// 3xTF32 matrix products on Hopper's tensor cores, for lane_mix
// (fourstep.cu), bank_power (accel.cu) and the forward PFB's DFT
// (pfb.cu).
//
// A block of two warpgroups (256 threads) computes a 128-row tile of
// C = A @ B with `wgmma.mma_async` .tf32 (m64nNk8, float32 accumulate),
// one 64-row half per warpgroup.  Operands:
//
// - A, the data, is read raw (float32) into a ring of shared-memory
//   stages by cp.async, rows padded to kAStride floats so that the
//   fragment loads below hit 32 distinct banks.  Each warpgroup loads its
//   m64k8 fragment from there into registers and splits it there:
//   big = tf32(a), small = tf32(a - big), both rounded to nearest
//   (`cvt.rna`; raw float32 bits would be truncated by the MMA).
// - B, the constant operand (a mixer, an operator bank), is split once by
//   the wrapper (ops/tf32.py) and stored already in the staged layout:
//   per (N tile, K tile) one contiguous run holding, for each plane, its
//   big and its small half as K-major core matrices (8 columns x 4 deep,
//   16 bytes a column; `wgmma` takes a .tf32 operand K-major only).  A
//   stage is filled by contiguous 16-byte cp.async copies.
//
// Each k8 step issues small(a)·big(b), big(a)·small(b), then big(a)·big(b)
// (`mma3`): the dropped small·small term is ~2^-22 of each product,
// against ~2^-11 for one TF32 pass.  The tensor cores add each MMA into
// its float32 accumulator without rounding to nearest, so an accumulator
// that runs the whole depth loses low bits at every step: on an H100 that
// error grew with the depth, ~2e-6 of the peak at K = 256, ~8e-6 at 1024
// and ~2.5e-5 at 3200.  So the MMAs run into partial accumulators that
// start anew (scale-d 0) every PERIOD stages, and each partial is added
// into float32 totals on the CUDA cores (rounded to nearest): ~2e-7 to
// ~6e-7 of the peak at every depth with PERIOD 1 or 2 (16 or 32 deep),
// the class of float32 on the CUDA cores.  The totals cost a second set of registers,
// and each promotion waits for the warpgroup's MMAs in flight (`Pipeline`
// below; tools/fft_sweep.py --only mix,bank times the periods).
// One __syncthreads per stage publishes the stage that arrived and frees
// the one read two steps before; the fragments of the next step load
// while the current step's three MMAs run (wait_group 1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bbt {

// Widest lane axis the lane mixes and the forward PFB's DFT take: (2L)^2
// split mixer floats, 80 MB at 1600 lanes.
constexpr int kMaxMixLanes = 1600;

namespace tc {

constexpr int kThreads = 256;          // two warpgroups
constexpr int kBM = 128;               // rows of a block tile
constexpr int kBK = 16;                // depth of a stage: two k8 steps
constexpr int kAStride = kBK + 4;      // floats per staged A row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- float32 -> TF32 big + small ------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// --- cp.async (zero-filled when !valid; src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy; wgmma reads through the
// async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma ------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator traffic across the MMAs.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major B tile without swizzle: core matrices of 8
// columns x 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart
// along N.
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo,
                                         uint32_t sbo) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// B stage layout of one plane half (ops/tf32.py `pack_operand`): core
// matrix (column group g, depth chunk c) at float (g * kBK / 4 + c) * 32,
// so the k8 step j starts at float 64 j.
constexpr uint32_t kLbo = 128;                 // next 4-deep chunk
constexpr uint32_t kSbo = (kBK / 4) * 128;     // next 8 columns

__device__ __forceinline__ uint64_t b_desc(const float* plane, int j) {
  return desc(plane + 64 * j, kLbo, kSbo);
}

// A fragment of the m64k8 step j for this thread, split: rows
// r, r + 8 and columns 8 j + t, 8 j + t + 4 of the staged tile, with
// r = 64 warpgroup + 16 warp + lane / 4 and t = lane % 4.
struct Frag {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ const float* frag_base(const float* tile) {
  const int lane = threadIdx.x & 31;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);  // 64 wg + 16 w + g
  return tile + row * kAStride + (lane & 3);
}

__device__ __forceinline__ void load_raw(const float* base, int j,
                                         float (&x)[4]) {
  const float* p = base + 8 * j;
  x[0] = p[0];
  x[1] = p[8 * kAStride];
  x[2] = p[4];
  x[3] = p[8 * kAStride + 4];
}

__device__ __forceinline__ void split4(const float (&x)[4], Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.big[i], f.small[i]);
}

// Accumulator element i of an m64nN tile: column 8 (i / 4) + 2 t + (i & 1)
// and row r + 8 ((i / 2) & 1) (r, t as for the fragments).
__device__ __forceinline__ int acc_row(int i) {
  const int lane = threadIdx.x & 31;
  return 16 * (threadIdx.x >> 5) + (lane >> 2) + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// One m64nNk8 MMA with A from registers and B from shared memory: d =
// A·B + (scale_d ? d : 0), d being N / 2 floats a thread.  The operand
// lists are written out per N.
template <int N>
struct Mma;

template <>
struct Mma<56> {
  static __device__ __forceinline__ void run(float (&d)[28],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
        "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<80> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The three passes of one k8 step into d; `fresh` starts d anew.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const Frag& a,
                                     const float* b_big, const float* b_small,
                                     int j, bool fresh = false) {
  Mma<N>::run(d, a.small, b_desc(b_big, j), !fresh);
  Mma<N>::run(d, a.big, b_desc(b_small, j), 1);
  Mma<N>::run(d, a.big, b_desc(b_big, j), 1);
}

// Whether tile T computes part of its stage in the block (`prepare`).
template <class T, class = void>
struct HasPrepare : std::false_type {};
template <class T>
struct HasPrepare<T, std::void_t<decltype(&T::prepare)>> : std::true_type {};

// The main loop of the kernels over the stages of the depth.  The
// kernel's tile T supplies
//   load(kt, stage): issue stage kt's cp.async copies (zeros past the
//                    depth, also for the stages that pad the last period)
//   prepare(stage):  optional: compute in the block what the stage's
//                    fragments are loaded from (the PFB's tap sums), from
//                    what load() staged there
//   frags<S>(stage, j): load and split the A fragments of k8 step j into
//                    fragment buffer S
//   mma<S>(stage, j, fresh): issue step j's MMAs from buffer S into the
//                    partials and commit them (`fresh` starts them anew)
//   promote():       add the partials into the float32 totals
// Each PERIOD stages the partials are promoted: the warpgroup waits for
// its MMAs and adds them on the CUDA cores.  Which stages promote is fixed
// at compile time: `wgmma_wait` under a run-time branch makes ptxas
// serialize the MMAs.  A tile with prepare() has stage kt + 2 prepared
// while stage kt's MMAs run, from copies that arrived a stage before, so
// the barrier each stage already takes publishes it: its stages are
// waited for three ahead (STAGES >= 5).
template <int STAGES, int STAGE_FLOATS, int PERIOD, class T>
struct Pipeline {
  static constexpr bool kPrep = HasPrepare<T>::value;
  static_assert(!kPrep || STAGES >= 5, "prepare() needs 5 stages or more");
  T& t;
  float* stages;
  int k_tiles;                         // stages, padded to whole periods

  __device__ __forceinline__ float* slot(int kt) const {
    return stages + (kt % STAGES) * STAGE_FLOATS;
  }

  template <bool FRESH, bool PROMOTE>
  __device__ __forceinline__ void stage(int kt) {
    float* sa = slot(kt);
    t.template mma<0>(sa, 0, FRESH);
    wgmma_wait<1>();                   // step-1 fragments free
    t.template frags<1>(sa, 1);
    t.template mma<1>(sa, 1, false);
    if constexpr (kPrep)               // while this stage's MMAs run
      if (kt + 2 < k_tiles) t.prepare(slot(kt + 2));
    if constexpr (PROMOTE) {
      wgmma_wait<0>();
      t.promote();
    } else {
      wgmma_wait<1>();                 // step-0 fragments free
    }
    // stage kt + 1 arrived (kt + 3 with prepare(): prepared next stage)
    cp_async_wait<kPrep ? STAGES - 5 : STAGES - 3>();
    fence_proxy_async();
    __syncthreads();                   // stage kt - 1 free
    if (kt + STAGES - 1 < k_tiles) t.load(kt + STAGES - 1, slot(kt + STAGES - 1));
    cp_async_commit();
    if (kt + 1 < k_tiles) t.template frags<0>(slot(kt + 1), 0);
  }

  template <int P>
  __device__ __forceinline__ void period(int kt) {
    stage<P == 0, P == PERIOD - 1>(kt + P);
    if constexpr (P + 1 < PERIOD) period<P + 1>(kt);
  }

  __device__ __forceinline__ void run() {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < k_tiles) t.load(s, slot(s));
      cp_async_commit();
    }
    cp_async_wait<kPrep ? STAGES - 4 : STAGES - 2>();   // 0 (0..2) arrived
    fence_proxy_async();
    __syncthreads();
    if constexpr (kPrep) {
      t.prepare(slot(0));
      if (1 < k_tiles) t.prepare(slot(1));
      __syncthreads();
    }
    t.template frags<0>(slot(0), 0);
    for (int kt = 0; kt < k_tiles; kt += PERIOD) period<0>(kt);
  }
};

// Runs the pipeline over k_tiles stages, rounded up to whole periods (the
// tile's loads zero-fill past the depth).
template <int STAGES, int STAGE_FLOATS, int PERIOD, class T>
__device__ __forceinline__ void run_pipeline(T& t, float* stages,
                                             int k_tiles) {
  Pipeline<STAGES, STAGE_FLOATS, PERIOD, T> p{
      t, stages, (k_tiles + PERIOD - 1) / PERIOD * PERIOD};
  p.run();
}

}  // namespace tc
}  // namespace bbt
