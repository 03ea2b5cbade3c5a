// Forward polyphase filter bank of one streaming block: the FIR tap-sum
// over the overlap-save window [carry | block], optionally followed by
// the channelizing DFT as a lane mix.
//
// Replaces `_fwd_body` (baseband_tasks_tpu/ops/pfb_pallas.py:66,
// launched by `_pfb_forward_impl` :156).  A row is one spectrum's worth
// of raw samples, L = n * reps lanes; the window has k = n_tap - 1 carry
// rows (the previous block's last rows, already scaled) followed by the
// m block rows, which are multiplied by the per-iteration scale here:
//
//   a[r, l] = sum_t taps[t, l] * w[r + t, l],   r < m
//   y = a                     (no DFT: the polyphase branches)
//   y = a @ (F (x) I_reps)    (with the DFT, F = Fr + i Fi, (L, L))
//
// The TPU kernel assembles each row block's halo from a second view of
// the input; here window row q comes from the carry when q < k and from
// the block otherwise.
//
// Without the DFT (pfb_fir_kernel) what bounds it on an H100 is bytes:
// the window read once, the output written once.  Each thread slides a
// register window of kFirUnroll + n_tap - 1 rows of VEC = 4 neighbouring
// lanes of one plane (16-byte loads and stores; the real and imaginary
// planes are separate threads, which halves a thread's registers) down
// kFirRows output rows, loading the next kFirUnroll rows before it sums
// this step's, so the halo is read (kFirRows + n_tap - 1) / kFirRows
// times and each thread keeps kFirUnroll 16-byte loads in flight.  n_tap
// is a template argument: the window is exactly the rows the sums need.
//
// With the DFT (pfb_dft_kernel) it is tensor-core operations: the
// product is lane_mix's real GEMM, [ar | ai] (m, 2L) @ [[Fr, Fi], [-Fi,
// Fr]] (2L, 2L) -> [yr | yi], in 3xTF32 `wgmma` (tf32mma.cuh), 3 x 8 L
// flops per complex output element (0.41 ms at m = 32256, L = 512 at 495
// TFLOP/s).  The A operand, the tap sum, never leaves the block: each
// ring stage holds the raw window rows of its 16-deep slice of the depth
// (128 + n_tap - 1 rows of one plane's 16 lanes, by 16-byte cp.async,
// which bypasses L1, at lane_mix's A row stride) and those lanes' taps,
// and two stages ahead of the MMAs (tc::Pipeline, while the current
// stage's MMAs run) every thread sums two runs of 4 rows of one lane
// into the stage's A tile on the CUDA cores (22 reads for 8 sums; a
// warp's two half-warps 4 rows apart, on other banks), in the FIR's
// order and arithmetic; the fragments are then loaded and split from it
// as lane_mix loads its staged A.  B, the mixer, is split and staged
// once per mixer by the wrapper (ops/tf32.py), as lane_mix's is; the
// partial sums are promoted into float32 totals every kPfbPeriod stages.
// tools/fft_sweep.py --only pfb times it against the FIR then lane_mix;
// PR 11's sweep (builds without the tap sum, without the A tile written,
// and with B staged alone) put it on shared-memory traffic.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

#include "common.cuh"
#include "tf32mma.cuh"

namespace bbt {

constexpr int kMaxTaps = 9;
// the FIR: output rows a thread, rows a step, lanes a thread (4: 16-byte
// accesses where L % 4 == 0 and the planes are aligned)
constexpr int kFirRows = 128, kFirUnroll = 4, kFirThreads = 128;
// the fused DFT: columns of a block tile, ring stages (>= 5: the tap sums
// are prepared two stages ahead) and promotion period
constexpr int kPfbBN = 128, kPfbStages = 5, kPfbPeriod = 2;

template <int VEC>
struct Lanes {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Lanes<VEC> load_lanes(const float* p, float f) {
  Lanes<VEC> out;
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    out.v[0] = x.x * f;
    out.v[1] = x.y * f;
    out.v[2] = x.z * f;
    out.v[3] = x.w * f;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out.v[i] = __ldg(p + i) * f;
  }
  return out;
}

template <int VEC>
__device__ __forceinline__ void store_lanes4(float* p, const Lanes<VEC>& x) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = x.v[i];
  }
}

// Without the DFT: block (lane tile of kFirThreads * VEC lanes, run of
// kFirRows output rows, plane), VEC lanes a thread.
template <int NT, int VEC>
__global__ void __launch_bounds__(kFirThreads)
pfb_fir_kernel(const float* __restrict__ cr, const float* __restrict__ ci,
               const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ taps,
               const float* __restrict__ scale, float scale_value,
               float* __restrict__ yr, float* __restrict__ yi, int m,
               int L) {
  constexpr int K = NT - 1;
  constexpr int U = kFirUnroll;
  constexpr int W = U + K;             // window rows in registers
  const int l = (blockIdx.x * kFirThreads + threadIdx.x) * VEC;
  if (l >= L) return;
  const float s = scale ? *scale : scale_value;
  const long r0 = static_cast<long>(blockIdx.y) * kFirRows;
  const int rows = min(kFirRows, static_cast<int>(m - r0));
  const float* carry = blockIdx.z ? ci : cr;
  const float* block = blockIdx.z ? xi : xr;
  float* y = blockIdx.z ? yi : yr;
  Lanes<VEC> tap[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) tap[t] = load_lanes<VEC>(taps + t * L + l, 1.0f);
  // window row q: the carry below k, the scaled block above, zeros past
  // the block
  auto load = [&](long q) {
    if (q < K) return load_lanes<VEC>(carry + q * L + l, 1.0f);
    if (q - K < m) return load_lanes<VEC>(block + (q - K) * L + l, s);
    Lanes<VEC> z;
#pragma unroll
    for (int i = 0; i < VEC; ++i) z.v[i] = 0.0f;
    return z;
  };
  Lanes<VEC> w[W];
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = load(r0 + j);
  for (int u0 = 0; u0 < rows; u0 += U) {
    // the next step's rows, in flight while this step sums
    Lanes<VEC> next[U];
#pragma unroll
    for (int j = 0; j < U; ++j) next[j] = load(r0 + u0 + W + j);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u0 + u >= rows) break;
      Lanes<VEC> a;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NT; ++t) acc = fmaf(tap[t].v[i], w[u + t].v[i], acc);
        a.v[i] = acc;
      }
      store_lanes4<VEC>(y + (r0 + u0 + u) * L + l, a);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = w[j + U];
#pragma unroll
    for (int j = 0; j < U; ++j) w[K + j] = next[j];
  }
}

// The fused DFT's tile for tc::Pipeline: one ring stage is [B big, B
// small | A tile | taps | raw window rows] of a 16-deep slice of the
// depth 2L (the real plane's lanes below L, the imaginary plane's above).
template <int BN>
struct PfbTile {
  static constexpr int kB = 2 * BN * tc::kBK;        // big + small B
  static constexpr int kA = tc::kBM * tc::kAStride;  // the tap sums
  static constexpr int kTaps = kMaxTaps * tc::kBK;
  static constexpr int kRawRows = tc::kBM + kMaxTaps - 1;
  static constexpr int kRawStride = tc::kAStride;    // rows 4 apart: other banks
  static constexpr int kOffA = kB, kOffTaps = kOffA + kA,
                       kOffRaw = kOffTaps + kTaps;
  static constexpr int kStage =
      (kOffRaw + kRawRows * kRawStride + 31) / 32 * 32;   // 128-byte stages

  const float* cr;
  const float* ci;
  const float* xr;
  const float* xi;
  const float* taps;
  const float* wtile;                 // this column tile's staged mixer
  float s;                            // the block rows' scale
  long m0;                            // the tile's first output row
  int m, L, n_tap, k_tiles;
  float total[BN / 2], part[BN / 2];  // float32 totals, the partial
  tc::Frag f[2];

  __device__ __forceinline__ void load(int kt, float* sa) const {
    const int tid = threadIdx.x;
    const int k0 = kt * tc::kBK;
    const bool in = k0 < 2 * L;       // not a stage padding a period
    const bool im = k0 >= L;
    const int col = im ? k0 - L : k0;
    const int k = n_tap - 1;
    const float* carry = im ? ci : cr;
    const float* block = im ? xi : xr;
    // the raw window rows m0 .. m0 + 128 + k - 1, 16 bytes a copy, then
    // the taps of the slice's lanes: at most 3 copies a thread, unrolled
    const int raw_copies = (tc::kBM + k) * 4;
    const int copies = raw_copies + n_tap * 4;
    static_assert(3 * tc::kThreads >= (kRawRows + kMaxTaps) * 4, "copies");
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int idx = tid + u * tc::kThreads;
      if (idx < raw_copies) {
        const int r = idx >> 2, c = (idx & 3) * 4;
        const long q = m0 + r;
        const bool ok = in && q - k < m;
        const float* src = !ok ? cr
                           : q < k ? carry + q * L + col + c
                                   : block + (q - k) * L + col + c;
        tc::cp_async16(sa + kOffRaw + r * kRawStride + c, src, ok);
      } else if (idx < copies) {
        const int t = (idx - raw_copies) >> 2, c = (idx & 3) * 4;
        tc::cp_async16(sa + kOffTaps + t * tc::kBK + c,
                       in ? taps + t * L + col + c : taps, in);
      }
    }
    const bool b_in = kt < k_tiles;
    const float* bsrc = wtile + static_cast<long>(b_in ? kt : 0) * kB;
    static_assert(kB % (4 * tc::kThreads) == 0, "whole 16-byte copies");
#pragma unroll
    for (int u = 0; u < kB / 4 / tc::kThreads; ++u) {
      const int idx = 4 * (tid + u * tc::kThreads);
      tc::cp_async16(sa + idx, bsrc + idx, b_in);
    }
  }

  // The stage's A tile from its raw rows: thread (lane c, half h of
  // warp w) sums output rows 16 w + 4 h + {0..3} and the 4 rows 8 below
  // them, each run over its 4 + k window rows (the FIR's order: taps
  // ascending from zero; the block rows scaled first, the carry rows,
  // window rows below k, not).
  __device__ __forceinline__ void prepare(float* sa) const {
    const int c = threadIdx.x & (tc::kBK - 1);
    const int r0 = 16 * (threadIdx.x >> 5) + 4 * ((threadIdx.x >> 4) & 1);
    const int k = n_tap - 1;
    float tap[kMaxTaps];
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t)
      tap[t] = t < n_tap ? sa[kOffTaps + t * tc::kBK + c] : 0.0f;
#pragma unroll
    for (int run = 0; run < 2; ++run) {
      const int row = r0 + 8 * run;
      const float* raw = sa + kOffRaw + row * kRawStride + c;
      float* a = sa + kOffA + row * tc::kAStride + c;
      // window rows below k (the carry, unscaled) only in the first tile
      float w[4 + kMaxTaps - 1];
      const bool carry_rows = m0 + row < k;
#pragma unroll
      for (int i = 0; i < 4 + kMaxTaps - 1; ++i) {
        const float f = carry_rows && row + i < k ? 1.0f : s;
        w[i] = i < 4 + k ? raw[i * kRawStride] * f : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t)
          if (t < n_tap) acc = fmaf(tap[t], w[r + t], acc);
        a[r * tc::kAStride] = acc;
      }
    }
  }

  template <int S>
  __device__ __forceinline__ void frags(const float* sa, int j) {
    float raw[4];
    tc::load_raw(tc::frag_base(sa + kOffA), j, raw);
    tc::split4(raw, f[S]);
  }

  template <int S>
  __device__ __forceinline__ void mma(const float* sa, int j, bool fresh) {
    tc::wgmma_fence();
    tc::mma3<BN>(part, f[S], sa, sa + BN * tc::kBK, j, fresh);
    tc::wgmma_commit();
  }

  __device__ __forceinline__ void promote() {
    tc::pin(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] += part[i];
  }
};

// With the DFT: block (column tile, 128-row tile) of [yr | yi].
template <int BN, int STAGES, int PERIOD>
__global__ void __launch_bounds__(tc::kThreads, 1)
pfb_dft_kernel(const float* __restrict__ cr, const float* __restrict__ ci,
               const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ taps, const float* __restrict__ wp,
               const float* __restrict__ scale, float scale_value,
               float* __restrict__ yr, float* __restrict__ yi, int m, int L,
               int n_tap, int n_tiles, int k_tiles) {
  using Tile = PfbTile<BN>;
  extern __shared__ __align__(128) float stages[];
  const int n_tile = blockIdx.x % n_tiles;     // column tiles of a row block
  const long m0 = static_cast<long>(blockIdx.x / n_tiles) * tc::kBM;
  Tile t{cr, ci, xr, xi, taps,
         wp + static_cast<long>(n_tile) * k_tiles * Tile::kB,
         scale ? *scale : scale_value, m0, m, L, n_tap, k_tiles};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) t.total[i] = t.part[i] = 0.0f;
  tc::run_pipeline<STAGES, Tile::kStage, PERIOD>(t, stages, k_tiles);

  // column c of the tile is yr[., c] below L, yi[., c - L] below 2 L
  // (L even: a pair stays in a plane)
  const int K = 2 * L;
  const int c0 = n_tile * BN;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const long row = m0 + tc::acc_row(i);
    const int col = c0 + tc::acc_col(i);
    if (row >= m || col >= K) continue;
    float* dst = col < L ? yr + row * L + col : yi + row * L + (col - L);
    *reinterpret_cast<float2*>(dst) = make_float2(t.total[i], t.total[i + 1]);
  }
}

}  // namespace bbt

namespace {

template <int NT>
int launch_fir(const float* cr, const float* ci, const float* xr,
               const float* xi, const float* taps, const float* scale,
               float scale_value, float* yr, float* yi, int m, int L,
               bool vec, cudaStream_t st) {
  const int row_runs = (m + bbt::kFirRows - 1) / bbt::kFirRows;
  const int lanes = vec ? L / 4 : L;   // threads across the lanes
  const dim3 grid((lanes + bbt::kFirThreads - 1) / bbt::kFirThreads,
                  row_runs, 2);
  if (vec) {
    bbt::pfb_fir_kernel<NT, 4><<<grid, bbt::kFirThreads, 0, st>>>(
        cr, ci, xr, xi, taps, scale, scale_value, yr, yi, m, L);
  } else {
    bbt::pfb_fir_kernel<NT, 1><<<grid, bbt::kFirThreads, 0, st>>>(
        cr, ci, xr, xi, taps, scale, scale_value, yr, yi, m, L);
  }
  return cudaGetLastError();
}

template <int... NT>
int launch_fir_taps(int n_tap, std::integer_sequence<int, NT...>,
                    const float* cr, const float* ci, const float* xr,
                    const float* xi, const float* taps, const float* scale,
                    float scale_value, float* yr, float* yi, int m, int L,
                    bool vec, cudaStream_t st) {
  int err = cudaErrorInvalidValue;
  ((n_tap == NT + 2
        ? (err = launch_fir<NT + 2>(cr, ci, xr, xi, taps, scale, scale_value,
                                    yr, yi, m, L, vec, st))
        : 0),
   ...);
  return err;
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// --- C entry points: each returns the cudaGetLastError() of its launch. ---

// wp == nullptr: the tap-sum alone (pfb_fwd); otherwise the tap-sum times
// the mixer wp, F staged by ops/tf32.py `pack_operand` for this kernel's
// tile (`bbt_pfb_fwd_tile`) as lane_mix's is (pfb_fwd_dft; L % 16 == 0).
extern "C" int bbt_pfb_fwd(const float* cr, const float* ci, const float* xr,
                           const float* xi, const float* taps,
                           const float* wp, const float* scale,
                           float scale_value, float* yr, float* yi, int m,
                           int L, int n_tap, int device, void* stream) {
  if (n_tap < 2 || n_tap > bbt::kMaxTaps || m < 1 || L < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (wp == nullptr) {
    const bool vec = L % 4 == 0 && aligned16({cr, ci, xr, xi, taps, yr, yi});
    return launch_fir_taps(n_tap, std::make_integer_sequence<int, 8>{}, cr,
                           ci, xr, xi, taps, scale, scale_value, yr, yi, m, L,
                           vec, st);
  }
  if (L > bbt::kMaxMixLanes || L % bbt::tc::kBK) return cudaErrorInvalidValue;
  using bbt::tc::kBK;
  using bbt::tc::kBM;
  constexpr size_t smem = static_cast<size_t>(bbt::kPfbStages) *
                          bbt::PfbTile<bbt::kPfbBN>::kStage * sizeof(float);
  auto kernel = bbt::pfb_dft_kernel<bbt::kPfbBN, bbt::kPfbStages,
                                    bbt::kPfbPeriod>;
  err = bbt::prepare(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const int n_tiles = (2 * L + bbt::kPfbBN - 1) / bbt::kPfbBN;
  const int k_tiles = 2 * L / kBK;
  const long blocks = static_cast<long>(n_tiles) * ((m + kBM - 1) / kBM);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), bbt::tc::kThreads, smem, st>>>(
      cr, ci, xr, xi, taps, wp, scale, scale_value, yr, yi, m, L, n_tap,
      n_tiles, k_tiles);
  return cudaGetLastError();
}

// The (columns, depth) tile pfb_fwd_dft's staged mixer is laid out for.
extern "C" int bbt_pfb_fwd_tile(int* tile) {
  tile[0] = bbt::kPfbBN;
  tile[1] = bbt::tc::kBK;
  return 0;
}
