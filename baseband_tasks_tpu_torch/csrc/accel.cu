// The acceleration search's two correlation kernels (models/accelsearch.py).
//
// bank_power: replaces `_bank_kernel` (baseband_tasks_tpu/ops/
// accel_correlate.py:134, launched by `_bank_matmul_impl` :165), the mx
// engine.  out = (t - u)^2 + (t + v)^2 with t = (fr + fi) @ ka, u = fi @ kb,
// v = fr @ kc: three GEMMs of (n_seg, L) segment planes against (L, n_cols)
// banded operator planes sharing one pass over the inputs, with the
// Karatsuba epilogue in registers.  Only the power map is written; t, u
// and v never reach device memory.
// What bounds it on an H100: operations.  At the search's full width
// (n_seg 8448, L 512, n_cols 16896) it does 3 x 2 x 8448 x 512 x 16896 =
// 438 GFLOP against 0.71 GB of traffic (0.21 ms).  The products run in
// 3xTF32 on the tensor cores (tf32mma.cuh: 3 x 438 GFLOP of passes, 2.66
// ms at 495 TFLOP/s, against 6.5 ms for float32 on the CUDA cores).  A
// block of two warpgroups holds a 128 x BN output tile in three partial
// accumulator sets and the float32 totals of t - u and t + v (5 BN / 2
// registers a thread: BN 64, promoted every stage, keeps the block at 255
// registers with the double-buffered fragments and no spill; every second
// stage spills); each k8 step splits its fr and fi fragments
// and fr + fi (summed in float32) in registers and issues 3 x 3 MMAs
// against the operator planes, which the wrapper splits and stages once
// per operator (ops/tf32.py).  Blocks walk the row tiles fastest, so the
// blocks in flight share a few operator column tiles and the segment
// planes (35 MB) stay in L2.  What holds it back is staging: a block
// reads 16 KB of segments and 24 KB of split operator per stage from L2,
// 22 GB in all, which alone takes 3.4 ms (tools/tf32_sweep.py's "staging
// only") and overlaps little with the MMAs.
//
// accel_corr: replaces `_kernel` (accel_correlate.py:54, launched by
// `_accel_correlate_impl` :81), the 'pallas' engine.  Block (tile of
// `lanes` z lanes, segment s) keeps its rows of the segment spectrum in
// registers and, a lane per team of seg_len/16 threads, multiplies them by
// the lane's templates (read lane-major: one contiguous run a lane, from
// the bank the wrapper transposes once), runs the inverse FFT over
// seg_len in registers (fft_reg.cuh: three radix-16 passes at 4096, two
// exchanges through the team's padded shared column, per-pass twiddle
// tables), scales by 1/seg_len, squares, and stages the first `valid`
// lags in shared memory; the tile's rows then go out lane-fastest, each
// row of the (n_seg, valid, n_out) map one run of whole 32-byte sectors
// when the wrapper pads n_out to a multiple of 8 (n_used lanes computed,
// zeros after them: the search's 65 of 128 at z_max 64).
// What bounds it on an H100: bytes, almost all of them the power map
// (4 x n_seg x valid x n_used B: 0.55 GB at n = 2^22, seg_len 4096, 65
// lanes, 0.17 ms; 1.07 GB, 0.33 ms, at 128), against ~10 GFLOP of FFT
// work (0.15 ms on the FP32 cores).  The bank (2 MB) stays in L2 and is
// read once per segment and lane; the spectrum once per block.  Two teams
// of 256 threads (own named barriers) share a block of ~227 KB (the
// exchanges, the twiddle tables and the 8-lane power stage): one block,
// 16 warps, per SM.  kCorrNext 1 loads the next lane's templates into
// registers during this lane's FFT.  What holds it back
// (tools/fft_sweep.py): the FFT alone and the loads and stores alone each
// take about half the kernel's time, and overlap little in one block.

#include <cuda_runtime.h>

#include "common.cuh"
#include "fft_reg.cuh"
#include "tf32mma.cuh"

namespace bbt {

template <int BN>
struct BankTile {
  static constexpr int kA = tc::kBM * tc::kAStride;   // one staged plane
  static constexpr int kHalf = BN * tc::kBK;          // one operator half
  static constexpr int kB = 6 * kHalf;                // ka, kb, kc
  static constexpr int kStage = 2 * kA + kB;

  const float* fr;
  const float* fi;
  const float* ktile;                 // this column tile's staged operator
  long m0;
  int n_seg, L, k_tiles;
  // partials t, u, v of the Karatsuba form; the float32 totals of t - u
  // and t + v; fragments of fr + fi, fi and fr
  float t[BN / 2], u[BN / 2], v[BN / 2], re[BN / 2], im[BN / 2];
  tc::Frag fs[2], fim[2], fre[2];

  __device__ __forceinline__ void load(int kt, float* sa) const {
    const int tid = threadIdx.x;
    const int k0 = kt * tc::kBK;
    // fr then fi: 128 rows x 4 chunks of 4 floats each
#pragma unroll
    for (int q = 0; q < 2 * tc::kBM * 4 / tc::kThreads; ++q) {
      const int idx = tid + q * tc::kThreads;
      const int plane = idx / (tc::kBM * 4);
      const int r = (idx / 4) % tc::kBM;
      const int c = 4 * (idx % 4);
      const long row = m0 + r;
      const bool ok = row < n_seg && k0 + c < L;
      const float* src = plane ? fi : fr;
      tc::cp_async16(sa + plane * kA + r * tc::kAStride + c,
                     ok ? src + row * L + k0 + c : src, ok);
    }
    const bool in = kt < k_tiles;              // not a stage padding a period
    const float* bsrc = ktile + static_cast<long>(in ? kt : 0) * kB;
#pragma unroll
    for (int idx = 4 * tid; idx < kB; idx += 4 * tc::kThreads)
      tc::cp_async16(sa + 2 * kA + idx, bsrc + idx, in);
  }

  template <int S>
  __device__ __forceinline__ void frags(const float* sa, int j) {
    float xr[4], xi[4], xs[4];
    tc::load_raw(tc::frag_base(sa), j, xr);
    tc::load_raw(tc::frag_base(sa + kA), j, xi);
#pragma unroll
    for (int q = 0; q < 4; ++q) xs[q] = xr[q] + xi[q];
    tc::split4(xs, fs[S]);
    tc::split4(xi, fim[S]);
    tc::split4(xr, fre[S]);
  }

  template <int S>
  __device__ __forceinline__ void mma(const float* sa, int j, bool fresh) {
    const float* ka = sa + 2 * kA;
    tc::wgmma_fence();
    tc::mma3<BN>(t, fs[S], ka, ka + kHalf, j, fresh);
    tc::mma3<BN>(u, fim[S], ka + 2 * kHalf, ka + 3 * kHalf, j, fresh);
    tc::mma3<BN>(v, fre[S], ka + 4 * kHalf, ka + 5 * kHalf, j, fresh);
    tc::wgmma_commit();
  }

  __device__ __forceinline__ void promote() {
    tc::pin(t);
    tc::pin(u);
    tc::pin(v);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      re[i] += t[i] - u[i];
      im[i] += t[i] + v[i];
    }
  }
};

template <int BN, int STAGES, int PERIOD>
__global__ void __launch_bounds__(tc::kThreads, 1)
bank_power_kernel(const float* __restrict__ fr, const float* __restrict__ fi,
                  const float* __restrict__ kp, float* __restrict__ out,
                  int n_seg, int L, int n_cols, int m_tiles, int k_tiles) {
  using Tile = BankTile<BN>;
  extern __shared__ __align__(128) float stages[];
  const long m0 = static_cast<long>(blockIdx.x % m_tiles) * tc::kBM;
  const int n_tile = blockIdx.x / m_tiles;
  Tile k{fr, fi, kp + static_cast<long>(n_tile) * k_tiles * Tile::kB, m0,
         n_seg, L, k_tiles};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    k.t[i] = k.u[i] = k.v[i] = k.re[i] = k.im[i] = 0.0f;
  tc::run_pipeline<STAGES, Tile::kStage, PERIOD>(k, stages, k_tiles);

  const int c0 = n_tile * BN;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const long row = m0 + tc::acc_row(i);
    const int col = c0 + tc::acc_col(i);
    if (row >= n_seg || col >= n_cols) continue;
    const float p0 = k.re[i] * k.re[i] + k.im[i] * k.im[i];
    const float p1 = k.re[i + 1] * k.re[i + 1] + k.im[i + 1] * k.im[i + 1];
    float* dst = out + row * n_cols + col;
    if (n_cols % 2 == 0) {                     // col even: an aligned pair
      *reinterpret_cast<float2*>(dst) = make_float2(p0, p1);
    } else {
      dst[0] = p0;
      if (col + 1 < n_cols) dst[1] = p1;
    }
  }
}

// accel_corr constants: threads a block, z lanes a tile (staged power
// rows), 0 / 1 (no FFT: load and store only) / 2 (no trim: FFT only),
// and whether the next round's bank is loaded into registers during this
// round's FFT (1) or at its own round's start (0) (tools/fft_sweep.py
// varies this line)
constexpr int kCorrThreads = 512, kCorrLanes = 8, kCorrMode = 0, kCorrNext = 1;
constexpr int kCorrLogR = 4;           // radix-16 register passes

// Shared-memory carve of an accel_corr block (host and device): one
// exchange per team (the threads of one lane's column), the twiddle
// table, and the power stage of the tile's lanes for `valid` rows.
struct CorrSmem {
  int log_t, teams, lanes, ex_slots, ex, tw, stage;
  __host__ __device__ CorrSmem(int log_n, int valid) {
    log_t = log_n > kCorrLogR ? log_n - kCorrLogR : 0;
    teams = kCorrThreads >> log_t;
    lanes = teams > kCorrLanes ? teams : kCorrLanes;
    ex_slots = reg::padded_size<1>(1 << log_n);
    ex = teams * ex_slots * 8;
    tw = reg::twiddle_slots(log_n, kCorrLogR) * 8;
    // the widest tile whose power stage fits beside them
    while (ex + tw + valid * lanes * 4 > kMaxBlockSmem && lanes > teams)
      lanes >>= 1;
    stage = valid * lanes * 4;
  }
  __host__ __device__ int bytes() const { return ex + tw + stage; }
};

// LOG_N fixes log2(seg_len) at compile time for the search's 4096 (-1:
// the launch's argument).
template <int LOG_N>
__global__ void __launch_bounds__(kCorrThreads, kCorrThreads > 256 ? 1 : 2)
accel_corr_kernel(const float2* __restrict__ spec,
                  const float2* __restrict__ bank, float* __restrict__ out,
                  int log_n_arg, int n_seg, int valid, int n_used,
                  int n_out) {
  constexpr int R = 1 << kCorrLogR;
  using Plan = reg::Plan<kCorrLogR, LOG_N>;
  extern __shared__ __align__(16) unsigned char corr_smem[];
  const int log_n = LOG_N >= 0 ? LOG_N : log_n_arg;
  const Plan plan(log_n);
  const CorrSmem lay(log_n, valid);
  const int n = 1 << log_n;
  float2* ex = reinterpret_cast<float2*>(corr_smem);
  float2* tw = reinterpret_cast<float2*>(corr_smem + lay.ex);
  float* stage = reinterpret_cast<float*>(corr_smem + lay.ex + lay.tw);
  const int team = threadIdx.x >> lay.log_t;
  const int t = threadIdx.x & ((1 << lay.log_t) - 1);
  const int l0 = blockIdx.x * lay.lanes;
  const int g_here = max(0, min(lay.lanes, n_used - l0));
  const int g_out = min(lay.lanes, n_out - l0);   // lanes past n_used: 0
  // rounds of `teams` lanes, the tile's dead lanes skipped a round at a time
  const int rounds = (g_here + lay.teams - 1) / lay.teams;
  const float inv_n = 1.0f / static_cast<float>(n);
  float2* my_ex = ex + team * lay.ex_slots;
  reg::fill_twiddle_tables(tw, log_n, kCorrLogR);
  __syncthreads();                     // the table, before any team reads it
  // the power stage, (valid, lanes) floats with the lane index swizzled
  // by the row so that a warp's stores of 32 rows of one lane, and its
  // loads of whole stage rows, fall on distinct banks
  const int log_g = __ffs(lay.lanes) - 1;
  const int sw_shift = log_g < 5 ? 5 - log_g : 0;
  const int sw_mask = (lay.lanes < 32 ? lay.lanes : 32) - 1;
  auto st = [&](int r, int g) {
    return (r << log_g) + (g ^ ((r >> sw_shift) & sw_mask));
  };
  // the (lane, row) coefficients of the bank this thread multiplies in
  // round rd: its rows of the team's lane, one contiguous lane-major run
  auto load_bank = [&](int rd, float2 (&b)[R]) {
    const int l = l0 + rd * lay.teams + team;
#pragma unroll
    for (int q = 0; q < R; ++q)
      b[q] = l < n_used && q < plan.used
                 ? bank[static_cast<long>(l) * n + plan.row_in(0, q, t)]
                 : make_float2(0.0f, 0.0f);
  };
  // a team's exchange is its own: whole-warp teams (at most 15) wait for
  // each other only at the power stage
  const bool own_bar = lay.log_t >= 5 && lay.teams <= 15;
  auto sync = [&] {
    if (own_bar) team_sync(team + 1, 1 << lay.log_t);
    else __syncthreads();
  };
  auto slot = [&](int, int row) { return my_ex + reg::pad_slot<1>(row); };
  const int tt[1] = {t};
  const bool live_ex[1] = {true};      // dead lanes transform zeros
  float keep = 0.0f;                   // kCorrMode 2: the FFT's results

  // kCorrNext: bk holds this round's bank, loaded during the last
  // round's FFT; otherwise it is loaded at the round's start
  float2 bk[R];
  if (kCorrNext) load_bank(0, bk);
  // the grid's rows walk the segments (at most 65535 rows)
  for (long s = blockIdx.y; s < n_seg; s += gridDim.y) {
    // this thread's rows of the segment spectrum, kept for every lane
    float2 sp[R];
#pragma unroll
    for (int q = 0; q < R; ++q)
      sp[q] = q < plan.used ? spec[s * n + plan.row_in(0, q, t)]
                            : make_float2(0.0f, 0.0f);
    for (int rd = 0; rd < rounds; ++rd) {
      const int g = rd * lay.teams + team;
      if (!kCorrNext) load_bank(rd, bk);
      float2 v[1][R];
#pragma unroll
      for (int q = 0; q < R; ++q) v[0][q] = cmul(sp[q], bk[q]);
      // the next round's lane (the first again for the next segment)
      if (kCorrNext) load_bank(rd + 1 < rounds ? rd + 1 : 0, bk);
      if (kCorrMode != 1)
        plan.template run<true>(v, tt, live_ex, tw, slot, sync);
      if (l0 + g < n_used) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (q >= plan.used) continue;
          const int r = plan.rows_final(q, t);
          const float vr = v[0][q].x * inv_n;
          const float vi = v[0][q].y * inv_n;
          if (kCorrMode == 2) keep += vr * vr + vi * vi;
          else if (r < valid) stage[st(r, g)] = vr * vr + vi * vi;
        }
      }
    }
    __syncthreads();
    // the tile's rows, lane-fastest: each output row's lanes in one run
    if (kCorrMode != 2) {
      float* o = out + s * valid * n_out + l0;
#pragma unroll 4
      for (int i = threadIdx.x; i < (valid << log_g); i += kCorrThreads) {
        const int r = i >> log_g, g = i & (lay.lanes - 1);
        if (g < g_out)
          o[static_cast<long>(r) * n_out + g] =
              g < g_here ? stage[st(r, g)] : 0.0f;
      }
    }
    // the next segment overwrites the stage
    __syncthreads();
  }
  if (kCorrMode == 2 && keep == -1.0f) out[0] = keep;
}

}  // namespace bbt


// --- C entry points: each returns the cudaGetLastError() of its launch. ---

namespace {

constexpr int kBankBN = 64, kBankStages = 4, kBankPeriod = 1;

}  // namespace

// bank_power: kp is the operator (ka, kb, kc) staged by ops/tf32.py
// `pack_operand` for this kernel's tile (`bbt_bank_power_tile`); L a
// multiple of 4 and fr, fi 16-byte aligned (the wrapper checks).
extern "C" int bbt_bank_power(const float* fr, const float* fi, const float* kp,
                              float* out, int n_seg, int L, int n_cols,
                              int device, void* stream) {
  using bbt::tc::kBK;
  using bbt::tc::kBM;
  if (n_seg <= 0 || n_cols <= 0 || L <= 0 || L % 4)
    return cudaErrorInvalidValue;
  constexpr size_t smem = static_cast<size_t>(kBankStages) *
                          bbt::BankTile<kBankBN>::kStage * sizeof(float);
  auto kernel = bbt::bank_power_kernel<kBankBN, kBankStages, kBankPeriod>;
  cudaError_t err = bbt::prepare(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const int m_tiles = (n_seg + kBM - 1) / kBM;
  const int k_tiles = (L + kBK - 1) / kBK;
  const long blocks =
      static_cast<long>(m_tiles) * ((n_cols + kBankBN - 1) / kBankBN);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), bbt::tc::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(fr, fi, kp, out, n_seg, L,
                                                n_cols, m_tiles, k_tiles);
  return cudaGetLastError();
}

// The (columns, depth) tile bank_power's staged operator is laid out for.
extern "C" int bbt_bank_power_tile(int* tile) {
  tile[0] = kBankBN;
  tile[1] = bbt::tc::kBK;
  return 0;
}

// accel_corr: spec is (n_seg, seg_len) complex64 (float2 pairs), bank the
// z-template transfer functions lane-major, (lanes, seg_len) complex64
// (ops/accel_correlate.py transposes the (seg_len, lanes) planes once per
// bank), out (n_seg, valid, n_out): the power of the first n_used lanes,
// then zeros up to n_out (>= n_used; a multiple of 8 makes every row of a
// tile whole 32-byte sectors).
extern "C" int bbt_accel_corr(const void* spec, const void* bank, float* out,
                              int n_seg, int seg_len, int lanes, int n_used,
                              int n_out, int valid, int device, void* stream) {
  using bbt::kCorrThreads;
  if (seg_len < 2 || (seg_len & (seg_len - 1)) || valid <= 0 ||
      valid > seg_len || n_seg <= 0 || n_used <= 0 || n_used > lanes ||
      n_out < n_used || (seg_len >> bbt::kCorrLogR) > kCorrThreads)
    return cudaErrorInvalidValue;
  const int log_n = bbt::log2i(seg_len);
  const bbt::CorrSmem lay(log_n, valid);
  const size_t smem = lay.bytes();
  auto kernel = log_n == 12 ? bbt::accel_corr_kernel<12>
                            : bbt::accel_corr_kernel<-1>;
  cudaError_t err = bbt::prepare(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const int tiles = (n_out + lay.lanes - 1) / lay.lanes;
  const int rows = n_seg < 65535 ? n_seg : 65535;
  kernel<<<dim3(tiles, rows), kCorrThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<const float2*>(bank),
      out, log_n, n_seg, valid, n_used, n_out);
  return cudaGetLastError();
}
