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
// `_accel_correlate_impl` :81), the 'pallas' engine.  Block (lane tile,
// segment s) multiplies the segment spectrum by its tile of the resident
// z bank, runs the inverse FFT over seg_len in shared memory (fft.cuh, DIF:
// natural order in, bit-reversed out, so the trim reads row bitrev(r)),
// scales by 1/seg_len, squares and writes only the first `valid` lags of
// the (n_seg, valid, 128) map.
// What bounds it on an H100: bytes, almost all of them the power map
// (4 x n_seg x valid x 128 B: 1.07 GB at n = 2^22, seg_len 4096, 0.32 ms),
// against ~20 GFLOP of FFT work.  The segment spectrum is read once per
// lane tile (from L2 after the first) and the bank (4 MB) stays in L2.
// A 4096-row column takes 32 KB per lane, so the tile is 4 lanes there
// (16 lanes at 512), and each output row is a 16-byte run.  Writing only
// the used z lanes (65 of 128 at z_max 64) is later work.

#include <cuda_runtime.h>

#include "common.cuh"
#include "fft.cuh"
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

__global__ void __launch_bounds__(kThreads)
accel_corr_kernel(const float2* __restrict__ spec, const float* __restrict__ tr,
                  const float* __restrict__ ti, float* __restrict__ out,
                  int log_n, int lanes, int log_tl, int valid, int n_seg) {
  extern __shared__ float2 smem[];
  const int n = 1 << log_n;
  const int tl = 1 << log_tl;
  float2* x = smem;
  float2* tw = smem + (n << log_tl);
  const int l0 = blockIdx.x << log_tl;
  const float inv_n = 1.0f / static_cast<float>(n);
  fill_twiddles(tw, n);

  // the grid's rows walk the segments (at most 65535 rows)
  for (long s = blockIdx.y; s < n_seg; s += gridDim.y) {
    const float2* f = spec + s * n;
    // x[row, lane] = spec[s, row] * (tr + i ti)[row, l0 + lane]
    batched(n << log_tl,
            [&](int idx) {
              const long b = static_cast<long>(idx >> log_tl) * lanes + l0 +
                             (idx & (tl - 1));
              const float2 a = f[idx >> log_tl];
              return make_float4(a.x, a.y, tr[b], ti[b]);
            },
            [&](int idx, float4 v) {
              x[idx] = cmul(make_float2(v.x, v.y), make_float2(v.z, v.w));
            });
    __syncthreads();
    fft_dif<true>(x, tw, log_n, log_tl);

    float* o = out + s * valid * lanes + l0;
    for (int idx = threadIdx.x; idx < (valid << log_tl); idx += blockDim.x) {
      const int r = idx >> log_tl;
      const int lane = idx & (tl - 1);
      const float2 v = x[(bitrev(r, log_n) << log_tl) + lane];
      const float vr = v.x * inv_n;
      const float vi = v.y * inv_n;
      o[static_cast<long>(r) * lanes + lane] = vr * vr + vi * vi;
    }
    // the next segment overwrites x
    __syncthreads();
  }
}

}  // namespace bbt

using bbt::kThreads;

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

// accel_corr: spec is (n_seg, seg_len) complex64 (float2 pairs), the bank
// planes (seg_len, lanes), out (n_seg, valid, lanes).
extern "C" int bbt_accel_corr(const void* spec, const float* tr, const float* ti,
                              float* out, int n_seg, int seg_len, int lanes,
                              int valid, int device, void* stream) {
  const int log_tl = bbt::choose_log_tl(seg_len, lanes, 0, 0);
  if (log_tl < 0 || seg_len < 2 || valid <= 0 || valid > seg_len || n_seg <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(seg_len, log_tl);
  cudaError_t err = bbt::prepare(bbt::accel_corr_kernel, smem, device);
  if (err != cudaSuccess) return err;
  const int rows = n_seg < 65535 ? n_seg : 65535;
  bbt::accel_corr_kernel<<<dim3(lanes >> log_tl, rows), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), tr, ti, out, bbt::log2i(seg_len), lanes,
      log_tl, valid, n_seg);
  return cudaGetLastError();
}
