// The acceleration search's two correlation kernels (models/accelsearch.py).
//
// bank_power: replaces `_bank_kernel` (baseband_tasks_tpu/ops/
// accel_correlate.py:134, launched by `_bank_matmul_impl` :165), the mx
// engine.  out = (t - u)^2 + (t + v)^2 with t = (fr + fi) @ ka, u = fi @ kb,
// v = fr @ kc: an FP32 GEMM of (n_seg, L) segment planes against (L, n_cols)
// banded operator planes, three products sharing one pass over the inputs,
// with the Karatsuba epilogue in registers.  Only the power map is written;
// t, u and v never reach device memory.
// What bounds it on an H100: operations.  At the search's full width
// (n_seg 8448, L 512, n_cols 16896) it does 3 x 2 x 8448 x 512 x 16896 =
// 438 GFLOP (6.5 ms at the 67 TFLOP/s FP32 rate of the CUDA cores) against
// 0.71 GB of traffic (0.21 ms).  The design is a classic shared-memory
// SGEMM: a 64 x 128 output tile per 256-thread block, 8-deep slices of the
// contraction double-buffered in shared memory (the next slice is fetched
// into registers while the current one is multiplied), and a 4 x 8
// microtile per thread with three accumulators per output (96 registers)
// so each (s, f, c) costs the three FMAs of the Karatsuba form and no
// more.  Each thread reads its eight columns as two float4 runs 64 columns
// apart, so a warp's shared-memory reads are conflict-free.  Tensor cores
// (3xTF32 or wgmma) are later work.
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

namespace bbt {

constexpr int kBM = 64, kBN = 128, kBK = 8;   // block tile (rows, cols, depth)
constexpr int kTM = 4, kTN = 8;               // per-thread microtile

__global__ void __launch_bounds__(kThreads)
bank_power_kernel(const float* __restrict__ fr, const float* __restrict__ fi,
                  const float* __restrict__ ka, const float* __restrict__ kb,
                  const float* __restrict__ kc, float* __restrict__ out,
                  int L, int n_cols) {
  // [buffer][depth][row or column]; A planes stored transposed
  __shared__ __align__(16) float s_r[2][kBK][kBM];
  __shared__ __align__(16) float s_i[2][kBK][kBM];
  __shared__ __align__(16) float s_a[2][kBK][kBN];
  __shared__ __align__(16) float s_b[2][kBK][kBN];
  __shared__ __align__(16) float s_c[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // column group: cols tx*4 and 64+tx*4
  const int ty = tid >> 4;          // row group: rows ty*4 .. ty*4+3
  const long m0 = static_cast<long>(blockIdx.y) * kBM;
  const long n0 = static_cast<long>(blockIdx.x) * kBN;

  // global -> register fetch of one depth slice: threads 0..127 take a
  // float4 of fr, 128..255 of fi (64 rows x 8 deep each); every thread one
  // float4 of each operator plane (8 deep x 128 columns)
  const int ta = tid & 127;
  const int a_row = ta >> 1, a_col = (ta & 1) * 4;
  const float* a_src = (tid < 128 ? fr : fi) + (m0 + a_row) * L + a_col;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  const long b_off = static_cast<long>(b_row) * n_cols + n0 + b_col;
  float4 pa, pb0, pb1, pb2;
  auto fetch = [&](int k0) {
    pa = *reinterpret_cast<const float4*>(a_src + k0);
    const long o = b_off + static_cast<long>(k0) * n_cols;
    pb0 = *reinterpret_cast<const float4*>(ka + o);
    pb1 = *reinterpret_cast<const float4*>(kb + o);
    pb2 = *reinterpret_cast<const float4*>(kc + o);
  };
  auto stash = [&](int buf) {
    float* a = tid < 128 ? &s_r[buf][0][0] : &s_i[buf][0][0];
    a[(a_col + 0) * kBM + a_row] = pa.x;
    a[(a_col + 1) * kBM + a_row] = pa.y;
    a[(a_col + 2) * kBM + a_row] = pa.z;
    a[(a_col + 3) * kBM + a_row] = pa.w;
    *reinterpret_cast<float4*>(&s_a[buf][b_row][b_col]) = pb0;
    *reinterpret_cast<float4*>(&s_b[buf][b_row][b_col]) = pb1;
    *reinterpret_cast<float4*>(&s_c[buf][b_row][b_col]) = pb2;
  };

  float t[kTM][kTN], u[kTM][kTN], v[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) t[i][j] = u[i][j] = v[i][j] = 0.0f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < L; k0 += kBK, buf ^= 1) {
    const bool more = k0 + kBK < L;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 r4 = *reinterpret_cast<const float4*>(&s_r[buf][k][ty * 4]);
      const float4 i4 = *reinterpret_cast<const float4*>(&s_i[buf][k][ty * 4]);
      const float ar[kTM] = {r4.x, r4.y, r4.z, r4.w};
      const float ai[kTM] = {i4.x, i4.y, i4.z, i4.w};
      float ba[kTN], bb[kTN], bc[kTN];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * 64 + tx * 4;
        const float4 a4 = *reinterpret_cast<const float4*>(&s_a[buf][k][c]);
        const float4 b4 = *reinterpret_cast<const float4*>(&s_b[buf][k][c]);
        const float4 c4 = *reinterpret_cast<const float4*>(&s_c[buf][k][c]);
        ba[h * 4 + 0] = a4.x; ba[h * 4 + 1] = a4.y;
        ba[h * 4 + 2] = a4.z; ba[h * 4 + 3] = a4.w;
        bb[h * 4 + 0] = b4.x; bb[h * 4 + 1] = b4.y;
        bb[h * 4 + 2] = b4.z; bb[h * 4 + 3] = b4.w;
        bc[h * 4 + 0] = c4.x; bc[h * 4 + 1] = c4.y;
        bc[h * 4 + 2] = c4.z; bc[h * 4 + 3] = c4.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float as = ar[i] + ai[i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          t[i][j] = fmaf(as, ba[j], t[i][j]);
          u[i][j] = fmaf(ai[i], bb[j], u[i][j]);
          v[i][j] = fmaf(ar[i], bc[j], v[i][j]);
        }
      }
    }
    // the other buffer was last read before the previous barrier
    if (more) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* row = out + (m0 + ty * 4 + i) * n_cols + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = h * 4 + q;
        const float cr = t[i][j] - u[i][j];
        const float ci = t[i][j] + v[i][j];
        p[q] = cr * cr + ci * ci;
      }
      *reinterpret_cast<float4*>(row + h * 64 + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
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

// bank_power: n_seg a multiple of 64, n_cols of 128, L of 8 (the wrapper
// checks); 16-byte aligned, contiguous planes.
extern "C" int bbt_bank_power(const float* fr, const float* fi, const float* ka,
                              const float* kb, const float* kc, float* out,
                              int n_seg, int L, int n_cols, int device,
                              void* stream) {
  if (n_seg % bbt::kBM || n_cols % bbt::kBN || L % bbt::kBK || L <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  bbt::bank_power_kernel<<<dim3(n_cols / bbt::kBN, n_seg / bbt::kBM), kThreads,
                           0, static_cast<cudaStream_t>(stream)>>>(
      fr, fi, ka, kb, kc, out, L, n_cols);
  return cudaGetLastError();
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
