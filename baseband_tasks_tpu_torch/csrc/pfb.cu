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
// the input; here a thread simply reads window row q from the carry
// when q < k and from the block otherwise.
//
// What bounds it on an H100.  Without the DFT: bytes; each thread keeps
// kTapRows + n_tap - 1 window rows of one lane in registers, so the
// window is read ~(16 + n_tap - 1) / 16 times (from L2) and the output
// written once.  With the DFT: FP32 FMAs, 8 L flops per output element
// (68 GFLOP at m = 32256, L = 512), done by lanemix.cuh's `mix_tile` on
// a kMixRows x L tap-sum tile that never leaves shared memory.

#include <cuda_runtime.h>

#include "common.cuh"
#include "lanemix.cuh"

namespace bbt {

constexpr int kMaxTaps = 9;
constexpr int kTapRows = kMixRows;

// The tap-sum of output rows r0 .. r0 + rows - 1 (rows <= kTapRows) at
// lane l; rows past `rows` come out zero.
__device__ __forceinline__ void tap_sum(
    const float* __restrict__ cr, const float* __restrict__ ci,
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ taps, float s, long r0, int rows, int l, int L,
    int n_tap, float2 out[kTapRows]) {
  const int k = n_tap - 1;
  float tap[kMaxTaps];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t)
    tap[t] = t < n_tap ? __ldg(taps + static_cast<long>(t) * L + l) : 0.0f;
  float2 v[kTapRows + kMaxTaps - 1];
#pragma unroll
  for (int q = 0; q < kTapRows + kMaxTaps - 1; ++q) {
    v[q] = make_float2(0.0f, 0.0f);
    if (q < rows + k) {
      const long row = r0 + q;
      if (row < k) {
        v[q] = make_float2(cr[row * L + l], ci[row * L + l]);
      } else {
        const long o = (row - k) * L + l;
        v[q] = make_float2(xr[o] * s, xi[o] * s);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kTapRows; ++r) {
    float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      if (t < n_tap) {
        acc.x = fmaf(tap[t], v[r + t].x, acc.x);
        acc.y = fmaf(tap[t], v[r + t].y, acc.y);
      }
    }
    out[r] = r < rows ? acc : make_float2(0.0f, 0.0f);
  }
}

// Without the DFT: block (row tile, lane tile), one lane per thread.
__global__ void __launch_bounds__(kThreads)
pfb_fir_kernel(const float* __restrict__ cr, const float* __restrict__ ci,
               const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ taps,
               const float* __restrict__ scale, float scale_value,
               float* __restrict__ yr, float* __restrict__ yi, int m, int L,
               int n_tap) {
  const int l = blockIdx.y * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const float s = scale ? *scale : scale_value;
  const long r0 = static_cast<long>(blockIdx.x) * kTapRows;
  const int rows = min(kTapRows, static_cast<int>(m - r0));
  float2 out[kTapRows];
  tap_sum(cr, ci, xr, xi, taps, s, r0, rows, l, L, n_tap, out);
#pragma unroll
  for (int r = 0; r < kTapRows; ++r) {
    if (r < rows) {
      const long o = (r0 + r) * L + l;
      yr[o] = out[r].x;
      yi[o] = out[r].y;
    }
  }
}

// With the DFT: block = kTapRows output rows of all L lanes; the tap-sum
// tile goes to shared memory, then `mix_tile` multiplies it by F.
__global__ void __launch_bounds__(kThreads)
pfb_dft_kernel(const float* __restrict__ cr, const float* __restrict__ ci,
               const float* __restrict__ xr, const float* __restrict__ xi,
               const float* __restrict__ taps, const float* __restrict__ fr,
               const float* __restrict__ fi,
               const float* __restrict__ scale, float scale_value,
               float* __restrict__ yr, float* __restrict__ yi, int m, int L,
               int n_tap) {
  extern __shared__ float2 tile[];
  const float s = scale ? *scale : scale_value;
  const long r0 = static_cast<long>(blockIdx.x) * kTapRows;
  const int rows = min(kTapRows, static_cast<int>(m - r0));
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float2 out[kTapRows];
    tap_sum(cr, ci, xr, xi, taps, s, r0, rows, l, L, n_tap, out);
#pragma unroll
    for (int r = 0; r < kTapRows; ++r) tile[r * L + l] = out[r];
  }
  __syncthreads();
  mix_tile(tile, L, fr, fi, yr, yi, r0, rows);
}

}  // namespace bbt

using bbt::kThreads;

// --- C entry point: returns the cudaGetLastError() of its launch. ---

// fr == nullptr: the tap-sum alone; otherwise the tap-sum times F.
extern "C" int bbt_pfb_fwd(const float* cr, const float* ci, const float* xr,
                           const float* xi, const float* taps,
                           const float* fr, const float* fi,
                           const float* scale, float scale_value, float* yr,
                           float* yi, int m, int L, int n_tap, int device,
                           void* stream) {
  if (n_tap < 2 || n_tap > bbt::kMaxTaps || m < 1 || L < 1)
    return cudaErrorInvalidValue;
  const int row_tiles = (m + bbt::kTapRows - 1) / bbt::kTapRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fr == nullptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    bbt::pfb_fir_kernel<<<dim3(row_tiles, (L + kThreads - 1) / kThreads),
                          kThreads, 0, st>>>(cr, ci, xr, xi, taps, scale,
                                             scale_value, yr, yi, m, L, n_tap);
    return cudaGetLastError();
  }
  if (L > bbt::kMaxMixLanes) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(bbt::kTapRows) * L * sizeof(float2);
  cudaError_t err = bbt::prepare(bbt::pfb_dft_kernel, smem, device);
  if (err != cudaSuccess) return err;
  bbt::pfb_dft_kernel<<<row_tiles, bbt::mix_threads(L), smem, st>>>(
      cr, ci, xr, xi, taps, fr, fi, scale, scale_value, yr, yi, m, L, n_tap);
  return cudaGetLastError();
}
