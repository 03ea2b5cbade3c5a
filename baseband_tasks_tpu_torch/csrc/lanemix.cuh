// A tile of rows times a complex (L, L) lane-mixing matrix, in FP32.
//
// Replaces the lane matmuls that the JAX package runs on the TPU's MXU
// inside its kernels: `_lane_matmul` (baseband_tasks_tpu/ops/
// spectral_filter.py:78, the `pre`/`post` mixes) and the F (x) I_reps DFT
// of `_fwd_body` (ops/pfb_pallas.py:111-114).  A block holds kMixRows
// rows of all L lanes in shared memory, as float2 a[r * L + k], and
// computes y[row0 + r, j] = sum_k a[r, k] * W[k, j] with W = wr + i wi
// read from device memory (the whole matrix, 2 L^2 floats, stays in L2).
// Each thread owns one output column j at a time and keeps its kMixRows
// complex sums in registers; a[r, k] is the same word for every thread of
// a warp (a shared-memory broadcast) and W[k, j] is read coalesced along
// j, so each step k costs two loads of W and kMixRows broadcasts for
// 4 kMixRows FMAs.
// Bound: FP32 FMAs (8 L flops per complex output element, CUDA cores, no
// tensor cores); the planes themselves cross device memory once.
#pragma once

#include <cuda_runtime.h>

namespace bbt {

constexpr int kMixRows = 16;

// Largest L a kMixRows x L float2 tile allows within the shared budget.
constexpr int kMaxMixLanes = 1600;

__device__ __forceinline__ void mix_tile(const float2* a, int L,
                                         const float* __restrict__ wr,
                                         const float* __restrict__ wi,
                                         float* __restrict__ yr,
                                         float* __restrict__ yi, long row0,
                                         int rows) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    float accr[kMixRows], acci[kMixRows];
#pragma unroll
    for (int r = 0; r < kMixRows; ++r) {
      accr[r] = 0.0f;
      acci[r] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < L; ++k) {
      const float w_r = __ldg(wr + static_cast<long>(k) * L + j);
      const float w_i = __ldg(wi + static_cast<long>(k) * L + j);
#pragma unroll
      for (int r = 0; r < kMixRows; ++r) {
        const float2 v = a[r * L + k];
        accr[r] = fmaf(v.x, w_r, fmaf(-v.y, w_i, accr[r]));
        acci[r] = fmaf(v.x, w_i, fmaf(v.y, w_r, acci[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < kMixRows; ++r) {
      if (r < rows) {
        const long o = (row0 + r) * L + j;
        yr[o] = accr[r];
        yi[o] = acci[r];
      }
    }
  }
}

// Threads of a mixing block: one column each, at most 256.
inline int mix_threads(int L) {
  return L >= 256 ? 256 : 128;
}

}  // namespace bbt
