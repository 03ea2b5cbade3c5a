// In-block power-of-two FFT over a tile of lanes, in shared memory.
//
// Replaces the JAX package's in-kernel Stockham FFT
// (baseband_tasks_tpu/ops/dedisperse_pallas.py `_stockham`, :71), which
// every dedispersion kernel inlines.  A thread block transforms one column
// of length n (a power of two, n >= 2) for `tl` contiguous lanes at once.
// The tile lives in shared memory as float2 x[row * tl + lane]: the lane
// is the fast index, so neighbouring threads touch neighbouring words, and
// the global loads and stores around the transform coalesce along lanes.
//
// Two in-place radix-2 forms avoid any permutation pass:
//   fft_dif: natural-order input  -> bit-reversed output,
//   fft_dit: bit-reversed input   -> natural-order output.
// Up to three consecutive radix-2 stages run in registers per pass: a
// thread loads the 2^k elements those stages couple, applies the k stages'
// butterflies (the same operations, in the same order, as k separate
// stages) and stores them back, so shared memory is read and written once
// per three stages (three passes for n = 512) instead of once per stage.
// Twiddles come from a per-block table tw[j] = exp(-2 pi i j / n),
// j < n/2, filled once with sincospif (exact argument j/n), and conjugated
// for the inverse transform.  No scaling is applied here.
#pragma once

#include <cuda_runtime.h>

namespace bbt {

__device__ __forceinline__ int bitrev(int i, int log_n) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log_n));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// tw[j] = exp(-2 pi i j / n) for j in [0, n/2).  Caller syncs before use.
__device__ __forceinline__ void fill_twiddles(float2* tw, int n) {
  for (int j = threadIdx.x; j < n / 2; j += blockDim.x) {
    float s, c;
    sincospif(-2.0f * static_cast<float>(j) / static_cast<float>(n), &s, &c);
    tw[j] = make_float2(c, s);
  }
}

// One pass of K radix-2 stages.  DIF: the stages' half-spans are
// 2^top, 2^(top-1), ..., 2^(top-K+1); DIT: 2^low, ..., 2^(low+K-1), with
// low = top - K + 1 in both.  The 2^K elements a group couples differ only
// in bits [low, low+K) of their row index.
template <int K, bool DIF, bool INVERSE>
__device__ __forceinline__ void fft_pass(float2* x, const float2* tw,
                                         int log_n, int log_tl, int low) {
  constexpr int R = 1 << K;
  const int tl = 1 << log_tl;
  const int items = (1 << (log_n - K)) << log_tl;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int lane = idx & (tl - 1);
    const int g = idx >> log_tl;
    const int base = ((g >> low) << (low + K)) | (g & ((1 << low) - 1));
    float2 v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = x[((base + (j << low)) << log_tl) + lane];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int jb = DIF ? (R >> (s + 1)) : (1 << s);   // partner bit in j
      const int log_h = DIF ? low + K - 1 - s : low + s;
      const int h = 1 << log_h;
      const int stride = 1 << (log_n - 1 - log_h);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j & jb) continue;
        const int pos = (base + (j << low)) & (h - 1);
        float2 w = tw[pos * stride];
        if (INVERSE) w.y = -w.y;
        const float2 a = v[j];
        if (DIF) {
          const float2 b = v[j | jb];
          v[j] = make_float2(a.x + b.x, a.y + b.y);
          v[j | jb] = cmul(make_float2(a.x - b.x, a.y - b.y), w);
        } else {
          const float2 b = cmul(v[j | jb], w);
          v[j] = make_float2(a.x + b.x, a.y + b.y);
          v[j | jb] = make_float2(a.x - b.x, a.y - b.y);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) x[((base + (j << low)) << log_tl) + lane] = v[j];
  }
  __syncthreads();
}

template <bool DIF, bool INVERSE>
__device__ void fft_passes(float2* x, const float2* tw, int log_n, int log_tl) {
  // DIF runs the stages from the largest half-span down, DIT from 1 up
  int done = 0;
  while (done < log_n) {
    const int k = log_n - done >= 3 ? 3 : log_n - done;
    const int low = DIF ? log_n - done - k : done;
    if (k == 3) fft_pass<3, DIF, INVERSE>(x, tw, log_n, log_tl, low);
    else if (k == 2) fft_pass<2, DIF, INVERSE>(x, tw, log_n, log_tl, low);
    else fft_pass<1, DIF, INVERSE>(x, tw, log_n, log_tl, low);
    done += k;
  }
}

// Decimation in frequency: x holds the column in natural order on entry
// and its transform in bit-reversed order on return.  Every pass ends in
// a block barrier, so the caller may read any element afterwards.
template <bool INVERSE>
__device__ void fft_dif(float2* x, const float2* tw, int log_n, int log_tl) {
  fft_passes<true, INVERSE>(x, tw, log_n, log_tl);
}

// Decimation in time: bit-reversed order on entry, natural order on return.
template <bool INVERSE>
__device__ void fft_dit(float2* x, const float2* tw, int log_n, int log_tl) {
  fft_passes<false, INVERSE>(x, tw, log_n, log_tl);
}

}  // namespace bbt
