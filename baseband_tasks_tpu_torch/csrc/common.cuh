// Launch geometry and tile-load helpers shared by the kernel sources.
//
// Every kernel of the port works on one column of a four-step FFT window
// for a tile of `tl` contiguous lanes: the column lives in shared memory
// as float2 x[row * tl + lane] (see fft.cuh), followed by the n/2-entry
// twiddle table.
#pragma once

#include <cuda_runtime.h>

namespace bbt {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 200 * 1024;  // of the 227 KB a block may use
constexpr int kMaxTileLanes = 16;

// Largest power-of-two lane tile <= 16 (and >= 2^min_log_tl) that divides
// L and whose shared tile (n rows of float2, plus `extra_per_lane` bytes
// per lane and `fixed` bytes) fits `budget`; returns log2 of it, or -1.
inline int choose_log_tl(int n, int L, int extra_per_lane, int fixed,
                         long budget = kMaxSmem, int min_log_tl = 0) {
  for (int log_tl = 4; log_tl >= min_log_tl; --log_tl) {
    const int tl = 1 << log_tl;
    if (tl > kMaxTileLanes || L % tl) continue;
    const long bytes = static_cast<long>(n) * tl * 8 + (n / 2) * 8 +
                       static_cast<long>(extra_per_lane) * tl + fixed;
    if (bytes <= budget) return log_tl;
  }
  return -1;
}

// Shared bytes of a column tile of n rows and its twiddle table.
inline size_t column_smem(int n, int log_tl) {
  return (static_cast<size_t>(n) << log_tl) * 8 + (n / 2) * 8;
}

// Tile load with kBatch loads in flight per thread: element idx of
// [0, total) is fetched by load(idx) and then handed to store(idx, value).
constexpr int kBatch = 8;

template <typename Load, typename Store>
__device__ __forceinline__ void batched(int total, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    decltype(load(0)) v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * blockDim.x;
      if (idx < total) v[u] = load(idx);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = i0 + u * blockDim.x;
      if (idx < total) store(idx, v[u]);
    }
  }
}

inline int log2i(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// Select the device (this library's runtime keeps its own current device)
// and allow the kernel more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel* kernel, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace bbt
