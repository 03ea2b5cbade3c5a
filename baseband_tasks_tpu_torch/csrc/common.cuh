// Launch geometry and tile-load helpers shared by the kernel sources.
//
// Every kernel of the port works on one column of a four-step FFT window
// for a tile of `tl` contiguous lanes: the column lives in shared memory
// as float2 x[row * tl + lane] (see fft.cuh), followed by the n/2-entry
// twiddle table.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace bbt {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 200 * 1024;  // of the 227 KB a block may use
constexpr int kMaxBlockSmem = 232448;  // the 227 KB themselves
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

// Asynchronous copies into shared memory (cp.async): `bytes` is 16, 8 or
// 4, and dst and src are aligned to it.  A thread's copies since its last
// cp_async_commit() form one group; cp_async_wait<N>() waits until at
// most N of its groups are in flight (a barrier then publishes them).
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) for the `count` threads (a
// multiple of 32) that name it: the warps of one team of a block.
__device__ __forceinline__ void team_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// p[0] += a, p[1] += b as one 64-bit compare-and-swap loop (p 8-byte
// aligned): the card has no float add among its shared-memory atomics, so
// atomicAdd on a shared float is such a loop of its own.
__device__ __forceinline__ void add_pair(float* p, float a, float b) {
  auto* w = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *w, seen;
  do {
    seen = old;
    const float x = __uint_as_float(static_cast<unsigned>(seen)) + a;
    const float y = __uint_as_float(static_cast<unsigned>(seen >> 32)) + b;
    old = atomicCAS(w, seen,
                    static_cast<unsigned long long>(__float_as_uint(x)) |
                        static_cast<unsigned long long>(__float_as_uint(y))
                            << 32);
  } while (old != seen);
}

__host__ __device__ constexpr int log2i(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// cp.async copy size for tile rows of tl elements of `elem` bytes in
// planes of row stride L elements starting at `planes` (null ones
// ignored): the row's bytes up to 16, or 0 (plain loads) when below 4 or
// when a row or a plane is not aligned to it.
inline int copy_chunk(int tl, int L, int elem,
                      std::initializer_list<const void*> planes) {
  const int row_bytes = tl * elem;
  const int chunk = row_bytes < 16 ? row_bytes : 16;
  if (chunk < 4 || (L * elem) % chunk) return 0;
  for (const void* p : planes)
    if (p && reinterpret_cast<uintptr_t>(p) % chunk) return 0;
  return chunk;
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
