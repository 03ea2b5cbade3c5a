// Overlap-save halo edges of a time-sharded mesh: each shard's `front`
// (its left neighbour's trailing pad_start rows) and `end` (its right
// neighbour's leading pad_end rows), zeros at the two ends of a
// non-periodic ring.
//
// Replaces `_halo_kernel` (baseband_tasks_tpu/parallel/halo_pallas.py:73,
// launched by `halo_edges_remote` :212).  On a TPU each device pushes its
// edges into its neighbours' output buffers by async remote DMA, after a
// barrier-semaphore handshake that tells it the neighbour has finished
// with those buffers.  Here one process drives every shard: it allocates
// each output and orders the launches on streams, so the kernel *pulls*:
// one launch per destination device covers every shard on that device,
// and each block reads its rows from the neighbour's block (through a
// peer pointer when the neighbour lives on another card) or writes zeros.
// The reader owns its output, so nothing can race and no barrier is
// needed; an in-kernel spin-wait between shards would deadlock whenever
// two shards' launches queue on one stream of one card.  Ordering across
// cards is the caller's: the wrapper makes the destination's stream wait
// on an event of each source's stream before the launch, and each
// source's stream wait on the destination's after it.
//
// Shards are slots of a row-major (time, ring) grid, slot = t * n_rings
// + r (the mesh's logical-id order); a ring is one `chan` column.  Rows
// are contiguous, so each edge is one contiguous byte range: the copy
// works on bytes and serves any dtype (float32 planes, (T, C, P, 2)
// float32 pairs, complex64).  It moves 16-byte vectors when every
// pointer, offset and length allows, else 4-byte words, else bytes.
//
// What bounds it on an H100: bytes, each edge byte read once and written
// once (at the flagship, 4 shards x (3584 + 4608) rows x 512 B x 2 =
// 33.6 MB a call, 0.010 ms at 3.35 TB/s); at that size it is close to
// launch-bound.  Reads over NVLink between cards run at 450 GB/s each way.

#include <cuda_runtime.h>

namespace bbt {

constexpr int kHaloThreads = 256;
constexpr int kHaloMaxSlots = 64;
constexpr long long kHaloChunk = 32 * 1024;   // bytes a block copies

// Passed by value (1.5 KB of the 4 KB of kernel parameters): no table in
// device memory, no copy to set it up.
struct HaloTable {
  const char* src[kHaloMaxSlots];   // each slot's block (local rows)
  char* front[kHaloMaxSlots];       // outputs; null: not on this device
  char* end[kHaloMaxSlots];
};

// grid (chunks, {front, end}, slot)
template <typename V>
__global__ void __launch_bounds__(kHaloThreads)
halo_kernel(HaloTable tab, int n_time, int n_rings, long long local_bytes,
            long long front_bytes, long long end_bytes, int periodic) {
  const int is_end = blockIdx.y;
  const int slot = blockIdx.z;
  char* dst = is_end ? tab.end[slot] : tab.front[slot];
  const long long nbytes = is_end ? end_bytes : front_bytes;
  const long long begin = static_cast<long long>(blockIdx.x) * kHaloChunk;
  if (dst == nullptr || begin >= nbytes) return;
  const long long stop = min(begin + kHaloChunk, nbytes);
  const int t = slot / n_rings;
  const int r = slot % n_rings;
  int nt = is_end ? t + 1 : t - 1;      // the neighbour along time
  bool zero = false;
  if (nt < 0 || nt >= n_time) {
    zero = !periodic;
    nt = (nt + n_time) % n_time;
  }
  // front: the neighbour's trailing rows; end: its leading rows
  const char* src = tab.src[nt * n_rings + r] +
                    (is_end ? 0 : local_bytes - front_bytes);
  for (long long i = begin + threadIdx.x * static_cast<long long>(sizeof(V));
       i < stop; i += kHaloThreads * static_cast<long long>(sizeof(V))) {
    V v{};
    if (!zero) v = *reinterpret_cast<const V*>(src + i);
    *reinterpret_cast<V*>(dst + i) = v;
  }
}

template <typename V>
cudaError_t launch_halo(const HaloTable& tab, int n_time, int n_rings,
                        long long local_bytes, long long front_bytes,
                        long long end_bytes, int periodic,
                        cudaStream_t stream) {
  const long long most = front_bytes > end_bytes ? front_bytes : end_bytes;
  const unsigned chunks =
      static_cast<unsigned>((most + kHaloChunk - 1) / kHaloChunk);
  halo_kernel<V><<<dim3(chunks, 2, n_time * n_rings), kHaloThreads, 0,
                   stream>>>(tab, n_time, n_rings, local_bytes, front_bytes,
                             end_bytes, periodic);
  return cudaGetLastError();
}

}  // namespace bbt

// `src`, `front`, `end`: host arrays of n_time * n_rings device addresses
// in slot order (front/end 0 for shards not on `device`).  Every block
// holds `local_rows` rows of `row_bytes` bytes; the outputs pad_start and
// pad_end rows.
extern "C" int bbt_halo_edges(const long long* src, const long long* front,
                              const long long* end, int n_time, int n_rings,
                              int local_rows, int pad_start, int pad_end,
                              long long row_bytes, int periodic, int device,
                              void* stream) {
  const int slots = n_time * n_rings;
  if (n_time < 1 || n_rings < 1 || slots > bbt::kHaloMaxSlots ||
      row_bytes < 1 || pad_start < 0 || pad_end < 0 ||
      pad_start > local_rows || pad_end > local_rows)
    return cudaErrorInvalidValue;
  if (pad_start == 0 && pad_end == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  bbt::HaloTable tab = {};
  const long long local_bytes = row_bytes * local_rows;
  const long long front_bytes = row_bytes * pad_start;
  const long long end_bytes = row_bytes * pad_end;
  unsigned long long bits = static_cast<unsigned long long>(front_bytes) |
                            static_cast<unsigned long long>(end_bytes) |
                            static_cast<unsigned long long>(local_bytes);
  for (int s = 0; s < slots; ++s) {
    tab.src[s] = reinterpret_cast<const char*>(src[s]);
    tab.front[s] = reinterpret_cast<char*>(front[s]);
    tab.end[s] = reinterpret_cast<char*>(end[s]);
    bits |= static_cast<unsigned long long>(src[s]) |
            static_cast<unsigned long long>(front[s]) |
            static_cast<unsigned long long>(end[s]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits % 16 == 0)
    return bbt::launch_halo<uint4>(tab, n_time, n_rings, local_bytes,
                                   front_bytes, end_bytes, periodic, st);
  if (bits % 4 == 0)
    return bbt::launch_halo<unsigned int>(tab, n_time, n_rings, local_bytes,
                                          front_bytes, end_bytes, periodic,
                                          st);
  return bbt::launch_halo<unsigned char>(tab, n_time, n_rings, local_bytes,
                                         front_bytes, end_bytes, periodic,
                                         st);
}

// Let `device` read `peer`'s memory; peer access already on is success.
extern "C" int bbt_enable_peer(int device, int peer) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();   // clear it, or the next launch check reports it
    return cudaSuccess;
  }
  return err;
}
