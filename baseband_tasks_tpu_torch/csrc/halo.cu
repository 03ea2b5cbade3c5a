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
//
// Across processes (a time ring whose shards belong to several processes
// of one host) the kernel takes its push form, `bbt_halo_push`: the TPU
// kernel's sends, one launch per process.  A table of moves gives, for
// each edge a local shard sends, its destination: a local output, or a
// slot of the receiving process's mailbox, device memory of that process
// mapped here through CUDA IPC (`bbt_ipc_*`); a move with no source
// writes the zeros of a non-periodic ring's open end.  After the launch
// the wrapper writes the receiver's "ready" flag by a stream memory
// operation (`bbt_flag_write`), and the receiver's stream waits for it
// (`bbt_flag_wait`) before a second launch of the same kernel copies its
// slots out into fresh outputs and a "consumed" flag frees them for the
// sender.  The flags are the TPU kernel's semaphores.  The kernel does not
// write a flag itself: a stream's memory operation starts after the
// kernel before it has finished, and its default write carries a memory
// barrier, so no `__threadfence_system()` is needed.  A wait occupies no
// SM (a spinning kernel would take the other process's time slice of a
// shared card).  The CUDA driver API's entry points are resolved at run time
// (`cudaGetDriverEntryPoint`), so the library links no libcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstring>

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


constexpr int kHaloMaxMoves = 2 * kHaloMaxSlots;

// The push form's moves: `src` (null: zeros) to `dst`, moves [0, n_front)
// of front_bytes, the others of end_bytes (2 KB of parameters).
struct HaloMoves {
  const char* src[kHaloMaxMoves];
  char* dst[kHaloMaxMoves];
};

// grid (chunks, moves)
template <typename V>
__global__ void __launch_bounds__(kHaloThreads)
halo_push_kernel(HaloMoves tab, int n_front, long long front_bytes,
                 long long end_bytes) {
  const int m = blockIdx.y;
  const long long nbytes = m < n_front ? front_bytes : end_bytes;
  const long long begin = static_cast<long long>(blockIdx.x) * kHaloChunk;
  if (begin >= nbytes) return;
  const long long stop = min(begin + kHaloChunk, nbytes);
  const char* src = tab.src[m];
  char* dst = tab.dst[m];
  for (long long i = begin + threadIdx.x * static_cast<long long>(sizeof(V));
       i < stop; i += kHaloThreads * static_cast<long long>(sizeof(V))) {
    V v{};
    if (src != nullptr) v = *reinterpret_cast<const V*>(src + i);
    *reinterpret_cast<V*>(dst + i) = v;
  }
}

template <typename V>
cudaError_t launch_push(const HaloMoves& tab, int n_moves, int n_front,
                        long long front_bytes, long long end_bytes,
                        cudaStream_t stream) {
  const long long most = front_bytes > end_bytes ? front_bytes : end_bytes;
  const unsigned chunks =
      static_cast<unsigned>((most + kHaloChunk - 1) / kHaloChunk);
  halo_push_kernel<V><<<dim3(chunks, n_moves), kHaloThreads, 0, stream>>>(
      tab, n_front, front_bytes, end_bytes);
  return cudaGetLastError();
}

// The CUDA driver API's stream memory operations (v2 entry points, CUDA 12,
// supported on every device of a CUDA 12 driver), resolved once.
typedef CUresult (*StreamValueFn)(CUstream, CUdeviceptr, cuuint32_t,
                                  unsigned int);
struct StreamOps {
  StreamValueFn wait = nullptr;
  StreamValueFn write = nullptr;
  cudaError_t err = cudaErrorNotReady;
};

const StreamOps& stream_ops() {
  static StreamOps ops = [] {
    StreamOps o;
    cudaDriverEntryPointQueryResult found;
    o.err = cudaGetDriverEntryPoint("cuStreamWaitValue32",
                                    reinterpret_cast<void**>(&o.wait),
                                    cudaEnableDefault, &found);
    if (o.err == cudaSuccess && found != cudaDriverEntryPointSuccess)
      o.err = cudaErrorSymbolNotFound;
    if (o.err != cudaSuccess) return o;
    o.err = cudaGetDriverEntryPoint("cuStreamWriteValue32",
                                    reinterpret_cast<void**>(&o.write),
                                    cudaEnableDefault, &found);
    if (o.err == cudaSuccess && found != cudaDriverEntryPointSuccess)
      o.err = cudaErrorSymbolNotFound;
    return o;
  }();
  return ops;
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

// The push form: `n_moves` moves (host arrays of device addresses; a
// source of 0 writes zeros), the first `n_front` of front_bytes, the
// others of end_bytes.  A destination may be an IPC-mapped address of
// another process's memory.
extern "C" int bbt_halo_push(const long long* src, const long long* dst,
                             int n_moves, int n_front, long long front_bytes,
                             long long end_bytes, int device, void* stream) {
  if (n_moves < 0 || n_moves > bbt::kHaloMaxMoves || n_front < 0 ||
      n_front > n_moves || front_bytes < 0 || end_bytes < 0)
    return cudaErrorInvalidValue;
  if (n_moves == 0 || (front_bytes == 0 && end_bytes == 0))
    return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  bbt::HaloMoves tab = {};
  unsigned long long bits = static_cast<unsigned long long>(front_bytes) |
                            static_cast<unsigned long long>(end_bytes);
  for (int m = 0; m < n_moves; ++m) {
    if (dst[m] == 0) return cudaErrorInvalidValue;
    tab.src[m] = reinterpret_cast<const char*>(src[m]);
    tab.dst[m] = reinterpret_cast<char*>(dst[m]);
    bits |= static_cast<unsigned long long>(src[m]) |
            static_cast<unsigned long long>(dst[m]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits % 16 == 0)
    return bbt::launch_push<uint4>(tab, n_moves, n_front, front_bytes,
                                   end_bytes, st);
  if (bits % 4 == 0)
    return bbt::launch_push<unsigned int>(tab, n_moves, n_front, front_bytes,
                                          end_bytes, st);
  return bbt::launch_push<unsigned char>(tab, n_moves, n_front, front_bytes,
                                         end_bytes, st);
}

// A mailbox or flag block for other processes to map: `nbytes` of device
// memory by cudaMalloc (the caching allocator's blocks are
// sub-allocations, which IPC cannot export), zeroed before it returns.
extern "C" int bbt_ipc_alloc(long long nbytes, long long* ptr, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  void* p = nullptr;
  err = cudaMalloc(&p, static_cast<size_t>(nbytes));
  if (err != cudaSuccess) return err;
  err = cudaMemset(p, 0, static_cast<size_t>(nbytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    cudaFree(p);
    return err;
  }
  *ptr = reinterpret_cast<long long>(p);
  return cudaSuccess;
}

extern "C" int bbt_ipc_free(long long ptr, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFree(reinterpret_cast<void*>(ptr));
}

// The 64-byte IPC handle of an allocation of bbt_ipc_alloc.
extern "C" int bbt_ipc_export(long long ptr, unsigned char* handle,
                              int device) {
  static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle size");
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, reinterpret_cast<void*>(ptr));
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return err;
}

// Map another process's allocation into this one on `device`; peer access
// is enabled lazily, so the allocation may live on another card of the
// host.
extern "C" int bbt_ipc_open(const unsigned char* handle, long long* ptr,
                            int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  err = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it, or the next launch check reports it
    return err;
  }
  *ptr = reinterpret_cast<long long>(p);
  return cudaSuccess;
}

extern "C" int bbt_ipc_close(long long ptr, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaIpcCloseMemHandle(reinterpret_cast<void*>(ptr));
}

// 1 when this process can order its streams on flags in device memory
// (stream memory operations resolved, a CUDA 12 driver), else 0.
extern "C" int bbt_stream_ops(int device) {
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  int version = 0;
  if (cudaDriverGetVersion(&version) != cudaSuccess || version < 12000)
    return 0;
  return bbt::stream_ops().err == cudaSuccess ? 1 : 0;
}

// Write `value` to the 32-bit flag at `addr` once the stream's earlier
// work has finished (with a memory barrier: the earlier writes are
// visible first).
extern "C" int bbt_flag_write(long long addr, unsigned int value, int device,
                              void* stream) {
  const bbt::StreamOps& ops = bbt::stream_ops();
  if (ops.err != cudaSuccess) return ops.err;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return static_cast<int>(ops.write(static_cast<CUstream>(stream),
                                    static_cast<CUdeviceptr>(addr), value,
                                    CU_STREAM_WRITE_VALUE_DEFAULT));
}

// Hold the stream's later work until the flag at `addr` reaches `value`
// (a cyclic >= on 32 bits).
extern "C" int bbt_flag_wait(long long addr, unsigned int value, int device,
                             void* stream) {
  const bbt::StreamOps& ops = bbt::stream_ops();
  if (ops.err != cudaSuccess) return ops.err;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return static_cast<int>(ops.wait(static_cast<CUstream>(stream),
                                   static_cast<CUdeviceptr>(addr), value,
                                   CU_STREAM_WAIT_VALUE_GEQ));
}
