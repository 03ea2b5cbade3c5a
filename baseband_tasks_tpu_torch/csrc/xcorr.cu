// xcorr: the FX correlator's X stage and its dump sums in one pass.
//
// Replaces no TPU kernel: the JAX package's CrossMultiply is plain jnp (a
// gather of each side of every baseline and an elementwise product) and
// the absorbed Integrate a segment sum of those products.  Here one launch
// a block of spectra adds the products straight into the dump's sums.
//
// In: the block's stacked spectra x, (T, n, cells..., P) complex64 at any
// strides (spectrum, station, up to four frequency-cell axes, then for
// P = 2 the polarization pair; P = 1 gives the elementwise products), and
// the segment id of each spectrum, seg (T,) int64.  Out: sums, (n_seg +
// 1, NB, F, P * P) complex64, contiguous, with F the cells in row-major
// order, NB = n (n + 1) / 2 baselines i <= j in packed upper-triangle
// order and the products p-major (XX*, XY*, YX*, YY*):
// sums[s, b(i, j), f, pq] += x[t, i, f, p] conj(x[t, j, f, q]) over the
// spectra t with seg[t] = s, for 0 <= s < n_seg.  The last row, the trash
// segment n_seg, and any other id are left alone.
//
// Per frequency cell f this is the Hermitian product of the (station,
// pol) x spectra matrix with its conjugate transpose.  What bounds it on
// an H100 is the FP32 rate: 8 operations (4 FMAs) a complex product, 7.7e9
// a block of 64 spectra at LOFAR's 62 stations x 2 pol and 1920 cells,
// 115 us at 67 TFLOP/s, against a 122 MB read of the spectra (36 us) and
// the sums' 240 MB read and write (72 us).
//
// Design (xGPU's register tiles: Clark, La Plante & Greenhill, IJHPCA
// 2013, grown for Hopper).  The work is F nt items (cell, tile), a tile
// kXcTileI x kXcTileJ stations of the triangle of pairs i <= j, and a
// block takes kXcThreads consecutive items, one a thread: the tile's
// station pairs x P x P products sum in its registers.  A spectrum costs
// a thread (kXcTileI + kXcTileJ) shared-memory reads of P complex for
// kXcTileI kXcTileJ P^2 complex FMAs; an SM reads 128 bytes of shared
// memory a cycle against 128 FMAs, so 2 x 2 tiles (4 FMAs a float) are
// bound by the reads, and 4 x 2 tiles (5.3 a float, 161 registers, no
// spill) are the widest that fit 384 threads (ptxas caps them at 168).
// The cells are walked in x's memory order (the wrapper sorts the cell
// axes by stride), so the blocks that run together read neighbouring
// channels.  Threads of a warp run along a row of the triangle, so their
// i side is a broadcast and their j side consecutive words.  Chunks of
// `tc` spectra of the block's cells are staged into a ring of kXcStages
// buffers by 8-byte cp.async, one (station, cell, pol) value each: the
// correlator's stack holds each station's channels contiguous and its
// polarizations far apart, so no wider copy fits it.  A buffer holds a
// spectrum's stations member-major, station s at word (s % kXcTileJ) ncj
// + s / kXcTileJ, so a thread's j stations are conflict-free reads;
// stations past n read zeros.  The ids are uniform over a block: a chunk
// is walked as runs of one id, each run summed in registers by a loop
// with no branch.  When the id changes, and at the end, the registers go
// into sums[id] by reductions (red.global.add.v4.f32, done in L2, so the
// thread does not wait for a read): each output element has one owner in
// a launch and launches are ordered, so one add meets each element and
// the result is the same bit for bit from run to run (the L2's add
// flushes denormals to zero).  Trash spectra are skipped.  Float32 FMAs
// on the CUDA cores only.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace bbt {

constexpr int kXcThreads = 384, kXcTileI = 4, kXcTileJ = 2, kXcChunk = 16,
              kXcStages = 2, kXcMinBlocks = 1;
static_assert(kXcStages >= 2, "the ring needs two buffers");
static_assert((kXcTileI == 2 || kXcTileI == 4) &&
                  (kXcTileJ == 2 || kXcTileJ == 4),
              "tiles of 2 or 4 stations a side");
constexpr int kXcPad = kXcTileI > kXcTileJ ? kXcTileI : kXcTileJ;
constexpr int kXcSmemBudget = 100 * 1024;  // ring, ids, cell offsets
constexpr int kXcMaxAxes = 4;              // cell axes of x

template <int P>
struct XcVec;
template <>
struct XcVec<1> {
  using type = float2;
};
template <>
struct XcVec<2> {
  using type = float4;
};

struct XcGeom {
  int T, n, F, n_seg;
  int ns;   // stations padded to whole tiles on both sides
  int nci;  // i tiles, ns / kXcTileI
  int ncj;  // j tiles, ns / kXcTileJ
  int nt;   // tiles of the triangle
  int fg;   // most cells a block's items touch
  int tc;   // spectra a ring buffer
  // x's strides in complex elements: spectrum, station, polarization;
  // the cell axes in the order the blocks walk them (sizes dims), each
  // with its stride in x and its stride in the sums' cell index
  long long st, ss, sp;
  int nd;
  int dims[kXcMaxAxes];
  long long strides[kXcMaxAxes];
  int out_strides[kXcMaxAxes];
};

// words of the ring's ids, kept even so that the cells' offsets after
// them are 8-byte aligned
__host__ __device__ inline int xcorr_id_words(int tc) {
  return (kXcStages * tc + 1) / 2 * 2;
}

// j tiles of triangle row a: those from the first that holds a j >= i
__host__ __device__ inline int xcorr_c0(int a) {
  return a * kXcTileI / kXcTileJ;
}

// a buffer word of station s
__device__ __forceinline__ int xcorr_word(int s, int ncj) {
  return (s % kXcTileJ) * ncj + s / kXcTileJ;
}

__device__ __forceinline__ void cmac(float2& acc, float ur, float ui,
                                     float vr, float vi) {
  // acc += u conj(v)
  acc.x = fmaf(ur, vr, acc.x);
  acc.x = fmaf(ui, vi, acc.x);
  acc.y = fmaf(ui, vr, acc.y);
  acc.y = fmaf(-ur, vi, acc.y);
}

__device__ __forceinline__ void unpack(float2 (&out)[1], float2 w) {
  out[0] = w;
}
__device__ __forceinline__ void unpack(float2 (&out)[2], float4 w) {
  out[0] = make_float2(w.x, w.y);
  out[1] = make_float2(w.z, w.w);
}

// dst[0..P) += the P * P complex sums a, P at a time
__device__ __forceinline__ void reduce_into(float2* dst, const float2* a) {
  atomicAdd(dst, a[0]);
}
__device__ __forceinline__ void reduce_into(float4* dst, const float2* a) {
  atomicAdd(dst, make_float4(a[0].x, a[0].y, a[1].x, a[1].y));
  atomicAdd(dst + 1, make_float4(a[2].x, a[2].y, a[3].x, a[3].y));
}

// Add a tile's register sums into one segment's row of sums (`out`: its
// baseline 0 at this thread's cell, `fp` words a baseline): baseline
// b(i, j) = i n - i (i + 1) / 2 + j of the pairs i <= j < n.
template <int P>
__device__ __forceinline__ void add_tile(
    float2 (&acc)[kXcTileI][kXcTileJ][P * P],
    typename XcVec<P>::type* out, long long fp, int a, int c, int n) {
#pragma unroll
  for (int ii = 0; ii < kXcTileI; ++ii) {
    const int i = kXcTileI * a + ii;
    auto* row = out + (static_cast<long long>(i) * n -
                       static_cast<long long>(i) * (i + 1) / 2) * fp;
#pragma unroll
    for (int jj = 0; jj < kXcTileJ; ++jj) {
      const int j = kXcTileJ * c + jj;
      if (i <= j && j < n) reduce_into(row + j * fp, acc[ii][jj]);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kXcThreads, kXcMinBlocks)
xcorr_kernel(const float2* __restrict__ x, const long long* __restrict__ seg,
             float2* __restrict__ sums, XcGeom g) {
  using V = typename XcVec<P>::type;
  constexpr int TI = kXcTileI, TJ = kXcTileJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = g.fg * g.ns;  // a spectrum's words in a buffer
  const int stage_elems = g.tc * row;
  V* ring = reinterpret_cast<V*>(smem_raw);
  int* ring_ids = reinterpret_cast<int*>(ring + kXcStages * stage_elems);
  long long* cell_off =
      reinterpret_cast<long long*>(ring_ids + xcorr_id_words(g.tc));
  int* cell_f = reinterpret_cast<int*>(cell_off + g.fg);
  // the block's items (cell, tile), kXcThreads consecutive of the F nt,
  // and the cells they touch
  const long long items = static_cast<long long>(g.F) * g.nt;
  const long long item0 = static_cast<long long>(blockIdx.x) * kXcThreads;
  const int f0 = static_cast<int>(item0 / g.nt);
  const int n_cells =
      static_cast<int>((min(item0 + kXcThreads, items) - 1) / g.nt - f0 + 1);

  // this thread's item; the spare threads of the last block read tile
  // (0, 0) of the block's first cell and write nothing
  const long long item = item0 + threadIdx.x;
  const bool active = item < items;
  const int fl = active ? static_cast<int>(item / g.nt) - f0 : 0;
  int a = 0, c = 0;
  if (active) {
    int rem = static_cast<int>(item % g.nt);
    while (rem >= g.ncj - xcorr_c0(a)) {
      rem -= g.ncj - xcorr_c0(a);
      ++a;
    }
    c = xcorr_c0(a) + rem;
  }

  // each cell's offset in x and its index in the sums
  for (int l = threadIdx.x; l < n_cells; l += blockDim.x) {
    long long off = 0;
    int rest = f0 + l, out = 0;
#pragma unroll
    for (int k = kXcMaxAxes - 1; k >= 0; --k) {
      if (k >= g.nd) continue;
      const int i = rest % g.dims[k];
      off += i * g.strides[k];
      out += i * g.out_strides[k];
      rest /= g.dims[k];
    }
    cell_off[l] = off;
    cell_f[l] = out;
  }
  // the padding stations read zeros
  const int pads = g.ns - g.n;
  if (pads) {
    const V zero = {};
    for (int k = threadIdx.x; k < kXcStages * g.tc * g.fg * pads;
         k += blockDim.x) {
      const int q = k / pads;
      ring[q * g.ns + xcorr_word(g.n + k - q * pads, g.ncj)] = zero;
    }
  }
  __syncthreads();

  // the loads: a chunk's values (t, p) of each column (s, l) of the
  // n n_cells (station, cell) pairs, the block's threads split into
  // `cols` columns at a time and `per_col` threads a column
  const int n_chunks = (g.T + g.tc - 1) / g.tc;
  const int n_col = g.n * n_cells;
  const int cols = min(n_col, static_cast<int>(blockDim.x));
  const int per_col = blockDim.x / cols;
  const int col0 = threadIdx.x % cols, k0 = threadIdx.x / cols;
  auto load = [&](int chunk) {
    const int stage = chunk % kXcStages;
    const int t0 = chunk * g.tc;
    const int n_tp = min(g.tc, g.T - t0) * P;
    float2* dst = reinterpret_cast<float2*>(ring + stage * stage_elems);
    if (k0 < per_col) {
      for (int col = col0; col < n_col; col += cols) {
        const int s = col / n_cells, l = col - s * n_cells;
        const float2* src = x + t0 * g.st + s * g.ss + cell_off[l];
        float2* to = dst + (l * g.ns + xcorr_word(s, g.ncj)) * P;
        for (int tp = k0; tp < n_tp; tp += per_col) {
          const int t = tp / P, p = tp - t * P;
          cp_async(to + t * row * P + p, src + t * g.st + p * g.sp, 8);
        }
      }
    }
    if (threadIdx.x < n_tp / P) {
      const long long id = seg[t0 + threadIdx.x];
      ring_ids[stage * g.tc + threadIdx.x] =
          (id >= 0 && id < g.n_seg) ? static_cast<int>(id) : -1;
    }
  };

  float2 acc[TI][TJ][P * P] = {};
  int cur = -1;  // the segment the registers sum, -1 none
  const long long nb = static_cast<long long>(g.n) * (g.n + 1) / 2;
  // sums[cur] of this thread's cell, P words of V a product row
  const long long fp = static_cast<long long>(g.F) * P;
  V* const cell_sums = reinterpret_cast<V*>(sums) +
                       static_cast<long long>(cell_f[fl]) * P;

#pragma unroll
  for (int c0 = 0; c0 < kXcStages - 1; ++c0) {
    if (c0 < n_chunks) load(c0);
    cp_async_commit();
  }
  // this thread's words in a spectrum's row
  int wi[TI], wj[TJ];
#pragma unroll
  for (int m = 0; m < TI; ++m)
    wi[m] = fl * g.ns + xcorr_word(TI * a + m, g.ncj);
#pragma unroll
  for (int m = 0; m < TJ; ++m) wj[m] = fl * g.ns + m * g.ncj + c;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<kXcStages - 2>();
    __syncthreads();
    // the buffer the last chunk used is free: fill it ahead
    if (chunk + kXcStages - 1 < n_chunks) load(chunk + kXcStages - 1);
    cp_async_commit();
    const int stage = chunk % kXcStages;
    const V* buf = ring + stage * stage_elems;
    const int* ids = ring_ids + stage * g.tc;
    const int nt = min(g.tc, g.T - chunk * g.tc);
    for (int t = 0; t < nt;) {
      const int id = ids[t];
      int end = t + 1;
      while (end < nt && ids[end] == id) ++end;
      if (id != cur) {
        if (cur >= 0 && active)
          add_tile<P>(acc, cell_sums + cur * nb * fp, fp, a, c, g.n);
#pragma unroll
        for (int ii = 0; ii < TI; ++ii)
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
            for (int k = 0; k < P * P; ++k)
              acc[ii][jj][k] = make_float2(0.f, 0.f);
        cur = id;
      }
      if (cur >= 0) {
        // two spectra a step give small tiles their loads' overlap; a 4 x 4
        // tile has it within one, and the second's operands would spill
#pragma unroll(kXcTileI * kXcTileJ < 16 ? 2 : 1)
        for (const V* r = buf + t * row; r < buf + end * row; r += row) {
          float2 u[TI][P];
#pragma unroll
          for (int m = 0; m < TI; ++m) unpack(u[m], r[wi[m]]);
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj) {
            float2 v[P];
            unpack(v, r[wj[jj]]);
#pragma unroll
            for (int ii = 0; ii < TI; ++ii)
#pragma unroll
              for (int p = 0; p < P; ++p)
#pragma unroll
                for (int q = 0; q < P; ++q)
                  cmac(acc[ii][jj][p * P + q], u[ii][p].x, u[ii][p].y,
                       v[q].x, v[q].y);
          }
        }
      }
      t = end;
    }
  }
  if (cur >= 0 && active)
    add_tile<P>(acc, cell_sums + cur * nb * fp, fp, a, c, g.n);
}

// The launch geometry of g's shape (T, n, n_seg, nd, dims set) for P
// polarizations, or false where no launch takes it: a block for each
// kXcThreads consecutive items (cell, tile) of the F nt, walked in the
// order of g's cell axes.
inline bool xcorr_geometry(XcGeom& g, int P, dim3& grid, size_t& smem) {
  if (g.T < 1 || g.n < 1 || g.n_seg < 0 || g.nd < 0 || g.nd > kXcMaxAxes)
    return false;
  g.F = 1;
  for (int k = 0; k < g.nd; ++k) g.F *= g.dims[k];
  if (g.F < 1) return false;
  g.ns = (g.n + kXcPad - 1) / kXcPad * kXcPad;
  g.nci = g.ns / kXcTileI;
  g.ncj = g.ns / kXcTileJ;
  long long nt = 0;
  for (int a = 0; a < g.nci; ++a) nt += g.ncj - xcorr_c0(a);
  g.nt = static_cast<int>(nt);
  g.fg = static_cast<int>(
      std::min<long long>((kXcThreads - 1) / nt + 2, g.F));
  const long per_t = static_cast<long>(g.fg) * g.ns * 8 * P + 4;
  g.tc = static_cast<int>(std::min<long>(
      {static_cast<long>(kXcChunk), static_cast<long>(g.T),
       (kXcSmemBudget - 12L * g.fg - 4) / (kXcStages * per_t)}));
  const long long blocks = (g.F * nt + kXcThreads - 1) / kXcThreads;
  if (g.tc < 1 || blocks > 0x7fffffff) return false;
  grid = dim3(static_cast<unsigned>(blocks));
  // the ring, its ids, the cells' offsets
  smem = static_cast<size_t>(kXcStages) * g.tc * g.fg * g.ns * 8 * P +
         xcorr_id_words(g.tc) * 4 + 12 * g.fg;
  return true;
}

}  // namespace bbt

// `x`: (T, n, cells..., P) complex64 at element strides `st` (spectrum),
// `ss` (station) and `sp` (polarization); its nd <= 4 cell axes of sizes
// `cell_dims`, in the order the blocks walk them (best: x's largest
// stride first), at strides `cell_strides` in x and `out_strides` in the
// sums' cell index; `seg`: (T,) int64; `sums`: (n_seg + 1, n (n + 1) / 2,
// F, P P) complex64, contiguous and 8 P-byte aligned.
extern "C" int bbt_xcorr(const void* x, const void* seg, void* sums, int T,
                         int n, int P, int n_seg, long long st, long long ss,
                         long long sp, int nd, const int* cell_dims,
                         const long long* cell_strides,
                         const long long* out_strides, int device,
                         void* stream) {
  if (P != 1 && P != 2) return cudaErrorInvalidValue;
  bbt::XcGeom g{};
  g.T = T;
  g.n = n;
  g.n_seg = n_seg;
  g.st = st;
  g.ss = ss;
  g.sp = sp;
  g.nd = nd;
  for (int k = 0; k < nd && k < bbt::kXcMaxAxes; ++k) {
    g.dims[k] = cell_dims[k];
    g.strides[k] = cell_strides[k];
    g.out_strides[k] = static_cast<int>(out_strides[k]);
  }
  dim3 grid;
  size_t smem;
  if (!bbt::xcorr_geometry(g, P, grid, smem)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(sums) % (8 * P))
    return cudaErrorMisalignedAddress;
  const auto strm = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float2*>(x);
  const auto* ids = static_cast<const long long*>(seg);
  auto* out = static_cast<float2*>(sums);
  cudaError_t err;
  if (P == 2) {
    err = bbt::prepare(bbt::xcorr_kernel<2>, smem, device);
    if (err != cudaSuccess) return err;
    bbt::xcorr_kernel<2><<<grid, bbt::kXcThreads, smem, strm>>>(xs, ids, out,
                                                                 g);
  } else {
    err = bbt::prepare(bbt::xcorr_kernel<1>, smem, device);
    if (err != cudaSuccess) return err;
    bbt::xcorr_kernel<1><<<grid, bbt::kXcThreads, smem, strm>>>(xs, ids, out,
                                                                 g);
  }
  return cudaGetLastError();
}
