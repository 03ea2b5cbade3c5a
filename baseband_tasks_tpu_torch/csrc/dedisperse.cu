// Coherent dedispersion + detection + fold for one overlap-save window:
// the four-step FFT chain of the flagship pipeline, as three passes.
//
// The window of N = N1 * N2 samples (both powers of two) and L lanes
// (channel x polarization, the contiguous axis) is viewed as (N1, N2, L)
// with time t = c * N2 + b.  Frequency bins live in d-major storage order
// (N2, N1, L), k = d * N1 + c, between the passes; the chirp is stored in
// the same order, so no transpose ever reaches device memory.
//
//   K1  window -> stage-A FFT over c (length N1) -> W_N^{-c b} -> (N2, N1, L)
//   K2  stage-B FFT over b (N2) -> x chirp -> inverse /N2 -> W_N^{+c b}, in place
//   K3  inverse stage-A over c (/N1) -> |z|^2 (or full Stokes) ->
//       fixed-point phase bin -> fold
//
// K1 reads the window as separate re/im planes, plane-packed words, or the
// two halves of a planes-first (2, rows, L) array (k1_planes,
// k1_stream_planes: on the card such an array is two contiguous planes);
// K2 reads the chirp as cos/sin planes or as one phase plane (k2_theta).
//
// What bounds the chain on an H100: bytes.  Each pass moves about
// 2 x 4 B x N x L per plane set (K1 writes it, K2 reads and writes it and
// reads the chirp, K3 reads it): ~1.4 GB per flagship step (N = 2^18,
// L = 128), ~0.42 ms at 3.35 TB/s, against ~6 GFLOP of FFT work.  The
// design keeps every intermediate of a column in shared memory (one read
// and one write of each plane per pass), decodes packed samples in the
// pass that reads them, and folds in the pass that detects, so the
// detected power never goes to device memory.  Each block works on a tile
// of `tl` contiguous lanes, so loads and stores are contiguous runs of
// tl floats; the lane tile is the fastest grid index, so the blocks in
// flight together cover whole rows and device memory is read in full
// rows rather than in scattered tl-float pieces.  All three passes run
// their columns in registers (fft_reg.cuh) and stage the next column by
// cp.async while they transform this one (see K1, k2_reg_kernel and K3
// below; K2 keeps the shared-memory k2_kernel, whose loads keep kBatch in
// flight a thread, for columns longer than 4096); TMA loads and fusing
// the passes are later work.
//
// bf16 intermediates (the JAX module's inter_dtype='bfloat16', whose K1
// stores y in the output's dtype, K2 casts y and the chirp to f32 on load
// and stores z in y's dtype, in place, and K3 casts z on load): each pass
// is templated on the storage type T of the planes between the passes,
// float or __nv_bfloat16, and K2 also on the chirp's type C.  Arithmetic
// stays float32 everywhere: loads are widened where they enter shared
// memory (Raw), stores round to nearest even with __floats2bfloat162_rn
// or __float2bfloat16_rn (JAX's astype).  Traffic per
// sample falls from 48 to 32 bytes over the three passes (28 with a bf16
// chirp).  The lane tile is the float32 one (up to 16 lanes; the column
// in shared memory stays float2); what changes is the global access: a
// thread moves V = 2 neighbouring bf16 lanes as one __nv_bfloat162, the 4
// bytes a float32 thread moves as one lane, so a warp still reads whole
// 32-byte sectors per row of a 16-lane tile.  Wider 16-byte bf16 vectors
// (8 lanes a thread) would make each thread write 64 contiguous bytes of
// the float2 column: 8-way shared-memory bank conflicts on every store, for
// no fewer bytes from device memory.  Tiles of one lane (odd L) take V = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "fft.cuh"
#include "fft_reg.cuh"

namespace bbt {

template <typename T>
constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Store lanes [a, a+V) of plane p, rounded to T (nearest even for bf16).
template <int V, typename T>
__device__ __forceinline__ void store_lanes(T* __restrict__ p, long a,
                                            const float (&v)[V]) {
  if constexpr (!kBf16<T>) {
#pragma unroll
    for (int i = 0; i < V; ++i) p[a + i] = v[i];
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p + a) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[a + i] = __float2bfloat16_rn(v[i]);
  }
}

// V lanes of an (re, im) plane pair as stored: what a batched load holds
// in registers until its store widens it, so kBatch bf16 lane pairs in
// flight take the registers of kBatch float32 lanes (widened at load
// time they took twice as many: 107 against 80 registers in K3, two
// blocks per SM instead of three).
template <int V, typename T>
struct Raw {
  T re[V], im[V];
  __device__ __forceinline__ float2 at(int i) const {
    return make_float2(to_float(re[i]), to_float(im[i]));
  }
};

template <>
struct Raw<2, __nv_bfloat16> {
  __nv_bfloat162 re, im;
  __device__ __forceinline__ float2 at(int i) const {
    return i ? make_float2(__high2float(re), __high2float(im))
             : make_float2(__low2float(re), __low2float(im));
  }
};

// V lanes of the (re, im) plane pair at offset a.
template <int V, typename T>
__device__ __forceinline__ Raw<V, T> load_raw(const T* __restrict__ re,
                                              const T* __restrict__ im,
                                              long a) {
  Raw<V, T> w;
  if constexpr (kBf16<T> && V == 2) {
    w.re = *reinterpret_cast<const __nv_bfloat162*>(re + a);
    w.im = *reinterpret_cast<const __nv_bfloat162*>(im + a);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      w.re[i] = re[a + i];
      w.im[i] = im[a + i];
    }
  }
  return w;
}

__device__ __forceinline__ float decode_field(unsigned f, int bits,
                                              float offset, float4 lv) {
  if (bits >= 4) return static_cast<float>(f) - offset;
  if (bits == 2) return f < 2 ? (f == 0 ? lv.x : lv.y) : (f == 2 ? lv.z : lv.w);
  return f == 0 ? lv.x : lv.w;
}

// ---------------------------------------------------------------------------
// K1: replaces `_k1_body_stream2_packed` (PACKED, dedisperse_pallas.py:764,
// with `_decode_planes` :732 and `_stage_a_twiddle` :201) and
// `_k1_body_stream2` (float32 planes, :570); with no edges (kf = ke = 0)
// and no scale it is also `_k1_body` (:223, the plain window of
// `_dedisperse_impl` and the forward `fft_pallas._fft_impl`) and
// `spectral_filter._k1_filter_body` (:92) without `pre` or scale, launched
// as k1_window (`bbt_k1_window`), and on the two halves of a planes-first
// (2, N, L) window it is `_k1_body_planes` (:229), launched as k1_planes.
// From planes-first block and edge arrays with the scale on every row it
// is `_k1_body_stream` (:240), launched as k1_stream_planes; the
// planes-first layout was a TPU layout choice (:574-577), and on the card
// the halves are plain (rows, L) planes.  With the carry as the front edge, no
// end edge and the scale on the block rows only (edge_scale = 0: the
// carry holds already-scaled samples), it is `_k1_filter_body`'s
// streaming form, launched as k1_stream (`bbt_k1_stream`); its `pre` mix
// is fourstep.cu's lane_mix, run on the output.
//
// Column b of a lane tile is window rows c*N2 + b, c < N1: rows c < kf
// from the front edge (row c*N2+b), rows c >= kf+nm from the end edge,
// and main row m = c-kf either from the float planes (row m*N2+b) or
// field m / nmp of packed word row (m % nmp)*N2+b.  The block scales it,
// runs the FFT over c, multiplies by W_N^{-k b} and stores it as row b of
// the d-major output (rows b*N1 + k).
// What bounds it on an H100: bytes (the window read once: 1/4 of a float
// plane pair for 8-bit words; y written once, float32 or bf16, T =
// __nv_bfloat16 for `_stage_a_stream2(_packed)`'s bf16 out_dtype,
// :587/:787): K1p's are 80 % stores.  The design:
// - Block (lane tile, group) walks a run of consecutive columns b, about
//   one block per resident slot of the card.  Column b + kK1Stages - 1 is
//   staged by cp.async while column b is transformed: whole tile rows
//   (16 lanes: 64-byte rows, as K2 found best) of each plane as stored,
//   the edge rows with the block's, and packed words raw (N1/(32/bits)
//   rows: 16 KB a stage at 8 bits).
// - Each thread reads its rows of the column from the stage into
//   registers, decoding a packed row's field in place (each thread's
//   rows, and so the word row and field each comes from, are fixed for
//   the block's life: one descriptor a row, computed once), and runs the
//   FFT over c there (reg::Plan, radix 8: three passes, two exchanges at
//   N1 = 512; 8.8.4 at 256, 8.8.2 at 128).  The paths' columns (N1 = 512
//   in every form, 256 and 128 for float32 planes, at the full tile) are
//   compiled for their sizes; others take a run-time plan.
// - W_N^{-k b} once a row, not once an element: the threads holding a
//   row's lanes each compute sincospif (the exact argument k b / N, as
//   before) for a share of the rows and take the rest by shuffle.
// - Stores: a row's tile lanes are neighbouring threads, so each store
//   instruction writes whole 64-byte tile rows of the d-major output;
//   kK1Vec > 1 gives each thread kK1Vec neighbouring lanes of the same
//   rows instead (8- or 16-byte stores; bf16 lanes rounded to nearest
//   even, as `store_lanes`).
// When the stages, and the exchange its column's stage buffer turns into
// once read, do not fit twice (packed words: a small stage, a large
// exchange), the exchange has a region of its own.  Sweep knobs
// (tools/fft_sweep.py --only k1): the widest tile, the stage buffers,
// the lanes a thread, and mode 1 (no FFT), 2 (no stores) or 3 (the
// staged loads alone).
constexpr int kK1Lanes = 16, kK1Stages = 2, kK1Vec = 1, kK1Mode = 0;
constexpr int kK1LogR = 3;             // radix-8 register passes
constexpr int kK1MaxThreads = 512;

// (lane, row group) items a thread holds: VL neighbouring lanes of one
// row group, or (VL = 1) two single-lane items, the lane fastest
__host__ __device__ constexpr int k1_items(int vl) { return vl > 1 ? vl : 2; }

// Shared-memory carve of a K1 block: kK1Stages stage buffers (the
// column's planes as stored: N1 float rows, or the edge rows then the
// packed word rows), the exchange when it has a region of its own, the
// twiddle tables.
template <bool PACKED>
struct K1Smem {
  int rows, stage, ex, buf, tw;   // rows a staged plane; the rest bytes
  bool own_ex;
  __host__ __device__ K1Smem(int n1, int tl, int kf, int ke, int nmp) {
    rows = PACKED ? kf + ke + nmp : n1;
    stage = (2 * rows * tl * 4 + 15) / 16 * 16;
    ex = (reg::padded_size<2>(n1 * tl) * 8 + 15) / 16 * 16;
    const int wide = stage > ex ? stage : ex;
    own_ex = kK1Stages * stage + ex < kK1Stages * wide;
    buf = own_ex ? stage : wide;
    tw = reg::twiddle_slots(log2i(n1), kK1LogR) * 8;
  }
  __host__ __device__ int bytes() const {
    return kK1Stages * buf + (own_ex ? ex : 0) + tw;
  }
};

// VL float lanes stored at p + a as one access, rounded to T
template <int VL, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, long a,
                                          const float (&v)[VL]) {
  if constexpr (!kBf16<T>) {
    if constexpr (VL == 4) {
      *reinterpret_cast<float4*>(p + a) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VL == 2) {
      *reinterpret_cast<float2*>(p + a) = make_float2(v[0], v[1]);
    } else {
      p[a] = v[0];
    }
  } else if constexpr (VL == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p + a) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  } else if constexpr (VL == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p + a) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    p[a] = __float2bfloat16_rn(v[0]);
  }
}

// LOG_N1 and LOG_TL fix log2(N1) and the tile at compile time for the
// paths' columns (-1: the launch's arguments); VL lanes a thread.  chunk:
// the cp.async copy size of a tile row (0: plain loads).
template <bool PACKED, typename T, int LOG_N1, int LOG_TL, int VL>
__global__ void __launch_bounds__(kK1MaxThreads)
k1_reg_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const unsigned* __restrict__ xpr,
              const unsigned* __restrict__ xpi, const float* __restrict__ fr,
              const float* __restrict__ fi, const float* __restrict__ er,
              const float* __restrict__ ei, const float* __restrict__ scale,
              float scale_value, int edge_scale, T* __restrict__ yr,
              T* __restrict__ yi, int log_n1_arg, int n2, int L,
              int log_tl_arg, int kf, int ke, int bits, float offset,
              float4 lv, int chunk) {
  constexpr int R = 1 << kK1LogR;
  constexpr int I = k1_items(VL);
  constexpr int TI = VL > 1 ? 1 : I;   // distinct row groups a thread holds
  constexpr int LOG_VL = VL == 4 ? 2 : VL == 2 ? 1 : 0;
  using Plan = reg::Plan<kK1LogR, LOG_N1>;
  extern __shared__ __align__(16) unsigned char k1_smem[];
  const int log_n1 = LOG_N1 >= 0 ? LOG_N1 : log_n1_arg;
  const int log_tl = LOG_TL >= 0 ? LOG_TL : log_tl_arg;
  const Plan plan(log_n1);
  const int n1 = 1 << log_n1;
  const int tl = 1 << log_tl;
  const int nm = n1 - kf - ke;
  const int nmp = PACKED ? nm / (32 / bits) : nm;
  const K1Smem<PACKED> lay(n1, tl, kf, ke, nmp);
  const int plane = lay.rows * tl;     // elements of one staged plane
  float2* own_ex = reinterpret_cast<float2*>(k1_smem + kK1Stages * lay.buf);
  float2* tw = reinterpret_cast<float2*>(k1_smem + kK1Stages * lay.buf +
                                         (lay.own_ex ? lay.ex : 0));
  const int l0 = blockIdx.x << log_tl;
  const int nthreads = blockDim.x;
  const float s = scale ? *scale : scale_value;
  const float se = edge_scale ? s : 1.0f;   // the edges' scale
  const unsigned mask = PACKED ? (1u << bits) - 1u : 0u;
  reg::fill_twiddle_tables(tw, log_n1, kK1LogR);

  // item i of this thread: lane `lane[i]` of the tile, row group t[i];
  // the threads sharing a row group are 2^log_p neighbouring threads
  const int log_p = log_tl > LOG_VL ? log_tl - LOG_VL : 0;
  int t[I], lane[I];
  bool live[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    if constexpr (VL > 1) {
      const int g = threadIdx.x >> log_p;
      live[i] = g < 1 << plan.log_t;
      lane[i] = ((threadIdx.x & ((1 << log_p) - 1)) << LOG_VL) + i;
      t[i] = live[i] ? g : 0;
    } else {
      const int item = threadIdx.x + i * nthreads;
      live[i] = item < tl << plan.log_t;
      lane[i] = item & (tl - 1);
      t[i] = live[i] ? item >> log_tl : 0;
    }
  }
  // packed: where each of this thread's rows comes from, for the block's
  // life: (staged row << 6) | (field shift + 1), shift + 1 = 0 for a
  // float edge row (the front edge rows first, then the end edge's, then
  // the word rows)
  int desc[TI][R];
  if constexpr (PACKED) {
#pragma unroll
    for (int j = 0; j < TI; ++j)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int c = plan.row_in(0, q, t[j]);
        int d;
        if (c < kf) {
          d = c << 6;
        } else if (c >= kf + nm) {
          d = (c - nm) << 6;
        } else {
          const int m = c - kf;
          const int f = m / nmp;
          d = ((kf + ke + m - f * nmp) << 6) | (bits * f + 1);
        }
        desc[j][q] = d;
      }
  }
  float2* ex;                          // the current column's exchange
  auto slot = [&](int i, int row) {
    return ex + reg::pad_slot<2>(row * tl + lane[i]);
  };
  auto sync = [] { __syncthreads(); };

  // column b of both planes into stage buffer s, as [plane][row][lane]
  auto stage_column = [&](int b, unsigned char* sbuf) {
    float* dst = reinterpret_cast<float*>(sbuf);
    const int rows = lay.rows;
    auto src = [&](int p, int r) {
      const float* base;
      int row;
      if (r < kf) {
        base = p ? fi : fr;
        row = r;
      } else if (PACKED ? r < kf + ke : r >= kf + nm) {
        base = p ? ei : er;
        row = r - (PACKED ? kf : kf + nm);
      } else if constexpr (PACKED) {
        base = reinterpret_cast<const float*>(p ? xpi : xpr);
        row = r - kf - ke;
      } else {
        base = p ? xi : xr;
        row = r - kf;
      }
      return base + (static_cast<long>(row) * n2 + b) * L + l0;
    };
    if (chunk) {
      const int per = chunk / 4;
      const int log_cpr = log_tl - (__ffs(per) - 1);   // copies a tile row
      const int total = (2 * rows) << log_cpr;
      for (int i = threadIdx.x; i < total; i += nthreads) {
        const int k = i & ((1 << log_cpr) - 1);
        const int rr = i >> log_cpr;   // plane * rows + row
        const int p = rr >= rows;
        cp_async(dst + rr * tl + k * per, src(p, rr - p * rows) + k * per,
                 chunk);
      }
    } else {
      for (int i = threadIdx.x; i < (2 * rows) << log_tl; i += nthreads) {
        const int rr = i >> log_tl;
        const int p = rr >= rows;
        dst[i] = src(p, rr - p * rows)[i & (tl - 1)];
      }
    }
  };
  auto buf_of = [&](int k) { return k1_smem + (k % kK1Stages) * lay.buf; };

  // this block's run of columns
  const int per_group = (n2 + gridDim.y - 1) / gridDim.y;
  const int b0 = blockIdx.y * per_group;
  const int n_cols = max(0, min(per_group, n2 - b0));
  for (int k = 0; k + 1 < kK1Stages; ++k) {
    if (k < n_cols) stage_column(b0 + k, buf_of(k));
    cp_async_commit();
  }
  const float nf = static_cast<float>(n1) * static_cast<float>(n2);
  // W_N^{-k b} at the compiled tile: the 2^log_p threads of a row group
  // each compute the twiddles of R / P of its rows (P = min(2^log_p, R))
  // and the others take them by shuffle
  constexpr bool kShareTw = LOG_TL >= 0;
  constexpr int kLogPT = LOG_TL > LOG_VL ? LOG_TL - LOG_VL : 0;
  constexpr int kLogP = kLogPT < kK1LogR ? kLogPT : kK1LogR;
  constexpr int kOwn = kShareTw ? R >> kLogP : 1;
  float keep = 0.0f;                   // kK1Mode 2, 3: the results
  for (int k = 0; k < n_cols; ++k) {
    const int b = b0 + k;
    const int ahead = k + kK1Stages - 1;
    if (ahead < n_cols) stage_column(b0 + ahead, buf_of(ahead));
    cp_async_commit();
    cp_async_wait<kK1Stages - 1>();    // column b arrived
    __syncthreads();
    const float* sf = reinterpret_cast<const float*>(buf_of(k));
    const unsigned* su = reinterpret_cast<const unsigned*>(sf);
    ex = lay.own_ex ? own_ex : reinterpret_cast<float2*>(buf_of(k));
    float2 v[I][R];
#pragma unroll
    for (int i = 0; i < I; ++i) {
      const int j = TI > 1 ? i : 0;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        v[i][q] = make_float2(0.0f, 0.0f);
        if (!live[i] || q >= plan.used) continue;
        if constexpr (PACKED) {
          const int d = desc[j][q];
          const int a = (d >> 6) * tl + lane[i];
          const int sh = (d & 63) - 1;
          if (sh < 0) {
            v[i][q] = make_float2(sf[a] * se, sf[a + plane] * se);
          } else {
            const unsigned fr_ = (su[a] >> sh) & mask;
            const unsigned fi_ = (su[a + plane] >> sh) & mask;
            v[i][q] = make_float2(decode_field(fr_, bits, offset, lv) * s,
                                  decode_field(fi_, bits, offset, lv) * s);
          }
        } else {
          const int c = plan.row_in(0, q, t[i]);
          const int a = c * tl + lane[i];
          const float f = c < kf || c >= kf + nm ? se : s;
          v[i][q] = make_float2(sf[a] * f, sf[a + plane] * f);
        }
      }
    }
    if (kK1Mode == 0 || kK1Mode == 2)
      plan.template run<false>(v, t, live, tw, slot, sync);
    if (kK1Mode == 3) {
#pragma unroll
      for (int i = 0; i < I; ++i)
#pragma unroll
        for (int q = 0; q < R; ++q) keep += v[i][q].x + v[i][q].y;
    } else {
      auto twiddle = [&](int kk) {
        float sn, cs;
        sincospif(-2.0f * static_cast<float>(kk * b) / nf, &sn, &cs);
        return make_float2(cs, sn);
      };
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        float2 own[kOwn];
        if constexpr (kShareTw) {
#pragma unroll
          for (int o = 0; o < kOwn; ++o)
            own[o] = twiddle(plan.rows_final(
                (o << kLogP) + (threadIdx.x & ((1 << kLogP) - 1)), t[j]));
        }
#pragma unroll
        for (int q = 0; q < R; ++q) {
          float2 w = make_float2(1.0f, 0.0f);
          if constexpr (kShareTw) {
            if constexpr (kLogP == 0) {
              w = own[q];
            } else {
              const int src = (threadIdx.x & 31 & ~((1 << kLogPT) - 1)) |
                              (q & ((1 << kLogP) - 1));
              w.x = __shfl_sync(0xffffffffu, own[q >> kLogP].x, src);
              w.y = __shfl_sync(0xffffffffu, own[q >> kLogP].y, src);
            }
          }
          if (!live[j] || q >= plan.used) continue;
          const int row = plan.rows_final(q, t[j]);
          if constexpr (!kShareTw) w = twiddle(row);
          const long o = (static_cast<long>(b) * n1 + row) * L + l0;
          if constexpr (VL > 1) {
            float re[VL], im[VL];
#pragma unroll
            for (int i = 0; i < VL; ++i) {
              const float2 out = cmul(v[i][q], w);
              re[i] = out.x;
              im[i] = out.y;
            }
            if (kK1Mode == 2) {
              keep += re[0] + im[VL - 1];
              continue;
            }
            store_vec<VL>(yr, o + lane[0], re);
            store_vec<VL>(yi, o + lane[0], im);
          } else {
            const float2 out = cmul(v[j][q], w);
            if (kK1Mode == 2) {
              keep += out.x + out.y;
              continue;
            }
            const float re[1] = {out.x}, im[1] = {out.y};
            store_vec<1>(yr, o + lane[j], re);
            store_vec<1>(yi, o + lane[j], im);
          }
        }
      }
    }
    // the next column's copies go to the buffer this one was staged and
    // exchanged in: every thread must be done reading it (an exchange of
    // its own is free once the next column's first exchange barrier has
    // passed, and this column's stage buffer since its own)
    if (!lay.own_ex || plan.passes < 2 || kK1Mode == 1 || kK1Mode == 3)
      __syncthreads();
  }
  if (kK1Mode >= 2 && keep == -1.0f) {
    const float kk[1] = {keep};
    store_vec<1>(yr, 0, kk);
  }
}

// ---------------------------------------------------------------------------
// K2: replaces `_k2_body` (dedisperse_pallas.py:259, launched by `_stage_b`
// :429) and, with THETA, `_k2_body_theta` (:286, launched by
// `_stage_b_theta` :460).  Two forms under each launch name: the register
// kernel k2_reg_kernel below for columns of up to 4096 rows (the paths'
// 512), and this shared-memory kernel for longer ones (launch_k2 picks;
// bbt_k2_form says which).  Block (lane tile, c) loads column c of the
// d-major planes (rows b*N1+c), runs the forward FFT over b (DIF: the
// spectrum comes out in bit-reversed order, so the chirp row is read at
// d = bitrev(position)), multiplies by the chirp, runs the inverse FFT
// (DIT: back to natural order), scales by 1/N2, applies W_N^{+c b} and
// writes the column back in place, as the TPU kernel aliases input and
// output.  The chirp is two planes (cos, sin) or, with THETA, one phase
// plane in cycles whose cos/sin the block computes with sincospif (exact
// argument scaling by pi), reading one chirp plane instead of two.
// Bound: bytes (read two planes and two chirp planes, write two planes;
// THETA: one chirp plane, five plane passes instead of six).  With T =
// __nv_bfloat16 the planes are bf16 (`_k2_body`'s casts, :267-270, and its
// stores in y's dtype, :282-283), and the chirp C float32 or bf16.
template <bool THETA, typename T, typename C, int V>
__global__ void __launch_bounds__(kThreads)
k2_kernel(T* __restrict__ yr, T* __restrict__ yi,
          const C* __restrict__ csr, const C* __restrict__ csi,
          int log_n1, int log_n2, int L, int log_tl) {
  extern __shared__ float2 smem[];
  const int n1 = 1 << log_n1;
  const int n2 = 1 << log_n2;
  const int tl = 1 << log_tl;
  float2* x = smem;
  float2* tw = smem + (n2 << log_tl);
  const int c = blockIdx.y;
  const int l0 = blockIdx.x << log_tl;
  fill_twiddles(tw, n2);

  const int total = n2 << log_tl;
  // (row, lane) of element idx of the column -> offset in the planes
  auto at = [&](int row, int idx) {
    return (static_cast<long>(row) * n1 + c) * L + l0 + (idx & (tl - 1));
  };
  // element e of the column, V lanes at a time (e a multiple of V)
  batched(total / V,
          [&](int g) {
            const int e = g * V;
            return load_raw<V>(yr, yi, at(e >> log_tl, e));
          },
          [&](int g, const Raw<V, T>& w) {
#pragma unroll
            for (int i = 0; i < V; ++i) x[g * V + i] = w.at(i);
          });
  __syncthreads();
  fft_dif<false>(x, tw, log_n2, log_tl);
  if constexpr (THETA) {
    static_assert(V == 1 && !kBf16<T>, "k2_theta takes float32 planes");
    batched(total,
            [&](int idx) { return csr[at(bitrev(idx >> log_tl, log_n2), idx)]; },
            [&](int idx, float th) {
              float sn, cs;
              sincospif(2.0f * th, &sn, &cs);
              x[idx] = cmul(x[idx], make_float2(cs, sn));
            });
  } else {
    batched(total / V,
            [&](int g) {
              const int e = g * V;
              return load_raw<V>(csr, csi, at(bitrev(e >> log_tl, log_n2), e));
            },
            [&](int g, const Raw<V, C>& w) {
#pragma unroll
              for (int i = 0; i < V; ++i) x[g * V + i] = cmul(x[g * V + i], w.at(i));
            });
  }
  __syncthreads();
  fft_dit<true>(x, tw, log_n2, log_tl);

  const float inv_n2 = 1.0f / static_cast<float>(n2);
  const float nf = static_cast<float>(n1) * static_cast<float>(n2);
  for (int e = threadIdx.x * V; e < total; e += blockDim.x * V) {
    const int lane = e & (tl - 1);
    const int b = e >> log_tl;
    float sn, cs;
    sincospif(2.0f * static_cast<float>(c * b) / nf, &sn, &cs);
    float re[V], im[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float2 v = x[e + i];
      const float2 out =
          cmul(make_float2(v.x * inv_n2, v.y * inv_n2), make_float2(cs, sn));
      re[i] = out.x;
      im[i] = out.y;
    }
    const long o = at(b, lane);
    store_lanes<V>(yr, o, re);
    store_lanes<V>(yi, o, im);
  }
}

// K2 in registers: the same function as k2_kernel, for every stage-B
// column the register budget below holds (N2 up to 4096; larger columns
// keep k2_kernel).  Block (lane tile, group) walks a run of consecutive
// columns c (about one block per resident slot of the card).  For each:
// - column c + kK2Stages - 1 is staged by cp.async while this one is
//   transformed: 16-byte (or smaller) copies of a tile row of each plane
//   as stored (y re, y im, the chirp's two planes or THETA's one), so bf16
//   stays bf16 until it is read into registers and widened, as `_k2_body`
//   casts (:267-270); each stage buffer then serves as its column's
//   exchange;
// - each thread reads its R = 8 rows of one lane and the chirp at the
//   rows it will hold after the forward FFT (the Stockham output is in
//   natural frequency order, so chirp row d is flat row d of the d-major
//   storage: no bit-reversed gather), then runs the forward FFT over b in
//   registers (reg::Plan, radix 8: three passes, two exchanges at
//   N2 = 512), multiplies by the chirp, and runs the inverse FFT on the
//   same registers: at a compiled size a thread ends the forward FFT with
//   the rows it began with, so the inverse takes its inputs by renamed
//   registers (Plan::to_inputs), with no exchange between the two;
// - 1/N2 and W_N^{+c b}: one sincospif per row on the exact argument,
//   shared by the tile's lanes (each computes its share of the rows and
//   shuffles), then the column is stored in place, a tile row a run.
// What bounds it: bytes (six plane passes; five with THETA).  A column's
// rows lie N1 x L elements apart, so each tile row is a separate run of
// device memory: the tile is 16 lanes (64-byte float32 rows), with which
// the kernel moves its bytes about 1.3x faster than with 8 (32-byte rows,
// tools/fft_sweep.py), and two (lane, row group) items a thread keep the
// 16-lane block at 512 threads.  What holds it back is device memory: the
// sweep's variant without FFTs takes about as long as the kernel.  The
// flagship's column (N2 = 512, the 16- and 8-lane tiles) is compiled for
// its size, as is the compiled PFB chains' (N2 = 256, 512 lanes).  Sweep
// knobs (tools/fft_sweep.py): the widest tile, the stage buffers, the
// items a thread, where the chirp comes from, and mode 1 (no FFT: the
// staged loads, the products and the stores) or 2 (no stores).  The
// chirp is staged with the planes when the stage buffers hold it at the
// widest tile; else float32 k2 reads it from device memory into registers
// at the column's start (kK2Chirp 0: N2 = 512's 16-lane float32 column
// and chirp do not fit twice; N2 = 256's do).  The bf16 and theta forms
// always stage theirs, whose widening or sincospif at the load would
// stall it.  kK2Chirp 1: float32 k2 always into registers; 2: always
// staged, on a narrower tile if it must.
constexpr int kK2Lanes = 16, kK2Stages = 2, kK2Items = 2, kK2Chirp = 0,
              kK2Mode = 0;
constexpr int kK2LogR = 3;             // radix-8 register passes
constexpr int kK2MaxThreads = 512;

// Shared-memory carve of a register-K2 block: kK2Stages buffers, each a
// column's staged planes (y re, y im as T, then, when `staged`, the
// chirp's planes as C) and then that column's exchange; then the twiddle
// tables.
template <bool THETA, typename T, typename C>
struct K2Smem {
  int buf, tw;   // bytes
  __host__ __device__ K2Smem(int n2, int tl, bool staged) {
    const int row = 2 * static_cast<int>(sizeof(T)) +
                    (staged ? (THETA ? 1 : 2) * static_cast<int>(sizeof(C))
                            : 0);
    const int stage = n2 * tl * row;
    const int ex = reg::padded_size<2>(n2 * tl) * 8;
    buf = ((stage > ex ? stage : ex) + 15) / 16 * 16;
    tw = reg::twiddle_slots(log2i(n2), kK2LogR) * 8;
  }
  __host__ __device__ int bytes() const { return kK2Stages * buf + tw; }
};

// LOG_N2 and LOG_TL fix log2(N2) and the tile at compile time for the
// paths' columns (-1: the launch's arguments).  chunk_y / chunk_c: the
// cp.async copy size of the planes / the chirp (0: plain loads); staged:
// the chirp comes with the planes (else from device memory, float32 k2).
template <bool THETA, typename T, typename C, int LOG_N2, int LOG_TL>
__global__ void __launch_bounds__(kK2MaxThreads)
k2_reg_kernel(T* __restrict__ yr, T* __restrict__ yi,
              const C* __restrict__ csr, const C* __restrict__ csi,
              int log_n1, int log_n2_arg, int L, int log_tl_arg, int chunk_y,
              int chunk_c, int staged) {
  constexpr int R = 1 << kK2LogR;
  constexpr int I = kK2Items;
  using Plan = reg::Plan<kK2LogR, LOG_N2>;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  const int log_n2 = LOG_N2 >= 0 ? LOG_N2 : log_n2_arg;
  const int log_tl = LOG_TL >= 0 ? LOG_TL : log_tl_arg;
  const Plan plan(log_n2);
  const int n1 = 1 << log_n1;
  const int n2 = 1 << log_n2;
  const int tl = 1 << log_tl;
  const int plane = n2 << log_tl;      // elements of one staged plane
  const K2Smem<THETA, T, C> lay(n2, tl, staged);
  float2* tw = reinterpret_cast<float2*>(k2_smem + kK2Stages * lay.buf);
  const int l0 = blockIdx.x << log_tl;
  const int nthreads = blockDim.x;
  reg::fill_twiddle_tables(tw, log_n2, kK2LogR);

  // item i of this thread: lane `lane[i]` of the tile, row group t[i]
  int t[I], lane[I];
  bool live[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int item = threadIdx.x + i * nthreads;
    live[i] = item < tl << plan.log_t;
    lane[i] = item & (tl - 1);
    t[i] = live[i] ? item >> log_tl : 0;
  }
  float2* ex;                          // the current column's exchange
  auto slot = [&](int i, int row) {
    return ex + reg::pad_slot<2>(row * tl + lane[i]);
  };
  auto sync = [] { __syncthreads(); };

  // np planes (p0, then p1) of column c, rows b = 0 .. N2-1 of the tile,
  // into dst as [plane][row][lane]
  auto stage_planes = [&](auto* dst, const auto* p0, const auto* p1, int np,
                          int c, int chunk) {
    using U = std::remove_pointer_t<decltype(dst)>;
    const long col = static_cast<long>(c) * L + l0;   // + b * n1 * L
    const long row_stride = static_cast<long>(n1) * L;
    if (chunk) {
      const int per = chunk / static_cast<int>(sizeof(U));
      const int log_cpr = log_tl - (__ffs(per) - 1);   // copies a tile row
      const int total = (np * n2) << log_cpr;
      for (int i = threadIdx.x; i < total; i += nthreads) {
        const int k = i & ((1 << log_cpr) - 1);
        const int row = (i >> log_cpr) & (n2 - 1);
        const int pl = i >> (log_cpr + log_n2);
        cp_async(dst + (pl * n2 + row) * tl + k * per,
                 (pl ? p1 : p0) + row * row_stride + col + k * per, chunk);
      }
    } else {
      for (int i = threadIdx.x; i < (np * n2) << log_tl; i += nthreads) {
        const int row = (i >> log_tl) & (n2 - 1);
        const int pl = i >> (log_tl + log_n2);
        dst[i] = (pl ? p1 : p0)[row * row_stride + col + (i & (tl - 1))];
      }
    }
  };
  auto buf_of = [&](int k) { return k2_smem + (k % kK2Stages) * lay.buf; };
  auto stage_column = [&](int c, unsigned char* s) {
    stage_planes(reinterpret_cast<T*>(s), yr, yi, 2, c, chunk_y);
    if (staged)
      stage_planes(reinterpret_cast<C*>(s + 2 * plane * sizeof(T)), csr, csi,
                   THETA ? 1 : 2, c, chunk_c);
  };

  // this block's run of columns
  const int per_group = (n1 + gridDim.y - 1) / gridDim.y;
  const int cb = blockIdx.y * per_group;
  const int n_cols = max(0, min(per_group, n1 - cb));
  for (int k = 0; k + 1 < kK2Stages; ++k) {
    if (k < n_cols) stage_column(cb + k, buf_of(k));
    cp_async_commit();
  }
  const float inv_n2 = 1.0f / static_cast<float>(n2);
  const float nf = static_cast<float>(n1) * static_cast<float>(n2);
  // the flagship's tile: a row's lanes are neighbouring threads that share
  // its twiddle, so each of the first P = min(tl, R) computes the
  // twiddles of R / P rows and the others take them by shuffle
  constexpr bool kShareTw = LOG_TL >= 1;
  constexpr int kLogP = LOG_TL < kK2LogR ? LOG_TL : kK2LogR;
  constexpr int kOwn = kShareTw ? R >> kLogP : 1;
  float keep = 0.0f;                   // kK2Mode 2: the results
  for (int k = 0; k < n_cols; ++k) {
    const int c = cb + k;
    const int ahead = k + kK2Stages - 1;
    if (ahead < n_cols) stage_column(cb + ahead, buf_of(ahead));
    cp_async_commit();
    cp_async_wait<kK2Stages - 1>();    // column c arrived
    __syncthreads();
    const unsigned char* s = buf_of(k);
    const T* sy = reinterpret_cast<const T*>(s);
    const C* sc = reinterpret_cast<const C*>(s + 2 * plane * sizeof(T));
    ex = reinterpret_cast<float2*>(buf_of(k));
    // this thread's rows of y, and the chirp at the frequency rows it
    // holds after the forward FFT
    float2 v[I][R], ch[I][R];
#pragma unroll
    for (int i = 0; i < I; ++i) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        v[i][q] = make_float2(0.0f, 0.0f);
        ch[i][q] = make_float2(1.0f, 0.0f);
        if (!live[i] || q >= plan.used) continue;
        const int a = plan.row_in(0, q, t[i]) * tl + lane[i];
        v[i][q] = make_float2(to_float(sy[a]), to_float(sy[a + plane]));
        const int row = plan.rows_final(q, t[i]);
        const int d = row * tl + lane[i];
        if constexpr (THETA) {
          float sn, cs;
          sincospif(2.0f * to_float(sc[d]), &sn, &cs);
          ch[i][q] = make_float2(cs, sn);
        } else if (staged) {
          ch[i][q] = make_float2(to_float(sc[d]), to_float(sc[d + plane]));
        } else {
          const long g = (static_cast<long>(row) * n1 + c) * L + l0 + lane[i];
          ch[i][q] = make_float2(to_float(csr[g]), to_float(csi[g]));
        }
      }
    }
    if (kK2Mode != 1) plan.template run<false>(v, t, live, tw, slot, sync);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int q = 0; q < R; ++q) v[i][q] = cmul(v[i][q], ch[i][q]);
    if constexpr (LOG_N2 >= 1) {
#pragma unroll
      for (int i = 0; i < I; ++i) Plan::to_inputs(v[i]);
    } else {                           // natural order back to row_in(0)
      __syncthreads();
#pragma unroll
      for (int i = 0; i < I; ++i) {
        if (!live[i]) continue;
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (q < plan.used) *slot(i, plan.rows_final(q, t[i])) = v[i][q];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < I; ++i) {
        if (!live[i]) continue;
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (q < plan.used) v[i][q] = *slot(i, plan.row_in(0, q, t[i]));
      }
    }
    if (kK2Mode != 1) plan.template run<true>(v, t, live, tw, slot, sync);
    // 1/N2, W_N^{+c b} and the store of row b = rows_final(q, t)
    auto twiddle = [&](int b) {
      float sn, cs;
      sincospif(2.0f * static_cast<float>(c * b) / nf, &sn, &cs);
      return make_float2(cs * inv_n2, sn * inv_n2);
    };
#pragma unroll
    for (int i = 0; i < I; ++i) {
      float2 own[kOwn];
      if constexpr (kShareTw) {
#pragma unroll
        for (int j = 0; j < kOwn; ++j)
          own[j] = twiddle(plan.rows_final(
              (j << kLogP) + (lane[i] & ((1 << kLogP) - 1)), t[i]));
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float2 w = make_float2(0.0f, 0.0f);
        if constexpr (kShareTw) {
          const int src = (threadIdx.x & 31 & ~((1 << LOG_TL) - 1)) |
                          (q & ((1 << kLogP) - 1));
          w.x = __shfl_sync(0xffffffffu, own[q >> kLogP].x, src);
          w.y = __shfl_sync(0xffffffffu, own[q >> kLogP].y, src);
        }
        if (!live[i] || q >= plan.used) continue;
        const int b = plan.rows_final(q, t[i]);
        if constexpr (!kShareTw) w = twiddle(b);
        const float2 out = cmul(v[i][q], w);
        if (kK2Mode == 2) {
          keep += out.x + out.y;
          continue;
        }
        const long o = (static_cast<long>(b) * n1 + c) * L + l0 + lane[i];
        const float re[1] = {out.x}, im[1] = {out.y};
        store_lanes<1>(yr, o, re);
        store_lanes<1>(yi, o, im);
      }
    }
    // the next column's copies go to the buffer this one was staged and
    // exchanged in: every thread must be done reading it
    __syncthreads();
  }
  if (kK2Mode == 2 && keep == -1.0f) yr[0] = yr[1];
}

// ---------------------------------------------------------------------------
// K3: replaces `_k3_fold_body` (dedisperse_pallas.py:381, launched by
// `_fold_pallas_call` :618) with `_detect_fold_accumulate` (:332): the
// power branch, and with STOKES the full-Stokes branch.
//
// Block (lane tile, group) walks a run of consecutive columns b (about one
// block per resident slot of the card, so each walks many): row b of the
// d-major planes for a tile of tl lanes, the inverse FFT over c
// (fft_reg.cuh, natural order in and out: the sample of time t = c*N2 + b
// sits at row c), 1/N1, |z|^2, and the phase bin in 31-bit fixed point:
//   num = (i0 + t*p) & 0x7FFFFFFF in uint32 (wraps mod 2^32 by definition,
//   where the TPU relied on int32 wrap), then
//   bin = ((num>>16)*n + (((num&0xFFFF)*n)>>16)) >> 15     (n <= 2^15),
// with rows outside [pad_start, pad_start+n_valid) in trash bin n_phase.
// With STOKES the profile has three planes of L lanes, [|z_l|^2 |
// Re z_l conj z_{l+1} | Im z_l conj z_{l+1}], lane l paired with lane
// (l+1) mod L as the TPU's one-lane roll pairs them (the cross terms of a
// dual-pol channel are those of its even, X, lane).  The tile's last
// lane pairs with lane (l0+tl) mod L of the next tile, so the block loads
// that lane too and transforms it beside the tile in the same register
// passes (threads of their own: 1/tl more work); a lane's partner is the
// next thread's item (a shuffle), the last lane's comes from the partner
// threads through shared memory.
// Design (what bounds it on an H100: bytes, the two planes read once,
// 1/tl more with STOKES; nothing but the profile is written):
// - The column's butterflies run in registers (reg::Plan, radix 8: three
//   passes and two shared-memory exchanges at N1 = 512, against fft.cuh's
//   three shared passes of three stages), each thread holding 8 rows of
//   one lane for fold_items (lane, row group) items; the flagship's
//   shape (N1 = 512, the 8-lane tile) is compiled for its sizes.
// - The next column is staged while this one is transformed and folded:
//   kFoldStages buffers filled by cp.async (16-byte copies of a tile row
//   of a plane, as stored: bf16 stays bf16 until it is read into
//   registers and widened, as `_k3_fold_body` casts, :412-413), each
//   reused as its column's exchange once read.  Power: two blocks, 16
//   warps, per SM; Stokes (one item a thread, 576 threads): one.
// - Shared float atomics are compare-and-swap loops on this card, and a
//   row's bin moves by one sample from one column to the next, so each
//   register slot sums its run of equal bins over the block's columns
//   and adds the run to the shared partials only when the bin changes
//   (kFoldRuns; 0: one atomic per value); a Stokes run's two cross sums
//   go in one 64-bit compare-and-swap.  The partials (float sums,
//   integer counts) go to the global (n_phase+1, W*L) profile and
//   (n_phase+1,) counts with one atomic per entry at the block's end.
//   Counts are taken by the lane-0 items of the lane-tile-0 blocks only
//   (the bin depends on t alone), once per row.  When the partials do not
//   fit shared memory (huge n_phase) the runs go to global atomics.
// - A row's 8 lanes are 8 neighbouring threads with the same bins: each
//   computes one of the row group's 8 bins and shuffles it to the others.
// What holds it back (tools/fft_sweep.py, which times the tile width,
// one stage against two or three, the runs against an atomic per value,
// and the kernel without its FFT or without its fold, kFoldMode 1, 2): the staged loads and the fold alone, and
// the FFT alone, each take about 0.14 ms of the power form's ~0.19, and
// overlap only in part.
constexpr int kFoldLanes = 8, kFoldStages = 2, kFoldMode = 0, kFoldRuns = 1;
constexpr int kFoldLogR = 3;           // radix-8 register passes

// (lane, row group) items a thread holds: one with STOKES (whose run
// sums take three registers a row) on tiles of up to 8 lanes, else two
template <bool STOKES>
__host__ __device__ constexpr int fold_items() {
  return STOKES && kFoldLanes <= 8 ? 1 : 2;
}

// threads of a block at N1 = 512 (64 row groups): the tile's items, then
// with STOKES the partner column's, each in whole warps
template <bool STOKES>
__host__ __device__ constexpr int fold_threads(int tl = kFoldLanes) {
  return (64 * tl / fold_items<STOKES>() + 31) / 32 * 32 +
         (STOKES ? (64 / fold_items<STOKES>() + 31) / 32 * 32 : 0);
}

// Shared-memory carve of a K3 block (host and device): kFoldStages
// buffers, each a column's staged planes and then, once they are read
// into registers, that column's exchange (the tile's lanes, then the
// Stokes partner's column and its transform's rows); the twiddles; the
// partials.
template <bool STOKES, typename T>
struct FoldSmem {
  // bf16 partners are staged as the aligned 4-byte lane pair they open
  static constexpr int kPartnerWords = kBf16<T> ? 2 : 1;
  int ex_main, buf, tw, acc;   // ex_main in float2 slots, the rest bytes
  __host__ __device__ FoldSmem(int n1, int tl, int n_phase, int smem_acc) {
    const int elems = 2 * n1 * tl + (STOKES ? 2 * n1 * kPartnerWords : 0);
    const int stage = elems * static_cast<int>(sizeof(T));
    ex_main = reg::padded_size<2>(n1 * tl);
    const int ex = (ex_main + (STOKES ? 2 * reg::padded_size<1>(n1) : 0)) * 8;
    buf = ((stage > ex ? stage : ex) + 15) / 16 * 16;
    tw = reg::twiddle_slots(log2i(n1), kFoldLogR) * 8;
    acc = smem_acc ? ((n_phase + 1) * (STOKES ? 3 : 1) * tl + n_phase + 1) * 4
                   : 0;
  }
  __host__ __device__ int bytes() const { return kFoldStages * buf + tw + acc; }
};

// LOG_N1 and LOG_TL fix log2(N1) and the tile at compile time for the
// flagship's shape (-1: the launch's arguments).  Threads [0, n_main)
// hold the tile's lanes, lane fastest; with STOKES threads [n_main,
// blockDim.x) hold the partner lane's column.
template <bool STOKES, typename T, int LOG_N1, int LOG_TL>
__global__ void __launch_bounds__(fold_threads<STOKES>())
k3_fold_kernel(const T* __restrict__ zr, const T* __restrict__ zi,
               const int* __restrict__ fold, float* __restrict__ prof,
               unsigned* __restrict__ cnt, int log_n1_arg, int log_n2, int L,
               int log_tl_arg, int n_phase, int pad_start, int n_valid,
               int smem_acc, int n_main, int chunk) {
  constexpr int W = STOKES ? 3 : 1;   // profile planes
  constexpr int R = 1 << kFoldLogR;
  constexpr int I = fold_items<STOKES>();
  constexpr int PW = FoldSmem<STOKES, T>::kPartnerWords;
  constexpr unsigned kNoBin = 0xffffffffu;
  using Plan = reg::Plan<kFoldLogR, LOG_N1>;
  extern __shared__ __align__(16) unsigned char k3_smem[];
  const int log_n1 = LOG_N1 >= 0 ? LOG_N1 : log_n1_arg;
  const int log_tl = LOG_TL >= 0 ? LOG_TL : log_tl_arg;
  const Plan plan(log_n1);
  const int n1 = 1 << log_n1;
  const int n2 = 1 << log_n2;
  const int tl = 1 << log_tl;
  const FoldSmem<STOKES, T> lay(n1, tl, n_phase, smem_acc);
  T* stages = reinterpret_cast<T*>(k3_smem);
  float2* tw = reinterpret_cast<float2*>(k3_smem + kFoldStages * lay.buf);
  float* pprof = reinterpret_cast<float*>(k3_smem + kFoldStages * lay.buf +
                                          lay.tw);
  const int acc_rows = (n_phase + 1) * W;
  unsigned* pcnt = reinterpret_cast<unsigned*>(pprof + acc_rows * tl);
  const int l0 = blockIdx.x << log_tl;
  const int lp = (l0 + tl) % L;            // partner of the tile's last lane
  const bool counter = blockIdx.x == 0;
  const int nthreads = blockDim.x;
  reg::fill_twiddle_tables(tw, log_n1, kFoldLogR);
  if (smem_acc) {
    for (int i = threadIdx.x; i < acc_rows * tl; i += nthreads)
      pprof[i] = 0.0f;
    for (int i = threadIdx.x; i <= n_phase; i += nthreads) pcnt[i] = 0u;
  }
  const unsigned i0 = static_cast<unsigned>(fold[0]);
  const unsigned p = static_cast<unsigned>(fold[1]);
  const unsigned nph = static_cast<unsigned>(n_phase);
  const float inv_n1 = 1.0f / static_cast<float>(n1);
  // add the W sums v to phase row `bin`, lane `lane` of the tile.  The
  // shared partials hold a bin's power sums for the tile's lanes, then
  // with STOKES each lane's (Re, Im) cross sums side by side, which one
  // 64-bit compare-and-swap adds together
  auto add = [&](unsigned bin, int lane, const float (&v)[W]) {
    if (!smem_acc) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        atomicAdd(&prof[(static_cast<long>(bin) * W + k) * L + l0 + lane],
                  v[k]);
      return;
    }
    float* row = pprof + static_cast<int>(bin) * W * tl;
    atomicAdd(&row[lane], v[0]);
    if constexpr (STOKES) {
      float* pair = row + tl + 2 * lane;
      if (tl & 1) {                  // pairs not 8-byte aligned
        atomicAdd(pair, v[1]);
        atomicAdd(pair + 1, v[2]);
      } else {
        add_pair(pair, v[1], v[2]);
      }
    }
  };

  // item i of this thread: lane `lane[i]` of the tile (tl: the Stokes
  // partner), row group t[i] of the column's 2^log_t
  const bool partner = STOKES && static_cast<int>(threadIdx.x) >= n_main;
  const int stride = partner ? nthreads - n_main : n_main;
  const int first = partner ? threadIdx.x - n_main : threadIdx.x;
  int t[I], lane[I];
  bool live[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int item = first + i * stride;
    live[i] = item < (partner ? 1 : tl) << plan.log_t;
    lane[i] = partner ? tl : item & (tl - 1);
    t[i] = live[i] ? (partner ? item : item >> log_tl) : 0;
  }
  float2* ex;                          // the current column's exchange
  auto slot = [&](int i, int row) {
    return partner ? ex + lay.ex_main + reg::pad_slot<1>(row)
                   : ex + reg::pad_slot<2>(row * tl + lane[i]);
  };
  auto sync = [] { __syncthreads(); };

  // column b of both planes (and the partner lane) into stage buffer s
  auto stage_column = [&](int b, T* s) {
    T* pr = s + 2 * n1 * tl;           // partner planes, PW words a row
    const long base = static_cast<long>(b) * n1 * L;
    if (chunk) {
      const int per = chunk / static_cast<int>(sizeof(T));
      const int log_cpr = log_tl - (__ffs(per) - 1);   // copies a plane row
      const int total = (2 * n1) << log_cpr;
      for (int i = threadIdx.x; i < total; i += nthreads) {
        const int c = i & ((1 << log_cpr) - 1);
        const int row = (i >> log_cpr) & (n1 - 1);
        const int plane = i >> (log_cpr + log_n1);
        cp_async(s + (plane * n1 + row) * tl + c * per,
                 (plane ? zi : zr) + base + static_cast<long>(row) * L + l0 +
                     c * per,
                 chunk);
      }
      if constexpr (STOKES) {
        for (int i = threadIdx.x; i < 2 * n1; i += nthreads) {
          const int plane = i >> log_n1, row = i & (n1 - 1);
          cp_async(pr + (plane * n1 + row) * PW,
                   (plane ? zi : zr) + base + static_cast<long>(row) * L + lp,
                   4);
        }
      }
    } else {
      for (int i = threadIdx.x; i < (2 * n1) << log_tl; i += nthreads) {
        const int ln = i & (tl - 1), row = (i >> log_tl) & (n1 - 1);
        const int plane = i >> (log_tl + log_n1);
        s[i] = (plane ? zi : zr)[base + static_cast<long>(row) * L + l0 + ln];
      }
      if constexpr (STOKES) {
        for (int i = threadIdx.x; i < 2 * n1; i += nthreads) {
          const int plane = i >> log_n1, row = i & (n1 - 1);
          pr[(plane * n1 + row) * PW] =
              (plane ? zi : zr)[base + static_cast<long>(row) * L + lp];
        }
      }
    }
  };
  auto stage_buf = [&](int k) {
    return stages + (k % kFoldStages) * (lay.buf / static_cast<int>(sizeof(T)));
  };

  // the run of equal bins each register slot is summing
  float run[I][R][W];
  unsigned run_bin[I][R];
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      run_bin[i][q] = kNoBin;
#pragma unroll
      for (int k = 0; k < W; ++k) run[i][q][k] = 0.0f;
    }
  auto flush = [&](int i, int q) {
    if (run_bin[i][q] == kNoBin) return;
    add(run_bin[i][q], lane[i], run[i][q]);
#pragma unroll
    for (int k = 0; k < W; ++k) run[i][q][k] = 0.0f;
  };

  // this block's run of columns
  const int per_group = (n2 + gridDim.y - 1) / gridDim.y;
  const int b0 = blockIdx.y * per_group;
  const int n_cols = max(0, min(per_group, n2 - b0));
  // columns b0 .. b0 + kFoldStages - 2 in flight before the first
  for (int k = 0; k + 1 < kFoldStages; ++k) {
    if (k < n_cols) stage_column(b0 + k, stage_buf(k));
    cp_async_commit();
  }
  float keep = 0.0f;                   // kFoldMode 2: the FFT's results
  for (int k = 0; k < n_cols; ++k) {
    const int b = b0 + k;
    // column b + kFoldStages - 1 into the buffer column b - 1 left
    const int ahead = k + kFoldStages - 1;
    if (ahead < n_cols) stage_column(b0 + ahead, stage_buf(ahead));
    cp_async_commit();
    cp_async_wait<kFoldStages - 1>();  // column b arrived
    __syncthreads();
    const T* s = stage_buf(k);
    ex = reinterpret_cast<float2*>(stage_buf(k));
    float2 v[I][R];
#pragma unroll
    for (int i = 0; i < I; ++i) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        v[i][q] = make_float2(0.0f, 0.0f);
        if (!live[i] || q >= plan.used) continue;
        const int row = plan.row_in(0, q, t[i]);
        const int a = partner ? 2 * n1 * tl + row * PW : row * tl + lane[i];
        const int im = partner ? n1 * PW : n1 * tl;
        v[i][q] = make_float2(to_float(s[a]), to_float(s[a + im]));
      }
    }
    if (kFoldMode != 1) plan.template run<true>(v, t, live, tw, slot, sync);
    // STOKES: the partner column's transform, for the tile's last lane
    // (every other lane's partner is the next thread's item), in a region
    // of its own past the partner's exchange
    float2* pfin = ex + lay.ex_main + reg::padded_size<1>(n1);
    if constexpr (STOKES) {
      if (partner) {
#pragma unroll
        for (int i = 0; i < I; ++i) {
          if (!live[i]) continue;
#pragma unroll
          for (int q = 0; q < R; ++q)
            if (q < plan.used)
              pfin[reg::pad_slot<1>(plan.rows_final(q, t[i]))] = v[i][q];
        }
      }
      __syncthreads();
    }
    // the phase bin of row c of this column
    auto bin_of = [&](int c) {
      const int tt = c * n2 + b;
      if (tt < pad_start || tt - pad_start >= n_valid) return nph;
      const unsigned num = (i0 + static_cast<unsigned>(tt) * p) & 0x7FFFFFFFu;
      return ((num >> 16) * nph + (((num & 0xFFFFu) * nph) >> 16)) >> 15;
    };
    // the flagship's tile: a row's 8 lanes are 8 neighbouring threads that
    // share its bins, so each computes the bin of one slot (its lane's)
    // and the others take it by shuffle
    constexpr bool kShareBins = LOG_TL == kFoldLogR;
#pragma unroll
    for (int i = 0; i < I; ++i) {
      unsigned own = 0;
      if constexpr (kShareBins) own = bin_of(plan.rows_final(lane[i] & (R - 1),
                                                             t[i]));
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float2 w = make_float2(0.0f, 0.0f);
        if constexpr (STOKES) {        // the whole warp shuffles
          w.x = __shfl_down_sync(0xffffffffu, v[i][q].x, 1);
          w.y = __shfl_down_sync(0xffffffffu, v[i][q].y, 1);
        }
        unsigned shared_bin = 0;
        if constexpr (kShareBins)
          shared_bin = __shfl_sync(0xffffffffu, own,
                                   (threadIdx.x & 31 & ~(R - 1)) | q);
        if (!live[i] || partner || q >= plan.used) continue;
        const int c = plan.rows_final(q, t[i]);
        const float vr = v[i][q].x * inv_n1;
        const float vi = v[i][q].y * inv_n1;
        if (kFoldMode == 2) {
          keep += vr * vr + vi * vi;
          continue;
        }
        const unsigned bin = kShareBins ? shared_bin : bin_of(c);
        if (counter && lane[i] == 0) {
          if (smem_acc) atomicAdd(&pcnt[bin], 1u);
          else atomicAdd(&cnt[bin], 1u);
        }
        float val[W];
        val[0] = vr * vr + vi * vi;
        if constexpr (STOKES) {
          if (lane[i] == tl - 1) w = pfin[reg::pad_slot<1>(c)];
          const float qr = w.x * inv_n1;
          const float qi = w.y * inv_n1;
          val[1] = vr * qr + vi * qi;
          val[2] = vi * qr - vr * qi;
        }
        if (kFoldRuns) {
          if (bin != run_bin[i][q]) {
            flush(i, q);
            run_bin[i][q] = bin;
          }
#pragma unroll
          for (int k = 0; k < W; ++k) run[i][q][k] += val[k];
        } else {
          add(bin, lane[i], val);
        }
      }
    }
    // the next column's copies go to the buffer this one was staged and
    // exchanged in: every thread must be done reading it
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (live[i] && !partner) flush(i, q);
  if (kFoldMode == 2 && keep == -1.0f) prof[0] = keep;
  if (smem_acc) {
    __syncthreads();
    for (int i = threadIdx.x; i < acc_rows * tl; i += nthreads) {
      if (pprof[i] == 0.0f) continue;
      const int bin = i / (W * tl), j = i - bin * W * tl;
      const int k = j < tl ? 0 : 1 + ((j - tl) & 1);
      const int ln = j < tl ? j : (j - tl) >> 1;
      atomicAdd(&prof[(static_cast<long>(bin) * W + k) * L + l0 + ln],
                pprof[i]);
    }
    if (counter)
      for (int i = threadIdx.x; i <= n_phase; i += nthreads)
        if (pcnt[i]) atomicAdd(&cnt[i], pcnt[i]);
  }
}

}  // namespace bbt

using bbt::kThreads;
using bf16 = __nv_bfloat16;

namespace {

// Run go(V) with the lanes per global access for planes of type T at a
// tile of 2^log_tl lanes: V = 2 (one __nv_bfloat162) for bf16 tiles of
// two or more lanes, else 1.
template <typename T, typename Go>
cudaError_t by_lanes(int log_tl, Go go) {
  if constexpr (bbt::kBf16<T>) {
    if (log_tl >= 1) return go(std::integral_constant<int, 2>{});
  }
  return go(std::integral_constant<int, 1>{});
}

// The paths' K1 columns compiled for their sizes (a run-time pass plan is
// several times slower): N1 = 512 in every form (the flagship's window,
// config 2's stream), 256 and 128 (config 3's stream) for float32 planes
// in and out.
template <bool PACKED, typename T>
constexpr bool k1_compiled(int n1) {
  return n1 == 512 || (!PACKED && !bbt::kBf16<T> && (n1 == 256 || n1 == 128));
}

// The K1 block for an N1-row column: log2 of the widest power-of-two tile
// <= kK1Lanes dividing L whose stages and exchange fit, or -1.
template <bool PACKED>
int k1_log_tl(int n1, int L, int kf, int ke, int nmp) {
  for (int lt = bbt::log2i(bbt::kK1Lanes); lt >= 0; --lt) {
    if (L % (1 << lt)) continue;
    if (bbt::K1Smem<PACKED>(n1, 1 << lt, kf, ke, nmp).bytes() <= bbt::kMaxSmem)
      return lt;
  }
  return -1;
}

template <bool PACKED, typename T>
int k1_form(int n1, int L) {
  const int lt = k1_log_tl<PACKED>(n1, L, 0, 0, PACKED ? n1 / 4 : n1);
  if (lt < 0) return -1;
  return lt == bbt::log2i(bbt::kK1Lanes) && k1_compiled<PACKED, T>(n1);
}

template <bool PACKED, typename T>
int launch_k1(const float* xr, const float* xi, const void* xpr,
              const void* xpi, const float* fr, const float* fi,
              const float* er, const float* ei, const float* scale,
              float scale_value, int edge_scale, T* yr, T* yi, int n1, int n2,
              int L, int kf, int ke, int bits, float offset, float4 lv,
              int device, void* stream) {
  const int nmp = (n1 - kf - ke) / (PACKED ? 32 / bits : 1);
  const int log_tl = k1_log_tl<PACKED>(n1, L, kf, ke, nmp);
  if (log_tl < 0 || kf < 0 || ke < 0 || kf + ke > n1)
    return cudaErrorInvalidValue;
  const int tl = 1 << log_tl;
  const size_t smem = bbt::K1Smem<PACKED>(n1, tl, kf, ke, nmp).bytes();
  const int row_groups = n1 > (1 << bbt::kK1LogR) ? n1 >> bbt::kK1LogR : 1;
  const int chunk = bbt::copy_chunk(tl, L, 4, {xr, xi, xpr, xpi, fr, fi, er,
                                              ei});
  auto go = [&](auto kernel, int vl) -> cudaError_t {
    // a row group's tl / vl threads (vl > 1), or two single-lane items a
    // thread, in whole warps
    const int items = (tl >= vl ? tl / vl : 1) * row_groups;
    const int per = vl > 1 ? 1 : bbt::k1_items(1);
    const int threads = (items + 32 * per - 1) / (32 * per) * 32;
    if (threads > bbt::kK1MaxThreads ||
        reinterpret_cast<uintptr_t>(yr) % (vl * sizeof(T)) ||
        reinterpret_cast<uintptr_t>(yi) % (vl * sizeof(T)))
      return cudaErrorInvalidValue;
    cudaError_t err = bbt::prepare(kernel, smem, device);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    const int lane_tiles = L >> log_tl;
    int groups = per_sm * sms / lane_tiles;
    if (groups < 1) groups = 1;
    if (groups > n2) groups = n2;
    kernel<<<dim3(lane_tiles, groups), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        xr, xi, static_cast<const unsigned*>(xpr),
        static_cast<const unsigned*>(xpi), fr, fi, er, ei, scale, scale_value,
        edge_scale, yr, yi, bbt::log2i(n1), n2, L, log_tl, kf, ke, bits,
        offset, lv, chunk);
    return cudaGetLastError();
  };
  constexpr int kHot = bbt::log2i(bbt::kK1Lanes);
  constexpr int kVec = bbt::kK1Vec;
  if (log_tl == kHot && k1_compiled<PACKED, T>(n1)) {
    if (n1 == 512)
      return go(bbt::k1_reg_kernel<PACKED, T, 9, kHot, kVec>, kVec);
    if constexpr (!PACKED && !bbt::kBf16<T>) {
      if (n1 == 256)
        return go(bbt::k1_reg_kernel<PACKED, T, 8, kHot, kVec>, kVec);
      return go(bbt::k1_reg_kernel<PACKED, T, 7, kHot, kVec>, kVec);
    }
  }
  return go(bbt::k1_reg_kernel<PACKED, T, -1, -1, 1>, 1);
}

constexpr float4 kNoLevels = {0.f, 0.f, 0.f, 0.f};

template <typename T>
int k1_packed(const void* xpr, const void* xpi, const float* fr,
              const float* fi, const float* er, const float* ei,
              const float* scale, void* yr, void* yi, int n1, int n2, int L,
              int kf, int ke, int bits, float offset, float lv0, float lv1,
              float lv2, float lv3, int device, void* stream) {
  return launch_k1<true, T>(nullptr, nullptr, xpr, xpi, fr, fi, er, ei, scale,
                            1.0f, 1, static_cast<T*>(yr), static_cast<T*>(yi),
                            n1, n2, L, kf, ke, bits, offset,
                            make_float4(lv0, lv1, lv2, lv3), device, stream);
}

template <typename T>
int k1_float(const float* xr, const float* xi, const float* fr,
             const float* fi, const float* er, const float* ei,
             const float* scale, void* yr, void* yi, int n1, int n2, int L,
             int kf, int ke, int device, void* stream) {
  return launch_k1<false, T>(xr, xi, nullptr, nullptr, fr, fi, er, ei, scale,
                             1.0f, 1, static_cast<T*>(yr), static_cast<T*>(yi),
                             n1, n2, L, kf, ke, 32, 0.0f, kNoLevels, device,
                             stream);
}

// The register K2's block for an N2-row column: the widest power-of-two
// tile <= kK2Lanes dividing L whose block (threads, stage buffers) fits,
// with the chirp staged when it fits there too (kK2Chirp); log2 of the
// tile, the block's threads and whether the chirp is staged, or false
// (the column is too long: k2_kernel takes it).
template <bool THETA, typename T, typename C>
bool k2_register_tile(int n2, int L, int* log_tl, int* threads,
                      bool* staged) {
  const int row_groups = n2 > (1 << bbt::kK2LogR) ? n2 >> bbt::kK2LogR : 1;
  constexpr bool kCanLoad = !THETA && !bbt::kBf16<T> && !bbt::kBf16<C>;
  for (int lt = bbt::log2i(bbt::kK2Lanes); lt >= 0; --lt) {
    if (L % (1 << lt)) continue;
    const int items = row_groups << lt;
    const int n = (items + 32 * bbt::kK2Items - 1) / (32 * bbt::kK2Items) * 32;
    if (n > bbt::kK2MaxThreads) continue;
    const auto fits = [&](bool st) {
      return bbt::K2Smem<THETA, T, C>(n2, 1 << lt, st).bytes() <=
             bbt::kMaxSmem;
    };
    const bool load = kCanLoad && bbt::kK2Chirp != 2 && fits(false);
    if (bbt::kK2Chirp == 1 && load) {
      *staged = false;
    } else if (fits(true)) {
      *staged = true;
    } else if (load) {
      *staged = false;
    } else {
      continue;
    }
    *log_tl = lt;
    *threads = n;
    return true;
  }
  return false;
}

template <bool THETA, typename T, typename C>
int launch_k2(void* yr, void* yi, const void* c0, const void* c1, int n1,
              int n2, int L, int device, void* stream) {
  int log_tl = -1, threads = 0;
  bool staged = true;
  if (k2_register_tile<THETA, T, C>(n2, L, &log_tl, &threads, &staged)) {
    const int tl = 1 << log_tl;
    const size_t smem = bbt::K2Smem<THETA, T, C>(n2, tl, staged).bytes();
    // the paths' columns compiled for their sizes (a run-time pass plan
    // is several times slower): the flagship's N2 = 512 at the two widest
    // tiles, the compiled PFB chains' N2 = 256 (2^15-row windows, 512
    // lanes) at the widest
    constexpr int kHotTile = bbt::log2i(bbt::kK2Lanes);
    auto kernel = n2 == 512 && log_tl == kHotTile
                      ? bbt::k2_reg_kernel<THETA, T, C, 9, kHotTile>
                  : n2 == 512 && log_tl == kHotTile - 1
                      ? bbt::k2_reg_kernel<THETA, T, C, 9, kHotTile - 1>
                  : n2 == 256 && log_tl == kHotTile
                      ? bbt::k2_reg_kernel<THETA, T, C, 8, kHotTile>
                      : bbt::k2_reg_kernel<THETA, T, C, -1, -1>;
    cudaError_t err = bbt::prepare(kernel, smem, device);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    const int lane_tiles = L >> log_tl;
    int groups = per_sm * sms / lane_tiles;
    if (groups < 1) groups = 1;
    if (groups > n1) groups = n1;
    kernel<<<dim3(lane_tiles, groups), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(yr), static_cast<T*>(yi), static_cast<const C*>(c0),
        static_cast<const C*>(c1), bbt::log2i(n1), bbt::log2i(n2), L, log_tl,
        bbt::copy_chunk(tl, L, sizeof(T), {yr, yi}),
        bbt::copy_chunk(tl, L, sizeof(C), {c0, c1}), staged);
    return cudaGetLastError();
  }
  log_tl = bbt::choose_log_tl(n2, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n2, log_tl);
  return by_lanes<T>(log_tl, [&](auto v) -> cudaError_t {
    auto kernel = bbt::k2_kernel<THETA, T, C, decltype(v)::value>;
    cudaError_t err = bbt::prepare(kernel, smem, device);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(L >> log_tl, n1), kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(yr), static_cast<T*>(yi), static_cast<const C*>(c0),
        static_cast<const C*>(c1), bbt::log2i(n1), bbt::log2i(n2), L, log_tl);
    return cudaGetLastError();
  });
}

template <bool STOKES, typename T>
int launch_k3_fold(const void* zr, const void* zi, const int* fold,
                   float* prof, unsigned* cnt, int n1, int n2, int L,
                   int n_phase, int pad_start, int n_valid, int device,
                   void* stream) {
  using Smem = bbt::FoldSmem<STOKES, T>;
  // the widest power-of-two tile <= kFoldLanes dividing L whose stages,
  // exchange and shared partials fit; else the widest without partials
  // (the runs go to global atomics)
  int log_tl = -1, smem_acc = 1;
  for (int acc = 1; acc >= 0 && log_tl < 0; --acc) {
    for (int lt = bbt::log2i(bbt::kFoldLanes); lt >= 0; --lt) {
      if (L % (1 << lt)) continue;
      if (Smem(n1, 1 << lt, n_phase, acc).bytes() <= bbt::kMaxSmem) {
        log_tl = lt;
        smem_acc = acc;
        break;
      }
    }
  }
  if (log_tl < 0) return cudaErrorInvalidValue;
  const int tl = 1 << log_tl;
  const size_t smem = Smem(n1, tl, n_phase, smem_acc).bytes();
  // threads: the tile's (lane, row group) items, fold_items a thread,
  // then with STOKES the partner column's row groups, in whole warps
  constexpr int items = bbt::fold_items<STOKES>();
  const int row_groups = n1 > (1 << bbt::kFoldLogR) ? n1 >> bbt::kFoldLogR
                                                    : 1;
  const auto warps_for = [](int n) {
    return (n + 32 * items - 1) / (32 * items) * 32;
  };
  const int n_main = warps_for(tl * row_groups);
  const int threads = n_main + (STOKES ? warps_for(row_groups) : 0);
  if (threads > bbt::fold_threads<STOKES>()) return cudaErrorInvalidValue;
  // 16-byte (or smaller) cp.async copies of a tile row, when the rows
  // and the planes are aligned to them; else plain loads
  const int chunk = bbt::copy_chunk(tl, L, sizeof(T), {zr, zi});
  // the flagship's column (N1 = 512, the full tile) compiled for its
  // shape; any other through the general kernel
  constexpr int kHotTile = bbt::kFoldLanes == 16 ? 4
                           : bbt::kFoldLanes == 8 ? 3
                           : bbt::kFoldLanes == 4 ? 2 : -1;
  auto kernel = n1 == 512 && log_tl == kHotTile
                    ? bbt::k3_fold_kernel<STOKES, T, 9, kHotTile>
                    : bbt::k3_fold_kernel<STOKES, T, -1, -1>;
  cudaError_t err = bbt::prepare(kernel, smem, device);
  if (err != cudaSuccess) return err;
  // about one block per resident slot; each walks n2 / groups columns
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int lane_tiles = L >> log_tl;
  int groups = per_sm * sms / lane_tiles;
  if (groups < 1) groups = 1;
  if (groups > n2) groups = n2;
  kernel<<<dim3(lane_tiles, groups), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(zr), static_cast<const T*>(zi), fold, prof, cnt,
      bbt::log2i(n1), bbt::log2i(n2), L, log_tl, n_phase, pad_start, n_valid,
      smem_acc, n_main, chunk);
  return cudaGetLastError();
}

}  // namespace

// --- C entry points: each returns the cudaGetLastError() of its launch. ---
// The `_bf16` entries take and give bf16 intermediate planes (y, z).

extern "C" int bbt_k1_packed(const void* xpr, const void* xpi, const float* fr,
                             const float* fi, const float* er, const float* ei,
                             const float* scale, void* yr, void* yi, int n1,
                             int n2, int L, int kf, int ke, int bits,
                             float offset, float lv0, float lv1, float lv2,
                             float lv3, int device, void* stream) {
  return k1_packed<float>(xpr, xpi, fr, fi, er, ei, scale, yr, yi, n1, n2, L,
                          kf, ke, bits, offset, lv0, lv1, lv2, lv3, device,
                          stream);
}

extern "C" int bbt_k1_packed_bf16(const void* xpr, const void* xpi,
                                  const float* fr, const float* fi,
                                  const float* er, const float* ei,
                                  const float* scale, void* yr, void* yi,
                                  int n1, int n2, int L, int kf, int ke,
                                  int bits, float offset, float lv0, float lv1,
                                  float lv2, float lv3, int device,
                                  void* stream) {
  return k1_packed<bf16>(xpr, xpi, fr, fi, er, ei, scale, yr, yi, n1, n2, L,
                         kf, ke, bits, offset, lv0, lv1, lv2, lv3, device,
                         stream);
}

extern "C" int bbt_k1_float(const float* xr, const float* xi, const float* fr,
                            const float* fi, const float* er, const float* ei,
                            const float* scale, void* yr, void* yi, int n1,
                            int n2, int L, int kf, int ke, int device,
                            void* stream) {
  return k1_float<float>(xr, xi, fr, fi, er, ei, scale, yr, yi, n1, n2, L, kf,
                         ke, device, stream);
}

extern "C" int bbt_k1_float_bf16(const float* xr, const float* xi,
                                 const float* fr, const float* fi,
                                 const float* er, const float* ei,
                                 const float* scale, void* yr, void* yi,
                                 int n1, int n2, int L, int kf, int ke,
                                 int device, void* stream) {
  return k1_float<bf16>(xr, xi, fr, fi, er, ei, scale, yr, yi, n1, n2, L, kf,
                        ke, device, stream);
}

// k1_window: stage A of a whole (N, L) window, no edges, no scale.
extern "C" int bbt_k1_window(const float* xr, const float* xi, float* yr,
                             float* yi, int n1, int n2, int L, int device,
                             void* stream) {
  return launch_k1<false, float>(xr, xi, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, 1.0f, 1, yr, yi,
                                 n1, n2, L, 0, 0, 32, 0.0f, kNoLevels, device,
                                 stream);
}

// k1_stream: stage A of the streaming window [carry | block], the carry
// (kc rows of N2) as the front edge and unscaled, the block scaled by
// *scale (or by scale_value when scale is null).
extern "C" int bbt_k1_stream(const float* cr, const float* ci, const float* xr,
                             const float* xi, const float* scale,
                             float scale_value, float* yr, float* yi, int n1,
                             int n2, int L, int kc, int device, void* stream) {
  if (kc < 0 || kc >= n1) return cudaErrorInvalidValue;
  return launch_k1<false, float>(xr, xi, nullptr, nullptr, cr, ci, nullptr,
                                 nullptr, scale, scale_value, 0, yr, yi, n1,
                                 n2, L, kc, 0, 32, 0.0f, kNoLevels, device,
                                 stream);
}

// k1_planes: stage A of a planes-first (2, N, L) window, the real plane
// at x2 and the imaginary plane right after it: k1_window on the two.
extern "C" int bbt_k1_planes(const float* x2, float* yr, float* yi, int n1,
                             int n2, int L, int device, void* stream) {
  const long plane = static_cast<long>(n1) * n2 * L;
  return bbt_k1_window(x2, x2 + plane, yr, yi, n1, n2, L, device, stream);
}

// k1_stream_planes: stage A of [front | block | end] from planes-first
// (2, rows, L) arrays, every row scaled by *scale: K1f on the six planes.
extern "C" int bbt_k1_stream_planes(const float* x2, const float* front,
                                    const float* end, const float* scale,
                                    float* yr, float* yi, int n1, int n2,
                                    int L, int kf, int ke, int device,
                                    void* stream) {
  const long row = static_cast<long>(n2) * L;
  return bbt_k1_float(x2, x2 + (n1 - kf - ke) * row, front, front + kf * row,
                      end, end + ke * row, scale, yr, yi, n1, n2, L, kf, ke,
                      device, stream);
}

// k1_form: 1 when a K1 launch (kind 0 k1_packed, 1 k1_packed_bf16, 2
// k1_float and the window/stream/planes forms, 3 k1_float_bf16) of an
// N1-row column on L lanes runs a register kernel compiled for its size,
// 0 when it runs the general one (a run-time pass plan), -1 for a kind
// it does not know or a shape no tile fits (k1_log_tl with no edges:
// the edges only shrink a packed stage).
extern "C" int bbt_k1_form(int n1, int L, int kind) {
  switch (kind) {
    case 0: return k1_form<true, float>(n1, L);
    case 1: return k1_form<true, bf16>(n1, L);
    case 2: return k1_form<false, float>(n1, L);
    case 3: return k1_form<false, bf16>(n1, L);
    default: return -1;
  }
}

extern "C" int bbt_k2(void* yr, void* yi, const void* csr, const void* csi,
                      int n1, int n2, int L, int device, void* stream) {
  return launch_k2<false, float, float>(yr, yi, csr, csi, n1, n2, L, device,
                                        stream);
}

// k2_bf16: K2 on bf16 planes with a float32 chirp; k2_bf16_chirp with a
// bf16 chirp.
extern "C" int bbt_k2_bf16(void* yr, void* yi, const void* csr,
                           const void* csi, int n1, int n2, int L, int device,
                           void* stream) {
  return launch_k2<false, bf16, float>(yr, yi, csr, csi, n1, n2, L, device,
                                       stream);
}

extern "C" int bbt_k2_bf16_chirp(void* yr, void* yi, const void* csr,
                                 const void* csi, int n1, int n2, int L,
                                 int device, void* stream) {
  return launch_k2<false, bf16, bf16>(yr, yi, csr, csi, n1, n2, L, device,
                                      stream);
}

// k2_theta: K2 with the chirp as one phase plane (cycles).
extern "C" int bbt_k2_theta(void* yr, void* yi, const void* theta, int n1,
                            int n2, int L, int device, void* stream) {
  return launch_k2<true, float, float>(yr, yi, theta, nullptr, n1, n2, L,
                                       device, stream);
}

// k2_form: 1 when a K2 launch (kind 0 k2, 1 k2_bf16, 2 k2_bf16_chirp,
// 3 k2_theta) of this shape runs the register kernel, 0 when it keeps the
// shared-memory k2_kernel (columns longer than the register block holds),
// -1 for a kind it does not know.
extern "C" int bbt_k2_form(int n2, int L, int kind) {
  int log_tl, threads;
  bool staged;
  switch (kind) {
    case 0:
      return k2_register_tile<false, float, float>(n2, L, &log_tl, &threads,
                                                   &staged);
    case 1:
      return k2_register_tile<false, bf16, float>(n2, L, &log_tl, &threads,
                                                  &staged);
    case 2:
      return k2_register_tile<false, bf16, bf16>(n2, L, &log_tl, &threads,
                                                 &staged);
    case 3:
      return k2_register_tile<true, float, float>(n2, L, &log_tl, &threads,
                                                  &staged);
    default:
      return -1;
  }
}

extern "C" int bbt_k3_fold(const void* zr, const void* zi, const int* fold,
                           float* prof, unsigned* cnt, int n1, int n2, int L,
                           int n_phase, int pad_start, int n_valid, int device,
                           void* stream) {
  return launch_k3_fold<false, float>(zr, zi, fold, prof, cnt, n1, n2, L,
                                      n_phase, pad_start, n_valid, device,
                                      stream);
}

// k3_fold_stokes: K3 folding the (n_phase+1, 3L) full-Stokes profile.
extern "C" int bbt_k3_fold_stokes(const void* zr, const void* zi,
                                  const int* fold, float* prof, unsigned* cnt,
                                  int n1, int n2, int L, int n_phase,
                                  int pad_start, int n_valid, int device,
                                  void* stream) {
  return launch_k3_fold<true, float>(zr, zi, fold, prof, cnt, n1, n2, L,
                                     n_phase, pad_start, n_valid, device,
                                     stream);
}

extern "C" int bbt_k3_fold_bf16(const void* zr, const void* zi,
                                const int* fold, float* prof, unsigned* cnt,
                                int n1, int n2, int L, int n_phase,
                                int pad_start, int n_valid, int device,
                                void* stream) {
  return launch_k3_fold<false, bf16>(zr, zi, fold, prof, cnt, n1, n2, L,
                                     n_phase, pad_start, n_valid, device,
                                     stream);
}

extern "C" int bbt_k3_fold_stokes_bf16(const void* zr, const void* zi,
                                       const int* fold, float* prof,
                                       unsigned* cnt, int n1, int n2, int L,
                                       int n_phase, int pad_start, int n_valid,
                                       int device, void* stream) {
  return launch_k3_fold<true, bf16>(zr, zi, fold, prof, cnt, n1, n2, L,
                                    n_phase, pad_start, n_valid, device,
                                    stream);
}
