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
// rows rather than in scattered tl-float pieces.  Each thread issues
// kBatch global loads before it stores any to shared memory, so enough
// bytes are in flight to cover device-memory latency.  The FFT is the
// shared-memory radix-2 of fft.cuh, three stages per pass; wgmma, TMA
// loads and fusing the passes are later work.

#include <cuda_runtime.h>

#include "common.cuh"
#include "fft.cuh"

namespace bbt {

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
// Block (lane tile, b) assembles window column b: rows c < kf from the
// front edge (row c*N2+b), rows c >= kf+nm from the end edge, and main row
// m = c-kf either from the float planes (row m*N2+b) or decoded from field
// m / nmp of packed word row (m % nmp)*N2+b.  Each packed word is read once
// and all its fields are decoded together.  Then scale, FFT over c, the
// W_N^{-c b} twiddle, and the store into row b of the d-major output.
// Bound: bytes (1/4 of a float plane's read for 8-bit input, plus the full
// float32 write); one read and one write per element.
template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
k1_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
          const unsigned* __restrict__ xpr, const unsigned* __restrict__ xpi,
          const float* __restrict__ fr, const float* __restrict__ fi,
          const float* __restrict__ er, const float* __restrict__ ei,
          const float* __restrict__ scale, float scale_value,
          int edge_scale, float* __restrict__ yr, float* __restrict__ yi,
          int log_n1, int n2, int L, int log_tl, int kf, int ke, int bits,
          float offset, float4 lv) {
  extern __shared__ float2 smem[];
  const int n1 = 1 << log_n1;
  const int tl = 1 << log_tl;
  float2* x = smem;
  float2* tw = smem + (n1 << log_tl);
  const int b = blockIdx.y;
  const int l0 = blockIdx.x << log_tl;
  const int nm = n1 - kf - ke;
  const float s = scale ? *scale : scale_value;
  const float se = edge_scale ? s : 1.0f;   // the edges' scale
  fill_twiddles(tw, n1);

  // element idx of a tile of rows: (row, lane) of a (rows, N2, L) plane
  auto at = [&](int idx) {
    return (static_cast<long>(idx >> log_tl) * n2 + b) * L + l0 + (idx & (tl - 1));
  };
  auto scaled = [&](float2* dst, float f) {
    return [=](int idx, float2 v) { dst[idx] = make_float2(v.x * f, v.y * f); };
  };
  batched(kf << log_tl,
          [&](int idx) { return make_float2(fr[at(idx)], fi[at(idx)]); },
          scaled(x, se));
  batched(ke << log_tl,
          [&](int idx) { return make_float2(er[at(idx)], ei[at(idx)]); },
          scaled(x + ((kf + nm) << log_tl), se));
  if constexpr (PACKED) {
    const int per = 32 / bits;
    const int nmp = nm / per;
    const unsigned mask = (1u << bits) - 1u;
    batched(nmp << log_tl,
            [&](int idx) { return make_uint2(xpr[at(idx)], xpi[at(idx)]); },
            [&](int idx, uint2 w) {
              const int lane = idx & (tl - 1);
              const int j = idx >> log_tl;
              for (int k = 0; k < per; ++k) {
                const int c = kf + k * nmp + j;
                const float vr = decode_field((w.x >> (bits * k)) & mask, bits, offset, lv);
                const float vi = decode_field((w.y >> (bits * k)) & mask, bits, offset, lv);
                x[(c << log_tl) + lane] = make_float2(vr * s, vi * s);
              }
            });
  } else {
    batched(nm << log_tl,
            [&](int idx) { return make_float2(xr[at(idx)], xi[at(idx)]); },
            scaled(x + (kf << log_tl), s));
  }
  __syncthreads();

  const int total = n1 << log_tl;
  fft_dif<false>(x, tw, log_n1, log_tl);

  const float nf = static_cast<float>(n1) * static_cast<float>(n2);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int lane = idx & (tl - 1);
    const int k = idx >> log_tl;
    const float2 v = x[(bitrev(k, log_n1) << log_tl) + lane];
    float sn, cs;
    sincospif(-2.0f * static_cast<float>(k * b) / nf, &sn, &cs);
    const float2 out = cmul(v, make_float2(cs, sn));
    const long o = (static_cast<long>(b) * n1 + k) * L + l0 + lane;
    yr[o] = out.x;
    yi[o] = out.y;
  }
}

// ---------------------------------------------------------------------------
// K2: replaces `_k2_body` (dedisperse_pallas.py:259, launched by `_stage_b`
// :429) and, with THETA, `_k2_body_theta` (:286, launched by
// `_stage_b_theta` :460).  Block (lane tile, c) loads column c of the
// d-major planes (rows b*N1+c), runs the forward FFT over b (DIF: the
// spectrum comes out in bit-reversed order, so the chirp row is read at
// d = bitrev(position)), multiplies by the chirp, runs the inverse FFT
// (DIT: back to natural order), scales by 1/N2, applies W_N^{+c b} and
// writes the column back in place, as the TPU kernel aliases input and
// output.  The chirp is two planes (cos, sin) or, with THETA, one phase
// plane in cycles whose cos/sin the block computes with sincospif (exact
// argument scaling by pi), reading one chirp plane instead of two.
// Bound: bytes (read two planes and two chirp planes, write two planes;
// THETA: one chirp plane, five plane passes instead of six).
template <bool THETA>
__global__ void __launch_bounds__(kThreads)
k2_kernel(float* __restrict__ yr, float* __restrict__ yi,
          const float* __restrict__ csr, const float* __restrict__ csi,
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
  batched(total,
          [&](int idx) {
            const long a = at(idx >> log_tl, idx);
            return make_float2(yr[a], yi[a]);
          },
          [&](int idx, float2 v) { x[idx] = v; });
  __syncthreads();
  fft_dif<false>(x, tw, log_n2, log_tl);
  if constexpr (THETA) {
    batched(total,
            [&](int idx) { return csr[at(bitrev(idx >> log_tl, log_n2), idx)]; },
            [&](int idx, float th) {
              float sn, cs;
              sincospif(2.0f * th, &sn, &cs);
              x[idx] = cmul(x[idx], make_float2(cs, sn));
            });
  } else {
    batched(total,
            [&](int idx) {
              const long a = at(bitrev(idx >> log_tl, log_n2), idx);
              return make_float2(csr[a], csi[a]);
            },
            [&](int idx, float2 w) { x[idx] = cmul(x[idx], w); });
  }
  __syncthreads();
  fft_dit<true>(x, tw, log_n2, log_tl);

  const float inv_n2 = 1.0f / static_cast<float>(n2);
  const float nf = static_cast<float>(n1) * static_cast<float>(n2);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int lane = idx & (tl - 1);
    const int b = idx >> log_tl;
    const float2 v = x[idx];
    float sn, cs;
    sincospif(2.0f * static_cast<float>(c * b) / nf, &sn, &cs);
    const float2 out =
        cmul(make_float2(v.x * inv_n2, v.y * inv_n2), make_float2(cs, sn));
    const long o = at(b, lane);
    yr[o] = out.x;
    yi[o] = out.y;
  }
}

// ---------------------------------------------------------------------------
// K3: replaces `_k3_fold_body` (dedisperse_pallas.py:381, launched by
// `_fold_pallas_call` :618) with `_detect_fold_accumulate` (:332): the
// power branch, and with STOKES the full-Stokes branch.
//
// Block (lane tile, group) walks columns b = group, group + groups, ...:
// loads row b of the d-major planes, runs the inverse FFT over c (DIF: the
// sample of time t = c*N2 + b sits at bit-reversed position c), scales by
// 1/N1, detects |z|^2 and bins pulse phase in 31-bit fixed point:
//   num = (i0 + t*p) & 0x7FFFFFFF in uint32 (wraps mod 2^32 by definition,
//   where the TPU relied on int32 wrap), then
//   bin = ((num>>16)*n + (((num&0xFFFF)*n)>>16)) >> 15     (n <= 2^15),
// with rows outside [pad_start, pad_start+n_valid) in trash bin n_phase.
// With STOKES the profile has three planes of L lanes, [|z_l|^2 |
// Re z_l conj z_{l+1} | Im z_l conj z_{l+1}], lane l paired with lane
// (l+1) mod L as the TPU's one-lane roll pairs them (the cross terms of a
// dual-pol channel are those of its even, X, lane).  The partner of the
// tile's last lane is lane (l0+tl) mod L, in the next tile: the block
// loads that one lane's column too and transforms it beside the tile, for
// 1/tl more reads and FFT work.
// The TPU carried the profile across a sequential grid; here blocks run in
// no order, so each block sums into shared-memory partials (float sums,
// integer counts) and adds them to the global (n_phase+1, W*L) profile and
// (n_phase+1,) counts with atomics once at its end.  Counts are taken by
// the lane-tile-0 blocks only (the bin depends on t alone).  When the
// partials do not fit shared memory (huge n_phase) every row goes to
// global atomics directly.
// Bound: bytes (read two planes, 1/tl more with STOKES); nothing but the
// profile is written.
template <bool STOKES>
__global__ void __launch_bounds__(kThreads)
k3_fold_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
               const int* __restrict__ fold, float* __restrict__ prof,
               unsigned* __restrict__ cnt, int log_n1, int log_n2, int L,
               int log_tl, int n_phase, int pad_start, int n_valid,
               int smem_acc) {
  constexpr int W = STOKES ? 3 : 1;   // profile planes
  extern __shared__ float2 smem[];
  const int n1 = 1 << log_n1;
  const int n2 = 1 << log_n2;
  const int tl = 1 << log_tl;
  float2* x = smem;
  float2* xp = smem + (n1 << log_tl);      // STOKES: the partner lane's column
  float2* tw = xp + (STOKES ? n1 : 0);
  float* pprof = reinterpret_cast<float*>(tw + n1 / 2);
  const int acc_rows = (n_phase + 1) * W;
  unsigned* pcnt = reinterpret_cast<unsigned*>(pprof + (acc_rows << log_tl));
  const int l0 = blockIdx.x << log_tl;
  const int lp = (l0 + tl) % L;            // partner of the tile's last lane
  const bool counter = blockIdx.x == 0;
  fill_twiddles(tw, n1);
  if (smem_acc) {
    for (int i = threadIdx.x; i < (acc_rows << log_tl); i += blockDim.x)
      pprof[i] = 0.0f;
    for (int i = threadIdx.x; i <= n_phase; i += blockDim.x) pcnt[i] = 0u;
  }
  const unsigned i0 = static_cast<unsigned>(fold[0]);
  const unsigned p = static_cast<unsigned>(fold[1]);
  const unsigned nph = static_cast<unsigned>(n_phase);
  const float inv_n1 = 1.0f / static_cast<float>(n1);
  const int total = n1 << log_tl;
  // add v to profile plane k of phase row `bin`, lane `lane` of the tile
  auto add = [&](unsigned bin, int k, int lane, float v) {
    const int row = static_cast<int>(bin) * W + k;
    if (smem_acc) atomicAdd(&pprof[(row << log_tl) + lane], v);
    else atomicAdd(&prof[static_cast<long>(row) * L + l0 + lane], v);
  };

  for (int b = blockIdx.y; b < n2; b += gridDim.y) {
    batched(total,
            [&](int idx) {
              const long a = (static_cast<long>(b) * n1 + (idx >> log_tl)) * L +
                             l0 + (idx & (tl - 1));
              return make_float2(zr[a], zi[a]);
            },
            [&](int idx, float2 v) { x[idx] = v; });
    if constexpr (STOKES) {
      batched(n1,
              [&](int r) {
                const long a = (static_cast<long>(b) * n1 + r) * L + lp;
                return make_float2(zr[a], zi[a]);
              },
              [&](int r, float2 v) { xp[r] = v; });
    }
    __syncthreads();
    fft_dif<true>(x, tw, log_n1, log_tl);
    if constexpr (STOKES) fft_dif<true>(xp, tw, log_n1, 0);
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int lane = idx & (tl - 1);
      const int r = idx >> log_tl;
      const int c = bitrev(r, log_n1);
      const float2 v = x[idx];
      const float vr = v.x * inv_n1;
      const float vi = v.y * inv_n1;
      const int t = c * n2 + b;
      unsigned bin = nph;
      if (t >= pad_start && t - pad_start < n_valid) {
        const unsigned num = (i0 + static_cast<unsigned>(t) * p) & 0x7FFFFFFFu;
        bin = ((num >> 16) * nph + (((num & 0xFFFFu) * nph) >> 16)) >> 15;
      }
      add(bin, 0, lane, vr * vr + vi * vi);
      if constexpr (STOKES) {
        const float2 q = lane + 1 < tl ? x[idx + 1] : xp[r];
        const float qr = q.x * inv_n1;
        const float qi = q.y * inv_n1;
        add(bin, 1, lane, vr * qr + vi * qi);
        add(bin, 2, lane, vi * qr - vr * qi);
      }
      if (counter && lane == 0) {
        if (smem_acc) atomicAdd(&pcnt[bin], 1u);
        else atomicAdd(&cnt[bin], 1u);
      }
    }
    __syncthreads();
  }
  if (smem_acc) {
    for (int i = threadIdx.x; i < (acc_rows << log_tl); i += blockDim.x)
      atomicAdd(&prof[static_cast<long>(i >> log_tl) * L + l0 + (i & (tl - 1))],
                pprof[i]);
    if (counter)
      for (int i = threadIdx.x; i <= n_phase; i += blockDim.x)
        if (pcnt[i]) atomicAdd(&cnt[i], pcnt[i]);
  }
}

}  // namespace bbt

using bbt::kThreads;

// --- C entry points: each returns the cudaGetLastError() of its launch. ---

extern "C" int bbt_k1_packed(const void* xpr, const void* xpi, const float* fr,
                             const float* fi, const float* er, const float* ei,
                             const float* scale, float* yr, float* yi, int n1,
                             int n2, int L, int kf, int ke, int bits,
                             float offset, float lv0, float lv1, float lv2,
                             float lv3, int device, void* stream) {
  const int log_tl = bbt::choose_log_tl(n1, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n1, log_tl);
  cudaError_t err = bbt::prepare(bbt::k1_kernel<true>, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k1_kernel<true><<<dim3(L >> log_tl, n2), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, static_cast<const unsigned*>(xpr),
      static_cast<const unsigned*>(xpi), fr, fi, er, ei, scale, 1.0f, 1, yr,
      yi, bbt::log2i(n1), n2, L, log_tl, kf, ke, bits, offset,
      make_float4(lv0, lv1, lv2, lv3));
  return cudaGetLastError();
}

extern "C" int bbt_k1_float(const float* xr, const float* xi, const float* fr,
                            const float* fi, const float* er, const float* ei,
                            const float* scale, float* yr, float* yi, int n1,
                            int n2, int L, int kf, int ke, int device,
                            void* stream) {
  const int log_tl = bbt::choose_log_tl(n1, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n1, log_tl);
  cudaError_t err = bbt::prepare(bbt::k1_kernel<false>, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k1_kernel<false><<<dim3(L >> log_tl, n2), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      xr, xi, nullptr, nullptr, fr, fi, er, ei, scale, 1.0f, 1, yr, yi,
      bbt::log2i(n1), n2, L, log_tl, kf, ke, 32, 0.0f,
      make_float4(0.f, 0.f, 0.f, 0.f));
  return cudaGetLastError();
}

// k1_window: stage A of a whole (N, L) window, no edges, no scale.
extern "C" int bbt_k1_window(const float* xr, const float* xi, float* yr,
                             float* yi, int n1, int n2, int L, int device,
                             void* stream) {
  const int log_tl = bbt::choose_log_tl(n1, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n1, log_tl);
  cudaError_t err = bbt::prepare(bbt::k1_kernel<false>, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k1_kernel<false><<<dim3(L >> log_tl, n2), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      xr, xi, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      1.0f, 1, yr, yi, bbt::log2i(n1), n2, L, log_tl, 0, 0, 32, 0.0f,
      make_float4(0.f, 0.f, 0.f, 0.f));
  return cudaGetLastError();
}

// k1_stream: stage A of the streaming window [carry | block], the carry
// (kc rows of N2) as the front edge and unscaled, the block scaled by
// *scale (or by scale_value when scale is null).
extern "C" int bbt_k1_stream(const float* cr, const float* ci, const float* xr,
                             const float* xi, const float* scale,
                             float scale_value, float* yr, float* yi, int n1,
                             int n2, int L, int kc, int device, void* stream) {
  const int log_tl = bbt::choose_log_tl(n1, L, 0, 0);
  if (log_tl < 0 || kc < 0 || kc >= n1) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n1, log_tl);
  cudaError_t err = bbt::prepare(bbt::k1_kernel<false>, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k1_kernel<false><<<dim3(L >> log_tl, n2), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      xr, xi, nullptr, nullptr, cr, ci, nullptr, nullptr, scale, scale_value,
      0, yr, yi, bbt::log2i(n1), n2, L, log_tl, kc, 0, 32, 0.0f,
      make_float4(0.f, 0.f, 0.f, 0.f));
  return cudaGetLastError();
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

namespace {

template <bool THETA>
int launch_k2(float* yr, float* yi, const float* c0, const float* c1, int n1,
              int n2, int L, int device, void* stream) {
  const int log_tl = bbt::choose_log_tl(n2, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n2, log_tl);
  cudaError_t err = bbt::prepare(bbt::k2_kernel<THETA>, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k2_kernel<THETA><<<dim3(L >> log_tl, n1), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      yr, yi, c0, c1, bbt::log2i(n1), bbt::log2i(n2), L, log_tl);
  return cudaGetLastError();
}

template <bool STOKES>
int launch_k3_fold(const float* zr, const float* zi, const int* fold,
                   float* prof, unsigned* cnt, int n1, int n2, int L,
                   int n_phase, int pad_start, int n_valid, int device,
                   void* stream) {
  constexpr int W = STOKES ? 3 : 1;
  const int partner = STOKES ? n1 * 8 : 0;   // the partner lane's column
  // shared partials: W (n_phase+1) floats per lane plus (n_phase+1) counts
  int log_tl = bbt::choose_log_tl(n1, L, (n_phase + 1) * 4 * W,
                                  (n_phase + 1) * 4 + partner);
  int smem_acc = 1;
  if (log_tl < 0) {
    log_tl = bbt::choose_log_tl(n1, L, 0, partner);
    smem_acc = 0;
  }
  if (log_tl < 0) return cudaErrorInvalidValue;
  size_t smem = bbt::column_smem(n1, log_tl) + partner;
  if (smem_acc)
    smem += (static_cast<size_t>(n_phase + 1) * W << log_tl) * 4 +
            (n_phase + 1) * 4;
  cudaError_t err = bbt::prepare(bbt::k3_fold_kernel<STOKES>, smem, device);
  if (err != cudaSuccess) return err;
  // ~1024 blocks in all; each walks n2 / groups columns
  const int lane_tiles = L >> log_tl;
  int groups = 1024 / lane_tiles;
  if (groups < 1) groups = 1;
  if (groups > n2) groups = n2;
  bbt::k3_fold_kernel<STOKES><<<dim3(lane_tiles, groups), kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      zr, zi, fold, prof, cnt, bbt::log2i(n1), bbt::log2i(n2), L, log_tl,
      n_phase, pad_start, n_valid, smem_acc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bbt_k2(float* yr, float* yi, const float* csr, const float* csi,
                      int n1, int n2, int L, int device, void* stream) {
  return launch_k2<false>(yr, yi, csr, csi, n1, n2, L, device, stream);
}

// k2_theta: K2 with the chirp as one phase plane (cycles).
extern "C" int bbt_k2_theta(float* yr, float* yi, const float* theta, int n1,
                            int n2, int L, int device, void* stream) {
  return launch_k2<true>(yr, yi, theta, nullptr, n1, n2, L, device, stream);
}

extern "C" int bbt_k3_fold(const float* zr, const float* zi, const int* fold,
                           float* prof, unsigned* cnt, int n1, int n2, int L,
                           int n_phase, int pad_start, int n_valid, int device,
                           void* stream) {
  return launch_k3_fold<false>(zr, zi, fold, prof, cnt, n1, n2, L, n_phase,
                               pad_start, n_valid, device, stream);
}

// k3_fold_stokes: K3 folding the (n_phase+1, 3L) full-Stokes profile.
extern "C" int bbt_k3_fold_stokes(const float* zr, const float* zi,
                                  const int* fold, float* prof, unsigned* cnt,
                                  int n1, int n2, int L, int n_phase,
                                  int pad_start, int n_valid, int device,
                                  void* stream) {
  return launch_k3_fold<true>(zr, zi, fold, prof, cnt, n1, n2, L, n_phase,
                              pad_start, n_valid, device, stream);
}
