// The four-step FFT's stand-alone passes: a natural-order power-of-two
// FFT (the 'pallas' FFT engine) and the overlap-save spectral filter.
//
// The window of N = N1 * N2 samples and L lanes is viewed as (N1, N2, L)
// with time t = c * N2 + b; between the passes the data sits in d-major
// storage order (N2, N1, L), where row d, column c holds frequency
// k = d * N1 + c, so a forward transform's output reshaped to (N, L) is
// the spectrum in natural order, and a natural-order spectrum reshaped to
// (N2, N1, L) is an inverse transform's input.  Stage A of a plain window
// is dedisperse.cu's K1 launched as k1_window.
//
//   k2_fwd   stage-B FFT over d's column (length N2), x scale   (N2, N1, L)
//   k2_inv   inverse stage-B FFT, x scale, W_N^{+c b}           (N2, N1, L)
//   k3_trim  inverse stage-A FFT over c (/N1), rows c in [kf, N1 - ke)
//            stored in natural time order                       (N - pads, L)
//   lane_mix (rows, L) planes times a complex (L, L) matrix: the
//            spectral filter's `pre`/`post` mixes               (rows, L)
//
// What bounds them on an H100: bytes.  Each pass reads and writes two
// float32 planes once (2 x 2 x 4 B x N x L: 537 MB at N = 2^18, L = 128,
// ~0.16 ms at 3.35 TB/s) against ~N L log2(N2) x 5 flops of FFT work.
// As in dedisperse.cu, one block holds one column for a tile of up to 16
// contiguous lanes in shared memory, the lane tile is the fastest grid
// index so the blocks in flight read whole rows, each thread keeps
// kBatch loads in flight, and the FFT is fft.cuh's in-place radix-2 with
// three stages per shared-memory pass.  k3_trim never stores the pad
// rows, so the overlap-save discard costs no pass of its own.

#include <cuda_runtime.h>

#include "common.cuh"
#include "fft.cuh"
#include "lanemix.cuh"

namespace bbt {

// ---------------------------------------------------------------------------
// k2_fwd (INVERSE = false): replaces `_k2_fwd_body` (fft_pallas.py:36,
// launched by `_fft_impl` :81).  k2_inv (INVERSE = true): replaces
// `_k2_inv_body` (fft_pallas.py:44, launched by `_fft_impl` :89).
//
// Block (lane tile, c) loads column c of the (N2, N1, L) input (rows
// r*N1+c), runs the FFT over r (DIF: output row r sits at bit-reversed
// position r), scales, and writes output row r to row r*N1+c.  Forward,
// the input is d-major stage-A output and row r is frequency bin d, so
// the output reshaped to (N, L) is the natural spectrum.  Inverse, the
// input is a natural spectrum seen as (N2, N1, L), row r is time b, and
// the W_N^{+c b} twiddle is applied for k3_trim.  The caller splits an
// inverse transform's scale as the TPU kernels do: `scale` here is the
// target scale times N1, and k3_trim divides by N1.
// Bound: bytes (read two planes, write two planes).
template <bool INVERSE>
__global__ void __launch_bounds__(kThreads)
k2_pass_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi, float scale,
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
  auto at = [&](int row, int lane) {
    return (static_cast<long>(row) * n1 + c) * L + l0 + lane;
  };
  batched(total,
          [&](int idx) {
            const long a = at(idx >> log_tl, idx & (tl - 1));
            return make_float2(xr[a], xi[a]);
          },
          [&](int idx, float2 v) { x[idx] = v; });
  __syncthreads();
  fft_dif<INVERSE>(x, tw, log_n2, log_tl);
  const float nf = static_cast<float>(n1) * static_cast<float>(n2);
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int lane = idx & (tl - 1);
    const int r = idx >> log_tl;
    const float2 v = x[(bitrev(r, log_n2) << log_tl) + lane];
    float2 out = make_float2(v.x * scale, v.y * scale);
    if constexpr (INVERSE) {
      float sn, cs;
      sincospif(2.0f * static_cast<float>(c * r) / nf, &sn, &cs);
      out = cmul(out, make_float2(cs, sn));
    }
    const long o = at(r, lane);
    yr[o] = out.x;
    yi[o] = out.y;
  }
}

// ---------------------------------------------------------------------------
// k3_trim: replaces `_k3_trim_body` (spectral_filter.py:129, launched by
// `_spectral_filter_impl` :245) without `post`, and `_k3_body`
// (dedisperse_pallas.py:314) in its re/im form, which is the case
// kf = ke = 0 (launched by `_stages_bc` :490 and `fft_pallas._fft_impl`
// :95).  Block (lane tile, b) loads row b of the d-major planes (rows
// b*N1+c, contiguous in c), runs the inverse FFT over c (DIF: time
// t = c*N2 + b at bit-reversed position c), scales by 1/N1 and stores only
// the rows c in [kf, N1 - ke), as output row (c - kf)*N2 + b: the pad rows
// never reach device memory.
// Bound: bytes (read two planes, write the valid part of two planes).
__global__ void __launch_bounds__(kThreads)
k3_trim_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
               float* __restrict__ outr, float* __restrict__ outi,
               int log_n1, int log_n2, int L, int log_tl, int kf, int ke) {
  extern __shared__ float2 smem[];
  const int n1 = 1 << log_n1;
  const int n2 = 1 << log_n2;
  const int tl = 1 << log_tl;
  float2* x = smem;
  float2* tw = smem + (n1 << log_tl);
  const int b = blockIdx.y;
  const int l0 = blockIdx.x << log_tl;
  fill_twiddles(tw, n1);

  batched(n1 << log_tl,
          [&](int idx) {
            const long a = (static_cast<long>(b) * n1 + (idx >> log_tl)) * L +
                           l0 + (idx & (tl - 1));
            return make_float2(zr[a], zi[a]);
          },
          [&](int idx, float2 v) { x[idx] = v; });
  __syncthreads();
  fft_dif<true>(x, tw, log_n1, log_tl);
  const float inv_n1 = 1.0f / static_cast<float>(n1);
  const int total = (n1 - kf - ke) << log_tl;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int lane = idx & (tl - 1);
    const int j = idx >> log_tl;
    const float2 v = x[(bitrev(kf + j, log_n1) << log_tl) + lane];
    const long o = (static_cast<long>(j) * n2 + b) * L + l0 + lane;
    outr[o] = v.x * inv_n1;
    outi[o] = v.y * inv_n1;
  }
}

// ---------------------------------------------------------------------------
// lane_mix: replaces `_lane_matmul` (spectral_filter.py:78) as the TPU
// kernels apply it inside `_k1_filter_body` (:92, `pre`) and
// `_k3_trim_body` (:129, `post`).  Those kernels hold all L lanes of a
// row block; the passes here hold a column for a tile of <= 16 lanes, so
// the mix runs as its own pass right after stage A (`pre`: a lane mix
// commutes with the row FFT and twiddle, which act on every lane alike)
// or after k3_trim (`post`).  Block i loads rows [16 i, 16 i + 16) of
// all L lanes into shared memory and `mix_tile` multiplies them by W.
// Bound: FP32 FMAs (8 L flops per element) above L ~ 64; below, bytes.
__global__ void __launch_bounds__(kThreads)
lane_mix_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ wr, const float* __restrict__ wi,
                float* __restrict__ yr, float* __restrict__ yi, int rows,
                int L) {
  extern __shared__ float2 tile[];
  const long row0 = static_cast<long>(blockIdx.x) * kMixRows;
  const int nr = min(kMixRows, static_cast<int>(rows - row0));
  const long base = row0 * L;
  batched(kMixRows * L,
          [&](int idx) {
            return idx < nr * L ? make_float2(xr[base + idx], xi[base + idx])
                                : make_float2(0.0f, 0.0f);
          },
          [&](int idx, float2 v) { tile[idx] = v; });
  __syncthreads();
  mix_tile(tile, L, wr, wi, yr, yi, row0, nr);
}

}  // namespace bbt

using bbt::kThreads;

// --- C entry points: each returns the cudaGetLastError() of its launch. ---

namespace {

template <bool INVERSE>
int launch_k2_pass(const float* inr, const float* ini, float* outr,
                   float* outi, float scale, int n1, int n2, int L,
                   int device, void* stream) {
  const int log_tl = bbt::choose_log_tl(n2, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n2, log_tl);
  cudaError_t err = bbt::prepare(bbt::k2_pass_kernel<INVERSE>, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k2_pass_kernel<INVERSE><<<dim3(L >> log_tl, n1), kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      inr, ini, outr, outi, scale, bbt::log2i(n1), bbt::log2i(n2), L, log_tl);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bbt_k2_fwd(const float* yr, const float* yi, float* zr,
                          float* zi, float scale, int n1, int n2, int L,
                          int device, void* stream) {
  return launch_k2_pass<false>(yr, yi, zr, zi, scale, n1, n2, L, device,
                               stream);
}

extern "C" int bbt_k2_inv(const float* xr, const float* xi, float* yr,
                          float* yi, float scale, int n1, int n2, int L,
                          int device, void* stream) {
  return launch_k2_pass<true>(xr, xi, yr, yi, scale, n1, n2, L, device,
                              stream);
}

extern "C" int bbt_k3_trim(const float* zr, const float* zi, float* outr,
                           float* outi, int n1, int n2, int L, int kf, int ke,
                           int device, void* stream) {
  const int log_tl = bbt::choose_log_tl(n1, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n1, log_tl);
  cudaError_t err = bbt::prepare(bbt::k3_trim_kernel, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k3_trim_kernel<<<dim3(L >> log_tl, n2), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      zr, zi, outr, outi, bbt::log2i(n1), bbt::log2i(n2), L, log_tl, kf, ke);
  return cudaGetLastError();
}

extern "C" int bbt_lane_mix(const float* xr, const float* xi, const float* wr,
                            const float* wi, float* yr, float* yi, int rows,
                            int L, int device, void* stream) {
  if (rows < 1 || L < 1 || L > bbt::kMaxMixLanes) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(bbt::kMixRows) * L * sizeof(float2);
  cudaError_t err = bbt::prepare(bbt::lane_mix_kernel, smem, device);
  if (err != cudaSuccess) return err;
  bbt::lane_mix_kernel<<<(rows + bbt::kMixRows - 1) / bbt::kMixRows,
                         bbt::mix_threads(L), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      xr, xi, wr, wi, yr, yi, rows, L);
  return cudaGetLastError();
}
