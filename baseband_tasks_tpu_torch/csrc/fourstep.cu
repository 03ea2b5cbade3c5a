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
//   k3_power the same without pads, storing |.|^2               (N, L)
//   lane_mix (rows, L) planes times a complex (L, L) matrix: the
//            spectral filter's `pre`/`post` mixes, in 3xTF32 on the
//            tensor cores (tf32mma.cuh)                         (rows, L)
//
// What bounds the FFT passes on an H100: bytes.  Each pass reads and writes two
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
#include "tf32mma.cuh"

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
// :95).  With POWER it is `_k3_body`'s |.|^2 form, launched as k3_power
// (no pads, one output plane).  Block (lane tile, b) loads row b of the
// d-major planes (rows b*N1+c, contiguous in c), runs the inverse FFT
// over c (DIF: time t = c*N2 + b at bit-reversed position c), scales by
// 1/N1 and stores only the rows c in [kf, N1 - ke), as output row
// (c - kf)*N2 + b: the pad rows never reach device memory.
// Bound: bytes (read two planes, write the valid part of two planes, or
// of one with POWER).
template <bool POWER>
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
    const float vr = v.x * inv_n1;
    const float vi = v.y * inv_n1;
    if constexpr (POWER) {
      outr[o] = vr * vr + vi * vi;
    } else {
      outr[o] = vr;
      outi[o] = vi;
    }
  }
}

// ---------------------------------------------------------------------------
// lane_mix: replaces `_lane_matmul` (spectral_filter.py:78) as the TPU
// kernels apply it inside `_k1_filter_body` (:92, `pre`) and
// `_k3_trim_body` (:129, `post`).  Those kernels hold all L lanes of a
// row block; the passes here hold a column for a tile of <= 16 lanes, so
// the mix runs as its own pass right after stage A (`pre`: a lane mix
// commutes with the row FFT and twiddle, which act on every lane alike)
// or after k3_trim (`post`).
//
// The complex product is one real GEMM, [xr | xi] (rows, 2L) @
// [[wr, wi], [-wi, wr]] (2L, 2L) -> [yr | yi], in 3xTF32 on the tensor
// cores (tf32mma.cuh): one partial and one float32 total a thread per
// output, where four real products into two would need the data operand
// twice per step.  The partial and the total take BN registers a thread:
// BN 128 (the 256-column tile of a single accumulator would need 256).
// The block matrix is built, split and staged once per mixer by the
// wrapper (ops/tf32.py).  A block computes 128 rows x BN columns
// of [yr | yi]; the A loader reads xr for k < L and xi above, and
// zero-fills rows past `rows` and depth past 2L (VEC: 16-byte copies when
// L % 4 == 0 and the planes are 16-byte aligned; else 4-byte copies).
// Bound: tensor-core operations, 3 passes x 8 L flops per complex output
// element (0.42 ms at 2^15 x 512, 0.21 ms at 261,120 x 128 at 495
// TFLOP/s), above the bytes (0.08 / 0.16 ms).  What holds it back is
// staging: each block reads its 8 KB of x and 16 KB of split mixer per
// stage from L2, which alone takes about as long as the MMAs (0.47 ms at
// 2^15 x 512, tools/tf32_sweep.py's "staging only"), and the two overlap
// little.
template <int BN, bool VEC>
struct MixTile {
  static constexpr int kA = tc::kBM * tc::kAStride;   // a staged A tile
  static constexpr int kB = 2 * BN * tc::kBK;         // big + small B
  static constexpr int kStage = kA + kB;

  const float* xr;
  const float* xi;
  const float* wtile;                 // this column tile's staged mixer
  long m0;
  int rows, L, k_tiles;
  float total[BN / 2], part[BN / 2];   // float32 totals, the partial
  tc::Frag f[2];

  __device__ __forceinline__ void load(int kt, float* sa) const {
    const int tid = threadIdx.x;
    const int k0 = kt * tc::kBK;
    const int K = 2 * L;
    constexpr int kPer = VEC ? 4 : 1;          // floats a copy
    constexpr int kCopies = tc::kBM * tc::kBK / kPer / tc::kThreads;
#pragma unroll
    for (int u = 0; u < kCopies; ++u) {
      const int idx = tid + u * tc::kThreads;
      const int r = idx / (tc::kBK / kPer);
      const int c = (idx % (tc::kBK / kPer)) * kPer;
      const int k = k0 + c;
      const long row = m0 + r;
      const bool ok = row < rows && k < K;
      const float* src = xr;
      if (ok) src = k < L ? xr + row * L + k : xi + row * L + (k - L);
      if constexpr (VEC) {
        tc::cp_async16(sa + r * tc::kAStride + c, src, ok);
      } else {
        tc::cp_async4(sa + r * tc::kAStride + c, src, ok);
      }
    }
    const bool in = kt < k_tiles;              // not a stage padding a period
    const float* bsrc = wtile + static_cast<long>(in ? kt : 0) * kB;
    static_assert(kB % (4 * tc::kThreads) == 0, "whole 16-byte copies");
#pragma unroll
    for (int u = 0; u < kB / 4 / tc::kThreads; ++u) {
      const int idx = 4 * (tid + u * tc::kThreads);
      tc::cp_async16(sa + kA + idx, bsrc + idx, in);
    }
  }

  template <int S>
  __device__ __forceinline__ void frags(const float* sa, int j) {
    float raw[4];
    tc::load_raw(tc::frag_base(sa), j, raw);
    tc::split4(raw, f[S]);
  }

  template <int S>
  __device__ __forceinline__ void mma(const float* sa, int j, bool fresh) {
    tc::wgmma_fence();
    tc::mma3<BN>(part, f[S], sa + kA, sa + kA + BN * tc::kBK, j, fresh);
    tc::wgmma_commit();
  }

  __device__ __forceinline__ void promote() {
    tc::pin(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] += part[i];
  }
};

template <int BN, int STAGES, int PERIOD, bool VEC>
__global__ void __launch_bounds__(tc::kThreads, 1)
lane_mix_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ wp, float* __restrict__ yr,
                float* __restrict__ yi, int rows, int L, int n_tiles,
                int k_tiles) {
  using Tile = MixTile<BN, VEC>;
  extern __shared__ __align__(128) float stages[];
  const int n_tile = blockIdx.x % n_tiles;     // column tiles of a row block
  const long m0 = static_cast<long>(blockIdx.x / n_tiles) * tc::kBM;
  Tile t{xr, xi, wp + static_cast<long>(n_tile) * k_tiles * Tile::kB, m0,
         rows, L, k_tiles};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) t.total[i] = t.part[i] = 0.0f;
  tc::run_pipeline<STAGES, Tile::kStage, PERIOD>(t, stages, k_tiles);
  const int K = 2 * L;

  // column c of the tile is yr[., c] below L, yi[., c - L] below 2 L
  const int c0 = n_tile * BN;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const long row = m0 + tc::acc_row(i);
    const int col = c0 + tc::acc_col(i);
    if (row >= rows) continue;
    const float y[2] = {t.total[i], t.total[i + 1]};
    if constexpr (VEC) {                       // L even: a pair stays in a plane
      if (col < K) {
        float* dst = col < L ? yr + row * L + col : yi + row * L + (col - L);
        *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col + h;
        if (c < L) {
          yr[row * L + c] = y[h];
        } else if (c < K) {
          yi[row * L + (c - L)] = y[h];
        }
      }
    }
  }
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

namespace {

template <bool POWER>
int launch_k3_trim(const float* zr, const float* zi, float* outr, float* outi,
                   int n1, int n2, int L, int kf, int ke, int device,
                   void* stream) {
  const int log_tl = bbt::choose_log_tl(n1, L, 0, 0);
  if (log_tl < 0) return cudaErrorInvalidValue;
  const size_t smem = bbt::column_smem(n1, log_tl);
  cudaError_t err = bbt::prepare(bbt::k3_trim_kernel<POWER>, smem, device);
  if (err != cudaSuccess) return err;
  bbt::k3_trim_kernel<POWER><<<dim3(L >> log_tl, n2), kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      zr, zi, outr, outi, bbt::log2i(n1), bbt::log2i(n2), L, log_tl, kf, ke);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bbt_k3_trim(const float* zr, const float* zi, float* outr,
                           float* outi, int n1, int n2, int L, int kf, int ke,
                           int device, void* stream) {
  return launch_k3_trim<false>(zr, zi, outr, outi, n1, n2, L, kf, ke, device,
                               stream);
}

// k3_power: inverse stage A and |.|^2 of a whole window, (N, L) in time
// order.
extern "C" int bbt_k3_power(const float* zr, const float* zi, float* out,
                            int n1, int n2, int L, int device, void* stream) {
  return launch_k3_trim<true>(zr, zi, out, nullptr, n1, n2, L, 0, 0, device,
                              stream);
}

namespace {

constexpr int kMixBN = 128, kMixStages = 4, kMixPeriod = 2;

template <bool VEC>
int launch_lane_mix(const float* xr, const float* xi, const float* wp,
                    float* yr, float* yi, int rows, int L, int device,
                    cudaStream_t stream) {
  using bbt::tc::kBK;
  using bbt::tc::kBM;
  constexpr size_t smem = static_cast<size_t>(kMixStages) *
                          bbt::MixTile<kMixBN, VEC>::kStage * sizeof(float);
  auto kernel = bbt::lane_mix_kernel<kMixBN, kMixStages, kMixPeriod, VEC>;
  cudaError_t err = bbt::prepare(kernel, smem, device);
  if (err != cudaSuccess) return err;
  const int n_tiles = (2 * L + kMixBN - 1) / kMixBN;
  const int k_tiles = (2 * L + kBK - 1) / kBK;
  const long blocks = static_cast<long>(n_tiles) * ((rows + kBM - 1) / kBM);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), bbt::tc::kThreads, smem, stream>>>(
      xr, xi, wp, yr, yi, rows, L, n_tiles, k_tiles);
  return cudaGetLastError();
}

}  // namespace

// lane_mix: wp is the mixer staged by ops/tf32.py `pack_operand` for
// this kernel's tile (`bbt_lane_mix_tile`); vec = L % 4 == 0 with 16-byte
// aligned planes.
extern "C" int bbt_lane_mix(const float* xr, const float* xi, const float* wp,
                            float* yr, float* yi, int rows, int L, int vec,
                            int device, void* stream) {
  if (rows < 1 || L < 1 || L > bbt::kMaxMixLanes || (vec && L % 4))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch_lane_mix<true>(xr, xi, wp, yr, yi, rows, L, device, st)
             : launch_lane_mix<false>(xr, xi, wp, yr, yi, rows, L, device,
                                      st);
}

// The (columns, depth) tile lane_mix's staged mixer is laid out for.
extern "C" int bbt_lane_mix_tile(int* tile) {
  tile[0] = kMixBN;
  tile[1] = bbt::tc::kBK;
  return 0;
}
