// Single-pass coherent dedispersion -> detection -> fold over small
// overlap-save windows.
//
// resident: replaces `_resident_body` (baseband_tasks_tpu/ops/
// dedisperse_resident.py:191, launched by `_resident_impl` :265), for both
// of its engines ('stockham' and 'mxu' compute the same function; the
// TPU's DFT-matmul form has no counterpart here yet).
//
// The block of T rows (T a multiple of hop = N - pad_start - pad_end) is
// cut into T / hop windows of N rows (N a power of two, 2048-4096 in use):
// window w covers block rows [w*hop - pad_start, w*hop + hop + pad_end),
// rows before the block taken from the front halo and rows after it from
// the end halo.  Block (lane tile, window group) walks its windows; for
// each it assembles the window column for `tl` lanes in shared memory,
// scales it, runs the forward FFT over all N rows (fft.cuh DIF: natural
// order in, bit-reversed out), multiplies by the chirp at frequency
// k = bitrev(position) (the chirp's d-major storage (N2, N1, L) is a
// reshape of natural order, so its flat row IS k), runs the inverse FFT
// (DIT: bit-reversed in, natural out), scales by 1/N, detects |z|^2 (or
// full Stokes, lane l with lane (l+1) mod L) and folds.  The JAX four-step
// (stage A, twiddle, stage B, chirp, mirrored inverse) is the same DFT
// decomposed for the TPU's tiles; one whole-column FFT needs no
// permutation pass here.
//
// The fold is K3's (csrc/dedisperse.cu `k3_fold_kernel`): window row r is
// block-local time t = w*hop + r (t = 0 at the front halo's start), the
// fixed-point bin map in uint32 ((i0 + t*p) & 0x7FFFFFFF, then the 16-bit
// split), rows outside [pad_start, pad_start + hop) to trash bin n_phase;
// shared-memory partials per block, added to the global (n_phase+1, W*L)
// profile and counts with atomics at the block's end (counts by the
// lane-tile-0 blocks only).  With STOKES the partner of the tile's last
// lane, (l0 + tl) mod L, has its window column carried through the whole
// chain beside the tile.
//
// What bounds it on an H100: bytes and operations about equally.  The
// function needs the block, the halos and the chirp once and writes only
// the profile: ~0.27 GB for a 261,120-row, 128-lane block at N = 2048,
// 0.081 ms, against ~5.4 GFLOP of FFT work over every window's N rows,
// 0.080 ms.  The kernel itself reads every window's N rows (the pads
// twice: N / hop times the block in all, 1.33 at N = 2048) and the chirp
// per window from L2.  The three-pass chain moves ~1.4 GB per 2^18-row
// window.  The design trades its device-memory passes for
// shared-memory FFT passes: a 2048-row column of 4 lanes (64 KB, so two
// or three blocks share an SM) or a 4096-row column of 4 lanes (128 KB)
// stays resident from load to fold.  The passes are latency-bound, not
// bandwidth-bound, so the tile is chosen for blocks per SM before lanes.

#include <cuda_runtime.h>

#include "common.cuh"
#include "fft.cuh"

namespace bbt {

constexpr long kTwoBlocksSmem = 110 * 1024;

template <bool STOKES>
__global__ void __launch_bounds__(kThreads)
resident_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ fr, const float* __restrict__ fi,
                const float* __restrict__ er, const float* __restrict__ ei,
                const float* __restrict__ cr, const float* __restrict__ ci,
                const int* __restrict__ fold, const float* __restrict__ scale,
                float* __restrict__ prof, unsigned* __restrict__ cnt,
                int log_n, int L, int log_tl, int ps, int hop, int T,
                int n_phase, int smem_acc) {
  constexpr int W = STOKES ? 3 : 1;   // profile planes
  extern __shared__ float2 smem[];
  const int n = 1 << log_n;
  const int tl = 1 << log_tl;
  float2* x = smem;
  float2* xp = smem + (n << log_tl);       // STOKES: the partner lane's column
  float2* tw = xp + (STOKES ? n : 0);
  float* pprof = reinterpret_cast<float*>(tw + n / 2);
  const int acc_rows = (n_phase + 1) * W;
  unsigned* pcnt = reinterpret_cast<unsigned*>(pprof + (acc_rows << log_tl));
  const int l0 = blockIdx.x << log_tl;
  const int lp = (l0 + tl) % L;            // partner of the tile's last lane
  const bool counter = blockIdx.x == 0;
  const int n_w = T / hop;
  fill_twiddles(tw, n);
  if (smem_acc) {
    for (int i = threadIdx.x; i < (acc_rows << log_tl); i += blockDim.x)
      pprof[i] = 0.0f;
    for (int i = threadIdx.x; i <= n_phase; i += blockDim.x) pcnt[i] = 0u;
  }
  const float s = *scale;
  const unsigned i0 = static_cast<unsigned>(fold[0]);
  const unsigned p = static_cast<unsigned>(fold[1]);
  const unsigned nph = static_cast<unsigned>(n_phase);
  const float inv_n = 1.0f / static_cast<float>(n);
  const int total = n << log_tl;
  auto add = [&](unsigned bin, int k, int lane, float v) {
    const int row = static_cast<int>(bin) * W + k;
    if (smem_acc) atomicAdd(&pprof[(row << log_tl) + lane], v);
    else atomicAdd(&prof[static_cast<long>(row) * L + l0 + lane], v);
  };

  for (int w = blockIdx.y; w < n_w; w += gridDim.y) {
    // window row r <-> block row q = w*hop - ps + r: front halo row q + ps
    // before the block, end halo row q - T after it
    auto sample = [&](int r, int lane) {
      const int q = w * hop - ps + r;
      const float *pr = xr, *pi = xi;
      long row = q;
      if (q < 0) { pr = fr; pi = fi; row = q + ps; }
      else if (q >= T) { pr = er; pi = ei; row = q - T; }
      const long a = row * L + lane;
      return make_float2(pr[a], pi[a]);
    };
    auto scaled = [&](float2* dst) {
      return [=](int idx, float2 v) { dst[idx] = make_float2(v.x * s, v.y * s); };
    };
    batched(total,
            [&](int idx) { return sample(idx >> log_tl, l0 + (idx & (tl - 1))); },
            scaled(x));
    if constexpr (STOKES)
      batched(n, [&](int r) { return sample(r, lp); }, scaled(xp));
    __syncthreads();
    fft_dif<false>(x, tw, log_n, log_tl);
    if constexpr (STOKES) fft_dif<false>(xp, tw, log_n, 0);
    // chirp at natural frequency k = bitrev(position), flat row k of the
    // d-major (N2, N1, L) storage
    batched(total,
            [&](int idx) {
              const long a = static_cast<long>(bitrev(idx >> log_tl, log_n)) * L +
                             l0 + (idx & (tl - 1));
              return make_float2(cr[a], ci[a]);
            },
            [&](int idx, float2 c) { x[idx] = cmul(x[idx], c); });
    if constexpr (STOKES)
      batched(n,
              [&](int r) {
                const long a = static_cast<long>(bitrev(r, log_n)) * L + lp;
                return make_float2(cr[a], ci[a]);
              },
              [&](int r, float2 c) { xp[r] = cmul(xp[r], c); });
    __syncthreads();
    fft_dit<true>(x, tw, log_n, log_tl);
    if constexpr (STOKES) fft_dit<true>(xp, tw, log_n, 0);

    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int lane = idx & (tl - 1);
      const int r = idx >> log_tl;
      const float2 v = x[idx];
      const float vr = v.x * inv_n;
      const float vi = v.y * inv_n;
      unsigned bin = nph;
      if (r >= ps && r - ps < hop) {
        const unsigned t = static_cast<unsigned>(w * hop + r);
        const unsigned num = (i0 + t * p) & 0x7FFFFFFFu;
        bin = ((num >> 16) * nph + (((num & 0xFFFFu) * nph) >> 16)) >> 15;
      }
      add(bin, 0, lane, vr * vr + vi * vi);
      if constexpr (STOKES) {
        const float2 q = lane + 1 < tl ? x[idx + 1] : xp[r];
        const float qr = q.x * inv_n;
        const float qi = q.y * inv_n;
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

template <bool STOKES>
int launch_resident(const float* xr, const float* xi, const float* fr,
                    const float* fi, const float* er, const float* ei,
                    const float* cr, const float* ci, const int* fold,
                    const float* scale, float* prof, unsigned* cnt, int n,
                    int L, int ps, int pe, int T, int n_phase, int device,
                    void* stream) {
  constexpr int W = STOKES ? 3 : 1;
  const int hop = n - ps - pe;
  if (n < 2 || (n & (n - 1)) || hop <= 0 || ps < 0 || pe < 0 || T % hop ||
      T <= 0 || n_phase < 1)
    return cudaErrorInvalidValue;
  const int partner = STOKES ? n * 8 : 0;   // the partner lane's column
  const int per_lane = (n_phase + 1) * 4 * W;
  const int fixed = (n_phase + 1) * 4 + partner;
  // power: a tile of >= 4 lanes (16-byte runs) small enough for two
  // blocks to share an SM's 228 KB, whose warps hide the FFT passes'
  // barriers (chip_smoke.py phase (k), 261,120 x 128 block at N = 2048
  // on an NVIDIA H100 80GB HBM3, 700.00 W: 1.23 ms with 4 lanes, 1.59
  // with 8); Stokes: the largest tile that fits, since the partner
  // column's one-lane passes cost more against a smaller tile (same
  // card and block: 2.54 ms with 4 lanes, 2.40 with 8; PERF.md §6)
  int log_tl = STOKES ? -1
                      : choose_log_tl(n, L, per_lane, fixed, kTwoBlocksSmem, 2);
  if (log_tl < 0) log_tl = choose_log_tl(n, L, per_lane, fixed);
  int smem_acc = 1;
  if (log_tl < 0) {
    log_tl = choose_log_tl(n, L, 0, partner);
    smem_acc = 0;
  }
  if (log_tl < 0) return cudaErrorInvalidValue;
  size_t smem = column_smem(n, log_tl) + partner;
  if (smem_acc)
    smem += (static_cast<size_t>(n_phase + 1) * W << log_tl) * 4 +
            (n_phase + 1) * 4;
  cudaError_t err = prepare(resident_kernel<STOKES>, smem, device);
  if (err != cudaSuccess) return err;
  const int n_w = T / hop;
  const int groups = n_w < 65535 ? n_w : 65535;
  resident_kernel<STOKES><<<dim3(L >> log_tl, groups), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      xr, xi, fr, fi, er, ei, cr, ci, fold, scale, prof, cnt, log2i(n), L,
      log_tl, ps, hop, T, n_phase, smem_acc);
  return cudaGetLastError();
}

}  // namespace bbt

// --- C entry point: returns the cudaGetLastError() of its launch. ---

// resident: x planes (T, L), front (ps, L), end (pe, L), chirp storage
// (N2, N1, L) for the window length n, fold (3,) int32, scale (1,); adds
// into the zeroed profile (n_phase+1, W*L) and counts (n_phase+1,).
extern "C" int bbt_resident(const float* xr, const float* xi, const float* fr,
                            const float* fi, const float* er, const float* ei,
                            const float* cr, const float* ci, const int* fold,
                            const float* scale, float* prof, unsigned* cnt,
                            int n, int L, int ps, int pe, int T, int n_phase,
                            int stokes, int device, void* stream) {
  return stokes ? bbt::launch_resident<true>(xr, xi, fr, fi, er, ei, cr, ci,
                                             fold, scale, prof, cnt, n, L, ps,
                                             pe, T, n_phase, device, stream)
                : bbt::launch_resident<false>(xr, xi, fr, fi, er, ei, cr, ci,
                                              fold, scale, prof, cnt, n, L, ps,
                                              pe, T, n_phase, device, stream);
}
