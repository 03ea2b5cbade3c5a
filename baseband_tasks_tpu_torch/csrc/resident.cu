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
// the end halo.  Each window column is scaled, run through the forward
// FFT over all N rows, multiplied by the chirp at natural frequency k
// (the chirp's d-major storage (N2, N1, L) is a reshape of natural order,
// so its flat row IS k), run through the inverse FFT, scaled by 1/N,
// detected |z|^2 (or full Stokes, lane l with lane (l+1) mod L) and folded.
// The JAX four-step (stage A, twiddle, stage B, chirp, mirrored inverse)
// is the same DFT decomposed for the TPU's tiles; one whole-column FFT
// needs no permutation pass here.
//
// The fold is K3's (csrc/dedisperse.cu `k3_fold_kernel`): window row r is
// block-local time t = w*hop + r (t = 0 at the front halo's start), the
// fixed-point bin map in uint32 ((i0 + t*p) & 0x7FFFFFFF, then the 16-bit
// split), rows outside [pad_start, pad_start + hop) to trash bin n_phase;
// shared-memory partials per block, added to the global (n_phase+1, W*L)
// profile and counts with atomics at the block's end (counts by the
// lane-tile-0 blocks only).
//
// What bounds it on an H100: bytes and operations about equally.  The
// function needs the block, the halos and the chirp once and writes only
// the profile: ~0.27 GB for a 261,120-row, 128-lane block at N = 2048,
// 0.081 ms, against ~5.4 GFLOP of FFT work over every window's N rows,
// 0.080 ms.  The kernel reads every window's N rows (the pads twice: N /
// hop times the block in all, 1.33 at N = 2048).  The three-pass chain
// moves ~1.4 GB per 2^18-row window.
//
// resident_reg_kernel, the form every window up to 4096 rows takes (its
// block does not hold longer ones; bbt_resident_form says which form a
// shape runs), keeps the window in registers from load to fold:
// - Block (lane tile, window group) walks a run of consecutive windows
//   (about one block per resident slot of the card).  The next window's
//   rows are copied by cp.async (16-byte copies of a tile row, halo rows
//   at the block's ends) into one of the stage buffers while this one is
//   transformed; each buffer then serves as its window's exchange.  The
//   paths' four cases are compiled with the tile and stage buffers the
//   sweep picked (tools/fft_sweep.py): 4 lanes and two buffers at 2048 in
//   power, one buffer in Stokes; 2 lanes and one buffer at 4096.
// - Each thread holds R = 16 rows of one lane (reg::Plan radix 16: N =
//   2048 as 16.16.8, 4096 as 16.16.16, three passes, two exchanges, both
//   compiled for their sizes).  The chirp rows a thread needs are the
//   frequencies it holds after the forward FFT (natural order), the same
//   in every window, so they are loaded into registers once a block (the
//   4096-row Stokes block keeps half of them in shared memory); PR 10's
//   sweep chose this over reading them from L2 every window.  At a
//   compiled size the inverse FFT takes its inputs by renamed registers
//   (Plan::to_inputs).
// - The fold: the transformed window goes once through the exchange so
//   that each thread folds R consecutive rows of one lane; it sums its run
//   of equal bins in registers (a bin spans 6-25 rows at the paths' fold
//   rates; the pad rows are one run into trash bin n_phase for the
//   block's life, the run state parked in shared memory between windows)
//   and adds a run to the shared partials only when the bin changes
//   (float atomicAdd on shared memory is a compare-and-swap loop on this
//   card, and PR 10's sweep chose the runs over an atomic a value; Stokes
//   cross sums go in one 64-bit compare-and-swap, `add_pair`), counts one
//   integer atomic a run from the lane-0 items of the lane-tile-0 blocks.
// - Stokes: the partner of the tile's last lane, (l0 + tl) mod L, is
//   staged beside the tile and transformed in the same register passes by
//   threads of its own; a lane's partner is the next thread's value (a
//   shuffle), the last lane's comes from the partner's exchange.
// What holds it back (PR 10's sweep, which timed builds without the fold
// and without the FFTs): the FFTs' shared-memory exchanges and barriers,
// one block of 16-24 warps an SM; without the fold the kernel took ~0.87
// of its time, without the FFTs ~0.5.
// resident_kernel, the shared-memory form for longer windows: fft.cuh's
// radix-2 passes over the whole column in shared memory, the chirp
// gathered at bit-reversed rows, an atomic a value.

#include <cuda_runtime.h>

#include "common.cuh"
#include "fft.cuh"
#include "fft_reg.cuh"

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

// Sweep knobs (tools/fft_sweep.py): the lane tile and the stage buffers
// of each compiled case (N 2048 power, 2048 Stokes, 4096 power, 4096
// Stokes) and the chirp slots a thread of the 4096-row Stokes case holds
// in registers (its 768 threads have 80 registers each; the rest go to a
// per-thread copy in shared memory, read once a window); the general
// instantiation's stage buffers.
constexpr int kResTile2048 = 4, kResStages2048 = 2, kResTile2048S = 4,
              kResStages2048S = 1, kResTile4096 = 2, kResStages4096 = 1,
              kResTile4096S = 2, kResStages4096S = 1, kResChirpRegs4096S = 8;
constexpr int kResStages = 2;
constexpr int kResLogR = 4;            // radix-16 register passes
constexpr int kResMaxThreads = 512;    // the general instantiation's block

__host__ __device__ constexpr int res_warps(int n) { return (n + 31) / 32 * 32; }

// threads of a block: the tile's (lane, row group) items, then with
// STOKES the partner column's row groups, each in whole warps
__host__ __device__ constexpr int res_threads(bool stokes, int log_n,
                                              int log_tl) {
  const int groups = log_n > kResLogR ? 1 << (log_n - kResLogR) : 1;
  return res_warps(groups << log_tl) + (stokes ? res_warps(groups) : 0);
}

// the compiled cases' tiles (log2), -1 for a size compiled generally
__host__ __device__ constexpr int res_hot_tile(bool stokes, int log_n) {
  return log_n == 11   ? log2i(stokes ? kResTile2048S : kResTile2048)
         : log_n == 12 ? log2i(stokes ? kResTile4096S : kResTile4096)
                       : -1;
}

// the stage buffers of an instantiation (log_n < 0: the general one)
__host__ __device__ constexpr int res_stages(bool stokes, int log_n) {
  return log_n == 11   ? (stokes ? kResStages2048S : kResStages2048)
         : log_n == 12 ? (stokes ? kResStages4096S : kResStages4096)
                       : kResStages;
}

// chirp slots held in registers (of R = 16) by an instantiation
__host__ __device__ constexpr int res_chirp_regs(bool stokes, int log_n) {
  return stokes && log_n == 12 ? kResChirpRegs4096S : 1 << kResLogR;
}

__host__ __device__ constexpr int res_max_threads(bool stokes, int log_n) {
  return log_n < 0 ? kResMaxThreads
                   : res_threads(stokes, log_n, res_hot_tile(stokes, log_n));
}

// Shared-memory carve of a register-resident block: `stages` buffers,
// each a window's staged planes (the tile's re and im rows, then with
// STOKES the partner lane's) and then that window's exchange (the tile's
// rows, then the partner's); the twiddle tables; the partials; the chirp
// slots past `chirp_regs` of each of `threads` threads; each thread's run
// state between two folds (bin, count, W sums).
template <bool STOKES>
struct ResSmem {
  int stages, ex_main, buf, tw, acc, chs, runs;   // ex_main in float2 slots
  __host__ __device__ ResSmem(int n, int tl, int n_phase, int smem_acc,
                              int stages_, int threads, int chirp_regs)
      : stages(stages_) {
    const int stage = (2 * n * tl + (STOKES ? 2 * n : 0)) * 4;
    ex_main = reg::padded_size<1>(n * tl);
    const int ex = (ex_main + (STOKES ? reg::padded_size<1>(n) : 0)) * 8;
    buf = ((stage > ex ? stage : ex) + 15) / 16 * 16;
    tw = reg::twiddle_slots(log2i(n), kResLogR) * 8;
    acc = smem_acc ? ((n_phase + 1) * (STOKES ? 3 : 1) * tl + n_phase + 1) * 4
                   : 0;
    acc = (acc + 7) / 8 * 8;
    chs = ((1 << kResLogR) - chirp_regs) * threads * 8;
    runs = (2 + (STOKES ? 3 : 1)) * threads * 4;
  }
  __host__ __device__ int chirp_offset() const { return stages * buf + tw + acc; }
  __host__ __device__ int runs_offset() const { return chirp_offset() + chs; }
  __host__ __device__ int bytes() const { return runs_offset() + runs; }
};

// LOG_N and LOG_TL fix the window and the tile at compile time for the
// paths' windows (-1: the launch's arguments).  Threads [0, n_main) hold
// the tile's lanes, lane fastest; with STOKES threads [n_main, blockDim.x)
// hold the partner lane's column.  chunk: the cp.async copy size of a
// tile row (0: plain loads).
template <bool STOKES, int LOG_N, int LOG_TL>
__global__ void __launch_bounds__(res_max_threads(STOKES, LOG_N))
resident_reg_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ fr, const float* __restrict__ fi,
                    const float* __restrict__ er, const float* __restrict__ ei,
                    const float* __restrict__ cr, const float* __restrict__ ci,
                    const int* __restrict__ fold,
                    const float* __restrict__ scale, float* __restrict__ prof,
                    unsigned* __restrict__ cnt, int log_n_arg, int L,
                    int log_tl_arg, int ps, int hop, int T, int n_phase,
                    int smem_acc, int n_main, int chunk) {
  constexpr int W = STOKES ? 3 : 1;   // profile planes
  constexpr int R = 1 << kResLogR;
  constexpr unsigned kNoBin = 0xffffffffu;
  constexpr int S = res_stages(STOKES, LOG_N);   // stage buffers
  constexpr int CR = res_chirp_regs(STOKES, LOG_N);
  using Plan = reg::Plan<kResLogR, LOG_N>;
  extern __shared__ __align__(16) unsigned char res_smem[];
  const int log_n = LOG_N >= 0 ? LOG_N : log_n_arg;
  const int log_tl = LOG_TL >= 0 ? LOG_TL : log_tl_arg;
  const Plan plan(log_n);
  const int n = 1 << log_n;
  const int tl = 1 << log_tl;
  const ResSmem<STOKES> lay(n, tl, n_phase, smem_acc, S, blockDim.x, CR);
  float2* tw = reinterpret_cast<float2*>(res_smem + S * lay.buf);
  float* pprof = reinterpret_cast<float*>(res_smem + S * lay.buf + lay.tw);
  const int acc_rows = (n_phase + 1) * W;
  unsigned* pcnt = reinterpret_cast<unsigned*>(pprof + acc_rows * tl);
  const int l0 = blockIdx.x << log_tl;
  const int lp = (l0 + tl) % L;            // partner of the tile's last lane
  const bool counter = blockIdx.x == 0;
  const int nthreads = blockDim.x;
  reg::fill_twiddle_tables(tw, log_n, kResLogR);
  if (smem_acc) {
    for (int i = threadIdx.x; i < acc_rows * tl; i += nthreads)
      pprof[i] = 0.0f;
    for (int i = threadIdx.x; i <= n_phase; i += nthreads) pcnt[i] = 0u;
  }
  const float s = *scale;
  const unsigned i0 = static_cast<unsigned>(fold[0]);
  const unsigned p = static_cast<unsigned>(fold[1]);
  const unsigned nph = static_cast<unsigned>(n_phase);
  const float inv_n = 1.0f / static_cast<float>(n);

  // this thread's item: lane `lane` of the tile (tl: the Stokes partner),
  // row group t of the column's 2^log_t; the fold item of a tile thread
  // is the same (lane, group): rows [g*used, g*used + used)
  const bool partner = STOKES && static_cast<int>(threadIdx.x) >= n_main;
  const int item = partner ? threadIdx.x - n_main : threadIdx.x;
  const bool live[1] = {item < (partner ? 1 : tl) << plan.log_t};
  const int t[1] = {live[0] ? item >> (partner ? 0 : log_tl) : 0};
  const int lane = partner ? tl : item & (tl - 1);
  const int lane_abs = partner ? lp : l0 + lane;
  float2* ex;                          // the current window's exchange
  auto slot = [&](int, int row) {
    return partner ? ex + lay.ex_main + reg::pad_slot<1>(row)
                   : ex + reg::pad_slot<1>(row * tl + lane);
  };
  auto sync = [] { __syncthreads(); };

  // the chirp at the frequency rows this thread holds after the forward
  // FFT, the same rows in every window: slots [0, CR) in registers, the
  // rest in this thread's slots of shared memory
  float2 ch[CR];
  float2* chs = reinterpret_cast<float2*>(res_smem + lay.chirp_offset()) +
                threadIdx.x;
  // this thread's run state, [word][thread]: bin, count, the W sums
  unsigned* park = reinterpret_cast<unsigned*>(res_smem + lay.runs_offset()) +
                   threadIdx.x;
  park[0] = kNoBin;
  park[blockDim.x] = 0u;
#pragma unroll
  for (int k = 0; k < W; ++k) park[(2 + k) * blockDim.x] = 0u;
  // the chirp at the rows this thread holds after the forward FFT, for
  // the block's life
#pragma unroll
  for (int q = 0; q < R; ++q) {
    float2 c = make_float2(1.0f, 0.0f);
    if (live[0] && q < plan.used) {
      const long a = static_cast<long>(plan.rows_final(q, t[0])) * L +
                     lane_abs;
      c = make_float2(cr[a], ci[a]);
    }
    if (q < CR) ch[q < CR ? q : 0] = c;
    else chs[(q - CR) * blockDim.x] = c;
  }

  // window w's rows for the tile (and the partner lane) into buffer sb:
  // window row r is block row q = w*hop - ps + r, the front halo's row
  // q + ps before the block, the end halo's row q - T after it
  auto src = [&](int w, int r, int pl, int ln) {
    const int q = w * hop - ps + r;
    const float* base = pl ? xi : xr;
    long row = q;
    if (q < 0) {
      base = pl ? fi : fr;
      row = q + ps;
    } else if (q >= T) {
      base = pl ? ei : er;
      row = q - T;
    }
    return base + row * L + ln;
  };
  auto stage_window = [&](int w, float* sb) {
    float* sp = sb + 2 * n * tl;       // the partner's planes
    if (chunk) {
      const int per = chunk / 4;
      const int log_cpr = log_tl - (__ffs(per) - 1);   // copies a tile row
      const int total = (2 * n) << log_cpr;
      for (int i = threadIdx.x; i < total; i += nthreads) {
        const int k = i & ((1 << log_cpr) - 1);
        const int r = (i >> log_cpr) & (n - 1);
        const int pl = i >> (log_cpr + log_n);
        cp_async(sb + (pl * n + r) * tl + k * per, src(w, r, pl, l0 + k * per),
                 chunk);
      }
      if constexpr (STOKES)
        for (int i = threadIdx.x; i < 2 * n; i += nthreads)
          cp_async(sp + i, src(w, i & (n - 1), i >> log_n, lp), 4);
    } else {
      for (int i = threadIdx.x; i < (2 * n) << log_tl; i += nthreads)
        sb[i] = *src(w, (i >> log_tl) & (n - 1), i >> (log_tl + log_n),
                     l0 + (i & (tl - 1)));
      if constexpr (STOKES)
        for (int i = threadIdx.x; i < 2 * n; i += nthreads)
          sp[i] = *src(w, i & (n - 1), i >> log_n, lp);
    }
  };
  auto buf_of = [&](int k) {
    return reinterpret_cast<float*>(res_smem + (k % S) * lay.buf);
  };

  // add a run's W sums v and its count to phase row `bin`.  The shared
  // partials hold a bin's power sums for the tile's lanes, then with
  // STOKES each lane's (Re, Im) cross sums side by side
  auto add = [&](unsigned bin, const float (&v)[W], unsigned count) {
    if (!smem_acc) {
#pragma unroll
      for (int k = 0; k < W; ++k)
        atomicAdd(&prof[(static_cast<long>(bin) * W + k) * L + l0 + lane],
                  v[k]);
      if (counter && lane == 0) atomicAdd(&cnt[bin], count);
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
    if (counter && lane == 0) atomicAdd(&pcnt[bin], count);
  };
  // this block's run of windows
  const int n_w = T / hop;
  const int per_group = (n_w + gridDim.y - 1) / gridDim.y;
  const int w0 = blockIdx.y * per_group;
  const int n_wins = max(0, min(per_group, n_w - w0));
  for (int k = 0; k + 1 < S; ++k) {
    if (k < n_wins) stage_window(w0 + k, buf_of(k));
    cp_async_commit();
  }
  for (int k = 0; k < n_wins; ++k) {
    const int w = w0 + k;
    const int ahead = k + S - 1;
    if (ahead < n_wins) stage_window(w0 + ahead, buf_of(ahead));
    cp_async_commit();
    cp_async_wait<S - 1>();            // window w arrived
    __syncthreads();
    const float* sb = buf_of(k);
    ex = reinterpret_cast<float2*>(buf_of(k));
    float2 v[1][R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      v[0][q] = make_float2(0.0f, 0.0f);
      if (!live[0] || q >= plan.used) continue;
      const int row = plan.row_in(0, q, t[0]);
      const int a = partner ? 2 * n * tl + row : row * tl + lane;
      const int im = partner ? n : n * tl;
      v[0][q] = make_float2(sb[a] * s, sb[a + im] * s);
    }
    plan.template run<false>(v, t, live, tw, slot, sync);
#pragma unroll
    for (int q = 0; q < R; ++q)
      v[0][q] = cmul(v[0][q], q < CR ? ch[q < CR ? q : 0]
                                     : chs[(q - CR) * blockDim.x]);
    if constexpr (LOG_N >= 1) {
      Plan::to_inputs(v[0]);
    } else {                           // natural order back to row_in(0)
      __syncthreads();
      if (live[0]) {
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (q < plan.used) *slot(0, plan.rows_final(q, t[0])) = v[0][q];
      }
      __syncthreads();
      if (live[0]) {
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (q < plan.used) v[0][q] = *slot(0, plan.row_in(0, q, t[0]));
      }
    }
    plan.template run<true>(v, t, live, tw, slot, sync);
    // the transformed window into the exchange in natural order, then
    // each tile thread folds rows [g*used, g*used + used) of its lane
    __syncthreads();
    if (live[0]) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (q < plan.used) *slot(0, plan.rows_final(q, t[0])) = v[0][q];
    }
    __syncthreads();
    if (!partner) {                    // whole warps (n_main is)
      const int g = t[0];
      const unsigned t0 = static_cast<unsigned>(w * hop + g * plan.used);
      unsigned num = (i0 + t0 * p) & 0x7FFFFFFFu;
      // the run of equal bins this thread is summing, parked in shared
      // memory between folds (the pad rows' run lasts the block's life)
      unsigned run_bin = park[0], run_n = park[blockDim.x];
      float run[W];
#pragma unroll
      for (int k = 0; k < W; ++k) run[k] = __uint_as_float(park[(2 + k) *
                                                                blockDim.x]);
      auto flush = [&] {
        if (run_bin == kNoBin) return;
        add(run_bin, run, run_n);
#pragma unroll
        for (int k = 0; k < W; ++k) run[k] = 0.0f;
        run_n = 0;
      };
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = g * plan.used + q;
        float2 a = make_float2(0.0f, 0.0f);
        if (live[0] && q < plan.used) a = ex[reg::pad_slot<1>(r * tl + lane)];
        float2 b = a;
        if constexpr (STOKES) {        // the whole warp shuffles
          b.x = __shfl_down_sync(0xffffffffu, a.x, 1);
          b.y = __shfl_down_sync(0xffffffffu, a.y, 1);
        }
        if (!live[0] || q >= plan.used) continue;
        const unsigned bin =
            r >= ps && r - ps < hop
                ? ((num >> 16) * nph + (((num & 0xFFFFu) * nph) >> 16)) >> 15
                : nph;
        num = (num + p) & 0x7FFFFFFFu;
        const float vr = a.x * inv_n, vi = a.y * inv_n;
        float val[W];
        val[0] = vr * vr + vi * vi;
        if constexpr (STOKES) {
          if (lane == tl - 1) b = ex[lay.ex_main + reg::pad_slot<1>(r)];
          const float qr = b.x * inv_n, qi = b.y * inv_n;
          val[1] = vr * qr + vi * qi;
          val[2] = vi * qr - vr * qi;
        }
        if (bin != run_bin) {
          flush();
          run_bin = bin;
        }
#pragma unroll
        for (int j = 0; j < W; ++j) run[j] += val[j];
        ++run_n;
      }
      park[0] = run_bin;
      park[blockDim.x] = run_n;
#pragma unroll
      for (int k = 0; k < W; ++k)
        park[(2 + k) * blockDim.x] = __float_as_uint(run[k]);
    }
    // the next window's copies go to the buffer this one was staged and
    // exchanged in: every thread must be done reading it
    __syncthreads();
  }
  if (!partner && live[0] && park[0] != kNoBin) {  // the last run
    float run[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
      run[k] = __uint_as_float(park[(2 + k) * blockDim.x]);
    add(park[0], run, park[blockDim.x]);
  }
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

// The register form's block for a window of n rows: the tile (log2, the
// compiled case's tile when L allows it, else the widest that divides L),
// the threads (n_main of them the tile's), the shared bytes and whether
// the partials fit shared memory; false when no block holds the window
// (resident_kernel takes it).
template <bool STOKES>
bool resident_register_block(int n, int L, int n_phase, int* log_tl,
                             int* n_main, int* threads, int* smem_acc,
                             size_t* smem) {
  const int log_n = log2i(n);
  const int hot = res_hot_tile(STOKES, log_n);
  const int groups = log_n > kResLogR ? 1 << (log_n - kResLogR) : 1;
  for (int acc = 1; acc >= 0; --acc) {
    for (int lt = hot >= 0 ? hot : 3; lt >= 0; --lt) {
      if (L % (1 << lt)) continue;
      const int cap = lt == hot ? res_max_threads(STOKES, log_n)
                                : kResMaxThreads;
      const int inst = lt == hot ? log_n : -1;   // the instantiation
      const int threads_lt = res_threads(STOKES, log_n, lt);
      const ResSmem<STOKES> lay(n, 1 << lt, n_phase, acc,
                                res_stages(STOKES, inst), threads_lt,
                                res_chirp_regs(STOKES, inst));
      if (threads_lt > cap || lay.bytes() > kMaxBlockSmem) continue;
      *log_tl = lt;
      *n_main = res_warps(groups << lt);
      *threads = res_threads(STOKES, log_n, lt);
      *smem_acc = acc;
      *smem = lay.bytes();
      return true;
    }
  }
  return false;
}

template <bool STOKES>
int launch_resident_reg(const float* xr, const float* xi, const float* fr,
                        const float* fi, const float* er, const float* ei,
                        const float* cr, const float* ci, const int* fold,
                        const float* scale, float* prof, unsigned* cnt, int n,
                        int L, int ps, int hop, int T, int n_phase, int log_tl,
                        int n_main, int threads, int smem_acc, size_t smem,
                        int device, void* stream) {
  const int log_n = log2i(n);
  const bool hot = log_tl == res_hot_tile(STOKES, log_n);
  auto kernel = hot && log_n == 11
                    ? resident_reg_kernel<STOKES, 11, res_hot_tile(STOKES, 11)>
                : hot && log_n == 12
                    ? resident_reg_kernel<STOKES, 12, res_hot_tile(STOKES, 12)>
                    : resident_reg_kernel<STOKES, -1, -1>;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return err;
  // 16-byte (or smaller) copies of a tile row when the rows and the six
  // planes are aligned to them; else plain loads
  const int chunk = copy_chunk(1 << log_tl, L, 4, {xr, xi, fr, fi, er, ei});
  // about one block per resident slot; each walks n_w / groups windows
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int lane_tiles = L >> log_tl;
  const int n_w = T / hop;
  int groups = per_sm * sms / lane_tiles;
  if (groups < 1) groups = 1;
  if (groups > n_w) groups = n_w;
  if (groups > 65535) groups = 65535;
  kernel<<<dim3(lane_tiles, groups), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      xr, xi, fr, fi, er, ei, cr, ci, fold, scale, prof, cnt, log_n, L,
      log_tl, ps, hop, T, n_phase, smem_acc, n_main, chunk);
  return cudaGetLastError();
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
  {
    int log_tl, n_main, threads, smem_acc;
    size_t smem;
    if (resident_register_block<STOKES>(n, L, n_phase, &log_tl, &n_main,
                                        &threads, &smem_acc, &smem))
      return launch_resident_reg<STOKES>(
          xr, xi, fr, fi, er, ei, cr, ci, fold, scale, prof, cnt, n, L, ps,
          hop, T, n_phase, log_tl, n_main, threads, smem_acc, smem, device,
          stream);
  }
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

// resident_form: 1 when a resident launch of this shape runs the register
// kernel, 0 when it keeps the shared-memory resident_kernel, -1 for a
// window the kernel does not take.
extern "C" int bbt_resident_form(int n, int L, int n_phase, int stokes) {
  if (n < 2 || (n & (n - 1)) || L < 1 || n_phase < 1) return -1;
  int log_tl, n_main, threads, smem_acc;
  size_t smem;
  return stokes ? bbt::resident_register_block<true>(
                      n, L, n_phase, &log_tl, &n_main, &threads, &smem_acc,
                      &smem)
                : bbt::resident_register_block<false>(
                      n, L, n_phase, &log_tl, &n_main, &threads, &smem_acc,
                      &smem);
}
