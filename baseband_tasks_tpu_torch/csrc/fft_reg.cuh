// Column FFTs whose butterflies run in registers (Stockham autosort).
//
// A column of n = 2^log_n complex points is transformed by n / R threads
// (R = 2^LOG_R points each, R <= 16; one thread for n <= R).  Thread t
// holds its R points in registers and runs the radix-R butterflies of a
// pass there; between two passes the column goes once through shared
// memory (the "exchange"), written in the order the next pass reads it.
// Passes run over radices R, R, ..., r_last (r_last = the bits left),
// each the radix-r decimation-in-time Stockham step
//
//   v[m] = x[j + m n/r] * W_{Ns r}^{m (j mod Ns)},   m < r
//   v    = DFT_r(v)
//   y[(j div Ns) Ns r + (j mod Ns) + m Ns] = v[m]
//
// for the thread's butterflies j = t + q (n/R), q < R/r, with Ns the
// product of the radices before the pass (Govindaraju et al. 2008).  The
// input is in natural order, and so is the output: slot s of thread t
// then holds row `rows_final(s, t)`, so the caller's epilogue (trim,
// detect, fold) knows each register's row.  n = 512 is three radix-8
// passes (two exchanges), 4096 three radix-16 passes.
//
// DFT_r runs as log2(r) radix-2 stages in registers on constants
// exp(-2 pi i k/16) rounded to float (`c16`), leaving each group's
// outputs in bit-reversed order (the rows they are stored to undo it);
// the twiddles between passes come from one table per pass, laid out
// [m][k] so that a warp reads neighbouring entries, each entry filled
// with sincospif on the exact argument as fft.cuh's table is.  So the
// arithmetic is that of fft.cuh's radix-2 passes: the same accuracy
// class.  The inverse transform conjugates every twiddle; no scaling is
// applied.
//
// Shared-memory layouts are the caller's (an index functor maps a row to
// a float2 slot): `pad_slot` spreads rows over the banks so that the
// exchange's reads and writes take the minimum two wavefronts a warp's
// float2 access needs (checked by simulating the layouts' bank
// wavefronts for the tiles the kernels use).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "fft.cuh"

namespace bbt {
namespace reg {

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// cos(2 pi k / 16), exactly rounded to float
__host__ __device__ constexpr float c16(int k) {
  k &= 15;
  if (k > 8) k = 16 - k;
  const bool neg = k > 4;
  if (neg) k = 8 - k;
  const float v = k == 0   ? 1.0f
                  : k == 1 ? 0.923879532511286756f
                  : k == 2 ? 0.707106781186547524f
                  : k == 3 ? 0.382683432365089772f
                           : 0.0f;
  return neg ? -v : v;
}

// d * exp(-+2 pi i E / 16) (the sign + for INVERSE), E a constant
template <bool INVERSE, int E>
__device__ __forceinline__ float2 rot16(float2 d) {
  constexpr int e = E & 15;
  if constexpr (e == 0) {
    return d;
  } else if constexpr (e == 4) {
    return INVERSE ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  } else if constexpr (e == 8) {
    return make_float2(-d.x, -d.y);
  } else if constexpr (e == 12) {
    return INVERSE ? make_float2(d.y, -d.x) : make_float2(-d.y, d.x);
  } else {
    constexpr float c = c16(e), s = c16(e + 12);   // sin = cos(. - pi/2)
    return cmul(d, make_float2(c, INVERSE ? s : -s));
  }
}

// Calls f(std::integral_constant<int, I>) for I = 0 .. N-1, so that
// every register index derived from I is a compile-time constant.
template <typename F, int... I>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// In-register DFT of the 2^LR points a[OFF .. OFF + 2^LR) (LR <= 4) as
// LR radix-2 decimation-in-frequency stages: natural order in,
// bit-reversed order out (a[OFF + s] holds output brev(s)); the callers
// fold the reversal into the rows they store, so no register moves.
template <int LR, int OFF, bool INVERSE, int N>
__device__ __forceinline__ void dft(float2 (&a)[N]) {
  constexpr int r = 1 << LR;
  static_for<LR>([&](auto sc) {
    constexpr int half = r >> (decltype(sc)::value + 1);
    static_for<r>([&](auto ic) {
      constexpr int i = decltype(ic)::value;
      if constexpr ((i & half) == 0) {
        const float2 x = a[OFF + i], y = a[OFF + i + half];
        a[OFF + i] = add(x, y);
        a[OFF + i + half] =
            rot16<INVERSE, (i & (half - 1)) * (8 / half)>(sub(x, y));
      }
    });
  });
}

// bits [0, lr) of m reversed
__device__ __forceinline__ int brev_low(int m, int lr) {
  return lr ? static_cast<int>(__brev(static_cast<unsigned>(m)) >> (32 - lr))
            : 0;
}

// Padded slot of element i: one (P = 1) or two (P = 2) float2 of padding
// after every 16, so rows a power of two apart fall on distinct banks.
template <int P>
__device__ __forceinline__ int pad_slot(int i) {
  return i + P * (i >> 4);
}

template <int P>
__host__ __device__ constexpr int padded_size(int n) {
  return n + P * (n >> 4);
}

// Passes of an n = 2^log_n column with radix 2^log_r, and the radix of
// pass p: log_r, ..., log_r, then the bits left.
__host__ __device__ constexpr int passes_of(int log_n, int log_r) {
  return log_n == 0 ? 0 : (log_n + log_r - 1) / log_r;
}

__host__ __device__ constexpr int log_radix_of(int log_n, int log_r, int p) {
  return p + 1 < passes_of(log_n, log_r)
             ? log_r
             : log_n - (passes_of(log_n, log_r) - 1) * log_r;
}

// The twiddle tables of an n-point column: pass p >= 1 multiplies slot m
// of butterfly j by W_n^{(m k) << (log_n - lns - lr)}, k = j mod 2^lns,
// and reads it from its own table [m][k] (radix x 2^lns entries, k
// fastest: a warp's neighbouring threads read neighbouring entries).
// Entry offset of pass p's table, and the slots of all of them.
__host__ __device__ constexpr int table_offset(int log_n, int log_r, int p) {
  int off = 0;
  for (int i = 1; i < p; ++i)
    off += 1 << (i * log_r + log_radix_of(log_n, log_r, i));
  return off;
}

__host__ __device__ constexpr int twiddle_slots(int log_n, int log_r) {
  return table_offset(log_n, log_r, passes_of(log_n, log_r));
}

// Fills the tables with sincospif on the exact argument.  Caller syncs
// before use.
__device__ __forceinline__ void fill_twiddle_tables(float2* tw, int log_n,
                                                    int log_r) {
  for (int p = 1; p < passes_of(log_n, log_r); ++p) {
    const int lns = p * log_r, lr = log_radix_of(log_n, log_r, p);
    const int shift = log_n - lns - lr;
    float2* table = tw + table_offset(log_n, log_r, p);
    for (int idx = threadIdx.x; idx < 1 << (lns + lr); idx += blockDim.x) {
      const int e = ((idx >> lns) * (idx & ((1 << lns) - 1))) << shift;
      float s, c;
      sincospif(-2.0f * static_cast<float>(e) /
                    static_cast<float>(1 << log_n),
                &s, &c);
      table[idx] = make_float2(c, s);
    }
  }
}

// The pass plan of an n-point column for threads of R = 2^LOG_R points;
// LOG_N >= 0 fixes log2(n) at compile time (the paths' hot sizes: every
// row and twiddle index then folds to a constant or a register plus an
// immediate), else it is the constructor's argument.
template <int LOG_R, int LOG_N = -1>
struct Plan {
  static constexpr int R = 1 << LOG_R;
  int log_n;
  int passes;      // 0 for n = 1
  int log_t;       // log2 of the threads per column, max(0, log_n - LOG_R)
  int used;        // slots a thread uses: min(R, n)

  __device__ __forceinline__ explicit Plan(int log_n_)
      : log_n(LOG_N >= 0 ? LOG_N : log_n_),
        passes(passes_of(log_n, LOG_R)),
        log_t(log_n > LOG_R ? log_n - LOG_R : 0),
        used(log_n < LOG_R ? 1 << log_n : R) {}

  __device__ __forceinline__ int log_radix(int p) const {
    return log_radix_of(log_n, LOG_R, p);
  }

  // row read by slot s of thread t in pass p (inputs in natural order)
  __device__ __forceinline__ int row_in(int p, int s, int t) const {
    const int lr = log_radix(p);
    const int q = s >> lr, m = s & ((1 << lr) - 1);
    return t + (q << log_t) + (m << (log_n - lr));
  }

  // row written by slot s of thread t after pass p's butterflies (whose
  // outputs sit in bit-reversed order within each group)
  __device__ __forceinline__ int row_out(int p, int s, int t) const {
    const int lr = log_radix(p);
    const int q = s >> lr, m = brev_low(s & ((1 << lr) - 1), lr);
    const int j = t + (q << log_t);
    const int lns = p * LOG_R;
    const int k = j & ((1 << lns) - 1);
    return ((j >> lns) << (lns + lr)) + k + (m << lns);
  }

  // the row slot s of thread t holds when the transform is done
  __device__ __forceinline__ int rows_final(int s, int t) const {
    return passes ? row_out(passes - 1, s, t) : s;
  }

  // LOG_N fixed: the pass-0 input slot of the row that slot s holds when
  // the transform is done, rows_final(s, t) == row_in(0, final_slot(s), t)
  // for every t.  A thread ends with the rows it began with, in another
  // order (the last pass's bit reversal), so a second transform of the
  // result takes its inputs by renaming registers, with no exchange
  // (`to_inputs`).
  __host__ __device__ static constexpr int final_slot(int s) {
    static_assert(LOG_N >= 1, "final_slot needs log2(n) at compile time");
    constexpr int pn = passes_of(LOG_N, LOG_R);
    constexpr int lr = log_radix_of(LOG_N, LOG_R, pn - 1);
    const int m = s & ((1 << lr) - 1);
    int b = 0;
    for (int i = 0; i < lr; ++i) b |= ((m >> i) & 1) << (lr - 1 - i);
    return pn == 1 ? b : (s >> lr) + (b << (LOG_R - lr));
  }

  // v[s] (row rows_final(s, t)) moved to slot final_slot(s): the inputs
  // of another transform of the same rows, in registers
  __device__ __forceinline__ static void to_inputs(float2 (&v)[R]) {
    float2 u[R];
    static_for<R>([&](auto sc) {
      constexpr int s = decltype(sc)::value;
      u[final_slot(s)] = v[s];
    });
    static_for<R>([&](auto sc) {
      constexpr int s = decltype(sc)::value;
      v[s] = u[s];
    });
  }

  // pass p's twiddles and butterflies on thread t's registers
  template <bool INVERSE>
  __device__ __forceinline__ void butterflies(float2 (&v)[R], int p, int t,
                                              const float2* tw) const {
    const int lr = log_radix(p);
    if (p > 0) {
      const int lns = p * LOG_R;
      const float2* table = tw + table_offset(log_n, LOG_R, p);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int q = s >> lr, m = s & ((1 << lr) - 1);
        const int k = (t + (q << log_t)) & ((1 << lns) - 1);
        if (s < used && m) {
          float2 w = table[(m << lns) + k];
          if (INVERSE) w.y = -w.y;
          v[s] = cmul(v[s], w);
        }
      }
    }
    static_for<LOG_R>([&](auto lc) {
      constexpr int LR = decltype(lc)::value + 1;
      if (lr == LR) {
        static_for<(R >> LR)>([&](auto qc) {
          constexpr int q = decltype(qc)::value;
          if ((q << LR) < used) dft<LR, (q << LR), INVERSE>(v);
        });
      }
    });
  }

  // The whole transform of the ITEMS columns a thread holds, in
  // lockstep.  v[i] holds item i's pass-0 inputs (rows row_in(0, s, t[i])),
  // slot(i, row) is the address of item i's exchange row (items with
  // live[i] false skip the exchange but keep the barriers), sync() the
  // barrier between writers and readers of the exchange.  On return v[i][s]
  // holds row rows_final(s, t[i]).
  template <bool INVERSE, int ITEMS, typename Slot, typename Sync>
  __device__ __forceinline__ void run(float2 (&v)[ITEMS][R],
                                      const int (&t)[ITEMS],
                                      const bool (&live)[ITEMS],
                                      const float2* tw, Slot slot,
                                      Sync sync) const {
#pragma unroll
    for (int p = 0; p < passes; ++p) {
      if (p > 0) {
        sync();
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          if (!live[i]) continue;
#pragma unroll
          for (int s = 0; s < R; ++s)
            if (s < used) v[i][s] = *slot(i, row_in(p, s, t[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) butterflies<INVERSE>(v[i], p, t[i], tw);
      if (p + 1 < passes) {
        sync();
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          if (!live[i]) continue;
#pragma unroll
          for (int s = 0; s < R; ++s)
            if (s < used) *slot(i, row_out(p, s, t[i])) = v[i][s];
        }
      }
    }
  }
};

}  // namespace reg
}  // namespace bbt
