"""A numpy model of the register-FFT kernels' layouts (``csrc/fft_reg.cuh``
``reg::Plan``, ``csrc/resident.cu`` ``resident_reg_kernel``,
``csrc/dedisperse.cu`` ``k2_reg_kernel``), against the port's plain
versions on the CPU.

The CUDA kernels run only on a card; this model replays, thread by
thread, what they do with the rows: each thread's R rows of a column
(``row_in``), the Stockham passes with their per-pass twiddle tables and
in-register radix-2 stages (bit-reversed within a group), the exchange
rows (``row_out``), the rows each register holds when a transform is done
(``rows_final``), the renaming of registers that feeds the inverse FFT
without an exchange (``final_slot``), the chirp read at natural frequency
rows, and the resident fold: each thread's run of consecutive rows after
the last exchange, runs of equal bins summed before one shared add (a run
lasting across a block's windows while its bin does: the pad rows one
run into the trash bin), counts one per run from lane 0.

Held to the port's plain versions (``dedisperse_fold_resident_ref`` on
the resident geometry: pads 256/256, windows 2048 and 4096 as radix
16.16.8 and 16.16.16, the flagship's B1937 fold rate, n_phase 64 and
32768; ``stage_b_ref`` for the K2 column at N2 = 512 as radix 8.8.8,
256 as 8.8.4, and at N2 = 32 and 4096): counts exact, profiles elementwise within 2e-4
(Stokes cross planes 1e-4 of their peak), planes within 1e-4 of the
peak, as the card tests hold the kernels (``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import dedisperse_resident as dr  # noqa: E402

FFT_TOL, PROFILE_RTOL = 1e-4, 2e-4
PAD = 256                                  # the resident paths' pads
B1937_RATE = 641.928123 / 250e3            # cycles a sample (chip_smoke.py)


def brev(m, bits):
    return int(format(m, f"0{bits}b")[::-1], 2) if bits else 0


class Plan:
    """``reg::Plan<log_r>`` on an n = 2^log_n column, for every thread at
    once: t is an integer array of row groups."""

    def __init__(self, log_r, log_n):
        self.log_r, self.log_n, self.R = log_r, log_n, 1 << log_r
        self.passes = 0 if log_n == 0 else -(-log_n // log_r)
        self.log_t = max(0, log_n - log_r)
        self.used = min(self.R, 1 << log_n)
        self.t = np.arange(1 << self.log_t)

    def log_radix(self, p):
        if p + 1 < self.passes:
            return self.log_r
        return self.log_n - (self.passes - 1) * self.log_r

    def row_in(self, p, s):
        lr = self.log_radix(p)
        q, m = s >> lr, s & ((1 << lr) - 1)
        return self.t + (q << self.log_t) + (m << (self.log_n - lr))

    def row_out(self, p, s):
        lr = self.log_radix(p)
        q, m = s >> lr, brev(s & ((1 << lr) - 1), lr)
        j = self.t + (q << self.log_t)
        lns = p * self.log_r
        return ((j >> lns) << (lns + lr)) + (j & ((1 << lns) - 1)) + (m << lns)

    def rows_final(self, s):
        return self.row_out(self.passes - 1, s) if self.passes else \
            np.full_like(self.t, s)

    def final_slot(self, s):
        lr = self.log_radix(self.passes - 1)
        b = brev(s & ((1 << lr) - 1), lr)
        return b if self.passes == 1 else (s >> lr) + (b << (self.log_r - lr))

    def _table(self, p):
        lns, lr = p * self.log_r, self.log_radix(p)
        idx = np.arange(1 << (lns + lr))
        e = ((idx >> lns) * (idx & ((1 << lns) - 1))) << (
            self.log_n - lns - lr)
        return np.exp(-2j * np.pi * e / (1 << self.log_n)).astype(
            np.complex64)

    def butterflies(self, v, p, inverse):
        """Pass p's twiddles and radix-2 stages on v[..., t, s]."""
        lr = self.log_radix(p)
        if p > 0:
            lns = p * self.log_r
            table = self._table(p)
            for s in range(self.used):
                q, m = s >> lr, s & ((1 << lr) - 1)
                if m:
                    k = (self.t + (q << self.log_t)) & ((1 << lns) - 1)
                    w = table[(m << lns) + k]
                    v[..., s] *= np.conj(w) if inverse else w
        r = 1 << lr
        sign = 1 if inverse else -1
        for off in range(0, self.used, r):
            for sc in range(lr):
                half = r >> (sc + 1)
                for i in range(r):
                    if i & half:
                        continue
                    x, y = v[..., off + i].copy(), v[..., off + i + half]
                    e = (i & (half - 1)) * (8 // half)
                    v[..., off + i] = x + y
                    v[..., off + i + half] = (x - y) * np.complex64(
                        np.exp(sign * 2j * np.pi * e / 16))

    def run(self, v, inverse):
        """The transform of v[..., t, s] (slot s holding row_in(0, s));
        returns v with slot s holding row rows_final(s)."""
        n = 1 << self.log_n
        for p in range(self.passes):
            if p > 0:
                v = np.stack([ex[..., self.row_in(p, s)]
                              for s in range(self.R)], axis=-1)
            self.butterflies(v, p, inverse)
            if p + 1 < self.passes:
                ex = np.zeros(v.shape[:-2] + (n,), np.complex64)
                for s in range(self.used):
                    ex[..., self.row_out(p, s)] = v[..., s]
        return v

    def load(self, x):
        """v[..., t, s] = x[..., row_in(0, s)] (x natural order)."""
        return np.stack([x[..., self.row_in(0, s)] if s < self.used else
                         np.zeros(x.shape[:-1] + (len(self.t),), x.dtype)
                         for s in range(self.R)], axis=-1)

    def gather_final(self, x):
        """x[..., rows_final(s)] as v[..., t, s]."""
        return np.stack([x[..., self.rows_final(s)] if s < self.used else
                         np.ones(x.shape[:-1] + (len(self.t),), x.dtype)
                         for s in range(self.R)], axis=-1)

    def to_inputs(self, v):
        """Rename registers: slot final_slot(s) takes slot s."""
        u = np.empty_like(v)
        for s in range(self.R):
            u[..., self.final_slot(s)] = v[..., s]
        return u

    def natural(self, v):
        """v[..., t, s] (rows_final) back to a natural-order column."""
        out = np.zeros(v.shape[:-2] + (1 << self.log_n,), np.complex64)
        for s in range(self.used):
            out[..., self.rows_final(s)] = v[..., s]
        return out


def crandn(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("log_r,log_n", [(3, 9), (3, 8), (4, 11), (4, 12),
                                         (3, 5), (3, 12), (4, 3)])
def test_register_layout(log_r, log_n):
    """Each thread ends a transform with the rows it began with: slot s
    holds row rows_final(s) = row_in(0, final_slot(s)), final_slot a
    permutation; the passes compute the DFT in natural order, forward and
    inverse (unscaled)."""
    plan = Plan(log_r, log_n)
    for s in range(plan.used):
        np.testing.assert_array_equal(plan.rows_final(s),
                                      plan.row_in(0, plan.final_slot(s)))
    assert sorted(plan.final_slot(s) for s in range(plan.used)) == \
        list(range(plan.used))
    rows = np.stack([plan.rows_final(s) for s in range(plan.used)])
    assert sorted(rows.ravel()) == list(range(1 << log_n))
    x = crandn(np.random.default_rng(log_n), (3, 1 << log_n))
    for inverse in (False, True):
        got = plan.natural(plan.run(plan.load(x), inverse))
        ref = np.fft.ifft(x) * x.shape[-1] if inverse else np.fft.fft(x)
        assert np.abs(got - ref).max() <= FFT_TOL * np.abs(ref).max()


def test_exchange_banks():
    """The exchanges' float2 accesses take the minimum two wavefronts a
    warp (tile lanes fastest, then row groups) needs: radix 16 on
    `pad_slot<1>` at tiles of 1, 2, 4, 8 lanes (resident), radix 8 on
    `pad_slot<2>` at 4 and 8 lanes (K2, K3); the resident fold's reads of
    R consecutive rows likewise."""
    def wavefronts(slots):
        banks = {}
        for sl in slots:                 # a float2 is banks 2 sl, 2 sl + 1
            for w in (2 * sl, 2 * sl + 1):
                banks.setdefault(w % 32, set()).add(w // 32)
        return max(len(v) for v in banks.values())

    for log_r, log_n, pad, tiles in ((4, 11, 1, (1, 2, 4, 8)),
                                     (4, 12, 1, (1, 2, 4)),
                                     (3, 9, 2, (4, 8))):
        plan = Plan(log_r, log_n)
        pad_slot = lambda i: i + pad * (i >> 4)  # noqa: E731
        for tl in tiles:
            groups = 32 // tl
            lanes = np.tile(np.arange(tl), groups)
            for p in range(plan.passes):
                for s in range(plan.used):
                    for rows in (plan.row_in(p, s), plan.row_out(p, s)):
                        for w0 in range(0, len(plan.t), groups):
                            r = np.repeat(rows[w0:w0 + groups], tl)
                            assert wavefronts(pad_slot(r * tl + lanes)) == 2
            if log_r == 4:               # the fold's consecutive rows
                for q in range(plan.R):
                    r = np.repeat(np.arange(groups) * plan.R + q, tl)
                    assert wavefronts(pad_slot(r * tl + lanes)) == 2


# -- the resident kernel ----------------------------------------------------

def resident_model(x, front, end, chirp, fold, scale, *, n_window, n_phase,
                   stokes, groups):
    """``resident_reg_kernel`` on complex64 arrays: x (T, L), halos
    (PAD, L), chirp (n_window, L) in natural order.  Windows are walked in
    ``groups`` runs of consecutive windows (the blocks' y); each fold item
    (lane, g) sums its runs of equal bins over rows [g R, g R + R) of each
    window of its group, a run lasting across windows while its bin does
    (the pad rows' run all the group long).  Returns the profile, the
    counts and the number of run flushes (shared adds) a lane takes."""
    hop = n_window - 2 * PAD
    T, L = x.shape
    n_w = T // hop
    plan = Plan(4, n_window.bit_length() - 1)
    padded = np.concatenate([front, x, end]) * np.float32(scale)
    win = np.stack([padded[w * hop:w * hop + n_window] for w in range(n_w)])
    v = plan.load(np.moveaxis(win, 1, 2))              # (n_w, L, t, s)
    v = plan.run(v, False) * plan.gather_final(chirp.T[None])
    v = plan.run(plan.to_inputs(v), True)
    y = plan.natural(v) / np.float32(n_window)          # (n_w, L, N)
    if stokes:
        q = np.roll(y, -1, axis=1)
        det = np.stack([y.real ** 2 + y.imag ** 2,
                        y.real * q.real + y.imag * q.imag,
                        y.imag * q.real - y.real * q.imag])
    else:
        det = (y.real ** 2 + y.imag ** 2)[None]
    det = det.astype(np.float32)                         # (W, n_w, L, N)
    # the kernel's bin map, row by row: num = (i0 + t p) & 0x7FFFFFFF
    r = np.arange(n_window)
    tt = (np.arange(n_w)[:, None] * hop + r[None]).astype(np.uint64)
    f = np.asarray(fold, np.int64).astype(np.uint64)
    num = (f[0] + tt * f[1]) & np.uint64(0x7FFFFFFF)
    bins = ((num >> np.uint64(16)) * np.uint64(n_phase)
            + (((num & np.uint64(0xFFFF)) * np.uint64(n_phase))
               >> np.uint64(16))) >> np.uint64(15)
    bins = np.where((r >= PAD) & (r < PAD + hop), bins, n_phase).astype(
        np.int64)                                        # (n_w, N)
    # fold item (lane, g): rows [g R, g R + R) of each window of its
    # group, in the order the kernel reads them; a run starts where the
    # bin changes or the item (or group) does
    R = plan.used
    W = det.shape[0]
    per = -(-n_w // groups)
    items = n_window // R
    flat_bins, flat_start, flat_vals = [], [], []
    for g0 in range(0, n_w, per):
        b = bins[g0:g0 + per].reshape(-1, items, R).transpose(1, 0, 2)
        b = b.reshape(items, -1)
        start = np.ones_like(b, bool)
        start[:, 1:] = b[:, 1:] != b[:, :-1]
        flat_bins.append(b.ravel())
        flat_start.append(start.ravel())
        flat_vals.append(det[:, g0:g0 + per].reshape(W, -1, L, items, R)
                         .transpose(0, 2, 3, 1, 4).reshape(W, L, -1))
    seq_bins = np.concatenate(flat_bins)
    idx = np.flatnonzero(np.concatenate(flat_start))
    run_bin = seq_bins[idx]
    run_len = np.diff(np.append(idx, seq_bins.size))
    sums = np.add.reduceat(np.concatenate(flat_vals, axis=2), idx, axis=2,
                           dtype=np.float64)
    prof = np.zeros((n_phase + 1, W, L))
    for k in range(W):
        for ln in range(L):
            np.add.at(prof[:, k, ln], run_bin, sums[k, ln])
    cnt = np.zeros(n_phase + 1, np.int64)
    np.add.at(cnt, run_bin, run_len)                     # lane 0's items
    return prof.reshape(n_phase + 1, W * L), cnt, len(idx)


def resident_case(n_window, L, seed):
    rng = np.random.default_rng(seed)
    hop = n_window - 2 * PAD
    T = 3 * hop
    x, front, end = (crandn(rng, (n, L)) for n in (T, PAD, PAD))
    # a unit-modulus chirp of random phases, the same at every lane tile
    chirp = np.exp(2j * np.pi * rng.random((n_window, L))).astype(
        np.complex64)
    return x, front, end, chirp


@pytest.mark.parametrize("n_phase", [64, 32768])
@pytest.mark.parametrize("stokes", [False, True])
@pytest.mark.parametrize("n_window", [2048, 4096])
def test_resident_register_fold(n_window, stokes, n_phase):
    L = 3
    x, front, end, chirp = resident_case(n_window, L, seed=n_window + L)
    fold = dd.fold_phase_vector(0.123, B1937_RATE)
    scale = 0.5
    prof, cnt, flushes = resident_model(
        x, front, end, chirp, fold, scale, n_window=n_window,
        n_phase=n_phase, stokes=stokes, groups=2)
    hop, n1, n2 = dr.resident_geometry(n_window, PAD, PAD)
    stor = dd.permute_to_storage_order(chirp, n1, n2)
    args = [torch.as_tensor(np.ascontiguousarray(f(a), np.float32))
            for a in (x, front, end, stor) for f in (np.real, np.imag)]
    rprof, rcnt = dr.dedisperse_fold_resident_ref(
        *args, torch.as_tensor(np.asarray(fold, np.int32)),
        torch.tensor([scale]), n_window=n_window, n_phase=n_phase,
        pad_start=PAD, pad_end=PAD, stokes=stokes)
    rprof, rcnt = rprof.double().numpy(), rcnt.numpy()
    np.testing.assert_array_equal(cnt, rcnt)
    assert cnt.sum() == 3 * n_window
    hit = rcnt > 0
    assert not prof[~hit].any()
    # every plane within 1e-4 of its peak (the card tests' bound); with 64
    # bins, each summing hundreds of rows, the power plane elementwise too
    # (with 2^15 a bin holds one or two rows, whose own roundoff is
    # relative to their size)
    for lo, hi in ((0, L), (L, prof.shape[1])):
        if hi > lo:
            err = np.abs(prof[:, lo:hi] - rprof[:, lo:hi]).max()
            assert err <= FFT_TOL * np.abs(rprof[:, lo:hi]).max()
    if n_phase == 64:
        rel = (np.abs(prof[:, :L] - rprof[:, :L])[hit]
               / np.abs(rprof[:, :L])[hit])
        assert rel.max() <= PROFILE_RTOL
    # a bin spans ~6 rows at this rate with 64 bins (under one with 2^15):
    # the runs take a quarter of the shared adds of an add a row, and the
    # pad rows are one run an item and group at any n_phase
    rows = 3 * n_window
    assert flushes <= rows / 4 if n_phase == 64 else flushes < rows


# -- K2 ---------------------------------------------------------------------

def k2_model(y, chirp, log_r=3):
    """``k2_reg_kernel`` on complex64 d-major planes y (N2, N1, L), chirp
    (N2, N1, L): per column c the forward plan over b, the chirp at the
    natural frequency rows each register holds, renamed registers, the
    inverse plan, then 1/N2 and W_N^{+c b} from sincospif's exact
    argument, stored at row b = rows_final."""
    n2, n1, L = y.shape
    plan = Plan(log_r, n2.bit_length() - 1)
    col = np.moveaxis(y, 0, -1)                          # (N1, L, N2)
    v = plan.run(plan.load(col), False)
    v = v * plan.gather_final(np.moveaxis(chirp, 0, -1))
    v = plan.run(plan.to_inputs(v), True)
    z = plan.natural(v)                                  # (N1, L, N2)
    c = np.arange(n1, dtype=np.int64)[:, None, None]
    b = np.arange(n2, dtype=np.int64)[None, None, :]
    arg = (2.0 * (c * b).astype(np.float32) / np.float32(n1 * n2)).astype(
        np.float32)
    tw = np.exp(1j * np.pi * arg.astype(np.float64)) / n2
    return np.moveaxis(z * tw.astype(np.complex64), -1, 0)


@pytest.mark.parametrize("n2,n1,L", [(512, 8, 3), (256, 16, 2),
                                     (32, 32, 2), (4096, 4, 1)])
def test_k2_register_column(n2, n1, L):
    rng = np.random.default_rng(n2 + L)
    y = crandn(rng, (n2, n1, L))
    chirp = np.exp(2j * np.pi * rng.random((n2, n1, L))).astype(np.complex64)
    got = k2_model(y, chirp)
    yr, yi = (torch.as_tensor(np.ascontiguousarray(f(y), np.float32))
              for f in (np.real, np.imag))
    cr, ci = (torch.as_tensor(np.ascontiguousarray(f(chirp), np.float32))
              for f in (np.real, np.imag))
    rr, ri = dd.stage_b_ref(yr, yi, cr, ci)
    ref = rr.numpy() + 1j * ri.numpy()
    assert np.abs(got - ref).max() <= FFT_TOL * np.abs(ref).max()
    assert math.isfinite(float(np.abs(got).max()))
