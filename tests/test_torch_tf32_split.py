"""Why lane_mix and bank_power take three TF32 passes, on the CPU.

The two kernels multiply on Hopper's tensor cores in TF32 (10-bit
mantissa).  These tests emulate that arithmetic in plain torch (TF32
round-to-nearest by float32 bit arithmetic and the big + small split of
``ops/tf32.py``, and the three-term product) at small versions of the
kernels' shapes: the 3xTF32 product stays within 1e-5 of the float64
product's peak, one TF32 pass does not stay within 1e-4 (the card's
``FFT_TOL``).  A model of the tensor cores' accumulation (each MMA added
into its float32 accumulator rounded toward zero) shows why the kernels
add each 16- or 32-deep partial into float32 totals: a truncating
accumulator that runs the whole depth drifts with it
(tests/test_torch_cuda.py holds the kernels to 1e-5 against float64 on
the card).  They also hold the wrappers' operand preparation (the block
mixer, the staged split layout, the per-tensor cache) to
``lane_mix_ref`` and ``bank_matmul_power_ref``.
"""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from baseband_tasks_tpu_torch.ops import accel_correlate as ac  # noqa: E402
from baseband_tasks_tpu_torch.ops import spectral_filter as sf  # noqa: E402
from baseband_tasks_tpu_torch.ops import tf32  # noqa: E402

SPLIT_TOL = 1e-5      # 3xTF32 against float64, of the peak
ONE_PASS_TOL = 1e-4   # what one TF32 pass fails (chip_smoke.py FFT_TOL)
BK = 16               # the kernels' stage depth (bbt_*_tile)


def matmul_3xtf32(a, b, passes=3):
    """``a @ b`` in the kernels' three TF32 passes: the split operands'
    cross terms, then ``big·big``, each a float32 matmul (``passes=1``:
    one TF32 product)."""
    ab, asm = tf32.split_tf32(a)
    bb, bs = tf32.split_tf32(b)
    if passes == 1:
        return ab @ bb
    return (asm @ bb + ab @ bs) + ab @ bb


def unpack_operand(packed, n_planes, K, N, bn):
    """Inverse of ``tf32.pack_operand``: [(big, small)] per plane, each
    (K, N)."""
    kp, np_ = -(-K // BK) * BK, -(-N // bn) * bn
    x = packed.reshape(np_ // bn, kp // BK, n_planes, 2, bn // 8, BK // 4,
                       8, 4).permute(2, 3, 1, 5, 7, 0, 4, 6)
    x = x.reshape(n_planes, 2, kp, np_)[..., :K, :N]
    return [(x[p, 0], x[p, 1]) for p in range(n_planes)]


def planes(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s) * scale, dtype=torch.float32)
            for s in shapes]


def peak_rel(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def test_round_tf32_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 2 ** -11),
                      1 + 2 ** -12 - 2 ** -23, 0.0, -0.0, 3.0,
                      1 + 2 ** -10 + 2 ** -11], dtype=torch.float32)
    want = [1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 0.0, -0.0,
            3.0, 1 + 2 ** -9]
    assert tf32.round_tf32(x).tolist() == want


def test_round_tf32_random():
    x, = planes(1, (4096,), scale=1e3)
    r = tf32.round_tf32(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    # within half a TF32 ulp (2^-11 relative) and at the nearest grid point
    ulp = torch.exp2(torch.floor(torch.log2(x.abs().double())) - 10)
    err = (r.double() - x.double()).abs()
    assert bool((err <= ulp / 2).all())


def test_split_tf32():
    x, = planes(2, (4096,))
    big, small = tf32.split_tf32(x)
    for h in (big, small):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    err = ((big.double() + small.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.abs().double()).all())


def _mix_case(rows, L, seed):
    xr, xi, wr, wi = planes(seed, (rows, L), (rows, L), (L, L), (L, L))
    wr, wi = wr / L ** 0.5, wi / L ** 0.5
    a = torch.cat([xr, xi], dim=1)
    b = tf32.mix_operand(wr, wi)
    ref = torch.cat(sf.lane_mix_ref(xr.double(), xi.double(), wr.double(),
                                    wi.double()), dim=1)
    return (lambda passes: matmul_3xtf32(a, b, passes)), ref


def _bank_case(n_seg, L, n_cols, seed):
    fr, fi, ka, kb, kc = planes(seed, (n_seg, L), (n_seg, L), (L, n_cols),
                                (L, n_cols), (L, n_cols))
    ref = ac.bank_matmul_power_ref(*(t.double() for t in (fr, fi, ka, kb,
                                                          kc)))

    def run(passes):
        t = matmul_3xtf32(fr + fi, ka, passes)
        cr = t - matmul_3xtf32(fi, kb, passes)
        ci = t + matmul_3xtf32(fr, kc, passes)
        return cr * cr + ci * ci
    return run, ref


CASES = {"mix 256x128": lambda: _mix_case(256, 128, 10),
         "mix 256x512": lambda: _mix_case(256, 512, 11),
         "bank 256x64@64x512": lambda: _bank_case(256, 64, 512, 12)}


@pytest.mark.parametrize("case", list(CASES))
def test_three_passes_float32_class(case):
    run, ref = CASES[case]()
    assert peak_rel(run(3), ref) <= SPLIT_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_one_pass_misses_fft_tol(case):
    run, ref = CASES[case]()
    assert peak_rel(run(1), ref) > ONE_PASS_TOL


def _round_to_zero(s):
    """float64 ``s`` rounded to float32 toward zero."""
    r = s.float()
    over = r.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma_3xtf32(a, b, period=None):
    """``a @ b`` as the kernels' k8 MMAs, in a model of the tensor cores'
    accumulation: each pass's k8 product (exact) is added into a float32
    partial rounded toward zero.  ``period``: the partial starts anew
    every ``period`` k8 steps, added into a float32 total rounded to
    nearest (the kernels' promotion: 2 or 4 steps, one or two 16-deep
    stages); None: one partial runs the whole depth."""
    ab, asm = tf32.split_tf32(a)
    bb, bs = tf32.split_tf32(b)
    total = torch.zeros(a.shape[0], b.shape[1])
    part = torch.zeros_like(total)
    for j, k0 in enumerate(range(0, a.shape[1], 8)):
        k = slice(k0, k0 + 8)
        for x, y in ((asm, bb), (ab, bs), (ab, bb)):
            part = _round_to_zero(part.double() + x[:, k].double()
                                  @ y[k].double())
        if period and (j + 1) % period == 0:
            total, part = total + part, torch.zeros_like(part)
    return total + part


def _mix_depth_case(L):
    """64 rows of a lane mix at depth 2L, 128 of its output columns."""
    xr, xi, wr, wi = planes(20 + L, (64, L), (64, L), (L, L), (L, L))
    a = torch.cat([xr, xi], dim=1)
    b = tf32.mix_operand(wr / L ** 0.5, wi / L ** 0.5)[:, :128]
    return a, b, a.double() @ b.double()


@pytest.mark.parametrize("period", [2, 4])
@pytest.mark.parametrize("L", [128, 512, 1600])
def test_promoted_partials_float32_class(L, period):
    a, b, ref = _mix_depth_case(L)
    assert peak_rel(mma_3xtf32(a, b, period=period), ref) <= 1e-6


def test_truncating_accumulator_drifts_with_depth():
    """One partial over the whole depth: within 1e-5 at 2L = 256, not at
    2L = 3200 (lane_mix's widest)."""
    errs = [peak_rel(mma_3xtf32(a, b), ref)
            for a, b, ref in (_mix_depth_case(L) for L in (128, 1600))]
    assert errs[0] <= SPLIT_TOL < errs[1]


@pytest.mark.parametrize("bn", [64, 96, 128, 256])
@pytest.mark.parametrize("K,N,n", [(16, 96, 1), (200, 200, 1), (6, 2, 1),
                                   (64, 512, 3)])
def test_pack_operand_roundtrip(K, N, n, bn):
    ps = planes(13, *[(K, N)] * n)
    packed = tf32.pack_operand(ps, bn, BK)
    kp, np_ = -(-K // BK) * BK, -(-N // bn) * bn
    assert packed.numel() == n * 2 * kp * np_
    for (big, small), p in zip(unpack_operand(packed, n, K, N, bn), ps):
        want_big, want_small = tf32.split_tf32(p)
        assert torch.equal(big, want_big) and torch.equal(small, want_small)
    # the padding is zeros: both halves sum to the planes' own
    assert float(packed.double().abs().sum()) == pytest.approx(
        sum(float(h.double().abs().sum()) for p in ps
            for h in tf32.split_tf32(p)))


def test_pack_operand_stage_layout():
    """One (N tile, K tile) stage is one run: core matrix (8-column
    group g, 4-deep chunk c) of a half at (g * BK / 4 + c) * 32, column r
    at 4 r, depth e at e (csrc/tf32mma.cuh)."""
    K, N, bn = 32, 16, 8
    # distinct values exact in TF32 (< 2^11)
    p = (torch.arange(K)[:, None] * N + torch.arange(N)[None]).float()
    packed = tf32.pack_operand([p], bn, BK)
    stage = 2 * bn * BK
    for nt, kt, g, c, r, e in [(0, 0, 0, 0, 0, 0), (1, 0, 0, 1, 3, 2),
                               (0, 1, 0, 3, 7, 3), (1, 1, 0, 2, 5, 1)]:
        k = kt * BK + 4 * c + e
        n = nt * bn + 8 * g + r
        at = (nt * (K // BK) + kt) * stage + (g * BK // 4 + c) \
            * 32 + 4 * r + e
        assert float(packed[at]) == float(p[k, n])


@pytest.mark.parametrize("rows,L", [(256, 128), (65, 3), (256, 512)])
def test_mix_operand_rebuilds_lane_mix_ref(rows, L):
    xr, xi, wr, wi = planes(14, (rows, L), (rows, L), (L, L), (L, L))
    (big, small), = unpack_operand(
        tf32.pack_operand([tf32.mix_operand(wr, wi)], 128, BK), 1, 2 * L,
        2 * L, 128)
    y = torch.cat([xr, xi], dim=1) @ (big + small)
    ref = torch.cat(sf.lane_mix_ref(xr, xi, wr, wi), dim=1)
    # the block form and the split planes: float32 rounding only
    assert peak_rel(y, ref.double()) <= 2e-6


def test_bank_operand_rebuilds_ref():
    n_seg, L, n_cols = 256, 64, 512
    fr, fi, ka, kb, kc = planes(15, (n_seg, L), (n_seg, L), (L, n_cols),
                                (L, n_cols), (L, n_cols))
    ops = [b + s for b, s in unpack_operand(
        tf32.pack_operand([ka, kb, kc], 64, BK), 3, L, n_cols, 64)]
    got = ac.bank_matmul_power_ref(fr, fi, *ops)
    ref = ac.bank_matmul_power_ref(fr, fi, ka, kb, kc)
    assert peak_rel(got, ref.double()) <= 2e-6


def test_cached_per_tensor():
    a, b = planes(16, (4, 4), (4, 4))
    calls = []

    def build():
        calls.append(1)
        return len(calls)
    assert tf32.cached((a, b), build) == 1
    assert tf32.cached((a, b), build) == 1
    a += 1                       # an in-place change rebuilds
    assert tf32.cached((a, b), build) == 2
    assert tf32.cached((b, a), build) == 3
    n = len(tf32._CACHE)
    del a
    gc.collect()
    assert len(tf32._CACHE) == n - 2


# -- the forward PFB's fused DFT (csrc/pfb.cu pfb_dft_kernel) --------------

def pfb_a_operand(carry, block, taps, scale):
    """The A operand the fused PFB computes into each stage: window row q
    is carry row q below k = n_tap - 1, else the block row scaled, and the
    tap sum of output row r and lane l runs taps ascending from zero in
    float32 (``PfbTile::prepare``, the FIR's order); [ar | ai] (m, 2L),
    the real plane's lanes below L."""
    (cr, ci), (xr, xi) = carry, block
    k, m = cr.shape[0], xr.shape[0]
    s = np.float32(scale)
    planes = []
    for c, x in ((cr, xr), (ci, xi)):
        w = np.concatenate([c, x * s]).astype(np.float32)
        acc = np.zeros((m, c.shape[1]), np.float32)
        for t in range(taps.shape[0]):
            acc = (acc.astype(np.float64) + taps[t].astype(np.float64)
                   * w[t:t + m].astype(np.float64)).astype(np.float32)
        planes.append(acc)
    return torch.as_tensor(np.concatenate(planes, axis=1))


@pytest.mark.parametrize("L", [128, 512])
def test_pfb_a_operand_and_dft_float32_class(L):
    """The tap sums equal the FIR's plain version; split big/small with
    round-to-nearest TF32 and multiplied in the kernel's three passes,
    promoted every 32 deep, the product is within 1e-5 of the float64
    tap sum times the DFT's peak, and lands as [yr | yi]."""
    from baseband_tasks_tpu_torch.ops import pfb as opfb
    from baseband_tasks_tpu_torch.ops.dft_matmul import _expanded_mats
    rng = np.random.default_rng(L)
    n_tap, m = 8, 64
    carry = [rng.standard_normal((n_tap - 1, L)).astype(np.float32)
             for _ in (0, 1)]
    block = [rng.standard_normal((m, L)).astype(np.float32) for _ in (0, 1)]
    taps = rng.standard_normal((n_tap, L)).astype(np.float32)
    fr, fi = (torch.as_tensor(np.asarray(p, np.float32)) for p in
              _expanded_mats(L // 2, 2, "forward"))
    a = pfb_a_operand(carry, block, taps, 0.75)
    ar, ai = opfb.pfb_forward_stream_ref(
        *map(torch.as_tensor, carry), *map(torch.as_tensor, block),
        torch.as_tensor(taps), n_tap=n_tap, scale=0.75)
    assert peak_rel(a, torch.cat([ar, ai], dim=1).double()) <= 1e-6
    b = tf32.mix_operand(fr, fi)
    got = mma_3xtf32(a, b[:, :128], period=4)
    # float64 from the inputs
    w = [np.concatenate([c.astype(np.float64), x.astype(np.float64) * 0.75])
         for c, x in zip(carry, block)]
    a64 = torch.as_tensor(np.concatenate(
        [sum(taps[t].astype(np.float64) * p[t:t + m] for t in range(n_tap))
         for p in w], axis=1))
    ref = a64 @ b.double()
    assert peak_rel(got, ref[:, :128]) <= SPLIT_TOL
    # the whole product as the plain version lays it out
    yr, yi = opfb.pfb_forward_stream_ref(
        *(t.double() for t in map(torch.as_tensor, carry)),
        *(t.double() for t in map(torch.as_tensor, block)),
        torch.as_tensor(taps).double(), fr.double(), fi.double(),
        n_tap=n_tap, scale=0.75)
    assert peak_rel(torch.cat([yr, yi], dim=1), ref) <= 1e-12
