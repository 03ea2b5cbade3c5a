"""A numpy model of the register K1 (``csrc/dedisperse.cu``
``k1_reg_kernel``), against the port's plain versions on the CPU.

The CUDA kernel runs only on a card; this model replays, thread by
thread, what it does with a column b of a lane tile: the (lane, row
group) items each thread holds (two single-lane items a thread, lane
fastest, or VL neighbouring lanes of one row group), the rows each
register holds (``reg::Plan`` radix 8: 8.8.8 at N1 = 512, 8.8.4 at 256,
8.8.2 at 128), the staged rows those registers are read from (the front
edge rows, the end edge rows, then the packed word rows) with each row's
field decoded in place through its descriptor (word row and field shift,
fixed for the block's life), the scale (the edges' own for a stream's
carry), the forward FFT, W_N^{-k b} from sincospif's exact float32
argument, one a row shared by the row's threads through the shuffle the
kernel takes, and the d-major store of row b N1 + k.

Held to the port's plain ``stage_a_packed_ref`` (8, 4, 2 and 1 bits, the
flagship's pads 3584/4608 scaled to the column: kf 7, ke 9 of 512 rows),
``stage_a_ref`` and ``k1_stream_ref`` within 1e-4 of the peak, bf16 within
one bf16 ulp plus 1e-6 of it, as the card tests hold the kernel
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from baseband_tasks_tpu_torch.ops import dedisperse as dd  # noqa: E402
from baseband_tasks_tpu_torch.ops import fft as ff  # noqa: E402
from baseband_tasks_tpu_torch.ops.unpack import (  # noqa: E402
    default_levels, default_offset)
from test_torch_register_fold import Plan, crandn  # noqa: E402

FFT_TOL = 1e-4
LOG_R = 3                                  # the kernel's radix-8 passes


def log2(n):
    return n.bit_length() - 1


def k1_items(n1, tl, vl):
    """(thread, item) -> (lane, row group) of the kernel's items, for the
    live ones, and the block's threads."""
    plan = Plan(LOG_R, log2(n1))
    groups = 1 << plan.log_t
    out = {}
    if vl > 1:
        log_p = max(log2(tl) - log2(vl), 0)
        threads = -(-(max(tl // vl, 1) * groups) // 32) * 32
        for tid in range(threads):
            g = tid >> log_p
            if g < groups:
                for i in range(vl):
                    out[tid, i] = (((tid & ((1 << log_p) - 1)) << log2(vl))
                                   + i, g)
    else:
        threads = -(-(tl * groups) // 64) * 32
        for tid in range(threads):
            for i in range(2):
                item = tid + i * threads
                if item < tl * groups:
                    out[tid, i] = (item & (tl - 1), item >> log2(tl))
    return out, threads


@pytest.mark.parametrize("n1", [512, 256, 128, 16, 4])
@pytest.mark.parametrize("tl,vl", [(16, 1), (16, 2), (16, 4), (8, 1),
                                   (1, 1)])
def test_items_cover_the_column(n1, tl, vl):
    """Every (lane, row group) of the tile is one item of one thread, and
    a block has at most 512 threads."""
    items, threads = k1_items(n1, tl, vl)
    groups = 1 << Plan(LOG_R, log2(n1)).log_t
    assert sorted(items.values()) == [(lane, g) for lane in range(tl)
                                      for g in range(groups)]
    assert threads <= 512 and threads % 32 == 0


@pytest.mark.parametrize("n1", [512, 256, 128])
@pytest.mark.parametrize("tl,vl", [(16, 1), (16, 2), (16, 4), (8, 1)])
def test_shared_twiddles_reach_their_rows(n1, tl, vl):
    """The compiled tile's twiddle sharing: thread pos of a row group
    computes W for rows_final((o << kLogP) + pos mod P), o < R / P, and
    the thread holding slot q takes own[q >> kLogP] from the group's
    thread (lane & ~(P' - 1)) | (q mod P): that is W of its own row."""
    plan = Plan(LOG_R, log2(n1))
    log_pt = max(log2(tl) - log2(vl), 0)
    log_p = min(log_pt, LOG_R)
    items, _ = k1_items(n1, tl, vl)
    for (tid, i), (lane, g) in items.items():
        for q in range(plan.R):
            src = (tid & ~31) | ((tid & 31) & ~((1 << log_pt) - 1)) | (
                q & ((1 << log_p) - 1))
            s_lane, s_g = items[src, i]
            assert s_g == g
            o = q >> log_p
            slot = (o << log_p) + (src & ((1 << log_p) - 1))
            assert plan.rows_final(slot)[s_g] == plan.rows_final(q)[g]


def descriptor(c, kf, ke, nm, nmp, bits):
    """The kernel's per-row descriptor: (staged row, field shift + 1)."""
    if c < kf:
        return c, 0
    if c >= kf + nm:
        return c - nm, 0
    m = c - kf
    f = m // nmp
    return kf + ke + m - f * nmp, bits * f + 1


def decode(field, bits, offset, levels):
    if bits >= 4:
        return field.astype(np.float32) - np.float32(offset)
    lv = np.asarray(levels, np.float32)
    return lv[field] if bits == 2 else np.where(field == 0, lv[0], lv[3])


def twiddle(k, b, nf):
    """sincospif(-2 float(k b) / N) as the kernel computes the argument."""
    arg = (np.float32(-2.0) * (k * b).astype(np.float32)) / np.float32(nf)
    return np.exp(1j * np.pi * arg.astype(np.float64)).astype(np.complex64)


def k1_model(n1, n2, L, kf, ke, scale, *, edge_scale=True, words=None,
             bits=32, main=None, front, end):
    """``k1_reg_kernel`` on one block's columns: ``front``/``end`` the
    (kf N2, L) / (ke N2, L) edge planes, ``words`` (nmp N2, L) int32 word
    planes (or ``main`` (nm N2, L) float planes), all (re, im) pairs of
    numpy arrays.  Returns the d-major (N2, N1, L) complex64 output."""
    plan = Plan(LOG_R, log2(n1))
    nm = n1 - kf - ke
    packed = words is not None
    nmp = nm // (32 // bits) if packed else nm
    s = np.float32(scale)
    se = s if edge_scale else np.float32(1.0)
    offset, levels = default_offset(bits if packed else 8), \
        default_levels(bits if packed else 8)
    mask = (1 << bits) - 1 if packed else 0
    # the stage of column b: [plane][row][b][lane], rows as the kernel
    # stages them
    rows = []
    for r in range(kf + ke + nmp if packed else n1):
        if r < kf:
            src, row = front, r
        elif (r < kf + ke) if packed else (r >= kf + nm):
            src, row = end, r - (kf if packed else kf + nm)
        else:
            src, row = (words, r - kf - ke) if packed else (main, r - kf)
        rows.append([np.ascontiguousarray(p[row * n2:(row + 1) * n2])
                     .view(np.uint32) for p in src])
    # 4-byte words as staged: (rows, N2, L) a plane
    stage = [np.stack([r[p] for r in rows]) for p in (0, 1)]
    v = np.zeros((n2, L, len(plan.t), plan.R), np.complex64)
    for q in range(plan.used):
        for t in plan.t:
            c = int(plan.row_in(0, q)[t])
            if packed:
                srow, sh = descriptor(c, kf, ke, nm, nmp, bits)
                if sh == 0:
                    re, im = (stage[p][srow].view(np.float32) * se
                              for p in (0, 1))
                else:
                    re, im = (decode((stage[p][srow] >> np.uint32(sh - 1))
                                     & np.uint32(mask), bits, offset,
                                     levels) * s for p in (0, 1))
            else:
                f = se if c < kf or c >= kf + nm else s
                re, im = (stage[p][c].view(np.float32) * f for p in (0, 1))
            v[:, :, t, q] = re + 1j * im
    v = plan.run(v, False)
    b = np.arange(n2)[:, None, None]
    y = np.zeros((n2, n1, L), np.complex64)
    for q in range(plan.used):
        k = plan.rows_final(q)                            # (t,)
        w = twiddle(k[None, :], b[:, :, 0], n1 * n2)      # (N2, t)
        y[:, k, :] = np.moveaxis(v[:, :, :, q] * w[:, None, :], 1, 2)
    return y


def planes_of(z):
    return [np.ascontiguousarray(f(z), np.float32) for f in (np.real,
                                                           np.imag)]


def tensors(ps):
    return [torch.as_tensor(p) for p in ps]


def check(got, ref_pair):
    ref = ref_pair[0].float().numpy() + 1j * ref_pair[1].float().numpy()
    peak = np.abs(ref).max()
    assert np.abs(got - ref).max() <= FFT_TOL * peak


# the plain versions take a window that splits as N1 x N2 (split_n: N2 =
# N1 up to 512), so a column is modelled over all N2 = N1 of them; the
# lanes do not enter the arithmetic (the items above cover the tiles)
L = 2


@pytest.mark.parametrize("n1,bits,kf,ke", [
    (512, 8, 7, 9), (512, 4, 7, 9), (512, 2, 7, 9), (512, 1, 7, 25),
    (256, 8, 3, 5), (256, 2, 3, 13), (128, 8, 1, 3), (128, 4, 1, 7)])
def test_k1_packed_model(n1, bits, kf, ke):
    rng = np.random.default_rng(n1 + bits)
    nmp = (n1 - kf - ke) // (32 // bits)
    words = [rng.integers(-2 ** 31, 2 ** 31, (nmp * n1, L)).astype(np.int32)
             for _ in (0, 1)]
    front = planes_of(crandn(rng, (kf * n1, L)))
    end = planes_of(crandn(rng, (ke * n1, L)))
    scale = 0.75
    got = k1_model(n1, n1, L, kf, ke, scale, words=words, bits=bits,
                   front=front, end=end)
    ref = dd.stage_a_packed_ref(*tensors(words), *tensors(front),
                                *tensors(end), torch.tensor([scale]),
                                bits=bits)
    check(got, ref)


@pytest.mark.parametrize("n1,kf,ke", [(512, 7, 9), (256, 1, 2),
                                      (128, 2, 1)])
def test_k1_float_model(n1, kf, ke):
    rng = np.random.default_rng(n1 + kf)
    main = planes_of(crandn(rng, ((n1 - kf - ke) * n1, L)))
    front = planes_of(crandn(rng, (kf * n1, L)))
    end = planes_of(crandn(rng, (ke * n1, L)))
    got = k1_model(n1, n1, L, kf, ke, 1.25, main=main, front=front, end=end)
    ref = dd.stage_a_ref(*tensors(main), *tensors(front), *tensors(end),
                         torch.tensor([1.25]))
    check(got, ref)


@pytest.mark.parametrize("n1", [512, 128])
def test_k1_window_model(n1):
    """k1_window (and k1_planes): no edges, no scale."""
    rng = np.random.default_rng(n1 + 2)
    x = planes_of(crandn(rng, (n1 * n1, L)))
    empty = [np.zeros((0, L), np.float32)] * 2
    got = k1_model(n1, n1, L, 0, 0, 1.0, main=x, front=empty, end=empty)
    check(got, ff.k1_window_ref(*tensors(x)))


@pytest.mark.parametrize("n1,kc", [(128, 1), (512, 1), (256, 3)])
def test_k1_stream_model(n1, kc):
    """k1_stream: the carry as the front edge, unscaled (edge_scale 0)."""
    rng = np.random.default_rng(n1 + kc + 1)
    carry = planes_of(crandn(rng, (kc * n1, L)))
    block = planes_of(crandn(rng, ((n1 - kc) * n1, L)))
    empty = [np.zeros((0, L), np.float32)] * 2
    got = k1_model(n1, n1, L, kc, 0, 0.5, edge_scale=False, main=block,
                   front=carry, end=empty)
    ref = ff.k1_stream_ref(*tensors(carry), *tensors(block),
                           torch.tensor([0.5]))
    check(got, ref)


def test_k1_packed_bf16_model():
    """The bf16 store rounds the model's float32 result to nearest even:
    within one bf16 ulp plus 1e-6 of the peak of the plain bf16 pass."""
    n1, bits, kf, ke = 512, 8, 7, 9
    rng = np.random.default_rng(5)
    nmp = (n1 - kf - ke) // 4
    words = [rng.integers(-2 ** 31, 2 ** 31, (nmp * n1, L)).astype(np.int32)
             for _ in (0, 1)]
    front = planes_of(crandn(rng, (kf * n1, L)))
    end = planes_of(crandn(rng, (ke * n1, L)))
    got = k1_model(n1, n1, L, kf, ke, 0.75, words=words, bits=bits,
                   front=front, end=end)
    ref = dd.stage_a_packed_ref(*tensors(words), *tensors(front),
                                *tensors(end), torch.tensor([0.75]),
                                bits=bits, out_dtype=torch.bfloat16)
    peak = max(float(r.float().abs().max()) for r in ref)
    for g, r in zip(planes_of(got), ref):
        g = torch.as_tensor(g).to(torch.bfloat16).float()
        r = r.float()
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30)))
                         - 7)
        assert bool(((g - r).abs() <= ulp + 1e-6 * peak).all())
