"""Fused coherent dedispersion -> detection -> fold for one window.

Counterpart of ``baseband_tasks_tpu/ops/dedisperse_pallas.py``.  The
overlap-save window of N = N1·N2 samples (powers of two) over L lanes runs
through a four-step FFT in three passes, with frequency bins in d-major
storage order (d, c) <-> k = d·N1 + c between them, so no transpose
reaches memory:

- **stage A** (K1): assemble the window from the front edge, the main
  block (float32 planes, plane-packed 1/2/4/8-bit words decoded in the
  pass, or the halves of planes-first (2, rows, L) arrays) and the end
  edge; scale; FFT over the N1 rows; twiddle W_N^{-c b}; store d-major
  (N2, N1, L).
- **stage B** (K2): FFT over N2, multiply by the chirp (cos/sin planes, or
  one phase plane in cycles), inverse FFT with 1/N2, twiddle W_N^{+c b};
  in place.
- **fold** (K3): inverse stage A with 1/N1, detect |z|² (or full Stokes:
  lane l with lane l+1), bin pulse phase in 31-bit fixed point, fold into
  an (n_phase+1, L or 3L) profile whose last row is the trash bin of the
  halo rows, with integer counts.  Or, without the fold, the inverse
  stage A as |z|² planes (k3_power) or re/im planes (``ops/fft.k3_trim``).

With ``inter_dtype='bfloat16'`` the planes between the passes (y after
stage A, z after stage B, in place) are stored as bfloat16, rounded to
nearest even; every pass computes in float32 and widens its bf16 loads
(the JAX module's bandwidth mode).  The bf16 passes are kernels of their
own (``k1_packed_bf16``, ``k1_float_bf16``, ``k2_bf16``, ``k2_bf16_chirp``
with a bf16 chirp, ``k3_fold_bf16``, ``k3_fold_stokes_bf16``).

Each stage has a wrapper and a plain PyTorch version (``*_ref``) that
produces the same layout.  A wrapper given CUDA tensors launches its
hand-written Hopper kernel (``csrc/dedisperse.cu``, ``csrc/fourstep.cu``)
or raises; given CPU tensors it runs the plain version.  Each launch adds
one to :data:`launch_counts` (shared with ``ops/fft.py``, in
``ops/_build.py``).  :func:`plain_versions` is the tests' way to run the
plain versions on a card.

The public entry points are those of the JAX module, without its TPU
tiling knobs (``block_b``, ``block_c``, ``interpret``).  Given numpy,
they run on the card when there is one, else on the CPU; a tensor keeps
its device:
:func:`dedisperse_pow2`, :func:`dedisperse_pow2_planes`,
:func:`dedisperse_fold_pow2`, :func:`dedisperse_fold_stream`,
:func:`dedisperse_fold_split` and :func:`dedisperse_fold_split_packed`.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import numpy as np
import torch

from ._build import (kernel_form, launch, launch_counts, library,
                     reset_launch_counts)
from .fold import fold_accumulate
from .unpack import decode_planes, default_levels, default_offset

__all__ = ["split_n", "permute_to_storage_order", "fold_phase_vector",
           "fold_bins_ref", "fold_bins", "fold_bin_runs", "fold_detected",
           "stage_a_packed", "stage_a", "stage_a_planes",
           "stage_a_stream_planes", "stage_b", "stage_b_theta",
           "detect_fold", "k3_power", "stage_a_packed_ref", "stage_a_ref",
           "stage_b_ref", "k2_theta_ref", "fold_ref", "k3_power_ref",
           "dedisperse_pow2", "dedisperse_pow2_planes",
           "dedisperse_fold_pow2", "dedisperse_fold_stream",
           "dedisperse_fold_split", "dedisperse_fold_split_packed",
           "fold_chain", "as_tensor", "launch_counts", "reset_launch_counts",
           "k2_form", "k1_form", "k3_form", "guppi_repack",
           "guppi_repack_ref"]

_FX_BITS = 31
_FX_ONE = 1 << _FX_BITS          # one pulse cycle in fixed-point units
_FX_MASK = _FX_ONE - 1

def _is_pow2(n):
    return n > 0 and (n & (n - 1)) == 0


def split_n(n):
    """N = N1 * N2, both powers of two, N1 <= N2 and N1 <= 512."""
    k = n.bit_length() - 1
    k1 = min(k // 2, 9)
    return 1 << k1, 1 << (k - k1)


def permute_to_storage_order(arr, n1, n2):
    """Natural frequency order k -> d-major storage order (d, c):
    ``storage[d, c] = arr[d * n1 + c]`` (numpy, frequency axis first)."""
    rest = arr.shape[1:]
    return np.ascontiguousarray(arr.reshape((n2, n1) + rest))


def fold_phase_vector(phase0_cycles, rate_cycles_per_sample):
    """(3,) int32 ``[i0_fx, p_fx, 0]``: pulse phase at local time index t
    is ``((i0_fx + t * p_fx) mod 2^31) / 2^31`` cycles."""
    i0 = int(round((float(phase0_cycles) % 1.0) * _FX_ONE)) & _FX_MASK
    p = int(round((float(rate_cycles_per_sample) % 1.0) * _FX_ONE)) \
        & _FX_MASK
    return np.array([i0, p, 0], dtype=np.int32)


def fold_bins_ref(fold, t, n_phase):
    """Numpy mirror of the kernel's exact bin map: floor(frac(t)·n_phase),
    computed in int64 and masked to 31 bits."""
    fold = np.asarray(fold, np.int64)
    num = (fold[0] + np.asarray(t, np.int64) * fold[1]) & _FX_MASK
    hi = num >> 16
    lo = num & 0xFFFF
    return ((hi * n_phase) + ((lo * n_phase) >> 16)) >> 15


def _check_n_phase(n_phase):
    """The 16-bit-split bin extraction is exact only for n_phase <= 2^15."""
    n_phase = int(n_phase)
    if not 0 < n_phase <= (1 << 15):
        raise ValueError(f"n_phase={n_phase} must be in [1, 32768]")
    return n_phase


def _geometry(t_main, pad_start, pad_end):
    """(n1, n2) of the window; every piece a non-zero multiple of N2."""
    n = t_main + pad_start + pad_end
    if not _is_pow2(n):
        raise ValueError(f"window {n} must be a power of two")
    n1, n2 = split_n(n)
    for name, val in (("pad_start", pad_start), ("pad_end", pad_end),
                      ("block", t_main)):
        if val % n2 or val == 0:
            raise ValueError(f"{name}={val} must be a non-zero multiple "
                             f"of N2={n2}")
    return n1, n2


# -- plain PyTorch versions ----------------------------------------------

def _twiddle(n1, n2, sign, device):
    """(N1, N2) complex64 exp(sign·2πi·c·b/N), angles in float64."""
    c = torch.arange(n1, dtype=torch.int64, device=device)[:, None]
    b = torch.arange(n2, dtype=torch.int64, device=device)[None, :]
    ang = (c * b).to(torch.float64) * (sign * 2.0 * math.pi / (n1 * n2))
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)


def _complex(re, im):
    """complex64 of two planes, bf16 planes widened to float32 first."""
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def stage_a_window_ref(w, out_dtype=torch.float32):
    """Plain stage A of a complex (N, L) window -> FFT over c ->
    W_N^{-c b} -> d-major (N2, N1, L) re/im planes (rounded to
    ``out_dtype``)."""
    n, L = w.shape
    n1, n2 = split_n(n)
    y = torch.fft.fft(w.reshape(n1, n2, L), dim=0) \
        * _twiddle(n1, n2, -1, w.device)[:, :, None]
    y = y.transpose(0, 1)
    return (y.real.to(out_dtype).contiguous(),
            y.imag.to(out_dtype).contiguous())


def stage_a_ref(xr, xi, fr, fi, er, ei, scale, out_dtype=torch.float32):
    """Plain stage A of the window [front | block | end] times ``scale``;
    the planes rounded to ``out_dtype`` (float32 or bfloat16)."""
    _geometry(xr.shape[0], fr.shape[0], er.shape[0])
    return stage_a_window_ref(torch.complex(torch.cat([fr, xr, er]) * scale,
                                            torch.cat([fi, xi, ei]) * scale),
                              out_dtype)


def stage_a_packed_ref(xpr, xpi, fr, fi, er, ei, scale, *, bits,
                       offset=None, levels=None, out_dtype=torch.float32):
    """Plain stage A from plane-packed int32 words (decode, then
    :func:`stage_a_ref`)."""
    return stage_a_ref(decode_planes(xpr, bits, offset, levels),
                       decode_planes(xpi, bits, offset, levels),
                       fr, fi, er, ei, scale, out_dtype)


def guppi_repack_ref(words):
    """Plain GUPPI repack: (n_chan, T) int32 words, each one sample's
    signed 8-bit (X re, X im, Y re, Y im) -> the (re, im) plane-packed
    (T/4, 2 n_chan) int32 words of lanes 2c + p, each byte's sign bit
    flipped (offset binary: decoded with offset 128)."""
    c, t = words.shape
    b = words.contiguous().view(torch.uint8).reshape(c, 4, t // 4, 2, 2)
    # (chan, plane k, row r, pol, re/im) -> (re/im, r, chan, pol, k)
    planes = (b ^ 0x80).permute(4, 2, 0, 3, 1).contiguous()
    return tuple(p.view(torch.int32).reshape(t // 4, 2 * c)
                 for p in planes)


def _stage_b_ref(yr, yi, chirp):
    n2, n1, _ = yr.shape
    y = torch.fft.fft(_complex(yr, yi), dim=0) * chirp
    z = torch.fft.ifft(y, dim=0) * _twiddle(n1, n2, +1, y.device).T[:, :, None]
    # in place, rounded to the planes' dtype
    yr.copy_(z.real)
    yi.copy_(z.imag)
    return yr, yi


def stage_b_ref(yr, yi, csr, csi):
    """Plain stage B, in place on the d-major (N2, N1, L) planes (float32,
    or bfloat16 widened on load and rounded on store; the chirp float32
    or bfloat16)."""
    return _stage_b_ref(yr, yi, _complex(csr, csi))


def k2_theta_ref(yr, yi, theta):
    """Plain stage B with the chirp as one phase plane in cycles
    (exp(2πi θ), the angle in float64), in place."""
    ang = theta.to(torch.float64) * (2.0 * math.pi)
    return _stage_b_ref(yr, yi, torch.polar(torch.ones_like(ang), ang)
                        .to(torch.complex64))


def _inverse_stage_a(zr, zi):
    """(N, L) complex time series of d-major planes (inverse, 1/N1)."""
    n2, n1, L = zr.shape
    x = torch.fft.ifft(_complex(zr, zi).transpose(0, 1), dim=0)
    return x.reshape(n1 * n2, L)


def _detect(x, stokes):
    """|x|², or with ``stokes`` the (N, 3L) [|x_l|² | Re x_l conj x_{l+1}
    | Im x_l conj x_{l+1}], lane l paired with lane (l+1) mod L."""
    power = x.real * x.real + x.imag * x.imag
    if not stokes:
        return power
    q = torch.roll(x, -1, dims=1)
    return torch.cat([power, x.real * q.real + x.imag * q.imag,
                      x.imag * q.real - x.real * q.imag], dim=1)


def k3_power_ref(zr, zi):
    """Plain inverse stage A (1/N1) and |·|² of d-major planes: the (N, L)
    detected power in time order."""
    return _detect(_inverse_stage_a(zr, zi), False)


def fold_ref(zr, zi, fold, *, n_phase, pad_start, n_valid, stokes=False):
    """Plain fold: inverse stage A -> |z|² (or full Stokes) -> fixed-point
    bins (int64, masked) -> one-hot fold.  Returns the (n_phase+1, L, or
    3L with ``stokes``) float32 profile and (n_phase+1,) int32 counts; row
    n_phase is the trash bin."""
    x = _inverse_stage_a(zr, zi)
    n = x.shape[0]
    t = torch.arange(n, dtype=torch.int64, device=zr.device)
    valid = (t >= pad_start) & (t < pad_start + n_valid)
    return fold_detected(_detect(x, stokes), fold_bins(fold, t, valid,
                                                       n_phase), n_phase)


def fold_bins(fold, t, valid, n_phase):
    """The kernels' fixed-point bin map of int64 times ``t`` (int64,
    masked to 31 bits), rows where ``valid`` is False to trash bin
    n_phase."""
    f = fold.to(torch.int64)
    num = (f[0] + t * f[1]) & _FX_MASK
    bins = (((num >> 16) * n_phase) + (((num & 0xFFFF) * n_phase) >> 16)) >> 15
    return torch.where(valid, bins, n_phase)


def fold_bin_runs(fold, k, n_phase, pad_start, n_valid, n):
    """The rows t of [pad_start, pad_start + n_valid) (clipped to [0, n))
    that :func:`fold_bins` puts in bin ``k``, as (start, stop) runs in
    increasing t: the plain version of the gather form's search
    (``csrc/dedisperse.cu`` ``BinRows``), with its arithmetic.

    The map is floor(num·n_phase / 2^31), num = (i0 + t·p) mod 2^31, so
    bin k holds num in [E_k, E_{k+1}), E_k = ceil(k·2^31 / n_phase): in
    each pulse period j (i0 + t·p in [j·2^31, (j+1)·2^31)) one run
    between the rows where the phase reaches E_k and E_{k+1}.  Where p >
    2^30 the phase falls a row, and the rows are those of 2^31 - 1 - num,
    which rises by 2^31 - p, in [2^31 - E_{k+1}, 2^31 - E_k).  The first
    period's edges are exact quotients; each later edge steps by 2^31 =
    q·p + r with a remainder in [0, p), no division."""
    one = _FX_ONE
    i0, p = int(fold[0]) & _FX_MASK, int(fold[1]) & _FX_MASK
    ta = min(max(int(pad_start), 0), n)
    tb = max(ta, min(int(pad_start) + int(n_valid), n))
    a = -(-(k << 31) // n_phase)
    b = -(-((k + 1) << 31) // n_phase)
    if p > one // 2:                  # the phase falls: mirror it
        i0, p, a, b = one - 1 - i0, one - p, one - b, one - a
    if p == 0:                        # one phase for every row
        return [(ta, tb)] if a <= i0 < b and ta < tb else []
    q, r = divmod(one, p)

    def start(x):                     # ceil(x / p) and its remainder
        t = -(-x // p)
        return t, t * p - x

    j = (i0 + ta * p) >> 31
    j1 = (i0 + (tb - 1) * p) >> 31 if tb > ta else j - 1
    (lo, s_lo), (hi, s_hi) = start((j << 31) + a - i0), \
        start((j << 31) + b - i0)
    runs = []
    while j <= j1:
        t0, t1 = max(lo, ta), min(hi, tb)
        if t0 < t1:
            runs.append((t0, t1))
        j += 1
        lo, s_lo = (lo + q, s_lo - r) if s_lo >= r else \
            (lo + q + 1, s_lo - r + p)
        hi, s_hi = (hi + q, s_hi - r) if s_hi >= r else \
            (hi + q + 1, s_hi - r + p)
    return runs


def fold_detected(detected, bins, n_phase):
    """One-hot fold of (T, W) detected rows into (n_phase+1, W) float32
    sums and (n_phase+1,) int32 counts."""
    prof = fold_accumulate(detected, bins, n_phase + 1, with_counts=False)
    cnt = torch.bincount(bins, minlength=n_phase + 1).to(torch.int32)
    return prof, cnt


# -- kernel wrappers -----------------------------------------------------

_plain = contextvars.ContextVar("plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Test-only: inside this context every kernel wrapper of the package
    runs its plain PyTorch version, on a CUDA device too, and counts no
    launch.  The tests and ``chip_smoke.py`` hold the kernels against it
    on the card; nothing else uses it."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def _on_cuda(x):
    """True for a CUDA tensor (outside :func:`plain_versions`), False
    for a CPU one or anything not a tensor (a public op converts numpy
    with :func:`_as_device` first); raises for another device."""
    if not torch.is_tensor(x):
        return False
    if x.device.type == "cuda":
        return not _plain.get()
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if dtype == torch.bfloat16 and t.data_ptr() % 4:
        # the bf16 kernels move lane pairs as 4-byte words
        raise ValueError(f"{name} must start on a 4-byte boundary")


_PLANE_DTYPES = (torch.float32, torch.bfloat16)


def _pair_dtype(a, b, names, allowed=_PLANE_DTYPES):
    """The common dtype of a plane pair: one of ``allowed``, the same for
    both (a mixed pair is refused: stage B runs in place)."""
    if a.dtype not in allowed:
        raise TypeError(f"{names[0]} has dtype {a.dtype}, expected one of "
                        f"{allowed}")
    if b.dtype != a.dtype:
        raise TypeError(f"{names[1]} has dtype {b.dtype}, {names[0]} "
                        f"{a.dtype}: the planes must share one dtype")
    return a.dtype


def _bf16_suffix(dtype):
    return "_bf16" if dtype == torch.bfloat16 else ""


def _out_dtype(dtype):
    if dtype not in _PLANE_DTYPES:
        raise TypeError(f"out_dtype {dtype} must be one of {_PLANE_DTYPES}")
    return dtype


def _check_kernel_geometry(n1, n2):
    # the in-kernel twiddle argument c·b/N is exact in float32 only below
    # 2^24; a radix-2 column needs at least two rows; a stage-B column of
    # N2 rows (12 bytes each with its twiddles) must fit shared memory
    if n1 * n2 > (1 << 24) or n1 < 2 or n2 > (1 << 14):
        raise ValueError(f"window {n1 * n2} = {n1}x{n2} outside the "
                         f"kernels' range: N in [4, 2^24], N2 <= 2^14")


def _check_edges(fr, fi, er, ei, scale, L, device):
    for name, t, rows in (("fr", fr, fr.shape[0]), ("fi", fi, fr.shape[0]),
                          ("er", er, er.shape[0]), ("ei", ei, er.shape[0])):
        _check(t, name, torch.float32, (rows, L), device)
    _check(scale, "scale", torch.float32, (1,), device)


def stage_a_packed(xpr, xpi, fr, fi, er, ei, scale, *, bits, offset=None,
                   levels=None, out_dtype=torch.float32):
    """Stage A from plane-packed words: K1p (``k1_packed``, or
    ``k1_packed_bf16`` for bfloat16 ``out_dtype``) on CUDA tensors, else
    :func:`stage_a_packed_ref`.

    ``xpr``/``xpi`` : (T·bits/32, L) int32 words; ``fr``/``fi`` :
    (pad_start, L) and ``er``/``ei`` : (pad_end, L) float32 decoded edges;
    ``scale`` : (1,) float32.  Returns d-major (N2, N1, L) planes of
    ``out_dtype``.
    """
    name = "k1_packed" + _bf16_suffix(_out_dtype(out_dtype))
    if not _on_cuda(xpr):
        return stage_a_packed_ref(xpr, xpi, fr, fi, er, ei, scale,
                                  bits=bits, offset=offset, levels=levels,
                                  out_dtype=out_dtype)
    per = 32 // bits
    tq, L = xpr.shape
    n1, n2 = _geometry(tq * per, fr.shape[0], er.shape[0])
    _check_kernel_geometry(n1, n2)
    kf, ke = fr.shape[0] // n2, er.shape[0] // n2
    if (n1 - kf - ke) % per:
        raise ValueError(f"main rows {n1 - kf - ke} must divide by {per} "
                         f"for {bits}-bit plane-packed input")
    dev = xpr.device
    _check(xpr, "xpr", torch.int32, (tq, L), dev)
    _check(xpi, "xpi", torch.int32, (tq, L), dev)
    _check_edges(fr, fi, er, ei, scale, L, dev)
    offset = default_offset(bits) if offset is None else offset
    lv = default_levels(bits) if levels is None else levels
    yr = torch.empty((n2, n1, L), dtype=out_dtype, device=dev)
    yi = torch.empty_like(yr)
    launch(name, f"bbt_{name}", dev, xpr.data_ptr(),
            xpi.data_ptr(), fr.data_ptr(), fi.data_ptr(), er.data_ptr(),
            ei.data_ptr(), scale.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            n1, n2, L, kf, ke, bits, float(offset), *map(float, lv))
    return yr, yi


def guppi_repack(words):
    """GUPPI words into K1p's two plane-packed planes: guppi_repack
    (``csrc/unpack.cu``) on a CUDA tensor, else :func:`guppi_repack_ref`.

    ``words`` : (n_chan, T) int32, channel-major, word (c, t) the bytes
    (X re, X im, Y re, Y im) of channel c's sample t (GUPPI NPOL=4,
    NBITS=8); T a multiple of 4.  Returns the (re, im) (T/4, 2 n_chan)
    int32 planes, offset binary (:func:`stage_a_packed` with
    ``offset=128`` decodes the signed values exactly).
    """
    if words.ndim != 2 or words.shape[1] % 4:
        raise ValueError(f"GUPPI words must be (n_chan, T), T a multiple "
                         f"of 4; got {tuple(words.shape)}")
    if not _on_cuda(words):
        return guppi_repack_ref(words)
    c, t = words.shape
    dev = words.device
    _check(words, "words", torch.int32, (c, t), dev)
    re = torch.empty((t // 4, 2 * c), dtype=torch.int32, device=dev)
    im = torch.empty_like(re)
    launch("guppi_repack", "bbt_guppi_repack", dev, words.data_ptr(),
           re.data_ptr(), im.data_ptr(), c, t // 4)
    return re, im


def stage_a(xr, xi, fr, fi, er, ei, scale, out_dtype=torch.float32):
    """Stage A from float32 (T, L) planes: K1f (``k1_float``, or
    ``k1_float_bf16`` for bfloat16 ``out_dtype``) on CUDA tensors, else
    :func:`stage_a_ref`."""
    name = "k1_float" + _bf16_suffix(_out_dtype(out_dtype))
    if not _on_cuda(xr):
        return stage_a_ref(xr, xi, fr, fi, er, ei, scale, out_dtype)
    t_main, L = xr.shape
    n1, n2 = _geometry(t_main, fr.shape[0], er.shape[0])
    _check_kernel_geometry(n1, n2)
    dev = xr.device
    _check(xr, "xr", torch.float32, (t_main, L), dev)
    _check(xi, "xi", torch.float32, (t_main, L), dev)
    _check_edges(fr, fi, er, ei, scale, L, dev)
    yr = torch.empty((n2, n1, L), dtype=out_dtype, device=dev)
    yi = torch.empty_like(yr)
    launch(name, f"bbt_{name}", dev, xr.data_ptr(), xi.data_ptr(),
            fr.data_ptr(), fi.data_ptr(), er.data_ptr(), ei.data_ptr(),
            scale.data_ptr(), yr.data_ptr(), yi.data_ptr(), n1, n2, L,
            fr.shape[0] // n2, er.shape[0] // n2)
    return yr, yi


def stage_a_planes(x2):
    """Stage A of a planes-first (2, N, L) window: k1_planes on a CUDA
    tensor, else :func:`stage_a_window_ref` of ``x2[0] + i x2[1]``.
    Returns d-major (N2, N1, L) planes."""
    if not _on_cuda(x2):
        return stage_a_window_ref(torch.complex(x2[0], x2[1]))
    _, n, L = x2.shape
    if not _is_pow2(n):
        raise ValueError(f"N={n} must be a power of two")
    n1, n2 = split_n(n)
    _check_kernel_geometry(n1, n2)
    dev = x2.device
    _check(x2, "x2", torch.float32, (2, n, L), dev)
    yr = torch.empty((n2, n1, L), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    launch("k1_planes", "bbt_k1_planes", dev, x2.data_ptr(), yr.data_ptr(),
           yi.data_ptr(), n1, n2, L)
    return yr, yi


def stage_a_stream_planes(x2, front, end, scale):
    """Stage A of [front | block | end] · scale from planes-first arrays:
    k1_stream_planes on CUDA tensors, else :func:`stage_a_ref` of the
    halves.  ``x2`` : (2, T, L); ``front`` : (2, pad_start, L); ``end`` :
    (2, pad_end, L); ``scale`` : (1,) float32 on every row, edges too."""
    if not _on_cuda(x2):
        return stage_a_ref(x2[0], x2[1], front[0], front[1], end[0],
                           end[1], scale)
    _, t_main, L = x2.shape
    p0, p1 = front.shape[1], end.shape[1]
    n1, n2 = _geometry(t_main, p0, p1)
    _check_kernel_geometry(n1, n2)
    dev = x2.device
    for name, t, rows in (("x2", x2, t_main), ("front", front, p0),
                          ("end", end, p1)):
        _check(t, name, torch.float32, (2, rows, L), dev)
    _check(scale, "scale", torch.float32, (1,), dev)
    yr = torch.empty((n2, n1, L), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    launch("k1_stream_planes", "bbt_k1_stream_planes", dev, x2.data_ptr(),
           front.data_ptr(), end.data_ptr(), scale.data_ptr(), yr.data_ptr(),
           yi.data_ptr(), n1, n2, L, p0 // n2, p1 // n2)
    return yr, yi


def stage_b(yr, yi, csr, csi):
    """Stage B in place on d-major (N2, N1, L) planes: K2 on CUDA
    tensors, else :func:`stage_b_ref`.  float32 planes take a float32
    chirp (``k2``); bfloat16 planes a float32 chirp (``k2_bf16``) or a
    bfloat16 one (``k2_bf16_chirp``)."""
    dt = _pair_dtype(yr, yi, ("yr", "yi"))
    ct = _pair_dtype(csr, csi, ("csr", "csi"),
                     _PLANE_DTYPES if dt == torch.bfloat16
                     else (torch.float32,))
    if not _on_cuda(yr):
        return stage_b_ref(yr, yi, csr, csi)
    n2, n1, L = yr.shape
    _check_kernel_geometry(n1, n2)
    dev = yr.device
    for name, t, d in (("yr", yr, dt), ("yi", yi, dt), ("csr", csr, ct),
                       ("csi", csi, ct)):
        _check(t, name, d, (n2, n1, L), dev)
    name = "k2" + _bf16_suffix(dt) + (
        "_chirp" if ct == torch.bfloat16 else "")
    launch(name, f"bbt_{name}", dev, yr.data_ptr(), yi.data_ptr(),
           csr.data_ptr(), csi.data_ptr(), n1, n2, L)
    return yr, yi


_K2_KINDS = {"k2": 0, "k2_bf16": 1, "k2_bf16_chirp": 2, "k2_theta": 3}


def k2_form(name, n2, L):
    """'register' or 'shared': the form of K2 launch ``name`` (k2,
    k2_bf16, k2_bf16_chirp, k2_theta) on (n2, n1, L) planes (needs the
    kernels' library, so a CUDA machine)."""
    return kernel_form("bbt_k2_form", int(n2), int(L), _K2_KINDS[name])


_K1_KINDS = {"k1_packed": 0, "k1_packed_bf16": 1, "k1_float": 2,
             "k1_float_bf16": 3}


def k1_form(n1, L, name="k1_float"):
    """'register' or 'general': whether K1 launch ``name`` (k1_packed,
    k1_packed_bf16, k1_float, k1_float_bf16; k1_window, k1_stream,
    k1_planes and k1_stream_planes run k1_float's kernel) on N1-row
    columns of L lanes runs the register kernel compiled for its size or
    the general one on a run-time pass plan (needs the kernels' library,
    so a CUDA machine)."""
    kind = _K1_KINDS.get(name, 2 if name.startswith("k1_") else None)
    if kind is None:
        raise ValueError(f"{name!r} is not a K1 launch")
    return kernel_form("bbt_k1_form", int(n1), int(L), kind,
                       other="general")


_K3_KINDS = {"k3_fold": 0, "k3_fold_stokes": 1, "k3_fold_bf16": 2,
             "k3_fold_stokes_bf16": 3}


def k3_form(name, n1, L, n_phase):
    """The form of K3 launch ``name`` (k3_fold, k3_fold_stokes and their
    ``_bf16`` twins) on N1-row columns of L lanes folding ``n_phase``
    bins, as ``{"tile": lanes a block, "partials": 'shared' (the runs
    form: the run sums go to the block's shared profile) or 'gather' (the
    gather form, where the runs form's widest tile with its partials does
    not fit: the columns into a time-major scratch, then a thread a bin
    and lane sums its rows; the tile is its transform's), "form":
    'register' (the column compiled for its tile at N1 = 512, the
    flagship's and the GUPPI node's) or 'general'}``.
    The form follows from the shape alone (needs the kernels' library,
    so a CUDA machine)."""
    code = library().bbt_k3_form(int(n1), int(L), int(n_phase),
                                 _K3_KINDS[name])
    if code < 0:
        raise ValueError(f"{name}({n1}, {L}, {n_phase}): no kernel takes "
                         f"this shape")
    return {"tile": 1 << (code & 15),
            "partials": "gather" if code & 64 else "shared",
            "form": "register" if code & 32 else "general"}


@functools.lru_cache(maxsize=None)
def _k3_scratch_bytes(name, n1, n2, L, n_phase):
    """Device bytes K3 launch ``name`` of this shape needs as scratch: the
    gather form's, 0 for the runs form."""
    return library().bbt_k3_scratch(n1, n2, L, n_phase, _K3_KINDS[name])


def stage_b_theta(yr, yi, theta):
    """Stage B in place with the chirp as one d-major (N2, N1, L) phase
    plane in cycles: k2_theta on CUDA tensors, else :func:`k2_theta_ref`."""
    if not _on_cuda(yr):
        return k2_theta_ref(yr, yi, theta)
    n2, n1, L = yr.shape
    _check_kernel_geometry(n1, n2)
    dev = yr.device
    for name, t in (("yr", yr), ("yi", yi), ("theta", theta)):
        _check(t, name, torch.float32, (n2, n1, L), dev)
    launch("k2_theta", "bbt_k2_theta", dev, yr.data_ptr(), yi.data_ptr(),
           theta.data_ptr(), n1, n2, L)
    return yr, yi


def _check_planes(zr, zi, allowed=(torch.float32,)):
    """(n1, n2, L, device, dtype) of a d-major plane pair the kernel
    takes: one dtype of ``allowed`` for both."""
    n2, n1, L = zr.shape
    _check_kernel_geometry(n1, n2)
    dev = zr.device
    dt = _pair_dtype(zr, zi, ("zr", "zi"), allowed)
    _check(zr, "zr", dt, (n2, n1, L), dev)
    _check(zi, "zi", dt, (n2, n1, L), dev)
    return n1, n2, L, dev, dt


def k3_power(zr, zi):
    """Inverse stage A (1/N1) and |·|² of d-major (N2, N1, L) planes:
    k3_power on CUDA tensors, else :func:`k3_power_ref`.  Returns the
    (N, L) power in time order."""
    if not _on_cuda(zr):
        return k3_power_ref(zr, zi)
    n1, n2, L, dev, _ = _check_planes(zr, zi)
    out = torch.empty((n1 * n2, L), dtype=torch.float32, device=dev)
    launch("k3_power", "bbt_k3_power", dev, zr.data_ptr(), zi.data_ptr(),
           out.data_ptr(), n1, n2, L)
    return out


def detect_fold(zr, zi, fold, *, n_phase, pad_start, n_valid, stokes=False):
    """Inverse stage A, detection and fold: K3 (k3_fold, or
    k3_fold_stokes; ``*_bf16`` for bfloat16 planes) on CUDA tensors, else
    :func:`fold_ref`.  K3 takes its form from the shape (:func:`k3_form`);
    a launch of the gather form also counts one ``k3_fold_gather``.
    ``fold`` : (3,) int32 ``[i0_fx, p_fx, 0]`` on the planes' device.
    Returns (n_phase+1, L) float32 sums ((n_phase+1, 3L) with ``stokes``)
    and (n_phase+1,) int32 counts."""
    _pair_dtype(zr, zi, ("zr", "zi"))
    if not _on_cuda(zr):
        return fold_ref(zr, zi, fold, n_phase=n_phase, pad_start=pad_start,
                        n_valid=n_valid, stokes=stokes)
    n1, n2, L, dev, dt = _check_planes(zr, zi, _PLANE_DTYPES)
    n_phase = _check_n_phase(n_phase)
    _check(fold, "fold", torch.int32, (3,), dev)
    width = 3 * L if stokes else L
    prof = torch.zeros((n_phase + 1, width), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n_phase + 1,), dtype=torch.int32, device=dev)
    name = ("k3_fold_stokes" if stokes else "k3_fold") + _bf16_suffix(dt)
    nbytes = _k3_scratch_bytes(name, n1, n2, L, n_phase)
    # the gather form's time-major z: the caching allocator hands the same
    # block back on every call of the stream
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=dev)
               if nbytes else None)
    launch(name, f"bbt_{name}", dev, zr.data_ptr(), zi.data_ptr(),
           fold.data_ptr(), prof.data_ptr(), cnt.data_ptr(),
           None if scratch is None else scratch.data_ptr(), n1, n2, L,
           n_phase, int(pad_start), int(n_valid))
    if scratch is not None:
        launch_counts["k3_fold_gather"] += 1
    return prof, cnt


# -- public entry points -------------------------------------------------

def as_tensor(a):
    """A tensor of ``a``; uint32 packed words become their int32 view."""
    t = torch.as_tensor(a)
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _device_of(a):
    """Where an op runs: a tensor argument's device; for numpy, the card
    when there is one, else the CPU (the entry-point rule of
    :class:`~..base.Base`)."""
    if torch.is_tensor(a):
        return a.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _as_device(a, device, dtype):
    """``a`` as a ``dtype`` tensor on ``device``.  A tensor already there
    keeps its strides, so a kernel wrapper refuses a non-contiguous one
    rather than the op copying it; data from elsewhere is copied anyway,
    into a contiguous tensor."""
    t = as_tensor(a)
    if t.device == device:
        return t.to(dtype=dtype)
    return t.to(device=device, dtype=dtype).contiguous()


def _fold_vector(fold, device):
    """The (3,) int32 ``[i0_fx, p_fx, 0]`` fold vector on ``device``."""
    fold = _as_device(fold, device, torch.int32)
    if tuple(fold.shape) != (3,):
        raise ValueError("fold must be a (3,) [i0_fx, p_fx, 0] vector; "
                         "build it with fold_phase_vector()")
    return fold


def _inter_dtype(inter_dtype):
    """The torch dtype of the planes between the passes: 'float32' or
    'bfloat16', as a string or a torch dtype; anything else raises
    ValueError."""
    key = str(inter_dtype).removeprefix("torch.")
    if key not in ("float32", "bfloat16"):
        raise ValueError(f"inter_dtype={inter_dtype!r} must be 'float32' "
                         f"or 'bfloat16'")
    return getattr(torch, key)


def _check_modes(n_phase, pad_start, front, inter_dtype="float32"):
    """(n_phase, intermediate torch dtype) of a split op's arguments."""
    inter = _inter_dtype(inter_dtype)
    if front != pad_start:
        raise ValueError("front buffer length must equal pad_start")
    return _check_n_phase(n_phase), inter


def _chirp_planes(csr, csi, device, inter):
    """The chirp's cos/sin planes on ``device``: a bfloat16 pair stays
    bfloat16 in bf16 mode (stage B widens it on load), anything else is
    float32 (widening a bf16 chirp is exact)."""
    keep = inter == torch.bfloat16 and all(
        torch.is_tensor(c) and c.dtype == torch.bfloat16 for c in (csr, csi))
    dt = torch.bfloat16 if keep else torch.float32
    return _as_device(csr, device, dt), _as_device(csi, device, dt)


def fold_chain(y, chirp_storage_r, chirp_storage_i, fold, *, n_phase,
               pad_start, n_valid, stokes=False):
    """Stage B and fold of stage A's planes ``y`` through the wrappers
    (which dispatch by device); with ``chirp_storage_i`` None,
    ``chirp_storage_r`` is the chirp phase plane in cycles.  Returns the
    (n_phase+1, L or 3L) profile and int32 counts."""
    if chirp_storage_i is None:
        z = stage_b_theta(*y, chirp_storage_r)
    else:
        z = stage_b(*y, chirp_storage_r, chirp_storage_i)
    return detect_fold(*z, fold, n_phase=n_phase, pad_start=pad_start,
                       n_valid=n_valid, stokes=stokes)


def _inverse_pass(y, csr, csi, power):
    """Stage B, then the inverse stage A as |·|² or re/im (N, L)."""
    from .fft import k3_trim        # ops/fft.py imports this module
    z = stage_b(*y, csr, csi)
    return k3_power(*z) if power else k3_trim(*z)


def dedisperse_pow2(xr, xi, chirp_storage_r, chirp_storage_i, *,
                    power=False):
    """Dedispersion y = IFFT(FFT(x) · chirp) of one power-of-two window.

    ``xr``/``xi`` : (N, L) float32 planes; ``chirp_storage_r/i`` : the
    chirp in d-major (N2, N1, L) storage order.  Returns the (N, L)
    power |y|² with ``power``, else the (re, im) planes.  Runs k1_window,
    K2 and k3_power (or k3_trim without pads).
    """
    from .fft import k1_window      # ops/fft.py imports this module
    dev = _device_of(xr)
    n = xr.shape[0]
    if not _is_pow2(n):
        raise ValueError(f"N={n} must be a power of two")
    f32 = [_as_device(a, dev, torch.float32)
           for a in (xr, xi, chirp_storage_r, chirp_storage_i)]
    return _inverse_pass(k1_window(*f32[:2]), f32[2], f32[3], power)


def dedisperse_pow2_planes(x2, chirp_storage_r, chirp_storage_i, *,
                           power=False):
    """As :func:`dedisperse_pow2` from one planes-first (2, N, L) input
    (``x2[0]`` real, ``x2[1]`` imaginary); stage A is k1_planes."""
    dev = _device_of(x2)
    n = x2.shape[1]
    if not _is_pow2(n):
        raise ValueError(f"N={n} must be a power of two")
    f32 = [_as_device(a, dev, torch.float32)
           for a in (x2, chirp_storage_r, chirp_storage_i)]
    return _inverse_pass(stage_a_planes(f32[0]), f32[1], f32[2], power)


def dedisperse_fold_pow2(x2, chirp_storage_r, chirp_storage_i, fold, *,
                         n_phase, pad_start, n_valid, stokes=False):
    """Dedisperse -> detect -> fold one padded planes-first (2, N, L)
    window: k1_planes, K2, K3.  Rows [pad_start, pad_start + n_valid)
    are folded, the others go to trash row n_phase.  Returns the
    (n_phase+1, L, or 3L with ``stokes``) profile and (n_phase+1,) float32
    counts."""
    dev = _device_of(x2)
    n = x2.shape[1]
    if not _is_pow2(n):
        raise ValueError(f"N={n} must be a power of two")
    f32 = [_as_device(a, dev, torch.float32)
           for a in (x2, chirp_storage_r, chirp_storage_i)]
    prof, cnt = fold_chain(stage_a_planes(f32[0]), f32[1], f32[2],
                           _fold_vector(fold, dev),
                           n_phase=_check_n_phase(n_phase),
                           pad_start=int(pad_start), n_valid=int(n_valid),
                           stokes=stokes)
    return prof, cnt.to(torch.float32)


def dedisperse_fold_stream(x2, front, end, chirp_storage_r, chirp_storage_i,
                           fold, scale, *, n_phase, pad_start, n_valid,
                           stokes=False):
    """As :func:`dedisperse_fold_pow2`, the window assembled in stage A
    (k1_stream_planes) from the block ``x2`` : (2, T, L) and the edges
    ``front`` : (2, pad_start, L) and ``end`` : (2, pad_end, L), all
    times ``scale`` ((1,) float32).  Pads and T are non-zero multiples of
    N2 and sum to a power of two.  With ``chirp_storage_i`` None,
    ``chirp_storage_r`` is the chirp phase in cycles (d-major, float32)
    and stage B is k2_theta."""
    dev = _device_of(x2)
    _geometry(x2.shape[1], front.shape[1], end.shape[1])
    n_phase, _ = _check_modes(n_phase, pad_start, front.shape[1])
    csr = _as_device(chirp_storage_r, dev, torch.float32)
    csi = (None if chirp_storage_i is None
           else _as_device(chirp_storage_i, dev, torch.float32))
    f32 = [_as_device(a, dev, torch.float32) for a in (x2, front, end, scale)]
    prof, cnt = fold_chain(stage_a_stream_planes(*f32[:3], f32[3].reshape(1)),
                           csr, csi, _fold_vector(fold, dev), n_phase=n_phase,
                           pad_start=int(pad_start), n_valid=int(n_valid),
                           stokes=stokes)
    return prof, cnt.to(torch.float32)


def dedisperse_fold_split(xr, xi, fr, fi, er, ei, chirp_storage_r,
                          chirp_storage_i, fold, scale, *, n_phase,
                          pad_start, n_valid, stokes=False,
                          inter_dtype="float32"):
    """Dedisperse -> detect -> fold one window from float32 re/im planes.

    ``xr``/``xi`` : (T, L); ``fr``/``fi`` : (pad_start, L); ``er``/``ei``
    : (pad_end, L); ``chirp_storage_r/i`` : (N2, N1, L) d-major chirp;
    ``fold`` : (3,) ``[i0_fx, p_fx, 0]`` (:func:`fold_phase_vector`);
    ``scale`` : (1,) float32 applied to the whole window.  Numpy inputs
    go where ``xr`` goes (:func:`_device_of`).  ``inter_dtype``
    'bfloat16' stores the planes between the passes as bfloat16 (a
    bfloat16 chirp pair is then kept as such).  Returns the (n_phase+1,
    L) profile ((n_phase+1, 3L) with ``stokes``: [|x_l|² | Re x_l conj
    x_{l+1} | Im x_l conj x_{l+1}]) and (n_phase+1,) float32 counts; row
    n_phase holds the halo rows.
    """
    dev = _device_of(xr)
    n_phase, inter = _check_modes(n_phase, pad_start, fr.shape[0],
                                  inter_dtype)
    f32 = [_as_device(a, dev, torch.float32)
           for a in (xr, xi, fr, fi, er, ei, scale)]
    chirp = _chirp_planes(chirp_storage_r, chirp_storage_i, dev, inter)
    y = stage_a(*f32[:6], f32[6].reshape(1), out_dtype=inter)
    prof, cnt = fold_chain(y, *chirp, _fold_vector(fold, dev),
                           n_phase=n_phase, pad_start=int(pad_start),
                           n_valid=int(n_valid), stokes=stokes)
    return prof, cnt.to(torch.float32)


def dedisperse_fold_split_packed(xpr, xpi, fr, fi, er, ei,
                                 chirp_storage_r, chirp_storage_i, fold,
                                 scale, *, n_phase, pad_start, n_valid,
                                 bits=8, offset=None, levels=None,
                                 stokes=False, inter_dtype="float32"):
    """As :func:`dedisperse_fold_split` with the main block as
    plane-packed 1/2/4/8-bit samples.

    ``xpr``/``xpi`` : (T·bits/32, L) int32 words holding the uint32 bit
    patterns (:func:`~.unpack.pack_time_planes`; numpy uint32 is
    accepted).  ``inter_dtype`` as for :func:`dedisperse_fold_split`.  The edges are decoded float32 in the units the in-kernel
    decode produces (``field - offset``, or table levels); a common
    normalization belongs in ``scale``.  8/4-bit use ``offset`` (default
    127.5/7.5); 2-bit maps crumbs through ``levels`` (default VDIF);
    1-bit maps to levels[0]/levels[3] (default ±1).
    """
    if bits not in (1, 2, 4, 8):
        raise ValueError("bits must be 1, 2, 4 or 8")
    dev = _device_of(xpr)
    n_phase, inter = _check_modes(n_phase, pad_start, fr.shape[0],
                                  inter_dtype)
    f32 = [_as_device(a, dev, torch.float32) for a in (fr, fi, er, ei, scale)]
    chirp = _chirp_planes(chirp_storage_r, chirp_storage_i, dev, inter)
    y = stage_a_packed(_as_device(xpr, dev, torch.int32),
                       _as_device(xpi, dev, torch.int32), *f32[:4],
                       f32[4].reshape(1), bits=bits, offset=offset,
                       levels=levels, out_dtype=inter)
    prof, cnt = fold_chain(y, *chirp, _fold_vector(fold, dev),
                           n_phase=n_phase, pad_start=int(pad_start),
                           n_valid=int(n_valid), stokes=stokes)
    return prof, cnt.to(torch.float32)
