"""Fused coherent dedispersion -> detection -> fold for one window.

Counterpart of the flagship path of
``baseband_tasks_tpu/ops/dedisperse_pallas.py``.  The overlap-save window
of N = N1·N2 samples (powers of two) over L lanes runs through a four-step
FFT in three passes, with frequency bins in d-major storage order
(d, c) <-> k = d·N1 + c between them, so no transpose reaches memory:

- **stage A** (K1): assemble the window from the front edge, the main
  block (float32 planes, or plane-packed 1/2/4/8-bit words decoded in the
  pass) and the end edge; scale; FFT over the N1 rows; twiddle
  W_N^{-c b}; store d-major (N2, N1, L).
- **stage B** (K2): FFT over N2, multiply by the chirp planes, inverse FFT
  with 1/N2, twiddle W_N^{+c b}; in place.
- **fold** (K3): inverse stage A with 1/N1, detect |z|², bin pulse phase
  in 31-bit fixed point, fold into an (n_phase+1, L) profile whose last
  row is the trash bin of the halo rows, with integer counts.

Each stage has a wrapper and a plain PyTorch version (``*_ref``) that
produces the same layout.  A wrapper given CUDA tensors launches its
hand-written Hopper kernel (``csrc/dedisperse.cu``) or raises; given CPU
tensors it runs the plain version.  Each launch adds one to
:data:`launch_counts` (shared with ``ops/fft.py``, in ``ops/_build.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._build import launch, launch_counts, reset_launch_counts
from .fold import fold_accumulate
from .unpack import decode_planes, default_levels, default_offset

__all__ = ["split_n", "permute_to_storage_order", "fold_phase_vector",
           "fold_bins_ref", "stage_a_packed", "stage_a", "stage_b",
           "detect_fold", "stage_a_packed_ref", "stage_a_ref",
           "stage_b_ref", "fold_ref", "dedisperse_fold_split",
           "dedisperse_fold_split_packed", "fold_chain", "as_tensor",
           "launch_counts", "reset_launch_counts"]

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


def stage_a_ref(xr, xi, fr, fi, er, ei, scale):
    """Plain stage A: window -> FFT over c -> W_N^{-c b} -> d-major
    (N2, N1, L) re/im planes."""
    n1, n2 = _geometry(xr.shape[0], fr.shape[0], er.shape[0])
    L = xr.shape[1]
    w = torch.complex(torch.cat([fr, xr, er]) * scale,
                      torch.cat([fi, xi, ei]) * scale).reshape(n1, n2, L)
    y = torch.fft.fft(w, dim=0) * _twiddle(n1, n2, -1, w.device)[:, :, None]
    y = y.transpose(0, 1)
    return y.real.contiguous(), y.imag.contiguous()


def stage_a_packed_ref(xpr, xpi, fr, fi, er, ei, scale, *, bits,
                       offset=None, levels=None):
    """Plain stage A from plane-packed int32 words (decode, then
    :func:`stage_a_ref`)."""
    return stage_a_ref(decode_planes(xpr, bits, offset, levels),
                       decode_planes(xpi, bits, offset, levels),
                       fr, fi, er, ei, scale)


def stage_b_ref(yr, yi, csr, csi):
    """Plain stage B, in place on the d-major (N2, N1, L) planes."""
    n2, n1, _ = yr.shape
    y = torch.fft.fft(torch.complex(yr, yi), dim=0) * torch.complex(csr, csi)
    z = torch.fft.ifft(y, dim=0) * _twiddle(n1, n2, +1, y.device).T[:, :, None]
    yr.copy_(z.real)
    yi.copy_(z.imag)
    return yr, yi


def fold_ref(zr, zi, fold, *, n_phase, pad_start, n_valid):
    """Plain fold: inverse stage A -> |z|² -> fixed-point bins (int64,
    masked) -> one-hot fold.  Returns the (n_phase+1, L) float32 profile
    and (n_phase+1,) int32 counts; row n_phase is the trash bin."""
    n2, n1, L = zr.shape
    n = n1 * n2
    x = torch.fft.ifft(torch.complex(zr, zi).transpose(0, 1), dim=0)
    x = x.reshape(n, L)
    power = x.real * x.real + x.imag * x.imag
    t = torch.arange(n, dtype=torch.int64, device=zr.device)
    f = fold.to(torch.int64)
    num = (f[0] + t * f[1]) & _FX_MASK
    bins = (((num >> 16) * n_phase) + (((num & 0xFFFF) * n_phase) >> 16)) >> 15
    valid = (t >= pad_start) & (t < pad_start + n_valid)
    bins = torch.where(valid, bins, n_phase)
    prof = fold_accumulate(power, bins, n_phase + 1, with_counts=False)
    cnt = torch.bincount(bins, minlength=n_phase + 1).to(torch.int32)
    return prof, cnt


# -- kernel wrappers -----------------------------------------------------

def _on_cuda(x):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
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
                   levels=None):
    """Stage A from plane-packed words: K1p on CUDA tensors, else
    :func:`stage_a_packed_ref`.

    ``xpr``/``xpi`` : (T·bits/32, L) int32 words; ``fr``/``fi`` :
    (pad_start, L) and ``er``/``ei`` : (pad_end, L) float32 decoded edges;
    ``scale`` : (1,) float32.  Returns d-major (N2, N1, L) planes.
    """
    if not _on_cuda(xpr):
        return stage_a_packed_ref(xpr, xpi, fr, fi, er, ei, scale,
                                  bits=bits, offset=offset, levels=levels)
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
    yr = torch.empty((n2, n1, L), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    launch("k1_packed", "bbt_k1_packed", dev, xpr.data_ptr(),
            xpi.data_ptr(), fr.data_ptr(), fi.data_ptr(), er.data_ptr(),
            ei.data_ptr(), scale.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            n1, n2, L, kf, ke, bits, float(offset), *map(float, lv))
    return yr, yi


def stage_a(xr, xi, fr, fi, er, ei, scale):
    """Stage A from float32 (T, L) planes: K1f on CUDA tensors, else
    :func:`stage_a_ref`."""
    if not _on_cuda(xr):
        return stage_a_ref(xr, xi, fr, fi, er, ei, scale)
    t_main, L = xr.shape
    n1, n2 = _geometry(t_main, fr.shape[0], er.shape[0])
    _check_kernel_geometry(n1, n2)
    dev = xr.device
    _check(xr, "xr", torch.float32, (t_main, L), dev)
    _check(xi, "xi", torch.float32, (t_main, L), dev)
    _check_edges(fr, fi, er, ei, scale, L, dev)
    yr = torch.empty((n2, n1, L), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    launch("k1_float", "bbt_k1_float", dev, xr.data_ptr(), xi.data_ptr(),
            fr.data_ptr(), fi.data_ptr(), er.data_ptr(), ei.data_ptr(),
            scale.data_ptr(), yr.data_ptr(), yi.data_ptr(), n1, n2, L,
            fr.shape[0] // n2, er.shape[0] // n2)
    return yr, yi


def stage_b(yr, yi, csr, csi):
    """Stage B in place on d-major (N2, N1, L) planes: K2 on CUDA
    tensors, else :func:`stage_b_ref`."""
    if not _on_cuda(yr):
        return stage_b_ref(yr, yi, csr, csi)
    n2, n1, L = yr.shape
    _check_kernel_geometry(n1, n2)
    dev = yr.device
    for name, t in (("yr", yr), ("yi", yi), ("csr", csr), ("csi", csi)):
        _check(t, name, torch.float32, (n2, n1, L), dev)
    launch("k2", "bbt_k2", dev, yr.data_ptr(), yi.data_ptr(),
            csr.data_ptr(), csi.data_ptr(), n1, n2, L)
    return yr, yi


def detect_fold(zr, zi, fold, *, n_phase, pad_start, n_valid):
    """Inverse stage A, detection and fold: K3 on CUDA tensors, else
    :func:`fold_ref`.  ``fold`` : (3,) int32 ``[i0_fx, p_fx, 0]`` on the
    planes' device.  Returns (n_phase+1, L) float32 sums and
    (n_phase+1,) int32 counts."""
    if not _on_cuda(zr):
        return fold_ref(zr, zi, fold, n_phase=n_phase, pad_start=pad_start,
                        n_valid=n_valid)
    n2, n1, L = zr.shape
    _check_kernel_geometry(n1, n2)
    n_phase = _check_n_phase(n_phase)
    dev = zr.device
    _check(zr, "zr", torch.float32, (n2, n1, L), dev)
    _check(zi, "zi", torch.float32, (n2, n1, L), dev)
    _check(fold, "fold", torch.int32, (3,), dev)
    prof = torch.zeros((n_phase + 1, L), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n_phase + 1,), dtype=torch.int32, device=dev)
    launch("k3_fold", "bbt_k3_fold", dev, zr.data_ptr(), zi.data_ptr(),
            fold.data_ptr(), prof.data_ptr(), cnt.data_ptr(), n1, n2, L,
            n_phase, int(pad_start), int(n_valid))
    return prof, cnt


# -- public entry points -------------------------------------------------

def as_tensor(a):
    """A tensor of ``a``; uint32 packed words become their int32 view."""
    t = torch.as_tensor(a)
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _as_device(a, device, dtype):
    return as_tensor(a).to(device=device, dtype=dtype).contiguous()


def _check_modes(n_phase, pad_start, front, stokes, inter_dtype):
    if stokes:
        raise NotImplementedError("Stokes detection is not ported yet")
    if str(inter_dtype) != "float32":
        raise NotImplementedError("only float32 intermediates are ported")
    if front != pad_start:
        raise ValueError("front buffer length must equal pad_start")
    return _check_n_phase(n_phase)


def fold_chain(y, chirp_storage_r, chirp_storage_i, fold, *, n_phase,
               pad_start, n_valid, kernels=True):
    """Stage B and fold of stage A's planes ``y``: the wrappers (which
    dispatch by device) with ``kernels``, else the plain versions.
    Returns the (n_phase+1, L) profile and int32 counts."""
    sb, fd = (stage_b, detect_fold) if kernels else (stage_b_ref, fold_ref)
    z = sb(*y, chirp_storage_r, chirp_storage_i)
    return fd(*z, fold, n_phase=n_phase, pad_start=pad_start,
              n_valid=n_valid)


def dedisperse_fold_split(xr, xi, fr, fi, er, ei, chirp_storage_r,
                          chirp_storage_i, fold, scale, *, n_phase,
                          pad_start, n_valid, stokes=False,
                          inter_dtype="float32"):
    """Dedisperse -> detect -> fold one window from float32 re/im planes.

    ``xr``/``xi`` : (T, L); ``fr``/``fi`` : (pad_start, L); ``er``/``ei``
    : (pad_end, L); ``chirp_storage_r/i`` : (N2, N1, L) d-major chirp;
    ``fold`` : (3,) ``[i0_fx, p_fx, 0]`` (:func:`fold_phase_vector`);
    ``scale`` : (1,) float32 applied to the whole window.  Numpy inputs
    are taken to the device of ``xr`` (the CPU for numpy).  Returns the
    (n_phase+1, L) profile and (n_phase+1,) float32 counts; row n_phase
    holds the halo rows.  The TPU tiling knobs (``block_b``,
    ``block_c``, ``interpret``) have no counterpart here.
    """
    dev = xr.device if torch.is_tensor(xr) else torch.device("cpu")
    n_phase = _check_modes(n_phase, pad_start, fr.shape[0], stokes,
                           inter_dtype)
    f32 = [_as_device(a, dev, torch.float32)
           for a in (xr, xi, fr, fi, er, ei, chirp_storage_r,
                     chirp_storage_i, scale)]
    y = stage_a(*f32[:6], f32[8].reshape(1))
    prof, cnt = fold_chain(y, f32[6], f32[7],
                           _as_device(fold, dev, torch.int32),
                           n_phase=n_phase, pad_start=int(pad_start),
                           n_valid=int(n_valid))
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
    accepted).  The edges are decoded float32 in the units the in-kernel
    decode produces (``field - offset``, or table levels); a common
    normalization belongs in ``scale``.  8/4-bit use ``offset`` (default
    127.5/7.5); 2-bit maps crumbs through ``levels`` (default VDIF);
    1-bit maps to levels[0]/levels[3] (default ±1).
    """
    if bits not in (1, 2, 4, 8):
        raise ValueError("bits must be 1, 2, 4 or 8")
    dev = xpr.device if torch.is_tensor(xpr) else torch.device("cpu")
    n_phase = _check_modes(n_phase, pad_start, fr.shape[0], stokes,
                           inter_dtype)
    f32 = [_as_device(a, dev, torch.float32)
           for a in (fr, fi, er, ei, chirp_storage_r, chirp_storage_i,
                     scale)]
    y = stage_a_packed(_as_device(xpr, dev, torch.int32),
                       _as_device(xpi, dev, torch.int32), *f32[:4],
                       f32[6].reshape(1), bits=bits, offset=offset,
                       levels=levels)
    prof, cnt = fold_chain(y, f32[4], f32[5],
                           _as_device(fold, dev, torch.int32),
                           n_phase=n_phase, pad_start=int(pad_start),
                           n_valid=int(n_valid))
    return prof, cnt.to(torch.float32)
