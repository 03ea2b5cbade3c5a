"""Fused z-template bank correlation for the acceleration search.

Counterpart of ``baseband_tasks_tpu/ops/accel_correlate.py``: the two
device kernels of ``models/accelsearch.py``, each with a wrapper and a
plain PyTorch version (``*_ref``) of the same function.

- :func:`bank_matmul_power` (engine 'mx'): the overlap-save correlation of
  every spectrum segment with every template as one bank product against
  the banded Karatsuba operator planes, ``t = (fr+fi)@ka``, ``u = fi@kb``,
  ``v = fr@kc``, and the power ``(t-u)² + (t+v)²``; the three products
  never reach device memory.  Launch ``bank_power`` (``csrc/accel.cu``,
  3xTF32 on the tensor cores).
- :func:`accel_correlate_bank` (engine 'pallas'): per segment spectrum,
  ``|IFFT(spec · tf[:, z])|²`` over a 128-lane z bank, trimmed to the
  first ``valid`` lags; the complex products stay on chip (registers and
  shared memory).  Launch ``accel_corr`` (``csrc/accel.cu``), which reads
  the bank lane-major (:func:`_lane_major`, built once per bank) and can
  stop at the used lanes (:func:`_accel_correlate_lanes`, the search's
  path: its pad lanes hold zero templates, so their power is zero).

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version (as does every wrapper inside the
test-only :func:`~.dedisperse.plain_versions`).  The argument and output
shapes and the validation are the JAX package's, so both packages accept
the same arguments and the search pads as the JAX search does.

Reference scope: the correlation of Ransom, Eikenberry & Middleditch
(2002) §3; the reference package has no searching.
"""

from __future__ import annotations

import torch

from ._build import kernel_tile, launch
from .dedisperse import _as_device, _check, _device_of, _is_pow2, _on_cuda
from .tf32 import cached, pack_operand

__all__ = ["accel_correlate_bank", "accel_correlate_bank_ref",
           "bank_matmul_power", "bank_matmul_power_ref", "LANES",
           "MAX_SEG_LEN"]

#: width of the z bank; unused lanes hold zero templates (zero power)
LANES = 128

#: largest segment :func:`accel_correlate_bank` takes: the JAX package's
#: limit, kept so both packages accept the same arguments.  On the card a
#: block holds the exchanges of two 4096-row columns (70 KB), their
#: twiddle tables (35 KB) and the power of eight lanes' rows (up to 120
#: KB; four lanes' when more rows are kept) in the 227 KB a block may use.
MAX_SEG_LEN = 4096

# bank_power's contraction step (one k8 MMA)
_BK = 8


def accel_correlate_bank_ref(segs, tf_r, tf_i, *, valid):
    """Plain version of :func:`accel_correlate_bank` (torch.fft)."""
    prod = segs[:, :, None] * torch.complex(tf_r, tf_i)[None]
    corr = torch.fft.ifft(prod, dim=1)[:, :valid]
    return corr.real * corr.real + corr.imag * corr.imag


def _accel_correlate_lanes_ref(segs, tf_r, tf_i, *, valid, n_used):
    """Plain version of :func:`_accel_correlate_lanes`."""
    return accel_correlate_bank_ref(segs, tf_r[:, :n_used], tf_i[:, :n_used],
                                    valid=valid)


def _lane_major(tf_r, tf_i):
    """The bank as ``accel_corr`` reads it: (LANES, seg_len) complex64,
    each lane's coefficients one contiguous run; built once per pair of
    bank tensors (and again after either is changed in place)."""
    return cached((tf_r, tf_i),
                  lambda: torch.complex(tf_r, tf_i).T.contiguous())


def accel_correlate_bank(segs, tf_r, tf_i, *, valid):
    """Correlate spectrum segments against a z-template bank, fused.

    Parameters
    ----------
    segs : (n_seg, seg_len) complex64
        Forward FFTs of the overlap-save segments of the normalized
        spectrum.
    tf_r, tf_i : (seg_len, LANES) float32
        Conjugated template transfer functions, one per lane (unused
        lanes zero).
    valid : int
        Correlation lags to keep per segment (seg_len - template span).

    Returns the (n_seg, valid, LANES) float32 power map
    ``|IFFT(segs[s] · tf[:, z])|²``, the inverse FFT scaled by 1/seg_len.
    ``seg_len`` must be a power of two no larger than ``MAX_SEG_LEN``.
    The kernel computes every lane (zero templates give zero power).
    """
    return _accel_correlate_lanes(segs, tf_r, tf_i, valid=valid,
                                  n_used=LANES)


def _accel_correlate_lanes(segs, tf_r, tf_i, *, valid, n_used):
    """:func:`accel_correlate_bank` for the first ``n_used`` lanes only:
    the (n_seg, valid, n_used) power map, the search's path (the lanes
    past its templates hold zero templates, so their power is zero and
    is neither computed nor written)."""
    dev = _device_of(segs)
    segs = _as_device(segs, dev, torch.complex64)
    tf_r, tf_i = (_as_device(t, dev, torch.float32) for t in (tf_r, tf_i))
    n_seg, seg_len = segs.shape
    if not _is_pow2(seg_len):
        raise ValueError(f"seg_len {seg_len} must be a power of two")
    if seg_len > MAX_SEG_LEN:
        raise ValueError(
            f"seg_len {seg_len} exceeds the kernel's shared-memory budget "
            f"(max {MAX_SEG_LEN}: a block holds the exchanges of its "
            f"columns and the power of a tile of z lanes in shared memory). "
            f"Use a seg_len <= {MAX_SEG_LEN} window — the trimmed-output "
            "traffic is the same.")
    if tuple(tf_r.shape) != (seg_len, LANES):
        raise ValueError(f"bank planes must be ({seg_len}, {LANES}), "
                         f"got {tuple(tf_r.shape)}")
    if not 0 < valid <= seg_len:
        raise ValueError(f"valid {valid} out of range")
    if not 0 < n_used <= LANES:
        raise ValueError(f"n_used {n_used} out of range (1..{LANES})")
    if not _on_cuda(segs):
        return _accel_correlate_lanes_ref(segs, tf_r, tf_i, valid=valid,
                                          n_used=n_used)
    if seg_len < 2:
        raise ValueError("the kernel needs seg_len >= 2")
    _check(segs, "segs", torch.complex64, (n_seg, seg_len), dev)
    _check(tf_r, "tf_r", torch.float32, (seg_len, LANES), dev)
    _check(tf_i, "tf_i", torch.float32, (seg_len, LANES), dev)
    bank = _lane_major(tf_r, tf_i)
    # rows padded to whole 32-byte sectors (zeros past n_used): the map
    # is a view of them, and its (n_seg * valid, n_used) reshape too
    n_out = _sector_lanes(n_used)
    out = torch.empty((n_seg, valid, n_out), dtype=torch.float32,
                      device=dev)
    launch("accel_corr", "bbt_accel_corr", dev, segs.data_ptr(),
           bank.data_ptr(), out.data_ptr(), n_seg, seg_len, LANES,
           int(n_used), n_out, int(valid))
    return out[..., :n_used]


def _sector_lanes(n_used):
    """Lanes of a stored map row: ``n_used`` rounded up to a multiple of
    8 (one 32-byte sector of float32)."""
    return -(-int(n_used) // 8) * 8


def bank_matmul_power_ref(fr, fi, ka, kb, kc):
    """Plain version of :func:`bank_matmul_power` (torch.matmul, at
    PyTorch's float32 matmul precision: full float32 unless a caller
    allows TF32)."""
    t = (fr + fi) @ ka
    cr = t - fi @ kb
    ci = t + fr @ kc
    return cr * cr + ci * ci


def bank_matmul_power(fr, fi, ka, kb, kc, *, seg_tile=256, col_tile=512):
    """Fused Karatsuba bank correlation + power for the search's mx engine.

    fr, fi : (n_seg, L) float32 segment planes (``n_seg % seg_tile == 0``;
        the caller pads segments, and the padded rows are trimmed by its
        final slice).
    ka, kb, kc : (L, n_cols) float32 Karatsuba operator planes, columns in
        flattened (lag, z) order (``n_cols % col_tile == 0``; extra
        columns zero).

    Returns the (n_seg, n_cols) power ``|sum_f seg[s, f] M[f, kz]|²``.
    ``seg_tile``/``col_tile`` are the JAX package's tiles, kept as the
    shape contract; the kernel (3xTF32 on the tensor cores, float32-class,
    ``ops/tf32.py``) masks its own tile edges and needs ``L`` a multiple
    of 8.  The operator is split and staged once per (ka, kb, kc) tensors
    (``ops/tf32.py``).
    """
    dev = _device_of(fr)
    fr, fi, ka, kb, kc = (_as_device(t, dev, torch.float32)
                          for t in (fr, fi, ka, kb, kc))
    n_seg, L = fr.shape
    n_cols = ka.shape[1]
    if n_seg % seg_tile or n_cols % col_tile:
        raise ValueError(f"shapes ({n_seg}, {n_cols}) must tile by "
                         f"({seg_tile}, {col_tile})")
    if tuple(ka.shape) != (L, n_cols):
        raise ValueError(f"operator planes must be ({L}, {n_cols})")
    if not _on_cuda(fr):
        return bank_matmul_power_ref(fr, fi, ka, kb, kc)
    if L % _BK:
        raise ValueError(f"the bank_power kernel tiles the contraction by "
                         f"{_BK}: L={L} must be a multiple of it")
    for name, t, shape in (("fr", fr, (n_seg, L)), ("fi", fi, (n_seg, L)),
                           ("ka", ka, (L, n_cols)), ("kb", kb, (L, n_cols)),
                           ("kc", kc, (L, n_cols))):
        _check(t, name, torch.float32, shape, dev)
    for name, t in (("fr", fr), ("fi", fi)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    tile = kernel_tile("bbt_bank_power_tile")
    kp = cached((ka, kb, kc), lambda: pack_operand([ka, kb, kc], *tile))
    out = torch.empty((n_seg, n_cols), dtype=torch.float32, device=dev)
    launch("bank_power", "bbt_bank_power", dev, fr.data_ptr(), fi.data_ptr(),
           kp.data_ptr(), out.data_ptr(), n_seg, L, n_cols)
    return out
