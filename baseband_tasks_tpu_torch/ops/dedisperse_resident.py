"""Single-pass fused dedisperse → detect → fold over small windows.

Counterpart of ``baseband_tasks_tpu/ops/dedisperse_resident.py``.  The
three-pass chain of :mod:`.dedisperse` runs its overlap-save window (the
whole block plus pads) through device memory three times, because a
2^18-row window does not fit on chip.  But the window is a choice:
overlap-save is exact for any window that covers the dispersion smear, and
at per-channel rates the smear is often short (DM 500 at 1.4 GHz in a
250 kHz channel ≈ 95 samples).  With a 2048–4096-row window the whole
FFT → chirp → IFFT → detect → fold chain of one window fits in shared
memory, and the block is read about once.

Window ``w`` covers block rows ``[w·hop - pad_start, w·hop + hop +
pad_end)`` with ``hop = n_window - pad_start - pad_end``; the block-edge
windows take their outer rows from the halo buffers.  Fold semantics (the
fixed-point ``[i0, p]`` phase map with t = 0 at the front halo's start,
the trash bin for pad rows, the Stokes lane layout) are those of
:func:`~.dedisperse.dedisperse_fold_split`; the tests compare the two.

On CUDA tensors both engines launch the one Hopper kernel ``resident``
(``csrc/resident.cu``): the JAX engines 'stockham' (butterfly FFTs) and
'mxu' (the stage transforms as DFT matmuls on the TPU's matrix unit)
compute the same function.  On CPU tensors, and inside the test-only
:func:`~.dedisperse.plain_versions`, each engine runs its own plain
version: the four-step FFT form or the DFT-matmul form of the JAX module.
Which form wins on the card against the three-pass chain is measured by
``chip_smoke.py`` phase (m) (PERF.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._build import launch
from .dedisperse import (_as_device, _check, _check_n_phase, _detect,
                         _device_of, _fold_vector, _is_pow2, _on_cuda,
                         _twiddle, fold_bins, fold_detected)

__all__ = ["dedisperse_fold_resident", "dedisperse_fold_resident_ref",
           "resident_geometry"]

#: largest window the kernel takes: one lane's 2^14-row column and its
#: twiddles fill ~190 KB of shared memory
MAX_WINDOW = 1 << 14


def resident_geometry(n_window, pad_start, pad_end):
    """(hop, n1, n2) for a resident window; validates divisibility.

    ``hop = n_window - pad_start - pad_end`` must be a positive multiple
    of both pads (the JAX kernel's neighbour views index the block in
    pad-sized tiles, and the port keeps its contract).
    """
    if not _is_pow2(n_window):
        raise ValueError(f"n_window={n_window} must be a power of two")
    hop = n_window - pad_start - pad_end
    if hop <= 0:
        raise ValueError("pads leave no valid samples in the window")
    for name, p in (("pad_start", pad_start), ("pad_end", pad_end)):
        if p <= 0 or hop % p:
            raise ValueError(f"{name}={p} must be a positive divisor "
                             f"of hop={hop}")
    k = n_window.bit_length() - 1
    n1 = 1 << (k // 2)
    return hop, n1, n_window // n1


@functools.lru_cache(maxsize=None)
def _dft_mats_np(n, sign, scale=1.0):
    """(2, n, n) float32 [cos, sin] planes of scale·exp(sign·2πi jk/n)."""
    th = sign * 2.0 * np.pi / n * np.outer(np.arange(n), np.arange(n))
    return np.stack([np.cos(th) * scale,
                     np.sin(th) * scale]).astype(np.float32)


# -- plain PyTorch versions ----------------------------------------------

def _windows(xr, xi, fr, fi, er, ei, scale, n_window, hop):
    """(n_w, n_window, L) complex windows of [front | block | end]·scale."""
    padded = torch.complex(torch.cat([fr, xr, er]) * scale,
                           torch.cat([fi, xi, ei]) * scale)
    return padded.unfold(0, n_window, hop).permute(0, 2, 1)


def _fft_convolve(win, chirp, n1, n2):
    """Four-step y = IFFT(FFT(x)·chirp) of (n_w, N, L) windows, the chirp
    (n2, n1, L) in d-major storage order (``_window_fft_convolve``)."""
    nw, n, L = win.shape
    dev = win.device
    a = torch.fft.fft(win.reshape(nw, n1, n2, L), dim=1)        # over c
    y = (a * _twiddle(n1, n2, -1, dev)[:, :, None]).transpose(1, 2)
    b = torch.fft.fft(y, dim=1) * chirp                          # b -> d
    z = torch.fft.ifft(b, dim=1) * _twiddle(n1, n2, +1, dev).T[:, :, None]
    return torch.fft.ifft(z.transpose(1, 2), dim=1).reshape(nw, n, L)


def _cmm(f, xr, xi):
    """Apply a (2, n, n) complex DFT matrix to (..., n, K) complex planes."""
    fr, fi = f[0], f[1]
    return fr @ xr - fi @ xi, fr @ xi + fi @ xr


def _plane_twiddle(rows, cols, sign, n, device):
    """float32 cos/sin of sign·2π·r·c/n over an (rows, cols, 1) grid, the
    angle formed in float32 as the JAX module forms it."""
    r = torch.arange(rows, dtype=torch.float32, device=device)[:, None, None]
    c = torch.arange(cols, dtype=torch.float32, device=device)[None, :, None]
    theta = (sign * 2.0 * np.pi / n) * r * c
    return torch.cos(theta), torch.sin(theta)


def _dft_convolve(win, cr, ci, n1, n2):
    """y = IFFT(FFT(x)·chirp) of (n_w, N, L) windows with each stage
    transform a dense DFT matmul (``_window_dft_convolve``)."""
    nw, n, L = win.shape
    dev = win.device
    fa, fb, ia, ib = (torch.as_tensor(_dft_mats_np(*a), device=dev) for a in
                      ((n1, -1.0), (n2, -1.0), (n1, 1.0, 1.0 / n1),
                       (n2, 1.0, 1.0 / n2)))
    ar, ai = _cmm(fa, win.real.reshape(nw, n1, n2 * L),
                  win.imag.reshape(nw, n1, n2 * L))
    ar, ai = ar.reshape(nw, n1, n2, L), ai.reshape(nw, n1, n2, L)
    wr, wi = _plane_twiddle(n1, n2, -1.0, n, dev)
    yr = (ar * wr - ai * wi).transpose(1, 2).reshape(nw, n2, n1 * L)
    yi = (ar * wi + ai * wr).transpose(1, 2).reshape(nw, n2, n1 * L)
    br, bi = _cmm(fb, yr, yi)
    br, bi = br.reshape(nw, n2, n1, L), bi.reshape(nw, n2, n1, L)
    mr = br * cr - bi * ci
    mi = br * ci + bi * cr
    br, bi = _cmm(ib, mr.reshape(nw, n2, n1 * L), mi.reshape(nw, n2, n1 * L))
    br, bi = br.reshape(nw, n2, n1, L), bi.reshape(nw, n2, n1, L)
    w2r, w2i = _plane_twiddle(n2, n1, 1.0, n, dev)
    zr = (br * w2r - bi * w2i).transpose(1, 2).reshape(nw, n1, n2 * L)
    zi = (br * w2i + bi * w2r).transpose(1, 2).reshape(nw, n1, n2 * L)
    or_, oi_ = _cmm(ia, zr, zi)
    return torch.complex(or_.reshape(nw, n, L), oi_.reshape(nw, n, L))


def dedisperse_fold_resident_ref(xr, xi, fr, fi, er, ei, chirp_storage_r,
                                 chirp_storage_i, fold, scale, *, n_window,
                                 n_phase, pad_start, pad_end, stokes=False,
                                 engine="stockham"):
    """Plain version of :func:`dedisperse_fold_resident` on tensors of one
    device: every window at once through the four-step FFT form
    ('stockham') or the DFT-matmul form ('mxu'), then the three-pass
    chain's detection, bin map and one-hot fold.  Returns the (n_phase+1,
    L or 3L) profile and (n_phase+1,) int32 counts."""
    hop, n1, n2 = resident_geometry(n_window, pad_start, pad_end)
    win = _windows(xr, xi, fr, fi, er, ei, scale, n_window, hop)
    if engine == "mxu":
        y = _dft_convolve(win, chirp_storage_r, chirp_storage_i, n1, n2)
    else:
        y = _fft_convolve(win, torch.complex(chirp_storage_r,
                                             chirp_storage_i), n1, n2)
    nw, n, L = y.shape
    r = torch.arange(n, dtype=torch.int64, device=y.device)
    t = (torch.arange(nw, dtype=torch.int64, device=y.device)[:, None] * hop
         + r[None]).reshape(-1)
    valid = ((r >= pad_start) & (r < pad_start + hop)).repeat(nw)
    return fold_detected(_detect(y.reshape(nw * n, L), stokes),
                         fold_bins(fold, t, valid, n_phase), n_phase)


# -- public entry point --------------------------------------------------

def dedisperse_fold_resident(xr, xi, fr, fi, er, ei, chirp_storage_r,
                             chirp_storage_i, fold, scale, *, n_window,
                             n_phase, pad_start, pad_end, stokes=False,
                             engine="stockham"):
    """Single-pass fused dedisperse → detect → fold over small windows.

    Parameters
    ----------
    xr, xi : (T, L) float32
        Block planes; ``T`` must be a multiple of
        ``hop = n_window - pad_start - pad_end``.
    fr, fi : (pad_start, L); er, ei : (pad_end, L)
        Halo edges for the block's outermost windows.
    chirp_storage_r/i : (N2, N1, L) float32
        Chirp for the *window* length in d-major storage order
        (:func:`~.dedisperse.permute_to_storage_order`).
    fold : (3,) int32 ``[i0_fx, p_fx, 0]``
        Fixed-point phase map with t = 0 at the front-halo start
        (:func:`~.dedisperse.fold_phase_vector`).
    scale : (1,) float32
        Input scale applied during window assembly.
    engine : 'stockham' or 'mxu'
        The JAX module's window-FFT forms; on the card both run the one
        kernel, on the CPU each its own plain version.

    Numpy inputs go where ``xr`` goes (the card when there is one, a
    tensor's own device).  Returns
    ``(profile (n_phase+1, L or 3L), counts (n_phase+1,))`` as float32;
    row ``n_phase`` is the pad trash bin.
    """
    if engine not in ("stockham", "mxu"):
        raise ValueError(f"engine={engine!r} must be 'stockham' or 'mxu'")
    hop, n1, n2 = resident_geometry(n_window, pad_start, pad_end)
    T, L = xr.shape
    if T % hop:
        raise ValueError(f"block length {T} must be a multiple of "
                         f"hop={hop}")
    if tuple(fr.shape) != (pad_start, L) or tuple(er.shape) != (pad_end, L):
        raise ValueError("halo buffers must be (pad_start, L)/(pad_end, L)")
    if tuple(chirp_storage_r.shape) != (n2, n1, L):
        raise ValueError(f"chirp storage must be ({n2}, {n1}, {L})")
    n_phase = _check_n_phase(n_phase)
    dev = _device_of(xr)
    f32 = [_as_device(a, dev, torch.float32)
           for a in (xr, xi, fr, fi, er, ei, chirp_storage_r,
                     chirp_storage_i, scale)]
    fold = _fold_vector(fold, dev)
    scale = f32[8].reshape(1)
    if not _on_cuda(f32[0]):
        prof, cnt = dedisperse_fold_resident_ref(
            *f32[:8], fold, scale, n_window=n_window, n_phase=n_phase,
            pad_start=pad_start, pad_end=pad_end, stokes=stokes,
            engine=engine)
        return prof, cnt.to(torch.float32)
    if n_window > MAX_WINDOW:
        raise ValueError(f"n_window={n_window} exceeds the kernel's "
                         f"shared-memory column (max {MAX_WINDOW})")
    for name, t, shape in (("xr", f32[0], (T, L)), ("xi", f32[1], (T, L)),
                           ("fr", f32[2], (pad_start, L)),
                           ("fi", f32[3], (pad_start, L)),
                           ("er", f32[4], (pad_end, L)),
                           ("ei", f32[5], (pad_end, L)),
                           ("chirp_storage_r", f32[6], (n2, n1, L)),
                           ("chirp_storage_i", f32[7], (n2, n1, L))):
        _check(t, name, torch.float32, shape, dev)
    _check(scale, "scale", torch.float32, (1,), dev)
    width = 3 * L if stokes else L
    prof = torch.zeros((n_phase + 1, width), dtype=torch.float32, device=dev)
    cnt = torch.zeros((n_phase + 1,), dtype=torch.int32, device=dev)
    launch("resident", "bbt_resident", dev,
           *(t.data_ptr() for t in f32[:8]), fold.data_ptr(),
           scale.data_ptr(), prof.data_ptr(), cnt.data_ptr(), n_window, L,
           int(pad_start), int(pad_end), T, n_phase, int(bool(stokes)))
    return prof, cnt.to(torch.float32)
