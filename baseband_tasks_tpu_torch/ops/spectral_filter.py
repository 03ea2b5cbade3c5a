"""Overlap-save spectral filtering of a power-of-two window, with lane
mixing.

Counterpart of ``baseband_tasks_tpu/ops/spectral_filter.py``:

    y = trim( IFFT_k( FFT_k(window · pre) * G[k, lane] ) ) · post

with the FFT along axis 0 (time rows), ``G`` an arbitrary complex gain
per (frequency, lane) (a dedispersion chirp, a Wiener gain, a response)
and ``pre``/``post`` optional complex (L, L) lane-mixing matrices (a
Dechannelize's inverse DFT folded into the filter by the compiled
pipelines).  On the kernels it is three passes of the four-step FFT:

- stage A: ``k1_window`` of a whole padded window, or ``k1_stream`` of
  the streaming window [carry | block] with a per-iteration scale on the
  block rows only (the carry holds the previous block's already-scaled
  rows);
- K2 (``ops/dedisperse.stage_b``): stage B, times the gain, inverse
  stage B;
- ``k3_trim``: inverse stage A, storing only the rows outside the
  overlap-save pads (multiples of N2, ``split_n``);

and ``lane_mix`` for ``pre`` (right after stage A: a lane mix commutes
with the row FFT and twiddle) and ``post`` (after k3_trim).  The TPU
kernels hold all L lanes of a row block and mix inside the first and last
kernel; the passes here hold a column for a tile of <= 16 lanes, so the
mix is a pass of its own (``csrc/fourstep.cu`` lane_mix: one real GEMM
in 3xTF32 on the tensor cores, ``csrc/tf32mma.cuh``, against the mixer
staged once per mixer tensor by ``ops/tf32.py``).  Each pass has a plain
PyTorch version; a wrapper given CUDA tensors launches its kernel or
raises, given CPU tensors it runs the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import kernel_tile, launch
from .dedisperse import (_as_device, _check, _device_of, _is_pow2, _on_cuda,
                         split_n, stage_b)
from .dft_matmul import device_mats
from .fft import _pad_rows, _window_split, k1_stream, k1_window, k3_trim
from .tf32 import cached, mix_operand, pack_operand

__all__ = ["spectral_filter_pow2", "spectral_filter_pow2_ref",
           "spectral_filter_stream", "spectral_filter_stream_ref",
           "lane_mix", "lane_mix_ref", "geometry_ok", "lane_dft_mats",
           "expand_lane_mats"]

#: widest lane axis the lane mixes and the forward PFB's DFT take
#: (``kMaxMixLanes``, ``csrc/tf32mma.cuh``)
MAX_MIX_LANES = 1600


def lane_dft_mats(n, *, inverse=True):
    """(wr, wi) float32 planes of the (n, n) DFT / inverse-DFT matrix
    W[j, k] = exp(∓2πi j k / n) (/n for the inverse), a lane mixer."""
    sign = 2.0 if inverse else -2.0
    theta = sign * np.pi / n * np.outer(np.arange(n), np.arange(n))
    scale = 1.0 / n if inverse else 1.0
    return ((np.cos(theta) * scale).astype(np.float32),
            (np.sin(theta) * scale).astype(np.float32))


def expand_lane_mats(mats, reps):
    """Expand (n, n) lane matrices to (n·reps, n·reps) acting on a lane
    axis ordered (chan-major, rep-minor): W ⊗ I_reps."""
    wr, wi = mats
    n = wr.shape[0]
    eye = np.eye(reps, dtype=np.float32)
    return (np.kron(wr, eye).reshape(n * reps, n * reps),
            np.kron(wi, eye).reshape(n * reps, n * reps))


def geometry_ok(n, pad_start, pad_end):
    """True when an (n, pad_start, pad_end) window fits the kernels'
    geometry (pow2 window, pads on the N2 grid); the 'pallas' task
    engines fall back to their 'xla' form when a short stream clamped
    the frame below the planned window."""
    if not _is_pow2(n):
        return False
    n2 = split_n(n)[1]
    return pad_start % n2 == 0 and pad_end % n2 == 0


def _check_gain(gr, n1, n2, L):
    if tuple(gr.shape) != (n2, n1, L):
        raise ValueError(f"gain storage shape {tuple(gr.shape)} does not "
                         f"match the (N2, N1, L) = ({n2}, {n1}, {L}) window "
                         f"layout (permute_to_storage_order)")


def _mats(mats, device):
    return None if mats is None else device_mats(mats, device)


# -- the lane mix ----------------------------------------------------------

def lane_mix_ref(xr, xi, wr, wi):
    """Plain (rows, L) planes @ complex (L, L) matrix."""
    return xr @ wr - xi @ wi, xr @ wi + xi @ wr


def lane_mix(xr, xi, wr, wi):
    """(rows, L) float32 planes times the complex (L, L) matrix wr + i·wi:
    lane_mix on CUDA tensors (3xTF32 on the tensor cores, float32-class,
    ``ops/tf32.py``), else :func:`lane_mix_ref`."""
    if not _on_cuda(xr):
        return lane_mix_ref(xr, xi, wr, wi)
    rows, L = xr.shape
    if L > MAX_MIX_LANES:
        raise ValueError(f"L={L} lanes above the lane mix's {MAX_MIX_LANES}")
    dev = xr.device
    for name, t, shape in (("xr", xr, (rows, L)), ("xi", xi, (rows, L)),
                           ("wr", wr, (L, L)), ("wi", wi, (L, L))):
        _check(t, name, torch.float32, shape, dev)
    tile = kernel_tile("bbt_lane_mix_tile")
    wp = cached((wr, wi), lambda: pack_operand([mix_operand(wr, wi)],
                                               *tile))
    vec = L % 4 == 0 and xr.data_ptr() % 16 == 0 and xi.data_ptr() % 16 == 0
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    launch("lane_mix", "bbt_lane_mix", dev, xr.data_ptr(), xi.data_ptr(),
           wp.data_ptr(), yr.data_ptr(), yi.data_ptr(), rows, L, int(vec))
    return yr, yi


# -- plain versions --------------------------------------------------------

def spectral_filter_pow2_ref(xr, xi, gr, gi, *, pad_start, pad_end,
                             pre=None, post=None):
    """Plain version: the ``pre`` mix, torch.fft over the window, times
    the gain (storage order reshaped to (N, L) is natural frequency
    order), inverse, trim, the ``post`` mix."""
    n, L = xr.shape
    pre, post = _mats(pre, xr.device), _mats(post, xr.device)
    if pre is not None:
        xr, xi = lane_mix_ref(xr, xi, *pre)
    g = torch.complex(gr, gi).reshape(n, L)
    y = torch.fft.ifft(torch.fft.fft(torch.complex(xr, xi), dim=0) * g,
                       dim=0)[pad_start:n - pad_end]
    yr, yi = y.real.contiguous(), y.imag.contiguous()
    if post is not None:
        yr, yi = lane_mix_ref(yr, yi, *post)
    return yr, yi


def spectral_filter_stream_ref(cr, ci, xr, xi, gr, gi, *, pad_start,
                               pad_end, scale=None, pre=None, post=None):
    """Plain streaming form: the window [carry | scale · block] through
    :func:`spectral_filter_pow2_ref`."""
    if scale is not None:
        xr, xi = xr * scale, xi * scale
    return spectral_filter_pow2_ref(torch.cat([cr, xr]), torch.cat([ci, xi]),
                                    gr, gi, pad_start=pad_start,
                                    pad_end=pad_end, pre=pre, post=post)


# -- entry points ----------------------------------------------------------

def _filter(y, gr, gi, pre, post, pad_start, pad_end):
    """Stage A's d-major planes ``y`` through the ``pre`` mix, K2,
    k3_trim and the ``post`` mix."""
    if pre is not None:
        n2, n1, L = y[0].shape
        y = tuple(p.reshape(n2, n1, L) for p in
                  lane_mix(y[0].reshape(-1, L), y[1].reshape(-1, L), *pre))
    y = stage_b(*y, gr, gi)
    out = k3_trim(*y, pad_start=pad_start, pad_end=pad_end)
    return out if post is None else lane_mix(*out, *post)


def spectral_filter_pow2(xr, xi, gr, gi, *, pad_start, pad_end, pre=None,
                         post=None):
    """trim(IFFT(FFT(x · pre) · G)) · post over a padded window.

    ``xr``, ``xi`` : (N, L) float32 window planes, N a power of two; the
    first ``pad_start`` and last ``pad_end`` rows are overlap-save pads
    (multiples of N2).  ``gr``, ``gi`` : (N2, N1, L) float32 gain in
    four-step storage order (``permute_to_storage_order``).  ``pre``,
    ``post`` : optional (wr, wi) pairs of (L, L) float32 lane mixers
    (numpy or tensors; e.g. :func:`lane_dft_mats`).  Returns the trimmed
    (N - pads, L) float32 planes.

    The passes dispatch by device (kernels on CUDA tensors, plain versions
    on CPU ones); numpy goes to the card when there is one.
    """
    dev = _device_of(xr)
    xr, xi, gr, gi = (_as_device(a, dev, torch.float32)
                      for a in (xr, xi, gr, gi))
    n, L = xr.shape
    n1, n2 = _window_split(n)
    _pad_rows(n2, n1, pad_start, pad_end)
    _check_gain(gr, n1, n2, L)
    pre, post = _mats(pre, dev), _mats(post, dev)
    return _filter(k1_window(xr, xi), gr, gi, pre, post, pad_start, pad_end)


def spectral_filter_stream(cr, ci, xr, xi, gr, gi, *, pad_start, pad_end,
                           scale=None, pre=None, post=None):
    """Streaming :func:`spectral_filter_pow2`: window = [carry | block].

    ``cr``/``ci`` : (pad_start + pad_end, L) carry planes (the last pad
    rows of the previous, already scaled, window); ``xr``/``xi`` :
    (N - pads, L) block planes; ``scale`` : None, a number or a
    one-element tensor multiplying the BLOCK rows only (the caller stores
    the scaled block tail as the next carry, so carries keep their own
    iteration's scale).  The window is assembled inside stage A, so the
    padded array never exists in device memory.  Returns rows
    [pad_start, N - pad_end) of the filtered window: one block of valid
    samples.  Numpy goes where :func:`spectral_filter_pow2` sends it.
    """
    dev = _device_of(xr)
    cr, ci, xr, xi, gr, gi = (_as_device(a, dev, torch.float32)
                              for a in (cr, ci, xr, xi, gr, gi))
    pad = pad_start + pad_end
    n = pad + xr.shape[0]
    L = xr.shape[-1]
    n1, n2 = _window_split(n)
    _pad_rows(n2, n1, pad_start, pad_end)
    if cr.shape[0] != pad:
        raise ValueError(f"carry must hold pad_start + pad_end = {pad} "
                         f"rows, got {cr.shape[0]}")
    _check_gain(gr, n1, n2, L)
    pre, post = _mats(pre, dev), _mats(post, dev)
    return _filter(k1_stream(cr, ci, xr, xi, scale), gr, gi, pre, post,
                   pad_start, pad_end)
