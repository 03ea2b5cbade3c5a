"""Overlap-save spectral filtering of a power-of-two window.

Counterpart of ``baseband_tasks_tpu/ops/spectral_filter.py``:

    y = trim( IFFT_k( FFT_k(window) * G[k, lane] ) )

with the FFT along axis 0 (time rows) and ``G`` an arbitrary complex gain
per (frequency, lane): a dedispersion chirp, a Wiener gain, a response.
It is three kernel passes of the four-step FFT: ``k1_window`` (stage A),
the flagship's K2 (``ops/dedisperse.stage_b``: stage B, times the gain,
inverse stage B) and ``k3_trim`` (inverse stage A, which stores only the
rows outside the overlap-save pads, so the pads never reach memory).  The
pads must be multiples of N2 (``split_n``).

The TPU version also fuses lane-mixing matrices (``pre``/``post``) and a
streaming window form (``spectral_filter_stream``); both belong to the
compiled pipelines and are not ported yet (ROADMAP.md, queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from .dedisperse import _is_pow2, split_n, stage_b
from .fft import _pad_rows, _window_split, k1_window, k3_trim

__all__ = ["spectral_filter_pow2", "spectral_filter_pow2_ref",
           "spectral_filter_stream", "geometry_ok", "lane_dft_mats",
           "expand_lane_mats"]

_NOT_PORTED = ("the spectral filter's lane mixes (pre/post) and streaming "
               "form belong to the compiled pipelines, not ported yet "
               "(ROADMAP.md, queue 1 item 8: CompiledPipeline)")


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
    geometry (pow2 window, pads on the N2 grid); the 'pallas' dispersion
    engine falls back to its 'xla' task when a short stream clamped the
    frame below the planned window."""
    if not _is_pow2(n):
        return False
    n2 = split_n(n)[1]
    return pad_start % n2 == 0 and pad_end % n2 == 0


def _check_gain(gr, n1, n2, L):
    if tuple(gr.shape) != (n2, n1, L):
        raise ValueError(f"gain storage shape {tuple(gr.shape)} does not "
                         f"match the (N2, N1, L) = ({n2}, {n1}, {L}) window "
                         f"layout (permute_to_storage_order)")


def spectral_filter_pow2_ref(xr, xi, gr, gi, *, pad_start, pad_end):
    """Plain version: torch.fft over the window, times the gain (storage
    order reshaped to (N, L) is natural frequency order), inverse, trim."""
    n, L = xr.shape
    g = torch.complex(gr, gi).reshape(n, L)
    y = torch.fft.ifft(torch.fft.fft(torch.complex(xr, xi), dim=0) * g,
                       dim=0)[pad_start:n - pad_end]
    return y.real.contiguous(), y.imag.contiguous()


def spectral_filter_pow2(xr, xi, gr, gi, *, pad_start, pad_end, pre=None,
                         post=None, kernels=True):
    """trim(IFFT(FFT(x) · G)) over a padded window.

    ``xr``, ``xi`` : (N, L) float32 window planes, N a power of two; the
    first ``pad_start`` and last ``pad_end`` rows are overlap-save pads
    (multiples of N2).  ``gr``, ``gi`` : (N2, N1, L) float32 gain in
    four-step storage order (``permute_to_storage_order``).  Returns the
    trimmed (N - pads, L) float32 planes.

    The passes dispatch by device (kernels on CUDA tensors, plain versions
    on CPU ones); ``kernels=False`` runs :func:`spectral_filter_pow2_ref`
    instead, on any device.  ``pre``/``post`` raise NotImplementedError.
    """
    if pre is not None or post is not None:
        raise NotImplementedError(_NOT_PORTED)
    n, L = xr.shape
    n1, n2 = _window_split(n)
    _pad_rows(n2, n1, pad_start, pad_end)
    _check_gain(gr, n1, n2, L)
    if not kernels:
        return spectral_filter_pow2_ref(xr, xi, gr, gi, pad_start=pad_start,
                                        pad_end=pad_end)
    y = stage_b(*k1_window(xr, xi), gr, gi)
    return k3_trim(*y, pad_start=pad_start, pad_end=pad_end)


def spectral_filter_stream(*args, **kwargs):
    """The streaming (carry | block) form: not ported yet."""
    raise NotImplementedError(_NOT_PORTED)
