"""Short DFTs as matrix products, and the float32 matmul precision.

Counterpart of the host parts of ``baseband_tasks_tpu/ops/dft_matmul.py``.
A length-n DFT of a batch is ``X @ F`` with F the (n, n) DFT matrix; the
JAX package routes transforms of n <= :data:`MAX_MATMUL_N` this way (the
planes forms of ``Channelize``/``Dechannelize`` in compiled pipelines) and
computes these products outside any Pallas kernel, so here they are plain
``torch.matmul`` (cuBLAS on a CUDA device).  The matrices are built in
numpy exactly as the JAX package builds them, including ``F (x) I_reps``
for a flattened (dft-major, reps-minor) lane axis (:func:`_expanded_mats`,
the forward PFB kernel's DFT).

``set_matmul_precision`` maps onto ``torch.set_float32_matmul_precision``
('highest' -> 'highest', 'high' -> 'high', 'default' -> 'medium').  The
port leaves PyTorch's default ('highest', full FP32) in place: the JAX
default 'high' is a TPU choice (three bf16 MXU passes, ~2^-16 relative),
while PyTorch's 'high' on a CUDA device means TF32 (10-bit mantissa).  The
hand-written kernels compute in FP32 whatever the setting: the FFT and
fold passes on the CUDA cores, and the two matrix products, lane_mix and
bank_power, in 3xTF32 on the tensor cores (``ops/tf32.py``: operands
split into two TF32 halves, three passes, partial sums promoted into
float32 totals; ~3e-7 to ~6e-7 of the peak against float64 at any
depth).  The JAX package's in-kernel bf16x3 emulation (``kernel_dot``)
is Mosaic-only and has no counterpart.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["dft_matmul_planes", "MAX_MATMUL_N", "matmul_precision",
           "set_matmul_precision", "device_mats", "DeviceMats"]

#: largest transform length routed to a matrix product
MAX_MATMUL_N = 256

_TO_TORCH = {"highest": "highest", "high": "high", "default": "medium"}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}


def matmul_precision():
    """The float32 matmul precision as the JAX package names it
    ('highest', 'high' or 'default')."""
    return _FROM_TORCH[torch.get_float32_matmul_precision()]


class set_matmul_precision:
    """Set the float32 matmul precision ('highest', 'high', 'default');
    usable as a context manager, which restores the previous setting."""

    def __init__(self, name):
        target = _TO_TORCH[str(name).lower()]
        self._old = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(target)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self._old)


@lru_cache(maxsize=None)
def _forward_mats(n, m):
    """cos/sin planes of F[j, k] = exp(-2πi j k / n), shape (n, m)."""
    theta = -2.0 * np.pi / n * np.outer(np.arange(n), np.arange(m))
    return (np.cos(theta).astype(np.float32),
            np.sin(theta).astype(np.float32))


@lru_cache(maxsize=None)
def _inverse_mats(n):
    """cos/sin planes of conj(F)/n, shape (n, n)."""
    theta = 2.0 * np.pi / n * np.outer(np.arange(n), np.arange(n))
    return ((np.cos(theta) / n).astype(np.float32),
            (np.sin(theta) / n).astype(np.float32))


@lru_cache(maxsize=None)
def _expanded_mats(n, reps, direction):
    """(n·reps, n·reps) planes of F ⊗ I_reps: the DFT acting on a
    flattened (dft-major, reps-minor) lane axis."""
    if direction == "forward":
        fr, fi = _forward_mats(n, n)
    else:
        fr, fi = _inverse_mats(n)
    if reps == 1:
        return fr, fi
    eye = np.eye(reps, dtype=np.float32)
    return (np.kron(fr, eye).astype(np.float32),
            np.kron(fi, eye).astype(np.float32))


def device_mats(mats, device):
    """A (re, im) pair of numpy matrices as contiguous float32 tensors on
    ``device`` (tensors already there are returned as they are)."""
    return tuple(torch.as_tensor(np.ascontiguousarray(m) if not
                                 torch.is_tensor(m) else m,
                                 dtype=torch.float32, device=device)
                 .contiguous() for m in mats)


class DeviceMats:
    """A numpy (re, im) matrix pair and its float32 copies per device,
    made once, so a step never copies the matrices from the host."""

    def __init__(self, mats):
        self.host = mats
        self._dev = {}

    def on(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = device_mats(self.host, device)
        return self._dev[key]


@lru_cache(maxsize=None)
def _dft_mats(n, direction):
    return DeviceMats(_forward_mats(n, n) if direction == "forward"
                      else _inverse_mats(n))


def _dot(x, mat, axis):
    """Contract ``axis`` of x with the rows of ``mat``; the transformed
    axis returned in place of ``axis``."""
    return torch.movedim(torch.tensordot(x, mat, dims=([axis % x.ndim],
                                                       [0])), -1, axis)


def dft_matmul_planes(xr, xi, *, axis, direction, n):
    """Complex DFT of separate float32 re/im planes as four matrix
    products (numpy scaling: forward unscaled, inverse 1/n).  Returns
    (yr, yi)."""
    fr, fi = _dft_mats(n, direction).on(xr.device)
    return (_dot(xr, fr, axis) - _dot(xi, fi, axis),
            _dot(xr, fi, axis) + _dot(xi, fr, axis))
