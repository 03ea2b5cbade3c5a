"""Natural-order power-of-two FFT from the four-step passes.

Counterpart of ``baseband_tasks_tpu/ops/fft_pallas.py``.  A window of
N = N1·N2 samples (``split_n``) over L lanes is viewed as (N1, N2, L) with
time t = c·N2 + b; between the passes the data sits in d-major storage
order (N2, N1, L), row d and column c holding frequency k = d·N1 + c:

- **k1_window**: stage-A FFT over c of the whole window, twiddle
  W_N^{-c b}, stored d-major (the flagship's K1 without edges or scale);
- **k1_stream**: the same for the streaming window [carry | block], the
  block rows (only) times a per-iteration scale (the same K1 with the
  carry as its front edge);
- **k2_fwd**: stage-B FFT over d's column, times a scale; the output
  reshaped to (N, L) is the spectrum in natural order;
- **k2_inv**: inverse stage-B FFT of a natural-order spectrum seen as
  (N2, N1, L), times a scale, twiddle W_N^{+c b};
- **k3_trim**: inverse stage-A FFT over c with 1/N1, keeping only the
  rows outside the ``pad_start``/``pad_end`` pads (multiples of N2), in
  natural time order.

Forward is k1_window → k2_fwd; inverse is k2_inv → k3_trim, with the
inverse scale split as on the TPU: k2_inv gets ``scale·N1`` and k3_trim
divides by N1.  Each pass has a wrapper and a plain PyTorch version
(``*_ref``) of the same layout.  A wrapper given CUDA tensors launches its
hand-written Hopper kernel (``csrc/dedisperse.cu`` for k1_window,
``csrc/fourstep.cu`` for the others) or raises; given CPU tensors it runs
the plain version.  Each launch adds one to ``launch_counts``.
"""

from __future__ import annotations

import math

import torch

from ._build import launch
from .dedisperse import (_check, _check_kernel_geometry, _is_pow2,
                         _on_cuda, _twiddle, split_n)

__all__ = ["k1_window", "k1_stream", "k2_fwd", "k2_inv", "k3_trim",
           "k1_window_ref", "k1_stream_ref", "k2_fwd_ref", "k2_inv_ref",
           "k3_trim_ref", "fft_pow2_planes", "fft_pow2_planes_ref",
           "fft_scale", "scale_arg"]


def _planes(z):
    return z.real.contiguous(), z.imag.contiguous()


def _window_split(n):
    if not _is_pow2(n):
        raise ValueError(f"N={n} must be a power of two")
    return split_n(n)


def _pad_rows(n2, n1, pad_start, pad_end):
    """(kf, ke): the pads as whole stage-A rows of N2 samples."""
    for name, val in (("pad_start", pad_start), ("pad_end", pad_end)):
        if val < 0 or val % n2:
            raise ValueError(f"{name}={val} must be a non-negative "
                             f"multiple of N2={n2}")
    kf, ke = pad_start // n2, pad_end // n2
    if kf + ke >= n1:
        raise ValueError("pads leave no valid rows")
    return kf, ke


# -- plain PyTorch versions ----------------------------------------------

def k1_window_ref(xr, xi):
    """Plain stage A of an (N, L) window -> d-major (N2, N1, L) planes."""
    n, L = xr.shape
    n1, n2 = _window_split(n)
    w = torch.complex(xr, xi).reshape(n1, n2, L)
    y = torch.fft.fft(w, dim=0) * _twiddle(n1, n2, -1, w.device)[:, :, None]
    return _planes(y.transpose(0, 1))


def k1_stream_ref(cr, ci, xr, xi, scale=None):
    """Plain stage A of the window [carry | scale · block] -> d-major
    (N2, N1, L) planes; the carry is not scaled."""
    if scale is not None:
        xr, xi = xr * scale, xi * scale
    return k1_window_ref(torch.cat([cr, xr]), torch.cat([ci, xi]))


def k2_fwd_ref(yr, yi, scale):
    """Plain forward stage B over axis 0 of (N2, N1, L) planes, times
    ``scale``."""
    return _planes(torch.fft.fft(torch.complex(yr, yi), dim=0) * scale)


def k2_inv_ref(xr, xi, scale):
    """Plain inverse stage B (unnormalized, times ``scale``) and the
    W_N^{+c b} twiddle, over axis 0 of (N2, N1, L) planes."""
    n2, n1, _ = xr.shape
    y = torch.fft.ifft(torch.complex(xr, xi), dim=0, norm="forward") * scale
    return _planes(y * _twiddle(n1, n2, +1, y.device).T[:, :, None])


def k3_trim_ref(zr, zi, *, pad_start=0, pad_end=0):
    """Plain inverse stage A (1/N1) of d-major planes; the rows of the
    pads are dropped.  Returns (N - pad_start - pad_end, L) planes."""
    n2, n1, L = zr.shape
    kf, ke = _pad_rows(n2, n1, pad_start, pad_end)
    x = torch.fft.ifft(torch.complex(zr, zi).transpose(0, 1), dim=0)
    return _planes(x[kf:n1 - ke].reshape(-1, L))


def fft_scale(n, *, inverse, ortho):
    """The transform's scale: 1 or 1/N (inverse), 1/sqrt(N) with ortho."""
    if ortho:
        return 1.0 / math.sqrt(n)
    return 1.0 / n if inverse else 1.0


def fft_pow2_planes_ref(xr, xi, *, inverse=False, ortho=False):
    """Plain natural-order FFT of (N, L) planes along axis 0."""
    norm = "ortho" if ortho else "backward"
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return _planes(fn(torch.complex(xr, xi), dim=0, norm=norm))


# -- kernel wrappers -----------------------------------------------------

def _checked(tensors, shape):
    """The common device of ``tensors`` after checking each is float32,
    contiguous and of ``shape``."""
    dev = tensors[0][1].device
    for name, t in tensors:
        _check(t, name, torch.float32, shape, dev)
    return dev


def k1_window(xr, xi):
    """Stage A of an (N, L) window: k1_window on CUDA tensors, else
    :func:`k1_window_ref`.  Returns d-major (N2, N1, L) planes."""
    if not _on_cuda(xr):
        return k1_window_ref(xr, xi)
    n, L = xr.shape
    n1, n2 = _window_split(n)
    _check_kernel_geometry(n1, n2)
    dev = _checked((("xr", xr), ("xi", xi)), (n, L))
    yr = torch.empty((n2, n1, L), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    launch("k1_window", "bbt_k1_window", dev, xr.data_ptr(), xi.data_ptr(),
           yr.data_ptr(), yi.data_ptr(), n1, n2, L)
    return yr, yi


def scale_arg(scale, device):
    """A per-iteration scale as a kernel argument pair (device pointer,
    value): None is (null, 1); a number is (null, its value); a
    one-element float32 tensor on ``device`` is (its pointer, unused), so
    a scale computed on the card never syncs the host.  Also returns the
    tensor, which must live until the launch is enqueued."""
    if scale is None:
        return None, 1.0, None
    if not torch.is_tensor(scale):
        return None, float(scale), None
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got {scale.numel()}")
    t = scale.to(device=device, dtype=torch.float32).reshape(1).contiguous()
    return t.data_ptr(), 0.0, t


def k1_stream(cr, ci, xr, xi, scale=None):
    """Stage A of the streaming window [carry | scale · block]: k1_stream
    on CUDA tensors, else :func:`k1_stream_ref`.

    ``cr``/``ci`` : (pad, L) carry planes, already scaled; ``xr``/``xi``
    : (N - pad, L) block planes, N a power of two and pad a multiple of
    N2; ``scale`` : None, a number, or a one-element tensor multiplying
    the block rows only.  Returns d-major (N2, N1, L) planes."""
    if not _on_cuda(xr):
        return k1_stream_ref(cr, ci, xr, xi, scale)
    pad, L = cr.shape
    m = xr.shape[0]
    n1, n2 = _window_split(pad + m)
    _check_kernel_geometry(n1, n2)
    if pad % n2:
        raise ValueError(f"carry of {pad} rows must be a multiple of "
                         f"N2={n2}")
    dev = _checked((("xr", xr), ("xi", xi)), (m, L))
    _check(cr, "cr", torch.float32, (pad, L), dev)
    _check(ci, "ci", torch.float32, (pad, L), dev)
    yr = torch.empty((n2, n1, L), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    ptr, value, keep = scale_arg(scale, dev)
    launch("k1_stream", "bbt_k1_stream", dev, cr.data_ptr(), ci.data_ptr(),
           xr.data_ptr(), xi.data_ptr(), ptr, value, yr.data_ptr(),
           yi.data_ptr(), n1, n2, L, pad // n2)
    del keep
    return yr, yi


def _stage_b_pass(name, fn, ref, xr, xi, scale):
    if not _on_cuda(xr):
        return ref(xr, xi, scale)
    n2, n1, L = xr.shape
    _check_kernel_geometry(n1, n2)
    dev = _checked((("xr", xr), ("xi", xi)), (n2, n1, L))
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    launch(name, fn, dev, xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
           yi.data_ptr(), float(scale), n1, n2, L)
    return yr, yi


def k2_fwd(yr, yi, scale=1.0):
    """Forward stage B of d-major (N2, N1, L) planes times ``scale``:
    k2_fwd on CUDA tensors, else :func:`k2_fwd_ref`."""
    return _stage_b_pass("k2_fwd", "bbt_k2_fwd", k2_fwd_ref, yr, yi, scale)


def k2_inv(xr, xi, scale):
    """Inverse stage B of a spectrum seen as (N2, N1, L), times ``scale``,
    and the W_N^{+c b} twiddle: k2_inv on CUDA tensors, else
    :func:`k2_inv_ref`."""
    return _stage_b_pass("k2_inv", "bbt_k2_inv", k2_inv_ref, xr, xi, scale)


def k3_trim(zr, zi, *, pad_start=0, pad_end=0):
    """Inverse stage A (1/N1) of d-major (N2, N1, L) planes, pads dropped:
    k3_trim on CUDA tensors, else :func:`k3_trim_ref`.  ``pad_start`` and
    ``pad_end`` are multiples of N2.  Returns (N - pads, L) planes."""
    if not _on_cuda(zr):
        return k3_trim_ref(zr, zi, pad_start=pad_start, pad_end=pad_end)
    n2, n1, L = zr.shape
    _check_kernel_geometry(n1, n2)
    kf, ke = _pad_rows(n2, n1, pad_start, pad_end)
    dev = _checked((("zr", zr), ("zi", zi)), (n2, n1, L))
    rows = (n1 - kf - ke) * n2
    outr = torch.empty((rows, L), dtype=torch.float32, device=dev)
    outi = torch.empty_like(outr)
    launch("k3_trim", "bbt_k3_trim", dev, zr.data_ptr(), zi.data_ptr(),
           outr.data_ptr(), outi.data_ptr(), n1, n2, L, kf, ke)
    return outr, outi


# -- public entry point --------------------------------------------------

def fft_pow2_planes(xr, xi, *, inverse=False, ortho=False, kernels=True):
    """Four-step FFT of float32 planes (N, L) along axis 0, natural order
    in and out; N a power of two.

    Forward is unscaled (1/sqrt(N) with ``ortho``); inverse is 1/N
    (1/sqrt(N)).  The passes dispatch by device (kernels on CUDA tensors,
    plain versions on CPU ones); ``kernels=False`` runs
    :func:`fft_pow2_planes_ref` instead, on any device.  Windows above
    2^24 samples raise ``ValueError`` on a CUDA device.
    """
    n, L = xr.shape
    n1, n2 = _window_split(n)
    if not kernels:
        return fft_pow2_planes_ref(xr, xi, inverse=inverse, ortho=ortho)
    scale = fft_scale(n, inverse=inverse, ortho=ortho)
    if not inverse:
        zr, zi = k2_fwd(*k1_window(xr, xi), scale)
        return zr.reshape(n, L), zi.reshape(n, L)
    y = k2_inv(xr.reshape(n2, n1, L), xi.reshape(n2, n1, L), scale * n1)
    return k3_trim(*y)
