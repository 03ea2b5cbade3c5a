"""Forward polyphase filter bank of a streaming block: the FIR tap-sum
and, optionally, the channelizing DFT, in one kernel pass.

Counterpart of ``baseband_tasks_tpu/ops/pfb_pallas.py``.  A "row" is one
output spectrum's worth of raw samples: ``L = n * reps`` lanes in
(sample-within-block major, trailing-dims minor) order, i.e.
``x.reshape(m, L)`` of the flat (samples, *extra) stream planes.  The
window is [carry | block]: the carry holds the previous block's last
``n_tap - 1`` rows (already scaled); a per-iteration ``scale`` multiplies
the block rows only.  Output rows are

    a[r] = Σ_t taps[t] · window[r + t]         (the polyphase branches)

or, with the expanded DFT planes ``fr``/``fi`` (``ops.dft_matmul.
_expanded_mats``, F ⊗ I_reps), the channelized spectra ``a @ (fr + i·fi)``
in (channel major, trailing minor) lane order.

:func:`pfb_forward_stream` launches ``csrc/pfb.cu`` on CUDA tensors and
runs :func:`pfb_forward_stream_ref` on CPU ones: ``pfb_fwd`` (the FIR
alone) or ``pfb_fwd_dft`` (the FIR's tap sums computed into the A stages
of a 3xTF32 tensor-core GEMM against the DFT planes, split and staged
once per pair of planes by ``ops/tf32.py``, float32-class as
``lane_mix``).  The geometry gates
(``forward_geometry_ok``, ``choose_block_rows``) are the JAX package's,
so the compiled pipelines fuse exactly the stages that it fuses; the
TPU's row-block tiling itself has no counterpart in the CUDA kernel.
"""

from __future__ import annotations

import torch

from ._build import kernel_tile, launch
from .dedisperse import _check, _device_of, _on_cuda
from .fft import scale_arg
from .spectral_filter import MAX_MIX_LANES
from .tf32 import cached, mix_operand, pack_operand

__all__ = ["pfb_forward_stream", "pfb_forward_stream_ref",
           "forward_geometry_ok", "choose_block_rows"]

#: most taps the kernel's register window holds (the gate's 2..9)
MAX_TAPS = 9


def choose_block_rows(m, hb, cap=1024):
    """Largest divisor of ``m`` that is a multiple of ``hb`` and <= cap
    (0 when none exists)."""
    best = 0
    for b in range(hb, cap + 1, hb):
        if m % b == 0:
            best = b
    return best


def forward_geometry_ok(m, L, n_tap):
    """True when an (m out-rows, L lanes, n_tap) forward PFB fits the
    kernel: lane count on the 128 grid, the halo within one 8-row
    sub-block granule, and a usable row-block divisor."""
    if L % 128 or not 2 <= n_tap <= 9:
        return False
    return choose_block_rows(m, 8) >= 8


def pfb_forward_stream_ref(carry_r, carry_i, xr, xi, taps, fr=None,
                           fi=None, *, n_tap, scale=None):
    """Plain version: the tap-sum over [carry | scale · block], then the
    DFT as a matrix product when ``fr``/``fi`` are given."""
    if scale is not None:
        xr, xi = xr * scale, xi * scale
    m = xr.shape[0]
    wr, wi = torch.cat([carry_r, xr]), torch.cat([carry_i, xi])
    ar = taps[0:1] * wr[0:m]
    ai = taps[0:1] * wi[0:m]
    for t in range(1, n_tap):
        ar = ar + taps[t:t + 1] * wr[t:t + m]
        ai = ai + taps[t:t + 1] * wi[t:t + m]
    if fr is None:
        return ar, ai
    return ar @ fr - ai @ fi, ar @ fi + ai @ fr


def _as_f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()


def pfb_forward_stream(carry_r, carry_i, xr, xi, taps, fr=None, fi=None,
                       *, n_tap, scale=None):
    """Channelized spectra planes from streaming raw planes.

    Parameters
    ----------
    carry_r, carry_i : (n_tap - 1, L) float32
        Previous block's trailing rows (zeros at stream start).
    xr, xi : (m, L) float32
        New block rows.
    taps : (n_tap, L) float32
        Per-lane FIR weights (channel taps tiled over trailing dims).
    fr, fi : (L, L) float32 or None
        Expanded forward DFT planes; None emits the raw tap-sum (the
        polyphase branches) for chains whose downstream inverse DFT
        cancels the DFT (the compiled round-trip fusion).
    scale : None, a number or a one-element tensor
        Multiplies the block rows only.

    Array arguments may be numpy, taken to the device of ``xr``: its own
    for a tensor, else the card when there is one.
    Returns (yr, yi) of shape (m, L).
    """
    m, L = xr.shape
    k = n_tap - 1
    if not choose_block_rows(m, 8 * -(-k // 8)):
        # the JAX package's refusal; the CUDA kernel tiles rows its own way
        raise ValueError(f"no usable row-block split for m={m}, "
                         f"n_tap={n_tap}")
    dev = _device_of(xr)
    carry_r, carry_i, xr, xi, taps = (_as_f32(a, dev) for a in
                                      (carry_r, carry_i, xr, xi, taps))
    with_dft = fr is not None
    if with_dft:
        fr, fi = _as_f32(fr, dev), _as_f32(fi, dev)
    if not _on_cuda(xr):
        return pfb_forward_stream_ref(carry_r, carry_i, xr, xi, taps, fr, fi,
                                      n_tap=n_tap, scale=scale)
    if not 2 <= n_tap <= MAX_TAPS:
        raise ValueError(f"n_tap={n_tap} outside the kernel's 2..{MAX_TAPS}")
    if with_dft and (L > MAX_MIX_LANES or L % 16):
        raise ValueError(f"L={L} lanes: the in-kernel DFT takes a multiple "
                         f"of 16 up to {MAX_MIX_LANES}")
    for name, t, shape in (("carry_r", carry_r, (k, L)),
                           ("carry_i", carry_i, (k, L)),
                           ("xr", xr, (m, L)), ("xi", xi, (m, L)),
                           ("taps", taps, (n_tap, L))) + (
            (("fr", fr, (L, L)), ("fi", fi, (L, L))) if with_dft else ()):
        _check(t, name, torch.float32, shape, dev)
    yr = torch.empty((m, L), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    wp = None
    if with_dft:
        tile = kernel_tile("bbt_pfb_fwd_tile")
        wp = cached((fr, fi), lambda: pack_operand([mix_operand(fr, fi)],
                                                   *tile))
    ptr, value, keep = scale_arg(scale, dev)
    launch("pfb_fwd_dft" if with_dft else "pfb_fwd", "bbt_pfb_fwd", dev,
           carry_r.data_ptr(), carry_i.data_ptr(), xr.data_ptr(),
           xi.data_ptr(), taps.data_ptr(),
           wp.data_ptr() if with_dft else None, ptr, value, yr.data_ptr(),
           yi.data_ptr(), m, L, n_tap)
    del keep
    return yr, yi
