"""The FX correlator's X stage and its dump sums as one pass.

:func:`xcorr_accumulate` adds the cross products of every baseline i <= j
of a block of stacked spectra into a reduction's sums by segment id: what
``models/correlator.CrossMultiply`` followed by the absorbed
``Integrate``'s update (``models/compiled.make_reduction_update``) does,
with no gathered sides, no products tensor and no ``index_add_``.  On
CUDA tensors it is one launch of ``xcorr`` (``csrc/xcorr.cu``: a
register-tiled Hermitian product per frequency cell, summed in registers
over each segment's run of spectra and added into the sums once); on CPU
tensors, and inside the test-only :func:`~.dedisperse.plain_versions`,
:func:`xcorr_accumulate_ref`.  The JAX package has no such kernel: its
``CrossMultiply`` is plain ``jnp``.

The launch goes through the operator ``bbt::xcorr_accumulate`` (defined
with ``torch.library.Library``, whose first call costs a millisecond
where a ``torch.library.custom_op``'s costs seconds of imports), so a
profiler records it as an operator and links the kernel to it by
``External id``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import launch
from .dedisperse import _on_cuda

__all__ = ["MIN_BASELINE_CELLS", "xcorr_accumulate",
           "xcorr_accumulate_ref"]

#: baselines x frequency cells of a spectrum below which the compiled
#: executor keeps the unfused products: each block of a launch walks every
#: spectrum of the call, so a launch of few (cell, tile) items leaves most
#: of the card idle.  On an H100 80GB HBM3 (2048 spectra in segments of
#: 256, either products) 36 x 256 ran at 0.67-0.75x the unfused path's
#: speed and 78 x 256 at 2.2x; 3 x 256 at 8192 spectra a block took 2.8
#: ms against its 0.5.
MIN_BASELINE_CELLS = 16384


def _cells(x, sums, full):
    """(n_station, cells, pols) of a stack ``x`` and the sums it adds
    into, checked against each other: ``full`` takes a trailing
    polarization axis of 2 to its four products."""
    if x.ndim < (3 if full else 2):
        raise ValueError(f"spectra of shape {tuple(x.shape)} have no "
                         f"station axis")
    n = x.shape[1]
    rest = tuple(x.shape[2:])
    if full and (not rest or rest[-1] != 2):
        raise ValueError(f"the full products need a trailing polarization "
                         f"axis of 2; the spectra are {tuple(x.shape)}")
    out = rest[:-1] + (4,) if full else rest
    want = (n * (n + 1) // 2,) + out
    if tuple(sums.shape[1:]) != want or sums.shape[0] < 1:
        raise ValueError(f"sums of shape {tuple(sums.shape)} do not take "
                         f"the baselines of spectra {tuple(x.shape)}: "
                         f"expected (n_seg + 1,) + {want}")
    pols = 2 if full else 1
    return n, math.prod(rest) // pols, pols


def xcorr_accumulate_ref(x, seg, sums, *, full):
    """Plain version of :func:`xcorr_accumulate`: an einsum of the
    spectra with their conjugates, weighted by each segment's one-hot
    column, and the upper triangle of station pairs added in."""
    n, cells, pols = _cells(x, sums, full)
    n_seg = sums.shape[0] - 1
    xs = x.reshape(x.shape[0], n, cells, pols)
    onehot = (seg[:, None] == torch.arange(n_seg, device=seg.device)
              ).to(x.dtype)
    v = torch.einsum("ts,tifp,tjfq->sijfpq", onehot, xs, xs.conj())
    i, j = torch.triu_indices(n, n, device=x.device)
    sums[:n_seg] += v[:, i, j].reshape((n_seg,) + tuple(sums.shape[1:]))
    return sums


#: cell axes a launch takes, after merging those that run as one
MAX_CELL_AXES = 4


def _cell_axes(x, pols):
    """The cell axes of spectra ``x`` (those after the station axis,
    without a trailing polarization pair) as ``(sizes, strides in x,
    strides in the cell index)``, axes of size 1 dropped, neighbours that
    run as one merged, in x's memory order (the largest stride first), so
    that a launch's blocks walk the cells as x holds them."""
    end = x.ndim - 1 if pols == 2 else x.ndim
    axes = []                         # [size, stride in x, stride out]
    out = 1
    for d, s in reversed(list(zip(x.shape[2:end], x.stride()[2:end]))):
        if d != 1:
            if axes and s == axes[-1][1] * axes[-1][0]:
                axes[-1][0] *= d
            else:
                axes.append([d, s, out])
        out *= d
    axes.sort(key=lambda a: -a[1])
    return tuple(tuple(a[k] for a in axes) for k in range(3))


def _xcorr_launch(x, seg, sums, pols):
    dims, strides, outs = _cell_axes(x, pols)
    if len(dims) > MAX_CELL_AXES:
        x = x.contiguous()
        dims, strides, outs = _cell_axes(x, pols)
    nd = max(len(dims), 1)
    launch("xcorr", "bbt_xcorr", x.device, x.data_ptr(), seg.data_ptr(),
           sums.data_ptr(), x.shape[0], x.shape[1], pols, sums.shape[0] - 1,
           x.stride(0), x.stride(1), x.stride(-1) if pols == 2 else 0,
           len(dims), (ctypes.c_int * nd)(*dims),
           (ctypes.c_longlong * nd)(*strides),
           (ctypes.c_longlong * nd)(*outs))


# the launch as the operator bbt::xcorr_accumulate (CUDA only), so that a
# profiler records it and links the kernel to it
_LIB = torch.library.Library("bbt", "DEF")
_LIB.define("xcorr_accumulate(Tensor x, Tensor seg, Tensor(a!) sums, "
            "int pols) -> ()")
_LIB.impl("xcorr_accumulate", _xcorr_launch, "CUDA")


def xcorr_accumulate(x, seg, sums, *, full):
    """Add the products of every baseline i <= j into ``sums`` in place.

    Parameters
    ----------
    x : (T, n_station, ...) complex64 tensor
        A block of stacked spectra at any strides, the station axis first
        after time (``CrossMultiply``'s input); with ``full`` the last
        axis is the polarization pair (X, Y).
    seg : (T,) int64 tensor
        Each spectrum's segment id; spectra of the trash segment
        ``n_seg = len(sums) - 1`` (or of any id outside ``[0, n_seg)``)
        add nothing.
    sums : (n_seg + 1, n_station (n_station + 1) / 2, ...) complex64
        The reduction's sums, baselines in packed upper-triangle order;
        the trailing axes those of ``x``, with ``full`` the last one the
        four products XX*, XY*, YX*, YY*.
    full : bool
        ``CrossMultiply(products='full')``, else the elementwise products.

    Returns ``sums``.
    """
    if not _on_cuda(x):
        return xcorr_accumulate_ref(x, seg, sums, full=full)
    _, _, pols = _cells(x, sums, full)
    for name, t, dtype in (("x", x, torch.complex64),
                           ("seg", seg, torch.int64),
                           ("sums", sums, torch.complex64)):
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; xcorr "
                             f"takes {dtype} on {x.device}")
    if tuple(seg.shape) != (x.shape[0],):
        raise ValueError(f"seg of shape {tuple(seg.shape)} does not give "
                         f"the {x.shape[0]} spectra an id each")
    if not sums.is_contiguous() or sums.data_ptr() % (8 * pols):
        raise ValueError(f"xcorr adds into contiguous, {8 * pols}-byte "
                         f"aligned sums")
    seg = seg.contiguous()
    torch.ops.bbt.xcorr_accumulate(x, seg, sums, pols)
    return sums
