"""3xTF32 products: the TF32 split, and the constant operand staged for
the tensor-core kernels (``csrc/tf32mma.cuh``).

``lane_mix`` and ``bank_power`` multiply on Hopper's tensor cores in
TF32 (10-bit mantissa), which alone keeps ~5e-4 relative.  Each operand
is split as ``x ≈ big + small`` with ``big = tf32(x)`` and ``small =
tf32(x - big)`` (round to nearest, ties away from zero, as ``cvt.rna``),
and a product takes three passes, ``small·big + big·small + big·big``:
the dropped ``small·small`` term is ~2^-22 of each product.  The kernels
add each 16- or 32-deep partial product into float32 totals on the CUDA
cores, so the tensor cores' truncating accumulation does not build up
with the depth (``csrc/tf32mma.cuh``): float32-class, against ~3e-4 of
the peak for one TF32 pass, whatever ``torch``'s matmul precision
setting.

The kernels split the data operand in registers.  The constant operand
(a lane mixer, the search's Karatsuba operator) is split once here and
stored in the layout a pipeline stage copies as one contiguous run
(:func:`pack_operand`, for the tile the kernel reports, ``_build.
kernel_tile``), cached per operand tensor (:func:`cached`).
:func:`round_tf32` and :func:`split_tf32` are the plain arithmetic, on
any device.
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

__all__ = ["round_tf32", "split_tf32", "pack_operand", "mix_operand",
           "cached"]


def round_tf32(x):
    """float32 ``x`` rounded to TF32 (19 bits: the low 13 mantissa bits
    cleared), to nearest with ties away from zero: ``cvt.rna.tf32.f32``
    on finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """(big, small): TF32 halves with ``big + small`` equal to float32
    ``x`` within ~2^-22 of it."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def pack_operand(planes, bn, bk):
    """Stage (K, N) float32 planes for a kernel with column tiles of
    ``bn`` and stages ``bk`` deep: padded with zeros to multiples of (bk,
    bn), split, and laid out as [N tile][K tile][plane][big, small]
    [8-column group][4-deep chunk][column][4 depths], a 1-D tensor: one
    stage of the kernel is one contiguous run, each half a K-major grid of
    8 x 4 core matrices."""
    K, N = planes[0].shape
    kp, np_ = -(-K // bk) * bk, -(-N // bn) * bn
    halves = []
    for p in planes:
        halves.extend(split_tf32(F.pad(p, (0, np_ - N, 0, kp - K))))
    x = torch.stack(halves).reshape(len(planes), 2, kp // bk, bk // 4, 4,
                                    np_ // bn, bn // 8, 8)
    # (plane, half, kt, chunk, depth, nt, group, col) ->
    # (nt, kt, plane, half, group, chunk, col, depth)
    return x.permute(5, 2, 0, 1, 6, 3, 7, 4).contiguous().reshape(-1)


def mix_operand(wr, wi):
    """The complex (L, L) mixer wr + i·wi as the real (2L, 2L) block
    matrix [[wr, wi], [-wi, wr]]: [xr | xi] @ it = [yr | yi]."""
    return torch.cat([torch.cat([wr, wi], dim=1),
                      torch.cat([-wi, wr], dim=1)])


_CACHE = {}


def cached(tensors, build):
    """``build()`` once per tuple of live ``tensors`` (by identity and
    in-place version); the entry goes when the first of them is freed."""
    key = tuple(id(t) for t in tensors)
    versions = tuple(t._version for t in tensors)
    hit = _CACHE.get(key)
    if hit is not None and hit[1] == versions and \
            all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[2]
    value = build()
    refs = tuple(weakref.ref(t, lambda _, k=key: _CACHE.pop(k, None))
                 for t in tensors)
    _CACHE[key] = (refs, versions, value)
    return value
