"""Plane-packed baseband samples: packing, edge decode and block decode.

Counterpart of ``baseband_tasks_tpu/ops/unpack_device.py``
(``pack_time_planes`` :174, ``plane_edges_device`` :200,
``VDIF_2BIT_LEVELS``) and of the stage-A kernel's in-kernel decode
(``ops/dedisperse_pallas._decode_planes`` :732).  The decode conventions
are the JAX package's, bit for bit:

- 8/4-bit: ``field - offset`` (default 127.5 / 7.5);
- 2-bit: the crumb indexes a 4-entry level table (VDIF levels by default);
- 1-bit: ``levels[0]`` or ``levels[3]`` (default -1 / +1).

Packed words travel as **int32 tensors holding the uint32 bit patterns**
(torch's ``uint32`` lacks most CPU ops).  Every field is extracted as
shift-then-mask, so the arithmetic shift's sign extension never reaches a
field.  Field ``k`` of each word is the sample ``k * T/planes`` later in
time, so each decoded plane is a contiguous row block of the FFT window.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["VDIF_2BIT_LEVELS", "pack_time_planes", "plane_edges",
           "decode_fields", "decode_planes", "default_offset",
           "default_levels"]

# standard VDIF 2-bit reconstruction levels
VDIF_2BIT_LEVELS = np.array([-3.3359, -1.0, 1.0, 3.3359], dtype=np.float32)


def default_offset(bits):
    """Offset subtracted from 8/4-bit fields (0 for the table depths)."""
    return {8: 127.5, 4: 7.5, 2: 0.0, 1: 0.0}[bits]


def default_levels(bits):
    """4-entry level table: VDIF levels for 2-bit, +-1 for 1-bit."""
    if bits == 2:
        return tuple(float(v) for v in VDIF_2BIT_LEVELS)
    return (-1.0, -1.0, 1.0, 1.0)


def _check_bits(bits):
    if bits not in (1, 2, 4, 8):
        raise ValueError("bits must be 1, 2, 4 or 8")
    return 32 // bits


def pack_time_planes(fields, bits):
    """(T, L) small-int sample fields -> (T*bits//32, L) int32 words.

    ``fields`` (numpy array or tensor) holds the raw encoded values
    (bytes for 8-bit, nibbles for 4-bit, crumbs for 2-bit, bits for
    1-bit); field k of each 32-bit word is the sample ``k * T/planes``
    later in time.  The result lies on the device of ``fields`` (the CPU
    for a numpy array); its ``.numpy().view(np.uint32)`` equals the JAX
    package's carriers ``.view(np.uint32)``.
    """
    per = _check_bits(bits)
    f = torch.as_tensor(fields).to(torch.int64)
    t, L = f.shape
    if t % per:
        raise ValueError(f"time axis must divide by {per}")
    if f.numel() and (int(f.min()) < 0 or int(f.max()) >> bits):
        raise ValueError(f"field values exceed {bits} bits")
    planes = f.reshape(per, t // per, L)
    w = torch.zeros((t // per, L), dtype=torch.int64, device=f.device)
    for k in range(per):
        w |= planes[k] << (bits * k)
    # uint32 pattern -> the int32 with the same bits, exactly
    w = w - ((w >> 31) << 32)
    return w.to(torch.int32)


def _field(words, k, bits):
    return (words >> (bits * k)) & ((1 << bits) - 1)


def decode_fields(f, bits, offset=None, levels=None):
    """Integer fields -> float32 samples in the kernels' units."""
    if bits == 2 or bits == 1:
        lv = torch.tensor(default_levels(bits) if levels is None
                          else levels, dtype=torch.float32, device=f.device)
        if bits == 1:
            return torch.where(f == 0, lv[0], lv[3])
        return lv[f.long()]
    if offset is None:
        offset = default_offset(bits)
    return f.to(torch.float32) - float(offset)


def decode_planes(words, bits, offset=None, levels=None):
    """Decode a whole plane-packed block: (T*bits//32, L) int32 words ->
    (T, L) float32 samples, plane k as the k-th contiguous row block."""
    per = _check_bits(bits)
    return torch.cat([decode_fields(_field(words, k, bits), bits, offset,
                                    levels) for k in range(per)], dim=0)


def plane_edges(words, pad_start, pad_end, bits, offset=None, levels=None):
    """Decoded (front, end) edge samples of a plane-packed block.

    front = first ``pad_start`` samples (field 0 of the leading words),
    end = last ``pad_end`` samples (highest field of the trailing words),
    in the same units as the block decode.  A pad may span several planes.
    Counterpart of ``unpack_device.plane_edges_device``.
    """
    per = _check_bits(bits)
    plen = words.shape[0]                       # samples per plane
    lo_parts, need = [], pad_start
    for k in range(per):
        if need <= 0:
            break
        take = min(need, plen)
        lo_parts.append(_field(words[:take], k, bits))
        need -= take
    hi_parts, need = [], pad_end
    for k in range(per - 1, -1, -1):
        if need <= 0:
            break
        take = min(need, plen)
        hi_parts.insert(0, _field(words[plen - take:], k, bits))
        need -= take
    empty = words[:0]
    lo = torch.cat(lo_parts, dim=0) if lo_parts else empty
    hi = torch.cat(hi_parts, dim=0) if hi_parts else empty
    return (decode_fields(lo, bits, offset, levels),
            decode_fields(hi, bits, offset, levels))
