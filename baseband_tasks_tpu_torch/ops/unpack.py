"""Packed baseband samples: payload decoders, plane packing, edge decode
and block decode.

Counterpart of ``baseband_tasks_tpu/ops/unpack_device.py`` (the payload
decoders ``unpack_*_device`` :76-133 of the file readers' packed ingest,
``pack_time_planes`` :174, ``plane_edges_device`` :200,
``VDIF_2BIT_LEVELS``) and of the stage-A kernel's in-kernel decode
(``ops/dedisperse_pallas._decode_planes`` :732).  The decode conventions
are the JAX package's, bit for bit:

- 8/4-bit: ``field - offset`` (default 127.5 / 7.5);
- 2-bit: the crumb indexes a 4-entry level table (VDIF levels by default);
- 1-bit: ``levels[0]`` or ``levels[3]`` (default -1 / +1);
- 16-bit payloads: little-endian ``u16 - 32767.5``; signed payloads
  (DADA, GUPPI): two's-complement int8/int16; 32-bit: the words are the
  float32 samples.

Packed words travel as **int32 tensors holding the uint32 bit patterns**
(torch's ``uint32`` lacks most CPU ops).  Every field is extracted as
shift-then-mask, so the arithmetic shift's sign extension never reaches a
field.  Field ``k`` of each word is the sample ``k * T/planes`` later in
time, so each decoded plane is a contiguous row block of the FFT window.
The payload decoders instead read a file's bytes in stream order: the
fields of each word LSB first, word after word (``(..., n)`` words ->
``(..., n * 32/bits)`` samples).  The JAX package computes them in plain
XLA; here they are plain torch ops on the words' device (several
elementwise passes on the card).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["VDIF_2BIT_LEVELS", "pack_time_planes", "plane_edges",
           "decode_fields", "decode_planes", "default_offset",
           "default_levels", "words_from_bytes", "unpack_8bit",
           "unpack_4bit", "unpack_2bit", "unpack_1bit", "unpack_16bit",
           "unpack_8bit_signed", "unpack_16bit_signed", "f32_payload"]

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


# -- payload decoders (the file readers' packed ingest) ---------------------

def words_from_bytes(raw):
    """Host helper: a little-endian payload as a writable numpy int32
    array of its uint32 words, the port's word convention.  ``raw`` is
    bytes (their length a multiple of 4) or a uint8 array whose last axis
    (a multiple of 4 long) is contiguous: the words keep its leading
    axes, and are a view of it where it is writable (else a copy)."""
    if isinstance(raw, np.ndarray):
        if raw.strides[-1] != 1:
            raw = np.ascontiguousarray(raw)
        words = raw.view("<u4").view(np.int32)
    else:
        words = np.frombuffer(raw, "<u4").view(np.int32)
    return words if words.flags.writeable else words.copy()


def _stream_fields(words, bits):
    """(..., n) int32 words -> (..., n * 32/bits) int32 fields in stream
    order (each word's fields LSB first), shift-then-mask."""
    per = 32 // bits
    mask = (1 << bits) - 1
    parts = [(words >> (bits * k)) & mask for k in range(per)]
    return torch.stack(parts, dim=-1).reshape(
        *words.shape[:-1], words.shape[-1] * per)


def unpack_8bit(words, offset=127.5):
    """(..., n) words -> (..., 4n) float32 samples, ``byte - offset``."""
    return _stream_fields(words, 8).to(torch.float32) - float(offset)


def unpack_4bit(words, offset=7.5):
    """(..., n) words -> (..., 8n) float32 samples, ``nibble - offset``
    (the low nibble of each byte first)."""
    return _stream_fields(words, 4).to(torch.float32) - float(offset)


def unpack_16bit(words, offset=32767.5):
    """(..., n) words -> (..., 2n) float32 samples, little-endian
    ``u16 - offset`` (the host ``'<u2'`` decode of io/vdif.py)."""
    return _stream_fields(words, 16).to(torch.float32) - float(offset)


def unpack_8bit_signed(words):
    """(..., n) words -> (..., 4n) float32 from two's-complement int8
    bytes (GUPPI and DADA payloads)."""
    f = _stream_fields(words, 8)
    return torch.where(f >= 128, f - 256, f).to(torch.float32)


def unpack_16bit_signed(words):
    """(..., n) words -> (..., 2n) float32 from little-endian
    two's-complement int16 (DADA NBIT=16)."""
    f = _stream_fields(words, 16)
    return torch.where(f >= 32768, f - 65536, f).to(torch.float32)


def f32_payload(words):
    """The words' bytes are already little-endian float32 samples (DADA
    NBIT=±32, VDIF 32-bit): a view, no copy."""
    return words.view(torch.float32)


def unpack_2bit(words, levels=None):
    """(..., n) words -> (..., 16n) float32 samples through a 4-level
    table (LSB-first crumbs; VDIF levels by default), as two nested
    selects: the host LUT's values exactly."""
    lv = np.asarray(VDIF_2BIT_LEVELS if levels is None else levels,
                    dtype=np.float32)
    c = _stream_fields(words, 2)
    return torch.where(c < 2, torch.where(c == 0, float(lv[0]),
                                          float(lv[1])),
                       torch.where(c == 2, float(lv[2]), float(lv[3])))


def unpack_1bit(words, low=-1.0, high=1.0):
    """(..., n) words -> (..., 32n) float32 samples, ``bit ? high :
    low`` (LSB first)."""
    b = _stream_fields(words, 1).to(torch.float32)
    return float(low) + b * float(high - low)
