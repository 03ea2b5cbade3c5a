"""Gathering frame payloads from a file of fixed-size frames."""

from __future__ import annotations

import numpy as np

__all__ = ["frame_payloads"]


def frame_payloads(fh, locs, frame_bytes, header_len, payload_bytes):
    """Payload bytes of file frames ``locs`` (an integer array of frame
    numbers, -1 for a missing frame) as a writable uint8 array of
    ``locs.shape + (payload_bytes,)``, zeros where a frame is missing.

    Frames that lie close together in the file (the usual case: a block
    of consecutive frames, threads interleaved) come in one read of the
    span that holds them; when they are all there, in file order, the
    result is a view into that read (payloads strided by the frame size,
    no copy).  Scattered frames come one read each.
    """
    locs = np.asarray(locs, dtype=np.int64)
    present = locs >= 0
    want = locs[present]
    if not want.size:
        return np.zeros(locs.shape + (payload_bytes,), np.uint8)
    lo, hi = int(want.min()), int(want.max())
    if hi - lo + 1 <= 2 * want.size:
        buf = bytearray((hi - lo + 1) * frame_bytes)
        fh.seek(lo * frame_bytes)
        got = fh.readinto(buf)
        if got != len(buf):
            raise EOFError(f"file ends {len(buf) - got} bytes short of "
                           f"frame {hi}")
        span = np.frombuffer(buf, np.uint8).reshape(hi - lo + 1, frame_bytes)
        payloads = span[:, header_len:header_len + payload_bytes]
        if want.size == locs.size and np.array_equal(
                locs.ravel(), np.arange(lo, lo + locs.size)):
            return payloads.reshape(locs.shape + (payload_bytes,))
        out = np.zeros(locs.shape + (payload_bytes,), np.uint8)
        out[present] = payloads[want - lo]
        return out
    out = np.zeros(locs.shape + (payload_bytes,), np.uint8)
    rows = np.empty((want.size, payload_bytes), np.uint8)
    for i, k in enumerate(want):
        fh.seek(int(k) * frame_bytes + header_len)
        rows[i] = np.frombuffer(fh.read(payload_bytes), np.uint8)
    out[present] = rows
    return out
