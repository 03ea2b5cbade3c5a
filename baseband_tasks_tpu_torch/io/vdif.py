"""VDIF (VLBI Data Interchange Format) stream reader/writer.

Counterpart of ``baseband_tasks_tpu/io/vdif.py``: a self-contained VDIF
implementation covering the common cases: little-endian 32-byte headers
(VDIF v0/v1; 16-byte legacy headers read), one or more threads (e.g.
polarizations), 2/4/8/16/32 bits per component, real or complex samples,
decoded on the host through the native LUT unpacker (``read()`` then
hands out tensors on the stream's device), or shipped packed
(:meth:`VDIFStreamReader.read_packed`) and decoded on the device inside a
compiled pipeline (:meth:`VDIFStreamReader.packed_decode_fn`).  Files
written by either package's writer read back identically in the other.

Format reference: the public VDIF specification (vlbi.org), v1.1.

Header words (little-endian u32):
  w0: seconds-from-epoch (30) | legacy (1) | invalid (1)
  w1: frame number in second (24) | ref epoch (6, half-years since 2000)
  w2: frame length / 8 incl. header (24) | log2 nchan (5) | version (3)
  w3: station (16) | thread id (10) | bits-1 (5) | complex (1)
  w4..w7: extended user data (zeroed here)
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch

from .. import native
from ..ops import unpack as up
from ..utils import Time, units as u
from ..utils.dtypes import to_numpy
from ._host import FileReader
from ._payload import frame_payloads

__all__ = ["open", "VDIFStreamReader", "VDIFStreamWriter"]

HEADER_BYTES = 32


def _ref_epoch_time(epoch):
    """VDIF reference epoch -> Time (half-years since 2000-01-01)."""
    year = 2000 + epoch // 2
    month = 1 if epoch % 2 == 0 else 7
    return Time(f"{year:04d}-{month:02d}-01T00:00:00.0", scale="utc")


def _time_to_epoch_seconds(t):
    """Time -> (ref_epoch, whole seconds since it)."""
    for epoch in range(63, -1, -1):
        e0 = _ref_epoch_time(epoch)
        if t >= e0:
            dt = (t - e0).sec
            return epoch, int(round(dt))
    raise ValueError("time before VDIF epoch range")


def _parse_header(raw):
    w = np.frombuffer(raw, dtype="<u4", count=8)
    return {
        "invalid": bool(w[0] >> 31),
        "legacy": bool((w[0] >> 30) & 1),
        "seconds": int(w[0] & 0x3FFFFFFF),
        "epoch": int((w[1] >> 24) & 0x3F),
        "frame_nr": int(w[1] & 0xFFFFFF),
        "frame_len8": int(w[2] & 0xFFFFFF),
        "lg2_nchan": int((w[2] >> 24) & 0x1F),
        "version": int(w[2] >> 29),
        "station": int(w[3] & 0xFFFF),
        "thread": int((w[3] >> 16) & 0x3FF),
        "bps": int(((w[3] >> 26) & 0x1F) + 1),
        "complex": bool(w[3] >> 31),
    }


def _build_header(seconds, frame_nr, epoch, frame_len8, lg2_nchan, thread,
                  bps, complex_data, station=0):
    w = np.zeros(8, dtype="<u4")
    w[0] = seconds & 0x3FFFFFFF
    w[1] = (frame_nr & 0xFFFFFF) | ((epoch & 0x3F) << 24)
    w[2] = (frame_len8 & 0xFFFFFF) | ((lg2_nchan & 0x1F) << 24)
    w[3] = (station & 0xFFFF) | ((thread & 0x3FF) << 16) \
        | (((bps - 1) & 0x1F) << 26) | (int(complex_data) << 31)
    return w.tobytes()


def _decode_payload(payload, bps):
    """Host decode of payload bytes (any leading shape, uint8) -> float32
    components, flat, in stream order."""
    raw = np.ascontiguousarray(payload, np.uint8)
    if bps == 8:
        return native.unpack_8bit(raw)
    if bps == 4:
        return native.unpack_4bit(raw)
    if bps == 2:
        return native.unpack_2bit(raw, up.VDIF_2BIT_LEVELS)
    if bps == 16:
        return raw.reshape(-1).view("<u2").astype(np.float32) - 32767.5
    if bps == 32:
        return raw.reshape(-1).view("<f4").astype(np.float32)
    raise ValueError(f"unsupported bits-per-sample {bps}")


def _encode_payload(comp, bps):
    if bps == 8:
        return np.clip(np.round(comp - 0.5) + 128, 0, 255
                       ).astype(np.uint8).tobytes()
    if bps == 4:
        vals = np.clip(np.round(comp - 0.5) + 8, 0, 15).astype(np.uint8)
        if vals.size % 2:
            vals = np.concatenate([vals, np.zeros(1, np.uint8)])
        return (vals[0::2] | (vals[1::2] << 4)).tobytes()
    if bps == 2:
        return native.pack_2bit(comp, np.array([-2.0, 0.0, 2.0],
                                               np.float32)).tobytes()
    if bps == 16:
        return (np.clip(np.round(comp - 0.5) + 32768, 0, 65535)
                .astype("<u2").tobytes())
    if bps == 32:
        return comp.astype("<f4").tobytes()
    raise ValueError(f"unsupported bits-per-sample {bps}")


class VDIFStreamReader(FileReader):
    """Stream head over a (possibly multi-thread) VDIF file.

    Threads become the last sample axis (one per polarization, say);
    channels within a frame the first.  Sample shape: (nchan, nthread),
    squeezed of length-1 axes.  ``device`` is where ``read()`` puts the
    decoded samples (default: the card when there is one).
    """

    def __init__(self, name, sample_rate=None, device=None):
        self._fh = open_file(name, "rb")
        try:
            self._init_from_file(sample_rate, device)
        except Exception:
            self._fh.close()
            self._fh = None
            raise

    def _init_from_file(self, sample_rate, device):
        first = _parse_header(self._fh.read(HEADER_BYTES))
        self._hdr0 = first
        frame_bytes = first["frame_len8"] * 8
        self._frame_bytes = frame_bytes
        self._header_len = 16 if first["legacy"] else 32
        payload_bytes = frame_bytes - self._header_len
        self._payload_bytes = payload_bytes
        nchan = 1 << first["lg2_nchan"]
        bps = first["bps"]
        factor = 2 if first["complex"] else 1
        spf = payload_bytes * 8 // (bps * nchan * factor)
        self._samples_per_frame_file = spf
        self._nchan = nchan
        self._bps = bps
        self._complex = first["complex"]

        # Index every frame header (seconds, frame_nr, thread) so frames
        # may appear in ANY order/interleaving in the file: one vectorized
        # pass (a memory map touches only the headers' pages)
        size = os.fstat(self._fh.fileno()).st_size
        scan = min(size // frame_bytes, 1 << 22)
        mm = np.memmap(self._fh, dtype=np.uint8, mode="r",
                       shape=(scan, frame_bytes))
        w = np.ascontiguousarray(mm[:, :16]).view("<u4").reshape(scan, 4)
        del mm
        invalid = (w[:, 0] >> 31).astype(bool)
        seconds = (w[:, 0] & 0x3FFFFFFF).astype(np.int64)
        frame_nr = (w[:, 1] & 0xFFFFFF).astype(np.int64)
        thread = ((w[:, 3] >> 16) & 0x3FF).astype(np.int64)
        self._threads = np.unique(thread).tolist()
        n_thread = len(self._threads)

        if sample_rate is None:
            # frames are numbered within each second, so the rate can only
            # be inferred when the file crosses a second boundary
            if len(np.unique(seconds)) < 2:
                raise ValueError(
                    "file shorter than one second; pass sample_rate=")
            frames_per_sec = int(frame_nr.max()) + 1
            sample_rate = u.Quantity(frames_per_sec * spf, u.Hz)
        fps = int(round(sample_rate.to_value(u.Hz) / spf))

        # first frame in time (not necessarily first in the file)
        k0 = np.lexsort((frame_nr, seconds))[0]
        sec0, fnr0 = int(seconds[k0]), int(frame_nr[k0])
        time_idx = (seconds - sec0) * fps + (frame_nr - fnr0)
        n_times = int(time_idx.max()) + 1
        #: (time frame, thread) -> frame number in the file, -1 where the
        #: frame is missing; frames flagged invalid carry fill/junk
        #: payloads (standard for drop-outs) and are zero-filled exactly
        #: like missing frames
        self._frame_table = np.full((n_times, n_thread), -1, np.int64)
        ok = ~invalid
        self._frame_table[time_idx[ok], np.searchsorted(
            self._threads, thread[ok])] = np.arange(scan)[ok]
        frames_per_thread = n_times

        epoch_time = _ref_epoch_time(first["epoch"])
        start = epoch_time + u.Quantity(float(sec0), u.s) \
            + u.Quantity(fnr0 * spf / sample_rate.to_value(u.Hz), u.s)

        sample_shape = tuple(s for s in (nchan, n_thread) if s > 1)
        self._squeeze = (nchan, n_thread)
        dtype = np.complex64 if first["complex"] else np.float32
        super().__init__(
            shape=(frames_per_thread * spf,) + sample_shape,
            start_time=start, sample_rate=sample_rate,
            samples_per_frame=spf, dtype=dtype, device=device)

    def _locs(self, f0, n_frames):
        """(n_frames, n_thread) file frame numbers of time frames f0...,
        -1 where a frame is missing or invalid (or past the file)."""
        table = self._frame_table
        locs = np.full((n_frames, table.shape[1]), -1, np.int64)
        lo, hi = max(f0, 0), min(f0 + n_frames, table.shape[0])
        if hi > lo:
            locs[lo - f0:hi - f0] = table[lo:hi]
        return locs

    def _payloads(self, locs):
        return frame_payloads(self._fh, locs, self._frame_bytes,
                              self._header_len, self._payload_bytes)

    def _read_frame_host(self, frame_index):
        return self._read_frames_host(frame_index, 1)

    def _read_frames_host(self, f0, n_frames):
        """Time frames ``[f0, f0 + n_frames)`` decoded on the host at once
        (one read of their payloads, one LUT pass); missing or invalid
        frames are zeros."""
        nchan, n_thread = self._squeeze
        spf = self._samples_per_frame_file
        locs = self._locs(f0, n_frames)
        factor = 2 if self._complex else 1
        comp = _decode_payload(self._payloads(locs), self._bps).reshape(
            n_frames, n_thread, -1)[..., :spf * nchan * factor]
        comp[locs < 0] = 0  # missing frame: stays zero (invalid data)
        comp = np.ascontiguousarray(comp).reshape(
            n_frames, n_thread, spf, nchan, factor)
        x = comp.view(np.complex64)[..., 0] if self._complex \
            else comp[..., 0]
        x = np.moveaxis(x, 1, -1)            # (F, spf, nchan, thread)
        return x.reshape((n_frames * spf,) + self.sample_shape)

    # -- packed-payload ingest (device-side decode) -----------------------
    # The eager path above decodes on the host (native LUT); production
    # ingest ships the raw payload bits to the device and decodes them
    # inside the compiled pipeline (ops/unpack.py): 4-16x fewer bytes over
    # the host link and no host decode.

    @property
    def packed_alignment(self):
        """Samples per packed unit: reads must be frame-aligned."""
        return self._samples_per_frame_file

    def read_packed(self, offset, count):
        """Raw payloads for samples [offset, offset+count) as host numpy
        ``(words, mask)``.

        words : (n_frames, n_thread, payload_bytes // 4) int32
            The payload bytes, bit for bit (little-endian uint32 words as
            int32, the port's word convention).
        mask : (n_frames, n_thread) bool
            True where the frame is present and valid; missing or invalid
            frames decode to zeros, exactly like the host path's zero
            fill.

        Host work is file I/O only: no decode, no samplewise pass.
        """
        spf = self._samples_per_frame_file
        if offset % spf or count % spf:
            raise ValueError(
                f"packed reads must be frame-aligned: offset {offset} "
                f"and count {count} must be multiples of {spf}")
        locs = self._locs(offset // spf, count // spf)
        return up.words_from_bytes(self._payloads(locs)), locs >= 0

    def packed_decode_fn(self):
        """``decode((words, mask)) -> samples`` on the words' device: the
        device counterpart of the host decode, bit for bit against it
        (tests/test_torch_packed.py)."""
        spf = self._samples_per_frame_file
        nchan, n_thread = self._squeeze
        cplx = self._complex
        bps = self._bps
        if bps == 8:
            unpack = up.unpack_8bit
        elif bps == 4:
            unpack = up.unpack_4bit
        elif bps == 2:
            def unpack(w):
                return up.unpack_2bit(w, up.VDIF_2BIT_LEVELS)
        elif bps == 16:
            unpack = up.unpack_16bit
        elif bps == 32:
            unpack = up.f32_payload   # payload bytes ARE the f32 samples
        else:
            raise ValueError(f"unsupported bits-per-sample {bps}")
        keep = tuple(slice(None) if s > 1 else 0
                     for s in (nchan, n_thread))

        def decode(packed):
            words, mask = packed
            comp = unpack(words)
            n_frames = comp.shape[0]
            comp = torch.where(mask[:, :, None], comp, 0.0)
            if cplx:
                x = torch.view_as_complex(
                    comp.reshape(n_frames, n_thread, spf, nchan, 2))
            else:
                x = comp.reshape(n_frames, n_thread, spf, nchan)
            x = x.movedim(1, -1)           # (F, spf, nchan, thread)
            x = x.reshape((n_frames * spf, nchan, n_thread))
            return x[(slice(None),) + keep]

        return decode


class VDIFStreamWriter:
    """Write a stream to VDIF frames (one thread per trailing axis entry).

    ``write`` takes numpy arrays or tensors (on any device)."""

    def __init__(self, name, template, *, bps=8, samples_per_frame=None,
                 station=0, nthread=None):
        self._fh = None   # open last, after all validation
        self._bps = bps
        self._station = station
        shape = template.shape
        self._complex = np.dtype(template.dtype).kind == "c"
        # interpret sample shape as (nchan, nthread) / (n,) / ().  A 2-d
        # shape is ambiguous (the reader squeezes both multi-channel
        # single-thread and single-channel multi-thread files to 2-d):
        # default to channels -- the frequency axis, which must survive a
        # read->write round trip -- and let ``nthread`` select threads.
        if len(shape) == 1:
            self._nchan, self._nthread = 1, 1
        elif len(shape) == 2:
            if nthread is not None and nthread != 1:
                if shape[1] != nthread:
                    raise ValueError(f"template axis {shape[1]} != "
                                     f"nthread {nthread}")
                self._nchan, self._nthread = 1, shape[1]
            else:
                self._nchan, self._nthread = shape[1], 1
        else:
            self._nchan, self._nthread = shape[1], shape[2]
        if self._nchan & (self._nchan - 1):
            raise ValueError(
                f"VDIF requires a power-of-two channel count, got "
                f"{self._nchan}; pad channels or split threads")
        rate = template.sample_rate.to_value(u.Hz)
        epoch, sec0 = _time_to_epoch_seconds(template.start_time)
        e0 = _ref_epoch_time(epoch)
        # exact two-double seconds from the reference epoch (a single
        # float loses ~1e-8 s at decade-scale offsets)
        hi, lo = (template.start_time - e0).sec_pair
        frac = (hi - sec0) + lo
        offset_samples = int(round(frac * rate))
        if samples_per_frame is None:
            # the frame size must divide the sample rate (integer frames
            # per second) AND the start offset (frame-aligned start)
            g = math.gcd(int(round(rate)),
                         offset_samples if offset_samples else
                         int(round(rate)))
            samples_per_frame = min(1024, g)
            while samples_per_frame > 1 and g % samples_per_frame:
                samples_per_frame -= 1
        if rate % samples_per_frame or \
                offset_samples % samples_per_frame:
            raise ValueError(
                f"samples_per_frame {samples_per_frame} must divide the "
                f"sample rate and the start offset within the second")
        self._spf = samples_per_frame
        self._rate = rate
        factor = 2 if self._complex else 1
        payload_bits = samples_per_frame * self._nchan * bps * factor
        if payload_bits % 64:
            raise ValueError("frame payload must be a multiple of 8 bytes")
        self._payload_bytes = payload_bits // 8
        self._frame_len8 = (self._payload_bytes + 32) // 8
        self._epoch, self._sec0 = epoch, sec0
        self._frame0 = offset_samples // samples_per_frame
        self._frames_per_sec = int(round(rate / samples_per_frame))
        self._counter = 0
        self._buffer = np.zeros((0, self._nchan, self._nthread),
                                np.complex64 if self._complex
                                else np.float32)
        self._fh = open_file(name, "wb")

    def write(self, data):
        data = to_numpy(data)
        data = data.reshape(len(data), self._nchan, self._nthread)
        self._buffer = np.concatenate([self._buffer, data])
        n = len(self._buffer) // self._spf * self._spf
        for start in range(0, n, self._spf):
            self._emit(self._buffer[start:start + self._spf])
        self._buffer = self._buffer[n:]

    def _emit(self, block):
        abs_frame = self._frame0 + self._counter
        seconds = self._sec0 + abs_frame // self._frames_per_sec
        frame_nr = abs_frame % self._frames_per_sec
        lg2 = int(self._nchan).bit_length() - 1
        for t in range(self._nthread):
            hdr = _build_header(seconds, frame_nr, self._epoch,
                                self._frame_len8, lg2, t, self._bps,
                                self._complex, self._station)
            x = block[:, :, t]
            if self._complex:
                comp = np.stack([x.real, x.imag], axis=-1).reshape(-1)
            else:
                comp = x.reshape(-1)
            self._fh.write(hdr)
            self._fh.write(_encode_payload(comp.astype(np.float32),
                                           self._bps))
        self._counter += 1

    def close(self):
        if self._fh is not None:
            if len(self._buffer):
                # flush the tail as a zero-padded final frame rather than
                # silently truncating a non-frame-multiple stream
                n = len(self._buffer)
                warnings.warn(
                    f"zero-padding final VDIF frame: {n} buffered samples "
                    f"< samples_per_frame={self._spf}")
                pad = np.zeros((self._spf - n,) + self._buffer.shape[1:],
                               self._buffer.dtype)
                self._emit(np.concatenate([self._buffer, pad]))
                self._buffer = self._buffer[:0]
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def open_file(name, mode="rb"):
    import builtins
    return builtins.open(name, mode)


def open(name, mode="r", **kwargs):
    """Open a VDIF file: 'r' -> stream reader, 'w' -> writer
    (needs ``template=``)."""
    if mode == "r":
        return VDIFStreamReader(name, **kwargs)
    if mode == "w":
        return VDIFStreamWriter(name, **kwargs)
    raise ValueError(f"unknown mode {mode!r}")
