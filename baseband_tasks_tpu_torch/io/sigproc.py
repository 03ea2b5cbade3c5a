"""SIGPROC filterbank files: the search-mode interchange format.

Counterpart of ``baseband_tasks_tpu/io/sigproc.py``.  Single-dish search
pipelines (PRESTO, sigproc, heimdall, ...) exchange detected, channelized
power as ``.fil`` files: a self-describing binary header (length-prefixed
keyword records between HEADER_START and HEADER_END) followed by raw
(time, [IF,] channel) samples.  The upstream baseband-tasks has no
search-mode formats (its PSRFITS is fold-mode); this reader/writer closes
the loop for the survey models (`models.DMTrialSearch`,
`models.FourierDomainAccelSearch`).  The reader decodes on the host and
hands out tensors on its ``device`` (the card when there is one), as the
port's other readers do (``io/_host.py``); the writer takes numpy or
tensors on any device and writes the same bytes as the JAX package's.

Conventions honored: ``fch1`` is the centre frequency of the FIRST
channel with ``foff`` the (usually negative) channel step; ``tstart``
is the MJD of the first sample; ``nbits`` 8 (unsigned), 16 (unsigned)
or 32 (float32).  Frequencies become the stream's per-channel
``frequency`` attribute with ``sideband = sign(foff)``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..utils import Time, units as u
from ..utils.dtypes import to_numpy
from ._host import FileReader

__all__ = ["SigprocStreamReader", "SigprocStreamWriter", "open",
           "read_header", "detect_format"]

_INT_KEYS = {"telescope_id", "machine_id", "data_type", "barycentric",
             "pulsarcentric", "nbits", "nsamples", "nchans", "nifs",
             "nbeams", "ibeam"}
_DBL_KEYS = {"az_start", "za_start", "src_raj", "src_dej", "tstart",
             "tsamp", "fch1", "foff", "refdm", "period"}
_STR_KEYS = {"source_name", "rawdatafile"}


def _read_string(fh):
    (n,) = struct.unpack("<i", fh.read(4))
    if not 0 < n < 128:
        raise ValueError(f"bad sigproc header string length {n}")
    return fh.read(n).decode("ascii")


def _write_string(fh, s):
    b = s.encode("ascii")
    if not 0 < len(b) < 128:
        # the reader (and other sigproc implementations) use the
        # length-prefix range as the header sanity check
        raise ValueError(f"sigproc header string {s!r} must be 1-127 "
                         f"ASCII characters")
    fh.write(struct.pack("<i", len(b)) + b)


def read_header(fh):
    """Parse a sigproc header from an open binary file; returns
    (header dict, payload byte offset)."""
    fh.seek(0)
    if _read_string(fh) != "HEADER_START":
        raise ValueError("not a sigproc filterbank file "
                         "(no HEADER_START)")
    hdr = {}
    while True:
        key = _read_string(fh)
        if key == "HEADER_END":
            break
        if key in _INT_KEYS:
            (hdr[key],) = struct.unpack("<i", fh.read(4))
        elif key in _DBL_KEYS:
            (hdr[key],) = struct.unpack("<d", fh.read(8))
        elif key in _STR_KEYS:
            hdr[key] = _read_string(fh)
        else:
            raise ValueError(f"unknown sigproc header key {key!r}")
    return hdr, fh.tell()


def _payload_dtype(nbits):
    try:
        return {8: np.dtype("u1"), 16: np.dtype("<u2"),
                32: np.dtype("<f4")}[int(nbits)]
    except KeyError:
        raise ValueError(f"nbits={nbits} not supported (8, 16 or 32; "
                         f"sub-byte sigproc packing is not implemented)")


class SigprocStreamReader(FileReader):
    """Stream head over a sigproc filterbank file.

    Sample shape is ``(nchans,)`` (``(nifs, nchans)`` when nifs > 1);
    dtype float32 regardless of the stored bit depth.  ``device`` is where
    ``read()`` puts the samples (default: the card when there is one).
    """

    def __init__(self, name, samples_per_frame=None, device=None):
        import builtins
        self._fh = builtins.open(name, "rb")
        try:
            self._init_from_file(samples_per_frame, device)
        except Exception:
            self._fh.close()
            self._fh = None
            raise

    def _init_from_file(self, samples_per_frame, device):
        hdr, off = read_header(self._fh)
        self._hdr = hdr
        self._payload_offset = off
        nchan = int(hdr["nchans"])
        nifs = int(hdr.get("nifs", 1))
        self._nifs, self._nchan = nifs, nchan
        self._raw_dtype = _payload_dtype(hdr.get("nbits", 32))
        comp = nifs * nchan
        self._bytes_per_sample = comp * self._raw_dtype.itemsize
        size = os.fstat(self._fh.fileno()).st_size
        n = (size - off) // self._bytes_per_sample
        n_hdr = int(hdr.get("nsamples", 0))
        if n_hdr:
            n = min(n, n_hdr)
        sample_rate = u.Quantity(1.0 / float(hdr["tsamp"]), u.Hz)
        start = Time(float(int(hdr["tstart"])),
                     float(hdr["tstart"]) - int(hdr["tstart"]),
                     format="mjd", scale="utc")
        sample_shape = (nifs, nchan) if nifs > 1 else (nchan,)
        chans = float(hdr["fch1"]) + np.arange(nchan) * float(hdr["foff"])
        freq = u.Quantity(np.broadcast_to(chans, sample_shape).copy(),
                          u.MHz)
        sideband = 1 if float(hdr["foff"]) >= 0 else -1
        spf = samples_per_frame or min(max(n, 1), 1 << 14)
        super().__init__(shape=(n,) + sample_shape, start_time=start,
                         sample_rate=sample_rate, samples_per_frame=spf,
                         dtype=np.dtype("f4"), frequency=freq,
                         sideband=sideband, device=device)

    @property
    def header(self):
        """The parsed sigproc header (dict)."""
        return dict(self._hdr)

    def _read_frame_host(self, frame_index):
        spf = self._samples_per_frame
        start = frame_index * spf
        stop = min(start + spf, self._shape[0])
        count = stop - start
        self._fh.seek(self._payload_offset
                      + start * self._bytes_per_sample)
        raw = np.frombuffer(self._fh.read(count * self._bytes_per_sample),
                            self._raw_dtype)
        return raw.astype(np.float32).reshape((count,)
                                              + self.sample_shape)


class SigprocStreamWriter:
    """Write a (real, detected) stream as a sigproc filterbank file.

    Header values come from the ``template`` stream (times, rate,
    per-channel frequencies) plus keyword overrides (``source_name``,
    ``telescope_id``, ...).  ``nbits=32`` writes float32 verbatim;
    8/16 quantize with the explicit ``scale``/``offset``
    (``stored = clip(round(x * scale + offset))`` — lossy, sigproc
    carries no scale fields, so pick them to span the data).
    """

    def __init__(self, name, template, *, nbits=32, scale=1.0,
                 offset=0.0, source_name="unknown", telescope_id=0,
                 machine_id=0, **extra):
        import builtins
        if np.dtype(template.dtype).kind == "c":
            raise ValueError("sigproc filterbank holds detected (real) "
                             "data; Square/Power the stream first")
        sample_shape = template.shape[1:]
        if len(sample_shape) == 1:
            nifs, nchan = 1, sample_shape[0]
        elif len(sample_shape) == 2:
            nifs, nchan = sample_shape
        else:
            raise ValueError("sample shape must be (nchan,) or "
                             "(nifs, nchan)")
        self._raw_dtype = _payload_dtype(nbits)
        self._scale = float(scale)
        self._offset = float(offset)
        freq = getattr(template, "frequency", None)
        if freq is None:
            raise ValueError("template needs per-channel frequency "
                             "labels (SetAttribute them)")
        fv = np.broadcast_to(np.asarray(freq.to_value(u.MHz)),
                             sample_shape)
        fv = fv.reshape(nifs, nchan)[0]
        foff = float(fv[1] - fv[0]) if nchan > 1 else 0.0
        if nchan > 2 and not np.allclose(np.diff(fv), foff,
                                         rtol=0, atol=abs(foff) * 1e-6
                                         + 1e-12):
            raise ValueError("sigproc needs evenly spaced channels")
        hi, lo = template.start_time.mjd_pair
        hdr = {"telescope_id": int(telescope_id),
               "machine_id": int(machine_id),
               "data_type": 1,
               "source_name": str(source_name),
               "tstart": float(hi) + float(lo),
               "tsamp": 1.0 / template.sample_rate.to_value(u.Hz),
               "nbits": int(nbits), "nchans": int(nchan),
               "nifs": int(nifs), "fch1": float(fv[0]), "foff": foff}
        hdr.update(extra)
        # validate everything BEFORE creating the output file, so a bad
        # keyword cannot leave a truncated file (and a leaked handle)
        for key, val in hdr.items():
            if key not in _INT_KEYS | _DBL_KEYS | _STR_KEYS:
                raise ValueError(f"unknown sigproc header key {key!r}")
            if key in _STR_KEYS and not 0 < len(str(val)) < 128:
                raise ValueError(f"sigproc header string {key}={val!r} "
                                 f"must be 1-127 ASCII characters")
        self._fh = builtins.open(name, "wb")
        try:
            _write_string(self._fh, "HEADER_START")
            for key, val in hdr.items():
                _write_string(self._fh, key)
                if key in _INT_KEYS:
                    self._fh.write(struct.pack("<i", int(val)))
                elif key in _DBL_KEYS:
                    self._fh.write(struct.pack("<d", float(val)))
                else:
                    _write_string(self._fh, str(val))
            _write_string(self._fh, "HEADER_END")
        except Exception:
            self._fh.close()
            self._fh = None
            raise

    def write(self, data):
        """Append samples (numpy, or a tensor on any device)."""
        data = np.asarray(to_numpy(data), dtype=np.float32)
        if self._raw_dtype.kind == "f":
            raw = data.astype("<f4")
        else:
            info = np.iinfo(self._raw_dtype)
            raw = np.clip(np.round(data * self._scale + self._offset),
                          info.min, info.max).astype(self._raw_dtype)
        self._fh.write(raw.tobytes())

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open(name, mode="r", **kwargs):
    """Open a sigproc filterbank: 'r' -> stream reader, 'w' -> writer
    (needs ``template=``)."""
    if mode == "r":
        return SigprocStreamReader(name, **kwargs)
    if mode == "w":
        return SigprocStreamWriter(name, **kwargs)
    raise ValueError(f"unknown mode {mode!r}")


def detect_format(head, name):
    """Registry detector: sigproc files start with the HEADER_START
    length-prefixed string."""
    return head[:16] == b"\x0c\x00\x00\x00HEADER_START" or \
        name.lower().endswith(".fil")
