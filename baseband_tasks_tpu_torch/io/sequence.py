"""Multi-file observation sequences.

Counterpart of ``baseband_tasks_tpu/io/sequence.py``.

Real observations rarely fit one file: GUPPI scans are split into
numbered ``*.raw`` segments, DADA ring buffers are dumped as one file
per buffer, VDIF captures roll over on size.  The reference handles
this through ``baseband``'s ``sequentialfile`` helpers (open a list of
raw files, or a ``FileNameSequencer`` template, as a single file
object).  Here the splice happens one level up, at the *stream* layer:
``SequentialStreamReader`` presents an ordered set of per-file streams
— any registered format — as one seekable stream, and
``SequentialStreamWriter`` splits a written stream into fixed-length
files, re-deriving each file's start time from the global sample
offset.  Working on streams rather than raw bytes means the splice is
format-agnostic and every file keeps a self-consistent header.

Reference analogue: ``baseband.helpers.sequentialfile`` (used via
``baseband.open(list_of_files)``); the ``FileNameSequencer`` mirrors
``baseband.helpers.sequentialfile.FileNameSequencer``.
"""

from __future__ import annotations

import glob as _glob
import os
import re

import numpy as np

from ..utils import units as u
from ..utils.dtypes import to_numpy
from ._host import FileReader

__all__ = ["FileNameSequencer", "SequentialStreamReader",
           "SequentialStreamWriter", "open"]


class FileNameSequencer:
    """Generate file names from a template with a ``{file_nr}`` field.

    The template is formatted with ``file_nr=index`` plus any entries of
    ``values`` (e.g. header cards), so ``'scan_{file_nr:04d}.raw'``
    yields ``scan_0000.raw, scan_0001.raw, ...``.  Negative indices
    count back from the number of files that exist on disk, and
    ``len()`` returns that number (the reference's sequencer from
    ``baseband.helpers.sequentialfile`` behaves the same way).
    """

    def __init__(self, template, values=None):
        self.template = template
        self.values = dict(values or {})
        if "{file_nr" not in template.replace(" ", ""):
            # accept any field spelled file_nr with format spec
            if not re.search(r"\{file_nr[^}]*\}", template):
                raise ValueError("template must contain a {file_nr} field")

    def __getitem__(self, file_nr):
        if file_nr < 0:
            file_nr += len(self)
            if file_nr < 0:
                raise IndexError("file number out of range")
        return self.template.format(file_nr=file_nr, **self.values)

    def __len__(self):
        i = 0
        while os.path.exists(self.template.format(file_nr=i,
                                                  **self.values)):
            i += 1
        return i


def _resolve_names(name, mode):
    """Normalize ``name`` into a list (read) or a lazy sequencer (write)."""
    if isinstance(name, FileNameSequencer):
        if "w" in mode:
            return name
        names = [name[i] for i in range(len(name))]
        if not names:
            raise FileNotFoundError(
                f"no files match template {name.template!r}")
        return names
    if isinstance(name, (list, tuple)):
        if not name:
            raise ValueError("empty file sequence")
        return list(name)
    if isinstance(name, str) and re.search(r"\{file_nr[^}]*\}", name):
        return _resolve_names(FileNameSequencer(name), mode)
    if isinstance(name, str) and _glob.has_magic(name):
        if "w" in mode:
            raise ValueError("cannot write to a glob pattern; pass a "
                             "list of names or a {file_nr} template")
        names = sorted(_glob.glob(name))
        if not names:
            raise FileNotFoundError(f"no files match {name!r}")
        return names
    return None  # not a sequence


def is_sequence(name):
    """Whether ``name`` denotes a multi-file sequence (list/tuple,
    ``FileNameSequencer``, glob pattern, or ``{file_nr}`` template)."""
    if isinstance(name, (FileNameSequencer, list, tuple)):
        return True
    return isinstance(name, str) and (
        re.search(r"\{file_nr[^}]*\}", name) is not None
        or _glob.has_magic(name))


def _default_opener(format=None, **kwargs):
    from ..registry import FORMATS, detect_format, _load_entry_points
    _load_entry_points()

    def opener(name, mode="r"):
        fmt = format if format is not None else detect_format(name)
        return FORMATS[fmt][0](name, mode, **kwargs)

    return opener


class SequentialStreamReader(FileReader):
    """Read an ordered set of per-file streams as one stream.

    Parameters
    ----------
    names : list of str
        File names, in time order.
    opener : callable, optional
        ``opener(name, mode='r') -> stream``.  Default: auto-detect the
        format of each file via the registry (all files must share one
        format unless ``format=`` is given).
    samples_per_frame : int, optional
        Output frame size; default: the first file's.
    tolerance : Quantity, optional
        Maximum allowed gap/overlap between the end of one file and the
        start of the next.  Default ``min(1 ns, 0.01 sample)`` — the
        same contiguity bar the combining tasks use.
    device : torch device, optional
        Where ``read()`` puts the samples (default: the card when there
        is one); the files are read on the host.
    **kwargs
        Passed through to the per-file opener (e.g. ``format=``, or
        format-specific options).
    """

    _max_open = 3  # per-file readers kept open (LRU)

    def __init__(self, names, opener=None, *, samples_per_frame=None,
                 tolerance=None, device=None, **kwargs):
        self._names = list(names)
        if opener is None:
            opener = _default_opener(**kwargs)
        elif kwargs:
            raise TypeError("cannot pass extra arguments together with "
                            "an explicit opener")
        self._opener = opener
        self._cache = {}          # index -> open reader
        self._cache_order = []    # LRU order, most recent last
        try:
            self._init_from_files(samples_per_frame, tolerance, device)
        except Exception:
            for reader in self._cache.values():
                reader.close()
            self._cache.clear()
            self._cache_order.clear()
            raise

    def _init_from_files(self, samples_per_frame, tolerance, device):
        first = self._reader(0)
        rate_hz = first.sample_rate.to_value(u.Hz)
        if tolerance is None:
            tolerance = min(1e-9, 0.01 / rate_hz)
        else:
            tolerance = tolerance.to_value(u.s)

        lengths = [first.shape[0]]
        expected = first.stop_time
        for i in range(1, len(self._names)):
            r = self._reader(i)
            if r.sample_shape != first.sample_shape:
                raise ValueError(
                    f"file {self._names[i]} sample shape {r.sample_shape} "
                    f"!= {first.sample_shape} of {self._names[0]}")
            if r.dtype != first.dtype:
                raise ValueError(
                    f"file {self._names[i]} dtype {r.dtype} != "
                    f"{first.dtype} of {self._names[0]}")
            if abs(r.sample_rate.to_value(u.Hz) - rate_hz) > 1e-6 * rate_hz:
                raise ValueError(
                    f"file {self._names[i]} sample rate {r.sample_rate} "
                    f"!= {first.sample_rate} of {self._names[0]}")
            gap = (r.start_time - expected).sec
            if abs(gap) > tolerance:
                raise ValueError(
                    f"file {self._names[i]} starts {gap:.3g} s away from "
                    f"the end of the previous file (tolerance "
                    f"{tolerance:.3g} s); streams must be contiguous")
            lengths.append(r.shape[0])
            expected = r.stop_time

        self._lengths = np.asarray(lengths, dtype=np.int64)
        self._file_offsets = np.concatenate(
            ([0], np.cumsum(self._lengths)))
        n = int(self._file_offsets[-1])
        if samples_per_frame is None:
            samples_per_frame = min(first.samples_per_frame, n)
        attrs = first.meta.get("__attributes__", {})
        super().__init__(
            shape=(n,) + first.sample_shape,
            start_time=first.start_time, sample_rate=first.sample_rate,
            samples_per_frame=samples_per_frame, dtype=first.dtype,
            frequency=attrs.get("frequency"),
            sideband=attrs.get("sideband"),
            polarization=attrs.get("polarization"), device=device)

    @property
    def files(self):
        """The file names in the sequence."""
        return list(self._names)

    def _reader(self, index):
        reader = self._cache.get(index)
        if reader is None:
            reader = self._opener(self._names[index], "r")
            self._cache[index] = reader
            while len(self._cache) > self._max_open:
                oldest = self._cache_order.pop(0)
                self._cache.pop(oldest).close()
        else:
            self._cache_order.remove(index)
        self._cache_order.append(index)
        return reader

    def _read_frame_host(self, frame_index):
        spf = self._samples_per_frame
        start = frame_index * spf
        stop = min(start + spf, self._shape[0])
        i = int(np.searchsorted(self._file_offsets, start,
                                side="right")) - 1
        pieces = []
        while start < stop:
            reader = self._reader(i)
            local = start - int(self._file_offsets[i])
            count = min(stop - start, int(self._lengths[i]) - local)
            host = getattr(reader, "read_host", None)
            if host is not None:
                pieces.append(host(local, count))
            else:
                reader.seek(local)
                pieces.append(to_numpy(reader.read(count)))
            start += count
            i += 1
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    def _close_file(self):
        for reader in self._cache.values():
            reader.close()
        self._cache.clear()
        self._cache_order.clear()


class _ShiftedTemplate:
    """Template proxy for per-file writers: the global template with
    start time advanced to a given sample offset and the time axis cut
    to the file length.  Everything else defers to the template."""

    def __init__(self, template, start_time, n):
        self._template = template
        self._start_time = start_time
        self._n = n

    @property
    def start_time(self):
        return self._start_time

    @property
    def shape(self):
        return (self._n,) + tuple(self._template.shape[1:])

    def __getattr__(self, name):
        return getattr(self._template, name)


class SequentialStreamWriter:
    """Write a stream into fixed-length numbered files.

    Parameters
    ----------
    names : list of str or FileNameSequencer
        Target file names.  A list bounds the total length; a sequencer
        is unbounded.
    template : stream
        Source of shape/dtype/rate/start time/metadata (the same
        template every single-file writer takes).
    samples_per_file : int
        Time samples per file (the last file may be shorter).
    opener : callable, optional
        ``opener(name, mode='w', template=...) -> writer``.  Default:
        the registry's writer for ``format=`` (required then).
    **kwargs
        Passed to each per-file writer (e.g. ``format='dada'``,
        ``nbit=8``).
    """

    def __init__(self, names, template, *, samples_per_file,
                 opener=None, format=None, **kwargs):
        if samples_per_file <= 0:
            raise ValueError("samples_per_file must be positive")
        self._names = names
        self._template = template
        self._samples_per_file = int(samples_per_file)
        if opener is None:
            if format is None:
                raise ValueError("writing a sequence requires format= "
                                 "or an explicit opener")
            from ..registry import FORMATS, _load_entry_points
            _load_entry_points()
            fmt_open = FORMATS[format][0]

            def opener(name, mode="w", template=None):
                return fmt_open(name, mode, template=template, **kwargs)
        elif kwargs or format is not None:
            raise TypeError("cannot pass extra arguments together with "
                            "an explicit opener")
        self._opener = opener
        self._offset = 0
        self._writer = None
        self._file_nr = 0
        self._rate_hz = template.sample_rate.to_value(u.Hz)
        self._closed = False

    def _name(self, file_nr):
        if isinstance(self._names, FileNameSequencer):
            return self._names[file_nr]
        try:
            return self._names[file_nr]
        except IndexError:
            raise EOFError(
                f"out of file names after {file_nr} files "
                f"({self._offset} samples written)") from None

    def write(self, data):
        if self._closed:
            raise ValueError("I/O operation on closed writer")
        data = to_numpy(data)
        spf = self._samples_per_file
        while len(data):
            in_file = self._offset % spf
            if self._writer is None:
                from ..utils.time import TimeDelta
                start = self._template.start_time + TimeDelta.from_samples(
                    self._offset, self._rate_hz)
                shifted = _ShiftedTemplate(self._template, start, spf)
                self._writer = self._opener(self._name(self._file_nr),
                                            "w", template=shifted)
            n = min(len(data), spf - in_file)
            self._writer.write(data[:n])
            data = data[n:]
            self._offset += n
            if (self._offset % spf) == 0:
                self._writer.close()
                self._writer = None
                self._file_nr += 1

    def tell(self):
        return self._offset

    def close(self):
        if not self._closed:
            if self._writer is not None:
                self._writer.close()
                self._writer = None
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def open(name, mode="r", **kwargs):
    """Open a multi-file sequence for stream reading or writing.

    ``name`` may be a list/tuple of file names, a ``FileNameSequencer``,
    a glob pattern (read only), or a string template containing
    ``{file_nr}``.  Writing requires ``template=``, ``samples_per_file=``
    and a ``format=`` (or ``opener=``).
    """
    if mode == "r":
        names = _resolve_names(name, mode)
        if names is None:
            names = [name]
        return SequentialStreamReader(names, **kwargs)
    if mode == "w":
        names = _resolve_names(name, mode)
        if names is None:
            raise ValueError("writing a sequence requires a list of "
                             "names or a {file_nr} template")
        return SequentialStreamWriter(names, **kwargs)
    raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")
