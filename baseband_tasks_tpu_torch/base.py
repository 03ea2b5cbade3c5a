"""Stream/task core.

Counterpart of ``baseband_tasks_tpu/base.py`` (itself modelled on the
upstream stream framework): every node in a pipeline looks like a
baseband file handle — ``shape``, ``dtype``, ``sample_rate``,
``start_time``, ``seek``/``tell``, ``read(count)`` — and wraps an
underlying handle ``ih``, so a pipeline is a lazy chain that computes
frames on demand.

- Frames are **torch tensors on the stream's device** (``device``, given
  to the sources and inherited by every task; a source built without one
  is on the card when there is one, else on the CPU); ``read()`` assembles
  outputs by slicing and concatenating them on that device, so a chain
  never bounces through host memory between stages.
- The ``dtype`` metadata stays a numpy dtype (it compares equal to the
  JAX package's); :func:`~.utils.dtypes.torch_dtype` gives the tensors'.
- Sample-pointer <-> time conversions use exact two-double arithmetic
  (``utils.time``) to keep ns-level bookkeeping off the device.
- At a stream's end a padded task re-reads a full window at an offset,
  so its frame function always sees the same shape.

``Base.compile()`` returns a read-compatible view that runs the chain
through ``models/compiled.CompiledPipeline`` (``models/view.py``).  The
JAX package's TPU performance hint has no counterpart: the class is
ported, nothing emits it.
"""

from __future__ import annotations

import inspect
import math
import operator
import warnings
from fractions import Fraction

import numpy as np
import torch

from .utils import Time, units as u
from .utils.dtypes import to_numpy, torch_dtype

__all__ = ["Base", "BaseTaskBase", "TaskBase", "PaddedTaskBase", "Task",
           "SetAttribute", "getattr_if_none", "check_broadcast_to",
           "simplify_shape", "FrameSizeWarning", "PerformanceHint"]

#: Stream attributes that propagate through tasks via ``meta``.
META_ATTRIBUTES = ("frequency", "sideband", "polarization")


def getattr_if_none(ih, attr, value=None, required=True):
    """Return ``value`` if not None, else ``getattr(ih, attr)``: task
    parameters default to the underlying stream's."""
    if value is None:
        value = getattr(ih, attr, None)
        if value is None and required:
            raise ValueError(
                f"{attr} not set and underlying stream does not have it; "
                f"pass it in explicitly.")
    return value


def check_broadcast_to(value, shape):
    """Check ``value`` broadcasts to ``shape``; return the broadcast array."""
    if isinstance(value, u.Quantity):
        return u.Quantity(np.broadcast_to(np.asarray(value.value), shape),
                          value.unit)
    return np.broadcast_to(value, shape)


def simplify_shape(value):
    """Strip leading length-1 dimensions from an attribute array."""
    arr = value.value if isinstance(value, u.Quantity) else np.asarray(value)
    arr = np.asarray(arr)
    shape = arr.shape
    first = 0
    while first < len(shape) and shape[first] == 1:
        first += 1
    arr = np.asarray(arr[(0,) * first])
    out = arr[()] if arr.ndim == 0 else arr
    return u.Quantity(out, value.unit) if isinstance(value, u.Quantity) else out


class Base:
    """Filehandle-like stream head: shape, rate, time, seek/tell/read.

    Subclasses implement ``_read_frame(frame_index)`` returning a tensor
    of ``(samples_per_frame,) + sample_shape`` on :attr:`device`.
    ``device=None`` means CUDA when ``torch.cuda.is_available()``, else
    the CPU; pass ``device="cpu"`` to keep a stream on the host.
    """

    def __init__(self, shape, start_time, sample_rate, *,
                 samples_per_frame=1, dtype=np.complex64,
                 frequency=None, sideband=None, polarization=None,
                 device=None):
        self._shape = tuple(operator.index(n) for n in shape)
        self._start_time = Time(start_time) if not isinstance(start_time, Time) \
            else start_time
        self._sample_rate = sample_rate
        self._samples_per_frame = operator.index(samples_per_frame)
        self._dtype = np.dtype(dtype)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self._device = torch.device(device)
        self._meta = {"__attributes__": {}}
        if (frequency is None) != (sideband is None):
            # one without the other is meaningless
            raise ValueError("frequency and sideband should both be passed "
                             "in.")
        for name, value in (("frequency", frequency), ("sideband", sideband),
                            ("polarization", polarization)):
            if value is not None:
                value = self._check_attribute(name, value)
            self._meta["__attributes__"][name] = value
        self._frame = None
        self._frame_index = None
        self._offset = 0
        self._closed = False

    def _check_attribute(self, name, value):
        if name == "sideband":
            value = np.where(np.asarray(value) < 0, -1, 1).astype(np.int8)
        elif name == "polarization":
            value = np.asarray(value)
        elif name == "frequency" and not isinstance(value, u.Quantity):
            raise TypeError("frequency must be a Quantity")
        broadcast_shape = self.sample_shape if self.sample_shape else (1,)
        check_broadcast_to(value, broadcast_shape)
        return simplify_shape(value)

    # -- shape / dtype / device ------------------------------------------
    @property
    def shape(self):
        return self._shape

    @property
    def sample_shape(self):
        return self._shape[1:]

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return math.prod(self._shape)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        """The torch device the stream's frames live on."""
        return self._device

    @property
    def complex_data(self):
        return self._dtype.kind == "c"

    @property
    def samples_per_frame(self):
        return self._samples_per_frame

    # -- metadata --------------------------------------------------------
    @property
    def meta(self):
        return self._meta

    def _get_attribute(self, name):
        value = self._meta["__attributes__"].get(name)
        if value is None:
            raise AttributeError(f"{name} not set on this stream")
        return value

    @property
    def frequency(self):
        return self._get_attribute("frequency")

    @property
    def sideband(self):
        return self._get_attribute("sideband")

    @property
    def polarization(self):
        return self._get_attribute("polarization")

    # -- time ------------------------------------------------------------
    @property
    def sample_rate(self):
        return self._sample_rate

    @property
    def start_time(self):
        return self._start_time

    @property
    def stop_time(self):
        return self._tell_time(self._shape[0])

    @property
    def time(self):
        """Time of the current sample pointer."""
        return self._tell_time(self._offset)

    def _tell_time(self, offset):
        from .utils.time import TimeDelta
        return self._start_time + TimeDelta.from_samples(
            offset, self._sample_rate.to_value(u.Hz))

    # -- seek / tell -----------------------------------------------------
    def seek(self, offset, whence=0):
        """Move the sample pointer.

        ``offset`` may be an integer number of samples, a time Quantity, or
        an absolute :class:`~baseband_tasks_tpu_torch.utils.Time` (whence
        ignored in that case).
        """
        if isinstance(offset, Time):
            offset = self._offset_from_time(offset)
            whence = 0
        elif isinstance(offset, u.Quantity):
            if offset.unit.is_equivalent(u.s):
                offset = offset.to_value(u.s) * self._sample_rate.to_value(u.Hz)
            else:
                offset = offset.to_value(u.one)
            offset = int(round(offset))
        offset = operator.index(offset)  # reject floats loudly, now
        if whence == 0 or whence == "start":
            self._offset = offset
        elif whence == 1 or whence == "current":
            self._offset += offset
        elif whence == 2 or whence == "end":
            self._offset = self._shape[0] + offset
        else:
            raise ValueError("invalid 'whence'; should be 0, 1 or 2")
        # like regular filehandles, out-of-range pointers are allowed;
        # reads validate the range
        return self._offset

    def _offset_from_time(self, time):
        dt = time - self._start_time
        hi, lo = dt.sec_pair
        rate = self._sample_rate.to_value(u.Hz)
        return int(round(hi * rate + lo * rate))

    def tell(self, unit=None):
        if unit is None:
            return self._offset
        if unit == "time" or isinstance(unit, Time):
            return self.time
        return (self._offset / self._sample_rate).to(unit)

    # -- read ------------------------------------------------------------
    def read(self, count=None, out=None):
        """Read ``count`` samples starting at the current pointer.

        Returns a tensor of shape ``(count,) + sample_shape`` on
        :attr:`device`; pass ``out=`` to have slices written into it
        instead.
        """
        if self._closed:
            raise ValueError("I/O operation on closed stream.")
        if self._offset < 0:
            raise OSError("cannot read from before the start of input.")
        samples_left = self._shape[0] - self._offset
        if count is not None:
            count = operator.index(count)
        if count is None or count < 0:
            count = max(samples_left, 0)
        if count > samples_left:
            raise EOFError("cannot read from beyond end of input.")

        frame_index, sample_off = divmod(self._offset, self._samples_per_frame)
        pieces = []
        sample = 0
        while sample < count:
            frame = self._get_frame_cached(frame_index)
            nsample = min(count - sample, len(frame) - sample_off)
            piece = frame[sample_off:sample_off + nsample]
            if out is None:
                pieces.append(piece)
            else:
                out[sample:sample + nsample] = piece
            sample += nsample
            sample_off = 0
            frame_index += 1
        self._offset += count
        if out is not None:
            return out
        if not pieces:
            return torch.zeros((0,) + self.sample_shape,
                               dtype=torch_dtype(self._dtype),
                               device=self._device)
        if len(pieces) == 1:
            return pieces[0]
        if not torch.is_tensor(pieces[0]):
            # frames of another type join themselves (integration.Integrated)
            return type(pieces[0]).cat(pieces)
        return torch.cat(pieces, dim=0)

    def _get_frame_cached(self, frame_index):
        if frame_index != self._frame_index:
            frame = self._read_frame(frame_index)
            # frames are returned as-is, so check the metadata contract
            if tuple(frame.shape[1:]) != tuple(self.sample_shape):
                raise ValueError(
                    f"frame sample shape {tuple(frame.shape[1:])} does "
                    f"not match the stream's {tuple(self.sample_shape)}")
            self._frame = frame
            self._frame_index = frame_index
        return self._frame

    def _read_frame(self, frame_index):  # pragma: no cover - abstract
        raise NotImplementedError

    def compile(self, *, block_samples=None, fuse=True, mesh=None,
                shard_axis="time"):
        """A read-compatible view backed by the compiled chain.

        Same filehandle protocol (``seek``/``read``/``tell``/meta), but
        frames come from a :class:`~.models.compiled.CompiledPipeline`
        stepped over source blocks, with its kernel fusions.  Warmup and
        the streaming delay are handled internally, so
        ``stream.compile().read(n) == stream.read(n)`` over the whole
        stream (head and tail edges are served eagerly; the midsection
        matches to the streaming-exactness contract of
        ``models/compiled.py``).  Pass ``mesh`` (a ``parallel.Mesh``) to
        run each step time-sharded over its ``shard_axis`` shards
        (:class:`~.models.sharded.ShardedPipeline`), behind the same
        read-compatible API.
        """
        from .models.view import compile_stream
        return compile_stream(self, block_samples=block_samples, fuse=fuse,
                              mesh=mesh, shard_axis=shard_axis)

    # -- conversions / niceties ------------------------------------------
    def __getitem__(self, item):
        from .shaping import GetItem, GetSlice
        if isinstance(item, slice):
            return GetSlice(self, item)
        if isinstance(item, tuple) and item and isinstance(item[0], slice):
            # sh[t_slice, sample_index...]: slice time first, then select.
            time_part, rest = item[0], item[1:]
            base = self if time_part == slice(None) \
                else GetSlice(self, time_part)
            if not rest:       # sh[:10,] — trailing comma, numpy-style
                return base
            return GetItem(base, rest if len(rest) > 1 else rest[0])
        return GetItem(self, item)

    def __array__(self, dtype=None, copy=None):
        old_offset = self._offset
        try:
            self.seek(0)
            data = to_numpy(self.read())
        finally:
            self._offset = old_offset
        if dtype is not None:
            data = data.astype(dtype, copy=False)
        return data

    # explicit np.asarray(sh) is supported above, but ufuncs/functions
    # must not silently materialize a whole (possibly huge) stream
    def __array_ufunc__(self, *args, **kwargs):
        return NotImplemented

    def __array_function__(self, *args, **kwargs):
        return NotImplemented

    def close(self):
        self._frame = None
        self._frame_index = None
        self._closed = True

    @property
    def closed(self):
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def _repr_item(self, name):
        """Value for a constructor parameter, searched as attribute,
        _attribute, or meta attribute."""
        for candidate in (name, "_" + name):
            if hasattr(self, candidate):
                return getattr(self, candidate)
        return self._meta.get("__attributes__", {}).get(name)

    @staticmethod
    def _repr_value(value):
        if isinstance(value, Time):
            return value.isot if value.isscalar else f"<Time {value.shape}>"
        arr = getattr(value, "value", value)
        if isinstance(arr, np.ndarray) and arr.size > 4:
            return f"<{type(value).__name__} {arr.shape}>"
        return repr(value)

    def __repr__(self):
        """Auto-repr from the constructor signature: every parameter that
        resolves to a set attribute is shown; chained handles indent."""
        cls = type(self)
        try:
            params = list(inspect.signature(cls.__init__).parameters
                          .values())[1:]
        except (TypeError, ValueError):
            params = []
        parts = []
        for par in params:
            if par.name in ("ih", "ihs") or par.kind in (
                    par.VAR_POSITIONAL, par.VAR_KEYWORD):
                continue
            value = self._repr_item(par.name)
            if value is None:
                continue
            parts.append(f"{par.name}={self._repr_value(value)}")
        head = f"{cls.__name__}({', '.join(parts)})"
        ih = getattr(self, "ih", None)
        ihs = getattr(self, "ihs", None)
        if ih is not None:
            sub = repr(ih).replace("\n", "\n   ")
            head += f"\nih: {sub}"
        elif ihs:
            for k, sub_ih in enumerate(ihs):
                sub = repr(sub_ih).replace("\n", "\n   ")
                head += f"\nihs[{k}]: {sub}"
        return head


class BaseTaskBase(Base):
    """A stream node wrapping an underlying handle ``ih``.

    All parameters default to the underlying stream's, the device
    included, and meta attributes propagate unless overridden.
    """

    def __init__(self, ih, *, shape=None, start_time=None, sample_rate=None,
                 samples_per_frame=None, dtype=None,
                 frequency=None, sideband=None, polarization=None):
        self.ih = ih
        shape = getattr_if_none(ih, "shape", shape)
        start_time = getattr_if_none(ih, "start_time", start_time)
        sample_rate = getattr_if_none(ih, "sample_rate", sample_rate)
        dtype = getattr_if_none(ih, "dtype", dtype)
        if samples_per_frame is None:
            samples_per_frame = getattr(ih, "samples_per_frame", 1)
        # Inherit meta attributes when not overridden.
        inherited = getattr(ih, "meta", {}).get("__attributes__", {})
        if frequency is None:
            frequency = inherited.get("frequency")
        if sideband is None:
            sideband = inherited.get("sideband")
        if polarization is None:
            polarization = inherited.get("polarization")
        super().__init__(shape=shape, start_time=start_time,
                         sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, dtype=dtype,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization,
                         device=getattr(ih, "device", None))

    def close(self):
        super().close()
        # drop our reference only; the underlying stream stays open
        self.__dict__.pop("ih", None)


class TaskBase(BaseTaskBase):
    """A stream node computing output frames as ``task(input_block)``.

    Handles sample-rate changes: ``ih_samples_per_frame`` input samples map
    to ``samples_per_frame`` output samples per frame; complete groups of
    ``q`` input <-> ``p`` output samples (``p/q`` the reduced rate ratio)
    define how much of a trailing partial block is usable.
    """

    def __init__(self, ih, *, ih_samples_per_frame=None, shape=None,
                 sample_rate=None, samples_per_frame=None, **kwargs):
        sample_rate = getattr_if_none(ih, "sample_rate", sample_rate)
        # Determine the rate ratio as an exact fraction.
        ratio = self._rate_ratio(sample_rate, ih.sample_rate)
        p, q = ratio.numerator, ratio.denominator
        if ih_samples_per_frame is None:
            if samples_per_frame is not None:
                ih_samples_per_frame = samples_per_frame * q // p
            else:
                ih_samples_per_frame = getattr(ih, "samples_per_frame", 1)
                ih_samples_per_frame = max(ih_samples_per_frame // q, 1) * q
        if samples_per_frame is None:
            samples_per_frame = ih_samples_per_frame * p // q
        if samples_per_frame * q != ih_samples_per_frame * p:
            raise ValueError(
                f"samples_per_frame {samples_per_frame} inconsistent with "
                f"input frame {ih_samples_per_frame} and rate ratio {ratio}")
        self._ih_samples_per_frame = ih_samples_per_frame
        ih_n = ih.shape[0]
        nframe, extra_in = divmod(ih_n, ih_samples_per_frame)
        usable_extra_in = (extra_in // q) * q
        extra_out = usable_extra_in * p // q
        n_out = nframe * samples_per_frame + extra_out
        self._ih_stop = nframe * ih_samples_per_frame + usable_extra_in
        if shape is None:
            shape = (n_out,) + self._output_sample_shape(ih)
        super().__init__(ih, shape=shape, sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, **kwargs)

    @staticmethod
    def _rate_ratio(sample_rate, ih_sample_rate):
        """Exact output/input sample-rate ratio as a Fraction.

        float64 values and unit scales are themselves exact binary
        rationals, so the quotient is formed in exact integer arithmetic.
        Only when the exact ratio is not simple (float-noise inputs like
        44.1 kHz) is it snapped to the nearest simple fraction, and only
        if that reproduces the exact ratio to 1 part in 1e12.
        """
        def as_fraction(q):
            v = np.asarray(q.value)
            if v.ndim:
                raise ValueError("sample rates must be scalar")
            return Fraction(float(v)) * Fraction(q.unit.scale)

        exact = as_fraction(sample_rate) / as_fraction(ih_sample_rate)
        if exact <= 0:
            raise ValueError(f"sample rate ratio {float(exact)} must be "
                             f"positive")
        if exact.denominator <= 1 << 40:
            return exact
        approx = exact.limit_denominator(10 ** 9)
        if abs(approx - exact) <= exact / 10 ** 12:
            return approx
        raise ValueError(f"sample rate ratio {float(exact)} is not a "
                         f"simple fraction")

    def _output_sample_shape(self, ih):
        return ih.sample_shape

    def task(self, data):  # pragma: no cover - abstract unless set
        raise NotImplementedError

    def _seek_frame(self, frame_index):
        """Input-range for output frame ``frame_index`` -> (start, stop)."""
        start = frame_index * self._ih_samples_per_frame
        stop = min(start + self._ih_samples_per_frame, self._ih_stop)
        return start, stop

    def _read_frame(self, frame_index):
        start, stop = self._seek_frame(frame_index)
        self.ih.seek(start)
        data = self.ih.read(stop - start)
        return self.task(data)


class PerformanceHint(UserWarning):
    """Advisory that a faster execution path exists.  Distinct category so
    it can be filtered without hiding real warnings."""


class FrameSizeWarning(UserWarning):
    """Advisory: a user-chosen frame size is FFT-slow or pad-inefficient.

    Purely informational — the computation is still correct.
    """


class PaddedTaskBase(TaskBase):
    """Overlap-save stream node: frames need padding samples on both sides.

    An output frame of ``samples_per_frame`` samples is computed from
    ``pad_start + samples_per_frame + pad_end`` input samples; successive
    input windows overlap.  The default frame size keeps padding overhead
    below 25% and rounds the padded window to an FFT-fast length.  At the
    stream end, a full-size window is re-read at an offset.
    """

    def __init__(self, ih, pad_start=0, pad_end=0, *, samples_per_frame=None,
                 next_fast_len=None, **kwargs):
        self._pad_start = operator.index(pad_start)
        self._pad_end = operator.index(pad_end)
        if self._pad_start < 0 or self._pad_end < 0:
            raise ValueError("padding values should be 0 or positive.")
        pad = self._pad_start + self._pad_end
        if samples_per_frame is None:
            samples_per_frame = max(3 * pad, 1)
            if next_fast_len is not None:
                padded = next_fast_len(samples_per_frame + pad)
                samples_per_frame = padded - pad
        else:
            total = samples_per_frame + pad
            if next_fast_len is not None and next_fast_len(total) != total:
                warnings.warn(
                    f"padded frame size {total} is not an FFT-fast length; "
                    f"consider samples_per_frame="
                    f"{next_fast_len(total) - pad}", FrameSizeWarning)
            if pad > 0 and samples_per_frame < 3 * pad:
                warnings.warn(
                    f"{type(self).__name__} efficiency below 75%: padding "
                    f"{pad} vs frame {samples_per_frame}; increase "
                    f"samples_per_frame.", FrameSizeWarning)
        n_out = ih.shape[0] - pad
        if n_out < 1:
            raise ValueError(
                f"input stream too short: {ih.shape[0]} samples cannot "
                f"support padding of {pad}")
        samples_per_frame = min(samples_per_frame, n_out)
        self._padded_samples_per_frame = samples_per_frame + pad
        super().__init__(ih, ih_samples_per_frame=samples_per_frame,
                         samples_per_frame=samples_per_frame,
                         shape=(n_out,) + self._output_sample_shape(ih),
                         **kwargs)
        # start_time shifts by pad_start samples of the underlying stream.
        if self._pad_start:
            self._start_time = (
                self._start_time
                + self._samples_to_timedelta(self._pad_start,
                                             ih.sample_rate))

    @staticmethod
    def _samples_to_timedelta(n, sample_rate):
        from .utils.time import TimeDelta
        return TimeDelta.from_samples(n, sample_rate.to_value(u.Hz))

    @property
    def pad_start(self):
        return self._pad_start

    @property
    def pad_end(self):
        return self._pad_end

    def _seek_frame(self, frame_index):
        start = frame_index * self._samples_per_frame
        stop = start + self._padded_samples_per_frame
        # Clamp to the stream end by re-reading a full window at an offset;
        # _frame_offset records how far into the window this frame starts.
        ih_n = self.ih.shape[0]
        if stop > ih_n:
            shift = stop - ih_n
            start -= shift
            stop = ih_n
            self._frame_offset = shift
        else:
            self._frame_offset = 0
        return start, stop

    def _read_frame(self, frame_index):
        start, stop = self._seek_frame(frame_index)
        offset = self._frame_offset
        self.ih.seek(start)
        data = self.ih.read(stop - start)
        out = self.task(data)
        if offset:
            out = out[offset:]
        return out


class Task(TaskBase):
    """Wrap a user callable as a stream task.

    The callable is used as a method (receiving the task instance) if its
    signature has a second positional argument, else as a plain function
    of the data block.
    """

    def __init__(self, ih, task, *, method=None, **kwargs):
        if method is None:
            method = self._is_method(task)
        if method:
            import types
            # MethodType also handles already-bound callables (the Task
            # instance becomes the first *free* argument)
            self.task = types.MethodType(task, self)
        else:
            self.task = task
        super().__init__(ih, **kwargs)

    @staticmethod
    def _is_method(func):
        """One *required* argument = function, two = method; anything
        else (or an un-inspectable callable) raises, so mistakes fail at
        construction."""
        try:
            sig = inspect.signature(func)
            params = [p for p in sig.parameters.values()
                      if p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)]
            n_required = sum(p.default is p.empty for p in params)
            assert 1 <= n_required <= 2
            return n_required == 2
        except Exception as exc:
            raise TypeError(
                "cannot determine whether ``task`` is a function or "
                "method; pass in ``method``.") from exc


class SetAttribute(BaseTaskBase):
    """Attach or override stream attributes without touching the data.

    Zero-copy: frames pass straight through.  Overriding ``sample_rate`` or
    ``start_time`` relabels the stream without resampling.
    """

    def __init__(self, ih, *, start_time=None, sample_rate=None,
                 frequency=None, sideband=None, polarization=None):
        super().__init__(ih, start_time=start_time, sample_rate=sample_rate,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization)

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        start = frame_index * spf
        stop = min(start + spf, self.ih.shape[0])
        self.ih.seek(start)
        return self.ih.read(stop - start)
