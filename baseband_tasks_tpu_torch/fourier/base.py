"""FFT engine abstraction.

Counterpart of ``baseband_tasks_tpu/fourier/base.py`` (itself modelled on
the upstream ``fourier`` layer: ``FFTBase`` planned transforms,
``FFTMakerBase`` factories, the ``fft_maker`` engine selector):

- An :class:`FFTBase` instance is a metadata record (shapes, dtypes, axis,
  norm, frequency axis) around a transform; PyTorch needs no planning
  step, so the transform itself is a plain call.
- Engines: 'xla' (the default device engine, ``torch.fft``; the name is
  kept from the JAX package so ``fft_maker.set(name)`` means the same
  on both sides), 'pallas' (the hand-written four-step kernels) and
  'numpy' (host).
- ``next_fast_len`` rounds block sizes up to 2/3/5-smooth values.

Conventions match numpy: forward FFT unscaled, inverse scaled by 1/n,
optional ``ortho`` 1/sqrt(n) on both; real input uses rfft with
``n//2 + 1`` output channels.  Dtypes are numpy dtypes.
"""

from __future__ import annotations

import contextlib
import operator

import numpy as np

__all__ = ["FFTBase", "FFTMakerBase", "FFTMakerMeta", "fft_maker",
           "FFT_MAKER_CLASSES", "next_fast_len"]

#: Registry of engine classes keyed by name ('xla', 'numpy', 'pallas').
FFT_MAKER_CLASSES = {}


def next_fast_len(n):
    """Smallest 2,3,5-smooth integer >= n.

    >>> from baseband_tasks_tpu_torch.fourier import next_fast_len
    >>> next_fast_len(7919)
    8000
    >>> next_fast_len(1024)
    1024
    """
    if n <= 6:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()  # power of two always works
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            # round p35 * 2**k up to >= n
            if p35 >= n:
                best = min(best, p35)
            else:
                k = (n + p35 - 1) // p35
                pow2 = 1 << (k - 1).bit_length()
                best = min(best, p35 * pow2)
            p35 *= 3
        p5 *= 5
    return best


class FFTBase:
    """A single planned FFT: fixed shape, dtype, axis and direction.

    Subclasses implement ``_fft(data)``; this class carries all metadata,
    including the physical frequency axis when a ``sample_rate`` is given.
    """

    def __init__(self, direction, time_shape, time_dtype, axis=0, ortho=False,
                 sample_rate=None):
        assert direction in ("forward", "backward")
        self._direction = direction
        self._axis = operator.index(axis)
        self._ortho = bool(ortho)
        self._sample_rate = sample_rate
        self._time_shape = tuple(time_shape)
        self._time_dtype = np.dtype(time_dtype)
        (self._frequency_shape,
         self._frequency_dtype) = self._get_frequency_data_info(
            self._time_shape, self._time_dtype, self._axis)

    @staticmethod
    def _get_frequency_data_info(shape, dtype, axis):
        shape = tuple(shape)
        if not shape:
            raise ValueError("cannot plan an FFT over an empty shape ()")
        axis = operator.index(axis)
        if not -len(shape) <= axis < len(shape):
            raise ValueError(f"axis {axis} out of bounds for a "
                             f"{len(shape)}-dimensional transform")
        axis = axis % len(shape)   # tuple slicing below needs axis >= 0
        dtype = np.dtype(dtype)
        if dtype.kind == "f":
            freq_dtype = np.dtype(f"c{dtype.itemsize * 2}")
            freq_shape = (shape[:axis] + (shape[axis] // 2 + 1,)
                          + shape[axis + 1:])
        else:
            freq_dtype = dtype
            freq_shape = tuple(shape)
        return freq_shape, freq_dtype

    # -- metadata --------------------------------------------------------
    @property
    def direction(self):
        return self._direction

    @property
    def axis(self):
        return self._axis

    @property
    def ortho(self):
        return self._ortho

    @property
    def sample_rate(self):
        return self._sample_rate

    @property
    def time_shape(self):
        return self._time_shape

    @property
    def time_dtype(self):
        return self._time_dtype

    @property
    def frequency_shape(self):
        return self._frequency_shape

    @property
    def frequency_dtype(self):
        return self._frequency_dtype

    @property
    def real_input(self):
        return self._time_dtype.kind == "f"

    @property
    def frequency(self):
        """Sample frequencies along the transform axis.

        A (n, 1, ..) column so it broadcasts against trailing sample
        dimensions.  A Quantity if ``sample_rate`` is one, else a plain
        array of cycles/sample.
        """
        n = self._time_shape[self._axis]
        if self.real_input:
            freqs = np.fft.rfftfreq(n)
        else:
            freqs = np.fft.fftfreq(n)
        rate = self._sample_rate
        if rate is None:
            rate = 1.0
        out = freqs * rate
        trailing = len(self._time_shape) - self._axis - 1
        if trailing:
            new_shape = out.shape + (1,) * trailing
            out = out.reshape(new_shape)
        return out

    # -- behaviour -------------------------------------------------------
    def __call__(self, data):
        return self._fft(data)

    def _fft(self, data):  # pragma: no cover - abstract
        raise NotImplementedError

    def inverse(self):
        """The matching inverse transform (same maker, flipped direction)."""
        direction = "backward" if self._direction == "forward" else "forward"
        return self._maker(self._time_shape, self._time_dtype,
                           direction=direction, axis=self._axis,
                           ortho=self._ortho, sample_rate=self._sample_rate)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self._direction == other._direction
                and self._time_shape == other._time_shape
                and self._time_dtype == other._time_dtype
                and self._axis == other._axis
                and self._ortho == other._ortho
                and _rates_equal(self._sample_rate, other._sample_rate))

    def __repr__(self):
        return (f"<{type(self).__name__} {self._direction}: "
                f"time {self._time_shape} {self._time_dtype} <-> "
                f"freq {self._frequency_shape} {self._frequency_dtype}, "
                f"axis={self._axis}, ortho={self._ortho}>")


def _rates_equal(a, b):
    if a is None or b is None:
        return a is b
    try:
        return bool(a == b)
    except Exception:
        return False


class FFTMakerMeta(type):
    """Auto-register maker classes by lowercased name minus 'fftmaker'."""

    def __init__(cls, name, bases, dct):
        super().__init__(name, bases, dct)
        if name != "FFTMakerBase" and not name.startswith("_"):
            key = name.lower().removesuffix("fftmaker")
            FFT_MAKER_CLASSES[key] = cls


class FFTMakerBase(metaclass=FFTMakerMeta):
    """Factory: call with (shape, dtype, ...) to get a planned FFT."""

    _fft_class = None  # subclass responsibility

    def __call__(self, shape, dtype, direction="forward", axis=0, ortho=False,
                 sample_rate=None):
        fft = self._fft_class(direction=direction, time_shape=shape,
                              time_dtype=dtype, axis=axis, ortho=ortho,
                              sample_rate=sample_rate)
        fft._maker = self
        return fft

    @staticmethod
    def next_fast_len(n):
        return next_fast_len(n)

    def get_frequency_data_info(self, shape, dtype, axis=0):
        """Frequency-domain (shape, dtype) for a time-domain array: real
        input transforms to ``shape[axis]//2 + 1`` complex samples along
        ``axis``; complex input keeps shape and dtype."""
        return FFTBase._get_frequency_data_info(shape, np.dtype(dtype),
                                                axis)

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __repr__(self):
        return f"{type(self).__name__}()"


class _FFTMakerState:
    """Global default engine with context-managed override:
    ``fft_maker.set('numpy')`` (optionally as a context manager),
    ``fft_maker.get()``, and ``fft_maker(shape, dtype, ...)`` to build an
    FFT with the current default.  Keyword arguments of ``set`` go to the
    named engine's constructor."""

    def __init__(self):
        self._value = None

    def _system_default(self):
        from .xla import XLAFFTMaker
        return XLAFFTMaker()

    @property
    def system_default(self):
        """The engine used when none has been set."""
        return self._system_default()

    def get(self):
        if self._value is None:
            self._value = self._system_default()
        return self._value

    def set(self, maker, **kwargs):
        if isinstance(maker, str):
            maker = FFT_MAKER_CLASSES[maker](**kwargs)
        elif kwargs:
            raise TypeError("kwargs only allowed with a named engine")
        previous = self._value
        self._value = maker

        @contextlib.contextmanager
        def _restore():
            try:
                yield maker
            finally:
                self._value = previous

        return _restore()

    def __call__(self, shape, dtype, **kwargs):
        return self.get()(shape, dtype, **kwargs)


fft_maker = _FFTMakerState()
