"""Channelization: block FFT into spectral channels and its inverse.

Counterpart of ``baseband_tasks_tpu/channelize.py`` (``Channelize``,
``Dechannelize``): ``task`` on the current ``fft_maker`` engine, and the
planes forms ``task_planes`` that the compiled pipelines run (separate
float32 re/im planes through ``ops/dft_matmul`` matrix products, for
n <= ``MAX_MATMUL_N``).
"""

from __future__ import annotations

import operator

import numpy as np

from .base import TaskBase, getattr_if_none
from .fourier import fft_maker
from .ops.dft_matmul import MAX_MATMUL_N, dft_matmul_planes
from .utils import units as u

__all__ = ["Channelize", "Dechannelize"]


class Channelize(TaskBase):
    """Channelize a stream into ``n`` spectral channels.

    Blocks of ``n`` consecutive time samples are Fourier transformed into a
    new leading channel axis of the sample shape; the sample rate drops by
    ``n``.  Real input produces ``n // 2 + 1`` channels.

    Parameters
    ----------
    ih : stream
        Input handle (time stream).
    n : int
        Number of time samples per spectrum.
    samples_per_frame : int, optional
        Output spectra per frame; default: as many as fit the input frame.
    frequency, sideband : optional
        Override the input stream's labels before computing per-channel
        frequencies.
    """

    def __init__(self, ih, n, samples_per_frame=None, *,
                 frequency=None, sideband=None):
        n = operator.index(n)
        self._n = n
        complex_data = ih.dtype.kind == "c"
        self._nchan = n if complex_data else n // 2 + 1
        if samples_per_frame is None:
            samples_per_frame = max(getattr(ih, "samples_per_frame", n) // n, 1)
        frequency = getattr_if_none(ih, "frequency", frequency, required=False)
        sideband = getattr_if_none(ih, "sideband", sideband, required=False)
        self._fft = fft_maker(
            (samples_per_frame, n) + ih.sample_shape, ih.dtype, axis=1,
            sample_rate=ih.sample_rate)
        if frequency is not None and sideband is not None:
            # Per-channel sky frequency: carrier + offset * sideband;
            # fft.frequency broadcasts as a (nchan, 1...) column against
            # the trailing sample axes.
            sideband = np.asarray(sideband)
            frequency = frequency + self._fft.frequency * sideband
        super().__init__(ih, ih_samples_per_frame=samples_per_frame * n,
                         samples_per_frame=samples_per_frame,
                         sample_rate=ih.sample_rate / n,
                         dtype=self._fft.frequency_dtype,
                         frequency=frequency, sideband=sideband)

    @property
    def n(self):
        return self._n

    def _output_sample_shape(self, ih):
        return (self._nchan,) + ih.sample_shape

    def task(self, data):
        return self._fft(data.reshape((-1, self._n) + tuple(data.shape[1:])))

    def task_planes(self, pair):
        """Planes-interchange form (models/compiled.py): the channel DFT
        of separate re/im planes as four matrix products; NotImplemented
        where it does not apply (real data, ortho, n > MAX_MATMUL_N)."""
        xr, xi = pair
        if xi is None or self._fft.ortho or self._n > MAX_MATMUL_N:
            return NotImplemented
        shape = (-1, self._n) + tuple(xr.shape[1:])
        return dft_matmul_planes(xr.reshape(shape), xi.reshape(shape),
                                 axis=1, direction="forward", n=self._n)

    def inverse(self, ih):
        """Build the Dechannelize that undoes this Channelize."""
        return Dechannelize(ih, n=self._n, dtype=self.ih.dtype)


class Dechannelize(TaskBase):
    """Inverse of :class:`Channelize`: merge the channel axis back to time.

    For real-valued output the original ``n`` must be given (it cannot be
    inferred from ``n // 2 + 1`` channels alone).
    """

    def __init__(self, ih, n=None, samples_per_frame=None, *,
                 dtype=None, frequency=None, sideband=None):
        if dtype is None:
            dtype = ih.dtype  # stay complex unless told otherwise
        complex_out = np.dtype(dtype).kind == "c"
        nchan = ih.sample_shape[0]
        if n is None:
            if not complex_out:
                raise ValueError("need explicit n for real dechannelization")
            n = nchan
        n = operator.index(n)
        self._n = n
        # samples_per_frame counts OUTPUT time samples, rounded to a whole
        # number of spectra; default one underlying frame's worth.
        if samples_per_frame is None:
            spectra_per_frame = max(getattr(ih, "samples_per_frame", 1), 1)
        else:
            spectra_per_frame = max(int(round(samples_per_frame / n)), 1)
        time_dtype = np.dtype(dtype)
        self._fft = fft_maker(
            (spectra_per_frame, n) + ih.sample_shape[1:], time_dtype,
            axis=1, direction="backward", sample_rate=ih.sample_rate * n)
        frequency = getattr_if_none(ih, "frequency", frequency,
                                    required=False)
        if frequency is not None:
            # Output carrier = channel-0 frequency.
            freq_arr = np.broadcast_to(np.asarray(frequency.value),
                                       ih.sample_shape or (1,))
            frequency = u.Quantity(freq_arr[0], frequency.unit)
        sideband = getattr_if_none(ih, "sideband", sideband, required=False)
        if sideband is not None:
            sb = np.broadcast_to(np.asarray(sideband), ih.sample_shape or (1,))
            sideband = sb[0]
        super().__init__(ih, ih_samples_per_frame=spectra_per_frame,
                         samples_per_frame=spectra_per_frame * n,
                         sample_rate=ih.sample_rate * n, dtype=time_dtype,
                         frequency=frequency, sideband=sideband)

    @property
    def n(self):
        return self._n

    def _output_sample_shape(self, ih):
        return ih.sample_shape[1:]

    def task(self, data):
        out = self._fft(data)
        return out.reshape((-1,) + tuple(out.shape[2:]))

    def task_planes(self, pair):
        """Planes-interchange form: the inverse channel DFT of separate
        re/im planes as four matrix products, channel axis merged to
        time."""
        xr, xi = pair
        if (xi is None or self._fft.ortho or self._n > MAX_MATMUL_N
                or np.dtype(self.dtype).kind != "c"):
            return NotImplemented
        yr, yi = dft_matmul_planes(xr, xi, axis=1, direction="backward",
                                   n=self._n)
        out = (-1,) + tuple(xr.shape[2:])
        return yr.reshape(out), yi.reshape(out)

    def inverse(self, ih):
        return Channelize(ih, n=self._n)
