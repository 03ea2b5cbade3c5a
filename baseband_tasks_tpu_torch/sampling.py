"""Time-shifting and resampling tasks.

Counterpart of ``baseband_tasks_tpu/sampling.py`` (``ShiftAndResample``,
``Resample``, ``TimeDelay``, ``ShiftSamples``, ``seek_float``,
``to_sample``).

Fractional delays use a Hann-windowed sinc interpolation kernel of
half-width ``pad`` (default 64) applied through ``Convolve``'s overlap-save
machinery, on either of its engines ('pallas': the spectral-filter
kernels); pure integer shifts use a per-channel gather.  Positive shift
delays the signal (a feature at time t appears at t + shift).

``ShiftAndResample``'s local-oscillator rotation is a per-lane constant,
so it is folded into the response's transform: every form (``task``,
``task_planes``, ``task_stream``) applies it with no extra pass.  (The
JAX package applies it after ``task`` only, so its compiled planes step
drops it; the port holds to its ``task``.)
"""

from __future__ import annotations

import numpy as np
import torch

from .base import PaddedTaskBase, getattr_if_none
from .convolution import Convolve
from .utils import Time, units as u
from .utils.time import TimeDelta

__all__ = ["ShiftAndResample", "Resample", "TimeDelay", "ShiftSamples",
           "seek_float", "to_sample"]


def to_sample(ih, offset):
    """A (possibly time-unit) offset in units of samples of ``ih``."""
    if isinstance(offset, u.Quantity):
        if offset.unit.is_equivalent(u.s):
            return np.asarray(offset.to_value(u.s)) \
                * ih.sample_rate.to_value(u.Hz)
        return np.asarray(offset.to_value(u.one), dtype=np.float64)
    return np.asarray(offset, dtype=np.float64)


def seek_float(ih, offset, whence=0):
    """Convert a possibly-quantity offset to a float number of samples."""
    if isinstance(offset, Time):
        hi, lo = (offset - ih.start_time).sec_pair
        rate = ih.sample_rate.to_value(u.Hz)
        return hi * rate + lo * rate
    if isinstance(offset, u.Quantity):
        if offset.unit.is_equivalent(u.s):
            offset = offset.to_value(u.s) * ih.sample_rate.to_value(u.Hz)
        else:
            offset = np.asarray(offset.to_value(u.one))
    offset = np.asarray(offset, dtype=np.float64)
    if whence in (1, "current"):
        offset = offset + ih.tell()
    elif whence in (2, "end"):
        offset = offset + ih.shape[0]
    elif whence not in (0, "start"):
        raise ValueError("invalid 'whence'")
    return offset


def _lo_rotation(ih, lo, samples, sideband):
    """exp(-2πi lo dt sideband) for a delay of ``samples`` samples,
    complex64 (host)."""
    sideband = getattr_if_none(ih, "sideband", sideband)
    dt = samples / ih.sample_rate.to_value(u.Hz)
    phase = -2j * np.pi * np.asarray(lo.to_value(u.Hz)) * dt \
        * np.asarray(sideband, dtype=float)
    return np.exp(phase).astype(np.complex64)


class ShiftAndResample(Convolve):
    """Shift a stream by (possibly per-channel, fractional) amounts and
    resample onto a (possibly offset-anchored) grid.

    Parameters
    ----------
    ih : stream
        Input (complex or real).
    shift : array-like or Quantity
        Delay per channel: time Quantity or number of samples;
        broadcastable against the sample shape.  Positive delays the
        signal.
    offset : Time, Quantity or float, optional
        Anchor: an output sample lands exactly on this input-stream offset
        (plus whole samples).  Default: the output grid moves by the mean
        shift, so only the per-channel residuals are interpolated.
    lo : Quantity, optional
        Local-oscillator frequency of complex baseband: after a time shift
        dt the data are rotated by exp(-2πi lo dt sideband), so sky phases
        stay coherent.  Needs ``sideband`` (from the stream or given).
    pad : int
        Half-width of the interpolation kernel (default 64).
    engine : {'xla', 'pallas', 'auto'}
        ``Convolve``'s engine.
    """

    def __init__(self, ih, shift, offset=None, whence=0, *, lo=None,
                 pad=64, samples_per_frame=None, sideband=None,
                 engine="xla"):
        shift_samples = to_sample(ih, shift)
        # the output grid moves by d_time input samples: the mean shift,
        # or with an anchor the nearest value congruent to it (mod 1)
        mean_shift = float(np.mean(shift_samples))
        if offset is not None:
            off_f = float(np.mean(seek_float(ih, offset, whence)))
            d_time = off_f + float(np.round(mean_shift - off_f))
        else:
            d_time = mean_shift
        self._grid_offset = d_time
        # per-channel delay relative to the shifted grid
        eff = np.atleast_1d(shift_samples - d_time)
        k_min = int(np.floor(eff.min())) - pad + 1
        k_max = int(np.floor(eff.max())) + pad
        k = np.arange(k_min, k_max + 1)
        arg = k.reshape((-1,) + (1,) * eff.ndim) - eff
        window = np.where(np.abs(arg) < pad,
                          np.cos(np.pi * arg / (2 * pad)) ** 2, 0.0)
        response = np.sinc(arg) * window
        sample_shape = ih.sample_shape
        if response.ndim - 1 < len(sample_shape):
            response = response.reshape(
                response.shape[:1] + (1,) * (len(sample_shape)
                                             - (response.ndim - 1))
                + response.shape[1:])
        elif response.ndim - 1 > len(sample_shape):
            # a scalar shift on a scalar-sample stream: drop the channel
            # axis atleast_1d added
            response = response.reshape(response.shape[:1] + sample_shape)
        self._shift_samples = shift_samples
        self._pad_sinc = pad
        self._lo = lo
        self._lo_factor = None if lo is None else _lo_rotation(
            ih, lo, shift_samples, sideband)
        self._lo_cache = None
        super().__init__(ih, response, offset=-k_min,
                         samples_per_frame=samples_per_frame,
                         engine=engine)
        # the output grid is the input grid shifted by d_time samples
        if d_time:
            self._start_time = self._start_time + self._samples_to_timedelta(
                1, ih.sample_rate) * d_time

    def _lo_in_response(self):
        return self._lo_factor is not None and self._complex_out()

    def _lane_factor(self):
        """The LO rotation, folded into the response for complex output."""
        return self._lo_factor if self._lo_in_response() else None

    def _lo_tensor(self, shape):
        if self._lo_cache is None:
            self._lo_cache = torch.as_tensor(
                np.broadcast_to(self._lo_factor, shape).copy(),
                device=self.device)
        return self._lo_cache

    def _prepare_device_caches(self):
        super()._prepare_device_caches()
        if self._lo_factor is not None and not self._lo_in_response():
            self._lo_tensor(tuple(self.sample_shape))

    def task(self, data):
        out = super().task(data)
        if self._lo_factor is not None and not self._lo_in_response():
            # real output: rotated after the convolution, as in the JAX
            # package (the result is complex)
            out = out * self._lo_tensor(tuple(out.shape[1:]))
        return out


class Resample(ShiftAndResample):
    """Resample so that a sample lands exactly at the requested offset.

    After construction the stream pointer is at that sample.
    """

    def __init__(self, ih, offset, whence=0, *, pad=64,
                 samples_per_frame=None, engine="xla"):
        super().__init__(ih, 0, offset=offset, whence=whence, pad=pad,
                         samples_per_frame=samples_per_frame,
                         engine=engine)
        target = seek_float(ih, offset, whence)
        self.seek(int(round(float(np.mean(target)) - self._grid_offset))
                  - self._pad_start)


class TimeDelay(PaddedTaskBase):
    """Delay a complex stream purely by relabelling time, with the
    matching local-oscillator phase rotation; no resampling.

    A bare float ``delay`` is in samples; a time Quantity converts by the
    sample rate.  ``lo`` is required: None means data recorded without
    mixing, which get no rotation.
    """

    def __init__(self, ih, delay, *, lo, frequency=None, sideband=None):
        if ih.dtype.kind != "c":
            raise ValueError("TimeDelay requires complex (analytic) data")
        super().__init__(ih, pad_start=0, pad_end=0,
                         samples_per_frame=getattr(ih, "samples_per_frame",
                                                   1),
                         frequency=frequency, sideband=sideband)
        delay_samples = float(to_sample(ih, delay))
        rate_hz = ih.sample_rate.to_value(u.Hz)
        self._start_time = self._start_time \
            + TimeDelta.from_samples(delay_samples, rate_hz)
        self._phase_factor = None if lo is None else _lo_rotation(
            ih, lo, delay_samples, sideband)
        self._phase_cache = None

    def _phase_tensor(self):
        if self._phase_cache is None:
            self._phase_cache = torch.as_tensor(
                np.broadcast_to(self._phase_factor,
                                tuple(self.sample_shape)).copy(),
                device=self.device)
        return self._phase_cache

    def _prepare_device_caches(self):
        if self._phase_factor is not None:
            self._phase_tensor()

    def task(self, data):
        if self._phase_factor is None:
            return data
        return data * self._phase_tensor()


class ShiftSamples(PaddedTaskBase):
    """Shift each channel by a whole number of samples.

    Positive shifts delay the channel.  A per-channel gather from the
    padded window, with int64 indices (no limit on the window's length);
    a uniform shift is a slice.  Shifts in samples are rounded to the
    nearest integer (a time Quantity converts first); use
    :class:`ShiftAndResample` to apply the fractional part.  ``shift``
    broadcasts against the sample shape by numpy's trailing-axis rule.
    """

    def __init__(self, ih, shift, *, samples_per_frame=None):
        shift = np.round(np.asarray(to_sample(ih, shift))).astype(np.int64)
        pad_start = max(int(shift.max()), 0)
        pad_end = max(-int(shift.min()), 0)
        super().__init__(ih, pad_start=pad_start, pad_end=pad_end,
                         samples_per_frame=samples_per_frame)
        try:
            full_shift = np.broadcast_to(shift, ih.sample_shape)
        except ValueError:
            raise ValueError(
                f"shift shape {shift.shape} cannot broadcast to sample "
                f"shape {ih.sample_shape}") from None
        self._uniform = int(full_shift.flat[0]) if full_shift.size \
            and np.all(full_shift == full_shift.flat[0]) else None
        # out[j, c] = window[j + pad_start - s_c, c]
        self._rel_index_host = (pad_start - full_shift).astype(np.int64)
        self._rel_index = None

    def _index_tensor(self):
        if self._rel_index is None:
            self._rel_index = torch.as_tensor(self._rel_index_host,
                                              device=self.device)
        return self._rel_index

    def _prepare_device_caches(self):
        if self._uniform is None:
            self._index_tensor()

    def task(self, data):
        n_out = data.shape[0] - self._pad_start - self._pad_end
        if self._uniform is not None:
            start = self._pad_start - self._uniform
            return data[start:start + n_out]
        j = torch.arange(n_out, device=data.device).reshape(
            (-1,) + (1,) * (data.ndim - 1))
        idx = j + self._index_tensor().to(data.device)
        return torch.gather(data, 0, idx)
