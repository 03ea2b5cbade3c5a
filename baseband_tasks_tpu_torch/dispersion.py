"""Coherent dispersion and dedispersion.

Counterpart of the coherent half of ``baseband_tasks_tpu/dispersion.py``
(``Disperse``, ``Dedisperse``): an overlap-save chirp convolution whose
total padding equals the dispersion smearing across the band.  The chirp
exp(2πi φ_DM(f) · sideband) is built once on the host in float64 and
cached on the stream's device as complex64.  Two engines:

- ``'xla'``: FFT -> chirp -> inverse FFT -> trim on the current
  ``fft_maker`` engine (``torch.fft``, or the four-step kernels under
  ``fft_maker.set('pallas')``);
- ``'pallas'``: a power-of-two window with the pads rounded up to
  multiples of the four-step N2, filtered by
  ``ops/spectral_filter.spectral_filter_pow2`` with the chirp in storage
  order: three kernel passes on a CUDA device, the pads dropped by the
  last one.  Its planes forms (``task_planes``, and ``task_stream`` with
  the window assembled from the overlap-save carry inside stage A) serve
  the compiled pipelines, which may fold a following Dechannelize in as
  the filter's ``post`` lane mix.

The incoherent ``DisperseSamples``/``DedisperseSamples`` wait for the
port of ``sampling.py`` (ROADMAP.md, queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import PaddedTaskBase, getattr_if_none
from .dm import DispersionMeasure
from .fourier import fft_maker
from .fourier.pallas import MIN_LANES
from .ops.dedisperse import permute_to_storage_order, split_n
from .ops.spectral_filter import (geometry_ok, spectral_filter_pow2,
                                  spectral_filter_stream)
from .utils import units as u
from .utils.dtypes import numpy_dtype

__all__ = ["Disperse", "Dedisperse"]


def _pow2_len(n):
    """Round up to a power of two ('pallas' engine windows)."""
    return 1 << (n - 1).bit_length()


class Disperse(PaddedTaskBase):
    """Coherently disperse a (complex baseband) stream.

    Each spectral component acquires the cold-plasma group delay relative
    to ``reference_frequency`` (which itself stays fixed in time); positive
    DM delays lower frequencies more.

    Parameters
    ----------
    ih : stream
        Input; each sample-shape channel has a carrier ``frequency`` and
        ``sideband`` (from the stream or passed explicitly).
    dm : DispersionMeasure or Quantity
        Dispersion measure (pc/cm³).  Negative values dedisperse.
    reference_frequency : Quantity, optional
        Frequency that stays aligned in time.  Default: the mean of the
        channels' band centers.
    engine : {'auto', 'xla', 'pallas'}
        'auto' picks 'pallas' for complex data over >= 8 lanes on a CUDA
        device, else 'xla'.
    """

    def __init__(self, ih, dm, *, reference_frequency=None,
                 samples_per_frame=None, frequency=None, sideband=None,
                 pad_margin=256, engine="auto"):
        frequency = getattr_if_none(ih, "frequency", frequency)
        sideband = getattr_if_none(ih, "sideband", sideband)
        if not isinstance(dm, u.Quantity):
            dm = DispersionMeasure(dm)
        elif not isinstance(dm, DispersionMeasure):
            dm = DispersionMeasure(dm.to_value(u.DM), u.DM)
        self._dm = dm
        if engine == "auto":
            lanes = int(np.prod(ih.sample_shape)) if ih.sample_shape else 1
            device = getattr(ih, "device", torch.device("cpu"))
            engine = "pallas" if (torch.device(device).type == "cuda"
                                  and ih.dtype.kind == "c"
                                  and lanes >= MIN_LANES) else "xla"
        if engine not in ("xla", "pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "pallas" and ih.dtype.kind != "c":
            raise ValueError("the pallas dedispersion engine requires "
                             "complex data")
        self.engine = engine

        sample_shape = ih.sample_shape if ih.sample_shape else (1,)
        freq = u.Quantity(np.broadcast_to(
            np.asarray(frequency.value, dtype=np.float64), sample_shape),
            frequency.unit)
        sb = np.broadcast_to(np.asarray(sideband), sample_shape)
        rate = ih.sample_rate

        # Band edges per channel (complex data spans ±B/2 around the
        # carrier; real data spans half the rate on the sideband's side).
        half = 0.5 * rate
        if ih.dtype.kind == "c":
            f_low = freq - half
            f_high = freq + half
        else:
            f_low = freq + np.minimum(sb, 0) * half
            f_high = freq + np.maximum(sb, 0) * half
        edges = np.concatenate([np.ravel(f_low.to_value(u.MHz)),
                                np.ravel(f_high.to_value(u.MHz))])
        if reference_frequency is None:
            # mean of the per-channel band centers
            centers = (f_low.to_value(u.MHz)
                       + f_high.to_value(u.MHz)) / 2.0
            reference_frequency = u.Quantity(float(np.mean(centers)),
                                             u.MHz)
        self.reference_frequency = reference_frequency

        # Delay extremes across the whole band set the padding.
        delays = dm.time_delay(u.Quantity(edges, u.MHz),
                               reference_frequency).to_value(u.s)
        rate_hz = rate.to_value(u.Hz)
        d_max = float(np.max(delays)) * rate_hz
        d_min = float(np.min(delays)) * rate_hz
        # Extra discard beyond the nominal smearing: the discrete chirp's
        # impulse response has band-edge (Gibbs) tails of a few hundred
        # samples at ~1e-3..1e-4 amplitude regardless of DM; discarding
        # them keeps overlap-save ghosts below the 60 dB noise floor.
        margin = int(pad_margin)
        pad_start = max(int(np.ceil(d_max)), 0) + margin
        pad_end = max(int(np.ceil(-d_min)), 0) + margin
        self._freq = freq
        self._sb = sb
        self._chirp_host = None
        self._chirp_cache = None
        self._storage_chirp_cache = None
        if self.engine == "pallas":
            fast_len = _pow2_len
            # A power-of-two window, with the pads rounded up to multiples
            # of the four-step N2 so the trim lands on whole stage-A rows
            # and the last kernel can drop the pads.
            spf0 = samples_per_frame if samples_per_frame is not None \
                else max(3 * (pad_start + pad_end), 1)
            n_fft = _pow2_len(spf0 + pad_start + pad_end)
            while True:
                n2 = split_n(n_fft)[1]
                p0 = -(-pad_start // n2) * n2
                p1 = -(-pad_end // n2) * n2
                if n_fft - p0 - p1 >= max(spf0, 1):
                    break
                n_fft *= 2
            pad_start, pad_end = p0, p1
            samples_per_frame = n_fft - p0 - p1
        else:
            fast_len = fft_maker.get().next_fast_len
        super().__init__(ih, pad_start=pad_start, pad_end=pad_end,
                         samples_per_frame=samples_per_frame,
                         next_fast_len=fast_len)
        if self.engine == "pallas" and not geometry_ok(
                self._padded_samples_per_frame, self._pad_start,
                self._pad_end):
            # e.g. a short stream clamped the frame below the planned
            # pow2 window; the 'xla' task is always valid
            self.engine = "xla"

    def _chirp(self):
        """Host chirp exp(2πi φ(f_sky) · sb) over the padded window,
        (n,) + sample_shape complex64, computed in float64."""
        if self._chirp_host is None:
            n = self._padded_samples_per_frame
            sample_shape = self.ih.sample_shape if self.ih.sample_shape \
                else (1,)
            fft = fft_maker((n,) + sample_shape, self.ih.dtype,
                            axis=0, sample_rate=self.ih.sample_rate)
            # baseband offsets -> sky frequency per (bin, channel...)
            offset = fft.frequency  # Quantity (nfreq, 1, ..)
            f_sky = self._freq + offset * self._sb
            phase = self._dm.phase_delay(f_sky, self.reference_frequency)
            cycles = np.asarray(phase.to_value(u.cycle), dtype=np.float64)
            cycles = cycles - np.round(cycles)
            factor = np.exp(2j * np.pi * cycles * np.asarray(self._sb))
            self._chirp_host = factor.astype(np.complex64)
        return self._chirp_host

    def _storage_chirp(self):
        """The chirp as float32 (N2, N1, L) planes in four-step storage
        order, on the stream's device."""
        n = self._padded_samples_per_frame
        n1, n2 = split_n(n)
        planes = self._chirp().reshape(n, -1)
        stor = permute_to_storage_order(planes, n1, n2)
        return tuple(torch.as_tensor(np.ascontiguousarray(
            part.astype(np.float32)), device=self.device)
            for part in (stor.real, stor.imag))

    def _storage_chirp_planes(self):
        if self._storage_chirp_cache is None:
            self._storage_chirp_cache = self._storage_chirp()
        return self._storage_chirp_cache

    def _chirp_tensor(self):
        """The complex chirp of the 'xla' task on the stream's device."""
        if self._chirp_cache is None:
            self._chirp_cache = torch.as_tensor(self._chirp(),
                                                device=self.device)
        return self._chirp_cache

    def _prepare_device_caches(self):
        """Build the engine's chirp on the device (compiled pipelines call
        this before their first step)."""
        if self.engine == "pallas":
            self._storage_chirp_planes()
        else:
            self._chirp_tensor()

    def _task_pallas(self, data):
        n = data.shape[0]
        sample_shape = tuple(data.shape[1:])
        x = data.to(torch.complex64).reshape(n, -1)
        yr, yi = self._task_pallas_planes(x.real.contiguous(),
                                          x.imag.contiguous())
        return torch.complex(yr, yi).reshape(
            (self._samples_per_frame,) + sample_shape)

    def _task_pallas_planes(self, xr, xi, post=None):
        """Dedisperse padded float32 planes (N, lanes) -> trimmed planes;
        ``post`` optionally folds a lane-mixing matrix in (a following
        Dechannelize's inverse DFT, models/compiled.py)."""
        return spectral_filter_pow2(
            xr, xi, *self._storage_chirp_planes(),
            pad_start=self._pad_start, pad_end=self._pad_end, post=post)

    def _task_pallas_stream(self, carry_pair, x_pair, scale=None,
                            post=None):
        """Streaming planes form: overlap-save carry + block planes in,
        trimmed planes out, with the window assembled in stage A and the
        optional per-iteration scale on the block rows."""
        return spectral_filter_stream(
            carry_pair[0], carry_pair[1], x_pair[0], x_pair[1],
            *self._storage_chirp_planes(), pad_start=self._pad_start,
            pad_end=self._pad_end, scale=scale, post=post)

    def task_planes(self, pair):
        """Planes-interchange form for compiled pipelines: padded window
        as (re, im) float32 planes in, trimmed planes out.  NotImplemented
        where the 'pallas' geometry does not apply (the caller then goes
        through ``task``)."""
        xr, xi = pair
        if (self.engine != "pallas" or xi is None
                or xr.shape[0] != self._padded_samples_per_frame):
            return NotImplemented
        shape = tuple(xr.shape)
        yr, yi = self._task_pallas_planes(xr.reshape(shape[0], -1),
                                          xi.reshape(shape[0], -1))
        out_shape = (self._samples_per_frame,) + shape[1:]
        return yr.reshape(out_shape), yi.reshape(out_shape)

    def task_stream(self, carry_pair, x_pair, scale=None):
        """Streaming planes form: (pad, ...) carry planes + (spf, ...)
        block planes -> trimmed planes (see models/compiled.py
        planes_step)."""
        pad = self._pad_start + self._pad_end
        if (self.engine != "pallas" or carry_pair[0].shape[0] != pad
                or x_pair[0].shape[0] + pad
                != self._padded_samples_per_frame):
            return NotImplemented
        shape = tuple(x_pair[0].shape)
        yr, yi = self._task_pallas_stream(
            (carry_pair[0].reshape(pad, -1),
             carry_pair[1].reshape(pad, -1)),
            (x_pair[0].reshape(shape[0], -1),
             x_pair[1].reshape(shape[0], -1)), scale=scale)
        out_shape = (self._samples_per_frame,) + shape[1:]
        return yr.reshape(out_shape), yi.reshape(out_shape)

    def task(self, data):
        if self.engine == "pallas" and \
                data.shape[0] == self._padded_samples_per_frame:
            return self._task_pallas(data)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[:, None]
        n = data.shape[0]
        fft = fft_maker((n,) + tuple(data.shape[1:]), numpy_dtype(data.dtype),
                        axis=0, sample_rate=self.ih.sample_rate)
        ft = fft(data)
        ft = ft * self._chirp_tensor()
        out = fft.inverse()(ft)
        out = out[self._pad_start:self._pad_start + self._samples_per_frame]
        if squeeze:
            out = out[:, 0]
        return out

    @property
    def dm(self):
        return self._dm

    @property
    def dedispersion_measure(self):
        return DispersionMeasure(-self._dm.to_value(u.DM), u.DM)


class Dedisperse(Disperse):
    """Coherently dedisperse: remove the dispersion of ``dm``."""

    def __init__(self, ih, dm, *, reference_frequency=None,
                 samples_per_frame=None, frequency=None, sideband=None,
                 pad_margin=256, engine="auto"):
        if not isinstance(dm, u.Quantity):
            dm = DispersionMeasure(dm)
        negated = DispersionMeasure(-dm.to_value(u.DM), u.DM)
        super().__init__(ih, negated,
                         reference_frequency=reference_frequency,
                         samples_per_frame=samples_per_frame,
                         frequency=frequency, sideband=sideband,
                         pad_margin=pad_margin, engine=engine)

    @property
    def dm(self):
        # the positive value passed in; the chirp uses its negation
        return DispersionMeasure(-self._dm.to_value(u.DM), u.DM)

    @property
    def dedispersion_measure(self):
        return self._dm
