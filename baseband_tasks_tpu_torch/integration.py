"""Integration over time or pulse phase; pulsar folding and pulse stacks.

Counterpart of ``baseband_tasks_tpu/integration.py`` (``Integrate``,
``Fold``, ``PulseStack`` and the deprecated ``Stack``).

The bin bookkeeping stays on the host at frame granularity, as in the JAX
package: bin edges (the phase -> offset inversion included) are computed
in float64/int64, and each input piece gets per-sample bin indices there.
The sums are taken on the stream's device with ``index_add_``.  Counts
are tallied on the host in int64 (they follow from the bin indices alone);
with ``masked=True`` they are per cell (``isfinite``), counted on the
device and kept in int64 there.  A fully flagged cell averages to NaN.

With ``average=False`` a read returns :class:`Integrated`, the sums and
their counts as two tensors on the stream's device, with the field names
(``data``, ``count``) of the JAX package's structured array.
"""

from __future__ import annotations

import operator
import warnings

import numpy as np
import torch

from .base import BaseTaskBase
from .utils import Time, units as u
from .utils.dtypes import numpy_dtype, torch_dtype

__all__ = ["is_index", "Integrated", "Integrate", "Fold", "PulseStack",
           "Stack"]


def is_index(n):
    """Whether ``n`` is usable as an integer index."""
    try:
        operator.index(n)
    except TypeError:
        return False
    return True


class Integrated:
    """Sums and counts of a non-averaged integration (``average=False``).

    ``data`` holds the sums in the stream's dtype and ``count`` the int64
    counts, of the same shape: per cell with ``masked=True``, else per
    bin, broadcast over the sample shape (as in the JAX package's
    structured array, whose count field is int32).  Both are tensors on
    the stream's device.  ``out["data"]`` and ``out.data`` are the same;
    slicing along time gives another :class:`Integrated`, and
    ``np.asarray(out)`` the host structured array.
    """

    __slots__ = ("data", "count")

    def __init__(self, data, count):
        self.data = data
        self.count = count

    def __getitem__(self, item):
        if isinstance(item, str):
            if item not in self.__slots__:
                raise KeyError(item)
            return getattr(self, item)
        return Integrated(self.data[item], self.count[item])

    def __len__(self):
        return len(self.data)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        """The host structured dtype, fields ``data`` and ``count``."""
        return np.dtype({"names": ["data", "count"],
                         "formats": [numpy_dtype(self.data.dtype),
                                     numpy_dtype(self.count.dtype)]})

    @staticmethod
    def cat(pieces):
        """The pieces joined along time."""
        return Integrated(torch.cat([p.data for p in pieces]),
                          torch.cat([p.count for p in pieces]))

    def __array__(self, dtype=None, copy=None):
        out = np.zeros(self.shape, self.dtype)
        out["data"] = self.data.detach().cpu().numpy()
        out["count"] = self.count.detach().cpu().numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self):
        return f"Integrated(data={self.data!r}, count={self.count!r})"


def _phase_to_cycles(ph):
    """A phase callable's result as float64 cycles, a ``(hi, lo)`` pair of
    host arrays (a :class:`~.phases.Phase` keeps its two doubles)."""
    from .phases import Phase
    if isinstance(ph, Phase):
        return ph.cycle_pair
    if isinstance(ph, u.Quantity):
        val = np.asarray(ph.to_value(u.cycle), dtype=np.float64)
        return val, np.zeros_like(val)
    val = np.asarray(ph, dtype=np.float64)
    return val, np.zeros_like(val)


def _phase_bins(phase, t, n_phase):
    """Phase bin in [0, n_phase) of each time of ``t`` under ``phase``:
    the fraction of a cycle at two-double precision, on the host."""
    hi, lo = _phase_to_cycles(phase(t))
    frac = (hi - np.floor(hi)) + lo
    frac = frac - np.floor(frac)
    return np.minimum((frac * n_phase).astype(np.int64), n_phase - 1)


class Integrate(BaseTaskBase):
    """Integrate a stream in steps of time, samples, or pulse phase.

    Parameters
    ----------
    ih : stream
        Input handle.
    step : int, Quantity, optional
        Bin size: integer number of input samples, a time Quantity, or a
        phase Quantity in cycles (requires ``phase``).  Default: the whole
        stream in one bin.
    phase : callable, optional
        Maps :class:`~baseband_tasks_tpu_torch.utils.Time` (array) to
        phase (Quantity in cycles or
        :class:`~baseband_tasks_tpu_torch.phases.Phase`).
    start : Time or int, optional
        Start of the first bin (default: start of the stream).
    average : bool
        If True (default) divide sums by counts; else ``read`` returns
        :class:`Integrated` sums and counts.
    masked : bool
        If True, non-finite input cells (NaN from upstream flagging) are
        excluded per *cell*: counts gain the sample shape, and a cell with
        no finite sample averages to NaN.
    samples_per_frame : int
        Output bins per frame.
    """

    def __init__(self, ih, step=None, phase=None, *, start=0, average=True,
                 masked=False, samples_per_frame=1, dtype=None):
        self._masked = bool(masked)
        self.ih = ih
        if isinstance(start, Time):
            ih_start = ih.seek(start)
        else:
            ih_start = operator.index(start)
        if not 0 <= ih_start <= ih.shape[0]:
            # seek allows out-of-range pointers; start == end is a legal
            # zero-length window (the bin count then refuses it)
            raise ValueError("'start' is not within the underlying stream.")
        self._ih_start = ih_start
        n_avail = ih.shape[0] - ih_start

        self._phase = phase
        self._average = bool(average)

        if step is None:
            if phase is None:
                mode = "sample"
                step = n_avail
            else:
                raise ValueError("phase integration needs an explicit step "
                                 "in cycles.")
        elif isinstance(step, u.Quantity):
            if step.unit.is_equivalent(u.s):
                mode = "time"
            elif step.unit.is_equivalent(u.cycle):
                if phase is None:
                    raise ValueError("step in cycles requires a phase "
                                     "callable.")
                mode = "phase"
            else:
                raise ValueError(f"cannot step by {step.unit}")
        else:
            mode = "sample"
            step = operator.index(step)
        self._mode = mode
        self._step = step

        ih_rate = ih.sample_rate.to_value(u.Hz)
        if mode == "sample":
            self._samples_per_bin = float(step)
            n_bins = n_avail // step
            sample_rate = ih.sample_rate / step
        elif mode == "time":
            spb = step.to_value(u.s) * ih_rate
            self._samples_per_bin = spb
            n_bins = int(np.floor(n_avail / spb + 1e-9))
            sample_rate = 1.0 / step
        else:
            # the phase at the stream's ends bounds the bin count and gives
            # a mean spin rate for the iterative inversion
            t_first = ih._tell_time(ih_start)
            t_last = ih._tell_time(ih.shape[0])
            ph0_hi, ph0_lo = _phase_to_cycles(phase(t_first))
            ph1_hi, ph1_lo = _phase_to_cycles(phase(t_last))
            self._phase0 = (float(ph0_hi), float(ph0_lo))
            total_cycles = (ph1_hi - ph0_hi) + (ph1_lo - ph0_lo)
            step_cyc = float(step.to_value(u.cycle))
            self._step_cycles = step_cyc
            n_bins = int(np.floor(total_cycles / step_cyc))
            self._mean_f = total_cycles / ((t_last - t_first).sec)  # Hz
            sample_rate = 1.0 / step
        if n_bins < 1:
            raise ValueError("stream too short for even one integration bin")

        n_frames, extra = divmod(n_bins, samples_per_frame)
        if n_frames == 0:
            samples_per_frame = n_bins

        super().__init__(
            ih, shape=(n_bins,) + ih.sample_shape,
            sample_rate=sample_rate,
            samples_per_frame=samples_per_frame,
            start_time=ih._tell_time(ih_start),
            dtype=dtype)
        self._sum_dtype = np.dtype(self._dtype)  # complex stays complex
        self._out_dtype = np.dtype({"names": ["data", "count"],
                                    "formats": [self._sum_dtype, np.int64]})

    @property
    def average(self):
        return self._average

    @property
    def dtype(self):
        return self._sum_dtype if self._average else self._out_dtype

    def _tell_time(self, offset):
        if self._mode == "phase":
            offsets = self._get_offsets(np.array([offset], dtype=np.float64))
            return self.ih._tell_time(self._ih_start + int(offsets[0]))
        return self.ih._tell_time(
            self._ih_start + int(round(offset * self._samples_per_bin)))

    # -- bin edge -> input offset ------------------------------------------
    def _get_offsets(self, bins):
        """Input sample offsets (relative to the start) of bin edges."""
        bins = np.asarray(bins, dtype=np.float64)
        if self._mode != "phase":
            n_avail = self.ih.shape[0] - self._ih_start
            # the bin-count floor has a small fudge, so the last edge can
            # land one sample past the stream: clamp
            return np.minimum(
                np.round(bins * self._samples_per_bin).astype(np.int64),
                n_avail)
        # iterative inversion of the phase model: find t with
        # phase(t) = phase0 + b * step
        ih_rate = self.ih.sample_rate.to_value(u.Hz)
        target = bins * self._step_cycles  # cycles since phase0
        offsets = target * (ih_rate / self._mean_f)
        t0 = self.ih._tell_time(self._ih_start)
        max_offset = self.ih.shape[0] - self._ih_start
        # tolerance in cycles: 1e-9 of a step, plus the phase advanced in
        # 1e-3 input sample
        cycles_per_sample = self._mean_f / ih_rate
        tol_cycles = 1e-9 * self._step_cycles + 1e-3 * cycles_per_sample
        for _ in range(10):
            offsets = np.clip(offsets, 0.0, float(max_offset))
            t = t0 + u.Quantity(offsets / ih_rate, u.s)
            hi, lo = _phase_to_cycles(self._phase(t))
            achieved = (hi - self._phase0[0]) + (lo - self._phase0[1])
            err = target - achieved
            if np.all(np.abs(err) < tol_cycles):
                break
            offsets = offsets + err / cycles_per_sample
        else:
            if np.any(np.abs(err) / cycles_per_sample > 0.5):
                warnings.warn("phase-to-offset inversion did not converge "
                              "to within half a sample.")
        out = np.round(np.clip(offsets, 0, max_offset)).astype(np.int64)
        # edges must not decrease where targets are unreachable (a phase
        # glitch): clamp them to the last reachable offset
        if out.ndim:
            out = np.maximum.accumulate(out)
        return out

    # -- frames ------------------------------------------------------------
    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        bin0 = frame_index * spf
        n_bins = min(spf, self._shape[0] - bin0)
        return self._integrate_bins(bin0, n_bins)

    def _acc_dtype(self):
        """The sums' torch dtype: complex64/float32, or 64-bit for a
        64-bit stream."""
        size = self._sum_dtype.itemsize
        if self._sum_dtype.kind == "c":
            return torch.complex128 if size >= 16 else torch.complex64
        return torch.float64 if size >= 8 else torch.float32

    def _accumulate(self, start, stop, n_cells, cells_of):
        """Sums and counts over input samples [start, stop) (relative to
        the start) into ``n_cells`` cells; ``cells_of(first, n)`` gives the
        int64 host cell index of the n samples from relative offset
        ``first``.  Returns ``(sums, counts)`` tensors on the stream's
        device; counts (int64) have the sample shape with ``masked``."""
        dev = self.ih.device
        sample_shape = tuple(self.ih.sample_shape)
        sums = torch.zeros((n_cells,) + sample_shape, dtype=self._acc_dtype(),
                           device=dev)
        if self._masked:
            counts = torch.zeros((n_cells,) + sample_shape,
                                 dtype=torch.int64, device=dev)
        else:
            counts = np.zeros(n_cells, np.int64)

        def accumulate(first, data):
            cells_np = cells_of(first - start, len(data))
            cells = torch.as_tensor(cells_np, device=dev)
            d = torch.as_tensor(data, device=dev)
            if self._masked:
                valid = torch.isfinite(d)
                d = torch.where(valid, d, torch.zeros((), dtype=d.dtype,
                                                      device=dev))
                counts.index_add_(0, cells, valid.to(torch.int64))
            else:
                counts[:] += np.bincount(cells_np, minlength=n_cells)
            sums.index_add_(0, cells, d.to(sums.dtype))

        self.ih.seek(self._ih_start + start)
        self.ih.read(stop - start, out=_FakeOutput(accumulate, start))
        if not self._masked:
            counts = torch.as_tensor(counts, device=dev).reshape(
                (n_cells,) + (1,) * len(sample_shape)).expand(sums.shape)
        return sums, counts

    def _finish(self, sums, counts):
        """The frame from sums and counts of one shape: their average
        (NaN where a masked cell has no sample), or :class:`Integrated`."""
        if not self._average:
            return Integrated(sums.to(torch_dtype(self._sum_dtype)), counts)
        # divide in float64, as the JAX package divides on the host
        wide = torch.complex128 if sums.is_complex() else torch.float64
        out = sums.to(wide) / counts.clamp_min(1).to(torch.float64)
        if self._masked:
            out = torch.where(counts > 0, out,
                              torch.full((), float("nan"), dtype=wide,
                                         device=out.device))
        return out.to(torch_dtype(self._sum_dtype))

    def _integrate_bins(self, bin0, n_bins):
        """Accumulate ``n_bins`` bins from ``bin0`` on the step grid (the
        geometry is explicit so PulseStack can reuse it)."""
        edges = self._get_offsets(bin0 + np.arange(n_bins + 1))
        start, stop = int(edges[0]), int(edges[-1])
        edges = edges - start

        def cells_of(first, n):
            return np.clip(np.searchsorted(edges, first + np.arange(n),
                                           side="right") - 1, 0, n_bins - 1)

        return self._finish(*self._accumulate(start, stop, n_bins, cells_of))


class _FakeOutput:
    """``out=`` for ``ih.read``: each piece read is handed to
    ``setitem(first, data)`` with its absolute offset, so a frame is
    binned as it is produced, without holding the whole input range."""

    def __init__(self, setitem, first_sample):
        self._setitem = setitem
        self._first = first_sample

    def __setitem__(self, item, data):
        start = item.start if isinstance(item, slice) else item
        self._setitem(self._first + (start or 0), data)


class Fold(Integrate):
    """Fold a stream on a pulsar phase model.

    The output sample shape gains a leading phase axis of ``n_phase``
    bins; each time step accumulates samples into the phase bin of their
    (fractional) model phase.
    """

    def __init__(self, ih, n_phase, phase, step=None, *, start=0,
                 average=True, masked=False, samples_per_frame=1,
                 dtype=None):
        self._n_phase = operator.index(n_phase)
        if isinstance(step, u.Quantity) and step.unit.is_equivalent(u.cycle):
            raise ValueError("Fold steps in time; use PulseStack for "
                             "phase-stepped profiles.")
        super().__init__(ih, step=step, phase=None, start=start,
                         average=average, masked=masked,
                         samples_per_frame=samples_per_frame, dtype=dtype)
        # Fold needs the phase callable for binning, even stepping in time
        self._phase = phase
        self._shape = (self._shape[0], self._n_phase) + self.ih.sample_shape

    @property
    def n_phase(self):
        return self._n_phase

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        bin0 = frame_index * spf
        n_bins = min(spf, self._shape[0] - bin0)
        edges = self._get_offsets(bin0 + np.arange(n_bins + 1))
        start, stop = int(edges[0]), int(edges[-1])
        edges_local = edges - start
        n_phase = self._n_phase
        ih_rate = self.ih.sample_rate.to_value(u.Hz)
        t0 = self.ih._tell_time(self._ih_start)

        def cells_of(first, n):
            sample_idx = first + np.arange(n)
            time_bins = np.clip(np.searchsorted(edges_local, sample_idx,
                                                side="right") - 1,
                                0, n_bins - 1)
            t = t0 + u.Quantity((start + sample_idx) / ih_rate, u.s)
            return time_bins * n_phase + _phase_bins(self._phase, t, n_phase)

        sums, counts = self._accumulate(start, stop, n_bins * n_phase,
                                        cells_of)
        shape = (n_bins, n_phase) + tuple(self.ih.sample_shape)
        return self._finish(sums.reshape(shape), counts.reshape(shape))


class PulseStack(Integrate):
    """Stack of single-pulse profiles: integrate in phase steps of
    ``1/n_phase`` cycle and reshape to (pulse, phase)."""

    def __init__(self, ih, n_phase, phase, *, start=0, average=True,
                 masked=False, samples_per_frame=1, dtype=None):
        self._n_phase = operator.index(n_phase)
        super().__init__(ih, step=u.Quantity(1.0 / n_phase, u.cycle),
                         phase=phase, start=start, average=average,
                         masked=masked,
                         samples_per_frame=samples_per_frame * n_phase,
                         dtype=dtype)
        n_pulse = self._shape[0] // n_phase
        self._shape = (n_pulse, self._n_phase) + self.ih.sample_shape
        # one output sample is one full pulse
        self._sample_rate = self._sample_rate / n_phase
        self._samples_per_frame = max(self._samples_per_frame // n_phase, 1)

    @property
    def n_phase(self):
        return self._n_phase

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        pulse0 = frame_index * spf
        n_pulse = min(spf, self._shape[0] - pulse0)
        # Integrate on the fine (phase-step) bin grid, then (pulse, phase)
        frame = self._integrate_bins(pulse0 * self._n_phase,
                                     n_pulse * self._n_phase)
        shape = (n_pulse, self._n_phase) + tuple(self.ih.sample_shape)
        if isinstance(frame, Integrated):
            return Integrated(frame.data.reshape(shape),
                              frame.count.reshape(shape))
        return frame.reshape(shape)

    def _tell_time(self, offset):
        return Integrate._tell_time(self, offset * self._n_phase)


def Stack(*args, **kwargs):
    """Deprecated alias of :class:`PulseStack`."""
    warnings.warn("Stack is deprecated; use PulseStack.", DeprecationWarning)
    return PulseStack(*args, **kwargs)
