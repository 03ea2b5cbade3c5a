"""Multi-stream combination tasks.

Counterpart of ``baseband_tasks_tpu/combining.py`` (``CombineStreamsBase``,
``CombineStreams``, ``Concatenate``, ``Stack``).

Input streams are aligned to their common time window (within
min(1 ns, 0.01 sample), checked in exact rational arithmetic), each frame
reads every input, and the combining function is applied to the data and
to the meta attributes alike.  Frames live on the first stream's device.
Compiled chains join such nodes with one source block per input
(``models/compiled.py``).
"""

from __future__ import annotations

import operator
from fractions import Fraction

import numpy as np
import torch

from .base import Base
from .utils import units as u
from .utils.dtypes import to_numpy

__all__ = ["CombineStreamsBase", "CombineStreams", "Concatenate", "Stack"]


class CombineStreamsBase(Base):
    """Combine multiple streams sample by sample with ``task(list)``."""

    def __init__(self, ihs, *, samples_per_frame=None, atol=None):
        if len(ihs) < 2:
            raise ValueError("need at least two streams to combine")
        self.ihs = list(ihs)
        ih0 = self.ihs[0]
        rate = ih0.sample_rate
        for ih in self.ihs[1:]:
            if not np.isclose(float((ih.sample_rate / rate).to_value(u.one)),
                              1.0, rtol=1e-12):
                raise ValueError("streams have different sample rates")
        rate_hz = rate.to_value(u.Hz)
        if atol is None:
            atol = min(1e-9, 0.01 / rate_hz)  # s
        # the common window: the latest start, the earliest stop
        starts = [ih.start_time for ih in self.ihs]
        start = max(starts)
        self._offsets = []
        frate = Fraction(float(rate_hz))
        for ih, t in zip(self.ihs, starts):
            # exact rational offset from the two-double seconds (a float64
            # seconds * rate loses more than 0.01 sample at day-scale
            # offsets and GHz rates)
            hi, lo = (start - t).sec_pair
            off_exact = (Fraction(float(hi)) + Fraction(float(lo))) * frate
            off_int = round(off_exact)
            resid_samples = float(off_exact - off_int)
            if abs(resid_samples) / rate_hz > atol:
                raise ValueError(
                    f"streams not aligned to within {atol} s; "
                    f"offset {float(off_exact)} samples")
            self._offsets.append(int(off_int))
        n = min(ih.shape[0] - off
                for ih, off in zip(self.ihs, self._offsets))
        if n <= 0:
            raise ValueError("streams do not overlap in time")
        # a dry run for the output sample shape
        dummies = [torch.zeros((7,) + tuple(ih.sample_shape),
                               dtype=torch.int8) for ih in self.ihs]
        try:
            out = self.task(dummies)
        except Exception as exc:
            raise ValueError(f"combination failed on dummy inputs: {exc}") \
                from exc
        if out.shape[0] != 7:
            raise ValueError("combination may not change the time axis.")
        if samples_per_frame is None:
            samples_per_frame = max(getattr(ih0, "samples_per_frame", 1), 1)
        super().__init__(shape=(n,) + tuple(out.shape[1:]), start_time=start,
                         sample_rate=rate,
                         samples_per_frame=samples_per_frame,
                         dtype=np.result_type(*(ih.dtype
                                                for ih in self.ihs)),
                         device=getattr(ih0, "device", None))
        self._combine_attributes()

    def _combine_attributes(self):
        """Combine each meta attribute every input has, as the data are
        (host numpy through ``task``); skipped where that fails."""
        attrs = self._meta["__attributes__"]
        for name in ("frequency", "sideband", "polarization"):
            values = [getattr(ih, "meta", {}).get("__attributes__",
                                                  {}).get(name)
                      for ih in self.ihs]
            if any(v is None for v in values):
                continue
            unit = next((v.unit for v in values
                         if isinstance(v, u.Quantity)), None)
            full = []
            for v, ih in zip(values, self.ihs):
                arr = (np.asarray(v.to_value(unit))
                       if isinstance(v, u.Quantity) else np.asarray(v))
                full.append(np.broadcast_to(arr, ih.sample_shape))
            try:
                combined = to_numpy(self.task([f[np.newaxis]
                                               for f in full]))[0]
            except Exception:
                continue
            attrs[name] = u.Quantity(combined, unit) if unit else combined

    def task(self, data_list):  # pragma: no cover - abstract
        raise NotImplementedError

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        start = frame_index * spf
        stop = min(start + spf, self._shape[0])
        pieces = []
        for ih, off in zip(self.ihs, self._offsets):
            ih.seek(off + start)
            pieces.append(ih.read(stop - start))
        return self.task(pieces)

    def close(self):
        super().close()
        self.ihs = []


class CombineStreams(CombineStreamsBase):
    """Combine streams with a user-supplied function of the list of
    input blocks (tensors; host numpy arrays for the meta attributes)."""

    def __init__(self, ihs, task, **kwargs):
        self._task_fn = task
        super().__init__(ihs, **kwargs)

    def task(self, data_list):
        return self._task_fn(data_list)


class Concatenate(CombineStreamsBase):
    """Concatenate streams along a sample axis (default: the first)."""

    def __init__(self, ihs, axis=1, **kwargs):
        axis = operator.index(axis)
        if axis == 0:
            raise ValueError("cannot concatenate along the time axis.")
        self._axis = axis
        super().__init__(ihs, **kwargs)

    def task(self, data_list):
        if isinstance(data_list[0], np.ndarray):
            return np.concatenate(data_list, axis=self._axis)
        return torch.cat(list(data_list), dim=self._axis)


class Stack(CombineStreamsBase):
    """Stack streams along a new sample axis (default: a new first sample
    axis)."""

    def __init__(self, ihs, axis=1, **kwargs):
        axis = operator.index(axis)
        if axis == 0:
            raise ValueError("cannot stack along the time axis.")
        self._axis = axis
        super().__init__(ihs, **kwargs)

    def task(self, data_list):
        if isinstance(data_list[0], np.ndarray):
            return np.stack(data_list, axis=self._axis)
        return torch.stack(list(data_list), dim=self._axis)
