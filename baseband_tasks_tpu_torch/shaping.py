"""Sample-shape manipulation tasks.

Counterpart of ``baseband_tasks_tpu/shaping.py`` (``ChangeSampleShape``,
``Reshape``, ``Transpose``, ``ReshapeAndTranspose``, ``GetItem``,
``GetSlice``).

The shape operation is validated once at construction by a dry run on a
dummy array and applied identically to the meta attributes (frequency,
sideband, polarization), which is what lets labels follow the data
through arbitrary reshapes.  The operations therefore take both numpy
arrays (the dry run and the labels, which may be strings) and tensors
(the data).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import META_ATTRIBUTES, TaskBase, BaseTaskBase
from .utils import Time, units as u

__all__ = ["ChangeSampleShapeBase", "ChangeSampleShape", "Reshape",
           "Transpose", "ReshapeAndTranspose", "GetItem", "GetSlice"]


def _transpose(data, axes):
    return data.permute(axes) if torch.is_tensor(data) \
        else data.transpose(axes)


class ChangeSampleShapeBase(TaskBase):
    """Base for tasks that only rearrange the sample shape.

    Subclasses define ``task(data)`` operating on the trailing (sample)
    axes with the leading time axis untouched.
    """

    def __init__(self, ih, **kwargs):
        # Dry-run the shape operation on a dummy of the true frame shape
        # (incl. scalar samples -> 1-d frames) to derive the output sample
        # shape and check it keeps the time axis intact.
        dummy = np.empty((7,) + ih.sample_shape, dtype=np.int8)
        try:
            out = self.task(dummy)
        except Exception as exc:
            raise ValueError(
                f"shape operation failed on dummy input of shape "
                f"{dummy.shape}: {exc}") from exc
        if out.shape[0] != 7:
            raise ValueError("shape operation may not change the leading "
                             "(time) axis.")
        self._output_shape = out.shape[1:]
        # Transform the attributes through the same operation *before* the
        # base class validates them against the new sample shape.
        transformed = self._transform_attributes(ih)
        super().__init__(ih, **{**transformed, **kwargs})

    def _output_sample_shape(self, ih):
        return self._output_shape

    def _transform_attributes(self, ih):
        result = {}
        for name in META_ATTRIBUTES:
            value = getattr(ih, "meta", {}).get("__attributes__",
                                                {}).get(name)
            if value is None:
                continue
            unit = value.unit if isinstance(value, u.Quantity) else None
            arr = np.asarray(value.value if unit else value)
            full = np.broadcast_to(arr, ih.sample_shape)
            out = np.asarray(self.task(full[np.newaxis]))[0]
            result[name] = u.Quantity(out, unit) if unit else out
        return result


class ChangeSampleShape(ChangeSampleShapeBase):
    """Apply a user-supplied shape-changing function."""

    def __init__(self, ih, task, **kwargs):
        self._task_fn = task
        super().__init__(ih, **kwargs)

    def task(self, data):
        return self._task_fn(data)


class Reshape(ChangeSampleShapeBase):
    """Reshape the sample axes to ``sample_shape``."""

    def __init__(self, ih, sample_shape, **kwargs):
        self._sample_shape_target = tuple(sample_shape)
        super().__init__(ih, **kwargs)

    def task(self, data):
        return data.reshape((data.shape[0],) + self._sample_shape_target)


class Transpose(ChangeSampleShapeBase):
    """Transpose the sample axes with ``sample_axes`` (indices within the
    full shape, which includes the time axis 0)."""

    def __init__(self, ih, sample_axes, **kwargs):
        ndim = len(ih.sample_shape) + 1
        axes = tuple(a if a >= 0 else a + ndim for a in sample_axes)
        if 0 in axes:
            raise ValueError("cannot transpose the time axis (axis 0).")
        self._axes = (0,) + axes
        super().__init__(ih, **kwargs)

    def task(self, data):
        return _transpose(data, self._axes)


class ReshapeAndTranspose(Reshape):
    """Reshape then transpose in one task."""

    def __init__(self, ih, sample_shape, sample_axes, **kwargs):
        ndim = len(tuple(sample_shape)) + 1  # rank after the reshape
        axes = tuple(a if a >= 0 else a + ndim for a in sample_axes)
        if 0 in axes:
            raise ValueError("cannot transpose the time axis (axis 0).")
        self._axes_rt = (0,) + axes
        self._sample_shape_target = tuple(sample_shape)
        ChangeSampleShapeBase.__init__(self, ih, **kwargs)

    def task(self, data):
        return _transpose(data.reshape((data.shape[0],)
                                       + self._sample_shape_target),
                          self._axes_rt)


class GetItem(ChangeSampleShapeBase):
    """Select along sample axes with an arbitrary (non-time) index."""

    def __init__(self, ih, item, **kwargs):
        self._item = item
        super().__init__(ih, **kwargs)

    def task(self, data):
        if isinstance(self._item, tuple):
            return data[(slice(None),) + self._item]
        return data[:, self._item]


class GetSlice(BaseTaskBase):
    """A time-slice view of a stream (``ih[start:stop]``).

    Only slices with unit step are supported; start/stop may be integers or
    absolute Times.
    """

    def __init__(self, ih, item):
        if not isinstance(item, slice) or item.step not in (None, 1):
            raise IndexError("only unit-step slices supported along time.")
        n = ih.shape[0]
        start = item.start or 0
        stop = item.stop if item.stop is not None else n
        if isinstance(start, Time):
            start = ih._offset_from_time(start)
        if isinstance(stop, Time):
            stop = ih._offset_from_time(stop)
        if start < 0:
            start = max(start + n, 0)   # python slice semantics: clamp
        if stop < 0:
            stop = max(stop + n, 0)
        start = min(start, n)
        stop = min(stop, n)
        if stop <= start:
            raise IndexError("empty time slice.")
        self._start = start
        super().__init__(ih, shape=(stop - start,) + ih.sample_shape)
        self._start_time = ih._tell_time(start)

    def _tell_time(self, offset):
        return self.ih._tell_time(self._start + offset)

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        start = self._start + frame_index * spf
        stop = min(start + spf, self._start + self._shape[0])
        self.ih.seek(start)
        return self.ih.read(stop - start)
