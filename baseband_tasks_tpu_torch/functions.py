"""Detection tasks: Square (total power) and Power (polarization products).

Counterpart of ``baseband_tasks_tpu/functions.py``: elementwise tensor
math on the stream's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TaskBase, getattr_if_none

__all__ = ["complex_square", "Square", "Power"]


def complex_square(z):
    """``|z|**2`` without the sqrt: ``z.real**2 + z.imag**2``."""
    return z.real ** 2 + z.imag ** 2


class Square(TaskBase):
    """Total-power detection: real ``x**2`` or complex ``|x|**2``.

    Polarization labels double (``'X'`` -> ``'XX'``).
    """

    def __init__(self, ih):
        polarization = getattr(ih, "polarization", None)
        if polarization is not None:
            polarization = np.char.add(polarization, polarization)
        real_dtype = np.empty(0, dtype=ih.dtype).real.dtype
        super().__init__(ih, dtype=real_dtype, polarization=polarization)

    def task(self, data):
        if data.is_complex():
            return complex_square(data)
        return data ** 2


class Power(TaskBase):
    """Polarization powers & cross terms for dual-polarization complex data.

    Output sample shape replaces the 2-element polarization axis by 4
    components: ``XX = |X|²``, ``YY = |Y|²``, ``Re(X Y*)``, ``Im(X Y*)``.
    """

    def __init__(self, ih, polarization=None):
        polarization = getattr_if_none(ih, "polarization", polarization)
        polarization = np.asarray(polarization)
        if ih.dtype.kind != "c":
            raise ValueError("Power requires complex voltage data.")
        # Find the polarization axis within the sample shape.
        pol_axis = None
        if polarization.ndim == 0:
            raise ValueError("need 2 distinct polarizations for Power.")
        full = np.broadcast_to(polarization,
                               ih.sample_shape[-polarization.ndim:])
        for axis in range(full.ndim):
            index = [0] * full.ndim
            index[axis] = slice(None)
            line = full[tuple(index)]
            if len(np.unique(line)) == 2:
                pol_axis = axis + (len(ih.sample_shape) - full.ndim)
                pols = line
                break
        if pol_axis is None:
            raise ValueError(
                "could not find a length-2 polarization axis; got "
                f"{polarization}")
        if ih.sample_shape[pol_axis] != 2:
            raise ValueError("polarization axis must have length 2.")
        self._pol_axis = pol_axis
        x, y = (str(p) for p in pols)
        out_pols = np.array([x + x, y + y, x + y, y + x])
        # position the labels on the polarization axis of the output shape
        trailing = len(ih.sample_shape) - pol_axis - 1
        if trailing:
            out_pols = out_pols.reshape((4,) + (1,) * trailing)
        real_dtype = np.empty(0, dtype=ih.dtype).real.dtype
        super().__init__(ih, shape=None, dtype=real_dtype,
                         polarization=out_pols)

    def _output_sample_shape(self, ih):
        pol_axis = self._pol_axis
        return (ih.sample_shape[:pol_axis] + (4,)
                + ih.sample_shape[pol_axis + 1:])

    def task(self, data):
        axis = self._pol_axis + 1  # account for leading time axis
        x = data.select(axis, 0)
        y = data.select(axis, 1)
        xy = x * y.conj()
        comps = [x.real ** 2 + x.imag ** 2,
                 y.real ** 2 + y.imag ** 2,
                 xy.real, xy.imag]
        return torch.stack(comps, dim=axis)
