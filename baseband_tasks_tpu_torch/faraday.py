"""Faraday rotation of polarized voltage streams.

Counterpart of ``baseband_tasks_tpu/faraday.py`` (beyond the upstream
baseband-tasks, which has no polarization calibration).  Magnetized
plasma along the line of sight rotates the polarization position angle by
``psi(nu) = RM * lambda(nu)**2`` (RM in rad/m^2); on raw voltages the
rotation is applied -- or, with the opposite sign, coherently removed
before detection -- exactly, per channel:

* linear feeds (labels like X/Y): the 2x2 rotation
  ``[x', y'] = [x cos(psi) - y sin(psi), x sin(psi) + y cos(psi)]``;
* circular feeds (labels like L/R): pure phases
  ``l' = l exp(+i psi)``, ``r' = r exp(-i psi)``.

Conventions as in the JAX package: psi grows counterclockwise (X toward
Y) for positive RM, so the detected ``P = Q + iU`` winds as
``exp(2i RM lambda**2)``, the sign :class:`~.models.RMSynthesis`
inverts.  ``reference_frequency`` holds that frequency's position angle
fixed instead of the infinite-frequency one.

Per-channel elementwise tensor math on the stream's device; ``task_planes``
keeps a compiled planes chain (``models/compiled.py``) in separate re/im
planes, since the rotation's coefficients are real.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TaskBase, getattr_if_none
from .polarization import _apply_matrix
from .utils import units as u

__all__ = ["FaradayRotate", "DeFaraday", "C_M_PER_S"]

#: speed of light (m/s), for lambda = c / nu
C_M_PER_S = 299_792_458.0

_LINEAR_PAIRS = ({"X", "Y"}, {"H", "V"})
_CIRCULAR_PAIRS = ({"L", "R"},)


def _rm_to_value(rm):
    """rad/m^2 as a plain float from a float or a units.Quantity."""
    if isinstance(rm, u.Quantity):
        return float(rm.to_value(u.rad / u.m ** 2))
    return float(rm)


class FaradayRotate(TaskBase):
    """Rotate the polarization of dual-pol complex voltages by
    ``psi(nu) = rm * (lambda(nu)**2 - lambda_ref**2)``.

    Parameters
    ----------
    ih : stream
        Complex dual-polarization input with per-channel ``frequency``
        labels.
    rm : float or Quantity
        Rotation measure in rad/m^2.  Positive applies the physical
        rotation; negative coherently de-rotates (see :class:`DeFaraday`).
    reference_frequency : Quantity, optional
        Frequency whose position angle is held fixed (default: the
        infinite-frequency angle, lambda_ref = 0).
    basis : {'linear', 'circular'}, optional
        Feed basis; inferred from polarization labels (X/Y, H/V ->
        linear; L/R -> circular) when not given.
    pol_axis : int, optional
        Polarization axis within the sample shape; inferred from the
        labels when not given.
    """

    def __init__(self, ih, rm, *, reference_frequency=None, basis=None,
                 pol_axis=None, polarization=None):
        if ih.dtype.kind != "c":
            raise ValueError("FaradayRotate requires complex voltages "
                             "(rotate before detection).")
        polarization = getattr_if_none(ih, "polarization", polarization,
                                       required=False)
        # component order along the pol axis: index of the X/H/L-like
        # component, then the Y/V/R-like one; (X, Y) / (L, R) without
        # labels
        order = (0, 1)
        if pol_axis is None or basis is None:
            if polarization is None:
                raise ValueError("need polarization labels (or explicit "
                                 "pol_axis= and basis=)")
            pols = np.broadcast_to(np.asarray(polarization),
                                   ih.sample_shape[len(ih.sample_shape)
                                                   - np.ndim(polarization):])
            found = None
            for axis in range(pols.ndim):
                index = [0] * pols.ndim
                index[axis] = slice(None)
                line = [str(p).upper() for p in pols[tuple(index)]]
                if len(set(line)) == 2:
                    found = (axis + len(ih.sample_shape) - pols.ndim,
                             line)
                    break
            if found is None:
                raise ValueError("could not find a length-2 polarization"
                                 f" axis in labels {polarization}")
            inferred_axis, line = found
            if pol_axis is None:
                pol_axis = inferred_axis
            pair = set(line)
            if basis is None:
                if pair in _LINEAR_PAIRS:
                    basis = "linear"
                elif pair in _CIRCULAR_PAIRS:
                    basis = "circular"
                else:
                    raise ValueError(
                        f"cannot infer feed basis from labels {pair}; "
                        f"pass basis='linear' or 'circular'")
            # the label ORDER decides the sign: ['Y','X'] or ['R','L']
            # streams get the same physics as ['X','Y'] / ['L','R']
            if line[0] in ("Y", "V", "R"):
                order = (1, 0)
        if basis not in ("linear", "circular"):
            raise ValueError(f"unknown basis {basis!r}")
        pol_axis = int(pol_axis) % len(ih.sample_shape)
        if ih.sample_shape[pol_axis] != 2:
            raise ValueError("polarization axis must have length 2")
        frequency = getattr(ih, "frequency", None)
        if frequency is None:
            raise ValueError("input needs per-channel frequency labels")

        self._rm = _rm_to_value(rm)
        self._basis = basis
        self._pol_axis = pol_axis
        self._order = order
        # psi per sample-shape element (the same on both pols)
        freq_hz = np.broadcast_to(
            np.asarray(frequency.to_value(u.Hz), dtype=np.float64),
            ih.sample_shape)
        if not (np.ptp(freq_hz, axis=self._pol_axis) == 0).all():
            raise ValueError("frequency must not vary along the "
                             "polarization axis")
        lam2 = (C_M_PER_S / freq_hz) ** 2
        if reference_frequency is not None:
            lam2 = lam2 - (C_M_PER_S
                           / float(reference_frequency.to_value(u.Hz))
                           ) ** 2
        self._psi = self._rm * np.take(lam2, 0, axis=self._pol_axis)
        self._reference_frequency = reference_frequency
        self._phase_cache = None
        self._rot = None
        super().__init__(ih, polarization=polarization)

    @property
    def rm(self):
        """Rotation measure (rad/m^2)."""
        return u.Quantity(self._rm, u.rad / u.m ** 2)

    @property
    def basis(self):
        return self._basis

    def _trig(self):
        """(cos psi, sin psi) as float32 tensors on the stream's device,
        shaped (1,) + sample shape without the polarization axis (they
        broadcast against one pol component with its time axis)."""
        if self._phase_cache is None:
            c = np.cos(self._psi).astype(np.float32)[np.newaxis]
            s = np.sin(self._psi).astype(np.float32)[np.newaxis]
            self._phase_cache = (torch.as_tensor(c, device=self.device),
                                 torch.as_tensor(s, device=self.device))
        return self._phase_cache

    def _rotation(self):
        """The linear basis' real rotation as (..., 2, 2) float32 matrices
        on the components in stream order, [[c, -s], [s, c]] for an
        (X, Y) stream and its transpose for (Y, X), on the stream's
        device (made once)."""
        if self._rot is None:
            c, s = (t[0] for t in self._trig())
            if self._order != (0, 1):
                s = -s
            self._rot = torch.stack([torch.stack([c, -s], dim=-1),
                                     torch.stack([s, c], dim=-1)], dim=-2)
        return self._rot

    def _split(self, x):
        axis = self._pol_axis + 1
        ix, iy = self._order
        return x.select(axis, ix), x.select(axis, iy)

    def _join(self, xo, yo):
        comps = [None, None]
        comps[self._order[0]], comps[self._order[1]] = xo, yo
        return torch.stack(comps, dim=self._pol_axis + 1)

    def task(self, data):
        if self._basis == "linear":
            return _apply_matrix(data, self._rotation(), self._pol_axis)
        # l' = l e^{+i psi}, r' = r e^{-i psi}
        c, s = (t.to(data.device) for t in self._trig())
        rot = torch.complex(c, s).to(data.dtype)
        a, b = self._split(data)            # L-like, R-like
        return self._join(a * rot, b * rot.conj())

    def task_planes(self, pair):
        """Planes form: the rotation has real coefficients on each
        plane, so re and im never recombine (models/compiled.py)."""
        xr, xi = pair
        if xi is None:
            return NotImplemented
        if self._basis == "linear":
            rot = self._rotation()
            return (_apply_matrix(xr, rot, self._pol_axis),
                    _apply_matrix(xi, rot, self._pol_axis))
        c, s = (t.to(xr.device) for t in self._trig())
        ar, br = self._split(xr)
        ai, bi = self._split(xi)
        # (a_r + i a_i)(c + i s); the conjugate for the R-like one
        xo = (c * ar - s * ai, c * ai + s * ar)
        yo = (c * br + s * bi, c * bi - s * br)
        return self._join(xo[0], yo[0]), self._join(xo[1], yo[1])


class DeFaraday(FaradayRotate):
    """Coherently remove Faraday rotation of measure ``rm``:
    :class:`FaradayRotate` with the opposite sign (Dedisperse is to
    Disperse as DeFaraday is to FaradayRotate)."""

    def __init__(self, ih, rm, **kwargs):
        rm = _rm_to_value(rm)
        super().__init__(ih, -rm, **kwargs)

    @property
    def rm(self):
        """The rotation measure being removed (rad/m^2)."""
        return u.Quantity(-self._rm, u.rad / u.m ** 2)
