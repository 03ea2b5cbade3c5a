"""Polarization basis conversion and Jones-matrix calibration.

Counterpart of ``baseband_tasks_tpu/polarization.py`` (beyond the
upstream baseband-tasks, which carries polarization labels but never acts
on the polarization state): converting between linear and circular feed
bases, and applying (or undoing) a 2x2 Jones matrix per channel.

Both are elementwise 2-vector maps along the polarization axis, a (2, 2)
complex product on the stream's device.  The matrices are complex64
tensors there (the JAX package's ``device_complex`` is a transfer
workaround of its TPU and has no counterpart).

Conventions: IAU/IEEE circular, ``L = (X - iY)/sqrt(2)``,
``R = (X + iY)/sqrt(2)`` (and the unitary inverse), so total power is
conserved exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TaskBase, getattr_if_none

__all__ = ["ConvertPolarization", "ApplyJones"]

_LINEAR = ({"X", "Y"}, {"H", "V"})
_CIRCULAR = ({"L", "R"},)

#: unitary linear -> circular map in (L, R) <- (X, Y) component order
_L2C = np.array([[1.0, -1.0j], [1.0, 1.0j]], np.complex64) / np.sqrt(2.0)


def _find_pol_axis(ih, pol_axis, polarization, *, required_len=2):
    """(pol_axis, ordered labels or None) for a dual-pol stream."""
    if pol_axis is not None:
        axis = pol_axis % len(ih.sample_shape)
        if ih.sample_shape[axis] != required_len:
            raise ValueError(
                f"pol_axis {pol_axis} has length "
                f"{ih.sample_shape[axis]}, need {required_len}")
        labels = None
        if polarization is not None:
            pols = np.broadcast_to(np.asarray(polarization),
                                   ih.sample_shape[len(ih.sample_shape)
                                   - np.ndim(polarization):])
            rel = axis - (len(ih.sample_shape) - pols.ndim)
            if 0 <= rel < pols.ndim:
                index = [0] * pols.ndim
                index[rel] = slice(None)
                labels = [str(p).upper() for p in pols[tuple(index)]]
        return axis, labels
    if polarization is None:
        raise ValueError("need polarization labels (or an explicit "
                         "pol_axis=)")
    pols = np.broadcast_to(np.asarray(polarization),
                           ih.sample_shape[len(ih.sample_shape)
                                           - np.ndim(polarization):])
    for rel in range(pols.ndim):
        if pols.shape[rel] != required_len:
            continue
        index = [0] * pols.ndim
        index[rel] = slice(None)
        line = [str(p).upper() for p in pols[tuple(index)]]
        if len(set(line)) == required_len:
            return rel + len(ih.sample_shape) - pols.ndim, line
    raise ValueError("could not find a length-2 polarization axis in "
                     f"labels {polarization}")


def _apply_matrix(data, mat, axis):
    """v' = mat @ v along ``axis`` of the sample shape (data has a
    leading time axis).  ``mat`` broadcasts against the remaining
    sample axes: shape (..., 2, 2)."""
    a = axis + 1  # the time axis
    m = mat.to(device=data.device, dtype=data.dtype)
    v0, v1 = (data.select(a, j).unsqueeze(-1) for j in (0, 1))
    # both output components at once, column by column: two elementwise
    # passes (a batched (2, 2) matmul would be a GEMM a sample)
    return torch.movedim(torch.addcmul(m[..., 0] * v0, m[..., 1], v1), -1, a)


class ConvertPolarization(TaskBase):
    """Convert dual-polarization voltages between feed bases.

    Parameters
    ----------
    ih : stream
        Complex dual-polarization voltages.
    to : {'circular', 'linear'}
        Target basis.  A stream already in the target basis is
        rejected (use `SetAttribute` to relabel instead).
    pol_axis : int, optional
        Polarization axis within the sample shape; inferred from the
        labels when not given.

    The (X, Y) <-> (L, R) maps are the unitary IAU/IEEE pair of the
    module docstring; output labels become ['L', 'R'] or ['X', 'Y'].
    """

    def __init__(self, ih, to, *, pol_axis=None, polarization=None):
        if ih.dtype.kind != "c":
            raise ValueError("polarization conversion needs complex "
                             "voltages")
        if to not in ("circular", "linear"):
            raise ValueError("to must be 'circular' or 'linear'")
        polarization = getattr_if_none(ih, "polarization", polarization,
                                       required=False)
        axis, labels = _find_pol_axis(ih, pol_axis, polarization)
        flip = False
        if labels is not None:
            pair = set(labels)
            src = "linear" if pair in _LINEAR else \
                "circular" if pair in _CIRCULAR else None
            if src == to:
                raise ValueError(f"stream is already {to}")
            if src is None and pol_axis is None:
                raise ValueError(f"cannot infer feed basis from labels "
                                 f"{pair}")
            # ['Y','X'] / ['R','L'] streams get the component-swapped
            # matrix
            flip = labels[0] in ("Y", "V", "R")
        mat = _L2C if to == "circular" else _L2C.conj().T
        if flip:
            # reversed input components AND reversed output rows keep
            # the label order of the stream
            mat = mat[::-1, ::-1]
        self._axis = axis
        new_pol = None
        if polarization is not None:
            out = ["L", "R"] if to == "circular" else ["X", "Y"]
            if flip:
                out = out[::-1]
            pols = np.broadcast_to(
                np.asarray(polarization),
                ih.sample_shape[len(ih.sample_shape)
                                - np.ndim(polarization):]).copy()
            rel = axis - (len(ih.sample_shape) - pols.ndim)
            if 0 <= rel < pols.ndim:
                sl = [slice(None)] * pols.ndim
                new = np.empty(pols.shape, dtype="U2")
                for k in range(2):
                    sl[rel] = k
                    new[tuple(sl)] = out[k]
                new_pol = new
            # else: an explicit pol_axis outside the span of the labels
            # (they broadcast over it): the labels cannot name the
            # converted components, so they are left unset
        super().__init__(ih, polarization=new_pol)
        self._mat = torch.as_tensor(np.ascontiguousarray(mat),
                                    device=self.device)

    def task(self, data):
        return _apply_matrix(data, self._mat, self._axis)


class ApplyJones(TaskBase):
    """Apply a 2x2 Jones matrix (per channel) to dual-pol voltages.

    Parameters
    ----------
    ih : stream
        Complex dual-polarization voltages.
    jones : array-like (..., 2, 2)
        Jones matrices; leading axes broadcast against the sample shape
        with the polarization axis REMOVED (e.g. ``(n_chan, 2, 2)`` for
        a per-channel calibration of a ``(n_chan, 2)`` sample shape).
    inverse : bool
        Apply ``inv(jones)`` instead, i.e. *calibrate* data that the
        instrument corrupted with ``jones``.
    pol_axis : int, optional
        Polarization axis within the sample shape; inferred from the
        labels when not given.

    ``.inverse()`` builds the undo task, so
    ``ApplyJones(ApplyJones(sh, J), J, inverse=True)`` is the identity
    to float roundoff.
    """

    def __init__(self, ih, jones, *, inverse=False, pol_axis=None,
                 polarization=None):
        if ih.dtype.kind != "c":
            raise ValueError("ApplyJones needs complex voltages")
        polarization = getattr_if_none(ih, "polarization", polarization,
                                       required=False)
        axis, _ = _find_pol_axis(ih, pol_axis, polarization)
        if torch.is_tensor(jones):
            jones = jones.detach().cpu().numpy()
        jones = np.asarray(jones, np.complex64)
        if jones.shape[-2:] != (2, 2):
            raise ValueError(f"jones must end in (2, 2), got "
                             f"{jones.shape}")
        self._jones = jones
        self._inverse = bool(inverse)
        mat = np.linalg.inv(jones) if inverse else jones
        # the leading shape must BE the sample shape without the pol
        # axis (extra leading dims would broadcast into the time axis)
        rest = tuple(s for i, s in enumerate(ih.sample_shape)
                     if i != axis)
        lead = mat.shape[:-2]
        try:
            ok = (len(lead) <= len(rest)
                  and np.broadcast_shapes(lead, rest) == tuple(rest))
        except ValueError:
            ok = False
        if not ok:
            raise ValueError(
                f"jones leading shape {lead} does not broadcast "
                f"against the non-pol sample shape {rest}")
        self._axis = axis
        super().__init__(ih)
        # trailing-aligned broadcasting puts the matrix against the
        # value's (..., rest, 2) layout directly
        self._mat = torch.as_tensor(np.ascontiguousarray(mat),
                                    device=self.device)

    def inverse(self, ih=None):
        """The task undoing this one (applied to ``ih`` or self)."""
        return ApplyJones(ih if ih is not None else self, self._jones,
                          inverse=not self._inverse,
                          pol_axis=self._axis)

    def task(self, data):
        return _apply_matrix(data, self._mat, self._axis)
