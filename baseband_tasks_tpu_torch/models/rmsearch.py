"""Rotation-measure synthesis: the Faraday depth spectrum as one matrix
product over channels.

Counterpart of ``baseband_tasks_tpu/models/rmsearch.py`` (beyond the
upstream baseband-tasks).  Faraday rotation winds the complex linear
polarization ``P(lambda**2) = Q + iU`` as ``exp(2 i phi lambda**2)``;
RM synthesis (Burn 1966; Brentjens & de Bruyn 2005) inverts that by
correlating against a bank of trial depths:

    F(phi) = sum_k w_k P_k exp(-2 i phi (lambda_k^2 - lambda_0^2))
             / sum_k w_k

The bank is one ``(..., n_chan) @ (n_chan, n_phi)`` product per Stokes
plane (four real products, ``torch.matmul`` at the port's
``matmul_precision()``, full FP32 by default), computed outside any
Pallas kernel in the JAX package too.  Sign conventions match
:class:`~baseband_tasks_tpu_torch.faraday.FaradayRotate`, so a voltage
stream rotated by ``rm`` peaks at ``phi = rm``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..faraday import C_M_PER_S
from ..utils import units as u
from ..utils.dtypes import default_device, to_numpy
from .meshtools import (axis_devices, mesh_cache_key, require_mesh_axis,
                        shard_columns)

__all__ = ["RMSynthesis"]


class RMSynthesis:
    """Faraday-depth transform of per-channel Stokes Q/U.

    Parameters
    ----------
    frequency : Quantity
        Per-channel frequencies, shape (n_chan,).
    phis : array or Quantity
        Trial Faraday depths (rad/m^2), shape (n_phi,).
    weights : array, optional
        Per-channel weights (default uniform); zero out flagged
        channels here.
    reference_lambda2 : {'mean', float}
        lambda_0^2 derotation point.  'mean' (default) uses the
        weighted mean of lambda^2.
    device : torch device, optional
        Where the transfer tables live and :meth:`fdf` runs on numpy
        input (default: the card when there is one).
    """

    def __init__(self, frequency, phis, *, weights=None,
                 reference_lambda2="mean", device=None):
        freq_hz = np.asarray(frequency.to_value(u.Hz), dtype=np.float64)
        if freq_hz.ndim != 1:
            raise ValueError("frequency must be one-dimensional "
                             "(per channel)")
        self.lam2 = (C_M_PER_S / freq_hz) ** 2
        if isinstance(phis, u.Quantity):
            phis = phis.to_value(u.rad / u.m ** 2)
        self.phis = np.asarray(phis, dtype=np.float64)
        w = (np.ones_like(self.lam2) if weights is None
             else np.asarray(weights, dtype=np.float64))
        if w.shape != self.lam2.shape:
            raise ValueError("weights must match the channel count")
        self.weights = w
        wsum = w.sum()
        if not wsum > 0:
            raise ValueError("weights sum to zero")
        if reference_lambda2 == "mean":
            self.lam2_0 = float((w * self.lam2).sum() / wsum)
        else:
            self.lam2_0 = float(reference_lambda2)
        self.device = default_device(device)
        theta = -2.0 * np.outer(self.lam2 - self.lam2_0, self.phis)
        self._set_tables((w[:, None] * np.cos(theta) / wsum)
                         .astype(np.float32),
                         (w[:, None] * np.sin(theta) / wsum)
                         .astype(np.float32))

    def _set_tables(self, tr, ti):
        self._tr = torch.as_tensor(np.ascontiguousarray(tr),
                                   device=self.device)
        self._ti = torch.as_tensor(np.ascontiguousarray(ti),
                                   device=self.device)

    @classmethod
    def from_jax_state(cls, frequency, phis, tr, ti, lam2_0, *,
                       weights=None, device=None):
        """A transform on the tables of a JAX ``RMSynthesis`` (its
        ``_tr`` / ``_ti`` as numpy and its ``lam2_0``)."""
        s = cls(frequency, phis, weights=weights, reference_lambda2=lam2_0,
                device=device)
        tr, ti = (np.array(t, dtype=np.float32) for t in (tr, ti))
        if tr.shape != tuple(s._tr.shape) or ti.shape != tr.shape:
            raise ValueError(f"tables of shape {tr.shape}/{ti.shape}, "
                             f"expected {tuple(s._tr.shape)}")
        s._set_tables(tr, ti)
        return s

    @property
    def n_phi(self):
        return self.phis.size

    @staticmethod
    def _fdf_impl(q, u_, tr, ti):
        # at the float32 matmul precision in force (ops.dft_matmul
        # .matmul_precision(); 'highest', full FP32, unless set)
        return torch.complex(q @ tr - u_ @ ti, q @ ti + u_ @ tr)

    def _planes(self, q, u_, device):
        def one(x):
            if not torch.is_tensor(x):
                x = torch.as_tensor(np.asarray(x))
            return x.to(device=device, dtype=torch.float32)
        return one(q), one(u_)

    def fdf(self, q, u_):
        """Faraday dispersion function F(phi) of Stokes planes.

        ``q``/``u_`` have channels on the LAST axis (any leading axes);
        returns a complex64 tensor (..., n_phi) on the transform's device.
        """
        return self._fdf_impl(*self._planes(q, u_, self.device),
                              self._tr, self._ti)

    def fdf_sharded(self, q, u_, mesh, *, axis_name="phi"):
        """:meth:`fdf` with the trial-depth bank sharded across the
        devices of a mesh axis (``parallel.Mesh``): each device holds
        ``n_phi / shards`` columns of the (n_chan, n_phi) transfer tables
        and computes its slice of the Faraday spectrum from the
        (replicated) planes, with no communication.  A grid that does
        not divide the shard count is zero-padded and the pad trimmed.
        Returns the (..., n_phi) spectrum of :meth:`fdf`, joined on the
        first device of the axis.
        """
        require_mesh_axis(mesh, axis_name)
        key = mesh_cache_key(mesh, axis_name)
        cache = self.__dict__.setdefault("_sharded_cache", {})
        if key not in cache:
            devices = axis_devices(mesh, axis_name)
            cache[key] = list(zip(devices, shard_columns(self._tr, devices),
                                  shard_columns(self._ti, devices)))
        parts = [self._fdf_impl(*self._planes(q, u_, dev), tr, ti)
                 for dev, tr, ti in cache[key]]
        dev0 = cache[key][0][0]
        f = torch.cat([p.to(dev0) for p in parts], dim=-1)
        return f[..., :self.n_phi] if f.shape[-1] != self.n_phi else f

    def rmsf(self, oversample=2):
        """RM spread function (the transform of the weights alone) over
        a ``oversample``-times-wider depth grid, as host numpy
        (phis, complex)."""
        span = self.phis.max() - self.phis.min()
        mid = 0.5 * (self.phis.max() + self.phis.min())
        # odd point count -> the grid contains the exact midpoint
        phis = np.linspace(mid - oversample * span / 2,
                           mid + oversample * span / 2,
                           oversample * max(self.phis.size, 2) + 1)
        theta = -2.0 * np.outer(phis, self.lam2 - self.lam2_0)
        w = self.weights / self.weights.sum()
        return phis, (np.exp(1j * theta) @ w)

    def candidates(self, q, u_, threshold=5.0):
        """(phi, |F|, snr) rows where ``|F(phi)|`` exceeds ``threshold``
        times the median |F| (host numpy, ``np.median``)."""
        f = to_numpy(self.fdf(q, u_))
        mag = np.abs(f).reshape(-1, self.n_phi)
        med = np.median(mag, axis=-1, keepdims=True)
        snr = mag / np.maximum(med, 1e-30)
        out = []
        for row in range(mag.shape[0]):
            for j in np.flatnonzero(snr[row] > threshold):
                out.append((float(self.phis[j]), float(mag[row, j]),
                            float(snr[row, j])))
        return out

    @staticmethod
    def stokes_qu(power_data, pol_axis=-1, *, device=None):
        """(Q, U) from :class:`~.functions.Power` output components
        ``[XX, YY, Re(XY*), Im(XY*)]`` (linear feeds): Q = XX - YY,
        U = 2 Re(X Y*).  A tensor keeps its device; numpy goes to
        ``device`` (default: the card when there is one)."""
        if not torch.is_tensor(power_data):
            power_data = torch.as_tensor(np.asarray(power_data),
                                         device=default_device(device))
        p = torch.movedim(power_data, pol_axis, -1)
        return p[..., 0] - p[..., 1], 2.0 * p[..., 2]
