"""Incoherent DM-trial search: many trial dedispersions as one product.

Counterpart of ``baseband_tasks_tpu/models/dmsearch.py``.  Given
channelized power, dedisperse at ``n_dm`` trial dispersion measures and
look for pulses; the whole trial bank is two FFTs and one contraction
over channels per frequency bin:

    P(t, c)  --rfft_t-->  P(f, c)
    D(f, j)  =  sum_c P(f, c) · exp(+2πi f τ(c, DM_j))
    d(t, j)  --irfft_f--  dedispersed time series per trial

The phase tables implement the per-channel *fractional* sample shifts
exactly (no rounding to integer samples, unlike shift-and-add).  They are
built in numpy exactly as the JAX package builds them (complex64 split
into float32 planes) and kept on the search's device; the contraction is
a batched ``einsum`` on both planes (cuBLAS on a card), computed outside
any Pallas kernel in the JAX package too.  The upstream baseband-tasks has
no DM search.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dm import DispersionMeasure
from ..utils import units as u
from ..utils.dtypes import default_device, to_numpy
from .meshtools import (axis_devices, mesh_cache_key, require_mesh_axis,
                        shard_columns)

__all__ = ["DMTrialSearch"]


class DMTrialSearch:
    """A trial-dedispersion bank over channelized power data.

    Parameters
    ----------
    frequency : Quantity (n_chan,)
        Channel centre frequencies.
    sample_rate : Quantity
        Time resolution of the input power samples.
    dms : array-like or DispersionMeasure (n_dm,)
        Trial dispersion measures.
    n_time : int
        Samples per processed block (power of two recommended).
    reference_frequency : Quantity, optional
        Delays are relative to this frequency (default: max channel, so
        all trial delays are positive).
    device : torch device, optional
        Where the phase tables live and the search runs (default: the
        card when there is one).

    Call :meth:`search` with a ``(n_time, n_chan)`` block to get
    ``(n_time, n_dm)`` trial-dedispersed time series.  The tail
    ``max_delay_samples`` of each output column wraps (circular FFT
    convention): feed overlapping blocks and discard the tail, as in
    overlap-save.
    """

    def __init__(self, frequency, sample_rate, dms, n_time, *,
                 reference_frequency=None, device=None):
        freq = u.Quantity(np.atleast_1d(np.asarray(
            frequency.to_value(u.MHz), dtype=np.float64)), u.MHz)
        if not isinstance(dms, DispersionMeasure):
            dms = DispersionMeasure(np.atleast_1d(np.asarray(dms,
                                                             dtype=float)))
        if reference_frequency is None:
            reference_frequency = u.Quantity(
                freq.to_value(u.MHz).max(), u.MHz)
        self.frequency = freq
        self.dms = dms
        self.reference_frequency = reference_frequency
        self.sample_rate = sample_rate
        self.n_time = int(n_time)
        self.device = default_device(device)
        rate_hz = sample_rate.to_value(u.Hz)
        # delay per (chan, trial) in samples
        tau = dms.time_delay(freq[:, np.newaxis],
                             reference_frequency).to_value(u.s) * rate_hz
        self.max_delay_samples = int(np.ceil(np.abs(tau).max()))
        if self.max_delay_samples >= self.n_time:
            raise ValueError(
                f"n_time {n_time} shorter than the maximum trial delay "
                f"({self.max_delay_samples} samples); raise n_time or "
                f"lower the DM range")
        f = np.fft.rfftfreq(self.n_time)[:, np.newaxis, np.newaxis]
        # advancing channel c by its delay tau removes the dispersion:
        # y(t) = x(t + tau)  <->  X(f)·exp(+2πi f tau)
        phase = np.exp(+2j * np.pi * f * tau[np.newaxis]) \
            .astype(np.complex64)                  # (n_freq, n_chan, n_dm)
        self._n_freq = phase.shape[0]
        self._phase_r = torch.as_tensor(np.ascontiguousarray(phase.real),
                                        device=self.device)
        self._phase_i = torch.as_tensor(np.ascontiguousarray(phase.imag),
                                        device=self.device)

    @classmethod
    def from_jax_state(cls, frequency, sample_rate, dms, n_time, phase_r,
                       phase_i, *, reference_frequency=None, device=None):
        """A search on the phase tables of a JAX ``DMTrialSearch`` (its
        ``_phase_r`` / ``_phase_i`` as numpy), with the same parameters."""
        s = cls(frequency, sample_rate, dms, n_time,
                reference_frequency=reference_frequency, device=device)
        for name, table in (("_phase_r", phase_r), ("_phase_i", phase_i)):
            table = np.array(table, dtype=np.float32)
            if table.shape != tuple(getattr(s, name).shape):
                raise ValueError(f"{name} of shape {table.shape}, expected "
                                 f"{tuple(getattr(s, name).shape)}")
            setattr(s, name, torch.as_tensor(table, device=s.device))
        return s

    def _search_impl(self, power, pr, pi):
        ft = torch.fft.rfft(power.to(torch.float32), dim=0)
        fr, fi = ft.real, ft.imag

        # D(f, j) = sum_c F(f, c)·(pr + i·pi)(f, c, j): real batched
        # products (batch = frequency bin)
        def bmm(a, b):
            return torch.einsum("fc,fcj->fj", a, b)

        dr = bmm(fr, pr) - bmm(fi, pi)
        di = bmm(fr, pi) + bmm(fi, pr)
        return torch.fft.irfft(torch.complex(dr, di), n=self.n_time, dim=0)

    def _block(self, power, device, pad=False):
        """``power`` as a float32 tensor on ``device`` of the block's
        shape; with ``pad``, a short block (a stream's tail) is
        zero-filled to ``n_time`` rows first."""
        if not torch.is_tensor(power):
            power = torch.as_tensor(np.asarray(power))
        power = power.to(device=device, dtype=torch.float32)
        if pad and power.ndim == 2 and power.shape[0] < self.n_time:
            power = torch.nn.functional.pad(
                power, (0, 0, 0, self.n_time - power.shape[0]))
        if tuple(power.shape) != (self.n_time, len(self.frequency)):
            raise ValueError(
                f"expected block shape ({self.n_time}, "
                f"{len(self.frequency)}), got {tuple(power.shape)}")
        return power

    def search(self, power):
        """Trial-dedisperse one block: (n_time, n_chan) -> (n_time, n_dm),
        a float32 tensor on the search's device.

        Only rows ``[0, n_time - max_delay_samples)`` are valid (the
        rest wrap circularly).
        """
        return self._search_impl(self._block(power, self.device),
                                 self._phase_r, self._phase_i)

    def search_sharded(self, power, mesh, *, axis_name="dm"):
        """:meth:`search` with the DM trials sharded across the devices of
        a mesh axis (``parallel.Mesh``).

        The trial axis is a pure batch axis: each device holds ``n_dm /
        shards`` columns of the (n_freq, n_chan, n_dm) phase tables and
        computes its slice of the bank from the (replicated) block, with
        no communication.  A trial count that does not divide the shard
        count is zero-padded (the JAX package requires it to divide) and
        the pad trimmed.  The per-device tables are cached per (mesh,
        axis).  Returns the (n_time, n_dm) map of :meth:`search`, joined
        on the first device of the axis.
        """
        require_mesh_axis(mesh, axis_name)
        key = mesh_cache_key(mesh, axis_name)
        cache = self.__dict__.setdefault("_sharded_cache", {})
        if key not in cache:
            devices = axis_devices(mesh, axis_name)
            cache[key] = list(zip(devices,
                                  shard_columns(self._phase_r, devices),
                                  shard_columns(self._phase_i, devices)))
        shards = cache[key]
        outs = [self._search_impl(self._block(power, dev), pr, pi)
                for dev, pr, pi in shards]
        n_dm = len(self.dms)
        d = torch.cat([o.to(shards[0][0]) for o in outs], dim=1)
        return d[:, :n_dm] if d.shape[1] != n_dm else d

    def detect(self, power, widths=(1, 2, 4, 8, 16, 32)):
        """Matched-filter the trial bank with boxcars and return S/N.

        For each trial DM and boxcar width ``w`` (samples), computes the
        running ``w``-sample sum via cumulative sums, normalizes by the
        per-trial noise (mean and population std over the valid region,
        as ``jnp.std``), and returns the best S/N over widths.

        Returns ``(snr, best_width)``: two (n_valid, n_dm) float32 numpy
        arrays, where ``snr[t, j]`` is the significance of a pulse
        *starting* at sample ``t`` in trial ``j``.
        """
        d = self.search(power)
        valid = self.n_time - self.max_delay_samples
        snr, bw = self._detect(d[:valid], tuple(int(w) for w in widths))
        return to_numpy(snr), to_numpy(bw)

    @staticmethod
    def _detect(d, widths):
        mu = d.mean(dim=0, keepdim=True)
        sd = d.std(dim=0, keepdim=True, correction=0) + 1e-30
        z = (d - mu) / sd
        c = torch.cat([torch.zeros((1,) + z.shape[1:], dtype=z.dtype,
                                   device=z.device),
                       torch.cumsum(z, dim=0)])
        best_snr = torch.full(z.shape, -torch.inf, dtype=z.dtype,
                              device=z.device)
        best_w = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
        for w in widths:
            # the sum of w unit-variance samples has std sqrt(w)
            s = (c[w:] - c[:-w]) / float(np.sqrt(w))
            if w > 1:
                s = torch.cat([s, torch.full((w - 1,) + s.shape[1:],
                                             -torch.inf, dtype=s.dtype,
                                             device=s.device)])
            take = s > best_snr
            best_snr = torch.where(take, s, best_snr)
            best_w = torch.where(take, torch.tensor(float(w),
                                                    device=z.device),
                                 best_w)
        return best_snr, best_w

    def candidates(self, power, threshold=8.0,
                   widths=(1, 2, 4, 8, 16, 32), time_tol=None,
                   dm_tol=None):
        """Clustered single-pulse candidates from one block (host numpy).

        Runs :meth:`detect`, thresholds the (time, trial) S/N map, and
        clusters the hits greedily by descending S/N (heimdall-style,
        time-first): each unclaimed peak becomes a candidate and claims
        every hit within ``time_tol`` samples across ALL trial DMs
        (default: the search's ``max_delay_samples``, or twice the summed
        boxcar widths if larger); DM is a clustering axis only when
        ``dm_tol`` (trials) is given.

        Returns a list of dicts, strongest first:
        ``{'time_sample', 'dm', 'snr', 'width', 'n_hits'}`` with ``dm``
        in the trial units (pc/cm^3).
        """
        snr, bw = self.detect(power, widths)
        tj = np.argwhere(snr > threshold)
        if tj.size == 0:
            return []
        s = snr[tj[:, 0], tj[:, 1]]
        w = bw[tj[:, 0], tj[:, 1]]
        order = np.argsort(-s)
        t, j = tj[order, 0], tj[order, 1]
        s, w = s[order], w[order]
        claimed = np.zeros(t.size, bool)
        dmv = np.asarray(self.dms.value if hasattr(self.dms, "value")
                         else self.dms).reshape(-1)
        out = []
        for i in range(t.size):
            if claimed[i]:
                continue
            tol = (time_tol if time_tol is not None
                   else np.maximum(2 * (max(w[i], 1) + np.maximum(w, 1)),
                                   self.max_delay_samples))
            near = ~claimed & (np.abs(t - t[i]) <= tol)
            if dm_tol is not None:
                near &= np.abs(j - j[i]) <= dm_tol
            claimed |= near
            out.append({"time_sample": int(t[i]),
                        "dm": float(dmv[j[i]]),
                        "snr": float(s[i]), "width": int(w[i]),
                        "n_hits": int(near.sum())})
        return out

    def search_stream(self, ih, count=None):
        """Overlap-save search over a stream of channelized power.

        Reads successive overlapping ``n_time`` windows from ``ih``
        (shape (n, n_chan)), discards the wrapped tail, and concatenates
        ``count`` valid output samples (default: as many as available)
        into one tensor on the search's device.
        """
        valid = self.n_time - self.max_delay_samples
        n_avail = ih.shape[0] - ih.tell() - self.max_delay_samples
        if count is None:
            count = n_avail
        count = min(count, n_avail)
        if count <= 0:
            raise ValueError(
                f"no valid output available: the stream must have more "
                f"than max_delay_samples ({self.max_delay_samples}) "
                f"samples beyond the current position")
        outs = []
        got = 0
        while got < count:
            start = ih.tell()
            block = self._block(ih.read(min(self.n_time,
                                            ih.shape[0] - start)),
                                self.device, pad=True)
            take = min(valid, count - got)
            outs.append(self.search(block)[:take])
            got += take
            ih.seek(start + take)
        return torch.cat(outs)
