"""Fast Folding Algorithm: all trial periods in [p, p+1) at once.

Counterpart of ``baseband_tasks_tpu/models/ffa.py``.  The FFA (Staelin
1969) folds a time series of ``m`` consecutive segments of ``p`` samples
at ``m`` trial periods between ``p`` and ``p + 1`` samples in ``log2(m)``
pairwise-combination stages — the standard deep search for long-period /
high-duty-cycle pulsars where the FFT-based search
(``models/accelsearch.py``) loses sensitivity to the sparse harmonic
comb.  Every stage is one ``gather`` + add over the whole (groups,
profiles, phase) tensor, so the trial bank advances in ``log2(m)`` device
passes of O(m·p) work each.  The JAX package runs these stages as plain
XLA (no kernel), and so the port runs them as plain torch on the tensor's
device.

Trial ``s`` (0..m-1) aligns segment ``i`` by rotating it back by
``~ i·s/(m-1)`` samples, i.e. it folds at period ``p + s/(m-1)``
samples.  The combination rule per stage (profiles ``j`` of the top and
bottom half-blocks, ``rot(b, k)[phi] = b[(phi + k) mod p]``)::

    out[2j]   = top[j] + rot(bottom[j], j)
    out[2j+1] = top[j] + rot(bottom[j], j + 1)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import units as u
from .meshtools import axis_devices, pad_to_multiple, require_mesh_axis

__all__ = ["FastFoldingSearch", "ffa_fold", "ffa_survey"]


def _as_tensor(x, device=None):
    """A tensor of ``x``: a tensor keeps its device, numpy goes to
    ``device`` (None: the card when there is one, else the CPU); float64
    becomes float32, as the JAX package's ``jnp.asarray`` makes it."""
    if not torch.is_tensor(x):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        x = torch.as_tensor(np.asarray(x), device=device)
    return x.to(torch.float32) if x.dtype == torch.float64 else x


def _ffa(x):
    """Core FFA over the last two axes: (..., m, p) -> (..., m, p)
    profiles, trial s on the m axis (m a power of two)."""
    m, p = x.shape[-2], x.shape[-1]
    batch = x.shape[:-2]
    # state: (..., groups, k profiles, p); start with m groups of 1
    s = x.reshape(batch + (m, 1, p))
    phase = torch.arange(p, device=x.device)[None, :]
    while s.shape[-3] > 1:
        k = s.shape[-2]
        top = s[..., 0::2, :, :]
        bot = s[..., 1::2, :, :]
        j = torch.arange(k, device=x.device)[:, None]
        idx0 = ((phase + j) % p).expand(bot.shape)      # rotate back by j
        idx1 = ((phase + j + 1) % p).expand(bot.shape)  # ... by j + 1
        r0 = torch.gather(bot, -1, idx0)
        r1 = torch.gather(bot, -1, idx1)
        # interleave: even trials from (top + r0), odd from (top + r1)
        out = torch.stack([top + r0, top + r1], dim=-2)
        s = out.reshape(batch + (s.shape[-3] // 2, 2 * k, p))
    return s[..., 0, :, :]


def ffa_fold(x, p, device=None):
    """Fold ``x`` (..., n) at all periods in [p, p+1) samples.

    The last axis is cropped to ``m*p`` with ``m`` the largest power of
    two (the FFA stage structure needs pow2 segment counts); returns
    ``(..., m, p)`` profiles, trial ``s`` = period ``p + s/(m-1)``.
    A numpy ``x`` goes to ``device`` (:func:`_as_tensor`).
    """
    x = _as_tensor(x, device)
    p = int(p)
    n = x.shape[-1]
    m = n // p
    if m < 2:
        raise ValueError(f"need at least 2 periods of {p} samples, "
                         f"have {n}")
    m = 1 << (m.bit_length() - 1)
    x = x[..., :m * p].reshape(tuple(x.shape[:-1]) + (m, p))
    return _ffa(x)


def _median(a):
    """Median over the last axis as ``jnp.median`` takes it: the mean of
    the two middle values when the axis is even (``torch.median`` returns
    the lower one)."""
    srt = torch.sort(a, dim=-1).values
    n = a.shape[-1]
    return 0.5 * (srt[..., (n - 1) // 2] + srt[..., n // 2])[..., None]


class FastFoldingSearch:
    """An FFA trial-period bank.

    Parameters
    ----------
    base_period : int
        Trial-bank start period in samples (``p``).
    n_time : int
        Samples per processed block; the largest pow2 number ``m`` of
        whole base periods is used, giving ``m`` trials with period
        resolution ``1/(m-1)`` samples across ``[p, p+1)``.
    sample_rate : Quantity, optional
        If given, :attr:`trial_periods` comes back as a time Quantity.
    device : torch device, optional
        Where a numpy block goes; ``None`` means CUDA when available.  A
        tensor block is folded on its own device.

    ``fold(x)`` folds a block; ``snr(x, widths=...)`` scores every
    (trial, phase) cell with boxcar matched filters and returns the
    best-width S/N per trial; ``candidates(x, threshold)`` the trials
    exceeding it.  To cover periods beyond ``[p, p+1)``, run one instance
    per integer ``p`` (the standard FFA survey loop), or downsample by 2
    between octaves.
    """

    def __init__(self, base_period, n_time, *, sample_rate=None,
                 device=None):
        self.p = int(base_period)
        if self.p < 2:
            raise ValueError("base_period must be at least 2 samples")
        m = int(n_time) // self.p
        if m < 2:
            raise ValueError(f"n_time={n_time} holds fewer than 2 base "
                             f"periods of {base_period}")
        self.m = 1 << (m.bit_length() - 1)
        self.n_time = int(n_time)
        self.sample_rate = sample_rate
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)

    @property
    def trial_periods(self):
        """Trial periods: samples (or seconds with a sample_rate)."""
        ps = self.p + np.arange(self.m) / max(self.m - 1, 1)
        if self.sample_rate is None:
            return ps
        return u.Quantity(ps / self.sample_rate.to_value(u.Hz), u.s)

    def _check_block(self, x):
        """Validate/crop a block so ``ffa_fold`` lands on exactly this
        instance's ``m`` trials: a shorter block would silently fold at a
        coarser trial grid than :attr:`trial_periods` reports, a longer
        one at a finer grid with more trials than reported."""
        x = _as_tensor(x, self.device)
        n = x.shape[-1]
        need = self.m * self.p
        if n < need:
            raise ValueError(
                f"block has {n} samples; this search needs at least "
                f"m*p = {self.m}*{self.p} = {need} (constructed for "
                f"n_time={self.n_time}); a shorter block would fold on "
                f"a different trial-period grid")
        return x[..., :need]

    def fold(self, x):
        """(..., n_time) -> (..., m, p) trial profiles."""
        return ffa_fold(self._check_block(x), self.p)

    def snr(self, x, widths=(1, 2, 4, 8, 16)):
        """Best boxcar-matched S/N per trial: (..., m)."""
        # a boxcar must stay well under one period: w >= p would wrap a
        # full turn (w >= p crashes, p/2 < w < p silently truncates)
        widths = tuple(w for w in (int(w) for w in widths)
                       if w <= self.p // 2) or (1,)
        prof = ffa_fold(self._check_block(x), self.p)
        # robust per-profile baseline and noise (median / MAD): a bright
        # pulse must not inflate its own noise estimate
        d = prof - _median(prof)
        sigma = 1.4826 * _median(d.abs())
        best = None
        for w in widths:
            # circular boxcar of width w via cumsum difference
            c = torch.cumsum(torch.cat([d, d[..., :w]], dim=-1), dim=-1)
            box = c[..., w:] - c[..., :-w] if w > 1 else d
            # matched-filter normalization: std of a w-bin sum is
            # sqrt(w)·sigma.  A zero MAD (constant or mostly-zero
            # profile) carries no noise estimate: score those trials 0
            s = torch.where(sigma > 0,
                            box / torch.clamp(math.sqrt(w) * sigma,
                                              min=1e-30),
                            torch.zeros((), dtype=box.dtype,
                                        device=box.device))
            peak = torch.amax(s, dim=-1)
            best = peak if best is None else torch.maximum(best, peak)
        return best

    def snr_sharded(self, x, mesh, *, axis_name="batch",
                    widths=(1, 2, 4, 8, 16)):
        """:meth:`snr` of a BATCH of series, sharded across the devices of
        a mesh axis (``parallel.Mesh``).

        The FFA's trial axis couples across segment halves at every stage
        of the recursion; the batch (DM trials, beams, polarizations) is
        the axis with no communication, so each device runs the whole
        recursion on its own rows.  ``x`` is ``(n_batch, n_time)``; a batch
        that does not divide the shard count is zero-padded (zero rows
        have zero MAD and score S/N 0) and trimmed from the ``(n_batch,
        m)`` result, joined on the first device of the axis.
        """
        n_shards = require_mesh_axis(mesh, axis_name)
        x = self._check_block(x)
        if x.ndim != 2:
            raise ValueError("snr_sharded wants a (n_batch, n_time) "
                             "stack of series")
        n_batch = x.shape[0]
        pad = pad_to_multiple(n_batch, n_shards)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        devices = axis_devices(mesh, axis_name)
        parts = [self.snr(rows.to(dev), widths)
                 for rows, dev in zip(x.chunk(n_shards), devices)]
        s = torch.cat([p.to(devices[0]) for p in parts])
        return s[:n_batch] if pad else s

    def candidates(self, x, threshold=7.0, widths=(1, 2, 4, 8, 16)):
        """Trials whose best S/N exceeds ``threshold``, as a list of
        ``{trial, period, snr}`` dicts sorted by descending S/N (host
        post-processing of the device S/N map)."""
        s = self.snr(x, widths).detach().cpu().numpy()
        if s.ndim != 1:
            raise ValueError("candidates() wants a single time series; "
                             "loop batch axes on the host")
        periods = self.trial_periods
        hits = np.flatnonzero(s > threshold)
        out = [{"trial": int(t), "period": periods[t],
                "snr": float(s[t])} for t in hits]
        out.sort(key=lambda c: -c["snr"])
        return out


def ffa_survey(x, p_min, p_max, *, sample_rate=None, threshold=7.0,
               widths=(1, 2, 4, 8, 16), device=None):
    """Survey all trial periods in ``[p_min, p_max)`` samples.

    The standard FFA survey loop: one :class:`FastFoldingSearch` per
    integer base period within an octave, downsampling the series by 2
    between octaves so the per-octave work stays ~constant (time
    resolution halves per octave, which the trial periods and reported
    candidate periods account for).  A numpy ``x`` goes to ``device``
    (:func:`_as_tensor`), a tensor stays on its own.

    Returns all candidates across the range, sorted by descending S/N,
    each ``{period, snr, trial, base_period, octave}`` with ``period`` in
    *original* samples (or a time Quantity with ``sample_rate``).
    """
    x = _as_tensor(x, device)
    if x.ndim != 1:
        raise ValueError("ffa_survey wants a single time series")
    p_min, p_max = int(p_min), int(p_max)
    if not 2 <= p_min < p_max:
        raise ValueError("need 2 <= p_min < p_max")
    out = []
    octave = 0
    scale = 1            # original samples per current sample
    lo = p_min
    while lo < p_max:
        hi = min(2 * p_min, (p_max + scale - 1) // scale)
        for p in range(lo, hi):
            if x.shape[-1] < 2 * p:
                break
            f = FastFoldingSearch(p, x.shape[-1], device=x.device)
            s = f.snr(x, widths).cpu().numpy()
            for t in np.flatnonzero(s > threshold):
                period = (p + t / max(f.m - 1, 1)) * scale
                if period >= p_max:
                    # the last base period's trial bank spans [p, p+1) in
                    # coarse samples; keep the documented range
                    continue
                out.append({"period": period, "snr": float(s[t]),
                            "trial": int(t), "base_period": p,
                            "octave": octave})
        # next octave at half the time resolution
        n2 = x.shape[-1] // 2 * 2
        x = x[:n2].reshape(-1, 2).sum(-1)
        scale *= 2
        octave += 1
        lo = p_min  # base periods repeat per octave on the coarser grid
        if scale * p_min >= p_max:
            break
    if sample_rate is not None:
        rate = sample_rate.to_value(u.Hz)
        for c in out:
            c["period"] = u.Quantity(c["period"] / rate, u.s)
    out.sort(key=lambda c: -c["snr"])
    return out
