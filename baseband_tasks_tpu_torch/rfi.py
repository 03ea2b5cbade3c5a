"""RFI detection and excision via the generalized spectral kurtosis.

Counterpart of ``baseband_tasks_tpu/rfi.py`` (beyond the upstream
baseband-tasks, which has no RFI module).  The statistic is the
generalized spectral-kurtosis (SK) estimator of Nita & Gary (2010, MNRAS
406, L60): for ``M`` accumulated power samples per channel,

    SK = (M d + 1) / (M - 1) * (M * S2 / S1**2 - 1),

with ``S1 = sum p``, ``S2 = sum p**2`` and ``d`` the gamma shape of a
single power sample (1 for the squared magnitude of complex Gaussian
voltage, 1/2 for squared real Gaussian voltage).  For clean noise
``E[SK] = 1`` with asymptotic ``Var[SK] = 2 (d + 1) / (M d)``;
continuous-wave RFI drives SK below 1, impulsive RFI above 1.

Both tasks are time-local block reductions, tensor math on the stream's
device with no host synchronization.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TaskBase
from .functions import complex_square
from .utils.dtypes import default_device

__all__ = ["spectral_kurtosis", "sk_sigma", "SpectralKurtosis",
           "ExciseSpectralKurtosis"]


def _gamma_shape(dtype, d):
    """Per-sample power gamma shape: 1 (complex voltage), 1/2 (real)."""
    if d is not None:
        if d <= 0:
            raise ValueError("gamma shape d must be positive")
        return float(d)
    return 1.0 if np.dtype(dtype).kind == "c" else 0.5


def _power(data):
    return complex_square(data) if data.is_complex() else data ** 2


def spectral_kurtosis(power, n, d=1.0, axis=0, *, device=None):
    """Generalized SK estimator over blocks of ``n`` along ``axis``.

    ``power`` holds non-negative per-sample powers whose length along
    ``axis`` is a multiple of ``n``: a tensor keeps its device, numpy
    goes to ``device`` (default: the card when there is one).  Returns
    a tensor with that axis reduced by ``n``; clean Gaussian noise gives
    values near 1.
    """
    if n < 2:
        raise ValueError("need at least 2 samples per SK block")
    if not torch.is_tensor(power):
        power = torch.as_tensor(np.asarray(power),
                                device=default_device(device))
    shape = tuple(power.shape)
    if shape[axis] % n:
        raise ValueError(f"axis length {shape[axis]} is not a multiple "
                         f"of the block size {n}")
    axis = axis % power.ndim
    blocked = power.reshape(
        shape[:axis] + (shape[axis] // n, n) + shape[axis + 1:])
    s1 = blocked.sum(dim=axis + 1)
    s2 = (blocked * blocked).sum(dim=axis + 1)
    # an all-zero block (padding, dropped frames) has no defined SK;
    # report the clean value so it is not flagged
    empty = s1 == 0
    v = n * s2 / torch.where(empty, torch.ones_like(s1), s1 * s1)
    sk = (n * d + 1.0) / (n - 1.0) * (v - 1.0)
    return torch.where(empty, torch.ones_like(sk), sk)


def sk_sigma(n, d=1.0):
    """Asymptotic standard deviation of the SK estimator for clean
    noise: ``sqrt(2 (d + 1) / (n d))``."""
    return float(np.sqrt(2.0 * (d + 1.0) / (n * d)))


class SpectralKurtosis(TaskBase):
    """SK statistic stream: one value per channel per ``n`` samples.

    Takes a *voltage* stream (real or complex; power is formed
    internally) and produces the per-channel spectral kurtosis at
    ``sample_rate / n``, the diagnostic companion of
    :class:`ExciseSpectralKurtosis`.

    Parameters
    ----------
    ih : stream
        Input voltages, typically channelized.
    n : int
        Power samples accumulated per SK estimate (``M``).
    d : float, optional
        Gamma shape of one power sample.  Default: 1 for complex input,
        1/2 for real input.
    """

    def __init__(self, ih, n, *, d=None, samples_per_frame=None):
        if n < 2:
            raise ValueError("need at least 2 samples per SK block")
        self._n = int(n)
        self._d = _gamma_shape(ih.dtype, d)
        super().__init__(ih, sample_rate=ih.sample_rate / n,
                         samples_per_frame=samples_per_frame,
                         dtype=np.float32)

    @property
    def sigma(self):
        """Clean-noise standard deviation of the output values."""
        return sk_sigma(self._n, self._d)

    def task(self, data):
        return spectral_kurtosis(_power(data), self._n, self._d).to(
            torch.float32)


class ExciseSpectralKurtosis(TaskBase):
    """Zero channel-blocks whose spectral kurtosis is non-thermal.

    A same-shape, same-rate transform: the stream is cut into blocks of
    ``n`` samples per channel; any (block, channel) cell whose SK
    deviates from 1 by more than ``threshold`` clean-noise sigmas is
    replaced by ``fill``.  The false-alarm rate on clean data is the
    two-sided Gaussian tail, ~0.3% at the default ``threshold=3``.

    Parameters
    ----------
    ih : stream
        Input voltages, typically channelized.
    n : int
        Samples per SK decision block (``M``).  Frames are sized to a
        multiple of ``n``; a partial block at the very end of the
        stream is judged with its own (shorter) ``M`` when it has >= 2
        samples and passed through unflagged otherwise.
    threshold : float, optional
        Flagging threshold in units of the clean-noise sigma.
    d : float, optional
        Gamma shape of one power sample (see module docstring).
    fill : float, optional
        Value written into flagged cells (default 0).  Use ``np.nan``
        with a downstream ``Integrate``/``Fold`` built with
        ``masked=True``, which then excludes flagged cells from the
        averages.  NaN fill is meant for detection-stage chains (flag ->
        detect -> integrate); one NaN fed into an FFT stage smears over
        the whole transform.
    """

    def __init__(self, ih, n, *, threshold=3.0, d=None, fill=0.0,
                 samples_per_frame=None):
        if n < 2:
            raise ValueError("need at least 2 samples per SK block")
        self._n = int(n)
        self._fill = complex(fill) if np.dtype(ih.dtype).kind == "c" \
            else float(fill)
        self._threshold = float(threshold)
        self._d = _gamma_shape(ih.dtype, d)
        if samples_per_frame is None:
            spf = getattr(ih, "samples_per_frame", 1)
            samples_per_frame = max(round(spf / n), 1) * n
        elif samples_per_frame % n:
            raise ValueError(f"samples_per_frame {samples_per_frame} "
                             f"must be a multiple of the block size {n}")
        # compiled steps cut the stream on the decision-block grid, so
        # compiled == eager flag for flag (models/compiled.py)
        self._task_granularity = self._n
        super().__init__(ih, samples_per_frame=samples_per_frame)

    @property
    def sigma(self):
        """Clean-noise standard deviation of the SK statistic."""
        return sk_sigma(self._n, self._d)

    def _keep_mask(self, power, n):
        sk = spectral_kurtosis(power, n, self._d)
        limit = self._threshold * sk_sigma(n, self._d)
        return (sk - 1.0).abs() <= limit

    def _excise(self, data, n):
        power = _power(data)
        keep = self._keep_mask(power, n)              # (k,) + sample_shape
        keep = keep.repeat_interleave(n, dim=0)       # (k*n,) + sample_shape
        if self._fill == 0:
            # a multiply, as in the JAX package: 0 * inf is NaN here too
            return data * keep.to(power.dtype)
        fill = torch.tensor(self._fill, dtype=data.dtype,
                            device=data.device)
        return torch.where(keep, data, fill)

    def task(self, data):
        n = self._n
        whole = (len(data) // n) * n
        if whole == len(data):
            return self._excise(data, n)
        head, tail = data[:whole], data[whole:]
        parts = []
        if whole:
            parts.append(self._excise(head, n))
        # judge the final partial block with its own, shorter M
        parts.append(self._excise(tail, len(tail)) if len(tail) >= 2
                     else tail)
        return torch.cat(parts) if len(parts) > 1 else parts[0]
