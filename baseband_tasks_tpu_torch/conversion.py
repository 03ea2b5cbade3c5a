"""Real-to-complex baseband conversion.

Counterpart of ``baseband_tasks_tpu/conversion.py`` (``Real2Complex``):
the analytic signal by ``torch.fft`` (one-sided spectrum, inverse FFT),
downshifted by a quarter of the sample rate to centre the band and
decimated by two; the frequency label moves to the band centre.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TaskBase, getattr_if_none

__all__ = ["Real2Complex"]


class Real2Complex(TaskBase):
    """Convert a real baseband stream to complex at half the sample rate."""

    def __init__(self, ih, *, samples_per_frame=None, frequency=None,
                 sideband=None):
        if ih.dtype.kind == "c":
            raise ValueError("Real2Complex requires real-valued input.")
        frequency = getattr_if_none(ih, "frequency", frequency,
                                    required=False)
        sideband = getattr_if_none(ih, "sideband", sideband, required=False)
        if frequency is not None and sideband is not None:
            # the real band [f, f + sb*B/2] -> a complex label at its centre
            frequency = frequency + np.asarray(sideband) \
                * (ih.sample_rate / 4)
        if samples_per_frame is None:
            spf_in = getattr(ih, "samples_per_frame", 2)
            samples_per_frame = max(spf_in // 2, 1)
        super().__init__(ih, ih_samples_per_frame=2 * samples_per_frame,
                         samples_per_frame=samples_per_frame,
                         sample_rate=ih.sample_rate / 2,
                         dtype=np.complex64, frequency=frequency,
                         sideband=sideband)

    def task(self, data):
        x = data.to(torch.float32)
        n = x.shape[0]
        X = torch.fft.fft(x.to(torch.complex64), dim=0)
        k = torch.arange(n, device=x.device)
        weight = torch.where(k == 0, 1.0, torch.where(
            k < n // 2, 2.0, torch.where(k == n // 2, 1.0, 0.0)))
        weight = weight.to(torch.float32).reshape((-1,) + (1,) * (x.ndim - 1))
        a = torch.fft.ifft(X * weight, dim=0)       # the analytic signal
        z = a[::2]
        # downshift by rate/4: exp(-2πi (n/4) t) at even t is (-1)^m
        m = torch.arange(z.shape[0], device=x.device)
        sign = torch.where(m % 2 == 0, 1.0, -1.0).to(torch.float32)
        return (z * sign.reshape((-1,) + (1,) * (x.ndim - 1))).to(
            torch.complex64)
