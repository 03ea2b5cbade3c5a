"""Host numpy FFT engine (registered as 'numpy'): for host-side reference
computations and cross-checks.

Counterpart of ``baseband_tasks_tpu/fourier/numpy.py``.  A tensor comes
back as a tensor on its own device; anything else as a numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.dtypes import to_numpy
from .base import FFTBase, FFTMakerBase

__all__ = ["NumpyFFTMaker", "NumpyFFTBase"]


class NumpyFFTBase(FFTBase):
    def _fft(self, data):
        device = data.device if torch.is_tensor(data) else None
        data = to_numpy(data)
        norm = "ortho" if self._ortho else None
        axis = self._axis
        if self._direction == "forward":
            if self.real_input:
                out = np.fft.rfft(data, axis=axis, norm=norm)
            else:
                out = np.fft.fft(data, axis=axis, norm=norm)
            out = out.astype(self._frequency_dtype, copy=False)
        else:
            if self.real_input:
                out = np.fft.irfft(data, n=self._time_shape[axis], axis=axis,
                                   norm=norm)
            else:
                out = np.fft.ifft(data, axis=axis, norm=norm)
            out = out.astype(self._time_dtype, copy=False)
        return out if device is None else torch.from_numpy(out).to(device)


class NumpyFFTMaker(FFTMakerBase):
    """Engine factory for host FFTs (registered as 'numpy')."""

    _fft_class = NumpyFFTBase
