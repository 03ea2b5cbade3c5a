"""Default device FFT engine on ``torch.fft`` (registered as 'xla').

Counterpart of ``baseband_tasks_tpu/fourier/xla.py``, keeping its
registry name so that ``fft_maker.set('xla')`` selects the default
engine on both sides.  On a CUDA tensor ``torch.fft`` runs cuFFT, as the
JAX engine left its transforms to XLA.  (The JAX engine's short-n DFT
matmul branch is a TPU workaround and has no counterpart here.)
"""

from __future__ import annotations

import torch

from ..utils.dtypes import as_tensor, torch_dtype
from .base import FFTBase, FFTMakerBase

__all__ = ["XLAFFTMaker", "XLAFFTBase"]


class XLAFFTBase(FFTBase):
    """One planned transform executing on the data's device via
    ``torch.fft``."""

    def _input(self, data):
        """``data`` as a tensor of the dtype this direction expects."""
        expected = (self._time_dtype if self._direction == "forward"
                    else self._frequency_dtype)
        return as_tensor(data, dtype=expected)

    def _fft(self, data):
        data = self._input(data)
        norm = "ortho" if self._ortho else "backward"
        axis = self._axis
        if self._direction == "forward":
            fn = torch.fft.rfft if self.real_input else torch.fft.fft
            return fn(data, dim=axis, norm=norm)
        if self.real_input:
            out = torch.fft.irfft(data, n=self._time_shape[axis], dim=axis,
                                  norm=norm)
            return out.to(torch_dtype(self._time_dtype))
        return torch.fft.ifft(data, dim=axis, norm=norm)


class XLAFFTMaker(FFTMakerBase):
    """Engine factory for device FFTs (registered as 'xla')."""

    _fft_class = XLAFFTBase
