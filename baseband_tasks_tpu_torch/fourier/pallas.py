"""Four-step FFT engine on the hand-written kernels (registered as
'pallas').

Counterpart of ``baseband_tasks_tpu/fourier/pallas.py``: select it with
``fft_maker.set('pallas')`` (context-manageable) and every task built and
read under it plans transforms this way:

* power-of-two complex64 transforms of n >= 512 over >= 8 lanes run
  ``ops/fft.fft_pow2_planes``: the kernels k1_window -> k2_fwd forward,
  k2_inv -> k3_trim inverse, on a CUDA device (their plain versions on
  the CPU);
* any other shape is the 'xla' engine's (``torch.fft``), as in the JAX
  package: that is the engine's definition, not a fallback.

Tests hold the kernels against their plain versions on a card inside
the test-only ``ops.dedisperse.plain_versions()``.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import FFTMakerBase, next_fast_len as smooth_len
from .xla import XLAFFTBase

__all__ = ["PallasFFTMaker", "PallasFFTBase"]

#: the four-step kernels take complex64 transforms of n >= MIN_N (a
#: power of two) over >= MIN_LANES lanes
MIN_N = 512
MIN_LANES = 8


class PallasFFTBase(XLAFFTBase):
    """One planned transform: the four-step kernels when the shape
    qualifies (:attr:`_use_pallas`), otherwise exactly the 'xla' engine."""

    @property
    def _use_pallas(self):
        n = self._time_shape[self._axis]
        lanes = int(np.prod(self._time_shape)) // max(n, 1)
        return (self._time_dtype == np.dtype("complex64")
                and n >= MIN_N and (n & (n - 1)) == 0
                and lanes >= MIN_LANES)

    def _fft(self, data):
        if not self._use_pallas:
            return super()._fft(data)
        from ..ops.fft import fft_pow2_planes
        x = torch.movedim(self._input(data), self._axis, 0)
        n = x.shape[0]
        batch_shape = tuple(x.shape[1:])
        x2 = x.reshape(n, -1)
        yr, yi = fft_pow2_planes(
            x2.real.contiguous(), x2.imag.contiguous(),
            inverse=self._direction != "forward", ortho=self._ortho)
        out = torch.complex(yr, yi).reshape((n,) + batch_shape)
        return torch.movedim(out, 0, self._axis)


class PallasFFTMaker(FFTMakerBase):
    """Engine factory for the four-step FFT (registered 'pallas')."""

    _fft_class = PallasFFTBase

    @staticmethod
    def next_fast_len(n):
        """Prefer a power of two (the four-step kernels require it) when
        it costs at most 12.5 % extra length over the 2/3/5-smooth size;
        otherwise keep the smooth size (whose transform is then the 'xla'
        engine's)."""
        s = smooth_len(n)
        if n > MIN_N:
            p2 = 1 << (n - 1).bit_length()
            if p2 <= s * 1.125:
                return p2
        return s
