"""FFT engines: 'xla' (torch.fft, the default), 'pallas' (the four-step
kernels) and 'numpy' (host)."""

from .base import (FFTBase, FFTMakerBase, FFTMakerMeta, fft_maker,
                   FFT_MAKER_CLASSES, next_fast_len)
from .numpy import NumpyFFTMaker, NumpyFFTBase
from .xla import XLAFFTMaker, XLAFFTBase
from .pallas import PallasFFTMaker, PallasFFTBase

__all__ = ["FFTBase", "FFTMakerBase", "FFTMakerMeta", "fft_maker",
           "FFT_MAKER_CLASSES", "next_fast_len", "NumpyFFTMaker",
           "NumpyFFTBase", "XLAFFTMaker", "XLAFFTBase", "PallasFFTMaker",
           "PallasFFTBase"]
