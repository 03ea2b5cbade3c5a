"""Device ops: packed-sample decode, fold, the dedispersion kernels, and
the four-step FFT and spectral filter."""

from .fold import fold_accumulate
from .dedisperse import (dedisperse_fold_split, dedisperse_fold_split_packed,
                         fold_phase_vector, split_n)
from .fft import fft_pow2_planes
from .spectral_filter import spectral_filter_pow2
from .unpack import VDIF_2BIT_LEVELS, pack_time_planes, plane_edges

__all__ = ["fold_accumulate", "dedisperse_fold_split",
           "dedisperse_fold_split_packed", "fold_phase_vector", "split_n",
           "fft_pow2_planes", "spectral_filter_pow2", "VDIF_2BIT_LEVELS",
           "pack_time_planes", "plane_edges"]
