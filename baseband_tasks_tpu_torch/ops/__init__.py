"""Device ops: packed-sample decode, fold, the dedispersion kernels (the
three-pass chain and the single-pass resident form), the four-step FFT
and spectral filter (with its lane mixes and streaming form), the forward
polyphase filter bank, the acceleration search's bank correlations, and
short DFTs as matrix products."""

from .accel_correlate import accel_correlate_bank, bank_matmul_power
from .fold import fold_accumulate
from .dedisperse import (dedisperse_fold_split, dedisperse_fold_split_packed,
                         fold_phase_vector, split_n)
from .dedisperse_resident import dedisperse_fold_resident, resident_geometry
from .fft import fft_pow2_planes
from .pfb import pfb_forward_stream
from .spectral_filter import spectral_filter_pow2, spectral_filter_stream
from .unpack import VDIF_2BIT_LEVELS, pack_time_planes, plane_edges

__all__ = ["fold_accumulate", "dedisperse_fold_split",
           "dedisperse_fold_split_packed", "fold_phase_vector", "split_n",
           "fft_pow2_planes", "spectral_filter_pow2",
           "spectral_filter_stream", "pfb_forward_stream", "VDIF_2BIT_LEVELS",
           "pack_time_planes", "plane_edges", "accel_correlate_bank",
           "bank_matmul_power", "dedisperse_fold_resident",
           "resident_geometry"]
