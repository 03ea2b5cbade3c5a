"""Device ops: packed-sample decode, fold, the dedispersion kernels, the
four-step FFT and spectral filter (with its lane mixes and streaming
form), the forward polyphase filter bank, and short DFTs as matrix
products."""

from .fold import fold_accumulate
from .dedisperse import (dedisperse_fold_split, dedisperse_fold_split_packed,
                         fold_phase_vector, split_n)
from .fft import fft_pow2_planes
from .pfb import pfb_forward_stream
from .spectral_filter import spectral_filter_pow2, spectral_filter_stream
from .unpack import VDIF_2BIT_LEVELS, pack_time_planes, plane_edges

__all__ = ["fold_accumulate", "dedisperse_fold_split",
           "dedisperse_fold_split_packed", "fold_phase_vector", "split_n",
           "fft_pow2_planes", "spectral_filter_pow2",
           "spectral_filter_stream", "pfb_forward_stream", "VDIF_2BIT_LEVELS",
           "pack_time_planes", "plane_edges"]
