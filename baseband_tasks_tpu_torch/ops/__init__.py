"""Device ops: packed-sample decode, fold, and the dedispersion kernels."""

from .fold import fold_accumulate
from .dedisperse import (dedisperse_fold_split, dedisperse_fold_split_packed,
                         fold_phase_vector, split_n)
from .unpack import VDIF_2BIT_LEVELS, pack_time_planes, plane_edges

__all__ = ["fold_accumulate", "dedisperse_fold_split",
           "dedisperse_fold_split_packed", "fold_phase_vector", "split_n",
           "VDIF_2BIT_LEVELS", "pack_time_planes", "plane_edges"]
