"""PyTorch/CUDA port of baseband_tasks_tpu: the flagship slice.

Coherent dedispersion -> detection -> pulse-phase fold of channelized,
plane-packed baseband, through hand-written CUDA kernels for NVIDIA
Hopper (``csrc/``) on a CUDA device and their plain PyTorch versions on
the CPU.  Importing the package imports torch and numpy only; the
kernels are built with ``nvcc`` at their first launch.
"""

from .dm import DispersionMeasure
from .models import WidebandPulsarPipeline
from .phases import Polyco, PolycoPhase
from .utils import Time, units

__all__ = ["WidebandPulsarPipeline", "DispersionMeasure", "Time", "units",
           "Polyco", "PolycoPhase"]
