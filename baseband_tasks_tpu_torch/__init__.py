"""PyTorch/CUDA port of baseband_tasks_tpu.

The slices so far:

- the flagship: coherent dedispersion -> detection -> pulse-phase fold
  of channelized, plane-packed baseband (``WidebandPulsarPipeline``);
- the lazy stream-task core (``Base``/``TaskBase``/``PaddedTaskBase``,
  generators, shaping, ``Channelize``/``Dechannelize``, ``Square``/
  ``Power``) on the three-engine ``fourier`` layer, with coherent
  ``Disperse``/``Dedisperse``;
- compiled chains (``CompiledPipeline``, ``stream.compile()``) with
  their kernel fusions, and the polyphase filter bank and its Wiener
  inversion (``PolyphaseFilterBank``, ``InversePolyphaseFilterBank``);
- the period searches: the Fourier-domain acceleration search
  (``FourierDomainAccelSearch``) and the fast folding algorithm
  (``FastFoldingSearch``), and the single-pass resident dedisperse ->
  fold op (``ops.dedisperse_fold_resident``).

Frames are torch tensors on the stream's device (the card when there is
one, unless a source is given another).  On a CUDA device the
FFT and filter passes run hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``); on the CPU their plain PyTorch versions.  Importing the
package imports torch and numpy only; the kernels are built with
``nvcc`` at their first launch.
"""

from .base import (Base, BaseTaskBase, TaskBase, PaddedTaskBase, Task,
                   SetAttribute)
from .channelize import Channelize, Dechannelize
from .dispersion import Disperse, Dedisperse
from .dm import DispersionMeasure
from .fourier import fft_maker
from .functions import Square, Power
from .generators import (StreamGenerator, EmptyStreamGenerator, Noise,
                         NoiseGenerator)
from .models import (CompiledPipeline, FastFoldingSearch,
                     FourierDomainAccelSearch, WidebandPulsarPipeline)
from .pfb import (InversePolyphaseFilterBank, PolyphaseFilterBank,
                  PolyphaseFilterBankSamples, sinc_hamming)
from .phases import Polyco, PolycoPhase
from .shaping import (ChangeSampleShape, Reshape, Transpose,
                      ReshapeAndTranspose, GetItem, GetSlice)
from .utils import Time, units

__all__ = ["Base", "BaseTaskBase", "TaskBase", "PaddedTaskBase", "Task",
           "SetAttribute", "StreamGenerator", "EmptyStreamGenerator",
           "Noise", "NoiseGenerator", "Channelize", "Dechannelize",
           "Square", "Power", "ChangeSampleShape", "Reshape", "Transpose",
           "ReshapeAndTranspose", "GetItem", "GetSlice", "Disperse",
           "Dedisperse", "DispersionMeasure", "fft_maker",
           "WidebandPulsarPipeline", "CompiledPipeline",
           "PolyphaseFilterBank", "PolyphaseFilterBankSamples",
           "InversePolyphaseFilterBank", "sinc_hamming", "Time", "units",
           "Polyco", "PolycoPhase", "FourierDomainAccelSearch",
           "FastFoldingSearch"]
