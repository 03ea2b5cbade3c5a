"""PyTorch/CUDA port of baseband_tasks_tpu.

The slices so far:

- the flagship: coherent dedispersion -> detection -> pulse-phase fold
  of channelized, plane-packed baseband (``WidebandPulsarPipeline``),
  and its split ops' bf16-intermediate mode;
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
  fold op (``ops.dedisperse_fold_resident``);
- integration over time or pulse phase (``Integrate``, ``Fold``,
  ``PulseStack``), eager and absorbed into compiled chains;
- convolution (``Convolve``, ``ConvolveSamples``), resampling and delays
  (``ShiftAndResample``, ``Resample``, ``TimeDelay``, ``ShiftSamples``),
  incoherent ``DisperseSamples``/``DedisperseSamples``, the joins
  (``CombineStreams``, ``Concatenate``, ``Stack``) with multi-input
  compiled graphs, ``Real2Complex``, and on them the FX correlator and
  the tied-array beamformer (``models.fx_correlate``,
  ``models.tied_array_beam``);
- stored baseband: VDIF, Mark 5B, DADA and GUPPI readers and writers and
  multi-file sequences (``io``, ``open``, with the host LUT decoder
  ``native``), packed ingest decoded on the device
  (``CompiledPipeline(..., packed=True)``) and the prefetching executor
  ``models.StreamRunner`` (pinned buffers and a copy stream on the card);
- the tasks beyond the reference (``FaradayRotate``/``DeFaraday``,
  ``ConvertPolarization``/``ApplyJones``, ``SpectralKurtosis``/
  ``ExciseSpectralKurtosis``), TOAs from folded profiles
  (``ProfileTemplate``, ``fit_phase_shift``), the search models built on
  them (``models.DMTrialSearch``, ``models.RMSynthesis``,
  ``models.SecondarySpectrum``), SIGPROC filterbank files
  (``io.sigproc``), the profiling hooks (``utils.profiling``) and the
  PINT phase providers (``phases.PintPhase``, ``phases.PintToas``).

Frames are torch tensors on the stream's device (the card when there is
one, unless a source is given another).  On a CUDA device the
FFT and filter passes run hand-written CUDA kernels for NVIDIA Hopper
(``csrc/``); on the CPU their plain PyTorch versions.  Importing the
package imports torch and numpy only; the kernels are built with
``nvcc`` at their first launch.
"""

from . import io, native
from .base import (Base, BaseTaskBase, TaskBase, PaddedTaskBase, Task,
                   SetAttribute)
from .channelize import Channelize, Dechannelize
from .combining import CombineStreams, Concatenate, Stack
from .conversion import Real2Complex
from .convolution import Convolve, ConvolveSamples
from .dispersion import (Disperse, Dedisperse, DisperseSamples,
                         DedisperseSamples)
from .dm import DispersionMeasure
from .faraday import FaradayRotate, DeFaraday
from .fourier import fft_maker
from .functions import Square, Power
from .generators import (StreamGenerator, EmptyStreamGenerator, Noise,
                         NoiseGenerator)
from .integration import Fold, Integrate, PulseStack
from .models import (CompiledPipeline, FastFoldingSearch,
                     FourierDomainAccelSearch, StreamRunner,
                     WidebandPulsarPipeline)
from .pfb import (InversePolyphaseFilterBank, PolyphaseFilterBank,
                  PolyphaseFilterBankSamples, sinc_hamming)
from .phases import Polyco, PolycoPhase
from .polarization import ConvertPolarization, ApplyJones
from .registry import open
from .rfi import SpectralKurtosis, ExciseSpectralKurtosis
from .sampling import ShiftAndResample, Resample, TimeDelay, ShiftSamples
from .shaping import (ChangeSampleShape, Reshape, Transpose,
                      ReshapeAndTranspose, GetItem, GetSlice)
from .timing import ProfileTemplate, fit_phase_shift
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
           "FastFoldingSearch", "Integrate", "Fold", "PulseStack",
           "CombineStreams", "Concatenate", "Stack", "Convolve",
           "ConvolveSamples", "ShiftAndResample", "Resample", "TimeDelay",
           "ShiftSamples", "DisperseSamples", "DedisperseSamples",
           "Real2Complex", "open", "io", "native", "StreamRunner",
           "SpectralKurtosis", "ExciseSpectralKurtosis", "FaradayRotate",
           "DeFaraday", "ConvertPolarization", "ApplyJones",
           "ProfileTemplate", "fit_phase_shift"]
