"""Compiled pipelines: the flagship dedisperse→detect→fold model,
compiled stream graphs with their kernel fusions (``CompiledPipeline``,
``stream.compile()``), their time-sharded executor (``ShardedPipeline``)
and their prefetching executor (``StreamRunner``),
the period searches (the Fourier-domain acceleration search and the fast
folding algorithm), the FX correlator and the tied-array beamformer, and
the analysis models beyond the reference: the DM-trial search, RM
synthesis and the secondary spectrum."""

from .accelsearch import FourierDomainAccelSearch, accel_template
from .beamform import BeamformStations, tied_array_beam
from .compiled import CompiledPipeline, carry_from_numpy
from .correlator import CrossMultiply, fx_correlate
from .dmsearch import DMTrialSearch
from .ffa import FastFoldingSearch, ffa_fold
from .foldmodel import FoldModel
from .rmsearch import RMSynthesis
from .runner import StreamRunner
from .scintillation import SecondarySpectrum, secondary_spectrum
from .sharded import ShardedPipeline
from .view import CompiledStreamView, compile_stream
from .wideband import WidebandPulsarPipeline

__all__ = ["CompiledPipeline", "CompiledStreamView", "FoldModel",
           "WidebandPulsarPipeline", "carry_from_numpy", "compile_stream",
           "FourierDomainAccelSearch", "accel_template",
           "FastFoldingSearch", "ffa_fold", "CrossMultiply",
           "fx_correlate", "BeamformStations", "tied_array_beam",
           "StreamRunner", "DMTrialSearch", "RMSynthesis",
           "SecondarySpectrum", "secondary_spectrum", "ShardedPipeline"]
