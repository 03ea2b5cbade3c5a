"""Compiled pipelines: the flagship dedisperse→detect→fold model,
compiled stream graphs with their kernel fusions (``CompiledPipeline``,
``stream.compile()``) and their prefetching executor (``StreamRunner``),
the period searches (the Fourier-domain acceleration search and the fast
folding algorithm), the FX correlator and the tied-array beamformer."""

from .accelsearch import FourierDomainAccelSearch, accel_template
from .beamform import BeamformStations, tied_array_beam
from .compiled import CompiledPipeline, carry_from_numpy
from .correlator import CrossMultiply, fx_correlate
from .ffa import FastFoldingSearch, ffa_fold
from .foldmodel import FoldModel
from .runner import StreamRunner
from .view import CompiledStreamView, compile_stream
from .wideband import WidebandPulsarPipeline

__all__ = ["CompiledPipeline", "CompiledStreamView", "FoldModel",
           "WidebandPulsarPipeline", "carry_from_numpy", "compile_stream",
           "FourierDomainAccelSearch", "accel_template",
           "FastFoldingSearch", "ffa_fold", "CrossMultiply",
           "fx_correlate", "BeamformStations", "tied_array_beam",
           "StreamRunner"]
