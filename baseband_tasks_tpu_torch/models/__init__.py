"""Compiled pipelines: the flagship dedisperse→detect→fold model,
compiled stream chains with their kernel fusions (``CompiledPipeline``,
``stream.compile()``), and the period searches (the Fourier-domain
acceleration search and the fast folding algorithm)."""

from .accelsearch import FourierDomainAccelSearch, accel_template
from .compiled import CompiledPipeline, carry_from_numpy
from .ffa import FastFoldingSearch, ffa_fold
from .foldmodel import FoldModel
from .view import CompiledStreamView, compile_stream
from .wideband import WidebandPulsarPipeline

__all__ = ["CompiledPipeline", "CompiledStreamView", "FoldModel",
           "WidebandPulsarPipeline", "carry_from_numpy", "compile_stream",
           "FourierDomainAccelSearch", "accel_template",
           "FastFoldingSearch", "ffa_fold"]
