"""Compiled pipelines: the flagship dedisperse→detect→fold model, and
compiled stream chains with their kernel fusions (``CompiledPipeline``,
``stream.compile()``)."""

from .compiled import CompiledPipeline, carry_from_numpy
from .foldmodel import FoldModel
from .view import CompiledStreamView, compile_stream
from .wideband import WidebandPulsarPipeline

__all__ = ["CompiledPipeline", "CompiledStreamView", "FoldModel",
           "WidebandPulsarPipeline", "carry_from_numpy", "compile_stream"]
