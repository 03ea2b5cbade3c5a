"""Compiled pipelines: the flagship dedisperse→detect→fold model."""

from .foldmodel import FoldModel
from .wideband import WidebandPulsarPipeline

__all__ = ["FoldModel", "WidebandPulsarPipeline"]
