"""Pulsar phase subsystem: two-double Phase, polycos, phase providers."""

from .phase import Phase, FractionalPhase
from .predictor import Polyco
from .core import PolycoPhase

__all__ = ["Phase", "FractionalPhase", "Polyco", "PolycoPhase"]
