"""Pulsar phase subsystem: two-double Phase, polycos, phase providers."""

from .phase import Phase, FractionalPhase
from .predictor import Polyco
from .pint_toas import PintToas
from .core import PolycoPhase, PintPhase

__all__ = ["Phase", "FractionalPhase", "Polyco", "PolycoPhase",
           "PintPhase", "PintToas"]
