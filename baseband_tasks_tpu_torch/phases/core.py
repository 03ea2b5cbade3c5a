"""Phase-callable providers for folding: polyco-backed.

Counterpart of ``baseband_tasks_tpu/phases/core.py``: ``PolycoPhase``
exposes ``__call__(t) -> Phase`` and ``apparent_spin_freq(t) -> Quantity``
(upstream baseband_tasks/phases/core.py:86).  The PINT-backed provider is
not ported yet.
"""

from __future__ import annotations

from .predictor import Polyco

__all__ = ["PolycoPhase"]


class PolycoPhase:
    """Phase and apparent spin frequency from a tempo polyco file."""

    def __init__(self, polyco):
        self.polyco = polyco if isinstance(polyco, Polyco) else Polyco(polyco)

    def __call__(self, t):
        return self.polyco(t)

    def apparent_spin_freq(self, t):
        return self.polyco(t, deriv=1)
