"""Phase-callable providers for folding: polyco- and PINT-backed.

Counterpart of ``baseband_tasks_tpu/phases/core.py``: ``PolycoPhase`` and
``PintPhase`` expose ``__call__(t) -> Phase`` and
``apparent_spin_freq(t) -> Quantity`` (upstream baseband_tasks
phases/core.py:16, :86).  PINT is an optional dependency; ``PintPhase``
raises a clear ImportError at construction when it is missing.
"""

from __future__ import annotations

import numpy as np

from ..utils import units as u
from .phase import Phase
from .predictor import Polyco

__all__ = ["PolycoPhase", "PintPhase"]


class PolycoPhase:
    """Phase and apparent spin frequency from a tempo polyco file."""

    def __init__(self, polyco):
        self.polyco = polyco if isinstance(polyco, Polyco) else Polyco(polyco)

    def __call__(self, t):
        return self.polyco(t)

    def apparent_spin_freq(self, t):
        return self.polyco(t, deriv=1)


class PintPhase:
    """Phase via a PINT timing model (.par file).

    Requires the optional ``pint-pulsar`` package (~10 ns precision).
    Arguments mirror the upstream package: ``par_file``, ``observatory``,
    ``frequency``, plus ``**kwargs`` forwarded to the TOA builder
    (:class:`~.pint_toas.PintToas`).
    """

    def __init__(self, par_file, observatory, frequency, **kwargs):
        try:
            import pint.models
        except ImportError as exc:
            raise ImportError(
                "PintPhase requires the 'pint-pulsar' package, which is not "
                "installed; use PolycoPhase with a polyco file instead."
            ) from exc
        from .pint_toas import PintToas
        self.par_file = par_file
        self.model = pint.models.get_model(par_file)
        self.toa_maker = PintToas(observatory, frequency, **kwargs)

    def __call__(self, t):
        toas = self.toa_maker(t)
        ph = self.model.phase(toas)
        return Phase(np.asarray(ph.int), np.asarray(ph.frac))

    def apparent_spin_freq(self, t):
        toas = self.toa_maker(t)
        f = self.model.d_phase_d_toa(toas)
        return u.Quantity(np.asarray(f.to_value("Hz")), u.Hz)
