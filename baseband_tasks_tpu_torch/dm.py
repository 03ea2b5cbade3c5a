"""Dispersion measure and the cold-plasma dispersion relations.

Counterpart of `upstream baseband_tasks/dm.py`: a dispersion-measure
quantity with ``time_delay``, ``phase_delay`` and ``phase_factor`` methods
using the Tempo/psrchive convention for the dispersion constant
(1 / 2.41e-4 MHz² s / (pc cm⁻³), dm.py:37).

Host-side: these produce numpy chirp arrays at graph-build time; the chirp
itself is uploaded to the device once and cached
(models/wideband.py).
"""

from __future__ import annotations

import numpy as np

from .utils import units as u

__all__ = ["DispersionMeasure", "dispersion_delay_constant"]

#: Tempo convention: delay = DM / (2.41e-4 MHz^2 / s) * f^-2.
dispersion_delay_constant = u.Quantity(1.0 / 2.41e-4,
                                       u.s * u.MHz ** 2 / u.DM)


class DispersionMeasure(u.Quantity):
    """Dispersion measure (pc / cm³) with delay/phase evaluation.

    Examples
    --------
    >>> from baseband_tasks_tpu_torch.dm import DispersionMeasure
    >>> from baseband_tasks_tpu_torch.utils import units as u
    >>> dm = DispersionMeasure(29.1168)  # PSR B1957+20
    >>> print(f"{dm.time_delay(300 * u.MHz).to_value(u.s):.6f}")
    1.342407
    >>> dt = dm.time_delay(300 * u.MHz, 310 * u.MHz)
    >>> print(f"{dt.to_value(u.ms):.4f}")
    85.2100
    """

    def __init__(self, value, unit=None):
        if unit is None:
            unit = u.DM if not isinstance(value, u.Quantity) else None
        super().__init__(value, unit)
        if not self.unit.is_equivalent(u.DM):
            raise u.UnitsError(
                f"dispersion measure needs pc/cm3-equivalent units, got "
                f"{self.unit}")

    def time_delay(self, frequency, reference_frequency=None):
        """Time delay of ``frequency`` relative to ``reference_frequency``
        (or to infinite frequency if not given)."""
        d = dispersion_delay_constant * self
        delay = d / (frequency ** 2)
        if reference_frequency is not None:
            delay = delay - d / (reference_frequency ** 2)
        return delay.to(u.s)

    def phase_delay(self, frequency, reference_frequency=None):
        """Phase rotation (cycles) of ``frequency`` relative to
        ``reference_frequency`` for coherent dedispersion.

        phi = d * f * (1/f_ref - 1/f)**2 cycles (reference dm.py:78-104),
        the quadratic-in-offset phase of the cold-plasma transfer
        function; with no reference frequency, relative to infinite
        frequency (1/f_ref -> 0), i.e. phi = d / f.
        """
        d = dispersion_delay_constant * self * u.cycle
        inv_ref = (0.0 / u.MHz if reference_frequency is None
                   else 1.0 / reference_frequency)
        phase = d * frequency * (inv_ref - 1.0 / frequency) ** 2
        return phase.to(u.cycle)

    def phase_factor(self, frequency, reference_frequency=None):
        """Complex chirp factor exp(i * 2 pi * phase_delay) (dm.py:107)."""
        phase = self.phase_delay(frequency, reference_frequency)
        return np.exp(1j * phase.to_value(u.rad)).astype(np.complex64)
