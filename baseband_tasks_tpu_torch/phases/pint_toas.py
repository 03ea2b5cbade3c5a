"""Time -> PINT TOAs conversion (optional dependency).

Counterpart of ``baseband_tasks_tpu/phases/pint_toas.py`` (itself the
counterpart of the upstream baseband-tasks' ``phases/pint_toas.py``),
host code on the port's own ``Time`` and units.  The whole block of times
is handed to ``pint.toa.get_TOAs_array`` in one vectorized call, as a
``(mjd_int, mjd_frac)`` two-double pair so the ~ns-level precision of
:class:`~baseband_tasks_tpu_torch.utils.Time` survives (PINT accepts MJD
2-tuples for exactly this purpose); PINT versions without the array API
take the upstream per-TOA path.  Constructing one needs pint installed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PintToas"]


class PintToas:
    """Callable turning Time arrays into one ``pint.toa.TOAs`` table.

    Parameters mirror the upstream package: observatory code, observing
    frequency (scalar or broadcastable against time shapes), solar-system
    ephemeris (``ephemeris``, or PINT's ``ephem`` spelling), BIPM clock
    settings, ``planets``, ``tdb_method``; extra keyword arguments are
    forwarded to ``get_TOAs_array``/``get_TOAs_list``.
    """

    def __init__(self, observatory, frequency, *, ephemeris="jpl",
                 ephem=None, include_bipm=True, bipm_version="BIPM2015",
                 planets=False, tdb_method="default", **kwargs):
        import pint.toa  # noqa: F401  (raises if pint missing)
        self.observatory = observatory
        self.frequency = frequency
        self.control_params = dict(
            ephem=ephem or ephemeris, include_bipm=include_bipm,
            bipm_version=bipm_version, planets=planets,
            tdb_method=tdb_method)
        self.control_params.update(kwargs)

    def _mjd_pair(self, t):
        """Time -> broadcast (int, frac) float64 MJD pair + freq in MHz.

        PINT's MJD 2-tuples are (integer day, fractional day); renormalize
        our free-form two-double pair accordingly (the fractional part
        keeps full float64 resolution, ~10 ps of a day).
        """
        from ..utils import units as u
        hi, lo = t.mjd_pair
        hi = np.atleast_1d(np.asarray(hi, dtype=np.float64))
        lo = np.atleast_1d(np.asarray(lo, dtype=np.float64))
        day = np.floor(hi)
        frac = (hi - day) + lo
        carry = np.floor(frac)
        day = day + carry
        frac = frac - carry
        freq = np.broadcast_to(
            np.asarray(self.frequency.to_value(u.MHz), dtype=np.float64),
            day.shape)
        return day, frac, freq

    def __call__(self, t):
        import pint.toa as toa
        hi, lo, freq = self._mjd_pair(t)
        if hasattr(toa, "get_TOAs_array"):
            return toa.get_TOAs_array(
                (hi, lo), obs=self.observatory, freqs=freq,
                **self.control_params)
        # old PINT: per-element TOA objects (the upstream package's path)
        toa_list = [toa.TOA((h, lw), obs=self.observatory, freq=f)
                    for h, lw, f in zip(hi.ravel(), lo.ravel(),
                                        freq.ravel())]
        return toa.get_TOAs_list(toa_list, **self.control_params)
