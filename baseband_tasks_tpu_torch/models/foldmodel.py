"""Host-side drifting-phase fold model for the fused pipeline.

Counterpart of ``baseband_tasks_tpu/models/foldmodel.py``.  The fold
kernel bins pulse phase with a fixed-point linear map
frac(t) = ((i0_fx + t·p_fx) mod 2^31) / 2^31 cycles.  Per block,
:class:`FoldModel` linearizes a phase model (e.g. a polyco) at full host
precision (two-double Phase arithmetic) and re-encodes it as a fresh
``[i0_fx, p_fx, 0]`` row:

- ``p_fx`` = round(frac(cycles-per-sample)·2^31), at most 2^-32
  cycle/sample off, re-evaluated every block so never cumulative;
- ``i0_fx`` = round(frac(φ₀)·2^31) from the phase at the block's first
  sample.

The rows are int64 and go to the device as integers; the JAX package's
16-bit halves existed only for its float32-only transfer boundary.
"""

from __future__ import annotations

import numpy as np

from ..integration import _phase_to_cycles
from ..ops.dedisperse import fold_phase_vector
from ..utils import units as u
from ..utils.time import TimeDelta

__all__ = ["FoldModel"]


class FoldModel:
    """Per-block fixed-point fold parameters from a phase callable.

    Parameters
    ----------
    phase : callable
        ``phase(t) -> Phase`` plus ``apparent_spin_freq(t) -> Quantity``
        (e.g. :class:`~baseband_tasks_tpu_torch.phases.PolycoPhase`).
    start_time : Time
        Time of global sample 0 of the (channelized) stream being folded.
    sample_rate : Quantity
        Per-channel complex sample rate.
    n_phase : int
        Phase bins the kernel will use (<= 2^15).
    """

    def __init__(self, phase, start_time, sample_rate, n_phase=64):
        if not 0 < int(n_phase) <= (1 << 15):
            raise ValueError(f"n_phase={n_phase} must be in [1, 32768]")
        self.phase = phase
        self.start_time = start_time
        self.sample_rate = sample_rate
        self._rate = float(sample_rate.to_value(u.Hz))

    def _time_at(self, offset):
        # two-double time arithmetic: offset/rate split into hi+lo
        hi = offset / self._rate
        lo = (offset - hi * self._rate) / self._rate
        return self.start_time + TimeDelta.from_sec(hi, lo)

    def foldv(self, offset, n_window):
        """(3,) int64 ``[i0_fx, p_fx, 0]`` for a block of ``n_window``
        valid samples starting at global sample ``offset``.

        The phase is linearized about the block start using the apparent
        spin frequency at mid-block; the pipeline step subtracts the pad
        offset before the kernel.
        """
        t_mid = self._time_at(offset + n_window / 2)
        f_app = float(np.atleast_1d(
            self.phase.apparent_spin_freq(t_mid).to_value(u.Hz))[0])
        a1 = f_app / self._rate                    # cycles per sample
        hi, lo = _phase_to_cycles(self.phase(self._time_at(offset)))
        hi = float(np.atleast_1d(hi)[0])
        lo = float(np.atleast_1d(lo)[0])
        frac0 = (hi - np.floor(hi)) + lo
        frac0 -= np.floor(frac0)
        return fold_phase_vector(frac0, a1).astype(np.int64)

    def table(self, offsets, n_window):
        """(len(offsets), 3) int64 fold table, one row per block."""
        return np.stack([self.foldv(off, n_window) for off in offsets])
