"""Pulse times of arrival from folded profiles: template matching.

Counterpart of ``baseband_tasks_tpu/timing.py``: host numpy on the port's
own ``Time`` and units.  The step after folding in every pulsar-timing
pipeline (PSRCHIVE's ``pat``): fit a folded profile against a high-S/N
template by the FFT phase-gradient method (Taylor 1992) and convert the
fitted pulse phase to a time of arrival with two-double precision.

Beyond the upstream baseband-tasks, which stops at folded profiles
(integration.py Fold); this closes the loop to the timing models the
phases subsystem consumes (Polyco/PINT), so simulate → fold → TOA →
timing-model residuals runs end to end in one framework.

The model is ``profile(i) ≈ b + a · template(i - shift)``.  In the
Fourier domain the shift is a phase ramp, so the fit is: locate the
cross-correlation peak (FFT, zero-padded for sub-bin resolution),
refine with a few Newton steps on the exact Fourier-domain objective,
and estimate the uncertainty from the Fisher information (template
curvature over the noise level).
"""

from __future__ import annotations

import numpy as np

from .utils import units as u
from .utils.dtypes import to_numpy

__all__ = ["ProfileTemplate", "fit_phase_shift"]


def fit_phase_shift(profile, template, *, oversample=16):
    """Fit ``profile(i) ≈ b + a · template(i - shift)`` for the shift.

    Parameters
    ----------
    profile, template : array (n_bin,)
        Folded pulse profiles (same binning; tensors are brought to the
        host).
    oversample : int
        Zero-padding factor for the initial cross-correlation peak
        search (the Newton refinement then converges from within half
        an oversampled bin).

    Returns
    -------
    shift, shift_err : float
        Best-fit shift and its 1-sigma uncertainty, in (fractional)
        bins of the profile; positive shift = profile is the template
        delayed by that many bins.
    scale, baseline : float
        Fitted amplitude ``a`` and offset ``b``.
    snr : float
        Fit signal-to-noise (scale over its uncertainty).
    """
    p = np.asarray(to_numpy(profile), dtype=np.float64)
    t = np.asarray(to_numpy(template), dtype=np.float64)
    if p.shape != t.shape or p.ndim != 1:
        raise ValueError("profile and template must be equal-length 1-D")
    n = p.size
    if n < 4:
        raise ValueError("need at least 4 phase bins")
    P = np.fft.rfft(p)
    T = np.fft.rfft(t)
    k = np.arange(P.size)
    # bin 0 is the baseline; exclude it from the shift fit entirely
    Pk = P[1:]
    Tk = T[1:]
    kk = k[1:].astype(np.float64)
    w = 2.0 * np.pi * kk / n

    # initial shift: peak of the (oversampled) circular cross-correlation
    m = n * int(oversample)
    xspec = np.zeros(m // 2 + 1, dtype=np.complex128)
    xspec[1:P.size] = Pk * np.conj(Tk)
    xc = np.fft.irfft(xspec, n=m)
    i0 = int(np.argmax(xc))
    # parabolic sub-sample refinement on the oversampled grid
    y0, y1, y2 = xc[(i0 - 1) % m], xc[i0], xc[(i0 + 1) % m]
    denom = y0 - 2.0 * y1 + y2
    frac = 0.5 * (y0 - y2) / denom if denom != 0 else 0.0
    shift = (i0 + frac) * n / m

    # Newton refinement of C(s) = sum_k Re(P conj(T) e^{+i w s}) — with
    # the model P_k = a T_k e^{-i w s}, C peaks at the least-squares s
    g = Pk * np.conj(Tk)
    for _ in range(8):
        ph = np.exp(1j * w * shift)
        d1 = np.sum(np.real(1j * w * g * ph))
        d2 = np.sum(np.real(-(w ** 2) * g * ph))
        if d2 >= 0:  # not a maximum; keep the grid estimate
            break
        step = d1 / d2
        shift -= step
        if abs(step) < 1e-12:
            break
    shift = float((shift + n / 2) % n - n / 2)  # wrap to [-n/2, n/2)

    # amplitude/baseline at the fitted shift
    ph = np.exp(1j * w * shift)
    tt = np.sum(np.abs(Tk) ** 2)
    scale = float(np.sum(np.real(g * ph)) / tt)
    baseline = float((P[0].real - scale * T[0].real) / n)

    # noise from the residual spectrum; Fisher errors (Taylor 1992)
    resid = Pk - scale * Tk * np.conj(ph)
    dof = max(2 * resid.size - 3, 1)
    sigma2 = float(np.sum(np.abs(resid) ** 2) / dof)  # per rfft bin (n/2 ×)
    curv = 2.0 * scale ** 2 * np.sum(w ** 2 * np.abs(Tk) ** 2)
    shift_err = float(np.sqrt(sigma2 / curv)) if curv > 0 else np.inf
    scale_err2 = sigma2 / (2.0 * tt)
    snr = float(scale / np.sqrt(scale_err2)) if scale_err2 > 0 else np.inf
    return shift, shift_err, scale, baseline, snr


class ProfileTemplate:
    """TOA extraction against a fixed template profile.

    Parameters
    ----------
    template : array (n_bin,)
        High-S/N standard profile; phase bin 0 is the fiducial point
        (phase 0 of the timing model used for folding).

    Notes
    -----
    :meth:`toa` assumes profiles were folded with phase bin ``j``
    covering pulse phases ``[j, j+1) / n_bin`` (the convention of
    `~baseband_tasks_tpu_torch.integration.Fold` and the fused fold kernels).
    """

    def __init__(self, template):
        self.template = np.asarray(to_numpy(template), dtype=np.float64)
        if self.template.ndim != 1:
            raise ValueError("template must be 1-D (phase bins)")

    def phase_shift(self, profile, **kwargs):
        """Fitted pulse-phase offset of ``profile`` vs the template, in
        cycles, with its 1-sigma error: ``(dphi, dphi_err, snr)``."""
        n = self.template.size
        shift, err, scale, base, snr = fit_phase_shift(
            profile, self.template, **kwargs)
        return shift / n, err / n, snr

    def toa(self, profile, *, time, folded_phase, period, **kwargs):
        """Time of arrival of the pulse nearest ``time``.

        Parameters
        ----------
        profile : array (n_bin,)
            Folded profile to fit.
        time : `~baseband_tasks_tpu_torch.utils.Time`
            Reference time of the fold (e.g. the mid-point of the
            integration).
        folded_phase : Phase-like or float
            Pulse phase of the timing model at ``time`` (e.g.
            ``PolycoPhase(...)(time)``); only its fractional part
            matters.
        period : Quantity
            Apparent pulse period at ``time`` (e.g. from
            ``1 / apparent_spin_freq(time)``).

        Returns
        -------
        toa : Time
            Arrival time: the instant nearest ``time`` at which the
            timing model phase plus the fitted offset is integer.
        toa_err : Quantity
            1-sigma uncertainty.
        snr : float
            Fit signal-to-noise.
        """
        dphi, dphi_err, snr = self.phase_shift(profile, **kwargs)
        frac = getattr(folded_phase, "fraction", None)
        if frac is None:
            frac = np.asarray(folded_phase, dtype=np.float64) % 1.0
        frac = float(frac) % 1.0
        # total phase of the fitted pulse peak relative to `time`;
        # choose the integer-phase crossing nearest zero
        phi = (frac + dphi + 0.5) % 1.0 - 0.5
        p_s = period.to_value(u.s)
        toa = time - u.Quantity(phi * p_s, u.s)
        return toa, u.Quantity(abs(dphi_err) * p_s, u.s), snr
