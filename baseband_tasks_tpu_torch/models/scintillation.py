"""Scintillometry: the secondary (delay-Doppler) spectrum of a dynamic
spectrum.

Counterpart of ``baseband_tasks_tpu/models/scintillation.py`` (beyond the
upstream baseband-tasks, which produces dynamic spectra but has no
scintillation analysis).  Interstellar scintillation imprints an
interference pattern on a pulsar's dynamic spectrum ``D(t, nu)``; its
2-D power spectrum, the **secondary spectrum**
``S(f_t, f_nu) = |FFT2(D)|^2`` with conjugate axes fringe rate (Hz) and
delay (s), concentrates that pattern into the parabolic arcs whose
curvature measures the screen distance and velocity (Stinebring et al.
2001).  A dynamic spectrum is ``Integrate(Square(Channelize(...)))``;
this module adds the analysis step: one 2-D real FFT (``torch.fft``),
``|.|^2`` and an ``fftshift`` on the tensor's device.  The axes are host
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import units as u
from ..utils.dtypes import default_device

__all__ = ["secondary_spectrum", "SecondarySpectrum"]


def _secondary(dyn, detrend=True):
    d = dyn.to(torch.float32)
    if detrend:
        # remove the mean bandpass and mean light curve: the DC cross
        # would otherwise dominate the delay/Doppler origin
        d = d - d.mean(dim=-2, keepdim=True)
        d = d - d.mean(dim=-1, keepdim=True)
    f = torch.fft.rfft2(d, dim=(-2, -1))
    s = f.real ** 2 + f.imag ** 2
    # the fringe-rate (time-conjugate) axis with 0 in the middle
    return torch.fft.fftshift(s, dim=-2)


def secondary_spectrum(dyn, *, t_step=None, nu_step=None, detrend=True,
                       device=None):
    """Secondary spectrum of a dynamic spectrum ``dyn`` (..., t, nu).

    Returns ``(S, fringe_rate, delay)``: the power on the (fringe rate,
    delay) grid (fringe-rate axis fftshifted so 0 sits in the middle;
    delay axis one-sided from the real FFT), a float32 tensor, plus the
    two axes: in Hz and s when ``t_step``/``nu_step`` are given as
    Quantities (subintegration length and channel bandwidth), else in
    cycles per sample.  A tensor keeps its device; numpy goes to
    ``device`` (default: the card when there is one).
    """
    if not torch.is_tensor(dyn):
        dyn = torch.as_tensor(np.asarray(dyn), device=default_device(device))
    if dyn.ndim < 2:
        raise ValueError("dynamic spectrum needs (..., time, freq)")
    n_t, n_nu = dyn.shape[-2], dyn.shape[-1]
    S = _secondary(dyn, detrend=bool(detrend))
    ft = np.fft.fftshift(np.fft.fftfreq(n_t))
    fnu = np.fft.rfftfreq(n_nu)
    if t_step is not None:
        ft = u.Quantity(ft / t_step.to_value(u.s), u.Hz)
    if nu_step is not None:
        fnu = u.Quantity(fnu / nu_step.to_value(u.Hz), u.s)
    return S, ft, fnu


class SecondarySpectrum:
    """Secondary-spectrum analysis bound to a dynamic-spectrum stream.

    Parameters
    ----------
    ih : stream
        A dynamic-spectrum producer: sample shape ``(n_chan,)`` (e.g.
        ``Integrate(Square(Channelize(...)))``), one spectrum per
        sample.
    n_time : int
        Subintegrations per analyzed block.

    ``analyze(offset=0)`` reads ``n_time`` spectra (on the stream's
    device) and returns ``(S, fringe_rate, delay)`` with physical axes
    from the stream's ``sample_rate`` (subintegration rate) and channel
    spacing (from its ``frequency`` labels when present).
    """

    def __init__(self, ih, n_time):
        if len(ih.sample_shape) != 1:
            raise ValueError("need a (time, chan) dynamic-spectrum "
                             f"stream, got sample shape "
                             f"{tuple(ih.sample_shape)}")
        self.ih = ih
        self.n_time = int(n_time)
        if self.n_time < 2:
            raise ValueError("need at least 2 subintegrations")
        self._t_step = u.Quantity(
            1.0 / ih.sample_rate.to_value(u.Hz), u.s)
        self._nu_step = None
        freq = getattr(ih, "frequency", None)
        if freq is not None and np.ndim(np.asarray(freq.value)) >= 1:
            fv = np.sort(np.asarray(freq.to_value(u.Hz)).ravel())
            df = np.diff(fv)
            if len(df) and np.allclose(df, df[0], rtol=1e-6):
                self._nu_step = u.Quantity(float(df[0]), u.Hz)

    def analyze(self, offset=0, *, detrend=True):
        self.ih.seek(int(offset))
        dyn = self.ih.read(self.n_time)
        return secondary_spectrum(dyn, t_step=self._t_step,
                                  nu_step=self._nu_step,
                                  detrend=detrend)
