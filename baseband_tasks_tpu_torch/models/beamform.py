"""Tied-array beamforming: phased (coherent) or incoherent summation of
multi-station voltage streams.

Counterpart of ``baseband_tasks_tpu/models/beamform.py``.  Shares the
station alignment of :func:`~.correlator.fx_correlate`: each station is
advanced by its known delay (with fringe stopping when ``lo`` is given),
channelized, and stacked to ``(time, station, n_chan, ...)``; the beam is

- ``mode='coherent'``: ``B_k = sum_a w_[a,k] X_[a,k]``, complex spectra
  out;
- ``mode='incoherent'``: ``B_k = sum_a w_[a,k] |X_[a,k]|**2``, detected
  power out.

``weights`` are per station (n_st,) or per (station, channel)
(n_st, n_chan), defaulting to 1/n_st.

Beyond the JAX package: many tied-array beams (TABs) at once, with
weights that lead with a TAB axis, ``(n_tab, n_st, ...)``
(``tabs=True``), formed as one batched complex matrix product over the
station axis (float32 arithmetic: TF32 is kept off for it); the beams'
coherent Stokes I, ``|B_X|**2 + |B_Y|**2`` over a trailing polarization
axis of 2 (``stokes='I'``); and :func:`tied_array_beam`'s TAB steering
from each TAB's geometric delays at every channel's sky frequency
(``beam_delays``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..base import TaskBase
from ..utils import units as u
from ..utils.profiling import span
from .correlator import _aligned_spectra, _one_station_labels

__all__ = ["BeamformStations", "tab_weights", "tied_array_beam"]


@contextlib.contextmanager
def _fp32_products():
    """Matrix products in float32 arithmetic: TF32 (10 mantissa bits, which
    a process may allow for its own products) off while the context runs,
    the process's setting restored after it."""
    matmul = torch.backends.cuda.matmul
    allowed = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = allowed


def _tab_products(w, x):
    """``w @ x`` (batched complex matrices) in float32 arithmetic."""
    with _fp32_products():
        return torch.matmul(w, x)


class BeamformStations(TaskBase):
    """Weighted sum over the leading station axis of the sample shape.

    Parameters
    ----------
    ih : stream
        Complex spectra with samples ``(n_st, n_chan, ...)``.
    weights : array, optional
        (n_st,) or (n_st, n_chan) complex weights (default uniform
        1/n_st), kept on the stream's device; with ``tabs``, weights
        (n_tab, n_st, ...) whose axes after the station axis broadcast
        against the sample shape after it, from its start (e.g.
        (n_tab, n_st, n_chan, n_subband) for samples (n_st, n_chan,
        n_subband, n_pol)).
    mode : {'coherent', 'incoherent'}
        Sum voltages, or detect then sum (real output).
    tabs : bool
        The weights lead with a TAB axis: samples ``(n_tab,) + rest`` out,
        each TAB's sum over the stations, all of them one batched complex
        matrix product in float32 (coherent only).
    stokes : {None, 'I'}
        'I': the beams' coherent Stokes I, ``|B_X|**2 + |B_Y|**2`` over a
        trailing polarization axis of 2, real, that axis dropped
        (coherent only).
    """

    def __init__(self, ih, weights=None, *, mode="coherent", tabs=False,
                 stokes=None):
        if ih.dtype.kind != "c":
            raise ValueError("BeamformStations needs complex (voltage "
                             "spectra) input")
        if mode not in ("coherent", "incoherent"):
            raise ValueError(f"unknown mode {mode!r}")
        if stokes not in (None, "I"):
            raise ValueError(f"stokes={stokes!r} must be None or 'I'")
        if mode == "incoherent" and (tabs or stokes):
            raise ValueError("TABs and Stokes I are coherent beams")
        n_st = ih.sample_shape[0]
        rest = tuple(ih.sample_shape[1:])
        if stokes and (not rest or rest[-1] != 2):
            raise ValueError(f"stokes='I' needs a trailing polarization "
                             f"axis of 2 after the station axis; the sample "
                             f"shape is {ih.sample_shape}")
        if weights is None and tabs:
            raise ValueError("tabs=True needs the TABs' weights")
        if weights is None:
            weights = np.full(n_st, 1.0 / n_st)
        weights = np.asarray(weights)
        lead = 2 if tabs else 1
        if (weights.ndim < lead or weights.shape[lead - 1] != n_st
                or (not tabs and weights.ndim > 2)):
            raise ValueError(f"weights shape {weights.shape} does not "
                             f"lead with " + ("the TABs and " if tabs else "")
                             + f"the {n_st} stations")
        if mode == "incoherent" and np.iscomplexobj(weights):
            raise ValueError("incoherent weights must be real")
        self._mode = mode
        self._stokes = stokes
        self._n_tab = weights.shape[0] if tabs else None
        if tabs:
            per = weights.shape[2:]
            if len(per) > len(rest) or any(
                    n not in (1, r) for n, r in zip(per, rest)):
                raise ValueError(f"TAB weights of shape {weights.shape} do "
                                 f"not broadcast against the samples "
                                 f"{ih.sample_shape} after the station "
                                 f"axis")
            # the axes the weights vary along are the product's batch;
            # the axes after them ride with time as its columns
            self._n_batch = max((k + 1 for k, n in enumerate(per) if n != 1),
                                default=0)
            per = per[:self._n_batch]
            w = np.moveaxis(weights.astype(np.complex64).reshape(
                weights.shape[:2] + per), (0, 1), (-2, -1))
        else:
            extra = len(ih.sample_shape) - weights.ndim
            w = (weights.astype(np.float32) if mode == "incoherent"
                 else weights.astype(np.complex64)
                 ).reshape((1,) + weights.shape + (1,) * extra)
        real_dtype = np.empty(0, dtype=ih.dtype).real.dtype
        kw = _one_station_labels(ih, "beamforming")
        if stokes:
            kw = {name: _stokes_label(name, value)
                  for name, value in kw.items()}
        super().__init__(ih, dtype=(real_dtype if mode == "incoherent"
                                    or stokes else ih.dtype), **kw)
        self._w = torch.as_tensor(np.ascontiguousarray(w),
                                  device=self.device)

    @property
    def mode(self):
        return self._mode

    @property
    def n_tab(self):
        """The number of TABs (weights with a TAB axis), else None."""
        return self._n_tab

    def _output_sample_shape(self, ih):
        shape = tuple(ih.sample_shape[1:])
        if self._n_tab is not None:
            shape = (self._n_tab,) + shape
        return shape[:-1] if self._stokes else shape

    def task(self, data):
        with span("beamformer.bf"):
            if self._n_tab is not None:
                return self._tab_beams(data)
            x = data
            if self._mode == "incoherent":
                x = x.real ** 2 + x.imag ** 2
            beam = torch.sum(x * self._w.to(x.device), dim=1)
            if self._stokes:
                beam = (beam.real ** 2 + beam.imag ** 2).sum(-1)
            return beam

    def _tab_beams(self, data):
        """The TABs of a block ``(time, n_st) + rest``: for each cell of the
        axes the weights vary along (the batch), the (n_tab, n_st) weights
        times the (n_st, time x the other axes) spectra, in float32;
        ``(time, n_tab) + rest`` out (Stokes I: the polarization axis
        summed away)."""
        n_time, n_st = data.shape[:2]
        rest = tuple(data.shape[2:])
        nb = self._n_batch
        batch, cols = rest[:nb], rest[nb:]
        # (time, n_st, *batch, *cols) -> (*batch, n_st, time x cols)
        x = data.permute(tuple(range(2, 2 + nb)) + (1, 0)
                         + tuple(range(2 + nb, data.ndim)))
        x = x.reshape(batch + (n_st, -1))
        beams = _tab_products(self._w.to(x.device), x)
        beams = beams.view(batch + (self._n_tab, n_time) + cols)
        if self._stokes:
            # the polarization axis: the last of the columns, or of the
            # batch where the weights vary along it
            pol = beams.ndim - 1 if cols else nb - 1
            beams = torch.linalg.vector_norm(
                torch.view_as_real(beams), dim=(pol, -1)).square_()
            nb -= not cols
        # (*batch, n_tab, time, *cols) -> (time, n_tab, *batch, *cols), a
        # view: a reduction's index_add_ reads it at its strides faster
        # than a transposing copy and a contiguous read
        order = (nb + 1, nb) + tuple(range(nb)) + tuple(
            range(nb + 2, beams.ndim))
        return beams.permute(order)


def _stokes_label(name, value):
    """A label of the stations' spectra as their Stokes I carries it: the
    polarization names become 'I'; another label's trailing axis (the
    polarization axis, where it has one) kept once where both
    polarizations agree, refused where they do not."""
    if value is None:
        return None
    if name == "polarization":
        return np.array("I")
    arr = np.asarray(getattr(value, "value", value))
    if arr.ndim == 0:
        return value
    if not np.all(arr[..., :1] == arr):
        raise ValueError(f"the polarizations disagree on {name}; Stokes I "
                         f"needs one {name} for both")
    return value[..., 0]


def tab_weights(frequency, sideband, beam_delays, n_station):
    """Complex64 weights ``(n_tab, n_station) + f.shape`` that steer TAB b to
    its geometric delays ``beam_delays[b]`` (a (n_tab, n_station)
    Quantity): ``exp(+2 pi i f tau[b, s] sideband) / n_station`` at each
    channel's sky frequency ``f`` (``frequency``, a Quantity as one
    station's spectra carry it; axes along which ``f sideband`` does not
    vary are kept as length 1), in float64 on the host: the sign of the
    correlator's fringe stopping (``correlator._phase_rotation``), so a
    source whose signal reaches station s ``tau[b, s]`` late adds in
    phase in TAB b."""
    f = (np.asarray(frequency.to_value(u.Hz), dtype=np.float64)
         * np.asarray(sideband, dtype=np.float64))
    for ax in range(f.ndim):
        if f.shape[ax] > 1 and np.all(f == f.take([0], axis=ax)):
            f = f.take([0], axis=ax)
    tau = np.asarray(beam_delays.to_value(u.s), dtype=np.float64)
    if tau.ndim != 2 or tau.shape[1] != n_station:
        raise ValueError(f"beam_delays of shape {tau.shape} is not "
                         f"(n_tab, {n_station})")
    phase = f[None, None] * tau.reshape(tau.shape + (1,) * f.ndim)
    return (np.exp(2j * np.pi * phase) / n_station).astype(np.complex64)


def tied_array_beam(streams, n_chan, *, weights=None, mode="coherent",
                    delays=None, lo=None, samples_per_frame=None,
                    method="phase", beam_delays=None, stokes=None):
    """Build a lazy tied-array (or incoherent) beam over station voltage
    streams.

    Parameters mirror :func:`~.correlator.fx_correlate`
    (``delays``/``lo``/``method`` do the same alignment and fringe
    stopping); ``weights``/``mode``/``stokes`` as in
    :class:`BeamformStations`.  ``beam_delays``, a (n_tab, n_station)
    Quantity of each TAB's geometric delay at each station (after the
    alignment by ``delays``), forms that many TABs, steered at every
    channel's sky frequency (:func:`tab_weights`; the streams need
    ``frequency`` and ``sideband`` labels), in place of ``weights``.

    Returns a stream of beam spectra, samples ``(n_chan,) + trailing``
    (``(n_tab, n_chan) + trailing`` with ``beam_delays``; the trailing
    polarization axis summed away by ``stokes='I'``): feed it to
    ``Dechannelize`` for a beamformed voltage series, or to
    ``Square``/``Fold``/``Integrate`` for tied-array pulsar observing.
    """
    stacked = _aligned_spectra(streams, n_chan, delays=delays, lo=lo,
                               samples_per_frame=samples_per_frame,
                               method=method)
    if beam_delays is None:
        return BeamformStations(stacked, weights, mode=mode, stokes=stokes)
    if weights is not None:
        raise ValueError("give weights or beam_delays, not both")
    labels = _one_station_labels(stacked, "beamforming")
    if labels["frequency"] is None:
        raise ValueError("beam_delays steer at each channel's sky "
                         "frequency: the streams need frequency and "
                         "sideband labels")
    with span("beamformer.weights"):
        w = tab_weights(labels["frequency"], labels["sideband"],
                        beam_delays, len(streams))
    return BeamformStations(stacked, w, mode=mode, tabs=True, stokes=stokes)
