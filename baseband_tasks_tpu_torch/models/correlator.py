"""FX correlator: multi-station cross-correlation to visibilities.

Counterpart of ``baseband_tasks_tpu/models/correlator.py``.  The chain,
built from ordinary stream nodes:

  per station:  [ShiftAndResample(-delay, lo=...)]   delay + fringe stop
                 (or ShiftSamples + a per-channel phase, method='phase')
                 -> Channelize(n_chan)               the "F" stage
  Stack(axis=1)                                      (time, station, chan)
  CrossMultiply                                      the "X" stage
  Integrate(n_avg)                                   visibility dump

Station streams may carry further sample axes after time, e.g. ``(time,
subband, pol)``: the F stage channelizes each of them, and with
``products='full'`` a trailing polarization axis of 2 gives all four
polarization products of every baseline.

so the result seeks by absolute ``Time``, carries per-channel
frequencies, and compiles (``CompiledPipeline``: one source block per
station, the integration absorbed).  The cross products are a gather and
an elementwise complex multiply on the stream's device.

Conventions: ``delays[k]`` is the known arrival delay of the signal at
station k; the correlator advances each stream by its delay so that
wavefronts align.  With ``lo`` set, the advance also rotates by
exp(+2πi lo delay sideband): fringe stopping for a signal mixed down from
sky frequency ``lo`` (the convention of ``sampling.ShiftAndResample``).
``lo`` may be an array that broadcasts against a station's sample shape,
e.g. one sky frequency per subband, shape ``(n_subband, 1)`` for
``(time, subband, pol)`` streams.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

from ..base import SetAttribute, Task, TaskBase
from ..channelize import Channelize
from ..combining import Stack
from ..fourier.base import next_fast_len
from ..integration import Integrate
from ..sampling import ShiftAndResample, ShiftSamples
from ..shaping import Reshape
from ..utils import units as u
from ..utils.profiling import span

__all__ = ["CrossMultiply", "fx_correlate"]


class CrossMultiply(TaskBase):
    """Station-pair products ``V_b = X_i conj(X_j)`` along a sample axis.

    Parameters
    ----------
    ih : stream
        Input with the station axis first in the sample shape (blocks
        ``(time, station, ...)``).
    baselines : list of (i, j), optional
        Station index pairs.  Default: all pairs with ``i <= j``
        (autocorrelations included, in packed upper-triangle order).
    products : 'elementwise' or 'full', optional
        'elementwise' (default): ``X_i conj(X_j)`` element by element
        along the trailing axes, so a polarization axis gives the
        parallel hands only.  'full': the trailing axis is a polarization
        pair (X, Y) and is replaced by the four products ``[X_i conj(X_j),
        X_i conj(Y_j), Y_i conj(X_j), Y_i conj(Y_j)]`` (XX*, XY*, YX*,
        YY*, in that order); a polarization label becomes the four pairs
        of labels.
    """

    def __init__(self, ih, baselines=None, products="elementwise"):
        if ih.dtype.kind != "c":
            raise ValueError("CrossMultiply needs complex (voltage "
                             "spectra) input.")
        if products not in ("elementwise", "full"):
            raise ValueError(f"products={products!r} must be 'elementwise' "
                             f"or 'full'")
        self._full = products == "full"
        if self._full and (len(ih.sample_shape) < 2
                           or ih.sample_shape[-1] != 2):
            raise ValueError(
                f"products='full' needs a trailing polarization axis of 2 "
                f"after the station axis; the sample shape is "
                f"{ih.sample_shape}")
        n_st = ih.sample_shape[0]
        if baselines is None:
            baselines = [(i, j) for i in range(n_st)
                         for j in range(i, n_st)]
        pairs = [(operator.index(i), operator.index(j))
                 for i, j in baselines]
        for i, j in pairs:
            if not (0 <= i < n_st and 0 <= j < n_st):
                raise ValueError(f"baseline ({i}, {j}) outside the "
                                 f"{n_st} stations")
        self._baselines = tuple(pairs)
        kw = _one_station_labels(ih, "correlation")
        if self._full:
            kw = {name: None if value is None
                  else _full_products_label(name, value)
                  for name, value in kw.items()}
        super().__init__(ih, dtype=np.complex64, **kw)
        self._bi = torch.tensor([p[0] for p in pairs], device=self.device)
        self._bj = torch.tensor([p[1] for p in pairs], device=self.device)

    @property
    def baselines(self):
        return self._baselines

    @property
    def full(self):
        """Whether the products are the four polarization products of
        each baseline (``products='full'``)."""
        return self._full

    def _output_sample_shape(self, ih):
        shape = (len(self._baselines),) + tuple(ih.sample_shape[1:])
        return shape[:-1] + (4,) if self._full else shape

    def task(self, data):
        with span("correlator.x"):
            bi, bj = self._bi.to(data.device), self._bj.to(data.device)
            if not self._full:
                return data[:, bi] * torch.conj(data[:, bj])
            # (..., p, 1) x (..., 1, q) -> (..., p, q), flattened p-major;
            # the conjugate taken of the stations before the gather, so
            # no gathered side is copied again to resolve it
            conj = torch.conj(data).resolve_conj()
            return (data[:, bi].unsqueeze(-1)
                    * conj[:, bj].unsqueeze(-2)).flatten(-2)


def _one_station_labels(ih, what):
    """The labels of ``ih`` (the station axis first in its sample shape)
    as one station carries them.  A label spanning the station axis
    cannot broadcast to the axis that replaces it (baselines, beams): all
    stations observe the same sky, so the stations' labels must be
    identical (``what`` names the operation that needs it) and one
    station's copy is kept.  Returns {name: label or None}."""
    n_st = ih.sample_shape[0]
    nss = len(ih.sample_shape)
    kw = {}
    for name in ("frequency", "sideband", "polarization"):
        value = getattr(ih, name, None)
        if value is not None:
            arr = np.asarray(getattr(value, "value", value))
            if arr.ndim >= nss and arr.shape[-nss] == n_st != 1:
                st_axis = arr.ndim - nss
                first = value[(slice(None),) * st_axis + (0,)]
                f_arr = np.asarray(getattr(first, "value", first))
                if not np.all(arr == np.expand_dims(f_arr, st_axis)):
                    raise ValueError(
                        f"stations disagree on {name}; {what} needs "
                        f"identical channel labels")
                value = first
        kw[name] = value
    return kw


def _full_products_label(name, value):
    """A label of the (station-collapsed) input as the four polarization
    products carry it: a polarization label's pairs of names, ``'X' 'Y'``
    -> ``'XX' 'XY' 'YX' 'YY'``; another label with a polarization axis of
    2 (a channelized stream's sideband, say) kept once where both
    polarizations agree, refused where they do not; a label without one
    as it is."""
    arr = np.asarray(getattr(value, "value", value))
    if arr.ndim == 0 or arr.shape[-1] != 2:
        return value
    if name == "polarization":
        return np.char.add(np.repeat(arr, 2, axis=-1).astype(str),
                           np.tile(arr, 2).astype(str))
    if not np.all(arr[..., :1] == arr[..., 1:]):
        raise ValueError(f"the polarizations disagree on {name}; the full "
                         f"products need one {name} for both")
    return value[..., :1]


def _phase_rotation(s, anchor, rate_hz, n_chan, d, lo, samples_per_frame):
    """method='phase' alignment of station stream ``s`` for arrival delay
    ``d``: (the stream shifted by whole samples and relabelled onto the
    anchor grid, the complex64 per-channel rotation for the fractional
    advance and the fringe stopping, shaped ``(n_chan,)`` + one axis per
    sample axis of ``s``: length 1, or that of ``lo`` where an array
    ``lo`` varies along it)."""
    # the data advance needed on the anchor grid: the stream's label
    # offset already accounts for part of the delay (output k must hold
    # the station signal at anchor time k + tau = label lab + (k +
    # ishift) + frac)
    tau = float(d.to_value(u.s)) * rate_hz                # samples
    lab = float((s.start_time - anchor).sec) * rate_hz
    eff = tau - lab
    ishift = int(round(eff))
    frac = eff - ishift
    if ishift:
        # the frame holds whole channelizer groups (compiled runs pin the
        # block to it)
        spf = samples_per_frame or 128 * n_chan
        spf = -(-spf // n_chan) * n_chan
        s = ShiftSamples(s, -ishift, samples_per_frame=spf)
    # the gather's output at label t holds the station content of label
    # t + ishift, so the anchor-grid value for time k sits at label k +
    # lab: remove that (fractional) label offset
    if lab:
        s = SetAttribute(s, start_time=s.start_time - lab / s.sample_rate)
    # the per-channel slope of the fractional advance, and the fringe
    # stopping of the whole delay (in float64: at a sky frequency of
    # ~1e8 Hz and a delay of ~1e-4 s the phase is ~1e4 cycles)
    nd = len(s.sample_shape)
    fk = np.fft.fftfreq(n_chan)                           # cycles/sample
    rot = np.exp(2j * np.pi * fk * frac).reshape((n_chan,) + (1,) * nd)
    if lo is not None:
        sb = np.asarray(getattr(s, "sideband", 1))
        if sb.ndim:
            raise ValueError("method='phase' fringe stopping needs a "
                             "scalar sideband")
        lo_hz = np.asarray(lo.to_value(u.Hz), dtype=np.float64)
        if lo_hz.ndim > nd or np.broadcast_shapes(
                lo_hz.shape, tuple(s.sample_shape)) != tuple(s.sample_shape):
            raise ValueError(f"lo of shape {lo_hz.shape} does not broadcast "
                             f"against the sample shape {s.sample_shape}")
        fringe = np.exp(2j * np.pi * lo_hz * float(d.to_value(u.s))
                        * float(sb))
        rot = rot * fringe.reshape((1,) * (nd - lo_hz.ndim + 1)
                                   + lo_hz.shape)
    return s, rot.astype(np.complex64)


def _sinc_resampler(s, anchor, n_chan, d, lo, samples_per_frame):
    """method='sinc' alignment: ShiftAndResample by -d onto the anchor
    grid, its frame re-sized to whole channelizer groups in a
    FFT-fast window (compiled runs pin the block to it)."""
    r = ShiftAndResample(s, -d, offset=anchor, lo=lo,
                         samples_per_frame=samples_per_frame)
    pads = r.pad_start + r.pad_end
    spf = r.samples_per_frame
    w = spf + pads
    for _ in range(64):
        w = next_fast_len(w)
        if (w - pads) % n_chan == 0:
            spf = w - pads
            break
        w += 1
    else:
        spf = -(-spf // n_chan) * n_chan
    if spf != r.samples_per_frame:
        r = ShiftAndResample(s, -d, offset=anchor, lo=lo,
                             samples_per_frame=spf)
    return r


def _aligned_spectra(streams, n_chan, *, delays, lo, samples_per_frame,
                     method):
    """Delay-align each station, channelize, and stack to a ``(time,
    station, n_chan, ...)`` stream (shared by :func:`fx_correlate` and
    ``beamform.tied_array_beam``)."""
    if len(streams) < 1:
        raise ValueError("need at least one stream")
    if method not in ("sinc", "phase"):
        raise ValueError(f"method={method!r} must be 'sinc' or 'phase'")
    anchor = streams[0].start_time
    rate_hz = float(streams[0].sample_rate.to_value(u.Hz))
    for k, s in enumerate(streams[1:], start=1):
        if float(s.sample_rate.to_value(u.Hz)) != rate_hz:
            raise ValueError(
                f"stations must share one sample rate; stream {k} has "
                f"{s.sample_rate} vs stream 0's {streams[0].sample_rate}")
    channelized = []
    for k, s in enumerate(streams):
        d = None if delays is None else delays[k]
        rotate = None
        if d is not None and method == "phase":
            s, rotate = _phase_rotation(s, anchor, rate_hz, n_chan, d, lo,
                                        samples_per_frame)
        elif d is not None:
            s = _sinc_resampler(s, anchor, n_chan, d, lo, samples_per_frame)
        # align the F-stage block grid across stations: trim so that each
        # stream's first spectrum starts a whole number of n_chan raw
        # samples from the anchor
        koff = int(round(float((s.start_time - anchor).sec) * rate_hz))
        trim = (-koff) % n_chan
        if trim:
            s = s[trim:]
        ch = Channelize(s, n_chan)
        if rotate is not None:
            # the rotation, on the stream's device from the start
            rv = torch.as_tensor(rotate, device=ch.device)
            ch = Task(ch, lambda data, rv=rv: data * rv.to(data.device))
        channelized.append(ch)
    if len(channelized) == 1:
        # a single station: the station axis made explicit
        return Reshape(channelized[0], (1,) + channelized[0].sample_shape)
    return Stack(channelized, axis=1)


def fx_correlate(streams, n_chan, n_avg, *, delays=None, lo=None,
                 baselines=None, average=True, samples_per_frame=None,
                 method="sinc", products="elementwise", start=0):
    """Build a lazy FX-correlator chain over ``streams``.

    Parameters
    ----------
    streams : list of stream
        Station voltage streams (complex, equal sample rates).
    n_chan : int
        Channels per spectrum (the F stage).
    n_avg : int
        Spectra averaged per visibility dump (the integration).
    delays : list of Quantity or None, optional
        Known arrival delay per station (module docstring); each stream
        is advanced by its delay (with fringe stopping when ``lo`` is
        given).  None entries are left as they are.
    lo : Quantity, optional
        Local-oscillator (sky) frequency of the downconversion; enables
        fringe stopping.  An array broadcasting against a station's
        sample shape gives each of its elements (e.g. each subband) its
        own sky frequency.
    baselines : list of (i, j), optional
        Passed to :class:`CrossMultiply`.
    products : 'elementwise' or 'full', optional
        Passed to :class:`CrossMultiply`: 'full' turns a trailing
        polarization axis of 2 into the four products XX*, XY*, YX*, YY*.
    start : Time or int, optional
        Start of the first dump (an int counts spectra from the start of
        the channelized stream), passed to :class:`Integrate`; default
        the stream's start.  A compiled run whose first spectra are its
        carries' warm-up starts its first dump after them.
    average : bool, optional
        Means (default), or sums and counts (``Integrated``).
    method : 'sinc' or 'phase', optional
        How the fractional part of each delay is applied: 'sinc' (default)
        resamples in the time domain (``ShiftAndResample``, an
        overlap-save window per station); 'phase' shifts whole samples
        before the F stage (``ShiftSamples``) and applies the fraction as
        a per-channel phase slope exp(2πi f_k tau_frac) after it, exact
        for the cross-spectrum expectation of band-limited channels.

    Returns
    -------
    stream with samples ``(n_baseline, n_chan) + trailing`` (the last
    trailing axis 4 with ``products='full'``), one per ``n_avg`` spectra.
    """
    stacked = _aligned_spectra(streams, n_chan, delays=delays, lo=lo,
                               samples_per_frame=samples_per_frame,
                               method=method)
    prods = CrossMultiply(stacked, baselines=baselines, products=products)
    return Integrate(prods, n_avg, start=start, average=average)
