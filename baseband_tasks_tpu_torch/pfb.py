"""Polyphase filter banks and their inversion.

Counterpart of ``baseband_tasks_tpu/pfb.py`` (``sinc_hamming``,
``PolyphaseFilterBankSamples``, ``PolyphaseFilterBank``,
``InversePolyphaseFilterBank``).  The forward bank is a direct FIR
tap-sum over shifted block views followed by a ``Channelize``; the
inverse dechannelizes and runs the per-polyphase Wiener deconvolution
along the block axis, with windows kept block-aligned so phases never
shift.  Two engines for the inverse:

- ``'xla'``: batch FFT -> gain -> inverse FFT -> trim on the current
  ``fft_maker`` engine;
- ``'pallas'``: power-of-two spectra windows with the pads on the
  four-step N2 grid, deconvolved by ``ops/spectral_filter`` with the gain
  in storage order (three kernel passes on a CUDA device, the pads
  dropped by the last).  A short stream that clamps the frame off that
  grid sets the engine to ``'pallas-fallback'``, which runs the 'xla'
  form: the JAX package's own geometry rule.

'auto' picks 'pallas' for complex data over >= 8 lanes on a CUDA device
(the port's rule for ``Disperse``), else 'xla'.  In the compiled
pipelines (``models/compiled.py``) the forward tap-sum runs on the
``ops/pfb`` kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import PaddedTaskBase
from .channelize import Channelize, Dechannelize
from .fourier import fft_maker
from .fourier.pallas import MIN_LANES
from .ops.dedisperse import permute_to_storage_order, split_n
from .ops.spectral_filter import (geometry_ok, spectral_filter_pow2,
                                  spectral_filter_stream)
from .utils.dtypes import torch_dtype

__all__ = ["sinc_hamming", "PolyphaseFilterBank",
           "PolyphaseFilterBankSamples", "InversePolyphaseFilterBank"]


def sinc_hamming(n_tap, n_sample, sc=None, *, sinc_scale=1.0):
    """Sinc-Hamming polyphase prototype filter.

    ``h(x) = sinc(scale * x) * hamming`` over ``n_tap * n_sample`` points
    with x spanning tap units symmetrically (CHIME uses 4 taps x 2048
    samples, GUPPI 12 x 64 with scale 0.95; the keyword ``sinc_scale`` is
    accepted alongside ``sc``).

    Returns a float32 array of shape ``(n_tap, n_sample)``.
    """
    if sc is None:
        sc = sinc_scale
    n = n_tap * n_sample
    i = np.arange(n)
    x = sc * (i / n_sample - n_tap / 2.0)
    h = np.sinc(x) * np.hamming(n)
    return h.reshape(n_tap, n_sample).astype(np.float32)


def _taps_dtype(response):
    return np.complex64 if np.iscomplexobj(response) else np.float32


class _PolyphaseFIR(PaddedTaskBase):
    """Blockwise FIR at the raw rate: z[k*n + j] = sum_t h[t, j] x[(k+t)*n + j].

    Padding is (n_tap - 1) * n samples, centred; windows stay multiples
    of n so polyphase indices never shift.  ``use_kernels`` selects the
    kernel or its plain version in compiled pipelines on a CUDA device.
    """

    def __init__(self, ih, response, *, samples_per_frame=None,
                 use_kernels=True):
        response = np.asarray(response)
        n_tap, n = response.shape[:2]
        self._n = n
        self._n_tap = n_tap
        self.use_kernels = bool(use_kernels)
        pad = (n_tap - 1) * n
        if samples_per_frame is not None:
            samples_per_frame *= n

        fast_len = fft_maker.get().next_fast_len

        def block_fast_len(size):
            return n * fast_len(-(-size // n))

        if pad % 2:
            raise ValueError("(n_tap - 1) * n must be even")
        # centred pads: output spectra are stamped mid-FIR
        super().__init__(ih, pad_start=pad // 2, pad_end=pad // 2,
                         samples_per_frame=samples_per_frame,
                         next_fast_len=block_fast_len)
        if self._samples_per_frame % n:
            raise ValueError(
                f"frame of {self._samples_per_frame} samples does not "
                f"hold whole blocks of n={n} (stream too short?); pass "
                f"samples_per_frame explicitly")
        # device taps, broadcastable against trailing sample dims
        extra = len(ih.sample_shape)
        self._taps = torch.as_tensor(
            response.astype(_taps_dtype(response)).reshape(
                (n_tap, 1, n) + (1,) * extra), device=self.device)

    def task(self, data):
        n = self._n
        xr = data.reshape((-1, n) + tuple(data.shape[1:]))
        m_out = xr.shape[0] - self._n_tap + 1
        acc = self._taps[0] * xr[:m_out]
        for t in range(1, self._n_tap):
            acc = acc + self._taps[t] * xr[t:t + m_out]
        return acc.reshape((-1,) + tuple(data.shape[1:]))

    def task_planes(self, pair):
        """Planes-interchange form: the FIR has real taps, so it applies
        to the re/im planes independently (models/compiled.py)."""
        return (self.task(pair[0]),
                None if pair[1] is None else self.task(pair[1]))


class PolyphaseFilterBankSamples(Channelize):
    """Polyphase filter bank: blockwise FIR then channelization.

    ``response`` has shape ``(n_tap, n)``; output channels are as for
    :class:`~baseband_tasks_tpu_torch.channelize.Channelize` of ``n``
    samples.  ``use_kernels`` (a port option) selects, on a CUDA device,
    the forward-PFB kernel or its plain version in compiled pipelines.
    """

    def __init__(self, ih, response, samples_per_frame=None, *,
                 frequency=None, sideband=None, use_kernels=True):
        response = np.asarray(response)
        n = response.shape[1]
        fir = _PolyphaseFIR(ih, response, samples_per_frame=samples_per_frame,
                            use_kernels=use_kernels)
        self._response = response
        super().__init__(fir, n,
                         samples_per_frame=fir.samples_per_frame // n,
                         frequency=frequency, sideband=sideband)

    @property
    def response(self):
        return self._response


class PolyphaseFilterBank(PolyphaseFilterBankSamples):
    """Polyphase filter bank (identical output to the Samples variant;
    the reference's Fourier-domain tap convolution is a numpy-efficiency
    choice, and the direct tap-sum serves both classes here)."""


class InversePolyphaseFilterBank(PaddedTaskBase):
    """Invert a polyphase filter bank by per-phase Wiener deconvolution.

    Dechannelizes the spectra back to the FIR'd raw stream, then divides
    out the prototype filter per polyphase slice with signal-to-noise
    regularization ``sn``: ``G = H / (|H|^2 + 1/sn^2)``.

    Parameters
    ----------
    ih : stream
        Channelized (PFB) stream.
    response : array (n_tap, n)
        The analysis prototype filter.
    sn : float
        Assumed signal-to-noise regularizer (CHIME ~10, GUPPI ~30).
    pad_start, pad_end : int
        Discarded blocks (spectra) on each side of every frame.
    dtype : dtype, optional
        Output dtype; pass float32 to reconstruct a real stream.
    engine : {'auto', 'xla', 'pallas'}
        See the module docstring.
    use_kernels : bool
        With the 'pallas' engine on a CUDA device, run the hand-written
        kernels (default) or, if False, the plain PyTorch version of the
        same filter.
    """

    def __init__(self, ih, response, *, sn=10.0, pad_start=128, pad_end=128,
                 samples_per_frame=None, dtype=None, frequency=None,
                 sideband=None, engine="auto", use_kernels=True):
        response = np.asarray(response)
        n_tap, n = response.shape[:2]
        self._n = n
        self._n_tap = n_tap
        self._sn = float(sn)
        dech = Dechannelize(ih, n=n, dtype=dtype, frequency=frequency,
                            sideband=sideband)
        if engine == "auto":
            lanes = int(np.prod(ih.sample_shape)) if ih.sample_shape else 1
            device = getattr(ih, "device", torch.device("cpu"))
            engine = "pallas" if (torch.device(device).type == "cuda"
                                  and ih.dtype.kind == "c"
                                  and lanes >= MIN_LANES) else "xla"
        if engine not in ("xla", "pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.use_kernels = bool(use_kernels)
        self._storage_gain_cache = None

        p0r = int(pad_start)
        p1r = int(pad_end) + (n_tap - 1)
        if engine == "pallas":
            # power-of-two spectra windows with pad rows on the four-step
            # N2 grid: the deconvolution runs as the spectral filter's
            # passes with the pads discarded inside the last one
            r0 = samples_per_frame if samples_per_frame is not None \
                else max(3 * (p0r + p1r), 1)
            m = 1 << (r0 + p0r + p1r - 1).bit_length()
            while True:
                n2r = split_n(m)[1]
                q0 = -(-p0r // n2r) * n2r
                q1 = -(-p1r // n2r) * n2r
                if m - q0 - q1 >= max(r0, 1):
                    break
                m *= 2
            p0r, p1r = q0, q1
            super().__init__(dech, pad_start=p0r * n, pad_end=p1r * n,
                             samples_per_frame=(m - p0r - p1r) * n)
            if not geometry_ok(self._padded_samples_per_frame // n,
                               self._pad_start // n, self._pad_end // n):
                # a short stream clamped the frame off the pow2 grid; the
                # 'xla' branch of task() is always valid
                self.engine = "pallas-fallback"
        else:
            if samples_per_frame is not None:
                samples_per_frame *= n

            fast_len = fft_maker.get().next_fast_len

            def block_fast_len(size):
                return n * fast_len(-(-size // n))

            super().__init__(dech, pad_start=p0r * n, pad_end=p1r * n,
                             samples_per_frame=samples_per_frame,
                             next_fast_len=block_fast_len)
        self._response = response
        self._gain_cache = None
        # the forward PFB stamps spectra mid-FIR (centred pads); the
        # reconstruction's content is aligned to the FIR window start, so
        # shift the labels back by half the FIR span to make output
        # sample t equal raw(t)
        self._start_time = self._start_time \
            - self._samples_to_timedelta(1, self.sample_rate) \
            * ((n_tap - 1) * n // 2)
        if self.engine == "pallas":
            self._batch_fft = self._batch_ifft = None
        else:
            m = self._padded_samples_per_frame // n
            shape = (m, n) + tuple(dech.sample_shape)
            self._batch_fft = fft_maker(shape, np.complex64, axis=0)
            self._batch_ifft = self._batch_fft.inverse()

    def _gain_np(self, m):
        """Wiener gain per (block-frequency, phase) as complex128 (m, n).

        The dechannelized stream per phase j is the correlation
        z_j[k] = sum_t h[t, j] x_j[k + t], i.e. Z = conj(H) X in the
        M-point DFT; the regularized inverse is G = H / (|H|² + 1/sn²),
        times (1 + 1/sn²) to keep unit gain where |H| = 1.
        """
        resp = np.zeros((m, self._n), dtype=np.float64)
        resp[:self._n_tap] = self._response
        hbar = np.conj(np.fft.fft(resp, axis=0))
        inv_sn2 = 1.0 / self._sn ** 2
        return (np.conj(hbar) / (np.abs(hbar) ** 2 + inv_sn2)
                * (1.0 + inv_sn2))

    def _make_gain(self, m):
        return torch.as_tensor(self._gain_np(m).astype(np.complex64),
                               device=self.device)

    @property
    def _rows(self):
        """Padded window size in spectra rows."""
        return self._padded_samples_per_frame // self._n

    def _storage_gain_np(self):
        """Wiener gain as complex64 (N2, N1, L) in four-step storage
        order, lanes = (phase j, trailing sample dims) flattened."""
        m = self._rows
        reps = int(np.prod(self.sample_shape, dtype=int)) \
            if self.sample_shape else 1
        gain = self._gain_np(m).astype(np.complex64)
        lanes = np.repeat(gain[:, :, np.newaxis], reps,
                          axis=2).reshape(m, self._n * reps)
        n1, n2 = split_n(m)
        return permute_to_storage_order(lanes, n1, n2)

    def _storage_gain(self):
        """The storage-order Wiener gain as float32 planes on the
        stream's device: the 'chirp' of the spectral-filter kernels."""
        stor = self._storage_gain_np()
        return tuple(torch.as_tensor(np.ascontiguousarray(part),
                                     device=self.device)
                     for part in (stor.real, stor.imag))

    def _storage_gain_planes(self):
        if self._storage_gain_cache is None:
            self._storage_gain_cache = self._storage_gain()
        return self._storage_gain_cache

    def _gain(self, m):
        """The complex (m, n) Wiener gain of the 'xla' task on the
        stream's device, for windows of m spectra rows."""
        if self._gain_cache is None or self._gain_cache.shape[0] != m:
            self._gain_cache = self._make_gain(m)
        return self._gain_cache

    def _prepare_device_caches(self):
        """Build the engine's gain on the device (compiled pipelines call
        this before their first step)."""
        if self.engine == "pallas":
            self._storage_gain_planes()
        else:
            self._gain(self._rows)

    def _task_pallas_planes(self, zr, zi, pre=None, scale=None,
                            carry=None):
        """Deconvolve float32 spectra-row planes (rows, n·reps lanes).

        With ``carry`` (pad rows), runs the streaming form (window
        assembled in stage A, ``scale`` on the block rows); otherwise
        ``zr/zi`` hold the full padded window.  ``pre`` optionally folds a
        preceding Dechannelize's inverse-DFT lane mix in (the compiled
        fusion).  Returns trimmed planes (valid_rows, n·reps)."""
        gr, gi = self._storage_gain_planes()
        n = self._n
        kw = dict(pad_start=self._pad_start // n,
                  pad_end=self._pad_end // n, pre=pre,
                  kernels=self.use_kernels)
        if carry is not None:
            return spectral_filter_stream(carry[0], carry[1], zr, zi,
                                          gr, gi, scale=scale, **kw)
        return spectral_filter_pow2(zr, zi, gr, gi, **kw)

    def _task_pallas(self, data):
        sample_shape = tuple(data.shape[1:])
        m = data.shape[0] // self._n
        z = data.to(torch.complex64).reshape(m, -1)
        yr, yi = self._task_pallas_planes(z.real.contiguous(),
                                          z.imag.contiguous())
        out = torch.complex(yr, yi).reshape((-1,) + sample_shape)
        if self.dtype.kind != "c":
            out = out.real
        return out.to(torch_dtype(self.dtype))

    def task(self, data):
        n = self._n
        if self.engine == "pallas" and \
                data.shape[0] == self._padded_samples_per_frame:
            return self._task_pallas(data)
        sample_shape = tuple(data.shape[1:])
        z = data.reshape((-1, n) + sample_shape)
        m = z.shape[0]
        gain = self._gain(m).reshape((m, n) + (1,) * len(sample_shape))
        zc = z.to(torch.complex64)
        if self._batch_fft is not None \
                and m == self._batch_fft.time_shape[0]:
            x = self._batch_ifft(self._batch_fft(zc) * gain)
        else:  # off-plan window (pallas-engine fallback frames)
            x = torch.fft.ifft(torch.fft.fft(zc, dim=0) * gain, dim=0)
        out = x.reshape((-1,) + sample_shape)
        out = out[self._pad_start:self._pad_start + self._samples_per_frame]
        if self.dtype.kind != "c":
            out = out.real
        return out.to(torch_dtype(self.dtype))
