"""Convolution tasks: direct (time-domain) and FFT overlap-save.

Counterpart of ``baseband_tasks_tpu/convolution.py`` (``ConvolveSamples``,
``Convolve``).

- ``ConvolveSamples``: a depthwise ``torch.nn.functional.conv1d`` per
  channel (the JAX package's ``lax.conv_general_dilated``), in full
  float32 (no TF32 on a card).
- ``Convolve``: overlap-save with the response's Fourier transform,
  computed once on the host in float64 and cached on the stream's device.
  Two engines:

  - ``'xla'``: FFT -> response -> inverse FFT -> trim on the current
    ``fft_maker`` engine;
  - ``'pallas'``: a power-of-two window with the response pad rounded up
    to the four-step N2, filtered by ``ops/spectral_filter`` with the
    response in storage order (the kernels k1_window/k1_stream, k2 and
    k3_trim on a CUDA device, the pads dropped by the last one).  Its
    planes forms (``task_planes``, ``task_stream``) serve the compiled
    pipelines.

  ``'auto'`` picks ``'pallas'`` for complex data over >= 8 lanes on a CUDA
  device.  Where a short stream clamps the frame below the planned window,
  ``'pallas'`` becomes ``'xla'``, as in the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .base import PaddedTaskBase, check_broadcast_to
from .fourier import fft_maker
from .fourier.pallas import MIN_LANES
from .ops.dedisperse import permute_to_storage_order, split_n
from .ops.spectral_filter import (geometry_ok, spectral_filter_pow2,
                                  spectral_filter_stream)
from .utils.dtypes import torch_dtype

__all__ = ["adjust_response_dims", "Convolve", "ConvolveSamples"]


def adjust_response_dims(response, ih):
    """Give a 1-D response trailing singleton axes so it broadcasts
    against the sample shape of ``ih``; otherwise check it broadcasts
    as is."""
    if response.ndim == 1 and ih.ndim > 1:
        response = response.reshape(response.shape[:1]
                                    + (1,) * (ih.ndim - 1))
    else:
        check_broadcast_to(response, response.shape[:1] + ih.sample_shape)
    return response


def _pow2_len(n):
    """Round up to a power of two ('pallas' engine windows)."""
    return 1 << (n - 1).bit_length()


def _lanes_response(resp, sample_shape):
    """The response (r, ...) broadcast over the sample shape, (r,) +
    sample_shape."""
    r = resp.reshape(resp.shape[:1] + (1,) * (len(sample_shape)
                                              - (resp.ndim - 1))
                     + resp.shape[1:])
    return np.broadcast_to(r, (resp.shape[0],) + tuple(sample_shape))


@contextlib.contextmanager
def _full_fp32_conv():
    """Convolutions in full float32: cuDNN would take TF32 by default."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _ConvolveBase(PaddedTaskBase):
    """Common setup: response array, padding split, time alignment.

    ``response`` has the convolution kernel along axis 0 and must
    broadcast against the sample shape on trailing axes.  ``offset``
    positions the kernel relative to the output grid: the output at sample
    ``i`` is ``sum_k data[i + k] * response[::-1][k]`` with the kernel's
    ``offset`` element aligned to ``i``.
    """

    def __init__(self, ih, response, *, offset=0, samples_per_frame=None,
                 engine="xla", **kwargs):
        response = np.asarray(response)
        if response.ndim < 1:
            raise ValueError("response must have at least 1 dimension")
        response = adjust_response_dims(response, ih)
        if engine == "auto":
            lanes = int(np.prod(ih.sample_shape)) if ih.sample_shape else 1
            device = getattr(ih, "device", torch.device("cpu"))
            engine = "pallas" if (torch.device(device).type == "cuda"
                                  and ih.dtype.kind == "c"
                                  and lanes >= MIN_LANES) else "xla"
        if engine not in ("xla", "pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "pallas" and ih.dtype.kind != "c":
            raise ValueError("the pallas convolution engine requires "
                             "complex data")
        self.engine = engine
        pad = response.shape[0] - 1
        extra = 0
        if engine == "pallas":
            fast_len = _pow2_len
            # a power-of-two window with the total pad on the four-step N2
            # grid, so that the trim happens inside the last kernel
            spf0 = samples_per_frame if samples_per_frame is not None \
                else max(3 * pad, 1)
            n_fft = _pow2_len(spf0 + pad)
            while True:
                n2 = split_n(n_fft)[1]
                pad_r = -(-pad // n2) * n2
                if n_fft - pad_r >= max(spf0, 1):
                    break
                n_fft *= 2
            extra = pad_r - pad
            samples_per_frame = n_fft - pad_r
        else:
            fast_len = fft_maker.get().next_fast_len
        super().__init__(ih, pad_start=pad - offset + extra,
                         pad_end=offset,
                         samples_per_frame=samples_per_frame,
                         next_fast_len=fast_len, **kwargs)
        # the trim drops pad_start + pad_end rows at the window front, so
        # the combined pad must sit on the N2 grid
        if engine == "pallas" and not geometry_ok(
                self._padded_samples_per_frame,
                self._pad_start + self._pad_end, 0):
            self.engine = "xla"
        if response.dtype.kind == "c" and self.dtype.kind != "c":
            raise ValueError(
                "complex response with a real output dtype would discard "
                "the imaginary part; pass dtype=complex64 or convert the "
                "stream (e.g. Real2Complex) first")
        self._response = response
        self._response_offset = offset

    @property
    def response(self):
        return self._response


class ConvolveSamples(_ConvolveBase):
    """Convolve a stream with a response directly in the time domain."""

    _response_cache = None

    def _response_tensor(self):
        """The flipped response as depthwise (C, 1, r) float32 (re, im)
        weights on the stream's device, cached."""
        if self._response_cache is None:
            sample_shape = tuple(self.ih.sample_shape)
            c = int(np.prod(sample_shape)) if sample_shape else 1
            rfull = _lanes_response(self._response, sample_shape).reshape(
                self._response.shape[0], c)
            w = np.ascontiguousarray(rfull[::-1].T[:, None, :])
            self._response_cache = tuple(
                torch.as_tensor(part.astype(np.float32), device=self.device)
                for part in (w.real, w.imag))
        return self._response_cache

    def _prepare_device_caches(self):
        self._response_tensor()

    def task(self, data):
        n_in = data.shape[0]
        sample_shape = tuple(data.shape[1:])
        c = int(np.prod(sample_shape)) if sample_shape else 1
        x = data.reshape(n_in, c)
        wr, wi = (w.to(data.device) for w in self._response_tensor())
        if data.is_complex():
            xr, xi = x.real, x.imag
            re = self._conv_real(xr, wr) - self._conv_real(xi, wi)
            im = self._conv_real(xr, wi) + self._conv_real(xi, wr)
            out = torch.complex(re, im)
        else:
            out = self._conv_real(x, wr)
        return out.reshape((out.shape[0],) + sample_shape)

    @staticmethod
    def _conv_real(x, w):
        """Valid-mode depthwise convolution along axis 0: x (n, C), w the
        flipped (C, 1, r) response -> (n - r + 1, C), in float32."""
        lhs = x.to(torch.float32).T.unsqueeze(0).contiguous()
        with _full_fp32_conv():
            out = torch.nn.functional.conv1d(lhs, w, groups=x.shape[1])
        return out[0].T


class Convolve(_ConvolveBase):
    """Convolve via FFT overlap-save with a cached response transform.

    The padded window's FT of the response is computed once on the host
    (float64) and cached on the stream's device: complex for the 'xla'
    task, float32 planes in four-step storage order for the 'pallas'
    forms.
    """

    _ft_response_cache = None
    _storage_response_cache = None

    def _lane_factor(self):
        """A per-lane complex factor multiplied into the response (None
        here; ``ShiftAndResample``'s LO rotation)."""
        return None

    def _ft_response(self):
        """Host FT (complex128) of the zero-padded response over the
        padded window, (n,) + sample_shape, aligned so that trimming
        ``pad_start + pad_end`` from the inverse FFT's start yields the
        convolution; times :meth:`_lane_factor` where there is one."""
        n = self._padded_samples_per_frame
        sample_shape = tuple(self.ih.sample_shape)
        padded = np.zeros((n,) + sample_shape, dtype=np.complex128)
        padded[:self._response.shape[0]] = _lanes_response(
            self._response, sample_shape)
        ft = np.fft.fft(padded, axis=0)
        factor = self._lane_factor()
        if factor is not None:
            ft = ft * np.broadcast_to(factor, sample_shape)
        return ft

    def _ft_response_tensor(self):
        """The complex64 response FT of the 'xla' task on the stream's
        device."""
        if self._ft_response_cache is None:
            self._ft_response_cache = torch.as_tensor(
                self._ft_response().astype(np.complex64),
                device=self.device)
        return self._ft_response_cache

    def _storage_response(self):
        """The response FT as float32 (N2, N1, L) planes in four-step
        storage order, on the stream's device (a scalar-sample stream is
        one lane)."""
        if self._storage_response_cache is None:
            n = self._padded_samples_per_frame
            n1, n2 = split_n(n)
            stor = permute_to_storage_order(
                self._ft_response().reshape(n, -1), n1, n2)
            self._storage_response_cache = tuple(
                torch.as_tensor(np.ascontiguousarray(
                    part.astype(np.float32)), device=self.device)
                for part in (stor.real, stor.imag))
        return self._storage_response_cache

    def _prepare_device_caches(self):
        """Build the engine's response on the device (compiled pipelines
        call this before their first step)."""
        if self.engine == "pallas":
            self._storage_response()
        else:
            self._ft_response_tensor()

    def _task_pallas_planes(self, xr, xi, carry=None, scale=None):
        """Convolve float32 planes through the spectral-filter kernels;
        the valid region starts ``pad_start + pad_end`` into the window
        (all the discard at the front, on the N2 grid), dropped by the
        last kernel.  With ``carry`` the window is [carry | block]."""
        gr, gi = self._storage_response()
        kw = dict(pad_start=self._pad_start + self._pad_end, pad_end=0)
        if carry is not None:
            return spectral_filter_stream(carry[0], carry[1], xr, xi,
                                          gr, gi, scale=scale, **kw)
        return spectral_filter_pow2(xr, xi, gr, gi, **kw)

    def _task_pallas(self, data):
        n = data.shape[0]
        sample_shape = tuple(data.shape[1:])
        x = data.to(torch.complex64).reshape(n, -1)
        yr, yi = self._task_pallas_planes(x.real.contiguous(),
                                          x.imag.contiguous())
        return torch.complex(yr, yi).reshape((-1,) + sample_shape)

    def _complex_out(self):
        return np.dtype(self.dtype).kind == "c"

    def task_planes(self, pair):
        """Planes form (models/compiled.py planes_step): the padded window
        as (re, im) float32 planes in, the convolved block out;
        NotImplemented where the 'pallas' geometry does not apply."""
        xr, xi = pair
        if (self.engine != "pallas" or xi is None
                or xr.shape[0] != self._padded_samples_per_frame
                or not self._complex_out()):
            return NotImplemented
        shape = tuple(xr.shape)
        yr, yi = self._task_pallas_planes(xr.reshape(shape[0], -1),
                                          xi.reshape(shape[0], -1))
        out_shape = (self._samples_per_frame,) + shape[1:]
        return yr.reshape(out_shape), yi.reshape(out_shape)

    def task_stream(self, carry_pair, x_pair, scale=None):
        """Streaming planes form: (pad, ...) carry planes + (spf, ...)
        block planes -> the convolved block, the window assembled in
        stage A (models/compiled.py planes_step)."""
        pad = self._pad_start + self._pad_end
        if (self.engine != "pallas" or carry_pair[0].shape[0] != pad
                or x_pair[0].shape[0] + pad
                != self._padded_samples_per_frame
                or not self._complex_out()):
            return NotImplemented
        shape = tuple(x_pair[0].shape)
        yr, yi = self._task_pallas_planes(
            x_pair[0].reshape(shape[0], -1),
            x_pair[1].reshape(shape[0], -1), scale=scale,
            carry=(carry_pair[0].reshape(pad, -1),
                   carry_pair[1].reshape(pad, -1)))
        out_shape = (self._samples_per_frame,) + shape[1:]
        return yr.reshape(out_shape), yi.reshape(out_shape)

    def task(self, data):
        if self.engine == "pallas" and \
                data.shape[0] == self._padded_samples_per_frame:
            return self._task_pallas(data)
        n = data.shape[0]
        fft = fft_maker((n,) + tuple(data.shape[1:]), np.complex64, axis=0,
                        sample_rate=self.ih.sample_rate)
        ft = fft(data.to(torch.complex64)) * self._ft_response_tensor()
        out = fft.inverse()(ft)
        # output i depends on inputs [i - r + 1, i]: the valid region
        # starts at r - 1 = pad_start + pad_end
        out = out[self._pad_start + self._pad_end:]
        if not self._complex_out():
            out = out.real.to(torch_dtype(self.dtype))
        return out
