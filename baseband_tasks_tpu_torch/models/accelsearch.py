"""Fourier-domain acceleration search: drifting-tone matched filters.

Counterpart of ``baseband_tasks_tpu/models/accelsearch.py``.  A pulsar in
a compact binary drifts in spin frequency during an observation; its
power smears over ``z = f_dot T**2`` Fourier bins and a plain FFT search
loses it.  The standard recovery (Ransom, Eikenberry & Middleditch 2002;
PRESTO's ``accelsearch``; GPU formulation in arXiv:1711.10855) correlates
the complex spectrum with a bank of constant-``f_dot`` templates — the
Fourier response of a linearly drifting tone — and searches the resulting
(frequency, z) map.

Engines, as in the JAX package:

- ``'mx'``: overlap-save windows of L = 2m spectrum bins (two shifted
  reshapes, no gather) contract with the device-resident banded operator
  ``M_z[f, k] = conj(t_z)[f-k]`` in one bank product with a fused power
  epilogue (:func:`~..ops.accel_correlate.bank_matmul_power`, the
  ``bank_power`` kernel on the card).
- ``'pallas'``: overlap-save segments, their forward FFT (``torch.fft``,
  as the JAX package computes it outside its kernel), then the fused
  bank correlation (:func:`~..ops.accel_correlate.accel_correlate_bank`,
  the ``accel_corr`` kernel on the card) over 128-lane chunks of the bank,
  each computed and written for its real templates only.  ``'auto'``
  picks it on a CUDA device (:func:`auto_engine`).
- ``'xla'``: the same overlap-save correlation on ``torch.fft``
  (broadcast multiply, batched inverse FFT); ``'auto'`` on the CPU.

The template bank, the operator planes and the lane banks are built in
numpy exactly as the JAX package builds them and moved to the device
once.  The spectrum (``_spectrum``) is plain torch on every engine;
:meth:`~FourierDomainAccelSearch.harmonic_sum` and the candidate
extraction are host numpy.  ``search_sharded`` splits the bank over the
devices of a mesh axis (``parallel.make_mesh`` or ``parallel.Mesh``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..ops.accel_correlate import (LANES, MAX_SEG_LEN,
                                   _accel_correlate_lanes, bank_matmul_power)
from ..utils import units as u
from .meshtools import (axis_shards, join_parts, mesh_cache_key,
                        pad_to_multiple, require_mesh_axis)

__all__ = ["FourierDomainAccelSearch", "accel_template", "auto_engine"]


def auto_engine(device_type):
    """The engine ``engine='auto'`` runs on a device of this type:
    'pallas' on 'cuda', 'xla' elsewhere.

    The JAX package's rule takes the engine that wins on the backend: the
    bank matmul ('mx') on a TPU, whose MXU runs it fastest, the FFT engine
    everywhere else.  On an H100 the fused bank correlation wins: 'pallas'
    takes 1.70-1.84 ms at 2^22 samples against 4.90-5.26 ms for 'xla' and
    7.64-7.73 ms for 'mx' (PERF.md, the acceleration search), so 'auto'
    on the card is 'pallas', not the JAX line's 'mx'."""
    return "pallas" if device_type == "cuda" else "xla"


def accel_template(z, m):
    """Fourier response of a unit tone drifting ``z`` bins, length ``m``.

    The DFT of ``exp(2πi (b0 t + z t²/2))`` over a unit observation,
    sampled at integer bin offsets ``b - b0`` in [-m/2, m/2): the complex
    Fresnel kernel the spectrum must be correlated with to concentrate a
    drifting tone back into one bin.  Computed by direct numerical
    integration (512 steps — relative error < 1e-4 for |z| < ~200, ample
    for matched filtering).
    """
    offs = np.arange(m) - m // 2
    t = (np.arange(512) + 0.5) / 512.0
    # response at bin offset b: mean_t exp(2πi (z t²/2 - b t))
    phase = 2j * np.pi * (0.5 * z * t[np.newaxis] ** 2
                          - offs[:, np.newaxis] * t[np.newaxis])
    return np.exp(phase).mean(axis=1).astype(np.complex64)


class FourierDomainAccelSearch:
    """A (frequency, z) correlation search.

    Parameters
    ----------
    n_time : int
        Length of the input time series (power samples).
    sample_rate : Quantity
        Rate of the input time series.
    z_max : float
        Largest drift searched, in Fourier bins over the observation
        (``z = f_dot T²``); the bank covers ``[-z_max, z_max]``.
    z_step : float
        Bank spacing in bins (2 is the classic choice: the response
        half-width).
    seg_len : int
        Spectrum segment length of the overlap-save correlation of the
        'xla' and 'pallas' engines ('mx' fixes its own L = 2m window).
    engine : 'auto', 'mx', 'xla' or 'pallas'
        See the module docstring; 'auto' is 'pallas' on a CUDA device and
        'xla' on the CPU (:func:`auto_engine`).
    device : torch device, optional
        Where the search runs; ``None`` means CUDA when available.

    Call :meth:`search` with the ``(n_time,)`` float series to get the
    ``(n_freq, n_z)`` normalized power map (a tensor on the device), or
    :meth:`candidates` for thresholded peaks.
    """

    def __init__(self, n_time, sample_rate, *, z_max=64.0, z_step=2.0,
                 seg_len=4096, engine="auto", device=None):
        self.n_time = int(n_time)
        self.sample_rate = sample_rate
        self.zs = np.arange(-z_max, z_max + 0.5 * z_step, z_step)
        # template width: the response spans ~|z| bins plus wings
        self.m = int(2 ** np.ceil(np.log2(max(2 * z_max + 32, 64))))
        if seg_len <= self.m:
            raise ValueError(f"seg_len {seg_len} must exceed the "
                             f"template span {self.m}")
        if engine not in ("auto", "mx", "xla", "pallas"):
            raise ValueError(f"engine={engine!r}: 'auto', 'mx', "
                             f"'xla' or 'pallas'")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.engine = engine
        # 'auto' on the card runs 'pallas' and takes its limits
        if self._engine() == "pallas":
            if seg_len & (seg_len - 1) or seg_len > MAX_SEG_LEN:
                raise ValueError(
                    f"engine='pallas' needs a power-of-two seg_len <= "
                    f"{MAX_SEG_LEN} (shared-memory budget of the fused "
                    f"kernel); got {seg_len}. Use engine='xla' or a smaller "
                    "window.")
        self.seg_len = int(seg_len)
        self.n_freq = self.n_time // 2 + 1
        # template transfer functions at the segment length: correlation
        # = IFFT(FFT(segment) * conj(FFT(template)))
        bank = np.stack([accel_template(z, self.m) for z in self.zs])
        padded = np.zeros((len(self.zs), self.seg_len), np.complex64)
        padded[:, :self.m] = bank
        tf = np.conj(np.fft.fft(padded, axis=1)).astype(np.complex64)
        # conjugate template taps of the mx engine: (n_z, m) float32
        # planes, kr + i*ki = conj(t)
        self._set_bank(tf.real, tf.imag, bank.real.astype(np.float32),
                       (-bank.imag).astype(np.float32))

    def _set_bank(self, tf_r, tf_i, taps_r, taps_i):
        """The bank's numpy tables; device copies are made on first use."""
        self._tf_r, self._tf_i, self._taps_r, self._taps_i = (
            np.array(a, np.float32, order="C")
            for a in (tf_r, tf_i, taps_r, taps_i))
        self._valid = self.seg_len - self.m
        self._n_seg = -(-self.n_freq // self._valid)
        self._tf_device = None
        self._bank_planes = None      # lane-major planes, built lazily
        self._mx_cache = None
        self._mx_fused_cache = None

    @classmethod
    def from_jax_state(cls, state, n_time, sample_rate, **kwargs):
        """A search computing from the JAX search's bank.

        ``state`` maps ``zs``, ``_tf_r``, ``_tf_i``, ``_taps_r`` and
        ``_taps_i`` of a JAX ``FourierDomainAccelSearch`` to numpy arrays;
        the other arguments are the constructor's (those the JAX object
        was built with).
        """
        self = cls(n_time, sample_rate, **kwargs)
        zs = np.asarray(state["zs"])
        if zs.shape != self.zs.shape:
            raise ValueError(f"state holds {zs.shape[0]} trials; these "
                             f"arguments make {self.zs.shape[0]}")
        self.zs = np.array(zs)
        self._set_bank(*(np.asarray(state[k]) for k in
                         ("_tf_r", "_tf_i", "_taps_r", "_taps_i")))
        return self

    @property
    def freqs(self):
        """Centre frequency of every row of the map."""
        return u.Quantity(
            np.arange(self.n_freq)
            * self.sample_rate.to_value(u.Hz) / self.n_time, u.Hz)

    @property
    def z_values(self):
        return self.zs

    def _on_device(self, *arrays):
        return tuple(torch.as_tensor(np.ascontiguousarray(a),
                                     device=self.device) for a in arrays)

    # -- the spectrum and its segments -------------------------------------
    def _spectrum(self, x):
        """Bin-noise-normalized rfft of the (mean-removed) series."""
        x = x - torch.mean(x)
        spec = torch.fft.rfft(x)
        norm = torch.sqrt(torch.mean(spec[1:].abs() ** 2) + 1e-30)
        return spec / norm

    def _segments(self, x):
        """Normalize the spectrum and cut overlap-save segments."""
        spec = self._spectrum(x)
        pad = self.m
        total = self._n_seg * self._valid + pad
        specp = torch.cat([spec.new_zeros(pad // 2), spec,
                           spec.new_zeros(total - self.n_freq - pad // 2)])
        idx = (torch.arange(self._n_seg, device=spec.device)[:, None]
               * self._valid
               + torch.arange(self.seg_len, device=spec.device)[None, :])
        return specp[idx]                          # (n_seg, seg_len)

    # -- engine 'xla' -------------------------------------------------------
    def _search_impl(self, x, tf_r, tf_i):
        # overlap-save segments along frequency with the template span m
        # at the FRONT of each window (correlation trims the first m-1
        # lags); lag j of segment s IS spectrum bin s·valid + j
        F = torch.fft.fft(self._segments(x), dim=1)
        tf = torch.complex(tf_r, tf_i)             # (n_z, seg_len)
        corr = torch.fft.ifft(F[:, None, :] * tf[None, :, :], dim=2)
        valid = corr[:, :, :self._valid]
        power = valid.real * valid.real + valid.imag * valid.imag
        zmap = power.transpose(1, 2).reshape(-1, tf_r.shape[0])
        return zmap[:self.n_freq]

    # -- engine 'mx' --------------------------------------------------------
    def _mx_planes(self):
        """float32 planes of the banded correlation operator
        ``M_z[f, k] = conj(t_z)[f - k]`` (zero outside ``0 <= f-k < m``)
        stored as (L, m, n_z) Karatsuba planes ``(mr, mr + mi, mi - mr)``,
        L = 2m, so ``corr[s, k, z] = sum_f segs[s, f] M_z[f, k]`` is the
        correlation lag ``k`` of segment ``s``.  Numpy, as the JAX
        package builds them."""
        if self._mx_cache is None:
            L = 2 * self.m
            f = np.arange(L)[:, None]
            k = np.arange(self.m)[None, :]
            d = f - k                          # (L, m) tap index
            band = (d >= 0) & (d < self.m)
            dc = np.clip(d, 0, self.m - 1)
            mr = np.where(band[None], self._taps_r[:, dc], 0.0
                          ).astype(np.float32)
            mi = np.where(band[None], self._taps_i[:, dc], 0.0
                          ).astype(np.float32)
            mr = mr.transpose(1, 2, 0)         # (L, m, n_z)
            mi = mi.transpose(1, 2, 0)
            self._mx_cache = tuple(
                np.ascontiguousarray(p.astype(np.float32))
                for p in (mr, mr + mi, mi - mr))
        return self._mx_cache

    def _mx_fused_planes(self, col_tile=512):
        """The Karatsuba planes flattened to (L, m * n_z_pad) on the
        device, the bank zero-padded so the column count tiles by
        ``col_tile`` (padded templates give zero power, trimmed)."""
        if self._mx_fused_cache is None:
            n_z = len(self.zs)
            q = max(1, col_tile // self.m)
            n_z_pad = -(-n_z // q) * q
            out = []
            for p in self._mx_planes():
                if n_z_pad != n_z:
                    p = np.pad(p, ((0, 0), (0, 0), (0, n_z_pad - n_z)))
                out.append(p.reshape(p.shape[0], -1))
            self._mx_fused_cache = self._on_device(*out)
        return self._mx_fused_cache

    def _search_impl_mx_fused(self, x, ka, kb, kc, seg_tile=256):
        """Windows of ``L = 2m`` spectrum bins advancing by ``m``: each
        segment is two adjacent rows of the (n_seg+1, m)-reshaped padded
        spectrum; segments padded to the kernel's row tile (zero rows give
        zero power past n_freq)."""
        m = self.m
        valid = m
        n_seg = -(-self.n_freq // valid)
        n_seg_pad = -(-n_seg // seg_tile) * seg_tile
        total = (n_seg_pad + 1) * valid
        front = m // 2
        spec = self._spectrum(x)

        def segs(p):
            p = torch.cat([p.new_zeros(front), p,
                           p.new_zeros(total - front - self.n_freq)])
            rows = p.reshape(n_seg_pad + 1, valid)
            return torch.cat([rows[:-1], rows[1:]], dim=1)

        fr, fi = segs(spec.real.contiguous()), segs(spec.imag.contiguous())
        power = bank_matmul_power(fr, fi, ka, kb, kc, seg_tile=seg_tile)
        n_z_pad = ka.shape[1] // m
        zmap = power.reshape(-1, n_z_pad)
        return zmap[:self.n_freq, :len(self.zs)]

    # -- engine 'pallas' ----------------------------------------------------
    def _lane_banks(self):
        """Template planes as lane-major (seg_len, 128) device chunks, with
        the number of real templates in each."""
        if self._bank_planes is None:
            banks = []
            for j0 in range(0, len(self.zs), LANES):
                chunk_r = self._tf_r[j0:j0 + LANES].T
                chunk_i = self._tf_i[j0:j0 + LANES].T
                n_here = chunk_r.shape[1]
                pad = LANES - n_here
                if pad:
                    z = np.zeros((self.seg_len, pad), np.float32)
                    chunk_r = np.concatenate([chunk_r, z], axis=1)
                    chunk_i = np.concatenate([chunk_i, z], axis=1)
                banks.append((self._on_device(chunk_r, chunk_i), n_here))
            self._bank_planes = banks
        return self._bank_planes

    def _search_impl_pallas(self, x, banks):
        """The forward segment FFT (torch.fft, shared by every z lane),
        then the fused bank correlation per 128-lane chunk, computed and
        written for the chunk's real templates only (its pad lanes hold
        zero templates, as in the JAX package, which computes and drops
        them)."""
        F = torch.fft.fft(self._segments(x), dim=1)
        cols = []
        for (tr, ti), n_here in banks:
            pmap = _accel_correlate_lanes(F, tr, ti, valid=self._valid,
                                          n_used=n_here)
            cols.append(pmap.reshape(-1, n_here)[:self.n_freq])
        return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)

    # -- dispatch ---------------------------------------------------------
    def _engine(self):
        """The engine a search on this device runs: ``engine``, with
        'auto' resolved by :func:`auto_engine`."""
        return auto_engine(self.device.type) if self.engine == "auto" \
            else self.engine

    def _use_mx(self):
        return self._engine() == "mx"

    def search(self, x):
        """(n_freq, n_z) normalized drift-corrected power map of the
        ``(n_time,)`` real time series (noise bins ~ chi²₂/2 ≈ 1), a
        float32 tensor on the search's device."""
        if not torch.is_tensor(x):
            x = torch.tensor(np.asarray(x))
        if tuple(x.shape) != (self.n_time,):
            raise ValueError(f"expected shape ({self.n_time},), got "
                             f"{tuple(x.shape)}")
        x = x.to(dtype=torch.float32).to(self.device)
        if self._use_mx():
            return self._search_impl_mx_fused(x, *self._mx_fused_planes())
        if self._engine() == "pallas":
            return self._search_impl_pallas(x, self._lane_banks())
        if self._tf_device is None:
            self._tf_device = self._on_device(self._tf_r, self._tf_i)
        return self._search_impl(x, *self._tf_device)

    def search_sharded(self, x, mesh, *, axis_name="z"):
        """:meth:`search` with the template bank sharded across the devices
        of a mesh axis (``parallel.Mesh``).

        The z axis is a pure batch axis of the whole computation: each
        device holds ``n_z / shards`` templates and correlates the
        (replicated) spectrum against its own slice, with no
        communication, each on the engine :meth:`search` would use there.
        A bank whose size does not divide the shard count is zero-padded
        (padded templates give zero power) and the pad is trimmed.
        Returns the (n_freq, n_z) map of :meth:`search`, joined on the
        first device of the axis (this process's first, on every process
        of a mesh over several, each computing its own shards).
        """
        n_shards = require_mesh_axis(mesh, axis_name)
        if not torch.is_tensor(x):
            x = torch.tensor(np.asarray(x))
        if tuple(x.shape) != (self.n_time,):
            raise ValueError(f"expected shape ({self.n_time},), got "
                             f"{tuple(x.shape)}")
        key = mesh_cache_key(mesh, axis_name)
        cache = self.__dict__.setdefault("_sharded_cache", {})
        devices, owners, local = axis_shards(mesh, axis_name)
        if key not in cache:
            cache[key] = self._shard_bank(devices, n_shards, local)
        maps = [None if s is None else s.search(x.to(s.device))
                for s in cache[key]]
        n_z = len(self.zs)
        zmap = join_parts(maps, owners, dim=1)
        return zmap[:, :n_z] if zmap.shape[1] != n_z else zmap

    def _shard_bank(self, devices, n_shards, local):
        """One search per device over its zero-padded slice of the bank
        (the same engine, planes built from the slice); None for the
        shards of other processes."""
        n_z = len(self.zs)
        per = (n_z + pad_to_multiple(n_z, n_shards)) // n_shards

        def part(a, k):
            out = np.zeros((per,) + a.shape[1:], np.float32)
            rows = a[k * per:(k + 1) * per]
            out[:len(rows)] = rows
            return out

        shards = []
        for k, dev in enumerate(devices):
            if not local[k]:
                shards.append(None)
                continue
            s = copy.copy(self)
            s.__dict__.pop("_sharded_cache", None)
            s.device = torch.device(dev)
            s.zs = np.zeros(per)            # only the bank's size is read
            s._set_bank(*(part(a, k) for a in (self._tf_r, self._tf_i,
                                               self._taps_r,
                                               self._taps_i)))
            shards.append(s)
        return shards

    # -- host post-processing ---------------------------------------------
    def harmonic_sum(self, zmap, n_harm=4):
        """Incoherent harmonic summing of a (frequency, z) map.

        A pulsed (non-sinusoidal) signal puts power in harmonics: the
        k-th harmonic of a tone at (f, z) sits at (k·f, k·z).  Summing
        ``zmap[k·f, nearest(k·z)]`` for k = 1..n_harm (the classic PRESTO
        scheme) recovers that power; the summed map's noise is
        ~chi²(2·n_harm)/2, so thresholds scale accordingly.

        Returns the (n_freq, n_z) summed map (host numpy array; rows
        whose k-th harmonic falls off the spectrum keep partial sums).
        """
        zmap = _host(zmap)
        nf, nz = zmap.shape
        out = zmap.copy()
        for k in range(2, int(n_harm) + 1):
            fi = np.arange(nf) * k
            ok = fi < nf
            # column of the k-scaled drift, clipped to the bank edge
            zi = np.abs(self.zs[:, None] * k
                        - self.zs[None, :]).argmin(axis=1)
            out[ok] += zmap[fi[ok]][:, zi]
        return out

    def candidates(self, x, threshold=25.0, exclude_dc=16):
        """Thresholded peaks of the z-map.

        Returns a list of ``(frequency Quantity, z_bins, power)`` sorted
        by power, keeping one entry per local maximum above ``threshold``
        (normalized power; ~chi²₂/2 units).  The first ``exclude_dc``
        frequency bins are skipped (red noise / DC).
        """
        work = _host(self.search(x)).copy()
        work[:exclude_dc] = 0.0
        out = []
        rate = self.sample_rate.to_value(u.Hz)
        while True:
            i, j = np.unravel_index(np.argmax(work), work.shape)
            p = work[i, j]
            if p < threshold:
                break
            out.append((u.Quantity(i * rate / self.n_time, u.Hz),
                        float(self.zs[j]), float(p)))
            lo = max(i - self.m // 2, 0)
            work[lo:i + self.m // 2 + 1] = 0.0
        return out


def _host(a):
    """A numpy array of ``a`` (a tensor anywhere, or array-like)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)
