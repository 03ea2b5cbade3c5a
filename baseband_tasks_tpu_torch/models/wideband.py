"""Flagship model: wideband coherent-dedispersion + fold pipeline.

Counterpart of ``baseband_tasks_tpu/models/wideband.py`` on one device: a
block of channelized complex baseband -> per-channel coherent dedispersion
(overlap-save chirp) -> detection -> phase-binned fold.  Detection is
power per channel and polarization, or, for dual polarization, full
Stokes [XX, YY, Re XY*, Im XY*] per channel.

``use_kernels`` means what the JAX pipeline's ``use_pallas`` means:

- True: the kernel path.  A power-of-two window with pads rounded to
  N2 runs through the three passes of :mod:`..ops.dedisperse`: the
  hand-written CUDA kernels on a CUDA device, their plain PyTorch
  versions on the CPU.
- False (the default): the plain path, the JAX ``_local_step``.  A
  2/3/5-smooth window (a power of two with ``fft_pow2``), ``torch.fft``
  along time (cuFFT on a card), the chirp in natural order, detection
  and a one-hot fold.

The entry points are those of the JAX pipeline: ``step_fn`` (a block of
the caller's voltages and a fold offset or fold row), ``step_bins_fn``
with ``phase_bins`` (folding on host-computed, full-precision phase
bins), ``planes_step`` (the planes-first kernel step, with the chirp as
cos/sin planes or one phase plane) and ``run_fn`` (a loop of steps).
Compared with the JAX pipeline: ``mesh`` is ``device`` and there is one
time shard (its halo edges are zeros, as the JAX halo exchange gives a
single shard); fold rows are int64 ``[i0_fx, p_fx, 0]`` (the JAX (4,)
16-bit halves were a TPU transfer workaround); bf16 intermediates are not
ported.  Tests run the kernel path on the plain versions on a card inside
:func:`..ops.dedisperse.plain_versions`.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..dm import DispersionMeasure
from ..fourier import next_fast_len
from ..ops.dedisperse import (_FX_MASK, _FX_ONE, as_tensor, dedisperse_pow2,
                              dedisperse_fold_stream, fold_chain,
                              permute_to_storage_order, split_n, stage_a,
                              stage_a_packed)
from ..ops.fold import fold_accumulate
from ..utils import units as u
from .foldmodel import FoldModel, _phase_to_cycles

__all__ = ["WidebandPulsarPipeline"]

# scale folded into the kernel per bit depth (keeps decoded values unit-ish)
_NORM = {8: 1.0 / 64.0, 4: 1.0 / 4.0, 2: 1.0, 1: 1.0}


class _TableFoldModel:
    """A fold model replaying given ``[i0_fx, p_fx, 0]`` rows for blocks
    at offsets 0, T, 2T, ... (see :meth:`WidebandPulsarPipeline
    .from_jax_state`)."""

    def __init__(self, rows, n_window):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.n_window = int(n_window)

    def table(self, offsets, n_window):
        offsets = np.asarray(offsets, dtype=np.int64)
        if n_window != self.n_window or np.any(offsets % n_window) or \
                np.any(offsets // n_window >= len(self.rows)):
            raise ValueError("fold table does not cover these blocks")
        return self.rows[offsets // n_window]


class WidebandPulsarPipeline:
    """Fused dedisperse→detect→fold steps on one device.

    Parameters
    ----------
    n_chan, n_pol : int
        Channels and polarizations of the input block.
    dm : float or DispersionMeasure
        Dispersion measure to remove (pc/cm³).
    freq_center : Quantity
        Band-centre sky frequency; channels are spaced by ``chan_rate``.
    chan_rate : Quantity
        Per-channel (complex) sample rate.
    period_samples : Fraction or tuple (q, p)
        Pulsar period as the exact rational q/p in channel samples, used
        when no ``phase_model`` is given.  Requires p·q < 2^31, q < 2^23.
    n_phase : int
        Phase bins per profile.
    block_samples : int
        Requested samples per step; grown so the window is FFT-fast.
    device : torch.device or str, optional
        Where the step runs (default: the CUDA device if there is one).
    fft_pow2 : bool
        A power-of-two window on the plain path too.
    use_kernels : bool
        The kernel path (the JAX ``use_pallas``); False is the plain
        ``torch.fft`` path.
    phase_model, start_time
        Optional drifting phase model (e.g. ``PolycoPhase``) and the time
        of sample 0; per block the host encodes it into a fold row.
    ingest_bits : int
        Bit depth the kernel geometry is sized for (packed main rows must
        divide by 32/ingest_bits).
    detect : str
        'power' (|x|² per channel and polarization) or 'stokes' (n_pol=2:
        [XX, YY, Re XY*, Im XY*] per channel).
    """

    def __init__(self, *, n_chan=1024, n_pol=4, dm=500.0,
                 freq_center=None, chan_rate=None,
                 period_samples=(16000, 3), n_phase=64,
                 block_samples=16384, device=None, fft_pow2=False,
                 use_kernels=False, phase_model=None, start_time=None,
                 ingest_bits=8, detect="power"):
        if freq_center is None:
            freq_center = 1400 * u.MHz
        if chan_rate is None:
            chan_rate = 250 * u.kHz
        if detect not in ("power", "stokes"):
            raise ValueError(f"detect={detect!r}: 'power' or 'stokes'")
        if detect == "stokes" and n_pol != 2:
            raise ValueError("detect='stokes' needs dual polarization "
                             "(n_pol=2): lanes pair (X, Y) per channel")
        self.detect = detect
        self.n_chan = n_chan
        self.n_pol = n_pol
        self.n_phase = n_phase
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.use_kernels = bool(use_kernels)
        frac = (period_samples if isinstance(period_samples, Fraction)
                else Fraction(*period_samples))
        self._per_q = int(frac.numerator)    # q samples per p periods
        self._per_p = int(frac.denominator)
        if self._per_p * self._per_q >= (1 << 31) or \
                self._per_q >= (1 << 23):
            raise ValueError(
                f"period_samples {self._per_q}/{self._per_p} too fine: "
                f"need p*q < 2^31 and q < 2^23 for exact bookkeeping")
        if not 0 < int(n_phase) <= (1 << 15):
            raise ValueError(f"n_phase={n_phase} must be in [1, 32768]")
        self._p_fx = int(round((Fraction(self._per_p, self._per_q) % 1)
                               * _FX_ONE)) & _FX_MASK
        if phase_model is not None:
            if start_time is None:
                raise ValueError("phase_model requires start_time")
            self.fold_model = FoldModel(phase_model, start_time,
                                        chan_rate, n_phase)
        else:
            self.fold_model = None

        dm = dm if isinstance(dm, DispersionMeasure) else DispersionMeasure(dm)
        self.dm = dm
        rate_hz = chan_rate.to_value(u.Hz)
        self.chan_rate = chan_rate
        chan_idx = np.arange(n_chan) - n_chan / 2 + 0.5
        freqs_mhz = freq_center.to_value(u.MHz) \
            + chan_idx * chan_rate.to_value(u.MHz)
        self.freqs = u.Quantity(freqs_mhz, u.MHz)
        self.reference_frequency = freq_center
        # per-channel pad from that channel's own smear (max over band),
        # rounded to multiples of 128
        edges = np.concatenate([freqs_mhz - rate_hz / 2e6,
                                freqs_mhz + rate_hz / 2e6])
        delays = dm.time_delay(u.Quantity(edges, u.MHz),
                               freq_center).to_value(u.s)
        pad_start = max(int(np.ceil(delays.max() * rate_hz)), 0) + 64
        pad_end = max(int(np.ceil(-delays.min() * rate_hz)), 0) + 64
        pad_start = -(-pad_start // 128) * 128
        pad_end = -(-pad_end // 128) * 128
        if pad_start + pad_end >= block_samples:
            raise ValueError(
                f"block_samples {block_samples} too small for dispersion "
                f"pads ({pad_start}, {pad_end}); raise it or lower the DM")
        n_min = block_samples + pad_start + pad_end
        if fft_pow2 or self.use_kernels:
            # power-of-two window with pads rounded up to multiples of N2,
            # so stage A assembles the window from block + edges; packed
            # ingest also needs the main rows divisible by 32/ingest_bits
            n_fft = 1 << (n_min - 1).bit_length()
            n1, n2 = split_n(n_fft)
            pad_start = -(-pad_start // n2) * n2
            pad_end = -(-pad_end // n2) * n2
            planes = 32 // int(ingest_bits)
            pad_end += ((n1 - (pad_start + pad_end) // n2) % planes) * n2
        else:
            n_fft = next_fast_len(n_min)
        self.pad_start, self.pad_end, self._n_fft = pad_start, pad_end, n_fft
        self.block_samples = n_fft - pad_start - pad_end
        self._chirp_np = self._build_chirp()
        self._dev = {}                   # device copies, made at first use

    @classmethod
    def from_jax_state(cls, state, **kwargs):
        """A pipeline computing from the JAX pipeline's numpy state.

        ``kwargs`` are the constructor's; ``state`` holds the geometry
        ``pad_start``, ``pad_end`` and ``n_fft`` (of either path) and
        optionally ``chirp`` (the JAX ``_chirp_np``), ``theta``
        (``_theta_np``), ``chirp_storage`` (the two planes of the JAX
        ``_chirp_storage_np()``) and ``fold_table``: int64
        ``[i0_fx, p_fx, 0]`` rows (halves recombined as ``(hi<<16)|lo``)
        for the blocks at offsets 0, T, 2T, ...  A chirp not given is the
        port's own for the state's window.
        """
        pipe = cls(**kwargs)
        n_fft = int(state["n_fft"])
        pipe.pad_start = int(state["pad_start"])
        pipe.pad_end = int(state["pad_end"])
        pipe.block_samples = n_fft - pipe.pad_start - pipe.pad_end
        if n_fft != pipe._n_fft:
            pipe._n_fft = n_fft
            pipe._chirp_np = pipe._build_chirp()
        if state.get("chirp") is not None:
            pair = np.asarray(state["chirp"], np.float32).reshape(
                n_fft, pipe.n_chan, 2)
            pipe._chirp_np = (np.ascontiguousarray(pair[..., 0]),
                              np.ascontiguousarray(pair[..., 1]))
        if state.get("theta") is not None:
            pipe._theta_np = np.asarray(state["theta"], np.float32)
        if state.get("chirp_storage") is not None:
            pipe._dev["planes"] = tuple(
                torch.as_tensor(np.ascontiguousarray(c, np.float32)).reshape(
                    c.shape[0], c.shape[1], -1).to(pipe.device)
                for c in state["chirp_storage"])
        if state.get("fold_table") is not None:
            pipe.fold_model = _TableFoldModel(state["fold_table"],
                                              pipe.global_block)
        return pipe

    # -- the chirp -----------------------------------------------------------
    def _build_chirp(self):
        """Dedispersion chirp conj(exp(2πi φ)) over (n_fft, n_chan), as
        float32 real and imaginary parts; sets ``_theta_np``, its phase
        in cycles (-φ mod 1, reduced in float64)."""
        n = self._n_fft
        offsets_mhz = np.fft.fftfreq(n) * self.chan_rate.to_value(u.MHz)
        f_sky = self.freqs.to_value(u.MHz)[np.newaxis, :] \
            + offsets_mhz[:, np.newaxis]
        phase = self.dm.phase_delay(u.Quantity(f_sky, u.MHz),
                                    self.reference_frequency)
        cyc = np.asarray(phase.to_value(u.cycle), dtype=np.float64)
        cyc -= np.round(cyc)
        self._theta_np = (-cyc).astype(np.float32)
        chirp = np.exp(-2j * np.pi * cyc)  # conjugate: REMOVE dispersion
        return (chirp.real.astype(np.float32), chirp.imag.astype(np.float32))

    def _storage(self, arr):
        """(n_fft, n_chan) -> d-major (N2, N1, n_chan, n_pol) float32."""
        n1, n2 = split_n(self._n_fft)
        stor = permute_to_storage_order(arr, n1, n2)
        return np.ascontiguousarray(np.broadcast_to(
            stor[:, :, :, np.newaxis], (n2, n1, self.n_chan, self.n_pol)))

    def _chirp_storage_np(self):
        """Chirp planes in d-major storage order: two float32 arrays
        (N2, N1, n_chan, n_pol)."""
        return tuple(self._storage(part) for part in self._chirp_np)

    def _chirp_theta_storage_np(self):
        """Chirp phase plane (cycles) in d-major storage order: one
        float32 array (N2, N1, n_chan, n_pol)."""
        return self._storage(self._theta_np)

    def _on_device(self, key, make):
        if key not in self._dev:
            self._dev[key] = make()
        return self._dev[key]

    def _planes_device(self, arrays):
        n1, n2 = split_n(self._n_fft)
        return tuple(torch.from_numpy(a).reshape(n2, n1, -1).to(self.device)
                     for a in arrays)

    def _chirp_device(self):
        """The cos/sin chirp planes on the device, (N2, N1, L) float32."""
        return self._on_device("planes", lambda: self._planes_device(
            self._chirp_storage_np()))

    def _theta_device(self):
        """The chirp phase plane on the device, (N2, N1, L) float32."""
        return self._on_device("theta", lambda: self._planes_device(
            (self._chirp_theta_storage_np(),))[0])

    def _chirp_natural(self):
        """The chirp in natural order, (n_fft, n_chan, 1) complex64."""
        return self._on_device("natural", lambda: torch.complex(
            *(torch.from_numpy(c) for c in self._chirp_np))[:, :, None]
            .to(self.device))

    # -- fold rows and bins ---------------------------------------------------
    def _shard_fold3(self, foldv):
        """Kernel fold rows from block rows: local time 0 of the kernel is
        the start of the front halo, so subtract pad_start samples of
        phase (int64 arithmetic, then the 31-bit mask: exact)."""
        base = (foldv[..., 0] - self.pad_start * foldv[..., 1]) & _FX_MASK
        if torch.is_tensor(foldv):
            return torch.stack([base, foldv[..., 1],
                                torch.zeros_like(base)], -1)
        return np.stack([base, foldv[..., 1], np.zeros_like(base)], -1)

    def _fixed_foldv(self, off):
        """(3,) int64 fold row for the fixed rational period, from the
        float32 integer-valued sample offset carry (phase zero at global
        sample 0).  float32 where the JAX pipeline computes in float32."""
        off_i = torch.remainder(off, float(self._per_q)).to(torch.int64)
        num = (off_i * self._per_p) % self._per_q    # exact: p*q < 2^31
        i0 = torch.round(num.to(torch.float32)
                         * np.float32(_FX_ONE / self._per_q))
        i0 = i0.to(torch.int64) & _FX_MASK
        return torch.stack([i0, torch.full_like(i0, self._p_fx),
                            torch.zeros_like(i0)])

    def _foldv(self, fold_in):
        """The (3,) int64 fold row of a step input: a scalar sample offset
        (fixed-period mode) or a (3,) ``[i0_fx, p_fx, 0]`` row at the
        block's first valid sample (``FoldModel.foldv``)."""
        f = torch.as_tensor(fold_in, device=self.device)
        if f.ndim == 0:
            return self._fixed_foldv(f.to(torch.float32))
        if tuple(f.shape) == (4,):
            raise ValueError(
                "a (4,) fold-halves vector is the JAX package's float32 "
                "transfer form; pass the (3,) [i0_fx, p_fx, 0] row "
                "(FoldModel.foldv)")
        if tuple(f.shape) != (3,):
            raise ValueError(f"fold input must be a scalar offset or a (3,) "
                             f"row, got shape {tuple(f.shape)}")
        return f.to(torch.int64)

    def _fold_bins(self, fold3, T):
        """Phase bins of T valid samples: the kernels' exact fixed-point
        map (``ops.dedisperse.fold_bins_ref``), in int64."""
        t = torch.arange(T, dtype=torch.int64, device=self.device)
        num = (fold3[0] + t * fold3[1]) & _FX_MASK
        n = self.n_phase
        return (((num >> 16) * n) + (((num & 0xFFFF) * n) >> 16)) >> 15

    # -- detection ----------------------------------------------------------
    def _detect_xla(self, y):
        """Detect a complex (T, C, P) block: power, or [XX, YY, Re(X Y*),
        Im(X Y*)] per channel."""
        if self.detect == "power":
            return y.real ** 2 + y.imag ** 2
        x0, x1 = y[..., 0], y[..., 1]
        cross = x0 * torch.conj(x1)
        return torch.stack([x0.abs() ** 2, x1.abs() ** 2, cross.real,
                            cross.imag], dim=-1)

    def _window(self, x):
        """The one shard's overlap-save window: zeros, x, zeros in time."""
        def zeros(n):
            return torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                               device=x.device)
        return torch.cat([zeros(self.pad_start), x, zeros(self.pad_end)])

    def _dedisperse_detect(self, xf):
        """(T, C, P, 2) float32 pairs -> detected (T, C, P or 4): the
        kernel chain (``dedisperse_pow2``) or torch.fft along time."""
        T = xf.shape[0]
        ps, C, P = self.pad_start, self.n_chan, self.n_pol
        if not self.use_kernels:
            w = self._window(torch.complex(xf[..., 0], xf[..., 1]))
            y = torch.fft.ifft(torch.fft.fft(w, dim=0) * self._chirp_natural(),
                               dim=0)
            return self._detect_xla(y[ps:ps + T])
        wr, wi = (self._window(xf[..., k].reshape(T, C * P)) for k in (0, 1))
        csr, csi = self._chirp_device()
        if self.detect == "power":
            power = dedisperse_pow2(wr, wi, csr, csi, power=True)
            return power[ps:ps + T].reshape(T, C, P)
        yr, yi = dedisperse_pow2(wr, wi, csr, csi, power=False)
        return self._detect_xla(torch.complex(yr[ps:ps + T],
                                              yi[ps:ps + T]).reshape(T, C, P))

    def _fold_block(self, xf, bins):
        """Dedisperse, detect and fold one block on the given bins."""
        return fold_accumulate(self._dedisperse_detect(xf), bins,
                               self.n_phase)

    def _assemble_stokes(self, prof3):
        """(n_phase, 3·C·P) kernel profile -> (n_phase, C, 4): plane 0
        holds XX/YY on the pol lanes, planes 1/2 the cross terms on the
        even (X) lanes."""
        p = prof3.reshape(self.n_phase, 3, self.n_chan, self.n_pol)
        return torch.stack([p[:, 0, :, 0], p[:, 0, :, 1], p[:, 1, :, 0],
                            p[:, 2, :, 0]], dim=-1)

    def _profile_epilogue(self, prof, cnt):
        """Fused-kernel epilogue: drop the trash bin, lay the lanes out as
        (n_phase, C, P), or (n_phase, C, 4) for Stokes."""
        prof = prof[:self.n_phase]
        if self.detect == "stokes":
            prof = self._assemble_stokes(prof)
        else:
            prof = prof.reshape(self.n_phase, self.n_chan, self.n_pol)
        return prof, cnt[:self.n_phase]

    def _as_input(self, block, shape, dtype):
        t = as_tensor(block)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"block must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        return t.to(self.device).contiguous()

    # -- entry points ---------------------------------------------------------
    def step_fn(self):
        """The step ``(xf, offset_mod) -> (profile, counts)``.

        ``xf`` : (global_block, n_chan, n_pol, 2) float32 voltages as
        trailing (re, im) pairs, a tensor or numpy, taken to the device;
        ``offset_mod`` : a scalar sample offset (fixed-period mode) or a
        (3,) ``[i0_fx, p_fx, 0]`` row for the block's first valid sample
        (``FoldModel.foldv``).  Returns the (n_phase, n_chan, n_pol)
        profile, (n_phase, n_chan, 4) for Stokes, and (n_phase,) float32
        counts.
        """
        T = self.global_block
        shape = (T, self.n_chan, self.n_pol, 2)

        def step(xf, offset_mod):
            x = self._as_input(xf, shape, torch.float32)
            return self._fold_block(x, self._fold_bins(
                self._foldv(offset_mod), T))
        return step

    def step_bins_fn(self):
        """The step ``(xf, bins_f) -> (profile, counts)`` folding on
        host-computed phase bins (:meth:`phase_bins`): (global_block,)
        floats, cast to int and clipped to [0, n_phase - 1]."""
        T = self.global_block
        shape = (T, self.n_chan, self.n_pol, 2)

        def step(xf, bins_f):
            x = self._as_input(xf, shape, torch.float32)
            b = torch.as_tensor(bins_f, device=self.device)
            if tuple(b.shape) != (T,):
                raise ValueError(f"bins must have shape ({T},), got "
                                 f"{tuple(b.shape)}")
            return self._fold_block(x, b.to(torch.int64).clamp(
                0, self.n_phase - 1))
        return step

    def phase_bins(self, phase, start_time, offset=0):
        """Host phase bins of one global block: ``phase`` (Time ->
        Phase, e.g. a ``PolycoPhase``) at the block's sample times from
        stream sample ``offset``, binned at full two-double precision, as
        the float32 array :meth:`step_bins_fn` takes."""
        rate = self.chan_rate.to_value(u.Hz)
        idx = offset + np.arange(self.global_block)
        t = start_time + u.Quantity(idx / rate, u.s)
        hi, lo = _phase_to_cycles(phase(t))
        frac = (hi - np.floor(hi)) + lo
        frac = frac - np.floor(frac)
        bins = np.minimum((frac * self.n_phase).astype(np.int64),
                          self.n_phase - 1)
        return bins.astype(np.float32)

    def planes_step(self, x2, csr, csi, off, fold_in):
        """One planes-first kernel step (the JAX
        ``_local_step_pallas_planes``) on ``dedisperse_fold_stream``.

        ``x2`` : (2, global_block, n_chan, n_pol) float32, real then
        imaginary plane; ``csr``/``csi`` : the chirp's cos/sin storage
        planes on the device (``_chirp_device()``), or its phase plane
        (``_theta_device()``) and None, which runs stage B as k2_theta;
        ``off`` : the sample offset whose ``1 + 1e-6 off`` scales the
        whole window (edges included); ``fold_in`` : as :meth:`step_fn`'s.
        Returns the profile and counts of :meth:`step_fn`.
        """
        if not self.use_kernels:
            raise ValueError("planes_step is the kernel path: "
                             "use_kernels=True")
        T, L = self.global_block, self.n_chan * self.n_pol
        x = self._as_input(x2, (2, T, self.n_chan, self.n_pol),
                           torch.float32).reshape(2, T, L)
        front, end = (torch.zeros((2, n, L), device=self.device)
                      for n in (self.pad_start, self.pad_end))
        off = torch.as_tensor(off, dtype=torch.float32, device=self.device)
        prof, cnt = dedisperse_fold_stream(
            x, front, end, csr, csi,
            self._shard_fold3(self._foldv(fold_in)).to(torch.int32),
            (1.0 + 1e-6 * off).reshape(1), n_phase=self.n_phase,
            pad_start=self.pad_start, n_valid=T,
            stokes=self.detect == "stokes")
        return self._profile_epilogue(prof, cnt)

    # -- the run loop ---------------------------------------------------------
    def _halo_edges(self, L):
        """(front_r, front_i, end_r, end_i) edges of the one time shard:
        zeros, as a halo exchange over one shard delivers."""
        front = torch.zeros((self.pad_start, L), dtype=torch.float32,
                            device=self.device)
        end = torch.zeros((self.pad_end, L), dtype=torch.float32,
                          device=self.device)
        return front, front, end, end

    def _kernel_step(self, bits, cr, ci, edges, off, fold3):
        """One window on the kernel path: (T·bits/32, C, P) int32 words
        (bits) or (T, C, P) float32 planes, with the kernel fold row
        ``fold3`` -> :meth:`_profile_epilogue`'s profile and int32
        counts.  The per-step scale is (1 + 1e-6·off)·norm, in float32."""
        L = self.n_chan * self.n_pol
        if bits:
            scale = ((1.0 + 1e-6 * off) * _NORM[bits]).reshape(1)
            y = stage_a_packed(cr.reshape(-1, L), ci.reshape(-1, L), *edges,
                               scale, bits=bits)
        else:
            scale = (1.0 + 1e-6 * off).reshape(1)
            y = stage_a(cr.reshape(-1, L), ci.reshape(-1, L), *edges, scale)
        prof, cnt = fold_chain(y, *self._chirp_device(), fold3,
                               n_phase=self.n_phase,
                               pad_start=self.pad_start,
                               n_valid=self.block_samples,
                               stokes=self.detect == "stokes")
        return self._profile_epilogue(prof, cnt)

    def _payload(self, seed, shape, bits):
        """Random input made on the device from ``seed``: uniform words
        for packed ingest, standard normal float32 otherwise (two planes
        on the kernel path, one array of pairs on the plain path)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        if bits:
            return tuple(torch.randint(0, 256, shape + (4,), generator=g,
                                       dtype=torch.uint8, device=self.device
                                       ).view(torch.int32).reshape(shape)
                         for _ in range(2))
        return tuple(torch.randn(shape, generator=g, device=self.device)
                     for _ in range(2 if self.use_kernels else 1))

    def run_fn(self, n_iter, offset0=0, ingest_bits=None):
        """A loop of ``n_iter`` pipeline steps over one input block.

        Returns ``run(seed=0, blocks=None) -> (profile_sum, count_sum)``:
        the (n_phase, n_chan, n_pol) profile, (n_phase, n_chan, 4) for
        Stokes, float32, and (n_phase,) float32 counts.  Every step
        reuses the input block, scaled by ``1 + 1e-6·off`` where the
        float32 offset carry advances by one block mod the period
        numerator; the fold row of step k comes from the phase model
        (block at ``offset0 + k·T``) or from the fixed rational period.

        With ``seed`` the input is made on the device once per seed.
        With ``blocks`` (numpy or tensors) those are used: on the kernel
        path ``(re, im)``, each (T·bits/32, n_chan, n_pol) int32/uint32
        words with ``ingest_bits``, else (T, n_chan, n_pol) float32; on
        the plain path ``(xf,)``, one (T, n_chan, n_pol, 2) float32
        array of pairs (packed ingest needs the kernel path).
        """
        T = self.global_block
        per_q = float(self._per_q)
        if ingest_bits not in (None, 1, 2, 4, 8):
            raise ValueError("ingest_bits must be None, 1, 2, 4 or 8")
        if ingest_bits and not self.use_kernels:
            raise ValueError("packed ingest requires use_kernels=True (the "
                             "JAX use_pallas=True)")
        if ingest_bits:
            n1, n2 = split_n(self._n_fft)
            nm = (self._n_fft - self.pad_start - self.pad_end) // n2
            per = 32 // ingest_bits
            if nm % per:
                raise ValueError(
                    f"{ingest_bits}-bit ingest needs the window main rows "
                    f"({nm}) divisible by {per}; adjust block_samples")
            shape = (T * ingest_bits // 32, self.n_chan, self.n_pol)
        elif self.use_kernels:
            shape = (T, self.n_chan, self.n_pol)
        else:
            shape = (T, self.n_chan, self.n_pol, 2)
        fold_rows = None
        if self.fold_model is not None:
            rows = self.fold_model.table(offset0 + np.arange(n_iter) * T, T)
            if self.use_kernels:
                rows = self._shard_fold3(rows).astype(np.int32)
            fold_rows = torch.as_tensor(rows, device=self.device)
        cache = {}

        def run(seed=0, blocks=None):
            if blocks is None:
                if seed not in cache:
                    cache[seed] = self._payload(seed, shape, ingest_bits)
                bases = cache[seed]
            else:
                dtype = torch.int32 if ingest_bits else torch.float32
                bases = tuple(self._as_input(b, shape, dtype) for b in blocks)
            if self.use_kernels:
                edges = self._halo_edges(self.n_chan * self.n_pol)
            off = torch.tensor(float(offset0) % per_q, dtype=torch.float32,
                               device=self.device)
            width = 4 if self.detect == "stokes" else self.n_pol
            acc = torch.zeros((self.n_phase, self.n_chan, width),
                              dtype=torch.float32, device=self.device)
            cnt_acc = torch.zeros((self.n_phase,), dtype=torch.int64,
                                  device=self.device)
            for k in range(n_iter):
                if fold_rows is not None:
                    fold = fold_rows[k]
                else:
                    fold = self._fixed_foldv(off)
                    if self.use_kernels:
                        fold = self._shard_fold3(fold).to(torch.int32)
                if self.use_kernels:
                    prof, cnt = self._kernel_step(ingest_bits, *bases, edges,
                                                  off, fold)
                else:
                    prof, cnt = self._fold_block(
                        bases[0] * (1.0 + 1e-6 * off),
                        self._fold_bins(fold, T))
                off = torch.remainder(off + T, per_q)
                acc += prof
                cnt_acc += cnt.to(torch.int64)
            return acc, cnt_acc.to(torch.float32)

        return run

    @property
    def global_block(self):
        """Samples consumed per step."""
        return self.block_samples
