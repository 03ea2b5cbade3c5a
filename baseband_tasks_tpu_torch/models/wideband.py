"""Flagship model: wideband coherent-dedispersion + fold pipeline.

Counterpart of ``baseband_tasks_tpu/models/wideband.py`` on one device: a
block of channelized dual-pol complex baseband -> per-channel coherent
dedispersion (overlap-save chirp) -> power detection -> phase-binned
fold, each step one overlap-save window of a power-of-two length through
the three passes of :mod:`..ops.dedisperse`.

Compared with the JAX pipeline: ``mesh`` is ``device``; ``use_pallas`` is
``use_kernels`` (the hand-written CUDA kernels on a CUDA device, their
plain PyTorch versions otherwise); only ``detect='power'`` and one time
shard are ported.  With one shard the halo edges are zeros, which is what
the JAX pipeline's halo exchange gives a single shard.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from ..dm import DispersionMeasure
from ..ops.dedisperse import (_FX_MASK, _FX_ONE, as_tensor, fold_chain,
                              permute_to_storage_order, split_n, stage_a,
                              stage_a_packed, stage_a_packed_ref,
                              stage_a_ref)
from ..utils import units as u
from .foldmodel import FoldModel

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
        Requested samples per step; grown so the window is a power of two.
    device : torch.device or str, optional
        Where the step runs (default: the CUDA device if there is one).
    use_kernels : bool
        Run the hand-written CUDA kernels (on a CUDA device; the CPU gets
        their plain versions); False runs the plain PyTorch versions.
    phase_model, start_time
        Optional drifting phase model (e.g. ``PolycoPhase``) and the time
        of sample 0; per block the host encodes it into a fold row.
    ingest_bits : int
        Bit depth the geometry is sized for (packed main rows must divide
        by 32/ingest_bits).
    detect : str
        'power' (|x|² per channel and polarization).
    """

    def __init__(self, *, n_chan=1024, n_pol=4, dm=500.0,
                 freq_center=None, chan_rate=None,
                 period_samples=(16000, 3), n_phase=64,
                 block_samples=16384, device=None, use_kernels=False,
                 phase_model=None, start_time=None, ingest_bits=8,
                 detect="power"):
        if freq_center is None:
            freq_center = 1400 * u.MHz
        if chan_rate is None:
            chan_rate = 250 * u.kHz
        if detect == "stokes":
            raise NotImplementedError("detect='stokes' is not ported yet")
        if detect != "power":
            raise ValueError(f"detect={detect!r}: 'power' or 'stokes'")
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
        # per-channel pad from that channel's own smear (max over band)
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
        # power-of-two window with pads rounded up to multiples of N2, so
        # stage A assembles the window from block + edges; packed ingest
        # also needs the main rows divisible by 32/ingest_bits
        n_fft = 1 << (block_samples + pad_start + pad_end - 1).bit_length()
        n1, n2 = split_n(n_fft)
        pad_start = -(-pad_start // n2) * n2
        pad_end = -(-pad_end // n2) * n2
        planes = 32 // int(ingest_bits)
        pad_end += ((n1 - (pad_start + pad_end) // n2) % planes) * n2
        self.pad_start, self.pad_end, self._n_fft = pad_start, pad_end, n_fft
        self.block_samples = n_fft - pad_start - pad_end
        self._chirp_np = self._build_chirp()
        self._chirp_planes = None        # device copy, made at first run

    @classmethod
    def from_jax_state(cls, state, **kwargs):
        """A pipeline computing from the JAX pipeline's numpy state.

        ``kwargs`` are the constructor's; ``state`` holds ``pad_start``,
        ``pad_end``, ``n_fft``, ``chirp_storage`` (the two planes of the
        JAX ``_chirp_storage_np()``) and optionally ``fold_table``: int64
        ``[i0_fx, p_fx, 0]`` rows (halves recombined as ``(hi<<16)|lo``)
        for the blocks at offsets 0, T, 2T, ...
        """
        pipe = cls(**kwargs)
        pipe.pad_start = int(state["pad_start"])
        pipe.pad_end = int(state["pad_end"])
        pipe._n_fft = int(state["n_fft"])
        pipe.block_samples = pipe._n_fft - pipe.pad_start - pipe.pad_end
        csr, csi = state["chirp_storage"]
        pipe._chirp_planes = tuple(
            torch.as_tensor(np.ascontiguousarray(c, np.float32)).reshape(
                c.shape[0], c.shape[1], -1).to(pipe.device)
            for c in (csr, csi))
        if state.get("fold_table") is not None:
            pipe.fold_model = _TableFoldModel(state["fold_table"],
                                              pipe.global_block)
        return pipe

    def _build_chirp(self):
        """Dedispersion chirp conj(exp(2πi φ)) over (n_fft, n_chan), as
        float32 real and imaginary parts."""
        n = self._n_fft
        offsets_mhz = np.fft.fftfreq(n) * self.chan_rate.to_value(u.MHz)
        f_sky = self.freqs.to_value(u.MHz)[np.newaxis, :] \
            + offsets_mhz[:, np.newaxis]
        phase = self.dm.phase_delay(u.Quantity(f_sky, u.MHz),
                                    self.reference_frequency)
        cyc = np.asarray(phase.to_value(u.cycle), dtype=np.float64)
        cyc -= np.round(cyc)
        chirp = np.exp(-2j * np.pi * cyc)  # conjugate: REMOVE dispersion
        return (chirp.real.astype(np.float32), chirp.imag.astype(np.float32))

    def _chirp_storage_np(self):
        """Chirp planes in d-major storage order: two float32 arrays
        (N2, N1, n_chan, n_pol)."""
        n1, n2 = split_n(self._n_fft)
        out = []
        for part in self._chirp_np:
            stor = permute_to_storage_order(part, n1, n2)   # (n2, n1, nc)
            out.append(np.ascontiguousarray(np.broadcast_to(
                stor[:, :, :, np.newaxis],
                (n2, n1, self.n_chan, self.n_pol))))
        return tuple(out)

    def _chirp_device(self):
        """The chirp planes on the device, (N2, N1, L) float32 each."""
        if self._chirp_planes is None:
            n1, n2 = split_n(self._n_fft)
            self._chirp_planes = tuple(
                torch.from_numpy(c).reshape(n2, n1, -1).to(self.device)
                for c in self._chirp_storage_np())
        return self._chirp_planes

    # -- the step ----------------------------------------------------------
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

    def _halo_edges(self, L):
        """(front_r, front_i, end_r, end_i) edges of the one time shard:
        zeros, as a halo exchange over one shard delivers."""
        front = torch.zeros((self.pad_start, L), dtype=torch.float32,
                            device=self.device)
        end = torch.zeros((self.pad_end, L), dtype=torch.float32,
                          device=self.device)
        return front, front, end, end

    def _step(self, bits, cr, ci, edges, csr, csi, off, fold3):
        """One window: (T·bits/32, C, P) int32 words (bits) or (T, C, P)
        float32 planes -> ((n_phase, C, P) profile, (n_phase,) int counts).
        The per-step scale is (1 + 1e-6·off)·norm, in float32."""
        L = self.n_chan * self.n_pol
        if bits:
            scale = ((1.0 + 1e-6 * off) * _NORM[bits]).reshape(1)
            sa = stage_a_packed if self.use_kernels else stage_a_packed_ref
            y = sa(cr.reshape(-1, L), ci.reshape(-1, L), *edges, scale,
                   bits=bits)
        else:
            scale = (1.0 + 1e-6 * off).reshape(1)
            sa = stage_a if self.use_kernels else stage_a_ref
            y = sa(cr.reshape(-1, L), ci.reshape(-1, L), *edges, scale)
        prof, cnt = fold_chain(y, csr, csi, fold3, n_phase=self.n_phase,
                               pad_start=self.pad_start,
                               n_valid=self.block_samples,
                               kernels=self.use_kernels)
        return (prof[:self.n_phase].reshape(self.n_phase, self.n_chan,
                                            self.n_pol),
                cnt[:self.n_phase])

    def _payload(self, seed, shape, bits):
        """Random re/im input made on the device from ``seed``: uniform
        words for packed ingest, standard normal float32 otherwise."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        if bits:
            return tuple(torch.randint(0, 256, shape + (4,), generator=g,
                                       dtype=torch.uint8, device=self.device
                                       ).view(torch.int32).reshape(shape)
                         for _ in range(2))
        return tuple(torch.randn(shape, generator=g, device=self.device)
                     for _ in range(2))

    def _as_input(self, block, shape, bits):
        t = as_tensor(block)
        dtype = torch.int32 if bits else torch.float32
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"block must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        return t.to(self.device).contiguous()

    def run_fn(self, n_iter, offset0=0, ingest_bits=None):
        """A loop of ``n_iter`` pipeline steps over one input block.

        Returns ``run(seed=0, blocks=None) -> (profile_sum, count_sum)``:
        (n_phase, n_chan, n_pol) float32 and (n_phase,) float32.  Every
        step reuses the input block, scaled by ``1 + 1e-6·off`` where the
        float32 offset carry advances by one block mod the period
        numerator; the fold row of step k comes from the phase model
        (block at ``offset0 + k·T``) or from the fixed rational period.

        With ``seed`` the input (packed words with ``ingest_bits``, else
        float32 planes) is made on the device once per seed.  With
        ``blocks = (re, im)`` (numpy or tensors) those are used:
        (T·bits/32, n_chan, n_pol) int32/uint32 words or
        (T, n_chan, n_pol) float32.
        """
        T = self.global_block
        per_q = float(self._per_q)
        if ingest_bits not in (None, 1, 2, 4, 8):
            raise ValueError("ingest_bits must be None, 1, 2, 4 or 8")
        if ingest_bits:
            n1, n2 = split_n(self._n_fft)
            nm = (self._n_fft - self.pad_start - self.pad_end) // n2
            per = 32 // ingest_bits
            if nm % per:
                raise ValueError(
                    f"{ingest_bits}-bit ingest needs the window main rows "
                    f"({nm}) divisible by {per}; adjust block_samples")
            shape = (T * ingest_bits // 32, self.n_chan, self.n_pol)
        else:
            shape = (T, self.n_chan, self.n_pol)
        if self.fold_model is not None:
            rows = self._shard_fold3(self.fold_model.table(
                offset0 + np.arange(n_iter) * T, T))
            fold_rows = torch.as_tensor(rows.astype(np.int32),
                                        device=self.device)
        else:
            fold_rows = None
        step = functools.partial(self._step, ingest_bits)
        cache = {}

        def run(seed=0, blocks=None):
            if blocks is None:
                if seed not in cache:
                    cache[seed] = self._payload(seed, shape, ingest_bits)
                bases = cache[seed]
            else:
                bases = tuple(self._as_input(b, shape, ingest_bits)
                              for b in blocks)
            csr, csi = self._chirp_device()
            edges = self._halo_edges(self.n_chan * self.n_pol)
            off = torch.tensor(float(offset0) % per_q, dtype=torch.float32,
                               device=self.device)
            acc = torch.zeros((self.n_phase, self.n_chan, self.n_pol),
                              dtype=torch.float32, device=self.device)
            cnt_acc = torch.zeros((self.n_phase,), dtype=torch.int64,
                                  device=self.device)
            for k in range(n_iter):
                fold3 = (fold_rows[k] if fold_rows is not None else
                         self._shard_fold3(self._fixed_foldv(off)).to(
                             torch.int32))
                prof, cnt = step(*bases, edges, csr, csi, off, fold3)
                off = torch.remainder(off + T, per_q)
                acc += prof
                cnt_acc += cnt
            return acc, cnt_acc.to(torch.float32)

        return run

    @property
    def global_block(self):
        """Samples consumed per step."""
        return self.block_samples
