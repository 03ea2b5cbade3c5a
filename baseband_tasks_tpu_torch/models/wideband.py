"""Flagship model: wideband coherent-dedispersion + fold pipeline.

Counterpart of ``baseband_tasks_tpu/models/wideband.py``: a block of
channelized complex baseband -> per-channel coherent dedispersion
(overlap-save chirp) -> detection -> phase-binned fold, over a (time,
chan) mesh (``parallel.make_mesh``).  Detection is power per channel and
polarization, or, for dual polarization, full Stokes [XX, YY, Re XY*,
Im XY*] per channel.

The mesh is the JAX pipeline's, driven by one process: every entry point
shards its input over the mesh, runs each shard's step on that shard's
device, sums the profiles over time shards and joins them over channel
shards.  The 'chan' axis needs no communication; along 'time' each shard
takes its overlap-save pads from its neighbours (``halo='ppermute'``:
copies between the shards' devices, ``parallel.halo``; ``halo='remote'``:
the ``halo_remote`` kernel, ``parallel.halo_remote``), zeros at the
stream's two ends.  ``device`` is the one-shard mesh.

On a mesh over several processes (``parallel.multihost.pod_mesh``) each
process runs the same entry point with the same arguments, holds and
computes the shards of its own cells only, and gets the whole result:
the profiles cross processes through the process group and are summed
over time shards in shard order, so the result equals the one-process
mesh's.  The float edges cross by the halo backend: with ``'ppermute'``
through the process group, with ``'remote'`` by the ``halo_remote``
kernel's push form, device to device through CUDA IPC on one host
(``close()`` releases its mailboxes; every process calls it).  Packed
steps move their decoded edges by copies with either backend, as the JAX
pipeline moves them by ``ppermute``.  A time ring whose neighbours are on
different hosts is refused with ``halo='remote'``.

``use_kernels`` means what the JAX pipeline's ``use_pallas`` means:

- True: the kernel path.  A power-of-two window with pads rounded to
  N2 runs through the three passes of :mod:`..ops.dedisperse`: the
  hand-written CUDA kernels on a CUDA device, their plain PyTorch
  versions on the CPU.
- False (the default): the plain path, the JAX ``_local_step``.  A
  2/3/5-smooth window (a power of two with ``fft_pow2``), ``torch.fft``
  along time (cuFFT on a card), the chirp in natural order, detection
  and a one-hot fold.

Packed ingest takes plane-packed words, or with ``ingest_layout='guppi'``
GUPPI raw blocks as a recorder writes them (channel-major words of
signed 8-bit dual-polarization samples), which each shard repacks on its
device into the plane-packed words K1p reads (``guppi_repack``), a
widening the JAX package lacks.

The entry points are those of the JAX pipeline: ``step_fn`` (a block of
the caller's voltages and a fold offset or fold row), ``step_bins_fn``
with ``phase_bins`` (folding on host-computed, full-precision phase
bins), ``planes_step`` (the planes-first kernel step, with the chirp as
cos/sin planes or one phase plane) and ``run_fn`` (a loop of steps).
Fold rows are int64 ``[i0_fx, p_fx, 0]`` (the JAX (4,) 16-bit halves
were a TPU transfer workaround).  The pipeline keeps its planes in
float32: the bf16 intermediates are a mode of the split ops
(``ops.dedisperse_fold_split(..., inter_dtype='bfloat16')``), an option
of neither package's pipeline.  Tests run the kernel path on the plain
versions on a card inside :func:`..ops.dedisperse.plain_versions`.
"""

from __future__ import annotations

from fractions import Fraction

import functools

import numpy as np
import torch

from ..dm import DispersionMeasure
from ..fourier import next_fast_len
from ..ops.dedisperse import (_FX_MASK, _FX_ONE, as_tensor, dedisperse_pow2,
                              dedisperse_fold_stream, fold_chain,
                              guppi_repack, permute_to_storage_order,
                              split_n, stage_a, stage_a_packed)
from ..ops.fold import fold_accumulate
from ..ops.unpack import plane_edges
from ..parallel.halo import halo_edges, halo_exchange, ppermute
from ..parallel._ipc import Mailboxes
from ..parallel.halo_remote import (check_hosts, halo_edges_remote,
                                    halo_exchange_remote)
from ..parallel.mesh import (Mesh, gather_cells, grid_indices, shard,
                             shard_async)
from ..utils import units as u
from ..utils.profiling import span
from .foldmodel import FoldModel, _phase_to_cycles
from .meshtools import require_mesh_axis

__all__ = ["WidebandPulsarPipeline"]

# scale folded into the kernel per bit depth (keeps decoded values unit-ish)
_NORM = {8: 1.0 / 64.0, 4: 1.0 / 4.0, 2: 1.0, 1: 1.0}
# the 8-bit field offset of each ingest layout (None: the decoders'
# default, 127.5): GUPPI's signed bytes arrive sign-flipped, v + 128
_INGEST_OFFSET = {"planes": None, "guppi": 128.0}


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
    """Fused dedisperse→detect→fold steps over a (time, chan) mesh.

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
        Requested samples per time shard per step; grown so the window
        is FFT-fast.
    device : torch.device or str, optional
        The one device of a one-shard mesh (default: the CUDA device if
        there is one); not with ``mesh``.
    mesh : parallel.Mesh, optional
        A (time, chan) mesh (``parallel.make_mesh``); n_chan must divide
        over its 'chan' axis.
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
    halo : str
        'ppermute' (the time shards' edges copied between their devices)
        or 'remote' (the ``halo_remote`` kernel on a CUDA mesh, across the
        processes of one host too).
    ingest_layout : str
        The words :meth:`run_fn` takes with ``ingest_bits``: 'planes'
        (two plane-packed blocks, offset-binary fields) or 'guppi' (one
        GUPPI raw block, channel-major (n_chan, T) words of signed 8-bit
        (X re, X im, Y re, Y im); the kernel path with n_pol = 2),
        repacked into planes on the device by ``guppi_repack``.
    """

    def __init__(self, *, n_chan=1024, n_pol=4, dm=500.0,
                 freq_center=None, chan_rate=None,
                 period_samples=(16000, 3), n_phase=64,
                 block_samples=16384, device=None, mesh=None,
                 fft_pow2=False, use_kernels=False, phase_model=None,
                 start_time=None, ingest_bits=8, detect="power",
                 halo="ppermute", ingest_layout="planes"):
        with span("wideband.init"):
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
            if halo not in ("ppermute", "remote"):
                raise ValueError(f"halo={halo!r}: 'ppermute' or 'remote'")
            self.halo = halo
            if ingest_layout not in _INGEST_OFFSET:
                raise ValueError(f"ingest_layout={ingest_layout!r}: "
                                 f"'planes' or 'guppi'")
            if ingest_layout == "guppi" and (n_pol != 2 or not use_kernels):
                raise ValueError("ingest_layout='guppi' is the kernel path "
                                 "(use_kernels=True) on dual-polarization "
                                 "blocks (n_pol=2)")
            self.ingest_layout = ingest_layout
            self.n_chan = n_chan
            self.n_pol = n_pol
            self.n_phase = n_phase
            if mesh is None:
                if device is None:
                    device = "cuda" if torch.cuda.is_available() else "cpu"
                mesh = Mesh([[device]], ("time", "chan"))
            elif device is not None:
                raise ValueError("give mesh or device, not both (device is "
                                 "the one-shard mesh)")
            if mesh.axis_names != ("time", "chan"):
                for axis in ("time", "chan"):
                    require_mesh_axis(mesh, axis)
                raise ValueError(f"mesh axes must be ('time', 'chan'), got "
                                 f"{mesh.axis_names}")
            self.mesh = mesh
            self.device = mesh.local_device    # where results are joined
            self.n_time_shards = mesh.shape["time"]
            self.n_chan_shards = mesh.shape["chan"]
            if n_chan % self.n_chan_shards:
                raise ValueError("n_chan must divide over the chan mesh axis")
            self._c_local = n_chan // self.n_chan_shards
            # the cells this process computes (all of a one-process mesh)
            self._cells = mesh.local_cells()
            self._owners = mesh.process_ids
            if not self._cells:
                raise ValueError("this process owns no cell of the mesh")
            if halo == "remote":
                # CUDA IPC stays inside a host: a ring across hosts raises
                check_hosts(self._owners, mesh.hosts)
            self._mailboxes = Mailboxes()
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

            if not isinstance(dm, DispersionMeasure):
                dm = DispersionMeasure(dm)
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
            self.pad_start, self.pad_end = pad_start, pad_end
            self._n_fft = n_fft
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

    # -- the mesh -------------------------------------------------------------
    def _lanes(self, t, c, device, axis=2, width=None):
        """Chan shard ``c``'s part of ``t`` (its lanes along ``axis``, by
        default the last of a (N2, N1, L) plane) on ``device``: ``t``
        itself with one chan shard, else a contiguous copy."""
        if t is None:
            return None
        if self.n_chan_shards == 1:
            return t.to(device)
        width = width or self._c_local * self.n_pol
        return t.narrow(axis, c * width, width).to(
            device, copy=True, memory_format=torch.contiguous_format)

    def _shard_chirp(self, key, c, device):
        """Chan shard ``c``'s chirp table ``key`` on ``device`` (cached):
        'planes' (cos/sin storage planes) or 'natural'."""
        def make():
            if key == "natural":
                return self._lanes(self._chirp_natural(), c, device, axis=1,
                                   width=self._c_local)
            return tuple(self._lanes(p, c, device)
                         for p in self._chirp_device())
        return self._on_device((key, c, device), make)

    def _halo_edges(self, grid, axis=0):
        """Each shard's (front, end) edges of a (time, chan) grid of
        blocks, by the pipeline's halo backend."""
        if self.halo == "remote":
            if axis != 0:
                raise NotImplementedError(
                    "halo='remote' moves axis-0 halos; reshape first")
            return halo_edges_remote(grid, self.pad_start, self.pad_end,
                                     owners=self._owners,
                                     mailboxes=self._mailboxes)
        return halo_edges(grid, self.pad_start, self.pad_end, axis=axis,
                          owners=self._owners)

    def _halo_exchange(self, grid):
        """Each shard's overlap-save window [front | block | end] along
        time, by the pipeline's halo backend."""
        if self.halo == "remote":
            return halo_exchange_remote(grid, self.pad_start, self.pad_end,
                                        owners=self._owners,
                                        mailboxes=self._mailboxes)
        return halo_exchange(grid, self.pad_start, self.pad_end,
                             owners=self._owners)

    def close(self):
        """Release the CUDA IPC mailboxes of ``halo='remote'`` across
        processes (a collective: every process calls it, together; a
        pipeline that has none returns at once).  Mailboxes not released
        so are released at ``multihost.shutdown()`` or at exit."""
        self._mailboxes.close()

    def _reduce(self, profs, cnts):
        """Per-shard (profile, counts) grids -> the profile summed over
        time shards and joined over chan shards, and the counts summed over
        time shards only (every chan shard counts the same samples), on
        the pipeline's device.  Over several processes every process
        first receives the other processes' shards, so each sums them in
        shard order, as one process does."""
        if profs.size == 1:
            return profs[0, 0], cnts[0, 0]
        dev = self.device
        cell = self._cells[0]
        profs = gather_cells(profs, self._owners, like=profs[cell])
        cnts = gather_cells(cnts, self._owners, like=cnts[cell])

        def over_time(grid, c):
            return functools.reduce(torch.add, (grid[t, c].to(dev) for t in
                                                range(self.n_time_shards)))
        cols = [over_time(profs, c) for c in range(self.n_chan_shards)]
        prof = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        return prof, over_time(cnts, 0)

    # -- fold rows and bins ---------------------------------------------------
    def _shard_fold3(self, foldv, shard=0, include_pad=True):
        """Fold rows of time shard ``shard`` from block rows (whose i0_fx
        is the phase at the block's first valid sample): add the shard's
        offset and, for the kernel path whose local time 0 is the start of
        the front halo, subtract pad_start samples of phase (int64
        arithmetic, then the 31-bit mask: exact, as the JAX int32 wrap is,
        since 2^31 divides 2^32)."""
        t_off = shard * self.block_samples - (self.pad_start if include_pad
                                              else 0)
        base = (foldv[..., 0] + t_off * foldv[..., 1]) & _FX_MASK
        if torch.is_tensor(foldv):
            return torch.stack([base, foldv[..., 1],
                                torch.zeros_like(base)], -1)
        return np.stack([base, foldv[..., 1], np.zeros_like(base)], -1)

    def _fixed_foldv(self, off):
        """(3,) int64 fold row for the fixed rational period, from the
        float32 integer-valued sample offset carry (phase zero at global
        sample 0); (n, 3) rows from (n,) offsets.  float32 where the JAX
        pipeline computes in float32."""
        off_i = torch.remainder(off, float(self._per_q)).to(torch.int64)
        num = (off_i * self._per_p) % self._per_q    # exact: p*q < 2^31
        i0 = torch.round(num.to(torch.float32)
                         * np.float32(_FX_ONE / self._per_q))
        i0 = i0.to(torch.int64) & _FX_MASK
        return torch.stack([i0, torch.full_like(i0, self._p_fx),
                            torch.zeros_like(i0)], -1)

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
        map (``ops.dedisperse.fold_bins_ref``), in int64, on the fold
        row's device."""
        t = torch.arange(T, dtype=torch.int64, device=fold3.device)
        num = (fold3[0] + t * fold3[1]) & _FX_MASK
        n = self.n_phase
        return (((num >> 16) * n) + (((num & 0xFFFF) * n) >> 16)) >> 15

    def _shard_bins(self, foldv):
        """``bins_of(t, device)`` for :meth:`_pairs_step`: time shard t's
        bins from the block's fold row."""
        def bins_of(t, device):
            return self._fold_bins(self._shard_fold3(
                foldv, t, include_pad=False).to(device), self.block_samples)
        return bins_of

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

    def _detect_window(self, w, c):
        """Chan shard ``c``'s overlap-save window -> detected power of its
        valid rows: a complex (N, C, P) window through torch.fft (plain
        path), or its (re, im) float32 (N, C, P) planes through the kernel
        chain (``dedisperse_pow2``)."""
        ps, T = self.pad_start, self.block_samples
        if not self.use_kernels:
            y = torch.fft.ifft(torch.fft.fft(w, dim=0) * self._shard_chirp(
                "natural", c, w.device), dim=0)
            return self._detect_xla(y[ps:ps + T])
        n, C, P = w[0].shape
        wr, wi = (p.reshape(n, C * P) for p in w)
        csr, csi = self._shard_chirp("planes", c, wr.device)
        if self.detect == "power":
            power = dedisperse_pow2(wr, wi, csr, csi, power=True)
            return power[ps:ps + T].reshape(T, C, P)
        yr, yi = dedisperse_pow2(wr, wi, csr, csi, power=False)
        return self._detect_xla(torch.complex(yr[ps:ps + T],
                                              yi[ps:ps + T]).reshape(T, C, P))

    def _pairs_step(self, grid, bins_of):
        """One step over a (time, chan) grid of (T, C, P, 2) float32 pair
        blocks (the JAX ``_local_step`` / ``_local_step_pallas``): halo
        exchange, dedisperse and detect each shard's window, fold it on
        ``bins_of(t, device)``, reduce over the mesh.  The kernel path
        exchanges the pairs' edges, as JAX does, and assembles each plane
        of the window in one copy."""
        if self.use_kernels:
            front, end = self._halo_edges(grid)
        else:
            windows = self._halo_exchange(_map(
                grid, lambda b: torch.complex(b[..., 0], b[..., 1])))
        profs = np.empty(grid.shape, dtype=object)
        cnts = np.empty(grid.shape, dtype=object)
        for t, c in self._cells:
            if self.use_kernels:
                parts = (front[t, c], grid[t, c], end[t, c])
                w = [torch.cat([p[..., k] for p in parts]) for k in (0, 1)]
                dev = w[0].device
            else:
                w = windows[t, c]
                dev = w.device
            profs[t, c], cnts[t, c] = fold_accumulate(
                self._detect_window(w, c), bins_of(t, dev), self.n_phase)
        return self._reduce(profs, cnts)

    def _assemble_stokes(self, prof3):
        """(n_phase, 3·C·P) kernel profile -> (n_phase, C, 4): plane 0
        holds XX/YY on the pol lanes, planes 1/2 the cross terms on the
        even (X) lanes."""
        p = prof3.reshape(self.n_phase, 3, self._c_local, self.n_pol)
        return torch.stack([p[:, 0, :, 0], p[:, 0, :, 1], p[:, 1, :, 0],
                            p[:, 2, :, 0]], dim=-1)

    def _profile_epilogue(self, prof, cnt):
        """Fused-kernel epilogue of one shard: drop the trash bin, lay the
        lanes out as (n_phase, C, P), or (n_phase, C, 4) for Stokes."""
        prof = prof[:self.n_phase]
        if self.detect == "stokes":
            prof = self._assemble_stokes(prof)
        else:
            prof = prof.reshape(self.n_phase, self._c_local, self.n_pol)
        return prof, cnt[:self.n_phase]

    def _shard_input(self, x, shape, dtype, spec):
        """The mesh's grid of blocks of a step input: a global array
        (tensor or numpy, every process passing the same), or a grid
        already sharded (``parallel.shard``, ``multihost.host_local``)."""
        if isinstance(x, np.ndarray) and x.dtype == object:
            if x.shape != self.mesh.devices.shape:
                raise ValueError(f"a sharded input's grid {x.shape} is not "
                                 f"the mesh's {self.mesh.devices.shape}")
            return x
        return shard(self._as_input(x, shape, dtype), self.mesh, spec)

    def _as_input(self, block, shape, dtype):
        t = as_tensor(block)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"block must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        return t

    # -- entry points ---------------------------------------------------------
    def step_fn(self):
        """The step ``(xf, offset_mod) -> (profile, counts)``.

        ``xf`` : (global_block, n_chan, n_pol, 2) float32 voltages as
        trailing (re, im) pairs, a tensor or numpy, sharded over the mesh
        (time on axis 0, channels on axis 1), or its grid of blocks
        already sharded (``multihost.host_local``); ``offset_mod`` : a scalar
        sample offset (fixed-period mode) or a (3,) ``[i0_fx, p_fx, 0]``
        row for the block's first valid sample (``FoldModel.foldv``).
        Returns the (n_phase, n_chan, n_pol) profile, (n_phase, n_chan, 4)
        for Stokes, and (n_phase,) float32 counts, on the pipeline's
        device.
        """
        shape = (self.global_block, self.n_chan, self.n_pol, 2)

        def step(xf, offset_mod):
            grid = self._shard_input(xf, shape, torch.float32,
                                     ("time", "chan"))
            return self._pairs_step(grid, self._shard_bins(
                self._foldv(offset_mod)))
        return step

    def step_bins_fn(self):
        """The step ``(xf, bins_f) -> (profile, counts)`` folding on
        host-computed phase bins (:meth:`phase_bins`): (global_block,)
        floats, cast to int and clipped to [0, n_phase - 1]."""
        T = self.global_block
        shape = (T, self.n_chan, self.n_pol, 2)
        Tl = self.block_samples

        def step(xf, bins_f):
            grid = shard(self._as_input(xf, shape, torch.float32), self.mesh,
                         ("time", "chan"))
            b = torch.as_tensor(bins_f, device=self.device)
            if tuple(b.shape) != (T,):
                raise ValueError(f"bins must have shape ({T},), got "
                                 f"{tuple(b.shape)}")
            b = b.to(torch.int64).clamp(0, self.n_phase - 1)
            return self._pairs_step(
                grid, lambda t, dev: b[t * Tl:(t + 1) * Tl].to(dev))
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
        imaginary plane, sharded over time on axis 1; ``csr``/``csi`` :
        the chirp's cos/sin storage planes (``_chirp_device()``), or its
        phase plane (``_theta_device()``) and None, which runs stage B as
        k2_theta; ``off`` : the sample offset whose ``1 + 1e-6 off``
        scales the whole window (edges included); ``fold_in`` : as
        :meth:`step_fn`'s.  The edges move along axis 1, so ``halo=
        'remote'`` (an axis-0 exchange) raises, as in the JAX pipeline.
        Returns the profile and counts of :meth:`step_fn`.
        """
        if not self.use_kernels:
            raise ValueError("planes_step is the kernel path: "
                             "use_kernels=True")
        T, Tl = self.global_block, self.block_samples
        L = self._c_local * self.n_pol
        grid = shard(self._as_input(x2, (2, T, self.n_chan, self.n_pol),
                                    torch.float32), self.mesh,
                     (None, "time", "chan"))
        front, end = self._halo_edges(grid, axis=1)
        foldv = self._foldv(fold_in)
        off = torch.as_tensor(off, dtype=torch.float32, device=self.device)
        scale = (1.0 + 1e-6 * off).reshape(1)
        profs = np.empty(grid.shape, dtype=object)
        cnts = np.empty(grid.shape, dtype=object)
        for t, c in self._cells:
            dev = grid[t, c].device
            prof, cnt = dedisperse_fold_stream(
                grid[t, c].reshape(2, Tl, L),
                front[t, c].reshape(2, self.pad_start, L),
                end[t, c].reshape(2, self.pad_end, L),
                self._lanes(csr, c, dev), self._lanes(csi, c, dev),
                self._shard_fold3(foldv, t).to(device=dev,
                                               dtype=torch.int32),
                scale.to(dev), n_phase=self.n_phase,
                pad_start=self.pad_start, n_valid=Tl,
                stokes=self.detect == "stokes")
            profs[t, c], cnts[t, c] = self._profile_epilogue(prof, cnt)
        return self._reduce(profs, cnts)

    # -- the run loop ---------------------------------------------------------
    def _packed_edges(self, grid, bits):
        """Each shard's decoded (front, end) edges of plane-packed (rows, L)
        words: every shard decodes only its own leading pad_end and
        trailing pad_start samples, and they move to the neighbours as
        float32 (by copies, with either halo backend, as the JAX pipeline
        moves them by ppermute)."""
        n = self.n_time_shards
        lead = np.empty(grid.shape, dtype=object)
        tail = np.empty(grid.shape, dtype=object)
        for t, c in self._cells:
            w = grid[t, c]
            # plane_edges(words, a, b) decodes the first a and last b
            # samples: the leading pad_end go left, the trailing
            # pad_start right; an edge nobody receives is not decoded
            # (its buffer only gives ppermute the shape of the zeros)
            lead[t, c], tail[t, c] = plane_edges(
                w, self.pad_end if t > 0 else 0,
                self.pad_start if t < n - 1 else 0, bits,
                _INGEST_OFFSET[self.ingest_layout])
            if t == 0:
                lead[t, c] = w.new_empty((self.pad_end, w.shape[1]),
                                         dtype=torch.float32)
            if t == n - 1:
                tail[t, c] = w.new_empty((self.pad_start, w.shape[1]),
                                         dtype=torch.float32)
        front = ppermute(tail, [(i, i + 1) for i in range(n - 1)],
                         self._owners)
        end = ppermute(lead, [(i + 1, i) for i in range(n - 1)],
                       self._owners)
        return front, end

    def _run_edges(self, bits, bases):
        """The (re, im) blocks' edges, per shard in cell order as
        (front_r, front_i, end_r, end_i): decoded and moved by copies for
        packed words, by the halo backend for float planes."""
        (fr, er), (fi, ei) = (self._packed_edges(b, bits) if bits
                              else self._halo_edges(b) for b in bases)
        return [(fr[cell], fi[cell], er[cell], ei[cell])
                for cell in self._cells]

    def _kernel_step(self, bits, bases, chirps, scales, folds, edges=None):
        """One window per shard on the kernel path, from the (rows, L)
        blocks ``bases`` (plane-packed int32 words with ``bits``, else
        float32 planes), each shard's chirp planes, (1,) float32 scale
        and kernel fold row in cell order (:meth:`_kernel_tables`), and
        the edges of :meth:`_run_edges` if given (else exchanged here);
        returns :meth:`_reduce`'s profile and int32 counts."""
        edges = edges or self._run_edges(bits, bases)
        profs = np.empty(bases[0].shape, dtype=object)
        cnts = np.empty(bases[0].shape, dtype=object)
        for i, (t, c) in enumerate(self._cells):
            cr, ci = bases[0][t, c], bases[1][t, c]
            if bits:
                y = stage_a_packed(cr, ci, *edges[i], scales[i], bits=bits,
                                   offset=_INGEST_OFFSET[self.ingest_layout])
            else:
                y = stage_a(cr, ci, *edges[i], scales[i])
            prof, cnt = fold_chain(y, *chirps[i], folds[i],
                                   n_phase=self.n_phase,
                                   pad_start=self.pad_start,
                                   n_valid=self.block_samples,
                                   stokes=self.detect == "stokes")
            profs[t, c], cnts[t, c] = self._profile_epilogue(prof, cnt)
        return self._reduce(profs, cnts)

    def _payload(self, seed, shape, bits):
        """Random input made on the device from ``seed``: uniform words
        for packed ingest (two planes, or one GUPPI block), standard
        normal float32 otherwise (two planes on the kernel path, one
        array of pairs on the plain path).  Each process of a mesh over
        several makes the whole global block, so the numbers do not
        depend on the process layout, and keeps its own shards."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        if bits:
            n = 1 if self.ingest_layout == "guppi" else 2
            return tuple(torch.randint(0, 256, shape + (4,), generator=g,
                                       dtype=torch.uint8, device=self.device
                                       ).view(torch.int32).reshape(shape)
                         for _ in range(n))
        return tuple(torch.randn(shape, generator=g, device=self.device)
                     for _ in range(2 if self.use_kernels else 1))

    def _offsets(self, offset0, n_iter):
        """(n_iter,) float32 offsets of a run's steps on the pipeline's
        device: ``offset0`` mod the period numerator, then the carry
        ``off_{k+1} = (off_k + T) mod q`` step by step, in float32 as the
        JAX run loop carries it."""
        per_q = float(self._per_q)
        off = torch.tensor(float(offset0) % per_q, dtype=torch.float32,
                           device=self.device)
        offs = [off]
        for _ in range(n_iter - 1):
            off = torch.remainder(off + self.global_block, per_q)
            offs.append(off)
        return torch.stack(offs)

    def _kernel_tables(self, offs, rows, bits):
        """Per step k, the kernel path's ``(scales, folds)``: one (1,)
        float32 scale (1 + 1e-6·off_k)·norm and one (3,) int32 fold row
        per shard in cell order, each a view of a table put on the
        shard's device once, from the (n_iter,) offsets and the (n_iter,
        3) int64 block rows."""
        scale = 1.0 + 1e-6 * offs
        if bits:
            scale = scale * _NORM[bits]
        scales, folds = [], []
        for t, c in self._cells:
            dev = self.mesh.devices[t, c]
            scales.append(scale.to(dev))
            folds.append(self._shard_fold3(rows, t).to(device=dev,
                                                       dtype=torch.int32))
        return [([s[k:k + 1] for s in scales], [f[k] for f in folds])
                for k in range(len(offs))]

    def run_fn(self, n_iter, offset0=0, ingest_bits=None):
        """A loop of ``n_iter`` pipeline steps over one input block.

        Returns ``run(seed=0, blocks=None) -> (profile_sum, count_sum)``:
        the (n_phase, n_chan, n_pol) profile, (n_phase, n_chan, 4) for
        Stokes, float32, and (n_phase,) float32 counts.  Every step
        reuses the input block, scaled by ``1 + 1e-6·off`` where the
        float32 offset carry advances by one global block mod the period
        numerator; the fold row of step k comes from the phase model
        (block at ``offset0 + k·T``) or from the fixed rational period.

        With ``seed`` the input is made on the device once per seed.
        With ``blocks`` (numpy or tensors) those are used: on the kernel
        path ``(re, im)``, each (T·bits/32, n_chan, n_pol) int32/uint32
        words with ``ingest_bits``, else (T, n_chan, n_pol) float32; on
        the plain path ``(xf,)``, one (T, n_chan, n_pol, 2) float32
        array of pairs (packed ingest needs the kernel path).  Blocks are
        sharded over the mesh on axes 0 (time) and 1 (channels); packed
        words are packed per time shard (``pack_time_planes`` of each
        shard's samples, concatenated), since each shard decodes its own.
        With ``ingest_layout='guppi'`` (``ingest_bits=8``) ``blocks`` is
        one GUPPI raw block, (n_chan, T) int32 words sharded on axes 0
        (channels) and 1 (time); each shard's words are repacked into its
        two planes on its device (span ``wideband.repack``).

        What depends only on these arguments is made here, once: the
        steps' offsets (the carry run ahead on the device), their scales
        and fold rows as tables on every shard's device.  Each shard's
        chirp planes and, with one time shard, its zero edges (no
        neighbour to read) are the pipeline's: the first call of its
        first ``run_fn`` makes them (on every process of a mesh), and
        every later call of every ``run_fn`` reuses them; a time-sharded
        mesh exchanges its edges every step.  The sums start as the first
        step's own profile and counts.  So with device blocks a call
        makes no tensor from a Python number and does not wait for the
        device.  Contiguous blocks in pinned host memory are copied on
        each device's copy stream (``parallel.mesh.shard_async``), under
        the kernels already queued; the steps wait on the device for
        their copies, and the call, at its end (span ``mesh.copy_wait``),
        waits on the host for those copies alone, not for its kernels.
        When it returns, the caller may refill its blocks.
        """
        with span("wideband.run_fn"):
            T = self.global_block
            if n_iter < 1:
                raise ValueError(f"n_iter={n_iter}: a run takes one step "
                                 f"or more")
            if ingest_bits not in (None, 1, 2, 4, 8):
                raise ValueError("ingest_bits must be None, 1, 2, 4 or 8")
            if ingest_bits and not self.use_kernels:
                raise ValueError("packed ingest requires use_kernels=True "
                                 "(the JAX use_pallas=True)")
            guppi = self.ingest_layout == "guppi"
            if guppi and ingest_bits != 8:
                raise ValueError("ingest_layout='guppi' reads 8-bit GUPPI "
                                 "words: ingest_bits=8")
            if ingest_bits:
                n1, n2 = split_n(self._n_fft)
                nm = (self._n_fft - self.pad_start - self.pad_end) // n2
                per = 32 // ingest_bits
                if nm % per:
                    raise ValueError(
                        f"{ingest_bits}-bit ingest needs the window main "
                        f"rows ({nm}) divisible by {per}; adjust "
                        f"block_samples")
                shape = ((self.n_chan, T) if guppi else
                         (T * ingest_bits // 32, self.n_chan, self.n_pol))
            elif self.use_kernels:
                shape = (T, self.n_chan, self.n_pol)
            else:
                shape = (T, self.n_chan, self.n_pol, 2)
            offs = self._offsets(offset0, n_iter)
            if self.fold_model is not None:
                rows = torch.as_tensor(self.fold_model.table(
                    offset0 + np.arange(n_iter) * T, T), device=self.device)
            else:
                rows = self._fixed_foldv(offs)
            if self.use_kernels:
                steps = self._kernel_tables(offs, rows, ingest_bits)
            else:
                scales = 1.0 + 1e-6 * offs
        L = self._c_local * self.n_pol
        cache = {}
        made = {}

        def blocks_of(arrays):
            """The shards' blocks, (rows, L) on the kernel path, and the
            copies from pinned memory they wait on (``shard_async``'s
            pending, one an array)."""
            if guppi:
                grid, pending = shard_async(arrays[0], self.mesh,
                                            ("chan", "time"))
                with span("wideband.repack"):
                    planes = _map(grid, guppi_repack)
                return tuple(_map(planes, lambda p, k=k: p[k])
                             for k in (0, 1)), (pending,)
            grids, pending = zip(*(shard_async(a, self.mesh, ("time", "chan"))
                                   for a in arrays))
            if self.use_kernels:
                grids = [_map(g, lambda b: b.reshape(-1, L)) for g in grids]
            return tuple(grids), pending

        def run(seed=0, blocks=None):
            # nested in "wideband.call": the inputs ("mesh.shard" inside
            # blocks_of, then "wideband.repack" for GUPPI words),
            # "wideband.prep" (the chirps and edges, made on the first
            # call), one "wideband.step" a step, then, where blocks were
            # copied from pinned memory, "mesh.copy_wait" for those copies
            pending = ()
            with span("wideband.call"):
                try:
                    if blocks is None:
                        if seed not in cache:
                            cache[seed], pending = blocks_of(self._payload(
                                seed, shape, ingest_bits))
                        bases = cache[seed]
                    else:
                        dtype = torch.int32 if ingest_bits else torch.float32
                        bases, pending = blocks_of(
                            [self._as_input(b, shape, dtype)
                             for b in ((blocks,) if guppi else blocks)])
                    with span("wideband.prep"):
                        if self.use_kernels and not made:
                            made["chirps"] = [self._shard_chirp(
                                "planes", c, self.mesh.devices[t, c])
                                for t, c in self._cells]
                            made["edges"] = (self._on_device(
                                ("zero edges", ingest_bits),
                                lambda: self._run_edges(ingest_bits, bases))
                                if self.n_time_shards == 1 else None)
                    for k in range(n_iter):
                        with span("wideband.step"):
                            if self.use_kernels:
                                prof, cnt = self._kernel_step(
                                    ingest_bits, bases, made["chirps"],
                                    *steps[k], made["edges"])
                            else:
                                scale = scales[k]
                                prof, cnt = self._pairs_step(
                                    _map(bases[0],
                                         lambda b: b * scale.to(b.device)),
                                    self._shard_bins(rows[k]))
                            if k == 0:
                                acc, cnt_acc = prof, cnt
                            else:
                                acc += prof
                                cnt_acc = (cnt_acc.to(torch.int64)
                                           + cnt.to(torch.int64))
                    return acc, cnt_acc.to(torch.float32)
                finally:
                    # the caller may refill its pinned blocks on return,
                    # also when a step raised
                    if any(pending):
                        with span("mesh.copy_wait"):
                            for p in pending:
                                p.wait()

        return run

    @property
    def global_block(self):
        """Samples consumed per step across the whole mesh."""
        return self.block_samples * self.n_time_shards

    def example_inputs(self, seed=0):
        """Random inputs of :meth:`step_fn`'s shapes: the JAX package's
        numbers from ``np.random.default_rng(seed)``, a (global_block,
        n_chan, n_pol, 2) float32 tensor on the pipeline's device (the
        step shards it over the mesh), and a float32 zero offset."""
        rng = np.random.default_rng(seed)
        xf = rng.standard_normal(
            (self.global_block, self.n_chan, self.n_pol, 2)).astype(
                np.float32)
        return (torch.from_numpy(xf).to(self.device),
                torch.tensor(0.0, dtype=torch.float32, device=self.device))


def _map(grid, fn):
    """``fn`` of every block of an object grid (None where a cell is
    another process's)."""
    out = np.empty(grid.shape, dtype=object)
    for idx in grid_indices(grid.shape):
        if grid[idx] is not None:
            out[idx] = fn(grid[idx])
    return out
