"""One process of a multi-process check of the mesh layer.

Each process of a run starts this module with its rank:

    python -m baseband_tasks_tpu_torch.tools.multihost_check RANK WORLD \\
        RENDEZVOUS OUT MODE [DEVICES] [--backend gloo|nccl]

``RENDEZVOUS`` is ``host:port`` or a ``file://`` path shared by the
processes, ``DEVICES`` this process's devices, comma-separated
(``cpu,cpu``; ``cuda:0,cuda:0`` for two processes on one card; by
default ``multihost.pod_mesh``'s).  The process joins the group
(``multihost.initialize``), runs the set of checks ``MODE`` names and
writes their arrays to ``OUT`` with ``.r<RANK>`` before its suffix
(:func:`rank_file`).  ``MODE`` is ``cpu`` (the set below: every
multi-process entry point of the port against the same call on a mesh of
one process, at small shapes), ``cpu3`` (the primitives and
``ShardedPipeline`` over three processes), ``transport`` (the
collectives and a staging-slot stress on the given devices, e.g. two
processes on one card) or ``module:function``, a function of the
working directory's modules taking a :class:`Context` and returning a
dict of arrays.  Exit codes: 0 when the checks ran, 2 (after a line
``INIT_FAIL: ...``) only when the process group could not be
initialized, 1 on any other failure.

Each case of the ``cpu`` set saves ``<case>/multi`` (this run, joined on
rank 0 where a result is per process) and ``<case>/one`` (the same call
on a one-process mesh of the same shape over rank 0's devices), which
the caller compares; ``<case>/raised`` is 1 where a call had to raise.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import traceback

import numpy as np
import torch

__all__ = ["Context", "rank_file", "main", "CPU_CASES", "BUILTIN"]


def rank_file(out, rank):
    """The file rank ``rank`` writes for output ``out``."""
    stem, ext = os.path.splitext(out)
    return f"{stem}.r{rank}{ext or '.npz'}"


class Context:
    """What a check set gets: the rank, the world size, this process's
    devices, and meshes over every process's devices."""

    def __init__(self, rank, world, devices):
        from ..parallel import multihost
        self.rank, self.world = rank, world
        self.devices = devices
        self.multihost = multihost
        self._all = None

    def all_devices(self):
        """Every process's device list, in rank order."""
        if self._all is None:
            self._all = [None] * self.world
            torch.distributed.all_gather_object(self._all, self.devices)
        return self._all

    def shards(self, n):
        """``n`` shards of this process, cycling through its devices."""
        return [self.devices[k % len(self.devices)] for k in range(n)]

    def mesh(self, time, chan=1):
        """A (time, chan) mesh over every process's devices, rank-major
        (each process owns whole time rows): ``pod_mesh`` with
        ``time * chan / world`` shards a process."""
        return self.multihost.pod_mesh(
            time, chan, local_devices=self.shards(time * chan // self.world))

    def chan_mesh(self, time):
        """A (time, world) mesh whose chan axis crosses the processes:
        process ``c`` owns chan column ``c`` (its devices down the
        column)."""
        from ..parallel import Mesh
        lists = self.all_devices()
        devs = np.empty((time, self.world), dtype=object)
        for t in range(time):
            for c in range(self.world):
                devs[t, c] = lists[c][t % len(lists[c])]
        ids = np.tile(np.arange(self.world), (time, 1))
        return Mesh(devs, ("time", "chan"), process_ids=ids)

    def axis_mesh(self, name, n):
        """A one-axis mesh of ``n`` shards over every process's devices,
        rank-major."""
        from ..parallel import Mesh
        mesh = self.mesh(n, 1)
        return Mesh(mesh.devices.reshape(-1), (name,),
                    process_ids=mesh.process_ids.reshape(-1))

    def local_mesh(self, mesh):
        """A one-process mesh of ``mesh``'s shape over this process's
        devices (the reference), cycling through them."""
        from ..parallel import Mesh
        devs = self.shards(mesh.devices.size)
        return Mesh(np.asarray(devs, dtype=object).reshape(
            mesh.devices.shape), mesh.axis_names)

    def gather(self, grid, owners):
        """Every cell of an object grid of tensors on every process."""
        from ..parallel.mesh import gather_cells
        return gather_cells(grid, owners, device=self.devices[0])

    def gather_list(self, parts):
        """Each process's tensor, in rank order, on every process."""
        grid = np.empty(self.world, dtype=object)
        grid[self.rank] = parts
        return list(self.gather(grid, np.arange(self.world)))


def _np(t):
    return t.detach().cpu().numpy()


def _stack(grid):
    """An object grid (or a list) of tensors as one array, stacked."""
    cells = grid.flat if isinstance(grid, np.ndarray) else grid
    return np.stack([_np(t) for t in cells])


# -- the cpu set ----------------------------------------------------------

# tests/test_multihost.py's configurations (its worker's CONFIGS)
SMALL = dict(n_chan=8, n_pol=2, dm=0.5, period_samples=(512, 1), n_phase=8,
             block_samples=1024)
PRODUCTION = dict(n_chan=128, n_pol=2, dm=50.0, period_samples=(16000, 3),
                  n_phase=64, block_samples=1 << 16)


def normal_pairs(n, cfg, seed=0, chunk=1 << 22):
    """``np.random.default_rng(seed).standard_normal((n, n_chan, n_pol,
    2)).astype(np.float32)`` (the JAX tests' input), drawn in chunks so
    the float64 draw is never whole in memory."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, cfg["n_chan"], cfg["n_pol"], 2), np.float32)
    flat = out.reshape(-1)
    for k in range(0, flat.size, chunk):
        m = min(chunk, flat.size - k)
        flat[k:k + m] = rng.standard_normal(m)
    return out


def _pipe(mesh, cfg, **kw):
    from .. import WidebandPulsarPipeline, units as u
    return WidebandPulsarPipeline(freq_center=600 * u.MHz,
                                  chan_rate=250 * u.kHz, mesh=mesh,
                                  **cfg, **kw)


def _result(out, case, multi, one):
    out[f"{case}/multi"] = multi
    if one is not None:
        out[f"{case}/one"] = one


def _step_case(ctx, out, case, mesh, cfg, xf, *, local=None):
    """``step_fn`` of ``xf`` (float32 17 as the offset) on ``mesh``, the
    input given whole, or as this process's rows through ``host_local``
    (``local``), against a one-process mesh of the same shape."""
    pipe = _pipe(mesh, cfg)
    arg = xf if local is None else ctx.multihost.host_local(
        local, mesh, ("time", "chan"))
    prof, cnt = pipe.step_fn()(arg, np.float32(17))
    one = None
    if ctx.rank == 0:
        ref = _pipe(ctx.local_mesh(mesh), cfg).step_fn()(xf, np.float32(17))
        one = np.concatenate([_np(ref[0]).ravel(), _np(ref[1])])
    _result(out, case, np.concatenate([_np(prof).ravel(), _np(cnt)]), one)
    out[f"{case}/shape"] = np.asarray(prof.shape)
    out[f"{case}/samples"] = np.int64(pipe.global_block)


def cpu_flagship(ctx, out):
    """The (time, chan) flagship: the small configuration of
    tests/test_multihost.py through ``host_local`` (rank-major) and with
    the chan axis across processes; the production shapes; ``run_fn``
    packed, float and plain; ``step_bins_fn`` and ``planes_step``."""
    cfg = SMALL
    mesh = ctx.mesh(2, 2)
    T = 2 * _pipe(ctx.local_mesh(mesh), cfg).block_samples
    xf = normal_pairs(T, cfg)
    rows = T // ctx.world
    _step_case(ctx, out, "small", mesh, cfg, xf,
               local=xf[ctx.rank * rows:(ctx.rank + 1) * rows])
    _step_case(ctx, out, "small_chan", ctx.chan_mesh(2), cfg, xf)

    # production shapes: 4 time rows x 2 chan shards, 2 rows a process
    big = ctx.mesh(4, 2)
    xb = normal_pairs(_pipe(big, PRODUCTION).global_block, PRODUCTION)
    _step_case(ctx, out, "production", big, PRODUCTION, xb)
    del xb

    # run_fn on a (4, 1) mesh: packed words, float planes (the kernel
    # path's plain versions on the CPU) and the plain path
    mesh41 = ctx.mesh(4, 1)
    for case, kw, bits in (("run_packed", {"use_kernels": True}, 8),
                           ("run_float", {"use_kernels": True}, None),
                           ("run_stokes", {"use_kernels": True,
                                           "detect": "stokes"}, None),
                           ("run_plain", {}, None)):
        got = _pipe(mesh41, cfg, **kw).run_fn(2, ingest_bits=bits)(seed=3)
        ref = _pipe(ctx.local_mesh(mesh41), cfg, **kw).run_fn(
            2, ingest_bits=bits)(seed=3) if ctx.rank == 0 else None
        _result(out, case, np.concatenate([_np(got[0]).ravel(),
                                           _np(got[1])]),
                None if ref is None else np.concatenate(
                    [_np(ref[0]).ravel(), _np(ref[1])]))

    # step_bins_fn and planes_step on the (2, 2) mesh
    kern = _pipe(mesh, cfg, use_kernels=True)
    Tk = kern.global_block
    rng = np.random.default_rng(5)
    xk = rng.standard_normal((Tk, cfg["n_chan"], cfg["n_pol"], 2)).astype(
        np.float32)
    bins = (np.arange(Tk) * 7 % 64).astype(np.float32)
    x2 = np.ascontiguousarray(np.moveaxis(xk, -1, 0))
    for case, call in (
            ("step_bins", lambda p: p.step_bins_fn()(xk, bins)),
            ("planes_step", lambda p: p.planes_step(
                x2, *p._chirp_device(), 11.0, np.float32(17)))):
        got = call(kern)
        ref = call(_pipe(ctx.local_mesh(mesh), cfg, use_kernels=True)) \
            if ctx.rank == 0 else None
        _result(out, case, np.concatenate([_np(got[0]).ravel(),
                                           _np(got[1])]),
                None if ref is None else np.concatenate(
                    [_np(ref[0]).ravel(), _np(ref[1])]))

    # halo='remote' reads peers inside one process: a time ring across
    # processes is refused, one that a process holds whole is served
    try:
        _pipe(mesh, cfg, halo="remote")
        out["remote_across/raised"] = np.int64(0)
    except ValueError as exc:
        out["remote_across/raised"] = np.int64("ppermute" in str(exc))
    remote = _pipe(ctx.chan_mesh(2), cfg, halo="remote").step_fn()(
        xf, np.float32(17))
    _result(out, "remote_chan", np.concatenate(
        [_np(remote[0]).ravel(), _np(remote[1])]), None)


def cpu_primitives(ctx, out, n=4):
    """``halo_edges`` / ``halo_exchange`` (non-periodic and periodic),
    ``corner_turn``, ``sharded_channelize`` / ``sharded_dechannelize``
    and ``unshard`` on an (``n``, 2) mesh split rank-major, against one
    process."""
    from ..parallel import (corner_turn, halo_edges, halo_exchange,
                            sharded_channelize, sharded_dechannelize,
                            sharded_overlap_save, shard, unshard)
    from ..parallel.halo_remote import halo_edges_remote
    mesh = ctx.mesh(n, 2)
    ref_mesh = ctx.local_mesh(mesh)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((n * 96, 2 * 6, 3), generator=g)
    spec = ("time", "chan")
    for periodic in (False, True):
        tag = "periodic" if periodic else "open"
        got = halo_edges(shard(x, mesh, spec), 40, 24, periodic,
                         owners=mesh.process_ids)
        win = halo_exchange(shard(x, mesh, spec), 40, 24, periodic,
                            owners=mesh.process_ids)
        multi = [_stack(ctx.gather(g_, mesh.process_ids))
                 for g_ in (*got, win)]
        one = None
        if ctx.rank == 0:
            blocks = shard(x, ref_mesh, spec)
            one = [_stack(g_) for g_ in (
                *halo_edges(blocks, 40, 24, periodic),
                halo_exchange(blocks, 40, 24, periodic))]
        for k, name in enumerate(("front", "end", "window")):
            _result(out, f"halo_{tag}_{name}", multi[k],
                    None if one is None else one[k])
    try:
        halo_edges_remote(shard(x, mesh, spec), 40, 24,
                          owners=mesh.process_ids)
        out["halo_remote_across/raised"] = np.int64(0)
    except ValueError as exc:
        out["halo_remote_across/raised"] = np.int64("ppermute" in str(exc))
    _result(out, "unshard", _np(unshard(shard(x, mesh, spec), mesh, spec)),
            _np(x))

    def window_fn(w):
        # each output sample mixes its own sample with one 40 earlier
        return w[40:w.shape[0] - 24] + 0.5 * w[:w.shape[0] - 64]
    _result(out, "overlap_save",
            _np(sharded_overlap_save(window_fn, mesh, 40, 24)(x)),
            _np(sharded_overlap_save(window_fn, ref_mesh, 40, 24)(x)))

    # the corner turn over n time shards, split rank-major
    line = ctx.mesh(n, 1)
    spectra = torch.randn((n, 8, 4 * n, 2), generator=g,
                          dtype=torch.complex64)
    spectra = spectra.reshape(8 * n, 4 * n, 2)
    blocks = list(shard(spectra, line, ("time",))[:, 0])
    turned = corner_turn(blocks, owners=list(line.process_ids[:, 0]))
    grid = np.empty(n, dtype=object)
    for i, t in enumerate(turned):
        grid[i] = t
    multi = _stack(ctx.gather(grid, line.process_ids[:, 0]))
    one = _stack(corner_turn(list(shard(spectra, ctx.local_mesh(line),
                                        ("time",))[:, 0])))
    _result(out, "corner_turn", multi, one)
    raw = torch.randn((n * 16 * n, 3), generator=g, dtype=torch.complex64)
    chan = sharded_channelize(line, 4 * n)(raw)
    back = sharded_dechannelize(line)(chan)
    local = ctx.local_mesh(line)
    ref = sharded_channelize(local, 4 * n)(raw)
    _result(out, "channelize", _np(chan), _np(ref))
    _result(out, "dechannelize", _np(back),
            _np(sharded_dechannelize(local)(ref)))


def _config2_chain(n_samples=1 << 16, integrate=None, fold=None):
    """A config-2-like compiled chain on the CPU: 16 x 125 kHz complex
    channels, Dedisperse(29.7, 'pallas') -> Dechannelize, optionally
    -> Square -> Integrate(``integrate``), or -> Square -> Fold into 8
    phase bins of a ``fold`` Hz pulsar, 20 ms a profile (segment ids
    that cycle through the phase bins)."""
    from .. import (Dechannelize, Dedisperse, Fold, Integrate,
                    NoiseGenerator, SetAttribute, Square, Time, units as u)
    n_chan = 16
    t0 = Time.from_mjd(58000.0)
    freq = (1400 + (np.arange(n_chan) - n_chan / 2) * 0.125) * u.MHz
    src = SetAttribute(NoiseGenerator(
        shape=(n_samples, n_chan), start_time=t0,
        sample_rate=125 * u.kHz, samples_per_frame=2048, seed=1,
        device="cpu"), frequency=freq, sideband=1)
    tail = Dechannelize(Dedisperse(src, 29.7, samples_per_frame=4096,
                                   engine="pallas"))
    if integrate:
        tail = Integrate(Square(tail), integrate)
    if fold:
        def phase(t):
            return u.Quantity((t - t0).sec * fold, u.cycle)
        tail = Fold(Square(tail), 8, phase, 20 * u.ms, average=False)
    return tail


def _joined_chain(n_samples=1 << 15):
    """Two sources summed, then Dedisperse(1.0): a multi-input compiled
    graph with a padded stage after the join."""
    from .. import (CombineStreams, Dedisperse, NoiseGenerator,
                    SetAttribute, Time, units as u)
    srcs = [NoiseGenerator(shape=(n_samples, 4),
                           start_time=Time.from_mjd(58000.0),
                           sample_rate=1 * u.MHz, samples_per_frame=2048,
                           seed=seed, device="cpu") for seed in (4, 5)]
    joined = CombineStreams(srcs, lambda d: d[0] + d[1])
    return Dedisperse(SetAttribute(joined, frequency=600 * u.MHz,
                                   sideband=1), 1.0, samples_per_frame=4096)


def cpu_sharded(ctx, out, n=4, n_blocks=8, joined=True):
    """``ShardedPipeline`` over ``n`` time shards, split rank-major,
    against one process: a config-2-like chain, with an absorbed
    Integrate (whose bins straddle the processes' shards) and with an
    absorbed Fold (whose phase bins every shard adds to), and a
    two-source graph; ``compile(mesh=)`` on the mesh refused."""
    import warnings
    from ..base import FrameSizeWarning
    from ..models import CompiledPipeline, ShardedPipeline
    mesh = ctx.mesh(n, 1)
    warnings.simplefilter("ignore", FrameSizeWarning)
    cases = [("sharded", _config2_chain),
             ("sharded_integrate", lambda: _config2_chain(integrate=3000)),
             ("sharded_fold", lambda: _config2_chain(fold=123.456))]
    if joined:
        cases.append(("sharded_joined", _joined_chain))
    for case, make in cases:
        cp = CompiledPipeline(make())
        blocks = cp.read_source_blocks(n_blocks)
        got = ShardedPipeline(cp, mesh).run_blocks(blocks)
        one = ShardedPipeline(cp, ctx.local_mesh(mesh)).run_blocks(
            blocks) if ctx.rank == 0 else None
        if cp.reduction is not None:
            # (sums, counts): their bytes
            _result(out, case, np.concatenate(
                [_np(t).ravel().view(np.uint8) for t in got]),
                None if one is None else np.concatenate(
                    [_np(t).ravel().view(np.uint8) for t in one]))
            continue
        # each process's shards in global order: interleave them by
        # super-step (rank-major: the first shards here)
        parts = ctx.gather_list(got)
        shape = (-1, n // ctx.world, cp.tail_block) + tuple(
            parts[0].shape[1:])
        whole = torch.cat([p.reshape(shape) for p in parts], dim=1)
        whole = whole.reshape((-1,) + tuple(parts[0].shape[1:]))
        _result(out, case, _np(torch.view_as_real(whole)),
                None if one is None else _np(torch.view_as_real(one)))
    try:
        _config2_chain().compile(mesh=mesh)
        out["compile_mesh/raised"] = np.int64(0)
    except ValueError as exc:
        out["compile_mesh/raised"] = np.int64("several processes"
                                              in str(exc))


def cpu_searches(ctx, out):
    """The four sharded searches over 4 shards, 2 a process, against the
    same calls on a one-process mesh; a DM trial count that does not
    divide the shards is zero-padded (the port's divergence)."""
    from .. import units as u
    from ..models import (DMTrialSearch, FastFoldingSearch,
                          FourierDomainAccelSearch, RMSynthesis)
    rng = np.random.default_rng(11)
    n = 1 << 12
    x = (rng.standard_normal(n) + 0.2 * np.sin(
        2 * np.pi * 300.5 * np.arange(n) / n)).astype(np.float32)
    cases = {
        "accel": (lambda: FourierDomainAccelSearch(
            n, 1 * u.kHz, seg_len=1024, engine="pallas", device="cpu"),
            "z", lambda s, m: s.search_sharded(x, m)),
        "ffa": (lambda: FastFoldingSearch(20, n, device="cpu"), "batch",
                lambda s, m: s.snr_sharded(np.stack([x, -x, 2 * x]), m)),
        "dm": (lambda: DMTrialSearch(
            np.linspace(1400.0, 1500.0, 16) * u.MHz, 1000 * u.Hz,
            np.linspace(0.0, 100.0, 41), 256, device="cpu"), "dm",
            lambda s, m: s.search_sharded(np.abs(x.reshape(256, 16)), m)),
        "rm": (lambda: RMSynthesis(
            (100.0 + np.arange(32) * 50.0 / 32) * u.MHz,
            np.linspace(-20, 20, 161), device="cpu"), "phi",
            lambda s, m: s.fdf_sharded(x[:96].reshape(3, 32),
                                       x[96:192].reshape(3, 32), m)),
    }
    for case, (make, axis, call) in cases.items():
        mesh = ctx.axis_mesh(axis, 4)
        got = call(make(), mesh)
        one = call(make(), ctx.local_mesh(mesh)) if ctx.rank == 0 else None
        if got.is_complex():
            got = torch.view_as_real(got)
            one = None if one is None else torch.view_as_real(one)
        _result(out, f"search_{case}", _np(got),
                None if one is None else _np(one))


def cpu_initialize(ctx, out):
    """``initialize`` a second time is a no-op; the counts of the
    transport moved."""
    from ..parallel import _transport
    ctx.multihost.initialize("file:///nonexistent", ctx.world, ctx.rank)
    out["initialize_twice/multi"] = np.int64(
        ctx.multihost.process_count())
    out["transfers/multi"] = np.asarray(
        [_transport.transfer_counts["calls"],
         _transport.transfer_counts["bytes"]])


CPU_CASES = (cpu_flagship, cpu_primitives, cpu_sharded, cpu_searches,
             cpu_initialize)


def cpu(ctx):
    torch.set_num_threads(1)
    out = {}
    for case in CPU_CASES:
        case(ctx, out)
    return out


def transport_refill(ctx, out, n_calls=16, n=1 << 20):
    """Rank 0 sends rank 1 ``n_calls`` different tensors in consecutive
    calls while rank 1's stream is held busy, so each received copy
    waits behind device work when the next call's data arrives: a
    staging slot refilled before its copy ran would hand out the next
    call's bytes.  Rank 1 saves what it received and what was sent."""
    from ..parallel import _transport
    dev = torch.device(ctx.devices[0])
    like = torch.empty(n, device=dev)
    got, want = [], []
    for k in range(n_calls):
        sent = torch.randn(n, generator=torch.Generator().manual_seed(k))
        if ctx.rank == 1 and dev.type == "cuda":
            torch.cuda._sleep(20_000_000)       # ~10 ms of device time
        [recv] = _transport.send_recv(
            [(0, 1, sent.to(dev) if ctx.rank == 0 else like)])
        if ctx.rank == 1:
            got.append(recv)
            want.append(sent)
    if ctx.rank == 1:
        _result(out, "refill", _np(torch.stack(got)), _np(torch.stack(want)))


def transport(ctx):
    """The transport on this process's devices (``cuda:0`` twice for
    two processes on one card, over gloo's host staging): the halo
    exchange, the corner turn and the channelizers, the flagship step's
    reduction (its plain path: no kernel), each against one process,
    and :func:`transport_refill`."""
    out = {}
    cpu_primitives(ctx, out)
    g = torch.Generator().manual_seed(2)
    mesh = ctx.mesh(2, 2)
    T = 2 * _pipe(ctx.local_mesh(mesh), SMALL).block_samples
    xf = torch.randn((T, SMALL["n_chan"], SMALL["n_pol"], 2), generator=g)
    _step_case(ctx, out, "small", mesh, SMALL, xf.to(ctx.devices[0]))
    transport_refill(ctx, out)
    return out


def cpu3(ctx):
    """Three processes, one time shard each: the primitives on a (3, 2)
    mesh and ``ShardedPipeline`` over 3 shards, where every exchange has
    a process that is neither end of it."""
    torch.set_num_threads(1)
    out = {}
    cpu_primitives(ctx, out, n=3)
    cpu_sharded(ctx, out, n=3, n_blocks=6, joined=False)
    cpu_initialize(ctx, out)
    return out


BUILTIN = {"cpu": cpu, "cpu3": cpu3, "transport": transport}


def _check_set(mode):
    if mode in BUILTIN:
        return BUILTIN[mode]
    module, _, name = mode.partition(":")
    if not name:
        raise ValueError(f"mode {mode!r}: one of {sorted(BUILTIN)} "
                         f"or 'module:function'")
    if os.getcwd() not in sys.path:
        sys.path.insert(0, os.getcwd())
    return getattr(importlib.import_module(module), name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("rendezvous")
    ap.add_argument("out")
    ap.add_argument("mode")
    ap.add_argument("devices", nargs="?", default=None)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    from ..parallel import multihost
    devices = args.devices.split(",") if args.devices else \
        multihost._local_devices(None)
    try:
        multihost.initialize(args.rendezvous, args.world, args.rank,
                             backend=args.backend)
        if multihost.process_count() != args.world:
            raise RuntimeError(f"{multihost.process_count()} processes, "
                               f"want {args.world}")
    except Exception as exc:     # the group could not come up
        print(f"INIT_FAIL: {type(exc).__name__}: {exc}", flush=True)
        return 2
    try:
        ctx = Context(args.rank, args.world, devices)
        results = _check_set(args.mode)(ctx)
        np.savez(rank_file(args.out, args.rank), **results)
        torch.distributed.barrier()
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK rank={args.rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
