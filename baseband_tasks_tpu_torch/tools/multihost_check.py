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
processes on one card), ``remote`` (``halo='remote'`` across the
processes on the given devices, the push form through CUDA IPC on
cards) or ``module:function``, a function of the
working directory's modules taking a :class:`Context` and returning a
dict of arrays.  Exit codes: 0 when the checks ran, 2 (after a line
``INIT_FAIL: ...``) only when the process group could not be
initialized, 1 on any other failure.

Each case of the ``cpu`` set saves ``<case>/multi`` (this run, joined on
rank 0 where a result is per process) and ``<case>/one`` (the same call
on a one-process mesh of the same shape over rank 0's devices), which
the caller compares; the ``halo='remote'`` cases also save
``<case>/ppermute`` (the same call with the copies of ``'ppermute'``);
``<case>/raised`` is 1 where a call had to raise.
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

    def owned_mesh(self, ids):
        """A (time, chan) mesh whose cell ``idx`` belongs to rank
        ``ids[idx]``, each process's devices cycled through its cells."""
        from ..parallel import Mesh
        lists = self.all_devices()
        ids = np.asarray(ids)
        devs = np.empty(ids.shape, dtype=object)
        used = [0] * self.world
        for idx in np.ndindex(ids.shape):
            r = int(ids[idx])
            devs[idx] = lists[r][used[r] % len(lists[r])]
            used[r] += 1
        return Mesh(devs, ("time", "chan"), process_ids=ids)

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


def _step_case(ctx, out, case, mesh, cfg, xf, *, local=None, **kw):
    """``step_fn`` of ``xf`` (float32 17 as the offset) on ``mesh``, the
    input given whole, or as this process's rows through ``host_local``
    (``local``), against a one-process mesh of the same shape; ``kw``
    the pipeline's keywords."""
    pipe = _pipe(mesh, cfg, **kw)
    arg = xf if local is None else ctx.multihost.host_local(
        local, mesh, ("time", "chan"))
    prof, cnt = pipe.step_fn()(arg, np.float32(17))
    pipe.close()
    one = None
    if ctx.rank == 0:
        ref = _pipe(ctx.local_mesh(mesh), cfg, **kw).step_fn()(
            xf, np.float32(17))
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

    # halo='remote' on time rings across the processes (the push form;
    # on CPU shards its plain copies) against one process and against
    # 'ppermute' (the cases above), and on rings each process holds whole
    _step_case(ctx, out, "remote_across", mesh, cfg, xf, halo="remote",
               local=xf[ctx.rank * rows:(ctx.rank + 1) * rows])
    out["remote_across/ppermute"] = out["small/multi"]
    out["remote_across/shape"] = out["small/shape"]
    out["remote_across/samples"] = out["small/samples"]
    _step_case(ctx, out, "remote_step_kernels", mesh, cfg, xk,
               use_kernels=True, halo="remote")
    kern = _pipe(mesh, cfg, use_kernels=True)
    got = kern.step_fn()(xk, np.float32(17))
    out["remote_step_kernels/ppermute"] = np.concatenate(
        [_np(got[0]).ravel(), _np(got[1])])
    remote = _pipe(mesh41, cfg, use_kernels=True, halo="remote")
    got = remote.run_fn(2)(seed=3)
    remote.close()
    ref = _pipe(ctx.local_mesh(mesh41), cfg, use_kernels=True,
                halo="remote").run_fn(2)(seed=3) if ctx.rank == 0 else None
    _result(out, "remote_run_float", np.concatenate(
        [_np(got[0]).ravel(), _np(got[1])]), None if ref is None else
        np.concatenate([_np(ref[0]).ravel(), _np(ref[1])]))
    out["remote_run_float/ppermute"] = out["run_float/multi"]
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
    got = halo_edges_remote(shard(x, mesh, spec), 40, 24,
                            owners=mesh.process_ids)
    _result(out, "halo_remote_across", np.concatenate(
        [_stack(ctx.gather(g_, mesh.process_ids)).ravel() for g_ in got]),
        None if ctx.rank else np.concatenate([_stack(g_).ravel() for g_ in
                                              halo_edges_remote(shard(
                                                  x, ref_mesh, spec), 40,
                                                  24)]))
    out["halo_remote_across/ppermute"] = np.concatenate(
        [out["halo_open_front/multi"].ravel(),
         out["halo_open_end/multi"].ravel()])
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


def remote_cases(ctx, out, meshes, rows=96, pads=(40, 24), x=None):
    """``halo_edges_remote`` and ``halo_exchange_remote`` with ``owners``,
    non-periodic and periodic, on each of ``meshes`` (name -> mesh)
    against one process and against ``'ppermute'`` (``halo_edges`` /
    ``halo_exchange`` with the same owners): cases ``remote_<periodicity>
    _<name>``, each the front, end and window stacks flattened; the
    ``halo_remote`` launches of this process in ``<case>/launches``.
    Then a ring across two hosts, given to the check by name:
    ``remote_hosts/raised``."""
    from ..ops._build import launch_counts
    from ..parallel import halo_edges, halo_exchange, shard
    from ..parallel.halo_remote import (check_hosts, halo_edges_remote,
                                        halo_exchange_remote)
    spec = ("time", "chan")

    def flat(grids, ids):
        return np.concatenate([_stack(ctx.gather(g_, ids)).ravel()
                               for g_ in grids])
    for name, mesh in meshes.items():
        n = mesh.devices.shape[0]
        if x is None:
            g = torch.Generator().manual_seed(n + 7)
            data = torch.randn((n * rows, 2 * 6, 3), generator=g)
        else:
            data = x[:n * rows]
        ids = mesh.process_ids
        for periodic in (False, True):
            case = f"remote_{'periodic' if periodic else 'open'}_{name}"
            blocks = shard(data, mesh, spec)
            before = launch_counts["halo_remote"]
            got = (*halo_edges_remote(blocks, *pads, periodic, owners=ids),
                   halo_exchange_remote(blocks, *pads, periodic, owners=ids))
            out[f"{case}/launches"] = np.int64(launch_counts["halo_remote"]
                                               - before)
            pp = (*halo_edges(blocks, *pads, periodic, owners=ids),
                  halo_exchange(blocks, *pads, periodic, owners=ids))
            one = None
            if ctx.rank == 0:
                ref = shard(data, ctx.local_mesh(mesh), spec)
                one = np.concatenate([_stack(g_).ravel() for g_ in (
                    *halo_edges_remote(ref, *pads, periodic),
                    halo_exchange_remote(ref, *pads, periodic))])
            _result(out, case, flat(got, ids), one)
            out[f"{case}/ppermute"] = flat(pp, ids)
    line = next(iter(meshes.values()))
    hosts = np.where(line.process_ids == 0, "host-a", "host-b")
    try:
        check_hosts(line.process_ids, hosts)
        out["remote_hosts/raised"] = np.int64(0)
    except ValueError as exc:
        out["remote_hosts/raised"] = np.int64("ppermute" in str(exc))


def remote_meshes(ctx):
    """The meshes of :func:`remote_cases`: rings across the processes on
    a (2W, 1) line ((4, 1) for two processes) and a (2, 2) grid ((3, 2)
    for three), every ring whole with the chan axis across the processes,
    and (two processes) one ring whole beside one across them."""
    meshes = {"line": ctx.mesh(2 * ctx.world, 1),
              "grid": ctx.mesh(2 if ctx.world == 2 else ctx.world, 2),
              "chan": ctx.chan_mesh(2)}
    if ctx.world == 2:
        meshes["mixed"] = ctx.owned_mesh([[0, 0], [0, 1], [0, 1]])
    return meshes


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


def cpu_remote(ctx, out):
    remote_cases(ctx, out, remote_meshes(ctx))


CPU_CASES = (cpu_flagship, cpu_primitives, cpu_remote, cpu_sharded,
             cpu_searches, cpu_initialize)


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


# the card tests' flagship (tests/test_torch_cuda.py's sharded pipeline)
CARD = dict(n_chan=8, n_pol=2, dm=1.0, period_samples=(800, 1), n_phase=16,
            block_samples=1024)


def remote_pipeline(ctx, out, cfg=CARD, n_iter=3):
    """The flagship with ``halo='remote'`` on time rings across the
    processes, against 'ppermute' in the same processes: the float
    ``run_fn`` on (4, 1) (edges of its payload bit for bit, its profiles
    and counts, the ``halo_remote`` launches and the transport's bytes
    beside what the profiles' gather sends) and ``step_fn`` on (2, 2) on
    both paths (bit for bit)."""
    from ..ops._build import launch_counts, reset_launch_counts
    from ..parallel import _transport, shard
    mesh = ctx.mesh(4, 1)
    cells = mesh.local_cells()
    pipes = {h: _pipe(mesh, cfg, use_kernels=True, halo=h)
             for h in ("remote", "ppermute")}
    pipe = pipes["remote"]
    shape = (pipe.global_block, cfg["n_chan"], cfg["n_pol"])
    planes = [shard(b, mesh, ("time", "chan"))
              for b in pipe._payload(0, shape, None)]
    same = []
    for p in planes:
        a, b = (pipes[h]._halo_edges(p) for h in ("remote", "ppermute"))
        same += [torch.equal(x[cell], y[cell]) for x, y in zip(a, b)
                 for cell in cells]
    out["run/edges_same"] = np.int64(all(same))
    runs = {h: q.run_fn(n_iter) for h, q in pipes.items()}
    runs["remote"](seed=0)              # the payload and the mailboxes
    reset_launch_counts()
    _transport.reset_transfer_counts()
    got = runs["remote"](seed=0)
    out["run/launches"] = np.int64(launch_counts["halo_remote"])
    out["run/bytes"] = np.int64(_transport.transfer_counts["bytes"])
    out["run/profile_bytes"] = np.int64(n_iter * len(cells) * pipe.n_phase
                                        * (pipe._c_local * pipe.n_pol + 1)
                                        * 4 * (ctx.world - 1))
    ref = runs["ppermute"](seed=0)
    out["run/prof"], out["run/cnt"] = (_np(t) for t in got)
    out["run/pp_prof"], out["run/pp_cnt"] = (_np(t) for t in ref)
    for q in pipes.values():
        q.close()
    mesh = ctx.mesh(2, 2)
    dev = ctx.devices[0]
    for kernels in (False, True):
        case = f"step_{'kernels' if kernels else 'plain'}"
        steps = {h: _pipe(mesh, cfg, use_kernels=kernels, halo=h)
                 for h in ("remote", "ppermute")}
        T = steps["remote"].global_block
        xf = torch.randn((T, cfg["n_chan"], cfg["n_pol"], 2),
                         generator=torch.Generator().manual_seed(46)).to(dev)
        reset_launch_counts()
        a = steps["remote"].step_fn()(xf, 300)
        out[f"{case}/launches"] = np.int64(launch_counts["halo_remote"])
        b = steps["ppermute"].step_fn()(xf, 300)
        out[f"{case}/multi"] = np.concatenate([_np(a[0]).ravel(),
                                               _np(a[1])])
        out[f"{case}/ppermute"] = np.concatenate([_np(b[0]).ravel(),
                                                  _np(b[1])])
        for q in steps.values():
            q.close()


def remote_stress(ctx, out, n_calls=64, rows=4096, lanes=128,
                  pads=(512, 768)):
    """``n_calls`` consecutive exchanges on (4, 1), new data each call,
    with rank 1's stream held busy before each (so rank 0 runs ahead and
    a mailbox slot reused before it was copied out would hand out a later
    call's edges); each process holds every edge it got against the
    slices of the data it expects, at the end."""
    from ..parallel import shard
    from ..parallel.halo_remote import halo_edges_remote
    mesh = ctx.mesh(4, 1)
    dev = torch.device(ctx.devices[0])
    n = mesh.devices.shape[0]
    got, want = [], []
    for k in range(n_calls):
        g = torch.Generator(device=dev).manual_seed(100 + k)
        x = torch.randn((n * rows, lanes), generator=g, device=dev)
        if ctx.rank == 1 and dev.type == "cuda":
            torch.cuda._sleep(2_000_000)        # ~1 ms of its stream
        front, end = halo_edges_remote(shard(x, mesh, ("time", "chan")),
                                       *pads, owners=mesh.process_ids)
        for t, c in mesh.local_cells():
            got += [front[t, c], end[t, c]]
            zeros = torch.zeros((0, lanes), device=dev)
            want += [x[t * rows - pads[0]:t * rows] if t > 0
                     else zeros.new_zeros((pads[0], lanes)),
                     x[(t + 1) * rows:(t + 1) * rows + pads[1]] if t < n - 1
                     else zeros.new_zeros((pads[1], lanes))]
    out["stress/calls"] = np.int64(n_calls)
    out["stress/bad"] = np.int64(sum(not torch.equal(a, b)
                                     for a, b in zip(got, want)))


def remote(ctx):
    """``halo='remote'`` across the processes on their devices (two
    processes on one card, or a card each): :func:`remote_cases`,
    :func:`remote_pipeline` and :func:`remote_stress`."""
    out = {}
    remote_cases(ctx, out, remote_meshes(ctx))
    remote_pipeline(ctx, out)
    remote_stress(ctx, out)
    return out


def cpu3(ctx):
    """Three processes, one time shard each: the primitives on a (3, 2)
    mesh and ``ShardedPipeline`` over 3 shards, where every exchange has
    a process that is neither end of it."""
    torch.set_num_threads(1)
    out = {}
    cpu_primitives(ctx, out, n=3)
    cpu_remote(ctx, out)
    cpu_sharded(ctx, out, n=3, n_blocks=6, joined=False)
    cpu_initialize(ctx, out)
    return out


BUILTIN = {"cpu": cpu, "cpu3": cpu3, "transport": transport,
           "remote": remote}


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
        # the IPC mailboxes closed everywhere before any is freed
        multihost.shutdown()
    print(f"MULTIHOST_OK rank={args.rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
