"""Device meshes, and sharding a tensor over them.

Counterpart of ``baseband_tasks_tpu/parallel/mesh.py``.  A JAX ``Mesh``
is one controller driving several devices through ``shard_map``; the port
keeps that model: a mesh is a named grid of ``torch.device``, driven by
one process.  A "sharded array" is an object array of the mesh's shape
holding each device's block on that device (:func:`shard`;
:func:`shard_async` leaves the copies from pinned host memory running on
each card's copy stream), and :func:`unshard` reassembles the global
tensor.  A device may appear several times in a mesh: several shards
then share one card (or the CPU), as the JAX tests put eight virtual
devices on one CPU.

A mesh may span processes (``multihost.pod_mesh``): ``process_ids`` holds
the rank that owns each cell, every process runs the same program on the
same mesh, and a process holds and computes the blocks of its own cells
only (:meth:`Mesh.local_cells`; the other cells of a sharded array are
None).  A mesh built without ``process_ids`` is wholly local to the
process that uses it.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..utils.profiling import span
from . import _transport

__all__ = ["Mesh", "make_mesh", "time_chan_specs", "default_devices",
           "axis_devices", "axis_owners", "axis_shards", "shard",
           "shard_async", "Pending", "unshard", "gather_cells", "join_parts"]


def grid_indices(shape):
    """Every index of an array of ``shape``, row-major (``np.ndindex``,
    which costs tens of microseconds a call, on the steps' host path)."""
    return itertools.product(*map(range, shape))


class Mesh:
    """A named grid of devices.

    ``devices`` : array-like of ``torch.device`` (or device strings), of
    one dimension per name in ``axis_names``.  ``shape`` maps each axis
    name to its size, as a JAX mesh's does.  ``process_ids`` : optional
    integer array of the grid's shape, the rank owning each cell (a mesh
    over several processes, ``multihost.pod_mesh``); a device named in
    another process's cell is that process's device.  Without it every
    cell is this process's (``process_ids`` is all 0 in one process).
    ``hosts`` : optional array of the grid's shape, the host name of each
    cell's process (``pod_mesh`` records them); None where not known.
    """

    def __init__(self, devices, axis_names, process_ids=None, hosts=None):
        names = tuple(axis_names)
        grid = _object_array(devices)
        if grid.ndim != len(names):
            raise ValueError(f"devices of shape {grid.shape} for axes "
                             f"{names}")
        self.devices = grid
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))
        me = _transport.process_index()
        ids = np.full(grid.shape, me, dtype=np.int64) \
            if process_ids is None \
            else np.asarray(process_ids, dtype=np.int64)
        if ids.shape != grid.shape:
            raise ValueError(f"process_ids of shape {ids.shape} for "
                             f"devices of shape {grid.shape}")
        self.process_ids = ids
        if hosts is not None:
            hosts = np.asarray(hosts, dtype=object)
            if hosts.shape != grid.shape:
                raise ValueError(f"hosts of shape {hosts.shape} for "
                                 f"devices of shape {grid.shape}")
        self.hosts = hosts
        self._local = ids == me
        self.spans_processes = not self._local.all()

    @property
    def size(self):
        return self.devices.size

    def is_local(self, idx):
        """Whether this process owns the cell at grid index ``idx``."""
        return bool(self._local[idx])

    def local_cells(self):
        """This process's cells, as grid indices in row-major order."""
        return [idx for idx in grid_indices(self.devices.shape)
                if self._local[idx]]

    @property
    def local_device(self):
        """This process's first device (its first cell's), where results
        joined over the mesh are put; the first device of a local mesh."""
        cells = self.local_cells()
        return self.devices[cells[0]] if cells else self.devices.flat[0]

    def __repr__(self):
        if self.spans_processes:
            return (f"Mesh({self.shape}, {list(self.devices.flat)}, "
                    f"process_ids={self.process_ids.tolist()})")
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _object_array(devices):
    """An object array of ``torch.device`` with the nesting of
    ``devices`` (device strings become devices)."""
    arr = np.asarray(devices, dtype=object)
    out = np.empty(arr.shape, dtype=object)
    for idx in grid_indices(arr.shape):
        out[idx] = torch.device(arr[idx])
    return out


def default_devices():
    """Every CUDA device, or the CPU where there is none (the entry-point
    rule of the port)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(time=1, chan=1, devices=None):
    """Build a (time, chan) mesh over the available devices.

    ``time`` shards the sample axis of overlap-save ops (halo exchange
    between neighbours); ``chan`` shards frequency channels (no
    communication).  Pass ``time=-1`` or ``chan=-1`` to absorb all
    remaining devices.  ``devices`` may list one device several times
    (e.g. ``[torch.device('cuda', 0)] * 4``).
    """
    devices = _object_array(list(devices) if devices is not None
                            else default_devices()).reshape(-1)
    time, chan = mesh_shape(devices.size, time, chan)
    return Mesh(devices[:time * chan].reshape(time, chan), ("time", "chan"))


def mesh_shape(n, time, chan):
    """(time, chan) of a mesh over ``n`` devices, ``-1`` absorbing the
    rest (:func:`make_mesh`'s rule)."""
    if time == -1 and chan == -1:
        raise ValueError("only one of time/chan may be -1")
    if time == -1:
        time = n // chan
    if chan == -1:
        chan = n // time
    if time < 1 or chan < 1:
        raise ValueError(f"mesh axes must be positive, got "
                         f"time={time}, chan={chan}")
    if time * chan > n:
        raise ValueError(f"mesh {time}x{chan} needs {time * chan} devices, "
                         f"have {n}")
    return time, chan


def time_chan_specs(mesh):
    """Standard partition specs for (samples, chan, pol[, pair]) blocks:
    a tuple of mesh-axis names (or None) per array dimension, as JAX's
    ``PartitionSpec`` lists them."""
    return {"data": ("time", "chan"), "per_chan": (None, "chan"),
            "profile": (None, "chan")}


def axis_devices(mesh, axis_name):
    """The devices along ``axis_name``, at index 0 of the other axes (what
    is split on one axis is replicated over the others)."""
    axis = mesh.axis_names.index(axis_name)
    take = tuple(slice(None) if i == axis else 0
                 for i in range(mesh.devices.ndim))
    return list(mesh.devices[take])


def axis_owners(mesh, axis_name):
    """The ranks owning the cells of :func:`axis_devices`."""
    axis = mesh.axis_names.index(axis_name)
    take = tuple(slice(None) if i == axis else 0
                 for i in range(mesh.devices.ndim))
    return [int(r) for r in mesh.process_ids[take]]


def block_index(spec, shape, mesh, idx):
    """The slices of an array of ``shape`` held at grid index ``idx``."""
    coord = dict(zip(mesh.axis_names, idx))
    out = []
    for dim, name in enumerate(spec):
        if name is None:
            out.append(slice(None))
            continue
        n = mesh.shape[name]
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {shape[dim]} does "
                             f"not divide over mesh axis {name!r} ({n})")
        k = shape[dim] // n
        i = coord[name]
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


class Pending:
    """The host-to-card copies :func:`shard_async` issued: each copy's
    event, and its pinned source, held until :meth:`wait`.  Empty (false)
    where nothing was issued."""

    def __init__(self):
        self._events = []
        self._sources = []

    def __bool__(self):
        return bool(self._events)

    def add(self, event, source):
        self._events.append(event)
        self._sources.append(source)

    def wait(self):
        """Block the host until every copy has read its source (each
        copy's event, never a stream); then the sources may be refilled.
        A no-op when nothing was issued."""
        for event in self._events:
            event.synchronize()
        self._events.clear()
        self._sources.clear()


_COPY_STREAMS = {}


def _copy_stream(device):
    """The one copy stream of a CUDA ``device``, made at first use."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _COPY_STREAMS:
        _COPY_STREAMS[index] = torch.cuda.Stream(index)
    return _COPY_STREAMS[index]


def _to_device(block, device, pending):
    """``block`` on ``device`` as a contiguous tensor.  A contiguous
    pinned block bound for a CUDA device is copied on the device's copy
    stream, which the device's current stream waits for, and the copy is
    added to ``pending``; anything else is copied on the current stream
    (the host waits where ``.to`` does)."""
    if not (device.type == "cuda" and block.device.type == "cpu"
            and block.is_contiguous() and block.is_pinned()):
        return block.to(device).contiguous()
    stream = _copy_stream(device)
    with torch.cuda.stream(stream):
        out = block.to(device, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    compute = torch.cuda.current_stream(device)
    compute.wait_event(done)
    out.record_stream(compute)
    pending.add(done, block)
    return out


def shard_async(x, mesh, spec):
    """:func:`shard`, without waiting for the copies from pinned memory:
    ``(grid, pending)``.  Each contiguous block of a pinned ``x`` bound for
    a CUDA device is copied on that device's copy stream, and the device's
    current stream waits for the copy, so the copy runs under the kernels
    already queued there.  ``x`` may be refilled only after
    ``pending.wait()``, which blocks the host on those copies alone.  Other
    blocks (on a device already, pageable, a non-contiguous view) are
    copied as :func:`shard` copies them, and add nothing to ``pending``."""
    pending = Pending()
    with span("mesh.shard"):
        x = torch.as_tensor(x)
        out = np.empty(mesh.devices.shape, dtype=object)
        for idx in mesh.local_cells():
            block = x[block_index(spec, x.shape, mesh, idx)]
            out[idx] = _to_device(block, mesh.devices[idx], pending)
    return out, pending


def shard(x, mesh, spec):
    """Split ``x`` (a tensor or numpy) over ``mesh`` by ``spec`` (one
    mesh-axis name or None per leading dimension; axes not named are
    replicated): an object array of the mesh's shape holding each
    device's contiguous block on that device.  A block that is the whole
    of ``x`` on its own device is ``x`` itself.  On a mesh over several
    processes every process passes the same global ``x`` (as to JAX's
    ``device_put``) and gets the blocks of its own cells; the others are
    None.  When it returns, ``x`` may be refilled: a copy from pinned
    memory (:func:`shard_async`) has been waited for, the kernels queued
    on the device have not."""
    grid, pending = shard_async(x, mesh, spec)
    pending.wait()
    return grid


def unshard(blocks, mesh, spec, device=None):
    """The global tensor of a sharded array (the inverse of :func:`shard`),
    on ``device`` (default: the mesh's first local device).  Replicated
    axes take the blocks at index 0.  On a mesh over several processes
    every process calls it and gets the whole tensor (the other
    processes' blocks are gathered)."""
    device = torch.device(device) if device is not None \
        else mesh.local_device
    grid = np.asarray(blocks, dtype=object)
    named = {name: dim for dim, name in enumerate(spec) if name is not None}
    # index 0 along every mesh axis the spec does not split
    take = tuple(slice(None) if name in named else slice(0, 1)
                 for name in mesh.axis_names)
    grid = gather_cells(grid[take], mesh.process_ids[take], device=device)
    axes = [name for name in mesh.axis_names if name in named]
    grid = grid.reshape([mesh.shape[name] for name in axes])

    def join(g, level):
        if level == len(axes):
            return g.to(device)
        return torch.cat([join(g[i], level + 1) for i in range(g.shape[0])],
                         dim=named[axes[level]])
    return join(grid[()] if not axes else grid, 0)


def gather_cells(grid, owners, device=None, like=None):
    """Every cell of an object grid, on every process of ``owners`` (a
    rank per cell): the cells this process holds as they are, the others
    received from their owners, in cell order.
    Received blocks land on ``device`` in the sender's shape and dtype,
    or, given ``like`` (a tensor), in its shape, dtype and device, which
    saves the shape exchange.  Every process of ``owners`` calls it."""
    grid = np.asarray(grid, dtype=object)
    owners = np.asarray(owners)
    me = _transport.process_index()
    ranks = sorted({int(r) for r in owners.flat})
    cells = list(grid_indices(grid.shape))
    pairs, where = [], []
    for idx in cells:
        src = int(owners[idx])
        for dst in ranks:
            if dst != src:
                t = grid[idx] if src == me else like
                pairs.append((src, dst, t))
                where.append(idx)
    got = _transport.send_recv(pairs, shapes=like is None, device=device)
    out = grid.copy()
    for idx, (_, dst, _), t in zip(where, pairs, got):
        if dst == me:
            out[idx] = t
    return out


def axis_shards(mesh, axis_name):
    """``(devices, owners, local)`` along ``axis_name``: the devices, the
    ranks owning them and whether
    each is this process's.  A process must own one shard at least."""
    devices = axis_devices(mesh, axis_name)
    owners = axis_owners(mesh, axis_name)
    me = _transport.process_index()
    local = [r == me for r in owners]
    if not any(local):
        raise ValueError(f"this process owns no shard along mesh axis "
                         f"{axis_name!r}")
    return devices, owners, local


def join_parts(parts, owners, dim):
    """The shards' parts (None for other processes') joined along ``dim``
    in shard order on this process's first shard's device, every part
    received where another process computed it (every part has one shape
    and dtype)."""
    mine = [p for p in parts if p is not None]
    home = mine[0].device
    grid = np.empty(len(parts), dtype=object)
    for i, p in enumerate(parts):
        grid[i] = p
    parts = list(gather_cells(grid, owners, like=mine[0]))
    return torch.cat([p.to(home) for p in parts], dim=dim)
