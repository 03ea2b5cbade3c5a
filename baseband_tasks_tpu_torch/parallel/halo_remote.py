"""In-kernel halo exchange: overlap-save edges copied by one kernel.

Counterpart of ``baseband_tasks_tpu/parallel/halo_pallas.py``.  There the
edges ride ICI from inside a Pallas kernel as async remote DMAs
(``_halo_kernel``), instead of an XLA ``ppermute`` collective.  Here the
kernel is ``halo_remote`` (``csrc/halo.cu``): one launch per destination
device covers every shard on that device, whatever its time ring, and
pulls each shard's edges from its neighbours' blocks (peer reads when a
neighbour lives on another card), writing the zeros of a non-periodic
ring's two ends itself.

The contract is :func:`..parallel.halo.halo_edges`' along axis 0:
``blocks`` are the per-shard blocks of a time ring (a sequence in ring
order, or an object array whose first axis is the ring and whose other
axes are independent rings, e.g. a mesh's (time, chan) grid); the result
is each shard's ``(front, end)``.  CUDA shards launch the kernel or
raise; CPU shards (and the tests' ``plain_versions()``) take the plain
version :func:`halo_edges_remote_ref`, the copies of ``halo_edges``.
Every launch adds one to ``launch_counts['halo_remote']``.

On a mesh over several processes (``owners``, the rank of each block;
every process calls with the same ``owners``) a ring that one process
holds whole keeps this pull form.  A time ring that crosses the
processes of one host takes the kernel's push form (``parallel/_ipc.py``):
each process's launch writes the edges it sends straight into the
receiving process's device memory, mapped through CUDA IPC, and the two
processes' streams order themselves on flags in device memory, with no
host call in the path (the process group is used once per layout, to
exchange the handles).  CPU shards, and the tests' ``plain_versions()``,
take the plain version there too: the copies of ``halo_edges(...,
owners=)``, through the process group.  A ring whose neighbours are on
different hosts is refused, naming ``halo='ppermute'``: the TPU's remote
DMA crosses hosts, CUDA IPC does not, and the port has no RDMA path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops._build import launch, library
from ..ops.dedisperse import _plain
from . import _ipc, _transport
from .halo import _check_pads, from_grid, halo_edges, ring_grid
from .mesh import grid_indices

__all__ = ["halo_edges_remote", "halo_exchange_remote",
           "halo_edges_remote_ref", "mesh_logical_id", "local_rings",
           "crossing_rings", "check_hosts", "MAX_SHARDS"]

#: shards one launch can address (the kernel's table of block pointers)
MAX_SHARDS = 64


def mesh_logical_id(axis_order, axis_name, idx, coords):
    """Logical id of the device at mesh coordinates ``coords`` (a dict of
    axis name -> index) with the ``axis_name`` coordinate replaced by
    ``idx``: the row-major flattening of the coordinates in the order of
    ``axis_order`` (((name, size), ...), the mesh's axes).  The kernel's
    slot table is laid out in this order, and a shard's time neighbour is
    the slot with the time coordinate moved by one."""
    lid = 0
    for name, size in axis_order:
        lid = lid * size + (idx if name == axis_name else coords[name])
    return lid


def halo_edges_remote_ref(blocks, pad_start, pad_end, periodic=False,
                          owners=None):
    """Plain version: the copies of :func:`..parallel.halo.halo_edges`
    (through the process group where ``owners`` puts two neighbours in
    different processes)."""
    return halo_edges(blocks, pad_start, pad_end, periodic, axis=0,
                      owners=owners)


def _check_blocks(blocks):
    first = blocks[0]
    for b in blocks:
        if b.shape != first.shape or b.dtype != first.dtype:
            raise ValueError("every shard's block must share one shape and "
                             f"dtype, got {tuple(b.shape)} {b.dtype} and "
                             f"{tuple(first.shape)} {first.dtype}")
        if not b.is_contiguous():
            raise ValueError("halo_remote needs contiguous blocks")
    return first


def _fence(src_devices, dst):
    """Order ``dst``'s current stream after each source device's."""
    stream = torch.cuda.current_stream(dst)
    for src in src_devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(src))
        stream.wait_event(event)


def _peer_ready(dst, srcs):
    """Let ``dst`` read each source card's memory, or raise."""
    for src in srcs:
        if not torch.cuda.can_device_access_peer(dst, src):
            raise RuntimeError(f"halo_remote: cuda:{dst} cannot read "
                               f"cuda:{src} (no peer access); use "
                               f"halo='ppermute'")
        err = library().bbt_enable_peer(dst, src)
        if err:
            raise RuntimeError(f"enabling peer access cuda:{dst} -> "
                               f"cuda:{src} failed with CUDA error {err}")


def _addresses(values):
    return (ctypes.c_longlong * len(values))(*values)


def _ring_ranks(owners):
    return ring_grid(np.asarray(owners, dtype=object)).astype(np.int64)


def local_rings(owners):
    """The rings (columns of the ring grid of ``owners``) this process
    holds whole."""
    ranks = _ring_ranks(owners)
    me = _transport.process_index()
    return [r for r in range(ranks.shape[1]) if (ranks[:, r] == me).all()]


def crossing_rings(owners):
    """The rings whose shards belong to more than one process."""
    ranks = _ring_ranks(owners)
    return [r for r in range(ranks.shape[1])
            if (ranks[:, r] != ranks[0, r]).any()]


def check_hosts(owners, hosts):
    """Raise, naming ``halo='ppermute'``, where a ring's neighbours
    belong to processes on different hosts: ``owners`` the rank of each
    shard, ``hosts`` the host name of each (``Mesh.hosts``, in the same
    form; None: not known, nothing checked).  A ring over two hosts has
    such neighbours whether it wraps or not."""
    if hosts is None:
        return
    ranks = _ring_ranks(owners)
    names = ring_grid(np.asarray(hosts, dtype=object))
    by_rank = {int(k): h for k, h in zip(ranks.flat, names.flat)}
    _ipc.check_reach(_ipc.Plan(ranks, 1, 1, False, 1, me=0).pairs(),
                     by_rank)


def halo_edges_remote(blocks, pad_start, pad_end, periodic=False,
                      owners=None, mailboxes=None):
    """Each shard's (front, end) edge buffers along axis 0, by the
    ``halo_remote`` kernel on CUDA shards (the plain copies on CPU
    shards): ``pad_start`` rows from the left neighbour's tail and
    ``pad_end`` from the right neighbour's head, zeros at non-periodic
    boundaries.  Semantics of :func:`..parallel.halo.halo_edges`;
    ``owners`` (a rank per block, the same on every process): a mesh over
    several processes (see the module docstring), whose results are None
    at other processes' shards; ``mailboxes``: the :class:`._ipc.Mailboxes`
    holding the push form's channels (by default the module's)."""
    if owners is not None:
        return _on_local_rings(blocks, owners, pad_start, pad_end, periodic,
                               mailboxes or _ipc.default_mailboxes())
    grid = ring_grid(blocks)
    n_time, n_rings = grid.shape
    # row-major over (time, ring): slot s is the shard of logical id
    # mesh_logical_id((("time", n_time), ("ring", n_rings)), "time", t,
    # {"ring": r}) = t * n_rings + r, the kernel's table order
    flat = list(grid.flat)
    first = _check_blocks(flat)
    local_n = first.shape[0]
    _check_pads(local_n, pad_start, pad_end, n_time, periodic)
    types = {b.device.type for b in flat}
    if types == {"cpu"} or (types == {"cuda"} and _plain.get()):
        return halo_edges_remote_ref(blocks, pad_start, pad_end, periodic)
    if types != {"cuda"}:
        raise ValueError(f"halo_remote: shards on {sorted(types)}; the "
                         f"kernel needs every shard on a CUDA device")
    if len(flat) > MAX_SHARDS:
        raise ValueError(f"halo_remote addresses at most {MAX_SHARDS} "
                         f"shards, got {len(flat)}")
    rest = tuple(first.shape[1:])
    row_bytes = first.element_size() * (first.numel() // local_n
                                        if local_n else 0)
    index = [b.device.index for b in flat]
    front = np.empty(len(flat), dtype=object)
    end = np.empty(len(flat), dtype=object)
    src = None
    for dst in dict.fromkeys(index):
        mine = [s for s in range(len(flat)) if index[s] == dst]
        # one buffer for the edges of every shard on this card
        buf = torch.empty((len(mine), pad_start + pad_end) + rest,
                          dtype=first.dtype, device=flat[mine[0]].device)
        for j, s in enumerate(mine):
            front[s] = buf[j, :pad_start]
            end[s] = buf[j, pad_start:]
        if not (pad_start or pad_end) or not row_bytes:
            continue
        if src is None:
            src = _addresses([b.data_ptr() for b in flat])
        others = sorted(set(index) - {dst})
        _peer_ready(dst, others)
        _fence(others, dst)
        launch("halo_remote", "bbt_halo_edges", flat[mine[0]].device, src,
               _addresses([front[s].data_ptr() if index[s] == dst else 0
                           for s in range(len(flat))]),
               _addresses([end[s].data_ptr() if index[s] == dst else 0
                           for s in range(len(flat))]),
               n_time, n_rings, local_n, pad_start, pad_end, row_bytes,
               int(bool(periodic)))
        # the sources' later work (a freed block reused) waits for the
        # reads
        for src_dev in others:
            _fence([dst], src_dev)
    return (from_grid(front.reshape(grid.shape), blocks),
            from_grid(end.reshape(grid.shape), blocks))


def _on_local_rings(blocks, owners, pad_start, pad_end, periodic,
                    mailboxes):
    """:func:`halo_edges_remote` over several processes: the pull form on
    the rings this process holds whole, the push form (or the plain
    copies) on the rings that cross processes."""
    grid = ring_grid(blocks)
    ranks = _ring_ranks(owners)
    front = np.empty(grid.shape, dtype=object)
    end = np.empty(grid.shape, dtype=object)
    whole = local_rings(owners)
    if whole:
        f, e = halo_edges_remote(grid[:, whole], pad_start, pad_end,
                                 periodic)
        front[:, whole], end[:, whole] = f, e
    across = crossing_rings(owners)
    if across:
        f, e = _across(grid[:, across], ranks[:, across], pad_start, pad_end,
                       periodic, mailboxes)
        front[:, across], end[:, across] = f, e
    return from_grid(front, blocks), from_grid(end, blocks)


def _across(grid, ranks, pad_start, pad_end, periodic, mailboxes):
    """Each local shard's edges on rings that cross processes (every
    process calls it with the same rings): the push form on CUDA shards,
    the plain copies on CPU shards and inside ``plain_versions()``."""
    mine = [b for b in grid.flat if b is not None]
    if not mine:
        raise ValueError("halo_remote across processes: this process holds "
                         "no shard of the rings that cross processes")
    first = _check_blocks(mine)
    _check_pads(first.shape[0], pad_start, pad_end, grid.shape[0], periodic)
    types = {b.device.type for b in mine}
    if types == {"cpu"} or (types == {"cuda"} and _plain.get()):
        return halo_edges_remote_ref(grid, pad_start, pad_end, periodic,
                                     owners=ranks)
    if types != {"cuda"}:
        raise ValueError(f"halo_remote: shards on {sorted(types)}; the "
                         f"kernel needs every shard on a CUDA device")
    devices = {b.device for b in mine}
    if len(devices) != 1:
        raise ValueError(f"halo_remote across processes: this process's "
                         f"shards of those rings are on "
                         f"{sorted(map(str, devices))}; the push form "
                         f"needs them on one card")
    if len(mine) > MAX_SHARDS:
        raise ValueError(f"halo_remote addresses at most {MAX_SHARDS} "
                         f"shards, got {len(mine)}")
    device = first.device
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    local_n, rest = first.shape[0], tuple(first.shape[1:])
    front = np.empty(grid.shape, dtype=object)
    end = np.empty(grid.shape, dtype=object)
    cells = [idx for idx in grid_indices(grid.shape) if grid[idx] is not None]
    # one buffer for the edges of every local shard
    buf = torch.empty((len(cells), pad_start + pad_end) + rest,
                      dtype=first.dtype, device=device)
    for j, idx in enumerate(cells):
        front[idx], end[idx] = buf[j, :pad_start], buf[j, pad_start:]
    row_bytes = first.element_size() * (first.numel() // local_n
                                        if local_n else 0)
    if not (pad_start or pad_end) or not row_bytes:
        return front, end
    key = (ranks.tobytes(), ranks.shape, tuple(first.shape), first.dtype,
           pad_start, pad_end, bool(periodic), device)
    mailboxes.channel(key, lambda: _ipc.Plan(
        ranks, pad_start, pad_end, periodic, row_bytes), device).run(
            grid, front, end)
    return front, end


def halo_exchange_remote(blocks, pad_start, pad_end, periodic=False,
                         owners=None, mailboxes=None):
    """Each shard's padded window ``concat([front, block, end])`` by
    :func:`halo_edges_remote` (drop-in for
    :func:`..parallel.halo.halo_exchange`, axis 0 only)."""
    front, end = halo_edges_remote(blocks, pad_start, pad_end, periodic,
                                   owners, mailboxes)
    grid, fg, eg = ring_grid(blocks), ring_grid(front), ring_grid(end)
    out = np.empty(grid.shape, dtype=object)
    for idx in grid_indices(grid.shape):
        if grid[idx] is not None:
            out[idx] = torch.cat([fg[idx], grid[idx], eg[idx]])
    return from_grid(out, blocks)
