"""Multi-process initialization and the mesh over every process's devices.

Counterpart of ``baseband_tasks_tpu/parallel/multihost.py``.  There,
``jax.distributed`` joins the hosts of a pod and every sharded array is
global; here ``torch.distributed`` joins the processes (one per card, as
PyTorch is run on GPUs, or several on one card or on CPUs), and a mesh
from :func:`pod_mesh` records which process owns each cell
(``Mesh.process_ids``).  Every process runs the same program on the same
mesh, holds the blocks of its own cells only (the others are None) and
computes only those; the collectives of ``parallel/halo.py`` and
``parallel/corner.py``, the flagship's reduction, the searches' joins and
``ShardedPipeline``'s ring exchange go through the process group where
the two ends of a copy belong to different processes
(``parallel/_transport.py``).  Launched the same way on one process, one
host or several:

    from baseband_tasks_tpu_torch.parallel import multihost
    multihost.initialize()              # torchrun's environment; no-op alone
    mesh = multihost.pod_mesh(chan=2)   # (time, chan) over every process

Two processes on one card (or on CPUs) name their rendezvous and take
gloo: ``initialize("file:///tmp/rdv", 2, rank, backend="gloo")`` and
``pod_mesh(local_devices=["cuda:0"] * 2)``.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ._ipc import release_all
from ._transport import process_count, process_index
from .mesh import Mesh, block_index, default_devices, mesh_shape

__all__ = ["initialize", "shutdown", "pod_mesh", "host_local",
           "process_index", "process_count"]

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _loopback(init_method):
    """Whether a rendezvous names this host (a loopback address, or a
    ``file://`` path, shared by the processes of one host)."""
    if init_method.startswith("file://"):
        return True
    host = init_method.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1") or host.startswith("127.")


def _local_layout(init_method, num_processes, rank, local_rank,
                  local_processes):
    """``(local_rank, local_processes)``: this process's index among the
    processes of its host, and their number.  Given, or torchrun's
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; else every process is on this
    host for a rendezvous on it (:func:`_loopback`), and over a
    rendezvous on another host each host runs one process per card, in
    rank order (torchrun's placement)."""
    env = os.environ
    if local_rank is None and env.get("LOCAL_RANK"):
        local_rank = int(env["LOCAL_RANK"])
    if local_processes is None and env.get("LOCAL_WORLD_SIZE"):
        local_processes = int(env["LOCAL_WORLD_SIZE"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_processes is None:
        local_processes = num_processes if _loopback(init_method) or \
            not cards else min(num_processes, cards)
    if local_rank is None:
        local_rank = rank % local_processes
    return int(local_rank), int(local_processes)


def _choose_backend(backend, local):
    """The backend to initialize for ``local`` processes on this host: the
    one asked for, checked, or NCCL when every local rank has a card of
    its own, gloo on the CPU.  Never a different one than asked for."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        if cards == 0:
            backend = "gloo"
        elif cards >= local:
            backend = "nccl"
        else:
            raise RuntimeError(
                f"{local} local processes and {cards} CUDA device(s): two "
                f"ranks would share a card, which NCCL refuses; pass "
                f"backend='gloo' to run them over host-staged gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("backend='nccl' asked for, but this torch "
                               "build has no NCCL")
        if local > cards:
            raise RuntimeError(
                f"backend='nccl' with {local} local processes and {cards} "
                f"CUDA device(s): two ranks would share a card, which NCCL "
                f"refuses; use backend='gloo'")
    elif not dist.is_gloo_available():
        raise RuntimeError("backend='gloo' asked for, but this torch build "
                           "has no gloo")
    return backend


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, *, backend=None, local_rank=None,
               local_processes=None):
    """Join the processes of a multi-process run (``torch.distributed``).

    With no arguments, reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``); a no-op when that names no second process, or
    when a process group exists already, so it is safe to call always.
    ``coordinator_address`` is ``host:port`` or a ``file://`` path shared
    by the processes.  ``local_rank`` and ``local_processes`` place this
    process among those of its host; by default torchrun's variables,
    else all processes on this host for a rendezvous on it (loopback or
    ``file://``), else one process per card of each host, in rank order.
    ``backend``: None takes NCCL when CUDA is available and every local
    rank has a card of its own, gloo on the CPU; a backend that is asked
    for and unavailable, or NCCL with two local ranks on one card, raises
    (no other backend is taken in its place).  Under NCCL the process's
    current card becomes ``cuda:local_rank``.
    """
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if explicit:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("give coordinator_address, num_processes and "
                             "process_id together")
        num_processes, rank = int(num_processes), int(process_id)
        if coordinator_address.startswith(("file://", "tcp://", "env://")):
            init_method = coordinator_address
        else:
            init_method = f"tcp://{coordinator_address}"
    else:
        if not all(os.environ.get(k) for k in _TORCHRUN):
            return
        num_processes = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    if num_processes <= 1:
        return
    if not 0 <= rank < num_processes:
        raise ValueError(f"process_id {rank} outside [0, {num_processes})")
    if init_method == "env://":
        where = f"tcp://{os.environ.get('MASTER_ADDR', '')}:0"
    else:
        where = init_method
    local_rank, local = _local_layout(where, num_processes, rank,
                                      local_rank, local_processes)
    backend = _choose_backend(backend, local)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=rank)


def shutdown():
    """Release the CUDA IPC mailboxes still open (``halo='remote'``
    across processes: closed in every process before any is freed) and
    destroy the process group.  Every process calls it, together; a
    no-op without a group."""
    if not dist.is_initialized():
        return
    release_all()
    dist.destroy_process_group()


def _local_devices(local_devices):
    if local_devices is not None:
        return [str(torch.device(d)) for d in local_devices]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return [f"cuda:{torch.cuda.current_device()}"]
    if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        return [f"cuda:{int(os.environ['LOCAL_RANK'])}"]
    return [str(d) for d in default_devices()]


def pod_mesh(time=-1, chan=1, local_devices=None):
    """A (time, chan) mesh over the local devices of every process, in
    rank order (each process's devices in the order it lists them).

    ``local_devices`` (this process's, e.g. ``["cpu"] * 2`` or
    ``["cuda:0"] * 2``): by default the process's own card under NCCL
    (``cuda:local_rank``, see :func:`initialize`), ``cuda:LOCAL_RANK``
    under torchrun, else every local device.  The cells are laid out
    row-major, so with as many devices a process as chan shards each
    process owns whole time rows.  The mesh records each cell's host
    name (``Mesh.hosts``).  Every process must call it (it gathers the
    device lists).
    """
    mine = (socket.gethostname(), _local_devices(local_devices))
    lists = [None] * process_count()
    if process_count() > 1:
        dist.all_gather_object(lists, mine)
    else:
        lists = [mine]
    devices = [d for _, devs in lists for d in devs]
    owners = [r for r, (_, devs) in enumerate(lists) for _ in devs]
    hosts = [host for host, devs in lists for _ in devs]
    time, chan = mesh_shape(len(devices), time, chan)
    n = time * chan
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(time, chan),
                ("time", "chan"),
                process_ids=np.asarray(owners[:n]).reshape(time, chan),
                hosts=np.asarray(hosts[:n], dtype=object).reshape(time,
                                                                  chan))


def host_local(local, mesh, spec):
    """A sharded array (``parallel.shard``'s object grid) from this
    process's part of the global array: ``local`` holds the rows of the
    global array that this process's cells cover along the first sharded
    dimension (the JAX ``make_array_from_process_local_data``).  This
    process's cells get their blocks; the other processes' cells are
    None.  The local rows must be contiguous in the global array."""
    local = torch.as_tensor(local)
    dim = next(d for d, name in enumerate(spec) if name is not None)
    axis = mesh.axis_names.index(spec[dim])
    cells = mesh.local_cells()
    mine = sorted({idx[axis] for idx in cells})
    out = np.empty(mesh.devices.shape, dtype=object)
    if not mine:
        return out
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(f"this process's cells along {spec[dim]!r} "
                         f"({mine}) are not contiguous")
    k, rest = divmod(local.shape[dim], len(mine))
    if rest:
        raise ValueError(f"local dimension {dim} of size "
                         f"{local.shape[dim]} does not split over this "
                         f"process's {len(mine)} cells along {spec[dim]!r}")
    shape = list(local.shape)
    shape[dim] = k * mesh.devices.shape[axis]
    for idx in cells:
        index = list(block_index(spec, shape, mesh, idx))
        s = index[dim]
        index[dim] = slice(s.start - mine[0] * k, s.stop - mine[0] * k)
        out[idx] = local[tuple(index)].to(mesh.devices[idx]).contiguous()
    return out
