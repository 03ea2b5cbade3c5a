"""Small shared helpers for the trial-bank ``*_sharded`` methods.

Counterpart of ``baseband_tasks_tpu/models/meshtools.py``.  The search
models shard the same way: the trial bank (or the batch) spreads over one
mesh axis with no communication, each device holding its slice of the
bank tables and computing its slice of the output, and the per-device
tables are cached per (mesh, axis) so a survey loop places them once.
On a mesh over several processes each process builds and computes its
own shards only, and the slices are joined on every process in shard
order (:func:`join_parts`), as the JAX package's replicated
``out_shardings=P()`` result reaches every process.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import axis_devices, axis_shards, join_parts

__all__ = ["require_mesh_axis", "mesh_cache_key", "pad_to_multiple",
           "axis_devices", "axis_shards", "shard_columns", "join_parts"]


def require_mesh_axis(mesh, axis_name):
    """Validate ``axis_name`` is a mesh axis; return its size."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}; "
                         f"axes are {tuple(mesh.shape)}")
    return int(mesh.shape[axis_name])


def mesh_cache_key(mesh, axis_name):
    """Hashable identity of (mesh, axis) for the per-model caches."""
    return (tuple(mesh.shape.items()), tuple(mesh.devices.flat),
            tuple(mesh.process_ids.flat), axis_name)


def pad_to_multiple(n, k):
    """Samples of padding that lift ``n`` to a multiple of ``k``."""
    return (-n) % k


def shard_columns(table, devices, dim=-1, local=None):
    """``table`` cut along ``dim`` into one slice per device of
    ``devices``, zero-padded to equal widths (a bank that does not divide
    the shard count gets zero columns at its end): a list of tensors, each
    on its device (None where ``local`` says the shard is another
    process's)."""
    dim = dim % table.ndim
    n = table.shape[dim]
    per = (n + pad_to_multiple(n, len(devices))) // len(devices)
    parts = []
    for k, dev in enumerate(devices):
        if local is not None and not local[k]:
            parts.append(None)
            continue
        cols = table.narrow(dim, min(k * per, n),
                            max(min(per, n - k * per), 0))
        shape = list(table.shape)
        shape[dim] = per
        part = torch.zeros(shape, dtype=table.dtype, device=dev)
        part.narrow(dim, 0, cols.shape[dim]).copy_(cols)
        parts.append(part)
    return parts
