"""Small shared helpers for the trial-bank ``*_sharded`` methods.

Counterpart of ``baseband_tasks_tpu/models/meshtools.py``.  The search
models shard the same way: the trial bank (or the batch) spreads over one
mesh axis with no communication, each device holding its slice of the
bank tables and computing its slice of the output, and the per-device
tables are cached per (mesh, axis) so a survey loop places them once.
"""

from __future__ import annotations

from ..parallel.mesh import axis_devices

__all__ = ["require_mesh_axis", "mesh_cache_key", "pad_to_multiple",
           "axis_devices"]


def require_mesh_axis(mesh, axis_name):
    """Validate ``axis_name`` is a mesh axis; return its size."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}; "
                         f"axes are {tuple(mesh.shape)}")
    return int(mesh.shape[axis_name])


def mesh_cache_key(mesh, axis_name):
    """Hashable identity of (mesh, axis) for the per-model caches."""
    return (tuple(mesh.shape.items()), tuple(mesh.devices.flat),
            axis_name)


def pad_to_multiple(n, k):
    """Samples of padding that lift ``n`` to a multiple of ``k``."""
    return (-n) % k

