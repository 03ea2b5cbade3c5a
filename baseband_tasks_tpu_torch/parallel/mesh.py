"""Device meshes of one process, and sharding a tensor over them.

Counterpart of ``baseband_tasks_tpu/parallel/mesh.py``.  A JAX ``Mesh``
is one controller driving several devices through ``shard_map``; the port
keeps that model: one process, and a mesh that is a named grid of
``torch.device``.  A "sharded array" is an object array of the mesh's
shape holding each device's block on that device (:func:`shard`), and
:func:`unshard` reassembles the global tensor.  A device may appear
several times in a mesh: several shards then share one card (or the
CPU), as the JAX tests put eight virtual devices on one CPU.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "time_chan_specs", "default_devices",
           "axis_devices", "shard", "unshard"]


def grid_indices(shape):
    """Every index of an array of ``shape``, row-major (``np.ndindex``,
    which costs tens of microseconds a call, on the steps' host path)."""
    return itertools.product(*map(range, shape))


class Mesh:
    """A named grid of devices.

    ``devices`` : array-like of ``torch.device`` (or device strings), of
    one dimension per name in ``axis_names``.  ``shape`` maps each axis
    name to its size, as a JAX mesh's does.
    """

    def __init__(self, devices, axis_names):
        names = tuple(axis_names)
        grid = _object_array(devices)
        if grid.ndim != len(names):
            raise ValueError(f"devices of shape {grid.shape} for axes "
                             f"{names}")
        self.devices = grid
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))

    @property
    def size(self):
        return self.devices.size

    def __repr__(self):
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
    n = devices.size
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
    return Mesh(devices[:time * chan].reshape(time, chan), ("time", "chan"))


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


def _index(spec, shape, mesh, coord):
    """The slices of an array of ``shape`` held at mesh ``coord``."""
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


def shard(x, mesh, spec):
    """Split ``x`` (a tensor or numpy) over ``mesh`` by ``spec`` (one
    mesh-axis name or None per leading dimension; axes not named are
    replicated): an object array of the mesh's shape holding each
    device's contiguous block on that device.  A block that is the whole
    of ``x`` on its own device is ``x`` itself."""
    x = torch.as_tensor(x)
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in grid_indices(mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, idx))
        block = x[_index(spec, x.shape, mesh, coord)]
        out[idx] = block.to(mesh.devices[idx]).contiguous()
    return out


def unshard(blocks, mesh, spec, device=None):
    """The global tensor of a sharded array (the inverse of :func:`shard`),
    on ``device`` (default: the mesh's first device).  Replicated axes
    take the blocks at index 0."""
    device = torch.device(device) if device is not None \
        else mesh.devices.flat[0]
    grid = np.asarray(blocks, dtype=object)
    named = {name: dim for dim, name in enumerate(spec) if name is not None}
    # index 0 along every mesh axis the spec does not split
    take = tuple(slice(None) if name in named else 0
                 for name in mesh.axis_names)
    grid = grid[take]
    axes = [name for name in mesh.axis_names if name in named]

    def join(g, level):
        if level == len(axes):
            return g.to(device)
        return torch.cat([join(g[i], level + 1) for i in range(g.shape[0])],
                         dim=named[axes[level]])
    return join(grid, 0)
