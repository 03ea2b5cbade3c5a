"""Halo exchange for time-sharded overlap-save processing.

Counterpart of ``baseband_tasks_tpu/parallel/halo.py``.  There, inside
``shard_map``, each time shard sends its edge samples to its neighbours
with ``jax.lax.ppermute``.  Here the shards of one process are explicit:
the functions take the per-shard blocks of a time ring and return the
per-shard results.  ``blocks`` is a sequence of tensors in ring order,
or an object array whose first axis is the ring (a mesh's (time, chan)
grid of blocks: each column is one ring); results come back in the same
form, each on its shard's device.  :func:`ppermute` is the collective: a
slice plus ``.to(neighbour's device)``, a fresh contiguous copy as XLA's
collective gives.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import grid_indices, shard, unshard

__all__ = ["halo_exchange", "halo_edges", "sharded_overlap_save",
           "ppermute"]


def ring_grid(blocks):
    """``blocks`` as a 2-D object array (ring position, ring): a sequence
    is one ring, an object array keeps its first axis as the ring and
    flattens the rest."""
    if isinstance(blocks, np.ndarray):
        return blocks.reshape(blocks.shape[0], -1)
    grid = np.empty((len(blocks), 1), dtype=object)
    for i, b in enumerate(blocks):
        grid[i, 0] = b
    return grid


def from_grid(grid, like):
    """A result grid in the form of the input ``like``."""
    if isinstance(like, np.ndarray):
        return grid.reshape(like.shape)
    return [grid[i, 0] for i in range(grid.shape[0])]


def _copy_to(t, device):
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


def _zeros_like(t, n, axis):
    shape = list(t.shape)
    shape[axis] = n
    return torch.zeros(shape, dtype=t.dtype, device=t.device)


def ppermute(bufs, perm):
    """``jax.lax.ppermute`` over a ring: shard ``j`` receives a copy of
    ``bufs[i]`` on its own device for each ``(i, j)`` in ``perm``, and
    zeros of ``bufs[j]``'s shape where nothing is sent to it.  ``bufs``
    is a sequence or a ring grid (see the module docstring)."""
    grid = ring_grid(bufs)
    out = np.empty(grid.shape, dtype=object)
    for i, j in perm:
        for r in range(grid.shape[1]):
            out[j, r] = _copy_to(grid[i, r], grid[j, r].device)
    for idx in grid_indices(grid.shape):
        if out[idx] is None:
            out[idx] = torch.zeros_like(grid[idx])
    return from_grid(out, bufs)


def _check_pads(local_n, pad_start, pad_end, n_shards, periodic):
    if (pad_start > local_n or pad_end > local_n) and \
            (n_shards > 1 or periodic):
        # a neighbour (or the wrap-around self) only holds local_n samples
        raise ValueError(
            f"halo ({pad_start},{pad_end}) exceeds local block {local_n}; "
            f"use fewer shards or larger blocks")


def _ring_perms(n_shards, periodic):
    """(fwd, bwd): sends to the right neighbour and to the left one."""
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    if periodic:
        fwd.append((n_shards - 1, 0))
        bwd.append((0, n_shards - 1))
    return fwd, bwd


def halo_edges(blocks, pad_start, pad_end, periodic=False, axis=0):
    """The two neighbour edge buffers of :func:`halo_exchange`,
    unconcatenated.

    Returns ``(front, end)``: for each shard, ``pad_start`` samples along
    ``axis`` from its left neighbour's tail and ``pad_end`` from its
    right neighbour's head, zeros at non-periodic boundaries (a lone
    shard wraps onto itself with ``periodic``).  For kernels that
    assemble their own windows this avoids the padded window in memory.
    """
    grid = ring_grid(blocks)
    n_shards = grid.shape[0]
    local_n = grid[0, 0].shape[axis]
    _check_pads(local_n, pad_start, pad_end, n_shards, periodic)
    if n_shards == 1 and not periodic:
        # a lone shard at both stream edges: zeros, whatever the pads
        front = np.empty(grid.shape, dtype=object)
        end = np.empty(grid.shape, dtype=object)
        for idx in grid_indices(grid.shape):
            front[idx] = _zeros_like(grid[idx], pad_start, axis)
            end[idx] = _zeros_like(grid[idx], pad_end, axis)
        return from_grid(front, blocks), from_grid(end, blocks)
    tails = np.empty(grid.shape, dtype=object)
    heads = np.empty(grid.shape, dtype=object)
    for idx in grid_indices(grid.shape):
        tails[idx] = grid[idx].narrow(axis, local_n - pad_start, pad_start)
        heads[idx] = grid[idx].narrow(axis, 0, pad_end)
    # a lone periodic shard is its own neighbour
    fwd, bwd = _ring_perms(n_shards, periodic) if n_shards > 1 \
        else ([(0, 0)], [(0, 0)])
    front = ppermute(tails, fwd)
    end = ppermute(heads, bwd)
    return from_grid(front, blocks), from_grid(end, blocks)


def halo_exchange(blocks, pad_start, pad_end, periodic=False, axis=0):
    """Extend each shard's block with its neighbours' edge samples along
    ``axis``: ``pad_start + local_n + pad_end`` samples a shard, zeros at
    non-periodic stream edges (``periodic=True`` wraps the ring)."""
    front, end = halo_edges(blocks, pad_start, pad_end, periodic, axis)
    grid, fg, eg = ring_grid(blocks), ring_grid(front), ring_grid(end)
    out = np.empty(grid.shape, dtype=object)
    for idx in grid_indices(grid.shape):
        out[idx] = torch.cat([fg[idx], grid[idx], eg[idx]], dim=axis)
    return from_grid(out, blocks)


def sharded_overlap_save(fn, mesh, pad_start, pad_end, *, in_spec=None,
                         out_spec=None, periodic=False):
    """Lift a padded-window function to a time-sharded array.

    ``fn(window)`` consumes ``pad_start + local_n + pad_end`` samples and
    returns ``local_n`` samples (the valid region): the single-device
    overlap-save contract of ``PaddedTaskBase``.  The returned callable
    takes a global array (samples on mesh axis 'time', channels on
    'chan', by default), runs ``fn`` on each shard's window after a halo
    exchange along 'time', and returns the global result on the mesh's
    first device.
    """
    in_spec = in_spec if in_spec is not None else ("time", "chan")
    out_spec = out_spec if out_spec is not None else in_spec
    t_axis = mesh.axis_names.index("time")

    def sharded(x):
        blocks = np.moveaxis(shard(x, mesh, in_spec), t_axis, 0)
        windows = halo_exchange(blocks, pad_start, pad_end, periodic)
        out = np.empty(windows.shape, dtype=object)
        for idx in grid_indices(windows.shape):
            out[idx] = fn(windows[idx])
        return unshard(np.moveaxis(out, 0, t_axis), mesh, out_spec)

    return sharded
