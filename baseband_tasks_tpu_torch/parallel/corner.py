"""Time <-> frequency corner turn: the channelizer's resharding collective.

Counterpart of ``baseband_tasks_tpu/parallel/corner.py``.  Channelization
is local (each length-``n`` spectrum uses ``n`` consecutive samples); what
needs communication is the reshard that follows, from time-sharded
spectra to channel-sharded ones.  On a TPU that is one
``jax.lax.all_to_all``; here, over the shards of one process, it is a
split of each shard's channel axis regrouped onto the shards.
"""

from __future__ import annotations

import torch

from .mesh import axis_devices

__all__ = ["corner_turn", "all_to_all", "sharded_channelize",
           "sharded_dechannelize"]


def all_to_all(blocks, split_axis, concat_axis):
    """``jax.lax.all_to_all(..., tiled=True)`` over a list of shards:
    shard ``j`` receives piece ``j`` of every shard's ``split_axis``
    (split into ``len(blocks)`` equal pieces), concatenated in shard order
    along ``concat_axis``, on its own device."""
    n = len(blocks)
    size = blocks[0].shape[split_axis]
    if size % n:
        raise ValueError(f"axis {split_axis} of size {size} does not split "
                         f"over {n} shards")
    pieces = [b.chunk(n, dim=split_axis) for b in blocks]
    return [torch.cat([pieces[i][j].to(blocks[j].device)
                       for i in range(n)], dim=concat_axis)
            for j in range(n)]


def corner_turn(blocks, *, chan_axis=1, time_axis=0):
    """Trade time shards for channel shards: each local ``(T_l, C, ...)``
    block becomes ``(T_l * S, C / S, ...)`` over ``S`` shards."""
    return all_to_all(blocks, split_axis=chan_axis, concat_axis=time_axis)


def sharded_channelize(mesh, n, *, axis_name="time"):
    """A sharded channelizer with the corner-turn reshard.

    Returns ``fn(x)`` taking a global ``(T, ...)`` array, split in time
    over the devices of ``axis_name``, and returning the ``(T // n, n,
    ...)`` channelized array: per shard a reshape and FFT, then the
    corner turn to channel shards; the result is joined along the channel
    axis on the first device.  The per-shard sample count must divide by
    ``n`` and the shard count must divide ``n``.
    """
    devices = axis_devices(mesh, axis_name)
    n_shards = len(devices)
    if n % n_shards:
        raise ValueError(f"n={n} must divide over {n_shards} shards")

    def fn(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n_shards:
            raise ValueError(f"{x.shape[0]} samples do not split over "
                             f"{n_shards} shards")
        blocks = [b.to(d) for b, d in zip(x.chunk(n_shards), devices)]
        spectra = []
        for xl in blocks:
            t_l = xl.shape[0]
            if t_l % n:
                raise ValueError(f"local block {t_l} not a multiple of "
                                 f"n={n}")
            spectra.append(torch.fft.fft(
                xl.reshape((t_l // n, n) + tuple(xl.shape[1:])), dim=1))
        turned = corner_turn(spectra)
        return torch.cat([t.to(devices[0]) for t in turned], dim=1)

    return fn


def sharded_dechannelize(mesh, *, axis_name="time"):
    """Inverse of :func:`sharded_channelize`: channel-sharded spectra back
    to a time-sharded raw stream (the corner turn back, then the inverse
    FFT), joined along time on the first device."""
    devices = axis_devices(mesh, axis_name)

    def fn(x):
        x = torch.as_tensor(x)
        blocks = [b.to(d) for b, d in zip(x.chunk(len(devices), dim=1),
                                          devices)]
        spectra = all_to_all(blocks, split_axis=0, concat_axis=1)
        raw = [torch.fft.ifft(s, dim=1) for s in spectra]
        return torch.cat([r.reshape((-1,) + tuple(r.shape[2:])).to(
            devices[0]) for r in raw])

    return fn
