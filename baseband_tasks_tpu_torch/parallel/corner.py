"""Time <-> frequency corner turn: the channelizer's resharding collective.

Counterpart of ``baseband_tasks_tpu/parallel/corner.py``.  Channelization
is local (each length-``n`` spectrum uses ``n`` consecutive samples); what
needs communication is the reshard that follows, from time-sharded
spectra to channel-sharded ones.  On a TPU that is one
``jax.lax.all_to_all``; here, over the shards of one process, it is a
split of each shard's channel axis regrouped onto the shards, and on a
mesh over several processes the pieces whose shards belong to different
processes go through one ``torch.distributed`` all-to-all
(``parallel/_transport.py``).
"""

from __future__ import annotations

import torch

from . import _transport
from .mesh import axis_shards, join_parts

__all__ = ["corner_turn", "all_to_all", "sharded_channelize",
           "sharded_dechannelize"]


def all_to_all(blocks, split_axis, concat_axis, owners=None):
    """``jax.lax.all_to_all(..., tiled=True)`` over a list of shards:
    shard ``j`` receives piece ``j`` of every shard's ``split_axis``
    (split into ``len(blocks)`` equal pieces), concatenated in shard order
    along ``concat_axis``, on its own device.  Every shard's block has one
    shape and dtype.  ``owners`` (a rank per shard; None: all this
    process's): a process passes None for the other processes' shards
    and gets None there; every process calls it."""
    n = len(blocks)
    mine = [b for b in blocks if b is not None]
    if not mine:
        if owners is None:
            raise ValueError("no block given")
    else:
        size = mine[0].shape[split_axis]
        if size % n:
            raise ValueError(f"axis {split_axis} of size {size} does not "
                             f"split over {n} shards")
    pieces = [None if b is None else b.chunk(n, dim=split_axis)
              for b in blocks]
    me = _transport.process_index()
    if owners is None:
        owners = [me] * n
    got = {}
    pairs, keys = [], []
    for j in range(n):
        for i in range(n):
            if owners[i] == owners[j]:
                if owners[j] == me:
                    got[i, j] = pieces[i][j].to(blocks[j].device)
                continue
            # the sender's piece, the receiver's like (its own piece i),
            # nothing on a third process
            part = pieces[i][j] if owners[i] == me else \
                pieces[j][i] if owners[j] == me else None
            pairs.append((owners[i], owners[j], part))
            keys.append((i, j))
    for key, t in zip(keys, _transport.all_to_all(pairs)):
        if t is not None:
            got[key] = t
    return [torch.cat([got[i, j] for i in range(n)], dim=concat_axis)
            if owners[j] == me else None for j in range(n)]


def corner_turn(blocks, *, chan_axis=1, time_axis=0, owners=None):
    """Trade time shards for channel shards: each local ``(T_l, C, ...)``
    block becomes ``(T_l * S, C / S, ...)`` over ``S`` shards."""
    return all_to_all(blocks, split_axis=chan_axis, concat_axis=time_axis,
                      owners=owners)


def sharded_channelize(mesh, n, *, axis_name="time"):
    """A sharded channelizer with the corner-turn reshard.

    Returns ``fn(x)`` taking a global ``(T, ...)`` array, split in time
    over the devices of ``axis_name``, and returning the ``(T // n, n,
    ...)`` channelized array: per shard a reshape and FFT, then the
    corner turn to channel shards; the result is joined along the channel
    axis on the first device.  The per-shard sample count must divide by
    ``n`` and the shard count must divide ``n``.  On a mesh over several
    processes every process passes the same ``x``, computes its own
    shards, and gets the whole result on its first device of the axis.
    """
    devices, owners, local = axis_shards(mesh, axis_name)
    n_shards = len(devices)
    if n % n_shards:
        raise ValueError(f"n={n} must divide over {n_shards} shards")

    def fn(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n_shards:
            raise ValueError(f"{x.shape[0]} samples do not split over "
                             f"{n_shards} shards")
        blocks = [b.to(d) if keep else None
                  for b, d, keep in zip(x.chunk(n_shards), devices, local)]
        spectra = []
        for xl in blocks:
            if xl is None:
                spectra.append(None)
                continue
            t_l = xl.shape[0]
            if t_l % n:
                raise ValueError(f"local block {t_l} not a multiple of "
                                 f"n={n}")
            spectra.append(torch.fft.fft(
                xl.reshape((t_l // n, n) + tuple(xl.shape[1:])), dim=1))
        return join_parts(corner_turn(spectra, owners=owners), owners, 1)

    return fn


def sharded_dechannelize(mesh, *, axis_name="time"):
    """Inverse of :func:`sharded_channelize`: channel-sharded spectra back
    to a time-sharded raw stream (the corner turn back, then the inverse
    FFT), joined along time on the first device (of every process, on a
    mesh over several)."""
    devices, owners, local = axis_shards(mesh, axis_name)

    def fn(x):
        x = torch.as_tensor(x)
        blocks = [b.to(d) if keep else None for b, d, keep in
                  zip(x.chunk(len(devices), dim=1), devices, local)]
        spectra = all_to_all(blocks, split_axis=0, concat_axis=1,
                             owners=owners)
        raw = [None if s is None else torch.fft.ifft(s, dim=1).flatten(0, 1)
               for s in spectra]
        return join_parts(raw, owners, 0)

    return fn

