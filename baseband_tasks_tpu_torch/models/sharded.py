"""Time-sharded execution of any compiled task graph over a mesh.

Counterpart of ``baseband_tasks_tpu/models/sharded.py``.
:class:`~.compiled.CompiledPipeline` turns a stream chain into one
``(carry, block) -> (carry, out)`` step on one device.
:class:`ShardedPipeline` runs ``S`` consecutive blocks a super-step, one
on each shard along the mesh's time axis, with the overlap-save carries
turned into a ring exchange of the shards' tails
(:func:`~..parallel.halo.ppermute`).

The JAX package runs the one-device step as one SPMD program under
``shard_map``.  The port's mesh is one process driving a grid of
``torch.device`` (``parallel/mesh.py``), so the super-step goes stage by
stage: every value on the program's stack is a list of ``S`` per-shard
tensors, each stage's task runs once per shard on that shard's device
(the ``S`` launches of a stage go out back to back), and each padded
stage's windows come from :meth:`ShardedPipeline._pad_hook`.

How the carry becomes a halo
----------------------------
Shard ``i`` holds block ``sS + i`` of super-step ``s``.  Its window front
is

* shard ``i > 0``: the tail of shard ``i-1``'s input at the same stage of
  this super-step;
* shard ``0``: the carry (shard ``S-1``'s tail from the previous
  super-step).

One ring permute delivers both: shard 0 receives shard ``S-1``'s current
tail, which is the next super-step's carry.  The JAX package recovers it
as a replicated value with a masked ``psum``; here it is the permute's
copy on shard 0's device (a copy, never a view of a block).  Every
per-shard task sees the shapes of the one-device step, so the output
equals the one-device compiled output (bit for bit in practice).

An absorbed trailing Integrate/Fold/PulseStack sums each super-step's
``S * tail_block`` output samples into the bins by segment id, with the
ids built once on the device, as ``CompiledPipeline.run_fn`` does.

Over several processes
----------------------
On a mesh over several processes (``parallel.multihost.pod_mesh``) each
process builds its own chain on its own card, and all run the same
calls.  A process holds and runs the shards of its own cells only (the
other shards' entries are None), stage by stage; the ring permute
crosses processes through the process group, and the carry lives with
the process that owns shard 0.  ``run_blocks`` returns this process's
shards' outputs in global order.  An absorbed reduction is added to in
shard order, each shard's output by its own process: before a process's
turn it receives the bins its shards add to whose latest values another
process holds (only those), and each bin's total reaches every process
at the end, so the totals equal one process's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import _transport
from ..parallel.halo import ppermute
from ..parallel.mesh import axis_devices, axis_owners
from .compiled import _tree_map, init_reduction_acc, make_reduction_update

__all__ = ["ShardedPipeline"]


def _canonical(device):
    """``device`` with the current CUDA index filled in (``cuda`` and
    ``cuda:0`` are then the same card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ShardedPipeline:
    """Run a compiled task graph time-sharded over a device mesh.

    Parameters
    ----------
    cp : CompiledPipeline
        The compiled graph, reused as it is: block bookkeeping, fusions,
        device caches and the absorbed reduction carry over.
    mesh : parallel.Mesh
        Blocks are sharded along ``axis_name``; other mesh axes replicate,
        so the shards are the devices along ``axis_name`` at index 0 of
        the others.  A device may repeat (several shards on one card).
    axis_name : str
        The mesh axis carrying consecutive time blocks.

    Notes
    -----
    ``S = mesh.shape[axis_name]`` consecutive source blocks form one
    super-step, so ``run_blocks`` wants ``n_blocks`` a multiple of ``S``.
    Every padded stage must have ``pad <= block`` at its point in the
    chain (its neighbour holds only one block of history); construct
    stages with a larger ``samples_per_frame`` otherwise, the constraint
    of ``parallel.halo.halo_exchange``.  The stages' device caches live
    on the chain's device, so every shard of this process must be on it
    (several shards on one card or on the CPU); shards on other cards of
    this process are refused, shards of other processes (each with its
    own chain) are not.
    """

    def __init__(self, cp, mesh, *, axis_name="time"):
        if axis_name not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis_name!r}; "
                             f"axes are {tuple(mesh.shape)}")
        self.cp = cp
        self.mesh = mesh
        self.axis_name = axis_name
        self.devices = axis_devices(mesh, axis_name)
        self.n_shards = len(self.devices)
        # the rank of each shard
        self.owners = axis_owners(mesh, axis_name)
        me = _transport.process_index()
        self._local = [r == me for r in self.owners]
        if not any(self._local):
            raise ValueError("this process owns no shard of the mesh axis")
        home = _canonical(cp.device)
        other = [d for d, keep in zip(self.devices, self._local)
                 if keep and _canonical(d) != home]
        if other:
            raise ValueError(
                f"shards on {other[0]}, not the chain's device {home}: the "
                f"stages' device caches live on the chain's device, so "
                f"every shard must be on it")
        self._run_cache = {}

    # -- the halo hook ---------------------------------------------------
    def _pad_hook(self):
        """``hook(stage, carry, xs) -> (windows, new_carry)`` over the
        ``S`` per-shard inputs ``xs`` of a padded stage (see the module
        docstring)."""
        S = self.n_shards
        ring = [(i, (i + 1) % S) for i in range(S)]

        def hook(st, c, xs):
            pad = st.pad
            if not pad:
                return list(xs), c
            n = next(x for x in xs if x is not None).shape[0]
            if pad > n:
                # the left neighbour only holds one block of history
                raise ValueError(
                    f"stage {type(st.node).__name__}: pad {pad} exceeds "
                    f"its per-shard block {n}; increase "
                    f"samples_per_frame or use fewer time shards")
            received = ppermute([None if x is None else x[n - pad:]
                                 for x in xs], ring, self.owners)
            fronts = [c] + received[1:]
            windows = [None if x is None else torch.cat([f, x], dim=0)
                       for f, x in zip(fronts, xs)]
            # shard 0 received shard S-1's tail: the next carry, a copy
            # (None in the processes that do not own shard 0)
            return windows, received[0]

        return hook

    # -- the sharded step --------------------------------------------------
    def sharded_step(self):
        """``(carry, xs) -> (carry, ys)``: one super-step.

        ``carry`` is ``cp.init_carry()``'s (on shard 0's device, the
        chain's); ``xs`` holds the ``S`` per-shard source blocks in time
        order, each in the form ``CompiledPipeline.step_fn`` takes (a
        tensor, a tuple with one per source, or a packed source's words)
        on its shard's device; ``ys`` is the list of the ``S`` output blocks
        (``tail_block`` samples each), each on its shard's device.  Over
        several processes the other processes' entries of ``xs`` and
        ``ys`` are None, and so is the carry where shard 0 is another
        process's.  The JAX step also returns the cache leaves it threads
        through ``jit``; nothing is traced here, so the step is all."""
        cp = self.cp
        multi = len(cp.sources) > 1
        run = cp._program_step(self._pad_hook(), _per_shard)

        def step(carry, xs):
            decoded = [None if x is None else cp._decode(x) for x in xs]
            inputs = (tuple([None if d is None else d[k] for d in decoded]
                            for k in range(len(cp.sources)))
                      if multi else decoded)
            return run(carry, inputs)

        return step

    def _shard_blocks(self, blocks, n_blocks):
        """Stacked source blocks (as ``CompiledPipeline._prep_blocks``
        gives them; ``n_blocks`` a multiple of S) -> per super-step, the
        ``S`` per-shard blocks on their shards' devices.  Works leaf by
        leaf, so packed stacks (words, or (words, mask)) shard the same
        way: each shard then decodes its own block inside the step."""
        S = self.n_shards
        cp = self.cp
        for k in range(0, n_blocks, S):
            yield [_tree_map(lambda t, d=dev: t.to(d),
                             cp._block(blocks, k + i)) if keep else None
                   for i, (dev, keep) in enumerate(zip(self.devices,
                                                       self._local))]

    def run_fn(self, n_blocks):
        """``run(blocks)`` over ``n_blocks`` stacked source blocks (a
        multiple of the shard count), as ``CompiledPipeline.run_fn``:
        the tail output joined on shard 0's device, or ``(sums, counts)``
        with an absorbed reduction.  Over several processes: this
        process's shards' outputs in global order, on its first shard's
        device, and the reduction's totals on every process.  Cached per
        ``n_blocks``."""
        n_blocks = int(n_blocks)
        S = self.n_shards
        if n_blocks % S:
            raise ValueError(f"n_blocks={n_blocks} must be a multiple of "
                             f"the {S} time shards")
        fn = self._run_cache.get(n_blocks)
        if fn is not None:
            return fn
        cp = self.cp
        step = self.sharded_step()
        home = self.devices[self._local.index(True)]
        red = cp.reduction
        if red is None:
            def fn(blocks):
                carry = cp.init_carry()
                outs = []
                for xs in self._shard_blocks(blocks, n_blocks):
                    carry, ys = step(carry, xs)
                    outs.extend(y.to(home) for y in ys if y is not None)
                return torch.cat(outs, dim=0)
        else:
            # segment ids over S * tail_block samples a super-step, built
            # once on the device
            tb = cp.tail_block
            ids, n_seg = cp.segment_ids_np(n_blocks)
            ids = ids.reshape(n_blocks // S, S, tb)
            moves, totals = _hand_over_plan(ids, self.owners, n_seg + 1,
                                            home)
            ids = torch.as_tensor(ids, device=home)
            update = make_reduction_update(red)

            def fn(blocks):
                carry = cp.init_carry()
                acc = init_reduction_acc(red, cp._tail.sample_shape, n_seg,
                                         home)
                for k, xs in enumerate(self._shard_blocks(blocks, n_blocks)):
                    carry, ys = step(carry, xs)
                    for i, y in enumerate(ys):
                        if (k, i) in moves:
                            # the accumulators follow the shards' order
                            _hand_over(acc, moves[k, i])
                        if y is not None:
                            update(*acc, y.to(home), ids[k, i])
                _hand_over(acc, totals)
                sums, counts = acc
                return cp._shape_reduced(sums), cp._shape_reduced(counts)

        self._run_cache[n_blocks] = fn
        return fn

    def run_blocks(self, blocks):
        """Run the sharded graph over stacked source blocks (tensors or
        numpy; a tuple of stacks for a multi-input graph; packed stacks
        from ``read_source_blocks``); see :meth:`run_fn`."""
        blocks, n_blocks = self.cp._prep_blocks(blocks)
        return self.run_fn(n_blocks)(blocks)

    def run_reduced(self, blocks):
        """The absorbed reduction averaged, ``(averages, counts)``, as
        ``CompiledPipeline.run_reduced``."""
        if self.cp.reduction is None:
            raise ValueError("no reduction to run")
        sums, counts = self.run_blocks(blocks)
        return self.cp._averaged(sums, counts)


def _per_shard(fn, *values):
    """``fn`` on each shard's values: the S launches of one stage (None
    for the shards of other processes)."""
    return [None if vs[0] is None else fn(*vs) for vs in zip(*values)]


def _hand_over_plan(ids, owners, n_bins, device):
    """The transfers that keep an absorbed reduction summed in the shards'
    order across processes: ``(moves, totals)``.

    ``ids`` (super-steps, S, tail_block) are the segment ids and
    ``owners`` the rank of each of the S shards.  The accumulators are
    updated shard after shard, each by the process owning the shard, so
    a bin's latest value sits with the process that last added to it.
    ``moves[k, i]``, before shard ``i`` of super-step ``k`` where a run
    of one process's shards starts, hands that process the bins the run
    adds to whose latest values sit with another process; ``totals``
    then gives every process of ``owners`` each bin's final value.  Each
    transfer is ``(src, dst, bins)``, ``bins`` an index tensor on
    ``device``."""
    order = [(k, i) for k in range(ids.shape[0]) for i in range(len(owners))]
    last = np.full(n_bins, -1)          # -1: no addition yet (zero)
    moves, pos = {}, 0
    while pos < len(order):
        dst = owners[order[pos][1]]
        end = pos
        while end < len(order) and owners[order[end][1]] == dst:
            end += 1
        bins = np.unique(np.concatenate([ids[k, i]
                                         for k, i in order[pos:end]]))
        held = last[bins]
        run = [(int(src), dst, torch.as_tensor(bins[held == src],
                                               device=device))
               for src in np.unique(held) if src not in (-1, dst)]
        if run:
            moves[order[pos]] = run
        last[bins] = dst
        pos = end
    totals = []
    for src in np.unique(last[last >= 0]):
        bins = torch.as_tensor(np.flatnonzero(last == src), device=device)
        totals.extend((int(src), dst, bins)
                      for dst in sorted(set(owners)) if dst != src)
    return moves, totals


def _hand_over(acc, transfers):
    """Copy the ``bins`` of the accumulators ``acc`` (in place) from
    ``src`` to ``dst`` for each ``(src, dst, bins)`` of ``transfers``
    (every process calls it with the same list)."""
    me = _transport.process_index()
    pairs = []
    for src, dst, bins in transfers:
        for t in acc:
            part = t.index_select(0, bins) if src == me else \
                t.new_empty((bins.numel(),) + tuple(t.shape[1:])) \
                if dst == me else None
            pairs.append((src, dst, part))
    got = _transport.send_recv(pairs)
    for k, (src, dst, bins) in enumerate(transfers):
        if dst == me:
            for j, t in enumerate(acc):
                t.index_copy_(0, bins, got[k * len(acc) + j])
