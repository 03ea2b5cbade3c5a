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
"""

from __future__ import annotations

import torch

from ..parallel.halo import ppermute
from ..parallel.mesh import axis_devices
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
    on the chain's device, so every shard must be on it (several shards
    on one card or on the CPU); shards on other cards are refused.
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
        home = _canonical(cp.device)
        other = [d for d in self.devices if _canonical(d) != home]
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
            n = xs[0].shape[0]
            if pad > n:
                # the left neighbour only holds one block of history
                raise ValueError(
                    f"stage {type(st.node).__name__}: pad {pad} exceeds "
                    f"its per-shard block {n}; increase "
                    f"samples_per_frame or use fewer time shards")
            received = ppermute([x[n - pad:] for x in xs], ring)
            fronts = [c] + received[1:]
            windows = [torch.cat([f, x], dim=0) for f, x in zip(fronts, xs)]
            # shard 0 received shard S-1's tail: the next carry, a copy
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
        (``tail_block`` samples each), each on its shard's device.  The
        JAX step also returns the cache leaves it threads through ``jit``;
        nothing is traced here, so the step is all."""
        cp = self.cp
        multi = len(cp.sources) > 1
        run = cp._program_step(self._pad_hook(), _per_shard)

        def step(carry, xs):
            decoded = [cp._decode(x) for x in xs]
            inputs = (tuple([d[k] for d in decoded]
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
                             cp._block(blocks, k + i))
                   for i, dev in enumerate(self.devices)]

    def run_fn(self, n_blocks):
        """``run(blocks)`` over ``n_blocks`` stacked source blocks (a
        multiple of the shard count), as ``CompiledPipeline.run_fn``:
        the tail output joined on shard 0's device, or ``(sums, counts)``
        with an absorbed reduction.  Cached per ``n_blocks``."""
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
        home = self.devices[0]
        red = cp.reduction
        if red is None:
            def fn(blocks):
                carry = cp.init_carry()
                outs = []
                for xs in self._shard_blocks(blocks, n_blocks):
                    carry, ys = step(carry, xs)
                    outs.extend(y.to(home) for y in ys)
                return torch.cat(outs, dim=0)
        else:
            # segment ids over S * tail_block samples a super-step, built
            # once on the device
            tb = cp.tail_block
            ids, n_seg = cp.segment_ids_np(n_blocks)
            ids = torch.as_tensor(ids.reshape(n_blocks // S, S, tb),
                                  device=home)
            update = make_reduction_update(red)

            def fn(blocks):
                carry = cp.init_carry()
                sums, counts = init_reduction_acc(
                    red, cp._tail.sample_shape, n_seg, home)
                for k, xs in enumerate(self._shard_blocks(blocks, n_blocks)):
                    carry, ys = step(carry, xs)
                    for i, y in enumerate(ys):
                        update(sums, counts, y.to(home), ids[k, i])
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
    """``fn`` on each shard's values: the S launches of one stage."""
    return [fn(*vs) for vs in zip(*values)]
