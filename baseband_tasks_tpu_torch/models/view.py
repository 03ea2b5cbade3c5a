"""Read-compatible compiled view of a task chain: ``stream.compile()``.

Counterpart of ``baseband_tasks_tpu/models/view.py``.
:class:`CompiledStreamView` wraps a :class:`~.compiled.CompiledPipeline`
behind the filehandle protocol of the stream it compiles (``seek``/
``read``/``tell``/``shape``/meta), so switching to the compiled path is one
call::

    view = chain.compile()
    data = view.read(n)        # == chain.read(n), on the chain's device

The compiled step's output index ``i`` is the eager chain's sample
``i - delay``, and its first ``warmup`` outputs are affected by the
zero-initialized overlap-save carries.  The view therefore serves

- ``[0, warmup - delay)``       from the eager chain (exact),
- the compiled midsection        from the compiled step (equal to eager to
  the streaming-exactness contract of ``compiled.py``),
- the final partial block        from the eager chain again,

so ``view.read(n) == chain.read(n)`` over the whole stream.  Carries
persist between reads, so sequential reads never recompute history;
seeking back past retained output restarts from block 0.

A trailing ``Integrate``/``Fold``/``PulseStack`` keeps its host bin
bookkeeping and rebinds over a compiled view of its input chain
(:func:`compile_stream`), so the per-sample work runs in the compiled
step; :meth:`~.compiled.CompiledPipeline.run_reduced` also sums on the
device.

With ``mesh=``, each compiled step runs ``S = mesh.shape[shard_axis]``
consecutive blocks, one a shard (:class:`~.sharded.ShardedPipeline`'s
super-step, the ring exchange of tails in place of the carries between
shards).  Only whole super-steps run compiled; the remainder (fewer than
``S`` blocks) is served eagerly, like any partial tail.
"""

from __future__ import annotations

import copy

import torch

from ..base import Base
from ..integration import Integrate
from .compiled import _tree_map

__all__ = ["CompiledStreamView", "compile_stream"]


class CompiledStreamView(Base):
    """A stream head with the eager chain's API and the compiled step's
    execution (see module docstring).

    Parameters
    ----------
    tail : task chain head (not a reduction)
        The chain to compile; a trailing ``Integrate``/``Fold``/
        ``PulseStack`` is handled by :func:`compile_stream`.
    block_samples, fuse
        Passed to :class:`~.compiled.CompiledPipeline`.
    mesh, shard_axis
        A ``parallel.Mesh`` to run each step as a super-step of ``S``
        blocks over the shards along ``shard_axis``
        (:class:`~.sharded.ShardedPipeline`); None for one block a step.
        A mesh over several processes is refused.
    """

    #: source samples per compiled step when nothing pins the block
    _TARGET_BLOCK = 1 << 16

    def __init__(self, tail, *, block_samples=None, fuse=True, mesh=None,
                 shard_axis="time"):
        from .compiled import CompiledPipeline

        if mesh is not None and mesh.spans_processes:
            # the JAX view's np.asarray of a global array with shards on
            # other processes is refused as well
            raise ValueError(
                "compile(mesh=) on a mesh over several processes: the view "
                "reads its whole stream in one process; run "
                "ShardedPipeline(cp, mesh).run_blocks in every process "
                "instead")
        cp = CompiledPipeline(tail, block_samples=block_samples, fuse=fuse)
        if block_samples is None and cp.block_samples < self._TARGET_BLOCK:
            # unpinned chains get the minimal legal block; a streamed view
            # wants big steps, so scale up where the stream allows
            B = cp.block_samples
            avail = min(src.shape[0] - extra for src, extra in zip(
                cp.sources, cp.source_offsets))
            big = -(-self._TARGET_BLOCK // B) * B
            big = max(min(big, avail // B * B), B)
            if big > B:
                try:
                    cp = CompiledPipeline(tail, block_samples=big, fuse=fuse)
                except ValueError:
                    pass  # a padded stage pins the block; keep the default
        if cp.delay != int(cp.delay):
            raise ValueError(
                f"chain has fractional streaming delay {cp.delay}; choose "
                "samples_per_frame values with an integral delay to "
                "compile a read-compatible view")
        self.cp = cp
        self._tail = tail
        self._delay = int(cp.delay)
        self._wu = int(cp.warmup)
        # mesh=None: one block a step; with a mesh, S consecutive blocks
        # a super-step, one a shard
        self._sharded = None
        self._S = 1
        if mesh is not None:
            from .sharded import ShardedPipeline
            self._sharded = ShardedPipeline(cp, mesh, axis_name=shard_axis)
            self._S = self._sharded.n_shards
        # full source blocks available from each source's folded offset;
        # with a mesh only whole super-steps run compiled, the remainder
        # (< S blocks) is served eagerly like any partial tail
        avail = min((src.shape[0] - extra) // cp.block_samples
                    for src, extra in zip(cp.sources, cp.source_offsets))
        self._max_blocks = max(avail // self._S * self._S, 0)
        attrs = tail.meta.get("__attributes__", {})
        super().__init__(
            shape=tail.shape, start_time=tail.start_time,
            sample_rate=tail.sample_rate,
            samples_per_frame=cp.tail_block, dtype=tail.dtype,
            frequency=attrs.get("frequency"),
            sideband=attrs.get("sideband"),
            polarization=attrs.get("polarization"), device=tail.device)
        if self._sharded is None:
            self._step = cp.step_fn()
        else:
            step = self._sharded.sharded_step()

            def super_step(carry, xs):
                carry, ys = step(carry, xs)
                return carry, torch.cat([y.to(self._device) for y in ys])
            self._step = super_step
        self._reset_scan()

    # -- streaming state ---------------------------------------------------
    def _reset_scan(self):
        self._carry = self.cp.init_carry()
        self._next_step = 0      # compiled steps taken (S blocks each)
        self._bufs = []          # per-step outputs, compiled coordinates
        self._buf_start = 0      # compiled index of _bufs[0][0]

    def _read_next_source_block(self):
        """The next step's input: the next block of each source (a tuple
        for a multi-input graph), or with a mesh the ``S`` per-shard
        blocks of the next super-step, each on its shard's device."""
        cp = self.cp
        B, S = cp.block_samples, self._S
        reads = []
        for src, extra in zip(cp.sources, cp.source_offsets):
            src.seek(extra + self._next_step * S * B)
            reads.append(src.read(S * B))
        self._next_step += 1

        def block(i):
            parts = tuple(r[i * B:(i + 1) * B] for r in reads)
            return parts if len(parts) > 1 else parts[0]
        if self._sharded is None:
            return block(0)
        return [_tree_map(lambda t, d=dev: t.to(d), block(i))
                for i, dev in enumerate(self._sharded.devices)]

    def _compiled_read(self, c0, c1):
        """Compiled outputs [c0, c1) (compiled coordinates)."""
        tb = self._S * self.cp.tail_block
        if c0 < self._buf_start:
            self._reset_scan()
        # drop whole retained step outputs that precede c0
        while self._bufs and self._buf_start + tb <= c0:
            self._bufs.pop(0)
            self._buf_start += tb
        if not self._bufs:
            skip = c0 // tb
            while self._next_step < skip:
                self._carry, _ = self._step(self._carry,
                                            self._read_next_source_block())
            self._buf_start = self._next_step * tb
        while self._next_step * tb < c1:
            self._carry, y = self._step(self._carry,
                                        self._read_next_source_block())
            self._bufs.append(y)
        buf = self._bufs[0] if len(self._bufs) == 1 \
            else torch.cat(self._bufs, dim=0)
        return buf[c0 - self._buf_start:c1 - self._buf_start]

    def _eager_read(self, s0, s1):
        self._tail.seek(s0)
        return self._tail.read(s1 - s0)

    # -- Base hook ---------------------------------------------------------
    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        s0 = frame_index * spf
        s1 = min(s0 + spf, self._shape[0])
        d, w = self._delay, self._wu
        lo = w - d                                  # >= 0: warmup >= delay
        hi = self._max_blocks * self.cp.tail_block - d
        pieces = []
        i = s0
        if i < lo:                                  # warmup head: eager
            j = min(s1, lo)
            pieces.append(self._eager_read(i, j))
            i = j
        if i < s1 and i < hi:                       # compiled midsection
            j = min(s1, hi)
            pieces.append(self._compiled_read(i + d, j + d))
            i = j
        if i < s1:                                  # partial last block
            pieces.append(self._eager_read(i, s1))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)

    def close(self):
        self._bufs = []
        super().close()

    def __repr__(self):
        shard = f", shards={self._S}" if self._S > 1 else ""
        return (f"CompiledStreamView({self._tail!r},\n"
                f"    block_samples={self.cp.block_samples}, "
                f"delay={self._delay}, warmup={self._wu}{shard})")


def compile_stream(tail, *, block_samples=None, fuse=True, mesh=None,
                   shard_axis="time"):
    """``tail.compile()``: a read-compatible compiled view of the chain
    (see :class:`CompiledStreamView`).  A trailing reduction is a copy of
    the node reading from a compiled view of its input.  With ``mesh``,
    each step runs ``S = mesh.shape[shard_axis]`` consecutive blocks, one
    a shard, through :class:`~.sharded.ShardedPipeline`."""
    if isinstance(tail, Integrate):
        new = copy.copy(tail)
        new.ih = compile_stream(tail.ih, block_samples=block_samples,
                                fuse=fuse, mesh=mesh, shard_axis=shard_axis)
        new._frame = None
        new._frame_index = None
        new._offset = 0
        return new
    return CompiledStreamView(tail, block_samples=block_samples, fuse=fuse,
                              mesh=mesh, shard_axis=shard_axis)
