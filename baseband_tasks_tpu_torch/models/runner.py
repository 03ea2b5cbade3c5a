"""Double-buffered streaming execution: host reads overlapped with device
steps.

Counterpart of ``baseband_tasks_tpu/models/runner.py``
(:class:`StreamRunner`).  While the device processes block ``i``, a reader
thread reads block ``i + 1`` from the source and ships it, so the run is
bounded by max(host rate, device rate) instead of their sum:

- the reader thread pulls ``prefetch`` blocks ahead through a bounded
  queue (0.2 s put timeout against a stop flag, so a failed consumer
  never leaves it blocked; its exceptions, ``EOFError`` past the stream
  included, surface in the consumer);
- host data (a file reader's host decode, ``read_host``, or its raw
  payload words, ``read_packed``) lands in a ring of ``prefetch + 1``
  pinned host buffers and is copied to the card with ``non_blocking=True``
  on a stream of its own; an event recorded after each copy is what the
  compute stream waits on before the step, and what the reader waits on
  before it refills that slot (the host must never overwrite bytes still
  in flight).  A block allocated on the copy stream is marked
  ``record_stream(compute)``, so the caching allocator cannot hand its
  memory out again before the step is done with it;
- a source whose reads already land on the card (a ``NoiseGenerator`` on
  CUDA) is read on the copy stream and passed through, without a round
  trip through the host;
- the step keeps the overlap-save carries on the device, an absorbed
  reduction is applied block by block with the segment ids placed on the
  device before the thread starts, and nothing synchronises with the
  host until the caller reads the result.

On the CPU the same class runs with no pinning and no side stream: the
reader thread hands over host tensors.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import warnings

import numpy as np
import torch

from ..utils.dtypes import torch_dtype
from .compiled import _tree_map, init_reduction_acc, make_reduction_update

__all__ = ["StreamRunner"]

_PUT_TIMEOUT = 0.2      # s: the reader re-checks the stop flag this often
_JOIN_TIMEOUT = 60.0    # s


def _planes_of(data):
    """Host samples as the planes step takes them: (re, im) float32 views
    of complex data, (data, None) for real data."""
    if np.iscomplexobj(data):
        return (data.real, data.imag)
    return (data, None)


class _PinnedRing:
    """Pinned host slots for the blocks in flight to one CUDA device, and
    the stream their copies run on.

    :meth:`ship` copies a host block (numpy arrays, nested in tuples, with
    ``None`` kept) into the next slot, then to the device on
    :attr:`stream`; it returns the device block and the copy's event.
    Before a slot is refilled the host waits for that slot's last copy.
    """

    def __init__(self, device, n_slots):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots = [None] * n_slots
        self._events = [None] * n_slots
        self._next = 0

    def _slot(self, index, host):
        slot = self._slots[index]
        if slot is None or not _same_layout(slot, host):
            slot = _tree_map(lambda a: None if a is None else torch.empty(
                a.shape, dtype=torch_dtype(a.dtype), pin_memory=True), host)
            self._slots[index] = slot
        return slot

    def ship(self, host, compute):
        """``host`` to the device through the next pinned slot; the block
        is kept alive for ``compute`` (the stream that consumes it)."""
        index = self._next
        self._next = (index + 1) % len(self._slots)
        done = self._events[index]
        if done is not None:
            done.synchronize()      # this slot's last copy has completed
        slot = self._slot(index, host)
        _tree_map(lambda p, a: None if a is None
                  else np.copyto(p.numpy(), a), slot, host)
        with torch.cuda.stream(self.stream):
            dev = _tree_map(lambda p: None if p is None else p.to(
                self.device, non_blocking=True), slot)
            event = torch.cuda.Event()
            event.record(self.stream)
        _tree_map(lambda t: None if t is None else t.record_stream(compute),
                  dev)
        self._events[index] = event
        return dev, event


def _same_layout(slot, host):
    flat_s, flat_h = [], []
    _tree_map(flat_s.append, slot)
    _tree_map(flat_h.append, host)
    return all((s is None and h is None) or (
        s is not None and h is not None and tuple(s.shape) == h.shape
        and s.dtype == torch_dtype(h.dtype)) for s, h in zip(flat_s, flat_h))


class StreamRunner:
    """Run a compiled pipeline over its source stream with prefetch.

    Parameters
    ----------
    cp : CompiledPipeline
        The compiled graph (single-source).  With ``packed=True`` it was
        built with, blocks travel as the source's raw payload words and
        decode inside :meth:`CompiledPipeline.step_fn`.
    prefetch : int
        Blocks the reader thread may run ahead (>= 1; 2 = classic double
        buffering); the card ring holds ``prefetch + 1`` pinned slots.
    planes : bool
        Ship complex blocks as two float32 re/im planes and run the
        pipeline's planes step (:meth:`CompiledPipeline.planes_step`, the
        streaming kernels); outputs come back as an ``(re, im)`` pair
        (``im`` None for real tails).  Not with packed ingest.
    """

    def __init__(self, cp, prefetch=2, planes=False):
        if len(cp.sources) != 1:
            raise ValueError("StreamRunner drives single-source graphs")
        self.cp = cp
        self.prefetch = max(int(prefetch), 1)
        self.planes = bool(planes)
        self.packed = cp._decoders[0] is not None
        if self.packed and self.planes:
            raise ValueError("packed ingest and planes interchange are "
                             "mutually exclusive (the planes step takes "
                             "decoded planes, the packed words decode in "
                             "the normal step)")
        dev = torch.device(cp.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._step = cp.planes_step() if self.planes else cp.step_fn()
        self._update = (None if cp.reduction is None
                        else make_reduction_update(cp.reduction))
        self._ring = (_PinnedRing(self.device, self.prefetch + 1)
                      if self.device.type == "cuda" else None)
        self._ids = {}      # (n_blocks, tail offset) -> (ids, n_seg)

    # -- the reader thread ----------------------------------------------
    def _host_block(self, src, offset, count):
        """One block as host numpy (a tuple for packed or planes blocks),
        or None when the source can only be read through ``read``."""
        if self.packed:
            return src.read_packed(offset, count)
        read_host = getattr(src, "read_host", None)
        if read_host is None:
            return None
        data = read_host(offset, count)
        return _planes_of(data) if self.planes else data

    def _ship(self, src, offset, count, compute):
        """Block ``[offset, offset + count)`` on the runner's device, and
        the event the step must wait for (None on the CPU)."""
        host = self._host_block(src, offset, count)
        if host is None:
            # the source reads onto its own device: on the card, read on
            # the copy stream and hand the block to the compute stream
            if self._ring is None:
                src.seek(offset)
                return src.read(count), None
            with torch.cuda.stream(self._ring.stream):
                src.seek(offset)
                block = src.read(count)
                event = torch.cuda.Event()
                event.record(self._ring.stream)
            block.record_stream(compute)
            return block, event
        if self._ring is None:
            return _tree_map(lambda a: None if a is None else
                             torch.from_numpy(np.ascontiguousarray(a)),
                             host), None
        return self._ring.ship(host, compute)

    def _reader(self, n_blocks, offset, q, stop, compute):
        src = self.cp.source
        block = self.cp.block_samples
        try:
            # source_offsets folds any compiled GetSlice time shift in
            base = self.cp.source_offsets[0] + offset
            # a new thread starts on device 0
            with (torch.cuda.device(self.device) if self._ring is not None
                  else contextlib.nullcontext()):
                for k in range(n_blocks):
                    item = self._ship(src, base + k * block, block, compute)
                    if not _put(q, item, stop):
                        return
        except Exception as exc:  # surface in the consumer
            _put(q, exc, stop)

    # -- the consumer -----------------------------------------------------
    def run(self, n_blocks, offset=0):
        """Process ``n_blocks`` source blocks.

        Without an absorbed reduction, returns the concatenated tail-rate
        output (a tensor on the device; an ``(re, im)`` pair with
        ``planes``).  With one (the graph ends in ``Integrate``/``Fold``/
        ``PulseStack``), returns the same ``(sums, counts)`` as
        ``CompiledPipeline.run_fn(n_blocks)``, the reduction applied block
        by block as it streams; ``offset`` must then be a whole number of
        source blocks so the eager timeline stays block-aligned.
        """
        cp = self.cp
        red = cp.reduction
        dev = self.device
        if red is not None:
            if offset % cp.block_samples:
                raise ValueError(
                    "with an absorbed reduction, offset must be a "
                    f"multiple of block_samples ({cp.block_samples})")
            tail_off = offset // cp.block_samples * cp.tail_block
            # the ids of every block on the device before the reader
            # starts: nothing in the loop copies from the host.  Kept for
            # the next run of the same blocks (the host computes them, at
            # two-double phase precision for a Fold)
            key = (n_blocks, tail_off)
            if key not in self._ids:
                ids_np, n_seg = cp.segment_ids_np(n_blocks, tail_off)
                self._ids = {key: (torch.as_tensor(ids_np, device=dev),
                                   n_seg)}
            ids, n_seg = self._ids[key]
            sums, counts = init_reduction_acc(red, cp._tail.sample_shape,
                                              n_seg, dev)
        carry = cp.init_carry(planes=self.planes)
        compute = (torch.cuda.current_stream(dev) if self._ring is not None
                   else None)
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._reader,
                             args=(n_blocks, offset, q, stop, compute),
                             daemon=True)
        t.start()
        outs = []
        try:
            for i in range(n_blocks):
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                block, event = item
                if event is not None:
                    compute.wait_event(event)
                carry, y = self._step(carry, block)
                if red is not None:
                    if self.planes:
                        y = y[0] if y[1] is None else torch.complex(*y)
                    self._update(sums, counts, y, ids[i])
                else:
                    outs.append(y)
        finally:
            stop.set()
            t.join(timeout=_JOIN_TIMEOUT)
            if t.is_alive():
                warnings.warn(
                    f"StreamRunner reader thread still alive after "
                    f"{_JOIN_TIMEOUT:.0f} s join (a read or copy hung?)",
                    RuntimeWarning, stacklevel=2)
        if red is not None:
            return cp._shape_reduced(sums), cp._shape_reduced(counts)
        if self.planes:
            yr = torch.cat([o[0] for o in outs], dim=0)
            if outs[0][1] is None:
                return yr, None
            return yr, torch.cat([o[1] for o in outs], dim=0)
        return torch.cat(outs, dim=0)


def _put(q, item, stop):
    """Put ``item`` on the bounded queue, re-checking the stop flag every
    ``_PUT_TIMEOUT``; False once the consumer has stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_PUT_TIMEOUT)
            return True
        except queue.Full:
            continue
    return False
