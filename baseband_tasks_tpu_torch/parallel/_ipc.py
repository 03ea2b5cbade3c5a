"""Mailboxes in another process's device memory, and flags on the streams.

The push form of the ``halo_remote`` kernel (``parallel/halo_remote.py``)
moves the edges of a time ring whose shards belong to several processes
of one host with no host in the path: each process's launch writes the
edges it sends into a mailbox in the receiving process's device memory,
mapped here through CUDA IPC, and the processes' streams order
themselves on 32-bit flags in device memory by stream memory operations
(``cuStreamWriteValue32`` / ``cuStreamWaitValue32``), the TPU kernel's
semaphores.  A wait holds a stream without occupying an SM, so two
processes that time-slice one card do not spin in each other's slices.

The process group is used once per exchange layout (a :class:`Channel`,
one per rings' owners, block shape and dtype, pads and periodicity): one
``all_gather_object`` of each rank's host name, card (index and UUID),
stream-operation support and mailbox and flag handles, and one of the
outcome of opening the peers' handles.  Each call ``k`` of a channel only
enqueues, on the process's current stream:

1. a sender waits until each receiver's "consumed" flag reaches
   ``k - 2`` (the mailbox is double-buffered by the parity of ``k``);
2. one push launch moves the edges whose source is local: to local
   outputs, into the receivers' mailbox slots, and zeros at local open
   ends of non-periodic rings;
3. the sender writes "ready = k" into each receiver's flags;
4. a receiver waits for "ready >= k" from each of its senders;
5. a second launch copies the received slots into its fresh outputs (the
   callers never get views of a mailbox);
6. the receiver writes "consumed = k" into each sender's flags.

Setup refuses, naming ``halo='ppermute'`` (whose copies go through the
process group) and with nothing switched on its own: before anything is
mapped, when the two ends of a transfer are on different hosts (CUDA IPC
stays inside one host, and the machine has no RDMA) or a process lacks
stream memory operations; on every process, when a peer's card is out
of reach or an IPC open fails anywhere.

Teardown (:meth:`Mailboxes.close`, every process at once): the cards
synchronised, a barrier, every import closed, a barrier, and only then
the own allocations freed, so no allocation is freed while another
process maps it.  A pipeline closes its mailboxes in ``close()``; those
still open when the process group is shut down (``multihost.shutdown``)
or at exit (``atexit``) are closed by :func:`release_all`.
"""

from __future__ import annotations

import atexit
import ctypes
import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..ops._build import launch, library
from . import _transport

__all__ = ["Plan", "Channel", "Mailboxes", "check_reach", "release_all",
           "default_mailboxes"]

_ALIGN = 256                      # bytes: mailbox slots and flag blocks
_BARRIER_S = 120                  # seconds a teardown barrier may wait
MAX_MOVES = 128                   # moves one launch addresses (halo.cu)
_PPERMUTE = "use halo='ppermute', whose copies go through the process group"


def _round(n):
    return -(-int(n) // _ALIGN) * _ALIGN


def check_reach(pairs, hosts, stream_ops=None):
    """Raise, naming ``halo='ppermute'``, when the push form cannot serve
    the transfers ``pairs`` ((src, dst) ranks): their two ends on
    different hosts (``hosts``: a host name per rank), or a process
    without stream memory operations (``stream_ops``: a flag per rank,
    if known)."""
    for src, dst in pairs:
        if hosts[src] != hosts[dst]:
            raise ValueError(
                f"halo='remote' writes a neighbour's edges into its memory "
                f"through CUDA IPC, which stays inside one host, but "
                f"processes {src} ({hosts[src]}) and {dst} ({hosts[dst]}) "
                f"are on different hosts; {_PPERMUTE}")
    if stream_ops is not None:
        for rank in sorted({r for pair in pairs for r in pair}):
            if not stream_ops[rank]:
                raise RuntimeError(
                    f"halo='remote' across processes orders the streams on "
                    f"flags by stream memory operations, which process "
                    f"{rank} lacks; {_PPERMUTE}")


class Plan:
    """The bookkeeping of one exchange layout, the same on every process:
    every edge of the rings of ``ranks`` ((n_time, n_rings), the rank
    owning each shard), which of them cross processes, and where each
    crossing edge lands in its receiver's mailbox.

    An edge is ``(side, t, r, s)``: shard ``(t, r)``'s front (side 0, the
    trailing ``pad_start`` rows of its left neighbour ``s``) or end
    (side 1, the leading ``pad_end`` rows of its right neighbour ``s``);
    ``s`` is None at an open end of a non-periodic ring (zeros)."""

    def __init__(self, ranks, pad_start, pad_end, periodic, row_bytes,
                 me=None):
        ranks = np.asarray(ranks, dtype=np.int64)
        self.ranks = ranks
        self.me = _transport.process_index() if me is None else int(me)
        self.nbytes = (int(pad_start) * int(row_bytes),
                       int(pad_end) * int(row_bytes))
        n_time, n_rings = ranks.shape
        self.edges = []
        for r in range(n_rings):
            for t in range(n_time):
                for side, s in ((0, t - 1), (1, t + 1)):
                    if not 0 <= s < n_time:
                        s = s % n_time if periodic else None
                    self.edges.append((side, t, r, s))
        #: the edges whose ends belong to different processes, in one
        #: order everywhere
        self.transfers = [e for e in self.edges if e[3] is not None
                          and self.src(e) != self.dst(e)]
        #: each receiver's bytes a parity, and each transfer's slot offset
        #: in its receiver's mailbox
        self.parity_bytes, self.offset = {}, {}
        for e in self.transfers:
            d = self.dst(e)
            self.offset[e] = self.parity_bytes.get(d, 0)
            self.parity_bytes[d] = self.offset[e] + _round(self.nbytes[e[0]])
        me = self.me
        self.send_to = sorted({self.dst(e) for e in self.transfers
                               if self.src(e) == me})
        self.recv_from = sorted({self.src(e) for e in self.transfers
                                 if self.dst(e) == me})

    def src(self, edge):
        return int(self.ranks[edge[3], edge[2]])

    def dst(self, edge):
        return int(self.ranks[edge[1], edge[2]])

    def pairs(self):
        """(src, dst) ranks of every transfer."""
        return [(self.src(e), self.dst(e)) for e in self.transfers]

    def push_edges(self):
        """The edges this process's push launch moves: those whose source
        is local (to a local output or a receiver's slot) and the zeros of
        its local open ends."""
        me = self.me
        return [e for e in self.edges
                if (e[3] is None and self.dst(e) == me)
                or (e[3] is not None and self.src(e) == me)]

    def copy_out_edges(self):
        """The edges this process copies out of its own mailbox."""
        return [e for e in self.transfers if self.dst(e) == self.me]


def _check(err, what):
    if err:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def _card_uuid(index):
    return str(torch.cuda.get_device_properties(index).uuid)


def _reachable(index, uuid):
    """Whether this process's card ``index`` can address memory on the
    card ``uuid`` (the same card, or one of this host's with peer
    access)."""
    if uuid == _card_uuid(index):
        return True
    for j in range(torch.cuda.device_count()):
        if _card_uuid(j) == uuid:
            return torch.cuda.can_device_access_peer(index, j)
    return False


def _gather(obj):
    out = [None] * _transport.process_count()
    dist.all_gather_object(out, obj)
    return out


class Channel:
    """The mailboxes and flags of one :class:`Plan` on ``device`` (this
    process's card), set up collectively at construction (every process
    of the group constructs it, in the same order).

    This process's own allocations: a mailbox of two parities of its
    received slots, and a flag block of ``ready[src]`` words (written by
    each sender) then ``consumed[dst]`` words (written by each
    receiver)."""

    def __init__(self, plan, device):
        self.plan = plan
        self.device = device
        self.k = 0
        self._push, self._copy_out = plan.push_edges(), plan.copy_out_edges()
        self._own, self._imports = [], []
        lib, idx = library(), device.index
        me, world = plan.me, _transport.process_count()
        self._world = world
        self._parity = plan.parity_bytes.get(me, 0)
        handles = {}
        for name, nbytes in (("flags", _round(8 * world)),
                             ("mailbox", 2 * self._parity)):
            if not nbytes:
                handles[name] = None
                continue
            ptr = ctypes.c_longlong()
            _check(lib.bbt_ipc_alloc(nbytes, ctypes.byref(ptr), idx),
                   f"cudaMalloc of a {nbytes}-byte IPC {name}")
            self._own.append(ptr.value)
            handle = ctypes.create_string_buffer(64)
            _check(lib.bbt_ipc_export(ptr.value, handle, idx),
                   "cudaIpcGetMemHandle")
            handles[name] = (ptr.value, handle.raw)
        self.flags = handles["flags"][0]
        self.mailbox = handles["mailbox"][0] if handles["mailbox"] else 0
        info = {"host": socket.gethostname(), "device": idx,
                "uuid": _card_uuid(idx),
                "stream_ops": bool(lib.bbt_stream_ops(idx)),
                "flags": handles["flags"][1],
                "mailbox": handles["mailbox"][1] if handles["mailbox"]
                else None}
        infos = _gather(info)
        try:
            check_reach(plan.pairs(), [i["host"] for i in infos],
                        [i["stream_ops"] for i in infos])
        except Exception:
            self._free_own()
            raise
        # map the peers' blocks: the flags of every peer, the mailbox of
        # every receiver
        self.peer_flags, self.peer_mailbox = {}, {}
        problem = None
        for peer in sorted(set(plan.send_to) | set(plan.recv_from)):
            if not _reachable(idx, infos[peer]["uuid"]):
                problem = (f"process {me}'s card cuda:{idx} cannot reach "
                           f"process {peer}'s card {infos[peer]['uuid']}")
                break
            wanted = [("flags", self.peer_flags)]
            if peer in plan.send_to:
                wanted.append(("mailbox", self.peer_mailbox))
            for name, where in wanted:
                ptr = ctypes.c_longlong()
                err = lib.bbt_ipc_open(infos[peer][name], ctypes.byref(ptr),
                                       idx)
                if err:
                    problem = (f"process {me} could not open process "
                               f"{peer}'s {name} (cudaIpcOpenMemHandle: "
                               f"CUDA error {err})")
                    break
                self._imports.append(ptr.value)
                where[peer] = ptr.value
            if problem:
                break
        problems = [p for p in _gather(problem) if p]
        if problems:
            # every process is past its opens: close, then free after all
            self.close_imports()
            if _barrier():
                self._free_own()
            raise RuntimeError(f"halo='remote' across processes could not "
                               f"map its mailboxes: {problems[0]}; "
                               f"{_PPERMUTE}")

    def close_imports(self):
        lib = library()
        torch.cuda.synchronize(self.device)
        for ptr in self._imports:
            _check(lib.bbt_ipc_close(ptr, self.device.index),
                   "cudaIpcCloseMemHandle")
        self._imports = []

    def _free_own(self):
        lib = library()
        for ptr in self._own:
            _check(lib.bbt_ipc_free(ptr, self.device.index), "cudaFree")
        self._own = []

    def _flag(self, fn, addr, value, stream):
        _check(getattr(library(), fn)(addr, value & 0xFFFFFFFF,
                                      self.device.index, stream), fn)

    def run(self, grid, front, end):
        """Enqueue one call: ``grid`` the rings' blocks (None for other
        processes' shards), ``front``/``end`` this process's fresh
        outputs (None elsewhere), all on this channel's card."""
        plan, me, world = self.plan, self.plan.me, self._world
        if not any(plan.nbytes):
            return
        self.k += 1
        k, parity = self.k, self.k % 2
        stream = torch.cuda.current_stream(self.device).cuda_stream
        out = (front, end)

        def source(e):
            # front: the neighbour's trailing rows; end: its leading rows
            block = grid[e[3], e[2]]
            tail = block.numel() * block.element_size() - plan.nbytes[0]
            return block.data_ptr() + (tail if e[0] == 0 else 0)

        def slot(e, base, rank_parity):
            return base + parity * rank_parity + plan.offset[e]

        push = []
        for e in self._push:
            if e[3] is None:
                push.append((e[0], 0, out[e[0]][e[1], e[2]].data_ptr()))
            elif plan.dst(e) == me:
                push.append((e[0], source(e),
                             out[e[0]][e[1], e[2]].data_ptr()))
            else:
                d = plan.dst(e)
                push.append((e[0], source(e), slot(
                    e, self.peer_mailbox[d], plan.parity_bytes[d])))
        copy_out = [(e[0], slot(e, self.mailbox, self._parity),
                     out[e[0]][e[1], e[2]].data_ptr())
                    for e in self._copy_out]
        if k > 2:
            for d in plan.send_to:
                self._flag("bbt_flag_wait", self.flags + 4 * (world + d),
                           k - 2, stream)
        self._launch(push)
        for d in plan.send_to:
            self._flag("bbt_flag_write", self.peer_flags[d] + 4 * me, k,
                       stream)
        for s in plan.recv_from:
            self._flag("bbt_flag_wait", self.flags + 4 * s, k, stream)
        self._launch(copy_out)
        for s in plan.recv_from:
            self._flag("bbt_flag_write",
                       self.peer_flags[s] + 4 * (world + me), k, stream)

    def _launch(self, moves):
        """One launch of the push form: ``moves`` as (side, src, dst)
        addresses (src 0: zeros), fronts first."""
        moves = sorted((m for m in moves if self.plan.nbytes[m[0]]),
                       key=lambda m: m[0])
        if not moves:
            return
        if len(moves) > MAX_MOVES:
            raise ValueError(f"halo_remote's push form moves at most "
                             f"{MAX_MOVES} edges a launch, got {len(moves)}")
        n = len(moves)
        launch("halo_remote", "bbt_halo_push", self.device,
               (ctypes.c_longlong * n)(*(m[1] for m in moves)),
               (ctypes.c_longlong * n)(*(m[2] for m in moves)), n,
               sum(1 for m in moves if m[0] == 0), *self.plan.nbytes)


def _barrier():
    """A barrier of the process group that gives up after _BARRIER_S
    (False: a peer did not come, or there is no group)."""
    if not dist.is_initialized():
        return False
    work = dist.barrier(async_op=True)
    try:
        return bool(work.wait(timeout=datetime.timedelta(
            seconds=_BARRIER_S)))
    except RuntimeError:
        return False


_open = []                        # registries holding channels
_hooked = False


class Mailboxes:
    """The channels of one owner (a pipeline, or the module's default
    for the functions' callers), by exchange layout."""

    def __init__(self):
        self._channels = {}

    def channel(self, key, make_plan, device):
        """The channel of ``key``, set up on ``device`` from the
        :class:`Plan` ``make_plan()`` the first time (a collective of
        every process)."""
        global _hooked
        ch = self._channels.get(key)
        if ch is None:
            ch = Channel(make_plan(), device)
            self._channels[key] = ch
            if self not in _open:
                _open.append(self)
            if not _hooked:
                atexit.register(release_all)
                _hooked = True
        return ch

    def close(self):
        """Release every channel (every process calls it, together)."""
        if self in _open:
            _open.remove(self)
        channels, self._channels = list(self._channels.values()), {}
        if not channels:
            return
        for ch in channels:
            torch.cuda.synchronize(ch.device)
        # a peer may still be using an allocation of this process until
        # the first barrier, and map it until the second
        barrier = _barrier()
        for ch in channels:
            ch.close_imports()
        if barrier and _barrier():
            for ch in channels:
                ch._free_own()


_default = Mailboxes()


def default_mailboxes():
    """The registry of callers that give none."""
    return _default


def release_all():
    """Close every open registry, oldest first (every process calls it,
    together, while the process group is up)."""
    for boxes in list(_open):
        boxes.close()
