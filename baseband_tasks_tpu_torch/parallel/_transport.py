"""Moving tensors between the processes of a multi-process mesh.

The port's collectives are copies between the devices of one process
(``parallel/halo.py``, ``parallel/corner.py``).  Where the two ends of a
copy belong to different processes the data goes through
``torch.distributed`` instead, by the functions here:

- :func:`send_recv`: a list of point-to-point transfers, posted as one
  ``batch_isend_irecv`` per call with every rank listing the same
  transfers in the same order (each transfer's index is its tag), so no
  pairing can deadlock;
- :func:`all_to_all`: the same list through one ``all_to_all_single``.

Every rank of the default process group calls these with the same list
(the SPMD model of the JAX package: each process runs the same program);
a rank takes part in the transfers it is an end of.  Tensors travel as
their bytes.  NCCL takes CUDA tensors directly; gloo takes host tensors,
so a CUDA tensor is staged through a reused pinned host buffer (its
device copy is ordered behind an event before the buffer is refilled).
``transfer_counts`` counts the calls and the bytes this rank sent, as
``ops.dedisperse.launch_counts`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["process_index", "process_count", "send_recv", "all_to_all",
           "transfer_counts", "reset_transfer_counts"]

#: calls of :func:`send_recv` / :func:`all_to_all` and the bytes this
#: rank sent
transfer_counts = {"calls": 0, "bytes": 0}

# dtypes a transfer header can name (receivers without a ``like``)
_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128,
           torch.int32, torch.int64, torch.uint8, torch.int8, torch.int16,
           torch.bool, torch.float16, torch.bfloat16)
_HEADER = 10                     # dtype code, ndim, up to 8 dimensions


def reset_transfer_counts():
    for k in transfer_counts:
        transfer_counts[k] = 0


def process_index():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _staged():
    """Whether device tensors go through host buffers (gloo)."""
    return dist.get_backend() != "nccl"


class _Slots:
    """Pinned host buffers reused call after call, one per slot key.  A
    buffer whose bytes were last copied to the device is refilled only
    after that copy's event completed."""

    def __init__(self):
        self._bufs = {}

    def take(self, key, nbytes):
        buf, event = self._bufs.get(key, (None, None))
        if event is not None:
            event.synchronize()
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
        self._bufs[key] = (buf, None)
        return buf[:nbytes]

    def copied_out(self, key, device):
        """Mark slot ``key`` as read by a device copy just enqueued on
        ``device``'s current stream."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self._bufs[key] = (self._bufs[key][0], event)


_slots = _Slots()


def _bytes(t):
    """``t``'s bytes, a flat uint8 view of a contiguous copy if needed."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _nbytes(shape, dtype):
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def _control_device():
    """Where small control tensors (headers) live: NCCL moves CUDA
    tensors only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _p2p(transfers, payload, landing):
    """Post one ``batch_isend_irecv`` of this rank's part of
    ``transfers`` ((src, dst) ranks) and wait.  ``payload(i)`` is the
    tensor sent for transfer ``i`` (a device tensor's bytes go through a
    staging slot under gloo); ``landing(i)`` the buffer it arrives in.
    Returns the bytes sent."""
    me = process_index()
    ops, staged, sent = [], set(), 0
    for i, (src, dst) in enumerate(transfers):
        if src == dst:
            raise ValueError(f"transfer {i} from rank {src} to itself")
        if src == me:
            b = _bytes(payload(i))
            if b.device.type == "cuda" and _staged():
                host = _slots.take(("send", i), b.numel())
                host.copy_(b, non_blocking=True)
                staged.add(b.device)
                b = host
            sent += b.numel()
            ops.append(dist.P2POp(dist.isend, b, dst, tag=i))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, landing(i), src, tag=i))
    for device in staged:
        # the staging copies (on the tensors' cards' current streams,
        # whichever card is current) must land before gloo reads the
        # slots
        torch.cuda.current_stream(device).synchronize()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return sent


def _headers(pairs):
    """The shape and dtype of every transfer, sent ahead of it:
    ``{i: (shape, dtype)}`` for this rank's received transfers."""
    dev = _control_device()
    heads = {}

    def payload(i):
        t = pairs[i][2]
        h = torch.zeros(_HEADER, dtype=torch.int64)
        h[0], h[1] = _DTYPES.index(t.dtype), t.ndim
        h[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
        return h.to(dev)

    def landing(i):
        heads[i] = torch.zeros(_HEADER, dtype=torch.int64, device=dev)
        return heads[i]

    _p2p([(s, d) for s, d, _ in pairs], payload, landing)
    out = {}
    for i, h in heads.items():
        h = h.cpu()
        out[i] = (tuple(int(d) for d in h[2:2 + int(h[1])]),
                  _DTYPES[int(h[0])])
    return out


def send_recv(pairs, *, shapes=False, device=None):
    """Point-to-point transfers between processes.

    ``pairs`` lists ``(src_rank, dst_rank, tensor)`` transfers, the same
    ranks in the same order on every rank.  On ``src`` the tensor is the
    one sent; on ``dst`` it is a tensor whose shape, dtype and device the
    received one takes; elsewhere it is ignored.  With ``shapes`` (the
    same on every rank) the senders first send each tensor's shape and
    dtype, and receivers give None and receive onto ``device``.  Returns
    one entry per transfer: the received tensor where this rank is the
    receiver, else None.
    """
    pairs = list(pairs)
    if not pairs:
        return []
    heads = _headers(pairs) if shapes else {}
    me = process_index()
    specs, landed = {}, {}
    for i, (src, dst, t) in enumerate(pairs):
        if dst == me and src != me:
            if shapes:
                specs[i] = heads[i] + (torch.device(device or "cpu"),)
            else:
                specs[i] = (tuple(t.shape), t.dtype, t.device)

    def landing(i):
        shape, dtype, dev = specs[i]
        n = _nbytes(shape, dtype)
        if dev.type == "cuda" and _staged():
            landed[i] = _slots.take(("recv", i), n)
        else:
            landed[i] = torch.empty(n, dtype=torch.uint8, device=dev)
        return landed[i]

    sent = _p2p([(s, d) for s, d, _ in pairs], lambda i: pairs[i][2],
                landing)
    transfer_counts["calls"] += 1
    transfer_counts["bytes"] += sent
    out = [None] * len(pairs)
    for i, buf in landed.items():
        shape, dtype, dev = specs[i]
        if buf.device != dev:
            # out of the staging slot; the slot is refilled only after
            # this copy's event
            dst = torch.empty(buf.numel(), dtype=torch.uint8, device=dev)
            dst.copy_(buf, non_blocking=True)
            _slots.copied_out(("recv", i), dev)
            buf = dst
        out[i] = buf.view(dtype).reshape(shape)
    return out


def all_to_all(pairs):
    """The transfers of :func:`send_recv` (every receiver giving its
    like) through one ``all_to_all_single``: each rank sends the bytes of
    its transfers to every other rank in one buffer, in transfer order.
    Every rank of the group calls it, an end of a transfer or not."""
    pairs = list(pairs)
    if not pairs:
        return []
    me, n = process_index(), process_count()
    outgoing = [[] for _ in range(n)]
    incoming = [[] for _ in range(n)]
    for i, (src, dst, t) in enumerate(pairs):
        if src == dst:
            raise ValueError(f"transfer {i} from rank {src} to itself")
        if src == me:
            outgoing[dst].append(_bytes(t))
        elif dst == me:
            incoming[src].append((i, t))
    any_t = next((t for _, _, t in pairs if t is not None), None)
    dev = any_t.device if any_t is not None else _control_device()
    if dev.type == "cuda" and _staged():
        dev = torch.device("cpu")     # gloo: through the host
    send = [b.to(dev) for group in outgoing for b in group]
    send_buf = torch.cat(send) if send else \
        torch.empty(0, dtype=torch.uint8, device=dev)
    in_sizes = [sum(_nbytes(t.shape, t.dtype) for _, t in group)
                for group in incoming]
    recv_buf = torch.empty(sum(in_sizes), dtype=torch.uint8, device=dev)
    dist.all_to_all_single(recv_buf, send_buf, in_sizes,
                           [sum(b.numel() for b in g) for g in outgoing])
    transfer_counts["calls"] += 1
    transfer_counts["bytes"] += send_buf.numel()
    out, pos = [None] * len(pairs), 0
    for group in incoming:
        for i, like in group:
            nb = _nbytes(like.shape, like.dtype)
            out[i] = recv_buf[pos:pos + nb].to(like.device).view(
                like.dtype).reshape(like.shape)
            pos += nb
    return out
