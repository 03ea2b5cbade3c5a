"""Observability: per-stage throughput counters, profiler traces and the
port's host spans.

Counterpart of ``baseband_tasks_tpu/utils/profiling.py`` (the upstream
baseband-tasks has no tracing or profiling hooks): (1)
``monitor(stream)`` wraps any stream node so its frames are counted and
timed, with a pipeline-wide report; (2) ``trace(path)`` is a context
manager around ``torch.profiler`` (CPU and, where there is a card, CUDA
activities) that writes a Chrome trace under ``path``; (3)
``span(name)`` marks a stretch of the port's host code: while a profiler
runs it is a ``record_function`` range, a ``user_annotation`` event on
the same timeline as the card's kernels and copies, and otherwise a
shared no-op.  Every span of the port goes through it.

On a card a frame's launches return before the card has run them, so a
monitor on a CUDA stream synchronizes that device inside the counted call:
its ``seconds`` are the card's wall time for the frames (the upstream
nodes' time included, as the JAX package's monitors count it).  On the
CPU nothing is synchronized.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from . import units as u

__all__ = ["monitor", "StreamMonitor", "trace", "span"]

_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A context naming the host code it wraps in a profiler's trace.

    While ``torch.profiler`` (or the autograd profiler) runs, a
    ``record_function(name)`` range; otherwise one shared no-op context,
    so a span costs one check when nothing is traced (an ungated
    ``record_function`` costs some microseconds even then)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StreamMonitor:
    """Counts samples and wall time of every ``_read_frame`` of a stream."""

    def __init__(self, stream, name=None):
        self.stream = stream
        self.name = name or type(stream).__name__
        self.samples = 0
        self.frames = 0
        self.seconds = 0.0
        orig = stream._read_frame
        device = getattr(stream, "device", None)
        sync = (torch.cuda.synchronize
                if device is not None and torch.device(device).type == "cuda"
                else None)

        def counted(frame_index):
            if sync is not None:
                sync(device)          # earlier work is not this frame's
            t0 = time.perf_counter()
            out = orig(frame_index)
            if sync is not None:
                sync(device)
            self.seconds += time.perf_counter() - t0
            self.frames += 1
            self.samples += len(out)
            return out

        stream._read_frame = counted

    @property
    def samples_per_second(self):
        return self.samples / self.seconds if self.seconds else 0.0

    @property
    def realtime_factor(self):
        """Processing speed relative to the stream's own sample rate."""
        rate = self.stream.sample_rate.to_value(u.Hz)
        return self.samples_per_second / rate if rate else 0.0

    def report(self):
        return (f"{self.name}: {self.samples} samples in {self.frames} "
                f"frames, {self.seconds:.3f} s "
                f"({self.samples_per_second:.3e} samples/s, "
                f"{self.realtime_factor:.2f}x realtime)")

    def __repr__(self):
        return f"<StreamMonitor {self.report()}>"


def monitor(stream, whole_chain=True):
    """Attach monitors to a stream (and, by default, its whole ih chain).

    Returns a list of :class:`StreamMonitor`, tail first.
    """
    monitors = []
    node = stream
    seen = set()
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        monitors.append(StreamMonitor(node))
        if not whole_chain:
            break
        node = getattr(node, "ih", None)
        if node is None:
            ihs = getattr(monitors[-1].stream, "ihs", None)
            if ihs:
                for sub in ihs:
                    monitors.extend(monitor(sub, whole_chain=True))
            break
    return monitors


@contextlib.contextmanager
def trace(path=None):
    """Profile a block of work with ``torch.profiler`` (CPU activities,
    and CUDA ones where there is a card) and write its Chrome trace to
    ``path/trace.json`` (default directory: ``torch-trace`` in the
    temporary directory).  Yields the directory."""
    from torch.profiler import ProfilerActivity, profile
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
