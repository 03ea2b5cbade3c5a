"""The traced run: ``torch.profiler`` over whole units of work, its chrome
trace read back into device intervals, and what the per-layer metrics and
the result's ``breakdown`` take from them.

Device activity is every kernel, copy and fill on the card
(``kernel``, ``gpu_memcpy``, ``gpu_memset``); the traced window is the
host span ``bench.window`` around the traced units, which start and end
with the card idle (each unit ends by fetching its output).
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("user_annotation", "cpu_op")


class Trace:
    """What a traced window holds, in seconds (trace times are in us)."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' "
                               f"spans, expected 1")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6

        def inside(e):
            return (e.get("ph") == "X" and float(e["ts"]) < self.t1
                    and float(e["ts"]) + float(e.get("dur", 0)) > self.t0)
        self.device = [e for e in events if e.get("cat") in _DEVICE_CATS
                       and inside(e)]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.host = [e for e in events if e.get("cat") in _HOST_CATS
                     and inside(e)]
        self.busy = _union([(max(float(e["ts"]), self.t0),
                             min(float(e["ts"]) + float(e["dur"]), self.t1))
                            for e in self.device])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self.kernel_s = sum(float(e["dur"]) for e in self.kernels) * 1e-6

    def host_to_device(self):
        """(bytes, device seconds) of the host-to-device copies."""
        nbytes = secs = 0.0
        for e in self.device:
            if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", ""):
                b = (e.get("args") or {}).get("bytes")
                if b is None:
                    continue
                nbytes += float(b)
                secs += float(e["dur"]) * 1e-6
        return nbytes, secs

    def device_ops(self, n=10):
        """The ``n`` device operations that took most time: [[name, s]]."""
        by = defaultdict(float)
        for e in self.device:
            by[e["name"][:120]] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n=10):
        """Idle device time within the window by what the host was doing
        when each gap began (the innermost host span and operation open
        then, on any thread): [[label, s]], the ``n`` largest."""
        gaps, last = [], self.t0
        for a, b in self.busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if last < self.t1:
            gaps.append((last, self.t1))
        by = defaultdict(float)
        labels = self._host_labels([a for a, _ in gaps])
        for (a, b), label in zip(gaps, labels):
            by[label] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_labels(self, times):
        """For each of the ascending ``times``, the innermost host span and
        operation open then, in one sweep over the host events."""
        events = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["cat"], e["name"]) for e in self.host
                        if e.get("name") != WINDOW)
        out, active, k = [], [], 0
        for t in times:
            while k < len(events) and events[k][0] <= t:
                active.append(events[k])
                k += 1
            active = [ev for ev in active if ev[1] > t]
            best = {}
            for s, e, cat, name in active:
                if cat not in best or e - s < best[cat][0]:
                    best[cat] = (e - s, name)
            parts = [best[c][1] for c in _HOST_CATS if c in best]
            out.append(" / ".join(parts)[:120] if parts else "no host span")
        return out


def _union(intervals):
    out = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def traced(fn, device):
    """Run ``fn()`` under ``torch.profiler`` inside the ``bench.window``
    span; returns ``(fn's result, Trace)``.  The chrome trace goes to a
    temporary file (under ``TMPDIR``) that is removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)
