"""The readers of the port's spans on a hand-made chrome trace: two
calls of the flagship entry, three steps, one idle gap that begins
inside a ``wideband.call`` and one that begins outside."""

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import WINDOW, Trace

SPAN_METRICS = ("wideband.prep_ms", "wideband.step_ms", "mesh.shard_ms",
                "wideband.idle_pct", "wideband.ops_per_step")


def ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "tid": tid}


def span(name, ts, dur, tid=1):
    return ev(name, "user_annotation", ts, dur, tid)


BASE = [
    span(WINDOW, 1000, 100),
    span("bench.unit", 1000, 100),
    span("wideband.run", 1000, 40),
    span("wideband.run", 1050, 40),
    ev("k1", "kernel", 1000, 30),
    ev("early", "kernel", 990, 15),       # starts before the window
    ev("k2", "kernel", 1035, 7),
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1048, 20),
    ev("Memset (Device)", "gpu_memset", 1068, 32),
    ev("late", "kernel", 1200, 5),        # after the window
]

PORT = [
    # call 1: shard, prep, two steps; idle 1030-1035 begins inside it
    span("wideband.call", 1000, 40),
    span("mesh.shard", 1002, 4),
    span("wideband.prep", 1006, 4),
    span("wideband.step", 1010, 15),
    span("wideband.step", 1025, 15),
    span("mesh.shard", 1003, 2, tid=2),   # another thread: not the call's
    # idle 1042-1048 begins between the calls
    # call 2: shard, prep, one step
    span("wideband.call", 1050, 40),
    span("mesh.shard", 1051, 4),
    span("wideband.prep", 1055, 3),
    span("wideband.step", 1058, 30),
    span("mesh.shard", 1092, 4),          # outside every call
]


def read(name, events):
    run = SimpleNamespace(trace=Trace(events), spans={}, work=(0.0, 0.0))
    return harness.module("metrics", name).read(run)


def test_span_readers_on_a_known_layout():
    events = BASE + PORT
    assert read("wideband.prep_ms", events) == pytest.approx((4 + 3) / 2e3)
    assert read("wideband.step_ms", events) == pytest.approx(
        (15 + 15 + 30) / 3e3)
    assert read("mesh.shard_ms", events) == pytest.approx((4 + 4) / 2e3)
    # gaps 1030-1035 (inside call 1) and 1042-1048 (between the calls)
    assert read("wideband.idle_pct", events) == pytest.approx(5.0)
    assert read("device.idle", events) == pytest.approx(11.0)
    # k1, k2, the copy and the fill start inside the window
    assert read("wideband.ops_per_step", events) == pytest.approx(4 / 3)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_find_nothing_without_port_spans(name):
    assert read(name, BASE) is None
