"""The trace reader on a hand-made chrome trace."""

import pytest

from benchmark.trace import WINDOW, Trace


def ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "args": args}


def test_busy_idle_copies_and_gaps():
    events = [
        ev(WINDOW, "user_annotation", 1000, 100),
        ev("bench.unit", "user_annotation", 1000, 100),
        ev("aten::copy_", "cpu_op", 1040, 30),
        ev("k1", "kernel", 1000, 20),
        ev("k2", "kernel", 1010, 20),          # overlaps k1
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1050, 10,
           bytes=5000),
        ev("k3", "kernel", 1090, 20),          # runs past the window
        ev("late", "kernel", 1200, 5),         # outside
    ]
    tr = Trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((30 + 10 + 10) * 1e-6)
    assert tr.kernel_s == pytest.approx(60e-6)
    assert tr.host_to_device() == (5000.0, pytest.approx(10e-6))
    gaps = dict(tr.idle_gaps())
    assert gaps["bench.unit / aten::copy_"] == pytest.approx(30e-6)
    assert gaps["bench.unit"] == pytest.approx(20e-6)
    assert tr.device_ops()[0] == ["k3", pytest.approx(20e-6)] or \
        tr.device_ops()[0][1] == pytest.approx(20e-6)
