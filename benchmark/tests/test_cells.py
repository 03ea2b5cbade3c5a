"""Each cell run end to end on the CPU at a small size: the port's plain
versions of its kernels against the plain reference (the comparison
that decides ``correct``), the result line's keys, and the controls."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import small

SPEC = harness.load_spec()
CELLS = small.cells(SPEC)


def small_of(cell):
    c = CELLS[cell]
    return c, small.flagship(), small.traffic(c["traffic"])


def run(cell, seed=2 ** 31 + 11, seconds=0.3, trace=False, control=False):
    c, cfg, traffic = small_of(cell)
    return harness.run_cell(SPEC, c, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            cfg=cfg, traffic=traffic, control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_the_reference(cell):
    res, lines = run(cell, control=True)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    for name, num in res["check"].items():
        assert num["value"] <= num["limit"], (name, num)
    assert set(res["metrics"]) == {"samples_per_s", "subint_ms_p95",
                                   "setup_s"}
    assert res["device"]["platform"] == "cpu"
    # the control, the reference in bfloat16 in the program's place,
    # fails a number, and the harness's verdict on it says so
    assert any(v > res["check"][n]["limit"]
               for n, v in res["control"].items()), res["control"]
    assert res["control_correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell):
    res, _ = run(cell, trace=True)
    assert res["correct"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    # on the CPU no metric read from the device trace has anything
    assert not {"kernels_roofline", "device.idle", "h2d.gbps"} & set(
        res["metrics"])


def test_same_seed_same_inputs():
    a, _ = run("flagship_fold.resident", seed=7, control=True)
    b, _ = run("flagship_fold.resident", seed=7, control=True)
    assert a["control"] == b["control"]
