"""The GUPPI full-Stokes cell on the CPU at a small size (the port's plain
versions against the plain reference), the reference's window and fold
rows against the port's, the work functions against numbers worked out
by hand, and the cell's per-layer readers on a CPU run and on a
hand-made device trace."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, peaks
from benchmark.tests import small, test_faults
from benchmark.tests.test_imports import ROOT, fresh
from benchmark.trace import WINDOW, Trace

SPEC = harness.load_spec()
CELL = "guppi_b1937_stokes.resident_10s"
METRICS = ("k3_stokes.roofline", "guppi.repack_roofline",
           "wideband.repack_ms")
# the accepted metrics that read a device trace, which the CPU has not
DEVICE = ("kernels_roofline", "device.idle", "k3_stokes.roofline",
          "guppi.repack_roofline")
SYSTEM = harness.module("systems", "guppi_b1937_stokes")
REF = harness.module("reference", "guppi_b1937_stokes")


def small_cfg():
    """The deployment at 4 channels, DM 30, a 4096-sample window (pads
    896 / 896); its 2048 bins hold 1.19 samples each a period."""
    cfg = harness.config_of(SPEC, "guppi_b1937_stokes")
    cfg.update(n_chan=4, dm=30.0, block_samples=2048,
               window={"n_fft": 4096, "pad_start": 896, "pad_end": 896,
                       "valid_samples": 2304})
    return cfg


def run(trace=False, control=False, seed=2 ** 31 + 13):
    """The cell at the small size: 3 calls of 8 steps a unit, so each
    bin of a unit sums some 27 samples."""
    traffic = small.traffic("resident_10s", steps_per_call=8)
    return harness.run_cell(SPEC, harness.cell_of(SPEC, CELL), seed, 0.3,
                            trace, torch.device("cpu"), time.perf_counter(),
                            cfg=small_cfg(), traffic=traffic,
                            control=control)


def test_cell_is_correct_and_its_control_is_not():
    res, lines = run(control=True)
    assert res["correct"], lines
    assert set(res["check"]) == set(REF.LIMITS)
    for name, num in res["check"].items():
        assert num["value"] <= num["limit"], (name, num)
    assert set(res["metrics"]) == {"samples_per_s", "subint_ms_p95",
                                   "setup_s"}
    assert any(v > res["check"][n]["limit"]
               for n, v in res["control"].items()), res["control"]
    assert res["control_correct"] is False


def test_traced_run_reads_the_span_and_no_device_metric():
    """On the CPU the device-trace readers find no kernel; the span
    readers find the port's ``wideband.repack`` and the flagship entry's
    spans, which this cell runs too."""
    res, _ = run(trace=True)
    assert res["correct"]
    assert not set(DEVICE) & set(res["metrics"])
    for name in ("wideband.repack_ms", "wideband.enqueue_ms",
                 "wideband.prep_ms", "wideband.step_ms", "mesh.shard_ms"):
        assert res["metrics"][name]["value"] > 0, name


FAULTS = (test_faults.flagship_state_unchanged,
          test_faults.flagship_half_batch, test_faults.flagship_altered)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_is_not_correct(fault, monkeypatch):
    """The faults the flagship's cells are checked with, planted under
    this cell's run: a step whose stream phase never advances, half of
    the samples folded and doubled, a profile cell altered."""
    fault(monkeypatch)
    res, _ = run()
    assert res["attempted"] > 0
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cfg", [harness.config_of(SPEC,
                                                   "guppi_b1937_stokes"),
                                 small_cfg()], ids=["full", "small"])
def test_window_matches_the_port(cfg):
    pipe = SYSTEM.pipeline(cfg, "cpu")
    assert REF.geometry(cfg) == (
        pipe.pad_start + pipe.block_samples + pipe.pad_end, pipe.pad_start,
        pipe.pad_end, pipe.block_samples)


@pytest.mark.parametrize("cfg", [harness.config_of(SPEC,
                                                   "guppi_b1937_stokes"),
                                 small_cfg()], ids=["full", "small"])
def test_fold_rows_match_the_port(cfg):
    """Exact rational polyco rows equal the port's two-double rows at
    the offsets of a unit's 78 calls."""
    pipe = SYSTEM.pipeline(cfg, "cpu")
    t = pipe.block_samples
    offsets = [k * t for k in range(78)]
    port = pipe.fold_model.table(np.array(offsets), t)
    rows = REF.fold_rows(cfg, offsets, t)
    assert [list(rows[o]) for o in offsets] == port[:, :2].tolist()


def test_work_functions():
    cfg = harness.config_of(SPEC, "guppi_b1937_stokes")
    nbytes, ops = SYSTEM.work_per_step(cfg)
    # 64 x 200,704 GUPPI words in, a 2049 x 64 x 4 float32 profile out
    assert nbytes == 51_380_224 + 2_098_176
    # 128 lanes x (two FFTs of 2^18: 10 x 262144 x 18, the response
    # 6 x 262144) and 64 channels x 12 x 200,704 Stokes operations
    assert ops == 128 * (47_185_920 + 1_572_864) + 154_140_672
    assert peaks.work_bound_s(nbytes, ops)[1] == "operations"
    # the words read once, both planes written once: 8 bytes a sample
    assert SYSTEM.repack_work(cfg) == (102_760_448, 0)
    kb, kops = SYSTEM.k3_stokes_work(cfg, 4)
    # both planes (2^18 x 128 x 8 bytes), a quarter more for the partner
    # column of each 4-lane tile, the 2049 x (3 x 128 + 1) profile
    assert kb == 268_435_456 + 67_108_864 + 3_155_460
    assert kops == 128 * 5 * 262_144 * 9 + 154_140_672
    assert peaks.work_bound_s(kb, kops)[1] == "bytes"


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_readers_on_a_known_trace():
    """Two calls, each a repack and a Stokes K3 of 10 us and another
    kernel of 20 us; repack spans of 3 and 5 us."""
    events = [ev(WINDOW, "user_annotation", 1000, 100)]
    for a in (1000, 1050):
        events += [
            ev("wideband.call", "user_annotation", a, 45),
            ev("wideband.repack", "user_annotation", a + 1,
               3 if a == 1000 else 5),
            ev("void bbt::guppi_repack_kernel(unsigned int const*, "
               "unsigned int*, unsigned int*, int, int)", "kernel", a, 10),
            ev("void bbt::k3_fold_kernel<true, float, -1, -1>(float const*)",
               "kernel", a + 10, 10),
            ev("void bbt::k2_reg_kernel<false, float, float, 9, 4>()",
               "kernel", a + 20, 20)]
    events.append(ev("void bbt::k3_fold_kernel<true, __nv_bfloat16, -1, "
                     "-1>()", "kernel", 1090, 5))
    # the harness scales a unit's work by the traced units
    work = tuple(2 * w for w in (
        SYSTEM.Work(1.675e6, {"guppi_repack": 3.35e5, "k3_fold_stokes": 0.5}),
        SYSTEM.Work(0.0, {"guppi_repack": 0.0, "k3_fold_stokes": 6.7e5})))
    got = {m: harness.module("metrics", m).read(SimpleNamespace(
        trace=Trace(events), spans={}, work=work))
        for m in METRICS + ("kernels_roofline",)}
    # bounds: 1 us over 85 us of kernels; 0.2 us over the repacks' 20 us;
    # 0.02 us of operations over the float K3's 20 us
    assert got["kernels_roofline"] == pytest.approx(100 / 85)
    assert got["guppi.repack_roofline"] == pytest.approx(1.0)
    assert got["k3_stokes.roofline"] == pytest.approx(0.1)
    assert got["wideband.repack_ms"] == pytest.approx(4e-3)


def test_work_scales_with_its_kernels():
    """A unit's work is the configuration's (bytes, operations) as plain
    numbers, with each rooflined kernel's share scaled alongside."""
    w = SYSTEM.Work(10.0, {"guppi_repack": 4, "k3_fold_stokes": 3})
    for got in (w * 3, 3 * w):
        assert float(got) == 30.0 and isinstance(got, SYSTEM.Work)
        assert got.kernels == {"guppi_repack": 12, "k3_fold_stokes": 9}
    assert w.kernels == {"guppi_repack": 4, "k3_fold_stokes": 3}
    assert type(w / 2) is float and peaks.work_bound_s(w, w)[0] > 0


@pytest.mark.parametrize("name", METRICS)
def test_readers_find_nothing_in_another_systems_run(name):
    """The flagship's (bytes, operations) work and a trace without the
    GUPPI kernels and spans: nothing to read."""
    events = [ev(WINDOW, "user_annotation", 1000, 100),
              ev("wideband.call", "user_annotation", 1000, 50),
              ev("void bbt::k3_fold_kernel<false, float, 9, 3>()", "kernel",
                 1000, 30)]
    run = SimpleNamespace(trace=Trace(events), spans={}, work=(1e6, 1e9))
    assert harness.module("metrics", name).read(run) is None


REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
ref = harness.module("reference", "guppi_b1937_stokes")
cfg = harness.config_of(harness.load_spec(), "guppi_b1937_stokes")
cfg.update(n_chan=4, dm=30.0, block_samples=2048,
           window={{"n_fft": 4096, "pad_start": 896, "pad_end": 896,
                    "valid_samples": 2304}})
words = torch.zeros((4, 2304), dtype=torch.int32)
ref.expected(cfg, {{}}, {{"pool": [words]}}, [((0, 0),)], "cpu")
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_reference_loads_neither_jax_nor_the_port():
    tops = set(fresh(REFERENCE.format(root=ROOT))["tops"])
    assert not tops & (set(harness.FORBIDDEN) | {"baseband_tasks_tpu_torch"})
