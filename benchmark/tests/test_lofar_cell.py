"""The LOFAR HBA correlator cell on the CPU at a small size (the port's
compiled correlator against the plain reference), faults planted in the
port that must fail the comparison, the work functions against numbers
worked out by hand, and the cell's per-layer readers on a hand-made
device trace and on another system's run."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, peaks
from benchmark.tests import small
from benchmark.tests.test_imports import ROOT, fresh
from benchmark.trace import WINDOW, Trace

SPEC = harness.load_spec()
CELL = "lofar_hba_cobalt.dump_1s"
METRICS = ("correlator.x_roofline", "compiled.block_ms", "compiled.idle_pct")
SYSTEM = harness.module("systems", "lofar_hba_cobalt")
REF = harness.module("reference", "lofar_hba_cobalt")

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def small_cfg():
    """The node at 4 stations, 2 subbands, 8 channels, dumps of 64
    spectra in blocks of 16, delays of up to 16 samples (a lead of 2
    spectra)."""
    cfg = harness.config_of(SPEC, "lofar_hba_cobalt")
    cfg.update(n_station=4, n_subband=2, n_chan=8, n_avg=64,
               block_samples=128, max_delay_samples=16)
    return cfg


def run(trace=False, control=False, seed=2 ** 31 + 13):
    traffic = small.traffic("dump_1s", steps_per_call=4)
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
    # the control fails a limit by more than 10x
    assert any(v > 10 * res["check"][n]["limit"]
               for n, v in res["control"].items()), res["control"]
    assert res["control_correct"] is False


def test_traced_run_reads_nothing_on_the_cpu():
    """No kernel, no device activity: every metric of the cell reads
    nothing on the CPU, the span readers included."""
    res, _ = run(trace=True)
    assert res["correct"]
    assert not (set(METRICS) | {"kernels_roofline", "device.idle"}) & set(
        res["metrics"])


def fringe_flipped(mp):
    from baseband_tasks_tpu_torch.models import correlator
    orig = correlator._phase_rotation

    def flipped(s, anchor, rate_hz, n_chan, d, lo, spf):
        return orig(s, anchor, rate_hz, n_chan, d,
                    None if lo is None else -lo, spf)
    mp.setattr(correlator, "_phase_rotation", flipped)


def fraction_dropped(mp):
    from baseband_tasks_tpu_torch.models import correlator
    orig = correlator._phase_rotation

    def fringe_only(s, anchor, rate_hz, n_chan, d, lo, spf):
        s, rot = orig(s, anchor, rate_hz, n_chan, d, lo, spf)
        _, slope = orig(s, anchor, rate_hz, n_chan, d, None, spf)
        return s, (rot / slope).astype(np.complex64)
    mp.setattr(correlator, "_phase_rotation", fringe_only)


def cross_hands_swapped(mp):
    from baseband_tasks_tpu_torch.models.correlator import CrossMultiply
    orig = CrossMultiply.task

    def swapped(self, data):
        return orig(self, data)[..., [0, 2, 1, 3]]
    mp.setattr(CrossMultiply, "task", swapped)


FAULTS = (fringe_flipped, fraction_dropped, cross_hands_swapped)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_is_not_correct(fault, monkeypatch):
    """The fringe stopped with the wrong sign, the fractional delay's
    phase slope left out, XY* and YX* swapped: each fails the
    comparison."""
    fault(monkeypatch)
    res, _ = run()
    assert res["attempted"] > 0
    assert not res["correct"], res["check"]


def test_work_functions():
    cfg = harness.config_of(SPEC, "lofar_hba_cobalt")
    assert SYSTEM.n_baselines(cfg) == 1953
    # 62 x 30 x 2 x 196,608 complex64 samples in, 1953 x 64 x 30 x 4
    # complex64 visibilities out
    samples = 731_381_760
    assert SYSTEM.x_stage_work(cfg) == (
        samples * 8 + 119_992_320,
        8 * 1953 * 4 * 64 * 30 * 3072)
    nbytes, ops = SYSTEM.work_per_dump(cfg)
    assert nbytes == 5_971_046_400
    # 11,427,840 FFTs of 64 points (5 x 64 x 6 each), 6 operations a
    # rotated sample, 8 a product
    assert ops == (11_427_840 * 1920 + 6 * samples
                   + 368_616_407_040) == 394_946_150_400
    assert peaks.work_bound_s(nbytes, ops)[1] == "operations"
    assert peaks.work_bound_s(*SYSTEM.x_stage_work(cfg))[0] == \
        pytest.approx(5.5017e-3, rel=1e-4)


def ev(name, cat, ts, dur, ext=None, tid=1):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
         "tid": tid}
    if ext is not None:
        e["args"] = {"External id": ext}
    return e


def known_trace():
    """Two calls of two blocks each (100 us window): each block's X span
    holds a gather op (kernel 5 us) and a product op (kernel 4 us); the
    F stage's op (kernel 3 us) and the sums' update (2 us) lie outside
    it; a gather op of another thread inside the span's time is not
    its.  Each call's span ends as its last kernel does, so the card's
    idle time after it began outside the call."""
    events = [ev(WINDOW, "user_annotation", 1000, 100)]
    ext = iter(range(1, 1000))
    for c, a in enumerate((1000, 1050)):
        events.append(ev("compiled.call", "user_annotation", a, 36))
        for b in range(2):
            t = a + 20 * b
            events += [ev("compiled.block", "user_annotation", t, 16),
                       ev("correlator.x", "user_annotation", t + 4, 8)]
            ops = [(t, "aten::_fft_c2c", 3), (t + 5, "aten::index", 5),
                   (t + 9, "aten::mul", 4), (t + 13, "aten::index_add_", 2)]
            dev = t + 1
            for ts, name, dur in ops:
                i = next(ext)
                events += [ev(name, "cpu_op", ts, 1, i),
                           ev(f"kernel of {name}", "kernel", dev, dur, i)]
                dev += dur
            i = next(ext)
            events += [ev("aten::index", "cpu_op", t + 6, 1, i, tid=2),
                       ev("other thread's gather", "kernel", dev, 1, i)]
    return events


def read(name, events, work=(1.0, 1.0)):
    run = SimpleNamespace(trace=Trace(events), spans={}, work=work)
    return harness.module("metrics", name).read(run)


def test_readers_on_a_known_trace():
    events = known_trace()
    # the X stage's bound: 0.125 us of bytes over 4 x 9 us of kernels
    x = SYSTEM.Work(0.0, {"correlator.x": 3.35e6 / 4})
    work = (SYSTEM.Work(1.675e6, {"correlator.x": 1.675e6 / 4}), x)
    assert read("correlator.x_roofline", events, work) == \
        pytest.approx(100 * 0.125e-6 / 36e-6)
    secs, n = harness.module("metrics", "correlator.x_roofline") \
        .launched_inside(Trace(events), "correlator.x")
    assert n == 8 and secs == pytest.approx(36e-6)
    assert read("compiled.block_ms", events) == pytest.approx(16e-3)
    # busy 1001-1016 and 1021-1036 in call 1, 1051-1066 and 1071-1086 in
    # call 2: of the gaps, 1000-1001, 1016-1021 and 1066-1071 begin
    # inside a call, 1036-1051 and 1086-1100 as one ends
    assert read("compiled.idle_pct", events) == pytest.approx(11.0)
    assert read("device.idle", events) == pytest.approx(40.0)


@pytest.mark.parametrize("name", METRICS)
def test_readers_find_nothing_in_another_systems_run(name):
    """The flagship's (bytes, operations) work and a trace of its entry's
    spans and kernels: nothing to read."""
    events = [ev(WINDOW, "user_annotation", 1000, 100),
              ev("wideband.call", "user_annotation", 1000, 50),
              ev("wideband.step", "user_annotation", 1001, 40),
              ev("aten::mul", "cpu_op", 1002, 1, 7),
              ev("void bbt::k3_fold_kernel<false, float, 9, 3>()", "kernel",
                 1000, 30, 7)]
    assert read(name, events, (1e6, 1e9)) is None


REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
ref = harness.module("reference", "lofar_hba_cobalt")
cfg = harness.config_of(harness.load_spec(), "lofar_hba_cobalt")
cfg.update(n_station=3, n_subband=2, n_chan=8, n_avg=16, block_samples=64,
           max_delay_samples=8)
x = torch.zeros((3, 200, 2, 2), dtype=torch.complex64)
ref.expected(cfg, {{}}, {{"pool": [x], "delays": [0.0, 1.5, 3.2],
                        "lead": 1}}, [0], "cpu")
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_reference_loads_neither_jax_nor_the_port():
    tops = set(fresh(REFERENCE.format(root=ROOT))["tops"])
    assert not tops & (set(harness.FORBIDDEN) | {"baseband_tasks_tpu_torch"})


def test_reference_of_a_known_dump():
    """Two stations, one subband, the second holding the first's signal
    one sample later, turned by its fringe and times 2: after the whole
    sample, the fringe stopping and a zero fractional slope the cross
    sums are twice the first station's power, the second's autos four
    times; XY* and YX* of a station whose Y is i X are -i and +i XX."""
    cfg = harness.config_of(SPEC, "lofar_hba_cobalt")
    cfg.update(n_station=2, n_subband=1, n_chan=8, n_avg=4, block_samples=32,
               max_delay_samples=8)
    rate = cfg["subband_khz"] * 1e3
    nu = cfg["subband0_mhz"] * 1e6
    s = torch.from_numpy(np.random.default_rng(0).standard_normal(80)
                         + 1j * np.random.default_rng(1).standard_normal(80))
    x = torch.zeros((2, 80, 1, 2), dtype=torch.complex128)
    x[0, :, 0, 0], x[0, :, 0, 1] = s, 1j * s
    fringe = np.exp(-2j * np.pi * nu * 1.0 / rate)
    x[1, 1:, 0, 0] = 2 * s[:-1] * fringe
    x[1, 1:, 0, 1] = 2j * s[:-1] * fringe
    ref = REF.expected(cfg, {}, {"pool": [x.to(torch.complex64)],
                                 "delays": [0.0, 1.0], "lead": 1},
                       [0], "cpu")[0]
    vis, cnt = ref[0].numpy(), ref[1]
    assert list(cnt) == [4] and vis.shape == (3, 8, 1, 4)
    xx = vis[0, ..., 0].real
    np.testing.assert_allclose(vis[0, ..., 1], -1j * xx, rtol=1e-6,
                               atol=1e-6 * xx.max())
    np.testing.assert_allclose(vis[0, ..., 2], 1j * xx, rtol=1e-6,
                               atol=1e-6 * xx.max())
    np.testing.assert_allclose(vis[1, ..., 0], 2 * xx, rtol=1e-5)
    np.testing.assert_allclose(vis[2, ..., 3].real, 4 * xx, rtol=1e-5)
    nums = REF.compare((vis[None].astype(np.complex64), cnt), ref)
    assert nums["vis_rel_err"] < 1e-6 and nums["count_err"] == 0
    bad = REF.compare((vis[None, ..., [0, 2, 1, 3]], cnt), ref)
    assert bad["vis_rel_err"] > 1.0
    assert REF.compare((np.concatenate([vis[None]] * 2), cnt),
                       ref)["count_err"] == np.inf


def test_traffic_keeps_the_flagship_keys():
    """``test_cells.py`` runs every cell's traffic through the flagship's
    small configuration: the mix has its keys and a feed it knows."""
    traffic = harness.traffic_of("dump_1s")
    assert {"feed", "pool", "steps_per_call", "calls_per_unit",
            "trace_units"} <= set(traffic)
    assert traffic["feed"] in harness.module("systems",
                                             "flagship_fold").FEEDS
    assert json.loads(json.dumps(traffic)) == traffic
