"""The LOTAAS tied-array beamformer cell on the CPU at a small size (the
port's compiled TABs against the plain reference), faults planted in the
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
CELL = "lofar_lotaas_tabs.stokes_1s"
METRICS = ("beamformer.bf_roofline", "beamformer.bf_share")
SYSTEM = harness.module("systems", "lofar_lotaas_tabs")
REF = harness.module("reference", "lofar_lotaas_tabs")

pytestmark = pytest.mark.filterwarnings(
    "ignore::baseband_tasks_tpu_torch.base.FrameSizeWarning")


def small_cfg():
    """The node at 3 fields, 5 TABs, 2 subbands and 16 channels: units of
    2 blocks of 192 samples (4 Stokes rows of 6 spectra) and the lead."""
    cfg = harness.config_of(SPEC, "lofar_lotaas_tabs")
    cfg.update(n_station=3, n_tab=5, n_subband=2, block_samples=192,
               cobalt_block_samples=384)
    return cfg


def run(trace=False, control=False, seed=2 ** 31 + 13):
    traffic = small.traffic("stokes_1s", steps_per_call=2)
    return harness.run_cell(SPEC, harness.cell_of(SPEC, CELL), seed, 0.3,
                            trace, torch.device("cpu"), time.perf_counter(),
                            cfg=small_cfg(), traffic=traffic,
                            control=control)


def test_cell_is_correct_and_its_control_is_not():
    res, lines = run(control=True)
    assert res["correct"], lines
    assert set(res["check"]) == set(REF.LIMITS)
    # every row counted its 6 spectra, and the sums sit 10x inside
    assert res["check"]["count_err"]["value"] == 0
    num = res["check"]["stokes_rel_err"]
    assert num["value"] <= num["limit"] / 10, num
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
    assert not (set(METRICS) | {"kernels_roofline", "device.idle",
                                "compiled.block_ms",
                                "compiled.idle_pct"}) & set(res["metrics"])


def tab_sign_flipped(mp):
    from baseband_tasks_tpu_torch.models import beamform
    orig = beamform.tab_weights

    def flipped(*args):
        return np.conj(orig(*args))
    mp.setattr(beamform, "tab_weights", flipped)


def y_dropped(mp):
    from baseband_tasks_tpu_torch.models import beamform
    orig = beamform._tab_products

    def x_only(w, x):
        beams = orig(w, x)
        # the product's columns are (time, polarization) pairs
        beams.view(beams.shape[:-1] + (-1, 2))[..., 1] = 0
        return beams
    mp.setattr(beamform, "_tab_products", x_only)


def subband_centre_weights(mp):
    from baseband_tasks_tpu_torch.models import beamform
    orig = beamform.tab_weights

    def centre(frequency, *args):
        # channel 0 of the FFT's order is the subband's centre
        f = frequency.value
        return orig(np.broadcast_to(f[:1], f.shape) * frequency.unit,
                    *args)
    mp.setattr(beamform, "tab_weights", centre)


def tf32(t):
    """``t`` (complex64) with each float rounded to TF32's 10 mantissa
    bits (round to nearest even)."""
    i = torch.view_as_real(t).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return torch.view_as_complex(i.view(torch.float32))


def tf32_product(mp):
    from baseband_tasks_tpu_torch.models import beamform

    def product(w, x):
        return torch.matmul(tf32(w), tf32(x))
    mp.setattr(beamform, "_tab_products", product)


FAULTS = (tab_sign_flipped, y_dropped, subband_centre_weights, tf32_product)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_is_not_correct(fault, monkeypatch):
    """The TABs' phase with the wrong sign, Y left out of Stokes I, every
    channel steered at its subband's centre, the product's inputs rounded
    to TF32: each fails the comparison."""
    fault(monkeypatch)
    res, _ = run()
    assert res["attempted"] > 0
    assert not res["correct"], res["check"]


def test_work_functions():
    cfg = harness.config_of(SPEC, "lofar_lotaas_tabs")
    assert SYSTEM.spectra_per_unit(cfg) == 12288 and SYSTEM.rows(cfg) == 2048
    assert SYSTEM.unit_blocks(cfg) == (8, 9)
    # 12 x 61 x 2 x 196,608 complex64 samples in, 2048 x 73 x 16 x 61
    # float32 Stokes I sums out
    samples = 287_834_112
    assert SYSTEM.unit_samples(cfg) == samples
    sums = 583_663_616
    # 8 operations a TAB a sample, 4 a beam sample (73 x 16 x 61 x 2 x
    # 12,288 of them) detected
    assert SYSTEM.bf_work(cfg) == (samples * 8 + sums,
                                   8 * 73 * samples + 4 * 1_750_990_848)
    nbytes, ops = SYSTEM.work_per_unit(cfg)
    assert nbytes == 2_886_336_512
    # 17,989,632 FFTs of 16 points (5 x 16 x 4 each), 6 operations a
    # rotated sample
    assert ops == (17_989_632 * 320 + 6 * samples
                   + 175_099_084_800) == 182_582_771_712
    assert peaks.work_bound_s(nbytes, ops)[1] == "operations"
    assert peaks.work_bound_s(nbytes, ops)[0] == pytest.approx(2.7251e-3,
                                                               rel=1e-4)
    # real time: 12 x 61 x 2 samples at 195,312.5 a second
    assert samples / (196608 / 195312.5) == pytest.approx(2.859e8, rel=1e-3)


def ev(name, cat, ts, dur, ext=None, tid=1):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
         "tid": tid}
    if ext is not None:
        e["args"] = {"External id": ext}
    return e


def known_trace():
    """Two blocks of one call (100 us window): each block's TAB span
    holds a copy op (kernel 5 us) and a product op (kernel 10 us); the F
    stage's op (kernel 3 us) and the sums' update (2 us) lie outside it;
    an op of another thread inside the span's time is not its."""
    events = [ev(WINDOW, "user_annotation", 1000, 100),
              ev("compiled.call", "user_annotation", 1000, 60)]
    ext = iter(range(1, 1000))
    for b in range(2):
        t = 1000 + 30 * b
        events += [ev("compiled.block", "user_annotation", t, 25),
                   ev("beamformer.bf", "user_annotation", t + 4, 12)]
        ops = [(t, "aten::_fft_c2c", 3), (t + 5, "aten::copy_", 5),
               (t + 9, "aten::bmm", 10), (t + 17, "aten::index_add_", 2)]
        dev = t + 1
        for ts, name, dur in ops:
            i = next(ext)
            events += [ev(name, "cpu_op", ts, 1, i),
                       ev(f"kernel of {name}", "kernel", dev, dur, i)]
            dev += dur
        i = next(ext)
        events += [ev("aten::copy_", "cpu_op", t + 6, 1, i, tid=2),
                   ev("other thread's copy", "kernel", dev, 1, i)]
    return events


def read(name, events, work=(1.0, 1.0)):
    run = SimpleNamespace(trace=Trace(events), spans={}, work=work)
    return harness.module("metrics", name).read(run)


def test_readers_on_a_known_trace():
    events = known_trace()
    # the TABs' bound: 6 us of operations over 2 x 15 us of kernels
    ops = SYSTEM.Work(peaks.FP32_FLOPS * 6e-6, {"beamformer.bf":
                                                peaks.FP32_FLOPS * 6e-6})
    work = (SYSTEM.Work(1.0, {"beamformer.bf": 1.0}), ops)
    assert read("beamformer.bf_roofline", events, work) == \
        pytest.approx(100 * 6e-6 / 30e-6)
    # 30 us of the 42 us of kernels (2 x (3 + 5 + 10 + 2) + 2 x 1)
    assert read("beamformer.bf_share", events, work) == \
        pytest.approx(100 * 30 / 42)
    # the span readers of the executor read the same trace
    assert read("compiled.block_ms", events) == pytest.approx(25e-3)


@pytest.mark.parametrize("name", METRICS)
def test_readers_find_nothing_in_another_systems_run(name):
    """The LOFAR correlator's trace (its X spans, no TAB span) and work:
    nothing to read."""
    events = [ev(WINDOW, "user_annotation", 1000, 100),
              ev("compiled.call", "user_annotation", 1000, 50),
              ev("correlator.x", "user_annotation", 1001, 40),
              ev("bbt::xcorr_accumulate", "cpu_op", 1002, 1, 7),
              ev("void bbt::xcorr_kernel<2>()", "kernel", 1000, 30, 7)]
    lofar = SYSTEM.Work(1e6, {"correlator.x": 1e6})
    assert read(name, events, (lofar, lofar)) is None


REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark import harness
ref = harness.module("reference", "lofar_lotaas_tabs")
cfg = harness.config_of(harness.load_spec(), "lofar_lotaas_tabs")
cfg.update(n_station=3, n_tab=2, n_subband=2, cobalt_block_samples=192)
x = torch.zeros((3, 230, 2, 2), dtype=torch.complex64)
ref.expected(cfg, {{}}, {{"pool": [x], "delays": [0.0, 0.5, 0.2],
                        "tabs": np.zeros((2, 3)), "lead": 1}}, [0], "cpu")
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_reference_loads_neither_jax_nor_the_port():
    tops = set(fresh(REFERENCE.format(root=ROOT))["tops"])
    assert not tops & (set(harness.FORBIDDEN) | {"baseband_tasks_tpu_torch"})


def test_reference_of_a_known_block():
    """Two fields holding the same signal at no delay: TAB 0 (no delay)
    is the signal itself, its Stokes I the bases E; TAB 1, whose delays
    put field 1 a phase 2 pi f tau behind at each channel's sky
    frequency f, holds cos^2(pi f tau) of it; the counts are 6 a row."""
    cfg = harness.config_of(SPEC, "lofar_lotaas_tabs")
    cfg.update(n_station=2, n_tab=2, n_subband=1, cobalt_block_samples=192,
               max_delay_samples=1)
    s = torch.from_numpy(np.random.default_rng(0).standard_normal((230, 2))
                         + 1j * np.random.default_rng(1)
                         .standard_normal((230, 2)))
    x = torch.stack([s, s])[:, :, None, :].to(torch.complex64)
    tau = np.array([[0.0, 0.0], [0.0, 3e-9]])
    ref = REF.expected(cfg, {}, {"pool": [x], "delays": [0.0, 0.0],
                                 "tabs": tau, "lead": 1}, [0], "cpu")[0]
    sums, cnt, base = ref[0].numpy(), ref[1], ref[2].numpy()
    assert sums.shape == (2, 2, 16, 1) and list(cnt) == [6, 6]
    np.testing.assert_allclose(sums[:, 0], base, rtol=1e-12)
    f = REF.sky_frequency(cfg, slice(0, 1))                 # (16, 1)
    np.testing.assert_allclose(sums[:, 1], np.cos(np.pi * f * 3e-9) ** 2
                               * sums[:, 0], rtol=1e-9)
    nums = REF.compare((sums.astype(np.float32), cnt), ref)
    assert nums["stokes_rel_err"] < 1e-6 and nums["count_err"] == 0
    bad = REF.compare((sums[:, ::-1].copy(), cnt), ref)
    assert bad["stokes_rel_err"] > 0.1
    assert REF.compare((sums[:1], cnt), ref)["count_err"] == np.inf
    assert REF.compare((sums, cnt[:1]), ref)["stokes_rel_err"] == np.inf


def test_traffic_keeps_the_flagship_keys():
    """``test_cells.py`` runs every cell's traffic through the flagship's
    small configuration: the mix has its keys and a feed it knows."""
    traffic = harness.traffic_of("stokes_1s")
    assert {"feed", "pool", "steps_per_call", "calls_per_unit",
            "trace_units"} <= set(traffic)
    assert traffic["feed"] in harness.module("systems",
                                             "flagship_fold").FEEDS
    assert json.loads(json.dumps(traffic)) == traffic
