"""The port's profiling hooks (``utils/profiling.py``) against the JAX
package.

Both packages monitor the same chain (a seeded StreamGenerator ->
Channelize -> Square, and a join of two sources): the monitors come in
the same order with the same names, and count the same frames and
samples exactly; on CPU streams the port never synchronizes a card;
``trace`` writes a non-empty Chrome trace of the block it wraps.

The port's spans (``span``, the port alone): with no profiler running a
flagship call never enters ``record_function``; under ``trace`` it
writes ``wideband.call`` with ``mesh.shard``, ``wideband.prep`` and one
``wideband.step`` a step nested inside it (and, after the steps,
``mesh.copy_wait`` where the inputs were issued as copies: a stand-in
copy here, as a CPU mesh issues none, also waited for when a step
raises), and building a pipeline and its ``run_fn`` writes
``wideband.init`` and ``wideband.run_fn``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import baseband_tasks_tpu as jb  # noqa: E402
from baseband_tasks_tpu.utils import profiling as jprof  # noqa: E402
from baseband_tasks_tpu.utils import Time as JTime  # noqa: E402
from baseband_tasks_tpu.utils import units as ju  # noqa: E402

import baseband_tasks_tpu_torch as pb  # noqa: E402
from baseband_tasks_tpu_torch.utils import profiling as pprof  # noqa: E402
from baseband_tasks_tpu_torch.utils import Time as PTime  # noqa: E402
from baseband_tasks_tpu_torch.utils import units as pu  # noqa: E402

DATA = (np.random.default_rng(2).standard_normal((8192, 2))
        + 1j * np.random.default_rng(3).standard_normal((8192, 2))
        ).astype(np.complex64)


def source(pkg, units, time):
    def frame(sh):
        o = sh.tell()
        return DATA[o:o + min(sh.samples_per_frame, sh.shape[0] - o)]
    kw = {"device": "cpu"} if pkg is pb else {}
    return pkg.StreamGenerator(frame, DATA.shape, time("2020-01-01"),
                               1 * units.MHz, samples_per_frame=1024,
                               dtype=DATA.dtype, **kw)


def chains(pkg, units, time):
    single = pkg.Square(pkg.Channelize(source(pkg, units, time), 16))
    joined = pkg.Square(pkg.Concatenate([source(pkg, units, time),
                                         source(pkg, units, time)]))
    return single, joined


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("whole_chain", [True, False])
def test_monitor_counts_match_jax(monkeypatch, which, whole_chain):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: (_ for _ in
                        ()).throw(AssertionError("synchronized a card")))
    p = chains(pb, pu, PTime)[which]
    j = chains(jb, ju, JTime)[which]
    pm = pprof.monitor(p, whole_chain=whole_chain)
    jm = jprof.monitor(j, whole_chain=whole_chain)
    for n in (100, 300, 25):
        p.read(n)
        j.read(n)
    assert [m.name for m in pm] == [m.name for m in jm]
    assert [(m.frames, m.samples) for m in pm] == \
        [(m.frames, m.samples) for m in jm]
    assert pm[0].samples >= 425 and pm[0].frames >= 1
    assert all(m.seconds >= 0 for m in pm)
    assert pm[0].samples_per_second > 0
    assert "samples in" in pm[0].report() and "realtime" in repr(pm[0])


def test_trace_writes_chrome_trace(tmp_path):
    single = chains(pb, pu, PTime)[0]
    with pprof.trace(str(tmp_path / "t")) as path:
        single.read(256)
    out = os.path.join(path, "trace.json")
    assert os.path.getsize(out) > 0
    with open(out) as f:
        assert json.load(f)["traceEvents"]


def flagship_small():
    u = pb.units
    return pb.WidebandPulsarPipeline(
        n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
        block_samples=1024, device="cpu")


def flagship_block(pipe):
    shape = (pipe.global_block, pipe.n_chan, pipe.n_pol, 2)
    return (np.random.default_rng(4).standard_normal(shape).astype(
        np.float32),)


def spans_of(path):
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]


def test_span_is_one_no_op_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered record_function with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert pprof.span("a") is pprof.span("b")
    pipe = flagship_small()
    run = pipe.run_fn(2)
    prof, cnt = run(blocks=flagship_block(pipe))
    assert int(cnt.sum()) == 2 * pipe.global_block


def test_flagship_call_spans_nest(tmp_path):
    pipe = flagship_small()
    run = pipe.run_fn(2)
    block = flagship_block(pipe)
    run(blocks=block)
    with pprof.trace(str(tmp_path / "t")) as path:
        run(blocks=block)
    spans = spans_of(path)
    names = sorted(n for n, _, _ in spans)
    assert names == ["mesh.shard", "wideband.call", "wideband.prep",
                     "wideband.step", "wideband.step"]
    by = {n: (a, b) for n, a, b in spans}
    c0, c1 = by["wideband.call"]
    assert all(c0 <= a and b <= c1 for _, a, b in spans)
    steps = sorted((a, b) for n, a, b in spans if n == "wideband.step")
    # in order, none overlapping: the inputs, the preamble, the steps
    assert by["mesh.shard"][1] <= by["wideband.prep"][0]
    assert by["wideband.prep"][1] <= steps[0][0]
    assert steps[0][1] <= steps[1][0]


class FakeCopy:
    """An issued copy's stand-in: counts the host's waits on it."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def with_fake_copy(monkeypatch):
    """Make ``run_fn``'s ``shard_async`` add one fake copy to the pending
    of each array it shards (a CPU mesh issues none)."""
    from baseband_tasks_tpu_torch.models import wideband
    copies = []
    real = wideband.shard_async

    def shard_async(x, mesh, spec):
        grid, pending = real(x, mesh, spec)
        copies.append(FakeCopy())
        pending.add(copies[-1], x)
        return grid, pending
    monkeypatch.setattr(wideband, "shard_async", shard_async)
    return copies


def test_flagship_call_waits_for_its_copies_last(tmp_path, monkeypatch):
    """A call whose inputs were issued as copies waits for each once, in
    one ``mesh.copy_wait`` inside ``wideband.call``, after its last
    ``wideband.step``."""
    pipe = flagship_small()
    run = pipe.run_fn(2)
    block = flagship_block(pipe)
    run(blocks=block)
    copies = with_fake_copy(monkeypatch)
    with pprof.trace(str(tmp_path / "t")) as path:
        run(blocks=block)
    assert [c.waits for c in copies] == [1]
    spans = spans_of(path)
    assert sorted(n for n, _, _ in spans) == [
        "mesh.copy_wait", "mesh.shard", "wideband.call", "wideband.prep",
        "wideband.step", "wideband.step"]
    by = {n: (a, b) for n, a, b in spans}
    c0, c1 = by["wideband.call"]
    assert all(c0 <= a and b <= c1 for _, a, b in spans)
    last_step = max(b for n, _, b in spans if n == "wideband.step")
    assert last_step <= by["mesh.copy_wait"][0]


def test_flagship_call_waits_for_its_copies_when_a_step_raises(
        monkeypatch):
    """A step that raises after the inputs were issued still leaves no
    copy reading the caller's blocks."""
    pipe = flagship_small()
    run = pipe.run_fn(2)
    copies = with_fake_copy(monkeypatch)

    def fail(*a, **k):
        raise RuntimeError("a step failed")
    monkeypatch.setattr(pipe, "_pairs_step", fail)
    with pytest.raises(RuntimeError, match="a step failed"):
        run(blocks=flagship_block(pipe))
    assert [c.waits for c in copies] == [1]


def test_flagship_set_up_spans(tmp_path):
    with pprof.trace(str(tmp_path / "t")) as path:
        pipe = flagship_small()
        pipe.run_fn(2)
    assert sorted(n for n, _, _ in spans_of(path)) == \
        ["wideband.init", "wideband.run_fn"]
