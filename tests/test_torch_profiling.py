"""The port's profiling hooks (``utils/profiling.py``) against the JAX
package.

Both packages monitor the same chain (a seeded StreamGenerator ->
Channelize -> Square, and a join of two sources): the monitors come in
the same order with the same names, and count the same frames and
samples exactly; on CPU streams the port never synchronizes a card;
``trace`` writes a non-empty Chrome trace of the block it wraps.
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
