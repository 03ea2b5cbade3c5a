"""No run and no reference loads JAX or the JAX package; the references
load nothing of the port either.  Each check runs in a fresh process
(this one has loaded the JAX package for pytest's warning filter)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import small

ROOT = str(harness.ROOT)
CELLS = list(small.cells(harness.load_spec()))

RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark import harness
from benchmark.tests import small
spec = harness.load_spec()
c = small.cells(spec)[{cell!r}]
cfg = small.flagship()
res, _ = harness.run_cell(spec, c, 5, 0.2, False, torch.device("cpu"),
                          time.perf_counter(), cfg=cfg,
                          traffic=small.traffic(c["traffic"]))
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "tops": tops}}))
"""

REFERENCES = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from benchmark import harness
from benchmark.tests import small
flag = harness.module("reference", "flagship_fold")
cfg = small.flagship()
t = cfg["window"]["valid_samples"]
rng = np.random.default_rng(1)
words = [tuple(rng.integers(-2**31, 2**31, (t // 4, 4, 2), dtype=np.int64)
               .astype(np.int32) for _ in range(2))]
flag.expected(cfg, {{}}, {{"pool": words}}, [((0, 0), (0, t))], "cpu")
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def fresh(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    got = fresh(RUN.format(root=ROOT, cell=cell))
    assert got["correct"]
    assert not set(got["tops"]) & set(harness.FORBIDDEN)
    assert "baseband_tasks_tpu_torch" in got["tops"]


def test_references_load_neither_jax_nor_the_port():
    tops = set(fresh(REFERENCES.format(root=ROOT))["tops"])
    assert not tops & (set(harness.FORBIDDEN) | {"baseband_tasks_tpu_torch"})


def test_forbidden_names_are_whole():
    sys.modules.setdefault("baseband_tasks_tpu_torch_probe", sys)
    try:
        assert "baseband_tasks_tpu_torch_probe" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["baseband_tasks_tpu_torch_probe"]
