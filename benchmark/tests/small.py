"""Small configurations and traffic of the benchmark's cells, for runs
on the CPU (the port's plain versions) in the tests."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _load(kind, name):
    with open(HERE / kind / f"{name}.json") as fh:
        return json.load(fh)


def flagship(**over):
    """The flagship at 4 channels, DM 30, 16 bins, a 4096-sample window."""
    cfg = _load("configs", "flagship_fold")
    cfg.update(n_chan=4, dm=30.0, n_phase=16, block_samples=2048,
               window={"n_fft": 4096, "pad_start": 128, "pad_end": 128,
                       "valid_samples": 3840})
    cfg.update(over)
    return cfg


def traffic(name, **over):
    """A traffic mix cut to a few small units."""
    t = copy.deepcopy(_load("traffic", name))
    t.update(pool=3, trace_units=2)
    if t["calls_per_unit"] > 1:
        t.update(calls_per_unit=3)
    else:
        t.update(steps_per_call=3)
    t.update(over)
    return t


def cells(spec):
    """Every cell of ``spec``, by name."""
    return {c["name"]: c for c in spec["workloads"]}
