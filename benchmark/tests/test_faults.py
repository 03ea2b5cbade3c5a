"""A run whose timed path is broken underneath comes out not correct.

Each fault the cells can have is planted in the port (on the CPU, at a
small size, past the harness's look for a card), then a whole run is
made: a step that returns its state unchanged, half of the batch left
out with the mean taken over the rest, and an answer altered where it
is produced.  (One chip: no exchange between chips to leave out.)"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import small

SPEC = harness.load_spec()


def run(cell):
    c = small.cells(SPEC)[cell]
    cfg = small.flagship()
    res, lines = harness.run_cell(SPEC, c, 2 ** 31 + 3, 0.2, False,
                                  torch.device("cpu"), time.perf_counter(),
                                  cfg=cfg, traffic=small.traffic(c["traffic"]))
    return res


def flagship_state_unchanged(mp):
    from baseband_tasks_tpu_torch.models.wideband import \
        WidebandPulsarPipeline as W
    orig = W.run_fn

    def frozen(self, n_iter, offset0=0, ingest_bits=None):
        # the stream's phase never advances: every call folds (and
        # scales) as the stream's first block does
        return orig(self, n_iter, 0, ingest_bits)
    mp.setattr(W, "run_fn", frozen)


def flagship_half_batch(mp):
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    orig = dd.detect_fold

    def half(zr, zi, fold, *, n_phase, pad_start, n_valid, stokes=False):
        prof, cnt = orig(zr, zi, fold, n_phase=n_phase, pad_start=pad_start,
                         n_valid=n_valid // 2, stokes=stokes)
        return prof * 2, cnt * 2
    mp.setattr(dd, "detect_fold", half)


def flagship_altered(mp):
    from baseband_tasks_tpu_torch.ops import dedisperse as dd
    orig = dd.detect_fold

    def altered(*args, **kwargs):
        prof, cnt = orig(*args, **kwargs)
        prof = prof.clone()
        prof[0, 0] *= 1.001
        return prof, cnt
    mp.setattr(dd, "detect_fold", altered)


#: every cell makes one-step calls, each from its own stream offset
FAULTS = {cell: [flagship_state_unchanged, flagship_half_batch,
                 flagship_altered]
          for cell in ("flagship_fold.resident", "flagship_fold.host_fed")}
CASES = [(cell, f) for cell, fs in FAULTS.items() for f in fs]


def test_every_cell_has_its_faults():
    assert set(FAULTS) == set(small.cells(SPEC))


@pytest.mark.parametrize("cell, fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    assert res["attempted"] > 0
    assert not res["correct"], res["check"]
