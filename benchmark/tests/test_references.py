"""What the references work out for themselves against what the port
derives: the flagship's window and fold rows."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests import small

SPEC = harness.load_spec()
FLAG = harness.module("reference", "flagship_fold")


@pytest.mark.parametrize("cfg", [harness.config_of(SPEC, "flagship_fold"),
                                 small.flagship()], ids=["full", "small"])
def test_flagship_window(cfg):
    pipe = harness.module("systems", "flagship_fold").pipeline(cfg, "cpu")
    assert FLAG.geometry(cfg) == (
        pipe.pad_start + pipe.block_samples + pipe.pad_end, pipe.pad_start,
        pipe.pad_end, pipe.block_samples)


def test_flagship_fold_rows_match_the_port():
    """Exact rational polyco rows equal the port's two-double rows."""
    cfg = harness.config_of(SPEC, "flagship_fold")
    pipe = harness.module("systems", "flagship_fold").pipeline(cfg, "cpu")
    t = pipe.block_samples
    offsets = [k * t for k in range(16)]
    port = pipe.fold_model.table(np.array(offsets), t)
    rows = FLAG.fold_rows(cfg, offsets, t)
    assert [list(rows[o]) for o in offsets] == port[:, :2].tolist()
