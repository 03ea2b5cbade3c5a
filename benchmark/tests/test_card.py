"""On the card: each cell for a few seconds at its full size, correct,
with every end-to-end metric, and its control not correct; run on the
chip with

    python -m pytest benchmark/tests/test_card.py -q -p no:cacheprovider \\
        --noconftest -o filterwarnings=error
"""

import time

import pytest
import torch

from benchmark import harness

SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    res, lines = harness.run_cell(SPEC, harness.cell_of(SPEC, cell),
                                  2 ** 31 + 101, 2.0, False, card,
                                  time.perf_counter())
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["samples_per_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, card):
    res, lines = harness.run_cell(SPEC, harness.cell_of(SPEC, cell),
                                  2 ** 31 + 103, 2.0, False, card,
                                  time.perf_counter(), control=True)
    assert res["correct"], lines
    assert res["control_correct"] is False, res["control"]
