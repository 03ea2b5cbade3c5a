"""The command line: without a CUDA device a run prints no result and
exits with 2; the harness never falls back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "flagship_fold.resident", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True,
        cwd=str(harness.ROOT), timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr
