"""The configurations' work functions against numbers worked out by
hand, and the roofline reader on them."""

from types import SimpleNamespace

import pytest

from benchmark import harness, peaks

SPEC = harness.load_spec()


def test_flagship_step():
    cfg = harness.config_of(SPEC, "flagship_fold")
    nbytes, ops = harness.module("systems", "flagship_fold").work_per_step(
        cfg, 2)
    # 128 lanes x (two FFTs of 2^18: 10 x 262144 x 18, the response
    # 6 x 262144, |x|^2 3 x 253952)
    assert ops == 128 * (47_185_920 + 1_572_864 + 761_856) == 6_338_641_920
    # 253,952 x 128 one-byte (re, im) pairs in, a 64 x 128 profile and
    # 64 counts of float32 out
    assert nbytes == 65_011_712 + 33_024
    bound, by = peaks.work_bound_s(nbytes, ops)
    assert by == "operations"
    assert bound == pytest.approx(94.606e-6, rel=1e-4)


def test_roofline_reader():
    read = harness.module("metrics", "kernels_roofline").read
    run = SimpleNamespace(trace=SimpleNamespace(kernel_s=2e-3),
                          work=(1e6, 6.7e10))
    assert read(run) == pytest.approx(50.0)
    run.trace.kernel_s = 0.0
    assert read(run) is None
    assert read(SimpleNamespace(trace=None, work=(1, 1))) is None
