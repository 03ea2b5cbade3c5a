"""The reader of the port's span ``mesh.copy_wait`` on a hand-made
chrome trace, ``test_span_metrics.py``'s two calls of the flagship
entry, each ending in a wait for its copies, and a wait on another
thread and one outside every call, which are not the calls'."""

import pytest

from benchmark.tests.test_span_metrics import BASE, PORT, read, span

WAITS = [
    span("mesh.copy_wait", 1038, 2),      # call 1 (1000-1040)
    span("mesh.copy_wait", 1020, 5, tid=2),   # another thread
    span("mesh.copy_wait", 1088, 2),      # call 2 (1050-1090)
    span("mesh.copy_wait", 1095, 3),      # outside every call
]


def test_copy_wait_counts_the_calls_own_waits():
    assert read("mesh.copy_wait_ms", BASE + PORT + WAITS) == \
        pytest.approx((2 + 2) / 2e3)


def test_copy_wait_finds_nothing_without_the_span():
    # a program without the span, or one that issues no copy (inputs on
    # the card)
    assert read("mesh.copy_wait_ms", BASE + PORT) is None
    assert read("mesh.copy_wait_ms", BASE + WAITS) is None
