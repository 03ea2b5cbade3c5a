"""The sweep's variant tables (``tools/fft_sweep.py`` ``TABLES``) against
the shipped kernel sources: each table's constants line is exactly one
line of its ``csrc`` unit, and its first variant builds that line as it
stands, so the first build of every sweep is the kernel as it ships.
Reads the sources only: no card and no ``nvcc``."""

import re

import pytest

pytest.importorskip("torch")

from baseband_tasks_tpu_torch.ops import _build  # noqa: E402
from baseband_tasks_tpu_torch.tools import fft_sweep  # noqa: E402


@pytest.mark.parametrize("table", sorted(fft_sweep.TABLES))
def test_first_variant_is_the_shipped_line(table):
    tab = fft_sweep.TABLES[table]
    src = (_build.CSRC / tab.unit).read_text()
    lines = re.findall(fft_sweep.knob_pattern(tab.names), src)
    assert len(lines) == 1
    assert " ".join(lines[0].split()) == fft_sweep.knob_line(
        tab.names, tab.variants[0])


def test_every_table_is_swept():
    """Each table belongs to one group, and every variant sets each of its
    line's constants."""
    swept = [t for tables, _, _ in fft_sweep.GROUPS.values() for t in tables]
    assert sorted(swept) == sorted(fft_sweep.TABLES)
    for tab in fft_sweep.TABLES.values():
        assert all(len(v) == len(tab.names) for v in tab.variants)
        assert len(set(tab.variants)) == len(tab.variants)
