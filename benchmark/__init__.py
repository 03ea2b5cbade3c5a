"""The benchmark of ``baseband_tasks_tpu_torch`` on one NVIDIA H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is found by name:

- ``configs/<config>.json``: the configuration as it is run (sizes,
  source, ``assumed`` and ``reduced``), naming its system and reference;
- ``systems/<system>.py``: builds the port's entry for a configuration,
  its feeds (how a traffic mix drives it) and its work function;
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by the
  closed-loop generator of ``harness.py``;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``reference/<config>.py``: the plain reference (numpy and torch only)
  and the limits of the comparison that decides ``correct``.

Nothing here imports JAX or the JAX package; only the systems import the
port.
"""
