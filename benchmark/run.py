"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and ``baseband_tasks_tpu_torch``.  Needs a CUDA device (exit code 2
without one); with ``--trace 0`` it prints the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each time after
comparing every unit of the window with the plain reference.  The
kernels build into ``build/`` inside the checkout on a first run.
"""

import time

T_START = time.perf_counter()      # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
