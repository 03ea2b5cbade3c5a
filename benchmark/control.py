"""The controls of ``correct``: for a cell, on several seeds, one run of
the program (its numbers compared, as every run compares them) and the
control (the plain reference computed in bfloat16, put in the program's
place) in the same process, at the cell's own size and load.

    python benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 5 > control.jsonl

prints one JSON line a seed: the program's numbers and verdict, the
control's numbers and the harness's verdict on them (``control_correct``,
by the same limits), and the limits.  A limit sits above every program
reading and below every control reading (``PERF.md`` lists them).  Exits
with 1 where the program is not correct or the control is, on any seed.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cell = harness.cell_of(spec, args.workload)
    device = torch.device("cuda", 0)
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _ = harness.run_cell(spec, cell, seed, args.seconds, False,
                                  device, time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "units": res["attempted"],
                          "program": {k: v["value"] for k, v in
                                      res["check"].items()},
                          "control": res["control"],
                          "control_correct": res["control_correct"],
                          "limits": {k: v["limit"] for k, v in
                                     res["check"].items()}}), flush=True)
        bad += (not res["correct"]) or res["control_correct"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
