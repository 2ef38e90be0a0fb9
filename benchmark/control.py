#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... [--seconds 2]
                                 [--control-seeds 1 2 3]

For each of `--seeds`: one run of the cell through the program with a
window of `--seconds` (its set-up, window and check, as `run.py` makes
them), printing the numbers compared. For each of `--control-seeds`: the
control, the reference one precision lower put in the program's place over
as many of the cell's queries as a run judges, printing the same numbers.
The benchmark's own runs never run the control. One JSON line a reading.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False, device="cuda:0")
        print(json.dumps({"side": "program", "seed": seed, **out["values"],
                          "correct": out["result"]["correct"]}), flush=True)
    for seed in args.control_seeds:
        values = harness.control_numbers(args.workload, seed, device="cuda:0")
        print(json.dumps({"side": "control", "seed": seed, **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
