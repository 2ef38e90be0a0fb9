#!/usr/bin/env python3
"""Run one cell of the benchmark of myscaledb_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for. Makes the cell's rows and queries (and documents and query texts,
where the configuration has them) from the seed on the card, builds the
table (and its indexes) through the port's public API,
warms up the cell's own shapes, measures for `--seconds`, then checks a
sample of what the window answered against the plain reference. With
`--trace 1` a traced window follows the measured one and the per-layer
metrics are reported instead of the end-to-end ones. The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers compared, each beside its limit. Exits
with 1 and prints no result without enough cards, and with 4 when a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # a library that loads JAX by itself is kept from doing so
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    from benchmark.spec import Cell

    chips = int(Cell(args.workload).cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 1

    def log(msg):
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t_start=T_START, log=log)
    if out["forbidden"]:
        log(f"modules of JAX or the JAX package were loaded: {out['forbidden']}")
        return 4
    res = out["result"]
    for name, c in res["checks"].items():
        sign = "<=" if c["kind"] == "max" else ">="
        print(f"check {name} {c['value']!r} {sign} {c['limit']!r}", file=sys.stderr)
    print(f"correct {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
