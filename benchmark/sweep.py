#!/usr/bin/env python3
"""The one-off sweep that fixes an IVF cell's operating point, on the card.

    python3 benchmark/sweep.py --workload <ivf cell> --seeds 1 2 3

For each seed, the cell's table and index once, then every query of
the pool at nprobe 1, 2, 4, ... (batches of the cell's size) and their
recall_ids@k against the reference; the operating point is the smallest
nprobe that reaches the target on every seed (`bench.py:443-457`'s rule).

Each prints one line a point.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nprobe_sweep(args, device):
    import numpy as np

    from benchmark import corpus, judge, system
    from benchmark.spec import Cell

    cell = Cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference()
    k, b = int(traffic["k"]), int(traffic["batch"])
    for seed in args.seeds:
        rows, pool, _ = corpus.make(cfg, seed, device)
        sut = system.PortTable(cfg, traffic, rows, device)
        for nprobe in args.nprobes:
            sut.params = {"nprobe": nprobe}
            sample = []
            for a in range(0, pool.shape[0], b):
                qi = np.arange(a, min(a + b, pool.shape[0]))
                res, ids = sut.search(pool[qi])
                sample.append((qi, ids, res.distances))
            v = judge.numbers(sample, rows, pool, k, cfg, ref, device)
            print(json.dumps({"seed": seed, "nprobe": nprobe, "recall": v["recall"],
                              "dist_err": v["dist_err"], "bad_hits": v["bad_hits"]}), flush=True)
        sut.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1])
    ap.add_argument("--nprobes", type=int, nargs="*", default=[1, 2, 4, 8])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 1
    nprobe_sweep(args, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
