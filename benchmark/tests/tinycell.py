"""A tiny copy of the benchmark's cells for the CPU, made by adding files
only: its own configuration, traffic, cell files and manifest beside the
benchmark's loops, references and metric readers."""

import json
import os
import shutil

from benchmark.spec import BENCH_DIR, REPO_ROOT

TINY_ROWS = 70_000  # past min_rows_to_build_vector_index, so IVFFLAT builds
CELLS = {"exact": "exact-b1000", "ivfflat": "ivfflat-b1000"}


def make(root: str) -> dict:
    """Write the tiny benchmark under `root`; returns {kind: cell name}
    and the manifest's path under "manifest"."""
    for sub in ("loops", "references", "metrics"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), os.path.join(root, sub))
    for sub in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(root, sub))
    with open(os.path.join(BENCH_DIR, "configs", "sift1m-l2.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", rows=TINY_ROWS, queries=400)
    cfg["indexes"]["ivfflat"]["ncentroids"] = 64
    _dump(os.path.join(root, "configs", "tiny.json"), cfg)
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    names = {}
    for kind, traffic in CELLS.items():
        with open(os.path.join(BENCH_DIR, "traffic", f"{traffic}.json")) as f:
            t = json.load(f)
        t.update(batch=100, warm_calls=2, keep_calls=4, trace_calls=3)
        if t.get("index"):
            t["params"] = {"nprobe": 8}
        _dump(os.path.join(root, "traffic", f"tiny-{traffic}.json"), t)
        with open(os.path.join(BENCH_DIR, "cells", f"sift1m-{traffic}.json")) as f:
            cell = json.load(f)
        cell.update(config="tiny", traffic=f"tiny-{traffic}")
        name = f"tiny-{traffic}"
        _dump(os.path.join(root, "cells", f"{name}.json"), cell)
        manifest["workloads"].append({"name": name, "config": "tiny", "traffic": f"tiny-{traffic}",
                                      "chips": 1, "why": "the CPU tests' copy"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if f"sift1m-{traffic}" in m.get("workloads", []):
                m["workloads"].append(name)
        names[kind] = name
    names["manifest"] = os.path.join(root, "manifest.json")
    _dump(names["manifest"], manifest)
    return names


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
