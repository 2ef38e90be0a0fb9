"""A tiny benchmark of text and hybrid cells for the CPU, made by adding
files only: a configuration with `documents` and an `fts` index, a text
and a hybrid traffic, their cells and a manifest, beside the benchmark's
loops, references and metric readers."""

import json
import os
import shutil

from benchmark.spec import BENCH_DIR, REPO_ROOT

CONFIG = "tiny-text"
ROWS, DIM, QUERIES, BATCH, K = 3_000, 64, 200, 32, 10
DOCUMENTS = {"vocabulary": 4_000, "zipf_s": 1.07, "mean_tokens": 24, "topical": 0.3,
             "topic_words": 40, "stop_words": "english"}
FTS = {"name": "fts", "params": {"stop_words": "english"}}
CHECKS = {"unanswered": {"max": 0}, "bad_hits": {"max": 0}, "route_misses": {"max": 0},
          "dist_err": {"max": 1e-5}, "rank_gap": {"max": 1e-5}, "recall": {"min": 0.99}}
TRAFFIC = {
    "text": {"loop": "closed_text", "mode": "text", "reference": "bm25", "index": None,
             "params": None},
    "hybrid": {"loop": "closed_hybrid", "mode": "hybrid", "reference": "bm25_fusion",
               "index": None, "params": None, "fusion_type": "rrf", "fusion_k": 60,
               "top_k_multiple_base": 3},
    "hybrid_rsf": {"loop": "closed_hybrid", "mode": "hybrid", "reference": "bm25_fusion",
                   "index": None, "params": None, "fusion_type": "rsf", "fusion_weight": 0.3,
                   "top_k_multiple_base": 3},
}
E2E = ("qps", "p95_ms", "setup_s")
PER_LAYER = ("device.idle_share", "device.ms_per_search", "program.launch_calls",
             "program.captures")


def make(root: str, checks=None) -> dict:
    """Write the tiny benchmark under `root`; returns {kind: cell name},
    the manifest's path under "manifest" and `root` under "dir"."""
    for sub in ("loops", "references", "metrics"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), os.path.join(root, sub))
    for sub in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(root, sub))
    with open(os.path.join(BENCH_DIR, "configs", "cohere1m-cosine.json")) as f:
        cfg = json.load(f)
    cfg.update(name=CONFIG, rows=ROWS, dim=DIM, queries=QUERIES, k=K, indexes={},
               corpus=dict(cfg["corpus"], centres=30), documents=DOCUMENTS, fts=FTS)
    _dump(os.path.join(root, "configs", f"{CONFIG}.json"), cfg)
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    names = {"dir": root, "manifest": os.path.join(root, "manifest.json")}
    for kind, extra in TRAFFIC.items():
        name = f"tiny-{kind}-b{BATCH}"
        traffic = dict(extra, batch=BATCH, k=K, warm_calls=2, keep_calls=4, trace_calls=3,
                       why="the CPU tests' copy")
        _dump(os.path.join(root, "traffic", f"{name}.json"), traffic)
        _dump(os.path.join(root, "cells", f"{name}.json"),
              {"config": CONFIG, "traffic": name, "chips": 1, "why": "the CPU tests' copy",
               "checks": dict(checks or CHECKS)})
        manifest["workloads"].append({"name": name, "config": CONFIG, "traffic": name,
                                      "chips": 1, "why": "the CPU tests' copy"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if m["name"] in E2E + PER_LAYER and "workloads" in m:
                m["workloads"].append(name)
        names[kind] = name
    _dump(names["manifest"], manifest)
    return names


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
