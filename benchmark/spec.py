"""Find a cell, its configuration, its traffic, its metrics and its loop by name."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from its file: metric files carry dots in their names, so
    they are loaded by path and not by import."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its own file, its configuration's and its traffic's, and
    the metrics BENCHMARK.json declares for it."""

    def __init__(self, name: str, bench_dir: str = BENCH_DIR,
                 manifest: Optional[str] = None):
        self.name = name
        self.dir = bench_dir
        self.cell = _json(os.path.join(bench_dir, "cells", f"{name}.json"))
        self.config = _json(os.path.join(bench_dir, "configs", f"{self.cell['config']}.json"))
        self.traffic = _json(os.path.join(bench_dir, "traffic", f"{self.cell['traffic']}.json"))
        self.manifest = _json(manifest or os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        """The end-to-end metrics (trace 0) or per-layer ones (trace 1)
        that BENCHMARK.json declares for this cell."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(os.path.join(self.dir, "metrics", f"{metric}.py"), metric).read

    def loop(self):
        kind = self.traffic["loop"]
        return load_module(os.path.join(self.dir, "loops", f"{kind}.py"), kind)

    def reference(self):
        """The plain reference: the traffic's where it names one (a text or
        hybrid search of the configuration's table), else the
        configuration's."""
        kind = self.traffic.get("reference") or self.config["reference"]
        return load_module(os.path.join(self.dir, "references", f"{kind}.py"), kind)
