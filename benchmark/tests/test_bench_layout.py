"""BENCHMARK.json, the files it names, and what the benchmark imports."""

import ast
import json
import os
import re
import sys

import pytest

from benchmark.spec import BENCH_DIR, REPO_ROOT, Cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "myscaledb_tpu"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for entry in manifest["configs"] + manifest["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    names = [e["name"] for e in manifest["configs"] + manifest["workloads"] + metrics]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in manifest["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in manifest["end_to_end"])
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_cell_config_and_metric_is_found_by_name(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        cell = Cell(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert cell.cell[key] == w[key], (w["name"], key)
        assert cell.config["name"] == w["config"]
        assert cell.loop().run and cell.reference().topk
        for trace in (False, True):
            for m in cell.metrics(trace):
                assert callable(cell.reader(m["name"]))
        got = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in got and len(got) >= 2
        assert cell.metrics(True)
    for c in manifest["configs"]:
        with open(os.path.join(REPO_ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        assert c["file"].startswith("benchmark/configs/")
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            moved = next(e for e in manifest["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", [w])


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    seen = 0
    for root, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                seen += 1
                path = os.path.join(root, f)
                for mod in _imports(path):
                    assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
    assert seen > 10


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH_DIR, "references")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] in {"numpy", "torch", "__future__"}, (f, mod)


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    import types

    from benchmark import harness

    import myscaledb_tpu_torch  # noqa: F401

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("xla_client"))
    monkeypatch.setitem(sys.modules, "myscaledb_tpu", types.ModuleType("myscaledb_tpu"))
    assert harness.forbidden_modules() == ["jaxlib.xla_client", "myscaledb_tpu"]
