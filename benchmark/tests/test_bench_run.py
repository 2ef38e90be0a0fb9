"""Whole runs on the CPU at a tiny size: a cell added by files only, the
result line's schema, `correct` on the sound program, and `correct` false
with the timed path broken underneath or with the control in its place."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import tinycell

from benchmark import harness
from benchmark.spec import REPO_ROOT

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    names = tinycell.make(root)
    names["dir"] = root
    return names


def _run(tiny, kind, trace=False, seconds=0.5, seed=SEED):
    return harness.run_cell(tiny[kind], seed, seconds, trace, device="cpu",
                            bench_dir=tiny["dir"], manifest=tiny["manifest"])


def _schema(res, trace):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] >= 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    for c in res["checks"].values():
        assert {"value", "limit"} <= set(c)
    json.loads(json.dumps(res))


@pytest.mark.parametrize("kind", ["exact", "ivfflat"])
def test_a_sound_run_is_correct(tiny, kind):
    out = _run(tiny, kind)
    res = out["result"]
    _schema(res, False)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and out["forbidden"] == []
    with open(tiny["manifest"]) as f:
        declared = json.load(f)["end_to_end"]
    want = {m["name"] for m in declared if tiny[kind] in m.get("workloads", [tiny[kind]])}
    assert "qps" in want and set(res["metrics"]) == want


# read from the card's busy time in the trace, which the CPU does not have
DEVICE_TIME = {"device.idle_share", "device.ms_per_search", "scan_roofline", "ivf_roofline"}


@pytest.mark.parametrize("kind", ["exact", "ivfflat"])
def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(tiny, kind):
    res = _run(tiny, kind, trace=True)["result"]
    _schema(res, True)
    assert res["correct"]
    # the CPU has no device timeline: every metric the cell declares is read
    # but those of the card's busy time (the counters', the spans' and the
    # profiler's CPU events')
    with open(tiny["manifest"]) as f:
        declared = {m["name"] for m in json.load(f)["per_layer"]
                    if tiny[kind] in m.get("workloads", [tiny[kind]])}
    assert {"program.launch_calls", "program.captures", "frontend.host_ms",
            "executor.plan_ms", "program.key_ms", "program.host_ms", "program.wait_ms",
            "executor.plan_hit_share"} <= declared
    assert set(res["metrics"]) == declared - DEVICE_TIME


def test_the_traced_window_opens_on_its_first_call(tiny, monkeypatch):
    """Nothing but the traced calls runs in the window: its first search
    starts as it opens, so no gap of the harness's own counts as idle."""
    from benchmark import trace

    seen = {}
    summary = trace.summary

    def spy(events):
        seen["events"] = events
        return summary(events)

    monkeypatch.setattr(trace, "summary", spy)
    _run(tiny, "exact", trace=True)
    win = next(e for e in seen["events"] if e.get("name") == trace.WINDOW)
    first = min(e["ts"] for e in seen["events"]
                if e.get("name") == "bench.search" and e["ts"] >= win["ts"])
    assert first - win["ts"] < 2000  # microseconds


def _alter_one_answer(monkeypatch):
    from myscaledb_tpu_torch.search import executor

    orig = executor.SearchResult._materialize

    def altered(self):
        first = self._host is None
        vals, segs, rows = orig(self)
        if first:
            rows[0, 0] = (rows[0, 0] + 1) % 1000
        return vals, segs, rows

    monkeypatch.setattr(executor.SearchResult, "_materialize", altered)


def _leave_out_half(monkeypatch):
    from myscaledb_tpu_torch.search import executor

    orig = executor.SearchResult._materialize

    def half(self):
        first = self._host is None
        vals, segs, rows = orig(self)
        if first:
            cut = (rows.shape[0] + 1) // 2
            rows[cut:] = -1
            segs[cut:] = -1
            vals[cut:] = -np.inf
        return vals, segs, rows

    monkeypatch.setattr(executor.SearchResult, "_materialize", half)


def _state_unchanged(monkeypatch):
    from myscaledb_tpu_torch.search import program

    orig = program.Program.run
    first = {}

    def stale(self, *a, **kw):
        out = orig(self, *a, **kw)
        return first.setdefault(id(self), out.clone())

    monkeypatch.setattr(program.Program, "run", stale)


def _index_skipped(monkeypatch):
    from myscaledb_tpu_torch.storage.table import Table

    monkeypatch.setattr(Table, "loaded_index", lambda self, *a, **kw: None)


FAULTS = {"answer_altered": _alter_one_answer, "half_left_out": _leave_out_half,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("kind", ["exact", "ivfflat"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, kind, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tiny, kind)["result"]
    assert not res["correct"], res["checks"]


def test_an_index_left_out_of_the_route_is_not_correct(tiny, monkeypatch):
    _index_skipped(monkeypatch)
    res = _run(tiny, "ivfflat")["result"]
    assert not res["correct"]
    assert res["checks"]["route_misses"]["value"] > 0


@pytest.mark.parametrize("kind", ["exact", "ivfflat"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(tiny, kind, seed):
    """The reference one precision lower in the program's place fails the
    cell's own limits (the readings on the card are in PERF.md)."""
    values = harness.control_numbers(tiny[kind], seed, device="cpu", bench_dir=tiny["dir"],
                                     manifest=tiny["manifest"])
    with open(os.path.join(tiny["dir"], "cells", f"{tiny[kind]}.json")) as f:
        limits = json.load(f)["checks"]
    ok, checks = harness.judge.compare(values, limits)
    assert not ok, checks


def test_run_py_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the refusal is for machines without one")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "benchmark", "run.py"), "--workload",
         "sift1m-exact-b1000", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
