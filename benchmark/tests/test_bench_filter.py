"""The pre-filtered Cosine MSTG cell (`cohere1m-mstg-f99-b256`) on the CPU:
a tiny copy of it made by adding files only, run whole through the
harness; faults planted under it and its control; its reference against
numpy in float64; the filters its files state; and the `filter.mask_ms`
reader."""

import json
import os
import shutil

import numpy as np
import pytest

from benchmark import harness
from benchmark.references import exact_knn_cosine_filter
from benchmark.spec import BENCH_DIR, REPO_ROOT, Cell

SEED = 2**31 + 9901
CELL = "cohere1m-mstg-f99-b256"
TINY = "tiny-mstg-f99-b256"
TINY_ROWS, TINY_DIM, TINY_BATCH, TINY_NPROBE = 70_000, 64, 16, 8
PASS_FROM = TINY_ROWS - TINY_ROWS // 100  # 1% of the rows pass, as in the cell


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The benchmark's loops, references and readers beside a tiny copy
    of the cell (the Cohere cell's tiny copy in test_bench_cohere.py, with
    the filter at 1% of its rows: exactly at filter_fallback_selectivity,
    so the index answers)."""
    root = str(tmp_path_factory.mktemp("bench"))
    for sub in ("loops", "references", "metrics"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), os.path.join(root, sub))
    for sub in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(root, sub))
    cell = Cell(CELL)
    flt = dict(cell.config["filter"], value=PASS_FROM)
    cfg = dict(cell.config, name="tiny-cosine-f99", rows=TINY_ROWS, dim=TINY_DIM, queries=400,
               corpus=dict(cell.config["corpus"], centres=100), filter=flt)
    cfg["indexes"] = {"mstg": dict(cfg["indexes"]["mstg"], ncentroids=64)}
    _dump(os.path.join(root, "configs", "tiny-cosine-f99.json"), cfg)
    traffic = dict(cell.traffic, batch=TINY_BATCH, warm_calls=2, keep_calls=4, trace_calls=3,
                   params={"nprobe": TINY_NPROBE}, filter=flt)
    _dump(os.path.join(root, "traffic", f"{TINY}.json"), traffic)
    _dump(os.path.join(root, "cells", f"{TINY}.json"),
          dict(cell.cell, config="tiny-cosine-f99", traffic=TINY))
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["workloads"].append({"name": TINY, "config": "tiny-cosine-f99", "traffic": TINY,
                                  "chips": 1, "why": "the CPU tests' copy"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    _dump(os.path.join(root, "manifest.json"), manifest)
    return root


def _run(root, trace=False):
    return harness.run_cell(TINY, SEED, 0.5, trace, device="cpu", bench_dir=root,
                            manifest=os.path.join(root, "manifest.json"))


def test_a_sound_run_of_the_filtered_cell_is_correct(tiny):
    out = _run(tiny)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and out["forbidden"] == []
    assert set(res["checks"]) == {"unanswered", "bad_hits", "route_misses", "dist_err", "recall"}
    assert out["values"]["bad_hits"] == 0 and out["values"]["recall"] >= 0.95
    assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}


def test_a_traced_run_reads_the_filters_span(tiny):
    """filter.mask_ms reads the span's self time; ivf.gathered_rows the
    candidates the layout scores: 8 lists of 70,000 / 96 rows, rounded
    up (730 a list), a padded query."""
    res = _run(tiny, trace=True)["result"]
    assert res["correct"], res["checks"]
    assert res["metrics"]["filter.mask_ms"]["unit"] == "ms"
    assert res["metrics"]["filter.mask_ms"]["value"] > 0
    assert res["metrics"]["ivf.gathered_rows"]["value"] == TINY_NPROBE * 730
    assert "ivf_roofline" not in res["metrics"]  # the CPU has no device timeline


def _alter(monkeypatch, change):
    from myscaledb_tpu_torch.search import executor

    orig = executor.SearchResult._materialize

    def altered(self):
        first = self._host is None
        vals, segs, rows = orig(self)
        if first:
            change(vals, segs, rows)
        return vals, segs, rows

    monkeypatch.setattr(executor.SearchResult, "_materialize", altered)


def _filter_ignored(monkeypatch):
    from myscaledb_tpu_torch.storage.table import Table

    orig = Table.search
    monkeypatch.setattr(Table, "search",
                        lambda self, *a, filter=None, **kw: orig(self, *a, **kw))


def _one_failing_row(monkeypatch):
    def change(vals, segs, rows):
        rows[0, 0] = 0  # id 0 fails id >= PASS_FROM

    _alter(monkeypatch, change)


def _half_of_k_empty(monkeypatch):
    def change(vals, segs, rows):
        half = rows.shape[1] // 2
        rows[:, half:] = -1
        segs[:, half:] = -1
        vals[:, half:] = -np.inf

    _alter(monkeypatch, change)


FAULTS = {"filter_ignored": _filter_ignored, "one_failing_row": _one_failing_row,
          "half_of_k_empty": _half_of_k_empty}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = _run(tiny)["result"]
    assert not res["correct"], res["checks"]
    if fault == "half_of_k_empty":
        assert res["checks"]["bad_hits"]["value"] > 0
    else:
        assert res["checks"]["dist_err"]["value"] == np.inf


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_cells_limits(tiny, seed):
    values = harness.control_numbers(TINY, seed, device="cpu", bench_dir=tiny,
                                     manifest=os.path.join(tiny, "manifest.json"))
    with open(os.path.join(tiny, "cells", f"{TINY}.json")) as f:
        limits = json.load(f)["checks"]
    ok, checks = harness.judge.compare(values, limits)
    assert not ok, checks
    assert checks["dist_err"]["value"] > checks["dist_err"]["limit"]
    assert values["bad_hits"] == 0  # the control keeps to the filter


def test_every_filtered_configuration_states_its_cells_filter():
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    seen = 0
    for w in manifest["workloads"]:
        cell = Cell(w["name"])
        if "filter" in cell.config or "filter" in cell.traffic:
            assert cell.traffic.get("filter") == cell.config.get("filter"), w["name"]
            assert cell.traffic["loop"] == "closed_filter"
            seen += 1
    assert seen >= 1
    assert Cell(CELL).config["filter"] == {"column": "id", "op": ">=", "value": 990_000}


@pytest.mark.parametrize("blocks", [(131_072, 1_024), (700, 16)])
def test_the_filtered_reference_is_numpys_float64_formula(monkeypatch, blocks):
    monkeypatch.setattr(exact_knn_cosine_filter, "BLOCK_ROWS", blocks[0])
    monkeypatch.setattr(exact_knn_cosine_filter, "BLOCK_QUERIES", blocks[1])
    cfg = {"metric": "Cosine", "storage_dtype": "bfloat16",
           "filter": {"column": "id", "op": ">=", "value": 2_500}}
    rng = np.random.default_rng(7)
    rows = (3 * rng.standard_normal((3000, 24)) + 1).astype(np.float32)
    queries = (rows[:40] + 0.3 * rng.standard_normal((40, 24))).astype(np.float32)
    x = rows.view(np.uint32)
    # round to nearest even at bf16, as the stored values are
    x = ((x + 0x7FFF + ((x >> 16) & 1)) & 0xFFFF0000).view(np.float32).astype(np.float64)
    q = queries.astype(np.float64)
    full = 1.0 - (q @ x.T) / np.outer(np.linalg.norm(q, axis=1), np.linalg.norm(x, axis=1))
    full[:, :2_500] = np.inf
    want_i = np.argsort(full, axis=1, kind="stable")[:, :10]
    want_d = np.take_along_axis(full, want_i, 1)
    d, ids = exact_knn_cosine_filter.topk(rows, queries, 10, cfg, "cpu")
    np.testing.assert_allclose(d, want_d, rtol=0, atol=1e-13)
    assert (ids >= 2_500).all() and (ids == want_i).mean() > 0.99
    got = exact_knn_cosine_filter.distances(rows, queries, want_i, cfg, "cpu")
    np.testing.assert_allclose(got, want_d, rtol=0, atol=1e-13)
    # a row outside the filter is infinitely far
    assert np.isinf(exact_knn_cosine_filter.distances(rows, queries, want_i - 2_500, cfg,
                                                      "cpu")).all()
    cd, ci = exact_knn_cosine_filter.control(rows, queries, 10, cfg, "cpu")
    assert cd.dtype == np.float32 and (ci >= 2_500).all() and np.abs(cd - want_d).max() > 1e-5


def test_the_mask_reader_reads_the_span_and_nothing_without_it():
    read = Cell(CELL).reader("filter.mask_ms")
    assert read({"counters": {"filter.mask.self_us": 3_000, "filter.mask.calls": 10},
                 "searches": 10}) == pytest.approx(0.3)
    # a program without the span (the parent of this metric) reads nothing
    for obs in ({"counters": {"vector_search.calls": 10}, "searches": 10},
                {"counters": {}, "searches": 0}):
        assert read(obs) is None
