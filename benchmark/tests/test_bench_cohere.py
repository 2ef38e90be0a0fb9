"""The Cosine MSTG cell (`cohere1m-mstg-b256`) on the CPU: a tiny copy of
it made by adding files only, run whole through the harness; its control;
its reference against numpy in float64; and the IVF roofline's
arithmetic and readers."""

import json
import os
import shutil

import numpy as np
import pytest

from benchmark import harness, roofline, roofline_ivf
from benchmark.references import exact_knn_cosine
from benchmark.spec import BENCH_DIR, REPO_ROOT, Cell

SEED = 2**31 + 4242
CELL = "cohere1m-mstg-b256"
TINY = "tiny-mstg-b256"
TINY_ROWS, TINY_DIM, TINY_BATCH, TINY_NPROBE = 70_000, 64, 16, 8
COSINE = {"metric": "Cosine", "storage_dtype": "bfloat16"}


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The benchmark's loops, references and readers beside a tiny copy
    of the cell: rows past min_rows_to_build_vector_index so MSTG builds,
    a narrower width and 100 blobs so a CPU search is quick and a query's
    top 100 lie in its own blob, as at full size."""
    root = str(tmp_path_factory.mktemp("bench"))
    for sub in ("loops", "references", "metrics"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), os.path.join(root, sub))
    for sub in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(root, sub))
    cell = Cell(CELL)
    cfg = dict(cell.config, name="tiny-cosine", rows=TINY_ROWS, dim=TINY_DIM, queries=400,
               corpus=dict(cell.config["corpus"], centres=100))
    cfg["indexes"] = {"mstg": dict(cfg["indexes"]["mstg"], ncentroids=64)}
    _dump(os.path.join(root, "configs", "tiny-cosine.json"), cfg)
    traffic = dict(cell.traffic, batch=TINY_BATCH, warm_calls=2, keep_calls=4, trace_calls=3,
                   params={"nprobe": TINY_NPROBE})
    _dump(os.path.join(root, "traffic", f"{TINY}.json"), traffic)
    _dump(os.path.join(root, "cells", f"{TINY}.json"),
          dict(cell.cell, config="tiny-cosine", traffic=TINY))
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["workloads"].append({"name": TINY, "config": "tiny-cosine", "traffic": TINY,
                                  "chips": 1, "why": "the CPU tests' copy"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    _dump(os.path.join(root, "manifest.json"), manifest)
    return root


def _run(root, trace=False):
    return harness.run_cell(TINY, SEED, 0.5, trace, device="cpu", bench_dir=root,
                            manifest=os.path.join(root, "manifest.json"))


def test_a_sound_run_of_the_tiny_cell_is_correct(tiny):
    out = _run(tiny)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and out["forbidden"] == []
    assert set(res["checks"]) == {"unanswered", "bad_hits", "route_misses", "dist_err", "recall"}
    assert out["values"]["route_misses"] == 0 and out["values"]["recall"] >= 0.95
    assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}


def test_a_traced_run_reads_the_rows_the_window_step_gathered(tiny):
    """ivf.gathered_rows is the budget of windows a padded query scores:
    96 lists (64 and half again) of ~729 rows take 3 windows a probe, so
    8 probes take 8 * 3 + 4 windows of 512 rows. The CPU has no device
    timeline, so ivf_roofline reads nothing."""
    res = _run(tiny, trace=True)["result"]
    assert res["correct"], res["checks"]
    assert res["metrics"]["ivf.gathered_rows"]["value"] == (TINY_NPROBE * 3 + 4) * 512
    assert res["metrics"]["ivf.gathered_rows"]["unit"] == "rows"
    assert "ivf_roofline" not in res["metrics"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_cells_limits(tiny, seed):
    values = harness.control_numbers(TINY, seed, device="cpu", bench_dir=tiny,
                                     manifest=os.path.join(tiny, "manifest.json"))
    with open(os.path.join(tiny, "cells", f"{TINY}.json")) as f:
        limits = json.load(f)["checks"]
    ok, checks = harness.judge.compare(values, limits)
    assert not ok, checks
    assert checks["dist_err"]["value"] > checks["dist_err"]["limit"]


@pytest.mark.parametrize("blocks", [(131_072, 1_024), (700, 16)])
def test_the_cosine_reference_is_numpys_float64_formula(monkeypatch, blocks):
    monkeypatch.setattr(exact_knn_cosine, "BLOCK_ROWS", blocks[0])
    monkeypatch.setattr(exact_knn_cosine, "BLOCK_QUERIES", blocks[1])
    rng = np.random.default_rng(5)
    rows = (3 * rng.standard_normal((3000, 24)) + 1).astype(np.float32)
    queries = (rows[:40] + 0.3 * rng.standard_normal((40, 24))).astype(np.float32)
    x = rows.view(np.uint32)
    # round to nearest even at bf16, as the stored values are
    x = ((x + 0x7FFF + ((x >> 16) & 1)) & 0xFFFF0000).view(np.float32).astype(np.float64)
    q = queries.astype(np.float64)
    full = 1.0 - (q @ x.T) / np.outer(np.linalg.norm(q, axis=1), np.linalg.norm(x, axis=1))
    want_i = np.argsort(full, axis=1, kind="stable")[:, :10]
    want_d = np.take_along_axis(full, want_i, 1)
    d, ids = exact_knn_cosine.topk(rows, queries, 10, COSINE, "cpu")
    np.testing.assert_allclose(d, want_d, rtol=0, atol=1e-13)
    assert (ids == want_i).mean() > 0.99
    got = exact_knn_cosine.distances(rows, queries, want_i, COSINE, "cpu")
    np.testing.assert_allclose(got, want_d, rtol=0, atol=1e-13)
    cd, _ = exact_knn_cosine.control(rows, queries, 10, COSINE, "cpu")
    assert cd.dtype == np.float32 and np.abs(cd - want_d).max() > 1e-5


def test_the_ivf_roofline_counts_the_problems_own_work():
    # the new cell: 4,096 lists asked, 6,144 built; 4 probed of 1M SQ8
    # rows at 768-d, 400 bf16 rows re-ranked, batch 256, top 100
    probed = 1_000_000 * 4 / 6144
    nbytes = 256 * (probed * 768 + 400 * 768 * 2 + 768 * 4 + 100 * 8) + 6144 * 768 * 4
    flops = 2.0 * 256 * 6144 * 768 + 2.0 * 768 * 256 * (probed + 400)
    args = (1_000_000, 768, 256, 100, "bfloat16", "MSTG", 4096, 4)
    got = roofline_ivf.search_work(*args, rerank_multiple=4)
    assert got == pytest.approx((nbytes, flops), rel=1e-12)
    assert nbytes / roofline.PEAK_BYTES_PER_S > flops / roofline.PEAK_FLOPS["f32"]
    assert roofline_ivf.search_s(*args, rerank_multiple=4) == \
        pytest.approx(nbytes / 3.35e12, rel=1e-12)
    # another rerank_multiple re-ranks that many rows a result
    more = roofline_ivf.search_work(*args, rerank_multiple=8)[0]
    assert more - nbytes == pytest.approx(256 * 400 * 768 * 2, rel=1e-12)
    # IVFFLAT reads bf16 rows and re-ranks none: 1,024 lists asked, 1,536
    # built, 2 probed
    probed = 1_000_000 * 2 / 1536
    got = roofline_ivf.search_work(1_000_000, 128, 1000, 10, "bfloat16", "IVFFLAT", 1024, 2,
                                   rerank_multiple=4)
    assert got == pytest.approx((1000 * (probed * 128 * 2 + 128 * 4 + 80) + 1536 * 128 * 4,
                                 2.0 * 1000 * 1536 * 128 + 2.0 * 128 * 1000 * probed), rel=1e-12)
    assert roofline_ivf.search_work(1000, 8, 1, 1, "bfloat16", "IVFPQ", 4, 1,
                                    rerank_multiple=4) is None


@pytest.mark.parametrize("kind,metric,ncentroids", [("IVFFLAT", "L2", 16),
                                                    ("MSTG", "Cosine", 64)])
def test_the_ivf_roofline_sizes_the_lists_the_port_builds(kind, metric, ncentroids):
    """The probed rows the yardstick counts are those of nprobe lists of
    the index the port builds: its list count and their mean size, read
    from a built index, not from the formula."""
    from benchmark.system import PortTable
    from myscaledb_tpu_torch.metrics import Metric

    rows_n, dim, nprobe = 70_000, 8, 3
    rng = np.random.default_rng(11)
    rows = (4.0 * rng.standard_normal((50, dim))[rng.integers(0, 50, rows_n)]
            + rng.standard_normal((rows_n, dim))).astype(np.float32)
    cfg = {"storage_dtype": "bfloat16", "metric": metric, "dim": dim,
           "indexes": {"i": {"type": kind, "ncentroids": ncentroids, "metric_type": metric}}}
    t = PortTable(cfg, {"k": 10, "index": "i", "params": {"nprobe": nprobe}}, rows, "cpu")
    try:
        idx = t.table.loaded_index(0, "vec", Metric.parse(metric))
        sizes = np.diff(idx.cluster_start.cpu().numpy().astype(np.int64))
    finally:
        t.close()
    assert idx.n_clusters == len(sizes) == roofline_ivf.n_lists(rows_n, ncentroids)
    assert sizes.sum() == rows_n
    code = 2 if kind == "IVFFLAT" else 1
    reranked = 0 if kind == "IVFFLAT" else 10 * 4
    want = nprobe * sizes.mean() * dim * code + reranked * dim * 2 + dim * 4 + 80
    got = roofline_ivf.search_work(rows_n, dim, 1, 10, "bfloat16", kind, ncentroids, nprobe,
                                   rerank_multiple=4)[0]
    assert got - len(sizes) * dim * 4 == pytest.approx(want, rel=1e-12)


def test_the_ivf_readers_read_the_trace_and_the_counters():
    roof = Cell(CELL).reader("ivf_roofline")
    gathered = Cell(CELL).reader("ivf.gathered_rows")
    cell = Cell(CELL)
    obs = {"trace": {"busy_s": 0.8, "window_s": 1.0, "searches": 100},
           "traffic": cell.traffic, "config": cell.config,
           "counters": {"ivf.window_rows": 256 * 20 * 512 * 7}, "queries": 256 * 7}
    least = roofline_ivf.search_s(1_000_000, 768, 256, 100, "bfloat16", "MSTG", 4096,
                                  cell.traffic["params"]["nprobe"], rerank_multiple=4)
    assert roof(obs) == pytest.approx(100.0 * least / 0.008)
    # a spec's own rerank_multiple sizes the re-rank
    spec = dict(cell.config["indexes"]["mstg"], rerank_multiple=8)
    more = roofline_ivf.search_s(1_000_000, 768, 256, 100, "bfloat16", "MSTG", 4096,
                                 cell.traffic["params"]["nprobe"], rerank_multiple=8)
    assert roof(dict(obs, config=dict(cell.config, indexes={"mstg": spec}))) == \
        pytest.approx(100.0 * more / 0.008)
    assert gathered(obs) == 20 * 512
    exact = Cell("sift1m-exact-b1000")
    assert roof(dict(obs, traffic=exact.traffic, config=exact.config)) is None
    assert roof(dict(obs, trace=None)) is None
    # a program without the counter (the parent of this metric) reads nothing
    assert gathered(dict(obs, counters={})) is None
