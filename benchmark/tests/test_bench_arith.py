"""The reference, the percentile, the idle union, the roofline and the
metric readers on small and synthetic inputs."""

import statistics

import numpy as np
import pytest

from benchmark import judge, roofline, trace
from benchmark.references import exact_knn
from benchmark.spec import Cell

CFG = {"metric": "L2", "storage_dtype": "bfloat16"}


def _data(n=3000, d=24, nq=40, seed=0):
    rng = np.random.default_rng(seed)
    rows = (3 * rng.standard_normal((n, d))).astype(np.float32)
    queries = (rows[:nq] + 0.3 * rng.standard_normal((nq, d))).astype(np.float32)
    return rows, queries


def _brute(rows, queries, k):
    x = rows.astype(np.float32).view(np.uint32)
    # round to nearest even at bf16, as the stored values are
    x = ((x + 0x7FFF + ((x >> 16) & 1)) & 0xFFFF0000).view(np.float32).astype(np.float64)
    d = ((queries.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.mark.parametrize("blocks", [(131_072, 1_024), (700, 16)])
def test_reference_topk_matches_a_numpy_brute_force(monkeypatch, blocks):
    monkeypatch.setattr(exact_knn, "BLOCK_ROWS", blocks[0])
    monkeypatch.setattr(exact_knn, "BLOCK_QUERIES", blocks[1])
    rows, queries = _data()
    d, ids = exact_knn.topk(rows, queries, 10, CFG, "cpu")
    want_d, want_i = _brute(rows, queries, 10)
    np.testing.assert_allclose(d, want_d, rtol=1e-12)
    assert (ids == want_i).mean() > 0.99
    got = exact_knn.distances(rows, queries, want_i, CFG, "cpu")
    np.testing.assert_allclose(got, want_d, rtol=1e-12)


def test_judge_passes_the_reference_and_fails_its_control():
    rows, queries = _data(n=20_000, d=128, nq=200)
    rows = rows * 2 + 6
    queries = queries * 2 + 6
    qi = np.arange(queries.shape[0])
    d, ids = exact_knn.topk(rows, queries, 10, CFG, "cpu")
    good = judge.numbers([(qi, ids, d.astype(np.float32))], rows, queries, 10, CFG, exact_knn,
                         "cpu")
    cd, ci = exact_knn.control(rows, queries, 10, CFG, "cpu")
    bad = judge.numbers([(qi, ci, cd)], rows, queries, 10, CFG, exact_knn, "cpu")
    assert good["bad_hits"] == 0 and good["recall"] == 1.0
    assert good["dist_err"] < 1e-6 and good["rank_gap"] < 1e-12
    assert bad["dist_err"] > 100 * max(good["dist_err"], 1e-9)


def test_judge_counts_empty_repeated_and_out_of_range_hits():
    rows, queries = _data()
    d, ids = exact_knn.topk(rows, queries, 10, CFG, "cpu")
    ids = ids.copy()
    ids[0, 0] = -1
    ids[1, 1] = ids[1, 0]
    ids[2, 2] = rows.shape[0]
    v = judge.numbers([(np.arange(len(queries)), ids, d)], rows, queries, 10, CFG, exact_knn,
                      "cpu")
    assert v["bad_hits"] == 3


def test_compare_holds_each_number_to_its_limit():
    ok, checks = judge.compare({"a": 1.0, "b": 0.9}, {"a": {"max": 1.0}, "b": {"min": 0.95}})
    assert not ok and checks["a"]["value"] == 1.0 and checks["b"]["limit"] == 0.95
    ok, _ = judge.compare({"a": 0.5}, {"a": {"max": 1.0}, "c": {"max": 0}})
    assert not ok  # a number the run did not give fails


def test_p95_is_the_inclusive_95th_percentile():
    read = Cell("sift1m-exact-b1000").reader("p95_ms")
    for v in ([5.0, 1.0, 3.0, 2.0, 4.0], list(np.random.default_rng(3).exponential(1, 997))):
        want = 1e3 * statistics.quantiles(v, n=100, method="inclusive")[94]
        assert read({"latencies_s": np.asarray(v)}) == pytest.approx(want)
    assert read({"latencies_s": np.asarray([])}) is None


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary_unions_device_time_and_labels_gaps():
    events = [
        _ev(trace.WINDOW, "user_annotation", 100.0, 100.0),
        _ev("k1", "kernel", 90.0, 20.0),      # clipped to [100, 110]
        _ev("k2", "kernel", 105.0, 10.0),     # overlaps k1: union [100, 115]
        _ev("Memcpy DtoH", "gpu_memcpy", 150.0, 10.0),
        _ev("k1", "kernel", 195.0, 10.0),     # clipped to [195, 200]
        _ev("k3", "kernel", 300.0, 5.0),      # outside the window
        _ev("bench.search", "user_annotation", 100.0, 90.0),
        _ev("cudaGraphLaunch", "cuda_runtime", 112.0, 3.0),
        _ev("cudaMemcpyAsync", "cuda_runtime", 118.0, 30.0),
        _ev("cudaStreamSynchronize", "cuda_runtime", 120.0, 2.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 400.0, 1.0),  # outside
    ]
    s = trace.summary(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((15 + 10 + 5) * 1e-6)
    assert s["launch_calls"] == 2
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([35e-6, 35e-6])
    assert {g[0] for g in gaps} == {"cudaMemcpyAsync", "bench.search"}
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(30e-6) and "k3" not in ops


def test_trace_summary_needs_its_window():
    with pytest.raises(ValueError):
        trace.summary([_ev("k", "kernel", 0.0, 1.0)])


def test_calls_before_the_window_stay_outside_it():
    """The profiler's start-up falls on the calls made before the window
    opens, not on the window's first call."""
    from torch.profiler import record_function

    def step(name):
        with record_function(name):
            sum(range(1000))

    events = trace.record(lambda: step("in"), "cpu", before=lambda: step("before"))
    win = next(e for e in events if e.get("name") == trace.WINDOW)
    first = next(e for e in events if e.get("name") == "before")
    inner = next(e for e in events if e.get("name") == "in")
    assert first["ts"] + first["dur"] <= win["ts"] <= inner["ts"]


def test_roofline_of_the_exact_scan():
    s = roofline.exact_scan_s(1_000_000, 128, 100, 10, "bfloat16")
    nbytes = 1_000_000 * 128 * 2 + 100 * 128 * 4 + 100 * 10 * 8
    assert s == pytest.approx(nbytes / 3.35e12)  # bound by bytes at 128-d
    g = roofline.exact_scan_s(1_000_000, 960, 256, 10, "bfloat16")
    assert g == pytest.approx((1_000_000 * 960 * 2 + 256 * 960 * 4 + 256 * 80) / 3.35e12)
    assert roofline.bound_s(0, 989e12, "bf16") == pytest.approx(1.0)


def test_metric_readers_on_a_synthetic_observation():
    cell = Cell("sift1m-exact-b1000")
    t = {"busy_s": 0.25, "window_s": 1.0, "searches": 500, "launch_calls": 2000}
    obs = {"setup_s": 12.5, "latencies_s": np.linspace(1e-3, 2e-3, 101),
           "queries": 50_000, "window_s": 10.0, "counters": {"SearchProgramCaptures": 0},
           "trace": t, "config": cell.config, "traffic": cell.traffic, "searches": 500}
    read = {m: cell.reader(m)(obs) for m in
            ("qps", "p95_ms", "setup_s", "device.idle_share", "device.ms_per_search",
             "scan_roofline", "program.launch_calls", "program.captures")}
    assert read["qps"] == 5000.0 and read["p95_ms"] == pytest.approx(1.95)
    assert read["device.idle_share"] == 75.0 and read["device.ms_per_search"] == 0.5
    assert read["scan_roofline"] == pytest.approx(
        100 * roofline.exact_scan_s(1_000_000, 128, 1000, 10, "bfloat16") / 0.5e-3)
    assert read["program.launch_calls"] == 4.0 and read["program.captures"] == 0
    obs["trace"] = dict(t, busy_s=0.0)
    assert cell.reader("device.idle_share")(obs) is None  # nothing ran: no share
    assert cell.reader("scan_roofline")(obs) is None
