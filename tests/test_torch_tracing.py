"""The port's span tracing (service/tracing.py) on the CPU: self times,
parents and trace ids, the error path, the ring's rows, the profiler's
ranges, and the spans a search opens at each layer of a small table."""

import gc
import json
import sys
import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

import myscaledb_tpu_torch as tms
from myscaledb_tpu_torch.search import program as program_mod
from myscaledb_tpu_torch.service import tracing
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS, GLOBAL_QUERY_LOG
from myscaledb_tpu_torch.service.tracing import GLOBAL_SPAN_LOG, span

DIM, N, NQ, K = 16, 4096, 8, 5
# the spans one vector search and the gather of its ids open, each once
SEARCH_PATH = ("table.search", "vector_search", "program.key", "program.run", "program.load",
               "table.gather", "result.readback")


def _rows(name=None):
    rows = GLOBAL_SPAN_LOG.rows()
    return [r for r in rows if name is None or r["span"] == name]


def test_a_parents_self_time_leaves_out_its_children():
    GLOBAL_SPAN_LOG.clear()
    before = GLOBAL_COUNTERS.snapshot()
    with span("t.parent"):
        time.sleep(0.004)
        with span("t.child"):
            time.sleep(0.006)
            with span("t.grandchild"):
                time.sleep(0.002)
        with span("t.child"):
            pass
    (p,), kids, (g,) = _rows("t.parent"), _rows("t.child"), _rows("t.grandchild")
    assert p["duration_us"] >= 12_000
    assert 4_000 <= p["self_us"] < p["duration_us"] - 8_000
    assert kids[0]["self_us"] >= 6_000 and kids[0]["duration_us"] >= 8_000
    total = p["self_us"] + sum(k["self_us"] for k in kids) + g["self_us"]
    # each self time is rounded to the microsecond on its own
    assert abs(total - p["duration_us"]) <= 4
    after = GLOBAL_COUNTERS.snapshot()
    for name, rows in (("t.parent", [p]), ("t.child", kids)):
        assert after[f"{name}.calls"] - before.get(f"{name}.calls", 0) == len(rows)
        assert (after[f"{name}.self_us"] - before.get(f"{name}.self_us", 0)
                == sum(r["self_us"] for r in rows))


def test_one_request_shares_its_trace_id_and_names_each_parent():
    GLOBAL_SPAN_LOG.clear()
    with span("t.root") as root:
        with span("t.mid") as mid:
            with span("t.leaf"):
                pass
        with span("t.side"):
            pass
    with span("t.root"):
        pass
    rows = {(r["span"], r["trace_id"]): r for r in _rows()}
    first, second = [r for r in _rows("t.root")]
    assert first["trace_id"] != second["trace_id"]
    # one random prefix a process, then a counter
    assert first["trace_id"][:8] == second["trace_id"][:8]
    assert len(first["trace_id"]) == 16
    tid = first["trace_id"]
    assert rows[("t.root", tid)]["span_id"] == root.span_id
    assert rows[("t.root", tid)]["parent_id"] == 0 and rows[("t.root", tid)]["depth"] == 0
    assert rows[("t.mid", tid)]["parent_id"] == root.span_id
    assert rows[("t.leaf", tid)]["parent_id"] == mid.span_id
    assert rows[("t.leaf", tid)]["depth"] == 2
    assert rows[("t.side", tid)]["parent_id"] == root.span_id
    assert len({r["span_id"] for r in _rows()}) == 5


def test_a_span_that_raises_is_recorded_and_reraises():
    GLOBAL_SPAN_LOG.clear()
    calls = GLOBAL_COUNTERS.get("t.fails.calls")
    with pytest.raises(KeyError):
        with span("t.outer"):
            with span("t.fails", table="x"):
                raise KeyError("gone")
    (row,) = _rows("t.fails")
    assert row["error"] == "KeyError: 'gone'" and row["table"] == "x"
    assert _rows("t.outer")[0]["error"].startswith("KeyError")
    assert GLOBAL_COUNTERS.get("t.fails.calls") == calls + 1
    with span("t.after"):
        pass
    assert _rows("t.after")[0]["parent_id"] == 0  # the failed spans were closed


def test_start_ts_is_read_before_the_body():
    GLOBAL_SPAN_LOG.clear()
    t0 = time.time()
    with span("t.timed"):
        inside = time.time()
        time.sleep(0.02)
    (row,) = _rows("t.timed")
    assert t0 <= row["start_ts"] <= inside
    assert row["duration_us"] >= 20_000


def test_ring_rows_are_left_to_the_collector_untracked():
    GLOBAL_SPAN_LOG.clear()
    for _ in range(50):
        with span("t.ring", table="x", segment=3, skipped=None):
            with span("t.ring_child"):
                pass
    gc.collect()
    raw = GLOBAL_SPAN_LOG.raw()
    assert len(raw) == 100
    assert not any(gc.is_tracked(r) for r in raw)
    row = _rows("t.ring")[0]
    assert {"trace_id", "span", "depth", "start_ts", "duration_us", "error", "parent_id",
            "self_us", "span_id"} <= set(row)
    assert row["table"] == "x" and row["segment"] == 3 and "skipped" not in row


def test_spans_on_many_threads_lose_no_count():
    """Spans count under the counters' lock: none is lost, with threads
    switching as often as they can."""
    threads, each = 12, 1000
    GLOBAL_SPAN_LOG.clear()
    before = GLOBAL_COUNTERS.snapshot()
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=30)
        for _ in range(each):
            with span("t.thread_outer"):
                with span("t.thread_inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    after = GLOBAL_COUNTERS.snapshot()
    rows = _rows()
    for name in ("t.thread_outer", "t.thread_inner"):
        mine = [r for r in rows if r["span"] == name]
        assert len(mine) == threads * each
        assert after[f"{name}.calls"] - before.get(f"{name}.calls", 0) == threads * each
        assert (after[f"{name}.self_us"] - before.get(f"{name}.self_us", 0)
                == sum(r["self_us"] for r in mine))
    by_id = {r["span_id"]: r for r in rows}
    inner = [r for r in rows if r["span"] == "t.thread_inner"]
    # each thread's spans nest in that thread's own
    assert all(by_id[r["parent_id"]]["span"] == "t.thread_outer"
               and by_id[r["parent_id"]]["trace_id"] == r["trace_id"] for r in inner)


def test_spans_are_profiler_ranges_only_while_it_records(tmp_path, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("t.outer_range"):
            with span("t.prof_a"):
                with span("t.prof_b"):
                    pass
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    by = {e["name"]: e for e in events}
    assert {"t.outer_range", "t.prof_a", "t.prof_b"} <= set(by)

    def within(inner, outer):
        return (outer["ts"] <= inner["ts"]
                and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])

    assert within(by["t.prof_a"], by["t.outer_range"])
    assert within(by["t.prof_b"], by["t.prof_a"])

    opened = []
    monkeypatch.setattr(tracing, "record_function", lambda name: opened.append(name))
    with span("t.off"):
        pass
    assert opened == []


def _table(kind):
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 100
    st.query.cost_based_index_routing = False
    db = tms.connect(st, device="cpu")
    rng = np.random.default_rng(20261018)
    t = db.create_table("spans", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(DIM)}))
    t.insert({"id": np.arange(N, dtype=np.uint64),
              "vec": rng.standard_normal((N, DIM)).astype(np.float32)})
    if kind.startswith("ivfflat"):
        t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=16)
        assert t.wait_index_built()
    return db, t, rng


@pytest.mark.parametrize("kind", ["flat", "ivfflat", "ivfflat_filter"])
def test_a_search_opens_each_layers_span_once_a_call(kind, monkeypatch):
    """The spans of one search, each once a call, and none inside a
    program's body; a filtered search opens `filter.mask` too, inside
    `vector_search` (the mask, the selectivity and the layout, built at
    the first call and then looked up)."""
    db, t, rng = _table(kind)
    flt = tms.F("id") >= N // 2 if kind == "ivfflat_filter" else None
    in_body = []
    call_body = program_mod.Program._call_body

    def watched(self):
        n = len(GLOBAL_SPAN_LOG.raw())
        out = call_body(self)
        in_body.append(len(GLOBAL_SPAN_LOG.raw()) - n)
        return out

    monkeypatch.setattr(program_mod.Program, "_call_body", watched)
    route = "VectorBruteForceSearches" if kind == "flat" else "VectorIndexSearches"
    GLOBAL_SPAN_LOG.clear()
    before = GLOBAL_COUNTERS.snapshot()
    calls = 4
    for _ in range(calls):
        q = rng.standard_normal((NQ, DIM)).astype(np.float32)
        res = t.search("vec", q, K, params=None if kind == "flat" else {"nprobe": 4},
                       filter=flt)
        ids = t.gather(res, ["id"])["id"]
        assert ids.shape == (NQ, K)
    after = GLOBAL_COUNTERS.snapshot()
    got = {k[: -len(".calls")]: after[k] - before.get(k, 0)
           for k in after if k.endswith(".calls") and after[k] != before.get(k, 0)}
    assert after[route] - before.get(route, 0) == calls
    assert len(t._programs) == 1
    path = SEARCH_PATH + (("filter.mask",) if flt is not None else ())
    assert got == {s: calls for s in path}
    # one capture a program, then a replay a call
    assert after["SearchProgramCaptures"] - before.get("SearchProgramCaptures", 0) == 1
    assert after["SearchProgramReplays"] - before.get("SearchProgramReplays", 0) == calls
    # nothing opens inside a program's body
    assert in_body == [0] * calls
    rows = _rows()
    by_id = {r["span_id"]: r for r in rows}
    for r in rows:
        if r["parent_id"]:
            assert by_id[r["parent_id"]]["span"] != "program.load"
            assert by_id[r["parent_id"]]["trace_id"] == r["trace_id"]
    for name in ("vector_search", "program.key"):
        assert all(by_id[r["parent_id"]]["span"] != "table.gather" for r in _rows(name))
    assert {by_id[r["parent_id"]]["span"] for r in _rows("result.readback")} == {"table.gather"}
    assert {by_id[r["parent_id"]]["span"] for r in _rows("filter.mask")} <= {"vector_search"}
    db.close()


def test_the_query_log_takes_the_root_spans_clock():
    db, t, rng = _table("flat")
    GLOBAL_SPAN_LOG.clear()
    t.search("vec", rng.standard_normal((NQ, DIM)).astype(np.float32), K)
    (root,) = _rows("table.search")
    (inner,) = _rows("vector_search")
    logged = [r for r in GLOBAL_QUERY_LOG.rows() if r["table"] == "spans"][-1]
    assert inner["duration_us"] <= logged["duration_ms"] * 1e3 <= root["duration_us"] + 1
    db.close()


def test_text_and_hybrid_searches_open_their_roots():
    db, t, rng = _table("flat")
    db.drop_table("spans")
    t = db.create_table("docs", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(DIM),
                                            "body": tms.String()}))
    words = np.array([f"w{i}" for i in range(30)])
    n = 512
    t.insert({"id": np.arange(n, dtype=np.uint64),
              "vec": rng.standard_normal((n, DIM)).astype(np.float32),
              "body": np.array([" ".join(rng.choice(words, 5)) for _ in range(n)], dtype=object)})
    t.add_fts_index("ft", "body")
    GLOBAL_SPAN_LOG.clear()
    t.text_search("ft", ["w1 w2", "w3"], k=K)
    t.hybrid_search("vec", "ft", rng.standard_normal(DIM).astype(np.float32), "w4 w5", k=K)
    rows = _rows()
    by_id = {r["span_id"]: r for r in rows}
    (troot,) = [r for r in rows if r["span"] == "table.text_search"]
    text = [r for r in rows if r["span"] == "text_search"]
    assert by_id[text[0]["parent_id"]] is troot
    (hroot,) = [r for r in rows if r["span"] == "table.hybrid_search"]
    (hyb,) = [r for r in rows if r["span"] == "hybrid_search"]
    assert hyb["parent_id"] == hroot["span_id"]
    inside = [r for r in rows if r["trace_id"] == hroot["trace_id"]]
    names = {r["span"] for r in inside}
    assert {"table.search", "vector_search", "text_search", "program.run"} <= names
    assert {by_id[r["parent_id"]]["span"] for r in inside if r["span"] == "table.search"} == {
        "hybrid_search"}
    db.close()
