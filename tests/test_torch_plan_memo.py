"""The executor's memo of resolved plans (search/executor.py), on the CPU.

A repeated fused search runs the plan kept under its request's key in the
table's program cache, with no planning: `SearchPlanHits` counts it, the
program is the one the planning made, and the answer is a cold plan's bit
for bit. Everything a plan reads is in its key or moves the table's
`segment_version`: each such change plans afresh and answers as a cold
plan does. A Lambda filter and the two-stage path are never kept; the
route counters and the index cache's recency see a hit as they see a
planned search. The mutations
that tests/test_torch_programs.py drives against the JAX package (insert,
delete, UPDATE of a filtered column, merge, truncate) and its eight
threads check the memo there.
"""

import numpy as np
import pytest

import myscaledb_tpu_torch as tms
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

K, DIM, NQ, NCENT = 10, 16, 8, 16
N1, N2 = 6_000, 1_000  # segment 0 takes an index (min rows 5,000), segment 1 does not
ROUTES = ("VectorSearchQueries", "VectorIndexSearches", "VectorBruteForceSearches",
          "VectorIndexFallbackToFlat", "VectorIndexCostRouteToScan",
          "VectorSearchSegmentsSkipped", "IvfFilterLayoutHits", "IvfFilterLayoutBuilds")
P = {"nprobe": 4}


def _counts(fn):
    """fn's result and the counters it moved."""
    before = GLOBAL_COUNTERS.snapshot()
    out = fn()
    after = GLOBAL_COUNTERS.snapshot()
    return out, {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _table(kind):
    """A port table of two segments: index-less, or with `kind` built on the
    first; every query batch and filter below is drawn from one seed."""
    rng = np.random.default_rng(27)
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 5_000
    db = tms.connect(st, device="cpu")
    binary = kind == "binary"
    vec = tms.BinaryVector(DIM * 8) if binary else tms.FloatVector(DIM)
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "tag": tms.Int32(), "vec": vec}))
    for lo, n in ((0, N1), (N1, N2)):
        data = (rng.integers(0, 256, (n, DIM), dtype=np.uint8) if binary
                else rng.standard_normal((n, DIM)).astype(np.float32))
        t.insert({"id": np.arange(lo, lo + n, dtype=np.uint64),
                  "tag": rng.integers(0, 10, n).astype(np.int32), "vec": data})
    if kind in ("IVFFLAT", "MSTG"):
        t.add_vector_index("i", "vec", type=kind, ncentroids=NCENT)
        assert t.wait_index_built()
    q = (rng.integers(0, 256, (NQ * 2, DIM), dtype=np.uint8) if binary
         else rng.standard_normal((NQ * 2, DIM)).astype(np.float32))
    return db, t, q


@pytest.fixture(scope="module")
def tables():
    made = {kind: _table(kind) for kind in ("exact", "IVFFLAT", "MSTG", "binary")}
    yield made
    for db, _, _ in made.values():
        db.close()


def _same(a, b):
    np.testing.assert_array_equal(a.segments, b.segments)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.scores, b.scores)


def _cold(t, *args, **kw):
    """The answer of a cold plan: nothing kept."""
    t._programs.invalidate()
    res = t.search(*args, **kw)
    res.rows  # read back before anything else runs
    return res


# kind, the search's keywords
CASES = {
    "exact": ("exact", {}),
    "ivfflat": ("IVFFLAT", {"params": P}),
    "mstg": ("MSTG", {"params": P}),
    "mstg_filter": ("MSTG", {"params": P, "filter": tms.F("id") >= N1 // 3}),
    "binary": ("binary", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_repeated_search_runs_the_kept_plan(tables, case):
    kind, kw = CASES[case]
    _, t, q = tables[kind]
    cold = _cold(t, "vec", q[:NQ], K, **kw)
    prog, = t._programs.programs()
    hit, moved = _counts(lambda: t.search("vec", q[:NQ], K, **kw))
    assert moved.get("SearchPlanHits") == 1 and "SearchPlanMisses" not in moved
    assert "SearchProgramCaptures" not in moved and t._programs.programs() == [prog]
    _same(hit, cold)
    if case == "mstg_filter":  # through the index's layout of the passing rows
        assert moved["IvfFilterLayoutHits"] == 1 and "IvfFilterLayoutBuilds" not in moved
        assert (t.gather(hit, ["id"])["id"] >= N1 // 3).all()


def _miss_then_fresh(t, q, change, kw):
    """Keep the plan of `kw`'s search, make `change` (it returns the
    search's keywords after it, or None for the same; "nq" is the batch's
    rows), search: it plans (a miss) and answers as a cold plan does;
    repeated, it hits."""
    t.search("vec", q[:NQ], **kw)
    _, moved = _counts(lambda: t.search("vec", q[:NQ], **kw))
    assert moved.get("SearchPlanHits") == 1
    after = dict(change() or kw)
    nq = after.pop("nq", NQ)
    got, moved = _counts(lambda: t.search("vec", q[:nq], **after))
    assert moved.get("SearchPlanMisses") == 1 and "SearchPlanHits" not in moved
    again, moved = _counts(lambda: t.search("vec", q[:nq], **after))
    assert moved.get("SearchPlanHits") == 1
    _same(again, got)
    _same(got, _cold(t, "vec", q[:nq], **after))


FLT = tms.F("tag") < 5
BASE = {"k": K, "params": P, "filter": FLT}

# a request that differs from BASE in one part of its key
REQUESTS = {
    "k": dict(BASE, k=K + 1),
    "nprobe": dict(BASE, params={"nprobe": 8}),
    "batch_bucket": dict(BASE, nq=NQ + 3),
    "filter_constant": dict(BASE, filter=tms.F("tag") < 6),
    "metric": dict(BASE, metric="IP"),
}


@pytest.mark.parametrize("part", list(REQUESTS))
def test_another_request_plans_afresh(tables, part):
    _, t, q = tables["MSTG"]
    _miss_then_fresh(t, q, lambda: REQUESTS[part], BASE)


# each settings field a plan reads, and a value that changes it
SETTINGS = {
    "max_search_result_window": ("query", 5_000),
    "two_stage_search": ("query", True),
    "optimize_prefilter_in_search": ("query", False),
    "filter_fallback_selectivity": ("query", 0.9),
    "cost_based_index_routing": ("query", False),
    "min_rows_to_build_vector_index": ("table", 500),
    "enable_brute_force_vector_search": ("query", False),
    "use_approx_topk": ("query", True),
    "approx_topk_recall_target": ("query", 0.9),
}


@pytest.mark.parametrize("field", list(SETTINGS))
def test_a_changed_setting_plans_afresh(field):
    """Every settings field the plan reads is in its key by value."""
    db, t, q = _table("MSTG")
    sec, value = SETTINGS[field]
    _miss_then_fresh(t, q, lambda: setattr(getattr(t.settings, sec), field, value), BASE)
    db.close()


def test_the_two_stage_path_plans_every_search(tables):
    """Under two_stage the MSTG segment's first pass and re-rank run
    eagerly: nothing is kept, every search plans."""
    _, t, q = tables["MSTG"]
    for _ in range(3):
        got, moved = _counts(lambda: t.search("vec", q[:NQ], K, params=P, two_stage=True))
        assert moved.get("SearchPlanMisses") == 1 and "SearchPlanHits" not in moved
    _same(got, _cold(t, "vec", q[:NQ], K, params=P, two_stage=True))


def _build(t):
    t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=NCENT)
    assert t.wait_index_built()


# an index change a kept plan must not outlive (the data's changes are
# cases of tests/test_torch_programs.py::test_mutation_misses_the_cache)
INDEX_CHANGES = {
    "index_build": ("exact", _build),
    "dropped_index": ("MSTG", lambda t: t.drop_vector_index("i")),
}


@pytest.mark.parametrize("what", list(INDEX_CHANGES))
def test_a_changed_index_plans_afresh(what):
    kind, mutate = INDEX_CHANGES[what]
    db, t, q = _table(kind)
    version = t.segment_version
    had = t.loaded_index(0, "vec", Metric.L2)

    def change():
        mutate(t)
        assert t.segment_version > version
        assert (t.loaded_index(0, "vec", Metric.L2) is None) == (had is not None)

    _miss_then_fresh(t, q, change, BASE)
    db.close()


def test_a_lambda_filter_never_hits(tables):
    _, t, q = tables["MSTG"]
    flt = tms.Lambda(["tag"], lambda tag: tag < 5)
    for _ in range(3):
        _, moved = _counts(lambda: t.search("vec", q[:NQ], K, params=P, filter=flt))
        assert moved.get("SearchPlanMisses") == 1 and "SearchPlanHits" not in moved


def _route_case(route, monkeypatch):
    """A table and the keywords of a search whose planning bumps `route`."""
    db, t, q = _table("MSTG")
    kw = dict(BASE)
    if route == "IvfFilterLayoutHits":
        kw["filter"] = tms.F("id") >= N1 // 3
    elif route == "VectorIndexFallbackToFlat":
        t.settings.query.filter_fallback_selectivity = 0.9
    elif route == "VectorIndexCostRouteToScan":
        idx = t.loaded_index(0, "vec", Metric.L2)
        monkeypatch.setattr(type(idx), "prefer_exact_scan", lambda *a: True)
        del kw["filter"]  # a filtered search prices its layout's searcher
    elif route == "VectorSearchSegmentsSkipped":
        # segment 1 (1,000 rows, no index) is no longer small
        t.settings.table.min_rows_to_build_vector_index = 500
        t.settings.query.enable_brute_force_vector_search = False
    return db, t, q, kw


@pytest.mark.parametrize("route", ["VectorIndexSearches", "IvfFilterLayoutHits",
                                   "VectorIndexFallbackToFlat", "VectorIndexCostRouteToScan",
                                   "VectorSearchSegmentsSkipped"])
def test_a_hit_moves_the_route_counters_as_planning_does(route, monkeypatch):
    """A repeated search planned in full (its plan dropped) and the same
    search run from the kept plan move every route counter alike."""
    db, t, q, kw = _route_case(route, monkeypatch)
    t.search("vec", q[:NQ], **kw)  # builds what a first search builds (a layout)
    t._programs.invalidate()
    _, planned = _counts(lambda: t.search("vec", q[:NQ], **kw))
    _, hit = _counts(lambda: t.search("vec", q[:NQ], **kw))
    assert planned.get("SearchPlanMisses") == 1 and hit.get("SearchPlanHits") == 1
    assert planned.get(route, 0) > 0
    assert {r: planned.get(r, 0) for r in ROUTES} == {r: hit.get(r, 0) for r in ROUTES}
    db.close()


def test_a_cost_route_is_priced_for_the_actual_batch(monkeypatch):
    """The key holds the padded batch; the cost model prices the actual
    one. A kept plan whose route the actual batch would change plans
    afresh."""
    db, t, q = _table("MSTG")
    idx = t.loaded_index(0, "vec", Metric.L2)
    monkeypatch.setattr(type(idx), "prefer_exact_scan", lambda self, nq, *a: nq > 5)
    t.search("vec", q[:5], K, params=P)
    _, moved = _counts(lambda: t.search("vec", q[:5], K, params=P))
    assert moved.get("SearchPlanHits") == 1 and "VectorIndexCostRouteToScan" not in moved
    got, moved = _counts(lambda: t.search("vec", q[:6], K, params=P))  # the same 8-row bucket
    assert moved.get("SearchPlanMisses") == 1 and moved["VectorIndexCostRouteToScan"] == 1
    _same(got, _cold(t, "vec", q[:6], K, params=P))
    db.close()


def test_a_hit_touches_the_index_cache(tables):
    """A hit refreshes the loaded index's recency, as `loaded_index` does:
    a hot index does not look idle to the cache."""
    _, t, q = tables["IVFFLAT"]
    cache = t._index_cache
    t.search("vec", q[:NQ], K, params=P)
    key, = [k for k in cache._items if k[0] == t.name and k[2] == 0]
    cache.put(("another",), object(), 1)
    assert next(reversed(cache._items)) != key
    hits = cache.hits
    _, moved = _counts(lambda: t.search("vec", q[:NQ], K, params=P))
    assert moved.get("SearchPlanHits") == 1
    assert next(reversed(cache._items)) == key and cache.hits == hits + 1
    cache.force_expire(("another",))


def test_plans_go_with_their_program():
    """A plan lives in the table's program cache beside the program it
    runs: evicting the program drops the plan, and the one drop drops
    both."""
    db, t, q = _table("exact")
    t._programs.cap = 2
    for k in (3, 4):
        t.search("vec", q[:NQ], k)
    assert len(t._programs._plans) == 2
    t.search("vec", q[:NQ], 5)  # evicts k 3's program, and its plan
    assert len(t._programs) == 2 and len(t._programs._plans) == 2
    _, moved = _counts(lambda: t.search("vec", q[:NQ], 3))
    assert moved.get("SearchPlanMisses") == 1 and moved.get("SearchProgramCaptures") == 1
    t._segments_changed()
    assert len(t._programs) == 0 and len(t._programs._plans) == 0
    db.close()
