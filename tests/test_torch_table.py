"""The rest of Table and Database: the port (myscaledb_tpu_torch, on the
CPU) against the JAX package on the same seeded inputs.

UPDATE and ADD / DROP COLUMN with their guards, merge (deletes and an
UPDATE that land mid-copy, the decoupled window over the sources'
indexes, the rebuild), truncate, the versioned engines under FINAL and
their merges, compute_distances, the system tables and the
full_text_search table function. Hit ids must be equal (continuous random
data, free of ties); distances agree within the reference's f32
tolerance, rtol 2e-4 / atol 2e-3 (tests/test_distance_ops.py:37).
"""

import threading

import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.index.decoupled import DecoupledIndex as JDecoupled
from myscaledb_tpu_torch.index.base import IndexStatus
from myscaledb_tpu_torch.index.decoupled import DecoupledIndex

DIM, N, NQ, K = 16, 2048, 8, 10
TOL = dict(rtol=2e-4, atol=2e-3)
BOTH = [jms, tms]


def _connect(ms, settings=None, **kw):
    return ms.connect(settings, **kw) if ms is jms else ms.connect(settings, device="cpu", **kw)


def _data(seed=20261017, n=2 * N):
    rng = np.random.default_rng(seed)
    vec = rng.standard_normal((n, DIM)).astype(np.float32)
    q = (vec[rng.choice(n, NQ, replace=False)] + 0.3 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    words = np.array([f"w{i}" for i in range(40)])
    body = np.array([" ".join(rng.choice(words, 6)) for _ in range(n)], dtype=object)
    cols = {
        "id": np.arange(n, dtype=np.uint64),
        "tag": rng.integers(0, 10, n).astype(np.int32),
        "price": rng.random(n).astype(np.float32),
        "body": body,
        "vec": vec,
    }
    return cols, q


SCHEMA = dict(id="UInt64", tag="Int32", price="Float32", body="String")


def _schema(ms):
    cols = {c: getattr(ms, t)() for c, t in SCHEMA.items()}
    return ms.Schema({**cols, "vec": ms.FloatVector(DIM)})


def _table(ms, settings=None, parts=2, fts=True, name="t"):
    cols, q = _data()
    db = _connect(ms, settings)
    t = db.create_table(name, _schema(ms))
    if fts:
        t.add_fts_index("ft", "body")
    n = len(cols["id"]) // parts
    for i in range(parts):
        t.insert({c: v[i * n:(i + 1) * n] for c, v in cols.items()})
    return db, t, cols, q


def _same(jres, tres):
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    np.testing.assert_allclose(tres.distances, jres.distances, **TOL)


def _all_rows(t, columns):
    """Every live row's columns, sorted by id (the table's logical content)."""
    out = {c: [] for c in columns}
    for seg in t.live_segments():
        alive = np.nonzero(~seg.deleted_host()[: seg.n_rows])[0]
        for c in columns:
            out[c].append(seg.scalar(c)[alive])
    out = {c: np.concatenate(v) for c, v in out.items()}
    order = np.argsort(out["id"], kind="stable")
    return {c: v[order] for c, v in out.items()}


class _GatedScheduler:
    """Holds jobs until released: the decoupled window stays observable."""

    def __init__(self):
        self.jobs = []

    def submit(self, job, slow=False):
        self.jobs.append(job)

    def release(self):
        jobs, self.jobs = self.jobs, []
        for j in jobs:
            j()


# ------------------------------------------------------ mutations and ALTER
def test_update_add_drop_column_match_jax():
    out = []
    for ms in BOTH:
        db, t, cols, q = _table(ms)
        F = ms.F
        steps = []
        assert t.update(F("id") < 100, {"price": 99.0}) == 100
        n3 = int((cols["tag"] == 3).sum())  # before: the table may share the inserted arrays
        assert t.update(F("tag") == 3, {"tag": lambda v: v + 10}) == n3
        assert t.delete(F("id") == 7) == 1
        assert t.update(F("id") < 10, {"price": 1.0}) == 9  # the deleted row is not updated
        t.add_column("score", ms.Float64(), 1.5)
        t.add_column("label", ms.String(), "none")
        assert t.update(F("tag") >= 10, {"score": 7.0, "label": "hot"}) > 0
        for flt in (F("price") > 98.0, F("tag") >= 10, F("score") > 2.0, F("label") == "hot"):
            res = t.search("vec", q, k=K, filter=flt)
            steps.append((res, t.gather(res, ["id", "tag", "price", "score", "label"])))
        t.drop_column("label")
        assert "label" not in t.schema.columns
        steps.append((None, _all_rows(t, ["id", "tag", "price", "score"])))
        out.append((t, steps, t.n_rows))
    (jt, jsteps, jn), (tt, tsteps, tn) = out
    assert tn == jn == 2 * N - 1
    for (jres, jg), (tres, tg) in zip(jsteps, tsteps):
        if jres is not None:
            _same(jres, tres)
            assert tres.valid.all()
        for c in jg:
            np.testing.assert_array_equal(tg[c], jg[c])


@pytest.mark.parametrize("op", ["update vector", "add existing", "add vector", "drop vector",
                                "drop missing", "drop fts column", "bad name"])
def test_alter_guards_raise_like_jax(op):
    for ms in BOTH:
        db, t, _, _ = _table(ms, parts=1)
        act = {
            "update vector": lambda: t.update(ms.F("id") == 0, {"vec": np.zeros(DIM)}),
            "add existing": lambda: t.add_column("tag", ms.Int32()),
            "add vector": lambda: t.add_column("v2", ms.FloatVector(4)),
            "drop vector": lambda: t.drop_column("vec"),
            "drop missing": lambda: t.drop_column("nope"),
            "drop fts column": lambda: t.drop_column("body"),
            "bad name": lambda: t.add_column("a b", ms.Int32()),
        }[op]
        with pytest.raises(ms.SchemaError):
            act()


def test_update_rebuilds_fts_and_keeps_the_index():
    for ms in BOTH:
        st = ms.Settings()
        st.table.min_rows_to_build_vector_index = 100
        db = _connect(ms, st)
        t = db.create_table("m", ms.Schema({"id": ms.UInt64(), "body": ms.String(),
                                            "vec": ms.FloatVector(4)}))
        t.add_fts_index("ft", "body")
        vecs = np.random.default_rng(3).standard_normal((300, 4)).astype(np.float32)
        t.insert({"id": np.arange(300, dtype=np.uint64),
                  "body": np.array(["old words"] + ["other text"] * 299, dtype=object),
                  "vec": vecs})
        t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=4)
        assert t.wait_index_built()
        inst = t._slots[(0, "i")].instance
        assert t.text_search("body", "old", k=3).valid[0].any()
        assert t.update(ms.F("id") == 0, {"body": "fresh content"}) == 1
        assert not t.text_search("body", "old", k=3).valid[0].any()
        res = t.text_search("body", "fresh", k=3)
        assert int(t.gather(res, ["id"])["id"][0, 0]) == 0
        assert t._slots[(0, "i")].instance is inst  # inherited, not rebuilt
        res = t.search("vec", vecs[5], k=1, params={"nprobe": 4})
        assert int(t.gather(res, ["id"])["id"][0, 0]) == 5
        db.close()


# --------------------------------------------------------------------- merge
def test_merge_with_deletes_and_a_mid_copy_update_matches_jax():
    """A DELETE and an UPDATE that land while the merge copies (between its
    snapshot and its swap) are re-applied to the merged segment."""
    out = []
    for ms in BOTH:
        db, t, cols, q = _table(ms, parts=3)
        F = ms.F
        assert t.delete(ms.Lambda(["id"], lambda v: v % 97 == 1)) == 43
        tdef = t._text_indexes["ft"]
        orig = tdef.on_new_segment
        fired = []

        def hook(seg, *a, **kw):  # runs after the copy, before the swap
            if not fired:
                fired.append(1)
                t.delete(F("id") == 500)
                t.update(F("id") < 50, {"price": -1.0, "body": "midcopy marker"})
            return orig(seg, *a, **kw)

        tdef.on_new_segment = hook
        new_id = t.merge()
        assert fired and [s.segment_id for s in t.live_segments()] == [new_id]
        res = t.search("vec", q, k=K)
        text = t.text_search("body", "marker", k=100)
        out.append((t, res, _all_rows(t, ["id", "tag", "price", "body"]), text))
    (jt, jres, jrows, jtext), (tt, tres, trows, ttext) = out
    assert tt.n_rows == jt.n_rows
    for c in jrows:
        np.testing.assert_array_equal(trows[c], jrows[c])
    assert 500 not in trows["id"] and (trows["price"][trows["id"] < 50] == -1.0).all()
    _same(jres, tres)
    np.testing.assert_array_equal(ttext.rows, jtext.rows)
    assert ttext.valid.sum() == int((trows["id"] < 50).sum())


def _gated_pair():
    """JAX and port tables (two parts of N rows, 10 deletes) whose IVFFLAT
    indexes are identical: built by JAX, carried across with load_index.
    The port's own builds wait behind a gate and never run."""
    tables = []
    for ms in BOTH:
        st = ms.Settings()
        st.table.min_rows_to_build_vector_index = 100
        st.table.storage_dtype = "float32"
        db = _connect(ms, st)
        t = db.create_table("dec", _schema(ms))
        if ms is tms:
            t._scheduler = _GatedScheduler()
        cols, q = _data()
        for p in (slice(0, N), slice(N, 2 * N)):
            t.insert({c: v[p] for c, v in cols.items()})
        t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=16)
        if ms is jms:
            assert t.wait_index_built()
        tables.append((db, t))
    (jdb, jt), (tdb, tt) = tables
    for sid in (0, 1):
        tt.load_index("i", sid, jt._slots[(sid, "i")].instance.state_dict())
    assert tt.index_status("i") == {0: IndexStatus.LOADED, 1: IndexStatus.LOADED}
    for t, F in ((jt, jms.F), (tt, tms.F)):
        assert t.delete(F("id") < 10) == 10
    return jt, tt, cols, q


def test_decoupled_window_and_rebuild_match_jax():
    jt, tt, cols, q = _gated_pair()
    gates = [_GatedScheduler(), tt._scheduler]
    jt._scheduler = gates[0]
    jid, tid = jt.merge(), tt.merge()
    assert jid == tid
    assert isinstance(jt._slots[(jid, "i")].instance, JDecoupled)
    slot = tt._slots[(tid, "i")]
    assert slot.status == IndexStatus.PENDING and isinstance(slot.instance, DecoupledIndex)
    assert all(m.dtype == torch.int32 and m.device == tt.device for m in slot.instance.row_maps)
    probes = np.concatenate([q, cols["vec"][[3, 1500, N + 7]]])
    for params in ({"nprobe": 4}, {"nprobe": 16}):
        for flt in (None, lambda ms: ms.F("tag") >= 5):
            jres = jt.search("vec", probes, k=K, params=params,
                             **({} if flt is None else {"filter": flt(jms)}))
            tres = tt.search("vec", probes, k=K, params=params,
                             **({} if flt is None else {"filter": flt(tms)}))
            _same(jres, tres)
            ids = tt.gather(tres, ["id", "tag"])
            assert (ids["id"][tres.valid] >= 10).all()
            if flt is not None:
                assert (ids["tag"][tres.valid] >= 5).all()
    # the rebuild: the slot upgrades to a real index; at nprobe = all
    # clusters IVFFLAT is exact, so both packages agree again
    for g in gates:
        g.release()
    assert jt.wait_index_built() and tt.wait_index_built()
    slot = tt._slots[(tid, "i")]
    assert slot.status == IndexStatus.LOADED and not isinstance(slot.instance, DecoupledIndex)
    _same(jt.search("vec", probes, k=K, params={"nprobe": 16}),
          tt.search("vec", probes, k=K, params={"nprobe": 16}))
    assert tt.n_rows == jt.n_rows == 2 * N - 10


def test_merge_without_decouple_builds_directly():
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 100
    st.table.enable_decouple_vector_index = False
    db = _connect(tms, st)
    t = db.create_table("nodec", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(8)}))
    v = np.random.default_rng(5).standard_normal((1000, 8)).astype(np.float32)
    t.insert({"id": np.arange(500, dtype=np.uint64), "vec": v[:500]})
    t.insert({"id": np.arange(500, 1000, dtype=np.uint64), "vec": v[500:]})
    t.add_vector_index("i", "vec", type="FLAT")
    assert t.wait_index_built()
    new_id = t.merge()
    assert t.wait_index_built()
    assert t._slots[(new_id, "i")].status == IndexStatus.LOADED
    res = t.search("vec", v[700], k=1)
    assert int(t.gather(res, ["id"])["id"][0, 0]) == 700
    db.close()


def test_truncate_then_insert_builds_afresh():
    for ms in BOTH:
        st = ms.Settings()
        st.table.min_rows_to_build_vector_index = 100
        db = _connect(ms, st)
        t = db.create_table("tr", _schema(ms))
        t.add_fts_index("ft", "body")
        cols, q = _data()
        t.insert(cols)
        t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=8)
        assert t.wait_index_built()
        t.truncate()
        assert t.n_rows == 0 and t.live_segments() == []
        assert not t.search("vec", q, k=K).valid.any()
        assert not t.text_search("body", "w1", k=K).valid.any()
        assert not t._slots
        t.insert({c: v[:500] for c, v in cols.items()})
        assert t.wait_index_built()
        assert {k: s.status.value for k, s in t._slots.items()} == {(1, "i"): "Loaded"}
        res = t.search("vec", cols["vec"][42], k=1, params={"nprobe": 8})
        assert int(t.gather(res, ["id"])["id"][0, 0]) == 42
        db.close()


# ----------------------------------------------------------- versioned engines
def _versioned(ms, engine):
    """A table of `engine` over 400 keys: a first insert of every key, then
    a second insert that supersedes / cancels some of them."""
    rng = np.random.default_rng(11)
    cols = {"id": ms.UInt64(), "ver": ms.UInt64(), "sign": ms.Int32(), "doc": ms.String(),
            "vec": ms.FloatVector(DIM)}
    kw = dict(key_column="id")
    if engine in ("ReplacingMergeTree", "VersionedCollapsingMergeTree"):
        kw["version_column"] = "ver"
    if "Collapsing" in engine:
        kw["sign_column"] = "sign"
    db = _connect(ms)
    t = db.create_table("v", ms.Schema(cols), engine=engine, **kw)
    t.add_fts_index("ft", "doc")
    n = 400
    v1 = rng.standard_normal((n, DIM)).astype(np.float32)
    t.insert({"id": np.arange(n, dtype=np.uint64), "ver": np.ones(n, np.uint64),
              "sign": np.ones(n, np.int32), "doc": np.array(["alpha"] * n, dtype=object),
              "vec": v1})
    m = 120
    keys = np.arange(0, 2 * m, 2, dtype=np.uint64)
    v2 = rng.standard_normal((m, DIM)).astype(np.float32)
    second = {"id": keys, "ver": np.full(m, 2, np.uint64), "doc": np.array(["beta"] * m, dtype=object),
              "vec": v2}
    if "Collapsing" in engine:
        # cancel rows (same vector, sign -1); VersionedCollapsing cancels
        # version 1 and the last 20 also get a new state at version 2
        second["sign"] = np.full(m, -1, np.int32)
        second["ver"] = np.ones(m, np.uint64)
        second["vec"] = v1[keys.astype(np.int64)]
        t.insert(second)
        third = {"id": keys[-20:], "ver": np.full(20, 2, np.uint64), "sign": np.ones(20, np.int32),
                 "doc": np.array(["gamma"] * 20, dtype=object), "vec": v2[-20:]}
        t.insert(third)
    else:
        second["sign"] = np.ones(m, np.int32)
        t.insert(second)
    q = np.concatenate([v1[keys[:4].astype(np.int64)], v2[:4]])
    return db, t, q


ENGINES = ["ReplacingMergeTree", "CollapsingMergeTree", "VersionedCollapsingMergeTree",
           "ReplicatedReplacingMergeTree"]


@pytest.mark.parametrize("engine", ENGINES)
def test_final_search_and_merge_match_jax(engine):
    out = []
    for ms in BOTH:
        db, t, q = _versioned(ms, engine)
        got = [sorted(t._final_survivors())]
        res = t.search("vec", q, k=K, final=True)
        text = t.text_search("doc", "alpha", k=60, final=True)
        n_before = t.n_rows
        t.merge()
        after = t.search("vec", q, k=K, final=True)
        plain = t.search("vec", q, k=K)
        got.append(_all_rows(t, ["id", "ver", "sign"]))
        out.append((t, got, res, text, after, plain, n_before))
    (jt, jgot, *jr), (tt, tgot, *tr) = out
    assert tt.engine == jt.engine
    assert tgot[0] == jgot[0]
    for c in jgot[1]:
        np.testing.assert_array_equal(tgot[1][c], jgot[1][c])
    for jx, tx in zip(jr[:-1], tr[:-1]):
        np.testing.assert_array_equal(tx.segments, jx.segments)
        np.testing.assert_array_equal(tx.rows, jx.rows)
        np.testing.assert_allclose(tx.scores, jx.scores, **TOL)
    assert tr[-1] == jr[-1] and tt.n_rows == jt.n_rows
    # after the merge every row is a winner: FINAL and a plain search agree
    np.testing.assert_array_equal(tr[2].rows, tr[3].rows)


def test_final_rules_and_errors_like_jax():
    for ms in BOTH:
        db = _connect(ms)
        with pytest.raises(ms.SchemaError):
            db.create_table("bad", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(4)}),
                            engine="CollapsingMergeTree", key_column="id")
        with pytest.raises(ms.SchemaError):
            db.create_table("bad2", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(4)}),
                            engine="SummingMergeTree", key_column="id")
        t = db.create_table("plain", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(4)}))
        t.insert({"id": np.arange(10, dtype=np.uint64), "vec": np.eye(10, 4, dtype=np.float32)})
        with pytest.raises(ms.SchemaError):
            t.search("vec", np.zeros(4, np.float32), k=2, final=True)
        db2, vt, _ = _versioned(ms, "VersionedCollapsingMergeTree")
        with pytest.raises(ms.SchemaError):
            vt.drop_column("sign")  # an engine column
        # #cancel > #state keeps the first cancel row (ClickHouse's rule)
        ct = db.create_table("ct", ms.Schema({"id": ms.UInt64(), "sign": ms.Int32(),
                                              "vec": ms.FloatVector(4)}),
                             engine="CollapsingMergeTree", key_column="id", sign_column="sign")
        ct.insert({"id": np.arange(4, dtype=np.uint64), "sign": np.ones(4, np.int32),
                   "vec": np.eye(4, dtype=np.float32)})
        ct.insert({"id": np.zeros(2, np.uint64), "sign": np.full(2, -1, np.int32),
                   "vec": np.eye(2, 4, dtype=np.float32)})
        assert (1, 0) in ct._final_survivors() and (0, 0) not in ct._final_survivors()


# ---------------------------------------------------------- compute_distances
@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_compute_distances_match_jax(metric):
    out = []
    for ms in BOTH:
        db, t, cols, q = _table(ms, fts=False)
        res = t.search("vec", q, k=K, metric=metric)
        m = ms.Metric(metric)
        out.append((t.compute_distances("vec", q, res, metric=m), res))
        one = t.compute_distances("vec", q[0], res, metric=m)  # one query, every row
        assert one.shape == res.rows.shape
    (jd, jres), (td, tres) = out
    np.testing.assert_array_equal(tres.rows, jres.rows)
    np.testing.assert_allclose(td, jd, **TOL)
    np.testing.assert_allclose(td, tres.distances, **TOL)


# ------------------------------------------------------------ introspection
_TIMING = ("elapsed", "memory_usage_bytes")


def test_system_tables_match_jax():
    out = []
    for ms in BOTH:
        st = ms.Settings()
        st.table.min_rows_to_build_vector_index = 1500
        db = _connect(ms, st)
        t = db.create_table("s", _schema(ms))
        t.add_fts_index("ft", "body")
        cols, q = _data()
        t.insert({c: v[:2000] for c, v in cols.items()})
        t.insert({c: v[2000:2100] for c, v in cols.items()})  # a small part
        t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=8)
        assert t.wait_index_built()
        t.search("vec", q, k=K)
        rows = {
            "vector_indices": db.system_table("vector_indices"),
            "vector_index_segments": [
                {c: v for c, v in r.items() if c not in _TIMING}
                for r in db.system_table("vector_index_segments")
            ],
            "tables": db.system_table("tables"),
            "parts": db.system_table("parts"),
            # the scheduler's thread and the caller record events in either order
            "events": sorted((e["table"], e["index_name"], e["segment_id"] or -1, e["event"])
                             for e in db.system_table("vector_index_event_log")),
            "fts": db.full_text_search("s", "ft", "w1 w2", k=20),
        }
        assert t.peek_index(0, "vec", t.index_metric_for("vec")) is t._slots[(0, "i")].instance
        assert t.peek_index(1, "vec", t.index_metric_for("vec")) is None
        assert any(r["table"] == "s" and r["kind"] == "vector_search"
                   for r in db.system_table("query_log"))
        assert {r["event"] for r in db.system_table("profile_events")} >= {"VectorIndexBuilds"}
        assert isinstance(db.system_table("span_log"), list)
        with pytest.raises(ms.SchemaError):
            db.system_table("nope")
        out.append(rows)
        db.close()
    jrows, trows = out
    assert trows["vector_indices"][0]["status"] == "Built"
    for kind in ("vector_indices", "vector_index_segments", "tables", "parts", "events"):
        assert trows[kind] == jrows[kind], kind
    assert [r["id"] for r in trows["fts"]] == [r["id"] for r in jrows["fts"]]
    np.testing.assert_allclose([r["bm25_score"] for r in trows["fts"]],
                               [r["bm25_score"] for r in jrows["fts"]], rtol=1e-6)
    assert all(set(r) == {"id", "tag", "price", "body", "bm25_score"} for r in trows["fts"])


def test_concurrent_searches_during_background_builds():
    """Builds on the scheduler's thread while the caller searches: every
    search answers (exact scan until a segment's index lands), no build
    fails, and the launch counters stay consistent."""
    import sys

    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 100
    db = _connect(tms, st)
    t = db.create_table("c", _schema(tms))
    cols, q = _data()
    t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        errors = []

        def searcher():
            try:
                for _ in range(20):
                    r = t.search("vec", q, k=K, params={"nprobe": 8})
                    assert r.valid.all()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        for i in range(4):
            t.insert({c: v[i * 1024:(i + 1) * 1024] for c, v in cols.items()})
        th = threading.Thread(target=searcher)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive() and not errors
    finally:
        sys.setswitchinterval(old)
    assert t.wait_index_built(60)
    assert set(t.index_status("i").values()) == {IndexStatus.LOADED}
    assert not [e for e in t.event_log.rows() if e["event"] == "BuildError"]
    db.close()
