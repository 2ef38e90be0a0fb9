"""The exact-search slice end to end: the port (myscaledb_tpu_torch, on
the CPU) against the JAX package on the same data.

Two segments per table, as on the main path: 70,000 rows (capacity
81,920, the tile-max pruned route) and 20,000 rows (capacity 20,480, the
score-kernel route). Search, pre-filtered search, delete and gather run
in both packages with L2, IP and Cosine; hit ids must be equal (the data
are continuous random draws, free of ties) and distances agree to
rtol 2e-4 / atol 2e-3: both packages rescore in f32 from identical
stored bf16 values, so only the summation order differs.
"""

import numpy as np
import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms

DIM, N1, N2, NQ, K = 16, 70_000, 20_000, 16, 10
TOL = dict(rtol=2e-4, atol=2e-3)
METRICS = ["L2", "IP", "Cosine"]


def _columns():
    rng = np.random.default_rng(20261016)
    vec = rng.standard_normal((N1 + N2, DIM)).astype(np.float32)
    ids = np.arange(N1 + N2, dtype=np.uint64)
    tag = rng.integers(0, 10, N1 + N2).astype(np.int32)
    parts = [slice(0, N1), slice(N1, N1 + N2)]
    qidx = rng.choice(N1 + N2, NQ, replace=False)
    queries = (vec[qidx] + 0.3 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    return [{"id": ids[p], "tag": tag[p], "vec": vec[p]} for p in parts], queries


def _build(ms, **kw):
    cols, queries = _columns()
    db = ms.connect(**kw)
    t = db.create_table(
        "t", ms.Schema({"id": ms.UInt64(), "tag": ms.Int32(), "vec": ms.FloatVector(DIM)})
    )
    for c in cols:
        t.insert(c)
    return db, t, queries


@pytest.fixture(scope="module")
def tables():
    jdb, jt, queries = _build(jms)
    tdb, tt, _ = _build(tms, device="cpu")
    yield jt, tt, queries
    jdb.close()
    tdb.close()


def _same(jres, tres):
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    np.testing.assert_allclose(tres.scores, jres.scores, **TOL)
    np.testing.assert_allclose(tres.distances, jres.distances, **TOL)


def test_segments_take_both_routes(tables):
    _, tt, _ = tables
    assert [(s.n_rows, s.capacity) for s in tt.live_segments()] == [
        (N1, 81_920), (N2, 20_480)
    ]


@pytest.mark.parametrize("metric", METRICS)
def test_search_parity(tables, metric):
    jt, tt, queries = tables
    jres = jt.search("vec", queries, k=K, metric=metric)
    tres = tt.search("vec", queries, k=K, metric=metric)
    _same(jres, tres)
    assert set(tres.segments.ravel()) == {0, 1}  # both segments contribute
    one = tt.search("vec", queries[3], k=K, metric=metric)  # a single [D] query
    np.testing.assert_array_equal(one.rows[0], tres.rows[3])


@pytest.mark.parametrize("metric", METRICS)
def test_filtered_search_parity(tables, metric):
    jt, tt, queries = tables
    flt = lambda F: (F("id") < 80_000) & (F("tag") != 3)  # noqa: E731
    jres = jt.search("vec", queries, k=K, metric=metric, filter=flt(jms.F))
    tres = tt.search("vec", queries, k=K, metric=metric, filter=flt(tms.F))
    _same(jres, tres)
    got = tt.gather(tres, ["id", "tag"])
    assert (got["id"] < 80_000).all() and (got["tag"] != 3).all()


def test_host_filter_and_const_fold_parity(tables):
    jt, tt, queries = tables
    # a Lambda evaluates on the host; `id >= 70_000` folds segment 0 away
    for make in (lambda ms: ms.Lambda(["tag"], lambda t: t % 2 == 0),
                 lambda ms: ms.F("id") >= 70_000):
        jres = jt.search("vec", queries, k=K, filter=make(jms))
        tres = tt.search("vec", queries, k=K, filter=make(tms))
        _same(jres, tres)


def test_delete_and_gather_parity():
    jdb, jt, queries = _build(jms)
    tdb, tt, _ = _build(tms, device="cpu")
    nearest = {int(i) for i in tt.gather(tt.search("vec", queries, k=K), ["id"])["id"][:, 0]}
    assert tt.delete(tms.F("id").isin(sorted(nearest))) == len(nearest)
    assert jt.delete(jms.F("id").isin(sorted(nearest))) == len(nearest)
    assert tt.n_rows == jt.n_rows == N1 + N2 - len(nearest)
    for metric in METRICS:
        jres = jt.search("vec", queries, k=K, metric=metric)
        tres = tt.search("vec", queries, k=K, metric=metric)
        _same(jres, tres)
        jg = jt.gather(jres, ["id", "tag", "vec"])
        tg = tt.gather(tres, ["id", "tag", "vec"])
        np.testing.assert_array_equal(tg["id"], jg["id"])
        np.testing.assert_array_equal(tg["tag"], jg["tag"])
        np.testing.assert_array_equal(np.array(tg["vec"].tolist()), np.array(jg["vec"].tolist()))
        assert not set(tg["id"].ravel().tolist()) & nearest  # no deleted row comes back
    jdb.close()
    tdb.close()


def test_empty_and_k_beyond_rows():
    tdb = tms.connect(device="cpu")
    t = tdb.create_table("e", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(4)}))
    q = np.ones((2, 4), np.float32)
    r = t.search("vec", q, k=3)
    assert (r.rows == -1).all() and np.isinf(r.distances).all()
    t.insert({"id": np.arange(5, dtype=np.uint64), "vec": np.eye(5, 4, dtype=np.float32)})
    r = t.search("vec", q, k=8)
    assert (r.valid.sum(axis=1) == 5).all() and (r.rows[:, 5:] == -1).all()
    with pytest.raises(tms.QueryShapeError):
        t.search("vec", np.ones(3, np.float32), k=3)
    with pytest.raises(tms.QueryShapeError):
        t.search("vec", q, k=0)
    # the approximate top-k answers; at 5 rows (<= 4k) its branch is the
    # exact one, as in the JAX package
    st = tms.Settings()
    st.query.use_approx_topk = True
    ra, re = t.search("vec", q, k=3, settings=st), t.search("vec", q, k=3)
    np.testing.assert_array_equal(ra.rows, re.rows)
    np.testing.assert_array_equal(ra.distances, re.distances)
    # two-stage search over segments without a two-stage index is the
    # plain search
    r2 = t.search("vec", q, k=8, two_stage=True)
    np.testing.assert_array_equal(r2.rows, r.rows)
    np.testing.assert_array_equal(r2.distances, r.distances)


@pytest.mark.parametrize(
    "make",
    [lambda ms: ms.F("id") < 12_345, lambda ms: ms.F("tag").isin([1, 2]),
     lambda ms: ms.Lambda(["tag"], lambda t: t > 4), lambda ms: None],
    ids=["lt", "in", "lambda", "none"],
)
def test_estimate_selectivity_parity(tables, make):
    from myscaledb_tpu.search.executor import estimate_selectivity as jest

    from myscaledb_tpu_torch.search.executor import estimate_selectivity

    jt, tt, _ = tables
    for jseg, tseg in zip(jt.live_segments(), tt.live_segments()):
        assert estimate_selectivity(tseg, make(tms)) == jest(jseg, make(jms))


def test_payload_budget_reserves_and_releases():
    import gc

    from myscaledb_tpu_torch.storage.hbm import GOVERNOR

    cols = {"id": np.arange(10, dtype=np.uint64), "vec": np.ones((10, 8), np.float32)}
    need = 1024 * 128 * 2 + 1024 * 8  # bf16 [1024, 128] payload + two f32 norms
    schema = tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(8)})
    gc.collect()  # release payloads of earlier tests that are already unreachable
    st = tms.Settings()
    st.server.device_payload_budget_bytes = GOVERNOR.tracked_bytes + need - 1
    db = tms.connect(st, device="cpu")
    t = db.create_table("b", schema)
    before = GOVERNOR.tracked_bytes
    # one byte short: the payload spills to the host tier, reserving nothing
    t.insert(cols)
    assert GOVERNOR.tracked_bytes == before
    (seg,) = t.live_segments()
    assert seg.vector("vec").is_host and seg.spilled_columns == {"vec"}
    st.server.device_payload_budget_bytes = before + need
    t.insert(cols)
    assert GOVERNOR.tracked_bytes == before + need
    assert not t.live_segments()[1].vector("vec").is_host
    db.drop_table("b")
    del t
    gc.collect()
    assert GOVERNOR.tracked_bytes == before
