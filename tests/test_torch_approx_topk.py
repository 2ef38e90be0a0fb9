"""The approximate top-k (QuerySettings.use_approx_topk): the port
(myscaledb_tpu_torch, on the CPU) against XLA's rule and the JAX package.

`jax.lax.approx_max_k` folds each score row into L bins (element i into
bin i mod L, XLA's PartialReduce) and takes the exact top-k of the bin
winners. On the CPU the JAX package's branch is exact (XLA's fallback
sorts the row), so the port is held to JAX by recall: over >= 1,000
query rows its ids reach recall_target - 0.02 of JAX's, and every score
it returns is that row's own score, within the reference tolerance
(rtol 2e-4, atol 2e-3) of JAX's score for that row. Where the branch is
exact (L >= N, k >= N, a FLAT segment of <= 4k rows) the ids equal
JAX's. L itself is held to XLA's own shape rule, and the plain partial
reduce to a numpy fold, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.ops import binary as jbin
from myscaledb_tpu.ops import bruteforce as jbf
from myscaledb_tpu.ops import distance as jdist
from myscaledb_tpu.parallel import distributed as jpar
from myscaledb_tpu.text import inverted as jinv
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import binary as tbin
from myscaledb_tpu_torch.ops import bruteforce as tbf
from myscaledb_tpu_torch.ops import topk
from myscaledb_tpu_torch.parallel import distributed as tpar
from myscaledb_tpu_torch.storage.convert import inverted_from_state_dict

TOL = dict(rtol=2e-4, atol=2e-3)
K = 10
DIM, N1, N2, NQ = 16, 20_000, 12_000, 1_000
METRICS = ["L2", "IP", "Cosine"]
ORACLE_N = [1_000, 5_000, 50_176, 65_536, 114_688, 131_072, 1_048_576]
ORACLE_K = [1, 10, 100]
ORACLE_R = [0.5, 0.9, 0.95, 0.99, 0.999, 1.0]


def _xla_l(n, k, r):
    """XLA's L: the last dim of approx_max_k without aggregation."""
    out = jax.eval_shape(
        lambda x: jax.lax.approx_max_k(x, k, recall_target=r, aggregate_to_topk=False),
        jax.ShapeDtypeStruct((2, n), jnp.float32),
    )
    return out[0].shape[-1]


def _numpy_fold(x, L):
    """The PartialReduce in numpy: pad with -inf to a multiple of L,
    reshape [Q, N / L, L], each bin's max and its first position."""
    q, n = x.shape
    f = -(-n // L)
    xp = np.full((q, f * L), -np.inf, np.float32)
    xp[:, :n] = x
    r = xp.reshape(q, f, L)
    m = r.max(axis=1)
    j = (r == m[:, None, :]).argmax(axis=1)
    return m, (j * L + np.arange(L)).astype(np.int32)


def _recall(got, want):
    return sum(len(set(g.tolist()) & set(w.tolist())) for g, w in zip(got, want)) / want.size


# ------------------------------------------------------------- the rule
@pytest.mark.parametrize("k", ORACLE_K)
@pytest.mark.parametrize("n", ORACLE_N)
def test_reduction_output_size_is_xlas(n, k):
    for r in ORACLE_R:
        assert topk.approx_reduction_output_size(n, k, r) == _xla_l(n, k, r), (n, k, r)


def test_reduction_output_size_probes_and_errors():
    probes = {(1_000, 10, 0.9): 256, (50_176, 10, 0.99): 1_664, (114_688, 10, 0.99): 896,
              (131_072, 10, 0.9): 128, (131_072, 10, 0.99): 1_024, (1_048_576, 10, 0.99): 1_024}
    for (n, k, r), want in probes.items():
        assert topk.approx_reduction_output_size(n, k, r) == want
    # a 1-D operand tiles by 1,024, as XLA's rule does
    for n, k, r in ((5_000, 10, 0.9), (50_176, 1, 0.9), (1_000, 10, 0.5), (131_072, 10, 0.99)):
        want = jax.eval_shape(
            lambda x: jax.lax.approx_max_k(x, k, recall_target=r, aggregate_to_topk=False),
            jax.ShapeDtypeStruct((n,), jnp.float32))[0].shape[-1]
        assert topk.approx_reduction_output_size(n, k, r, rank=1) == want, (n, k, r)
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError):
            topk.approx_reduction_output_size(1_000, 10, bad)


# ------------------------------------------------------ the partial reduce
@pytest.mark.parametrize("q,n,L,masked", [
    (5, 1_000, 256, False), (7, 1_000, 256, True), (3, 5_000, 384, True),
    (4, 4_099, 128, False), (2, 131, 128, True), (6, 640, 640, False), (1, 9, 1, False),
])
def test_plain_bin_max_equals_numpy_fold(q, n, L, masked):
    rng = np.random.default_rng(n + L)
    x = rng.standard_normal((q, n)).astype(np.float32)
    x[:, rng.random(n) < 0.2] = x[:, :1]  # exact ties inside bins
    if masked:
        x[0] = -np.inf  # a fully masked row
        x[1:, rng.random(n) < 0.7] = -np.inf
    v, i = topk.approx_bin_max_plain(torch.from_numpy(x), L)
    mv, mi = _numpy_fold(x, L)
    np.testing.assert_array_equal(v.numpy(), mv)
    np.testing.assert_array_equal(i.numpy(), mi)
    # the wrapper takes the plain version for a CPU tensor, and reads a
    # column slice of a wider matrix in place
    wide = torch.from_numpy(np.concatenate([x, x[:, :7]], axis=1))
    wv, wi = topk.approx_bin_max(wide[:, :n], L)
    np.testing.assert_array_equal(wv.numpy(), mv)
    np.testing.assert_array_equal(wi.numpy(), mi)


@pytest.mark.parametrize("n,k,r", [(20_480, 10, 0.9), (50_176, 100, 0.95), (4_099, 5, 0.5)])
def test_approx_topk_returns_bin_winners_with_their_scores(n, k, r):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((64, n)).astype(np.float32)
    L = topk.approx_reduction_output_size(n, k, r)
    assert L < n
    v, i = topk.topk_scores(torch.from_numpy(x), k, approx=True, recall_target=r)
    v, i = v.numpy(), i.numpy()
    for row in range(x.shape[0]):
        assert len(set(i[row].tolist())) == k  # distinct
        np.testing.assert_array_equal(v[row], x[row, i[row]])  # the rows' own scores
        assert (np.diff(v[row]) <= 0).all()  # sorted descending
        for b, s in zip(i[row] % L, v[row]):
            assert s == x[row, b::L].max()  # each its bin's max
    # the stable variant returns the same set, ties by lower row
    sv, si = topk.topk_stable(torch.from_numpy(x), k, approx=True, recall_target=r)
    np.testing.assert_array_equal(sv.numpy(), v)
    np.testing.assert_array_equal(np.sort(si.numpy(), 1), np.sort(i, 1))


def test_stable_approx_orders_tied_winners_by_row():
    # bins 0..3 of L = 128 hold equal winners at rows 3, 2 + 128, 1 + 256, 0:
    # the stable branch returns them by row, the winners' bins aside
    x = np.full((1, 1_024), -1.0, np.float32)
    for row in (3, 130, 257, 0):
        x[0, row] = 5.0
    L = topk.approx_reduction_output_size(1_024, 2, 0.5)
    assert L == 128
    v, i = topk.topk_stable(torch.from_numpy(x), 3, approx=True, recall_target=0.5)
    assert i.tolist() == [[0, 3, 130]] and v.tolist() == [[5.0, 5.0, 5.0]]


def test_clustered_insert_order_keeps_recall():
    """Rows inserted in cluster order: a query's neighbours sit in one
    contiguous run. The strided bins spread the run over every bin, so
    recall holds the target; contiguous windows of the same count would
    put the run in a few bins (the control)."""
    rng = np.random.default_rng(3)
    n_clusters, per, r = 64, 320, 0.9
    centers = 8.0 * rng.standard_normal((n_clusters, DIM)).astype(np.float32)
    x = np.repeat(centers, per, axis=0) + rng.standard_normal((n_clusters * per, DIM)).astype(
        np.float32)
    q = (x[rng.choice(len(x), NQ, replace=False)]
         + 0.3 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    db = tms.connect(device="cpu")
    t = db.create_table("c", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(DIM)}))
    t.insert({"id": np.arange(len(x), dtype=np.uint64), "vec": x})
    st = tms.Settings()
    st.query.use_approx_topk, st.query.approx_topk_recall_target = True, r
    exact = t.search("vec", q, k=K)
    approx = t.search("vec", q, k=K, settings=st)
    rec = _recall(approx.rows, exact.rows)
    assert r <= rec < 1.0, rec
    # control: the same number of bins as contiguous windows (numpy f32
    # scores of the inserted rows)
    cap = t.live_segments()[0].capacity
    L = topk.approx_reduction_output_size(cap, K, r)
    s = np.full((NQ, cap), -np.inf, np.float32)
    s[:, : len(x)] = 2.0 * q @ x.T - (x * x).sum(1)[None, :]
    w = cap // L
    best = s[:, : w * L].reshape(NQ, L, w).argmax(axis=2) + np.arange(L)[None, :] * w
    vals = np.take_along_axis(s, best, 1)
    control = np.take_along_axis(best, np.argsort(-vals, 1)[:, :K], 1)
    assert _recall(control, exact.rows) < r - 0.2
    db.close()


# --------------------------------------------------- where it is exact
def test_exact_where_bins_cover_the_row(monkeypatch):
    """L >= N, k >= N and a FLAT segment of <= 4k rows take the exact
    branch: no partial reduce runs, and the ids are the JAX package's."""
    def refuse(*a, **kw):
        raise AssertionError("the partial reduce ran where the branch is exact")

    monkeypatch.setattr(topk, "approx_bin_max", refuse)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5_000, DIM)).astype(np.float32)
    q = rng.standard_normal((40, DIM)).astype(np.float32)
    aux = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    for r in (0.999, 1.0):  # L = N at n 5,000, k 10
        assert topk.approx_reduction_output_size(5_000, K, r) == 5_000
        tv, ti = tbf.scan_topk_t(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(aux),
                                 k=K, metric=Metric.L2, n_valid=5_000, approx=True,
                                 recall_target=r)
        jv, ji = jbf.scan_topk_t(jnp.asarray(q), jnp.asarray(x), jnp.asarray(aux), k=K,
                                 metric=JMetric.L2, n_valid=5_000, approx=True, recall_target=r)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    s = rng.standard_normal((3, 12)).astype(np.float32)  # k >= N
    tv, ti = topk.topk_scores(torch.from_numpy(s), 15, approx=True, recall_target=0.5)
    jv, ji = jax.lax.top_k(jnp.asarray(s), 12)
    np.testing.assert_array_equal(ti.numpy()[:, :12], np.asarray(ji))
    assert (ti.numpy()[:, 12:] == -1).all() and np.isneginf(tv.numpy()[:, 12:]).all()
    # 30 rows <= 4k = 40: the FLAT index's branch is exact
    small = {"id": np.arange(30, dtype=np.uint64), "vec": x[:30]}
    out = []
    for ms, kw in ((jms, {}), (tms, {"device": "cpu"})):
        st = ms.Settings()
        st.query.use_approx_topk, st.query.approx_topk_recall_target = True, 0.5
        db = ms.connect(st, **kw)
        t = db.create_table("s", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(DIM)}))
        t.insert(small)
        out.append(t.search("vec", q, k=K).rows)
        db.close()
    np.testing.assert_array_equal(out[1], out[0])


# ------------------------------------------------- parity with the JAX package
def _columns():
    rng = np.random.default_rng(20261017)
    vec = rng.standard_normal((N1 + N2, DIM)).astype(np.float32)
    tag = rng.integers(0, 10, N1 + N2).astype(np.int32)
    ids = np.arange(N1 + N2, dtype=np.uint64)
    queries = (vec[rng.choice(N1 + N2, NQ, replace=False)]
               + 0.3 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    parts = [slice(0, N1), slice(N1, N1 + N2)]
    return [{"id": ids[p], "tag": tag[p], "vec": vec[p]} for p in parts], queries


def _table(ms, settings=None, index=False, **kw):
    cols, queries = _columns()
    st = settings or ms.Settings()
    if index:
        st.table.min_rows_to_build_vector_index = 1_000
    db = ms.connect(st, **kw)
    t = db.create_table(
        "t", ms.Schema({"id": ms.UInt64(), "tag": ms.Int32(), "vec": ms.FloatVector(DIM)})
    )
    for c in cols:
        t.insert(c)
    return db, t, queries


def _approx_settings(ms, r):
    st = ms.Settings()
    st.query.use_approx_topk, st.query.approx_topk_recall_target = True, r
    return st


@pytest.fixture(scope="module")
def dbs():
    jdb, jt, queries = _table(jms)
    tdb, tt, _ = _table(tms, device="cpu")
    yield jdb, jt, tdb, tt, queries
    jdb.close()
    tdb.close()


@pytest.fixture(scope="module")
def tables(dbs):
    return dbs[1], dbs[3], dbs[4]


def _jax_row_scores(jt, queries, metric):
    """JAX's exact score of every row: {segment id: f32[Q, capacity]}."""
    m = JMetric(metric)
    out = {}
    for seg in jt.live_segments():
        p = seg.vector("vec")
        dpad = p.data.shape[1]
        q = jdist.normalize_queries(jnp.asarray(np.pad(queries, ((0, 0), (0, dpad - DIM)))), m)
        out[seg.segment_id] = np.asarray(jdist.scores_ref(q, p.data, p.aux_for(m), metric=m))
    return out


def _hold_to_jax(jres, tres, row_scores, r):
    """Recall against JAX's (exact) ids >= r - 0.02, and every returned
    score JAX's score for that row."""
    def keys(res):
        return res.segments.astype(np.int64) * 10**9 + res.rows
    rec = _recall(keys(tres), keys(jres))
    assert rec >= r - 0.02, rec
    ok = tres.rows >= 0
    assert ok.all()  # every query finds k rows
    want = np.array([[row_scores[s][i, row] for s, row in zip(segs, rows)]
                     for i, (segs, rows) in enumerate(zip(tres.segments, tres.rows))])
    np.testing.assert_allclose(tres.scores, want, **TOL)
    return rec


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_table_search_recall_against_jax(tables, metric, filtered):
    jt, tt, queries = tables
    r = 0.9
    flt = (lambda F: (F("id") < 28_000) & (F("tag") != 3)) if filtered else (lambda F: None)
    jres = jt.search("vec", queries, k=K, metric=metric, filter=flt(jms.F),
                     settings=_approx_settings(jms, r))
    tres = tt.search("vec", queries, k=K, metric=metric, filter=flt(tms.F),
                     settings=_approx_settings(tms, r))
    row_scores = _jax_row_scores(jt, queries, metric)
    _hold_to_jax(jres, tres, row_scores, r)
    # the approximate branch really drops rows at this target
    exact = tt.search("vec", queries, k=K, metric=metric, filter=flt(tms.F))
    assert (tres.rows != exact.rows).any()
    if filtered:
        got = tt.gather(tres, ["id", "tag"])
        assert (got["id"] < 28_000).all() and (got["tag"] != 3).all()


def test_built_flat_index_takes_the_setting():
    r = 0.9
    pair = []
    for ms, kw in ((jms, {}), (tms, {"device": "cpu"})):
        db, t, queries = _table(ms, _approx_settings(ms, r), index=True, **kw)
        t.add_vector_index("f", "vec", type="FLAT")
        t.wait_index_built()
        pair.append((db, t, t.search("vec", queries, k=K)))
    (jdb, jt, jres), (tdb, tt, tres) = pair
    idx = tt.loaded_index(tt.live_segments()[0].segment_id, "vec", Metric.L2)
    assert idx is not None and idx.approx and idx.recall_target == r
    _hold_to_jax(jres, tres, _jax_row_scores(jt, queries, "L2"), r)
    assert (tres.rows != jres.rows).any()  # the built index's scan is approximate
    jdb.close()
    tdb.close()


def test_sql_settings_reach_the_scan(dbs):
    jdb, jt, tdb, tt, queries = dbs
    lit = ", ".join("[" + ", ".join(repr(float(v)) for v in q) + "]" for q in queries)
    stmt = (f"SELECT id, batch_distance(vec, [{lit}]) AS d FROM t ORDER BY d.2 LIMIT {K} "
            f"BY d.1")
    out = {}
    for name, db in (("jax", jdb), ("port", tdb)):
        ids = np.full((NQ, K), -1, np.int64)
        d = np.zeros((NQ, K))
        fill = np.zeros(NQ, np.int64)
        for row in db.sql(stmt + " SETTINGS use_approx_topk=1"):
            i = row["d"][0]
            ids[i, fill[i]], d[i, fill[i]] = row["id"], row["d"][1]
            fill[i] += 1
        out[name] = ids, d
    ids, d = out["port"]
    assert (fill == K).all() and (ids >= 0).all()
    rec = _recall(ids, out["jax"][0])
    assert rec >= 0.99 - 0.02, rec
    assert (ids != out["jax"][0]).any()  # the port's scan is approximate
    # each distance is JAX's for that row (ids are insert positions)
    rs = _jax_row_scores(jt, queries, "L2")
    score = np.where(ids < N1, np.take_along_axis(rs[0], np.minimum(ids, N1 - 1), 1),
                     np.take_along_axis(rs[1], np.maximum(ids - N1, 0), 1))
    qsq = (queries.astype(np.float64) ** 2).sum(1)[:, None]
    np.testing.assert_allclose(d, qsq - score, **TOL)


def _planted_binary(rng, n, nbytes, nq):
    """Random rows, and for each query K planted rows at Hamming
    distances 1..K, so that each query's exact top-K is unique."""
    x = rng.integers(0, 256, (n, nbytes), dtype=np.uint8)
    q = rng.integers(0, 256, (nq, nbytes), dtype=np.uint8)
    rows = rng.choice(n, (nq, K), replace=False)
    bits = nbytes * 8
    for i in range(nq):
        for d, row in enumerate(rows[i], start=1):
            flip = np.zeros(bits, np.uint8)
            flip[rng.choice(bits, d, replace=False)] = 1
            x[row] = q[i] ^ np.packbits(flip)
    return x, q, rows


@pytest.mark.parametrize("masked", [False, True])
def test_binary_scan_recall_against_jax(masked):
    rng = np.random.default_rng(5)
    n, nbytes, chunk = 16_384, 16, 8_192  # two chunks of 8,192 rows
    x, q, planted = _planted_binary(rng, n, nbytes, NQ)
    mask = rng.random(n) < 0.9 if masked else None
    if mask is not None:
        mask[planted.ravel()] = True
    assert topk.approx_reduction_output_size(chunk, K, 0.99) < chunk
    jv, ji = jbin.binary_scan_topk(jnp.asarray(q), jnp.asarray(x), k=K, metric=JMetric.HAMMING,
                                   n_valid=n - 5, approx=True, chunk_rows=chunk,
                                   mask=None if mask is None else jnp.asarray(mask))
    tv, ti = tbin.binary_scan_topk(torch.from_numpy(q), torch.from_numpy(x), k=K,
                                   metric=Metric.HAMMING, n_valid=n - 5, approx=True,
                                   chunk_rows=chunk,
                                   mask=None if mask is None else torch.from_numpy(mask))
    ji, ti, tv = np.asarray(ji), ti.numpy(), tv.numpy()
    live = planted < n - 5
    assert all(set(planted[i][live[i]]) <= set(ji[i]) for i in range(NQ))  # JAX: exact
    assert _recall(ti, ji) >= 0.99 - 0.02
    # every score is JAX's score of that row
    js = np.asarray(jbin.binary_chunk_scores(jnp.asarray(q), jnp.asarray(x), JMetric.HAMMING))
    np.testing.assert_array_equal(tv, np.take_along_axis(js, ti, 1))
    assert (ti < n - 5).all()
    if mask is not None:
        assert mask[ti].all()


@pytest.fixture(scope="module")
def text_stores():
    """(JAX store, port store) over 9,000 docs in a 9,216-row segment:
    the dense route."""
    rng = np.random.default_rng(17)
    vocab = [f"term{i}" for i in range(400)]
    docs = np.array([" ".join(rng.choice(vocab, 11)) for _ in range(9_000)], dtype=object)
    js = jinv.InvertedIndex.build([docs], 9_216)
    ts = inverted_from_state_dict(js.state_dict(), "cpu")
    queries = [" ".join(rng.choice(vocab, 3)) for _ in range(NQ)]
    return js, ts, queries


def _bm25_score_recall(tv, tr, full, jv):
    """Recall by score (BM25 ties): the share of JAX's top-k scores
    (multiset) the port's cover; every port score is JAX's score of its
    row (`full`, f32[Q, capacity], 2 ulp)."""
    fin = np.isfinite(tv)
    np.testing.assert_allclose(tv[fin], full[np.nonzero(fin)[0], tr[fin]], rtol=2.5e-7, atol=0)
    hit = tot = 0
    for i in range(tv.shape[0]):
        want = sorted(jv[i][np.isfinite(jv[i])].tolist())
        got = sorted(tv[i][fin[i]].tolist())
        tot += len(want)
        a = b = 0
        while a < len(want) and b < len(got):
            if want[a] == got[b]:
                hit, a, b = hit + 1, a + 1, b + 1
            elif want[a] < got[b]:
                a += 1
            else:
                b += 1
    return hit / max(tot, 1)


def test_bm25_dense_recall_against_jax(text_stores):
    js, ts, queries = text_stores
    assert ts.plan_batch(queries, stats=ts.stats)[3] == "dense"
    assert topk.approx_reduction_output_size(ts.capacity, K, 0.99) < ts.capacity
    jall = js.bm25_topk_batch(queries, ts.capacity)  # JAX's score of every row
    jv_all, jr_all = np.asarray(jall[0]), np.asarray(jall[1])
    full = np.full((len(queries), ts.capacity), -np.inf, np.float32)
    ok = jr_all >= 0
    full[np.nonzero(ok)[0], jr_all[ok]] = jv_all[ok]
    tout = ts.bm25_topk_batch(queries, K, approx=True)
    assert tout[4] is None
    jout = js.bm25_topk_batch(queries, K, approx=True)
    jv = np.asarray(jout[0])
    np.testing.assert_array_equal(jv, jv_all[:, :K])  # JAX's branch is exact on the CPU
    tv, tr = tout[0].numpy(), tout[1].numpy()
    rec = _bm25_score_recall(tv, tr, full, jv)
    assert rec >= 0.99 - 0.02, rec
    # the single-query form is the batch's row
    for i in (0, 7):
        v, r, terms = ts.bm25_topk(queries[i], K, approx=True)
        jv1, _, jterms = js.bm25_topk(queries[i], K, approx=True)
        assert terms == jterms and tuple(v.shape) == (1, K) == np.asarray(jv1).shape
        np.testing.assert_array_equal(v.numpy()[0], tv[i])
        np.testing.assert_array_equal(r.numpy()[0], tr[i])
        assert _bm25_score_recall(v.numpy(), r.numpy(), full[i : i + 1], np.asarray(jv1)) >= 0.8


def test_bm25_sparse_path_stays_exact(text_stores, monkeypatch):
    js, ts, queries = text_stores

    def refuse(*a, **kw):
        raise AssertionError("the sparse path ran the partial reduce")

    monkeypatch.setattr(topk, "approx_bin_max", refuse)
    a = ts.bm25_topk_batch(queries[:50], K, approx=True, route="sparse")
    e = ts.bm25_topk_batch(queries[:50], K, route="sparse")
    np.testing.assert_array_equal(a[1].numpy(), e[1].numpy())


def test_distributed_scan_recall_against_jax():
    jmesh = jpar.make_mesh(8, query_axis=2)
    mesh = tpar.make_mesh(8, query_axis=2, device="cpu")
    rng = np.random.default_rng(9)
    n, nq = 4 * 8_192, NQ
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    q = rng.standard_normal((nq, DIM)).astype(np.float32)
    aux = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    mask = rng.random(n) < 0.8
    assert topk.approx_reduction_output_size(8_192, K, 0.99) < 8_192
    v, r = tpar.distributed_scan_topk(
        mesh, torch.from_numpy(q), tpar.shard_rows(mesh, x), tpar.shard_rows(mesh, aux),
        k=K, metric=Metric.L2, rows_per_shard=n // 4, approx=True,
        mask=tpar.shard_rows(mesh, mask),
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    jv, jr = jpar.distributed_scan_topk(
        jmesh, jax.device_put(q, NamedSharding(jmesh, P("query", None))),
        jpar.shard_rows(jmesh, x), jpar.shard_rows(jmesh, aux), k=K, metric=JMetric.L2,
        rows_per_shard=n // 4, approx=True, mask=jpar.shard_rows(jmesh, mask),
    )
    r, v, jr = r.numpy(), v.numpy(), np.asarray(jax.device_get(jr))
    assert mask[r].all()
    assert _recall(r, jr) >= 0.99 - 0.02
    want = 2.0 * np.einsum("qd,qkd->qk", q.astype(np.float64), x[r].astype(np.float64)) - aux[r]
    np.testing.assert_allclose(v, want, **TOL)


# ----------------------------------------- indexes ignore the setting
@pytest.mark.parametrize("kind,params", [
    ("IVFFLAT", {"ncentroids": 64}), ("HNSWFLAT", {"m": 16, "ef_c": 64}), ("MSTG", {}),
])
def test_index_searches_ignore_the_setting(kind, params):
    """IVF, HNSW and MSTG segments answer a search with the setting, with
    the ids they give without it (the setting reaches FLAT scans only)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((6_000, DIM)).astype(np.float32)
    q = (x[:200] + 0.1 * rng.standard_normal((200, DIM))).astype(np.float32)
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 1_000
    db = tms.connect(st, device="cpu")
    t = db.create_table("i", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(DIM)}))
    t.insert({"id": np.arange(len(x), dtype=np.uint64), "vec": x})
    t.add_vector_index("ix", "vec", type=kind, **params)
    t.wait_index_built()
    plain = tms.Settings()
    plain.query.cost_based_index_routing = False
    appr = _approx_settings(tms, 0.5)
    appr.query.cost_based_index_routing = False
    want = t.search("vec", q, k=K, settings=plain)
    got = t.search("vec", q, k=K, settings=appr)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.distances, want.distances)
    db.close()
