"""Full-text and hybrid search: the port (myscaledb_tpu_torch, on the CPU)
against the JAX package on the same inputs.

BM25 scores tie exactly as a rule (12-word documents over a small
vocabulary, tf = 1), so ties are part of what is compared:

  * the dense BM25 path sums each row's contributions over terms in
    order, as JAX's `fori_loop` does: ids equal JAX's, ties included, and
    scores agree within 2 f32 ulp (rtol 2.5e-7);
  * the sparse path takes a row's score as the difference of two f32
    prefix sums, whose error is a few ulps of the running total
    (`sparse_error_bound`); its scores are held to that bound, its ids
    compared wherever the k-th and (k+1)-th scores differ by more;
  * fusion and every top-k on the text path order exact ties as
    `jax.lax.top_k` does, lower position first.

Stores are carried across with `storage/convert.py::
inverted_from_state_dict`, so both packages score the same postings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.search import fusion as jfusion
from myscaledb_tpu.text import inverted as jinv
from myscaledb_tpu.text.analyzer import Analyzer as JAnalyzer
from myscaledb_tpu_torch.ops.topk import topk_stable
from myscaledb_tpu_torch.search import fusion as tfusion
from myscaledb_tpu_torch.storage.convert import inverted_from_state_dict
from myscaledb_tpu_torch.text import inverted as tinv
from myscaledb_tpu_torch.text.analyzer import Analyzer as TAnalyzer

DENSE_RTOL = 2.5e-7  # 2 f32 ulp
K = 10
VOCAB = [f"term{i}" for i in range(400)]


def _docs(rng, n, words=12, vocab=VOCAB):
    return np.array([" ".join(rng.choice(vocab, words)) for _ in range(n)], dtype=object)


def _queries(rng, n, words, vocab=VOCAB):
    return [" ".join(rng.choice(vocab, words)) for _ in range(n)]


def test_analyzer_matches_jax():
    texts = [
        "History's best BOOKS, and the books' index", "a-b_c 42x don't", "",
        "The quick brown fox", "x" * 70 + " short", "Über naïve café", "it's its IT",
    ]
    for params in (None, {"stop_words": "english"}, {"lower_case": False, "min_token_len": 2},
                   {"stop_words": ["fox", "Books"], "max_token_len": 5}):
        ja, ta = JAnalyzer(params), TAnalyzer(params)
        assert ta.config() == ja.config()
        for t in texts:
            assert ta.tokenize(t) == ja.tokenize(t)
            assert ta.tokenize_query(t) == ja.tokenize_query(t)


# ------------------------------------------------------------------ stores
@pytest.fixture(scope="module")
def stores():
    """(JAX store, port store) over 9,000 docs in a 9,216-row segment: the
    dense route. Every doc also holds `common`, whose 9,000 postings
    exceed BUDGET_CAP, so a query with it scans in chunks."""
    rng = np.random.default_rng(7)
    docs = _docs(rng, 9_000, words=11)
    docs = np.array([d + " common" for d in docs], dtype=object)
    js = jinv.InvertedIndex.build([docs], 9_216)
    ts = inverted_from_state_dict(js.state_dict(), "cpu")
    assert ts.builder == "state_dict" and js.stats.doc_freq["common"] > jinv.BUDGET_CAP
    return js, ts, rng


def _masks(rng, nq, cap, kind):
    if kind == "none":
        return None, None
    if kind == "shared":
        m = rng.random(cap) < 0.6
    else:
        m = rng.random((nq, cap)) < 0.6
    return jnp.asarray(m), torch.from_numpy(m)


def _dense_same(jout, tout):
    jv, jr, jt = (np.asarray(a) for a in jout[:3])
    tv, tr, tt = (a.numpy() for a in tout[:3])
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=DENSE_RTOL, atol=0)


@pytest.mark.parametrize("mask_kind", ["none", "shared", "per_query"])
@pytest.mark.parametrize("operator", ["OR", "AND"])
def test_dense_bm25_matches_jax_ties_included(stores, operator, mask_kind):
    js, ts, _ = stores
    rng = np.random.default_rng(["none", "shared", "per_query"].index(mask_kind) + 10 * len(operator))
    qs = _queries(rng, 12, 3) + _queries(rng, 4, 8) + ["common " + VOCAB[5], "", "nosuchterm"]
    qs += [f"{VOCAB[1]} common", VOCAB[2]]
    jm, tm = _masks(rng, len(qs), js.capacity, mask_kind)
    jout = js.bm25_topk_batch(qs, K, operator=operator, mask=jm)
    tout = ts.bm25_topk_batch(qs, K, operator=operator, mask=tm)
    assert tout[4] is None  # the dense path has no prefix-sum bound
    _dense_same(jout, tout)
    jv = np.asarray(jout[0])
    # ties are really there: some query's top-k holds equal scores
    assert any(len(set(r[np.isfinite(r)].tolist())) < np.isfinite(r).sum() for r in jv)


def test_chunked_term_matches_jax(stores):
    js, ts, _ = stores
    qs = ["common", f"common {VOCAB[3]}", f"{VOCAB[9]} common {VOCAB[10]}"]
    plan = ts.plan_batch(qs, stats=ts.stats)
    assert plan[2] == jinv.BUDGET_CAP and plan[0][0, plan[1].shape[1]] > 0
    assert (plan[0][:, plan[1].shape[1] : 2 * plan[1].shape[1]] > 0).sum(axis=1)[0] == 2  # two chunks
    for op in ("OR", "AND"):
        _dense_same(js.bm25_topk_batch(qs, 50, operator=op), ts.bm25_topk_batch(qs, 50, operator=op))


@pytest.fixture(scope="module")
def sparse_stores():
    """(JAX store, port store) whose capacity (262,144) takes the sparse
    route for short queries in both packages."""
    rng = np.random.default_rng(11)
    docs = _docs(rng, 6_000)
    js = jinv.InvertedIndex.build([docs], jinv.SPARSE_MIN_CAPACITY)
    ts = inverted_from_state_dict(js.state_dict(), "cpu")
    return js, ts


def _sparse_same(jout, tout, k):
    """Scores within the sparse bound; ids where the k-th and (k+1)-th
    scores of JAX's k+1 differ by more than it (compared as sets: the
    path's noise reorders exact ties inside the top-k)."""
    jv, jr = np.asarray(jout[0]), np.asarray(jout[1])
    tv, tr = tout[0].numpy(), tout[1].numpy()
    bound = tout[4].numpy()
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    compared = 0
    for i in range(jv.shape[0]):
        fin = np.isfinite(jv[i, :k])
        assert (np.abs(np.sort(tv[i, :k][fin]) - np.sort(jv[i, :k][fin])) <= bound[i]).all()
        if not np.isfinite(jv[i, k]) or jv[i, k - 1] - jv[i, k] > bound[i]:
            assert set(tr[i, :k].tolist()) == set(jr[i, :k].tolist())
            compared += 1
    return compared


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("operator", ["OR", "AND"])
def test_sparse_bm25_matches_jax_within_bound(sparse_stores, operator, masked):
    js, ts = sparse_stores
    rng = np.random.default_rng(5 + masked)
    qs = _queries(rng, 24, 3) + _queries(rng, 8, 2)
    assert ts.plan_batch(qs, stats=ts.stats)[3] == "sparse"
    jm = tm = None
    if masked:
        m = rng.random(js.capacity) < 0.5
        jm, tm = jnp.asarray(m), torch.from_numpy(m)
    jout = js.bm25_topk_batch(qs, K + 1, operator=operator, mask=jm)
    tout = ts.bm25_topk_batch(qs, K + 1, operator=operator, mask=tm)
    assert tout[4] is not None and (tout[4] > 0).all()
    compared = _sparse_same(jout, tout, K)
    assert compared >= 4  # the id check is not vacuous


def test_sparse_bound_covers_f64_and_both_routes_agree(sparse_stores):
    """The sparse path against the dense one on the same store and
    queries, and both against an f64 BM25 of each hit."""
    js, ts = sparse_stores
    rng = np.random.default_rng(21)
    qs = _queries(rng, 16, 3)
    sp = ts.bm25_topk_batch(qs, K + 1, route="sparse")
    de = ts.bm25_topk_batch(qs, K + 1, route="dense")
    bound = sp[4].numpy()
    dv, sv = de[0].numpy(), sp[0].numpy()
    for i in range(len(qs)):
        fin = np.isfinite(dv[i, :K])
        assert (np.abs(np.sort(sv[i, :K][fin]) - np.sort(dv[i, :K][fin])) <= bound[i]).all()
    # f64 oracle of each dense hit
    st = ts.stats
    for i, q in enumerate(qs):
        terms = list(dict.fromkeys(ts.analyzer.tokenize_query(q)))
        for r, v in zip(de[1][i, :K].tolist(), dv[i, :K].tolist()):
            if r < 0:
                continue
            want = 0.0
            for t in terms:
                s, ln = ts.term_range(t)
                rows = ts.postings_rows[s : s + ln].numpy()
                hit = np.nonzero(rows == r)[0]
                if len(hit):
                    tf = float(ts.postings_tf[s + hit[0]])
                    dl = float(ts.doc_len[r])
                    denom = tf + 1.2 * (0.25 + 0.75 * dl / st.avg_doc_len)
                    want += st.idf(t) * tf * 2.2 / denom
            assert abs(v - want) <= 1e-5 * want


def test_phrase_doc_counts_match_jax():
    rng = np.random.default_rng(3)
    small = [f"w{i}" for i in range(6)]
    docs = _docs(rng, 400, words=7, vocab=small)
    js = jinv.InvertedIndex.build([docs], 512)
    ts = inverted_from_state_dict(js.state_dict(), "cpu")
    for phrase in (["w1", "w2"], ["w3", "w3"], ["w0", "w1", "w2"], ["w5"], ["w1", "zz"]):
        got = ts.phrase_counts_device(phrase).numpy()
        want = np.asarray(js.phrase_counts_device(phrase))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ts.phrase_bitmap(phrase), js.phrase_bitmap(phrase))
    assert ts.phrase_counts_device(["w1", "w2"]).sum() > 0


def test_builders_give_one_store():
    """The Python builder and the native one (when it builds here) give
    the JAX package's arrays, and record which ran."""
    rng = np.random.default_rng(4)
    cols = [_docs(rng, 300, words=5), _docs(rng, 300, words=3)]
    js = jinv.InvertedIndex.build(cols, 512, use_native=False)
    for native in (False, True):
        ts = tinv.InvertedIndex.build(cols, 512, device="cpu", use_native=native)
        if not native:
            assert ts.builder == "python"
        a, b = ts.state_dict(), js.state_dict()
        assert a["meta"] == b["meta"]
        for f in ("term_offsets", "postings_rows", "postings_tf", "doc_len", "terms", "token_stream"):
            np.testing.assert_array_equal(a["arrays"][f], b["arrays"][f])


# ------------------------------------------------------------------ fusion
def _legs(rng, nq, k, nseg=2, nrows=30, empty=0.2):
    tags = rng.integers(0, nseg, (nq, k)).astype(np.int32)
    rows = rng.integers(0, nrows, (nq, k)).astype(np.int32)  # duplicates on purpose
    drop = rng.random((nq, k)) < empty
    tags[drop], rows[drop] = -1, -1
    return tags, rows


def _fused_same(jout, tout):
    jv, jt, jr = (np.asarray(a) for a in jout)
    tv, tt, tr = (a.numpy() for a in tout)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, rtol=DENSE_RTOL, atol=0)


@pytest.mark.parametrize("k", [5, 40])
def test_rrf_fuse_matches_jax(k):
    rng = np.random.default_rng(k)
    ta, ra = _legs(rng, 6, 15)
    tb, rb = _legs(rng, 6, 12)
    jout = jfusion.rrf_fuse_t(*(jnp.asarray(a) for a in (ta, ra, tb, rb)), k, fusion_k=60)
    tout = tfusion.rrf_fuse_t(*(torch.from_numpy(a) for a in (ta, ra, tb, rb)), k, fusion_k=60)
    _fused_same(jout, tout)


@pytest.mark.parametrize("weight,asc", [(0.5, False), (0.3, True), (1.0, False)])
def test_rsf_fuse_matches_jax(weight, asc):
    rng = np.random.default_rng(int(weight * 10))
    tv_, rv = _legs(rng, 5, 14)
    tt_, rt = _legs(rng, 5, 9)
    sv = np.round(rng.standard_normal((5, 14)), 1).astype(np.float32)  # ties in the scores
    st = np.round(rng.uniform(0, 5, (5, 9)), 1).astype(np.float32)
    st[0] = 2.0  # an all-equal leg
    args = (tv_, rv, sv, tt_, rt, st)
    jout = jfusion.rsf_fuse_t(*(jnp.asarray(a) for a in args), 10, fusion_weight=weight,
                              vec_ascending_better=asc)
    tout = tfusion.rsf_fuse_t(*(torch.from_numpy(a) for a in args), 10, fusion_weight=weight,
                              vec_ascending_better=asc)
    _fused_same(jout, tout)


@pytest.mark.parametrize("n,k", [(50, 10), (7, 7), (300, 64)])
def test_topk_stable_matches_lax_top_k(n, k):
    rng = np.random.default_rng(n)
    s = rng.integers(-3, 3, (9, n)).astype(np.float32)
    s[0] = 1.0  # a row of one value
    s[1, ::3] = -np.inf
    s[2] = -np.inf
    s[3, :5] = [0.5, -0.5, 0.5, -0.5, 0.5]
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    tv, ti = topk_stable(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------------- table
DIM, N1, N2, NQ = 8, 2_000, 1_500, 12


def _table_columns():
    rng = np.random.default_rng(2026)
    n = N1 + N2
    body = _docs(rng, n, words=10, vocab=VOCAB[:150])
    title = _docs(rng, n, words=3, vocab=VOCAB[100:200])
    body[7] = "exact phrase marker " + body[7]
    body[N1 + 9] = "the exact phrase marker again"
    vec = rng.standard_normal((n, DIM)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64)
    parts = [slice(0, N1), slice(N1, n)]
    qv = (vec[rng.choice(n, NQ)] + 0.3 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    qt = _queries(rng, NQ, 3, VOCAB[:150])
    return [{"id": ids[p], "body": body[p], "title": title[p], "vec": vec[p]} for p in parts], qv, qt


def _make_table(ms, **kw):
    cols, qv, qt = _table_columns()
    db = ms.connect(**kw)
    t = db.create_table("h", ms.Schema({"id": ms.UInt64(), "body": ms.String(),
                                        "title": ms.String(), "vec": ms.FloatVector(DIM)}))
    t.add_fts_index("ft", "body")
    t.add_fts_index("ft2", ["title", "body"])
    for c in cols:
        t.insert(c)
    assert t.delete(ms.F("id").isin(list(range(3, N1 + N2, 35)))) == 100
    return db, t, qv, qt


@pytest.fixture(scope="module")
def tables():
    jdb, jt, qv, qt = _make_table(jms)
    tdb, tt, _, _ = _make_table(tms, device="cpu")
    yield jt, tt, qv, qt
    jdb.close()
    tdb.close()


def _result_same(jres, tres, **tol):
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    fin = np.isfinite(jres.scores)
    np.testing.assert_array_equal(np.isfinite(tres.scores), fin)
    np.testing.assert_allclose(tres.scores[fin], jres.scores[fin], **(tol or dict(rtol=DENSE_RTOL, atol=0)))


@pytest.mark.parametrize("operator", ["OR", "AND"])
@pytest.mark.parametrize("index", ["ft", "ft2"])
def test_table_text_search_matches_jax(tables, operator, index):
    jt, tt, _, qt = tables
    qs = qt + [f"{VOCAB[4]} {VOCAB[5]}", VOCAB[6]]
    for flt in (None, lambda ms: ms.F("id") < 2_600):
        kw = {} if flt is None else {"filter": flt(jms)}
        jres = jt.text_search(index, qs, k=K, operator=operator, **kw)
        kw = {} if flt is None else {"filter": flt(tms)}
        tres = tt.text_search(index, qs, k=K, operator=operator, **kw)
        _result_same(jres, tres)
        ids = tt.gather(tres, ["id"])["id"][tres.valid]
        assert not (ids % 35 == 3).any()  # no deleted row comes back
    one = tt.text_search("body", qs[0], k=K)  # a column name resolves to its index
    np.testing.assert_array_equal(one.rows, jt.text_search("body", qs[0], k=K).rows)


def test_table_nlq_matches_jax(tables):
    jt, tt, _, qt = tables
    qs = ['"exact phrase marker" ' + qt[0], f'{qt[1]} -{VOCAB[7]}', '"phrase marker"', qt[2]]
    jres = jt.text_search("ft", qs, k=K, enable_nlq=True)
    tres = tt.text_search("ft", qs, k=K, enable_nlq=True)
    _result_same(jres, tres)
    body = tt.gather(tres, ["body"])["body"]
    assert all("phrase marker" in b for b in body[2][tres.valid[2]])
    assert not any(VOCAB[7] in b.split() for b in body[1][tres.valid[1]])


def test_fts_predicates_filter_vector_search_like_jax(tables):
    jt, tt, qv, _ = tables
    for make in (
        lambda t: t.has_token("body", VOCAB[3]),
        lambda t: t.like("body", f"% {VOCAB[8]} {VOCAB[9]} %"),
        lambda t: t.like("body", f"%{VOCAB[8]}%", negate=True),
        lambda t: t.multi_search_any("body", [f" {VOCAB[1]} {VOCAB[2]} ", "phrase"]),
        lambda t: t.has_phrase("body", "exact phrase marker"),
        lambda t: t.has_token_matching("body", r"term1[0-2]"),
        lambda t: t.has_phrase("title", f"{VOCAB[120]} {VOCAB[121]}"),
    ):
        jres = jt.search("vec", qv, k=K, filter=make(jt))
        tres = tt.search("vec", qv, k=K, filter=make(tt))
        np.testing.assert_array_equal(tres.segments, jres.segments)
        np.testing.assert_array_equal(tres.rows, jres.rows)
        np.testing.assert_allclose(tres.distances, jres.distances, rtol=2e-4, atol=2e-3)
        for seg in tt.live_segments():
            np.testing.assert_array_equal(
                make(tt).evaluate(seg), make(jt).evaluate(jt.live_segments()[seg.segment_id])
            )


@pytest.mark.parametrize("fusion", [("rrf", {"fusion_k": 60}), ("rsf", {"fusion_weight": 0.5}),
                                    ("rsf", {"fusion_weight": 0.8})])
def test_hybrid_search_matches_jax(tables, fusion):
    jt, tt, qv, qt = tables
    ftype, kw = fusion
    for flt in (None, lambda ms: ms.F("id") >= 500):
        extra_j = {} if flt is None else {"filter": flt(jms)}
        extra_t = {} if flt is None else {"filter": flt(tms)}
        jres = jt.hybrid_search("vec", "ft", qv, qt, k=K, fusion_type=ftype, **kw, **extra_j)
        tres = tt.hybrid_search("vec", "ft", qv, qt, k=K, fusion_type=ftype, **kw, **extra_t)
        # RSF normalizes the vector leg's scores, which agree with JAX's
        # within the f32 tolerance of the vector search (rtol 2e-4), and
        # min-max scaling carries that error into the fused score
        _result_same(jres, tres, **({} if ftype == "rrf" else dict(rtol=0, atol=1e-4)))
    one = tt.hybrid_search("vec", "body", qv[:1], qt[0], k=K, fusion_type=ftype, **kw)
    np.testing.assert_array_equal(one.rows, jt.hybrid_search(
        "vec", "body", qv[:1], qt[0], k=K, fusion_type=ftype, **kw).rows)


def test_fts_stats_and_lifecycle(tables):
    jt, tt, _, qt = tables
    assert tt._text_indexes["ft"].store(0).builder in ("native", "python")
    tdb = tms.connect(device="cpu")
    t = tdb.create_table("s", tms.Schema({"id": tms.UInt64(), "body": tms.String()}))
    t.insert({"id": np.arange(3, dtype=np.uint64), "body": ["a b", "b c", "c d e"]})
    t.add_fts_index("f", "body")
    stats = tdb.fts_index_stats("s", "body", "b c zz")
    assert stats == {"total_docs": 3, "total_tokens": 7, "avg_doc_len": 7 / 3,
                     "doc_freq": {"b": 2, "c": 2, "zz": 0}}
    with pytest.raises(tms.IndexParameterError):
        t.add_fts_index("f", "body")
    with pytest.raises(tms.SchemaError):
        t.add_fts_index("g", "id")
    with pytest.raises(tms.SchemaError):
        t.text_search("f", "b", final=True)
    t.drop_fts_index("f")
    with pytest.raises(tms.SchemaError):
        t.text_search("body", "b")
    # stats_override scores against a cluster's statistics
    jres = jt.text_search("ft", qt[:3], k=K, stats_override=jinv.BM25Stats(10_000, 120_000, {}))
    tres = tt.text_search("ft", qt[:3], k=K, stats_override=tinv.BM25Stats(10_000, 120_000, {}))
    _result_same(jres, tres)
