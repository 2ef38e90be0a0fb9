"""Text and hybrid search programs: the port's counterparts of the JAX
package's jitted BM25 bodies (`_bm25_score_topk_batch`,
`_bm25_sparse_topk_batch`), `merge_tagged_topk`, `_fuse_device` and
`_phrase_doc_counts`, on the CPU.

A text search is one program of the table's one cache (`Table._programs`):
every live store's BM25 body and the merge, over one packed int32 plan
(`inverted.pack_plans`) and the masks' buffers; a hybrid search adds the
fuse program. On the CPU a program runs its body eagerly through the same
buffers as a captured CUDA graph replays them on the card, so these tests
hold the packing, the padding of the batch to 8 rows, the keys and the
invalidation to the JAX package's results:

  * ids equal JAX's and scores within 2 f32 ulp on the dense path (the
    port's sums are JAX's, ties included); on the sparse path scores
    within the route's `sparse_error_bound` and ids compared wherever the
    bound separates them;
  * the pad rows come out empty in every route, AND with need_counts
    included;
  * a program's output equals the pre-program body on the unpadded
    batch bit for bit.

The JAX package is imported inside the tests, so the card tests (marker
`cuda`) run where JAX is absent:
`python -m pytest --noconftest tests/test_torch_text_programs.py -m cuda`.
"""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import myscaledb_tpu_torch as tms
from myscaledb_tpu_torch.search import executor, text_executor
from myscaledb_tpu_torch.search.executor import SearchResult
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.text import inverted as tinv

DENSE_RTOL = 2.5e-7  # 2 f32 ulp, as tests/test_torch_text.py
K = 10
VOCAB = [f"w{i}" for i in range(120)]
N1, N2 = 300, 200


def _jax():
    import myscaledb_tpu as jms
    from myscaledb_tpu.text import inverted as jinv

    return jms, jinv


def _docs(rng, n):
    """Documents of 4-24 words over VOCAB (Zipf-like: low ids are common,
    words repeat), half of them holding `common` too (its postings exceed
    128, so a query with it takes a larger budget)."""
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    out = []
    for _ in range(n):
        words = list(rng.choice(VOCAB, int(rng.integers(4, 25)), p=p))
        if rng.random() < 0.5:
            words.append("common")
        out.append(" ".join(words))
    return np.array(out, dtype=object)


def _queries(rng, n, words):
    """Words of VOCAB[10:60]: none has more than 128 postings in a store."""
    return [" ".join(rng.choice(VOCAB[10:60], words, replace=False)) for _ in range(n)]


def _columns(seed=17):
    rng = np.random.default_rng(seed)
    body = _docs(rng, N1 + N2)
    body[5] = "alpha beta gamma " + body[5]
    body[N1 + 7] = "x alpha beta gamma y"
    vec = rng.standard_normal((N1 + N2, 8)).astype(np.float32)
    ids = np.arange(N1 + N2, dtype=np.uint64)
    return [{"id": ids[p], "body": body[p], "vec": vec[p]}
            for p in (slice(0, N1), slice(N1, N1 + N2))]


def _make(ms, nseg, **kw):
    db = ms.connect(**kw)
    t = db.create_table("t", ms.Schema({"id": ms.UInt64(), "body": ms.String(),
                                        "vec": ms.FloatVector(8)}))
    t.add_fts_index("ft", "body")
    cols = _columns()
    for c in cols[:nseg]:
        t.insert(c)
    t.text_search("ft", "w1")  # builds any pending store
    return db, t


@pytest.fixture(scope="module")
def tables():
    """{nseg: (JAX table, port table)} for one and two segments."""
    jms, _ = _jax()
    out, dbs = {}, []
    for nseg in (1, 2):
        jdb, jt = _make(jms, nseg)
        tdb, tt = _make(tms, nseg, device="cpu")
        dbs += [jdb, tdb]
        out[nseg] = (jt, tt)
    yield out
    for db in dbs:
        db.close()


@pytest.fixture()
def route(request, monkeypatch):
    """Force both packages' route rule: "sparse" (every store at or above
    a zero capacity floor) or "dense" (a floor no store reaches)."""
    _, jinv = _jax()
    floor = 0 if request.param == "sparse" else 1 << 40
    monkeypatch.setattr(jinv, "SPARSE_MIN_CAPACITY", floor)
    monkeypatch.setattr(tinv, "SPARSE_MIN_CAPACITY", floor)
    return request.param


def _count(name):
    return GLOBAL_COUNTERS.get(name)


def _routes(tt, qs, operator="OR"):
    tdef = tt._text_indexes["ft"]
    segs = tt.live_segments()
    stats = tdef.merged_stats([s.segment_id for s in segs])
    return {tdef.store(s.segment_id).plan_batch(qs, stats=stats, operator=operator)[3]
            for s in segs}


def _sparse_bounds(tt, qs, operator="OR"):
    """Each query's sparse bound: the largest over the stores."""
    tdef = tt._text_indexes["ft"]
    segs = tt.live_segments()
    stats = tdef.merged_stats([s.segment_id for s in segs])
    return np.max([tdef.store(s.segment_id).bm25_topk_batch(
        qs, K, stats=stats, operator=operator, route="sparse")[4].numpy() for s in segs], axis=0)


def _same(jres, tres, route, bounds=None):
    """Dense: ids equal, scores within 2 ulp. Sparse: scores (sorted)
    within the bound; the hit sets equal at every cut the bound
    separates. Returns the number of such cuts compared."""
    fin = np.isfinite(jres.scores)
    np.testing.assert_array_equal(np.isfinite(tres.scores), fin)
    np.testing.assert_array_equal(tres.valid, jres.valid)
    if route == "dense":
        np.testing.assert_array_equal(tres.segments, jres.segments)
        np.testing.assert_array_equal(tres.rows, jres.rows)
        np.testing.assert_allclose(tres.scores[fin], jres.scores[fin], rtol=DENSE_RTOL, atol=0)
        return fin.sum()
    cuts = 0
    for i in range(jres.nq):
        b = 2 * bounds[i]
        jv, tv = jres.scores[i], tres.scores[i]
        assert (np.abs(np.sort(tv[fin[i]]) - np.sort(jv[fin[i]])) <= bounds[i]).all()
        keys = lambda r: list(zip(r.segments[i].tolist(), r.rows[i].tolist()))  # noqa: E731
        jk, tk = keys(jres), keys(tres)
        # a cut inside the k returned: the last slot only shows where the
        # one before it ends
        for j in range(1, jres.k):
            if np.isfinite(jv[j - 1]) and not jv[j - 1] - jv[j] <= b:
                assert set(tk[:j]) == set(jk[:j])
                cuts += 1
    return cuts


def _pad_rows_empty(res):
    """The program's rows past the batch: every slot empty."""
    pad = res._packed[:, res.nq:]
    assert (pad[1] == -1).all() and (pad[2] == -1).all()
    assert torch.isinf(pad[0].view(torch.float32)).all()


# ---------------------------------------------------------------- parity
def _nlq_queries(rng, nq):
    qs = _queries(rng, nq, 3)
    qs[0] = '"alpha beta" ' + qs[0]
    if nq > 1:
        qs[1] = f"{qs[1]} -w3"
    return qs


@pytest.mark.parametrize("mask", ["none", "shared", "nlq"])
@pytest.mark.parametrize("operator", ["OR", "AND"])
@pytest.mark.parametrize("route", ["sparse", "dense"], indirect=True)
def test_text_search_matches_jax(tables, route, operator, mask):
    """Two segments, nine queries (two program rows of padding)."""
    jms, _ = _jax()
    jt, tt = tables[2]
    rng = np.random.default_rng(len(operator) + 3 * len(mask))
    qs = _nlq_queries(rng, 9) if mask == "nlq" else _queries(rng, 9, 3)
    qs[2] = "w0 w1"  # many matches
    assert _routes(tt, qs, operator) == {route}
    kw = {"enable_nlq": True} if mask == "nlq" else {}
    jkw, tkw = dict(kw), dict(kw)
    if mask == "shared":
        jkw["filter"], tkw["filter"] = jms.F("id") < 420, tms.F("id") < 420
    jres = jt.text_search("ft", qs, k=K + 1, operator=operator, **jkw)
    tres = tt.text_search("ft", qs, k=K + 1, operator=operator, **tkw)
    scored = [text_executor.parse_nlq(q)[0] for q in qs]
    bounds = _sparse_bounds(tt, scored, operator) if route == "sparse" else None
    assert _same(jres, tres, route, bounds) > 0
    _pad_rows_empty(tres)
    if mask == "shared":
        assert (tt.gather(tres, ["id"])["id"][tres.valid] < 420).all()


@pytest.mark.parametrize("nseg", [1, 2])
@pytest.mark.parametrize("nq", [1, 7, 8, 9, 33])
@pytest.mark.parametrize("route", ["sparse", "dense"], indirect=True)
def test_batch_sizes_and_empty_pad_rows(tables, route, nq, nseg):
    """AND over queries of two and three terms (need_counts), an empty
    query among them: JAX's results, and the pad rows empty."""
    jt, tt = tables[nseg]
    rng = np.random.default_rng(nq + 100 * nseg)
    qs = [" ".join(rng.choice(VOCAB[:12], 2 + i % 2, replace=False)) for i in range(nq)]
    if nq > 2:
        qs[1] = ""
    assert _routes(tt, qs, "AND") == {route}
    jres = jt.text_search("ft", qs, k=K + 1, operator="AND")
    tres = tt.text_search("ft", qs, k=K + 1, operator="AND")
    bounds = _sparse_bounds(tt, qs, "AND") if route == "sparse" else None
    _same(jres, tres, route, bounds)
    assert tres._packed.shape[1] == max(8, -(-nq // 8) * 8)
    _pad_rows_empty(tres)
    assert tres.valid.any()


@pytest.mark.parametrize("fusion", [("rrf", {"fusion_k": 60}), ("rsf", {"fusion_weight": 0.4})])
@pytest.mark.parametrize("nseg", [1, 2])
def test_hybrid_search_matches_jax(tables, nseg, fusion):
    jt, tt = tables[nseg]
    ftype, kw = fusion
    rng = np.random.default_rng(nseg)
    qv = rng.standard_normal((5, 8)).astype(np.float32)
    qt = _queries(rng, 5, 3)
    caps = _count("SearchProgramCaptures")
    jres = jt.hybrid_search("vec", "ft", qv, qt, k=K, fusion_type=ftype, **kw)
    tres = tt.hybrid_search("vec", "ft", qv, qt, k=K, fusion_type=ftype, **kw)
    assert _count("SearchProgramCaptures") - caps <= 3  # the vector, text and fuse programs
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    fin = np.isfinite(jres.scores)
    tol = dict(rtol=DENSE_RTOL, atol=0) if ftype == "rrf" else dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.scores[fin], jres.scores[fin], **tol)
    assert tres._packed is not None and tres._packed.shape == (3, 5, K)


@pytest.mark.parametrize("route", ["sparse", "dense"])
@pytest.mark.parametrize("nq", [1, 9])
def test_bm25_topk_batch_matches_jax(route, nq, monkeypatch):
    """The store's own entry point, one program on the store; its output
    carries the sparse bound."""
    from myscaledb_tpu_torch.storage.convert import inverted_from_state_dict

    _, jinv = _jax()
    cols = _columns()
    js = jinv.InvertedIndex.build([cols[0]["body"]], 1024)
    ts = inverted_from_state_dict(js.state_dict(), "cpu")
    floor = 0 if route == "sparse" else 1 << 40
    monkeypatch.setattr(jinv, "SPARSE_MIN_CAPACITY", floor)
    monkeypatch.setattr(tinv, "SPARSE_MIN_CAPACITY", floor)
    rng = np.random.default_rng(nq)
    qs = _queries(rng, nq, 3)
    m = rng.random(ts.capacity) < 0.7
    import jax.numpy as jnp

    for op in ("OR", "AND"):
        jout = js.bm25_topk_batch(qs, K, operator=op, mask=jnp.asarray(m))
        tout = ts.bm25_topk_batch(qs, K, operator=op, mask=torch.from_numpy(m))
        assert tout[0].shape == (nq, K) and tout[3] == jout[3]
        jv, jr = np.asarray(jout[0]), np.asarray(jout[1])
        tv, tr = tout[0].numpy(), tout[1].numpy()
        np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        if route == "dense":
            assert tout[4] is None
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_allclose(tv, jv, rtol=DENSE_RTOL, atol=0)
        else:
            bound = tout[4].numpy()
            assert bound.shape == (nq,) and (bound > 0).all()
            fin = np.isfinite(jv)
            for i in range(nq):
                assert (np.abs(np.sort(tv[i][fin[i]]) - np.sort(jv[i][fin[i]])) <= bound[i]).all()


# ------------------------------------------------ programs vs eager bodies
@pytest.mark.parametrize("operator", ["OR", "AND"])
@pytest.mark.parametrize("route", ["sparse", "dense"])
def test_store_program_equals_the_body_bit_for_bit(tables, route, operator):
    """bm25_topk_batch's program against `_bm25_*_topk_batch` called
    directly on the unpadded batch (the plan's own arrays, a per-query
    mask): the same bits."""
    _, tt = tables[2]
    store = tt._text_indexes["ft"].store(1)
    rng = np.random.default_rng(4)
    qs = _queries(rng, 6, 3) + ["common w1", ""]
    stats = store.stats
    mask = torch.from_numpy(rng.random((len(qs), store.capacity)) < 0.6)
    got = store.bm25_topk_batch(qs, K, stats=stats, operator=operator, mask=mask, route=route)
    qints, idfs, budget, _, need_counts, _ = store.plan_batch(qs, stats=stats, operator=operator)
    args = (*store.tensors, torch.from_numpy(qints), torch.from_numpy(idfs),
            torch.tensor(stats.avg_doc_len, dtype=torch.float32), mask)
    if route == "sparse":
        v, r, tg, pm = tinv._bm25_sparse_topk_batch(*args, budget=budget,
                                                    capacity=store.capacity, k=K)
        assert torch.equal(got[4].view(torch.int32), tinv.sparse_error_bound(pm).view(torch.int32))
    else:
        v, r, tg = tinv._bm25_score_topk_batch(*args, budget=budget, capacity=store.capacity, k=K,
                                               need_counts=need_counts)
    assert torch.equal(got[0].view(torch.int32), v.view(torch.int32))
    assert torch.equal(got[1], r) and torch.equal(got[2], tg)
    prog = store._programs.programs()[-1]  # the last one used
    assert prog.out.shape[1] == 8 and (prog.out[1, len(qs):] == -1).all()


@pytest.mark.parametrize("nlq", [False, True])
@pytest.mark.parametrize("route", ["sparse", "dense"], indirect=True)
def test_text_program_equals_the_eager_stores_and_merge(tables, route, nlq):
    """text_search's program against each store's pre-program body on the
    unpadded batch and the eager merge: the same bits."""
    _, tt = tables[2]
    rng = np.random.default_rng(8)
    qs = _nlq_queries(rng, 5) if nlq else _queries(rng, 5, 3)
    flt = tms.F("id") >= 30
    res = tt.text_search("ft", qs, k=K, filter=flt, enable_nlq=nlq)
    tdef = tt._text_indexes["ft"]
    segs = tt.live_segments()
    stats = tdef.merged_stats([s.segment_id for s in segs])
    parsed = [text_executor.parse_nlq(q) for q in qs]
    vs, rs = [], []
    for seg in segs:
        store = tdef.store(seg.segment_id)
        mask = executor.segment_mask(seg, flt).build()
        if nlq:
            extra = np.zeros((len(qs), seg.capacity), bool)
            for i, (_, ph, ng) in enumerate(parsed):
                extra[i, : seg.n_rows] = tdef.nlq_mask(seg, store, ph, ng)
            mask = torch.logical_and(torch.from_numpy(extra), mask[None, :])
        qints, idfs, budget, rt, need, _ = store.plan_batch(
            [p[0] for p in parsed] if nlq else qs, stats=stats)
        assert rt == route
        args = (*store.tensors, torch.from_numpy(qints), torch.from_numpy(idfs),
                torch.tensor(stats.avg_doc_len, dtype=torch.float32), mask)
        if route == "sparse":
            v, r = tinv._bm25_sparse_topk_batch(*args, budget=budget, capacity=store.capacity,
                                                k=K)[:2]
        else:
            v, r = tinv._bm25_score_topk_batch(*args, budget=budget, capacity=store.capacity,
                                               k=K, need_counts=need)[:2]
        vs.append(v)
        rs.append(r)
    mv, mt, mr = executor.merge_tagged_topk(vs, rs, K)
    want = executor.pack_result(mv, mt, mr)
    assert torch.equal(res._packed[:, : len(qs)], want)


# ------------------------------------------------------------ the plans
def test_packed_plan_equals_each_store_plan(tables):
    """One tokenization, each store planned from its terms: the same
    arrays as the store's plan_batch; the packed columns decode to them,
    and its pad rows are empty queries."""
    _, tt = tables[2]
    tdef = tt._text_indexes["ft"]
    rng = np.random.default_rng(12)
    qs = _queries(rng, 10, 3) + ["W1 w1 w2 COMMON", "", "nosuch w5", " ".join(VOCAB[:9])]
    stats = tdef.merged_stats([0, 1])
    terms = tinv.query_terms(tdef.analyzer, qs)
    stores = [tdef.store(i) for i in (0, 1)]
    plans = []
    for op in ("OR", "AND"):
        for store in stores:
            want = store.plan_batch(qs, stats=stats, operator=op)
            got = store.plan_terms(terms, stats=stats, operator=op)
            np.testing.assert_array_equal(got.qints, want[0])
            np.testing.assert_array_equal(got.idfs, want[1])
            assert tuple(got[2:]) == want[2:5] and terms == want[5]
            plans.append(got)
    nq_pad = tinv.pad_queries(len(qs))
    assert nq_pad == 16
    packed, offs = tinv.pack_plans(plans, stats.avg_doc_len, nq_pad)
    assert packed.dtype == np.int32 and packed.shape == (16, 1 + sum(3 * p.idfs.shape[1] + 1
                                                                     for p in plans))
    assert packed[:, 0].view(np.float32).tolist() == [np.float32(stats.avg_doc_len)] * 16
    t = torch.from_numpy(packed)
    for p, off in zip(plans, offs):
        nt = p.idfs.shape[1]
        np.testing.assert_array_equal(packed[: len(qs), off : off + 2 * nt + 1], p.qints)
        np.testing.assert_array_equal(
            t[: len(qs), off + 2 * nt + 1 : off + 3 * nt + 1].view(torch.float32).numpy(), p.idfs)
        pad = packed[len(qs):, off : off + 3 * nt + 1]
        assert (pad[:, 2 * nt] == nt + 1).all()
        assert (np.delete(pad, 2 * nt, axis=1) == 0).all()
    assert [tinv.pad_queries(n) for n in (1, 7, 8, 9, 33)] == [8, 8, 8, 16, 40]


# ------------------------------------------------------ keys and replays
def _text_keys(t):
    """The text searches' keys in the table's one cache, least recently
    used first."""
    return [key for key in t._programs._entries if key[0] == "text"]


def test_keys_and_replays(tables):
    """The same shapes replay; a new budget or nt makes a new key; new
    statistics (stats_override) do not, and score as JAX's do."""
    _, jinv = _jax()
    jt, tt = tables[2]
    rng = np.random.default_rng(30)
    qs = _queries(rng, 5, 3)
    tt._programs.invalidate()
    caps, reps = _count("SearchProgramCaptures"), _count("SearchProgramReplays")
    tt.text_search("ft", qs, k=K)
    tt.text_search("ft", _queries(rng, 8, 3), k=K)  # 8 rows: the same padded batch
    tt.text_search("ft", _queries(rng, 3, 2), k=K)
    assert {s[1] for s in _text_keys(tt)[0][3]} == {128}
    assert (_count("SearchProgramCaptures") - caps, _count("SearchProgramReplays") - reps) == (1, 3)
    key, = _text_keys(tt)
    budgets = lambda key: tuple(s[1] for s in key[3])  # noqa: E731
    nts = lambda key: tuple(s[2] for s in key[3])  # noqa: E731
    tt.text_search("ft", [q + " common" for q in qs], k=K)  # common's postings > 128
    tt.text_search("ft", [" ".join(VOCAB[:9])] + qs, k=K)  # 9 terms: nt 16
    keys = _text_keys(tt)
    assert len(keys) == 3
    assert budgets(keys[1]) != budgets(key) and nts(keys[2]) != nts(key)
    caps = _count("SearchProgramCaptures")
    for st in (jinv.BM25Stats(5_000, 60_000, {}), jinv.BM25Stats(900, 9_000, {"w1": 800})):
        jres = jt.text_search("ft", qs, k=K, stats_override=st)
        tres = tt.text_search("ft", qs, k=K, stats_override=tinv.BM25Stats(
            st.total_docs, st.total_tokens, dict(st.doc_freq)))
        _same(jres, tres, "dense")
    assert _count("SearchProgramCaptures") == caps and len(_text_keys(tt)) == 3


def _ops(ms, t):
    F = ms.F
    cols = _columns(seed=99)[1]
    return {
        "drop_index": lambda: t.drop_fts_index("ft"),
        "rebuild": lambda: t.update(F("id") < 40, {"body": "w1 w2 rebuilt"}),
        "insert": lambda: t.insert({**cols, "id": cols["id"] + 10_000}),
        "delete": lambda: t.delete(F("id") < 60),
        "merge": lambda: t.merge(),
    }


@pytest.mark.parametrize("op", ["drop_index", "rebuild", "insert", "delete", "merge"])
def test_changes_miss_the_cache_and_release_the_stores(op):
    """After each change the text programs are gone, and with them every
    tensor of a replaced or dropped store; the next search captures anew
    and returns JAX's results after the same change."""
    jms, _ = _jax()
    jdb, jt = _make(jms, 2)
    tdb, tt = _make(tms, 2, device="cpu")
    qs = ["w1 w2", "w3 rebuilt", "w4 w5 w6"]
    tt.text_search("ft", qs, k=K)
    old_progs = [weakref.ref(p) for p in tt._programs.programs()]
    tdef = tt._text_indexes["ft"]
    old_store = weakref.ref(tdef.store(0).postings_rows)
    del tdef
    _ops(jms, jt)[op]()
    _ops(tms, tt)[op]()
    assert len(tt._programs) == 0
    gc.collect()
    assert all(r() is None for r in old_progs)
    if op != "insert" and op != "delete":
        assert old_store() is None
    if op == "drop_index":
        with pytest.raises(tms.SchemaError):
            tt.text_search("ft", qs, k=K)
    else:
        caps = _count("SearchProgramCaptures")
        tres = tt.text_search("ft", qs, k=K)
        assert _count("SearchProgramCaptures") - caps == 1
        _same(jt.text_search("ft", qs, k=K), tres, "dense")
    jdb.close()
    tdb.close()


def test_eight_threads_get_their_own_answers(tables):
    jt, tt = tables[2]
    rng = np.random.default_rng(77)
    batches = [_queries(rng, 1 + i % 5, 2 + i % 3) for i in range(8)]
    want = [jt.text_search("ft", b, k=K) for b in batches]
    got = [None] * 8
    errors = []

    def worker(i):
        try:
            for _ in range(4):
                r = tt.text_search("ft", batches[i], k=K)
                got[i] = r
                r.rows  # noqa: B018 -- read it back here, on this thread
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    for j, r in zip(want, got):
        _same(j, r, "dense")


# ------------------------------------------------------- phrase and fuse
@pytest.fixture(scope="module")
def phrase_stores():
    from myscaledb_tpu_torch.storage.convert import inverted_from_state_dict

    _, jinv = _jax()
    rng = np.random.default_rng(3)
    small = [f"v{i}" for i in range(5)]
    docs = np.array([" ".join(rng.choice(small, int(rng.integers(1, 9)))) for _ in range(300)],
                    dtype=object)
    js = jinv.InvertedIndex.build([docs], 512)
    return js, inverted_from_state_dict(js.state_dict(), "cpu")


@pytest.mark.parametrize("phrase", [["v1"], ["v1", "v2"], ["v3", "v3", "v0"],
                                    ["v0", "v1", "v2", "v4"], ["v1", "absent"]],
                         ids=["m1", "m2", "m3", "m4", "absent"])
def test_phrase_counts_program_matches_jax(phrase_stores, phrase):
    js, ts = phrase_stores
    want = np.asarray(js.phrase_counts_device(phrase))
    caps, reps = _count("SearchProgramCaptures"), _count("SearchProgramReplays")
    for _ in range(2):
        np.testing.assert_array_equal(ts.phrase_counts_device(phrase).numpy(), want)
    if "absent" not in phrase:
        assert _count("SearchProgramReplays") - reps == 2
        assert _count("SearchProgramCaptures") - caps <= 1
        assert want.sum() > 0


def _leg(rng, nq, nq_pad, k, nseg):
    vals = np.sort(rng.standard_normal((nq_pad, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    rows = rng.integers(0, 40, (nq_pad, k)).astype(np.int32)
    tags = rng.integers(0, nseg, (nq_pad, k)).astype(np.int32)
    drop = rng.random((nq_pad, k)) < 0.2
    vals[drop], rows[drop], tags[drop] = -np.inf, -1, -1
    vals[nq:], rows[nq:], tags[nq:] = -np.inf, -1, -1
    return vals, tags, rows


@pytest.mark.parametrize("empty", ["none", "vector", "text", "both"])
@pytest.mark.parametrize("ftype", ["rrf", "rsf"])
def test_fuse_program_matches_jax(ftype, empty):
    """`fuse_legs` (one program) against JAX's `_fuse_device` on legs
    padded past nq, and with empty legs (SearchResult.empty)."""
    import jax.numpy as jnp
    from myscaledb_tpu.search import text_executor as jtext

    rng = np.random.default_rng(len(ftype) + len(empty))
    nq, k = 5, 6
    legs, ress = [], []
    for name, kl, seg_ids in (("vector", 12, np.array([0, 2])), ("text", 9, np.array([1, 2]))):
        if empty in (name, "both"):
            legs.append((np.full((nq, kl), -np.inf, np.float32), np.full((nq, kl), -1, np.int32),
                         np.full((nq, kl), -1, np.int32)))
            ress.append((SearchResult.empty(Metric.IP, nq, kl), np.zeros(0, np.int64)))
            continue
        v, tg, r = _leg(rng, nq, 8, kl, len(seg_ids))
        legs.append((v, tg, r))
        packed = executor.pack_result(torch.from_numpy(v), torch.from_numpy(tg),
                                      torch.from_numpy(r))
        ress.append((SearchResult(Metric.IP, device=packed, seg_ids=seg_ids, nq=nq, k=kl),
                     seg_ids))
    uni = np.unique(np.concatenate([ress[0][1], ress[1][1]]))
    if len(uni) == 0:
        uni = np.asarray([-1], np.int64)
    maps = [np.searchsorted(uni, ids).astype(np.int32) if len(ids) else np.asarray([-1], np.int32)
            for _, ids in ress]
    kw = dict(fusion_k=60, fusion_weight=0.3, vec_asc=False)
    jv, jt, jr = jtext._fuse_device(
        *(jnp.asarray(a) for a in legs[0]), jnp.asarray(maps[0]),
        *(jnp.asarray(a) for a in legs[1]), jnp.asarray(maps[1]),
        k=K, fusion_type=ftype, nq=nq, **kw)
    got = text_executor.fuse_legs(ress[0][0], ress[1][0], K, fusion_type=ftype, device="cpu",
                                  **kw)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(got.segments, np.where(jt >= 0, uni[np.maximum(jt, 0)], -1))
    np.testing.assert_array_equal(got.rows, np.asarray(jr))
    np.testing.assert_allclose(got.scores, np.asarray(jv), rtol=DENSE_RTOL, atol=0)
    if empty == "both":
        assert not got.valid.any()
    else:
        assert got.valid.any()


# ------------------------------------------------------------- the card
@pytest.fixture()
def cuda_table():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    db = tms.connect(device="cuda")
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "body": tms.String(),
                                         "vec": tms.FloatVector(8)}))
    t.add_fts_index("ft", "body")
    for c in _columns():
        t.insert(c)
    t.text_search("ft", "w1")
    yield t
    db.close()


def _replay_equals_body(prog, got):
    """The program's last inputs are still in its buffers: its body run
    eagerly on them gives the replay's bits."""
    with torch.cuda.device(prog.device):
        want = prog._call_body()
    torch.cuda.synchronize()
    assert prog.graph is not None and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("operator", ["OR", "AND"])
def test_text_replay_equals_its_body(cuda_table, operator):
    rng = np.random.default_rng(5)
    for qs in (_queries(rng, 9, 3), _queries(rng, 9, 8)):
        res = cuda_table.text_search("ft", qs, k=K, operator=operator)
        prog = cuda_table._programs.programs()[-1]  # the last one used
        _replay_equals_body(prog, res._packed)
        _pad_rows_empty(res)


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", ["rrf", "rsf"])
def test_hybrid_replay_equals_its_body(cuda_table, ftype):
    rng = np.random.default_rng(6)
    qv = rng.standard_normal((7, 8)).astype(np.float32)
    res = cuda_table.hybrid_search("vec", "ft", qv, _queries(rng, 7, 3), k=K, fusion_type=ftype)
    prog = text_executor._FUSE_PROGRAMS.programs()[-1]
    _replay_equals_body(prog, res._packed)


@pytest.mark.cuda
def test_phrase_replay_equals_its_body(cuda_table):
    store = cuda_table._text_indexes["ft"].store(0)
    got = store.phrase_counts_device(["alpha", "beta", "gamma"])
    prog = store._programs.programs()[-1]
    _replay_equals_body(prog, got)
    assert int(got[5]) == 1


@pytest.mark.cuda
def test_a_body_that_does_not_capture_raises(cuda_table, monkeypatch):
    """No eager fallback on the card: the capture's error names the
    stores' routes."""
    real = text_executor.store_topk

    def syncing(*a, **kw):
        out = real(*a, **kw)
        out[0].sum().item()
        return out

    monkeypatch.setattr(text_executor, "store_topk", syncing)
    cuda_table._programs.invalidate()
    with pytest.raises(RuntimeError, match="segment 0: BM25"):
        cuda_table.text_search("ft", ["w1 w2"], k=K)
