"""MeshTable's programs: the port's counterparts of the JAX package's
`shard_map` programs under `jax.jit` (parallel/distributed.py: the sharded
scan, IVF, two-stage and BM25 bodies, the merge, the fuse, the fused
steps), on the CPU.

Every MeshTable search is one program (parallel/distributed.py::
MeshProgram) of the table's caches; on the CPU it runs its body eagerly
through the same static buffers a captured CUDA graph replays on the card.
These tests hold, on grids of eight `cpu` entries (query axis 1 and 2):

  * each route's program output bit for bit to the same search composed
    eagerly from the public `distributed_*` functions (exact, filtered,
    IVF, two-stage, IVF + delta, BM25, hybrid RRF / RSF), also split into
    a graph a grid entry (the path of a grid over several cards);
  * the same routes to the JAX MeshTable (the virtual 8-device mesh of
    tests/conftest.py): ids equal (the inputs have no ties where vectors
    are scored; BM25 ties break by slot on both), scores within rtol 2e-4
    / atol 2e-3;
  * in-place inserts and deletes read by the next replay with no
    recapture, and the programs each reseal, index build and text-index
    rebuild drops (the `SearchProgram*` counters);
  * `make_full_step` as a program against the eager step bit for bit and
    against the JAX step.

The JAX package is imported inside the tests, so the card tests (marker
`cuda`) run where JAX is absent:
`python -m pytest --noconftest tests/test_torch_mesh_programs.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.parallel import distributed as dist
from myscaledb_tpu_torch.parallel.distributed import Mesh, make_mesh
from myscaledb_tpu_torch.parallel.mesh_table import MeshTable, _merge_topk
from myscaledb_tpu_torch.search.fusion import rrf_fuse_t, rsf_fuse_t
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.storage.convert import mesh_indexes_from_arrays

TOL = dict(rtol=2e-4, atol=2e-3)
N, N0, NEW, D, K = 8_000, 6_000, 500, 32, 10
NPROBE = 8
CUT = 200  # the filter: price < CUT


def _corpus():
    rng = np.random.default_rng(0xB10C)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    ids = np.arange(N, dtype=np.int64) * 7
    price = rng.integers(0, 1000, N).astype(np.int32)
    words = np.array(["alpha", "beta", "gamma", "delta", "omega"])
    body = np.array([" ".join(rng.choice(words, 3)) + f" doc{i}" for i in range(N)], dtype=object)
    rows = np.concatenate([[5, 77, 1234, 500], rng.choice(N0, 12, replace=False)])
    q = (vecs[rows] + 0.05 * rng.standard_normal((16, D))).astype(np.float32)
    texts = ["doc91", "alpha beta", "gamma", "doc182 omega", "delta doc7", "beta", "omega alpha",
             "doc5 gamma delta"] * 2
    return ids, vecs, price, body, q, texts


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _cols(corpus, lo, hi):
    ids, vecs, price, body, _, _ = corpus
    return {"id": ids[lo:hi], "vec": vecs[lo:hi], "price": price[lo:hi], "body": body[lo:hi]}


def _table(corpus, mesh, name="p", n=N0):
    t = MeshTable(name, D, mesh=mesh, filter_columns=("price",), text_column="body")
    t.insert(_cols(corpus, 0, n))
    return t


def _cheap(price):
    return price < CUT


def _index_np(t):
    """A JAX table's `_ivf` / `_mstg` as numpy (bf16 stays bf16)."""
    idx = t._ivf if t._ivf is not None else t._mstg
    return tuple(np.asarray(a) for a in idx[:-1]) + (int(idx[-1]),)


@pytest.fixture(scope="module")
def jref(corpus):
    """The JAX MeshTable on the same rows: exact and filtered; IVF (32
    clusters, exported) at NPROBE, then NEW rows appended (the delta
    route); the two-stage index (32 clusters, exported); BM25 and hybrid
    RRF / RSF."""
    from myscaledb_tpu.parallel.mesh_table import MeshTable as JMeshTable

    _, _, _, _, q, texts = corpus
    t = JMeshTable("j", D, filter_columns=("price",), text_column="body")
    t.insert(_cols(corpus, 0, N0))
    out = {"exact": t.search(q, K), "filtered": t.search(q, K, filter=_cheap),
           "text": t.text_search(texts, K)}
    t.build_ivf(ncentroids=32)
    out["ivf_index"] = _index_np(t)
    out["ivf"] = t.search(q, K, params={"nprobe": NPROBE})
    t.insert(_cols(corpus, N0, N0 + NEW))
    out["delta"] = t.search(q, K, params={"nprobe": NPROBE}, filter=_cheap)
    out["rrf"] = t.hybrid_search(q, texts, K, params={"nprobe": NPROBE})
    t.build_mstg(ncentroids=32)
    out["mstg_index"] = _index_np(t)
    out["mstg"] = t.search(q, K, params={"nprobe": NPROBE, "num_reorder": 64})
    out["rsf"] = t.hybrid_search(q, texts, K, fusion_type="rsf", fusion_weight=0.5)
    return out


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **TOL)


# ------------------------------------------------------------ eager paths
def _eager_vector(t, q, *, filter=None, params=None):
    """The vector search composed from the public eager functions, as
    MeshTable ran it before its programs: (scores, slot rows) [Qpad, k]."""
    s = t._s
    mesh = t.mesh
    mask = list(s.alive)
    if filter is not None:
        mask = [torch.logical_and(a, filter(price=s.cols["price"][d])) for d, a in enumerate(mask)]
    qp, _ = t._queries_host(q)
    qt = torch.from_numpy(qp)
    nprobe = int((params or {}).get("nprobe", 0))
    v = None
    if t._mstg is not None and nprobe:
        cents, csq, lo, scale, pcodes, psq, prows, cstart, bpad = t._mstg
        v, r = dist.distributed_twostage_topk(
            mesh, qt, cents, csq, lo, scale, pcodes, psq, prows, cstart, s.data, s.aux, k=K,
            nprobe=nprobe, num_reorder=int(params.get("num_reorder", 0)) or max(4 * K, 64),
            bucket_pad=bpad, rows_per_shard=s.cap, mask=mask)
    elif t._ivf is not None and nprobe:
        cents, csq, pdata, paux, prows, cstart, bpad = t._ivf
        v, r = dist.distributed_ivf_topk(mesh, qt, cents, csq, pdata, paux, prows, cstart, k=K,
                                         nprobe=nprobe, bucket_pad=bpad, rows_per_shard=s.cap,
                                         mask=mask)
    if v is None:
        return dist.distributed_scan_topk(mesh, qt, s.data, s.aux, k=K, metric=t.metric,
                                          rows_per_shard=s.cap, mask=mask)
    if (s.fill > t._ivf_fill).any():
        dm = [torch.logical_and(m, x) for m, x in zip(mask, t._delta_mask)]
        dv, dr = dist.distributed_scan_topk(mesh, qt, s.data, s.aux, k=K, metric=t.metric,
                                            rows_per_shard=s.cap, mask=dm)
        v, r = _merge_topk(v, r, dv, dr, K)
    return v, r


def _eager_text(t, texts, nq_pad):
    """BM25 from `distributed_bm25_topk_batch` over a plan made here, the
    batch padded with empty queries to `nq_pad` rows."""
    ti = t._text_index()
    s = t._s
    texts = list(texts) + [""] * (nq_pad - len(texts))
    terms = [list(dict.fromkeys(ti.shards[0].analyzer.tokenize(x))) for x in texts]
    T = max(4, 1 << max(0, (max(len(x) for x in terms) - 1).bit_length()))
    S, Q = t.n_shards, len(texts)
    starts, lengths = np.zeros((S, Q, T), np.int32), np.zeros((S, Q, T), np.int32)
    idfs = np.zeros((Q, T), np.float32)
    longest = 1
    for qi, ws in enumerate(terms):
        for tj, w in enumerate(ws):
            idfs[qi, tj] = ti.stats.idf(w)
            for sh, ix in enumerate(ti.shards):
                starts[sh, qi, tj], lengths[sh, qi, tj] = ix.term_range(w)
                longest = max(longest, int(lengths[sh, qi, tj]))
    budget = min(max(128, 1 << (longest - 1).bit_length()), ti.budget_cap)
    return dist.distributed_bm25_topk_batch(
        t.mesh, dist.shard_rows(t.mesh, starts), dist.shard_rows(t.mesh, lengths),
        dist.replicate(t.mesh, idfs), dist.replicate(t.mesh, np.float32(ti.stats.avg_doc_len)),
        ti.prow, ti.ptf, ti.dlen, list(s.alive), k=K, budget=budget, rows_per_shard=s.cap)


def _eager_hybrid(t, q, texts, ftype, params=None):
    vv, vr = _eager_vector(t, q, params=params)
    tv, tr = _eager_text(t, texts, vv.shape[0])

    def tags(r):
        return torch.where(r >= 0, 0, -1).to(torch.int32)

    if ftype == "rsf":
        fv, _, fr = rsf_fuse_t(tags(vr), vr, vv, tags(tr), tr, tv, K, fusion_weight=0.5,
                               vec_ascending_better=False)
    else:
        fv, _, fr = rrf_fuse_t(tags(vr), vr, tags(tr), tr, K, fusion_k=60)
    return fv, fr


def _bits(packed, v, r):
    """The program's packed [2, Qpad, k] output equals (v, r) bit for bit."""
    assert torch.equal(packed[0], v.contiguous().view(torch.int32))
    assert torch.equal(packed[1], r)


def _routes(t, corpus):
    """Each route's program output beside its eager composition."""
    _, _, _, _, q, texts = corpus
    ivf = {"nprobe": NPROBE}
    out = {"exact": (t._vector_run(q, K)[0], _eager_vector(t, q)),
           "filtered": (t._vector_run(q, K, filter=_cheap)[0], _eager_vector(t, q, filter=_cheap)),
           "text": (t._text_run(texts, K)[0], _eager_text(t, texts, 16))}
    t.build_ivf(ncentroids=32)
    out["ivf"] = (t._vector_run(q, K, params=ivf)[0], _eager_vector(t, q, params=ivf))
    t.insert(_cols(corpus, N0, N0 + NEW))
    out["delta"] = (t._vector_run(q, K, filter=_cheap, params=ivf)[0],
                    _eager_vector(t, q, filter=_cheap, params=ivf))
    run = dict(filter=None, params=ivf, fusion_k=60, fusion_weight=0.5)
    out["rrf"] = (t._hybrid_run(q, texts, K, fusion_type="rrf", **run)[0],
                  _eager_hybrid(t, q, texts, "rrf", ivf))
    t.build_mstg(ncentroids=32)
    two = {"nprobe": NPROBE, "num_reorder": 64}
    out["mstg"] = (t._vector_run(q, K, params=two)[0], _eager_vector(t, q, params=two))
    run["params"] = None
    out["rsf"] = (t._hybrid_run(q, texts, K, fusion_type="rsf", **run)[0],
                  _eager_hybrid(t, q, texts, "rsf"))
    return out


ROUTES = ["exact", "filtered", "text", "ivf", "delta", "rrf", "mstg", "rsf"]


@pytest.fixture(scope="module", params=[1, 2], ids=["query_axis1", "query_axis2"])
def routes(request, corpus):
    return _routes(_table(corpus, make_mesh(8, query_axis=request.param, device="cpu")), corpus)


@pytest.mark.parametrize("route", ROUTES)
def test_program_equals_eager_body(routes, route):
    packed, (v, r) = routes[route]
    _bits(packed, v, r)


@pytest.fixture(scope="module")
def split_routes(corpus):
    """The routes with a graph a grid entry (query group, shard): the
    GridProgram path a grid over several cards takes (each part's output
    copied onto the first entry's graph; a query group off the data row
    copies its shards' operands in)."""
    real = dist._graph_key
    dist._graph_key = lambda mesh, qi, d: (qi, d)
    try:
        t = _table(corpus, make_mesh(8, query_axis=2, device="cpu"), "split")
        out = _routes(t, corpus)
        parts = {len(p.parts) for p in t._programs.programs()}
    finally:
        dist._graph_key = real
    return out, parts


@pytest.mark.parametrize("route", ROUTES)
def test_grid_split_equals_eager_body(split_routes, route):
    out, parts = split_routes
    assert parts == {8}  # 2 query groups x 4 shards
    _bits(out[route][0], *out[route][1])


# ------------------------------------------------------------- vs JAX
@pytest.fixture(scope="module")
def port(corpus):
    """The port's table on the JAX test's mesh (8 data shards), searched
    on the same routes, each index the JAX table's installed."""
    _, _, _, _, q, texts = corpus
    t = _table(corpus, make_mesh(8, device="cpu"), "pj")
    return t, q, texts


def _ids(t, packed, nq):
    h = packed.numpy()[:, :nq]
    v = np.ascontiguousarray(h[0]).view(np.float32)
    return t._ids_of(h[1], v), v


def test_routes_match_jax(port, jref, corpus):
    t, q, texts = port
    _same(t.search(q, K), jref["exact"])
    _same(t.search(q, K, filter=_cheap), jref["filtered"])
    _same(t.text_search(texts, K), jref["text"])
    mesh_indexes_from_arrays(t, ivf=jref["ivf_index"])
    _same(t.search(q, K, params={"nprobe": NPROBE}), jref["ivf"])
    t.insert(_cols(corpus, N0, N0 + NEW))
    _same(t.search(q, K, params={"nprobe": NPROBE}, filter=_cheap), jref["delta"])
    _same(t.hybrid_search(q, texts, K, params={"nprobe": NPROBE}), jref["rrf"])
    mesh_indexes_from_arrays(t, mstg=jref["mstg_index"])
    _same(t.search(q, K, params={"nprobe": NPROBE, "num_reorder": 64}), jref["mstg"])
    _same(t.hybrid_search(q, texts, K, fusion_type="rsf", fusion_weight=0.5), jref["rsf"])


# -------------------------------------------------------- invalidation
def _captures():
    return GLOBAL_COUNTERS.get("SearchProgramCaptures")


def test_in_place_mutations_need_no_recapture(corpus):
    ids, vecs, price, body, q, _ = corpus
    t = _table(corpus, make_mesh(8, device="cpu"), "inplace", n=4_000)
    t.build_ivf(ncentroids=16)
    t.insert(_cols(corpus, 4_000, 4_100))  # the delta route from here on
    p = {"nprobe": 4}
    first, _ = t.search(q, K, params=p)
    c0, sealed = _captures(), t._s
    # a delete of every first hit, and a row planted at each query
    t.delete(first[:, 0])
    t.insert({"id": np.arange(10**6, 10**6 + 16), "vec": q, "price": price[:16],
              "body": body[:16]})
    got, _ = t.search(q, K, params=p)
    assert t._s is sealed and _captures() == c0
    np.testing.assert_array_equal(got[:, 0], np.arange(10**6, 10**6 + 16))
    assert not np.isin(first[:, 0], got).any()
    # the same on the exact route, filtered
    t.search(q, K, filter=_cheap)
    c1 = _captures()
    t.delete(np.arange(10**6, 10**6 + 16))
    got, _ = t.search(q, K, filter=_cheap)
    assert _captures() == c1 and (got >= 0).all() and not (got >= 10**6).any()


@pytest.mark.parametrize("change", ["reseal", "build_ivf", "build_mstg", "text_rebuild"])
def test_each_change_drops_the_programs_it_invalidates(corpus, change):
    ids, vecs, price, body, q, texts = corpus
    t = _table(corpus, make_mesh(8, device="cpu"), "drop", n=2_000)
    t.text_search(texts, K)  # first: building the text index drops every program
    t.search(q, K)
    t.hybrid_search(q, texts, K)
    old = t._s.data[0]
    assert sorted(key[0] for key in t._programs._entries) == ["hybrid", "text", "vector"]
    if change == "reseal":
        t.insert(_cols(corpus, 2_000, N))  # past the slack: the next search reseals
    elif change == "text_rebuild":
        t.insert(_cols(corpus, 2_000, 2_100))  # in the slack: the text index goes stale
    else:
        getattr(t, change)(ncentroids=16)
    c0 = _captures()
    t.search(q, K)
    vector_captures = _captures() - c0
    t.text_search(texts, K)
    text_captures = _captures() - c0 - vector_captures
    t.hybrid_search(q, texts, K)
    hybrid_captures = _captures() - c0 - vector_captures - text_captures
    # one cache: a change drops every program; a text rebuild drops them at
    # the text search that makes it, after the vector search has replayed
    want = (0, 1, 1) if change == "text_rebuild" else (1, 1, 1)
    assert (vector_captures, text_captures, hybrid_captures) == want
    # after a reseal or an insert the text search rebuilds the text index,
    # which drops the vector program made before it
    kinds = ["hybrid", "text"] + ([] if change in ("reseal", "text_rebuild") else ["vector"])
    assert sorted(key[0] for key in t._programs._entries) == kinds
    assert (t._s.data[0] is old) == (change != "reseal")


# -------------------------------------------------------- fused steps
def _step_inputs(mesh, rng):
    """The dry run's full-step operands (tests/test_torch_mesh_dryrun.py)
    at 256 rows a shard."""
    s = mesh.shape["data"]
    rps, d, c, nq = 256, 64, 16, 16
    n = rps * s
    x = rng.standard_normal((n, d)).astype(np.float32)
    aux = np.sum(x.astype(np.float64) ** 2, axis=1).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    nc, bucket = 8, rps // 8
    ivf = {f: [] for f in ("cents", "csq", "pdata", "paux", "prows", "cstart")}
    for sh in range(s):
        rows = x[sh * rps : (sh + 1) * rps]
        assign = np.arange(rps) % nc
        order = np.argsort(assign, kind="stable").astype(np.int32)
        cents = np.stack([rows[assign == ci].mean(0) for ci in range(nc)]).astype(np.float32)
        ivf["cents"].append(cents)
        ivf["csq"].append((cents**2).sum(1).astype(np.float32))
        ivf["pdata"].append(rows[order])
        ivf["paux"].append((rows[order].astype(np.float64) ** 2).sum(1).astype(np.float32))
        ivf["prows"].append(order)
        ivf["cstart"].append(np.concatenate([[0], np.cumsum(np.bincount(assign))]).astype(np.int32))
    doc_terms = rng.integers(0, 16, size=(n, 4))
    df = np.array([int((doc_terms == t).any(1).sum()) for t in range(16)])
    idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5)).astype(np.float32)[[1, 5, 11]]
    width = rps * 4 + 64 + 256
    st, ln = np.zeros((s, 3), np.int32), np.zeros((s, 3), np.int32)
    prow, ptf = np.zeros((s, width), np.int32), np.zeros((s, width), np.float32)
    for sh in range(s):
        local = doc_terms[sh * rps : (sh + 1) * rps]
        cur = 0
        for j, t in enumerate((1, 5, 11)):
            tf = (local == t).sum(1)
            hit = np.nonzero(tf)[0]
            st[sh, j], ln[sh, j] = cur, len(hit)
            prow[sh, cur : cur + len(hit)], ptf[sh, cur : cur + len(hit)] = hit, tf[hit]
            cur += len(hit)
    arrays = dict(q=q, x=x, aux=aux, c0=x[:c], st=st, ln=ln, idf=idf, avg=np.float32(4.0),
                  prow=prow, ptf=ptf, dlen=np.full((s, rps), 4.0, np.float32),
                  **{f"ivf_{k}": np.stack(v) for k, v in ivf.items()})
    return arrays, dict(k=8, rows_per_shard=rps, nprobe=nc, bucket_pad=bucket, bm25_budget=256)


def _step_args(pkg, mesh, a):
    shard, rep = pkg.shard_rows, pkg.replicate
    return (a["q"], shard(mesh, a["x"]), shard(mesh, a["aux"]), rep(mesh, a["c0"]),
            shard(mesh, a["ivf_cents"]), shard(mesh, a["ivf_csq"]), shard(mesh, a["ivf_pdata"]),
            shard(mesh, a["ivf_paux"]), shard(mesh, a["ivf_prows"]), shard(mesh, a["ivf_cstart"]),
            shard(mesh, a["st"]), shard(mesh, a["ln"]), rep(mesh, a["idf"]), rep(mesh, a["avg"]),
            shard(mesh, a["prow"]), shard(mesh, a["ptf"]), shard(mesh, a["dlen"]))


def _eager_full_step(mesh, args, *, k, rows_per_shard, nprobe, bucket_pad, bm25_budget):
    """The full step composed from the public eager functions."""
    (q, x, aux, c0, ic, icsq, ipd, ipa, ipr, ics, st, ln, idf, avg, prow, ptf, dl) = args
    cents = dist.sharded_lloyd_step(mesh, x, c0)
    ev, er = dist.distributed_scan_topk(mesh, q, x, aux, k=k, metric=Metric.L2,
                                        rows_per_shard=rows_per_shard)
    iv, ir = dist.distributed_ivf_topk(mesh, q, ic, icsq, ipd, ipa, ipr, ics, k=k, nprobe=nprobe,
                                       bucket_pad=bucket_pad, rows_per_shard=rows_per_shard)
    tv, tr = dist.distributed_bm25_topk(mesh, st, ln, idf, avg, prow, ptf, dl, k=k,
                                        budget=bm25_budget, rows_per_shard=rows_per_shard)
    tr_b = tr.expand(ir.shape[0], tr.shape[-1])
    fv, _, fr = rrf_fuse_t(torch.where(ir >= 0, 0, -1), ir, torch.where(tr_b >= 0, 0, -1), tr_b,
                           k)
    return ev, er, iv, ir, tv, tr, fv, fr, cents


@pytest.mark.parametrize("query_axis", [1, 2])
def test_full_step_program(query_axis):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from myscaledb_tpu.metrics import Metric as JMetric
    from myscaledb_tpu.parallel import distributed as jdist

    mesh = make_mesh(8, query_axis=query_axis, device="cpu")
    a, static = _step_inputs(mesh, np.random.default_rng(4))
    args = _step_args(dist, mesh, a)
    step = dist.make_full_step(mesh, metric=Metric.L2, **static)
    got = step(torch.from_numpy(a["q"]), *args[1:])
    want = _eager_full_step(mesh, (torch.from_numpy(a["q"]),) + args[1:], **static)
    for g, w in zip(got[:8], want[:8]):
        assert torch.equal(g, w)
    assert torch.equal(got[8][0], want[8][0])
    c0 = _captures()
    again = step(torch.from_numpy(a["q"]), *args[1:])  # the same tensors: a replay
    assert _captures() == c0 and len(step.programs) == 1
    assert all(torch.equal(g, w) for g, w in zip(again[:8], got[:8]))

    jmesh = jdist.make_mesh(8, query_axis=query_axis)
    jargs = _step_args(jdist, jmesh, a)
    jstep = jdist.make_full_step(jmesh, metric=JMetric.L2, **static)
    jout = [np.asarray(jax.device_get(o[0] if isinstance(o, (list, tuple)) else o)) for o in
            jstep(jax.device_put(a["q"], NamedSharding(jmesh, P("query", None))), *jargs[1:])]
    ev, er, iv, ir, tv, tr, fv, fr, cents = (
        (o[0] if isinstance(o, list) else o).numpy() for o in got)
    np.testing.assert_array_equal(np.sort(er, 1), np.sort(jout[1], 1))
    np.testing.assert_allclose(ev, jout[0], **TOL)
    np.testing.assert_allclose(np.sort(iv, 1), np.sort(jout[2], 1), atol=1e-2)
    np.testing.assert_allclose(np.sort(tv[0]), np.sort(jout[4][0]), atol=1e-3)
    np.testing.assert_allclose(np.sort(fv, 1), np.sort(jout[6], 1), atol=1e-6)
    np.testing.assert_allclose(cents, jout[8], rtol=1e-5, atol=1e-5)


def test_train_and_search_step_program():
    mesh = make_mesh(8, query_axis=2, device="cpu")
    a, static = _step_inputs(mesh, np.random.default_rng(9))
    x, aux, c0 = (dist.shard_rows(mesh, a["x"]), dist.shard_rows(mesh, a["aux"]),
                  dist.replicate(mesh, a["c0"]))
    step = dist.make_train_and_search_step(mesh, k=8, metric=Metric.L2, rows_per_shard=256)
    q = torch.from_numpy(a["q"])
    v, r, cents = step(q, x, aux, c0)
    ev, er = dist.distributed_scan_topk(mesh, q, x, aux, k=8, metric=Metric.L2,
                                        rows_per_shard=256)
    assert torch.equal(v, ev) and torch.equal(r, er)
    assert torch.equal(cents[0], dist.sharded_lloyd_step(mesh, x, c0)[0])
    # an operand written in place is read by the replay
    x[1][:] = 0
    c1 = _captures()
    v2, r2, _ = step(q, x, aux, c0)
    ev2, er2 = dist.distributed_scan_topk(mesh, q, x, aux, k=8, metric=Metric.L2,
                                          rows_per_shard=256)
    assert _captures() == c1 and torch.equal(v2, ev2) and torch.equal(r2, er2)


# ------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def cuda_table():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = _table(_corpus(), Mesh([[torch.device("cuda", 0)] * 4]), "card")
    t.search(_corpus()[4], K)
    return t


def _replay_equals_body(prog, got):
    """The one-card program's last inputs are still in its buffers: its
    body run eagerly on them gives the replay's bits."""
    (part,) = prog.parts
    with torch.cuda.device(part.device):
        want = part._call_body()
    torch.cuda.synchronize()
    assert part.graph is not None and torch.equal(got.reshape(-1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["exact", "filtered", "ivf", "delta", "mstg", "text", "rrf",
                                   "rsf"])
def test_card_replay_equals_its_body(cuda_table, route):
    corpus = _corpus()
    t, q, texts = cuda_table, corpus[4], corpus[5]
    p = {"nprobe": NPROBE}
    if route in ("ivf", "delta") and t._ivf is None:
        t.build_ivf(ncentroids=32)
    if route == "delta" and not (t._s.fill > t._ivf_fill).any():
        t.insert(_cols(corpus, N0, N0 + NEW))
    if route == "mstg":
        t.build_mstg(ncentroids=32)
    if route in ("text", "rrf", "rsf"):
        got = (t._text_run(texts, K)[0] if route == "text" else
               t._hybrid_run(q, texts, K, filter=None, params=None, fusion_k=60,
                             fusion_type=route, fusion_weight=0.5)[0])
    else:
        got = t._vector_run(q, K, filter=_cheap if route in ("filtered", "delta") else None,
                            params=None if route in ("exact", "filtered") else p)[0]
    _replay_equals_body(t._programs.programs()[-1], got)  # the last one used


@pytest.mark.cuda
def test_card_body_that_syncs_raises_at_capture(cuda_table, monkeypatch):
    """No eager fallback on the card: the capture's error names the
    table and the route."""
    real = dist.scan_topk_t

    def syncing(*a, **kw):
        out = real(*a, **kw)
        out[0].sum().item()
        return out

    monkeypatch.setattr(dist, "scan_topk_t", syncing)
    cuda_table._programs.invalidate()
    with pytest.raises(RuntimeError, match="MeshTable 'card': exact search"):
        cuda_table.search(_corpus()[4], K)
