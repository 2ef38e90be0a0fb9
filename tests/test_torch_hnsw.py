"""The HNSW slice of the port (myscaledb_tpu_torch, on the CPU) against the
JAX package on the same data.

Sizes are small (n = 3,000-4,096, d = 128, m = 16-32), so the node-block
layout exists: the frontier expansion goes through
`gathermv.gather_block_scores` at every m and beam width, whose plain
version runs on CPU tensors. The JAX side runs its Pallas kernel in
interpret mode where its alignment gate lets it (m = 32, BEAM = 8), and
its einsum elsewhere.

Tolerances, per test:
  * codecs, dedup, window lists and the robust prune: equal outputs;
  * k-means fed JAX's own random draws: centroids within 1e-4;
  * a JAX-built index carried across (`hnsw_from_state_dict`) and searched
    by both: ids recall of port vs JAX >= 0.99, and the scores of shared
    rows within rtol 2e-4 / atol 2e-3 (tests/test_distance_ops.py's f32
    tolerance; only the order of the f32 sums differs). HNSWPQ alone, a
    deliberate divergence: ids recall >= 0.9, >= 0.99 of JAX's hits
    returned by the port or scoring no better than its k-th hit, and every
    other port hit scoring at least JAX's k-th (the port keeps a neighbour
    that two expanded nodes share once, so its pool holds rows JAX's
    second copy pushed out);
  * the port's own builds: recall@10 >= 0.9 against exact numpy, as
    tests/test_hnsw.py asks of the JAX package.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myscaledb_tpu_torch as tms
from myscaledb_tpu.index import hnsw as jhnsw
from myscaledb_tpu.index import ivf as jivf
from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.ops import kmeans as jkmeans
from myscaledb_tpu.ops import quantize as jquantize
from myscaledb_tpu.ops import topk as jtopk
from myscaledb_tpu.storage.schema import FloatVector as JFloatVector
from myscaledb_tpu.storage.schema import Schema as JSchema
from myscaledb_tpu.storage.schema import UInt64 as JUInt64
from myscaledb_tpu.storage.segment import Segment as JSegment

from myscaledb_tpu_torch.errors import IndexParameterError
from myscaledb_tpu_torch.index import hnsw, ivf
from myscaledb_tpu_torch.index.base import IndexStatus
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import gathermv, kmeans, quantize, topk
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.storage.convert import hnsw_from_state_dict
from myscaledb_tpu_torch.storage.schema import FloatVector, Schema, UInt64
from myscaledb_tpu_torch.storage.segment import Segment

D, M, EF_C, K = 128, 32, 100, 10
TOL = dict(rtol=2e-4, atol=2e-3)
METRICS = ["L2", "IP", "Cosine"]


def _blobs(seed, n, d=D, n_blobs=30, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = spread * rng.standard_normal((n_blobs, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, n_blobs, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return rng, vecs


def _queries(rng, vecs, nq, noise=0.3):
    pick = rng.choice(len(vecs), nq, replace=False)
    return (vecs[pick] + noise * rng.standard_normal((nq, vecs.shape[1]))).astype(np.float32)


def _exact_top(q, vecs, metric, k=K):
    if metric == "L2":
        s = -((q[:, None] - vecs[None]) ** 2).sum(-1)
    elif metric == "IP":
        s = q @ vecs.T
    else:
        s = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
            vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        ).T
    return np.argsort(-s, 1)[:, :k]


def _recall(rows, want):
    rows = np.asarray(rows)
    return sum(len(set(g.tolist()) & set(w.tolist())) for g, w in zip(rows, want)) / want.size


def _found_or_beaten(rows, vals, jrows, jvals):
    """Share of the JAX package's hits that the port returns too, or that
    score no better than the port's k-th hit (within TOL)."""
    found = 0
    for r, v, jr, jv in zip(rows, vals, jrows, jvals):
        kth = v[-1]
        for row, val in zip(jr.tolist(), jv.tolist()):
            found += row in set(r.tolist()) or val <= kth + TOL["atol"] + TOL["rtol"] * abs(kth)
    return found / jrows.size


def _port_payload(vecs):
    schema = Schema({"id": UInt64(), "vec": FloatVector(vecs.shape[1])})
    seg = Segment.from_columns(
        0, schema, {"id": np.arange(len(vecs), dtype=np.uint64), "vec": vecs}, device="cpu"
    )
    return seg.vector("vec")


def _pad_q(q, payload):
    return torch.nn.functional.pad(torch.from_numpy(q), (0, payload.data.shape[1] - q.shape[1]))


# ------------------------------------------------------------ device ops
def test_sq8_codes_equal():
    rng = np.random.default_rng(1)
    rep = (rng.standard_normal((500, 64)) * rng.uniform(0.1, 5, 64)).astype(np.float32)
    rep[:, 7] = 2.5  # a constant dimension: scale 1
    rep[::50] = np.round(rep[::50] * 4) / 4  # values on exact code boundaries
    lo_j, sc_j = jquantize.sq8_train_dev(jnp.asarray(rep))
    lo, sc = quantize.sq8_train_dev(torch.from_numpy(rep))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_j))
    codes_j = np.asarray(jquantize.sq8_encode_dev(jnp.asarray(rep), lo_j, sc_j))
    codes = quantize.sq8_encode_dev(torch.from_numpy(rep), lo, sc)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), codes_j)
    dec_j = np.asarray(jquantize.sq8_decode_dev(jnp.asarray(codes_j), lo_j, sc_j).astype(jnp.float32))
    dec = quantize.sq8_decode_dev(codes, lo, sc)
    assert dec.dtype == torch.bfloat16
    np.testing.assert_array_equal(dec.float().numpy(), dec_j)


@pytest.mark.parametrize("with_extra", [False, True])
def test_dedup_rows_equal(with_extra):
    rng = np.random.default_rng(2)
    rows = rng.integers(-1, 40, (6, 50)).astype(np.int32)
    vals = rng.standard_normal((6, 50)).astype(np.float32)
    extra = rng.random((6, 50)) < 0.5 if with_extra else None
    jv, jr, je = jtopk.dedup_rows(
        jnp.asarray(vals), jnp.asarray(rows), None if extra is None else jnp.asarray(extra)
    )
    tv, tr, te = topk.dedup_rows(
        torch.from_numpy(vals), torch.from_numpy(rows),
        None if extra is None else torch.from_numpy(extra),
    )
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if with_extra:
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    else:
        assert te is None and je is None


@pytest.mark.parametrize("limit", [None, 3])
def test_windows_for_probes_equal(limit):
    rng = np.random.default_rng(3)
    sizes = rng.integers(0, 1500, 40)
    sizes[[4, 17]] = 0  # empty clusters
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n_windows = -(-int(starts[-1]) // ivf.WINDOW)
    probe = np.stack([rng.choice(40, 6, replace=False) for _ in range(5)]).astype(np.int32)
    for budget in (4, 12, n_windows + 6):
        jw, jv = jivf.windows_for_probes(
            jnp.asarray(starts), jnp.asarray(probe), n_windows, budget,
            None if limit is None else jnp.int32(limit),
        )
        tw, tv = ivf.windows_for_probes(
            torch.from_numpy(starts), torch.from_numpy(probe), n_windows, budget, limit
        )
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_lloyd_update_equal():
    rng = np.random.default_rng(4)
    cents = rng.standard_normal((24, 16)).astype(np.float32)
    sums = rng.standard_normal((24, 16)).astype(np.float32) * 10
    counts = rng.integers(0, 9, 24).astype(np.float32)
    counts[[0, 5, 6, 23]] = 0  # empty clusters are reseeded from the largest
    want = np.asarray(jkmeans.lloyd_update(*(jnp.asarray(a) for a in (cents, sums, counts))))
    got = kmeans.lloyd_update(*(torch.from_numpy(a) for a in (cents, sums, counts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_extra", [0, 12])
def test_kmeans_fit_balanced_with_jax_draws(n_extra):
    """Given the JAX package's own initial draw, the fit is the same. The
    rows are 60 distinct points, each 20 times, so that no row lies within
    f32 rounding of a boundary between two centroids (the two packages sum
    in another order, and a boundary row could go either way)."""
    rng = np.random.default_rng(5)
    data = np.repeat(5.0 * rng.standard_normal((60, 16)), 20, axis=0).astype(np.float32)
    data = data[rng.permutation(len(data))]
    c, seed = 24, 0
    init = np.array(jax.random.permutation(jax.random.PRNGKey(seed), len(data))[:c])
    want = np.asarray(jkmeans.kmeans_fit_balanced(
        jnp.asarray(data), n_clusters=c, n_extra=n_extra, n_iters=10, seed=seed
    ))
    got = kmeans.kmeans_fit_balanced(
        torch.from_numpy(data), n_clusters=c, n_extra=n_extra, n_iters=10,
        init_idx=torch.from_numpy(init),
    )
    assert got.shape == (c + n_extra, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # assignment and the training sample given JAX's draws
    np.testing.assert_array_equal(
        kmeans.assign_chunked(torch.from_numpy(data), got, chunk=500).numpy(),
        np.asarray(jkmeans.assign_chunked(jnp.asarray(data), jnp.asarray(want), chunk=500)),
    )
    idx = np.array(jax.random.randint(jax.random.PRNGKey(seed), (1000,), 0, 1000))
    np.testing.assert_array_equal(
        kmeans.training_sample(torch.from_numpy(data), 1000, c, idx=torch.from_numpy(idx)).numpy(),
        np.asarray(jkmeans.training_sample(jnp.asarray(data), 1000, c, seed=seed)),
    )


def test_prune_chunk_equal():
    rng = np.random.default_rng(6)
    b, ck, d, m = 16, 65, 6, 32  # low d: the rule has candidates to prune
    node = rng.standard_normal((b, d)).astype(np.float32)
    cand = (node[:, None] + rng.standard_normal((b, ck, d))).astype(np.float32)
    dist = ((cand - node[:, None]) ** 2).sum(-1)
    order = np.argsort(dist, 1)
    cand = np.take_along_axis(cand, order[..., None], 1)
    rows = rng.permutation(10_000)[: b * ck].reshape(b, ck).astype(np.int32)
    rows[3, 40:] = -1  # invalid candidates
    cand[3, 40:] = 0.0
    want = np.asarray(jhnsw._prune_chunk(
        jnp.asarray(node), jnp.asarray(cand), jnp.asarray(rows), m, jhnsw.PRUNE_ALPHA
    ))
    got = hnsw._prune_chunk(
        torch.from_numpy(node), torch.from_numpy(cand), torch.from_numpy(rows), m, hnsw.PRUNE_ALPHA
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] >= 0).all() and (got >= 0).sum() < b * m  # the rule pruned some


# ------------------------------------------------- JAX index, both packages
def _jax_corpus():
    rng, vecs = _blobs(7, 4096)
    schema = JSchema({"id": JUInt64(), "vec": JFloatVector(D)})
    seg = JSegment.from_columns(0, schema, {"id": np.arange(len(vecs), dtype=np.uint64), "vec": vecs})
    return seg, vecs, _queries(rng, vecs, 16)


@pytest.fixture(scope="module")
def jax_corpus():
    return _jax_corpus()


PARITY_CASES = [("HNSWFLAT", m) for m in METRICS] + [("HNSWSQ", "L2"), ("HNSWPQ", "L2")]


def _carried_across(jax_corpus, kind, metric):
    """A JAX-built index carried across and searched by both packages at
    ef_s 64: (port scores, port rows, JAX scores, JAX rows)."""
    seg, vecs, q = jax_corpus
    jcls = {"HNSWFLAT": jhnsw.HNSWFlatIndex, "HNSWSQ": jhnsw.HNSWSQIndex,
            "HNSWPQ": jhnsw.HNSWPQIndex}[kind]
    jidx = jcls.build(
        seg.vector("vec"), len(vecs), metric=JMetric(metric), dim=D, params={"m": M, "ef_c": EF_C}
    )
    assert jidx.nbdata is not None and jidx.tproj is None
    jv, jr = (np.asarray(a) for a in jidx.search(jnp.asarray(q), K, params={"ef_s": 64}))
    tidx = hnsw_from_state_dict(jidx.state_dict(), "cpu")
    assert type(tidx).kind.value == kind and tidx.codec == jidx.codec
    assert tidx.data.dtype == (torch.bfloat16 if kind == "HNSWFLAT" else torch.uint8)
    assert tuple(tidx.nbdata.shape) == (len(vecs), M, D)
    np.testing.assert_array_equal(tidx.neighbors.numpy(), np.asarray(jidx.neighbors))
    tv, tr = (a.numpy() for a in tidx.search_t(torch.from_numpy(q), K, params=(("ef_s", 64),)))
    return tv, tr, jv, jr


@pytest.mark.parametrize("kind,metric", PARITY_CASES)
def test_jax_index_carried_across_searches_alike(jax_corpus, kind, metric):
    _, vecs, q = jax_corpus
    tv, tr, jv, jr = _carried_across(jax_corpus, kind, metric)
    pq = kind == "HNSWPQ"
    if pq:
        # the deliberate divergence (ROADMAP queue 3): with PQ's coarse
        # traversal scores, the room a shared neighbour's second copy took
        # in JAX's pool turns one hit of 10 of the 16 queries (150 of 160
        # shared); each JAX hit the port misses scores no better than the
        # port's k-th
        assert _recall(tr, jr) >= 0.9 and _found_or_beaten(tr, tv, jr, jv) >= 0.99
    else:
        assert _recall(tr, jr) >= 0.99
    shared = 0
    for i in range(len(q)):
        jmap = dict(zip(jr[i].tolist(), jv[i].tolist()))
        jkth = jv[i, -1]
        for r, v in zip(tr[i].tolist(), tv[i].tolist()):
            if r >= 0 and r in jmap:
                np.testing.assert_allclose(v, jmap[r], **TOL)
                shared += 1
            elif pq:  # a row JAX's pool had no room for
                assert v >= jkth - TOL["atol"] - TOL["rtol"] * abs(jkth)
    assert shared >= (0.9 if pq else 0.99) * q.shape[0] * K
    # both packages find the true neighbours (the SQ8 and PQ codecs re-score
    # codes; PQ at 32 subspaces of 4 dimensions loses more)
    assert _recall(tr, _exact_top(q, vecs, metric)) >= {"HNSWFLAT": 0.9, "HNSWSQ": 0.5,
                                                        "HNSWPQ": 0.4}[kind]


def _counting_kernel_route(monkeypatch):
    """Record the rows shape of every `gather_block_scores` call."""
    calls = []
    real = gathermv.gather_block_scores

    def counting(*a):
        calls.append(tuple(a[1].shape))
        return real(*a)

    monkeypatch.setattr(gathermv, "gather_block_scores", counting)
    return calls


@pytest.mark.parametrize("m", [16, 48])
def test_jax_index_any_m_through_the_kernel_route(jax_corpus, monkeypatch, m):
    """Where the JAX package's alignment gate sends its search to an einsum
    (m % 32 != 0), the port still scores every frontier iteration through
    `gather_block_scores`, and both packages find the same rows: ids
    recall of port vs JAX >= 0.99."""
    seg, vecs, q = jax_corpus
    jidx = jhnsw.HNSWFlatIndex.build(
        seg.vector("vec"), len(vecs), metric=JMetric.L2, dim=D, params={"m": m, "ef_c": EF_C}
    )
    assert jidx.nbdata is not None
    _, jr = (np.asarray(a) for a in jidx.search(jnp.asarray(q), K, params={"ef_s": 64}))
    tidx = hnsw_from_state_dict(jidx.state_dict(), "cpu")
    calls = _counting_kernel_route(monkeypatch)
    _, tr = tidx.search_t(torch.from_numpy(q), K, params=(("ef_s", 64),))
    assert len(calls) == hnsw.n_iterations(64) and calls[0] == (len(q), hnsw.BEAM)
    assert _recall(tr.numpy(), jr) >= 0.99


@pytest.mark.parametrize("ef_s,k", [(5, 5), (1, 3)])
def test_beam_narrower_than_8_through_the_kernel_route(monkeypatch, ef_s, k):
    """At max(ef_s, k) < 8 the beam narrows to that width (the JAX package
    cannot search there: its top_k takes 8 of a narrower frontier). Every
    frontier iteration still goes through `gather_block_scores`; every
    query gets k distinct live rows (a neighbour that two expanded nodes
    share enters the 2·ef-row result pool once, so the final dedup leaves
    k), whose scores are their exact f32 scores (rtol 2e-4 / atol 2e-3),
    and recall@k against exact numpy is >= 0.8."""
    rng, vecs = _blobs(14, 3000)
    payload = _port_payload(vecs)
    idx = hnsw.HNSWFlatIndex.build(payload, len(vecs), metric=Metric.L2, dim=D, params={"m": M})
    q = _queries(rng, vecs, 16)
    calls = _counting_kernel_route(monkeypatch)
    v, r = idx.search_t(_pad_q(q, payload), k, params=(("ef_s", ef_s),))
    ef = max(ef_s, k)
    assert len(calls) == hnsw.n_iterations(ef) and calls[0] == (16, ef)
    r, v = r.numpy(), v.numpy()
    assert (r >= 0).all() and all(len(set(row.tolist())) == k for row in r)
    stored = payload.data[: len(vecs), :D].float().numpy()[r]  # [Q, k, D]
    exact = 2.0 * np.einsum("qd,qkd->qk", q, stored) - (stored**2).sum(-1)
    np.testing.assert_allclose(v, exact, **TOL)
    assert _recall(r, _exact_top(q, vecs, "L2", k)) >= 0.8


@pytest.mark.parametrize("ef_s,k", [(5, 5), (16, 10)])
@pytest.mark.parametrize("route", ["node_blocks", "rows"])
def test_shared_neighbour_enters_pool_and_frontier_once(monkeypatch, route, ef_s, k):
    """Every node gets the same m neighbours, so the nodes one iteration
    expands all share them. Each shared row must enter the result pool and
    the frontier once (the final cut's input, pool ∪ frontier, is read
    through `dedup_rows`), and every query gets k distinct live rows, on
    the gathermv route and on the route without node blocks."""
    rng, vecs = _blobs(15, 3000)
    payload = _port_payload(vecs)
    idx = hnsw.HNSWFlatIndex.build(payload, len(vecs), metric=Metric.L2, dim=D, params={"m": M})
    shared = torch.from_numpy(rng.choice(len(vecs), M, replace=False).astype(np.int32))
    idx.neighbors = shared.expand(idx.neighbors.shape[0], M).contiguous()
    if route == "rows":
        idx.nbdata = idx.nbaux = None
    else:
        safe = idx.neighbors.to(torch.int64)
        idx.nbdata = idx.tdata[safe]
        idx.nbaux = None if idx.taux is None else idx.taux[safe]
    pools = []
    real = hnsw.dedup_rows

    def recording(vals, rows, extra):
        pools.append(rows.clone())
        return real(vals, rows, extra)

    monkeypatch.setattr(hnsw, "dedup_rows", recording)
    q = _queries(rng, vecs, 8)
    v, r = idx.search_t(_pad_q(q, payload), k, params=(("ef_s", ef_s),))
    ef = max(ef_s, k)
    rp = 2 * ef
    pool, frontier = pools[-1][:, :rp].numpy(), pools[-1][:, rp:].numpy()
    assert frontier.shape[1] == ef
    for part in (pool, frontier):
        for row in part:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)
    # the shared rows reached the pool (the expansions found them)
    assert np.isin(pool, shared.numpy()).any(1).all()
    r = r.numpy()
    assert (r >= 0).all() and all(len(set(row.tolist())) == k for row in r)


def test_build_estimate_matches_jax(jax_corpus):
    seg, vecs, _ = jax_corpus
    payload = _port_payload(vecs)
    for params in ({}, {"m": 16}, {"m": 32, "ef_c": 60}):
        assert hnsw.HNSWFlatIndex.estimate_build_bytes(payload, len(vecs), params) == (
            jhnsw.HNSWFlatIndex.estimate_build_bytes(seg.vector("vec"), len(vecs), params)
        )


# ------------------------------------------------------ the port's builds
@pytest.mark.parametrize("metric", METRICS)
def test_own_build_recall_through_the_kernel_route(metric, monkeypatch):
    rng, vecs = _blobs(8, 3000)
    payload = _port_payload(vecs)
    idx = hnsw.HNSWFlatIndex.build(
        payload, len(vecs), metric=Metric(metric), dim=D, params={"m": M, "ef_c": EF_C}
    )
    assert idx.nbdata is not None and gathermv.supports(D)
    calls = []
    real = gathermv.gather_block_scores

    def counting(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(gathermv, "gather_block_scores", counting)
    q = _queries(rng, vecs, 16)
    v, r = idx.search_t(_pad_q(q, payload), K, params=(("ef_s", 100),))
    assert len(calls) == hnsw.n_iterations(100) and calls[0] == (16, hnsw.BEAM)
    assert _recall(r, _exact_top(q, vecs, metric)) >= 0.9
    for row in r.numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    assert (torch.diff(v, dim=1) <= 0).all()  # best first


def test_rows_wider_than_the_kernel_takes_route_on_row_gathers(monkeypatch):
    """Node blocks wider than the gathermv kernel takes (Dt > MAX_DT) are
    not built, and the frontier gathers rows instead: the search never
    calls the kernel's wrapper and still finds each row's own vector."""
    d = gathermv.MAX_DT + 1  # padded to 12,416
    rng = np.random.default_rng(15)
    vecs = rng.standard_normal((600, d)).astype(np.float32)
    payload = _port_payload(vecs)
    assert not gathermv.supports(payload.data.shape[1])
    idx = hnsw.HNSWFlatIndex.build(payload, len(vecs), metric=Metric.L2, dim=d, params={"m": 4})
    assert idx.nbdata is None and idx.tproj is None
    assert hnsw.HNSWFlatIndex.estimate_build_bytes(payload, len(vecs), {"m": 4}) == (
        4 * 600 * 12_416 + 2 * payload.nbytes + 600 * 12_416
    )
    calls = _counting_kernel_route(monkeypatch)
    _, r = idx.search_t(_pad_q(vecs[:4], payload), 1, params=(("ef_s", 16),))
    assert calls == [] and r[:, 0].tolist() == [0, 1, 2, 3]


def test_hnswsq_build_recall():
    rng, vecs = _blobs(9, 3000)
    payload = _port_payload(vecs)
    idx = hnsw.HNSWSQIndex.build(
        payload, len(vecs), metric=Metric.L2, dim=D, params={"m": M, "ef_c": 60}
    )
    assert idx.data.dtype == torch.uint8 and idx.codec == "sq8"
    q = vecs[rng.choice(len(vecs), 8, replace=False)]
    _, r = idx.search_t(_pad_q(q, payload), K, params=(("ef_s", 100),))
    assert _recall(r, _exact_top(q, vecs, "L2")) >= 0.5  # codec-limited, as in JAX


def test_connectivity_repair_isolated_clusters():
    """Well-separated clusters build near-clique components; every node
    must be reachable from the entries and a query in every blob finds it."""
    rng = np.random.default_rng(10)
    n_blobs, per, d, k = 40, 50, 24, 5
    centers = 50.0 * rng.standard_normal((n_blobs, d)).astype(np.float32)
    vecs = np.repeat(centers, per, axis=0) + 0.1 * rng.standard_normal((n_blobs * per, d)).astype(
        np.float32
    )
    n = len(vecs)
    payload = _port_payload(vecs)
    idx = hnsw.HNSWFlatIndex.build(payload, n, metric=Metric.L2, dim=d, params={"m": 8, "ef_c": 40})
    neighbors = idx.neighbors.numpy()
    seen = np.zeros(n, bool)
    dq = deque(int(e) for e in idx.entry_rows.numpy() if 0 <= e < n)
    for e in list(dq):
        seen[e] = True
    while dq:
        u = dq.popleft()
        for v in neighbors[u]:
            if v >= 0 and not seen[v]:
                seen[v] = True
                dq.append(int(v))
    assert seen.all(), f"{(~seen).sum()} nodes unreachable from entries"
    _, r = idx.search_t(_pad_q(centers, payload), k, params=(("ef_s", 50),))
    r = r.numpy()
    for b in range(n_blobs):
        got = r[b][r[b] >= 0]
        assert len(got) and (got // per == b).any(), f"blob {b} unreachable"


def test_entries_and_rerank_params():
    """`entries` widens the entry set; `rerank` widens the exact re-score
    pool, and the chunked re-score (pool wider than the transient cap)
    loses nothing."""
    rng, vecs = _blobs(11, 3000)
    payload = _port_payload(vecs)
    idx = hnsw.HNSWFlatIndex.build(payload, len(vecs), metric=Metric.L2, dim=D, params={"m": M})
    q = _pad_q(vecs[:8], payload)
    want = _exact_top(vecs[:8], vecs, "L2")
    _, r1 = idx.search_t(q, K, params=(("ef_s", 64),))
    _, r2 = idx.search_t(q, K, params=(("entries", 64), ("ef_s", 64)))
    assert (r1[:, 0].numpy() == np.arange(8)).all() and (r2[:, 0].numpy() == np.arange(8)).all()
    _, r3 = idx.search_t(q, K, params=(("ef_s", 64), ("rerank", 64)))
    _, r4 = idx.search_t(q, K, params=(("ef_s", 64), ("rerank", 512)))
    assert _recall(r4, want) >= _recall(r3, want)
    old = hnsw.RESCORE_TRANSIENT_CAP
    try:
        hnsw.RESCORE_TRANSIENT_CAP = 8 * 128 * D * 4  # step = 128
        _, r5 = idx.search_t(q, K, params=(("ef_s", 64), ("rerank", 513)))
    finally:
        hnsw.RESCORE_TRANSIENT_CAP = old
    assert _recall(r5, want) >= _recall(r3, want)
    for row in r5.numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_state_dict_roundtrip_and_mask():
    rng, vecs = _blobs(12, 3000)
    payload = _port_payload(vecs)
    idx = hnsw.HNSWFlatIndex.build(payload, len(vecs), metric=Metric.IP, dim=D, params={"m": M})
    idx2 = hnsw.HNSWFlatIndex.from_state_dict(idx.state_dict(), device="cpu")
    q = _pad_q(vecs[:4], payload)
    torch.testing.assert_close(idx2.search_t(q, 5), idx.search_t(q, 5), rtol=0, atol=0)
    allowed = rng.choice(len(vecs), 300, replace=False)
    mask = torch.zeros(payload.data.shape[0], dtype=torch.bool)
    mask[allowed] = True
    _, r = idx.search_t(q, 5, mask=mask, params=(("ef_s", 128),))
    r = r.numpy()
    assert (r >= 0).sum() > 0 and np.isin(r[r >= 0], allowed).all()
    assert idx.memory_bytes > idx.nbdata.numel()


# ---------------------------------------------------------- table level
def _table(n=3000, metric="Cosine", **settings):
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 1000
    for k, v in settings.items():
        setattr(st.query, k, v)
    db = tms.connect(st, device="cpu")
    t = db.create_table("h", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    rng, vecs = _blobs(13, n)
    t.insert({"id": np.arange(n, dtype=np.uint64), "vec": vecs})
    t.add_vector_index("h", "vec", type="HNSWFLAT", m=M, ef_c=EF_C, metric_type=metric)
    assert t.wait_index_built()  # connect()'s database builds in the background
    return t, rng, vecs


def _bumps(fn):
    names = ("VectorIndexSearches", "VectorBruteForceSearches", "VectorIndexFallbackToFlat",
             "VectorIndexCostRouteToScan")
    before = {n: GLOBAL_COUNTERS.get(n) for n in names}
    out = fn()
    return out, {n: GLOBAL_COUNTERS.get(n) - before[n] for n in names}


def test_index_lifecycle_add_insert_drop():
    t, rng, vecs = _table()
    assert t.index_status("h") == {0: IndexStatus.LOADED}
    assert t.wait_index_built(1.0)
    assert t.index_metric_for("vec") == Metric.COSINE  # the index's metric wins
    t.insert({"id": np.arange(3000, 3500, dtype=np.uint64), "vec": vecs[:500]})  # small part
    t.insert({"id": np.arange(3500, 4700, dtype=np.uint64), "vec": vecs[:1200]})
    assert t.wait_index_built()
    assert t.index_status("h") == {0: IndexStatus.LOADED, 1: IndexStatus.SMALL_PART,
                                   2: IndexStatus.LOADED}
    events = [e["event"] for e in t.event_log.rows()]
    assert events.count("BuildSucceed") == 2 and events.count("WillNotBuild") == 1
    assert t.loaded_index(0, "vec", Metric.COSINE) is not None
    assert t.loaded_index(0, "vec", Metric.L2) is None  # another metric scans
    with pytest.raises(IndexParameterError):
        t.add_vector_index("h2", "vec", type="HNSWFLAT")  # one index per column
    t.drop_vector_index("h")
    assert t.index_status("h") == {} and t.loaded_index(0, "vec", Metric.COSINE) is None
    q = _queries(rng, vecs, 4)
    _, bumps = _bumps(lambda: t.search("vec", q, k=K, metric="Cosine"))
    assert bumps["VectorIndexSearches"] == 0 and bumps["VectorBruteForceSearches"] == 3


@pytest.mark.parametrize("kind", ["HNSWPQ", "IVFFLAT", "IVFSQ", "IVFPQ", "MSTG"])
def test_pq_and_ivf_kinds_build_and_search(kind):
    """The kinds that waited for IVF search and the PQ codec build through
    add_vector_index and answer through the index. The IVF kinds report
    exact distances (IVFFLAT scans the raw rows, the others re-rank
    exactly); HNSWPQ re-scores its PQ codes."""
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 1000
    st.query.cost_based_index_routing = False
    db = tms.connect(st, device="cpu")
    t = db.create_table("u", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    rng, vecs = _blobs(16, 3000)
    t.insert({"id": np.arange(3000, dtype=np.uint64), "vec": vecs})
    params = dict(m=M, ef_c=60) if kind == "HNSWPQ" else dict(ncentroids=32)
    t.add_vector_index("i", "vec", type=kind, metric_type="L2", **params)
    assert t.wait_index_built()
    assert t.index_status("i") == {0: IndexStatus.LOADED}
    idx = t.loaded_index(0, "vec", Metric.L2)
    assert type(idx).kind.value == kind
    assert idx.codec == {"HNSWPQ": "pq", "IVFFLAT": "raw", "IVFSQ": "sq8", "IVFPQ": "pq",
                         "MSTG": "sq8"}[kind]
    q = _queries(rng, vecs, 16)
    sp = {"ef_s": 100} if kind == "HNSWPQ" else {"nprobe": 8}
    res, bumps = _bumps(lambda: t.search("vec", q, k=K, params=sp))
    assert bumps["VectorIndexSearches"] == 1 and bumps["VectorBruteForceSearches"] == 0
    assert (res.rows >= 0).all() and (np.diff(res.distances, axis=1) >= 0).all()
    stored = torch.from_numpy(vecs).to(torch.bfloat16).float().numpy()
    recall = _recall(res.rows, _exact_top(q, stored, "L2"))
    if kind == "HNSWPQ":
        # codec-limited: 32 subspaces of 4 dimensions, 256 codewords each
        assert recall >= 0.4
    else:
        assert recall >= (0.8 if kind == "IVFPQ" else 0.9)  # 40 PQ-ranked candidates re-ranked
        # each hit's score is its stored row's exact f32 score
        x = stored[res.rows]
        exact = 2.0 * np.einsum("qd,qkd->qk", q, x) - (x * x).sum(-1)
        np.testing.assert_allclose(res.scores, exact, **TOL)
    db.close()


def test_table_search_routes_and_counters():
    t, rng, vecs = _table()
    q = _queries(rng, vecs, 16)
    want = _exact_top(q, vecs, "Cosine")
    stored = torch.from_numpy(vecs).to(torch.bfloat16).float().numpy()  # what the scan scores
    graph = tms.Settings()
    graph.query.cost_based_index_routing = False
    res, bumps = _bumps(lambda: t.search("vec", q, k=K, params={"ef_s": 100}, settings=graph))
    assert bumps["VectorIndexSearches"] == 1 and bumps["VectorBruteForceSearches"] == 0
    assert _recall(res.rows, want) >= 0.9
    assert np.isfinite(res.distances).all() and (np.diff(res.distances, axis=1) >= 0).all()
    # the default routes this small segment to the exact scan by the cost model
    seg = t.live_segments()[0]
    idx = t.loaded_index(0, "vec", Metric.COSINE)
    assert idx.prefer_exact_scan(16, K, (), int(seg.vector("vec").nbytes))
    res, bumps = _bumps(lambda: t.search("vec", q, k=K))
    assert bumps["VectorIndexCostRouteToScan"] == 1 and bumps["VectorBruteForceSearches"] == 1
    assert _recall(res.rows, _exact_top(q, stored, "Cosine")) == 1.0
    with pytest.raises(IndexParameterError):
        t.search("vec", q, k=K, params={"nprobe": 4})


def test_table_filtered_search_and_deletes():
    t, rng, vecs = _table(metric="L2", cost_based_index_routing=False)
    q = _queries(rng, vecs, 16)
    flt = tms.F("id") < 1500
    res, bumps = _bumps(lambda: t.search("vec", q, k=K, filter=flt, params={"ef_s": 100}))
    assert bumps["VectorIndexSearches"] == 1
    ids = t.gather(res, ["id"])["id"]
    assert (res.rows >= 0).all() and (ids < 1500).all()
    assert _recall(res.rows, _exact_top(q, vecs[:1500], "L2")) >= 0.9
    # an over-selective filter falls back to the exact masked scan
    res, bumps = _bumps(lambda: t.search("vec", q, k=K, filter=tms.F("id") < 20))
    assert bumps["VectorIndexFallbackToFlat"] == 1 and bumps["VectorIndexSearches"] == 0
    assert (t.gather(res, ["id"])["id"] < 20).all()
    np.testing.assert_array_equal(
        np.sort(res.rows, 1), np.sort(_exact_top(q, vecs[:20], "L2"), 1)
    )
    # deleted rows never come back from the graph
    nearest = sorted({int(i) for i in t.gather(
        t.search("vec", q, k=K, params={"ef_s": 100}), ["id"])["id"][:, :3].ravel()})
    assert t.delete(tms.F("id").isin(nearest)) == len(nearest)
    res, bumps = _bumps(lambda: t.search("vec", q, k=K, params={"ef_s": 100}))
    assert bumps["VectorIndexSearches"] == 1
    assert not set(t.gather(res, ["id"])["id"].ravel().tolist()) & set(nearest)


if __name__ == "__main__":
    # the readings the parity test holds to its limits, per kind:
    # PYTHONPATH=. python tests/test_torch_hnsw.py
    jax.config.update("jax_platforms", "cpu")
    corpus = _jax_corpus()
    for kind, metric in PARITY_CASES:
        tv, tr, jv, jr = _carried_across(corpus, kind, metric)
        shared = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(tr, jr))
        exact = _exact_top(corpus[2], corpus[1], metric)
        print(f"{kind} {metric} at ef_s 64: ids shared with JAX {shared} of {jr.size}, JAX hits "
              f"found or beaten {_found_or_beaten(tr, tv, jr, jv):.4f}; recall@{K} against exact "
              f"numpy: port {_recall(tr, exact):.4f}, JAX {_recall(jr, exact):.4f}")
