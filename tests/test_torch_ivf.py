"""The IVF slice of the port (myscaledb_tpu_torch, on the CPU) against the
JAX package on the same data: k-means, the device PQ codec, window masks,
the IVFFLAT / IVFSQ / IVFPQ / MSTG indexes and the executor's two-stage
path.

Sizes are small (n <= 20,000, d <= 64, ncentroids <= 64). The IVF family
has no Pallas kernel, so the JAX side runs as its own tests run it.

Tolerances, per test:
  * k-means and PQ codebooks fed JAX's own random draws: within 1e-4;
    codes, codeword norms and decoded rows: equal;
  * a window mask: equal to the row-space mask permuted into the layout;
  * a JAX-built index carried across (`segment_from_arrays` +
    `ivf_from_state_dict` + `reattach_payload`) and searched by both with
    the executor's nprobe convention (the pow2 bucket sizes the probe
    list, the actual nprobe masks the probes past it): equal ids (the data
    are continuous random draws, free of ties) and scores within rtol 2e-4 /
    atol 2e-3 (tests/test_distance_ops.py:37; only the order of the f32
    sums differs);
  * the port's own builds: the JAX package's recall floors
    (tests/test_quantized_indexes.py:71-95).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.index import ivf as jivf
from myscaledb_tpu.index.base import split_dyn_nprobe as jsplit
from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.ops import kmeans as jkmeans
from myscaledb_tpu.ops import quantize as jquantize
from myscaledb_tpu.search import executor as jexecutor
from myscaledb_tpu.storage.schema import FloatVector as JFloatVector
from myscaledb_tpu.storage.schema import Int32 as JInt32
from myscaledb_tpu.storage.schema import Schema as JSchema
from myscaledb_tpu.storage.schema import UInt64 as JUInt64
from myscaledb_tpu.storage.segment import Segment as JSegment

from myscaledb_tpu_torch.index import ivf
from myscaledb_tpu_torch.index.base import IndexStatus, split_dyn_nprobe
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import kmeans, quantize
from myscaledb_tpu_torch.search import executor
from myscaledb_tpu_torch.search.filters import WindowMask, as_mask_array
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.storage.convert import ivf_from_state_dict, segment_from_arrays
from myscaledb_tpu_torch.storage.schema import FloatVector, Int32, Schema, UInt64
from myscaledb_tpu_torch.storage.segment import Segment

TOL = dict(rtol=2e-4, atol=2e-3)
K = 10
D, N, NQ, NCENT = 32, 8_000, 16, 32
KINDS = {
    "IVFFLAT": (jivf.IVFFlatIndex, ivf.IVFFlatIndex, {}),
    "IVFSQ": (jivf.IVFSQIndex, ivf.IVFSQIndex, {}),
    "IVFPQ": (jivf.IVFPQIndex, ivf.IVFPQIndex, {"M": 8}),
    "MSTG": (jivf.MSTGIndex, ivf.MSTGIndex, {}),
}
CARRIED = [("IVFFLAT", m) for m in ("L2", "IP", "Cosine")] + [
    ("IVFSQ", "L2"), ("IVFPQ", "L2"), ("MSTG", "Cosine")]


def _recall(rows, want):
    rows = np.asarray(rows)
    return sum(len(set(g.tolist()) & set(w.tolist())) for g, w in zip(rows, want)) / want.size


def _blobs(seed, n, d, n_blobs=40, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = spread * rng.standard_normal((n_blobs, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, n_blobs, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return rng, vecs


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


# ------------------------------------------------------------ device ops
def _repeated_points(seed, n_points, reps, d):
    """`n_points` distinct points, each `reps` times, shuffled: no row lies
    within f32 rounding of a boundary between two centroids, so the two
    packages (which sum in another order) assign every row alike."""
    rng = np.random.default_rng(seed)
    data = np.repeat(5.0 * rng.standard_normal((n_points, d)), reps, axis=0).astype(np.float32)
    return data[rng.permutation(len(data))]


def test_kmeans_fit_with_jax_draws():
    data = _repeated_points(21, 60, 20, 16)
    c, seed = 24, 3
    init = np.array(jax.random.permutation(jax.random.PRNGKey(seed), len(data))[:c])
    want = np.asarray(jkmeans.kmeans_fit(jnp.asarray(data), n_clusters=c, n_iters=10, seed=seed))
    got = kmeans.kmeans_fit(torch.from_numpy(data), n_clusters=c, n_iters=10,
                            init_idx=torch.from_numpy(init))
    assert got.shape == (c, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bits", [4, 5])
def test_pq_codec_with_jax_draws(bits):
    """pq_train_dev given JAX's draw per subspace (seed + j) gives JAX's
    codebooks; codes, codeword norms and decoded rows are then equal."""
    rep = _repeated_points(22, 60, 20, D)
    m, seed = 8, 0
    ksub = 1 << bits
    draws = [torch.from_numpy(np.array(
        jax.random.permutation(jax.random.PRNGKey(seed + j), len(rep))[:ksub])) for j in range(m)]
    want = np.asarray(jquantize.pq_train_dev(jnp.asarray(rep), m, bits=bits, seed=seed))
    books = quantize.pq_train_dev(torch.from_numpy(rep), m, bits=bits, init_idx=draws)
    assert books.shape == (m, ksub, D // m)
    np.testing.assert_allclose(books.numpy(), want, rtol=0, atol=1e-4)
    # the rest on JAX's own codebooks, so the comparison is exact
    books = torch.from_numpy(np.array(want))
    codes_j = np.asarray(jquantize.pq_encode_dev(jnp.asarray(rep), jnp.asarray(want)))
    codes = quantize.pq_encode_dev(torch.from_numpy(rep), books)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), codes_j)
    np.testing.assert_array_equal(
        quantize.pq_codeword_sqnorms(books).numpy(),
        np.asarray(jquantize.pq_codeword_sqnorms(jnp.asarray(want))))
    dec_j = np.asarray(jquantize.pq_decode_dev(jnp.asarray(codes_j), jnp.asarray(want)))
    dec = quantize.pq_decode_dev(codes, books)
    assert dec.dtype == torch.bfloat16 and dec.shape == (len(rep), D)
    np.testing.assert_array_equal(dec.float().numpy(), dec_j.astype(np.float32))
    cbn = np.asarray(jquantize.pq_codeword_sqnorms(jnp.asarray(want)))
    np.testing.assert_array_equal(  # JAX's IVF build sums them the same way
        quantize.pq_decoded_sqnorms(codes, books).numpy(),
        np.asarray(jnp.sum(jnp.take_along_axis(cbn.T, codes_j.astype(np.int32), axis=0), axis=1)))


def test_pq_train_fewer_rows_than_codewords():
    """With fewer rows than 2^bits each subspace fits N centroids and
    repeats its last one, as the JAX package does."""
    rep = np.random.default_rng(23).standard_normal((100, 8)).astype(np.float32)
    books = quantize.pq_train_dev(torch.from_numpy(rep), 4, bits=8)
    assert books.shape == (4, 256, 2)
    assert (books[:, 100:] == books[:, 99:100]).all()


# ------------------------------------------------------------ window masks
def _port_segment(vecs, tags, storage_dtype=torch.bfloat16):
    schema = Schema({"id": UInt64(), "tag": Int32(), "vec": FloatVector(vecs.shape[1])})
    return Segment.from_columns(
        0, schema,
        {"id": np.arange(len(vecs), dtype=np.uint64), "tag": tags, "vec": vecs},
        device="cpu", storage_dtype=storage_dtype,
    )


@pytest.fixture
def port_ivf():
    rng, vecs = _blobs(24, 3_000, D)
    tags = rng.integers(0, 10, len(vecs)).astype(np.int32)
    seg = _port_segment(vecs, tags)
    idx = ivf.IVFFlatIndex.build(seg.vector("vec"), len(vecs), metric=Metric.L2, dim=D,
                                 params={"ncentroids": 16})
    return seg, idx


FILTERS = {
    "cmp": lambda F: F("id") < 2500,
    "and_not_in": lambda F: (F("id") >= 1000) & ~F("tag").isin([2, 5]),
    "or": lambda F: (F("tag") == 3) | (F("id") < 300),
}


@pytest.mark.parametrize("deletes", [False, True], ids=["no_deletes", "deletes"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_window_mask_is_the_row_mask_permuted(port_ivf, name, deletes):
    """WindowMask.build() equals the row-space DeviceMask permuted by
    perm_rows, on a miss and on the cache hit that follows; a delete
    (a new mutation generation) misses and builds anew."""
    seg, idx = port_ivf
    expr = FILTERS[name](tms.F)
    live = idx.perm_rows >= 0
    perm = torch.clamp(idx.perm_rows, min=0).to(torch.int64)

    def check(expect_hit):
        dm = executor.segment_mask(seg, expr)
        assert type(dm).__name__ == "DeviceMask"
        before = {c: GLOBAL_COUNTERS.get(c) for c in ("IvfWindowMaskBuilds", "IvfWindowMaskCacheHits")}
        wm = idx.to_window_mask(dm, seg)
        assert isinstance(wm, WindowMask) and wm.skel[0] == "prebuilt"
        hit = GLOBAL_COUNTERS.get("IvfWindowMaskCacheHits") - before["IvfWindowMaskCacheHits"]
        built = GLOBAL_COUNTERS.get("IvfWindowMaskBuilds") - before["IvfWindowMaskBuilds"]
        assert (hit, built) == ((1, 0) if expect_hit else (0, 1))
        got = wm.build()
        assert got.shape == idx.perm_rows.shape
        want = dm.build()[perm]
        assert torch.equal(got[live], want[live])
        with pytest.raises(TypeError, match="row-space"):
            as_mask_array(wm)
        return got

    if deletes:
        seg.delete_rows(np.arange(7, 3_000, 97))
    first = check(expect_hit=False)
    assert check(expect_hit=True) is first
    seg.delete_rows(np.arange(3, 3_000, 53))  # a new mutation generation
    check(expect_hit=False)


def test_window_mask_unbuilt_and_unkeyed():
    """A mask leaf the cache cannot key (a constant held as a tensor) gives
    an unbuilt WindowMask over the mirrors; it builds to the same bitmap."""
    rng, vecs = _blobs(25, 3_000, D)
    seg = _port_segment(vecs, rng.integers(0, 10, len(vecs)).astype(np.int32))
    idx = ivf.IVFFlatIndex.build(seg.vector("vec"), len(vecs), metric=Metric.L2, dim=D,
                                 params={"ncentroids": 16})
    dm = executor.segment_mask(seg, tms.F("id") < 1234)
    dm.leaves[-1] = torch.tensor(1234, dtype=torch.int64)
    wm = idx.to_window_mask(dm, seg)
    assert isinstance(wm, WindowMask) and wm.skel[0] == "root"
    live = idx.perm_rows >= 0
    got = wm.build()[live]
    assert torch.equal(got, (idx.perm_rows[live] < 1234))


# ------------------------------------------------- JAX index, both packages
@pytest.fixture(scope="module")
def carried_corpus():
    """One JAX segment (bf16 payload), its port twin over the same bytes,
    the twin with deletes, the queries and the filter."""
    rng, vecs = _blobs(26, N, D)
    tags = rng.integers(0, 10, N).astype(np.int32)
    schema = JSchema({"id": JUInt64(), "tag": JInt32(), "vec": JFloatVector(D)})
    jseg = JSegment.from_columns(
        0, schema, {"id": np.arange(N, dtype=np.uint64), "tag": tags, "vec": vecs})
    deleted = np.zeros(jseg.capacity, bool)
    deleted[np.arange(5, N, 13)] = True
    jp = jseg.vector("vec")
    tschema = Schema({"id": UInt64(), "tag": Int32(), "vec": FloatVector(D)})

    def twin(dels):
        return segment_from_arrays(
            0, tschema, n_rows=N, capacity=jseg.capacity,
            vectors={"vec": {"data": np.asarray(jp.data).view(np.uint16),
                             "sqnorm": np.asarray(jp.sqnorm), "invnorm": np.asarray(jp.invnorm)}},
            scalars={c: jseg.scalar(c) for c in ("id", "tag")}, device="cpu", deleted=dels)

    q = (vecs[rng.choice(N, NQ, replace=False)] + 0.3 * rng.standard_normal((NQ, D))).astype(np.float32)
    ids = np.arange(jseg.capacity)
    tag_full = np.zeros(jseg.capacity, np.int32)
    tag_full[:N] = tags
    row_mask = (ids < N) & ~deleted & (ids < 6_000) & (tag_full != 3)
    return dict(jseg=jseg, plain=twin(None), deleted=twin(deleted), q=q,
                row_mask=row_mask, vecs=vecs)


_JAX_INDEXES = {}


def _jax_index(corpus, kind, metric):
    key = (kind, metric)
    if key not in _JAX_INDEXES:
        jcls, _, extra = KINDS[kind]
        _JAX_INDEXES[key] = jcls.build(
            corpus["jseg"].vector("vec"), N, metric=JMetric(metric), dim=D,
            params={"ncentroids": NCENT, **extra})
    return _JAX_INDEXES[key]


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "filter_and_deletes"])
@pytest.mark.parametrize("nprobe", [1, 3, 8])
@pytest.mark.parametrize("kind,metric", CARRIED)
def test_jax_index_carried_across_searches_alike(carried_corpus, kind, metric, nprobe, masked):
    """The JAX package searches with a row-space mask; the port with the
    WindowMask of the same predicate (filter ∩ deletes), or none."""
    c = carried_corpus
    jidx = _jax_index(c, kind, metric)
    seg = c["deleted"] if masked else c["plain"]
    tidx = ivf_from_state_dict(jidx.state_dict(), "cpu", seg.vector("vec"))
    assert type(tidx).kind.value == kind and tidx.codec == jidx.codec
    assert tidx.two_stage == (kind != "IVFFLAT") and (tidx.raw_data is None) == (kind == "IVFFLAT")
    assert tidx.memory_bytes == jidx.memory_bytes
    dpad = seg.vector("vec").data.shape[1]
    qpad = np.pad(c["q"], ((0, 0), (0, dpad - D)))
    pkey, dyn = jsplit((("nprobe", nprobe),))
    assert split_dyn_nprobe((("nprobe", nprobe),)) == (pkey, dyn)
    jmask = tmask = None
    if masked:
        jmask = jnp.asarray(c["row_mask"])
        dm = executor.segment_mask(seg, (tms.F("id") < 6_000) & (tms.F("tag") != 3))
        tmask = tidx.to_window_mask(dm, seg)
        assert isinstance(tmask, WindowMask)
    jv, jr = (np.asarray(a) for a in jidx.search_t(
        jnp.asarray(qpad), K, mask=jmask, params=pkey, dyn_nprobe=dyn))
    tv, tr = (a.numpy() for a in tidx.search_t(
        torch.from_numpy(qpad), K, mask=tmask, params=pkey, dyn_nprobe=dyn))
    np.testing.assert_array_equal(tr, jr)
    live = jr >= 0
    np.testing.assert_array_equal(np.isfinite(tv), live)
    np.testing.assert_allclose(tv[live], jv[live], **TOL)
    if masked:
        assert c["row_mask"][tr[live]].all()
    if nprobe == 8:  # enough probes that every query fills its k
        assert live.all()


def test_two_stage_index_without_payload_raises(carried_corpus):
    """A two-stage index loaded from a state dict has no segment payload:
    its search raises instead of serving quantized distances."""
    c = carried_corpus
    state = _jax_index(c, "MSTG", "Cosine").state_dict()
    assert "raw_data" not in state["arrays"]
    tidx = ivf_from_state_dict(state, "cpu")
    q = torch.zeros((2, c["plain"].vector("vec").data.shape[1]))
    with pytest.raises(RuntimeError, match="reattach_payload"):
        tidx.search_t(q, K, params=(("nprobe", 4),))
    v, r = tidx.search_first_stage(q, 40, params={"nprobe": 4})  # the codes alone need no payload
    assert v.shape == r.shape == (2, 40)
    with pytest.raises(RuntimeError, match="reattach_payload"):
        tidx.compute_scores_subset(q, r)
    before = tidx.memory_bytes
    tidx.reattach_payload(c["plain"].vector("vec"))
    assert tidx.raw_data is c["plain"].vector("vec").data and tidx.memory_bytes == before
    assert tidx.search_t(q, K, params=(("nprobe", 4),))[0].shape == (2, K)


def test_state_dict_roundtrip_port_build():
    rng, vecs = _blobs(27, 4_000, D)
    seg = _port_segment(vecs, rng.integers(0, 10, len(vecs)).astype(np.int32))
    p = seg.vector("vec")
    q = torch.nn.functional.pad(torch.from_numpy(vecs[:5]), (0, p.data.shape[1] - D))
    for kind in KINDS:
        _, cls, extra = KINDS[kind]
        idx = cls.build(p, len(vecs), metric=Metric.L2, dim=D, params={"ncentroids": 16, **extra})
        idx2 = ivf_from_state_dict(idx.state_dict(), "cpu", p)
        assert type(idx2) is cls
        for a, b in zip(idx.search_t(q, 5, params=(("nprobe", 8),)),
                        idx2.search_t(q, 5, params=(("nprobe", 8),))):
            assert torch.equal(a, b)


# ------------------------------------------------------ the port's builds
@pytest.mark.parametrize("kind", ["IVFSQ", "IVFPQ", "MSTG"])
def test_own_build_meets_the_jax_floors(kind):
    """tests/test_quantized_indexes.py's floors at its sizes: IVFSQ >= 0.85,
    MSTG >= 0.95, IVFPQ >= its ADC oracle - 0.05."""
    rng = np.random.default_rng(0)
    n, d, nq = 20_000, 32, 16
    centers = 8.0 * rng.standard_normal((40, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 40, n)] + rng.standard_normal((n, d))).astype(np.float32)
    seg = _port_segment(vecs, np.zeros(n, np.int32), storage_dtype=torch.float32)
    _, cls, _ = KINDS[kind]
    params = {"ncentroids": 64, **({"M": 16} if kind == "IVFPQ" else {})}
    idx = cls.build(seg.vector("vec"), n, metric=Metric.L2, dim=d, params=params)
    q = (vecs[rng.choice(n, nq, replace=False)] + 0.1 * rng.standard_normal((nq, d))).astype(np.float32)
    qp = torch.nn.functional.pad(torch.from_numpy(q), (0, seg.vector("vec").data.shape[1] - d))
    want = _exact_top(q, vecs, "L2")
    _, r = idx.search_t(qp, K, params=(("nprobe", 32),))
    rec = _recall(r.numpy(), want)
    if kind == "IVFPQ":
        dec = quantize.pq_decode_dev(quantize.pq_encode_dev(torch.from_numpy(vecs), idx.codec_a),
                                     idx.codec_a).float().numpy()
        ideal = _recall(np.argsort(-(2 * q @ dec.T - (dec**2).sum(1)[None]), 1)[:, :K], want)
        assert rec >= ideal - 0.05, f"PQ recall {rec} below ADC oracle {ideal}"
    else:
        assert rec >= (0.95 if kind == "MSTG" else 0.85), f"{kind} recall {rec}"


def test_default_pq_m_and_alpha():
    assert [ivf._default_pq_m(d) for d in (128, 960, 100, 24, 7)] == [
        jivf._default_pq_m(d) for d in (128, 960, 100, 24, 7)] == [32, 32, 4, 8, 1]
    rng, vecs = _blobs(28, 3_000, D)
    seg = _port_segment(vecs, np.zeros(3_000, np.int32))
    idx = ivf.MSTGIndex.build(seg.vector("vec"), 3_000, metric=Metric.L2, dim=D,
                              params={"ncentroids": 64})
    assert idx._nprobe((("alpha", 2),)) == 2 * ivf.DEFAULT_NPROBE
    assert idx._nprobe((("alpha", 2), ("nprobe", 5))) == 5
    assert idx._nprobe((("nprobe", 10_000),)) == idx.n_clusters
    assert idx._nprobe(()) == ivf.DEFAULT_NPROBE


# ---------------------------------------------------------- table level
def _tables(kind="MSTG", n_small=600, **index_params):
    """A JAX table and a port table over the same two inserts (a large
    segment with the index and a small one that is scanned); the port's
    index is the JAX one, loaded from its state dict."""
    rng, vecs = _blobs(29, N + n_small, D)
    tags = rng.integers(0, 10, len(vecs)).astype(np.int32)
    parts = [slice(0, N), slice(N, N + n_small)]
    tables = []
    for ms, min_rows in ((jms, 1_000), (tms, 10 * N)):
        st = ms.Settings()
        st.table.min_rows_to_build_vector_index = min_rows
        db = ms.connect(st) if ms is jms else ms.connect(st, device="cpu")
        t = db.create_table("t", ms.Schema({"id": ms.UInt64(), "tag": ms.Int32(),
                                             "vec": ms.FloatVector(D)}))
        for p in parts:
            t.insert({"id": np.arange(len(vecs), dtype=np.uint64)[p], "tag": tags[p], "vec": vecs[p]})
        t.add_vector_index("i", "vec", type=kind, ncentroids=NCENT, **index_params)
        assert t.wait_index_built()
        tables.append((db, t))
    (jdb, jt), (tdb, tt) = tables
    assert tt.index_status("i") == {0: IndexStatus.SMALL_PART, 1: IndexStatus.SMALL_PART}
    jidx = jt.loaded_index(0, "vec", JMetric.L2)
    loaded = tt.load_index("i", 0, jidx.state_dict())
    assert tt.index_status("i")[0] == IndexStatus.LOADED
    assert loaded.two_stage == (kind != "IVFFLAT")
    if loaded.two_stage:
        assert loaded.raw_data is tt.live_segments()[0].vector("vec").data
    q = (vecs[rng.choice(N, NQ, replace=False)] + 0.3 * rng.standard_normal((NQ, D))).astype(np.float32)
    return jt, tt, q, vecs, (jdb, tdb)


def _same(jres, tres):
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    np.testing.assert_allclose(tres.distances, jres.distances, **TOL)


@pytest.fixture(scope="module")
def mstg_tables():
    jt, tt, q, vecs, dbs = _tables()
    yield jt, tt, q, vecs
    for db in dbs:
        db.close()


def _bumps(fn):
    names = ("VectorIndexSearches", "VectorBruteForceSearches", "VectorIndexFallbackToFlat",
             "IvfWindowMaskBuilds", "IvfWindowMaskCacheHits", "IvfFilterLayoutBuilds",
             "IvfFilterLayoutHits")
    before = {n: GLOBAL_COUNTERS.get(n) for n in names}
    out = fn()
    return out, {n: GLOBAL_COUNTERS.get(n) - before[n] for n in names}


@pytest.mark.parametrize("nprobe", [3, 5])
def test_table_two_stage_search_matches_jax(mstg_tables, nprobe):
    """two_stage_search=1: the first pass of the MSTG segment, one global
    candidate cut, the exact re-rank, and the scanned small segment merged
    in: the JAX executor's ids."""
    jt, tt, q, _ = mstg_tables
    params = {"nprobe": nprobe}
    jres = jt.search("vec", q, k=K, params=params, two_stage=True)
    tres, b = _bumps(lambda: tt.search("vec", q, k=K, params=params, two_stage=True))
    assert b["VectorIndexSearches"] == 0 and b["VectorBruteForceSearches"] == 1
    _same(jres, tres)
    st = tms.Settings()
    st.query.two_stage_search = True
    _same(jres, tt.search("vec", q, k=K, params=params, settings=st))


@pytest.mark.parametrize("nprobe", [3, 5])
def test_table_search_dyn_nprobe_matches_jax(mstg_tables, nprobe):
    """One-stage search at an nprobe that is not a power of two: the probe
    list and window budget come from the pow2 bucket, the actual nprobe
    masks the rest, and the port returns the JAX package's ids."""
    jt, tt, q, _ = mstg_tables
    jres = jt.search("vec", q, k=K, params={"nprobe": nprobe})
    tres, b = _bumps(lambda: tt.search("vec", q, k=K, params={"nprobe": nprobe}))
    assert b["VectorIndexSearches"] == 1 and b["VectorBruteForceSearches"] == 1
    _same(jres, tres)


def test_table_filtered_search_window_mask_and_fallback(mstg_tables):
    """A filter above filter_fallback_selectivity goes to the index, which
    searches its layout of the passing rows (built once, then from the
    cache; the JAX package masks its probed windows, and here each finds
    the same hits); one below it falls back to the exact scan. Both match
    the JAX package."""
    jt, tt, q, _ = mstg_tables
    for _ in range(2):  # the second search hits the cached layout
        jres = jt.search("vec", q, k=K, params={"nprobe": 4}, filter=jms.F("id") < 2_000)
        tres, b = _bumps(lambda: tt.search("vec", q, k=K, params={"nprobe": 4},
                                           filter=tms.F("id") < 2_000))
        _same(jres, tres)
        assert (tt.gather(tres, ["id"])["id"] < 2_000).all()
        assert b["VectorIndexSearches"] == 1 and b["VectorIndexFallbackToFlat"] == 0
    assert b["IvfFilterLayoutHits"] == 1 and b["IvfFilterLayoutBuilds"] == 0
    assert b["IvfWindowMaskCacheHits"] == b["IvfWindowMaskBuilds"] == 0
    jres = jt.search("vec", q, k=K, params={"nprobe": 4}, filter=jms.F("id") < 60)
    tres, b = _bumps(lambda: tt.search("vec", q, k=K, params={"nprobe": 4},
                                       filter=tms.F("id") < 60))
    assert b["VectorIndexFallbackToFlat"] == 1 and b["VectorIndexSearches"] == 0
    _same(jres, tres)


def test_table_ivfflat_deletes_match_jax():
    jt, tt, q, _, dbs = _tables("IVFFLAT")
    nearest = sorted({int(i) for i in tt.gather(tt.search("vec", q, k=K, params={"nprobe": 8}),
                                                 ["id"])["id"][:, :2].ravel()})
    assert tt.delete(tms.F("id").isin(nearest)) == jt.delete(jms.F("id").isin(nearest)) == len(nearest)
    jres = jt.search("vec", q, k=K, params={"nprobe": 8})
    tres = tt.search("vec", q, k=K, params={"nprobe": 8})
    _same(jres, tres)
    assert not set(tt.gather(tres, ["id"])["id"].ravel().tolist()) & set(nearest)
    for db in dbs:
        db.close()


def test_add_vector_index_without_type_builds_mstg():
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 1_000
    db = tms.connect(st, device="cpu")
    t = db.create_table("m", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    rng, vecs = _blobs(30, 5_000, D)
    t.insert({"id": np.arange(5_000, dtype=np.uint64), "vec": vecs})
    desc = t.add_vector_index("m", "vec")
    assert t.wait_index_built()
    assert desc.kind.value == "MSTG" and t.index_status("m") == {0: IndexStatus.LOADED}
    idx = t.loaded_index(0, "vec", Metric.L2)
    assert isinstance(idx, ivf.MSTGIndex) and idx.codec == "sq8"
    assert idx.raw_data is t.live_segments()[0].vector("vec").data  # a reference, not a copy
    q = vecs[rng.choice(5_000, NQ, replace=False)]
    res, b = _bumps(lambda: t.search("vec", q, k=K))
    assert b["VectorIndexSearches"] == 1
    stored = torch.from_numpy(vecs).to(torch.bfloat16).float().numpy()
    assert _recall(res.rows, _exact_top(q, stored, "L2")) >= 0.95
    # every hit's distance is the exact f32 distance of its stored row
    rows = stored[np.maximum(res.rows, 0)]
    exact = ((q[:, None] - rows) ** 2).sum(-1)
    np.testing.assert_allclose(res.distances, exact, **TOL)
    db.close()


def _disk_mode_table(path):
    """A device-tier table of 5,000 rows with an MSTG made disk-mode by
    `path`: the index parameter, the table's default_mstg_disk_mode, or a
    direct build of the index class (returned with its segment)."""
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 1_000
    if path == "table_default":
        st.table.default_mstg_disk_mode = 1
    db = tms.connect(st, device="cpu")
    t = db.create_table("d", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    rng, vecs = _blobs(31, 5_000, D)
    t.insert({"id": np.arange(5_000, dtype=np.uint64), "vec": vecs})
    if path == "index_param":
        t.add_vector_index("m", "vec", type="MSTG", disk_mode=1, ncentroids=NCENT)
    elif path == "table_default":
        t.add_vector_index("m", "vec", ncentroids=NCENT)
    else:
        seg = t.live_segments()[0]
        idx = ivf.MSTGIndex.build(seg.vector("vec"), 5_000, metric=Metric.L2, dim=D,
                                  params={"disk_mode": 1, "ncentroids": NCENT})
        return db, t, vecs, rng, idx
    assert t.wait_index_built()
    assert t.index_status("m") == {0: IndexStatus.LOADED}
    return db, t, vecs, rng, t.loaded_index(0, "vec", Metric.L2)


@pytest.mark.parametrize("path", ["index_param", "table_default", "index_build"])
def test_disk_mode_builds_and_serves(path):
    """MSTG disk_mode=1, through each of its three entry paths, builds an
    index whose re-rank rows live in host memory (the stored rows, f32),
    whose search takes the two-stage path, and whose hits carry the exact
    f64 distances of their stored rows."""
    db, t, vecs, rng, idx = _disk_mode_table(path)
    seg = t.live_segments()[0]
    stored = seg.vector("vec").data[: seg.n_rows].to(torch.float32)
    assert isinstance(idx, ivf.MSTGIndex) and idx.raw_data is None and idx.requires_two_stage()
    assert torch.equal(idx.raw_host, stored)
    q = (vecs[rng.choice(5_000, NQ, replace=False)] + 0.1 * rng.standard_normal((NQ, D))).astype(np.float32)
    want = _exact_top(q, stored[:, :D].numpy(), "L2")
    if path == "index_build":
        qp = torch.nn.functional.pad(torch.from_numpy(q), (0, stored.shape[1] - D))
        v, r = idx.search_t(qp, K, params=(("nprobe", 8),))
        assert _recall(r.numpy(), want) >= 0.95
        x = stored[r.to(torch.int64)][..., :D].double().numpy()
        exact = 2 * np.einsum("qd,qkd->qk", q.astype(np.float64), x) - (x ** 2).sum(-1)
        np.testing.assert_array_equal(v.numpy(), exact.astype(np.float32))
    else:
        res, b = _bumps(lambda: t.search("vec", q, k=K, params={"nprobe": 8}))
        assert b["VectorIndexSearches"] == 0  # a disk-mode index always takes the two-stage path
        assert _recall(res.rows, want) >= 0.95
        x = stored[np.maximum(res.rows, 0)][..., :D].double().numpy()
        exact = ((q.astype(np.float64)[:, None] - x) ** 2).sum(-1)
        np.testing.assert_allclose(res.distances, exact, **TOL)
    db.close()


def test_jax_executor_segment_mask_lowers_alike(carried_corpus):
    """The JAX executor's and the port's lowered masks of the same
    predicate over the same segment build the same bitmap."""
    c = carried_corpus
    expr = lambda F: (F("id") < 6_000) & (F("tag") != 3)  # noqa: E731
    jm = np.asarray(jexecutor.segment_mask(c["jseg"], expr(jms.F)).build())
    tm = executor.segment_mask(c["plain"], expr(tms.F)).build().numpy()
    np.testing.assert_array_equal(tm, jm)
