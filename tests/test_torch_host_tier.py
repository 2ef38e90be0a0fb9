"""The host tier of the port (myscaledb_tpu_torch, on the CPU) against the
JAX package on the same data: the streamed exact scan, host-tier tables,
the device budget's spill, disk-mode MSTG and the other index builds over
host payloads, mixed device and host segments, HNSW over a host payload,
checkpoints in both directions and the build-memory estimate.

Sizes are small (n 3,000-6,000, d 16-32, ncentroids 16-32). On the CPU the
port's host tier is an ordinary CPU tensor (pinned memory and the copy
stream belong to a CUDA card); `stream_scan_topk` runs the same chunk loop
with the kernels' plain versions. The JAX side runs as its own tests run
it (tests/test_host_tier.py, tests/test_hbm_governor.py).

Tolerances, per test:
  * the streamed scan, host-tier searches and carried-across indexes: ids
    equal on tie-free inputs (continuous random draws), scores and
    distances within rtol 2e-4 / atol 2e-3 (tests/test_distance_ops.py:37);
  * the disk-mode re-rank: distances equal to an f64 numpy score of the
    stored rows cast to f32, within 1 f32 ulp (both packages sum in f64 in
    another order);
  * the host k-means sample: equal bit for bit (both draw with numpy);
    k-means and PQ codebooks fed JAX's own random draws: within 1e-4;
    codes equal;
  * the port's own builds: the JAX package's recall floors
    (tests/test_host_tier.py: >= 0.9 of the stream scan's distances).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.index import hnsw as jhnsw
from myscaledb_tpu.index import ivf as jivf
from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.ops import bruteforce as jbruteforce
from myscaledb_tpu.ops import kmeans as jkmeans
from myscaledb_tpu.ops import quantize as jquantize
from myscaledb_tpu.storage.hbm import GOVERNOR as JGOVERNOR
from myscaledb_tpu.storage.schema import FloatVector as JFloatVector
from myscaledb_tpu.storage.schema import Schema as JSchema
from myscaledb_tpu.storage.schema import UInt64 as JUInt64
from myscaledb_tpu.storage.segment import Segment as JSegment

from myscaledb_tpu_torch.index import flat, hnsw, ivf
from myscaledb_tpu_torch.index.base import IndexStatus
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import bruteforce, kmeans, quantize
from myscaledb_tpu_torch.ops.distance import KERNEL_SUM_TOL
from myscaledb_tpu_torch.ops.stream import HostRep, host_chunks
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.storage import hbm
from myscaledb_tpu_torch.storage.convert import (
    hnsw_from_state_dict,
    ivf_from_state_dict,
    segment_from_arrays,
)
from myscaledb_tpu_torch.storage.hbm import GOVERNOR
from myscaledb_tpu_torch.storage.schema import FloatVector, Schema, UInt64
from myscaledb_tpu_torch.storage.segment import Segment

TOL = dict(rtol=2e-4, atol=2e-3)
K, D, N, NQ, NCENT = 10, 32, 5_000, 16, 32
NB = 6_000  # rows of every JAX IVF build here: one k-means sample shape, compiled once
F32_ULP = np.finfo(np.float32).eps


def _recall(rows, want):
    rows = np.asarray(rows)
    return sum(len(set(g.tolist()) & set(w.tolist())) for g, w in zip(rows, want)) / want.size


def _blobs(seed, n, d=D, n_blobs=40, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = spread * rng.standard_normal((n_blobs, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, n_blobs, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return rng, vecs


def _queries(rng, vecs, nq=NQ, noise=0.3):
    pick = rng.choice(len(vecs), nq, replace=False)
    return (vecs[pick] + noise * rng.standard_normal((nq, vecs.shape[1]))).astype(np.float32)


def _settings(ms, host=True, **table):
    st = ms.Settings()
    if host:
        st.table.vector_storage_tier = "host"
    for k, v in table.items():
        setattr(st.table, k, v)
    return st


def _same(jres, tres, split=None):
    """Equal hits, distances within TOL, plus `split` where a device-tier
    segment's exact scan carries its kernels' bf16 hi/lo query split."""
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    if split is None:
        np.testing.assert_allclose(tres.distances, jres.distances, **TOL)
        return
    gap = np.abs(tres.distances - jres.distances)
    assert (gap <= TOL["atol"] + TOL["rtol"] * np.abs(jres.distances) + split).all()


def _split(tt, tres, q):
    """The hi/lo query split's bound on each hit of a device-tier scan
    (distance.kernel_error_bound: 2^-16 of sum |q_i x_i|, x2 for L2), which
    these rows' large norms (|x|^2 ~ 2,000) lift above the f32 tolerance."""
    x = np.array(tt.gather(tres, ["vec"])["vec"].tolist(), np.float64)
    return 2 * KERNEL_SUM_TOL * np.abs(q[:, None, :] * x).sum(-1)


def _pad(q, dpad):
    return np.pad(q, ((0, 0), (0, dpad - q.shape[1])))


# ---------------------------------------------------------- stream scan
MASKS = ["none", "random", "empty_chunk"]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_stream_scan_topk_matches_jax(metric, mask):
    """n 5,000 in chunks of 1,024 (a ragged last chunk of 904 rows)."""
    rng, vecs = _blobs(1, N)
    cap, dpad = 5_120, 128
    data = np.zeros((cap, dpad), np.float32)
    data[:N, :D] = vecs
    sq = np.einsum("ij,ij->i", data, data)
    inv = np.where(sq > 0, 1 / np.sqrt(np.where(sq > 0, sq, 1)), 0).astype(np.float32)
    aux = {"L2": sq, "IP": None, "Cosine": inv}[metric]
    q = _pad(_queries(rng, vecs), dpad)
    m = None
    if mask == "random":
        m = rng.random(cap) < 0.6
    elif mask == "empty_chunk":
        m = np.ones(cap, bool)
        m[1_024:1_024] = False
    jv, jr = (np.asarray(a) for a in jbruteforce.stream_scan_topk(
        jnp.asarray(q), data, aux, k=K, metric=JMetric(metric), n_valid=N,
        mask=None if m is None else jnp.asarray(m), chunk=1_024))
    tv, tr = (a.numpy() for a in bruteforce.stream_scan_topk(
        torch.from_numpy(q), torch.from_numpy(data), None if aux is None else torch.from_numpy(aux),
        k=K, metric=Metric(metric), n_valid=N, mask=None if m is None else torch.from_numpy(m),
        chunk=1_024))
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, **TOL)
    assert (tr >= 0).all() and (tr < N).all()
    if m is not None:
        assert m[tr].all()


def test_host_chunks_cpu_views_and_padding():
    """On the CPU the chunks are views of the host rows; `pad` zero-fills
    the ragged last one to the chunk's shape."""
    x = torch.arange(10 * 3, dtype=torch.float32).reshape(10, 3)
    got = [(i, m, p[0]) for i, m, p in host_chunks([x], 10, "cpu", 4, pad=True)]
    assert [(i, m) for i, m, _ in got] == [(0, 4), (4, 4), (8, 2)]
    assert got[0][2].data_ptr() == x.data_ptr()
    assert got[2][2].shape == (4, 3) and (got[2][2][2:] == 0).all()
    assert torch.equal(got[2][2][:2], x[8:])
    assert [p[0].shape[0] for _, _, p in host_chunks([x], 10, "cpu", 4)] == [4, 4, 2]
    with pytest.raises(ValueError, match="unsupported device"):
        list(host_chunks([x], 10, "meta", 4))


# -------------------------------------------------- host-tier table search
@pytest.fixture(scope="module")
def host_tables():
    """A JAX and a port host-tier table over the same 5,000 rows."""
    rng, vecs = _blobs(2, N)
    out = []
    for ms in (jms, tms):
        st = _settings(ms, min_rows_to_build_vector_index=1)
        db = ms.connect(st) if ms is jms else ms.connect(st, device="cpu")
        t = db.create_table("h", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(D)}))
        t.insert({"id": np.arange(N, dtype=np.uint64), "vec": vecs})
        out.append((db, t))
    (jdb, jt), (tdb, tt) = out
    yield jt, tt, vecs, _queries(rng, vecs)
    jdb.close()
    tdb.close()


def test_host_payload_keeps_raw_f32(host_tables):
    """A requested-host payload: the raw f32 rows, zero-padded, the JAX
    segment's norms bit for bit, no second f32 copy; column reads return
    the inserted rows."""
    jt, tt, vecs, _ = host_tables
    seg, jseg = tt.live_segments()[0], jt.live_segments()[0]
    p, jp = seg.vector("vec"), jseg.vector("vec")
    assert p.is_host and p.tier == "host" and p.data.device.type == "cpu" and jp.is_host
    assert p.data.dtype == torch.float32 and p.data.shape == jp.data.shape
    np.testing.assert_array_equal(p.data.numpy(), jp.data)
    np.testing.assert_array_equal(p.sqnorm.numpy(), jp.sqnorm)
    np.testing.assert_array_equal(p.invnorm.numpy(), jp.invnorm)
    assert seg._exact_f32 == {} and not seg.spilled_columns
    rows = np.array([0, 17, N - 1])
    np.testing.assert_array_equal(seg.vector_rows("vec", rows), vecs[rows])
    res = tt.search("vec", vecs[rows], k=1)
    got = tt.gather(res, ["vec", "id"])
    np.testing.assert_array_equal(np.array(got["vec"][:, 0].tolist(), np.float32), vecs[rows])


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
@pytest.mark.parametrize("case", ["plain", "filtered", "k_beyond_rows"])
def test_host_table_search_matches_jax(host_tables, case, metric):
    jt, tt, _, q = host_tables
    kw = {}
    if case == "filtered":
        kw = dict(filter=(jms.F("id") >= 1_000) & (jms.F("id") < 4_321))
    k = N + 10 if case == "k_beyond_rows" else K
    if case == "k_beyond_rows":
        q = q[:2]
    jres = jt.search("vec", q, k=k, metric=metric, **kw)
    if case == "filtered":
        kw = dict(filter=(tms.F("id") >= 1_000) & (tms.F("id") < 4_321))
    before = GLOBAL_COUNTERS.get("VectorBruteForceSearches")
    tres = tt.search("vec", q, k=k, metric=metric, **kw)
    assert GLOBAL_COUNTERS.get("VectorBruteForceSearches") - before == 1
    live = jres.rows >= 0
    if case == "k_beyond_rows":
        # every row is returned: the order of the exact ties past the k-th
        # place (none here) and the ids of the valid slots agree
        assert live.sum(1).tolist() == [N, N] and (tres.rows >= 0).sum(1).tolist() == [N, N]
        np.testing.assert_array_equal(np.sort(tres.rows, 1), np.sort(jres.rows, 1))
        np.testing.assert_allclose(np.sort(tres.distances, 1), np.sort(jres.distances, 1), **TOL)
        return
    _same(jres, tres)
    if case == "filtered":
        ids = tt.gather(tres, ["id"])["id"]
        assert ((ids >= 1_000) & (ids < 4_321)).all()


def test_flat_index_over_host_payload_streams(host_tables):
    """A FLAT index over a host-tier payload streams it: the scan's hits."""
    _, tt, _, q = host_tables
    seg = tt.live_segments()[0]
    p = seg.vector("vec")
    idx = flat.FlatIndex.build(p, seg.n_rows, metric=Metric.L2, dim=D)
    assert idx.host and idx.memory_bytes == 0
    qp = torch.from_numpy(_pad(q, p.data.shape[1]))
    v, r = idx.search_t(qp, K)
    sv, sr = bruteforce.stream_scan_topk(qp, p.data, p.sqnorm, k=K, metric=Metric.L2,
                                         n_valid=seg.n_rows)
    assert torch.equal(r, sr) and torch.equal(v, sv)


def test_host_table_deletes_match_jax():
    rng, vecs = _blobs(3, 4_000)
    q = _queries(rng, vecs)
    res = []
    for ms in (jms, tms):
        st = _settings(ms, min_rows_to_build_vector_index=1)
        db = ms.connect(st) if ms is jms else ms.connect(st, device="cpu")
        t = db.create_table("d", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(D)}))
        t.insert({"id": np.arange(4_000, dtype=np.uint64), "vec": vecs})
        nearest = sorted({int(i) for i in t.gather(t.search("vec", q, k=2), ["id"])["id"].ravel()})
        assert t.delete(ms.F("id").isin(nearest)) == len(nearest)
        r = t.search("vec", q, k=K)
        assert not set(t.gather(r, ["id"])["id"].ravel().tolist()) & set(nearest)
        res.append(r)
        db.close()
    _same(*res)


# ---------------------------------------------------------------- spill
def _budget_pair(ms, seed=7, n=NB):
    """Tables of each package with an HBM segment and a spilled one
    (tests/test_hbm_governor.py's scenario)."""
    rng, vecs = _blobs(seed, 2 * n)
    st = ms.Settings()
    st.table.min_rows_to_build_vector_index = 1
    st.server.device_payload_budget_bytes = 10**15
    db = ms.connect(st) if ms is jms else ms.connect(st, device="cpu")
    t = db.create_table("b", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(D)}),
                        settings=st)
    t.insert({"id": np.arange(n, dtype=np.uint64), "vec": vecs[:n]})
    gov = JGOVERNOR if ms is jms else GOVERNOR
    st.server.device_payload_budget_bytes = gov.tracked_bytes
    t.insert({"id": np.arange(n, 2 * n, dtype=np.uint64), "vec": vecs[n:]})
    return db, t, vecs, _queries(rng, vecs)


def test_budget_exhaustion_spills_like_jax():
    before = GLOBAL_COUNTERS.get("SegmentPayloadsSpilledToHost")
    jdb, jt, vecs, q = _budget_pair(jms)
    tdb, tt, _, _ = _budget_pair(tms)
    assert GLOBAL_COUNTERS.get("SegmentPayloadsSpilledToHost") - before == 1
    s0, s1 = tt.live_segments()
    assert not s0.vector("vec").is_host and not s0.spilled_columns
    p = s1.vector("vec")
    assert p.is_host and s1.spilled_columns == {"vec"} and jt.live_segments()[1].vector("vec").is_host
    # the spilled payload holds the bf16-rounded values the device would score
    rounded = torch.from_numpy(vecs[NB:]).to(torch.bfloat16).to(torch.float32)
    assert torch.equal(p.data[:NB, :D], rounded)
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(jt.live_segments()[1].vector("vec").data))
    np.testing.assert_array_equal(p.sqnorm.numpy(), jt.live_segments()[1].vector("vec").sqnorm)
    events = [r["event"] for r in tt.event_log.rows()]
    assert "TierSpill" in events and "TierSpill" in [r["event"] for r in jt.event_log.rows()]
    # column reads of a spilled column return its stored (rounded) rows, as JAX's
    np.testing.assert_array_equal(s1.vector_rows("vec", np.arange(5)),
                                  jt.live_segments()[1].vector_rows("vec", np.arange(5)))
    # exact search across the device segment and the spilled one
    tres = tt.search("vec", q, k=K, metric="L2")
    _same(jt.search("vec", q, k=K, metric="L2"), tres, _split(tt, tres, q))
    # IVF still builds: raw on the device segment, disk mode on the spilled one
    for t in (jt, tt):
        t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=16)
        assert t.wait_index_built()
    for t in (jt, tt):
        i0, i1 = t._slots[(0, "i")].instance, t._slots[(1, "i")].instance
        assert i0.codec == "raw" and i1.codec == "sq8" and i1.requires_two_stage()
    probe = vecs[[5, NB + 7]]
    for t in (jt, tt):
        assert t.gather(t.search("vec", probe, k=3, metric="L2"), ["id"])["id"][:, 0].tolist() == [
            5, NB + 7]
    jdb.close()
    tdb.close()


def test_requested_host_scan_matches_device_tier():
    """tests/test_host_tier.py::test_host_stream_scan_matches_hbm on the
    port: the raw f32 host rows and the bf16 device rows give the same
    nearest row, distances within the JAX test's 5e-3."""
    vecs = np.random.default_rng(0).standard_normal((5_000, D)).astype(np.float32)
    q = vecs[[3, 700, 4_000]] + 0.01
    res = []
    for host in (True, False):
        db = tms.connect(_settings(tms, host=host), device="cpu")
        t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
        t.insert({"id": np.arange(5_000, dtype=np.uint64), "vec": vecs})
        assert t.live_segments()[0].vector("vec").is_host == host
        res.append(t.search("vec", q, k=5, metric="L2"))
        db.close()
    np.testing.assert_allclose(res[0].distances, res[1].distances, rtol=5e-3, atol=5e-3)
    assert res[0].rows[0, 0] == res[1].rows[0, 0] == 3


def test_governor_register_releases_on_gc():
    """tests/test_hbm_governor.py::test_register_releases_on_gc on the
    port's governor (whose admit reserves first)."""
    g = hbm.HbmGovernor()

    class Owner:
        pass

    o = Owner()
    assert g.admit(1_000, torch.device("cpu")) and g.tracked_bytes == 1_000
    g.register(o, 1_000)
    assert g.tracked_bytes == 1_000
    del o
    gc.collect()
    assert g.tracked_bytes == 0


def test_spilled_table_gives_the_unspilled_hits():
    """A spill changes no stored value: the spilled payload's f32 scan
    returns the device table's hits, but where the device scan's bf16 query
    split (within its kernel bound of the exact f32 score) resolves a
    near-tie the other way; the distances agree within that bound."""
    rng, vecs = _blobs(8, 3_000)
    q = _queries(rng, vecs)
    res = []
    for budget in (None, 0):
        st = tms.Settings()
        st.server.device_payload_budget_bytes = None if budget is None else GOVERNOR.tracked_bytes
        db = tms.connect(st, device="cpu")
        t = db.create_table("s", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
        t.insert({"id": np.arange(3_000, dtype=np.uint64), "vec": vecs})
        assert t.live_segments()[0].vector("vec").is_host == (budget == 0)
        res.append(t.search("vec", q, k=K))
        split = _split(t, res[-1], q) if budget is None else split
        db.close()
    dev, host = res
    same = (dev.rows == host.rows).all(1)
    assert same.mean() >= 0.8
    tol = TOL["atol"] + TOL["rtol"] * np.abs(dev.distances) + split
    assert (np.abs(np.sort(host.distances, 1) - np.sort(dev.distances, 1)) <= tol).all()
    assert (np.abs(host.distances - dev.distances)[same] <= tol[same]).all()


def _patch_device_copies(monkeypatch, copy):
    """Route every `Tensor.to(<torch.device>)` (the payload upload's step)
    through `copy(real_to, tensor, device)`; dtype casts pass as they are."""
    real = torch.Tensor.to

    def to(self, *args, **kwargs):
        if args and isinstance(args[0], torch.device):
            return copy(real, self, *args, **kwargs)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", to)


def test_oom_retry_recovers_spills_and_reraises(monkeypatch):
    """An upload that runs out of device memory once is retried (after a
    collection) and lands on the device; twice, the payload spills; any
    other error is raised."""
    calls = {"n": 0, "fail": 0}

    def flaky(real, t, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] <= calls["fail"]:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(t, *args, **kwargs)

    _patch_device_copies(monkeypatch, flaky)
    schema = Schema({"id": UInt64(), "vec": FloatVector(8)})
    cols = {"id": np.arange(10, dtype=np.uint64), "vec": np.ones((10, 8), np.float32)}
    for fail, host in ((1, False), (2, True)):
        calls.update(n=0, fail=fail)
        gc.collect()  # the retry collects: leave it no other payload to free
        before = GOVERNOR.tracked_bytes
        spills = GLOBAL_COUNTERS.get("SegmentPayloadsSpilledToHost")
        seg = Segment.from_columns(0, schema, cols, device="cpu")
        assert seg.vector("vec").is_host == host and seg.spilled_columns == ({"vec"} if host else set())
        assert GLOBAL_COUNTERS.get("SegmentPayloadsSpilledToHost") == spills + host
        # three tensors (rows, two norms) once, after `fail` failed attempts
        assert calls["n"] == fail + (0 if host else 3)
        assert GOVERNOR.tracked_bytes == before + (0 if host else 1024 * 128 * 2 + 1024 * 8)
        del seg
        gc.collect()

    def broken(real, t, *args, **kwargs):
        raise ValueError("not a memory problem")

    _patch_device_copies(monkeypatch, broken)
    gc.collect()
    before = GOVERNOR.tracked_bytes
    with pytest.raises(ValueError, match="not a memory problem"):
        Segment.from_columns(0, schema, cols, device="cpu")
    assert GOVERNOR.tracked_bytes == before  # the reservation is given back


def test_binary_column_has_no_host_tier(monkeypatch):
    def oom(real, t, *args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory (simulated)")

    _patch_device_copies(monkeypatch, oom)
    schema = tms.Schema({"id": tms.UInt64(), "b": tms.BinaryVector(64)})
    cols = {"id": np.arange(4, dtype=np.uint64), "b": np.zeros((4, 8), np.uint8)}
    with pytest.raises(MemoryError, match="no host tier"):
        Segment.from_columns(0, schema, cols, device="cpu")


# ------------------------------------------------- disk-mode MSTG, host tier
def _jax_host_segment(vecs):
    schema = JSchema({"id": JUInt64(), "vec": JFloatVector(vecs.shape[1])})
    return JSegment.from_columns(0, schema, {"id": np.arange(len(vecs), dtype=np.uint64),
                                             "vec": vecs}, storage_tier="host")


def _port_twin(jseg):
    jp = jseg.vector("vec")
    dim = jseg.schema.columns["vec"].dim
    return segment_from_arrays(
        0, Schema({"id": UInt64(), "vec": FloatVector(dim)}), n_rows=jseg.n_rows,
        capacity=jseg.capacity,
        vectors={"vec": {"data": jp.data, "sqnorm": jp.sqnorm, "invnorm": jp.invnorm,
                         "tier": "host"}},
        scalars={"id": jseg.scalar("id")}, device="cpu")


@pytest.fixture(scope="module")
def disk_corpus():
    rng, vecs = _blobs(4, NB)
    jseg = _jax_host_segment(vecs)
    return jseg, _port_twin(jseg), vecs, _queries(rng, vecs)


def test_jax_disk_mode_mstg_carried_across(disk_corpus):
    """A JAX MSTG over a host-tier payload (disk mode) carried across with
    its raw_host re-attached from the payload: equal ids, and re-rank
    distances that equal an f64 score of the stored rows within 1 ulp."""
    jseg, tseg, vecs, q = disk_corpus
    jidx = jivf.MSTGIndex.build(jseg.vector("vec"), len(vecs), metric=JMetric.L2, dim=D,
                                params={"ncentroids": NCENT})
    assert jidx.requires_two_stage()
    p = tseg.vector("vec")
    tidx = ivf_from_state_dict(jidx.state_dict(), "cpu", p)
    assert tidx.raw_host is p.data and tidx.raw_data is None and tidx.requires_two_stage()
    assert tidx.memory_bytes == jidx.memory_bytes
    qp = _pad(q, p.data.shape[1])
    jv, jr = (np.asarray(a) for a in jidx.search(jnp.asarray(qp), K, params={"nprobe": 8}))
    tv, tr = (a.numpy() for a in tidx.search_t(torch.from_numpy(qp), K, params=(("nprobe", 8),)))
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, rtol=F32_ULP, atol=0)
    x = p.data.numpy()[tr].astype(np.float64)
    want = (2 * np.einsum("qd,qkd->qk", qp.astype(np.float64), x) - (x ** 2).sum(-1))
    np.testing.assert_allclose(tv, want.astype(np.float32), rtol=F32_ULP, atol=0)
    # the first stage alone and the subset re-rank, as the executor calls them
    v1, r1 = tidx.search_first_stage(torch.from_numpy(qp), 40, params={"nprobe": 8})
    jv1, jr1 = jidx.search_first_stage(jnp.asarray(qp), 40, params={"nprobe": 8})
    np.testing.assert_array_equal(r1.numpy(), np.asarray(jr1))
    keep = torch.where(r1 >= 0, r1, -1)
    np.testing.assert_allclose(
        tidx.compute_scores_subset(torch.from_numpy(qp), keep).numpy(),
        np.asarray(jidx.compute_scores_subset(jnp.asarray(qp), jnp.asarray(keep.numpy()))),
        rtol=F32_ULP, atol=0)
    # a segment whose candidates all fell below the global cut
    none = torch.full_like(r1, -1)
    assert torch.isneginf(tidx.compute_scores_subset(torch.from_numpy(qp), none)).all()


def _jax_init(n, c, seed=0):
    return torch.from_numpy(np.array(jax.random.permutation(jax.random.PRNGKey(seed), n)[:c]))


def _repeated_points(seed, n_points, reps, d=D):
    """`n_points` distinct points, each `reps` times, shuffled: no row lies
    within f32 rounding of a boundary between two centroids, so the two
    packages (which sum in another order) assign every row alike."""
    rng = np.random.default_rng(seed)
    data = np.repeat(5.0 * rng.standard_normal((n_points, d)), reps, axis=0).astype(np.float32)
    return data[rng.permutation(len(data))]


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_fresh_host_build_with_jax_draws(metric, monkeypatch):
    """The port's own disk-mode MSTG build over a host payload, fed JAX's
    k-means init draw: the same training sample bit for bit, centroids
    within 1e-4, the same assignment, and equal SQ8 codes and layout."""
    vecs = _repeated_points(14, 60, NB // 60)
    n = len(vecs)
    jseg = _jax_host_segment(vecs)
    tseg = _port_twin(jseg)
    p, jp = tseg.vector("vec"), jseg.vector("vec")
    target = min(n, NCENT * 128)
    cos = metric == "Cosine"
    rep_h = jp.data[:n] * jp.invnorm[:n, None] if cos else jp.data[:n]
    jsample = np.asarray(jkmeans.training_sample_host(rep_h, n, NCENT))
    tsample = kmeans.training_sample_host(HostRep(p.data, n, p.invnorm if cos else None), n,
                                          NCENT, device="cpu")
    assert tsample.shape == (target, p.data.shape[1])
    np.testing.assert_array_equal(tsample.numpy(), jsample)
    init = _jax_init(target, NCENT)
    real = kmeans.kmeans_fit_balanced
    monkeypatch.setattr(kmeans, "kmeans_fit_balanced",
                        lambda data, **kw: real(data, init_idx=init, **kw))
    params = {"ncentroids": NCENT}
    tidx = ivf.MSTGIndex.build(p, n, metric=Metric(metric), dim=D, params=params)
    jidx = jivf.MSTGIndex.build(jp, n, metric=JMetric(metric), dim=D, params=params)
    np.testing.assert_allclose(tidx.centroids.numpy(), np.asarray(jidx.centroids), rtol=0, atol=1e-4)
    for f in ("perm_rows", "cluster_start", "perm_data", "codec_a", "codec_b"):
        np.testing.assert_array_equal(getattr(tidx, f).numpy(), np.asarray(getattr(jidx, f)), f)
    np.testing.assert_allclose(tidx.perm_aux.numpy(), np.asarray(jidx.perm_aux), rtol=1e-6)
    assert tidx.raw_host is p.data and tidx.raw_data is None and tidx.requires_two_stage()
    assert tidx.memory_bytes == jidx.memory_bytes < tseg.capacity * p.data.shape[1] * 4 / 2


def test_disk_mode_recall_against_the_stream_scan(disk_corpus):
    """A fresh disk-mode MSTG over the host payload: recall >= 0.9 against
    the stream scan's ids."""
    jseg, tseg, vecs, q = disk_corpus
    p = tseg.vector("vec")
    qp = torch.from_numpy(_pad(q, p.data.shape[1]))
    idx = ivf.MSTGIndex.build(p, len(vecs), metric=Metric.L2, dim=D, params={"ncentroids": NCENT})
    _, gr = bruteforce.stream_scan_topk(qp, p.data, p.sqnorm, k=K, metric=Metric.L2,
                                        n_valid=len(vecs), chunk=1_024)
    _, r = idx.search_t(qp, K, params=(("nprobe", 8),))
    assert _recall(r.numpy(), gr.numpy()) >= 0.9


def test_host_table_disk_mstg_recall_and_footprint():
    """tests/test_host_tier.py::test_host_tier_mstg_disk on the port, on
    its data."""
    vecs = np.random.default_rng(0).standard_normal((6_000, D)).astype(np.float32)
    db = tms.connect(_settings(tms, min_rows_to_build_vector_index=1), device="cpu")
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    t.insert({"id": np.arange(6_000, dtype=np.uint64), "vec": vecs})
    t.add_vector_index("m", "vec", type="MSTG", ncentroids=NCENT)
    assert t.wait_index_built()
    idx = t.loaded_index(0, "vec", Metric.L2)
    seg = t.live_segments()[0]
    assert idx.raw_host is seg.vector("vec").data and idx.raw_data is None
    assert idx.memory_bytes < seg.capacity * seg.vector("vec").data.shape[1] * 4 / 2
    q = (vecs[:64] + 0.05 * np.random.default_rng(1).standard_normal((64, D))).astype(np.float32)
    bf = tms.Settings()
    bf.query.enable_brute_force_vector_search = True
    gt = t.search("vec", q, k=K, settings=bf)  # the index is set aside only by a drop
    before = GLOBAL_COUNTERS.get("VectorIndexSearches")
    got = t.search("vec", q, k=K)
    assert GLOBAL_COUNTERS.get("VectorIndexSearches") == before  # two-stage path
    kth = gt.distances[:, K - 1 : K]
    assert (got.distances <= kth * (1 + 1e-4) + 1e-3).mean() >= 0.9
    d = ((q[0].astype(np.float64) - vecs[got.rows[0, 0]]) ** 2).sum()
    assert got.distances[0, 0] == pytest.approx(d, rel=1e-4)
    db.close()


# ----------------------------------------------- other builds, host payloads
def test_ivfflat_degrades_to_disk_mode():
    rng, vecs = _blobs(6, 3_000)
    db = tms.connect(_settings(tms, min_rows_to_build_vector_index=1), device="cpu")
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    t.insert({"id": np.arange(3_000, dtype=np.uint64), "vec": vecs})
    before = GLOBAL_COUNTERS.get("IvfFlatDegradedToDiskMode")
    t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=16)
    assert t.wait_index_built()
    assert GLOBAL_COUNTERS.get("IvfFlatDegradedToDiskMode") - before == 1
    idx = t.loaded_index(0, "vec", Metric.L2)
    assert isinstance(idx, ivf.IVFFlatIndex) and idx.codec == "sq8" and idx.requires_two_stage()
    assert idx.raw_host is not None and idx.raw_data is None
    r = t.search("vec", vecs[42], k=3)
    assert t.gather(r, ["id"])["id"][0, 0] == 42
    with pytest.raises(tms.IndexParameterError, match="compressed codec"):
        ivf.IVFIndex._build_common(t.live_segments()[0].vector("vec"), 3_000, metric=Metric.L2,
                                   dim=D, params={}, settings=None, codec="raw")
    db.close()


def test_ivfpq_over_host_payload_with_jax_draws(disk_corpus, monkeypatch):
    """IVFPQ over a host payload: the codebooks of JAX's host pq_train fed
    its draws (within 1e-4); on JAX's codebooks, equal pq_encode codes."""
    jseg, tseg, vecs, _ = disk_corpus
    p, jp = tseg.vector("vec"), jseg.vector("vec")
    n, m, bits = len(vecs), 8, 4
    rep = HostRep(p.data, n)
    draws = [_jax_init(n, 1 << bits, j) for j in range(m)]
    want = jquantize.pq_train(jp.data[:n, :D], m, bits=bits)
    books = quantize.pq_train_host(rep, m, D, "cpu", bits=bits, init_idx=draws)
    np.testing.assert_allclose(books.numpy(), want.codebooks, rtol=0, atol=1e-4)
    codes = jquantize.pq_encode(jp.data[:n, :D], want)
    books = torch.from_numpy(want.codebooks)
    got = torch.cat([quantize.pq_encode_dev(x[:, :D], books) for _, _, x in rep.chunks("cpu", 1_024)])
    np.testing.assert_array_equal(got.numpy(), codes)
    # the build takes the same route: IVFPQ over the host payload, disk mode
    init = _jax_init(min(n, 16 * 128), 16)
    real = kmeans.kmeans_fit_balanced
    monkeypatch.setattr(kmeans, "kmeans_fit_balanced",
                        lambda data, **kw: real(data, init_idx=init, **kw))
    monkeypatch.setattr(quantize, "pq_train_host",
                        lambda *a, **kw: torch.from_numpy(want.codebooks))
    tidx = ivf.IVFPQIndex.build(p, n, metric=Metric.L2, dim=D,
                                params={"ncentroids": 16, "M": m, "bit_size": bits})
    assert tidx.codec == "pq" and tidx.requires_two_stage() and tidx.perm_data.shape[1] == m
    live = tidx.perm_rows >= 0
    rows = tidx.perm_rows[live].to(torch.int64)
    np.testing.assert_array_equal(tidx.perm_data[live].numpy(), codes[rows.numpy()])
    dec = quantize.pq_decode_dev(torch.from_numpy(codes), books).to(torch.float32)
    np.testing.assert_allclose(tidx.perm_aux[live].numpy(), (dec * dec).sum(1)[rows].numpy(),
                               rtol=1e-6)


def test_sq8_train_host_equals_numpy(disk_corpus):
    jseg, tseg, vecs, _ = disk_corpus
    p = tseg.vector("vec")
    n = len(vecs)
    for inv in (None, p.invnorm):
        rep = HostRep(p.data, n, inv)
        lo, scale = quantize.sq8_train_host(rep, "cpu")
        rep_h = p.data[:n].numpy() if inv is None else p.data[:n].numpy() * p.invnorm[:n, None].numpy()
        want = jquantize.sq8_train(rep_h)
        np.testing.assert_array_equal(lo.numpy(), want.lo)
        np.testing.assert_array_equal(scale.numpy(), want.scale)
        enc = torch.cat([quantize.sq8_encode_dev(x, lo, scale) for _, _, x in rep.chunks("cpu", 1_000)])
        np.testing.assert_array_equal(enc.numpy(), jquantize.sq8_encode(rep_h, want))


def test_assign_chunked_host_equals_jax():
    rng = np.random.default_rng(9)
    pts = np.repeat(5.0 * rng.standard_normal((50, 16)), 60, axis=0).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    cents = pts[:20].copy()
    want = jkmeans.assign_chunked_host(pts, jnp.asarray(cents), chunk=700)
    got = kmeans.assign_chunked_host(HostRep(torch.from_numpy(pts), len(pts)),
                                     torch.from_numpy(cents), chunk=700)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", ["index_param", "table_default"])
def test_disk_mode_on_hbm_table_like_jax(path):
    """tests/test_host_tier.py::test_hbm_disk_mode_param on both packages:
    the re-rank rows move to the host, the index takes the two-stage path,
    and the port's hits equal JAX's (JAX's index carried across, so the
    k-means draws agree)."""
    rng, vecs = _blobs(10, NB)
    out = []
    for ms in (jms, tms):
        st = _settings(ms, host=False, min_rows_to_build_vector_index=1 if ms is jms else 10**6)
        if path == "table_default":
            st.table.default_mstg_disk_mode = 1
        db = ms.connect(st) if ms is jms else ms.connect(st, device="cpu")
        t = db.create_table("t2", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(D)}))
        t.insert({"id": np.arange(NB, dtype=np.uint64), "vec": vecs})
        params = {"ncentroids": NCENT}
        if path == "index_param":
            params["disk_mode"] = 1
        t.add_vector_index("m", "vec", type="MSTG", **params)
        assert t.wait_index_built()
        out.append((db, t))
    (jdb, jt), (tdb, tt) = out
    jidx = jt._slots[(0, "m")].instance
    assert jidx.raw_host is not None and jidx.raw_data is None
    assert tt.index_status("m") == {0: IndexStatus.SMALL_PART}
    assert tt._index_descs["m"].params.get("disk_mode") == 1
    # the port's own build of the same description: disk mode
    own = ivf.MSTGIndex.build(tt.live_segments()[0].vector("vec"), NB, metric=Metric.L2,
                              dim=D, params=dict(tt._index_descs["m"].params))
    assert own.raw_host is not None and own.raw_data is None and own.requires_two_stage()
    # JAX's index: built with disk_mode=1 its raw_host is the stored rows;
    # carried across it re-attaches the device payload, as JAX's reload does
    loaded = tt.load_index("m", 0, jidx.state_dict())
    assert loaded.raw_data is not None and loaded.raw_host is None
    loaded.raw_host, loaded.raw_data, loaded.raw_aux = tt.live_segments()[0].vector("vec").data[
        :NB].to(torch.float32), None, None
    q = _queries(rng, vecs)
    jres = jt.search("vec", q, k=K, params={"nprobe": 4})
    tres = tt.search("vec", q, k=K, params={"nprobe": 4})
    np.testing.assert_array_equal(tres.rows, jres.rows)
    np.testing.assert_allclose(tres.distances, jres.distances, **TOL)
    assert tt.gather(tres, ["id"])["id"][0, 0] == jt.gather(jres, ["id"])["id"][0, 0]
    jdb.close()
    tdb.close()


# ------------------------------------------------------- mixed segments
@pytest.mark.parametrize("two_stage", [False, True])
def test_mixed_device_and_spilled_segments_match_jax(two_stage):
    """An HBM segment and a spilled one, each with JAX's MSTG (device
    re-rank on the first, disk mode on the second), searched with and
    without two_stage: JAX's hits."""
    jdb, jt, vecs, q = _budget_pair(jms, seed=11)
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 10**6
    st.server.device_payload_budget_bytes = 10**15
    tdb = tms.connect(st, device="cpu")
    tt = tdb.create_table("b", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    tt.insert({"id": np.arange(NB, dtype=np.uint64), "vec": vecs[:NB]})
    st.server.device_payload_budget_bytes = GOVERNOR.tracked_bytes
    tt.insert({"id": np.arange(NB, 2 * NB, dtype=np.uint64), "vec": vecs[NB:]})
    jt.add_vector_index("m", "vec", type="MSTG", ncentroids=NCENT)
    tt.add_vector_index("m", "vec", type="MSTG", ncentroids=NCENT)
    assert jt.wait_index_built() and tt.wait_index_built()
    for sid in (0, 1):
        loaded = tt.load_index("m", sid, jt._slots[(sid, "m")].instance.state_dict())
        assert (loaded.raw_host is not None) == (sid == 1)
    jres = jt.search("vec", q, k=K, params={"nprobe": 4}, two_stage=two_stage)
    tres = tt.search("vec", q, k=K, params={"nprobe": 4}, two_stage=two_stage)
    _same(jres, tres, _split(tt, tres, q))
    assert set(np.unique(tres.segments).tolist()) == {0, 1}
    jdb.close()
    tdb.close()


# --------------------------------------------------- HNSW over host payloads
@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_jax_hnsw_over_host_payload_carried_across(metric):
    """JAX's HNSWFLAT over a host payload (the bf16 rows on the device)
    carried across: searches of the carried index return JAX's ids. The
    port's own build over the same payload holds the same bf16 scoring
    copy, with that copy's own |x|^2 or 1/|x| (a deliberate divergence:
    JAX keeps the f32 rows' own), and finds at least JAX's recall against
    the exact f32 scan."""
    rng, vecs = _blobs(12, 1_024, 128, n_blobs=30)
    jseg = _jax_host_segment(vecs)
    tseg = _port_twin(jseg)
    q = _queries(rng, vecs)
    p = tseg.vector("vec")
    jidx = jhnsw.HNSWFlatIndex.build(jseg.vector("vec"), 1_024, metric=JMetric(metric), dim=128,
                                     params={"m": 16, "ef_c": 64})
    jv, jr = (np.asarray(a) for a in jidx.search(jnp.asarray(q), K, params={"ef_s": 64}))
    tidx = hnsw_from_state_dict(jidx.state_dict(), "cpu")
    tv, tr = (a.numpy() for a in tidx.search_t(torch.from_numpy(q), K, params=(("ef_s", 64),)))
    assert _recall(tr, jr) >= 0.99
    np.testing.assert_allclose(np.sort(tv, 1), np.sort(jv, 1), **TOL)
    own = hnsw.HNSWFlatIndex.build(p, 1_024, metric=Metric(metric), dim=128,
                                   params={"m": 16, "ef_c": 64})
    assert own.data.dtype == torch.bfloat16 and own.data.shape == (1_024, 128)
    np.testing.assert_array_equal(own.data.float().numpy(), np.asarray(jidx.data, np.float32))
    # the |x|^2 or 1/|x| of the bf16 rows it scores (JAX's copy keeps the f32 rows' own)
    bf16_nrm = np.linalg.norm(own.data.double().numpy(), axis=1)
    f32_aux = p.invnorm if metric == "Cosine" else p.sqnorm
    want = 1 / bf16_nrm if metric == "Cosine" else bf16_nrm**2
    np.testing.assert_allclose(own.aux.numpy(), want, rtol=1e-6)
    assert np.abs(own.aux.numpy() / f32_aux[:1_024].numpy() - 1).max() < 1e-2
    _, r = own.search_t(torch.from_numpy(q), K, params=(("ef_s", 64),))
    x, qq = vecs.astype(np.float64), q.astype(np.float64)
    if metric == "Cosine":
        exact = np.argsort(-((qq / np.linalg.norm(qq, axis=1, keepdims=True))
                             @ (x / np.linalg.norm(x, axis=1, keepdims=True)).T), 1)[:, :K]
    else:
        exact = np.argsort(((qq[:, None, :] - x[None]) ** 2).sum(-1), 1)[:, :K]
    # above JAX's: its f32 aux beside the bf16 rows loses near neighbours here
    # (Cosine 1.0 against 0.919, L2 0.981 against 0.913)
    assert _recall(r.numpy(), exact) > _recall(jr, exact)
    est = hnsw.HNSWFlatIndex.estimate_build_bytes(p, 1_024, {"m": 16})
    assert est == jhnsw.HNSWFlatIndex.estimate_build_bytes(jseg.vector("vec"), 1_024, {"m": 16})


# --------------------------------------------------------- checkpoints
def _host_mstg_table(ms, path, vecs):
    st = _settings(ms, min_rows_to_build_vector_index=1)
    db = ms.connect(st, path=path) if ms is jms else ms.connect(st, path=path, device="cpu")
    t = db.create_table("ckpt", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(D)}))
    t.insert({"id": np.arange(len(vecs), dtype=np.uint64), "vec": vecs})
    t.delete(ms.F("id") < 25)
    t.add_vector_index("m", "vec", type="MSTG", ncentroids=NCENT)
    assert t.wait_index_built()
    return db, t


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_host_tier_checkpoint_both_directions(tmp_path, direction):
    rng, vecs = _blobs(13, NB)
    q = _queries(rng, vecs)
    src, dst = (jms, tms) if direction == "jax_to_port" else (tms, jms)
    sdb, st_ = _host_mstg_table(src, str(tmp_path), vecs)
    want = st_.search("vec", q, k=K, params={"nprobe": 4})
    st_.persist()
    dst_st = _settings(dst, min_rows_to_build_vector_index=1)
    ddb = dst.connect(dst_st, path=str(tmp_path)) if dst is jms else dst.connect(
        dst_st, path=str(tmp_path), device="cpu")
    dt = ddb.load_table("ckpt")
    got = dt.search("vec", q, k=K, params={"nprobe": 4})
    _same(want, got)
    assert not (dt.gather(got, ["id"])["id"] < 25).any()
    idx = dt._slots[(0, "m")].instance
    assert idx.raw_host is not None and idx.raw_data is None
    if dst is tms:
        assert idx.raw_host is dt.live_segments()[0].vector("vec").data
    sdb.close()
    ddb.close()


# ------------------------------------------------------ memory estimates
def test_build_estimate_of_a_40gb_host_payload_is_bounded():
    """tests/test_review_fixes_r2.py:78-95 on the port: the estimate counts
    the training sample and the codes, not the host bytes; the JAX
    package's estimate, the same."""

    class FakeHostPayload:
        is_host = True
        nbytes = 40 * (1 << 30)

        class data:
            shape = (100_000_000, 128)

    est = ivf.MSTGIndex.estimate_build_bytes(FakeHostPayload(), 100_000_000)
    assert est == jivf.MSTGIndex.estimate_build_bytes(FakeHostPayload(), 100_000_000)
    assert est < 30 * (1 << 30)
