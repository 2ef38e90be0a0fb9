"""Search programs (search/program.py): the port's counterpart of the JAX
package's jitted search programs, on the CPU.

On the CPU a program runs its body eagerly through the same static
buffers (the query input, one buffer per mask, the actual nprobe) and the
same copy of the packed output as a captured CUDA graph replays them on
the card, so these tests hold the buffer handling, the cache and its
invalidation to the JAX package's results:

  * `VectorIndex.search` against the JAX package's `idx.search` for every
    index kind, each index built by JAX and carried across with
    storage/convert.py: ids equal and scores within rtol 2e-4 / atol 2e-3
    (the port's f32 tolerance; only the order of f32 sums differs), where
    the data hold no ties; HNSW by ids recall >= 0.99 (HNSWPQ >= 0.9, its
    documented divergence) with shared rows' scores within the same
    tolerance, as tests/test_torch_hnsw.py holds them; every program's
    output equal to the eager `search_t` bit for bit;
  * `Table.search` through cached programs: lazy results that do not
    alias, a miss after every mutation that changes what a search reads
    (results equal to JAX's after the same operations), no program left
    holding a dropped table's tensors, eight threads, the cache's cap and
    the counters; the plans kept beside the programs (a repeated search
    runs its plan, a mutation drops it).
"""

import gc
import sys
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.index import binary as jbinary
from myscaledb_tpu.index import flat as jflat
from myscaledb_tpu.index import hnsw as jhnsw
from myscaledb_tpu.index import ivf as jivf
from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.storage.schema import BinaryVector as JBinaryVector
from myscaledb_tpu.storage.schema import FloatVector as JFloatVector
from myscaledb_tpu.storage.schema import Int32 as JInt32
from myscaledb_tpu.storage.schema import Schema as JSchema
from myscaledb_tpu.storage.schema import UInt64 as JUInt64
from myscaledb_tpu.storage.segment import Segment as JSegment

from myscaledb_tpu_torch.index import base, flat, ivf
from myscaledb_tpu_torch.index.binary import BinaryFlatIndex
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import _cuda
from myscaledb_tpu_torch.search import executor, program
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.storage.convert import (
    binary_from_state_dict,
    hnsw_from_state_dict,
    ivf_from_state_dict,
    segment_from_arrays,
)
from myscaledb_tpu_torch.storage.schema import BinaryVector, FloatVector, Int32, Schema, UInt64

K = 10
TOL = dict(rtol=2e-4, atol=2e-3)
N, D, NQ, NCENT = 3_000, 32, 12, 16
HN, HD = 2_000, 128  # HNSW: the node-block layout needs 128-wide rows


def _blobs(seed, n, d, n_blobs=30, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = spread * rng.standard_normal((n_blobs, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, n_blobs, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return rng, vecs


def _queries(rng, vecs, nq=NQ, noise=0.3):
    pick = rng.choice(len(vecs), nq, replace=False)
    return (vecs[pick] + noise * rng.standard_normal((nq, vecs.shape[1]))).astype(np.float32)


def _twin(jseg, dim, tier="hbm"):
    """The port's segment over the JAX segment's stored bytes."""
    jp = jseg.vector("vec")
    data = np.asarray(jp.data)
    data = data if tier == "host" else data.view(np.uint16)
    return segment_from_arrays(
        0, Schema({"id": UInt64(), "tag": Int32(), "vec": FloatVector(dim)}), n_rows=jseg.n_rows,
        capacity=jseg.capacity,
        vectors={"vec": {"data": data, "sqnorm": np.asarray(jp.sqnorm),
                         "invnorm": np.asarray(jp.invnorm), "tier": tier}},
        scalars={c: jseg.scalar(c) for c in ("id", "tag")}, device="cpu")


def _corpus(seed, n, d, tier="hbm"):
    rng, vecs = _blobs(seed, n, d)
    tags = rng.integers(0, 10, n).astype(np.int32)
    schema = JSchema({"id": JUInt64(), "tag": JInt32(), "vec": JFloatVector(d)})
    jseg = JSegment.from_columns(
        0, schema, {"id": np.arange(n, dtype=np.uint64), "tag": tags, "vec": vecs},
        storage_tier=tier)
    tseg = _twin(jseg, d, tier)
    dpad = tseg.vector("vec").data.shape[1]
    q = np.pad(_queries(rng, vecs), ((0, 0), (0, dpad - d)))
    mask = np.zeros(jseg.capacity, bool)
    mask[:n] = (tags != 3) & (np.arange(n) % 7 != 0)
    return dict(jseg=jseg, tseg=tseg, vecs=vecs, q=q, mask=mask)


@pytest.fixture(scope="module")
def ivf_corpus():
    return _corpus(31, N, D)


@pytest.fixture(scope="module")
def hnsw_corpus():
    return _corpus(32, HN, HD)


@pytest.fixture(scope="module")
def disk_corpus():
    return _corpus(33, N, D, tier="host")


def _both(jidx, tidx, q, params, mask):
    """(port scores, port rows, JAX scores, JAX rows) of `search`, after
    checking the port's program output against its eager `search_t`."""
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jv, jr = (np.asarray(a) for a in jidx.search(jnp.asarray(q), K, params=params, mask=jm))
    before = GLOBAL_COUNTERS.get("SearchProgramReplays")
    tv, tr = tidx.search(torch.from_numpy(q), K, params=params, mask=tm)
    ev, er = tidx.search_t(torch.from_numpy(q), K, mask=tm, params=tuple(sorted(params.items())))
    assert torch.equal(tr, er) and torch.equal(tv.view(torch.int32), ev.view(torch.int32))
    eager = isinstance(tidx, ivf.IVFIndex) and tidx.raw_host is not None
    assert GLOBAL_COUNTERS.get("SearchProgramReplays") - before == (0 if eager else 1)
    return tv.numpy(), tr.numpy(), jv, jr


def _same_hits(tv, tr, jv, jr):
    np.testing.assert_array_equal(tr, jr)
    live = jr >= 0
    np.testing.assert_array_equal(np.isfinite(tv), live)
    np.testing.assert_allclose(tv[live], jv[live], **TOL)


# ---------------------------------------------------- VectorIndex.search
@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_flat_search_matches_jax(ivf_corpus, metric, masked):
    c = ivf_corpus
    jp, tp = c["jseg"].vector("vec"), c["tseg"].vector("vec")
    jidx = jflat.FlatIndex(jp.data, jp.aux_for(JMetric(metric)), metric=JMetric(metric), dim=D,
                           n_rows=N)
    tidx = flat.FlatIndex(tp.data, tp.aux_for(Metric(metric)), metric=Metric(metric), dim=D,
                          n_rows=N)
    _same_hits(*_both(jidx, tidx, c["q"], {}, c["mask"] if masked else None))


_JAX_IVF = {}


def _jax_ivf(corpus, kind, **params):
    key = (id(corpus), kind, tuple(sorted(params.items())))
    if key not in _JAX_IVF:
        cls = {"IVFFLAT": jivf.IVFFlatIndex, "IVFSQ": jivf.IVFSQIndex, "IVFPQ": jivf.IVFPQIndex,
               "MSTG": jivf.MSTGIndex}[kind]
        extra = {"M": 8} if kind == "IVFPQ" else {}
        _JAX_IVF[key] = cls.build(corpus["jseg"].vector("vec"), corpus["jseg"].n_rows,
                                  metric=JMetric.L2, dim=D,
                                  params={"ncentroids": NCENT, **extra, **params})
    return _JAX_IVF[key]


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
@pytest.mark.parametrize("nprobe", [1, 3, 8])
@pytest.mark.parametrize("kind", ["IVFFLAT", "IVFSQ", "IVFPQ", "MSTG"])
def test_ivf_search_matches_jax(ivf_corpus, kind, nprobe, masked):
    c = ivf_corpus
    jidx = _jax_ivf(c, kind)
    tidx = ivf_from_state_dict(jidx.state_dict(), "cpu", c["tseg"].vector("vec"))
    _same_hits(*_both(jidx, tidx, c["q"], {"nprobe": nprobe}, c["mask"] if masked else None))


def test_ivf_search_takes_a_window_mask(ivf_corpus):
    """A WindowMask (the executor's mask for an IVF index) goes into the
    program as its window-layout bitmap: the row-space mask's hits."""
    c = ivf_corpus
    tidx = ivf_from_state_dict(_jax_ivf(c, "IVFFLAT").state_dict(), "cpu")
    seg = c["tseg"]
    flt = (tms.F("tag") != 3) & (tms.F("id") < 2_000)
    wm = tidx.to_window_mask(executor.segment_mask(seg, flt), seg)
    assert isinstance(wm, executor.WindowMask)
    rows = torch.from_numpy((seg.scalar("tag") != 3) & (seg.scalar("id") < 2_000))
    rmask = torch.zeros(seg.capacity, dtype=torch.bool)
    rmask[:N] = rows
    q = torch.from_numpy(c["q"])
    wv, wr = tidx.search(q, K, params={"nprobe": 4}, mask=wm)
    rv, rr = tidx.search(q, K, params={"nprobe": 4}, mask=rmask)
    assert torch.equal(wr, rr) and torch.equal(wv, rv)
    assert rmask[wr[wr >= 0].long()].all()


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
def test_disk_mode_mstg_search_matches_jax(disk_corpus, masked):
    """A disk-mode MSTG (its re-rank rows in host memory) searches eagerly
    in two stages, as the JAX package's override of `search` does: JAX's
    ids, no program run."""
    c = disk_corpus
    jidx = _jax_ivf(c, "MSTG")
    assert jidx.requires_two_stage()
    tidx = ivf_from_state_dict(jidx.state_dict(), "cpu", c["tseg"].vector("vec"))
    assert tidx.raw_host is not None
    _same_hits(*_both(jidx, tidx, c["q"], {"nprobe": 4}, c["mask"] if masked else None))


def test_device_mstg_built_in_disk_mode_matches_jax(ivf_corpus):
    """MSTG with disk_mode=1 over an HBM payload: the JAX index's re-rank
    rows moved to the host; carried across with its host rows."""
    c = ivf_corpus
    jidx = _jax_ivf(c, "MSTG", disk_mode=1)
    assert jidx.raw_host is not None
    tidx = ivf_from_state_dict(jidx.state_dict(), "cpu")
    tidx.raw_host = torch.from_numpy(np.asarray(jidx.raw_host))
    _same_hits(*_both(jidx, tidx, c["q"], {"nprobe": 4}, None))


_JAX_HNSW = {}


def _jax_hnsw(corpus, kind):
    if kind not in _JAX_HNSW:
        cls = {"HNSWFLAT": jhnsw.HNSWFlatIndex, "HNSWSQ": jhnsw.HNSWSQIndex,
               "HNSWPQ": jhnsw.HNSWPQIndex}[kind]
        _JAX_HNSW[kind] = cls.build(corpus["jseg"].vector("vec"), HN, metric=JMetric.L2, dim=HD,
                                    params={"m": 16, "ef_c": 64})
    return _JAX_HNSW[kind]


HNSW_CALLS = [
    ({"ef_s": 64}, False),
    ({"ef_s": 64, "entries": 64}, False),
    ({"ef_s": 64, "rerank": 64}, False),
    ({"ef_s": 128}, True),
]


@pytest.mark.parametrize("params,masked", HNSW_CALLS, ids=["ef_s", "entries", "rerank", "mask"])
@pytest.mark.parametrize("kind", ["HNSWFLAT", "HNSWSQ", "HNSWPQ"])
def test_hnsw_search_matches_jax(hnsw_corpus, kind, params, masked):
    c = hnsw_corpus
    jidx = _jax_hnsw(c, kind)
    tidx = hnsw_from_state_dict(jidx.state_dict(), "cpu")
    mask = c["mask"] if masked else None
    tv, tr, jv, jr = _both(jidx, tidx, c["q"], params, mask)
    shared = hits = 0
    for i in range(len(tr)):
        jmap = dict(zip(jr[i].tolist(), jv[i].tolist()))
        for r, v in zip(tr[i].tolist(), tv[i].tolist()):
            if r >= 0:
                hits += 1
                if mask is not None:
                    assert mask[r]
                if r in jmap:
                    np.testing.assert_allclose(v, jmap[r], **TOL)
                    shared += 1
    assert hits == (jr >= 0).sum()
    assert shared >= (0.9 if kind == "HNSWPQ" else 0.99) * hits


def _binary_corpus():
    rng = np.random.default_rng(34)
    dim, n = 256, 4_000
    protos = rng.random((12, dim)) < 0.5
    bits = protos[rng.integers(0, 12, n)] ^ (rng.random((n, dim)) < 0.08)
    packed = np.packbits(bits, axis=1)
    q = packed[rng.choice(n, NQ)] ^ np.packbits(rng.random((NQ, dim)) < 0.05, axis=1)
    # plant rows at distinct distances from each query: no tie at the k-th place
    for i, qq in enumerate(np.unpackbits(q, axis=1)):
        zeros = rng.permutation(np.nonzero(qq == 0)[0])
        for j in range(20):
            row = qq.copy()
            row[zeros[: j + 1]] = 1
            bits[i * 20 + j] = row
    packed = np.packbits(bits, axis=1)
    cols = {"id": np.arange(n, dtype=np.uint64), "bv": packed}
    jseg = JSegment.from_columns(0, JSchema({"id": JUInt64(), "bv": JBinaryVector(dim)}), cols)
    from myscaledb_tpu_torch.storage.segment import Segment

    tseg = Segment.from_columns(0, Schema({"id": UInt64(), "bv": BinaryVector(dim)}), cols,
                                device="cpu")
    mask = np.zeros(jseg.capacity, bool)
    mask[:n] = np.arange(n) % 5 != 1
    return jseg, tseg, q, mask, dim, n


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
@pytest.mark.parametrize("kind", ["BinaryFLAT", "BinaryMSTG"])
@pytest.mark.parametrize("metric", ["Hamming", "Jaccard"])
def test_binary_search_matches_jax(kind, metric, masked):
    jseg, tseg, q, mask, dim, n = _binary_corpus()
    jm, tm = JMetric(metric), Metric(metric)
    if kind == "BinaryFLAT":
        jidx = jbinary.BinaryFlatIndex(jseg.vector("bv").data, metric=jm, dim=dim, n_rows=n)
        tidx = BinaryFlatIndex(tseg.vector("bv").data, metric=tm, dim=dim, n_rows=n)
        params = {}
    else:
        jidx = jbinary.BinaryMSTGIndex.build(jseg.vector("bv"), n, metric=jm, dim=dim,
                                             params={"ncentroids": 8})
        tidx = binary_from_state_dict(jidx.state_dict(), "cpu")
        params = {"nprobe": 3}
    tv, tr, jv, jr = _both(jidx, tidx, q, params, mask if masked else None)
    np.testing.assert_array_equal(tv, jv)  # integer or one-quotient scores: exact
    kth = tv[:, -1:]
    above = tv > kth  # the rows no tie at the k-th place can swap
    for i in range(len(tr)):
        assert set(tr[i][above[i]].tolist()) == set(jr[i][jv[i] > kth[i]].tolist())


# ---------------------------------------------------- Table programs
DIM, N1, N2 = 16, 9_000, 3_000


def _table_columns(seed=41):
    rng = np.random.default_rng(seed)
    vec = rng.standard_normal((N1 + N2, DIM)).astype(np.float32)
    tag = rng.integers(0, 10, N1 + N2).astype(np.int32)
    ids = np.arange(N1 + N2, dtype=np.uint64)
    q = (vec[rng.choice(N1 + N2, NQ, replace=False)]
         + 0.3 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    parts = [slice(0, N1), slice(N1, N1 + N2)]
    return [{"id": ids[p], "tag": tag[p], "vec": vec[p]} for p in parts], q


def _pair(settings=None):
    cols, q = _table_columns()
    out = []
    for ms in (jms, tms):
        st = ms.Settings()
        st.table.min_rows_to_build_vector_index = 10**6
        if settings:
            settings(st)
        db = ms.connect(st) if ms is jms else ms.connect(st, device="cpu")
        t = db.create_table(
            "t", ms.Schema({"id": ms.UInt64(), "tag": ms.Int32(), "vec": ms.FloatVector(DIM)}))
        for c in cols:
            t.insert(c)
        out.append((db, t))
    return out, q


def _same(jres, tres):
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    np.testing.assert_allclose(tres.distances, jres.distances, **TOL)


def _count(name):
    return GLOBAL_COUNTERS.get(name)


def test_back_to_back_results_do_not_alias():
    """Two searches through one program return their own lazy results:
    each a copy of the program's output, equal to a fresh program's."""
    ((jdb, jt), (tdb, tt)), q = _pair()
    tt.search("vec", q[:8], k=K)  # makes the program of 8-row batches
    caps, reps = _count("SearchProgramCaptures"), _count("SearchProgramReplays")
    r1 = tt.search("vec", q[:5], k=K)
    r2 = tt.search("vec", q[5:], k=K)  # the same padded batch (8 rows): the same program
    assert (_count("SearchProgramCaptures"), _count("SearchProgramReplays")) == (caps, reps + 2)
    prog, = tt._programs.programs()
    ptrs = {r1._packed.data_ptr(), r2._packed.data_ptr(), prog.out.data_ptr()}
    assert len(ptrs) == 3
    assert r1._host is None and r2._host is None  # still lazy
    tt._programs.invalidate()
    f1 = tt.search("vec", q[:5], k=K)
    f2 = tt.search("vec", q[5:], k=K)
    for got, fresh, sl in ((r1, f1, slice(0, 5)), (r2, f2, slice(5, None))):
        np.testing.assert_array_equal(got.rows, fresh.rows)
        np.testing.assert_array_equal(got.scores, fresh.scores)
        _same(jt.search("vec", q[sl], k=K), got)
    jdb.close()
    tdb.close()


def test_replays_count_and_keys():
    """One capture per key, one replay per search; k, the padded batch and
    the mask's kind key a program, the query's values do not."""
    ((jdb, jt), (tdb, tt)), q = _pair()
    caps, reps = _count("SearchProgramCaptures"), _count("SearchProgramReplays")
    for _ in range(3):
        tt.search("vec", q, k=K)
    tt.search("vec", q + 1.0, k=K)
    assert (_count("SearchProgramCaptures") - caps, _count("SearchProgramReplays") - reps) == (1, 4)
    tt.search("vec", q, k=K + 1)
    tt.search("vec", q[:3], k=K)
    tt.search("vec", q, k=K, filter=tms.F("tag") < 5)
    assert _count("SearchProgramCaptures") - caps == 4 and len(tt._programs) == 4
    jdb.close()
    tdb.close()


def test_cap_evicts():
    ((jdb, jt), (tdb, tt)), q = _pair()
    tt._programs.cap = 2
    ev = _count("SearchProgramEvictions")
    for k in (3, 4, 5, 3):
        tt.search("vec", q, k=k)
    assert len(tt._programs) == 2 and _count("SearchProgramEvictions") - ev == 2
    _same(jt.search("vec", q, k=3), tt.search("vec", q, k=3))
    jdb.close()
    tdb.close()


def _ops(ms, t, db):
    F = ms.F
    return {
        "insert": lambda: t.insert({"id": np.arange(10**5, 10**5 + 700, dtype=np.uint64),
                                    "tag": np.full(700, 4, np.int32),
                                    "vec": np.random.default_rng(5).standard_normal(
                                        (700, DIM)).astype(np.float32)}),
        "delete": lambda: t.delete(F("id") < 4_000),
        "update": lambda: t.update(F("id") < 6_000, {"tag": 11}),
        "merge": lambda: t.merge(),
        "truncate": lambda: t.truncate(),
    }


@pytest.mark.parametrize("op", ["insert", "delete", "update", "merge", "truncate"])
def test_mutation_misses_the_cache(op):
    """After each mutation the next search makes a new program and returns
    what the JAX package returns after the same operation; the programs
    made before it are gone."""
    ((jdb, jt), (tdb, tt)), q = _pair()
    flt = {"update": lambda ms: ms.F("tag") == 11}.get(op)
    kw = lambda ms: {"filter": flt(ms)} if flt else {}  # noqa: E731
    _same(jt.search("vec", q, k=K, **kw(jms)), tt.search("vec", q, k=K, **kw(tms)))
    hits = _count("SearchPlanHits")
    tt.search("vec", q, k=K, **kw(tms))  # the plan kept beside the program
    # (before the update no segment can hold tag 11: both fold away, and
    # an empty answer keeps no plan)
    assert _count("SearchPlanHits") - hits == (op != "update")
    old = [weakref.ref(p) for p in tt._programs.programs()]
    version = tt.segment_version
    _ops(jms, jt, jdb)[op]()
    _ops(tms, tt, tdb)[op]()
    assert tt.segment_version > version and len(tt._programs) == 0
    assert len(tt._programs._plans) == 0
    gc.collect()
    assert all(r() is None for r in old)
    caps = _count("SearchProgramCaptures")
    hits, misses = _count("SearchPlanHits"), _count("SearchPlanMisses")
    tres = tt.search("vec", q, k=K, **kw(tms))
    jres = jt.search("vec", q, k=K, **kw(jms))
    assert (_count("SearchPlanHits"), _count("SearchPlanMisses") - misses) == (hits, 1)
    if op == "truncate":
        assert not tres.valid.any() and not jres.valid.any()
    else:
        assert _count("SearchProgramCaptures") - caps == 1
        _same(jres, tres)
        again = tt.search("vec", q, k=K, **kw(tms))  # the new plan, kept
        assert _count("SearchPlanHits") - hits == 1
        _same(jres, again)
    jdb.close()
    tdb.close()


def test_spill_misses_the_cache():
    """An insert whose payload the device budget refuses spills to the host
    tier: the next search misses the cache and streams that segment
    eagerly beside the program-less merge, with JAX's hits."""
    from myscaledb_tpu.storage.hbm import GOVERNOR as JGOVERNOR
    from myscaledb_tpu_torch.storage.hbm import GOVERNOR

    ((jdb, jt), (tdb, tt)), q = _pair(lambda st: setattr(st.server, "device_payload_budget_bytes",
                                                         10**15))
    _same(jt.search("vec", q, k=K), tt.search("vec", q, k=K))
    version = tt.segment_version
    cols, _ = _table_columns(seed=42)
    for t, gov in ((jt, JGOVERNOR), (tt, GOVERNOR)):
        t.settings.server.device_payload_budget_bytes = gov.tracked_bytes
        t.insert({**cols[1], "id": cols[1]["id"] + 10**6})
    assert tt.live_segments()[-1].vector("vec").is_host
    assert tt.segment_version > version and len(tt._programs) == 0
    _same(jt.search("vec", q, k=K), tt.search("vec", q, k=K))
    jdb.close()
    tdb.close()


@pytest.mark.parametrize("how", ["drop", "detach"])
def test_dropped_table_releases_its_tensors(how, tmp_path):
    """DROP and DETACH leave no program holding the table's tensors: the
    programs and the payload they read are collected (a database with a
    path checkpoints a detached table and parks nothing)."""
    db = tms.connect(path=str(tmp_path / "db"), device="cpu")
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(DIM)}))
    cols, q = _table_columns()
    t.insert({"id": cols[0]["id"], "vec": cols[0]["vec"]})
    t.search("vec", q, k=K)
    prog, = t._programs.programs()
    payload = t.live_segments()[0].vector("vec").data
    assert any(r is payload for r in prog.refs)
    refs = [weakref.ref(prog), weakref.ref(payload)]
    del prog, payload
    getattr(db, f"{how}_table")("t")
    assert len(t._programs) == 0
    del t
    gc.collect()
    assert [r() for r in refs] == [None, None]
    db.close()


def _ivf_fts_table():
    """A port table of two segments with an MSTG index on the first (an
    IVF index with a two-stage path) and an fts index on both: every kind
    of program a table keeps."""
    cols, q = _table_columns()
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 5_000
    db = tms.connect(st, device="cpu")
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "tag": tms.Int32(),
                                         "body": tms.String(), "vec": tms.FloatVector(DIM)}))
    words = np.array(["alpha beta", "beta gamma", "gamma delta"], dtype=object)
    for c in cols:
        t.insert({**c, "body": words[c["tag"] % 3]})
    t.add_vector_index("i", "vec", type="MSTG", ncentroids=NCENT)
    t.add_fts_index("ft", "body")
    assert t.wait_index_built()
    return db, t, q


@pytest.mark.parametrize("drop", ["segments_changed", "fts_store_rebuild", "drop_fts_index"])
def test_one_cache_a_table_and_one_drop(drop):
    """The fused vector programs, the two-stage path's index programs and
    the text programs live in the table's one cache; `_segments_changed`,
    which an fts store's rebuild and `drop_fts_index` call too, empties it
    and lets go of every program."""
    db, t, q = _ivf_fts_table()
    p = {"nprobe": 4}
    t.search("vec", q, k=K, params=p)
    t.search("vec", q, k=K, params=p, filter=tms.F("tag") < 5)
    t.search("vec", q, k=K, params=p, two_stage=True)
    t.text_search("ft", ["alpha", "gamma delta"], k=K)
    assert sorted(key[0] for key in t._programs._entries) == ["fused", "fused", "index", "text"]
    old = [weakref.ref(prog) for prog in t._programs.programs()]
    version = t.segment_version
    {"segments_changed": t._segments_changed,
     "fts_store_rebuild": lambda: t._text_indexes["ft"].on_new_segment(t.live_segments()[0]),
     "drop_fts_index": lambda: t.drop_fts_index("ft")}[drop]()
    assert t.segment_version > version and len(t._programs) == 0
    gc.collect()
    assert all(r() is None for r in old)
    db.close()


def test_dropped_table_releases_its_filter_masks():
    """A string predicate's device mask is cached on its segment and goes
    with it: after DROP no mask of the table's segments is reachable."""
    db = tms.connect(device="cpu")
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "body": tms.String(),
                                         "vec": tms.FloatVector(DIM)}))
    cols, q = _table_columns()
    words = np.array(["alpha beta", "beta gamma"], dtype=object)
    t.insert({"id": cols[0]["id"], "body": words[cols[0]["tag"] % 2], "vec": cols[0]["vec"]})
    flt = tms.F("body") == "beta gamma"
    assert t.search("vec", q, k=K, filter=flt).valid.any()
    seg = t.live_segments()[0]
    mask, = seg.mask_cache.values()
    assert executor.segment_mask(seg, flt) is mask  # the repeated predicate's hit
    ref = weakref.ref(mask)
    del mask, seg
    db.drop_table("t")
    del t
    gc.collect()
    assert ref() is None
    db.close()


@pytest.mark.parametrize("keys", [1, 4])
def test_eight_threads_get_their_own_answers(keys):
    """Eight threads, each its own queries, over one request key or four
    (k and a filter's constant): every answer is JAX's, and every search
    after each key's first few runs its kept plan."""
    ((jdb, jt), (tdb, tt)), q = _pair()
    batches = [q[i % 4 * 3:(i % 4 + 1) * 3] + 0.01 * i for i in range(8)]

    def req(ms, i):
        if keys == 1:
            return {"k": K}
        return {"k": K + i % 2, "filter": ms.F("tag") < 3 + i % 4 // 2}

    want = [jt.search("vec", b, **req(jms, i)) for i, b in enumerate(batches)]
    got = [None] * 8
    errors = []
    hits, misses = _count("SearchPlanHits"), _count("SearchPlanMisses")

    def worker(i):
        try:
            for _ in range(5):
                r = tt.search("vec", batches[i], **req(tms, i))
                got[i] = (r.segments.copy(), r.rows.copy(), r.distances.copy())
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
    for (segs, rows, dists), j in zip(got, want):
        np.testing.assert_array_equal(segs, j.segments)
        np.testing.assert_array_equal(rows, j.rows)
        np.testing.assert_allclose(dists, j.distances, **TOL)
    # every batch pads to 8 rows; a filter's constant is a program's input
    assert len(tt._programs) == min(keys, 2) and len(tt._programs._plans) == keys
    hit, missed = _count("SearchPlanHits") - hits, _count("SearchPlanMisses") - misses
    # a key's searches that plan before its first plan is kept are misses
    assert hit + missed == 40 and keys <= missed <= 8
    jdb.close()
    tdb.close()


def _ivf_pair():
    """Both packages' tables with JAX's IVFFLAT on the first segment (the
    port loads it: both search the same index)."""
    ((jdb, jt), (tdb, tt)), q = _pair(
        lambda st: setattr(st.table, "min_rows_to_build_vector_index", 5_000))
    jt.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=NCENT)
    tt.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=NCENT)
    assert jt.wait_index_built() and tt.wait_index_built()
    tt.load_index("i", 0, jt.loaded_index(0, "vec", JMetric.L2).state_dict())
    return (jdb, jt), (tdb, tt), q


def test_dyn_nprobe_is_an_input_not_a_key():
    """nprobe 3 and 4 share the pow2 bucket 4: one program, the actual
    nprobe a device scalar input; each equals JAX's at its nprobe. A
    filtered search is a program of its own over the index's layout of the
    passing rows, beside the unfiltered one. It is held to JAX's exact
    filtered answer, query by query: every hit passes; a hit in that answer
    has its distance, any other is no nearer than its k-th. Its candidates
    hold every passing row of the query's nprobe best lists (and of the
    scanned segment), so query by query its i-th distance is no farther
    than that of the exact top-k over those rows. JAX's masked scan of its
    probed windows also reads rows of the lists beside them, so the two
    answers differ, and the port's recall is held to JAX's on the mean."""
    (jdb, jt), (tdb, tt), q = _ivf_pair()
    caps = _count("SearchProgramCaptures")
    for nprobe in (3, 4, 3):
        _same(jt.search("vec", q, k=K, params={"nprobe": nprobe}),
              tt.search("vec", q, k=K, params={"nprobe": nprobe}))
    assert _count("SearchProgramCaptures") - caps == 1
    prog, = tt._programs.programs()
    assert prog.dyn is not None and int(prog.dyn) == 3
    f = lambda ms: (ms.F("tag") != 3) & (ms.F("id") < 7_000)  # noqa: E731
    jres = jt.search("vec", q, k=K, params={"nprobe": 4}, filter=f(jms))
    tres = tt.search("vec", q, k=K, params={"nprobe": 4}, filter=f(tms))
    assert len(tt._programs) == 2 and _count("SearchProgramCaptures") - caps == 2
    jt.settings.query.filter_fallback_selectivity = 1.0  # every filtered search scans exactly
    exact = jt.search("vec", q, k=K, params={"nprobe": 4}, filter=f(jms))
    assert (tres.rows >= 0).all() and (exact.rows >= 0).all()
    got = tt.gather(tres, ["id", "tag"])
    assert (got["id"] < 7_000).all() and (got["tag"] != 3).all()

    def hits(res, i):
        return list(zip(res.segments[i].tolist(), res.rows[i].tolist()))

    def recall(res):
        return np.mean([len(set(hits(res, i)) & set(hits(exact, i))) for i in range(len(q))]) / K

    assert recall(tres) >= recall(jres)
    # the exact top-k over the passing rows of each query's 4 best lists
    # (the index's centroid ranking) and of the scanned segment, in numpy
    idx = tt.loaded_index(0, "vec", Metric.L2)
    q64 = np.asarray(q, np.float64)
    cen = idx.centroids.numpy().astype(np.float64)[:, : q64.shape[1]]
    best = np.argsort(-(2 * q64 @ cen.T - (cen ** 2).sum(1)), axis=1)[:, :4]
    pos_of = np.empty(idx.n_rows, np.int64)
    perm = idx.perm_rows.numpy()
    pos_of[perm[perm >= 0]] = np.nonzero(perm >= 0)[0]
    owner = np.searchsorted(idx.cluster_start.numpy()[1:], pos_of, side="right")
    parts = []
    for seg in tt.live_segments():
        n = seg.n_rows
        ok = (seg.scalar("id")[:n] < 7_000) & (seg.scalar("tag")[:n] != 3)
        x = seg.vector("vec").data[:n, : q64.shape[1]].to(torch.float64).numpy()
        d = ((q64[:, None, :] - x[None]) ** 2).sum(-1)
        d[:, ~ok] = np.inf
        if seg.segment_id == 0:
            d[~(owner[None, :] == best[:, :, None]).any(1)] = np.inf
        parts.append(d)
    ref = np.sort(np.concatenate(parts, axis=1), axis=1)[:, :K]
    assert np.isfinite(ref).all()
    for i in range(len(q)):
        want = dict(zip(hits(exact, i), exact.distances[i]))
        kth = float(exact.distances[i].max())
        for hit, d in zip(hits(tres, i), tres.distances[i]):
            if hit in want:
                np.testing.assert_allclose(d, want[hit], **TOL)
            else:  # L2: no row outside the exact answer is nearer than its k-th
                assert d >= kth - TOL["atol"] - TOL["rtol"] * abs(kth)
        assert (np.sort(tres.distances[i]) <= ref[i] + TOL["atol"] + TOL["rtol"] * ref[i]).all()
    jdb.close()
    tdb.close()


def test_two_stage_plain_segments_search_through_programs():
    """Under two_stage_search the IVF segment takes the eager first pass
    and re-rank; the index-less segment calls `VectorIndex.search` with the
    table's cache: JAX's hits."""
    (jdb, jt), (tdb, tt), q = _ivf_pair()
    caps = _count("SearchProgramCaptures")
    for ms, t in ((jms, jt), (tms, tt)):
        t.settings.query.two_stage_search = True
    _same(jt.search("vec", q, k=K, params={"nprobe": 4}),
          tt.search("vec", q, k=K, params={"nprobe": 4}))
    assert _count("SearchProgramCaptures") - caps == 1 and len(tt._programs) == 1
    jdb.close()
    tdb.close()


def test_launch_record_counts_on_replay():
    """`recording_launches` keeps a capture's launches off the counters;
    `add_launches` counts them once per replay."""
    def wrapper():
        pass

    wrapper.launches = wrapper.launches_f32 = 0
    with _cuda.recording_launches() as rec:
        _cuda.count_launch(wrapper)
        _cuda.count_launch(wrapper, f32=True)
    assert (wrapper.launches, len(rec)) == (0, 2)
    for _ in range(3):
        _cuda.add_launches(rec)
    assert (wrapper.launches, wrapper.launches_f32) == (6, 3)
    _cuda.count_launch(wrapper)
    assert wrapper.launches == 7


def test_program_checks_its_inputs():
    prog = program.Program(lambda q, m, d: q.to(torch.int32), device="cpu",
                           query=((8, 4), torch.float32), masks=[None], out_shape=(8, 4),
                           label="test")
    out = prog.run(np.ones((3, 4), np.float32), [None])
    assert out.tolist() == [[1] * 4] * 3 + [[0] * 4] * 5
    with pytest.raises(ValueError, match="mask"):
        prog.run(np.ones((3, 4), np.float32), [torch.ones(4, dtype=torch.bool)])
    with pytest.raises(ValueError, match="nprobe"):
        prog.run(np.ones((3, 4), np.float32), [None], 3)
    with pytest.raises(TypeError, match="cannot key"):
        base.signature(type("Odd", (), {"__init__": lambda s: setattr(s, "x", object())})(), [])
