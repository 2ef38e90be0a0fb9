"""The port's ShardedTable (myscaledb_tpu_torch on the CPU) against the JAX
package's, mirroring tests/test_sharded_table.py: the same seeded numpy
rows go into a JAX and a port sharded table, and the fan-out with the
initiator's fusion must agree: `_stable_shard` bit for bit, the global
(shard, segment, row) ids equal (the inputs have no ties), scores within
the reference's f32 tolerance (rtol 2e-4, atol 2e-3); the text legs score
against cluster-wide BM25 statistics, so a sharded table's BM25 scores
equal the unsharded table's."""

import numpy as np
import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.parallel.sharded_table import _stable_shard as jax_stable_shard
from myscaledb_tpu_torch.parallel.sharded_table import ShardedTable, _stable_shard

TOL = dict(rtol=2e-4, atol=2e-3)
D, N, NQ = 24, 600, 6
WORDS = ["red", "fox", "dog", "lazy", "fast", "car", "blue", "whale", "tpu", "vector",
         "search", "night", "sky", "ball", "engine", "deep", "quiet", "loud"]


def _data(seed):
    rng = np.random.default_rng(seed)
    docs = np.array(
        [" ".join(rng.choice(WORDS, size=rng.integers(3, 9))) for _ in range(N)], dtype=object
    )
    return {
        "id": np.arange(N, dtype=np.uint64),
        "body": docs,
        "vec": rng.standard_normal((N, D)).astype(np.float32),
    }, rng.standard_normal((NQ, D)).astype(np.float32)


def _schema(pkg):
    return pkg.Schema({"id": pkg.UInt64(), "body": pkg.String(), "vec": pkg.FloatVector(D)})


@pytest.fixture()
def dbs():
    jdb, tdb = jms.connect(), tms.connect(device="cpu")
    yield jdb, tdb
    jdb.close()
    tdb.close()


def _sharded(db, pkg, cols, n_shards, settings=None):
    t = db.create_sharded_table("sh", _schema(pkg), n_shards=n_shards, shard_key="id",
                                settings=settings)
    t.add_fts_index("ft", "body")
    t.insert(cols)
    return t


def _same_hits(jres, tres, check_scores=True):
    for f in ("shards", "segments", "rows"):
        np.testing.assert_array_equal(getattr(tres, f), getattr(jres, f), err_msg=f)
    if check_scores:
        np.testing.assert_allclose(tres.scores, jres.scores, **TOL)
        np.testing.assert_allclose(tres.distances, jres.distances, **TOL)


@pytest.mark.parametrize("kind", ["uint64", "int32", "str"])
def test_stable_shard_matches_jax(kind):
    rng = np.random.default_rng(41)
    keys = {
        "uint64": rng.integers(0, 2**63, 5000, dtype=np.uint64),
        "int32": rng.integers(-2**31, 2**31 - 1, 5000, dtype=np.int32),
        "str": np.array([f"user-{i}-é" for i in rng.integers(0, 10**9, 500)], dtype=object),
    }[kind]
    for n in (1, 3, 4, 7):
        got = _stable_shard(keys, n)
        np.testing.assert_array_equal(got, jax_stable_shard(keys, n))
        assert got.dtype == np.int64 and got.min() >= 0 and got.max() < n


def test_sharded_vector_matches_single_and_jax(dbs):
    jdb, tdb = dbs
    cols, q = _data(42)
    single = tdb.create_table("single", _schema(tms))
    single.insert(cols)
    jt, tt = _sharded(jdb, jms, cols, 3), _sharded(tdb, tms, cols, 3)
    assert isinstance(tt, ShardedTable) and tms.ShardedTable is ShardedTable
    assert tt.n_rows == N and [s.n_rows for s in tt.shards] == [s.n_rows for s in jt.shards]
    for metric in ("L2", "IP", "Cosine"):
        tres = tt.search("vec", q, k=10, metric=metric)
        _same_hits(jt.search("vec", q, k=10, metric=metric), tres)
        rs = single.search("vec", q, k=10, metric=metric)
        np.testing.assert_array_equal(
            tt.gather(tres, ["id"])["id"], single.gather(rs, ["id"])["id"])
        np.testing.assert_allclose(tres.distances, rs.distances, rtol=1e-6)


def test_sharded_bm25_matches_single_and_jax(dbs):
    jdb, tdb = dbs
    cols, _ = _data(43)
    single = tdb.create_table("single", _schema(tms))
    single.add_fts_index("ft", "body")
    single.insert(cols)
    jt, tt = _sharded(jdb, jms, cols, 3), _sharded(tdb, tms, cols, 3)
    for text in ("red dog", "vector tpu engine", "fox", "quiet night sky"):
        tres = tt.text_search("body", text, k=8)
        jres = jt.text_search("body", text, k=8)
        # cluster statistics: the unsharded table's scores, not per-shard ones
        rs = single.text_search("body", text, k=8)
        np.testing.assert_allclose(np.sort(tres.scores[0]), np.sort(rs.scores[0]), rtol=1e-6)
        np.testing.assert_allclose(tres.scores, jres.scores, rtol=2**-18)
        # ids where no tie spans the k-th place (BM25 ties are common)
        kth = jres.scores[0, -1]
        sure = jres.scores[0] > kth + 1e-5
        got = set(zip(tt.gather(tres, ["id"])["id"][0][tres.scores[0] > kth + 1e-5]))
        want = set(zip(jt.gather(jres, ["id"])["id"][0][sure]))
        assert got == want, text


def test_sharded_hybrid_and_filters(dbs):
    jdb, tdb = dbs
    cols, q = _data(44)
    jt, tt = _sharded(jdb, jms, cols, 2), _sharded(tdb, tms, cols, 2)
    for fusion in ("rrf", "rsf"):
        tres = tt.hybrid_search("vec", "body", cols["vec"][6], "red dog", k=5, fusion_type=fusion)
        jres = jt.hybrid_search("vec", "body", cols["vec"][6], "red dog", k=5, fusion_type=fusion)
        _same_hits(jres, tres, check_scores=False)
        np.testing.assert_allclose(tres.scores, jres.scores, **TOL)
        assert 6 in tt.gather(tres, ["id"])["id"][0].astype(int)
    # filtered fan-out
    flt_t, flt_j = tms.F("id") >= 300, jms.F("id") >= 300
    tres = tt.search("vec", q, k=6, filter=flt_t)
    _same_hits(jt.search("vec", q, k=6, filter=flt_j), tres)
    assert (tt.gather(tres, ["id"])["id"][tres.valid] >= 300).all()
    # deletes reach every shard
    assert tt.delete(tms.F("id") == 6) == 1 == jt.delete(jms.F("id") == 6)
    tres = tt.search("vec", cols["vec"][6], k=3)
    assert int(tt.gather(tres, ["id"])["id"][0, 0]) != 6
    _same_hits(jt.search("vec", cols["vec"][6], k=3), tres)


def test_sharded_index_ddl(dbs):
    jdb, tdb = dbs
    cols, q = _data(45)
    tables = []
    for db, pkg in ((jdb, jms), (tdb, tms)):
        st = pkg.Settings()
        st.table.min_rows_to_build_vector_index = 4
        t = db.create_sharded_table("sh", _schema(pkg), n_shards=2, settings=st, shard_key="id")
        t.insert(cols)
        t.add_vector_index("v", "vec", type="IVFFLAT", ncentroids=4)
        assert t.wait_index_built(60)
        rows = db.system_table("vector_indices")
        assert len(rows) == 2 and all(r["status"] == "Built" for r in rows)  # one per shard
        tables.append(t)
    # every list probed: the IVF answer is the exact one on both sides
    res = [t.search("vec", q, k=5, params={"nprobe": 4}) for t in tables]
    _same_hits(*res)
    tables[1].drop_vector_index("v")
    assert tdb.system_table("vector_indices") == []
