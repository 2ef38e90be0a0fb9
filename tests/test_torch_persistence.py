"""Checkpoints, the index cache, the cold tier and the system logs: the port
(myscaledb_tpu_torch, on the CPU) against the JAX package.

A checkpoint written by one package's `Table.persist` loads through the
other's `Database.load_table`, in both directions, and both then search
to the same ids: one table per direction holds a bf16 payload with one
index kind per vector column (FLAT, IVFFLAT, IVFSQ, IVFPQ, MSTG,
HNSWFLAT, HNSWPQ, BinaryMSTG), an fts index, String columns, a small part
and deletes. The loaded side's indexes come back BUILT and load on their
first search. HNSWPQ keeps the deliberate divergence of the port's graph
search (ROADMAP queue 3: a neighbour two expanded nodes share enters the
pool once), so it is held, as in tests/test_torch_hnsw.py, to ids recall
>= 0.9 against JAX; BinaryMSTG's Hamming scores are integers with ties,
so its scores must be equal and its ids wherever no tie spans the k-th
place.

Then the format rules (checksum guard, v1 -> v2 migration of void `|V2`
arrays, `.tmp` resume, future versions), detach / attach / rename, LRU
eviction with CACHE_EXPIRE and the lazy reload, the build-memory retry
after an eviction, the object-store cold start and the system logs across
a restart.
"""

import json
import os
import shutil

import numpy as np
import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.storage import persistence as jpersistence
from myscaledb_tpu_torch.errors import IndexBuildMemoryError, PersistenceError
from myscaledb_tpu_torch.index.base import IndexStatus
from myscaledb_tpu_torch.ops.distance import KERNEL_SUM_TOL
from myscaledb_tpu_torch.storage import persistence
from myscaledb_tpu_torch.storage.stores import (
    MANIFEST,
    LocalStore,
    MemoryStore,
    S3Store,
    store_from_url,
    sync_dir_from_store,
    sync_dir_to_store,
)

D, BITS, N1, N2, NQ, K = 16, 64, 2048, 300, 8, 10
TOL = dict(rtol=2e-4, atol=2e-3)
DELETED = list(range(5, N1 + N2, 58))
# vector column -> (index type, build params, search params)
KINDS = {
    "v_flat": ("FLAT", {}, {}),
    "v_ivfflat": ("IVFFLAT", {"ncentroids": 16}, {"nprobe": 4}),
    "v_ivfsq": ("IVFSQ", {"ncentroids": 16}, {"nprobe": 4}),
    "v_ivfpq": ("IVFPQ", {"ncentroids": 16, "M": 4}, {"nprobe": 4}),
    "v_mstg": ("MSTG", {"ncentroids": 16}, {"nprobe": 4}),
    "v_hnsw": ("HNSWFLAT", {"m": 16, "ef_c": 40}, {"ef_s": 64}),
    "v_hnswpq": ("HNSWPQ", {"m": 16, "ef_c": 40, "M": 4}, {"ef_s": 64}),
    "bv": ("BinaryMSTG", {"ncentroids": 8}, {"nprobe": 4}),
}


def _connect(ms, settings=None, **kw):
    return ms.connect(settings, **kw) if ms is jms else ms.connect(settings, device="cpu", **kw)


def _settings(ms, min_rows=1000):
    st = ms.Settings()
    st.table.min_rows_to_build_vector_index = min_rows
    st.query.cost_based_index_routing = False  # the graph is searched, not routed to the scan
    st.server.system_log_flush_interval_s = 0  # flushed on close only
    return st


def _columns():
    rng = np.random.default_rng(20261017)
    n = N1 + N2
    centers = 6.0 * rng.standard_normal((24, D)).astype(np.float32)
    cols = {"id": np.arange(n, dtype=np.uint64),
            "tag": np.array([f"t{i % 5}" for i in range(n)], dtype=object),
            "body": np.array([" ".join(rng.choice([f"w{j}" for j in range(30)], 5))
                              for _ in range(n)], dtype=object)}
    for c in KINDS:
        if c != "bv":
            cols[c] = (centers[rng.integers(0, 24, n)]
                       + rng.standard_normal((n, D))).astype(np.float32)
    cols["bv"] = rng.integers(0, 256, (n, BITS // 8), dtype=np.uint8)
    qi = rng.choice(n, NQ, replace=False)
    queries = {c: (cols[c][qi] + 0.3 * rng.standard_normal((NQ, D))).astype(np.float32)
               for c in KINDS if c != "bv"}
    queries["bv"] = cols["bv"][qi] ^ rng.integers(0, 2, (NQ, BITS // 8), dtype=np.uint8)
    return cols, queries


def _schema(ms):
    cols = {"id": ms.UInt64(), "tag": ms.String(), "body": ms.String()}
    cols.update({c: ms.FloatVector(D) for c in KINDS if c != "bv"})
    cols["bv"] = ms.BinaryVector(BITS)
    return ms.Schema(cols)


def _build(ms, path):
    """A persisted table of every kind (bf16 payload): a 2,048-row part
    with indexes, a 300-row small part, 40 deletes, an fts index."""
    cols, queries = _columns()
    db = _connect(ms, _settings(ms), path=path)
    t = db.create_table("t", _schema(ms))
    t.add_fts_index("ft", "body")
    t.insert({c: v[:N1] for c, v in cols.items()})
    t.insert({c: v[N1:] for c, v in cols.items()})
    for c, (kind, params, _) in KINDS.items():
        t.add_vector_index(f"i_{c}", c, type=kind, **params)
    assert t.wait_index_built(600)
    assert t.delete(ms.F("id").isin(DELETED)) == len(DELETED)
    t.persist()
    return db, t, queries


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """{direction: (writer table, loaded table, queries)}, the writer's
    table live and the loader's freshly loaded from its checkpoint."""
    out, dbs = {}, []
    for name, writer, loader in (("jax_to_port", jms, tms), ("port_to_jax", tms, jms)):
        path = str(tmp_path_factory.mktemp(name))
        wdb, wt, queries = _build(writer, path)
        ldb = _connect(loader, _settings(loader), path=path)
        lt = ldb.load_table("t")
        out[name] = (wt, lt, queries)
        dbs += [wdb, ldb]
    yield out
    for db in dbs:
        db.close()


def _statuses(t, index):
    return {sid: s.status.value for (sid, n), s in t._slots.items() if n == index}


def _pair(crossed, direction):
    wt, lt, q = crossed[direction]
    return (wt, lt) if direction == "jax_to_port" else (lt, wt)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("column", list(KINDS))
def test_checkpoint_crosses_and_searches_alike(crossed, direction, column):
    jt, tt = _pair(crossed, direction)
    loaded = crossed[direction][1]
    q = crossed[direction][2][column]
    index = f"i_{column}"
    assert _statuses(loaded, index) == {0: "Built", 1: "Small"}
    _, _, params = KINDS[column]
    jres = jt.search(column, q, k=K, params=params or None)
    tres = tt.search(column, q, k=K, params=params or None)
    assert _statuses(loaded, index)[0] == "Loaded"  # reloaded on the first search
    events = [e["event"] for e in loaded.event_log.rows() if e["index_name"] == index]
    assert events[-2:] == ["LoadStart", "LoadSucceed"]
    ids_t = tt.gather(tres, ["id"])["id"]
    assert not set(ids_t[tres.valid].tolist()) & set(DELETED)  # no deleted row
    kind = KINDS[column][0]
    if kind == "HNSWPQ":
        hit = sum(len(set(a) & set(b)) for a, b in zip(tres.rows.tolist(), jres.rows.tolist()))
        assert hit / jres.rows.size >= 0.9
        return
    if kind == "BinaryMSTG":
        np.testing.assert_array_equal(tres.scores, jres.scores)
        strict = tres.scores > tres.scores[:, -1:]  # better than the k-th: no tie at the cut
        np.testing.assert_array_equal(np.sort(np.where(strict, tres.rows, -1)),
                                      np.sort(np.where(strict, jres.rows, -1)))
        return
    np.testing.assert_array_equal(tres.segments, jres.segments)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    # the port's exact scan carries its kernels' bf16 hi/lo query split
    # (distance.kernel_error_bound: 2^-16 of sum |q_i x_i|, x2 for L2), which
    # these rows' large norms (|x|^2 ~ 900) lift above the f32 tolerance
    x = np.array(tt.gather(tres, [column])[column].tolist(), np.float64)
    split = 2 * KERNEL_SUM_TOL * np.abs(q[:, None, :] * x).sum(-1)
    gap = np.abs(tres.distances - jres.distances)
    assert (gap <= TOL["atol"] + TOL["rtol"] * np.abs(jres.distances) + split).all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_fts_and_rows(crossed, direction):
    jt, tt = _pair(crossed, direction)
    loaded = crossed[direction][1]
    assert loaded.n_rows == N1 + N2 - len(DELETED) and jt.n_rows == tt.n_rows
    jres = jt.text_search("ft", ["w1 w2", "w3"], k=K)
    tres = tt.text_search("ft", ["w1 w2", "w3"], k=K)
    np.testing.assert_array_equal(tres.rows, jres.rows)
    np.testing.assert_allclose(tres.scores, jres.scores, rtol=1e-6)
    for c in ("id", "tag", "body"):
        np.testing.assert_array_equal(tt.gather(tres, [c])[c], jt.gather(jres, [c])[c])


def test_checksum_guard(tmp_path):
    cols, _ = _columns()
    db = _connect(tms, _settings(tms), path=str(tmp_path))
    t = db.create_table("c", _schema(tms))
    t.insert({c: v[:500] for c, v in cols.items()})
    t.persist()
    db.close()
    with open(tmp_path / "c" / "segment_0" / "columns.npz", "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    db2 = _connect(tms, _settings(tms), path=str(tmp_path))
    with pytest.raises(PersistenceError, match="checksum"):
        db2.load_table("c")
    db2.close()


def _ivf_checkpoint(tmp_path):
    st = _settings(tms, min_rows=100)
    db = _connect(tms, st, path=str(tmp_path))
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    vecs = np.random.default_rng(0).standard_normal((3000, D)).astype(np.float32)
    t.insert({"id": np.arange(3000, dtype=np.uint64), "vec": vecs})
    t.add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=16)
    assert t.wait_index_built()
    t.persist()
    return db, t, vecs, str(tmp_path / "t" / "segment_0" / "index_ivf")


def test_v1_void_arrays_migrate_and_rewrite(tmp_path):
    """A round-1 (v1) index dir: no format_version, bf16 arrays stored as
    numpy's opaque void `|V2`. Loading migrates it and rewrites it as v2
    (`__bf16`-tagged bits), which the JAX package then reads too."""
    db, t, vecs, idir = _ivf_checkpoint(tmp_path)
    with np.load(os.path.join(idir, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    assert "perm_data__bf16" in arrays  # a bf16 payload (the default storage)
    v1 = {(k[: -len("__bf16")] if k.endswith("__bf16") else k):
          (v.view("V2") if k.endswith("__bf16") else v) for k, v in arrays.items()}
    np.savez(os.path.join(idir, "arrays.npz"), **v1)
    with open(os.path.join(idir, "meta.json")) as f:
        meta = json.load(f)
    meta.pop("format_version")
    with open(os.path.join(idir, "meta.json"), "w") as f:
        json.dump(meta, f)
    persistence._write_checksums(idir, ["meta.json", "arrays.npz"])
    seg = t.live_segments()[0]
    inst = persistence.load_index(idir, "cpu", seg.vector("vec"))
    assert inst.n_rows == 3000
    with open(os.path.join(idir, "meta.json")) as f:
        assert json.load(f)["format_version"] == persistence.INDEX_FORMAT_VERSION == 2
    with np.load(os.path.join(idir, "arrays.npz")) as z:
        assert "perm_data__bf16" in z.files and z["perm_data__bf16"].dtype == np.uint16
    bits = t._slots[(0, "ivf")].instance.state_dict()["arrays"]["perm_data"]
    np.testing.assert_array_equal(inst.state_dict()["arrays"]["perm_data"], bits)
    jinst = jpersistence.load_index(idir)
    np.testing.assert_array_equal(np.asarray(jinst.perm_data).view(np.uint16), bits)
    db.close()


def test_future_version_rejected(tmp_path):
    db, t, _, idir = _ivf_checkpoint(tmp_path)
    with open(os.path.join(idir, "meta.json")) as f:
        meta = json.load(f)
    meta["format_version"] = persistence.INDEX_FORMAT_VERSION + 1
    with open(os.path.join(idir, "meta.json"), "w") as f:
        json.dump(meta, f)
    persistence._write_checksums(idir, ["meta.json", "arrays.npz"])
    with pytest.raises(PersistenceError, match="newer"):
        persistence.load_index(idir, "cpu")
    db.close()


def test_interrupted_persist_resumes_and_torn_tmp_is_discarded(tmp_path):
    db, t, vecs, idir = _ivf_checkpoint(tmp_path)
    t.persist()  # a second persist replaces the dir atomically
    assert os.path.isdir(idir) and not os.path.isdir(idir + ".tmp")
    db.close()
    os.rename(idir, idir + ".tmp")  # a crash between serialize and rename
    db2 = _connect(tms, _settings(tms), path=str(tmp_path))
    t2 = db2.load_table("t")
    assert os.path.isdir(idir) and t2.index_status("ivf") == {0: IndexStatus.BUILT}
    r = t2.search("vec", vecs[9], k=1, params={"nprobe": 16})
    assert int(t2.gather(r, ["id"])["id"][0, 0]) == 9
    db2.close()
    sdir = os.path.dirname(idir)
    os.rename(idir, idir + ".tmp")
    with open(os.path.join(idir + ".tmp", "arrays.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\x00garbage\x00")
    assert persistence.resume_tmp_index_dirs(sdir) == 0
    assert not os.path.isdir(idir + ".tmp") and not os.path.isdir(idir)


@pytest.mark.parametrize("with_path", [True, False])
def test_detach_attach_rename(tmp_path, with_path):
    cols, q = _columns()
    kw = {"path": str(tmp_path)} if with_path else {}
    db = _connect(tms, _settings(tms), **kw)
    t = db.create_table("a", _schema(tms))
    t.insert({c: v[:N1] for c, v in cols.items()})
    t.add_vector_index("i", "v_ivfflat", type="IVFFLAT", ncentroids=16)
    assert t.wait_index_built()
    want = t.search("v_ivfflat", q["v_ivfflat"], k=K, params={"nprobe": 4}).rows
    db.detach_table("a")
    user_tables = lambda: [n for n in db.tables() if not n.startswith("system_")]  # noqa: E731
    assert user_tables() == [] and (os.path.isdir(tmp_path / "a") == with_path)
    with pytest.raises(tms.SchemaError):
        db.table("a")
    t2 = db.attach_table("a")
    assert (t2 is t) != with_path  # a checkpoint is reloaded, a live table parked
    np.testing.assert_array_equal(
        t2.search("v_ivfflat", q["v_ivfflat"], k=K, params={"nprobe": 4}).rows, want)
    with pytest.raises(tms.SchemaError):
        db.attach_table("a")
    db.rename_table("a", "b")
    assert user_tables() == ["b"] and db.table("b").name == "b"
    if with_path:
        assert os.path.isdir(tmp_path / "b") and not os.path.exists(tmp_path / "a")
        db.table("b").persist()
        db.close()
        db2 = _connect(tms, _settings(tms), path=str(tmp_path))
        t3 = db2.load_table("b")
        np.testing.assert_array_equal(
            t3.search("v_ivfflat", q["v_ivfflat"], k=K, params={"nprobe": 4}).rows, want)
        db2.close()
    else:
        with pytest.raises(tms.SchemaError):
            db.attach_table("zz")
        db.close()


def test_cache_eviction_expires_and_reloads(tmp_path):
    st = _settings(tms, min_rows=1000)
    st.server.vector_index_cache_size = 1  # one entry at a time
    db = _connect(tms, st, path=str(tmp_path))
    t = db.create_table("e", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((4000, D)).astype(np.float32)
    t.insert({"id": np.arange(4000, dtype=np.uint64), "vec": vecs})
    t.add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=16)
    assert t.wait_index_built()
    t.persist()
    t.insert({"id": np.arange(4000, 6000, dtype=np.uint64),
              "vec": rng.standard_normal((2000, D)).astype(np.float32)})
    assert t.wait_index_built()  # its build's cache entry evicts segment 0's
    assert db.index_cache.evictions > 0
    assert t.index_status("ivf")[0] == IndexStatus.BUILT
    expired = [e for e in t.event_log.rows() if e["event"] == "CacheExpire"]
    assert [(e["index_name"], e["segment_id"]) for e in expired] == [("ivf", 0)]
    res = t.search("vec", vecs[3], k=1, params={"nprobe": 16})  # the lazy reload
    assert int(t.gather(res, ["id"])["id"][0, 0]) == 3
    assert t.index_status("ivf")[0] == IndexStatus.LOADED
    assert [e["event"] for e in t.event_log.rows()][-2:] == ["LoadStart", "LoadSucceed"]
    db.close()


def test_build_memory_retry_evicts_then_builds(tmp_path):
    """A build refused by the memory budget evicts cached indexes worth its
    estimate and retries (VIBuilderUpdater.cpp:639-657): the persisted
    index demotes to BUILT (CACHE_EXPIRE), the retry succeeds."""
    st = _settings(tms, min_rows=1000)
    db = _connect(tms, st, path=str(tmp_path))
    t = db.create_table("r", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    rng = np.random.default_rng(2)
    t.insert({"id": np.arange(3000, dtype=np.uint64),
              "vec": rng.standard_normal((3000, D)).astype(np.float32)})
    t.add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=16)
    assert t.wait_index_built()
    t.persist()
    refusals = []
    real = t._check_build_memory

    def once(nbytes):
        if not refusals:
            refusals.append(nbytes)
            raise IndexBuildMemoryError("budget")
        return real(nbytes)

    t._check_build_memory = once
    t.insert({"id": np.arange(3000, 6000, dtype=np.uint64),
              "vec": rng.standard_normal((3000, D)).astype(np.float32)})
    assert t.wait_index_built()
    assert refusals and t.index_status("ivf") == {0: IndexStatus.BUILT, 1: IndexStatus.LOADED}
    events = [(e["event"], e["segment_id"]) for e in t.event_log.rows()]
    tail = events[events.index(("BuildError", 1)):]
    assert ("CacheExpire", 0) in tail and tail[-1] == ("BuildSucceed", 1)
    assert t._slots[(1, "ivf")].retries == 1
    db.close()


def test_cold_start_from_object_stores(tmp_path):
    for store in (MemoryStore(), LocalStore(str(tmp_path / "bucket"))):
        st = _settings(tms, min_rows=1)
        st.table.storage_policy = "remote"
        name = type(store).__name__
        db = _connect(tms, st, path=str(tmp_path / name / "warm"), remote_store=store)
        t = db.create_table("tt", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(8)}))
        vecs = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
        t.insert({"id": np.arange(64, dtype=np.uint64), "vec": vecs})
        t.add_vector_index("iv", "vec", type="IVFFLAT", ncentroids=4, metric_type="L2")
        assert t.wait_index_built()
        t.persist()
        assert store.exists(f"tables/tt/{MANIFEST}")
        db.close()
        db2 = _connect(tms, st, path=str(tmp_path / name / "cold"), remote_store=store)
        t2 = db2.load_table("tt")
        r = t2.search("vec", vecs[:3], k=1)
        assert list(r.rows[:, 0]) == [0, 1, 2]
        assert t2.system_vector_indices()[0]["status"] in ("Built", "Loaded")
        db2.close()
        store.delete(f"tables/tt/{MANIFEST}")  # no commit point: nothing to load
        db3 = _connect(tms, st, path=str(tmp_path / name / "cold2"), remote_store=store)
        with pytest.raises(tms.SchemaError):
            db3.load_table("tt")
        db3.close()


def test_store_protocol(tmp_path):
    store = MemoryStore()
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.bin").write_bytes(b"aaaa")
    (src / "b.bin").write_bytes(b"bbbb")
    sync_dir_to_store(store, "p", str(src))
    (src / "b.bin").unlink()
    (src / "c.bin").write_bytes(b"cccc")
    sync_dir_to_store(store, "p", str(src))
    assert not store.exists("p/b.bin") and store.exists("p/c.bin")
    dst = tmp_path / "dst"
    assert sync_dir_from_store(store, "p", str(dst))
    assert sorted(f.name for f in dst.iterdir()) == ["a.bin", "c.bin"]
    store.put("p/a.bin", b"tampered")
    with pytest.raises(PersistenceError, match="sha mismatch"):
        sync_dir_from_store(store, "p", str(tmp_path / "dst2"))

    class FakeS3:
        def __init__(self):
            self.objects = {}

        def put_object(self, Bucket, Key, Body):
            self.objects[(Bucket, Key)] = bytes(Body)

        def get_object(self, Bucket, Key):
            return {"Body": self.objects[(Bucket, Key)]}

        def head_object(self, Bucket, Key):
            if (Bucket, Key) not in self.objects:
                raise KeyError(Key)

        def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
            keys = sorted(k for b, k in self.objects if b == Bucket and k.startswith(Prefix))
            return {"Contents": [{"Key": k} for k in keys], "IsTruncated": False}

        def delete_object(self, Bucket, Key):
            self.objects.pop((Bucket, Key), None)

    s3 = S3Store("bkt", "root", client=FakeS3())
    s3.put("x/a", b"1")
    s3.put("x/b", b"2")
    assert s3.exists("x/a") and s3.get("x/b") == b"2" and s3.list_prefix("x/") == ["x/a", "x/b"]
    s3.delete("x/a")
    with pytest.raises(PersistenceError):
        s3.get("x/a")
    local = store_from_url(f"file://{tmp_path}/store")
    local.put("d/e.bin", b"xyz")
    assert local.get("d/e.bin") == b"xyz" and local.list_prefix("d/") == ["d/e.bin"]
    with pytest.raises(PersistenceError):
        local.put("../escape", b"no")
    with pytest.raises(PersistenceError):
        store_from_url("gs://nope")


def test_system_logs_survive_restart(tmp_path):
    st = _settings(tms, min_rows=1)
    db = _connect(tms, st, path=str(tmp_path))
    t = db.create_table("qlog_port_t", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(8)}))
    t.insert({"id": np.arange(64, dtype=np.uint64),
              "vec": np.random.default_rng(4).standard_normal((64, 8)).astype(np.float32)})
    t.add_vector_index("ix", "vec", type="FLAT")
    assert t.wait_index_built()
    t.search("vec", np.zeros(8, np.float32), k=4)
    before = len(db.system_table("query_log"))
    assert db.system_logs.flush() > 0
    db.system_logs.flush()  # a second flush adds nothing
    assert len(db.system_table("query_log")) == before
    db.close()
    db2 = _connect(tms, st, path=str(tmp_path))
    rows = [r for r in db2.system_table("query_log") if r["table"] == "qlog_port_t"]
    assert rows and rows[0]["kind"] == "vector_search" and isinstance(rows[0]["settings"], dict)
    events = [r for r in db2.system_table("vector_index_event_log") if r["table"] == "qlog_port_t"]
    built = [r for r in events if r["event"] == "BuildSucceed"]
    assert built and built[0]["index_name"] == "ix" and built[0]["segment_id"] == 0
    assert "DefinitionCreated" in {r["event"] for r in events}
    db2.close()
    shutil.rmtree(tmp_path / "qlog_port_t", ignore_errors=True)
