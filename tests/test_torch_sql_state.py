"""State carried across through SQL, and EXPLAIN's routing inputs.

  * A table checkpointed by `BACKUP TABLE ... TO` through one package's
    SQL is `RESTORE`d through the other's (both directions; the two share
    the checkpoint format). The original and the restored table answer
    the same distance(), batch_distance() and textsearch() SELECTs: ids,
    stored columns and the statement's shape exactly, distances within
    rtol 2e-4 / atol 2e-3 and BM25 scores within 2^-18 (the comparison
    of `tests/test_torch_sql.py`).
  * EXPLAIN of a restored table, whose index is built but not loaded,
    models the route from the index's description
    (`index/hnsw.py::default_ef_search`, `scan_beats_graph`) and from the
    segment payload's `nbytes`: both packages print the same plan, and a
    float payload's `nbytes` is the same number in both.
"""

import numpy as np
import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from test_torch_sql import assert_same_result

N, D = 600, 16
WORDS = ["red", "fox", "lazy", "dog", "blue", "whale", "night", "sky", "fast", "car"]

INDEXES = {
    "none": "",
    "ivfflat": ", VECTOR INDEX vi vec TYPE IVFFLAT('ncentroids=4')",
    "hnswflat": ", VECTOR INDEX vi vec TYPE HNSWFLAT('m=16')",
}


def _connect(side):
    st = jms.Settings() if side == "jax" else tms.Settings()
    st.table.min_rows_to_build_vector_index = 100
    return jms.connect(st) if side == "jax" else tms.connect(st, device="cpu")


def _create(db, index):
    db.sql(
        f"CREATE TABLE kt (id UInt64, body String, vec Array(Float32), "
        f"CONSTRAINT c CHECK length(vec) = {D}{INDEXES[index]}, "
        "INDEX ft body TYPE fts('{}')) ENGINE = MergeTree ORDER BY id"
    )
    rng = np.random.default_rng(11)
    t = db.table("kt")
    t.insert({
        "id": np.arange(N, dtype=np.uint64),
        "body": np.asarray([" ".join(rng.choice(WORDS, 5)) for _ in range(N)], object),
        "vec": rng.standard_normal((N, D)).astype(np.float32),
    })
    if index != "none":
        assert t.wait_index_built()
    return rng


def _statements(rng, index):
    qs = rng.standard_normal((3, D)).astype(np.float32)
    lit = lambda v: "[" + ", ".join(repr(float(x)) for x in v) + "]"  # noqa: E731
    # every window, the whole graph: the index answers, and exactly
    params = {"none": "", "ivfflat": "('nprobe=4')", "hnswflat": "('ef_s=600')"}[index]
    route = " SETTINGS cost_based_index_routing=0" if index == "hnswflat" else ""
    out = [
        f"SELECT id, body, distance{params}(vec, {lit(q)}) AS d FROM kt ORDER BY d LIMIT 10{route}"
        for q in qs
    ]
    out.append(
        f"SELECT id, distance{params}(vec, {lit(qs[0])}) AS d FROM kt "
        f"WHERE id < 300 ORDER BY d LIMIT 5{route}"
    )
    out.append(
        "SELECT id, batch_distance(vec, [" + ", ".join(lit(q) for q in qs) + "]) AS d "
        "FROM kt ORDER BY d.2 LIMIT 4 BY d.1"
    )
    out += [
        f"SELECT id, textsearch(body, '{w}') AS s FROM kt ORDER BY s DESC LIMIT 8"
        for w in ("red fox", "lazy dog night", "whale")
    ]
    out.append("SELECT count() FROM kt")
    return out


def _run(db, stmt):
    try:
        return db.sql(stmt), None
    except Exception as e:  # noqa: BLE001 — compared by type
        return None, e


@pytest.mark.parametrize("index", list(INDEXES))
@pytest.mark.parametrize("src_side", ["jax", "torch"])
def test_backup_in_one_package_restores_in_the_other(tmp_path, src_side, index):
    dst_side = "torch" if src_side == "jax" else "jax"
    src, dst = _connect(src_side), _connect(dst_side)
    try:
        rng = _create(src, index)
        dest = str(tmp_path / "bk")
        assert src.sql(f"BACKUP TABLE kt TO '{dest}'") == [{"backed_up": "kt", "path": dest}]
        assert dst.sql(f"RESTORE TABLE kt FROM '{dest}'") == [{"restored": "kt"}]
        stmts = _statements(rng, index)
        for stmt in stmts:
            js, ts = (src, dst) if src_side == "jax" else (dst, src)
            ra, ea = _run(js, stmt)
            rb, eb = _run(ts, stmt)
            assert ea is None, (stmt, ea)
            assert_same_result(stmt, ra, ea, rb, eb, {"id", "body", "vec"})
        if index != "none":
            # the restored index answered (the searches loaded it)
            desc = dst.sql("SELECT name, type, status FROM system.vector_indices")
            assert [(r["name"], r["type"], r["status"]) for r in desc] == [
                ("vi", index.upper(), "Built")
            ]
            seg = dst.table("kt").live_segments()[0]
            metric = jms.Metric.L2 if dst_side == "jax" else tms.Metric.L2
            assert dst.table("kt").peek_index(seg.segment_id, "vec", metric) is not None
    finally:
        src.close()
        dst.close()


def test_explain_of_a_restored_index_matches(tmp_path):
    """Both packages restore one checkpoint (JAX's) and print the same
    plan before the first search loads the index; a settings overlay that
    turns cost routing off names the graph search in both."""
    src = _connect("jax")
    jdb, tdb = _connect("jax"), _connect("torch")
    try:
        _create(src, "hnswflat")
        dest = str(tmp_path / "bk")
        src.sql(f"BACKUP TABLE kt TO '{dest}'")
        for db in (jdb, tdb):
            db.sql(f"RESTORE TABLE kt FROM '{dest}'")
        base = "EXPLAIN SELECT id, distance(vec, [0.0]) AS d FROM kt ORDER BY d LIMIT 5"
        for stmt in (base, base + " SETTINGS cost_based_index_routing=0"):
            a, b = jdb.sql(stmt), tdb.sql(stmt)
            assert a == b, (a, b)
        text = "\n".join(r["explain"] for r in tdb.sql(base))
        assert "HNSWFLAT -> exact scan (cost route)" in text
        segs = tdb.table("kt").live_segments()
        assert tdb.table("kt").peek_index(segs[0].segment_id, "vec", tms.Metric.L2) is None
    finally:
        for db in (src, jdb, tdb):
            db.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_payload_nbytes_matches(dtype):
    """The bytes EXPLAIN's cost route reads (`seg.vector(col).nbytes`)."""
    sizes = []
    for side in ("jax", "torch"):
        db = _connect(side)
        try:
            db.sql(
                f"CREATE TABLE nb (id UInt64, vec Array(Float32), CONSTRAINT c CHECK "
                f"length(vec) = 40) ENGINE = MergeTree ORDER BY id "
                f"SETTINGS storage_dtype = '{dtype}'"
            )
            vals = ", ".join(f"({i}, {[float(i)] * 40})" for i in range(300))
            db.sql(f"INSERT INTO nb VALUES {vals}")
            seg = db.table("nb").live_segments()[0]
            sizes.append(int(seg.vector("vec").nbytes))
        finally:
            db.close()
    assert sizes[0] == sizes[1] > 0


def test_sql_tables_live_on_the_database_device():
    db = tms.connect(device="cpu")
    try:
        db.sql("CREATE TABLE dv (id UInt64, vec Array(Float32), CONSTRAINT c CHECK length(vec) = 4)")
        db.sql("INSERT INTO dv VALUES (1, [1.0, 0, 0, 0])")
        t = db.table("dv")
        assert t.device == db.device
        assert t.live_segments()[0].vector("vec").data.device == db.device
    finally:
        db.close()
