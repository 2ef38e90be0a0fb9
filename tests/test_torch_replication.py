"""Replicated index builds in the port (myscaledb_tpu_torch on the CPU),
mirroring tests/test_replication.py: the deterministic picker selects one
builder, which is the JAX package's choice bit for bit; the other replica
loads the published files from the shared store, and falls back to a
local build when they never land (reference:
ReplicatedMergeTreeBuildVIStrategyPicker + the DataPartsExchange index
fetch)."""

import numpy as np
import pytest

import myscaledb_tpu_torch as ms
from myscaledb_tpu.service.replication import pick_build_replica as jax_pick
from myscaledb_tpu_torch.index.base import IndexStatus
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.service.replication import ReplicaContext, pick_build_replica


def _settings():
    st = ms.Settings()
    st.table.min_rows_to_build_vector_index = 100
    st.table.build_vector_index_on_random_single_replica = True
    st.table.storage_dtype = "float32"
    return st


def test_picker_deterministic_and_spread():
    picks = [pick_build_replica("t", seg, "idx", 3) for seg in range(60)]
    assert picks == [pick_build_replica("t", seg, "idx", 3) for seg in range(60)]
    assert set(picks) == {0, 1, 2}  # spreads over replicas
    # the JAX package's picker: a mixed replica set builds each index once
    for n in (2, 3, 5):
        for table in ("t", "r", "sift"):
            assert [pick_build_replica(table, s, "ivf", n) for s in range(40)] == [
                jax_pick(table, s, "ivf", n) for s in range(40)
            ]
    with pytest.raises(ValueError):
        ReplicaContext(2, 2)


def test_single_builder_and_fetch(tmp_path):
    """Two replicas over one shared store: exactly one builds each
    (segment, index); the other loads the published files."""
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((3000, 16)).astype(np.float32)
    cols = {"id": np.arange(3000, dtype=np.uint64), "vec": vecs}
    schema = ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(16)})
    dbs = [
        ms.connect(_settings(), path=str(tmp_path), replica_id=i, n_replicas=2, device="cpu")
        for i in range(2)
    ]
    try:
        ts = [db.create_table("r", schema, settings=_settings()) for db in dbs]
        for t in ts:
            t.insert(cols)  # the same part on both replicas
        builder = pick_build_replica("r", 0, "ivf", 2)
        builds = GLOBAL_COUNTERS.get("VectorIndexBuilds")
        fetches = GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFetches")
        # the builder adds first so the fetcher has something to find
        for t in (ts[builder], ts[1 - builder]):
            t.add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=8)
            assert t.wait_index_built(120)
        assert GLOBAL_COUNTERS.get("VectorIndexBuilds") == builds + 1
        assert GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFetches") == fetches + 1
        want = None
        for t in ts:
            assert t._slots[(0, "ivf")].status == IndexStatus.LOADED
            res = t.search("vec", vecs[40:48], k=5, params={"nprobe": 2})
            ids = t.gather(res, ["id"])["id"].astype(int)
            assert (ids[:, 0] == np.arange(40, 48)).all()
            # the fetched index is the builder's: equal ids at a partial nprobe
            want = ids if want is None else want
            np.testing.assert_array_equal(ids, want)
    finally:
        for db in dbs:
            db.close()


def test_fetch_timeout_falls_back_to_local_build(tmp_path):
    """A lone non-builder replica times out waiting and builds locally."""
    rng = np.random.default_rng(22)
    st = _settings()
    vecs = rng.standard_normal((1000, 8)).astype(np.float32)
    schema = ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(8)})
    other = 1 - pick_build_replica("solo", 0, "i", 2)
    db = ms.connect(st, path=str(tmp_path), replica_id=other, n_replicas=2, device="cpu")
    try:
        t = db.create_table("solo", schema, settings=st)
        t.replica.fetch_timeout_s = 0.3
        t.insert({"id": np.arange(1000, dtype=np.uint64), "vec": vecs})
        before = GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFailedFetches")
        t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=8)
        assert t.wait_index_built(60)
        assert GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFailedFetches") > before
        assert t._slots[(0, "i")].status == IndexStatus.LOADED
    finally:
        db.close()
