"""The replicated data path of the port (myscaledb_tpu_torch on the CPU),
mirroring tests/test_data_replication.py test for test: rows inserted on
replica A are searchable on replica B after sync; deletes, mutations,
merges and truncate converge; a restarted replica resumes from its
persisted state; fenced mutations survive a partition. Then what only the
port adds: a replicated UPDATE refreshes the device mirrors and filter
caches a filtered search reads (an exact scan and an IVF window search),
and the mutation fence makes no network call while it holds the node
lock. A JAX node and a port node replicating to each other are in
tests/test_torch_replication_interop.py.

Every wait polls with its own deadline.
"""

import time
import urllib.request

import numpy as np

import myscaledb_tpu_torch as ms
from myscaledb_tpu_torch import F
from myscaledb_tpu_torch.service import data_replication
from myscaledb_tpu_torch.service.data_replication import ReplicatedNode
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

DIM = 16


def _schema():
    return ms.Schema({"id": ms.UInt64(), "score": ms.Float32(), "vec": ms.FloatVector(DIM)})


def _mk_node(tmp_path, name, settings=None):
    db = ms.connect(settings, device="cpu")
    t = db.create_table("rt", _schema())
    node = ReplicatedNode(db, name, str(tmp_path / name))
    node.attach(t)
    return db, t, node


def _pair(tmp_path, settings=None):
    db_a, t_a, a = _mk_node(tmp_path, "a", settings)
    db_b, t_b, b = _mk_node(tmp_path, "b", settings)
    a.peers = [b.url]
    b.peers = [a.url]
    return (db_a, t_a, a), (db_b, t_b, b)


def _rows(rng, n, base=0):
    return {
        "id": np.arange(base, base + n, dtype=np.uint64),
        "score": rng.random(n).astype(np.float32),
        "vec": rng.standard_normal((n, DIM)).astype(np.float32),
    }


def _close(*objs):
    for o in objs:
        o.close()


def _ids(t, res):
    return np.asarray(t.gather(res, ["id"])["id"])[np.asarray(res.valid)].astype(int)


def test_insert_replicates(tmp_path):
    rng = np.random.default_rng(1)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        data = _rows(rng, 200)
        t_a.insert(data)
        assert t_b.n_rows == 0
        assert b.sync() >= 1
        assert t_b.n_rows == 200
        # replica B answers a search for rows inserted only on replica A
        res = t_b.search("vec", data["vec"][17], k=1)
        assert int(t_b.gather(res, ["id"])["id"][0, 0]) == 17
        # B's hits equal A's: the payload B built from the fetched f32
        # columns scores as A's does
        q = rng.standard_normal((4, DIM)).astype(np.float32)
        ra, rb = t_a.search("vec", q, k=10), t_b.search("vec", q, k=10)
        np.testing.assert_array_equal(_ids(t_a, ra), _ids(t_b, rb))
        np.testing.assert_array_equal(ra.scores, rb.scores)
        # no duplicate on re-sync (idempotent by uid)
        assert b.sync() == 0
        assert t_b.n_rows == 200
        # and A does not re-ingest its own rows when pulling from B
        a.sync()
        assert t_a.n_rows == 200
    finally:
        _close(a, b, db_a, db_b)


def test_bidirectional_and_deletes_converge(tmp_path):
    rng = np.random.default_rng(2)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 100))
        t_b.insert(_rows(rng, 50, base=1000))
        a.sync(), b.sync()
        assert t_a.n_rows == 150 and t_b.n_rows == 150
        # delete on A (rows that originated on B!) converges to B
        t_a.delete(F("id") >= 1030)
        assert t_a.n_rows == 130
        b.sync()
        assert t_b.n_rows == 130
        res = t_b.search("vec", np.zeros(DIM, np.float32), k=150)
        assert (_ids(t_b, res) < 1030).all()
    finally:
        _close(a, b, db_a, db_b)


def test_mutation_replicates(tmp_path):
    rng = np.random.default_rng(3)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 60))
        b.sync()
        t_a.update(F("id") < 10, {"score": 9.5})
        b.sync()
        res = t_b.search("vec", np.zeros(DIM, np.float32), k=60)
        g = t_b.gather(res, ["id", "score"])
        sel = g["id"][res.valid] < 10
        assert sel.sum() == 10
        assert np.allclose(g["score"][res.valid][sel], 9.5)
    finally:
        _close(a, b, db_a, db_b)


def test_merge_replicates(tmp_path):
    rng = np.random.default_rng(4)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        # leadership is deterministic: exactly one of the two may merge
        if a.is_merge_leader("rt"):
            (lt, ln), (ft, fn) = (t_a, a), (t_b, b)
        else:
            (lt, ln), (ft, fn) = (t_b, b), (t_a, a)
        lt.insert(_rows(rng, 40))
        lt.insert(_rows(rng, 40, base=40))
        fn.sync()
        assert len(ft.live_segments()) == 2
        lt.delete(F("id") == 7)
        lt.merge()
        assert len(lt.live_segments()) == 1
        fn.sync()
        assert len(ft.live_segments()) == 1
        assert ft.n_rows == 79
        q = np.zeros(DIM, np.float32)
        ids = ft.gather(ft.search("vec", q, k=100), ["id"])["id"]
        assert 7 not in ids.astype(int)
        # the non-leader's merge() is gated off (leader-assigned merges
        # are enforced, not a docstring convention)
        assert ft.merge() is None
        assert len(ft.live_segments()) == 1
    finally:
        _close(a, b, db_a, db_b)


def test_restart_resumes_from_state(tmp_path):
    rng = np.random.default_rng(5)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    data2 = _rows(rng, 30, base=500)
    try:
        t_a.insert(_rows(rng, 30))
        b.sync()
        assert t_b.n_rows == 30
    finally:
        _close(b, db_b)
    # restart B: a new database over the same replica root; catch-up
    # applies the ops its (empty) tables lack, then the new insert, and
    # never one uid twice
    db_b2 = ms.connect(device="cpu")
    t_b2 = db_b2.create_table("rt", _schema())
    b2 = ReplicatedNode(db_b2, "b", str(tmp_path / "b"))
    try:
        b2.attach(t_b2)
        b2.peers = [a.url]
        b2.sync()
        assert t_b2.n_rows == 30
        t_a.insert(data2)
        b2.sync()
        assert t_b2.n_rows == 60
        res = t_b2.search("vec", data2["vec"][3], k=1)
        assert int(t_b2.gather(res, ["id"])["id"][0, 0]) == 503
    finally:
        _close(b2, db_b2, a, db_a)


def test_concurrent_merges_delete_converges(tmp_path):
    """A and B merge the same sources concurrently (divergent merge uids);
    a delete on A still reaches B's copy of those rows: deletes are
    addressed by origin segment + origin rows and resolve through each
    replica's own merge history."""
    rng = np.random.default_rng(6)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 40))
        t_a.insert(_rows(rng, 40, base=40))
        b.sync()
        assert t_a.merge(force=True) is not None
        assert t_b.merge(force=True) is not None
        a.sync(), b.sync()  # each skips the other's merge (sources gone)
        assert len(t_a.live_segments()) == 1
        assert len(t_b.live_segments()) == 1
        assert t_a.n_rows == 80 and t_b.n_rows == 80
        t_a.delete(F("id") < 12)
        assert t_a.n_rows == 68
        b.sync()
        assert t_b.n_rows == 68
        res = t_b.search("vec", np.zeros(DIM, np.float32), k=100)
        ids = _ids(t_b, res)
        assert len(ids) == 68 and (ids >= 12).all()
        # and the reverse direction
        t_b.delete(F("id") >= 70)
        a.sync()
        assert t_a.n_rows == 58
    finally:
        _close(a, b, db_a, db_b)


def test_delete_survives_merge_then_converges(tmp_path):
    """Deletes on rows merged on the publisher (provenance composed through
    its merge) and on rows merged on the applier (resolved through its own
    history)."""
    rng = np.random.default_rng(7)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 30))
        t_a.insert(_rows(rng, 30, base=30))
        b.sync()
        t_b.merge(force=True)
        t_a.delete(F("id").isin([3, 33]))
        b.sync()
        assert t_b.n_rows == 58
        t_a.merge(force=True)
        t_a.delete(F("id") == 55)
        b.sync()
        assert t_b.n_rows == 57
    finally:
        _close(a, b, db_a, db_b)


def test_applier_local_deletes_survive_remote_merge(tmp_path):
    """The follower deletes rows locally; the leader merges before it has
    seen the delete, and the follower applies that merge: its local
    deletes are re-applied to the ingested merged segment."""
    rng = np.random.default_rng(8)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        if a.is_merge_leader("rt"):
            (lt, ln), (ft, fn) = (t_a, a), (t_b, b)
        else:
            (lt, ln), (ft, fn) = (t_b, b), (t_a, a)
        lt.insert(_rows(rng, 30))
        lt.insert(_rows(rng, 30, base=30))
        fn.sync()
        ft.delete(F("id") < 5)
        assert ft.n_rows == 55
        lt.merge()
        fn.sync()
        assert len(ft.live_segments()) == 1
        assert ft.n_rows == 55  # local deletes re-applied, not resurrected
        ln.sync()
        assert lt.n_rows == 55
    finally:
        _close(a, b, db_a, db_b)


def test_three_replica_pending_deletes(tmp_path):
    """C hears of a delete (from B) before the origin insert (from A): the
    delete buffers as pending and drains when the insert lands."""
    rng = np.random.default_rng(9)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    db_c, t_c, c = _mk_node(tmp_path, "c")
    try:
        t_a.insert(_rows(rng, 20))
        b.sync()
        t_b.delete(F("id") < 4)
        c.peers = [b.url]
        c.sync()
        assert t_c.n_rows == 0
        c.peers = [b.url, a.url]
        c.sync()
        assert t_c.n_rows == 16
    finally:
        _close(a, b, c, db_a, db_b, db_c)


def test_background_sync_thread(tmp_path):
    """A node with a sync interval drains its peers without sync() calls
    (the replication-queue thread), and the thread stops on close()."""
    rng = np.random.default_rng(10)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    errors = GLOBAL_COUNTERS.get("ReplicationSyncErrors")
    try:
        b.start_sync(0.05)
        t_a.insert(_rows(rng, 25))
        deadline = time.time() + 10.0
        while time.time() < deadline and t_b.n_rows != 25:
            time.sleep(0.05)
        assert t_b.n_rows == 25
        assert GLOBAL_COUNTERS.get("ReplicationSyncErrors") == errors, b.last_sync_error
    finally:
        _close(a, b, db_a, db_b)
    assert not b._sync_thread.is_alive()


def test_leader_failover(tmp_path):
    """When the leader replica dies, the survivor takes over merges after
    peer_down_after_s."""
    rng = np.random.default_rng(11)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    a.peer_down_after_s = b.peer_down_after_s = 0.2
    a.sync(), b.sync()  # learn each other's node ids
    leaders = [n for n in (a, b) if n.is_merge_leader("rt")]
    assert len(leaders) == 1
    dead = leaders[0]
    survivor, st, sdb = (a, t_a, db_a) if dead is b else (b, t_b, db_b)
    try:
        assert not survivor.is_merge_leader("rt")
        dead.close()
        (db_a if dead is a else db_b).close()
        time.sleep(0.3)  # past peer_down_after_s with no successful pull
        survivor.sync()  # a failed pull does not refresh last_ok
        assert survivor.is_merge_leader("rt")
        st.insert(_rows(rng, 10))
        st.insert(_rows(rng, 10, base=10))
        assert st.merge() is not None  # the gate is open on the survivor
    finally:
        _close(survivor, sdb)


def test_transient_fetch_failure_retries(tmp_path, monkeypatch):
    """A failed segment fetch does not advance the watermark: the entry is
    retried on the next sync."""
    rng = np.random.default_rng(12)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 64))
        real = type(b)._fetch_segment_columns
        fails = {"n": 1}

        def flaky(self, *args, **kw):
            if fails["n"]:
                fails["n"] -= 1
                return None  # a download or checksum failure
            return real(self, *args, **kw)

        monkeypatch.setattr(type(b), "_fetch_segment_columns", flaky)
        assert b.sync() == 0
        assert t_b.n_rows == 0
        assert b.sync() >= 1  # retried from the same watermark
        assert t_b.n_rows == 64
        t_a.delete(F("id") < 8)
        assert b.sync() >= 1
        ids = _ids(t_b, t_b.search("vec", np.zeros(DIM, np.float32), k=64))
        assert len(ids) == 56 and (ids >= 8).all()
    finally:
        _close(a, b, db_a, db_b)


def test_fenced_mutation_survives_partition(tmp_path):
    """An UPDATE committed on the minority side of a partition is fenced
    (applied locally, queued) and re-emitted at a fresh epoch when the
    quorum returns."""
    rng = np.random.default_rng(13)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 60))
        b.sync(), a.sync()
        a.peer_down_after_s = 0.0  # every peer ages out at once
        assert not a._has_majority()
        before = GLOBAL_COUNTERS.get("ReplicatedFencedMutations")
        t_a.update(F("id") < 10, {"score": 7.25})
        assert GLOBAL_COUNTERS.get("ReplicatedFencedMutations") == before + 1
        assert a._fenced_pending
        a.peer_down_after_s = 60.0
        a.sync()  # a pull refreshes last_ok: quorum, the rebase re-emits
        assert not a._fenced_pending
        assert b.sync() >= 1
        res = t_b.search("vec", np.zeros(DIM, np.float32), k=60)
        g = t_b.gather(res, ["id", "score"])
        sel = g["id"][res.valid] < 10
        assert np.allclose(g["score"][res.valid][sel], 7.25)
    finally:
        _close(a, b, db_a, db_b)


def test_fenced_mutation_superseded_is_loud(tmp_path):
    """Write-write conflict across the partition: the majority side's
    UPDATE wins and the fenced one is dropped with a counter."""
    rng = np.random.default_rng(14)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 40))
        b.sync(), a.sync()
        a.peer_down_after_s = 0.0
        t_a.update(F("id") < 5, {"score": 1.0})  # fenced
        assert b._has_majority()
        t_b.update(F("id") < 5, {"score": 2.0})  # a majority write
        a.peer_down_after_s = 60.0
        before = GLOBAL_COUNTERS.get("ReplicatedFencedMutationsSuperseded")
        a.sync()
        assert GLOBAL_COUNTERS.get("ReplicatedFencedMutationsSuperseded") >= before + 1
        res = t_a.search("vec", np.zeros(DIM, np.float32), k=40)
        g = t_a.gather(res, ["id", "score"])
        sel = g["id"][res.valid] < 5
        assert np.allclose(g["score"][res.valid][sel], 2.0)
    finally:
        _close(a, b, db_a, db_b)


def test_truncate_replicates(tmp_path):
    """tests/test_review_fixes_r3.py::test_truncate_replicates."""
    rng = np.random.default_rng(15)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    try:
        t_a.insert(_rows(rng, 32))
        assert b.sync() >= 1 and t_b.n_rows == 32
        t_a.truncate()
        assert b.sync() >= 1
        assert t_b.n_rows == 0
        t_a.insert(_rows(rng, 8, base=100))
        assert b.sync() >= 1 and t_b.n_rows == 8
    finally:
        _close(a, b, db_a, db_b)


def test_replicated_update_reaches_filtered_search(tmp_path):
    """A replicated UPDATE overwrites B's host scalars and bumps the
    segment's generation: the device mirror of the column, its min/max,
    the filter-mask cache and the IVF window-bitmap cache all key on it,
    so B's filtered searches (the exact scan and the IVF window path),
    which filled those caches before the UPDATE, see the new values."""
    rng = np.random.default_rng(16)
    st = ms.Settings()
    st.table.min_rows_to_build_vector_index = 100
    st.table.storage_dtype = "float32"
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path, st)
    try:
        t_b.add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=8)
        parts = [_rows(rng, 300), _rows(rng, 200, base=300)]
        for p in parts:
            t_a.insert(p)
        b.sync()
        assert t_b.wait_index_built(60)
        score = np.concatenate([p["score"] for p in parts])
        q = rng.standard_normal((3, DIM)).astype(np.float32)
        hot = F("score") > 0.5
        searches = {"scan": None, "ivf": {"nprobe": 8}}  # nprobe 8: every list

        def check(want_score):
            want = np.nonzero(want_score > 0.5)[0]
            for name, params in searches.items():
                res = t_b.search("vec", q, k=400, filter=hot, params=params)
                g = t_b.gather(res, ["id", "score"])
                for i in range(len(q)):
                    ok = res.valid[i]
                    np.testing.assert_array_equal(
                        np.sort(g["id"][i][ok].astype(int)), want, err_msg=name)
                    np.testing.assert_array_equal(
                        g["score"][i][ok], want_score[g["id"][i][ok].astype(int)], err_msg=name)

        check(score)  # fills the caches at the current generation
        t_a.update(F("id") < 60, {"score": 9.0})
        assert b.sync() >= 1
        score[:60] = 9.0
        check(score)
        seg = next(s for s in t_b.live_segments() if s.n_rows == 300)
        assert seg.scalar_minmax("score")[1] == 9.0
    finally:
        _close(a, b, db_a, db_b)


def test_mutation_fence_makes_no_network_call_under_the_node_lock(tmp_path, monkeypatch):
    """The commit listener's fence reads the cached peer liveness while it
    holds the node lock: an unknown peer id is fetched before the lock is
    taken, and `_has_majority` itself never calls out."""
    rng = np.random.default_rng(17)
    (db_a, t_a, a), (db_b, t_b, b) = _pair(tmp_path)
    calls = []
    real = urllib.request.urlopen

    def spy(url, *args, **kw):
        calls.append((str(url), a._lock._is_owned()))
        return real(url, *args, **kw)

    monkeypatch.setattr(data_replication.urllib.request, "urlopen", spy)
    try:
        t_a.insert(_rows(rng, 20))
        assert not a._peer_ids  # A has not pulled from B yet
        assert not a._has_majority()  # the cache knows no peer: no call
        assert calls == []
        t_a.update(F("id") < 3, {"score": 4.0})
        assert [u for u, _ in calls] == [f"{b.url}/meta"]
        assert not any(owned for _, owned in calls)
        assert not a._fenced_pending  # B counted: a majority write
        assert a._mut_clock[f"a:rt:0"][:2] == [1, 1]
    finally:
        _close(a, b, db_a, db_b)
