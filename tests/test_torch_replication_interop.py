"""Replication between the two packages: a JAX replica and a port replica
(myscaledb_tpu_torch on the CPU) share the wire and the on-disk layout, so
they replicate to each other.

  * data: a JAX `ReplicatedNode` and a port `ReplicatedNode` on 127.0.0.1
    converge on insert, deletes, mutate and merge (with its row maps, and
    a delete through the merged part's provenance afterwards), with each
    package as the origin; both elect the same merge leader;
  * indexes: an index built and served by one package's replica (its
    `IndexExchangeServer`) is fetched, verified and searched by the other
    package's replica, in both directions.
"""

import numpy as np
import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.service.data_replication import ReplicatedNode as JaxNode
from myscaledb_tpu.service.exchange import IndexExchangeServer as JaxExchange
from myscaledb_tpu_torch.service.data_replication import ReplicatedNode as TorchNode
from myscaledb_tpu_torch.service.exchange import IndexExchangeServer as TorchExchange
from myscaledb_tpu_torch.service.replication import pick_build_replica

DIM = 16
TOL = dict(rtol=2e-4, atol=2e-3)


def _schema(pkg):
    return pkg.Schema({"id": pkg.UInt64(), "score": pkg.Float32(), "vec": pkg.FloatVector(DIM)})


def _rows(rng, n, base=0):
    return {
        "id": np.arange(base, base + n, dtype=np.uint64),
        "score": rng.random(n).astype(np.float32),
        "vec": rng.standard_normal((n, DIM)).astype(np.float32),
    }


def _hits(t, q):
    res = t.search("vec", q, k=20)
    g = t.gather(res, ["id", "score"])
    return g["id"].astype(int), g["score"], res.scores


@pytest.mark.parametrize("origin", ["jax", "torch"])
def test_data_replication_between_packages(tmp_path, origin):
    rng = np.random.default_rng(51 if origin == "jax" else 52)
    jdb, tdb = jms.connect(), tms.connect(device="cpu")
    jt, tt = jdb.create_table("rt", _schema(jms)), tdb.create_table("rt", _schema(tms))
    jn = JaxNode(jdb, "jax", str(tmp_path / "jax"))
    tn = TorchNode(tdb, "torch", str(tmp_path / "torch"))
    jn.attach(jt)
    tn.attach(tt)
    jn.peers, tn.peers = [tn.url], [jn.url]
    (xt, xn), (yt, yn) = ((jt, jn), (tt, tn)) if origin == "jax" else ((tt, tn), (jt, jn))
    F = jms.F if origin == "jax" else tms.F
    FY = tms.F if origin == "jax" else jms.F
    q = rng.standard_normal((4, DIM)).astype(np.float32)

    def converged(n_rows):
        assert xt.n_rows == yt.n_rows == n_rows
        xi, xs, xv = _hits(xt, q)
        yi, ys, yv = _hits(yt, q)
        np.testing.assert_array_equal(yi, xi)
        np.testing.assert_array_equal(ys, xs)
        np.testing.assert_allclose(yv, xv, **TOL)

    try:
        xt.insert(_rows(rng, 40))
        xt.insert(_rows(rng, 40, base=40))
        assert yn.sync() == 2
        converged(80)
        # one leader, the same on both sides
        xn.sync()
        assert xn.is_merge_leader("rt") != yn.is_merge_leader("rt")
        xt.delete(F("id").isin([3, 50]))
        assert yn.sync() >= 1
        converged(78)
        xt.update(F("id") < 10, {"score": 9.0})
        assert yn.sync() >= 1
        converged(78)
        assert xt.merge(force=True) is not None
        assert yn.sync() >= 1
        assert len(yt.live_segments()) == 1
        converged(78)
        # a delete on the follower, through the merged part's provenance
        yt.delete(FY("id") >= 70)
        assert xn.sync() >= 1
        converged(68)
    finally:
        jn.close(), tn.close(), jdb.close(), tdb.close()


def _settings(pkg):
    st = pkg.Settings()
    st.table.min_rows_to_build_vector_index = 100
    st.table.build_vector_index_on_random_single_replica = True
    st.table.storage_dtype = "float32"
    return st


@pytest.mark.parametrize("builder_pkg", ["jax", "torch"])
def test_index_exchange_between_packages(tmp_path, builder_pkg):
    rng = np.random.default_rng(53)
    vecs = rng.standard_normal((3000, 16)).astype(np.float32)
    cols = {"id": np.arange(3000, dtype=np.uint64), "vec": vecs}
    builder = pick_build_replica("r", 0, "ivf", 2)
    other = 1 - builder
    pkgs = [None, None]
    pkgs[builder] = jms if builder_pkg == "jax" else tms
    pkgs[other] = tms if builder_pkg == "jax" else jms
    roots = [str(tmp_path / "r0"), str(tmp_path / "r1")]
    srv = (JaxExchange if builder_pkg == "jax" else TorchExchange)(roots[builder])
    peers = [None, None]
    peers[builder] = srv.url
    dbs = []
    try:
        for i, pkg in enumerate(pkgs):
            kw = {"device": "cpu"} if pkg is tms else {}
            dbs.append(pkg.connect(_settings(pkg), path=roots[i], replica_id=i, n_replicas=2,
                                   replica_peers=peers, **kw))
        ts = [
            db.create_table("r", pkg.Schema({"id": pkg.UInt64(), "vec": pkg.FloatVector(16)}),
                            settings=_settings(pkg))
            for db, pkg in zip(dbs, pkgs)
        ]
        for t in ts:
            t.insert(cols)
        before = dbs[other].counters.get("ReplicatedPartVectorIndexFetches")
        for i in (builder, other):
            ts[i].add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=8)
            assert ts[i].wait_index_built(120)
        # the fetcher loaded the builder's files
        assert dbs[other].counters.get("ReplicatedPartVectorIndexFetches") == before + 1
        assert ts[other]._slots[(0, "ivf")].path.startswith(roots[other])
        res = [t.search("vec", vecs[:16], k=5, params={"nprobe": 2}) for t in ts]
        ids = [t.gather(r, ["id"])["id"].astype(int) for t, r in zip(ts, res)]
        assert (ids[other][:, 0] == np.arange(16)).all()
        np.testing.assert_array_equal(ids[other], ids[builder])
        np.testing.assert_allclose(res[other].scores, res[builder].scores, **TOL)
    finally:
        srv.close()
        for db in dbs:
            db.close()
