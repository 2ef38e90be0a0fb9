"""The HTTP replica index exchange of the port (myscaledb_tpu_torch on the
CPU), mirroring tests/test_index_exchange.py: the builder serves its
persisted indexes over HTTP; the peer downloads into a vector_tmp_*
staging dir, verifies the checksums and installs atomically. Exchanges
between a JAX replica and a port replica are in
tests/test_torch_replication_interop.py."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import myscaledb_tpu_torch as ms
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.service.exchange import IndexExchangeServer, fetch_index
from myscaledb_tpu_torch.service.replication import pick_build_replica


def _settings():
    st = ms.Settings()
    st.table.min_rows_to_build_vector_index = 100
    st.table.build_vector_index_on_random_single_replica = True
    st.table.storage_dtype = "float32"
    return st


def test_http_fetch_roundtrip(tmp_path):
    """Two replicas with separate stores, joined only by HTTP."""
    rng = np.random.default_rng(31)
    vecs = rng.standard_normal((3000, 16)).astype(np.float32)
    cols = {"id": np.arange(3000, dtype=np.uint64), "vec": vecs}
    builder = pick_build_replica("r", 0, "ivf", 2)
    other = 1 - builder
    roots = [str(tmp_path / "a"), str(tmp_path / "b")]
    srv = IndexExchangeServer(roots[builder])
    peers = [None, None]
    peers[builder] = srv.url
    dbs = [
        ms.connect(_settings(), path=roots[i], replica_id=i, n_replicas=2,
                   replica_peers=peers, device="cpu")
        for i in range(2)
    ]
    try:
        ts = [
            db.create_table("r", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(16)}),
                            settings=_settings())
            for db in dbs
        ]
        for t in ts:
            t.insert(cols)
        ts[builder].add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=8)
        assert ts[builder].wait_index_built(120)
        before = GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFetches")
        ts[other].add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=8)
        assert ts[other].wait_index_built(120)
        assert GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFetches") == before + 1
        # the fetched index serves searches, with the builder's ids
        got = [t.gather(t.search("vec", vecs[:8], k=3, params={"nprobe": 2}), ["id"])["id"]
               for t in (ts[other], ts[builder])]
        assert int(got[0][5, 0]) == 5
        np.testing.assert_array_equal(got[0], got[1])
        # and landed as a verified directory in the fetcher's own store
        d = os.path.join(roots[other], "r", "segment_0", "index_ivf")
        assert os.path.exists(os.path.join(d, "checksums.json"))
        assert not os.path.exists(os.path.join(roots[other], "r", "segment_0", "vector_tmp_ivf"))
    finally:
        srv.close()
        for db in dbs:
            db.close()


def test_exchange_status_codes(tmp_path):
    os.makedirs(tmp_path / "t" / "segment_0" / "index_i")
    srv = IndexExchangeServer(str(tmp_path))
    try:
        # the dir exists but has no checksums.json yet: "building"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/index/t/0/i", timeout=10)
        assert e.value.code == 404 and e.value.headers["X-Index-Status"] == "building"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/index/t/0/nope", timeout=10)
        assert e.value.code == 404 and e.value.headers["X-Index-Status"] == "absent"
        # a path that climbs out of the root is refused
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/index/t/0/i/..", timeout=10)
        assert e.value.code in (400, 404)
    finally:
        srv.close()


def test_fetch_rejects_corrupt_files(tmp_path):
    d = tmp_path / "t" / "segment_0" / "index_i"
    os.makedirs(d)
    (d / "arrays.npz").write_bytes(b"payload")
    (d / "meta.json").write_text("{}")
    (d / "checksums.json").write_text(json.dumps({"arrays.npz": "0" * 64, "meta.json": "0" * 64}))
    srv = IndexExchangeServer(str(tmp_path))
    try:
        before = GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFailedFetches")
        out = fetch_index(srv.url, "t", 0, "i", str(tmp_path / "dest"), timeout_s=5)
        assert out is None  # checksum mismatch: no partial install
        assert not os.path.exists(tmp_path / "dest" / "segment_0" / "index_i")
        assert not os.path.exists(tmp_path / "dest" / "segment_0" / "vector_tmp_i")
        assert GLOBAL_COUNTERS.get("ReplicatedPartVectorIndexFailedFetches") == before + 1
    finally:
        srv.close()


def test_fetch_timeout_returns_none(tmp_path):
    srv = IndexExchangeServer(str(tmp_path))
    try:
        out = fetch_index(srv.url, "t", 0, "i", str(tmp_path / "dest"),
                          timeout_s=0.5, poll_interval_s=0.1)
        assert out is None
    finally:
        srv.close()
