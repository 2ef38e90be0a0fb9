"""Serving: the coalescing `SearchServer` and the `HttpFrontend` of the port
(myscaledb_tpu_torch, on the CPU), after `tests/test_server.py`, with
every response held to the JAX package's server on the same requests.

Both packages hold the same table (2,000 x 16 Gaussian rows, a string
column with an fts index). A response is compared field by field:

  * `rows`, `segments` and `valid` exactly (the data have no ties);
  * `distances` (vector and hybrid searches) within rtol 2e-4 / atol 2e-3
    (`tests/test_distance_ops.py:37`);
  * BM25 `scores` within the port's dense-path bound,
    `text/inverted.py::DENSE_RTOL` (2^-18 relative); fused hybrid scores
    within rtol 2e-4 / atol 2e-3.

The port's server passes a group's queries as they are, where the JAX
server pads the group to a power of two (`_bucket`, for XLA's compile
cache); `test_groups_without_the_pad_match_the_jax_pad` shows that each
request gets the hits it gets with the pad.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.service import server as jserver
from myscaledb_tpu_torch.service import server as tserver
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.text.inverted import DENSE_RTOL

N, D = 2000, 16
DIST = dict(rtol=2e-4, atol=2e-3)
TEXT = dict(rtol=DENSE_RTOL, atol=0.0)


def _fill(ms, db):
    t = db.create_table(
        "t", ms.Schema({"id": ms.UInt64(), "doc": ms.String(), "vec": ms.FloatVector(D)})
    )
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    t.insert({
        "id": np.arange(N, dtype=np.uint64),
        "doc": np.asarray([f"word{i % 13} text" for i in range(N)], dtype=object),
        "vec": vecs,
    })
    t.add_fts_index("ft", "doc")
    return vecs


@pytest.fixture(scope="module")
def dbs():
    jdb, tdb = jms.connect(), tms.connect(device="cpu")
    vecs = _fill(jms, jdb)
    _fill(tms, tdb)
    yield jdb, tdb, vecs
    jdb.close()
    tdb.close()


def _same_hit(a, b, kind):
    """A JAX server response `a` and the port's `b` for one request."""
    for f in ("rows", "segments", "valid"):
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]), err_msg=f)
    valid = np.asarray(a["valid"])
    if kind == "text":
        np.testing.assert_allclose(np.asarray(b["scores"])[valid], np.asarray(a["scores"])[valid], **TEXT)
    else:
        np.testing.assert_allclose(np.asarray(b["scores"])[valid], np.asarray(a["scores"])[valid], **DIST)
    if kind == "vec":
        np.testing.assert_allclose(
            np.asarray(b["distances"])[valid], np.asarray(a["distances"])[valid], **DIST
        )


def _servers(jdb, tdb, **kw):
    return jserver.SearchServer(jdb, **kw), tserver.SearchServer(tdb, **kw)


def test_server_coalesces_concurrent_requests(dbs):
    jdb, tdb, vecs = dbs
    js, ts = _servers(jdb, tdb, max_batch=64, max_delay_ms=20.0)
    try:
        before = GLOBAL_COUNTERS.get("ServerBatches")
        req_before = GLOBAL_COUNTERS.get("ServerRequests")
        futs = [ts.submit_search("t", "vec", vecs[i], 3) for i in range(32)]
        outs = [f.result(timeout=30) for f in futs]
        for i, o in enumerate(outs):
            assert o["rows"][0] == i  # each caller got ITS query's result
        batches = GLOBAL_COUNTERS.get("ServerBatches") - before
        assert 1 <= batches < 32  # coalesced, not one search per request
        assert GLOBAL_COUNTERS.get("ServerRequests") - req_before == 32
        jouts = [f.result(timeout=60) for f in [js.submit_search("t", "vec", vecs[i], 3) for i in range(32)]]
        for a, b in zip(jouts, outs):
            _same_hit(a, b, "vec")
    finally:
        js.close()
        ts.close()


def test_server_concurrent_threads(dbs):
    _, tdb, vecs = dbs
    srv = tserver.SearchServer(tdb, max_batch=128, max_delay_ms=5.0)
    errs = []

    def client(lo, hi):
        try:
            for i in range(lo, hi):
                out = srv.search("t", "vec", vecs[i], 1)
                assert out["rows"][0] == i, (i, out["rows"])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        threads = [threading.Thread(target=client, args=(w * 10, w * 10 + 10)) for w in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not errs, errs
    finally:
        srv.close()


@pytest.mark.parametrize("kind", ["vec", "text", "hybrid"])
def test_server_answers_as_jax_does(dbs, kind):
    jdb, tdb, vecs = dbs
    js, ts = _servers(jdb, tdb, max_delay_ms=5.0)
    qi = [7, 100, 513]
    try:
        outs = []
        for srv in (js, ts):
            if kind == "vec":
                futs = [srv.submit_search("t", "vec", vecs[i], 5) for i in qi]
            elif kind == "text":
                futs = [srv.submit_text_search("t", "doc", f"word{i % 13}", 4) for i in qi]
            else:
                futs = [
                    srv.submit_hybrid_search("t", "vec", "doc", vecs[i], f"word{i % 13}", 5)
                    for i in qi
                ]
            outs.append([f.result(timeout=60) for f in futs])
        for a, b in zip(*outs):
            _same_hit(a, b, kind)
            assert b["valid"].any()
        if kind == "text":
            out = ts.text_search("t", "doc", "word5", 4)
            assert all(r % 13 == 5 for r in out["rows"][out["valid"]])
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("group", [1, 3, 5, 9, 17, 33])
def test_groups_without_the_pad_match_the_jax_pad(dbs, group):
    """The JAX server pads a group of n queries to max(8, 2^ceil(log2 n))
    (`_bucket`, repeating the last query); the port passes the n queries
    as they are. Each request's hits are the same either way, and the
    same as the JAX server's."""
    jdb, tdb, vecs = dbs
    t = tdb.table("t")
    qs = vecs[np.arange(group) * 37 % N] + np.float32(0.01)
    cap = jserver.SearchServer._bucket(group)
    padded = np.concatenate([qs, np.repeat(qs[-1:], cap - group, 0)])
    a, b = t.search("vec", padded, 10), t.search("vec", qs, 10)
    np.testing.assert_array_equal(a.rows[:group], b.rows)
    np.testing.assert_array_equal(a.segments[:group], b.segments)
    np.testing.assert_allclose(a.distances[:group], b.distances, **DIST)
    ts = tserver.SearchServer(tdb, max_batch=256, max_delay_ms=200.0, adaptive_flush=False)
    js = jserver.SearchServer(jdb, max_batch=256, max_delay_ms=200.0, adaptive_flush=False)
    try:
        before = GLOBAL_COUNTERS.get("ServerBatches")
        touts = [f.result(timeout=60) for f in [ts.submit_search("t", "vec", q, 10) for q in qs]]
        assert GLOBAL_COUNTERS.get("ServerBatches") - before == 1  # one group
        jouts = [f.result(timeout=60) for f in [js.submit_search("t", "vec", q, 10) for q in qs]]
    finally:
        ts.close()
        js.close()
    for i, (ja, tb) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(tb["rows"], a.rows[i])
        _same_hit(ja, tb, "vec")


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _same_reply(a, b, kind):
    assert a.keys() == b.keys()
    if "results" in a:
        assert len(a["results"]) == len(b["results"])
        for x, y in zip(a["results"], b["results"]):
            _same_reply(x, y, kind)
        return
    assert a["rows"] == b["rows"] and a["segments"] == b["segments"]
    tol = TEXT if kind == "text" else DIST
    np.testing.assert_allclose(b["distances"], a["distances"], **tol)
    assert a.get("columns") == b.get("columns")


def test_http_frontend(dbs):
    jdb, tdb, vecs = dbs
    jf = jserver.HttpFrontend(jdb, max_delay_ms=2.0)
    tf = tserver.HttpFrontend(tdb, max_delay_ms=2.0)
    reqs = [
        ("/search", {"table": "t", "column": "vec", "vector": vecs[9].tolist(), "k": 3,
                     "gather": ["id", "doc"]}, "vec"),
        ("/search", {"table": "t", "column": "vec",
                     "vectors": [vecs[i].tolist() for i in range(0, 100, 7)], "k": 4}, "vec"),
        ("/text_search", {"table": "t", "index": "ft", "query": "word3", "k": 5}, "text"),
        ("/hybrid_search", {"table": "t", "vector_column": "vec", "text_column": "doc",
                            "vector": vecs[21].tolist(), "text_query": "word8", "k": 5}, "hyb"),
        ("/sql", {"query": "SELECT count(*) FROM t"}, "sql"),
        ("/sql", {"query": "SELECT id, distance(vec, " + json.dumps(vecs[4].tolist())
                  + ") AS d FROM t ORDER BY d LIMIT 3"}, "sql"),
    ]
    try:
        assert urllib.request.urlopen(f"http://127.0.0.1:{tf.port}/ping", timeout=30).read() == b'{"ok": true}'
        out = _post(tf.port, "/search", reqs[0][1])
        assert out["rows"][0] == 9 and out["columns"]["id"][0] == 9
        assert all(r % 13 == 3 for r in _post(tf.port, "/text_search", reqs[2][1])["rows"])
        assert _post(tf.port, "/sql", reqs[4][1])["rows"][0]["count()"] == N
        for path, body, kind in reqs:
            a, b = _post(jf.port, path, body), _post(tf.port, path, body)
            if kind != "sql":
                _same_reply(a, b, kind)
            elif "distance" in body["query"]:
                assert [r["id"] for r in a["rows"]] == [r["id"] for r in b["rows"]]
                np.testing.assert_allclose([r["d"] for r in b["rows"]], [r["d"] for r in a["rows"]], **DIST)
            else:
                assert a == b
        # error surface: a missing table is a 400 in both
        for f in (jf, tf):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f.port, "/search", {"table": "missing", "column": "x", "vector": [0.0], "k": 1})
            assert e.value.code == 400
    finally:
        jf.close()
        tf.close()


def test_http_batched_search_and_keepalive(dbs):
    _, tdb, vecs = dbs
    front = tserver.HttpFrontend(tdb, max_delay_ms=2.0)
    try:
        out = _post(front.port, "/search", {"table": "t", "column": "vec",
                                            "vectors": [vecs[3].tolist(), vecs[11].tolist()], "k": 2})
        assert out["results"][0]["rows"][0] == 3
        assert out["results"][1]["rows"][0] == 11
        conn = http.client.HTTPConnection("127.0.0.1", front.port, timeout=30)
        for i in (5, 8):
            body = json.dumps({"table": "t", "column": "vec", "vector": vecs[i].tolist(), "k": 1})
            conn.request("POST", "/search", body, {"Content-Type": "application/json"})
            r = conn.getresponse()
            assert r.version == 11
            assert json.loads(r.read())["rows"][0] == i
        conn.close()
    finally:
        front.close()


def test_adaptive_flush_tracks_bursts(dbs):
    _, tdb, vecs = dbs
    srv = tserver.SearchServer(tdb, max_batch=64, max_delay_ms=50.0)
    try:
        assert srv.adaptive_flush and srv._expected == 1
        srv.search("t", "vec", vecs[0], 1)
        t0 = time.time()
        out = srv.search("t", "vec", vecs[1], 1)
        dt = time.time() - t0
        assert out["rows"][0] == 1
        assert dt < 0.05, f"single sync call waited the full delay ({dt:.3f}s)"
        futs = [srv.submit_search("t", "vec", vecs[i], 1) for i in range(16)]
        for i, f in enumerate(futs):
            assert f.result(timeout=30)["rows"][0] == i
        assert srv._expected > 1
    finally:
        srv.close()


def test_closed_server_fails_requests(dbs):
    _, tdb, vecs = dbs
    srv = tserver.SearchServer(tdb)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.search("t", "vec", vecs[0], 1)


def test_json_default_takes_torch_values():
    enc = lambda v: json.loads(json.dumps(v, default=tserver._json_default))  # noqa: E731
    assert enc({"a": torch.tensor(3), "b": torch.tensor([1.5, 2.0]), "c": np.int64(4),
                "d": np.float32(0.5), "e": np.arange(2)}) == {
        "a": 3, "b": [1.5, 2.0], "c": 4, "d": 0.5, "e": [0, 1]}


def test_database_device_context():
    """`Database.on_device()`: the database's CUDA device (made without
    touching CUDA), nothing on the CPU."""
    db = tms.Database.__new__(tms.Database)
    db.device = torch.device("cuda", 1)
    ctx = db.on_device()
    assert isinstance(ctx, torch.cuda.device) and ctx.idx == 1
    db.device = torch.device("cpu")
    assert not isinstance(db.on_device(), torch.cuda.device)


def test_server_threads_take_the_database_device(dbs):
    """The dispatcher and each resolver enter the database's device."""
    import contextlib

    _, tdb, vecs = dbs
    entered = []

    class _Db:
        device = tdb.device

        def table(self, name):
            return tdb.table(name)

        @contextlib.contextmanager
        def on_device(self):
            entered.append(threading.current_thread().name)
            yield

    srv = tserver.SearchServer(_Db(), max_delay_ms=1.0)
    try:
        assert srv.search("t", "vec", vecs[4], 1)["rows"][0] == 4
    finally:
        srv.close()
    assert any(n == "search-dispatcher" for n in entered)
    assert any(n.startswith("search-resolve") for n in entered)


def test_server_stress_many_threads(dbs):
    """More client threads than cores, the interpreter switching threads
    every microsecond: each request gets its own query's hits, and the
    server counts every request once."""
    import os
    import sys

    _, tdb, vecs = dbs
    n_threads = max(32, 2 * (os.cpu_count() or 1))
    per = 6
    srv = tserver.SearchServer(tdb, max_batch=64, max_delay_ms=1.0, max_inflight=4)
    errs = []
    old = sys.getswitchinterval()

    def client(w):
        try:
            for j in range(per):
                i = (w * per + j) % N
                fut = srv.submit_search("t", "vec", vecs[i], 1)
                assert fut.result(timeout=60)["rows"][0] == i
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    before = GLOBAL_COUNTERS.get("ServerRequests")
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(w,)) for w in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        srv.close()
    assert not errs, errs[:3]
    assert GLOBAL_COUNTERS.get("ServerRequests") - before == n_threads * per
