"""The port's MeshTable (myscaledb_tpu_torch on the CPU, a Mesh of eight
`cpu` entries) mirroring tests/test_mesh_table.py: each test makes the
JAX test's assertions against host numpy ground truth, and holds the port
to the JAX MeshTable (the virtual 8-device mesh of tests/conftest.py) on
the same rows: exact ids equal; IVF and two-stage ids equal given the same
index (the JAX table's `_ivf` / `_mstg` installed on the port's through
storage/convert.py::mesh_indexes_from_arrays); the k-means centroids of
the port's own build within rtol 1e-4 of JAX's; scores within rtol 2e-4 /
atol 2e-3. A JAX search costs seconds on the CPU, so the JAX side runs
once per configuration in module fixtures, on batches of queries."""

import json
import os

import numpy as np
import pytest
import torch

from myscaledb_tpu.parallel.mesh_table import MeshTable as JMeshTable
from myscaledb_tpu_torch.errors import QueryShapeError
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.parallel.distributed import make_mesh
from myscaledb_tpu_torch.parallel.mesh_table import MeshTable as TMeshTable
from myscaledb_tpu_torch.storage.convert import mesh_indexes_from_arrays

TOL = dict(rtol=2e-4, atol=2e-3)


def MeshTable(*args, **kw):
    """The port's table on the JAX test's mesh: 8 data shards, query axis 1."""
    return TMeshTable(*args, mesh=make_mesh(8, device="cpu"), **kw)


@pytest.fixture(scope="module")
def rng_mod():
    return np.random.default_rng(0xFEED)


@pytest.fixture(scope="module")
def corpus(rng_mod):
    n, d = 20_000, 32
    vecs = rng_mod.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) * 7  # non-trivial id mapping
    price = rng_mod.integers(0, 1000, n).astype(np.int32)
    return ids, vecs, price


@pytest.fixture(scope="module")
def queries(corpus):
    """16 queries near corpus rows (no ties), the first four the rows the
    JAX tests search for."""
    ids, vecs, price = corpus
    rng = np.random.default_rng(3)
    rows = np.concatenate([[5, 77, 1234, 500], rng.choice(len(vecs), 12, replace=False)])
    q = vecs[rows] + 0.05 * rng.standard_normal((16, vecs.shape[1])).astype(np.float32)
    return rows, q.astype(np.float32)


def _index_np(t):
    """A JAX table's `_ivf` / `_mstg` as numpy (bf16 stays bf16)."""
    idx = t._ivf if t._ivf is not None else t._mstg
    return tuple(np.asarray(a) for a in idx[:-1]) + (int(idx[-1]),)


@pytest.fixture(scope="module")
def jref(corpus, queries):
    """The JAX MeshTable's answers on the full corpus (with price): exact,
    filtered, IVF (ncentroids 64, nprobe 16; and nprobe 32 filtered), MSTG
    (ncentroids 64, nprobe 16), and the Cosine exact scan; each index
    exported as numpy."""
    ids, vecs, price = corpus
    _, q = queries
    t = JMeshTable("m3", 32, filter_columns=("price",))
    t.insert({"id": ids, "vec": vecs, "price": price})
    out = {"exact": t.search(q, 10), "filtered": t.search(q, 5, filter=lambda price: price < 200)}
    t.build_ivf(ncentroids=64)
    out["ivf_index"] = _index_np(t)
    out["ivf"] = t.search(q, 5, params={"nprobe": 16})
    out["ivf_filtered"] = t.search(q, 5, params={"nprobe": 32}, filter=lambda price: price < 200)
    t.build_mstg(ncentroids=64)
    out["mstg_index"] = _index_np(t)
    out["mstg"] = t.search(q, 5, params={"nprobe": 16, "num_reorder": 64})
    c = JMeshTable("m4", 32, metric="Cosine")
    c.insert({"id": ids, "vec": vecs})
    out["cosine"] = c.search(q, 5)
    return out


def _same(got, want, check_ids=True):
    if check_ids:
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **TOL)


def _gt_l2(vecs, q, k):
    d = ((vecs.astype(np.float64) - q) ** 2).sum(1)
    return np.argsort(d)[:k]


def test_exact_scan_matches_numpy(corpus, queries, jref):
    ids, vecs, price = corpus
    t = MeshTable("m", 32)
    t.insert({"id": ids, "vec": vecs})
    q = vecs[123] + 0.01
    out_ids, scores = t.search(q, 10)
    want = ids[_gt_l2(vecs, q, 10)]
    assert out_ids[0, 0] == ids[123] or set(out_ids[0]) & set(want[:3])
    assert set(out_ids[0]) == set(want) or len(set(out_ids[0]) & set(want)) >= 8
    # the JAX table's ids and scores on the same rows
    _same(t.search(queries[1], 10), jref["exact"])


def test_batch_and_id_mapping(corpus, queries, jref):
    ids, vecs, price = corpus
    t = MeshTable("m2", 32)
    t.insert({"id": ids, "vec": vecs})
    qs = vecs[[5, 77, 1234]]
    out_ids, _ = t.search(qs, 3)
    assert out_ids.shape == (3, 3)
    assert out_ids[0, 0] == ids[5]
    assert out_ids[1, 0] == ids[77]
    assert out_ids[2, 0] == ids[1234]
    # the first queries of the batch are near rows 5, 77, 1234, 500
    got = t.search(queries[1][:4], 3)
    _same(got, tuple(a[:4, :3] for a in jref["exact"]))
    np.testing.assert_array_equal(got[0][:, 0], ids[queries[0][:4]])


def test_filter_and_delete(corpus, queries, jref):
    ids, vecs, price = corpus
    t = MeshTable("m3", 32, filter_columns=("price",))
    t.insert({"id": ids, "vec": vecs, "price": price})
    _same(t.search(queries[1], 5, filter=lambda price: price < 200), jref["filtered"])
    q = vecs[500]
    out_ids, _ = t.search(q, 5, filter=lambda price: price < 200)
    sel = {int(i) for i, p in zip(ids, price) if p < 200}
    assert all(int(i) in sel for i in out_ids[0] if i >= 0)
    out_ids0, _ = t.search(q, 1)
    t.delete(int(out_ids0[0, 0]))
    out_ids1, _ = t.search(q, 1)
    assert out_ids1[0, 0] != out_ids0[0, 0]


def test_cosine(corpus, queries, jref):
    ids, vecs, price = corpus
    t = MeshTable("m4", 32, metric=Metric.COSINE)
    t.insert({"id": ids, "vec": vecs})
    q = vecs[42]
    out_ids, scores = t.search(q, 5)
    assert out_ids[0, 0] == ids[42]
    s = scores[0]
    assert (np.diff(s[np.isfinite(s)]) <= 1e-6).all()
    _same(t.search(queries[1], 5), jref["cosine"])


def test_sharded_ivf(corpus, queries, jref):
    ids, vecs, price = corpus
    t = MeshTable("m5", 32)
    t.insert({"id": ids, "vec": vecs})
    t.build_ivf(ncentroids=64)
    hits = 0
    for i in (3, 900, 7777):
        out_ids, _ = t.search(vecs[i], 5, params={"nprobe": 16})
        hits += int(out_ids[0, 0] == ids[i])
    assert hits >= 2
    out_ids, _ = t.search(vecs[11], 3, params={"nprobe": 64})
    assert out_ids[0, 0] == ids[11]
    # the port's own global k-means against the JAX package's
    np.testing.assert_allclose(
        t._ivf[0][0][0].numpy(), jref["ivf_index"][0][0], rtol=1e-4, atol=1e-5
    )
    # the JAX index installed on the port's table: the same ids
    mesh_indexes_from_arrays(t, ivf=jref["ivf_index"])
    _same(t.search(queries[1], 5, params={"nprobe": 16}), jref["ivf"])


def test_ivf_filters_and_deletes(corpus, queries, jref):
    ids, vecs, price = corpus
    t = MeshTable("m6", 32, filter_columns=("price",))
    t.insert({"id": ids, "vec": vecs, "price": price})
    t.build_ivf(ncentroids=32)
    q = vecs[500]
    out_ids, _ = t.search(q, 5, params={"nprobe": 32}, filter=lambda price: price < 200)
    sel = {int(i) for i, p in zip(ids, price) if p < 200}
    got = [int(i) for i in out_ids[0] if i >= 0]
    assert got and all(i in sel for i in got)
    want = [int(ids[j]) for j in _gt_l2(vecs, q, 20_000) if price[j] < 200][:5]
    assert len(set(got) & set(want)) >= 4
    top, _ = t.search(q, 1, params={"nprobe": 32})
    t.delete(int(top[0, 0]))
    after, _ = t.search(q, 1, params={"nprobe": 32})
    assert after[0, 0] != top[0, 0]
    # the JAX index (64 clusters) on a fresh port table: the same filtered ids
    u = MeshTable("m6j", 32, filter_columns=("price",))
    u.insert({"id": ids, "vec": vecs, "price": price})
    mesh_indexes_from_arrays(u, ivf=jref["ivf_index"])
    _same(u.search(queries[1], 5, params={"nprobe": 32}, filter=lambda price: price < 200),
          jref["ivf_filtered"])


def test_sharded_mstg_two_stage(corpus, queries, jref):
    ids, vecs, price = corpus
    t = MeshTable("m5b", 32)
    t.insert({"id": ids, "vec": vecs})
    t.build_mstg(ncentroids=64)
    assert t._mstg[4][0].dtype == torch.uint8
    hits = 0
    for i in (3, 900, 7777):
        out_ids, _ = t.search(vecs[i], 5, params={"nprobe": 16, "num_reorder": 64})
        hits += int(out_ids[0, 0] == ids[i])
    assert hits >= 2
    q = vecs[11]
    got_ids, got_scores = t.search(q, 5, params={"nprobe": 64})
    exact_ids, exact_scores = t.search(q, 5)
    assert got_ids[0, 0] == ids[11]
    assert set(got_ids[0]) == set(exact_ids[0])
    np.testing.assert_allclose(got_scores[0], exact_scores[0], rtol=1e-4)
    out_ids, _ = t.search(q, 5, params={"nprobe": 64, "num_reorder": 8})
    assert (out_ids[0] >= 0).all()
    # the port's own codec and k-means against the JAX package's
    jcents, _, jlo, jscale = jref["mstg_index"][:4]
    np.testing.assert_allclose(t._mstg[0][0][0].numpy(), jcents[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t._mstg[2][0].numpy(), jlo)
    # XLA turns the division by 255 into a product with its reciprocal:
    # the scales may differ in the last bit
    np.testing.assert_allclose(t._mstg[3][0].numpy(), jscale, rtol=2.5e-7, atol=0)
    mesh_indexes_from_arrays(t, mstg=jref["mstg_index"])
    _same(t.search(queries[1], 5, params={"nprobe": 16, "num_reorder": 64}), jref["mstg"])


@pytest.fixture(scope="module")
def jdelta(corpus):
    """A JAX table of the first 16,000 rows with IVF (32 clusters) and
    MSTG (32 clusters) exported, then 1,000 rows appended after the
    build: the delta scan's answers at nprobe 4."""
    ids, vecs, price = corpus
    out = {}
    for kind in ("ivf", "mstg"):
        t = JMeshTable(f"d_{kind}", 32, filter_columns=("price",))
        t.insert({"id": ids[:16_000], "vec": vecs[:16_000], "price": price[:16_000]})
        getattr(t, f"build_{kind}")(ncentroids=32)
        out[f"{kind}_index"] = _index_np(t)
        t.insert({"id": ids[16_000:17_000], "vec": vecs[16_000:17_000],
                  "price": price[16_000:17_000]})
        out[kind] = t.search(vecs[[16_500, 16_001, 3, 900]] + 0.01, 5, params={"nprobe": 4})
    return out


def _delta_table(name, corpus, index, kind):
    ids, vecs, price = corpus
    t = MeshTable(name, 32, filter_columns=("price",))
    t.insert({"id": ids[:16_000], "vec": vecs[:16_000], "price": price[:16_000]})
    mesh_indexes_from_arrays(t, **{kind: index})
    t.insert({"id": ids[16_000:17_000], "vec": vecs[16_000:17_000],
              "price": price[16_000:17_000]})
    return t


def test_mstg_filters_deletes_delta(corpus, jdelta):
    ids, vecs, price = corpus
    t = MeshTable("m6b", 32, filter_columns=("price",))
    t.insert({"id": ids[:16_000], "vec": vecs[:16_000], "price": price[:16_000]})
    t.build_mstg(ncentroids=32)
    q = vecs[500]
    out_ids, _ = t.search(q, 5, params={"nprobe": 32}, filter=lambda price: price < 200)
    sel = {int(i) for i, p in zip(ids[:16_000], price[:16_000]) if p < 200}
    got = [int(i) for i in out_ids[0] if i >= 0]
    assert got and all(i in sel for i in got)
    top, _ = t.search(q, 1, params={"nprobe": 32})
    t.delete(int(top[0, 0]))
    after, _ = t.search(q, 1, params={"nprobe": 32})
    assert after[0, 0] != top[0, 0]
    t.insert({"id": ids[16_000:17_000], "vec": vecs[16_000:17_000],
              "price": price[16_000:17_000]})
    out, _ = t.search(vecs[16_500], 1, params={"nprobe": 4})
    assert out[0, 0] == ids[16_500]
    # the JAX MSTG with the same appended rows: the probe merged with the delta
    u = _delta_table("m6bj", corpus, jdelta["mstg_index"], "mstg")
    _same(u.search(vecs[[16_500, 16_001, 3, 900]] + 0.01, 5, params={"nprobe": 4}),
          jdelta["mstg"])


def test_incremental_insert_no_reseal(corpus):
    ids, vecs, price = corpus
    t = MeshTable("m7", 32)
    t.insert({"id": ids[:10_000], "vec": vecs[:10_000]})
    a, _ = t.search(vecs[2], 1)
    assert a[0, 0] == ids[2]
    sealed_before = t._s
    t.insert({"id": ids[10_000:12_000], "vec": vecs[10_000:12_000]})
    assert t._s is sealed_before  # no reseal: fits in slack
    b, _ = t.search(vecs[11_000], 1)
    assert b[0, 0] == ids[11_000]
    t.insert({"id": ids[12_000:], "vec": vecs[12_000:]})
    c, _ = t.search(vecs[15_000], 1)
    assert c[0, 0] == ids[15_000]
    assert t.n_rows == 20_000
    # the appended slots hold what a reseal of the same rows holds
    fresh = MeshTable("m7f", 32)
    fresh.insert({"id": ids[:12_000], "vec": vecs[:12_000]})
    u = MeshTable("m7u", 32)
    u.insert({"id": ids[:10_000], "vec": vecs[:10_000]})
    u._seal()
    u.insert({"id": ids[10_000:12_000], "vec": vecs[10_000:12_000]})
    q = vecs[[2, 10_500, 11_999]] + 0.01
    np.testing.assert_array_equal(u.search(q, 5)[0], fresh.search(q, 5)[0])


def test_ivf_delta_scan_after_insert(corpus, jdelta):
    ids, vecs, price = corpus
    t = MeshTable("m8", 32)
    t.insert({"id": ids[:16_000], "vec": vecs[:16_000]})
    t.build_ivf(ncentroids=32)
    t.insert({"id": ids[16_000:17_000], "vec": vecs[16_000:17_000]})
    out, _ = t.search(vecs[16_500], 1, params={"nprobe": 4})
    assert out[0, 0] == ids[16_500]
    u = _delta_table("m8j", corpus, jdelta["ivf_index"], "ivf")
    _same(u.search(vecs[[16_500, 16_001, 3, 900]] + 0.01, 5, params={"nprobe": 4}),
          jdelta["ivf"])


def _docs4000():
    return np.array(
        [f"alpha beta doc{i}" if i % 7 == 0 else f"gamma delta doc{i}" for i in range(4000)],
        dtype=object,
    )


@pytest.fixture(scope="module")
def jtext(corpus):
    """The JAX text tables of test_text_and_hybrid (4,000 documents) and
    test_hybrid_rsf_and_batch_distance (600): BM25 batches (with ties),
    a filtered batch, hybrid RRF and RSF."""
    ids, vecs, price = corpus
    n = 4000
    t = JMeshTable("m9", 32, text_column="body", filter_columns=("price",))
    t.insert({"id": ids[:n], "vec": vecs[:n], "price": price[:n], "body": _docs4000()})
    out = {
        "text": t.text_search(["doc91", "alpha", "gamma", "doc182", "beta doc7"], 10),
        "filtered": t.text_search(["gamma", "alpha"], 10, filter=lambda price: price < 100),
        "hybrid": t.hybrid_search(vecs[[91, 14]], ["doc91", "alpha"], 5),
    }
    u = JMeshTable("m13", 32, text_column="body")
    u.insert({"id": ids[:600], "vec": vecs[:600], "body": _docs600()})
    out["rsf"] = u.hybrid_search(vecs[[33, 36]], ["needle33", "gamma"], 5, fusion_type="rsf",
                                 fusion_weight=0.5)
    return out


def test_text_and_hybrid(corpus, jtext):
    ids, vecs, price = corpus
    n = 4000
    t = MeshTable("m9", 32, text_column="body", filter_columns=("price",))
    t.insert({"id": ids[:n], "vec": vecs[:n], "price": price[:n], "body": _docs4000()})
    out_ids, scores = t.text_search("doc91", 3)
    assert out_ids[0, 0] == ids[91]
    out_ids, _ = t.text_search("alpha", 10)
    got = [int(i) for i in out_ids[0] if i >= 0]
    assert got and all((int(i) // 7) % 7 == 0 for i in got)
    out_ids, _ = t.text_search("gamma", 10, filter=lambda price: price < 100)
    sel = {int(i) for i, p in zip(ids[:n], price[:n]) if p < 100}
    assert all(int(i) in sel for i in out_ids[0] if i >= 0)
    out_ids, scores = t.hybrid_search(vecs[91], "doc91", 5)
    assert out_ids[0, 0] == ids[91]
    out_ids, _ = t.text_search(["doc91", "doc182"], 1)
    assert out_ids[0, 0] == ids[91] and out_ids[1, 0] == ids[182]
    # the JAX table's BM25 (ties break by slot on both), filter and RRF
    _same(t.text_search(["doc91", "alpha", "gamma", "doc182", "beta doc7"], 10), jtext["text"])
    _same(t.text_search(["gamma", "alpha"], 10, filter=lambda price: price < 100),
          jtext["filtered"])
    _same(t.hybrid_search(vecs[[91, 14]], ["doc91", "alpha"], 5), jtext["hybrid"])


def test_text_follows_incremental_insert(corpus):
    ids, vecs, price = corpus
    t = MeshTable("m10", 32, text_column="body")
    t.insert(
        {"id": ids[:1000], "vec": vecs[:1000],
         "body": np.array(["common filler"] * 1000, dtype=object)}
    )
    a, _ = t.text_search("needle", 1)
    assert a[0, 0] == -1
    t.insert(
        {"id": np.array([777_777], np.int64), "vec": vecs[1000:1001],
         "body": np.array(["the needle doc"], dtype=object)}
    )
    b, _ = t.text_search("needle", 1)
    assert b[0, 0] == 777_777


def test_predicate_fresh_lambdas(corpus):
    """The counterpart of the JAX test_predicate_skeleton_cache: fresh
    lambdas and a changed closure constant each filter by their own
    constant (the port calls the filter eagerly on each shard's columns;
    there is no trace to cache)."""
    ids, vecs, price = corpus
    t = MeshTable("m11", 32, filter_columns=("price",))
    t.insert({"id": ids[:2000], "vec": vecs[:2000], "price": price[:2000]})

    def make(lo):
        return lambda price: price < lo

    stored = torch.from_numpy(vecs[:2000]).to(torch.bfloat16).to(torch.float32).numpy()
    for lo in (100, 500, 50):
        out, _ = t.search(vecs[1], 10, filter=make(lo))
        sel = {int(i) for i, p in zip(ids[:2000], price[:2000]) if p < lo}
        got = [int(i) for i in out[0] if i >= 0]
        assert got and all(i in sel for i in got)
        # the nearest passing rows of the stored (bf16) values
        want = [int(ids[j]) for j in _gt_l2(stored, vecs[1], 2000) if price[j] < lo][:10]
        assert got == want


def test_save_load(tmp_path, corpus):
    ids, vecs, price = corpus
    t = MeshTable("m12", 32, filter_columns=("price",), text_column="body")
    docs = np.array([f"tok{i}" for i in range(500)], dtype=object)
    t.insert({"id": ids[:500], "vec": vecs[:500], "price": price[:500], "body": docs})
    t.delete(int(ids[3]))
    t.save(str(tmp_path / "mt"))
    t2 = TMeshTable.load(str(tmp_path / "mt"), mesh=make_mesh(8, device="cpu"))
    assert t2.n_rows == 499
    out, _ = t2.search(vecs[7], 1)
    assert out[0, 0] == ids[7]
    out, _ = t2.search(vecs[3], 1)
    assert out[0, 0] != ids[3]
    out, _ = t2.text_search("tok42", 1)
    assert out[0, 0] == ids[42]
    files = sorted(os.listdir(tmp_path / "mt"))
    assert "meshtable.npz" not in files
    assert sum(f.startswith("shard_") for f in files) == t.n_shards
    total = 0
    for f in files:
        if f.startswith("shard_"):
            with np.load(tmp_path / "mt" / f, allow_pickle=False) as z:
                total += len(z["ids"])
    assert total == 500


def test_load_legacy_monolithic(tmp_path, corpus):
    ids, vecs, price = corpus
    root = tmp_path / "legacy"
    root.mkdir()
    np.savez(
        root / "meshtable.npz", ids=ids[:100], vecs=vecs[:100],
        deleted=np.array([int(ids[5])], np.int64), col_price=price[:100],
    )
    with open(root / "meshtable.json", "w") as f:
        json.dump({"name": "mleg", "dim": 32, "metric": "L2", "filter_columns": ["price"],
                   "text_column": None, "analyzer_params": None}, f)
    t = TMeshTable.load(str(root), mesh=make_mesh(8, device="cpu"))
    assert t.n_rows == 99
    out, _ = t.search(vecs[7], 1)
    assert out[0, 0] == ids[7]


def _docs600():
    return np.array(
        ["alpha beta" if i % 3 else f"needle{i} gamma" for i in range(600)], dtype=object
    )


def test_hybrid_rsf_and_batch_distance(corpus, jtext):
    ids, vecs, price = corpus
    t = MeshTable("m13", 32, text_column="body")
    t.insert({"id": ids[:600], "vec": vecs[:600], "body": _docs600()})
    h_ids, h_sc = t.hybrid_search(vecs[33], "needle33", 3, fusion_type="rsf", fusion_weight=0.5)
    assert h_ids[0, 0] == ids[33]
    assert 0.0 <= float(h_sc[0, 0]) <= 1.0 + 1e-6
    h_ids, _ = t.hybrid_search(vecs[33], "needle33", 3)
    assert h_ids[0, 0] == ids[33]
    with pytest.raises(QueryShapeError):
        t.hybrid_search(vecs[33], "needle33", 3, fusion_type="nope")
    triples = t.batch_distance(vecs[[10, 20]], 3)
    per_q = {}
    for qi, rid, _s in triples:
        per_q.setdefault(qi, []).append(rid)
    assert set(per_q) == {0, 1}
    assert per_q[0][0] == ids[10] and per_q[1][0] == ids[20]
    assert len(per_q[0]) == 3 and len(per_q[1]) == 3
    _same(t.hybrid_search(vecs[[33, 36]], ["needle33", "gamma"], 5, fusion_type="rsf",
                          fusion_weight=0.5), jtext["rsf"])
