"""The JAX package's multi-chip dry run (__graft_entry__.py: the
distributed full step, then the MeshTable construct) with its assertions
unchanged, on the JAX package (the virtual 8-device CPU mesh of
tests/conftest.py) and on the port (a Mesh of eight `cpu` entries), at 8
devices and query axis 2. It has a file of its own because the JAX side
alone takes about a minute on the CPU."""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.parallel import distributed as jdist
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.parallel import distributed as tdist


def _np(x):
    if isinstance(x, (list, tuple)):
        x = x[0]  # a replicated result: every copy is the same
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x))


class _Pkg:
    """What differs between the two packages in the dry run."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            from myscaledb_tpu.parallel.mesh_table import MeshTable

            self.dist, self.metric, self.MeshTable = jdist, JMetric, MeshTable
        else:
            from myscaledb_tpu_torch.parallel.mesh_table import MeshTable

            self.dist, self.metric, self.MeshTable = tdist, Metric, MeshTable

    def mesh(self, n, query_axis):
        if self.name == "jax":
            return jdist.make_mesh(n, query_axis=query_axis)
        return tdist.make_mesh(n, query_axis=query_axis, device="cpu")

    def queries(self, mesh, q):
        if self.name == "jax":
            return jax.device_put(q, NamedSharding(mesh, P("query", None)))
        return torch.from_numpy(q)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_multichip_dryrun(pkg):
    """__graft_entry__.py's dry run (the distributed step, then the
    MeshTable construct) at 8 devices and query axis 2, its assertions
    unchanged, on each package."""
    p = _Pkg(pkg)
    dist = p.dist
    n_devices, query_axis = 8, 2
    mesh = p.mesh(n_devices, query_axis)
    s = mesh.shape["data"]

    rng = np.random.default_rng(0)
    rows_per_shard = 256
    n, d, c, k, nq = rows_per_shard * s, 128, 16, 8, 8 * query_axis
    x = rng.standard_normal((n, d)).astype(np.float32)
    aux = np.sum(x.astype(np.float64) ** 2, axis=1).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)

    n_clusters, bucket = 8, rows_per_shard // 8
    ivf_cents = np.zeros((s, n_clusters, d), np.float32)
    ivf_csq = np.zeros((s, n_clusters), np.float32)
    ivf_pdata = np.zeros((s, rows_per_shard, d), np.float32)
    ivf_paux = np.full((s, rows_per_shard), np.inf, np.float32)
    ivf_prows = np.full((s, rows_per_shard), -1, np.int32)
    ivf_cstart = np.zeros((s, n_clusters + 1), np.int32)
    for sh in range(s):
        rows = x[sh * rows_per_shard : (sh + 1) * rows_per_shard]
        assign = np.arange(rows_per_shard) % n_clusters
        order = np.argsort(assign, kind="stable").astype(np.int32)
        sizes = np.bincount(assign, minlength=n_clusters)
        ivf_cstart[sh, 1:] = np.cumsum(sizes)
        ivf_pdata[sh] = rows[order]
        ivf_paux[sh] = (rows[order].astype(np.float64) ** 2).sum(1)
        ivf_prows[sh] = order
        for ci in range(n_clusters):
            ivf_cents[sh, ci] = rows[assign == ci].mean(0)
        ivf_csq[sh] = (ivf_cents[sh] ** 2).sum(1)

    vocab, terms_per_doc = 16, 4
    doc_terms = rng.integers(0, vocab, size=(n, terms_per_doc))
    df_global = np.zeros(vocab, np.int64)
    for t in range(vocab):
        df_global[t] = int(((doc_terms == t).any(1)).sum())
    total_tokens = n * terms_per_doc
    avg_len = total_tokens / n
    idf = np.log(1.0 + (n - df_global + 0.5) / (df_global + 0.5)).astype(np.float32)
    query_terms = [1, 5, 11]
    nnz_pad = rows_per_shard * terms_per_doc + 64
    bm25_budget = 256
    t_starts = np.zeros((s, len(query_terms)), np.int32)
    t_lengths = np.zeros((s, len(query_terms)), np.int32)
    t_prow = np.zeros((s, nnz_pad + bm25_budget), np.int32)
    t_ptf = np.zeros((s, nnz_pad + bm25_budget), np.float32)
    t_dlen = np.full((s, rows_per_shard), float(terms_per_doc), np.float32)
    for sh in range(s):
        local_docs = doc_terms[sh * rows_per_shard : (sh + 1) * rows_per_shard]
        cursor = 0
        for j, t in enumerate(query_terms):
            tf = (local_docs == t).sum(1)
            hit = np.nonzero(tf)[0]
            t_starts[sh, j] = cursor
            t_lengths[sh, j] = len(hit)
            t_prow[sh, cursor : cursor + len(hit)] = hit
            t_ptf[sh, cursor : cursor + len(hit)] = tf[hit]
            cursor += len(hit)

    step = dist.make_full_step(
        mesh, k=k, metric=p.metric.L2, rows_per_shard=rows_per_shard, nprobe=n_clusters,
        bucket_pad=bucket, bm25_budget=bm25_budget,
    )
    out = step(
        p.queries(mesh, q),
        dist.shard_rows(mesh, x),
        dist.shard_rows(mesh, aux),
        dist.replicate(mesh, x[:c]),
        dist.shard_rows(mesh, ivf_cents),
        dist.shard_rows(mesh, ivf_csq),
        dist.shard_rows(mesh, ivf_pdata),
        dist.shard_rows(mesh, ivf_paux),
        dist.shard_rows(mesh, ivf_prows),
        dist.shard_rows(mesh, ivf_cstart),
        dist.shard_rows(mesh, t_starts),
        dist.shard_rows(mesh, t_lengths),
        dist.replicate(mesh, idf),
        dist.replicate(mesh, np.float32(avg_len)),
        dist.shard_rows(mesh, t_prow),
        dist.shard_rows(mesh, t_ptf),
        dist.shard_rows(mesh, t_dlen),
    )
    ev, er, iv, ir, tv, tr, fv, fr, cents = (_np(o) for o in out)

    assert ev.shape == (nq, k) and er.shape == (nq, k)
    assert cents.shape == (c, d)
    s_exact = 2 * q @ x.T - aux[None, :]
    want = np.sort(np.argsort(-s_exact, axis=1)[:, :k], axis=1)
    assert np.array_equal(np.sort(er, axis=1), want), "exact-scan merge mismatch"
    gt_vals = np.sort(s_exact, axis=1)[:, -k:][:, ::-1]
    assert np.allclose(np.sort(iv, 1), np.sort(gt_vals, 1), atol=1e-2), (
        "sharded IVF full-probe != exact scan"
    )
    k1, b = 1.2, 0.75
    bm = np.zeros(n)
    for j, t in enumerate(query_terms):
        tf = (doc_terms == t).sum(1).astype(np.float64)
        denom = tf + k1 * (1 - b + b * terms_per_doc / avg_len)
        bm += np.where(tf > 0, idf[j] * tf * (k1 + 1) / denom, 0.0)
    bm_sorted = np.sort(bm)[::-1][:k]
    assert np.allclose(np.sort(tv[0])[::-1], bm_sorted, atol=1e-3), (
        "sharded BM25 != numpy global-stats BM25"
    )
    for qi in range(nq):
        rrf = {}
        for rank, rid in enumerate(ir[qi], start=1):
            if rid >= 0:
                rrf[rid] = rrf.get(rid, 0.0) + 1.0 / (60 + rank)
        for rank, rid in enumerate(tr[0], start=1):
            if rid >= 0:
                rrf[rid] = rrf.get(rid, 0.0) + 1.0 / (60 + rank)
        want_scores = np.sort(np.array(list(rrf.values())))[::-1][:k]
        assert np.allclose(np.sort(fv[qi])[::-1][: len(want_scores)], want_scores, atol=1e-6), (
            "device RRF fusion != numpy RRF"
        )

    MeshTable = p.MeshTable
    mt = MeshTable("dryrun", d, mesh=mesh, filter_columns=("price",))
    ids = np.arange(n, dtype=np.int64) * 3
    price = (np.arange(n) % 100).astype(np.int32)
    mt.insert({"id": ids, "vec": x, "price": price})
    out_ids, _ = mt.search(x[17], k)
    assert out_ids[0, 0] == ids[17], "MeshTable exact scan self-hit failed"
    out_ids, _ = mt.search(x[17], k, filter=lambda price: price < 5)
    got = [int(i) for i in out_ids[0] if i >= 0]
    assert got and all((i // 3) % 100 < 5 for i in got), "MeshTable filter leak"
    mt.build_ivf(ncentroids=8)
    out_ids, _ = mt.search(x[33], k, params={"nprobe": 8})
    assert out_ids[0, 0] == ids[33], "MeshTable sharded IVF full-probe failed"
    out_ids, _ = mt.search(x[33], k, params={"nprobe": 8}, filter=lambda price: price < 5)
    got = [int(i) for i in out_ids[0] if i >= 0]
    assert got and all((i // 3) % 100 < 5 for i in got), "MeshTable filtered-IVF leak"
    mt.delete(int(ids[33]))
    out_ids, _ = mt.search(x[33], k, params={"nprobe": 8})
    assert out_ids[0, 0] != ids[33], "MeshTable IVF delete leak"
    mt.insert(
        {"id": np.array([10**6], np.int64), "vec": x[33:34] + 1e-3,
         "price": np.array([7], np.int32)}
    )
    out_ids, _ = mt.search(x[33] + 1e-3, k, params={"nprobe": 8})
    assert out_ids[0, 0] == 10**6, "MeshTable IVF delta-scan miss"

    mt_ts = MeshTable("dryrun_mstg", d, mesh=mesh)
    mt_ts.insert({"id": ids, "vec": x})
    mt_ts.build_mstg(ncentroids=8)
    assert _np(mt_ts._mstg[4]).dtype == np.uint8, "MSTG payload not SQ8 codes"
    ts_ids, ts_sc = mt_ts.search(x[21], k, params={"nprobe": 8})
    ex_ids, ex_sc = mt_ts.search(x[21], k)
    assert ts_ids[0, 0] == ids[21], "MeshTable two-stage self-hit failed"
    assert set(ts_ids[0]) == set(ex_ids[0]), "two-stage full-probe != exact"
    assert np.allclose(ts_sc[0], ex_sc[0], rtol=1e-4), "two-stage re-rank scores not exact"

    mt2 = MeshTable("dryrun_text", d, mesh=mesh, text_column="body")
    docs = np.array(
        ["alpha beta" if i % 3 else f"needle{i} gamma" for i in range(n)], dtype=object
    )
    mt2.insert({"id": ids, "vec": x, "body": docs})
    t_ids, t_sc = mt2.text_search("needle33", 3)
    assert t_ids[0, 0] == ids[33], "MeshTable BM25 text-search miss"
    h_ids, _ = mt2.hybrid_search(x[33], "needle33", 3)
    assert h_ids[0, 0] == ids[33], "MeshTable hybrid RRF miss"
    h_ids, h_sc = mt2.hybrid_search(x[33], "needle33", 3, fusion_type="rsf", fusion_weight=0.5)
    assert h_ids[0, 0] == ids[33], "MeshTable hybrid RSF miss"
    assert 0.0 <= float(h_sc[0, 0]) <= 1.0 + 1e-6, "RSF score out of range"
    triples = mt.batch_distance(x[[10, 20]], 3)
    per_q = {}
    for qi, rid, _s in triples:
        per_q.setdefault(qi, []).append(rid)
    assert set(per_q) == {0, 1} and per_q[0][0] == ids[10] and per_q[1][0] == ids[20], (
        "MeshTable batch_distance miss"
    )
    with tempfile.TemporaryDirectory() as ckpt:
        mt.save(ckpt)
        files = sorted(os.listdir(ckpt))
        n_sh = int(mesh.shape["data"])
        assert (
            sum(f.startswith("shard_") for f in files) == n_sh and "meshtable.npz" not in files
        ), f"per-shard checkpoint layout wrong: {files}"
        mt3 = MeshTable.load(ckpt, mesh=mesh)
        assert mt3.n_rows == mt.n_rows, "per-shard load row-count mismatch"
        out_ids, _ = mt3.search(x[17], k)
        assert out_ids[0, 0] == ids[17], "per-shard load search miss"
        out_ids, _ = mt3.search(x[33], k)
        assert out_ids[0, 0] != ids[33], "per-shard load lost deletes"
