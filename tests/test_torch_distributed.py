"""The port's parallel/distributed.py (myscaledb_tpu_torch on the CPU)
against the JAX package's, mirroring tests/test_distributed.py: the JAX
side runs on the virtual 8-device CPU mesh of tests/conftest.py, the port
on a Mesh of eight `cpu` entries (query axis 2, data axis 4). The same
seeded numpy inputs go through both; ids must be equal (the inputs have no
ties where vectors are scored; BM25 ties break by row on both sides) and
scores agree within rtol 2e-4 / atol 2e-3. The JAX package's multi-chip
dry run on each package is in tests/test_torch_mesh_dryrun.py."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.parallel import distributed as jdist
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import bruteforce, kmeans
from myscaledb_tpu_torch.parallel import distributed as tdist

TOL = dict(rtol=2e-4, atol=2e-3)


@pytest.fixture(scope="module")
def meshes():
    return jdist.make_mesh(8, query_axis=2), tdist.make_mesh(8, query_axis=2, device="cpu")


def _np(x):
    if isinstance(x, (list, tuple)):
        x = x[0]  # a replicated result: every copy is the same
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(jax.device_get(x))


def _jq(mesh, q):
    return jax.device_put(q, NamedSharding(mesh, P("query", None)))


def _aux(x, metric):
    x64 = x.astype(np.float64)
    if metric == "L2":
        return (x64**2).sum(1).astype(np.float32)
    if metric == "Cosine":
        return (1.0 / np.sqrt((x64**2).sum(1))).astype(np.float32)
    return np.zeros(len(x), np.float32)


def test_mesh_shapes():
    mesh = tdist.make_mesh(8, query_axis=2, device="cpu")
    assert mesh.shape == {"query": 2, "data": 4}
    assert mesh.shape == jdist.make_mesh(8, query_axis=2).shape
    assert tdist.Mesh([torch.device("cpu")] * 4).shape == {"query": 1, "data": 4}
    assert tdist.Mesh([["cpu"] * 3] * 2).devices[1][2] == torch.device("cpu")
    with pytest.raises(ValueError):
        tdist.Mesh([["cpu"] * 3, ["cpu"] * 2])
    with pytest.raises(ValueError):
        tdist.make_mesh(6, query_axis=4, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tdist.Mesh([["meta"]])


def test_distributed_scan_matches_single(rng, meshes):
    jmesh, mesh = meshes
    n, d, k, nq = 4096, 128, 10, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    aux = _aux(x, "L2")
    v, r = tdist.distributed_scan_topk(
        mesh, torch.from_numpy(q), tdist.shard_rows(mesh, x), tdist.shard_rows(mesh, aux),
        k=k, metric=Metric.L2, rows_per_shard=n // 4,
    )
    sv, sr = bruteforce.scan_topk_t(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(aux), k=k,
        metric=Metric.L2, n_valid=n,
    )
    np.testing.assert_array_equal(np.sort(r.numpy(), 1), np.sort(sr.numpy(), 1))
    np.testing.assert_allclose(v.numpy(), sv.numpy(), rtol=1e-5)
    # the JAX package's sharded scan on the same inputs
    jv, jr = jdist.distributed_scan_topk(
        jmesh, _jq(jmesh, q), jdist.shard_rows(jmesh, x), jdist.shard_rows(jmesh, aux),
        k=k, metric=JMetric.L2, rows_per_shard=n // 4,
    )
    np.testing.assert_array_equal(r.numpy(), _np(jr))
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_distributed_scan_masked_matches_jax(meshes, metric):
    jmesh, mesh = meshes
    rng = np.random.default_rng(7)
    n, d, k, nq = 2048, 64, 8, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    aux = _aux(x, metric)
    mask = rng.random(n) < 0.3
    v, r = tdist.distributed_scan_topk(
        mesh, torch.from_numpy(q), tdist.shard_rows(mesh, x), tdist.shard_rows(mesh, aux),
        k=k, metric=Metric(metric), rows_per_shard=n // 4, mask=tdist.shard_rows(mesh, mask),
    )
    jv, jr = jdist.distributed_scan_topk(
        jmesh, _jq(jmesh, q), jdist.shard_rows(jmesh, x), jdist.shard_rows(jmesh, aux),
        k=k, metric=JMetric(metric), rows_per_shard=n // 4, mask=jdist.shard_rows(jmesh, mask),
    )
    assert mask[r.numpy()].all()
    np.testing.assert_array_equal(r.numpy(), _np(jr))
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)


def test_sharded_kmeans_matches_reference_step(rng, meshes):
    jmesh, mesh = meshes
    n, d, c = 2048, 16, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    cents0 = x[:c].astype(np.float32)
    m1 = tdist.make_mesh(8, query_axis=1, device="cpu")
    out = tdist.sharded_lloyd_step(m1, tdist.shard_rows(m1, x), tdist.replicate(m1, cents0))
    assert len(out) == 8 and all(o is out[0] for o in out)  # one copy on one device
    # single-device reference step
    sums, counts = kmeans.lloyd_stats(torch.from_numpy(x), torch.from_numpy(cents0))
    want = kmeans.lloyd_update(torch.from_numpy(cents0), sums, counts).numpy()
    np.testing.assert_allclose(_np(out), want, rtol=1e-5, atol=1e-5)
    jm1 = jdist.make_mesh(8, query_axis=1)
    jout = jdist.sharded_lloyd_step(jm1, jdist.shard_rows(jm1, x), jdist.replicate(jm1, cents0))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
    # the fit from the corpus's first rows, against the JAX package's
    fit = tdist.sharded_kmeans_fit(mesh, tdist.shard_rows(mesh, x), n_clusters=c, n_iters=3)
    jfit = jdist.sharded_kmeans_fit(jmesh, jdist.shard_rows(jmesh, x), n_clusters=c, n_iters=3)
    np.testing.assert_allclose(_np(fit), _np(jfit), rtol=1e-4, atol=1e-5)


def test_fused_train_and_search_step(rng, meshes):
    jmesh, mesh = meshes
    n, d, c, k, nq = 1024, 128, 16, 8, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    aux = np.sum(x**2, 1).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    step = tdist.make_train_and_search_step(mesh, k=k, metric=Metric.L2, rows_per_shard=n // 4)
    vals, rows, cents = step(
        torch.from_numpy(q), tdist.shard_rows(mesh, x), tdist.shard_rows(mesh, aux),
        tdist.replicate(mesh, x[:c]),
    )
    assert vals.shape == (nq, k) and rows.shape == (nq, k)
    assert _np(cents).shape == (c, d)
    assert np.all(np.isfinite(vals.numpy()))
    assert np.all(rows.numpy() >= 0)
    jstep = jdist.make_train_and_search_step(
        jmesh, k=k, metric=JMetric.L2, rows_per_shard=n // 4
    )
    jv, jr, jc = jstep(
        _jq(jmesh, q), jdist.shard_rows(jmesh, x), jdist.shard_rows(jmesh, aux),
        jdist.replicate(jmesh, x[:c]),
    )
    np.testing.assert_array_equal(rows.numpy(), _np(jr))
    np.testing.assert_allclose(vals.numpy(), _np(jv), **TOL)
    np.testing.assert_allclose(_np(cents), _np(jc), rtol=1e-5, atol=1e-5)


def _ivf_layout(x, s, rows_per_shard, n_clusters):
    """A per-shard cluster-major IVF layout in numpy (clusters of unequal
    sizes), with the SQ8 codes of the same order for the two-stage
    search."""
    d = x.shape[1]
    lo = x.min(0)
    scale = (x.max(0) - lo) / 255.0
    out = {f: [] for f in ("cents", "csq", "pdata", "paux", "prows", "cstart", "codes", "psq")}
    bucket = 0
    for sh in range(s):
        rows = x[sh * rows_per_shard : (sh + 1) * rows_per_shard]
        assign = (np.arange(rows_per_shard) * 7 + sh) % n_clusters
        assign[: rows_per_shard // 4] = 0  # one big cluster
        order = np.argsort(assign, kind="stable").astype(np.int32)
        sizes = np.bincount(assign, minlength=n_clusters)
        bucket = max(bucket, int(sizes.max()))
        cstart = np.zeros(n_clusters + 1, np.int32)
        cstart[1:] = np.cumsum(sizes)
        cents = np.stack([rows[assign == ci].mean(0) for ci in range(n_clusters)])
        codes = np.clip(np.round((rows[order] - lo) / scale), 0, 255).astype(np.uint8)
        dec = codes.astype(np.float32) * scale + lo
        out["cents"].append(cents.astype(np.float32))
        out["csq"].append((cents**2).sum(1).astype(np.float32))
        out["pdata"].append(rows[order])
        out["paux"].append((rows[order].astype(np.float64) ** 2).sum(1).astype(np.float32))
        out["prows"].append(order)
        out["cstart"].append(cstart)
        out["codes"].append(codes)
        out["psq"].append((dec * dec).sum(1).astype(np.float32))
    arrays = {f: np.stack(v) for f, v in out.items()}
    assert arrays["pdata"].shape == (s, rows_per_shard, d)
    return arrays, lo.astype(np.float32), scale.astype(np.float32), bucket


def test_ivf_and_twostage_match_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(11)
    s, rps, d, c, k, nq = 4, 512, 32, 8, 8, 16
    x = rng.standard_normal((s * rps, d)).astype(np.float32)
    q = (x[rng.choice(s * rps, nq, replace=False)] + 0.3 * rng.standard_normal((nq, d))).astype(
        np.float32
    )
    aux = _aux(x, "L2")
    lay, lo, scale, bucket = _ivf_layout(x, s, rps, c)
    mask = rng.random(s * rps) < 0.7
    fields = ("cents", "csq", "pdata", "paux", "prows", "cstart")
    v, r = tdist.distributed_ivf_topk(
        mesh, torch.from_numpy(q), *(tdist.shard_rows(mesh, lay[f]) for f in fields),
        k=k, nprobe=3, bucket_pad=bucket, rows_per_shard=rps, mask=tdist.shard_rows(mesh, mask),
    )
    jv, jr = jdist.distributed_ivf_topk(
        jmesh, _jq(jmesh, q), *(jdist.shard_rows(jmesh, lay[f]) for f in fields),
        k=k, nprobe=3, bucket_pad=bucket, rows_per_shard=rps, mask=jdist.shard_rows(jmesh, mask),
    )
    assert (r.numpy() >= 0).all() and mask[r.numpy()].all()
    np.testing.assert_array_equal(r.numpy(), _np(jr))
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)
    # every cluster probed: the exact scan's answer over the masked rows
    v_all, r_all = tdist.distributed_ivf_topk(
        mesh, torch.from_numpy(q), *(tdist.shard_rows(mesh, lay[f]) for f in fields),
        k=k, nprobe=c, bucket_pad=bucket, rows_per_shard=rps, mask=tdist.shard_rows(mesh, mask),
    )
    s_exact = np.where(mask[None], 2 * q @ x.T - aux[None], -np.inf)
    want = np.argsort(-s_exact, axis=1)[:, :k]
    np.testing.assert_array_equal(r_all.numpy(), want)

    ts = ("cents", "csq")
    rest = ("codes", "psq", "prows", "cstart")
    tv, tr = tdist.distributed_twostage_topk(
        mesh, torch.from_numpy(q), *(tdist.shard_rows(mesh, lay[f]) for f in ts),
        tdist.replicate(mesh, lo), tdist.replicate(mesh, scale),
        *(tdist.shard_rows(mesh, lay[f]) for f in rest),
        tdist.shard_rows(mesh, x), tdist.shard_rows(mesh, aux),
        k=k, nprobe=3, num_reorder=24, bucket_pad=bucket, rows_per_shard=rps,
        mask=tdist.shard_rows(mesh, mask),
    )
    jtv, jtr = jdist.distributed_twostage_topk(
        jmesh, _jq(jmesh, q), *(jdist.shard_rows(jmesh, lay[f]) for f in ts),
        jdist.replicate(jmesh, lo), jdist.replicate(jmesh, scale),
        *(jdist.shard_rows(jmesh, lay[f]) for f in rest),
        jdist.shard_rows(jmesh, x), jdist.shard_rows(jmesh, aux),
        k=k, nprobe=3, num_reorder=24, bucket_pad=bucket, rows_per_shard=rps,
        mask=jdist.shard_rows(jmesh, mask),
    )
    np.testing.assert_array_equal(tr.numpy(), _np(jtr))
    np.testing.assert_allclose(tv.numpy(), _np(jtv), **TOL)
    # the re-rank scores are exact: each hit's f32 score of its own row
    got = tr.numpy()
    np.testing.assert_allclose(tv.numpy(), np.take_along_axis(s_exact, got, 1), **TOL)


def _postings(doc_terms, s, rps, query_terms, budget):
    """Per-shard postings of each query's terms: starts / lengths
    [S, Q, T] into [S, W] rows / tf, with tail padding >= budget."""
    nq, nt = query_terms.shape
    width = rps * doc_terms.shape[1] * nq + budget
    starts = np.zeros((s, nq, nt), np.int32)
    lengths = np.zeros((s, nq, nt), np.int32)
    prow = np.zeros((s, width), np.int32)
    ptf = np.zeros((s, width), np.float32)
    for sh in range(s):
        local = doc_terms[sh * rps : (sh + 1) * rps]
        cursor = 0
        for qi in range(nq):
            for j, t in enumerate(query_terms[qi]):
                tf = (local == t).sum(1)
                hit = np.nonzero(tf)[0]
                starts[sh, qi, j] = cursor
                lengths[sh, qi, j] = len(hit)
                prow[sh, cursor : cursor + len(hit)] = hit
                ptf[sh, cursor : cursor + len(hit)] = tf[hit]
                cursor += len(hit)
    return starts, lengths, prow, ptf


def test_bm25_topk_batch_matches_jax(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(5)
    s, rps, vocab, k, budget = 4, 128, 40, 10, 128
    n = s * rps
    lens = rng.integers(2, 9, n)
    doc_terms = np.full((n, 8), -1)
    for i, ln in enumerate(lens):
        doc_terms[i, :ln] = rng.integers(0, vocab, ln)
    query_terms = rng.integers(0, vocab, (6, 3))
    starts, lengths, prow, ptf = _postings(doc_terms, s, rps, query_terms, budget)
    df = np.array([int((doc_terms == t).any(1).sum()) for t in range(vocab)])
    idf_all = np.log(1.0 + (n - df + 0.5) / (df + 0.5)).astype(np.float32)
    idfs = idf_all[query_terms]
    avg_len = np.float32(lens.sum() / n)
    dlen = lens.astype(np.float32).reshape(s, rps)
    alive = rng.random(n) < 0.8
    args = (starts, lengths)
    v, r = tdist.distributed_bm25_topk_batch(
        mesh, *(tdist.shard_rows(mesh, a) for a in args), tdist.replicate(mesh, idfs),
        tdist.replicate(mesh, avg_len), tdist.shard_rows(mesh, prow), tdist.shard_rows(mesh, ptf),
        tdist.shard_rows(mesh, dlen), tdist.shard_rows(mesh, alive),
        k=k, budget=budget, rows_per_shard=rps,
    )
    jv, jr = jdist.distributed_bm25_topk_batch(
        jmesh, *(jdist.shard_rows(jmesh, a) for a in args), jdist.replicate(jmesh, idfs),
        jdist.replicate(jmesh, avg_len), jdist.shard_rows(jmesh, prow),
        jdist.shard_rows(jmesh, ptf), jdist.shard_rows(jmesh, dlen),
        jdist.shard_rows(jmesh, alive), k=k, budget=budget, rows_per_shard=rps,
    )
    np.testing.assert_array_equal(r.numpy(), _np(jr))
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)
    # against an f64 BM25 with the global statistics
    for qi in range(len(query_terms)):
        bm = np.zeros(n)
        for j, t in enumerate(query_terms[qi]):
            tf = (doc_terms == t).sum(1).astype(np.float64)
            denom = tf + 1.2 * (0.25 + 0.75 * lens / float(avg_len))
            bm += np.where(tf > 0, idfs[qi, j] * tf * 2.2 / denom, 0.0)
        bm = np.where(alive, bm, 0.0)
        ok = r.numpy()[qi] >= 0
        np.testing.assert_allclose(v.numpy()[qi][ok], bm[r.numpy()[qi][ok]], rtol=1e-5)
        np.testing.assert_allclose(v.numpy()[qi][ok], np.sort(bm)[::-1][: ok.sum()], rtol=1e-5)
