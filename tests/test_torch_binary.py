"""Binary vectors: the port (myscaledb_tpu_torch, on the CPU) against the
JAX package on the same packed rows.

Hamming and Jaccard scores are integers, or an f32 quotient of two, so
the port's plain popcount (a 256-entry table over bytes) must give JAX's
`lax.population_count` scores exactly. Top-k selection is `torch.topk` on
both the exact scan and BinaryMSTG, which orders ties its own way: the
top-k scores must be JAX's exactly, and the ids JAX's wherever no tie
spans the k-th place (compared as sets).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.metrics import Metric as JMetric
from myscaledb_tpu.ops import binary as jbin
from myscaledb_tpu_torch.index.base import IndexStatus
from myscaledb_tpu_torch.index.ivf import default_ncentroids
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import binary as tbin
from myscaledb_tpu_torch.storage.convert import binary_from_state_dict, segment_from_arrays

METRICS = [("Hamming", Metric.HAMMING, JMetric.HAMMING), ("Jaccard", Metric.JACCARD, JMetric.JACCARD)]
K = 10


def _packed(rng, n, nbytes, density=0.5):
    bits = rng.random((n, nbytes * 8)) < density
    return np.packbits(bits, axis=1)


def _plant(rng, x, q, n_near=20):
    """Put, for each query, n_near rows that hold its bits plus 1, 2, ...,
    n_near more (set where the query has 0s): their Hamming and Jaccard
    scores are distinct, so no tie spans the k-th place among them."""
    bits = np.unpackbits(x, axis=1)
    for i, qq in enumerate(np.unpackbits(q, axis=1)):
        zeros = rng.permutation(np.nonzero(qq == 0)[0])
        for j in range(n_near):
            row = qq.copy()
            row[zeros[: j + 1]] = 1
            bits[i * n_near + j] = row
    return np.packbits(bits, axis=1)


def _clustered_bits(rng, n, dim, n_blobs=12, flip=0.08):
    """Sign-bit-like rows: blob prototypes with a few bits flipped."""
    protos = rng.random((n_blobs, dim)) < 0.5
    which = rng.integers(0, n_blobs, n)
    noise = rng.random((n, dim)) < flip
    return np.packbits(protos[which] ^ noise, axis=1)


@pytest.mark.parametrize("nbytes", [1, 5, 8, 13, 128])
@pytest.mark.parametrize("name,tm,jm", METRICS)
def test_chunk_scores_match_jax(name, tm, jm, nbytes):
    """B not a multiple of 4 included; all-zero rows and queries (Jaccard
    of two empty sets is 1.0)."""
    rng = np.random.default_rng(nbytes)
    q = _packed(rng, 7, nbytes)
    x = _packed(rng, 300, nbytes, density=0.3)
    q[0] = 0
    x[:4] = 0
    x[4] = 255
    want = np.asarray(jbin.binary_chunk_scores(jnp.asarray(q), jnp.asarray(x), jm))
    got = tbin.binary_chunk_scores(torch.from_numpy(q), torch.from_numpy(x), tm).numpy()
    np.testing.assert_array_equal(got, want)
    if tm == Metric.JACCARD:
        assert got[0, 0] == 1.0


@pytest.mark.parametrize("name,tm,jm", METRICS)
def test_block_scores_are_the_gathered_row_scores(name, tm, jm):
    """The blocks layout equals the rows layout on the gathered blocks,
    with empty slots and masked rows at -inf (Jaccard from the slots' bit
    counts, which Hamming does not read)."""
    rng = np.random.default_rng(3)
    c, m, nb, nq, p = 6, 40, 9, 5, 3
    x = _packed(rng, c * m, nb).reshape(c, m, nb)
    rows = rng.permutation(c * m).astype(np.int32).reshape(c, m)
    rows[:, -7:] = -1
    q = _packed(rng, nq, nb)
    blk = rng.integers(0, c, (nq, p)).astype(np.int32)
    mask = rng.random(c * m) < 0.7
    got = tbin.binary_block_scores(*(torch.from_numpy(a) for a in (q, x, blk, rows)), tm,
                                   mask=torch.from_numpy(mask),
                                   popcnt=tbin.row_popcounts(torch.from_numpy(x))).numpy()
    for i in range(nq):
        for j in range(p):
            want = np.asarray(jbin.binary_chunk_scores(jnp.asarray(q[i : i + 1]),
                                                       jnp.asarray(x[blk[i, j]]), jm))[0]
            r = rows[blk[i, j]]
            ok = (r >= 0) & mask[np.maximum(r, 0)]
            np.testing.assert_array_equal(got[i, j * m : (j + 1) * m], np.where(ok, want, -np.inf))


# (Q, P, C, lo, hi): blk drawn from [lo, hi), clamped to [0, C): all pairs on
# one bucket, on distinct buckets, C = 1, Q * P not a multiple of 16, P > C
# (repeats within a query), ids outside [0, C), and one bucket with a
# thousand pairs among many small ones
GROUP_CASES = [(100, 16, 1, 0, 1), (40, 3, 120, 0, 120), (7, 5, 1, -2, 3), (13, 7, 20, 0, 20),
               (9, 12, 4, 0, 4), (25, 4, 30, -5, 40), (1000, 2, 700, 0, 700)]


@pytest.mark.parametrize("q,p,c,lo,hi", GROUP_CASES)
def test_group_probes_plain(q, p, c, lo, hi):
    """Every (query, probe) pair once, in (bucket, q, p) order; groups of at
    most 16 pairs of one bucket (the bucket clamp(blk)) that cover each
    bucket's run in order; the count."""
    rng = np.random.default_rng(q * p + c)
    blk = rng.integers(lo, hi, (q, p)).astype(np.int32)
    if (q, p, c) == (40, 3, 120):
        blk = rng.permutation(c)[: q * p].reshape(q, p).astype(np.int32)  # all distinct
    if q == 1000:
        blk[::2, 0] = 3  # 500 pairs on bucket 3, 1,000 on a few others
    pairs, groups, count = tbin.group_probes_plain(torch.from_numpy(blk), c)
    pairs, groups, n = pairs.numpy(), groups.numpy(), int(count[0])
    bucket = np.clip(blk.reshape(-1), 0, c - 1)
    np.testing.assert_array_equal(pairs, np.lexsort((np.arange(q * p), bucket)))
    assert groups.shape == (tbin.group_bound(q * p, c), 3) and (groups[n:] == -1).all()
    g = groups[:n]
    assert ((g[:, 2] >= 1) & (g[:, 2] <= tbin.QT)).all()
    np.testing.assert_array_equal(np.cumsum(g[:, 2]) - g[:, 2], g[:, 1])  # consecutive runs
    assert g[:, 2].sum() == q * p
    np.testing.assert_array_equal(np.repeat(g[:, 0], g[:, 2]), bucket[pairs])
    # a bucket's groups are full but its last: ceil(count / 16) of them
    sizes = np.bincount(bucket, minlength=c)
    np.testing.assert_array_equal(np.bincount(g[:, 0], minlength=c), -(-sizes // tbin.QT))
    # the CPU route of the kernel's wrapper is the plain version
    for a, b in zip(tbin.group_probes(torch.from_numpy(blk), c),
                    tbin.group_probes_plain(torch.from_numpy(blk), c)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nbytes", [1, 5, 13, 128])
def test_jaccard_union_from_row_counts_is_bit_exact(nbytes):
    """Jaccard with each slot's bit count (|q| + |x| - |q & x|, one
    popcount a word) equals the two-popcount plain version bit for bit;
    all-zero queries and slots included (1.0 for two empty sets)."""
    rng = np.random.default_rng(nbytes + 40)
    c, m, nq, p = 5, 33, 6, 4
    x = _packed(rng, c * m, nbytes, density=0.3).reshape(c, m, nbytes)
    x[0, :3] = 0
    q = _packed(rng, nq, nbytes)
    q[0] = 0
    rows = rng.permutation(c * m).astype(np.int32).reshape(c, m)
    rows[:, -4:] = -1
    blk = rng.integers(-1, c + 1, (nq, p)).astype(np.int32)
    tq, tx, tb, tr = (torch.from_numpy(a) for a in (q, x, blk, rows))
    popcnt = tbin.row_popcounts(tx)
    np.testing.assert_array_equal(popcnt.numpy(), np.unpackbits(x, axis=-1).sum(-1))
    for mask in (None, torch.from_numpy(rng.random(c * m) < 0.7)):
        two = tbin.binary_block_scores_plain(tq, tx, tb, tr, mask, Metric.JACCARD)
        one = tbin.binary_block_scores_plain(tq, tx, tb, tr, mask, Metric.JACCARD, popcnt)
        assert torch.equal(one, two)
        assert torch.equal(tbin.binary_block_scores(tq, tx, tb, tr, Metric.JACCARD, mask=mask,
                                                    popcnt=popcnt), two)
    assert bool((two[0][torch.isfinite(two[0])] >= 0).all())


@pytest.mark.parametrize("popcnt", ["missing", "wrong shape", "int64"])
def test_jaccard_blocks_need_the_bit_counts(popcnt):
    """The blocks layout takes Jaccard only with each slot's bit count
    (int32[C, M]); Hamming does not read it."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy(_packed(rng, 4 * 9, 16).reshape(4, 9, 16))
    q = torch.from_numpy(_packed(rng, 3, 16))
    blk = torch.from_numpy(rng.integers(0, 4, (3, 2)).astype(np.int32))
    rows = torch.arange(36, dtype=torch.int32).reshape(4, 9)
    pc = {"missing": None, "wrong shape": tbin.row_popcounts(x)[:, :5],
          "int64": tbin.row_popcounts(x).to(torch.int64)}[popcnt]
    with pytest.raises(ValueError, match="Jaccard needs popcnt"):
        tbin.binary_block_scores(q, x, blk, rows, Metric.JACCARD, popcnt=pc)
    assert torch.equal(tbin.binary_block_scores(q, x, blk, rows, Metric.HAMMING, popcnt=pc),
                       tbin.binary_block_scores_plain(q, x, blk, rows, None, Metric.HAMMING))


def _topk_same(tv, ti, jv, ji, k=K):
    """Scores exactly; id sets where no tie spans the k-th place (the
    (k+1)-th score of JAX's run is given as jv[:, k])."""
    np.testing.assert_array_equal(tv[:, :k], jv[:, :k])
    compared = 0
    for i in range(jv.shape[0]):
        if jv.shape[1] == k or jv[i, k - 1] != jv[i, k]:
            assert set(ti[i, :k].tolist()) == set(ji[i, :k].tolist())
            compared += 1
    return compared


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,tm,jm", METRICS)
def test_scan_topk_chunked_matches_jax(name, tm, jm, masked):
    rng = np.random.default_rng(17)
    n, nvalid = 3 * 1024, 3 * 1024 - 50
    q = _packed(rng, 9, 16)
    x = _plant(rng, _packed(rng, n, 16), q)[rng.permutation(n)]
    mask = (rng.random(n) < 0.6) if masked else None
    kw = dict(k=K + 1, n_valid=nvalid, chunk_rows=1024)
    jv, ji = jbin.binary_scan_topk(jnp.asarray(q), jnp.asarray(x), metric=jm,
                                   mask=None if mask is None else jnp.asarray(mask), **kw)
    tv, ti = tbin.binary_scan_topk(torch.from_numpy(q), torch.from_numpy(x), metric=tm,
                                   mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert _topk_same(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)) >= 3
    assert (ti.numpy() < nvalid).all()
    if mask is not None:
        assert mask[ti.numpy()[ti.numpy() >= 0]].all()


def test_unpack_bits_matches_jax():
    rng = np.random.default_rng(1)
    x = _packed(rng, 11, 6)
    for dim in (48, 44):
        np.testing.assert_array_equal(tbin.unpack_bits_f32(torch.from_numpy(x), dim).numpy(),
                                      np.asarray(jbin.unpack_bits_f32(jnp.asarray(x), dim)))


# ------------------------------------------------------------------- table
DIM, N1, N2, NQ = 256, 6_000, 700, 16


def _binary_tables(kind, metric, min_rows_jax=1_000):
    rng = np.random.default_rng(23)
    packed = _clustered_bits(rng, N1 + N2, DIM)
    q = packed[rng.choice(N1 + N2, NQ)] ^ _packed(rng, NQ, DIM // 8, density=0.05)
    packed = _plant(rng, packed, q)
    ids = np.arange(N1 + N2, dtype=np.uint64)
    parts = [slice(0, N1), slice(N1, N1 + N2)]
    out = []
    for ms, min_rows in ((jms, min_rows_jax), (tms, 1_000)):
        st = ms.Settings()
        st.table.min_rows_to_build_vector_index = min_rows
        st.table.binary_vector_search_metric_type = metric
        db = ms.connect(st) if ms is jms else ms.connect(st, device="cpu")
        t = db.create_table("b", ms.Schema({"id": ms.UInt64(), "bv": ms.BinaryVector(DIM)}))
        for p in parts:
            t.insert({"id": ids[p], "bv": packed[p]})
        if kind is not None:
            t.add_vector_index("i", "bv", type=kind)
            assert t.wait_index_built()
        out.append((db, t))
    return out, q


@pytest.mark.parametrize("kind", ["BinaryFLAT", "BinaryMSTG"])
@pytest.mark.parametrize("metric", ["Hamming", "Jaccard"])
def test_jax_index_carried_across_matches(kind, metric):
    (jdb_jt, tdb_tt), q = _binary_tables(kind, metric)
    (jdb, jt), (tdb, tt) = jdb_jt, tdb_tt
    assert tt.index_status("i") == {0: IndexStatus.LOADED, 1: IndexStatus.SMALL_PART}
    jidx = jt.loaded_index(0, "bv", JMetric(metric))
    loaded = tt.load_index("i", 0, jidx.state_dict())
    if kind == "BinaryMSTG":
        assert loaded.n_overflow == jidx.n_overflow and loaded.bucket_cap == jidx.bucket_cap
        direct = binary_from_state_dict(jidx.state_dict(), "cpu")
        assert direct.n_clusters == jidx.n_clusters
    for params in ({}, {"nprobe": 3}) if kind == "BinaryMSTG" else ({},):
        for flt in (None, lambda ms: ms.F("id") >= 200):
            jkw = {"filter": flt(jms)} if flt else {}
            tkw = {"filter": flt(tms)} if flt else {}
            jres = jt.search("bv", q, k=K + 1, params=params or None, **jkw)
            tres = tt.search("bv", q, k=K + 1, params=params or None, **tkw)
            assert _topk_same(tres.scores, tres.rows + 10**6 * tres.segments,
                              jres.scores, jres.rows + 10**6 * jres.segments) >= 3
            np.testing.assert_array_equal(tres.distances[:, :K], jres.distances[:, :K])
    jdb.close()
    tdb.close()


@pytest.mark.parametrize("built_by", ["port", "jax"])
def test_bucket_popcnt_counts_the_bucket_bits(built_by):
    """`bucket_popcnt` is each slot's bit count (a numpy popcount of
    `bucket_data`), for the port's own build and for a JAX index carried
    across (derived from its arrays; not part of the state)."""
    (jpair, tpair), _ = _binary_tables("BinaryMSTG", "Jaccard")
    (jdb, jt), (tdb, tt) = jpair, tpair
    if built_by == "port":
        idx = tt.loaded_index(0, "bv", Metric.JACCARD)
    else:
        idx = binary_from_state_dict(jt.loaded_index(0, "bv", JMetric.JACCARD).state_dict(), "cpu")
    assert "bucket_popcnt" not in idx.state_dict()["arrays"]
    data = idx.bucket_data.numpy()
    assert idx.bucket_popcnt.dtype == torch.int32 and idx.bucket_popcnt.shape == data.shape[:2]
    np.testing.assert_array_equal(idx.bucket_popcnt.numpy(), np.unpackbits(data, axis=-1).sum(-1))
    assert (idx.bucket_popcnt.numpy()[idx.bucket_rows.numpy() < 0] == 0).all()
    jdb.close()
    tdb.close()


@pytest.mark.parametrize("metric", ["Hamming", "Jaccard"])
def test_port_built_binary_mstg_finds_the_exact_neighbours(metric):
    """The port's own BinaryMSTG build (k-means over the unpacked bits)
    reaches the exact scan's top-k scores on clustered rows when every
    cluster is probed, and most of them at the default nprobe."""
    (jpair, tpair), q = _binary_tables("BinaryMSTG", metric, min_rows_jax=10**6)
    (jdb, jt), (tdb, tt) = jpair, tpair
    idx = tt.loaded_index(0, "bv", Metric(metric))
    assert idx.n_clusters == max(4, default_ncentroids(N1) // 4) and idx.bucket_data.dtype == torch.uint8
    assert (idx.bucket_rows >= 0).sum() + idx.n_overflow == N1
    exact = jt.search("bv", q, k=K)  # JAX: no index built, the exact scan
    full = tt.search("bv", q, k=K, params={"nprobe": idx.n_clusters})
    np.testing.assert_array_equal(full.scores, exact.scores)
    default = tt.search("bv", q, k=K)
    assert (default.scores >= exact.scores[:, -1:]).mean() > 0.8
    jdb.close()
    tdb.close()


@pytest.mark.parametrize("name,tm,jm", METRICS)
def test_jax_binary_segment_carried_across_matches(name, tm, jm):
    """A JAX segment's binary payload through `segment_from_arrays` holds
    the bytes the port's own ingest stores (no row popcounts) and scores
    as JAX's segment does, deletes included."""
    (jpair, tpair), q = _binary_tables(None, "Hamming")
    (jdb, jt), (tdb, tt) = jpair, tpair
    jseg, own = jt.live_segments()[0], tt.live_segments()[0]
    jseg.delete_rows(np.arange(0, N1, 5))
    jp = jseg.vector("bv")
    seg = segment_from_arrays(
        0, own.schema, n_rows=jseg.n_rows, capacity=jseg.capacity,
        vectors={"bv": {"data": np.asarray(jp.data), "popcnt": np.asarray(jp.popcnt)}},
        scalars={"id": jseg.scalar("id")}, device="cpu", deleted=jseg.deleted_host(),
    )
    p = seg.vector("bv")
    np.testing.assert_array_equal(p.data.numpy(), own.vector("bv").data.numpy())
    assert p.nbytes == p.data.numel() and p.aux_for(tm) is None
    alive = ~jseg.deleted_host()
    jv, ji = jbin.binary_scan_topk(jnp.asarray(q), jp.data, k=K + 1, metric=jm,
                                   n_valid=jseg.n_rows, mask=jnp.asarray(alive))
    tv, ti = tbin.binary_scan_topk(torch.from_numpy(q), p.data, k=K + 1, metric=tm,
                                   n_valid=seg.n_rows, mask=seg.alive_mask_device())
    assert _topk_same(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)) >= 3
    assert alive[ti.numpy()].all()
    with pytest.raises(tms.SchemaError):
        segment_from_arrays(0, own.schema, n_rows=jseg.n_rows, capacity=jseg.capacity,
                            vectors={"bv": {"data": np.asarray(jp.data)[:, :-1]}},
                            scalars={"id": jseg.scalar("id")}, device="cpu")
    jdb.close()
    tdb.close()


def test_binary_table_search_filter_and_deletes_match_jax():
    (jpair, tpair), q = _binary_tables(None, "Hamming")
    (jdb, jt), (tdb, tt) = jpair, tpair
    gone = list(range(0, N1 + N2, 7))
    assert jt.delete(jms.F("id").isin(gone)) == tt.delete(tms.F("id").isin(gone)) == len(gone)
    bool_q = np.unpackbits(q, axis=1).astype(bool)  # bool input packs like the JAX package
    for metric in ("Hamming", "Jaccard"):
        for flt in (None, lambda ms: ms.F("id") >= 2_000):
            jkw = {"filter": flt(jms)} if flt else {}
            tkw = {"filter": flt(tms)} if flt else {}
            jres = jt.search("bv", q, k=K + 1, metric=metric, **jkw)
            tres = tt.search("bv", bool_q, k=K + 1, metric=metric, **tkw)
            _topk_same(tres.scores, tres.rows + 10**6 * tres.segments,
                       jres.scores, jres.rows + 10**6 * jres.segments)
            ids = tt.gather(tres, ["id"])["id"][tres.valid]
            assert not set(ids.tolist()) & set(gone)
            if flt is not None:
                assert (ids >= 2_000).all()
    assert tt.index_metric_for("bv") == Metric.HAMMING
    with pytest.raises(tms.QueryShapeError):
        tt.search("bv", np.zeros((2, 5), np.uint8), k=3)
    jdb.close()
    tdb.close()
