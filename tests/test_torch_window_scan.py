"""The IVF window step (`ops/windowscan.py`) on the CPU.

`window_scan_plain` against the group-loop expression the index ran
before the window step became one call (a gather, `_decode` and `_dot` a
group of windows): bit for bit, for raw bf16 and f32 rows, SQ8 and PQ
codes, every metric, one group and one window a group. The index's scan
stage, now one top-k over the whole budget, against the group-by-group
top-k and merge it replaced: the same ids and scores on inputs without
ties, unfiltered, under a row mask, under a window mask and under a
smaller dynamic nprobe. The kernel itself runs only on a card
(tests/test_torch_kernels.py, marker `cuda`).
"""

import numpy as np
import pytest
import torch

from myscaledb_tpu_torch.index import ivf, registry
from myscaledb_tpu_torch.index.base import IndexKind, params_key
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import distance, quantize, windowscan
from myscaledb_tpu_torch.ops.topk import NEG_INF, dedup_rows
from myscaledb_tpu_torch.search.filters import WindowMask
from myscaledb_tpu_torch.storage.schema import FloatVector, Schema, UInt64
from myscaledb_tpu_torch.storage.segment import Segment

METRICS = [Metric.L2, Metric.IP, Metric.COSINE]
WINDOW = windowscan.WINDOW
OLD_CAP = 512 << 20  # the group cap of the expression below
CODECS = ["bf16", "f32", "sq8", "pq"]


# --------------------------------------------- the expression it replaced
def _old_decode(codec, gathered, lo, scale, books):
    """IVFIndex._decode as it was."""
    if codec == "raw":
        return gathered.to(torch.float32)
    if codec == "sq8":
        return quantize.sq8_decode_dev(gathered, lo, scale).to(torch.float32)
    return quantize.pq_decode_dev(gathered, books).to(torch.float32)


def _old_dot(q, rows_mat):
    """IVFIndex._dot as it was."""
    d = rows_mat.shape[-1]
    return torch.bmm(rows_mat, q[:, :d, None])[:, :, 0]


def _old_groups(q, pdw, paw, widx, metric, decode, cap):
    """The old window step's groups: (slice of the budget, scores) a group."""
    nq, w_budget = widx.shape
    elem = 4 * max(1, pdw.shape[-1])
    cap_windows = max(1, cap // max(1, nq * WINDOW * elem))
    group = max(1, min(w_budget, cap_windows))
    for s in range(0, w_budget, group):
        sl = widx[:, s : s + group]
        xb = decode(pdw[sl]).reshape(nq, sl.shape[1] * WINDOW, -1)
        scores = _old_dot(q, xb)
        if metric == Metric.L2:
            scores = 2.0 * scores - paw[sl].reshape(nq, -1)
        yield s, group, scores


def _old_scan_stage(idx, queries, k, *, mask=None, nprobe, dyn_nprobe=None, cap=OLD_CAP):
    """IVFIndex._scan_stage as it was: a top-k a group of windows, merged
    into the running top-k, then the dedup and the final cut."""
    wmask = None
    if isinstance(mask, WindowMask):
        wmask = mask.build().reshape(idx.n_windows, WINDOW)
        mask = None
    nq = queries.shape[0]
    q = distance.normalize_queries(queries.to(torch.float32), idx.metric)
    cs = q[:, : idx.centroids.shape[1]] @ idx.centroids.T
    if idx.metric in (Metric.L2, Metric.COSINE):
        cs = 2.0 * cs - idx.csq[None, :]
    sizes = idx.cluster_start[1:] - idx.cluster_start[:-1]
    cs = cs.masked_fill(~(sizes > 0)[None, :], NEG_INF)
    probe = torch.topk(cs, nprobe, dim=1).indices
    w_budget = int(min(idx.n_windows + nprobe, nprobe * idx.wpp + 4))
    limit = None if dyn_nprobe is None else min(int(dyn_nprobe), nprobe)
    widx, valid_w = ivf.windows_for_probes(idx.cluster_start, probe, idx.n_windows, w_budget,
                                           limit=limit)
    kk = min(k, idx.n_rows)
    pdw = idx.perm_data.view(idx.n_windows, WINDOW, -1)
    prw = idx.perm_rows.view(idx.n_windows, WINDOW)
    paw = idx.perm_aux.view(idx.n_windows, WINDOW)

    def decode(g):
        return _old_decode(idx.codec, g, idx.codec_a, idx.codec_b, idx.codec_a)

    bv = br = None
    for s, group, scores in _old_groups(q, pdw, paw, widx, idx.metric, decode, cap):
        sl = widx[:, s : s + group]
        live = valid_w[:, s : s + group]
        rows = prw[sl].masked_fill(~live[..., None], -1).reshape(nq, -1)
        valid = rows >= 0
        if wmask is not None:
            valid = valid & wmask[sl].reshape(nq, -1)
        elif mask is not None:
            valid = valid & mask[torch.clamp(rows, min=0).to(torch.int64)]
        scores = scores.masked_fill(~valid, NEG_INF)
        sv, sp = torch.topk(scores, min(kk, scores.shape[1]), dim=1)
        sr = torch.gather(rows, 1, sp)
        if bv is None:
            bv, br = ivf._pad_cols(sv, sr, kk)
        else:
            bv, npos = torch.topk(torch.cat([bv, sv], dim=1), kk, dim=1)
            br = torch.gather(torch.cat([br, sr], dim=1), 1, npos)
    bv, br, _ = dedup_rows(bv, br)
    bv, pos = torch.topk(bv, kk, dim=1)
    br = torch.gather(br, 1, pos)
    br = torch.where(torch.isfinite(bv), br, torch.full_like(br, -1))
    return ivf._pad_cols(bv, br, k)


# ------------------------------------------------------- the plain version
def _operands(codec, metric, nq=6, nw=7, w=5, d=128, seed=0):
    """A payload of `nw` windows whose last one is ragged (its last 100
    rows zero padding, aux inf), its decode constants, queries and
    duplicate-free window budgets laid out as `windows_for_probes` lays
    them out: live slots first in window order, then dead slots (window
    0). The ragged window is live for the first query."""
    g = torch.Generator().manual_seed(seed)
    n = nw * WINDOW
    rep = torch.randn((n, d), generator=g)
    if metric == Metric.COSINE:
        rep = rep / torch.linalg.vector_norm(rep, dim=1, keepdim=True)
    lo = scale = books = None
    if codec in ("bf16", "f32"):
        data = rep.to(torch.bfloat16 if codec == "bf16" else torch.float32)
        dec = data.to(torch.float32)
    elif codec == "sq8":
        lo, scale = quantize.sq8_train_dev(rep)
        data = quantize.sq8_encode_dev(rep, lo, scale)
        dec = quantize.sq8_decode_dev(data, lo, scale).to(torch.float32)
    else:
        m = 16
        books = torch.randn((m, 256, d // m), generator=g)
        data = torch.randint(0, 256, (n, m), generator=g, dtype=torch.int64).to(torch.uint8)
        dec = quantize.pq_decode_dev(data, books).to(torch.float32)
    aux = torch.sum(dec * dec, dim=1)
    data[-100:] = 0
    aux[-100:] = float("inf")
    q = distance.normalize_queries(torch.randn((nq, d), generator=g), metric)
    widx = torch.zeros((nq, w), dtype=torch.int64)
    valid = torch.zeros((nq, w), dtype=torch.bool)
    for i in range(nq):
        n_live = 1 + i % w
        pick = torch.randperm(nw, generator=g)[:n_live]
        if i == 0:
            pick[0] = nw - 1
        widx[i, :n_live] = torch.sort(pick).values
        valid[i, :n_live] = True
    return q, data, aux, widx, valid, lo, scale, books


@pytest.mark.parametrize("one_window_a_group", [False, True], ids=["one_group", "window_groups"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("codec", CODECS)
def test_plain_is_the_old_group_loop_bit_for_bit(monkeypatch, codec, metric, one_window_a_group):
    """Every live slot's scores equal the old expression's bit for bit;
    every dead slot's are -inf (the old path masked those rows to -inf
    after scoring them), and the ragged window's padding reads -inf under
    L2 in both."""
    q, data, aux, widx, valid, lo, scale, books = _operands(codec, metric)
    cap = 1 if one_window_a_group else OLD_CAP
    monkeypatch.setattr(windowscan, "GROUP_TRANSIENT_CAP", cap)
    if codec == "pq":
        got = windowscan.window_scan_plain(q, data, aux, widx, valid, metric=metric,
                                           codebooks=books)
    else:
        got = windowscan.window_scan(q, data, aux, widx, valid, metric=metric, lo=lo,
                                     scale=scale)
    old_codec = {"bf16": "raw", "f32": "raw"}.get(codec, codec)

    def decode(g):
        return _old_decode(old_codec, g, lo, scale, books)

    pdw = data.view(-1, WINDOW, data.shape[1])
    groups = list(_old_groups(q, pdw, aux.view(-1, WINDOW), widx, metric, decode, cap))
    assert len(groups) == (widx.shape[1] if one_window_a_group else 1)
    want = torch.cat([s for _, _, s in groups], dim=1)
    live = valid[:, :, None].expand(-1, -1, WINDOW).reshape(q.shape[0], -1)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got[live].view(torch.int32), want[live].view(torch.int32))
    assert torch.isneginf(got[~live]).all()
    if metric == Metric.L2:
        assert torch.isneginf(got[0, (valid[0].sum() - 1) * WINDOW + WINDOW - 100 :]).all()


# --------------------------------------------------------- the scan stage
N, D, NCENT, NQ, NPROBE = 6_000, 64, 16, 24, 4


def _index(kind, metric):
    """A port index of `kind` over N clustered rows on the CPU, its queries
    (rows plus noise, no ties) and a row mask over the segment's capacity."""
    rng = np.random.default_rng(7)
    centres = 6.0 * rng.standard_normal((40, D)).astype(np.float32)
    vecs = (centres[rng.integers(0, 40, N)] + rng.standard_normal((N, D))).astype(np.float32)
    seg = Segment.from_columns(0, Schema({"id": UInt64(), "vec": FloatVector(D)}),
                               {"id": np.arange(N, dtype=np.uint64), "vec": vecs}, device="cpu")
    p = seg.vector("vec")
    params = {"ncentroids": NCENT, **({"M": 16} if kind == "IVFPQ" else {})}
    idx = registry.implementation(IndexKind(kind)).build(p, N, metric=metric, dim=D,
                                                         params=params)
    q = vecs[rng.choice(N, NQ, replace=False)] + 0.3 * rng.standard_normal((NQ, D))
    q = torch.nn.functional.pad(torch.from_numpy(q.astype(np.float32)), (0, p.data.shape[1] - D))
    mask = torch.from_numpy(np.arange(seg.capacity) % 5 != 2)
    return idx, q, mask


@pytest.fixture(scope="module")
def indexes():
    built = {}

    def get(kind, metric):
        if (kind, metric) not in built:
            built[(kind, metric)] = _index(kind, metric)
        return built[(kind, metric)]

    return get


SCAN_CASES = [("IVFFLAT", m) for m in METRICS] + [
    ("IVFSQ", Metric.L2), ("IVFSQ", Metric.IP), ("IVFPQ", Metric.L2), ("MSTG", Metric.COSINE)]


@pytest.mark.parametrize("masking", ["none", "rows", "windows", "dyn_nprobe"])
@pytest.mark.parametrize("kind,metric", SCAN_CASES, ids=[f"{k}-{m.value}" for k, m in SCAN_CASES])
def test_scan_stage_equals_the_group_merge(indexes, kind, metric, masking):
    """One top-k over the whole budget gives the ids and scores the
    group-by-group merge gave, with the budget in one group (as at the
    SIFT cell's shape) and one window a group (as at 768-d)."""
    idx, q, mask = indexes(kind, metric)
    k = 3 * 10 if idx.two_stage else 10  # a first pass hands on k * rerank_multiple
    kw, old_kw = {}, {}
    if masking == "rows":
        kw["mask"] = old_kw["mask"] = mask
    elif masking == "windows":
        bitmap = mask[torch.clamp(idx.perm_rows, min=0).to(torch.int64)]
        n_prime = int(idx.perm_rows.shape[0])
        wm = WindowMask(("prebuilt", n_prime, n_prime, False, None), [bitmap], q.device)
        kw["mask"] = old_kw["mask"] = wm
    elif masking == "dyn_nprobe":
        kw["dyn_nprobe"] = old_kw["dyn_nprobe"] = 2
    v, r = idx._scan_stage(q, k, params=params_key({"nprobe": NPROBE}), **kw)
    for cap in (OLD_CAP, 1):
        ov, orow = _old_scan_stage(idx, q, k, nprobe=NPROBE, cap=cap, **old_kw)
        assert torch.equal(r, orow)
        assert torch.equal(v, ov)
    assert (r >= 0).all()
    if masking == "rows":
        assert mask[r.to(torch.int64)].all()
