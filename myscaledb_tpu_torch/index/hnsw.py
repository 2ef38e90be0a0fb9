"""HNSW-family graph indexes: HNSWFLAT, HNSWSQ and HNSWPQ.

Counterpart of myscaledb_tpu/index/hnsw.py. The graph is built in
batches, not by sequential insertion, with the same contract as hnswlib
(params m / ef_c, search param ef_s). The payload the final re-score reads
is the raw rows (HNSWFLAT), SQ8 codes (HNSWSQ) or PQ codes (HNSWPQ,
ops/quantize.py); routing always uses the SQ8 traversal shadow.

  BUILD:
    1. candidate generation: a throwaway IVF index over the segment
       (index/ivf.py); all 512 rows of a window share one candidate pool,
       the windows of the clusters nearest the window's rows;
    2. diversity pruning: keep candidate c unless an already kept p has
       alpha·d(p,c) <= d(u,c) (`_prune_chunk`, many windows per call);
    3. reverse edges fill the free slots (host, one linear sweep);
    4. entry points: the IVF cluster heads, plus one entry per component
       the entries cannot reach (`_repair_entries`);
    5. an SQ8 traversal shadow of the (PCA-projected when wide) rows, and
       the node-block layout `nbdata` u8[N, m, Dt]: node i's neighbours'
       codes, contiguous, when it fits NODE_BLOCK_CAP_BYTES.

  SEARCH (batched beam, `search_t`): a fixed number of frontier
    iterations; each expands the best BEAM unexpanded candidates of every
    query, scores their neighbours in traversal space (the gathermv
    kernel over `nbdata`, ops/gathermv.py), and merges the new
    candidates into the ef-wide frontier and a wider result pool. The
    pool is then re-scored exactly against the payload. The pre-filter
    mask applies to the result pool, not to routing.

The JAX package's `lax.scan`/`fori_loop`s are Python loops here; every
gather that relied on JAX's index clamping clamps explicitly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ..errors import IndexParameterError
from ..metrics import Metric
from ..ops import gathermv, quantize
from ..ops.distance import base_aux
from ..ops.stream import HostRep
from ..ops.topk import NEG_INF, dedup_rows
from .base import IndexKind, ParamsKey, VectorIndex, check_cancel
from .ivf import WINDOW, IVFIndex, _scan_rep, default_ncentroids, windows_for_probes
from .registry import register

DEFAULT_M = 32
DEFAULT_EF_C = 100
DEFAULT_EF_S = 64
BEAM = 8  # nodes expanded per iteration per query
# search_t's per-row state: seen in an earlier iteration, or not yet
KNOWN, UNSEEN = 0, 255
# Iteration budget: iters = max(ITER_MIN, ceil(ITER_FACTOR * ef / BEAM)).
ITER_FACTOR = 1.5
ITER_MIN = 4
# Cost-model constants of prefer_exact_scan: scan time = SCAN_FIXED_S +
# bytes / SCAN_BYTES_PER_S, graph time = iters x (ITER_FIXED_S + nq x
# ITER_PER_QUERY_S). Medians of 5 runs of `chip_smoke.py` phase 7 on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, over the 100,000 x 960
# Cosine table: the graph search at ef_s 100 in batches of 256 and 32 in
# turns, whose device-time slope gives the per-query term and whose
# batch-32 host time per iteration the fixed term; the exact scan's
# device rate and the host time it leaves uncovered. Both searches are
# host-bound there, so the fixed terms follow the host's speed (phase 7
# prints their spread).
SCAN_BYTES_PER_S = 3.53907e11
SCAN_FIXED_S = 2.51254e-3
ITER_FIXED_S = 1.73306e-3
ITER_PER_QUERY_S = 4.17335e-7
# Final-cut exact re-score: bound on the decoded-f32 gather transient
# [Q, chunk, D]; wide rerank pools re-score in chunks under this cap.
RESCORE_TRANSIENT_CAP = 256 * 1024 * 1024
PRUNE_ALPHA = 1.2
# Traversal projection width: rows wider than this are PCA-projected for
# all routing work when full-width node blocks would not fit the cap.
TRAVERSE_DIM = 256
# Node-block neighbour payload: n_rows * m * Dt bytes of device memory;
# left out above this cap (the traversal then gathers rows). Kept at the
# JAX package's value, so both packages build the same layout.
NODE_BLOCK_CAP_BYTES = 4 << 30
# Bound on the [rows, ck, D] f32 candidate block one `_prune_chunk` call
# takes: windows are pruned in groups that fit it.
PRUNE_TRANSIENT_CAP = 1 << 30


def n_iterations(ef: int) -> int:
    """Frontier iterations of a search at width ef."""
    return max(ITER_MIN, int(math.ceil(ITER_FACTOR * ef / BEAM)))


def scan_beats_graph(nq: int, ef: int, scan_bytes: int) -> bool:
    """The routing cost model, callable without an index instance."""
    trav_s = n_iterations(ef) * (ITER_FIXED_S + nq * ITER_PER_QUERY_S)
    return SCAN_FIXED_S + scan_bytes / SCAN_BYTES_PER_S < trav_s


def default_ef_search(params) -> int:
    """ef_default as the build derives it (for descriptor-only cost
    modeling: EXPLAIN of an index that is built but not loaded)."""
    ef_c = int((params or {}).get("ef_c", DEFAULT_EF_C))
    return max(DEFAULT_EF_S, ef_c // 2)


def _prune_chunk(
    node_vecs: torch.Tensor,  # f32[B, D]
    cand_vecs: torch.Tensor,  # f32[B, Ck, D]
    cand_rows: torch.Tensor,  # int[B, Ck] (-1 invalid), sorted by distance
    m: int,
    alpha: float,
) -> torch.Tensor:
    """Robust prune for a chunk of nodes -> int64[B, m] neighbour rows."""
    bsz, ck, _ = cand_vecs.shape
    ip = torch.bmm(cand_vecs, cand_vecs.transpose(1, 2))
    sq = torch.sum(cand_vecs * cand_vecs, dim=2)
    d_cc = sq[:, :, None] + sq[:, None, :] - 2.0 * ip  # [B, Ck, Ck]
    d_uc = (
        torch.sum(node_vecs * node_vecs, dim=1)[:, None]
        + sq
        - 2.0 * torch.bmm(cand_vecs, node_vecs[:, :, None])[:, :, 0]
    )  # [B, Ck]
    valid = cand_rows >= 0
    kept = torch.zeros((bsz, ck), dtype=torch.bool, device=cand_vecs.device)
    count = torch.zeros((bsz,), dtype=torch.int32, device=cand_vecs.device)
    for j in range(ck):
        # prune j if some kept i has alpha*d(i,j) <= d(u,j)
        blocked = torch.any(kept & (alpha * d_cc[:, :, j] <= d_uc[:, j, None]), dim=1)
        take = valid[:, j] & ~blocked & (count < m)
        kept[:, j] = take
        count += take.to(torch.int32)
    # compact kept candidates to the front, pad with -1
    order = torch.argsort((~kept).to(torch.int8), dim=1, stable=True)
    rows = torch.where(kept, cand_rows.to(torch.int64), torch.full_like(cand_rows, -1, dtype=torch.int64))
    return torch.gather(rows, 1, order)[:, :m]


def _window_candidates(ivf, wi: int, *, ck: int, nprobe: int, w_budget: int, l2: bool):
    """Candidate pool of window `wi`: (rows' vectors f32[WIN, D], row ids
    int64[WIN], candidate vectors f32[WIN, ck, D], candidate rows
    int64[WIN, ck], nearest first). All rows of the window share one pool:
    the windows of the nprobe clusters with the best row-centroid affinity
    within the window."""
    nw = ivf.n_windows
    pdw = ivf.perm_data.reshape(nw, WINDOW, -1)
    prw = ivf.perm_rows.reshape(nw, WINDOW).to(torch.int64)
    paw = ivf.perm_aux.reshape(nw, WINDOW)
    sizes = ivf.cluster_start[1:] - ivf.cluster_start[:-1]
    q = pdw[wi].to(torch.float32)  # [WIN, D]
    qrows = prw[wi]
    qvalid = qrows >= 0
    cs = q @ ivf.centroids.T
    if l2:
        cs = 2.0 * cs - ivf.csq[None, :]
    cs = cs.masked_fill(~(sizes > 0)[None, :], NEG_INF)
    cs = cs.masked_fill(~qvalid[:, None], NEG_INF)
    cbest = torch.amax(cs, dim=0, keepdim=True)  # [1, C]
    probe = torch.topk(cbest, nprobe, dim=1).indices  # [1, P]
    widx, valid_w = windows_for_probes(ivf.cluster_start, probe, nw, w_budget)
    widx, valid_w = widx[0], valid_w[0]  # [W]
    xb = pdw[widx].to(torch.float32).reshape(-1, q.shape[1])  # [P, D]
    prows = torch.where(valid_w[:, None], prw[widx], torch.full_like(prw[widx], -1)).reshape(-1)
    scores = q @ xb.T  # [WIN, P]
    if l2:
        scores = 2.0 * scores - paw[widx].reshape(-1)[None, :]
    bad = (prows < 0)[None, :] | (prows[None, :] == qrows[:, None])
    scores = scores.masked_fill(bad, NEG_INF)
    cv, pos = torch.topk(scores, ck, dim=1)  # [WIN, ck]
    crow = torch.where(torch.isfinite(cv), prows[pos], torch.full_like(pos, -1))
    cvecs = xb[pos].masked_fill((crow < 0)[..., None], 0.0)  # [WIN, ck, D]
    return q, qrows, cvecs, crow


def _graph_chunk(ivf, neighbors, windows, *, ck, m, alpha, nprobe, l2):
    """Candidate generation for each window of `windows`, then ONE robust
    prune over all their rows, scattered into `neighbors` (int32[n+1, m];
    the last row is a write sink for padding)."""
    n_sent = neighbors.shape[0] - 1
    w_budget = int(min(ivf.n_windows + nprobe, nprobe * ivf.wpp + 4))
    parts = [
        _window_candidates(ivf, wi, ck=ck, nprobe=nprobe, w_budget=w_budget, l2=l2)
        for wi in windows
    ]
    q = torch.cat([p[0] for p in parts])
    qrows = torch.cat([p[1] for p in parts])
    cvecs = torch.cat([p[2] for p in parts])
    crow = torch.cat([p[3] for p in parts])
    del parts
    nb = _prune_chunk(q, cvecs, crow, m, alpha)
    tgt = torch.where(qrows >= 0, qrows, torch.full_like(qrows, n_sent))
    neighbors[tgt] = nb.to(torch.int32)


def _reach_closure(neighbors: np.ndarray, seed: np.ndarray, reach: np.ndarray) -> None:
    """Mark (in place) every node forward-reachable from `seed`."""
    frontier = seed[seed >= 0]
    frontier = frontier[~reach[frontier]]
    reach[frontier] = True
    while len(frontier):
        nxt = neighbors[frontier].reshape(-1)
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt)
        nxt = nxt[~reach[nxt]]
        reach[nxt] = True
        frontier = nxt


def _repair_entries(
    neighbors: np.ndarray, entry_rows: np.ndarray, n_rows: int,
    cancel_cb=None, cap: int = 65536,
) -> np.ndarray:
    """Connectivity repair: extra entry rows so every node is reachable.
    Near-neighbour candidate generation cannot guarantee the global
    connectivity hnswlib gets from sequential insertion: a component of
    well-separated clusters whose k-means cell has no head of its own
    would be invisible to the beam search at any ef. Host BFS over the
    forward edges; every still-unreachable component contributes its
    first node as an extra entry."""
    reach = np.zeros(n_rows, bool)
    _reach_closure(neighbors, np.asarray(entry_rows), reach)
    extra: list = []
    while not reach.all() and len(extra) < cap:
        if len(extra) % 256 == 0:
            check_cancel(cancel_cb)
        u = int(np.argmin(reach))  # first unreachable node
        extra.append(u)
        _reach_closure(neighbors, np.asarray([u]), reach)
    return np.asarray(extra, np.int64)


def _graph_candidates(
    ivf, n_rows: int, ck: int, m: int, alpha: float, cancel_cb=None
) -> torch.Tensor:
    """Pruned forward neighbour lists int32[n_rows, m] for every row, via
    cluster-blocked candidate generation over the throwaway IVF. Windows
    are pruned in groups whose candidate block fits PRUNE_TRANSIENT_CAP,
    so the ck-step selection loop runs once per group."""
    # probe budget scales with clusters-per-window: every row's own
    # cluster (plus a margin of neighbours) must fit in the probe list
    avg_sz = max(1.0, n_rows / max(ivf.n_clusters, 1))
    nprobe = int(min(ivf.n_clusters, max(12, int(math.ceil(WINDOW / avg_sz)) + 8)))
    nw = ivf.n_windows
    d = ivf.perm_data.shape[1]
    group = max(1, PRUNE_TRANSIENT_CAP // (WINDOW * ck * d * 4))
    neighbors = torch.full((n_rows + 1, m), -1, dtype=torch.int32, device=ivf.perm_data.device)
    for w0 in range(0, nw, group):
        check_cancel(cancel_cb)
        _graph_chunk(
            ivf, neighbors, range(w0, min(w0 + group, nw)), ck=ck, m=m, alpha=alpha,
            nprobe=nprobe, l2=ivf.metric in (Metric.L2, Metric.COSINE),
        )
    return neighbors[:n_rows]


def _clamped(rows: torch.Tensor) -> torch.Tensor:
    """Row ids as gather indices: -1 padding clamped to row 0 (the JAX
    package's takes clamp; its results are masked afterwards)."""
    return torch.clamp(rows, min=0).to(torch.int64)


class _HNSWBase(VectorIndex):
    _array_fields = (
        "data",  # payload for scoring: raw (storage dtype) or codes
        "aux",  # f32[N'] |x|^2 (L2) or 1/|x| (raw Cosine)
        "codec_a",
        "codec_b",
        "neighbors",  # int32[N, m]
        "centroids",  # f32[C, Dt] entry routing (traversal space)
        "csq",
        "entry_rows",  # int32[C]
        "tdata",  # u8[N, Dt] SQ8 traversal codes
        "ta",  # sq8 lo[Dt]
        "tb",  # sq8 scale[Dt]
        "taux",  # f32[N] |decode(tdata)|^2 (L2 and Cosine)
        "tproj",  # f32[D', Dt] PCA projection (None = identity)
        "nbdata",  # u8[N, m, Dt] node i's neighbour codes, contiguous
        "nbaux",  # f32[N, m] neighbour |x|^2 (L2 and Cosine)
    )
    _optional_fields = ("tdata", "ta", "tb", "taux", "tproj", "nbdata", "nbaux")
    _static_fields = ("metric", "dim", "n_rows", "m", "ef_default", "codec")
    codec = "raw"

    def __init__(self, **kw):
        for f in self._array_fields + self._static_fields:
            setattr(self, f, kw.pop(f, None) if f in self._optional_fields else kw.pop(f))
        if kw:
            raise TypeError(f"unexpected fields: {sorted(kw)}")

    @classmethod
    def estimate_build_bytes(cls, payload, n_rows: int, params=None) -> int:
        """The build's device footprint: the f32 scan representation, ~2
        payload-sized transients, the SQ8 shadow and the node blocks. The
        projection condition mirrors `_build_common` exactly. A graph build
        is device-resident even over a host-tier payload: the whole f32
        representation comes to the device, beside a bf16 IVF payload and
        the bf16 scoring copy."""
        dpad = payload.data.shape[1]
        m = int((params or {}).get("m", DEFAULT_M))
        projected = dpad > TRAVERSE_DIM and n_rows * m * dpad > NODE_BLOCK_CAP_BYTES
        dt_w = TRAVERSE_DIM if projected else dpad
        nb = n_rows * m * dt_w
        blocks = nb if nb <= NODE_BLOCK_CAP_BYTES and gathermv.supports(dt_w) else 0
        if getattr(payload, "is_host", False):
            return 4 * n_rows * dpad + (2 + 2) * n_rows * dpad + n_rows * dt_w + blocks
        return 4 * n_rows * dpad + 2 * int(payload.nbytes) + n_rows * dt_w + blocks

    # ------------------------------------------------------------- build
    @classmethod
    def _build_common(
        cls, payload, n_rows, *, metric, dim, params, settings, codec, cancel_cb=None,
    ) -> "_HNSWBase":
        if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            raise IndexParameterError(f"HNSW does not support metric {metric}")
        if codec not in ("raw", "sq8", "pq"):
            raise IndexParameterError(f"unknown HNSW codec {codec!r}")
        params = dict(params or {})
        m = int(params.get("m", DEFAULT_M))
        ef_c = int(params.get("ef_c", DEFAULT_EF_C))
        dpad = payload.data.shape[1]
        host_pl = getattr(payload, "is_host", False)
        if host_pl:
            # graph builds are device-resident: the f32 representation of
            # a host-tier payload comes to the device whole
            inv = payload.invnorm if metric == Metric.COSINE else None
            rep = HostRep(payload.data, n_rows, inv).to_device(payload.device)
        else:
            rep = _scan_rep(payload, n_rows, metric)  # f32[n, dpad]
        dev = rep.device

        # 0) traversal projection: uncentered PCA to TRAVERSE_DIM, only when
        # full-width node blocks would not fit the cap
        tproj = None
        rep_t = rep
        if dpad > TRAVERSE_DIM and n_rows * m * dpad > NODE_BLOCK_CAP_BYTES:
            sample = rep[: min(n_rows, 131072)]
            cov = (sample.T @ sample).cpu().numpy()
            check_cancel(cancel_cb)
            _, v = np.linalg.eigh(cov.astype(np.float64))
            tproj = torch.from_numpy(
                np.ascontiguousarray(v[:, ::-1][:, :TRAVERSE_DIM]).astype(np.float32)
            ).to(dev)
            rep_t = rep @ tproj

        # 1) candidate generation via a throwaway IVF over the traversal
        # representation (normalized rows for Cosine)
        from ..storage.segment import VectorPayload

        ivf_payload = VectorPayload(
            data=rep_t.to(torch.bfloat16),
            sqnorm=torch.sum(rep_t * rep_t, dim=1),
            invnorm=torch.ones((n_rows,), dtype=torch.float32, device=dev),
        )
        ivf = IVFIndex._build_common(
            ivf_payload,
            n_rows,
            metric=Metric.L2 if metric != Metric.IP else Metric.IP,
            dim=int(rep_t.shape[1]),
            params={"ncentroids": default_ncentroids(n_rows)},
            settings=settings,
            codec="raw",
            cancel_cb=cancel_cb,
        )
        # 2) cluster-blocked candidate generation + robust prune, on device
        ck = min(2 * m + 1, n_rows)
        neighbors = _graph_candidates(ivf, n_rows, ck, m, PRUNE_ALPHA, cancel_cb).cpu().numpy()
        check_cancel(cancel_cb)

        # 3) reverse edges into free slots (vectorized host pass): sort all
        # (v, u) reverse edges by target, then scatter each target's first
        # free_v of them into its free slots
        src = np.repeat(np.arange(n_rows, dtype=np.int32), m)
        dst = neighbors.reshape(-1)
        ok = dst >= 0
        src, dst = src[ok], dst[ok]
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        grp_start = np.searchsorted(dst, np.arange(n_rows))
        rank = np.arange(len(dst)) - grp_start[dst]
        deg = (neighbors >= 0).sum(axis=1)
        slot = deg[dst] + rank
        keep = slot < m
        fwd = neighbors[dst[keep]]
        dup = (fwd == src[keep, None]).any(axis=1)
        neighbors[dst[keep][~dup], slot[keep][~dup]] = src[keep][~dup]

        # 4) entry points = IVF cluster heads; 5) connectivity repair
        entry_rows = ivf.cluster_heads().cpu().numpy()
        extra_entries = _repair_entries(neighbors, entry_rows, n_rows, cancel_cb=cancel_cb)
        centroids = ivf.centroids
        csq = ivf.csq
        if len(extra_entries):
            extra_c = rep_t[torch.from_numpy(extra_entries).to(dev)]
            centroids = torch.cat([centroids, extra_c], dim=0)
            csq = torch.cat([csq, torch.sum(extra_c * extra_c, dim=1)])
            entry_rows = np.concatenate([entry_rows, extra_entries.astype(entry_rows.dtype)])

        # traversal shadow: SQ8 codes of the traversal-space rows (every
        # codec routes on the cheapest representation)
        ta, tb = quantize.sq8_train_dev(rep_t)
        tdata = quantize.sq8_encode_dev(rep_t, ta, tb)
        taux = None
        if metric in (Metric.L2, Metric.COSINE):
            # Cosine too: projection breaks unit norms, so traversal uses
            # the L2 form; the exact final re-score restores true cosine
            tdec = quantize.sq8_decode_dev(tdata, ta, tb).to(torch.float32)
            taux = torch.sum(tdec * tdec, dim=1)
            del tdec

        # node-block neighbour payload: contiguous [m, Dt] code blocks, which
        # the gathermv kernel scores (a width it does not take gathers rows)
        nbdata = nbaux = None
        neigh_dev = torch.from_numpy(neighbors).to(dev)
        dt_w = int(tdata.shape[1])
        if n_rows * m * dt_w <= NODE_BLOCK_CAP_BYTES and gathermv.supports(dt_w):
            safe_n = _clamped(neigh_dev)
            nbdata = tdata[safe_n]  # [N, m, Dt]
            if taux is not None:
                nbaux = taux[safe_n]  # [N, m]

        # payload codec for scoring
        codec_a = codec_b = None
        if codec == "raw":
            if host_pl:
                # the stored rows as bf16 on the device (Cosine's `rep` is
                # normalized), with that copy's own |x|^2 or 1/|x|: the f32
                # rows' own (the JAX package keeps them) err ~1e-3 per row
                # beside the bf16 rows, enough to reorder near neighbours
                raw = payload.data[:n_rows].to(dev) if metric == Metric.COSINE else rep
                data = raw.to(torch.bfloat16)
                aux_arr = base_aux(data, metric)
            elif metric == Metric.COSINE:
                # score exactly like the scan: raw payload rows x f32 1/|x|
                data, aux_arr = payload.data, payload.invnorm
            else:
                data = payload.data
                aux_arr = torch.sum(rep * rep, dim=1) if metric == Metric.L2 else None
        elif codec == "sq8":
            codec_a, codec_b = quantize.sq8_train_dev(rep)
            data = quantize.sq8_encode_dev(rep, codec_a, codec_b)
            dec = quantize.sq8_decode_dev(data, codec_a, codec_b).to(torch.float32)
            aux_arr = torch.sum(dec * dec, dim=1)
        else:  # pq: M subspaces (32 unless given) of the unpadded rows
            mm = int(params.get("M", 32))
            if dim % mm:
                raise IndexParameterError(f"dim {dim} not divisible by M={mm}")
            codec_a = quantize.pq_train_dev(rep[:, :dim], mm, bits=int(params.get("bit_size", 8)))
            data = quantize.pq_encode_dev(rep[:, :dim], codec_a)
            aux_arr = quantize.pq_decoded_sqnorms(data, codec_a)

        return cls(
            data=data,
            aux=aux_arr,
            codec_a=codec_a,
            codec_b=codec_b,
            neighbors=neigh_dev,
            centroids=centroids,
            csq=csq,
            entry_rows=torch.from_numpy(entry_rows.astype(np.int32)).to(dev),
            tdata=tdata,
            ta=ta,
            tb=tb,
            taux=taux,
            tproj=tproj,
            nbdata=nbdata,
            nbaux=nbaux,
            metric=metric,
            dim=dim,
            n_rows=n_rows,
            m=m,
            ef_default=default_ef_search(params),
            codec=codec,
        )

    # ------------------------------------------------------------- score
    def _decode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        g = self.data[_clamped(rows)]
        if self.codec == "sq8":
            g = quantize.sq8_decode_dev(g, self.codec_a, self.codec_b)
        elif self.codec == "pq":
            g = quantize.pq_decode_dev(g, self.codec_a)
        return g.to(torch.float32)

    def _score_rows(self, q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Exact scores f32[Q, R] of per-query row sets rows[Q, R] against
        the payload codec: an elementwise f32 multiply-and-sum, so no TF32
        setting can reach it."""
        vecs = self._decode_rows(rows)  # [Q, R, D']
        s = torch.sum(vecs * q[:, None, : vecs.shape[-1]], dim=2)
        del vecs
        if self.metric == Metric.L2:
            s = 2.0 * s - self.aux[_clamped(rows)]
        elif self.metric == Metric.COSINE and self.codec == "raw" and self.aux is not None:
            # raw-payload cosine: aux holds f32 1/|x| (scan-identical scoring)
            s = s * self.aux[_clamped(rows)]
        return s.masked_fill(rows < 0, NEG_INF)

    def _score_traverse(self, qt: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Traversal-space scores f32[Q, R] via the SQ8 shadow (row gather):
        dot(q, c*scale + lo) = dot(bf16(q*scale), c) + dot(q, lo), with the
        u8 codes exact in f32 and f32 accumulation."""
        safe = _clamped(rows)
        g = self.tdata[safe].to(torch.float32)  # [Q, R, Dt]
        qs = (qt * self.tb[None, :]).to(torch.bfloat16).to(torch.float32)
        s = torch.bmm(g, qs[:, :, None])[:, :, 0]
        s = s + (qt @ self.ta)[:, None]
        if self.taux is not None:
            s = 2.0 * s - self.taux[safe]
        return s.masked_fill(rows < 0, NEG_INF)

    def _score_blocks(
        self, qt: torch.Tensor, exp_rows: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frontier expansion via node blocks: score each expanded node's
        contiguous [m, Dt] neighbour-code block in traversal space (the
        gathermv kernel). Returns (scores f32[Q, BEAM*m], neighbour rows
        int64[Q, BEAM*m])."""
        nq, beam = exp_rows.shape
        safe = _clamped(exp_rows)
        nbrs = self.neighbors[safe].to(torch.int64)  # [Q, B, m]
        nbrs = nbrs.masked_fill((exp_rows < 0)[..., None], -1)
        qs = (qt * self.tb[None, :]).contiguous()
        mm = self.nbdata.shape[1]
        s = gathermv.gather_block_scores(qs, safe.to(torch.int32).contiguous(), self.nbdata)
        s = s.reshape(nq, beam, mm) + (qt @ self.ta)[:, None, None]
        if self.nbaux is not None:
            s = 2.0 * s - self.nbaux[safe]
        nbrs = nbrs.reshape(nq, -1)
        return s.reshape(nq, -1).masked_fill(nbrs < 0, NEG_INF), nbrs

    def _project_query(self, q: torch.Tensor) -> torch.Tensor:
        if self.tproj is None:
            return q
        return q[:, : self.tproj.shape[0]] @ self.tproj

    def prefer_exact_scan(self, nq: int, k: int, params, scan_bytes: int) -> bool:
        """Graph-vs-scan cost model (scan_beats_graph); ef as search_t
        derives it."""
        p = dict(params or ())
        ef = max(int(p.get("ef_s", self.ef_default)), k)
        return scan_beats_graph(nq, ef, scan_bytes)

    # ------------------------------------------------------------- search
    def search_t(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        mask: Optional[torch.Tensor] = None,
        params: ParamsKey = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        p = dict(params)
        ef = max(int(p.get("ef_s", self.ef_default)), k)
        iters = n_iterations(ef)
        beam = min(BEAM, ef)
        nq = queries.shape[0]
        dev = queries.device
        q = queries.to(torch.float32)
        if self.metric == Metric.COSINE:
            nrm = torch.linalg.vector_norm(q, dim=1, keepdim=True)
            q = q / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        qt = self._project_query(q)  # traversal space

        if self.tdata is not None:
            score_t = lambda rows: self._score_traverse(qt, rows)  # noqa: E731
        else:  # an index without a shadow routes on exact scores
            score_t = lambda rows: self._score_rows(q, rows)  # noqa: E731

        def res_mask(rows, scores):
            bad = rows < 0
            if mask is not None:
                bad = bad | ~mask[_clamped(rows)]
            return scores.masked_fill(bad, NEG_INF)

        # entry: representatives of the nearest centroids (traversal
        # space); the entry count scales with ef
        n_entry = int(p.get("entries", 0)) or max(BEAM, ef // 2)
        n_entry = min(n_entry, self.centroids.shape[0])
        cdim = self.centroids.shape[1]
        cs = qt[:, :cdim] @ self.centroids.T
        if self.metric in (Metric.L2, Metric.COSINE):
            cs = 2.0 * cs - self.csq[None, :]
        ecl = torch.topk(cs, n_entry, dim=1).indices  # [Q, E]
        erows = self.entry_rows[ecl].to(torch.int64)
        escores = score_t(erows)

        # frontier [Q, ef] of distinct rows, plus a result pool of the best
        # `rp` candidates seen, re-scored exactly at the end. Entries are
        # deduplicated and sorted by score so the cut to ef keeps the
        # nearest; only the survivors are marked known. `seen` u8[Q, N + 1]
        # (the last column a sink for -1) is KNOWN (0) for a row seen in an
        # earlier iteration, UNSEEN (255) for one not seen yet and, within
        # an iteration, the number (1..beam) of the first expanded node
        # whose neighbours hold it: a neighbour enters the pool and the
        # frontier only from that node, so two expanded nodes that share it
        # put it in once (a node's own neighbours are distinct rows: the
        # prune blocks a repeat at distance 0).
        npad = self.neighbors.shape[0]
        escores, erows, _ = dedup_rows(escores, erows, None)
        pos0 = torch.topk(escores, escores.shape[1], dim=1).indices
        escores = torch.gather(escores, 1, pos0)
        erows = torch.gather(erows, 1, pos0)
        tril = torch.tril(torch.ones((beam, beam), dtype=torch.bool, device=dev), -1)
        rp = max(k, int(p.get("rerank", 0)) or 2 * ef)
        pad = ef - n_entry if ef > n_entry else 0
        fv = tnf.pad(escores, (0, pad), value=NEG_INF)[:, :ef]
        fr = tnf.pad(erows, (0, pad), value=-1)[:, :ef]
        fe = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
        seen = torch.full((nq, npad + 1), UNSEEN, dtype=torch.uint8, device=dev)
        seen.scatter_(1, torch.where(fr >= 0, fr, npad), KNOWN)
        wide = max(0, rp - erows.shape[1])
        rv, pos = torch.topk(tnf.pad(res_mask(erows, escores), (0, wide), value=NEG_INF), rp, dim=1)
        rr = torch.gather(tnf.pad(erows, (0, wide), value=-1), 1, pos)
        m = self.neighbors.shape[1]
        node = (torch.arange(beam * m, device=dev) // m + 1).to(torch.uint8).expand(nq, -1)

        for _ in range(iters):
            # expand the best `beam` unexpanded frontier slots
            sel = fv.masked_fill(fe | (fr < 0), NEG_INF)
            bv, bpos = torch.topk(sel, beam, dim=1)
            fe = fe.scatter(1, bpos, True)
            exp_rows = torch.gather(fr, 1, bpos).masked_fill(bv == NEG_INF, -1)
            # intra-beam dedup: later copies of a row in one beam are nulled
            dup = ((exp_rows[:, :, None] == exp_rows[:, None, :]) & tril).any(-1)
            exp_rows = exp_rows.masked_fill(dup, -1)
            if self.nbdata is not None:
                ns, nbrs = self._score_blocks(qt, exp_rows)
            else:
                nbrs = self.neighbors[_clamped(exp_rows)].to(torch.int64)
                nbrs = nbrs.masked_fill((exp_rows < 0)[..., None], -1).reshape(nq, -1)
                ns = score_t(nbrs)
            # kill the neighbours known before this iteration and the
            # copies of a row held by a later expanded node than its first
            col = torch.where(nbrs >= 0, nbrs, npad)
            seen.scatter_reduce_(1, col, node, "amin")
            repeat = torch.gather(seen, 1, col) != node
            ns = ns.masked_fill(repeat, NEG_INF)
            nbrs = nbrs.masked_fill(repeat, -1)
            seen.scatter_(1, col, KNOWN)
            # result pool: top-rp merge of masked scores
            rv, pos2 = torch.topk(torch.cat([rv, res_mask(nbrs, ns)], dim=1), rp, dim=1)
            rr = torch.gather(torch.cat([rr, nbrs], dim=1), 1, pos2)
            # frontier merge: its rows stay distinct
            fv, npos = torch.topk(torch.cat([fv, ns], dim=1), ef, dim=1)
            fr = torch.gather(torch.cat([fr, nbrs], dim=1), 1, npos)
            fe = torch.gather(torch.cat([fe, torch.zeros_like(ns, dtype=torch.bool)], dim=1), 1, npos)

        # final cut: pool ∪ frontier, dedup by row id, exact re-score,
        # chunked so the gathered transient stays under the cap
        pool_r = torch.cat([rr, fr], dim=1)
        pool_v = torch.cat([rv, res_mask(fr, fv)], dim=1)
        _, pr, _ = dedup_rows(pool_v, pool_r, None)
        width = pr.shape[1]
        cap = RESCORE_TRANSIENT_CAP // max(1, nq * self.dim * 4)
        if width <= max(cap, k):
            rv, pos = torch.topk(res_mask(pr, self._score_rows(q, pr)), k, dim=1)
            rr = torch.gather(pr, 1, pos)
        else:
            step = max(k, cap, 128)
            rv = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev)
            rr = torch.full((nq, k), -1, dtype=pr.dtype, device=dev)
            for s in range(0, width, step):
                chunk = pr[:, s : s + step]
                evc = res_mask(chunk, self._score_rows(q, chunk))
                rv, pos = torch.topk(torch.cat([rv, evc], dim=1), k, dim=1)
                rr = torch.gather(torch.cat([rr, chunk], dim=1), 1, pos)
        rr = torch.where(torch.isfinite(rv), rr, torch.full_like(rr, -1))
        return rv, rr.to(torch.int32)

    # -------------------------------------------------------------- misc
    def state_dict(self) -> Dict[str, Any]:
        """numpy arrays + meta, in the JAX package's layout; a bf16 payload
        crosses as its stored bits (uint16)."""
        arrays = {}
        for f in self._array_fields:
            v = getattr(self, f)
            if v is None:
                continue
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                arrays[f] = v.view(torch.int16).numpy().view(np.uint16)
            else:
                arrays[f] = v.numpy()
        return {
            "meta": {
                "kind": self.kind.value,
                "metric": self.metric.value,
                "dim": self.dim,
                "n_rows": self.n_rows,
                "m": self.m,
                "ef_default": self.ef_default,
                "codec": self.codec,
                "storage_dtype": str(self.data.dtype).replace("torch.", ""),
            },
            "arrays": arrays,
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any], *, device) -> "_HNSWBase":
        """The index from `state_dict()`'s layout on `device`. A raw bf16
        payload must arrive as its bits (uint16)."""
        meta, arrays = state["meta"], state["arrays"]
        bf16 = "bfloat16" in meta["storage_dtype"] and meta["codec"] == "raw"
        kw: Dict[str, Any] = {}
        for f in cls._array_fields:
            v = arrays.get(f)
            if v is None:
                kw[f] = None
                continue
            a = np.array(v)
            if f == "data" and bf16:
                if a.dtype.itemsize != 2:
                    raise ValueError(f"a bf16 payload must cross as its 16-bit words, got {a.dtype}")
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            kw[f] = t.to(device)
        kw.update(
            metric=Metric(meta["metric"]),
            dim=int(meta["dim"]),
            n_rows=int(meta["n_rows"]),
            m=int(meta["m"]),
            ef_default=int(meta["ef_default"]),
            codec=meta["codec"],
        )
        return cls(**kw)


@register(IndexKind.HNSWFLAT)
class HNSWFlatIndex(_HNSWBase):
    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None,
              cancel_cb=None):
        return cls._build_common(
            payload, n_rows, metric=metric, dim=dim, params=params,
            settings=settings, codec="raw", cancel_cb=cancel_cb,
        )


@register(IndexKind.HNSWSQ)
class HNSWSQIndex(_HNSWBase):
    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None,
              cancel_cb=None):
        return cls._build_common(
            payload, n_rows, metric=metric, dim=dim, params=params,
            settings=settings, codec="sq8", cancel_cb=cancel_cb,
        )


@register(IndexKind.HNSWPQ)
class HNSWPQIndex(_HNSWBase):
    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None,
              cancel_cb=None):
        return cls._build_common(
            payload, n_rows, metric=metric, dim=dim, params=params,
            settings=settings, codec="pq", cancel_cb=cancel_cb,
        )
