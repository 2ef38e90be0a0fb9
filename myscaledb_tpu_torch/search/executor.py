"""Vector search execution: per-segment search + global top-k merge.

Counterpart of myscaledb_tpu/search/executor.py. The re-expression of the
reference's search-manager stack:

  MergeTreeVSManager::vectorScan            -> per-segment search_t
  performPrefilter + DenseBitmap            -> filters.Expr -> device mask
  getTotalTopSearchResultImpl (k-way heap)  -> on-device merge across segments
  two-stage search (first_stage_only +      -> _two_stage_run: a global
    computeTopDistanceSubset)                  candidate cut, exact re-rank
  mergeResult (score join by label)         -> SearchResult / Table.gather
  disk-mode parts (Search::DiskIOManager)   -> host-tier segments: a streamed
                                               exact scan (stream_scan_topk)

As in the JAX package, the WHOLE query -- the cast and pad of the
queries, every segment's index search or scan and the global merge -- is
one program (`_fused_multi_search`): on a CUDA device one captured graph,
replayed from search/program.py's cache per (k, params bucket, padded
batch, the masks' kinds, the searchers and their tensors, the table's
segment-set version). Outside it stay the query upload (through a pinned
staging buffer), one copy per mask and one copy of the packed outputs.
Results are lazy: that copy stays on the device until the caller reads
it. The two-stage path (first passes, a global cut, the exact re-rank)
and host-tier scans stay eager, as in the JAX package; their plain
segments call `VectorIndex.search`, a program of its own.

Labels stay segment-local; a global hit is (segment_id, row_id, score).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ..config import Settings
from ..errors import QueryShapeError
from ..index.base import VectorIndex, params_key, split_dyn_nprobe
from ..index.binary import BinaryFlatIndex
from ..index.flat import FlatIndex
from ..metrics import Metric, score_to_distance
from ..ops.topk import NEG_INF, topk_stable
from ..service.event_log import GLOBAL_COUNTERS
from ..service.tracing import span
from ..storage.schema import BinaryVector
from .filters import DeviceMask, Expr, Lambda, WindowMask, as_mask_array
from .program import Program, label_of, mask_argument, mask_spec, materialize_mask, signature


class SearchResult:
    """Global top-k for a batch of queries. Device-lazy: the (scores,
    segment tag, row) tensors stay on the device until first host access.
    `device` is that tuple, or one int32[3, Q, k] tensor (`pack_result`):
    the scores' bits, the tags and the rows, read back in one copy."""

    def __init__(
        self,
        metric: Metric,
        *,
        device=None,
        seg_ids: Optional[np.ndarray] = None,
        host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
        nq: int,
        k: int,
        query_sqnorm: Optional[np.ndarray] = None,
    ):
        self.metric = metric
        self._packed = device if isinstance(device, torch.Tensor) else None
        if self._packed is not None:
            device = (self._packed[0].view(torch.float32), self._packed[1], self._packed[2])
        self._device = device
        self._seg_ids = seg_ids
        self._host = host
        self.nq = nq
        self.k = k
        self.query_sqnorm = query_sqnorm

    @classmethod
    def empty(cls, metric: Metric, nq: int, k: int, query_sqnorm=None):
        return cls(
            metric,
            host=(
                np.full((nq, k), NEG_INF, np.float32),
                np.full((nq, k), -1, np.int64),
                np.full((nq, k), -1, np.int32),
            ),
            nq=nq,
            k=k,
            query_sqnorm=query_sqnorm,
        )

    def _materialize(self):
        if self._host is None:
            with span("result.readback"):
                if self._packed is not None:
                    packed = self._packed.cpu().numpy()[:, : self.nq]
                    vals, tags, rows = packed[0].view(np.float32), packed[1], packed[2]
                else:
                    vals, tags, rows = (t[: self.nq].cpu().numpy() for t in self._device)
                rows = rows.astype(np.int32)
                segs = np.where(tags >= 0, self._seg_ids[np.maximum(tags, 0)], -1)
                self._host = (vals, segs.astype(np.int64), rows)
        return self._host

    @property
    def scores(self) -> np.ndarray:
        return self._materialize()[0]

    @property
    def segments(self) -> np.ndarray:
        return self._materialize()[1]

    @property
    def rows(self) -> np.ndarray:
        return self._materialize()[2]

    @property
    def valid(self) -> np.ndarray:
        return self.rows >= 0

    @property
    def distances(self) -> np.ndarray:
        """User-visible distance column. L2 reports |q-x|^2 (the per-query
        |q|^2 constant dropped inside the kernel is re-applied here)."""
        d = score_to_distance(self.metric, self.scores.astype(np.float64))
        if self.metric == Metric.L2 and self.query_sqnorm is not None:
            d = d + np.asarray(self.query_sqnorm)[:, None]
            d = np.maximum(d, 0.0)
        return np.where(self.valid, d, np.inf).astype(np.float32)


def _merge_tagged_body(vals_t, rows_t, k, *, stable: bool = False):
    """The global tagged top-k merge across per-segment (vals, rows) lists
    (the k-way merge, getTotalTopSearchResultImpl analogue). Returns
    (vals f32[Q,k], tag int32[Q,k] — position in the tuple, rows
    int32[Q,k]). `stable` orders exact ties as `jax.lax.top_k` does
    (`topk_stable`); the vector paths take `torch.topk`."""
    vals = torch.cat(vals_t, dim=-1)
    rows = torch.cat(rows_t, dim=-1)
    tag = torch.cat(
        [torch.full(v.shape, i, dtype=torch.int32, device=v.device) for i, v in enumerate(vals_t)],
        dim=-1,
    )
    kk = min(k, vals.shape[-1])
    if stable:
        mv, pos = topk_stable(vals, kk)
        pos = pos.to(torch.int64)
    else:
        mv, pos = torch.topk(vals, kk, dim=-1)
    mr = torch.gather(rows, -1, pos)
    mt = torch.gather(tag, -1, pos)
    bad = torch.logical_or(~torch.isfinite(mv), mr < 0)
    mt = torch.where(bad, torch.full_like(mt, -1), mt)
    mr = torch.where(bad, torch.full_like(mr, -1), mr)
    if kk < k:
        mv = tnf.pad(mv, (0, k - kk), value=NEG_INF)
        mt = tnf.pad(mt, (0, k - kk), value=-1)
        mr = tnf.pad(mr, (0, k - kk), value=-1)
    return mv, mt, mr


def pack_result(mv: torch.Tensor, mt: torch.Tensor, mr: torch.Tensor) -> torch.Tensor:
    """int32[3, Q, k]: a global top-k's scores (their bits), tags and rows
    in one buffer, copied and read back in one launch each."""
    return torch.stack([mv.contiguous().view(torch.int32), mt.to(torch.int32), mr.to(torch.int32)])


def _fused_multi_search(queries, searchers, masks, k, pkey, nq_pad, dpad, binary,
                        dyn_nprobe=None):
    """One program: the cast + pad of the raw queries, every segment's
    top-k and the global merge (the JAX package's `_fused_multi_search`).

    queries: the raw batch [nq_pad, dim] (f32, or packed u8 bits with dpad
    its byte count), padded here to [nq_pad, dpad]. searchers: an index, or
    an exact scan, per segment; masks: what each one's `search_t` takes
    (None, a bool[capacity] bitmap or a prebuilt WindowMask). dyn_nprobe:
    the actual nprobe (a device scalar) beside the params' pow2 bucket.
    Returns `pack_result` of (vals f32[Q,k], tag int32[Q,k] -- position in
    `searchers`, rows int32[Q,k])."""
    q = queries if binary else queries.to(torch.float32)
    q = tnf.pad(q, (0, dpad - q.shape[1], 0, nq_pad - q.shape[0])).contiguous()
    vs, rs = [], []
    for s, m in zip(searchers, masks):
        kw = {}
        if dyn_nprobe is not None and getattr(s, "supports_dyn_nprobe", False):
            kw["dyn_nprobe"] = dyn_nprobe
        v, r = s.search_t(q, k, mask=_resolve_mask(m), params=pkey, **kw)
        vs.append(v)
        rs.append(r)
    return pack_result(*_merge_tagged_body(tuple(vs), tuple(rs), k))


def merge_tagged_topk(vals_t, rows_t, k):
    """The global tagged merge for host callers (the text path), with
    exact ties ordered as the JAX package's `merge_tagged_topk` orders
    them: lower position in the concatenation first."""
    return _merge_tagged_body(tuple(vals_t), tuple(rows_t), k, stable=True)


def _as_query_batch(query, dim: int):
    """Normalize the query input to a host f32 [Q, dim] batch and its
    per-query |q|^2 (numpy, re-applied to L2 distances on the host)."""
    if isinstance(query, torch.Tensor):
        query = query.detach().cpu().numpy()
    q = np.asarray(query, dtype=np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2 or q.shape[1] != dim:
        raise QueryShapeError(f"query must be [*, {dim}], got {q.shape}")
    qsq = np.einsum("ij,ij->i", q, q)
    return q, q.shape[0], qsq


def _prep_queries(q: np.ndarray, nq_pad: int, dpad: int, device) -> torch.Tensor:
    """The two-stage path's queries: the raw batch uploaded once and
    padded to [nq_pad, dpad] (f32, or packed u8 bits with dpad = the row's
    byte count) on the device, as the JAX package's `_prep_query`."""
    qd = torch.from_numpy(q).to(device)
    return tnf.pad(qd, (0, dpad - q.shape[1], 0, nq_pad - q.shape[0])).contiguous()


def _as_binary_query_batch(query, vtype) -> Tuple[np.ndarray, int]:
    """Binary query: packed uint8 [*, dim/8] or bool [*, dim] -> packed
    host u8 [Q, dim/8]."""
    if isinstance(query, torch.Tensor):
        query = query.detach().cpu().numpy()
    q = np.asarray(query)
    if q.ndim == 1:
        q = q[None, :]
    if q.dtype == np.bool_:
        if q.ndim != 2 or q.shape[1] != vtype.dim:
            raise QueryShapeError(f"binary query must be [*, {vtype.dim}] bits")
        q = np.packbits(q, axis=1)
    else:
        q = q.astype(np.uint8, copy=False)
        if q.ndim != 2 or q.shape[1] != vtype.nbytes:
            raise QueryShapeError(f"binary query must be packed [*, {vtype.nbytes}] uint8")
    return np.ascontiguousarray(q), q.shape[0]


# (segment uid, filter repr, mutation generation) -> device mask. Repeated
# queries with the same host-evaluated predicate skip host evaluation AND
# the mask upload. Bounded; Lambda filters are not cached (their repr
# does not capture the closure).
_MASK_CACHE: dict = {}
_MASK_CACHE_CAP = 256


def segment_mask(segment, filter_expr: Optional[Expr]):
    """Pre-filter bitmap for one segment: WHERE bitmap ∩ alive bitmap,
    extended to capacity (False in padding). None when unconstrained.

    Numeric predicates lower to the device (DeviceMask): the bitmap is
    built on the segment's device from mirrored scalar columns, with no
    host evaluation and no upload. Strings/Lambda evaluate on the host
    (with the repeated-predicate mask cache)."""
    alive = segment.alive_mask_device()
    if filter_expr is None:
        return alive  # may be None
    lowered = filter_expr.lower_t(segment)
    if lowered is not None:
        skel, leaves = lowered
        has_alive = alive is not None
        return DeviceMask(
            ("root", segment.capacity, segment.n_rows, has_alive, skel),
            ([alive] if has_alive else []) + leaves,
            segment.device,
        )
    cacheable = not any(isinstance(e, Lambda) for e in _walk_filter(filter_expr))
    key = None
    if cacheable:
        key = (segment.uid, repr(filter_expr), segment.mutation_generation)
        hit = _MASK_CACHE.get(key)
        if hit is not None:
            return hit
    host = filter_expr.evaluate(segment)  # bool[n_rows]
    full = np.zeros(segment.capacity, dtype=bool)
    full[: segment.n_rows] = host
    dev = torch.from_numpy(full).to(segment.device)
    if alive is not None:
        dev = torch.logical_and(dev, alive)
    if key is not None:
        if len(_MASK_CACHE) >= _MASK_CACHE_CAP:
            _MASK_CACHE.pop(next(iter(_MASK_CACHE)))
        _MASK_CACHE[key] = dev
    return dev


def _walk_filter(expr):
    yield expr
    for attr in ("a", "b"):
        child = getattr(expr, attr, None)
        if child is not None and isinstance(child, Expr):
            yield from _walk_filter(child)


# (segment uid, predicate repr, mutation generation) -> passing-row count.
_SELECTIVITY_CACHE: dict = {}
_SELECTIVITY_CACHE_CAP = 512


def estimate_selectivity(segment, filter_expr: Optional[Expr]) -> Optional[float]:
    """Fraction of the segment's rows passing `filter_expr` (ignoring
    deletes), or None when it cannot be costed cheaply (Lambda closures).
    Cached per (segment, predicate, mutation generation)."""
    if filter_expr is None:
        return 1.0
    if segment.n_rows == 0:
        return 0.0
    if any(isinstance(e, Lambda) for e in _walk_filter(filter_expr)):
        return None
    key = (segment.uid, repr(filter_expr), segment.mutation_generation)
    hit = _SELECTIVITY_CACHE.get(key)
    if hit is None:
        host = filter_expr.evaluate(segment)
        hit = float(np.count_nonzero(host)) / float(segment.n_rows)
        if len(_SELECTIVITY_CACHE) >= _SELECTIVITY_CACHE_CAP:
            _SELECTIVITY_CACHE.pop(next(iter(_SELECTIVITY_CACHE)))
        _SELECTIVITY_CACHE[key] = hit
    return hit


class VectorSearchExecutor:
    """Executes a vector search over a table's segments.

    Index-vs-brute-force policy per segment (bruteForceSearchEnabled,
    MergeTreeVSManager.cpp:1681-1688): a built index for the column is
    used when present, unless an over-selective filter
    (filter_fallback_selectivity) or the cost model
    (cost_based_index_routing) sends the segment to the exact scan;
    otherwise small segments always scan exactly and large ones scan only
    if enable_brute_force_vector_search.
    """

    def __init__(self, table):
        self.table = table

    def run(
        self,
        column: str,
        query,
        k: Optional[int],
        *,
        filter: Optional[Expr] = None,
        params: Optional[Dict[str, Any]] = None,
        metric: Optional[Metric] = None,
        settings: Optional[Settings] = None,
        two_stage: Optional[bool] = None,
    ) -> SearchResult:
        with span("vector_search", table=self.table.name, column=column):
            return self._run_traced(
                column, query, k, filter=filter, params=params, metric=metric,
                settings=settings, two_stage=two_stage,
            )

    def _run_traced(
        self, column, query, k, *, filter, params, metric, settings, two_stage
    ) -> SearchResult:
        t = self.table
        st = settings or t.settings
        vtype = t.schema.require_vector(column)
        k = int(k if k is not None else st.query.default_topk)
        if k <= 0:
            raise QueryShapeError("k must be positive")
        if k > st.query.max_search_result_window:
            raise QueryShapeError(
                f"top-k window {k} exceeds max_search_result_window="
                f"{st.query.max_search_result_window}"
            )
        metric = metric or t.index_metric_for(column)
        is_binary = isinstance(vtype, BinaryVector)
        if is_binary:
            qh, nq = _as_binary_query_batch(query, vtype)
            qsq = None
        else:
            qh, nq, qsq = _as_query_batch(query, vtype.dim)
        GLOBAL_COUNTERS.bump("VectorSearchQueries", nq)

        version = t.segment_version  # read before the segments: see ProgramCache.get
        segments = t.live_segments()
        if not segments:
            return SearchResult.empty(metric, nq, k, qsq)

        nq_pad = max(8, -(-nq // 8) * 8)
        dpad = segments[0].vector(column).data.shape[1]
        pkey = params_key(params)
        use_two_stage = st.query.two_stage_search if two_stage is None else bool(two_stage)
        searchers: List[VectorIndex] = []
        masks: List[Any] = []
        seg_ids: List[int] = []
        first_stage: List[Tuple[int, VectorIndex, Any]] = []
        host_scans: List[Tuple[int, VectorIndex, Any]] = []
        for seg in segments:
            fexpr = filter
            if filter is not None and st.query.optimize_prefilter_in_search:
                fold = filter.const_fold(seg)
                if fold is False:
                    continue  # provably no row passes: skip the segment
                if fold is True:
                    fexpr = None  # provably all pass: alive mask only
            mask = segment_mask(seg, fexpr)
            idx = t.loaded_index(seg.segment_id, column, metric)
            forced_exact = False
            if (
                idx is not None
                and fexpr is not None
                and st.query.filter_fallback_selectivity > 0
            ):
                sel = estimate_selectivity(seg, fexpr)
                if sel is not None and sel < st.query.filter_fallback_selectivity:
                    # over-selective filter: the exact masked scan is both
                    # correct (a graph walk loses recall on sparse masks)
                    # and cheap (few survivors) -- fallbackToFlat
                    idx = None
                    forced_exact = True
                    GLOBAL_COUNTERS.bump("VectorIndexFallbackToFlat")
            if idx is not None and st.query.cost_based_index_routing:
                payload = seg.vector(column)
                # a host-tier payload is never routed to the scan: its
                # cost is the host link's, which the model does not price
                if not payload.is_host and idx.prefer_exact_scan(nq, k, pkey, int(payload.nbytes)):
                    # the exact scan is modeled cheaper than this index's
                    # search for this batch and corpus, and it is exact
                    idx = None
                    forced_exact = True
                    GLOBAL_COUNTERS.bump("VectorIndexCostRouteToScan")
            if idx is not None and isinstance(mask, DeviceMask) and hasattr(idx, "to_window_mask"):
                # IVF-layout indexes test the predicate over their own
                # window-permuted column mirrors (no per-row gather)
                wm = idx.to_window_mask(mask, seg)
                if wm is not None:
                    mask = wm
            if (
                idx is not None
                and (use_two_stage or idx.requires_two_stage())
                and idx.supports_two_stage()
            ):
                first_stage.append((seg.segment_id, idx, mask))
                continue
            if idx is None:
                small = forced_exact or seg.n_rows < st.table.min_rows_to_build_vector_index
                if not small and not st.query.enable_brute_force_vector_search:
                    # the reference SKIPS index-less large parts when brute
                    # force is off (fewer/no rows, not an error)
                    GLOBAL_COUNTERS.bump("VectorSearchSegmentsSkipped")
                    continue
                payload = seg.vector(column)
                if is_binary:
                    idx = BinaryFlatIndex(
                        payload.data, metric=metric, dim=vtype.dim, n_rows=seg.n_rows
                    )
                else:
                    idx = FlatIndex(
                        payload.data,
                        payload.aux_for(metric),
                        metric=metric,
                        dim=vtype.dim,
                        n_rows=seg.n_rows,
                        host=payload.is_host,  # a host-tier payload streams
                        approx=st.query.use_approx_topk,
                        recall_target=st.query.approx_topk_recall_target,
                    )
                GLOBAL_COUNTERS.bump("VectorBruteForceSearches")
            else:
                GLOBAL_COUNTERS.bump("VectorIndexSearches")
            if isinstance(idx, FlatIndex) and idx.host:
                # beyond-HBM tier: the streamed exact scan, eager
                host_scans.append((seg.segment_id, idx, mask))
                continue
            searchers.append(idx)
            masks.append(mask)
            seg_ids.append(seg.segment_id)

        if not searchers and not first_stage and not host_scans:
            # every segment const-folded away or skipped
            return SearchResult.empty(metric, nq, k, qsq)

        dev = segments[0].device
        if first_stage or host_scans:
            return self._two_stage_run(
                first_stage, host_scans, searchers, masks, seg_ids,
                _prep_queries(qh, nq_pad, dpad, dev), nq, qsq, k, metric, st, params,
            )
        # the IVF probe list is sized from nprobe's pow2 bucket, the actual
        # nprobe masks the probes past it (base.split_dyn_nprobe): a device
        # scalar of the program, not a key
        bucketed, dyn_np = split_dyn_nprobe(pkey)
        if not any(getattr(s, "supports_dyn_nprobe", False) for s in searchers):
            dyn_np = None
        mats = [materialize_mask(m) for m in masks]
        specs = tuple(mask_spec(m) for m in mats)
        kinds = [None if sp is None else sp[0] for sp in specs]
        found = tuple(searchers)
        refs: List[torch.Tensor] = []  # filled with the key: the tensors the program reads

        def body(q, mbufs, dyn):
            return _fused_multi_search(
                q, found, [mask_argument(kd, b) for kd, b in zip(kinds, mbufs)], k, bucketed,
                nq_pad, dpad, is_binary, dyn,
            )

        def make():
            return Program(
                body, device=dev, query=((nq_pad,) + tuple(qh.shape[1:]),
                                         torch.from_numpy(qh[:0]).dtype),
                masks=[None if sp is None else (sp[1], sp[2]) for sp in specs],
                dyn=dyn_np is not None, out_shape=(3, nq_pad, k),
                label=label_of(found), refs=refs,
            )

        with span("program.key"):
            key = (
                "fused", k, bucketed, nq_pad, dpad, tuple(qh.shape[1:]), is_binary, specs,
                tuple(signature(s, refs) for s in searchers), dyn_np is not None, version,
            )
            prog = t._programs.get(key, make, version)
        packed = prog.run(qh, [None if m is None else m[1] for m in mats], dyn_np)
        return SearchResult(
            metric,
            device=packed,
            seg_ids=np.asarray(seg_ids, dtype=np.int64),
            nq=nq,
            k=k,
            query_sqnorm=qsq,
        )

    # ------------------------------------------------------------ two-stage
    def _two_stage_run(
        self, first_stage, host_scans, searchers, masks, seg_ids, queries, nq, qsq, k, metric,
        st, params,
    ) -> SearchResult:
        """Two-stage search, eager as in the JAX package: the host-tier
        segments' streamed scans, the first pass of every two-stage index
        (`search_first_stage`, k * two_stage_num_reorder_multiple
        candidates each), one global candidate cut over all of them, the
        exact re-rank of the survivors (`compute_scores_subset`); the other
        segments are searched as usual (`VectorIndex.search`, at the actual
        nprobe: a program each) and merged in."""
        mult = st.query.two_stage_num_reorder_multiple
        per: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
        for seg_id, idx, mask in host_scans:
            v, r = idx.search(queries, k, params=params, mask=mask)
            per.append((seg_id, v, r))
        cand = []
        for seg_id, idx, mask in first_stage:
            ncand = min(max(k * mult, k), idx.n_rows)
            v, r = idx.search_first_stage(queries, ncand, params=params, mask=mask)
            cand.append((seg_id, idx, v, r))
        if cand:
            all_vals = torch.cat([v for _, _, v, _ in cand], dim=-1)
            ncut = min(all_vals.shape[-1], max(k * mult, k))
            cut = torch.topk(all_vals, ncut, dim=-1).values[:, -1:]
        for seg_id, idx, v, r in cand:
            rows_kept = torch.where(v >= cut, r, torch.full_like(r, -1))
            exact = idx.compute_scores_subset(queries, rows_kept)
            v2, p2 = torch.topk(exact, min(k, exact.shape[-1]), dim=-1)
            per.append((seg_id, v2, torch.gather(rows_kept, -1, p2)))
        for idx, mask, sid in zip(searchers, masks, seg_ids):
            v, r = idx.search(queries, k, params=params, mask=mask,
                              programs=self.table._programs)
            per.append((sid, v, r))
        kk = min(k, sum(v.shape[-1] for _, v, _ in per))
        mv, mt, mr = _merge_tagged_body(
            tuple(v for _, v, _ in per), tuple(r for _, _, r in per), kk
        )
        return SearchResult(
            metric,
            device=pack_result(mv, mt, mr),
            seg_ids=np.asarray([s for s, _, _ in per], dtype=np.int64),
            nq=nq,
            k=kk,
            query_sqnorm=qsq,
        )


def _resolve_mask(mask):
    """A WindowMask goes to its index unbuilt (the index reads it in its
    own layout); every other mask is materialized to row space."""
    return mask if isinstance(mask, WindowMask) else as_mask_array(mask)
