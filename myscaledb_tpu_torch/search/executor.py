"""Vector search execution: per-segment search + global top-k merge.

Counterpart of myscaledb_tpu/search/executor.py. The re-expression of the
reference's search-manager stack:

  MergeTreeVSManager::vectorScan            -> per-segment search_t
  performPrefilter + DenseBitmap            -> filters.Expr -> device mask (an
                                               IVF index: its layout of the
                                               passing rows, `_prefilter`)
  getTotalTopSearchResultImpl (k-way heap)  -> on-device merge across segments
  two-stage search (first_stage_only +      -> _two_stage_run: a global
    computeTopDistanceSubset)                  candidate cut, exact re-rank
  mergeResult (score join by label)         -> SearchResult / Table.gather
  disk-mode parts (Search::DiskIOManager)   -> host-tier segments: a streamed
                                               exact scan (stream_scan_topk)

As in the JAX package, the WHOLE query -- the cast and pad of the
queries, every segment's index search or scan and the global merge -- is
one program (`_fused_multi_search`): on a CUDA device one captured graph,
replayed from the table's program cache (search/program.py) per (k,
params bucket, padded batch, the masks' kinds, the searchers and their
tensors). Outside it stay the query upload (through a pinned
staging buffer), one copy per mask and one copy of the packed outputs.
The plan that finds the program (the segment walk, masks, routes and the
program's key) is kept beside it under the request's key, so a repeated
request runs the program without planning (`_Plan`).
Results are lazy: that copy stays on the device until the caller reads
it. The two-stage path (first passes, a global cut, the exact re-rank)
and host-tier scans stay eager, as in the JAX package; their plain
segments call `VectorIndex.search`, a program of its own.

Labels stay segment-local; a global hit is (segment_id, row_id, score).
"""

from __future__ import annotations

import operator
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ..config import Settings
from ..errors import QueryShapeError
from ..index.base import VectorIndex, label_of, params_key, signature, split_dyn_nprobe
from ..index.binary import BinaryFlatIndex
from ..index.flat import FlatIndex
from ..metrics import Metric, score_to_distance
from ..ops.topk import NEG_INF, topk_stable
from ..service.event_log import GLOBAL_COUNTERS
from ..service.tracing import span
from ..storage.schema import BinaryVector
from .filters import (
    And,
    Compare,
    DeviceMask,
    Expr,
    In,
    Lambda,
    Like,
    Literal,
    Not,
    Or,
    WindowMask,
    as_mask_array,
    mask_argument,
    mask_spec,
    materialize_mask,
)
from .program import Program


class SearchResult:
    """Global top-k for a batch of queries. Device-lazy: `device`, one
    int32[3, Q, k] tensor (`pack_result`: the scores' bits, the segment
    tags and the rows), stays on the device until the first host access
    reads it back in one copy."""

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
        self._packed = device
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
                packed = self._packed.cpu().numpy()[:, : self.nq]
                vals, tags, rows = packed[0].view(np.float32), packed[1], packed[2]
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


def _as_query_batch(query, dim: int, metric: Metric):
    """Normalize the query input to a host f32 [Q, dim] batch and, for L2,
    its per-query |q|^2 (numpy, re-applied to L2 distances on the host;
    None for the other metrics, whose distances do not read it)."""
    if isinstance(query, torch.Tensor):
        query = query.detach().cpu().numpy()
    q = np.asarray(query, dtype=np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2 or q.shape[1] != dim:
        raise QueryShapeError(f"query must be [*, {dim}], got {q.shape}")
    qsq = np.einsum("ij,ij->i", q, q) if metric == Metric.L2 else None
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


def segment_mask(segment, filter_expr: Optional[Expr]):
    """Pre-filter bitmap for one segment: WHERE bitmap ∩ alive bitmap,
    extended to capacity (False in padding). None when unconstrained.

    Numeric predicates lower to the device (DeviceMask): the bitmap is
    built on the segment's device from mirrored scalar columns, with no
    host evaluation and no upload. Strings/Lambda evaluate on the host;
    a repeated predicate's device mask comes from the segment's
    `mask_cache` (Lambda filters are not cached: their repr does not
    capture the closure)."""
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

    def make():
        host = filter_expr.evaluate(segment)  # bool[n_rows]
        full = np.zeros(segment.capacity, dtype=bool)
        full[: segment.n_rows] = host
        dev = torch.from_numpy(full).to(segment.device)
        return dev if alive is None else torch.logical_and(dev, alive)

    if _has_lambda(filter_expr):
        return make()
    key = (repr(filter_expr), segment.mutation_generation)
    return _memo(segment.mask_cache, _MASK_CACHE_CAP, key, make)


def _has_lambda(expr) -> bool:
    return any(isinstance(e, Lambda) for e in _walk_filter(expr))


def _walk_filter(expr):
    yield expr
    for attr in ("a", "b"):
        child = getattr(expr, attr, None)
        if child is not None and isinstance(child, Expr):
            yield from _walk_filter(child)


def _filter_key(expr: Expr) -> Optional[str]:
    """A filter's part of a plan's key: its repr where every node is one
    of `_PURE_FILTERS`, else None (the plan is not kept)."""
    if all(type(e) in _PURE_FILTERS for e in _walk_filter(expr)):
        return repr(expr)
    return None


def _plan_key(column, k, pkey, metric, use_two_stage, nq_pad, qh, is_binary, filter, fkey, st,
              version) -> Optional[tuple]:
    """The key a fused search's plan is kept under, or None where the
    request is never kept (a filter outside `_PURE_FILTERS`)."""
    if filter is not None and fkey is None:
        return None
    return ("plan", column, k, pkey, metric, use_two_stage, nq_pad, qh.shape[1:], qh.dtype.str,
            is_binary, fkey, _settings_key(st), version)


def estimate_selectivity(segment, filter_expr: Optional[Expr]) -> Optional[float]:
    """Fraction of the segment's rows passing `filter_expr` (ignoring
    deletes), or None when it cannot be costed cheaply (Lambda closures).
    Cached on the segment per (predicate, mutation generation)."""
    if filter_expr is None:
        return 1.0
    if segment.n_rows == 0:
        return 0.0
    if _has_lambda(filter_expr):
        return None

    def make():
        host = filter_expr.evaluate(segment)
        return float(np.count_nonzero(host)) / float(segment.n_rows)

    key = (repr(filter_expr), segment.mutation_generation)
    return _memo(segment.selectivity_cache, _SELECTIVITY_CACHE_CAP, key, make)


# entries of a segment's mask and selectivity caches
_MASK_CACHE_CAP = 256
_SELECTIVITY_CACHE_CAP = 512


def _memo(cache: dict, cap: int, key, make):
    """cache[key], made on a miss; past `cap` the oldest entry goes."""
    hit = cache.get(key)
    if hit is None:
        hit = make()
        if len(cache) >= cap:
            cache.pop(next(iter(cache)))
        cache[key] = hit
    return hit


def _prefilter(segment, fexpr: Optional[Expr], idx, st, k: int, pkey, counts: Dict[str, int]):
    """(mask, searcher, forced to the exact scan, searches a layout) of one
    segment under a filter: the pre-filter bitmap, the route its
    selectivity decides, and for an IVF index the searcher of the passing
    rows with their layout as its mask (`filter_layout`, cached by the
    filter as the segment's masks are), or in disk mode its window mask.
    The route's counters go on `counts`."""
    mask = segment_mask(segment, fexpr)
    if idx is None or fexpr is None:
        return mask, idx, False, False
    if st.query.filter_fallback_selectivity > 0:
        sel = estimate_selectivity(segment, fexpr)
        if sel is not None and sel < st.query.filter_fallback_selectivity:
            # over-selective filter: the exact masked scan is both correct
            # (a graph walk loses recall on sparse masks) and cheap (few
            # survivors) -- fallbackToFlat
            _add(counts, "VectorIndexFallbackToFlat")
            return mask, None, True, False
    if hasattr(idx, "filter_layout"):
        # IVF-layout indexes search the passing rows in their own order,
        # or (disk mode) test the predicate over their window-permuted
        # column mirrors
        key = None if _has_lambda(fexpr) else (repr(fexpr), segment.mutation_generation)
        found = idx.filter_layout(mask, key, k, pkey)
        if found is not None:
            layout, buf = found
            return buf, layout, False, True
        if isinstance(mask, DeviceMask):
            wm = idx.to_window_mask(mask, segment)
            if wm is not None:
                return wm, idx, False, False
    return mask, idx, False, False


def _add(counts: Dict[str, int], name: str, n: int = 1) -> None:
    counts[name] = counts.get(name, 0) + n


# The filter nodes whose answer is a pure function of a segment's rows and
# whose repr names every operand: a plan under a filter of these alone is
# memoized by the filter's repr. Any other node plans every search in full:
# a `Lambda` (its repr does not name its closure) and the fts predicates of
# text_executor (they read an fts store, whose tokenizer they captured when
# they were made).
_PURE_FILTERS = (And, Or, Not, Literal, Compare, In, Like)

# The settings a plan reads: their values are part of a plan's key
# (`Settings` is mutable: its identity says nothing).
_settings_key = operator.attrgetter(
    "query.max_search_result_window", "query.two_stage_search",
    "query.optimize_prefilter_in_search", "query.filter_fallback_selectivity",
    "query.cost_based_index_routing", "query.enable_brute_force_vector_search",
    "query.use_approx_topk", "query.approx_topk_recall_target",
    "table.min_rows_to_build_vector_index",
)


class _Plan:
    """A fused search's resolved plan, kept in the table's program cache
    (`ProgramCache.keep_plan`) under the request's key: what the planning
    hands `Program.run` besides the queries, the counters it bumped, the
    loaded indexes whose cache recency it refreshed, and the cost routes it
    priced. A repeated request runs it in place of the planning."""

    __slots__ = ("program", "masks", "dyn", "seg_ids", "metric", "counts", "touched", "routes")

    def __init__(self, program, masks, dyn, seg_ids, metric, counts, touched, routes):
        self.program = program
        self.masks = masks
        self.dyn = dyn
        self.seg_ids = seg_ids
        self.metric = metric
        self.counts = (tuple(counts), tuple(counts.values()))
        self.touched = tuple(touched)
        self.routes = tuple(routes)

    def holds(self, nq: int, k: int, pkey) -> bool:
        """Whether the cost routes priced for the planned batch route this
        one alike: the key holds the padded batch, the model prices the
        actual one."""
        return all(idx.prefer_exact_scan(nq, k, pkey, nbytes) == scan
                   for idx, nbytes, scan in self.routes)

    def run(self, table, qh, nq: int, qsq, k: int) -> SearchResult:
        GLOBAL_COUNTERS.bump_many(*self.counts)
        table.touch_indexes(self.touched)
        return SearchResult(self.metric, device=self.program.run(qh, self.masks, self.dyn),
                            seg_ids=self.seg_ids, nq=nq, k=k, query_sqnorm=qsq)


class VectorSearchExecutor:
    """Executes a vector search over a table's segments.

    Index-vs-brute-force policy per segment (bruteForceSearchEnabled,
    MergeTreeVSManager.cpp:1681-1688): a built index for the column is
    used when present, unless an over-selective filter
    (filter_fallback_selectivity) or the cost model
    (cost_based_index_routing) sends the segment to the exact scan;
    otherwise small segments always scan exactly and large ones scan only
    if enable_brute_force_vector_search.

    A fused search's plan (the segments, their masks, routes and searchers,
    the program) is a function of the request's key (`_plan_key`: the
    column, k, params, metric, the padded batch's shape, the filter's repr,
    the settings the plan reads) and of the table's `segment_version`,
    which moves with every change a plan could see. It is kept in the
    table's program cache beside its program, and a repeated request runs
    it without planning (counter `SearchPlanHits`; a request that plans,
    `SearchPlanMisses`). The table's one drop drops it. The two-stage path,
    host-tier scans and a filter outside `_PURE_FILTERS` plan every search.
    Each search opens `program.key` once, around the key and the lookup,
    and a filtered one `filter.mask` once, around the filter's part of the
    key; a planning search opens neither again.
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
            qh, nq, qsq = _as_query_batch(query, vtype.dim, metric)
        GLOBAL_COUNTERS.bump("VectorSearchQueries", nq)

        version = t.segment_version  # read before the segments: see ProgramCache.get
        nq_pad = max(8, -(-nq // 8) * 8)
        pkey = params_key(params)
        use_two_stage = st.query.two_stage_search if two_stage is None else bool(two_stage)
        fkey = None
        if filter is not None:
            with span("filter.mask"):
                fkey = _filter_key(filter)
        with span("program.key"):
            mkey = _plan_key(column, k, pkey, metric, use_two_stage, nq_pad, qh, is_binary,
                             filter, fkey, st, version)
            try:
                plan = None if mkey is None else t._programs.plan(mkey)
            except TypeError:  # params that do not hash: never kept
                mkey = plan = None
        if plan is not None and plan.holds(nq, k, pkey):
            return plan.run(t, qh, nq, qsq, k)
        GLOBAL_COUNTERS.bump("SearchPlanMisses")
        return self._plan_run(column, filter, k, pkey, params, metric, st, use_two_stage, qh, nq,
                              qsq, nq_pad, is_binary, vtype, version, mkey)

    def _plan_run(self, column, filter, k, pkey, params, metric, st, use_two_stage, qh, nq, qsq,
                  nq_pad, is_binary, vtype, version, mkey) -> SearchResult:
        """Plan the search in full and run it; a fused plan is kept under
        `mkey` (None: not kept)."""
        t = self.table
        segments = t.live_segments()
        if not segments:
            return SearchResult.empty(metric, nq, k, qsq)

        dpad = segments[0].vector(column).data.shape[1]
        searchers: List[VectorIndex] = []
        masks: List[Any] = []
        seg_ids: List[int] = []
        first_stage: List[Tuple[int, VectorIndex, Any]] = []
        host_scans: List[Tuple[int, VectorIndex, Any]] = []
        counts: Dict[str, int] = {}  # the routes' counters, bumped once the segments are walked
        touched: List[Tuple[str, str, int]] = []  # the loaded indexes' cache keys
        routes: List[Tuple[VectorIndex, int, bool]] = []  # the cost routes priced
        layouts = 0  # segments searched through a filter layout
        for seg in segments:
            fexpr = filter
            if filter is not None and st.query.optimize_prefilter_in_search:
                fold = filter.const_fold(seg)
                if fold is False:
                    continue  # provably no row passes: skip the segment
                if fold is True:
                    fexpr = None  # provably all pass: alive mask only
            idx = t.loaded_index(seg.segment_id, column, metric, touched)
            if filter is None:
                mask, forced_exact = segment_mask(seg, None), False
            else:
                mask, idx, forced_exact, layout = _prefilter(seg, fexpr, idx, st, k, pkey, counts)
                layouts += layout
            if idx is not None and st.query.cost_based_index_routing:
                payload = seg.vector(column)
                # a host-tier payload is never routed to the scan: its
                # cost is the host link's, which the model does not price
                if not payload.is_host:
                    scan = idx.prefer_exact_scan(nq, k, pkey, int(payload.nbytes))
                    routes.append((idx, int(payload.nbytes), scan))
                    if scan:
                        # the exact scan is modeled cheaper than this
                        # index's search for this batch and corpus, and it
                        # is exact
                        idx = None
                        forced_exact = True
                        _add(counts, "VectorIndexCostRouteToScan")
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
                    _add(counts, "VectorSearchSegmentsSkipped")
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
                _add(counts, "VectorBruteForceSearches")
            else:
                _add(counts, "VectorIndexSearches")
            if isinstance(idx, FlatIndex) and idx.host:
                # beyond-HBM tier: the streamed exact scan, eager
                host_scans.append((seg.segment_id, idx, mask))
                continue
            searchers.append(idx)
            masks.append(mask)
            seg_ids.append(seg.segment_id)
        if counts:
            GLOBAL_COUNTERS.bump_many(tuple(counts), tuple(counts.values()))

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

        key = (
            "fused", k, bucketed, nq_pad, dpad, tuple(qh.shape[1:]), is_binary, specs,
            tuple(signature(s, refs) for s in searchers), dyn_np is not None,
        )
        prog = t._programs.get(key, make, version)
        inputs = [None if m is None else m[1] for m in mats]
        sids = np.asarray(seg_ids, dtype=np.int64)
        if mkey is not None:
            sids.flags.writeable = False  # every result of the plan reads it
            if layouts:
                _add(counts, "IvfFilterLayoutHits", layouts)  # a repeated plan's layout lookups
            _add(counts, "SearchPlanHits")
            t._programs.keep_plan(
                mkey, _Plan(prog, inputs, dyn_np, sids, metric, counts, touched, routes),
                key, prog, version)
        packed = prog.run(qh, inputs, dyn_np)
        return SearchResult(metric, device=packed, seg_ids=sids, nq=nq, k=k, query_sqnorm=qsq)

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
