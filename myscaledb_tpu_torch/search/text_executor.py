"""Text & hybrid search execution over a table's segments.

Counterpart of myscaledb_tpu/search/text_executor.py. Re-expresses
MergeTreeTextSearchManager / MergeTreeHybridSearchManager:

  * table-consistent BM25: per-segment stats merged BEFORE scoring
    (getStatisticForTextSearch, ReadWithHybridSearch.cpp:89-209);
  * per-segment BM25 top-k on the segment's device with the pre-filter ∩
    delete bitmap (bm25SearchWithFilter contract);
  * a global merge across segments by score (exact ties: lower segment
    position, then lower row, as in the JAX package);
  * hybrid: vector leg + text leg, each fetching
    k × hybrid_search_top_k_multiple_base candidates
    (ExpressionAnalyzer.cpp:1217), fused with RRF or RSF on the device.

The fts stores of the segments that exist when the index is added are
built on the caller's thread; a later segment's store is built on the
table's build scheduler, and a search that arrives first builds it on
demand (as in the JAX package).
"""

from __future__ import annotations

import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..errors import QueryShapeError, SchemaError
from ..metrics import Metric, score_ascending_better
from ..service.event_log import GLOBAL_COUNTERS
from ..service.tracing import span
from ..text.analyzer import Analyzer
from ..text.inverted import (
    BM25Stats,
    InvertedIndex,
    pack_plans,
    pad_queries,
    query_terms,
    store_topk,
)
from .executor import SearchResult, merge_tagged_topk, pack_result, segment_mask
from .filters import Expr
from .fusion import rrf_fuse_t, rsf_fuse_t
from .program import (
    Program,
    ProgramCache,
    mask_spec,
    materialize_mask,
    normalize_device,
    tensors_key,
)


class TextIndexDefinition:
    """One fts index over one or more string columns (the
    `INDEX name(col, ...) TYPE fts('{json}')` DDL analogue)."""

    def __init__(self, name: str, columns: List[str], params: Optional[Dict[str, Any]] = None):
        self.name = name
        self.columns = list(columns)
        self.analyzer = Analyzer(params)
        self.params = dict(params or {})
        self._stores: Dict[int, InvertedIndex] = {}
        self._lock = threading.Lock()
        # segment_id -> segment, for stores whose background build is
        # pending or running; a search arriving first builds on demand
        # under the per-definition build lock
        self._pending: Dict[int, Any] = {}
        self._build_lock = threading.Lock()
        self._stats_cache = None  # (segment-id key, merged BM25Stats)
        # bumped on every invalidation: a stats computation that straddles
        # one must not install its (stale) result
        self._stats_gen = 0
        # the table's text programs (set by Table.add_fts_index): dropped
        # with every change of a store, so that no graph keeps a replaced
        # store's postings alive on the device
        self.programs: Optional[ProgramCache] = None

    def _build_store(self, segment) -> InvertedIndex:
        texts = [segment.scalar(c)[: segment.n_rows] for c in self.columns]
        store = InvertedIndex.build(
            texts, segment.capacity, analyzer=self.analyzer, device=segment.device
        )
        GLOBAL_COUNTERS.bump("FTSIndexBuilds")
        return store

    def _invalidate_locked(self) -> None:
        self._stats_cache = None
        self._stats_gen += 1
        if self.programs is not None:
            self.programs.invalidate()

    def on_new_segment(self, segment, scheduler=None) -> None:
        """Register (and build) the fts store for a segment: now, or with a
        scheduler as a background job (a search that arrives first builds
        it on demand). A rebuild replaces the segment's store."""
        if scheduler is None:
            store = self._build_store(segment)
            with self._lock:
                self._stores[segment.segment_id] = store
                self._pending.pop(segment.segment_id, None)
                self._invalidate_locked()
            return
        sid = segment.segment_id
        with self._lock:
            self._pending[sid] = segment
            self._stores.pop(sid, None)
            self._invalidate_locked()

        def job():
            with self._build_lock:
                with self._lock:
                    seg = self._pending.get(sid)
                if seg is None:
                    return  # built on demand (or dropped) meanwhile
                store = self._build_store(seg)
                with self._lock:
                    if self._pending.pop(sid, None) is not None:
                        self._stores[sid] = store
                        self._invalidate_locked()

        scheduler.submit(job)

    def on_segment_dropped(self, segment_id: int) -> None:
        with self._lock:
            self._stores.pop(segment_id, None)
            self._pending.pop(segment_id, None)
            self._invalidate_locked()

    def on_deletes(self, segment) -> None:
        """Deletes (local or replicated) need no store change: a search
        masks deleted rows through the alive bitmap."""

    def store(self, segment_id: int) -> Optional[InvertedIndex]:
        with self._lock:
            hit = self._stores.get(segment_id)
            if hit is not None or segment_id not in self._pending:
                return hit
        # a pending background build: build on demand (the first caller
        # wins; the background job then finds the pending entry gone)
        with self._build_lock:
            with self._lock:
                hit = self._stores.get(segment_id)
                seg = self._pending.get(segment_id)
            if hit is not None or seg is None:
                return hit
            store = self._build_store(seg)
            with self._lock:
                self._pending.pop(segment_id, None)
                self._stores[segment_id] = store
                self._invalidate_locked()
            return store

    def nlq_mask(self, segment, store, phrases, negs) -> np.ndarray:
        """bool[n_rows] rows satisfying the NLQ structure: every quoted
        phrase present (adjacency over the device token stream, or a host
        verify) and no excluded term present."""
        m = np.ones(segment.n_rows, bool)
        for ph in phrases:
            toks = self.analyzer.tokenize(ph)
            if not toks:
                continue
            if len(toks) > 1:
                # device path: adjacency over the token stream (the stream
                # concatenates this index's columns, the join the host
                # verifier builds below)
                bm = store.phrase_bitmap(toks)
                if bm is not None:
                    GLOBAL_COUNTERS.bump("FTSDevicePhraseChecks")
                    m &= bm
                    continue
            cand = store.term_bitmap(toks[0])
            for tk in toks[1:]:
                cand = cand & store.term_bitmap(tk)
            if len(toks) > 1:
                ver = np.zeros(segment.n_rows, bool)
                for i in np.nonzero(cand)[0]:
                    tt = self.analyzer.tokenize(
                        " ".join(str(segment.scalar(c)[i]) for c in self.columns)
                    )
                    ver[i] = any(
                        tt[j : j + len(toks)] == toks for j in range(len(tt) - len(toks) + 1)
                    )
                cand = ver
            m &= cand
        for ng in negs:
            for tk in self.analyzer.tokenize(ng):
                m &= ~store.term_bitmap(tk)
        return m

    def merged_stats(self, segment_ids) -> BM25Stats:
        """Table-level BM25 statistics over `segment_ids` (a pending store
        is built first), cached per segment set: stores are immutable once
        built."""
        key = tuple(segment_ids)
        with self._lock:
            cached = self._stats_cache
            pending = bool(self._pending)
            gen = self._stats_gen
        if not pending and cached is not None and cached[0] == key:
            return cached[1]
        parts = []
        for s in segment_ids:
            st = self.store(s)
            if st is not None:
                parts.append(st.stats)
        out = BM25Stats.merge(parts) if parts else BM25Stats(0, 0, {})
        with self._lock:
            if not pending and self._stats_gen == gen and not self._pending:
                self._stats_cache = (key, out)
        return out


class _FtsFilterBase(Expr):
    """Base for string-function predicates accelerated by an fts index
    (MergeTreeConditionTantivy atoms, MergeTreeIndexTantivy.h:141-180).
    The bitmap is candidate generation plus exact verification: term
    bitmaps cut the row set, the predicate verifies only candidates."""

    def __init__(self, table, column: str):
        self._table = table
        self.column = column

    def _tdef(self):
        for d in self._table._text_indexes.values():
            if self.column in d.columns:
                return d
        return None

    def _tokens(self) -> List[List[str]]:
        """DNF of token groups: a row is a candidate when ALL tokens of ANY
        group appear in it. [] = no index cut possible (scan everything)."""
        raise NotImplementedError

    def _verify(self, text: str) -> bool:
        raise NotImplementedError

    def _needs_verify(self) -> bool:
        return True

    def evaluate(self, segment) -> np.ndarray:
        tdef = self._tdef()
        groups = self._tokens()
        if tdef is not None and groups:
            store = tdef.store(segment.segment_id)
            if store is not None:
                cand = np.zeros(segment.n_rows, bool)
                for grp in groups:
                    if not grp:
                        continue
                    g = store.term_bitmap(grp[0])
                    for tk in grp[1:]:
                        g &= store.term_bitmap(tk)
                    cand |= g
                GLOBAL_COUNTERS.bump("FTSAcceleratedFilters")
                if not self._needs_verify():
                    return cand
                out = np.zeros(segment.n_rows, bool)
                idx = np.nonzero(cand)[0]
                if len(idx):
                    col = segment.scalar(self.column)
                    out[idx] = [self._verify(str(col[i])) for i in idx]
                return out
        # no index cut: verify every row
        col = segment.scalar(self.column)[: segment.n_rows]
        return np.fromiter(
            (self._verify(str(v)) for v in col), dtype=bool, count=segment.n_rows
        )

    def columns(self):
        return {self.column}


class _TokenFilter(_FtsFilterBase):
    """hasToken(col, 'tok'): the ffi_query_term[s]_bitmap role."""

    def __init__(self, table, column: str, token: str):
        super().__init__(table, column)
        self.token = token
        an = self._tdef().analyzer if self._tdef() else Analyzer()
        self._toks = an.tokenize(token)

    def _tokens(self):
        return [self._toks] if self._toks else []

    def _needs_verify(self) -> bool:
        return False  # token containment IS the predicate

    def _verify(self, text: str) -> bool:
        return set(self._toks) <= set(Analyzer().tokenize(text))

    def evaluate(self, segment):
        if not self._toks:
            return np.zeros(segment.n_rows, bool)
        return super().evaluate(segment)

    def __repr__(self):
        return f"hasToken({self.column}, {self.token!r})"


class _LikeFilter(_FtsFilterBase):
    """col LIKE '%pattern%' accelerated by token bitmaps: the pattern's
    complete inner tokens must all appear in a matching row, so their
    bitmap intersection is a safe candidate set; a real LIKE match then
    verifies candidates."""

    def __init__(self, table, column: str, pattern: str, negate: bool = False):
        super().__init__(table, column)
        self.pattern = pattern
        self.negate = negate
        rx = re.escape(pattern).replace("%", ".*").replace("_", ".")
        self._rx = re.compile(f"^{rx}$", re.DOTALL)
        an = self._tdef().analyzer if self._tdef() else Analyzer()
        # complete tokens only: pieces between wildcards, without the edge
        # fragments that may be partial words
        self._toks = []
        inner = [p for p in pattern.split("%")[1:-1] if p and "_" not in p]
        for piece in inner:
            toks = an.tokenize(piece)
            if len(toks) >= 3:
                self._toks.extend(toks[1:-1])

    def _tokens(self):
        # negated LIKE cannot use candidate cuts (complement semantics)
        return [self._toks] if self._toks and not self.negate else []

    def _verify(self, text: str) -> bool:
        hit = self._rx.match(text) is not None
        return (not hit) if self.negate else hit

    def __repr__(self):
        kw = "NOT LIKE" if self.negate else "LIKE"
        return f"fts:{self.column} {kw} {self.pattern!r}"


class _MultiSearchAnyFilter(_FtsFilterBase):
    """multiSearchAny(col, needles): substring-any, candidates from the
    union of each needle's inner-token bitmaps, substring verify."""

    def __init__(self, table, column: str, needles: List[str]):
        super().__init__(table, column)
        self.needles = [str(n) for n in needles]
        an = self._tdef().analyzer if self._tdef() else Analyzer()
        self._groups = []
        self._cuttable = True
        for n in self.needles:
            toks = an.tokenize(n)
            # safe only when the needle's inner tokens are whole words
            inner = toks[1:-1] if len(toks) >= 3 else []
            if inner:
                self._groups.append(inner)
            else:
                self._cuttable = False  # some needle has no safe cut

    def _tokens(self):
        return self._groups if self._cuttable else []

    def _verify(self, text: str) -> bool:
        return any(n in text for n in self.needles)

    def __repr__(self):
        return f"multiSearchAny({self.column}, {self.needles!r})"


class _PhraseFilter(_FtsFilterBase):
    """Sentence/phrase predicate (ffi_query_sentence_bitmap role): the
    store's token-stream adjacency when the index covers exactly this
    column, else candidates from the phrase's term bitmaps and an
    adjacency verify on the host."""

    def __init__(self, table, column: str, phrase: str):
        super().__init__(table, column)
        self.phrase = phrase
        self._an = self._tdef().analyzer if self._tdef() else Analyzer()
        self._toks = self._an.tokenize(phrase)

    def _tokens(self):
        return [self._toks] if self._toks else []

    def _verify(self, text: str) -> bool:
        toks = self._an.tokenize(text)
        n, m = len(toks), len(self._toks)
        if m == 0:
            return True
        return any(toks[i : i + m] == self._toks for i in range(n - m + 1))

    def evaluate(self, segment):
        if not self._toks:
            return np.ones(segment.n_rows, bool)
        tdef = self._tdef()
        # a multi-column store concatenates its columns into one stream
        if tdef is not None and list(tdef.columns) == [self.column]:
            store = tdef.store(segment.segment_id)
            if store is not None:
                bm = store.phrase_bitmap(self._toks)
                if bm is not None:
                    GLOBAL_COUNTERS.bump("FTSAcceleratedFilters")
                    GLOBAL_COUNTERS.bump("FTSDevicePhraseChecks")
                    return bm
        return super().evaluate(segment)

    def __repr__(self):
        return f"hasPhrase({self.column}, {self.phrase!r})"


class _RegexTokenFilter(_FtsFilterBase):
    """Regex term bitmap (ffi_regex_term_bitmap role): rows containing at
    least one vocabulary term matching the regex."""

    def __init__(self, table, column: str, pattern: str):
        super().__init__(table, column)
        self.pattern = pattern
        self._rx = re.compile(pattern)

    def evaluate(self, segment) -> np.ndarray:
        tdef = self._tdef()
        if tdef is not None:
            store = tdef.store(segment.segment_id)
            if store is not None:
                out = np.zeros(segment.n_rows, bool)
                for term in store.vocab:
                    if self._rx.fullmatch(term):
                        out |= store.term_bitmap(term)
                GLOBAL_COUNTERS.bump("FTSAcceleratedFilters")
                return out
        an = Analyzer()
        col = segment.scalar(self.column)[: segment.n_rows]
        return np.fromiter(
            (any(self._rx.fullmatch(tk) for tk in an.tokenize(str(v))) for v in col),
            dtype=bool,
            count=segment.n_rows,
        )

    def __repr__(self):
        return f"hasTokenMatching({self.column}, {self.pattern!r})"


def fts_token_filter(table, column: str, token: str) -> Expr:
    return _TokenFilter(table, column, token)


def fts_like_filter(table, column: str, pattern: str, negate: bool = False) -> Expr:
    return _LikeFilter(table, column, pattern, negate)


def fts_multi_search_any(table, column: str, needles: List[str]) -> Expr:
    return _MultiSearchAnyFilter(table, column, needles)


def fts_phrase_filter(table, column: str, phrase: str) -> Expr:
    return _PhraseFilter(table, column, phrase)


def fts_regex_filter(table, column: str, pattern: str) -> Expr:
    return _RegexTokenFilter(table, column, pattern)


def parse_nlq(query: str):
    """Natural-language query structure (the tantivy NLQ subset the
    reference exposes via enable_nlq, VSDescription.h:80-88): quoted
    phrases must match adjacently, '-term' excludes, the rest are
    ordinary scored terms. Returns (bm25_text, phrases, excluded)."""
    phrases = re.findall(r'"([^"]*)"', query)
    rest = re.sub(r'"[^"]*"', " ", query)
    negs = re.findall(r"(?:^|\s)-([\w]+)", rest)
    rest = re.sub(r"(?:^|\s)-[\w]+", " ", rest)
    bm25_text = (rest + " " + " ".join(phrases)).strip()
    return bm25_text, phrases, negs


class TextSearchExecutor:
    def __init__(self, table):
        self.table = table

    def _resolve(self, column_or_index: str) -> TextIndexDefinition:
        t = self.table
        tdef = t._text_indexes.get(column_or_index)
        if tdef is not None:
            return tdef
        for d in t._text_indexes.values():
            if column_or_index in d.columns:
                return d
        raise SchemaError(
            f"no fts index covering {column_or_index!r}; add one with add_fts_index()"
        )

    def run(
        self,
        column_or_index: str,
        query,
        k: Optional[int],
        *,
        filter: Optional[Expr] = None,
        operator: str = "OR",
        stats_override: Optional[BM25Stats] = None,
        enable_nlq: bool = False,
        settings=None,
    ) -> SearchResult:
        """textsearch() analogue: BM25 top-k, scores descending.

        `query` may be one string or a list of strings (a batch). The
        batch is tokenized once, each live store planned from its terms,
        and every store's BM25 body and the merge run as one program (on
        the card one CUDA graph) of the table's `_text_programs`, keyed on
        k, the batch padded to 8 rows, each store's route, budget, nt,
        need_counts, capacity and tensors, the masks' shapes, the
        segment-set version and the index's store generation; the plans
        and statistics are its one packed input. stats_override: corpus
        statistics injected by a distributed initiator, in place of the
        table's own. The result is device-lazy like vector search."""
        with span("text_search", table=self.table.name, column=column_or_index):
            return self._run_traced(
                column_or_index, query, k, filter=filter, operator=operator,
                stats_override=stats_override, enable_nlq=enable_nlq, settings=settings,
            )

    def _run_traced(
        self, column_or_index, query, k, *, filter, operator, stats_override, enable_nlq,
        settings,
    ) -> SearchResult:
        t = self.table
        st = settings or t.settings
        queries = [query] if isinstance(query, str) else list(query)
        nq = len(queries)
        if nq == 0:
            raise QueryShapeError("query batch is empty")
        k = int(k if k is not None else st.query.default_topk)
        if k <= 0:
            raise QueryShapeError("k must be positive")
        if k > st.query.max_search_result_window:
            raise QueryShapeError(
                f"top-k window {k} exceeds max_search_result_window="
                f"{st.query.max_search_result_window}"
            )
        tdef = self._resolve(column_or_index)
        GLOBAL_COUNTERS.bump("TextSearchQueries", nq)
        # read before the segments and stores: see ProgramCache.get
        version, seg_version, gen = t._text_programs.version, t.segment_version, tdef._stats_gen
        segments = t.live_segments()
        seg_ids = [s.segment_id for s in segments]
        stats = stats_override if stats_override is not None else tdef.merged_stats(seg_ids)

        parsed = [parse_nlq(q) for q in queries] if enable_nlq else None
        need_nlq = parsed is not None and any(p or n for _, p, n in parsed)
        bm25_queries = [p[0] for p in parsed] if parsed is not None else queries
        terms = query_terms(tdef.analyzer, bm25_queries)
        nq_pad = pad_queries(nq)

        parts = []  # (segment id, store, plan, [base mask, NLQ mask])
        for seg in segments:
            store = tdef.store(seg.segment_id)
            if store is None:
                continue
            nlq = None
            if need_nlq:
                extra = np.zeros((nq_pad, seg.capacity), bool)
                for qi, (_, phrases, negs) in enumerate(parsed):
                    extra[qi, : seg.n_rows] = tdef.nlq_mask(seg, store, phrases, negs)
                nlq = ("rows", torch.from_numpy(extra))
            base = materialize_mask(segment_mask(seg, filter))
            plan = store.plan_terms(terms, stats=stats, operator=operator)
            parts.append((seg.segment_id, store, plan, [base, nlq]))
        if not parts:
            return SearchResult.empty(Metric.IP, nq, k)
        packed, offs = pack_plans([p for _, _, p, _ in parts], stats.avg_doc_len, nq_pad)
        refs: List[torch.Tensor] = []
        stores = tuple(
            (p.route, p.budget, p.idfs.shape[1], p.need_counts, store.capacity,
             tensors_key(store.tensors, refs))
            for _, store, p, _ in parts
        )
        mats = [m for _, _, _, ms in parts for m in ms]
        specs = tuple(mask_spec(m) for m in mats)
        key = ("text", k, nq_pad, stores, specs, seg_version, gen)
        found = [(part[1].tensors, off, desc) for part, off, desc in zip(parts, offs, stores)]

        def body(plan, mbufs, dyn):
            del dyn
            vs, rs, ts = [], [], []
            for i, (tensors, off, desc) in enumerate(found):
                route, budget, nt, need_counts, capacity, _ = desc
                base, nlq = mbufs[2 * i], mbufs[2 * i + 1]
                if nlq is not None:
                    base = nlq if base is None else torch.logical_and(nlq, base[None, :])
                v, r, tg, _ = store_topk(
                    tensors, plan, off, nt, base, route=route, budget=budget, capacity=capacity,
                    k=k, need_counts=need_counts, approx=False,
                )
                vs.append(v)
                rs.append(r)
                ts.append(tg)
            if len(vs) == 1:
                # the tag column already came from the scoring body
                return pack_result(vs[0], ts[0], rs[0])
            return pack_result(*merge_tagged_topk(vs, rs, k))

        def make():
            label = ", ".join(f"segment {sid}: BM25 {p.route}" for sid, _, p, _ in parts)
            return Program(
                body, device=parts[0][1].device, query=(tuple(packed.shape), torch.int32),
                masks=[None if sp is None else (sp[1], sp[2]) for sp in specs],
                out_shape=(3, nq_pad, k), label=f"the text search ({label})", refs=refs,
            )

        out = t._text_programs.get(key, make, version).run(
            packed, [None if m is None else m[1] for m in mats]
        )
        # BM25 score is bigger-better: exposed under the IP (similarity)
        # convention
        return SearchResult(
            Metric.IP, device=out, seg_ids=np.asarray([p[0] for p in parts], dtype=np.int64),
            nq=nq, k=k,
        )


# the fuse programs (their bodies read nothing but their buffers)
_FUSE_PROGRAMS = ProgramCache()


def _fuse_device(
    vleg, vtag_map, tleg, ttag_map, *, k, fusion_type, fusion_k, fusion_weight, vec_asc, nq
):
    """Device hybrid fusion: slice off the query padding ([:nq]), remap
    each leg's segment tags into one tag space (`*_tag_map`: int32 over a
    leg's tag positions), and fuse (RRF / RSF) over (tag, row) pairs."""
    (vvals, vtags, vrows), (tvals, ttags, trows) = (
        tuple(a[:nq] for a in leg) for leg in (vleg, tleg)
    )

    def remap(tags, rows, tag_map):
        neg = torch.full_like(tags, -1)
        uni = torch.where(tags >= 0, tag_map[torch.clamp(tags, min=0).to(torch.int64)], neg)
        ok = torch.logical_and(uni >= 0, rows >= 0)
        return torch.where(ok, uni, neg), torch.where(ok, rows, torch.full_like(rows, -1))

    vt, vr = remap(vtags, vrows, vtag_map)
    tt, tr = remap(ttags, trows, ttag_map)
    if fusion_type == "rrf":
        return rrf_fuse_t(vt, vr, tt, tr, k, fusion_k=fusion_k)
    return rsf_fuse_t(
        vt, vr, vvals, tt, tr, tvals, k, fusion_weight=fusion_weight, vec_ascending_better=vec_asc
    )


def _leg_input(res: SearchResult):
    """(packed int32[3, Q', k'] device result | None, its key part) of a
    hybrid leg: both legs' programs return packed results; a host result
    here is SearchResult.empty (every slot invalid; the fuse body makes
    it)."""
    if res._packed is None:
        return None, ("empty", res.k)
    return res._packed, ("packed", tuple(res._packed.shape))


def fuse_legs(vres: SearchResult, tres: SearchResult, k: int, *, fusion_type: str, fusion_k: int,
              fusion_weight: float, vec_asc: bool, device) -> SearchResult:
    """The hybrid fuse as one program (JAX's jitted `_fuse_device`), keyed
    on its static arguments (k, fusion_type, fusion_k, fusion_weight,
    vec_asc, nq) and the legs' shapes. The legs' packed results are
    copied into its buffers on the device; the two tag maps ride in one
    host upload."""
    nq = vres.nq
    v_ids = vres._seg_ids if vres._seg_ids is not None else np.zeros(0, np.int64)
    t_ids = tres._seg_ids if tres._seg_ids is not None else np.zeros(0, np.int64)
    uni = np.unique(np.concatenate([v_ids, t_ids]))
    if len(uni) == 0:
        uni = np.asarray([-1], np.int64)  # both legs empty: sentinel

    def tag_map(ids):
        if not len(ids):
            return np.asarray([-1], np.int32)
        return np.searchsorted(uni, ids).astype(np.int32)

    vmap, tmap = tag_map(v_ids), tag_map(t_ids)
    maps = np.concatenate([vmap, tmap])
    (vbuf, vspec), (tbuf, tspec) = _leg_input(vres), _leg_input(tres)
    device = normalize_device(device)
    key = ("fuse", str(device), k, fusion_type, fusion_k, fusion_weight, vec_asc, nq, vspec,
           tspec, len(vmap), len(tmap))
    lv = len(vmap)

    def leg(buf, spec):
        if buf is None:
            return (torch.full((nq, spec[1]), float("-inf"), dtype=torch.float32, device=device),
                    torch.full((nq, spec[1]), -1, dtype=torch.int32, device=device),
                    torch.full((nq, spec[1]), -1, dtype=torch.int32, device=device))
        return buf[0].view(torch.float32), buf[1], buf[2]

    def body(q, legs, dyn):
        del dyn
        return pack_result(*_fuse_device(
            leg(legs[0], vspec), q[:lv], leg(legs[1], tspec), q[lv:], k=k,
            fusion_type=fusion_type, fusion_k=fusion_k, fusion_weight=fusion_weight,
            vec_asc=vec_asc, nq=nq,
        ))

    def make():
        return Program(
            body, device=device, query=(maps.shape, torch.int32),
            masks=[None if b is None else (tuple(b.shape), b.dtype) for b in (vbuf, tbuf)],
            out_shape=(3, nq, k), label=f"the {fusion_type.upper()} fuse",
        )

    out = _FUSE_PROGRAMS.get(key, make).run(maps, [vbuf, tbuf])
    return SearchResult(Metric.IP, device=out, seg_ids=uni, nq=nq, k=k)


class HybridSearchExecutor:
    def __init__(self, table):
        self.table = table

    def run(
        self,
        vector_column: str,
        text_column_or_index: str,
        vector_query,
        text_query,
        k: Optional[int],
        *,
        fusion_type: str = "rsf",
        fusion_weight: Optional[float] = None,
        fusion_k: Optional[int] = None,
        filter: Optional[Expr] = None,
        operator: str = "OR",
        params: Optional[Dict[str, Any]] = None,
        settings=None,
    ) -> SearchResult:
        """hybridsearch() analogue: both legs fetch k×multiple_base
        candidates, fused on the device (RRF: Σ1/(k+rank); RSF:
        direction-aware min-max, HybridSearchUtils.cpp:164,212-313), scores
        descending.

        Batched: vector_query may be [Q, D] with text_query a matching list
        of Q strings (or one string shared by all). Device-lazy: no host
        sync until results are read."""
        with span("hybrid_search", table=self.table.name, column=vector_column):
            return self._run_traced(
                vector_column, text_column_or_index, vector_query, text_query, k,
                fusion_type=fusion_type, fusion_weight=fusion_weight, fusion_k=fusion_k,
                filter=filter, operator=operator, params=params, settings=settings,
            )

    def _run_traced(
        self, vector_column, text_column_or_index, vector_query, text_query, k, *,
        fusion_type, fusion_weight, fusion_k, filter, operator, params, settings,
    ) -> SearchResult:
        t = self.table
        st = settings or t.settings
        k = int(k if k is not None else st.query.default_topk)
        n_cand = min(
            k * st.query.hybrid_search_top_k_multiple_base, st.query.max_search_result_window
        )
        ftype = fusion_type.lower()
        if ftype not in ("rrf", "rsf"):
            raise QueryShapeError(f"fusion_type must be rrf or rsf, got {fusion_type!r}")

        vres = t.search(vector_column, vector_query, n_cand, filter=filter, params=params,
                        settings=st)
        nq = vres.nq
        GLOBAL_COUNTERS.bump("HybridSearchQueries", nq)
        tq = [text_query] * nq if isinstance(text_query, str) else list(text_query)
        if len(tq) != nq:
            raise QueryShapeError(f"text_query batch ({len(tq)}) must match vector batch ({nq})")
        tres = TextSearchExecutor(t).run(
            text_column_or_index, tq, n_cand, filter=filter, operator=operator, settings=st
        )

        return fuse_legs(
            vres, tres, k, fusion_type=ftype,
            fusion_k=int(fusion_k if fusion_k is not None else st.query.hybrid_search_fusion_k),
            fusion_weight=float(
                st.query.hybrid_search_fusion_weight if fusion_weight is None else fusion_weight
            ),
            vec_asc=score_ascending_better(vres.metric), device=t.device,
        )
