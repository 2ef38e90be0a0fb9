"""Table: segments, vector indexes and the search entry points.

Counterpart of myscaledb_tpu/storage/table.py, for the MergeTree engine:

  * insert  -> new immutable segment (INSERT = new part), searchable by
    exact scan immediately; every vector index of the table is built for
    it (or marked a small part)
  * add_vector_index / drop_vector_index -> the per-(segment, index)
    lifecycle (IndexStatus slots, event log, counters)
  * search  -> VectorSearchExecutor (pre-filter ∩ deletes, per-segment
    index search or exact scan, global top-k merge)
  * lightweight DELETE -> per-segment delete bitmaps intersected into
    every search
  * gather  -> output columns of the hits
  * add_fts_index -> an fts store per segment; text_search (BM25) and
    hybrid_search (RRF / RSF) through search/text_executor.py, and the
    fts-accelerated string predicates (has_token, like, ...) as filters

Every segment and index lives on the table's explicit `device`. Index
builds, vector and fts alike, run synchronously on the caller's thread;
`load_index` installs an index from a state dict instead (a two-stage
index re-attaches its segment's payload after a build and after a load).
The background build scheduler, the LRU index cache, persistence
(fts_indexes.json among it) and replication are ROADMAP queue 1 #10 and
#13. Versioned engines, mutations and merges are not ported yet (ROADMAP
queue 1).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import Settings
from ..errors import IndexBuildCanceledError, IndexBuildMemoryError, IndexParameterError, SchemaError
from ..index import binary, hnsw, ivf  # noqa: F401  (register the index kinds)
from ..index import registry
from ..index.base import IndexDescription, IndexKind, IndexStatus, VectorIndex
from ..metrics import Metric
from ..search.executor import SearchResult, VectorSearchExecutor
from ..search.filters import Expr
from ..service.event_log import GLOBAL_COUNTERS, GLOBAL_QUERY_LOG, EventLog, EventType
from ..service.tracing import span
from .hbm import device_memory_stats
from .schema import BinaryVector, Schema
from .segment import Segment

_STORAGE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Index kinds the port cannot build, with the reason or the ROADMAP item
# that ports them.
_NOT_PORTED = {
    IndexKind.FLAT: "FLAT needs no index: every index-less segment is scanned exactly",
}


@dataclasses.dataclass
class IndexSlot:
    """Per-(segment, index) build state (VIWithColumnInPart analogue)."""

    status: IndexStatus
    instance: Optional[VectorIndex] = None
    # set to stop an in-flight build at the next chunk boundary
    cancel: threading.Event = dataclasses.field(default_factory=threading.Event)


class Table:
    def __init__(
        self,
        name: str,
        schema: Schema,
        settings: Optional[Settings] = None,
        *,
        device,
        engine: str = "MergeTree",
        event_log: Optional[EventLog] = None,
    ):
        if engine.strip().lower() != "mergetree":
            raise NotImplementedError(
                f"engine {engine!r}: only MergeTree is ported yet (versioned "
                "engines and FINAL are in ROADMAP queue 1 #3)"
            )
        self.name = name
        self.schema = schema
        self.settings = settings or Settings()
        self.device = torch.device(device)
        self.engine = "MergeTree"
        self._lock = threading.RLock()
        # serializes DELETEs against each other
        self._dml_lock = threading.RLock()
        self._segments: Dict[int, Segment] = {}
        self._next_segment_id = 0
        self._index_descs: Dict[str, IndexDescription] = {}
        self._slots: Dict[tuple, IndexSlot] = {}  # (segment_id, index_name)
        self._text_indexes: Dict[str, Any] = {}  # name -> TextIndexDefinition
        self.event_log = event_log if event_log is not None else EventLog()
        self._executor = VectorSearchExecutor(self)

    # ------------------------------------------------------------- ingest
    def insert(self, columns: Dict[str, Any]) -> int:
        """One insert = one immutable segment (one MergeTree part)."""
        tset = self.settings.table
        if tset.vector_storage_tier != "hbm":
            raise NotImplementedError(
                f"vector_storage_tier={tset.vector_storage_tier!r}: the host "
                "tier is not ported yet (ROADMAP queue 1 #9)"
            )
        if tset.storage_dtype not in _STORAGE_DTYPES:
            raise SchemaError(f"unsupported storage_dtype {tset.storage_dtype!r}")
        with self._lock:
            seg_id = self._next_segment_id
            self._next_segment_id += 1
        seg = Segment.from_columns(
            seg_id,
            self.schema,
            columns,
            device=self.device,
            alignment=tset.segment_row_alignment,
            storage_dtype=_STORAGE_DTYPES[tset.storage_dtype],
            server_settings=self.settings.server,
        )
        with self._lock:
            self._segments[seg_id] = seg
            descs = list(self._index_descs.values())
        for desc in descs:
            self._schedule_build(seg, desc)
        with self._lock:
            tdefs = list(self._text_indexes.values())
        for tdef in tdefs:
            tdef.on_new_segment(seg)
        GLOBAL_COUNTERS.bump("InsertedSegments")
        GLOBAL_COUNTERS.bump("InsertedRows", seg.n_rows)
        return seg_id

    def delete(self, filter: Expr) -> int:
        """Lightweight DELETE: set delete-bitmap bits on matching rows."""
        n = 0
        with self._dml_lock:
            for seg in self.live_segments():
                rows = np.nonzero(filter.evaluate(seg))[0]
                if len(rows):
                    n += seg.delete_rows(rows)
        GLOBAL_COUNTERS.bump("DeletedRows", n)
        return n

    # -------------------------------------------------------------- index
    def add_vector_index(
        self, name: str, column: str, type: str = "MSTG", **params
    ) -> IndexDescription:
        """ALTER TABLE ADD VECTOR INDEX analogue. Builds the index for every
        existing segment before it returns (synchronous builds)."""
        with self._lock:
            if name in self._index_descs:
                raise IndexParameterError(f"vector index {name!r} already exists")
            d = self._index_desc(column)
            if d is not None:
                raise IndexParameterError(f"column {column!r} already has vector index {d.name!r}")
        vtype = self.schema.require_vector(column)
        is_binary = isinstance(vtype, BinaryVector)
        if type.lower() == "default":
            # TYPE DEFAULT: the column's search type decides
            type = "BinaryMSTG" if is_binary else "MSTG"
        if (
            type.upper() == "MSTG"
            and "disk_mode" not in params
            and self.settings.table.default_mstg_disk_mode
        ):
            # the table-level default fills an omitted disk_mode
            params["disk_mode"] = int(self.settings.table.default_mstg_disk_mode)
        desc = registry.make_description(
            name,
            column,
            type,
            vtype.dim,
            is_binary_column=is_binary,
            default_metric=self._default_metric_name(is_binary),
            params=params,
            strict=self.settings.table.vector_index_parameter_check,
        )
        if desc.kind in _NOT_PORTED:
            raise NotImplementedError(
                f"index type {desc.kind.value} is not ported yet: {_NOT_PORTED[desc.kind]}"
            )
        if desc.params.get("disk_mode"):
            raise NotImplementedError(
                "MSTG disk_mode=1 (the host re-rank tier) is not ported yet (ROADMAP queue 1 #9)"
            )
        with self._lock:
            self._index_descs[name] = desc
            segs = list(self._segments.values())
        self.event_log.record(self.name, name, column, EventType.DEFINITION_CREATED)
        for seg in segs:
            self._schedule_build(seg, desc)
        return desc

    def drop_vector_index(self, name: str) -> None:
        with self._lock:
            desc = self._index_descs.pop(name, None)
            if desc is None:
                raise IndexParameterError(f"no vector index named {name!r}")
            for key in [k for k in self._slots if k[1] == name]:
                # an in-flight build stops at its next chunk boundary
                self._slots[key].cancel.set()
                del self._slots[key]
        self.event_log.record(self.name, name, desc.column, EventType.DEFINITION_DROPPED)

    def _schedule_build(self, seg: Segment, desc: IndexDescription) -> None:
        key = (seg.segment_id, desc.name)
        tset = self.settings.table
        small = seg.n_rows < tset.min_rows_to_build_vector_index or (
            tset.min_bytes_to_build_vector_index > 0
            and seg.n_rows * desc.dim * 4 < tset.min_bytes_to_build_vector_index
        )
        with self._lock:
            self._slots[key] = IndexSlot(
                IndexStatus.SMALL_PART if small else IndexStatus.PENDING
            )
        if small:
            self.event_log.record(
                self.name, desc.name, desc.column, EventType.WILL_NOT_BUILD,
                segment_id=seg.segment_id,
            )
            return
        self._build_one(seg, desc)

    def _build_one(self, seg: Segment, desc: IndexDescription) -> None:
        key = (seg.segment_id, desc.name)
        with self._lock:
            slot = self._slots.get(key)
            if slot is None or slot.status not in (IndexStatus.PENDING, IndexStatus.ERROR):
                return
            slot.status = IndexStatus.BUILDING
        self.event_log.record(
            self.name, desc.name, desc.column, EventType.BUILD_START,
            segment_id=seg.segment_id,
        )
        t0 = time.time()

        def _canceled() -> bool:
            if slot.cancel.is_set():
                return True
            with self._lock:  # index dropped (slot replaced or removed)
                return self._slots.get(key) is not slot

        try:
            impl = registry.implementation(desc.kind)
            payload = seg.vector(desc.column)
            self._check_build_memory(
                impl.estimate_build_bytes(payload, seg.n_rows, desc.params)
            )
            with span("index_build", table=self.name, index=desc.name,
                      kind=desc.kind.value, segment=seg.segment_id, rows=seg.n_rows):
                instance = impl.build(
                    payload,
                    seg.n_rows,
                    metric=desc.metric,
                    dim=desc.dim,
                    params=desc.params,
                    settings=self.settings,
                    cancel_cb=_canceled,
                )
            elapsed = time.time() - t0
            self._reattach(instance, seg, desc)
            with self._lock:
                if self._slots.get(key) is not slot:  # index dropped mid-build
                    return
                slot.instance = instance
                slot.status = IndexStatus.LOADED
            self.event_log.record(
                self.name, desc.name, desc.column, EventType.BUILD_SUCCEED,
                segment_id=seg.segment_id, elapsed_s=elapsed,
            )
            GLOBAL_COUNTERS.bump("VectorIndexBuilds")
        except IndexBuildCanceledError:
            GLOBAL_COUNTERS.bump("VectorIndexBuildCancels")
            self.event_log.record(
                self.name, desc.name, desc.column, EventType.BUILD_CANCELED,
                segment_id=seg.segment_id,
            )
        except Exception as e:  # noqa: BLE001 — the status machine records it
            # a build that does not fit the budget fails here too: the
            # retry after evicting cached indexes waits for the LRU cache
            # (ROADMAP queue 1 #10)
            GLOBAL_COUNTERS.bump("VectorIndexBuildFailEvents")
            msg = f"{type(e).__name__}: {e}"
            with self._lock:
                if self._slots.get(key) is slot:
                    slot.status = IndexStatus.ERROR
            self.event_log.record(
                self.name, desc.name, desc.column, EventType.BUILD_ERROR,
                segment_id=seg.segment_id, error=msg,
            )

    @staticmethod
    def _reattach(instance: VectorIndex, seg: Segment, desc: IndexDescription) -> None:
        """Point a two-stage index's exact re-rank at its segment's own
        payload (a reference: the index never owns or serializes it)."""
        if hasattr(instance, "reattach_payload"):
            instance.reattach_payload(seg.vector(desc.column))

    def load_index(self, name: str, segment_id: int, state: Dict[str, Any]) -> VectorIndex:
        """Install index `name` of one segment from a `state_dict()` (the
        port's or the JAX package's layout) in place of a build: the load
        path. The index moves to the table's device and a two-stage index
        re-attaches the segment's payload. Returns the loaded instance."""
        from .convert import index_from_state_dict

        with self._lock:
            desc = self._index_descs.get(name)
            seg = self._segments.get(segment_id)
        if desc is None or seg is None:
            raise IndexParameterError(f"no vector index {name!r} on segment {segment_id}")
        if state["meta"]["kind"] != desc.kind.value:
            raise IndexParameterError(
                f"state of a {state['meta']['kind']} index cannot load as {desc.kind.value}"
            )
        self.event_log.record(
            self.name, name, desc.column, EventType.LOAD_START, segment_id=segment_id
        )
        instance = index_from_state_dict(state, self.device, seg.vector(desc.column))
        self._reattach(instance, seg, desc)
        with self._lock:
            self._slots[(segment_id, name)] = IndexSlot(IndexStatus.LOADED, instance)
        self.event_log.record(
            self.name, name, desc.column, EventType.LOAD_SUCCEED, segment_id=segment_id
        )
        return instance

    def _check_build_memory(self, estimate_bytes: int) -> None:
        """Raise IndexBuildMemoryError when the build would not fit the
        budget: `build_memory_limit_bytes`, or ratio x the device's memory
        with the live use added (a device without memory stats, the CPU,
        skips the check)."""
        srv = self.settings.server
        limit = srv.build_memory_limit_bytes
        if limit is None:
            stats = device_memory_stats(self.device)
            if stats is None:
                return
            in_use, cap = stats
            limit = int(cap * srv.vector_index_build_size_ratio_of_memory)
            if in_use + estimate_bytes <= cap and estimate_bytes <= limit:
                return
            raise IndexBuildMemoryError(
                f"index build needs ~{estimate_bytes >> 20} MiB "
                f"(in_use {in_use >> 20} MiB, budget {limit >> 20} MiB)"
            )
        if estimate_bytes > limit:
            raise IndexBuildMemoryError(
                f"index build needs ~{estimate_bytes >> 20} MiB > budget {limit >> 20} MiB"
            )

    def index_status(self, name: str) -> Dict[int, IndexStatus]:
        """segment id -> IndexStatus of index `name` (system.vector_indices'
        per-part status)."""
        with self._lock:
            return {sid: s.status for (sid, n), s in self._slots.items() if n == name}

    def wait_index_built(self, timeout: float = 300.0) -> bool:
        """True: builds run on the caller's thread, so every build has
        ended when add_vector_index or insert returns. (The JAX package's
        call; it waits once builds run in the background, ROADMAP queue 1
        #10.)"""
        return True

    # ----------------------------------------------------------------- fts
    def add_fts_index(self, name: str, columns, params: Optional[Dict[str, Any]] = None):
        """INDEX name(col, ...) TYPE fts('{json}') analogue. Builds a store
        for every existing segment now, and for every later segment at
        insert time, on the caller's thread."""
        from ..search.text_executor import TextIndexDefinition

        if isinstance(columns, str):
            columns = [columns]
        for c in columns:
            t = self.schema.require(c)
            if t.name != "String":
                raise SchemaError(f"fts index requires String columns, {c} is {t}")
        with self._lock:
            if name in self._text_indexes:
                raise IndexParameterError(f"fts index {name!r} already exists")
            tdef = TextIndexDefinition(name, columns, params)
            self._text_indexes[name] = tdef
        for seg in self.live_segments():
            tdef.on_new_segment(seg)
        self.event_log.record(self.name, name, ",".join(columns), EventType.DEFINITION_CREATED)
        return tdef

    def drop_fts_index(self, name: str) -> None:
        with self._lock:
            tdef = self._text_indexes.pop(name, None)
        if tdef is None:
            raise IndexParameterError(f"no fts index named {name!r}")
        self.event_log.record(self.name, name, ",".join(tdef.columns), EventType.DEFINITION_DROPPED)

    def has_token(self, column: str, token: str) -> Expr:
        """hasToken(col, 'tok') predicate, accelerated by the fts index
        when one covers the column; tokenize-and-scan otherwise."""
        from ..search.text_executor import fts_token_filter

        return fts_token_filter(self, column, token)

    def like(self, column: str, pattern: str, negate: bool = False) -> Expr:
        """col [NOT] LIKE pattern, fts-accelerated: whole inner tokens of
        the pattern cut the candidate set, the real LIKE verifies."""
        from ..search.text_executor import fts_like_filter

        return fts_like_filter(self, column, pattern, negate)

    def multi_search_any(self, column: str, needles) -> Expr:
        """multiSearchAny(col, needles): substring-any, fts-accelerated."""
        from ..search.text_executor import fts_multi_search_any

        return fts_multi_search_any(self, column, list(needles))

    def has_phrase(self, column: str, phrase: str) -> Expr:
        """Phrase predicate: the phrase's tokens appear adjacent in order."""
        from ..search.text_executor import fts_phrase_filter

        return fts_phrase_filter(self, column, phrase)

    def has_token_matching(self, column: str, regex: str) -> Expr:
        """Regex term predicate: some token of the row matches the regex."""
        from ..search.text_executor import fts_regex_filter

        return fts_regex_filter(self, column, regex)

    def text_search(
        self,
        column_or_index: str,
        query,
        k: Optional[int] = None,
        *,
        filter: Optional[Expr] = None,
        operator: str = "OR",
        stats_override=None,
        final: bool = False,
        enable_nlq: bool = False,
        settings: Optional[Settings] = None,
    ) -> SearchResult:
        """textsearch()(col, 'query') analogue: BM25 top-k, descending. A
        list of strings is a batch. enable_nlq activates the
        natural-language subset: quoted phrases must match adjacently,
        '-term' excludes."""
        from ..search.text_executor import TextSearchExecutor

        t0 = time.time()
        if final:
            raise SchemaError("FINAL requires a Replacing/Collapsing engine table")
        st = settings or self.settings
        res = TextSearchExecutor(self).run(
            column_or_index, query, k, filter=filter, operator=operator,
            stats_override=stats_override, enable_nlq=enable_nlq, settings=st,
        )
        self._log_query("text_search", column_or_index, res.nq, res.k, t0)
        return res

    def hybrid_search(
        self,
        vector_column: str,
        text_column: str,
        vector_query,
        text_query,
        k: Optional[int] = None,
        *,
        fusion_type: str = "rsf",
        fusion_weight: Optional[float] = None,
        fusion_k: Optional[int] = None,
        filter: Optional[Expr] = None,
        operator: str = "OR",
        params: Optional[Dict[str, Any]] = None,
        final: bool = False,
        settings: Optional[Settings] = None,
    ) -> SearchResult:
        """hybridsearch('fusion_type=...')(vec, text, [q], 'text') analogue."""
        from ..search.text_executor import HybridSearchExecutor

        t0 = time.time()
        if final:
            raise SchemaError("FINAL requires a Replacing/Collapsing engine table")
        res = HybridSearchExecutor(self).run(
            vector_column, text_column, vector_query, text_query, k,
            fusion_type=fusion_type, fusion_weight=fusion_weight, fusion_k=fusion_k,
            filter=filter, operator=operator, params=params, settings=settings or self.settings,
        )
        self._log_query("hybrid_search", vector_column, res.nq, res.k, t0)
        return res

    def _log_query(self, kind: str, column: str, nq: int, k: int, t0: float) -> None:
        GLOBAL_QUERY_LOG.record(
            kind, table=self.name, column=column, nq=nq, k=k, rows_read=self.n_rows,
            duration_ms=(time.time() - t0) * 1e3,
        )

    def loaded_index(self, segment_id: int, column: str, metric: Metric):
        """The built index of `column` for one segment, when its metric is
        the one searched; else None (the segment is scanned)."""
        with self._lock:
            for desc in self._index_descs.values():
                if desc.column != column or desc.metric != metric:
                    continue
                slot = self._slots.get((segment_id, desc.name))
                if slot is not None and slot.instance is not None:
                    return slot.instance
        return None

    def _index_desc(self, column: str) -> Optional[IndexDescription]:
        """The vector index defined on `column` (at most one), or None."""
        with self._lock:
            return next((d for d in self._index_descs.values() if d.column == column), None)

    def _default_metric_name(self, binary: bool) -> str:
        tset = self.settings.table
        return tset.binary_vector_search_metric_type if binary else tset.float_vector_search_metric_type

    def index_metric_for(self, column: str) -> Metric:
        """Metric used for a column: its index's metric, else the table
        default (float_ or binary_vector_search_metric_type)."""
        desc = self._index_desc(column)
        if desc is not None:
            return desc.metric
        binary = isinstance(self.schema.require_vector(column), BinaryVector)
        return Metric.parse(self._default_metric_name(binary), binary=binary)

    # -------------------------------------------------------------- search
    def search(
        self,
        column: str,
        query,
        k: Optional[int] = None,
        *,
        filter: Optional[Expr] = None,
        params: Optional[Dict[str, Any]] = None,
        metric: Optional[str] = None,
        two_stage: Optional[bool] = None,
        settings: Optional[Settings] = None,
    ) -> SearchResult:
        """distance()/batch_distance() analogue: top-k nearest rows.

        A [D] query is one search; an [Q, D] batch is the batch_distance
        semantics (per-query top-k)."""
        t0 = time.time()
        m = None
        if metric is not None:
            vtype = self.schema.require_vector(column)
            m = Metric.parse(metric, binary=isinstance(vtype, BinaryVector))
        desc = self._index_desc(column) if params else None
        if desc is not None:
            registry.validate_search_params(desc.kind, params)
        res = self._executor.run(
            column,
            query,
            k,
            filter=filter,
            params=params,
            metric=m,
            settings=settings or self.settings,
            two_stage=two_stage,
        )
        k_eff = int(k if k is not None else (settings or self.settings).query.default_topk)
        self._log_query("vector_search", column, res.nq, k_eff, t0)
        return res

    def gather(self, result: SearchResult, columns: List[str]) -> Dict[str, np.ndarray]:
        """Fetch output columns for result hits (the 'read only top-k rows'
        stage). Returns [Q, k] object/num arrays; missing slots get type
        defaults."""
        out: Dict[str, np.ndarray] = {}
        segs = {s.segment_id: s for s in self.live_segments()}
        for cname in columns:
            ctype = self.schema.require(cname)
            is_vec = cname in self.schema.vector_columns()
            if is_vec or ctype.np_dtype == np.dtype(object):
                arr = np.full(result.rows.shape, None, dtype=object)
                if not is_vec:
                    arr[:] = ""
            else:
                arr = np.zeros(result.rows.shape, dtype=ctype.np_dtype)
            for sid, seg in segs.items():
                sel = (result.segments == sid) & (result.rows >= 0)
                if not sel.any():
                    continue
                if is_vec:
                    vals = seg.vector_rows(cname, result.rows[sel])
                    lst = np.empty(len(vals), dtype=object)
                    lst[:] = [list(v) for v in vals]
                    arr[sel] = lst
                else:
                    arr[sel] = seg.scalar(cname)[result.rows[sel]]
            out[cname] = arr
        return out

    # --------------------------------------------------------------- admin
    def live_segments(self) -> List[Segment]:
        with self._lock:
            return list(self._segments.values())

    @property
    def n_rows(self) -> int:
        return sum(s.num_live for s in self.live_segments())
