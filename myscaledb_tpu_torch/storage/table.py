"""Table: segments, vector indexes and the search entry points.

Counterpart of myscaledb_tpu/storage/table.py:

  * insert  -> new immutable segment (INSERT = new part), searchable by
    exact scan immediately; every vector index of the table is scheduled
    for it (or marked a small part)
  * add_vector_index / drop_vector_index -> the per-(segment, index)
    lifecycle (IndexStatus slots, event log, counters), built on the
    database's build scheduler (fast / slow pools) or, for a table without
    one, on the caller's thread; a build that does not fit the memory
    budget evicts cached indexes and retries
  * search  -> VectorSearchExecutor (pre-filter ∩ deletes, per-segment
    index search or exact scan, global top-k merge); `final=True` re-reads
    the candidates through a versioned engine's merging algorithm
  * lightweight DELETE -> per-segment delete bitmaps intersected into
    every search; UPDATE of scalar columns in place; ADD / DROP COLUMN
  * merge -> live rows of the sources concatenated into one new segment,
    served through a DecoupledIndex over the sources' indexes until its
    own index is built; truncate
  * gather / compute_distances -> output columns and exact distances of
    the hits
  * add_fts_index -> an fts store per segment; text_search (BM25) and
    hybrid_search (RRF / RSF) through search/text_executor.py, and the
    fts-accelerated string predicates (has_token, like, ...) as filters
  * persist -> a checkpoint in the JAX package's on-disk format
    (storage/persistence.py); a persisted index comes back BUILT and
    reloads lazily on its first search, through the LRU index cache

  * replication hooks -> commit listeners called after each local commit
    (insert, mutate, deletes, merge with its row maps, truncate), through
    which service/data_replication.py publishes; a merge gate that defers
    merges to the replica set's leader (`force=True` bypasses it); and,
    with `build_vector_index_on_random_single_replica` and a `replica`
    context, one replica builds each (segment, index) and publishes it
    while the others fetch it (a shared directory or the HTTP exchange of
    service/exchange.py) and load it onto their own device

Every segment and index lives on the table's explicit `device`; a build
or an index fetch on a worker thread runs under that device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import Settings
from ..errors import IndexBuildCanceledError, IndexBuildMemoryError, IndexParameterError, SchemaError
from ..index import binary, hnsw, ivf  # noqa: F401  (register the index kinds)
from ..index import registry
from ..index.base import IndexDescription, IndexStatus, VectorIndex
from ..index.decoupled import DecoupledIndex
from ..metrics import Metric
from ..search.executor import SearchResult, VectorSearchExecutor
from ..search.program import ProgramCache
from ..search.filters import Expr
from ..service.event_log import GLOBAL_COUNTERS, GLOBAL_QUERY_LOG, EventLog, EventType
from ..service.tracing import span
from . import persistence
from .hbm import device_memory_stats
from .schema import BinaryVector, Schema, is_vector_type
from .segment import Segment

_STORAGE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

MAX_BUILD_RETRIES = 3  # maxBuildRetryCount (VIBuilderUpdater.cpp:639-657)

_ENGINES = {
    "merge": "MergeTree",
    "replacing": "Replacing",
    "collapsing": "Collapsing",
    "versionedcollapsing": "VersionedCollapsing",
}


@dataclasses.dataclass
class IndexSlot:
    """Per-(segment, index) build state (VIWithColumnInPart analogue)."""

    status: IndexStatus
    instance: Optional[VectorIndex] = None
    error: str = ""
    elapsed_s: float = 0.0
    retries: int = 0
    path: str = ""  # on-disk dir when persisted (the lazy reload's source)
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
        key_column: Optional[str] = None,
        version_column: Optional[str] = None,
        sign_column: Optional[str] = None,
        event_log: Optional[EventLog] = None,
        scheduler=None,
        index_cache=None,
        storage_dir: Optional[str] = None,
        remote_store=None,
        replica=None,
    ):
        self.name = name
        self.schema = schema
        self.settings = settings or Settings()
        self.device = torch.device(device)
        self.storage_dir = storage_dir
        self.remote_store = remote_store  # cold tier (storage_policy='remote')
        # service/replication.py::ReplicaContext when this table is one
        # replica of a set that builds each index once
        self.replica = replica
        # Versioned engines: rows sharing key_column supersede or cancel
        # each other; FINAL searches and merges re-read candidates through
        # the merging algorithm (performFinal, ReadWithHybridSearch.cpp:
        # 692-899):
        #   Replacing(ver):              winner = max version, then insertion order
        #   Collapsing(sign):            +1/-1 state/cancel pairs collapse per key
        #   VersionedCollapsing(sign,v): pairs collapse per (key, version)
        # Replicated* collapses onto the base engine.
        eng = engine.strip().lower().replace("mergetree", "") or "merge"
        eng = eng.replace("replicated", "") or "merge"
        if eng not in _ENGINES:
            raise SchemaError(f"unsupported engine {engine!r}")
        self.engine = _ENGINES[eng]
        if self.engine != "MergeTree":
            if key_column is None:
                raise SchemaError(f"{engine} requires an ORDER BY key column")
            schema.require(key_column)
            if version_column is not None:
                schema.require(version_column)
        if self.engine in ("Collapsing", "VersionedCollapsing"):
            if sign_column is None:
                raise SchemaError(f"{engine} requires a sign column")
            schema.require(sign_column)
        if self.engine == "VersionedCollapsing" and version_column is None:
            raise SchemaError(f"{engine} requires a version column")
        self.key_column = key_column
        self.version_column = version_column
        self.sign_column = sign_column
        self._winners_cache: Optional[tuple] = None
        self.event_log = event_log if event_log is not None else EventLog()
        self._scheduler = scheduler
        self._index_cache = index_cache
        self._lock = threading.RLock()
        # serializes DML (DELETE / UPDATE) against the merge swap, so a
        # mutation that lands mid-merge is re-applied to the merged segment
        self._dml_lock = threading.RLock()
        self._segments: Dict[int, Segment] = {}
        self._next_segment_id = 0
        self._index_descs: Dict[str, IndexDescription] = {}
        self._slots: Dict[tuple, IndexSlot] = {}  # (segment_id, index_name)
        self._text_indexes: Dict[str, Any] = {}  # name -> TextIndexDefinition
        self._executor = VectorSearchExecutor(self)
        # the search programs over this table's segments (one CUDA graph
        # each on the card); dropped whenever the segment set changes
        self._programs = ProgramCache()
        # the text searches' programs: dropped with the segment set too,
        # and by the fts definitions whenever a store changes
        self._text_programs = ProgramCache()
        # Commit listeners, called after a local commit (insert / deletes /
        # mutate / merge / truncate) outside the table's locks: the hook
        # data replication publishes through (the ReplicatedMergeTree
        # log-entry write, StorageReplicatedMergeTree.cpp:3183). A
        # listener must not mutate the table synchronously.
        self._commit_listeners: List[Any] = []
        # the traceback of the last listener that raised (the counter
        # CommitListenerErrors counts them)
        self.last_listener_error: Optional[str] = None
        # Merge gate: when set (by a ReplicatedNode), merge() defers to it
        # unless force=True: the leader-assigned merge (the reference's ZK
        # merge assignment)
        self.merge_gate: Optional[Any] = None

    @property
    def segment_version(self) -> int:
        """Moves on with every change of the segment set, its deletes, its
        filterable columns or its indexes (`_segments_changed`)."""
        return self._programs.version

    def _segments_changed(self) -> None:
        """Drop the cached search programs: a graph bakes in the tensors it
        reads and keeps them alive, so a dropped segment's or index's bytes
        would otherwise stay on the device, unseen by the memory governor.
        Called after every insert (and its spill), delete, UPDATE, ALTER,
        merge, truncate, index build, load, drop or cache eviction; the
        database calls it on DROP and DETACH."""
        self._programs.invalidate()
        self._text_programs.invalidate()

    def add_commit_listener(self, fn) -> None:
        self._commit_listeners.append(fn)

    def _notify_commit(self, op: str, **kw) -> None:
        for fn in list(self._commit_listeners):
            try:
                fn(self, op, **kw)
            except Exception:  # noqa: BLE001 — replication must not fail DML
                self.last_listener_error = traceback.format_exc()
                GLOBAL_COUNTERS.bump("CommitListenerErrors")

    # ------------------------------------------------------------- ingest
    def _new_segment(self, columns: Dict[str, Any]) -> Segment:
        tset = self.settings.table
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
            storage_tier=tset.vector_storage_tier,
            server_settings=self.settings.server,
        )
        for cname in sorted(seg.spilled_columns):
            # memory pressure moved this payload to the host tier: logged,
            # as the reference logs its cache events, instead of failing
            self.event_log.record(
                self.name, "", cname, EventType.TIER_SPILL, segment_id=seg_id
            )
        return seg

    def insert(self, columns: Dict[str, Any]) -> int:
        """One insert = one immutable segment (one MergeTree part)."""
        seg = self._new_segment(columns)
        with self._lock:
            self._segments[seg.segment_id] = seg
            descs = list(self._index_descs.values())
            tdefs = list(self._text_indexes.values())
        self._segments_changed()
        for desc in descs:
            self._schedule_build(seg, desc)
        for tdef in tdefs:
            # off the insert's critical path; a search that arrives first
            # builds the store on demand
            tdef.on_new_segment(seg, scheduler=self._scheduler)
        GLOBAL_COUNTERS.bump("InsertedSegments")
        GLOBAL_COUNTERS.bump("InsertedRows", seg.n_rows)
        self._notify_commit("insert", segment=seg)
        return seg.segment_id

    def update(self, filter: Expr, assignments: Dict[str, Any]) -> int:
        """Mutation (ALTER TABLE ... UPDATE col = v WHERE ...). Scalar
        columns mutate in place and vector indexes are inherited, the
        reference's rule for mutations that keep the vector column intact
        (MutateTask.cpp:840-842, :1395-1415); a vector column cannot be
        UPDATEd (delete and re-insert). A value may be a function of the
        column's old values."""
        for cname in assignments:
            if is_vector_type(self.schema.require(cname)):
                raise SchemaError(
                    f"cannot UPDATE vector column {cname!r}; delete and "
                    "re-insert the rows (index inheritance only covers "
                    "mutations that keep the vector column intact)"
                )
        n = 0
        touched = []
        with self._dml_lock:
            for seg in self.live_segments():
                m = filter.evaluate(seg) & ~seg.deleted_host()[: seg.n_rows]
                rows = np.nonzero(m)[0]
                if not len(rows):
                    continue
                for cname, value in assignments.items():
                    col = seg.scalar(cname)
                    col[rows] = value(col[rows]) if callable(value) else value
                # the filter caches and the device mirrors of scalar
                # columns key on the generation
                seg.mutation_generation += 1
                # an fts index over a mutated column is rebuilt for the segment
                for tdef in list(self._text_indexes.values()):
                    if any(c in tdef.columns for c in assignments):
                        tdef.on_new_segment(seg)
                n += len(rows)
                touched.append(seg)
        if touched:
            self._segments_changed()
        GLOBAL_COUNTERS.bump("MutatedRows", n)
        for seg in touched:
            self._notify_commit("mutate", segment=seg)
        return n

    def delete(self, filter: Expr) -> int:
        """Lightweight DELETE: set delete-bitmap bits on matching rows."""
        n = 0
        touched = []
        with self._dml_lock:
            for seg in self.live_segments():
                rows = np.nonzero(filter.evaluate(seg))[0]
                if len(rows):
                    n += seg.delete_rows(rows)
                    touched.append(seg)
                    for tdef in list(self._text_indexes.values()):
                        tdef.on_deletes(seg)
        if touched:
            self._segments_changed()
        GLOBAL_COUNTERS.bump("DeletedRows", n)
        for seg in touched:
            self._notify_commit("deletes", segment=seg)
        return n

    def add_column(self, name: str, coltype, default=None) -> None:
        """ALTER TABLE ADD COLUMN (scalar columns only): existing segments
        get the default value (an instant metadata change materialized
        with a default, as in the reference)."""
        if is_vector_type(coltype):
            raise SchemaError(
                "ADD COLUMN supports scalar columns; create a new table "
                "for additional vector columns"
            )
        with self._lock:
            if name in self.schema.columns:
                raise SchemaError(f"column {name!r} already exists")
            if not name.isidentifier():
                raise SchemaError(f"bad column name {name!r}")
            fill = default
            if fill is None:
                fill = "" if coltype.np_dtype == np.dtype(object) else 0
            fill = coltype.validate(np.array([fill]))[0]
            for seg in self._segments.values():
                seg.scalars[name] = np.full(seg.n_rows, fill, dtype=coltype.np_dtype)
                seg.mutation_generation += 1
            self.schema.columns[name] = coltype
            self._winners_cache = None
        self._segments_changed()

    def drop_column(self, name: str) -> None:
        """ALTER TABLE DROP COLUMN (scalar, not an engine column, not under
        an fts index)."""
        with self._lock:
            if name not in self.schema.columns:
                raise SchemaError(f"no such column: {name}")
            if is_vector_type(self.schema.columns[name]):
                raise SchemaError("cannot drop a vector column")
            if name in (self.key_column, self.version_column, self.sign_column):
                raise SchemaError(f"column {name!r} is an engine column")
            for tdef in self._text_indexes.values():
                if name in tdef.columns:
                    raise SchemaError(
                        f"column {name!r} is covered by fts index; drop the index first"
                    )
            del self.schema.columns[name]
            for seg in self._segments.values():
                seg.scalars.pop(name, None)
                seg.mutation_generation += 1
            self._winners_cache = None
        self._segments_changed()

    # -------------------------------------------------------------- index
    def add_vector_index(
        self, name: str, column: str, type: str = "MSTG", **params
    ) -> IndexDescription:
        """ALTER TABLE ADD VECTOR INDEX analogue: a build is scheduled for
        every existing segment (wait_index_built() waits for them)."""
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
        if self._index_cache is not None:
            self._index_cache.expire_prefix((self.name, name))
        self._segments_changed()
        self.event_log.record(self.name, name, desc.column, EventType.DEFINITION_DROPPED)

    def _is_small(self, n_rows: int, desc: IndexDescription) -> bool:
        tset = self.settings.table
        return n_rows < tset.min_rows_to_build_vector_index or (
            tset.min_bytes_to_build_vector_index > 0
            and n_rows * desc.dim * 4 < tset.min_bytes_to_build_vector_index
        )

    def _submit(self, job, *, slow: bool = False) -> None:
        """Run a build job on the scheduler (the slow pool for parts above
        max_rows_for_slow_mode_single_vector_index_build), under this
        table's device; without a scheduler, now."""
        if self._scheduler is None:
            job()
            return
        dev = self.device

        def on_device():
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    job()
            else:
                job()

        self._scheduler.submit(on_device, slow=slow)

    def _schedule_build(self, seg: Segment, desc: IndexDescription) -> None:
        key = (seg.segment_id, desc.name)
        small = self._is_small(seg.n_rows, desc)
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
        slow = seg.n_rows > self.settings.table.max_rows_for_slow_mode_single_vector_index_build
        if self._replicated_build() and not self.replica.i_build(
            self.name, seg.segment_id, desc.name
        ):
            # another replica builds this one: fetch its files
            self._submit(lambda: self._fetch_replica_index(seg, desc), slow=slow)
        else:
            self._submit(lambda: self._build_one(seg, desc), slow=slow)

    def _replicated_build(self) -> bool:
        """One replica of the set builds each (segment, index), the others
        fetch it (build_vector_index_on_random_single_replica)."""
        return bool(
            self.replica is not None
            and self.settings.table.build_vector_index_on_random_single_replica
            and self.storage_dir
        )

    def _build_one(self, seg: Segment, desc: IndexDescription) -> None:
        key = (seg.segment_id, desc.name)
        with self._lock:
            slot = self._slots.get(key)
            if slot is None or slot.status not in (IndexStatus.PENDING, IndexStatus.ERROR):
                return
            # a serving (decoupled) instance stays live while this builds
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
            self._reattach(instance, seg, desc)
            if self.device.type == "cuda":
                # a search on another thread may take the index next
                torch.cuda.current_stream(self.device).synchronize()
            elapsed = time.time() - t0
            with self._lock:
                if self._slots.get(key) is not slot:  # index dropped mid-build
                    return
                slot.instance = instance
                slot.status = IndexStatus.LOADED
                slot.elapsed_s = elapsed
                slot.error = ""
            self._segments_changed()
            if self._index_cache is not None:
                self._index_cache.put(
                    (self.name, desc.name, seg.segment_id), instance, instance.memory_bytes
                )
            if self._replicated_build():
                self._publish_index(seg.segment_id, desc.name, instance)
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
        except IndexBuildMemoryError as e:
            self._build_failed(key, seg, desc, str(e), retryable=True)
        except Exception as e:  # noqa: BLE001 — the status machine records it
            # a device OOM mid-build (pressure the estimate could not see)
            # is as retryable as a budget miss: the retry evicts first
            self._build_failed(
                key, seg, desc, f"{type(e).__name__}: {e}",
                retryable=isinstance(e, torch.cuda.OutOfMemoryError),
            )

    def _build_failed(self, key, seg, desc, msg: str, retryable: bool = False) -> None:
        """ERROR status and event; a retryable failure (memory) evicts LRU
        cache entries worth the build's estimate, then builds again, up to
        MAX_BUILD_RETRIES attempts (VIBuilderUpdater.cpp:639-657)."""
        GLOBAL_COUNTERS.bump("VectorIndexBuildFailEvents")
        with self._lock:
            slot = self._slots.get(key)
            if slot is None:
                return
            slot.status = IndexStatus.ERROR
            slot.error = msg
            slot.retries += 1
            retry = retryable and slot.retries < MAX_BUILD_RETRIES
        self.event_log.record(
            self.name, desc.name, desc.column, EventType.BUILD_ERROR,
            segment_id=seg.segment_id, error=msg,
        )
        if not retry:
            return
        if self._index_cache is not None:
            impl = registry.implementation(desc.kind)
            est = impl.estimate_build_bytes(seg.vector(desc.column), seg.n_rows, desc.params)
            self._index_cache.shrink_by(est)
        with self._lock:
            slot.status = IndexStatus.PENDING
        self._submit(lambda: self._build_one(seg, desc))

    def _publish_index(self, segment_id: int, index_name: str, instance) -> None:
        """Builder replica: write the index into the store at once, so its
        peers can fetch it (the DataPartsExchange upload side)."""
        from ..service.replication import index_dir

        path = index_dir(self.storage_dir, segment_id, index_name)
        try:
            persistence.save_index(instance, path)
        except NotImplementedError:
            return  # a transient index kind is not publishable
        with self._lock:
            slot = self._slots.get((segment_id, index_name))
            if slot is not None:
                slot.path = path

    def _fetch_replica_index(self, seg: Segment, desc: IndexDescription) -> None:
        """Non-builder replica: wait for the builder's files (its HTTP
        exchange with `replica.peers`, else the shared store) and load them
        onto this table's device (the DataPartsExchange download side). A
        fetch that never lands, or does not load, builds locally (the
        reference's fallback)."""
        from ..service.exchange import fetch_index
        from ..service.replication import pick_build_replica, wait_for_peer_index

        key = (seg.segment_id, desc.name)
        rep = self.replica
        if rep.peers is not None:
            builder = pick_build_replica(self.name, seg.segment_id, desc.name, rep.n_replicas)
            url = rep.peers[builder]
            path = fetch_index(
                url, self.name, seg.segment_id, desc.name, self.storage_dir,
                timeout_s=rep.fetch_timeout_s, poll_interval_s=rep.poll_interval_s,
            ) if url else None
        else:
            path = wait_for_peer_index(self.storage_dir, seg.segment_id, desc.name, rep)
        if path is None:
            GLOBAL_COUNTERS.bump("ReplicatedPartVectorIndexFailedFetches")
            self._build_one(seg, desc)
            return
        try:
            inst = persistence.load_index(path, self.device, seg.vector(desc.column))
            if inst is None:  # FLAT: the segment payload is the index
                self._build_one(seg, desc)
                return
            self._reattach(inst, seg, desc)
            if self.device.type == "cuda":
                # a search on another thread may take the index next
                torch.cuda.current_stream(self.device).synchronize()
            with self._lock:
                slot = self._slots.get(key)
                if slot is None:  # index dropped meanwhile
                    return
                slot.instance = inst
                slot.status = IndexStatus.LOADED
                slot.path = path
            self._segments_changed()
            if self._index_cache is not None:
                self._index_cache.put(
                    (self.name, desc.name, seg.segment_id), inst, inst.memory_bytes
                )
            GLOBAL_COUNTERS.bump("ReplicatedPartVectorIndexFetches")
            self.event_log.record(
                self.name, desc.name, desc.column, EventType.LOAD_SUCCEED,
                segment_id=seg.segment_id,
            )
        except Exception as e:  # noqa: BLE001 — a bad fetch builds locally
            GLOBAL_COUNTERS.bump("ReplicatedPartVectorIndexFailedFetches")
            with self._lock:
                slot = self._slots.get(key)
                if slot is not None:
                    slot.error = f"fetch: {type(e).__name__}: {e}"
            self._build_one(seg, desc)

    @staticmethod
    def _reattach(instance: VectorIndex, seg: Segment, desc: IndexDescription) -> None:
        """Point a two-stage index's exact re-rank at its segment's own
        payload (a reference: the index never owns or serializes it)."""
        if hasattr(instance, "reattach_payload"):
            instance.reattach_payload(seg.vector(desc.column))

    def load_index(self, name: str, segment_id: int, state: Dict[str, Any]) -> VectorIndex:
        """Install index `name` of one segment from a `state_dict()` (the
        port's or the JAX package's layout) in place of a build. The index
        moves to the table's device and a two-stage index re-attaches the
        segment's payload. Returns the loaded instance."""
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
        self._segments_changed()
        if self._index_cache is not None:
            self._index_cache.put((self.name, name, segment_id), instance, instance.memory_bytes)
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
        """Block until no slot is PENDING or BUILDING; False on timeout."""
        deadline = time.time() + timeout
        while True:
            with self._lock:
                busy = any(
                    s.status in (IndexStatus.PENDING, IndexStatus.BUILDING)
                    for s in self._slots.values()
                )
            if not busy:
                return True
            if time.time() >= deadline:
                return False
            time.sleep(0.02)

    def loaded_index(self, segment_id: int, column: str, metric: Metric):
        """The index of `column` for one segment, when its metric is the
        one searched: the loaded (or decoupled) instance, or a persisted
        one reloaded now; else None (the segment is scanned)."""
        reloaded = None
        with self._lock:
            for desc in self._index_descs.values():
                if desc.column != column or desc.metric != metric:
                    continue
                slot = self._slots.get((segment_id, desc.name))
                if slot is None:
                    continue
                if slot.instance is not None:
                    if slot.status == IndexStatus.LOADED and self._index_cache is not None:
                        self._index_cache.get((self.name, desc.name, segment_id))
                    return slot.instance
                if slot.status == IndexStatus.BUILT and slot.path:
                    reloaded = (desc.name, self._reload_index(segment_id, desc, slot))
                    break
        if reloaded is None or reloaded[1] is None:
            return None
        name, inst = reloaded
        if self._index_cache is not None:
            # outside the lock: an eviction it causes calls back into a
            # table's lock, possibly another table's
            self._index_cache.put((self.name, name, segment_id), inst, inst.memory_bytes)
        return inst

    def peek_index(self, segment_id: int, column: str, metric: Metric):
        """Like loaded_index, but never loads from disk and never touches
        the LRU cache (read-only introspection such as EXPLAIN)."""
        with self._lock:
            for desc in self._index_descs.values():
                if desc.column != column or desc.metric != metric:
                    continue
                slot = self._slots.get((segment_id, desc.name))
                if slot is not None and slot.instance is not None:
                    return slot.instance
        return None

    def _reload_index(self, segment_id: int, desc: IndexDescription, slot: IndexSlot):
        """Lazy reload of a persisted index after a restart or an eviction
        (loadVectorIndexFromLocalFile analogue). The caller holds the
        lock, and puts the instance into the index cache after releasing
        it."""
        t0 = time.time()
        self.event_log.record(
            self.name, desc.name, desc.column, EventType.LOAD_START, segment_id=segment_id
        )
        seg = self._segments.get(segment_id)
        if seg is None:
            return None
        try:
            payload = seg.vector(desc.column)
            inst = persistence.load_index(slot.path, self.device, payload)
            if inst is None:  # FLAT: rebuilt from the segment payload
                inst = registry.implementation(desc.kind).build(
                    payload, seg.n_rows, metric=desc.metric, dim=desc.dim,
                    params=desc.params, settings=self.settings,
                )
            self._reattach(inst, seg, desc)
            slot.instance = inst
            slot.status = IndexStatus.LOADED
            self.event_log.record(
                self.name, desc.name, desc.column, EventType.LOAD_SUCCEED,
                segment_id=segment_id, elapsed_s=time.time() - t0,
            )
            GLOBAL_COUNTERS.bump("VectorIndexLoads")
            return inst
        except Exception as e:  # noqa: BLE001 — the status machine records it
            GLOBAL_COUNTERS.bump("VectorIndexLoadFailEvents")
            slot.status = IndexStatus.ERROR
            slot.error = f"load: {type(e).__name__}: {e}"
            self.event_log.record(
                self.name, desc.name, desc.column, EventType.LOAD_ERROR,
                segment_id=segment_id, error=slot.error,
            )
            return None

    def on_cache_evict(self, index_name: str, segment_id: int) -> None:
        """LRU eviction: a persisted index drops its tensors and demotes to
        BUILT (reloadable); an unpersisted one stays LOADED (nothing to
        reload it from)."""
        with self._lock:
            slot = self._slots.get((segment_id, index_name))
            if slot is None or slot.status != IndexStatus.LOADED or not slot.path:
                return
            slot.instance = None
            slot.status = IndexStatus.BUILT
            desc = self._index_descs.get(index_name)
        self._segments_changed()
        if desc is not None:
            self.event_log.record(
                self.name, index_name, desc.column, EventType.CACHE_EXPIRE,
                segment_id=segment_id,
            )

    # ------------------------------------------------------------ persist
    def persist(self, directory: Optional[str] = None) -> str:
        """Write the schema, every segment and every built index to
        storage_dir (a checkpoint; restart = Database.load_table), in the
        JAX package's format. `directory` overrides the destination (a
        backup: the slots' reload paths keep pointing at storage_dir)."""
        if not directory and not self.storage_dir:
            raise SchemaError(f"table {self.name!r} has no storage_dir")
        root = directory or self.storage_dir
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "schema.json"), "w") as f:
            json.dump(
                {
                    "columns": persistence.schema_to_json(self.schema),
                    "engine": {
                        "name": self.engine,
                        "key_column": self.key_column,
                        "version_column": self.version_column,
                        "sign_column": self.sign_column,
                    },
                },
                f,
            )
        with self._lock:
            segs = list(self._segments.values())
            descs = dict(self._index_descs)
        for seg in segs:
            segdir = os.path.join(root, f"segment_{seg.segment_id}")
            persistence.save_segment(seg, segdir)
            for name in descs:
                with self._lock:
                    slot = self._slots.get((seg.segment_id, name))
                    inst = slot.instance if slot else None
                    spath = slot.path if slot else ""
                if slot is None or isinstance(inst, DecoupledIndex):
                    continue  # a decoupled index is transient: rebuilt on load
                idir = os.path.join(segdir, f"index_{name}")
                if inst is not None:
                    persistence.save_index(inst, idir)
                    if directory is None:
                        # the canonical checkpoint: lazy reloads point here
                        with self._lock:
                            slot.path = idir
                elif (
                    slot.status == IndexStatus.BUILT
                    and spath
                    and os.path.isdir(spath)
                    and os.path.abspath(spath) != os.path.abspath(idir)
                ):
                    # BUILT but not loaded (after a restart or an eviction):
                    # copy its files, or a restore would rebuild it
                    shutil.copytree(spath, idir, dirs_exist_ok=True)
        # stale segment_* dirs (TRUNCATE, merge) would resurrect rows on load
        keep = {f"segment_{seg.segment_id}" for seg in segs}
        for entry in os.listdir(root):
            if entry.startswith("segment_") and entry not in keep:
                shutil.rmtree(os.path.join(root, entry), ignore_errors=True)
        with open(os.path.join(root, "indexes.json"), "w") as f:
            json.dump(
                {
                    name: {
                        "column": d.column,
                        "type": d.kind.value,
                        "metric": d.metric.value,
                        "params": d.params,
                        "declared_type": d.declared_type,
                        "definition": d.definition,
                    }
                    for name, d in descs.items()
                },
                f,
            )
        with self._lock:
            tdefs = dict(self._text_indexes)
        with open(os.path.join(root, "fts_indexes.json"), "w") as f:
            json.dump(
                {name: {"columns": d.columns, "params": d.params} for name, d in tdefs.items()},
                f,
            )
        # cold tier: sync the committed local tree up to the object store
        # (manifest last; unchanged files skipped by sha)
        if (
            directory is None
            and self.remote_store is not None
            and self.settings.table.storage_policy != "default"
        ):
            from .stores import sync_dir_to_store

            sync_dir_to_store(self.remote_store, f"tables/{self.name}", root)
        return root

    # ----------------------------------------------------------------- fts
    def add_fts_index(self, name: str, columns, params: Optional[Dict[str, Any]] = None):
        """INDEX name(col, ...) TYPE fts('{json}') analogue. Builds a store
        for every existing segment now, on the caller's thread; a later
        segment's store is built at insert time."""
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
            tdef.programs = self._text_programs
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
        self._text_programs.invalidate()
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

    def _require_versioned(self, final: bool) -> None:
        if final and self.engine == "MergeTree":
            raise SchemaError("FINAL requires a Replacing/Collapsing engine table")

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

        with span("table.text_search") as sp:
            self._require_versioned(final)
            st = settings or self.settings
            k_eff = int(k if k is not None else st.query.default_topk)
            res = TextSearchExecutor(self).run(
                column_or_index, query, self._final_fetch_k(k_eff, st) if final else k,
                filter=filter, operator=operator, stats_override=stats_override,
                enable_nlq=enable_nlq, settings=st,
            )
            if final:
                res = self._apply_final(res, k_eff)
            self._log_query("text_search", column_or_index, res.nq, k_eff, sp,
                            query_text=str(query)[:200])
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

        with span("table.hybrid_search") as sp:
            self._require_versioned(final)
            st = settings or self.settings
            k_eff = int(k if k is not None else st.query.default_topk)
            res = HybridSearchExecutor(self).run(
                vector_column, text_column, vector_query, text_query,
                self._final_fetch_k(k_eff, st) if final else k,
                fusion_type=fusion_type, fusion_weight=fusion_weight, fusion_k=fusion_k,
                filter=filter, operator=operator, params=params, settings=st,
            )
            if final:
                res = self._apply_final(res, k_eff)
            self._log_query("hybrid_search", vector_column, res.nq, k_eff, sp,
                            query_text=str(text_query)[:200])
            return res

    def _log_query(self, kind, column, nq, k, root: span, query_text="", error="") -> None:
        """One query-log row; its duration is the root span's so far."""
        GLOBAL_QUERY_LOG.record(
            kind, table=self.name, column=column, query_text=query_text, nq=nq, k=k,
            rows_read=self.n_rows, duration_ms=root.elapsed_ms(), error=error,
        )

    # ------------------------------------------------ versioned engines
    def _survivor_positions(self, allk, allv, allsgn) -> np.ndarray:
        """Positions (into the input arrays) of the rows that survive the
        engine's merging algorithm. The inputs are all candidate rows in
        insertion order (across segments)."""
        n = len(allk)
        order_ins = np.arange(n)
        if self.engine == "Replacing":
            # winner = max version (when there is one), then insertion order
            if allv is not None:
                order = np.lexsort((order_ins, allv, allk))
            else:
                order = np.lexsort((order_ins, allk))
            sk = allk[order]
            last = np.concatenate([sk[1:] != sk[:-1], [True]])
            return order[last]
        # collapsing engines: group rows (in insertion order) by key, or by
        # (key, version) for VersionedCollapsing
        if self.engine == "VersionedCollapsing":
            order = np.lexsort((order_ins, allv, allk))
            ok, ov = allk[order], allv[order]
            change = (ok[1:] != ok[:-1]) | (ov[1:] != ov[:-1])
        else:
            order = np.lexsort((order_ins, allk))
            ok = allk[order]
            change = ok[1:] != ok[:-1]
        starts = np.nonzero(np.concatenate([[True], change]))[0]
        counts = np.diff(np.concatenate([starts, [n]]))
        ends = starts + counts - 1
        state = allsgn[order] > 0
        pos = np.arange(n)
        n_state = np.add.reduceat(state.astype(np.int64), starts)
        n_cancel = counts - n_state
        keep = np.zeros(n, bool)
        if self.engine == "Collapsing":
            # ClickHouse's collapsing rules per key group:
            #   #state > #cancel          -> keep the last state row
            #   #cancel > #state          -> keep the first cancel row
            #   equal & last row is state -> keep first cancel + last state
            #   equal & last row cancel   -> keep nothing
            last_state = np.maximum.reduceat(np.where(state, pos, -1), starts)
            first_cancel = np.minimum.reduceat(np.where(~state, pos, n), starts)
            more_state = n_state > n_cancel
            more_cancel = n_cancel > n_state
            balanced_state = (n_state == n_cancel) & state[ends] & (n_state > 0)
            keep[last_state[more_state | balanced_state]] = True
            keep[first_cancel[more_cancel | balanced_state]] = True
        else:
            # VersionedCollapsing: min(#state, #cancel) pairs annihilate per
            # (key, version); the |excess| rows of the dominant sign remain
            # (the last `excess` states / the first `excess` cancels)
            excess = np.repeat(n_state - n_cancel, counts)
            cum_s = np.cumsum(state)
            cum_s -= np.repeat(cum_s[starts] - state[starts], counts)
            keep |= state & (np.repeat(n_state, counts) - cum_s < excess)
            cum_c = np.cumsum(~state)
            cum_c -= np.repeat(cum_c[starts] - (~state)[starts], counts)
            keep |= ~state & (cum_c <= -excess)
        return order[np.nonzero(keep)[0]]

    def _collect_engine_rows(self, sources, alive_snaps):
        """(keys, versions, signs, tags[si, row]) over the alive rows of
        `sources` in insertion order; None arrays when not configured."""
        keys_l, vers_l, sgn_l, tag_l = [], [], [], []
        for si, (seg, alive) in enumerate(zip(sources, alive_snaps)):
            idx = np.nonzero(alive)[0]
            if not len(idx):
                continue
            keys_l.append(seg.scalar(self.key_column)[idx])
            if self.version_column is not None:
                vers_l.append(seg.scalar(self.version_column)[idx])
            if self.sign_column is not None:
                sgn_l.append(seg.scalar(self.sign_column)[idx])
            tag_l.append(np.stack([np.full(len(idx), si), idx], axis=1))
        if not keys_l:
            return None
        return (
            np.concatenate(keys_l),
            np.concatenate(vers_l) if vers_l else None,
            np.concatenate(sgn_l) if sgn_l else None,
            np.concatenate(tag_l),
        )

    def _engine_dedup_alive(self, sources, alive_snaps) -> None:
        """Clear (in place) the alive bits of the rows the engine's merge
        drops within `sources`: Replacing rows superseded by a newer
        same-key row, collapsed state/cancel pairs."""
        got = self._collect_engine_rows(sources, alive_snaps)
        if got is None:
            return
        allk, allv, allsgn, tags = got
        survivors = self._survivor_positions(allk, allv, allsgn)
        dead = np.ones(len(allk), bool)
        dead[survivors] = False
        for si, row in tags[dead]:
            alive_snaps[si][row] = False

    def _table_generation(self) -> tuple:
        with self._lock:
            return tuple(sorted((s.uid, s.mutation_generation) for s in self._segments.values()))

    def _final_survivor_bitmaps(self) -> Dict[int, np.ndarray]:
        """Per-segment winner bitmaps {segment_id: bool[n_rows]} of the
        alive rows that survive the engine's merging algorithm over the
        whole table (the view performFinal re-reads candidates through),
        in array form, cached per table generation (any insert, delete or
        update invalidates it)."""
        self._require_versioned(True)
        gen = self._table_generation()
        cached = self._winners_cache
        if cached is not None and cached[0] == gen:
            return cached[1]
        segs = sorted(self.live_segments(), key=lambda s: s.segment_id)
        bitmaps = {seg.segment_id: np.zeros(seg.n_rows, bool) for seg in segs}
        alive = [~seg.deleted_host()[: seg.n_rows] for seg in segs]
        got = self._collect_engine_rows(segs, alive)
        if got is not None:
            allk, allv, allsgn, tags = got
            sid = np.array([seg.segment_id for seg in segs], np.int64)
            win = tags[self._survivor_positions(allk, allv, allsgn)]
            for si in np.unique(win[:, 0]):
                bitmaps[int(sid[si])][win[win[:, 0] == si, 1]] = True
        self._winners_cache = (gen, bitmaps)
        return bitmaps

    def _final_survivors(self) -> set:
        """The (segment_id, row) set of _final_survivor_bitmaps (tests and
        tools; the search paths read the bitmaps)."""
        return {
            (sid, int(r))
            for sid, bm in self._final_survivor_bitmaps().items()
            for r in np.nonzero(bm)[0]
        }

    def _apply_final(self, res: SearchResult, k: int) -> SearchResult:
        """Drop the candidates the merging algorithm discards, then cut to
        k (performFinal on the candidate set): one bitmap gather and a
        stable keep-first compaction."""
        bitmaps = self._final_survivor_bitmaps()
        scores, segs, rows = res.scores, res.segments, res.rows
        keep = np.zeros((res.nq, res.k), bool)
        for sid, bm in bitmaps.items():
            in_seg = (segs == sid) & (rows >= 0)
            if in_seg.any():
                r = np.where(in_seg, rows, 0)
                keep |= in_seg & bm[np.minimum(r, len(bm) - 1)]
        order = np.argsort(~keep, axis=1, kind="stable")
        n_keep = keep.sum(axis=1)
        take = order[:, :k]
        pos_ok = np.arange(k)[None, :] < np.minimum(n_keep, k)[:, None]
        out_v = np.where(pos_ok, np.take_along_axis(scores, take, axis=1), float("-inf"))
        out_s = np.where(pos_ok, np.take_along_axis(segs, take, axis=1), -1)
        out_r = np.where(pos_ok, np.take_along_axis(rows, take, axis=1), -1)
        return SearchResult(
            res.metric,
            host=(out_v.astype(np.float32), out_s.astype(np.int64), out_r.astype(np.int32)),
            nq=res.nq,
            k=k,
            query_sqnorm=res.query_sqnorm,
        )

    def _final_fetch_k(self, k: int, settings: Optional[Settings] = None) -> int:
        st = settings or self.settings
        return int(min(max(k * st.query.final_topk_multiple, k), st.query.max_search_result_window))

    # --------------------------------------------------------------- index lookup
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
        final: bool = False,
    ) -> SearchResult:
        """distance()/batch_distance() analogue: top-k nearest rows.

        A [D] query is one search; an [Q, D] batch is the batch_distance
        semantics (per-query top-k). final=True keeps only the rows that
        survive the engine's merging algorithm (SELECT ... FINAL)."""
        with span("table.search") as sp:
            self._require_versioned(final)
            m = None
            if metric is not None:
                vtype = self.schema.require_vector(column)
                m = Metric.parse(metric, binary=isinstance(vtype, BinaryVector))
            desc = self._index_desc(column) if params else None
            if desc is not None:
                registry.validate_search_params(desc.kind, params)
            st = settings or self.settings
            k_eff = int(k if k is not None else st.query.default_topk)
            res = self._executor.run(
                column,
                query,
                self._final_fetch_k(k_eff, st) if final else k,
                filter=filter,
                params=params,
                metric=m,
                settings=st,
                two_stage=two_stage,
            )
            if final:
                res = self._apply_final(res, k_eff)
            self._log_query("vector_search", column, res.nq, k_eff, sp)
            return res

    def compute_distances(
        self, column: str, query, result: SearchResult, metric: Optional[Metric] = None
    ) -> np.ndarray:
        """Exact user-visible distances of `query` to the result's rows for
        any float vector column (the multi-distance join: a secondary
        distance() column evaluated on the primary's top-k rows), in f64
        on the host from the stored payload. Returns f32[Q, k] (inf on
        invalid slots)."""
        vtype = self.schema.require_vector(column)
        q = np.asarray(query, np.float64).reshape(-1, vtype.dim)
        m = metric or self.index_metric_for(column)
        out = np.full(result.rows.shape, np.inf, np.float32)
        if q.shape[0] == 1 and result.nq > 1:
            q = np.broadcast_to(q, (result.nq, vtype.dim))
        for seg in self.live_segments():
            sel = (result.segments == seg.segment_id) & result.valid
            if not sel.any():
                continue
            qi, ki = np.nonzero(sel)
            data = seg.vector(column).data
            rows = torch.as_tensor(result.rows[qi, ki].astype(np.int64), device=data.device)
            data = data[rows, : vtype.dim]
            data = data.to(torch.float32).cpu().numpy().astype(np.float64)
            qq = q[qi]
            if m == Metric.L2:
                d = ((qq - data) ** 2).sum(1)
            elif m == Metric.IP:
                d = (qq * data).sum(1)
            else:  # Cosine
                num = (qq * data).sum(1)
                den = np.linalg.norm(qq, axis=1) * np.linalg.norm(data, axis=1)
                d = 1.0 - num / np.where(den > 0, den, 1.0)
            out[qi, ki] = d.astype(np.float32)
        return out

    def gather(self, result: SearchResult, columns: List[str]) -> Dict[str, np.ndarray]:
        """Fetch output columns for result hits (the 'read only top-k rows'
        stage). Returns [Q, k] object/num arrays; missing slots get type
        defaults."""
        with span("table.gather"):
            return self._gather(result, columns)

    def _gather(self, result: SearchResult, columns: List[str]) -> Dict[str, np.ndarray]:
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

    def merge(self, segment_ids: Optional[List[int]] = None, *, force: bool = False) -> Optional[int]:
        """Merge segments into one, dropping deleted rows (and, for a
        versioned engine, the rows its merging algorithm drops). With
        enable_decouple_vector_index and a live index on every source, the
        merged segment is served through a DecoupledIndex (the sources'
        indexes and row-id maps, MergeTask.cpp:319-405) until its own
        index, built on the scheduler, lands. Returns the merged segment's
        id, or None.

        In a replica set only the leader initiates merges (`merge_gate`,
        installed by ReplicatedNode.attach: the ZK leader-assigned merge);
        on the others merge() returns None and the leader's merge reaches
        them through the op log. `force=True` bypasses the gate; then
        convergence rests on origin-addressed delete provenance instead.
        """
        if not force and self.merge_gate is not None and not self.merge_gate():
            GLOBAL_COUNTERS.bump("MergesDeferredToLeader")
            return None
        with self._lock:
            ids = segment_ids or sorted(self._segments)
            # one segment still merges on a versioned engine: OPTIMIZE
            # FINAL rewrites the part through the merging algorithm
            if len(ids) < 2 and (self.engine == "MergeTree" or not ids):
                return None
            sources = [self._segments[i] for i in ids]
        # phase 1 (no DML lock, the copy is long): snapshot each source's
        # alive bitmap and mutation generation, and copy the live rows
        gen_snaps = [seg.mutation_generation for seg in sources]
        alive_snaps = [~seg.deleted_host()[: seg.n_rows].copy() for seg in sources]
        if self.engine != "MergeTree":
            self._engine_dedup_alive(sources, alive_snaps)
        cols: Dict[str, List[np.ndarray]] = {c: [] for c in self.schema.columns}
        row_maps: List[np.ndarray] = []  # old capacity -> new row id
        offset = 0
        for seg, alive in zip(sources, alive_snaps):
            rmap = np.full(seg.capacity, -1, np.int32)
            n_alive = int(alive.sum())
            rmap[: seg.n_rows][alive] = offset + np.arange(n_alive, dtype=np.int32)
            offset += n_alive
            row_maps.append(rmap)
            keep = torch.from_numpy(np.nonzero(alive)[0])
            for cname, ctype in self.schema.columns.items():
                if cname in seg.vectors:
                    data = seg.vector(cname).data
                    data = data[keep.to(data.device)]
                    if not isinstance(ctype, BinaryVector):
                        data = data[:, : ctype.dim].to(torch.float32)
                    cols[cname].append(data.cpu().numpy())
                else:
                    cols[cname].append(seg.scalar(cname)[: seg.n_rows][alive].copy())
        merged = {c: np.concatenate(v, axis=0) for c, v in cols.items()}
        n_merged = len(next(iter(merged.values())))
        if n_merged == 0:
            self._drop_segments(ids)
            return None

        # the merged segment is built unpublished: no search sees both
        # generations
        new_seg = self._new_segment(merged)
        new_id = new_seg.segment_id

        # decoupled serving: a description with a live index on every
        # source searches the merged segment through them
        decouple = self.settings.table.enable_decouple_vector_index
        with self._lock:
            descs = list(self._index_descs.values())
        decoupled_descs: List[IndexDescription] = []
        plain_descs: List[IndexDescription] = []
        for desc in descs:
            with self._lock:
                subs = [
                    slot.instance
                    for slot in (self._slots.get((s.segment_id, desc.name)) for s in sources)
                    if slot is not None and slot.instance is not None
                ]
            if decouple and not self._is_small(n_merged, desc) and len(subs) == len(sources):
                inst = DecoupledIndex(
                    subs,
                    [torch.from_numpy(m).to(self.device) for m in row_maps],
                    metric=desc.metric,
                    dim=desc.dim,
                    n_rows=n_merged,
                )
                with self._lock:
                    self._slots[(new_id, desc.name)] = IndexSlot(IndexStatus.PENDING, instance=inst)
                decoupled_descs.append(desc)
            else:
                plain_descs.append(desc)
        # fts stores for the merged segment, built before it is published
        for tdef in list(self._text_indexes.values()):
            tdef.on_new_segment(new_seg)

        # phase 2 (DML lock held): re-apply what landed on the sources
        # during the copy, then swap sources for the merged segment at once
        with self._dml_lock:
            changed = False
            for seg, alive_snap, gen_snap, rmap in zip(sources, alive_snaps, gen_snaps, row_maps):
                if seg.mutation_generation == gen_snap:
                    continue
                changed = True
                # deletes since the snapshot -> delete the mapped rows
                new_dead = seg.deleted_host()[: seg.n_rows] & alive_snap
                if new_dead.any():
                    mapped = rmap[: seg.n_rows][new_dead]
                    new_seg.delete_rows(mapped[mapped >= 0])
                # scalar UPDATEs since the snapshot -> copy the scalars of
                # the rows alive at the snapshot again (a vector column
                # cannot be UPDATEd, so the device payload is still right)
                snap_rows = np.nonzero(alive_snap)[0]
                dst = rmap[: seg.n_rows][alive_snap]
                for cname in new_seg.scalars:
                    new_seg.scalar(cname)[dst] = seg.scalar(cname)[snap_rows]
            if changed:
                # text columns may have been UPDATEd mid-copy
                for tdef in list(self._text_indexes.values()):
                    tdef.on_new_segment(new_seg)
            with self._lock:
                self._segments[new_id] = new_seg
                for i in ids:
                    self._segments.pop(i, None)
                    for key in [k for k in self._slots if k[0] == i]:
                        del self._slots[key]

        # after the swap: schedule the rebuilds, clean the caches
        slow = n_merged > self.settings.table.max_rows_for_slow_mode_single_vector_index_build
        for desc in decoupled_descs:
            self._submit(lambda d=desc: self._build_one(new_seg, d), slow=slow)
            GLOBAL_COUNTERS.bump("DecoupledMerges")
        for desc in plain_descs:
            self._schedule_build(new_seg, desc)
        self._forget_segments(ids)
        self._segments_changed()
        GLOBAL_COUNTERS.bump("SegmentMerges")
        # row maps (source row -> merged row, -1 dropped) let replication
        # compose per-origin row provenance through the merge
        self._notify_commit(
            "merge",
            segment=new_seg,
            dropped_ids=list(ids),
            row_maps=[rm[: seg.n_rows] for rm, seg in zip(row_maps, sources)],
        )
        return new_id

    def truncate(self) -> None:
        """TRUNCATE TABLE: drop every segment (the schema and the index
        definitions stay; new inserts build fresh indexes). A replicated
        table's peers converge through the truncate op."""
        with self._lock:
            seg_ids = list(self._segments)
        self._drop_segments(seg_ids)
        with self._lock:
            self._winners_cache = None
        self._notify_commit("truncate")

    def _drop_segments(self, segment_ids: List[int]) -> None:
        """Remove segments without merging (also a peer's merge applied
        here: its merged part replaces the sources)."""
        with self._dml_lock, self._lock:
            for i in segment_ids:
                self._segments.pop(i, None)
                for key in [k for k in self._slots if k[0] == i]:
                    del self._slots[key]
        self._forget_segments(segment_ids)
        self._segments_changed()

    def _forget_segments(self, segment_ids: List[int]) -> None:
        """Drop what the fts stores and the index cache hold of removed
        segments."""
        for tdef in list(self._text_indexes.values()):
            for i in segment_ids:
                tdef.on_segment_dropped(i)
        if self._index_cache is not None:
            for i in segment_ids:
                for name in list(self._index_descs):
                    self._index_cache.force_expire((self.name, name, i))

    # ----------------------------------------------------------- introspect
    def system_vector_indices(self) -> List[Dict[str, Any]]:
        """system.vector_indices rows (StorageSystemVIs.cpp:39-52)."""
        out = []
        with self._lock:
            segs = list(self._segments.values())
            for desc in self._index_descs.values():
                slots = {s.segment_id: self._slots.get((s.segment_id, desc.name)) for s in segs}
                built = sum(
                    1 for s in slots.values()
                    if s and s.status in (IndexStatus.BUILT, IndexStatus.LOADED)
                )
                small = sum(1 for s in slots.values() if s and s.status == IndexStatus.SMALL_PART)
                errors = [
                    (sid, s.error) for sid, s in slots.items()
                    if s and s.status == IndexStatus.ERROR
                ]
                building = any(
                    s and s.status in (IndexStatus.PENDING, IndexStatus.BUILDING)
                    for s in slots.values()
                )
                if errors:
                    status = "Error"
                elif building:
                    status = "InProgress"
                elif not segs or built + small == len(segs):
                    status = "Built"
                else:
                    status = "NotBuilt"
                out.append({
                    "database": "default",
                    "table": self.name,
                    "name": desc.name,
                    "type": (
                        desc.declared_type
                        if desc.declared_type and desc.declared_type.lower() != "default"
                        else desc.kind.value
                    ),
                    "expr": desc.definition or desc.column,
                    "metric": desc.metric.value,
                    "dim": desc.dim,
                    "total_parts": len(segs),
                    "parts_with_vector_index": built,
                    "small_parts": small,
                    "status": status,
                    "latest_failed_part": errors[-1][0] if errors else "",
                    "latest_fail_reason": errors[-1][1] if errors else "",
                })
        return out

    def system_vector_index_segments(self) -> List[Dict[str, Any]]:
        """system.vector_index_segments rows (StorageSystemVIsWithPart.cpp).
        `progress` is 1.0 once a part's index is built or loaded, else 0.0
        (the port's builds report no partial progress)."""
        out = []
        with self._lock:
            for (sid, iname), slot in sorted(self._slots.items()):
                desc = self._index_descs.get(iname)
                seg = self._segments.get(sid)
                if desc is None or seg is None:
                    continue
                done = slot.status in (IndexStatus.LOADED, IndexStatus.BUILT)
                out.append({
                    "database": "default",
                    "table": self.name,
                    "name": iname,
                    "part": sid,
                    "dimension": desc.dim,
                    "status": slot.status.value,
                    "total_vectors": seg.n_rows,
                    "memory_usage_bytes": slot.instance.memory_bytes if slot.instance else 0,
                    "elapsed": slot.elapsed_s,
                    "progress": 1.0 if done else 0.0,
                    "error": slot.error,
                })
        return out
