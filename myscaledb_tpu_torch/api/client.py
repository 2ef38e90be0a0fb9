"""Database: top-level handle owning the tables, the build pools, the index
cache and the logs. `connect()` is the entry point.

Counterpart of myscaledb_tpu/api/client.py, with its replica arguments
(`replica_id`, `n_replicas`, `replica_peers`: one replica of a set that
builds each index once, service/replication.py) and its sharded tables
(`create_sharded_table`, parallel/sharded_table.py). The database carries
an explicit torch device into every table, segment and index: "cuda"
unless the caller asks for the CPU, never a quiet fallback.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cache.lru import LRUCache
from ..config import Settings
from ..errors import SchemaError
from ..index import registry
from ..index.base import IndexStatus
from ..ops._cuda import set_exact_precision
from ..service.background import BuildScheduler
from ..service.event_log import GLOBAL_COUNTERS, GLOBAL_QUERY_LOG, EventLog
from ..storage import persistence
from ..storage.schema import BinaryVector, Schema
from ..storage.table import IndexSlot, Table

# the index cache of a device without memory stats (the CPU), as the JAX
# package sizes it when it cannot read the device's memory
_FALLBACK_CACHE_BYTES = 4 << 30


def resolve_device(device) -> torch.device:
    """The database's device. "cuda" (or "cuda:N") needs a CUDA device and
    raises without one; nothing falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_exact_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


class Database:
    def __init__(
        self,
        settings: Optional[Settings] = None,
        *,
        path: Optional[str] = None,
        event_log_path: Optional[str] = None,
        remote_store=None,
        replica_id: Optional[int] = None,
        n_replicas: int = 1,
        replica_peers=None,
        device="cuda",
    ):
        self.settings = settings or Settings()
        self.device = resolve_device(device)
        self.path = path
        # cold tier (S3 / remote disks analogue): an ObjectStore or its URL
        if isinstance(remote_store, str):
            from ..storage.stores import store_from_url

            remote_store = store_from_url(remote_store)
        self.remote_store = remote_store
        self.replica = None
        if replica_id is not None and n_replicas > 1:
            from ..service.replication import ReplicaContext

            # replica_peers: the peers' IndexExchangeServer URLs by replica
            # id; index fetches then go over HTTP instead of a shared dir
            self.replica = ReplicaContext(replica_id, n_replicas, peers=replica_peers)
        self.event_log = EventLog(path=event_log_path)
        self._tables: Dict[str, Table] = {}
        # DETACH TABLE registry: name -> the live Table (a database without
        # a path) or None (persisted: ATTACH reloads it from disk)
        self._detached: Dict[str, Optional[Table]] = {}
        self._lock = threading.RLock()
        self._sql_runner = None  # made by the first sql() call
        srv = self.settings.server
        self.scheduler = BuildScheduler(
            n_fast=srv.background_vector_pool_size,
            n_slow=srv.background_slow_mode_vector_pool_size,
        )
        cache_bytes = srv.vector_index_cache_size
        if cache_bytes is None:
            mem = (
                torch.cuda.get_device_properties(self.device).total_memory
                if self.device.type == "cuda"
                else _FALLBACK_CACHE_BYTES
            )
            ratio = min(max(srv.vector_index_cache_size_ratio_of_memory, 0.1), 0.9)
            cache_bytes = int(mem * ratio)
        self.index_cache = LRUCache(cache_bytes, on_evict=self._on_cache_evict)
        self.counters = GLOBAL_COUNTERS
        # persistent system logs: with a storage path, query_log and
        # vector_index_event_log flush into backing tables and survive a
        # restart; a database without a path keeps ring-only logs
        self.system_logs = None
        if self.path:
            from ..service.system_log import SystemLogs

            self.system_logs = SystemLogs(self, flush_interval_s=srv.system_log_flush_interval_s)

    def on_device(self):
        """This database's device as the calling thread's current device
        (each thread has its own; a kernel launches on the current one)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _on_cache_evict(self, key, _value) -> None:
        """Route an LRU eviction back to the owning table (CACHE_EXPIRE)."""
        try:
            table_name, index_name, segment_id = key
        except (TypeError, ValueError):
            return
        # one dict read, without the database's lock: the eviction may come
        # from a thread that holds a table's lock, and rename_table takes
        # the two the other way round
        t = self._tables.get(table_name)
        if t is not None:
            t.on_cache_evict(index_name, segment_id)

    # -------------------------------------------------------------- tables
    def create_table(
        self,
        name: str,
        schema: Schema,
        settings: Optional[Settings] = None,
        *,
        engine: str = "MergeTree",
        key_column: Optional[str] = None,
        version_column: Optional[str] = None,
        sign_column: Optional[str] = None,
    ) -> Table:
        with self._lock:
            if name in self._tables:
                raise SchemaError(f"table {name!r} already exists")
            t = Table(
                name, schema, settings or self.settings, device=self.device,
                engine=engine, key_column=key_column, version_column=version_column,
                sign_column=sign_column, event_log=self.event_log, scheduler=self.scheduler,
                index_cache=self.index_cache,
                storage_dir=os.path.join(self.path, name) if self.path else None,
                remote_store=self.remote_store, replica=self.replica,
            )
            self._tables[name] = t
            return t

    def load_table(
        self, name: str, settings: Optional[Settings] = None, *, directory: Optional[str] = None
    ) -> Table:
        """Restart path: reload a persisted table (either package's
        checkpoint). Segments load now (they are the data); built indexes
        stay on disk (status BUILT) and reload lazily on their first
        search. `directory` overrides the source (RESTORE TABLE ... FROM)."""
        if not directory and not self.path:
            raise SchemaError("database has no storage path")
        root = directory or os.path.join(self.path, name)
        if not os.path.isfile(os.path.join(root, "schema.json")):
            # cold start: materialize the table from the object store
            pulled = False
            if self.remote_store is not None:
                from ..storage.stores import sync_dir_from_store

                os.makedirs(root, exist_ok=True)
                pulled = sync_dir_from_store(self.remote_store, f"tables/{name}", root)
            if not pulled:
                raise SchemaError(f"no persisted table at {root}")
        with open(os.path.join(root, "schema.json")) as f:
            sj = json.load(f)
        # the pre-engine format stored the bare column map
        eng = sj.get("engine", {}) if "columns" in sj else {}
        schema = persistence.schema_from_json(sj.get("columns", sj))
        t = self.create_table(
            name, schema, settings, engine=eng.get("name", "MergeTree"),
            key_column=eng.get("key_column"), version_column=eng.get("version_column"),
            sign_column=eng.get("sign_column"),
        )
        # fts indexes first: the segment inserts below then build their stores
        fts_file = os.path.join(root, "fts_indexes.json")
        if os.path.exists(fts_file):
            with open(fts_file) as f:
                for iname, d in json.load(f).items():
                    t.add_fts_index(iname, d["columns"], d.get("params"))
        # index definitions (no builds yet: the segments come first)
        descs = {}
        idx_file = os.path.join(root, "indexes.json")
        if os.path.exists(idx_file):
            with open(idx_file) as f:
                descs = json.load(f)
        seg_dirs = [d for d in os.listdir(root) if d.startswith("segment_")]
        # numeric order: insertion order decides Replacing winners
        for segdir in sorted(seg_dirs, key=lambda d: int(d.split("_", 1)[1])):
            sdir = os.path.join(root, segdir)
            persistence.resume_tmp_index_dirs(sdir)  # interrupted persists
            _, cols, deleted = persistence.load_segment_columns(sdir, schema)
            new_id = t.insert(cols)
            seg = next(s for s in t.live_segments() if s.segment_id == new_id)
            if deleted is not None:
                seg.delete_rows(np.nonzero(deleted)[0])
                t._segments_changed()
            for iname in descs:
                idir = os.path.join(sdir, f"index_{iname}")
                if os.path.isdir(idir):
                    with t._lock:
                        t._slots[(new_id, iname)] = IndexSlot(IndexStatus.BUILT, path=idir)
        for iname, d in descs.items():
            # the description is registered without builds for the segments
            # that carry a persisted index; the others build now
            vtype = schema.require_vector(d["column"])
            desc = registry.make_description(
                iname, d["column"], d["type"], vtype.dim,
                is_binary_column=isinstance(vtype, BinaryVector), default_metric=d["metric"],
                params=dict(d["params"], metric_type=d["metric"]), strict=False,
            )
            desc.declared_type = d.get("declared_type", "") or desc.declared_type
            desc.definition = d.get("definition", "")
            with t._lock:
                t._index_descs[iname] = desc
                pending = [s for s in t.live_segments() if (s.segment_id, iname) not in t._slots]
            for seg in pending:
                t._schedule_build(seg, desc)
        return t

    def create_sharded_table(
        self,
        name: str,
        schema: Schema,
        *,
        n_shards: int,
        settings: Optional[Settings] = None,
        shard_key: Optional[str] = None,
    ):
        """Distributed-engine analogue: a logical table over n shard tables
        of this database, fused on the initiator
        (parallel/sharded_table.py)."""
        from ..parallel.sharded_table import ShardedTable

        return ShardedTable(
            self, name, schema, n_shards=n_shards, settings=settings, shard_key=shard_key
        )

    def table(self, name: str) -> Table:
        with self._lock:
            if name not in self._tables:
                raise SchemaError(f"no such table: {name}")
            return self._tables[name]

    def drop_table(self, name: str) -> None:
        with self._lock:
            t = self._tables.pop(name, None)
        if t is not None:
            self.index_cache.expire_prefix((name,))
            t._segments_changed()  # its search programs let go of its tensors

    def detach_table(self, name: str) -> None:
        """DETACH TABLE: remove from the registry without dropping data. A
        table with a storage path is checkpointed, and marked for a reload
        from disk only once the checkpoint is complete (an ATTACH never
        reads a half-written one); a database without a path parks the
        live object."""
        with self._lock:
            if name not in self._tables:
                raise SchemaError(f"no such table: {name}")
            # parked live while its checkpoint is written: an ATTACH in the
            # meantime takes the live object back
            t = self._tables.pop(name)
            self._detached[name] = t
        if t.storage_dir:
            t.persist()
            with self._lock:
                if self._detached.get(name) is t:
                    self._detached[name] = None  # ATTACH reloads it from disk
        self.index_cache.expire_prefix((name,))
        t._segments_changed()  # its search programs let go of its tensors

    def attach_table(self, name: str) -> Table:
        """ATTACH TABLE: re-register a detached table, reloading it from its
        checkpoint when it has one (segments now, indexes lazily)."""
        with self._lock:
            if name in self._tables:
                raise SchemaError(f"table {name!r} already exists")
            missing = name not in self._detached
            t = self._detached.pop(name, None)
            if t is not None:
                self._tables[name] = t
        if t is not None:
            return t
        if missing and not self.path:
            raise SchemaError(f"no detached table: {name}")
        return self.load_table(name)

    def rename_table(self, name: str, new_name: str) -> None:
        """RENAME TABLE: the registry, Table.name and the checkpoint
        directory move together (a persisted table stays loadable under
        its new name); the index cache is keyed by table name, so its
        entries are expired and the indexes reload under the new name."""
        with self._lock:
            if name not in self._tables:
                raise SchemaError(f"no such table: {name}")
            if new_name in self._tables:
                raise SchemaError(f"table {new_name!r} already exists")
            t = self._tables[name]
            old_dir = t.storage_dir
            new_dir = os.path.join(self.path, new_name) if self.path else None
            if new_dir and os.path.exists(new_dir):
                raise SchemaError(f"storage dir for {new_name!r} already exists")
            if old_dir and new_dir and os.path.isdir(old_dir):
                os.replace(old_dir, new_dir)
                with t._lock:
                    for slot in t._slots.values():
                        if slot.path.startswith(old_dir):
                            slot.path = new_dir + slot.path[len(old_dir):]
            del self._tables[name]
            t.name = new_name
            if new_dir:
                t.storage_dir = new_dir
            self._tables[new_name] = t
        self.index_cache.expire_prefix((name,))

    def tables(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    # ------------------------------------------------------------- system
    def system_table(self, which: str) -> List[dict]:
        """system.vector_indices / vector_index_segments /
        vector_index_event_log / query_log / span_log / profile_events /
        tables / parts (attachSystemTables.cpp:144-145,
        SystemLog.cpp:224-225)."""
        with self._lock:
            tables = list(self._tables.values())
        if which == "vector_indices":
            return [r for t in tables for r in t.system_vector_indices()]
        if which == "vector_index_segments":
            return [r for t in tables for r in t.system_vector_index_segments()]
        if which == "vector_index_event_log":
            if self.system_logs is not None:
                return self.system_logs.rows("vector_index_event_log")
            return self.event_log.rows()
        if which in ("span_log", "opentelemetry_span_log"):
            from ..service.tracing import GLOBAL_SPAN_LOG

            return GLOBAL_SPAN_LOG.rows()
        if which == "query_log":
            if self.system_logs is not None:
                return self.system_logs.rows("query_log")
            return GLOBAL_QUERY_LOG.rows()
        if which == "profile_events":
            return [{"event": k, "value": v} for k, v in sorted(self.counters.snapshot().items())]
        if which == "tables":
            return [
                {"database": "default", "name": t.name, "engine": t.engine, "total_rows": t.n_rows}
                for t in tables
            ]
        if which == "parts":
            # one row per live segment (StorageSystemParts)
            return [
                {
                    "database": "default",
                    "table": t.name,
                    "name": f"seg_{s.segment_id}",
                    "partition": "tuple()",
                    "rows": int(s.num_live),
                    "active": 1,
                    "marks": 1,
                    "bytes_on_disk": int(getattr(s, "device_bytes", 0) or 0),
                }
                for t in tables
                for s in t.live_segments()
            ]
        raise SchemaError(f"unknown system table: {which}")

    # ------------------------------------------------------ table functions
    def full_text_search(
        self,
        table: str,
        index_name: str,
        query: str,
        *,
        k: Optional[int] = None,
        columns: Optional[List[str]] = None,
        with_score: bool = True,
        operator: str = "OR",
    ) -> List[dict]:
        """full_text_search(db_table, index, query) table function
        (StorageFullTextSearch, default limit 10000,
        TableFunctionFullTextSearch.cpp)."""
        t = self.table(table)
        res = t.text_search(index_name, query, k or 10_000, operator=operator)
        cols = columns or list(t.schema.scalar_columns())
        gathered = t.gather(res, cols)
        out = []
        for j in range(res.k):
            if not res.valid[0, j]:
                continue
            row = {c: gathered[c][0, j] for c in cols}
            if with_score:
                row["bm25_score"] = float(res.scores[0, j])
            out.append(row)
        return out

    def fts_index_stats(self, table: str, column_or_index: str, query: str = "") -> dict:
        """ftsIndex(db, table, col, query) analogue: table-level BM25 corpus
        statistics (total docs/tokens, per-query-term doc freq), the
        payload a distributed initiator aggregates and passes back as
        `text_search(..., stats_override=...)` (TableFunctionFtsIndex.cpp:
        112-116)."""
        from ..search.text_executor import TextSearchExecutor

        t = self.table(table)
        tdef = TextSearchExecutor(t)._resolve(column_or_index)
        stats = tdef.merged_stats([s.segment_id for s in t.live_segments()])
        terms = tdef.analyzer.tokenize(query) if query else []
        return {
            "total_docs": stats.total_docs,
            "total_tokens": stats.total_tokens,
            "avg_doc_len": stats.avg_doc_len,
            "doc_freq": {tm: stats.doc_freq.get(tm, 0) for tm in terms},
        }

    # ----------------------------------------------------------------- sql
    def sql(self, statement: str):
        """Execute one SQL statement (the reference's dialect subset).
        Returns a list of row dicts for SELECT, [] for DDL/INSERT. The
        runner is made once, under the database's lock, and persists
        across calls so `SET k = v` session settings stick; a statement
        runs on the database's device, whichever thread calls."""
        from ..sql.runner import SQLRunner

        with self._lock:
            if self._sql_runner is None:
                self._sql_runner = SQLRunner(self)
            runner = self._sql_runner
        with self.on_device():
            return runner.execute(statement)

    def close(self) -> None:
        """Flush the system logs and stop the build pools (queued builds
        still run; the workers exit after them)."""
        if self.system_logs is not None:
            self.system_logs.close()
        self.scheduler.shutdown()


def connect(settings: Optional[Settings] = None, **kw) -> Database:
    """Database(settings, path=..., event_log_path=..., remote_store=...,
    replica_id=..., n_replicas=..., replica_peers=..., device="cuda"); pass
    device="cpu" for the CPU."""
    return Database(settings, **kw)
