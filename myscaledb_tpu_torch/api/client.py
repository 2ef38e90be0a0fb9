"""Database: top-level handle owning the tables. `connect()` is the entry
point.

Counterpart of myscaledb_tpu/api/client.py without the build scheduler,
the index LRU cache, replicas and system tables (index builds run on the
caller's thread). The database carries an explicit torch device into
every table, segment and index, and one vector-index event log.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from ..config import Settings
from ..errors import SchemaError
from ..ops._cuda import set_exact_precision
from ..service.event_log import EventLog
from ..storage.schema import Schema
from ..storage.table import Table


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
    def __init__(self, settings: Optional[Settings] = None, *, device="cuda"):
        self.settings = settings or Settings()
        self.device = resolve_device(device)
        self.event_log = EventLog()
        self._tables: Dict[str, Table] = {}
        self._lock = threading.RLock()

    # -------------------------------------------------------------- tables
    def create_table(
        self,
        name: str,
        schema: Schema,
        settings: Optional[Settings] = None,
        *,
        engine: str = "MergeTree",
    ) -> Table:
        with self._lock:
            if name in self._tables:
                raise SchemaError(f"table {name!r} already exists")
            t = Table(
                name, schema, settings or self.settings, device=self.device, engine=engine,
                event_log=self.event_log,
            )
            self._tables[name] = t
            return t

    def table(self, name: str) -> Table:
        with self._lock:
            if name not in self._tables:
                raise SchemaError(f"no such table: {name}")
            return self._tables[name]

    def drop_table(self, name: str) -> None:
        with self._lock:
            self._tables.pop(name, None)

    def tables(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

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

    def close(self) -> None:
        with self._lock:
            self._tables.clear()


def connect(settings: Optional[Settings] = None, *, device="cuda") -> Database:
    return Database(settings, device=device)
