"""Vector index event log + profile counters.

Mirrors system.vector_index_event_log (src/VectorIndex/Interpreters/
VIEventLog.h:32-48 — DEFINITION_CREATED/DROPPED, BUILD_START/SUCCEED/
ERROR/CANCELD, LOAD_*, CACHE_EXPIRE) and the ProfileEvents counters
(src/Common/ProfileEvents.cpp:538-543). Events are kept in a bounded
in-memory ring (queryable via Database.system_table('vector_index_event_log'))
and optionally mirrored to a JSONL file.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence


class EventType(enum.Enum):
    DEFINITION_CREATED = "DefinitionCreated"
    DEFINITION_DROPPED = "DefinitionDropped"
    DEFINITION_ERROR = "DefinitionError"
    BUILD_START = "BuildStart"
    BUILD_SUCCEED = "BuildSucceed"
    BUILD_ERROR = "BuildError"
    BUILD_CANCELED = "BuildCanceled"
    LOAD_START = "LoadStart"
    LOAD_SUCCEED = "LoadSucceed"
    LOAD_ERROR = "LoadError"
    CACHE_EXPIRE = "CacheExpire"
    WILL_NOT_BUILD = "WillNotBuild"  # small part
    TIER_SPILL = "TierSpill"  # payload degraded HBM->host (memory pressure)


@dataclasses.dataclass
class Event:
    ts: float
    table: str
    index_name: str
    column: str
    segment_id: Optional[int]
    event: EventType
    elapsed_s: float = 0.0
    error: str = ""

    def as_row(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["event"] = self.event.value
        return d


class EventLog:
    def __init__(self, max_events: int = 100_000, path: Optional[str] = None):
        self._events: collections.deque = collections.deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._path = path
        self._n = 0  # total ever appended (drain cursor space)

    def record(
        self,
        table: str,
        index_name: str,
        column: str,
        event: EventType,
        *,
        segment_id: Optional[int] = None,
        elapsed_s: float = 0.0,
        error: str = "",
    ) -> None:
        ev = Event(
            ts=time.time(),
            table=table,
            index_name=index_name,
            column=column,
            segment_id=segment_id,
            event=event,
            elapsed_s=elapsed_s,
            error=error,
        )
        with self._lock:
            self._events.append(ev)
            self._n += 1
            if self._path:
                try:
                    with open(self._path, "a") as f:
                        f.write(json.dumps(ev.as_row()) + "\n")
                except OSError:
                    pass

    def clear(self) -> None:
        """TRUNCATE TABLE system.* analogue for the in-memory ring."""
        with self._lock:
            target = getattr(self, "_events", None)
            if target is None:
                target = self._rows
            target.clear()

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [e.as_row() for e in self._events]

    def drain(self, cursor: int):
        """Rows appended after `cursor` + the new cursor (the SystemLog
        flush contract: each row lands in persistent storage exactly
        once). Rows that scrolled off the ring before a flush are lost —
        same as the reference under flush backpressure."""
        with self._lock:
            dropped = self._n - len(self._events)
            start = max(cursor - dropped, 0)
            rows = [e.as_row() for e in list(self._events)[start:]]
            return rows, self._n

    def query(self, **eq) -> List[Dict[str, Any]]:
        out = []
        for r in self.rows():
            if all(r.get(k) == v for k, v in eq.items()):
                out.append(r)
        return out


class Counters:
    """Named monotonic counters (ProfileEvents analogue)."""

    def __init__(self):
        self._c: Dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def bump_many(self, names: Sequence[str], counts: Sequence[int]) -> None:
        """bump(name, n) for each name of `names` and n of `counts`, under
        one hold of the lock."""
        with self._lock:
            c = self._c
            for name, n in zip(names, counts):
                c[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)


GLOBAL_COUNTERS = Counters()


class QueryLog:
    """Per-query accounting ring (system.query_log analogue,
    src/Interpreters/SystemLog.cpp / QueryLog.cpp): one row per search or
    SQL statement with duration, rows read, and the effective knobs. The
    span log covers STAGES; this covers QUERIES."""

    def __init__(self, max_entries: int = 100_000):
        self._rows: collections.deque = collections.deque(maxlen=max_entries)
        self._lock = threading.Lock()
        self._n = 0  # total ever appended (drain cursor space)

    def record(
        self,
        kind: str,
        *,
        table: str = "",
        column: str = "",
        query_text: str = "",
        nq: int = 1,
        k: int = 0,
        rows_read: int = 0,
        duration_ms: float = 0.0,
        settings: Optional[Dict[str, Any]] = None,
        error: str = "",
    ) -> None:
        row = {
            "event_time": time.time(),
            "kind": kind,  # vector_search | text_search | hybrid_search | sql
            "table": table,
            "column": column,
            "query": query_text,
            "nq": int(nq),
            "k": int(k),
            "rows_read": int(rows_read),
            "duration_ms": float(duration_ms),
            "settings": dict(settings or {}),
            "error": error,
        }
        with self._lock:
            self._rows.append(row)
            self._n += 1

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._rows]

    def drain(self, cursor: int):
        """See EventLog.drain."""
        with self._lock:
            dropped = self._n - len(self._rows)
            start = max(cursor - dropped, 0)
            rows = [dict(r) for r in list(self._rows)[start:]]
            return rows, self._n


GLOBAL_QUERY_LOG = QueryLog()
