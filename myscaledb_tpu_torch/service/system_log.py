"""Persistent system logs: query_log / vector_index_event_log backed by
engine tables.

The reference's SystemLog (src/Interpreters/SystemLog.cpp:224-225)
flushes in-memory log buffers into REAL MergeTree tables every
flush_interval_milliseconds (7500 default), so system.query_log survives
restarts and is retroactively queryable with full SQL. This is the same
contract on the TPU engine: each log gets a scalar-only engine Table
(`system_query_log`, `system_vector_index_event_log`) under the
database's storage path, a background flusher drains the in-memory rings
into it (one immutable segment per flush — the SystemLog insert-block
shape), and `SELECT ... FROM system.query_log` merges the persisted
history with the not-yet-flushed ring tail. The backing tables are
ordinary tables: JOINs / GROUP BY / window functions over log history
work like over any other table (once the port has SQL, ROADMAP queue 1
#11).

A copy of myscaledb_tpu/service/system_log.py: the backing tables are the
port's own `Table`s on the database's device, in the JAX package's
on-disk layout.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ..storage.schema import Float64, Int64, Schema, String, UInt64

QUERY_LOG_TABLE = "system_query_log"
EVENT_LOG_TABLE = "system_vector_index_event_log"

_QUERY_COLS = {
    "event_time": Float64(),
    "kind": String(),
    "table": String(),
    "column": String(),
    "query": String(),
    "nq": UInt64(),
    "k": UInt64(),
    "rows_read": UInt64(),
    "duration_ms": Float64(),
    "settings": String(),  # JSON-encoded dict
    "error": String(),
}

_EVENT_COLS = {
    "ts": Float64(),
    "table": String(),
    "index_name": String(),
    "column": String(),
    "segment_id": Int64(),  # -1 encodes None
    "event": String(),
    "elapsed_s": Float64(),
    "error": String(),
}


def _encode_query(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {
        "event_time": np.array([r["event_time"] for r in rows], np.float64),
        "kind": np.array([r["kind"] for r in rows], object),
        "table": np.array([r["table"] for r in rows], object),
        "column": np.array([r["column"] for r in rows], object),
        "query": np.array([r["query"] for r in rows], object),
        "nq": np.array([r["nq"] for r in rows], np.uint64),
        "k": np.array([r["k"] for r in rows], np.uint64),
        "rows_read": np.array([r["rows_read"] for r in rows], np.uint64),
        "duration_ms": np.array([r["duration_ms"] for r in rows], np.float64),
        "settings": np.array(
            [json.dumps(r.get("settings") or {}) for r in rows], object
        ),
        "error": np.array([r["error"] for r in rows], object),
    }


def _decode_query(row: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(row)
    try:
        out["settings"] = json.loads(row.get("settings") or "{}")
    except (TypeError, ValueError):
        out["settings"] = {}
    for k in ("nq", "k", "rows_read"):
        out[k] = int(out[k])
    return out


def _encode_event(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {
        "ts": np.array([r["ts"] for r in rows], np.float64),
        "table": np.array([r["table"] for r in rows], object),
        "index_name": np.array([r["index_name"] for r in rows], object),
        "column": np.array([r["column"] for r in rows], object),
        "segment_id": np.array(
            [-1 if r["segment_id"] is None else r["segment_id"] for r in rows],
            np.int64,
        ),
        "event": np.array([r["event"] for r in rows], object),
        "elapsed_s": np.array([r["elapsed_s"] for r in rows], np.float64),
        "error": np.array([r["error"] for r in rows], object),
    }


def _decode_event(row: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(row)
    sid = int(out["segment_id"])
    out["segment_id"] = None if sid < 0 else sid
    return out


class SystemLogs:
    """Owns the backing tables + the flush thread. Created by Database
    when it has a storage path (in-memory databases keep ring-only logs,
    like the reference with system logs disabled)."""

    def __init__(self, db, flush_interval_s: float = 7.5):
        self.db = db
        self._cursors = {"query_log": 0, "vector_index_event_log": 0}
        self._tables: Dict[str, Any] = {}
        self._lock = threading.Lock()
        for key, tname, cols in (
            ("query_log", QUERY_LOG_TABLE, _QUERY_COLS),
            ("vector_index_event_log", EVENT_LOG_TABLE, _EVENT_COLS),
        ):
            root = os.path.join(db.path, tname)
            if os.path.isfile(os.path.join(root, "schema.json")):
                t = db.load_table(tname)
            else:
                t = db.create_table(tname, Schema(dict(cols)))
            self._tables[key] = t
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if flush_interval_s and flush_interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, args=(float(flush_interval_s),),
                name="system-log-flush", daemon=True,
            )
            self._thread.start()

    # ------------------------------------------------------------- sources
    def _source(self, key: str):
        if key == "query_log":
            from .event_log import GLOBAL_QUERY_LOG

            return GLOBAL_QUERY_LOG
        return self.db.event_log

    def _encode(self, key: str, rows):
        return _encode_query(rows) if key == "query_log" else _encode_event(rows)

    def _decode(self, key: str, row):
        return _decode_query(row) if key == "query_log" else _decode_event(row)

    # --------------------------------------------------------------- flush
    def _loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — logging must not crash serving
                from .event_log import GLOBAL_COUNTERS

                GLOBAL_COUNTERS.bump("SystemLogFlushErrors")

    def truncate(self, which: str) -> None:
        """TRUNCATE TABLE system.<log>: drop the persisted rows and reset
        the flush cursor so cleared ring entries are not re-flushed."""
        with self._lock:
            t = self._tables.get(which)
            if t is not None:
                t.truncate()
            self._cursors[which] = 0

    def flush(self) -> int:
        """Drain ring tails into the backing tables (one segment per
        non-empty flush) and persist the new segment incrementally."""
        from ..storage import persistence

        flushed = 0
        with self._lock:
            for key, t in self._tables.items():
                rows, cur = self._source(key).drain(self._cursors[key])
                if not rows:
                    self._cursors[key] = cur
                    continue
                seg_id = t.insert(self._encode(key, rows))
                self._cursors[key] = cur
                flushed += len(rows)
                root = t.storage_dir
                if root:
                    os.makedirs(root, exist_ok=True)
                    spath = os.path.join(root, "schema.json")
                    if not os.path.isfile(spath):
                        with open(spath, "w") as f:
                            json.dump(
                                {
                                    "columns": persistence.schema_to_json(
                                        t.schema
                                    ),
                                    "engine": {"name": t.engine},
                                },
                                f,
                            )
                    seg = next(
                        s for s in t.live_segments()
                        if s.segment_id == seg_id
                    )
                    persistence.save_segment(
                        seg, os.path.join(root, f"segment_{seg_id}")
                    )
        return flushed

    # ---------------------------------------------------------------- read
    def rows(self, key: str) -> List[Dict[str, Any]]:
        """Persisted history + the not-yet-flushed ring tail, in event
        order (the retroactively-queryable SystemLog view)."""
        t = self._tables[key]
        out: List[Dict[str, Any]] = []
        cols = list(t.schema.scalar_columns())
        for seg in sorted(t.live_segments(), key=lambda s: s.segment_id):
            alive = np.nonzero(~seg.deleted_host()[: seg.n_rows])[0]
            lists = [seg.scalar(c)[alive].tolist() for c in cols]
            out.extend(
                self._decode(key, dict(zip(cols, vals)))
                for vals in zip(*lists)
            )
        with self._lock:
            tail, _ = self._source(key).drain(self._cursors[key])
        out.extend(tail)
        return out

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        try:
            self.flush()
        except Exception:  # noqa: BLE001
            pass
