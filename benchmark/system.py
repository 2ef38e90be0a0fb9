"""The system under test: myscaledb_tpu_torch through its public API.

Builds the configuration's table (one insert of every row, one segment)
and the index the traffic searches through. Where the configuration has
`documents`, the table also holds each row's document in a String column,
filled by the same insert, and the configuration's `fts` index over it.
Every call the loops time goes through `Table.search`,
`Table.text_search` or `Table.hybrid_search`; ids are read back with
`Table.gather`.
"""

from __future__ import annotations

import gc
import time
from typing import List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

TABLE, COLUMN, TEXT = "bench", "vec", "text"


class PortTable:
    def __init__(self, config, traffic, rows: np.ndarray, device,
                 documents: Optional[List[str]] = None):
        import myscaledb_tpu_torch as ms

        st = ms.Settings()
        st.table.storage_dtype = config["storage_dtype"]
        st.table.float_vector_search_metric_type = config["metric"]
        if traffic.get("top_k_multiple_base") is not None:
            st.query.hybrid_search_top_k_multiple_base = int(traffic["top_k_multiple_base"])
        self.db = ms.connect(st, device=device)
        schema = {"id": ms.UInt64(), COLUMN: ms.FloatVector(int(config["dim"]))}
        data = {"id": np.arange(rows.shape[0], dtype=np.uint64), COLUMN: rows}
        if documents is not None:
            schema[TEXT] = ms.String()
            data[TEXT] = documents
        self.table = self.db.create_table(TABLE, ms.Schema(schema))
        self.seconds = {}  # the set-up's steps: insert, fts, index
        t0 = time.perf_counter()
        self.table.insert(data)
        self.seconds["insert"] = time.perf_counter() - t0
        if documents is not None:
            t0 = time.perf_counter()
            fts = config["fts"]
            self.table.add_fts_index(fts["name"], TEXT, fts.get("params"))
            self.seconds["fts"] = time.perf_counter() - t0
        self.k = int(traffic["k"])
        self.params = traffic.get("params")
        self.fusion = {key: traffic[key] for key in ("fusion_type", "fusion_k", "fusion_weight")
                       if traffic.get(key) is not None}
        index = traffic.get("index")
        if index:
            t0 = time.perf_counter()
            spec = dict(config["indexes"][index])
            self.table.add_vector_index(index, COLUMN, spec.pop("type"), **spec)
            if not self.table.wait_index_built(timeout=600):
                raise RuntimeError(f"the {index} index was not built")
            self.seconds["index"] = time.perf_counter() - t0

    def ids(self, answer) -> np.ndarray:
        """int64[Q, k]: the id column of each hit, -1 where the answer has
        no row."""
        got = self.table.gather(answer, ["id"])["id"].astype(np.int64)
        return np.where(answer.rows >= 0, got, -1)

    def search(self, queries: np.ndarray):
        """One batch: (the result, its ids on the host)."""
        with record_function("bench.search"):
            res = self.table.search(COLUMN, queries, self.k, params=self.params)
        with record_function("bench.gather"):
            return res, self.ids(res)

    def text_search(self, texts: List[str]):
        """One batch of query texts, BM25 over the text column: (the
        result, its ids on the host)."""
        with record_function("bench.search"):
            res = self.table.text_search(TEXT, texts, self.k)
        with record_function("bench.gather"):
            return res, self.ids(res)

    def hybrid_search(self, queries: np.ndarray, texts: List[str]):
        """One batch of query vectors and their texts, fused as the traffic
        says: (the result, its ids on the host)."""
        with record_function("bench.search"):
            res = self.table.hybrid_search(COLUMN, TEXT, queries, texts, self.k,
                                           params=self.params, **self.fusion)
        with record_function("bench.gather"):
            return res, self.ids(res)

    def close(self) -> None:
        """Let go of the table, its programs and the device memory they
        hold."""
        import torch

        self.db.drop_table(TABLE)
        self.db.close()
        self.table = self.db = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def counters() -> dict:
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    return GLOBAL_COUNTERS.snapshot()


def delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(before) | set(after)}


def route_counters(traffic) -> List[Tuple[str, str]]:
    """The counters that one call on the traffic's route bumps, each with
    what it counts once: a "search" (one call) or a "query" (each query of
    the batch). By the traffic's `mode`: "vector" (the default) the vector
    search's own counter, the index's or the exact scan's; "text" BM25's;
    "hybrid" the fusion's, its vector leg's and its text leg's."""
    vector = ("VectorIndexSearches" if traffic.get("index") else "VectorBruteForceSearches",
              "search")
    mode = traffic.get("mode", "vector")
    if mode == "vector":
        return [vector]
    if mode == "text":
        return [("TextSearchQueries", "query")]
    if mode == "hybrid":
        return [("HybridSearchQueries", "query"), vector, ("TextSearchQueries", "query")]
    raise ValueError(f"traffic mode {mode!r}")
