"""The system under test: myscaledb_tpu_torch through its public API.

Builds the configuration's table (one insert of every row, one segment)
and the index the traffic searches through. Every call the loops time goes
through `Table.search`; ids are read back with `Table.gather`.
"""

from __future__ import annotations

import gc
import numpy as np
from torch.profiler import record_function

TABLE, COLUMN = "bench", "vec"


class PortTable:
    def __init__(self, config, traffic, rows: np.ndarray, device):
        import myscaledb_tpu_torch as ms

        st = ms.Settings()
        st.table.storage_dtype = config["storage_dtype"]
        st.table.float_vector_search_metric_type = config["metric"]
        self.db = ms.connect(st, device=device)
        self.table = self.db.create_table(
            TABLE, ms.Schema({"id": ms.UInt64(), COLUMN: ms.FloatVector(int(config["dim"]))}))
        self.table.insert({"id": np.arange(rows.shape[0], dtype=np.uint64), COLUMN: rows})
        self.k = int(traffic["k"])
        self.params = traffic.get("params")
        index = traffic.get("index")
        if index:
            spec = dict(config["indexes"][index])
            self.table.add_vector_index(index, COLUMN, spec.pop("type"), **spec)
            if not self.table.wait_index_built(timeout=600):
                raise RuntimeError(f"the {index} index was not built")

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


def route_counter(traffic) -> str:
    """The counter that one search bumps once on the traffic's route."""
    return "VectorIndexSearches" if traffic.get("index") else "VectorBruteForceSearches"
