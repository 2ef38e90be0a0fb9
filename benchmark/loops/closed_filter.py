"""Closed loop with a pre-filter: `closed.py`'s loop (one client sends a
batch, waits for its ids on the host, then sends the next), each call a
filtered search.

Traffic keys: those of `closed.py`, and `filter` ({"column", "op",
"value"}): the WHERE clause every search passes into the index search,
`Table.search(..., filter=F(column) <op> value)`.
"""

from __future__ import annotations

import os

from torch.profiler import record_function

from benchmark.spec import load_module
from benchmark.system import COLUMN

_closed = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "closed.py"),
                      "closed")
plan = _closed.plan

OPS = {"<": lambda f, v: f < v, "<=": lambda f, v: f <= v, ">": lambda f, v: f > v,
       ">=": lambda f, v: f >= v, "==": lambda f, v: f == v, "!=": lambda f, v: f != v}


class Filtered:
    """The system under test, each search under the traffic's filter."""

    def __init__(self, sut, spec):
        from myscaledb_tpu_torch import F

        self.sut = sut
        self.filter = OPS[spec["op"]](F(spec["column"]), spec["value"])

    def search(self, queries):
        """One batch: (the result, its ids on the host)."""
        sut = self.sut
        with record_function("bench.search"):
            res = sut.table.search(COLUMN, queries, sut.k, filter=self.filter, params=sut.params)
        with record_function("bench.gather"):
            return res, sut.ids(res)


def warm(sut, traffic, plan) -> None:
    _closed.warm(Filtered(sut, traffic["filter"]), traffic, plan)


def traced(sut, traffic, plan, rng) -> dict:
    return _closed.traced(Filtered(sut, traffic["filter"]), traffic, plan, rng)


def run(sut, traffic, plan, seconds, rng, **kw) -> dict:
    return _closed.run(Filtered(sut, traffic["filter"]), traffic, plan, seconds, rng, **kw)
