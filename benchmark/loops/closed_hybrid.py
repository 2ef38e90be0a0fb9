"""Closed loop of hybrid searches: `closed.py`'s loop (one client sends a
batch, waits for its ids on the host, then sends the next), each call a
hybrid search of the batch's query vectors and their query texts,
`Table.hybrid_search`: the vector leg through the traffic's index (or the
exact scan) at its `params`, the text leg BM25 over the configuration's
`fts` index, both legs fused on the device.

Traffic keys: those of `closed.py`, `mode` "hybrid", `reference`
"bm25_fusion", and the fusion's: `fusion_type` ("rrf" or "rsf"),
`fusion_k` (RRF), `fusion_weight` (RSF), `top_k_multiple_base` (each leg
fetches k times it); the program's settings where one is left out. The
batches are `closed.py`'s, each with the query texts of its pool queries.
"""

from __future__ import annotations

import os

from benchmark.spec import load_module

_closed = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "closed.py"),
                      "closed")
READS_TEXTS = True  # the harness hands `plan` the pool's query texts


def plan(traffic, pool, rng, *, texts) -> list:
    """(pool indices, (their vectors, their query texts)) of every distinct
    batch."""
    return [(idx, (q, [texts[i] for i in idx.tolist()]))
            for idx, q in _closed.plan(traffic, pool, rng)]


class Hybrid:
    """The system under test, each batch a hybrid search."""

    def __init__(self, sut):
        self.sut = sut

    def search(self, batch):
        return self.sut.hybrid_search(*batch)


def warm(sut, traffic, plan) -> None:
    _closed.warm(Hybrid(sut), traffic, plan)


def traced(sut, traffic, plan, rng) -> dict:
    return _closed.traced(Hybrid(sut), traffic, plan, rng)


def run(sut, traffic, plan, seconds, rng, **kw) -> dict:
    return _closed.run(Hybrid(sut), traffic, plan, seconds, rng, **kw)
