"""Closed loop of text searches: `closed.py`'s loop (one client sends a
batch, waits for its ids on the host, then sends the next), each call a
BM25 search of the batch's query texts, `Table.text_search` over the
configuration's `fts` index.

Traffic keys: those of `closed.py`, `mode` "text" and `reference` "bm25".
The batches are `closed.py`'s, drawn from the query pool in the same
seeded order; each carries the query texts of its pool queries (the
configuration's `documents`) in the place of their vectors.
"""

from __future__ import annotations

import os

from benchmark.spec import load_module

_closed = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "closed.py"),
                      "closed")
READS_TEXTS = True  # the harness hands `plan` the pool's query texts


def plan(traffic, pool, rng, *, texts) -> list:
    """(pool indices, their query texts) of every distinct batch."""
    return [(idx, [texts[i] for i in idx.tolist()]) for idx, _ in _closed.plan(traffic, pool, rng)]


class Texts:
    """The system under test, each batch a text search."""

    def __init__(self, sut):
        self.sut = sut

    def search(self, texts):
        return self.sut.text_search(texts)


def warm(sut, traffic, plan) -> None:
    _closed.warm(Texts(sut), traffic, plan)


def traced(sut, traffic, plan, rng) -> dict:
    return _closed.traced(Texts(sut), traffic, plan, rng)


def run(sut, traffic, plan, seconds, rng, **kw) -> dict:
    return _closed.run(Texts(sut), traffic, plan, seconds, rng, **kw)
