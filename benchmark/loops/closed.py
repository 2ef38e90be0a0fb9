"""Closed loop: one client sends a batch, waits for its ids on the host,
then sends the next.

Traffic keys: `batch` (queries a call), `k`, `warm_calls` (calls of the
one shape before the window), `keep_calls` (calls whose answers are judged:
a reservoir sample drawn from the seed), `trace_calls` (calls in the traced
window). Batches are drawn cyclically from the configuration's query pool,
in an order drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np


def plan(traffic, pool: np.ndarray, rng) -> list:
    """(pool indices, queries) of every distinct batch: the pool in a
    seeded order, cut cyclically into batches until the cycle closes."""
    b = int(traffic["batch"])
    n = pool.shape[0]
    order = rng.permutation(n)
    count = np.lcm(n, b) // b
    out = []
    for i in range(count):
        idx = order[(i * b + np.arange(b)) % n]
        out.append((idx, np.ascontiguousarray(pool[idx])))
    return out


def warm(sut, traffic, plan) -> None:
    for i in range(int(traffic["warm_calls"])):
        sut.search(plan[i % len(plan)][1])


def traced(sut, traffic, plan, rng) -> dict:
    """The traced window: `trace_calls` calls."""
    return run(sut, traffic, plan, 0.0, rng, calls=int(traffic["trace_calls"]), keep=False)


def run(sut, traffic, plan, seconds, rng, *, calls=None, keep=True) -> dict:
    """Drive the loop for `seconds` (or exactly `calls` calls). Returns the
    per-call latencies, the queries answered, the window's length, the
    queries of calls that raised (and the first error), and the kept
    answers [(pool indices, ids, distances)]."""
    size = int(traffic["keep_calls"]) if keep else 0
    # drawn before the clock starts, and only where a sample is kept: the
    # traced window opens right before this call
    draws = rng.random(1 << 20) if size else None
    kept, lat = [], []
    failed, error = 0, None
    i = 0
    nb = len(plan)
    first = int(traffic["warm_calls"])  # the window goes on where the warm-up stopped
    t0 = last = time.perf_counter()
    end = t0 + seconds
    while (i < calls) if calls is not None else (time.perf_counter() < end):
        idx, qb = plan[(first + i) % nb]
        s = time.perf_counter()
        try:
            res, ids = sut.search(qb)
        except Exception as e:  # noqa: BLE001 — a failed call is counted, the loop goes on
            failed += 1
            error = error or repr(e)
            res = None
        last = time.perf_counter()
        lat.append(last - s)
        if res is not None and size:
            # reservoir sampling: every call equally likely to be kept
            if len(kept) < size:
                kept.append((idx, ids, res))
            else:
                j = int(draws[i % draws.size] * (i + 1))
                if j < size:
                    kept[j] = (idx, ids, res)
        i += 1
    sample = [(idx, ids, res.distances) for idx, ids, res in kept]
    return {"latencies_s": np.asarray(lat), "queries": (i - failed) * int(traffic["batch"]),
            "window_s": last - t0,
            "attempted": i * int(traffic["batch"]), "failed": failed * int(traffic["batch"]),
            "unanswered": failed * int(traffic["batch"]), "searches": i, "sample": sample,
            "error": error}
