"""Decide `correct`: the numbers compared with the plain reference.

A sample is what the timed path answered for some queries: the query's
index in the pool, the ids read back from the table and the distances it
served. Every number below is worked out against the configuration's
reference (references/<name>.py), which recomputes from the benchmark's
own rows and queries; the cell's file gives the limit of each number it
compares ({"max": x} or {"min": x}).

  unanswered    requests due in the window that never got an answer
  bad_hits      returned slots that are empty, out of range or repeated
  route_misses  searches that did not take the route the traffic names,
                by the program's own counter
  dist_err      the widest gap between a served distance and the
                reference's distance of the same row, over the reference's
                k-th distance of that query
  rank_gap      the widest amount by which a returned row lies beyond the
                reference's k-th distance, over that k-th distance
  recall        the mean share of the reference's top-k ids returned
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def numbers(sample: List[Tuple[np.ndarray, np.ndarray, np.ndarray]], rows: np.ndarray,
            pool: np.ndarray, k: int, config, reference, device) -> Dict[str, float]:
    """The answer numbers of a sample [(pool index int[m], ids [m, k],
    served distances [m, k])] (unanswered and route_misses come from the
    loop)."""
    if not sample:
        return {"bad_hits": 0, "dist_err": 0.0, "rank_gap": 0.0, "recall": 0.0}
    qi = np.concatenate([s[0] for s in sample])
    ids = np.concatenate([s[1] for s in sample]).astype(np.int64)
    got = np.concatenate([s[2] for s in sample]).astype(np.float64)
    n = rows.shape[0]

    inside = (ids >= 0) & (ids < n)
    srt = np.sort(np.where(inside, ids, -1 - np.arange(k)[None, :]), axis=1)
    repeated = np.zeros_like(inside)
    repeated[:, 1:] = srt[:, 1:] == srt[:, :-1]
    width_ok = ids.shape[1] == k
    bad = int((~inside).sum() + repeated.sum()) + (0 if width_ok else ids.size)

    uniq, inv = np.unique(qi, return_inverse=True)
    ref_d, ref_i = reference.topk(rows, pool[uniq], k, config, device)
    kth = ref_d[inv, k - 1]
    scale = np.where(kth > 0, kth, 1.0)[:, None]
    safe = np.where(inside, ids, 0)
    d_ref = reference.distances(rows, pool[qi], safe, config, device)
    dist_err = np.where(inside, np.abs(got - d_ref) / scale, 0.0).max()
    rank_gap = np.where(inside, np.maximum(d_ref - kth[:, None], 0.0) / scale, 0.0).max()
    want = ref_i[inv]
    hit = (ids[:, :, None] == want[:, None, :]).any(2) & inside
    recall = float(hit.sum(1).mean() / k)
    return {"bad_hits": bad, "dist_err": float(dist_err), "rank_gap": float(rank_gap),
            "recall": recall}


def compare(values: Dict[str, float], limits: Dict[str, Dict[str, float]]):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell
    compares; a number missing from `values` fails."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        if "max" in lim:
            good = v is not None and v <= lim["max"]
            out[name] = {"value": v, "limit": lim["max"], "kind": "max"}
        else:
            good = v is not None and v >= lim["min"]
            out[name] = {"value": v, "limit": lim["min"], "kind": "min"}
        ok &= bool(good)
    return ok, out
