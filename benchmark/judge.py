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

A reference whose scores are higher-better declares `ORDER = "desc"` (a
BM25 or a fused score: references/bm25.py, references/bm25_fusion.py),
and one that reads texts `TEXTS = True`: it is handed the query texts,
the documents and the traffic (`reference_args`). A descending reference
gives each served row the range of scores it may have, and the k-th
score that k rows surely reach (the k-th of their lowest): one value, or
a range where float32 may order near ties either way and a score follows
from ranks, as a fused one does. Then:

  bad_hits      returned slots out of range or repeated, and the gap
                between the rows returned and the rows the reference has
                to give (k, or fewer where fewer rows match)
  dist_err      the widest gap between a served score and the range of
                the same row, over |the k-th score|
  rank_gap      the widest amount by which a returned row's range lies
                below the k-th score, over |that score|
  recall        the mean share of the rows due that were returned with a
                range reaching the k-th score (BM25 ties exactly as a
                rule, so any of a tie counts)
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from benchmark.spec import load_module


def numbers(sample: List[Tuple[np.ndarray, np.ndarray, np.ndarray]], rows: np.ndarray,
            pool: np.ndarray, k: int, config, reference, device, *, text=None,
            traffic=None) -> Dict[str, float]:
    """The answer numbers of a sample [(pool index int[m], ids [m, k],
    served distances or scores [m, k])] (unanswered and route_misses come
    from the loop). `text` (corpus.Text) and `traffic` go to a reference
    that reads texts."""
    if getattr(reference, "ORDER", "asc") == "desc":
        return _numbers_desc(sample, rows, pool, k, config, reference, device, text, traffic)
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


def reference_args(reference, config, text, queries: np.ndarray, traffic) -> dict:
    """The keywords a reference that reads texts (`TEXTS = True`) takes
    beside the rows and the query vectors: the query texts of the pool
    queries `queries`, the documents (corpus.Text) and the traffic; and
    for one made of others (`LEGS`, {leg: reference name, None for the
    configuration's own}) those references, from its own directory."""
    if not getattr(reference, "TEXTS", False):
        return {}
    kw = {"texts": [text.queries[i] for i in queries], "text": text, "traffic": traffic}
    legs = getattr(reference, "LEGS", None)
    if legs:
        where = os.path.dirname(os.path.abspath(reference.__file__))
        kw["legs"] = {leg: load_module(os.path.join(where, f"{name or config['reference']}.py"),
                                       name or config["reference"])
                      for leg, name in legs.items()}
    return kw


def _numbers_desc(sample, rows, pool, k, config, reference, device, text, traffic):
    if not sample:
        return {"bad_hits": 0, "dist_err": 0.0, "rank_gap": 0.0, "recall": 0.0}
    qi = np.concatenate([s[0] for s in sample])
    ids = np.concatenate([s[1] for s in sample]).astype(np.int64)
    got = np.concatenate([s[2] for s in sample]).astype(np.float64)
    n = rows.shape[0]

    valid = ids >= 0
    inside = valid & (ids < n)
    srt = np.sort(np.where(inside, ids, -1 - np.arange(ids.shape[1])[None, :]), axis=1)
    repeated = np.zeros_like(inside)
    repeated[:, 1:] = srt[:, 1:] == srt[:, :-1]

    uniq, inv = np.unique(qi, return_inverse=True)
    top, _, lo, hi = reference.ranked(rows, pool[uniq], k, config, device,
                                      served=np.where(inside, ids, -1), inv=inv,
                                      **reference_args(reference, config, text, uniq, traffic))
    due = np.isfinite(top).sum(1)[inv]  # the rows the reference has to give, up to k
    bad = int((valid & ~inside).sum() + repeated.sum() + np.abs(valid.sum(1) - due).sum())
    if ids.shape[1] != k:
        bad += ids.size
    kth = np.where(due > 0, top[inv, np.maximum(due, 1) - 1], 0.0)
    scale = np.where(kth != 0, np.abs(kth), 1.0)[:, None]
    off = np.maximum(np.maximum(lo - got, got - hi), 0.0)
    dist_err = np.where(inside, off / scale, 0.0).max()
    rank_gap = np.where(inside, np.maximum(kth[:, None] - hi, 0.0) / scale, 0.0).max()
    # the distinct served rows whose range reaches the k-th score
    reach = np.sort(np.where(inside & (hi >= kth[:, None]), ids, -1 - np.arange(ids.shape[1])), 1)
    first = np.ones_like(inside)
    first[:, 1:] = reach[:, 1:] != reach[:, :-1]
    hit = (first & (reach >= 0)).sum(1)
    recall = float(np.where(due > 0, np.minimum(hit, due) / np.maximum(due, 1), 1.0).mean())
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
