"""Plain reference of a hybrid search: a vector leg and a BM25 leg fused by
RRF or RSF.

The semantics the configurations state (MyScaleDB's `HybridSearch`,
`src/VectorIndex/Utils/HybridSearchUtils.cpp`): each leg fetches its top
D = k x `top_k_multiple_base` rows (default 3), the vector leg by the
configuration's metric, the text leg by BM25; the fused list is the union
of the two, each row scored

  * RRF (`fusion_type` "rrf"): the sum over the legs that hold it of
    1 / (`fusion_k` + its rank there, from 1); `fusion_k` default 60;
  * RSF ("rsf"): each leg's scores min-max normalised over its D rows, 1
    the best (for a distance the smallest), then `fusion_weight` x the text
    leg's + (1 - `fusion_weight`) x the vector leg's, 0 from a leg that
    does not hold the row; `fusion_weight` default 0.5; a leg whose scores
    are all equal gives each of its rows 1;

and the k of highest fused score are returned with that score. The
parameters are the traffic's. Each leg is exact: the vector leg through
the configuration's own exact reference, the text leg through
references/bm25.py (`LEGS`: the judge hands both over as `legs`); both in
float64, importing nothing of the program and reading nothing it made.

A served fused score depends on the program's ranks, which its float32
scores may order otherwise than float64 where two rows lie within
rounding of each other. So each served row gets the range of fused scores
that its ranks allow: a row may stand anywhere among the rows whose vector
distance lies within VECTOR_TIE_RTOL of the sums behind it (for Cosine,
of 1) of its own, or whose BM25 score lies within TEXT_TIE_RTOL of its own
score (exact BM25 ties keep row order, lower row first, as float32 sums of
the same terms tie exactly too); a row that may or may not make a leg's
depth D takes 0 from it at the low end. The judge reads the served score
against that range.

`control` is the same search one precision lower: the vector leg's
reference control (bf16 queries) and BM25 in float32 with bf16 idf and
length norms.
"""

from __future__ import annotations

import numpy as np
import torch

ORDER = "desc"  # higher fused scores are better
TEXTS = True  # takes the documents and the query texts
LEGS = {"vector": None, "text": "bm25"}  # the references of the legs; None: the configuration's
MULTIPLE_BASE, FUSION_K, FUSION_WEIGHT = 3, 60, 0.5  # MyScaleDB's default settings
# float32 may order two vector distances within this share of the sums
# behind them either way (`_vector_scale`; an H100's exact Cosine scan of
# 1M x 768 rows at k 300 inverted pairs up to 1.2e-6 apart, where 2^-20
# would not hold), and two BM25 scores within this share of the score (a
# float32 sum of a few BM25 terms errs by ~2^-18 of it)
VECTOR_TIE_RTOL = 2.0**-18
TEXT_TIE_RTOL = 2.0**-16


def _params(traffic):
    t = traffic or {}
    return (str(t["fusion_type"]).lower(), int(t.get("fusion_k") or FUSION_K),
            float(FUSION_WEIGHT if t.get("fusion_weight") is None else t["fusion_weight"]),
            int(t.get("top_k_multiple_base") or MULTIPLE_BASE))


class Legs:
    """Both legs of every query: exact, or the control's where `low`. The
    vector legs of all queries at once; a text leg a query, on the
    device, as it is asked for."""

    def __init__(self, rows, queries, k, config, device, texts, text, traffic, legs, low=False):
        self.kind, self.fusion_k, self.weight, base = _params(traffic)
        if self.kind not in ("rrf", "rsf"):
            raise ValueError(f"bm25_fusion: fusion_type {self.kind!r}")
        self.depth = depth = min(k * base, rows.shape[0])
        self.vref, self.bm25 = legs["vector"], legs["text"]
        self.index = self.bm25.Index(text, config, device)
        self.texts, self.low = texts, low
        if low:
            self.vd, self.vi = self.vref.control(rows, queries, depth, config, device)
        else:
            # twice the depth, so that every row a served row's band
            # reaches inside the depth is in the list
            self.vd, self.vi = self.vref.topk(rows, queries, min(2 * depth, rows.shape[0]),
                                              config, device)
        self.vd = self.vd.astype(np.float64)
        self.vscale = _vector_scale(config, queries, rows, self.vi[:, 0])

    def text_leg(self, u: int):
        """Query u's rows that hold a term, ordered as the leg ranks them:
        (scores descending, rows) on the device."""
        return self.bm25.ordered(*self.index.scores(self.texts[u], self.low))

    def fused(self, u: int, t_vals: torch.Tensor, t_rows: torch.Tensor):
        """(rows, fused scores) of query u from the legs' own ranks, by
        fused score descending, then row ascending."""
        depth = self.depth
        v_rows = self.vi[u, :depth]
        t_top = t_vals[:depth].double().cpu().numpy()
        t_rows = t_rows[:depth].cpu().numpy()
        score: dict = {}
        if self.kind == "rrf":
            for leg in (v_rows, t_rows):
                for rank, r in enumerate(leg.tolist(), start=1):
                    score[r] = score.get(r, 0.0) + 1.0 / (self.fusion_k + rank)
        else:
            v_norm = _minmax(self.vd[u, :depth], self.vd[u, :depth], ascending=True)
            t_norm = _minmax(t_top, t_top, ascending=False)
            for leg, norm, w in ((v_rows, v_norm, 1.0 - self.weight),
                                 (t_rows, t_norm, self.weight)):
                for r, x in zip(leg.tolist(), norm.tolist()):
                    score[r] = score.get(r, 0.0) + w * x
        rows = np.fromiter(score.keys(), np.int64, len(score))
        vals = np.fromiter(score.values(), np.float64, len(score))
        order = np.lexsort((rows, -vals))
        return rows[order], vals[order]

    def ranges(self, u: int, t_vals, t_rows, served: np.ndarray, dist: np.ndarray):
        """lo, hi: the fused scores that the served rows `served` of query u
        (their vector distances `dist`; flat) may have, by the ranks their
        legs allow."""
        depth = self.depth
        ld = self.vd[u]
        band = VECTOR_TIE_RTOL * self.vscale[u]
        v_lo = 1 + np.searchsorted(ld, dist - band, side="left")
        v_hi = np.searchsorted(ld, dist + band, side="right") + ~np.isin(served, self.vi[u])
        t_lo, t_hi, own = _text_ranks(t_vals, t_rows, served, depth)
        if self.kind == "rrf":
            parts = [_rrf(lo, hi, depth, self.fusion_k) for lo, hi in ((v_lo, v_hi), (t_lo, t_hi))]
        else:
            v_leg = self.vd[u, :depth]
            t_top = t_vals[:depth].double().cpu().numpy()
            v_norm = _minmax(dist, v_leg, ascending=True)
            t_norm = _minmax(own, t_top, ascending=False)
            # a normalised score moves by its own band and the extremes'
            v_err = 3 * band / _span(v_leg)
            t_err = 3 * TEXT_TIE_RTOL * (float(t_top.max()) if t_top.size else 0.0) / _span(t_top)
            parts = [_rsf(v_lo, v_hi, depth, v_norm, v_err, 1.0 - self.weight),
                     _rsf(t_lo, t_hi, depth, t_norm, t_err, self.weight)]
        return parts[0][0] + parts[1][0], parts[0][1] + parts[1][1]


def _vector_scale(config, queries: np.ndarray, rows: np.ndarray, nearest: np.ndarray):
    """The size of the sums behind a query's distances, which their float32
    rounding scales with: 1 for Cosine (unit vectors: the sum of |q_i x_i|
    is at most 1), |q|^2 + |x|^2 of the nearest row for L2."""
    if config["metric"] == "Cosine":
        return np.ones(queries.shape[0])
    if config["metric"] == "L2":
        q, x = queries.astype(np.float64), rows[nearest].astype(np.float64)
        return (q * q).sum(1) + (x * x).sum(1)
    raise ValueError(f"bm25_fusion: metric {config['metric']!r} has no vector leg here")


def _text_ranks(t_vals: torch.Tensor, t_rows: torch.Tensor, served: np.ndarray, depth: int):
    """(lo, hi, score) of the served rows in a text leg (ordered as
    `bm25.ordered` gives it): the ranks each may take, an exact tie keeping
    its place and a score within TEXT_TIE_RTOL of its own passing it either
    way; depth + 1 for a row that holds no term."""
    n = t_rows.numel()
    want = torch.from_numpy(served.astype(np.int64)).to(t_rows.device)
    if n == 0:
        far = np.full(served.shape, depth + 1, np.int64)
        return far, far, np.zeros(served.shape)
    by_row = torch.argsort(t_rows)
    idx = torch.searchsorted(t_rows[by_row], want).clamp_(max=n - 1)
    at = by_row[idx]  # its place in the leg, the ties before it included
    held = t_rows[at] == want
    own = torch.where(held, t_vals[at], torch.zeros_like(t_vals[at]))
    asc = t_vals.flip(0)
    above = n - torch.searchsorted(asc, own, right=True)
    lo = 1 + (n - torch.searchsorted(asc, own * (1 + TEXT_TIE_RTOL), right=True)) + (at - above)
    below = torch.searchsorted(asc, own) - torch.searchsorted(asc, own * (1 - TEXT_TIE_RTOL))
    hi = 1 + at + below  # the scores just below its own may pass it
    far = torch.full_like(lo, depth + 1)
    return (torch.where(held, lo, far).cpu().numpy(), torch.where(held, hi, far).cpu().numpy(),
            own.double().cpu().numpy())


def _span(leg: np.ndarray) -> float:
    """The range of a leg's scores; inf where they are all equal (each
    normalises to 1 then, whatever its rounding)."""
    span = float(leg.max() - leg.min()) if leg.size else 0.0
    return span if span >= 1e-12 else np.inf


def _minmax(x: np.ndarray, leg: np.ndarray, ascending: bool) -> np.ndarray:
    """x min-max normalised over a leg's scores, 1 the best; all 1 where
    the leg's scores are all equal."""
    if leg.size == 0:
        return np.zeros_like(x)
    lo, hi = float(leg.min()), float(leg.max())
    if hi - lo < 1e-12:
        return np.ones_like(x)
    norm = (x - lo) / (hi - lo)
    return 1.0 - norm if ascending else norm


def _rrf(lo, hi, depth, fusion_k):
    """The range of one leg's RRF term for ranks in [lo, hi]: none past
    the depth, 0 at the low end where the rank may pass it."""
    inside = lo <= depth
    top = np.where(inside, 1.0 / (fusion_k + lo), 0.0)
    bottom = np.where(hi <= depth, 1.0 / (fusion_k + np.minimum(hi, depth)), 0.0)
    return bottom, top


def _rsf(lo, hi, depth, norm, err, weight):
    """The range of one leg's RSF term, `weight` x the row's normalised
    score `norm` (within `err`) where it makes the depth: 0 past it, from
    0 where its rank may pass it."""
    inside = lo <= depth
    low = np.where(hi <= depth, weight * np.maximum(norm - err, 0.0), 0.0)
    return low, np.where(inside, weight * (norm + err), 0.0)


def _top(legs: Legs, k: int):
    """(fused scores f64[Q, k] descending, -inf past the union of the
    legs; row ids int64[Q, k], -1 there)."""
    nq = legs.vi.shape[0]
    vals, ids = np.full((nq, k), -np.inf), np.full((nq, k), -1, np.int64)
    for u in range(nq):
        r, s = legs.fused(u, *legs.text_leg(u))
        m = min(k, r.size)
        vals[u, :m], ids[u, :m] = s[:m], r[:m]
    return vals, ids


def topk(rows, queries, k: int, config, device, *, texts, text, traffic, legs):
    """The fused top-k of every query: (scores f64[Q, k] descending, -inf
    past the union of the legs; row ids int64[Q, k], -1 there)."""
    return _top(Legs(rows, queries, k, config, device, texts, text, traffic, legs), k)


def ranked(rows, queries, k: int, config, device, *, served, inv, texts, text, traffic,
           legs):
    """(the fused scores that k rows surely reach: the k highest of the
    union's lowest fused scores, f64[Q, k] descending, -inf past the union;
    the top-k's row ids, int64[Q, k]; and lo, hi f64[S, m]: the range of
    fused scores that each served row `served[s]` (-1: none) of the query
    `inv[s]` may have, 0 for none)."""
    both = Legs(rows, queries, k, config, device, texts, text, traffic, legs)
    safe = np.maximum(served, 0)
    dist = both.vref.distances(rows, queries[inv], safe, config, device)
    vals, ids = np.full((len(texts), k), -np.inf), np.full((len(texts), k), -1, np.int64)
    lo, hi = np.zeros(served.shape), np.zeros(served.shape)
    for u in range(len(texts)):
        leg = both.text_leg(u)
        union, _ = both.fused(u, *leg)
        m = min(k, union.size)
        ids[u, :m] = union[:m]
        u_dist = both.vref.distances(rows, queries[u : u + 1], union[None, :], config, device)[0]
        vals[u, :m] = np.sort(both.ranges(u, *leg, union, u_dist)[0])[::-1][:m]
        mine = np.nonzero(inv == u)[0]
        if mine.size:
            a, b = both.ranges(u, *leg, safe[mine].ravel(), dist[mine].ravel())
            lo[mine], hi[mine] = a.reshape(-1, served.shape[1]), b.reshape(-1, served.shape[1])
    ok = served >= 0
    return vals, ids, np.where(ok, lo, 0.0), np.where(ok, hi, 0.0)


def control(rows, queries, k: int, config, device, *, texts, text, traffic, legs):
    """The search one precision below the configuration's: (scores
    f32[Q, k], row ids int64[Q, k])."""
    lower = Legs(rows, queries, k, config, device, texts, text, traffic, legs, low=True)
    vals, ids = _top(lower, k)
    return vals.astype(np.float32), ids
