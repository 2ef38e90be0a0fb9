"""Plain reference of a BM25 text search (Okapi BM25, OR semantics).

The semantics the configurations state: the table's `fts` index analyses
each document and each query text by its params, and a text search
returns the k rows of highest BM25 score among the rows that hold at least
one of the query's terms, with that score. Restated here from the public
definitions, not from the program:

  * analysis: the text lower-cased (`lower_case`, default true), cut into
    the runs of `[0-9A-Za-z_]+`, each run kept as a term when its length
    lies in [`min_token_len`, `max_token_len`] (defaults 1 and 64) and it
    is not a stop word (`stop_words`: "english", or a list); a query's
    terms are its distinct terms, each once (the benchmark's query texts
    hold no apostrophe, so no possessive rule applies);
  * BM25 of row d: the sum over the query's terms t that d holds of
    idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl)), k1 1.2,
    b 0.75, idf(t) = ln(1 + (N - n + 0.5) / (n + 0.5)) with N the table's
    rows and n the rows holding t, dl the row's terms and avgdl their mean
    over the table.

The documents come as the benchmark makes them (corpus.Text: a vocabulary
and each row's words): a document is its words joined by single spaces,
and no term spans a space, so a row's terms are its words' terms in order.
Float64 on the device; it imports nothing of the program and reads
nothing the program made.

Exact ties are common (equal lengths, tf 1). The order is score
descending, then row ascending; a served row is given its one score,
whatever its place (`ranked`: lo == hi).

`control` is the same search one precision lower, for the check that the
comparison can fail: the configuration scores in float32, so the control
scores in float32 with each idf and each row's length norm rounded to
bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

ORDER = "desc"  # higher scores are better
TEXTS = True  # takes the documents and the query texts
K1, B = 1.2, 0.75
TERM_CHARS = frozenset("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_")
ENGLISH_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such that the their "
    "then there these they this to was will with".split())


class Analyzer:
    """The `fts` params' analysis of a text into terms."""

    def __init__(self, params=None):
        params = dict(params or {})
        self.lower = bool(params.get("lower_case", True))
        stops = params.get("stop_words")
        if stops == "english":
            self.stops = ENGLISH_STOPWORDS
        else:
            self.stops = frozenset(w.lower() if self.lower else w for w in (stops or ()))
        self.shortest = int(params.get("min_token_len", 1))
        self.longest = int(params.get("max_token_len", 64))

    def terms(self, text: str) -> list:
        text = text.lower() if self.lower else text
        runs = "".join(c if c in TERM_CHARS else " " for c in text).split()
        return [t for t in runs if self.shortest <= len(t) <= self.longest and t not in self.stops]


class Index:
    """The table's term statistics on the device: each row's length, and
    each term's rows and term frequencies (term-major)."""

    def __init__(self, text, config, device):
        self.device = dev = torch.device(device)
        self.analyzer = Analyzer(config["fts"].get("params"))
        self.term_id: dict = {}
        # each vocabulary word's terms, as ids into the term dictionary
        word_terms = [[self.term_id.setdefault(t, len(self.term_id))
                       for t in self.analyzer.terms(w)] for w in text.vocab]
        count = torch.tensor([len(ts) for ts in word_terms], dtype=torch.int64, device=dev)
        start = torch.cumsum(count, 0) - count
        flat = torch.tensor([t for ts in word_terms for t in ts], dtype=torch.int64, device=dev)
        n = len(text.offsets) - 1
        words = torch.from_numpy(np.asarray(text.ids, np.int64)).to(dev)
        per_row = torch.from_numpy(np.diff(np.asarray(text.offsets, np.int64))).to(dev)
        lens = count[words]  # terms of each word of the table
        row = torch.repeat_interleave(
            torch.repeat_interleave(torch.arange(n, device=dev), per_row), lens)
        first = torch.repeat_interleave(start[words], lens)
        within = torch.arange(row.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(lens, 0) - lens, lens)
        term = flat[first + within] if flat.numel() else row[:0]
        self.n = n
        self.dl = torch.bincount(row, minlength=n).to(torch.float64)
        self.avgdl = float(self.dl.sum()) / max(n, 1)
        pair, tf = torch.unique(term * n + row, sorted=True, return_counts=True)
        self.rows = pair % n  # term-major: the rows of term 0, then of term 1, ...
        self.tf = tf.to(torch.float64)
        self.df = torch.bincount(pair // n, minlength=len(self.term_id)).cpu().numpy()
        self.start = np.concatenate([[0], np.cumsum(self.df)])

    def query(self, text: str) -> list:
        """The query's distinct terms that some row holds, as term ids."""
        seen = []
        for t in self.analyzer.terms(text):
            tid = self.term_id.get(t)
            if tid is not None and self.df[tid] > 0 and tid not in seen:
                seen.append(tid)
        return seen

    def scores(self, text: str, low: bool = False):
        """(BM25 of every row, 0 where it holds no term: f64[N], or f32
        with bf16 idf and norms where `low`; bool[N]: the rows holding
        one)."""
        dt = torch.float32 if low else torch.float64
        out = torch.zeros(self.n, dtype=dt, device=self.device)
        hit = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        norm = (1.0 - B) + B * self.dl / self.avgdl
        norm = norm.to(torch.bfloat16).to(dt) if low else norm
        for tid in self.query(text):
            a, b = int(self.start[tid]), int(self.start[tid + 1])
            rows, tf = self.rows[a:b], self.tf[a:b].to(dt)
            n_t = float(self.df[tid])
            idf = torch.tensor(np.log(1.0 + (self.n - n_t + 0.5) / (n_t + 0.5)), dtype=dt)
            idf = idf.to(torch.bfloat16).to(dt) if low else idf
            out.index_add_(0, rows, idf * tf * (K1 + 1.0) / (tf + K1 * norm[rows]))
            hit[rows] = True
        return out, hit


def ordered(scores: torch.Tensor, hit: torch.Tensor):
    """The rows that hold a term, by score descending and then row
    ascending: (their scores, the rows)."""
    rows = torch.nonzero(hit).flatten()  # ascending
    order = torch.argsort(-scores[rows], stable=True)
    return scores[rows[order]], rows[order]


def _top(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """(f64[k] descending, -inf past the rows that match; int64[k], -1
    there) of an ordered list."""
    m = min(k, rows.numel())
    out_v, out_i = np.full(k, -np.inf), np.full(k, -1, np.int64)
    out_v[:m] = vals[:m].double().cpu().numpy()
    out_i[:m] = rows[:m].cpu().numpy()
    return out_v, out_i


def topk(rows, queries, k: int, config, device, *, texts, text, traffic=None):
    """BM25 top-k of every query text: (scores f64[Q, k] descending, -inf
    where fewer rows match; row ids int64[Q, k], -1 there)."""
    index = Index(text, config, device)
    tops = [_top(*ordered(*index.scores(q)), k) for q in texts]
    return np.stack([t[0] for t in tops]), np.stack([t[1] for t in tops])


def ranked(rows, queries, k: int, config, device, *, served, inv, texts, text, traffic=None):
    """(the top-k as `topk`, and lo, hi f64[S, m]: the score of each served
    row `served[s]` (-1: none) for the query text `texts[inv[s]]`, 0 for a
    row that holds no term; lo == hi)."""
    index = Index(text, config, device)
    vals = np.full((len(texts), k), -np.inf)
    ids = np.full((len(texts), k), -1, np.int64)
    score = np.zeros(served.shape, np.float64)
    for u, q in enumerate(texts):
        s, hit = index.scores(q)
        vals[u], ids[u] = _top(*ordered(s, hit), k)
        mine = np.nonzero(inv == u)[0]
        at = torch.from_numpy(np.maximum(served[mine], 0)).to(s.device)
        score[mine] = s[at].cpu().numpy()
    score = np.where(served >= 0, score, 0.0)
    return vals, ids, score, score


def control(rows, queries, k: int, config, device, *, texts, text, traffic=None):
    """The search one precision below the configuration's: (scores
    f32[Q, k], row ids int64[Q, k])."""
    index = Index(text, config, device)
    tops = [_top(*ordered(*index.scores(q, low=True)), k) for q in texts]
    return np.stack([t[0] for t in tops]).astype(np.float32), np.stack([t[1] for t in tops])
