"""Per-segment inverted index with device-resident postings + BM25 scoring.

Counterpart of myscaledb_tpu/text/inverted.py. Layout:

  host:   term -> term_id dict; term_offsets int64[V+1] (CSR row pointers);
          per-term doc freq (df)
  device: postings_rows int32[nnz]  (row ids, CSR order by term)
          postings_tf   f32[nnz]    (term frequency in that row)
          doc_len       f32[capacity]

on the segment's device. Scoring is Okapi BM25 with externally supplied
corpus statistics (summed over segments), in two bodies of torch ops,
each run inside a program (search/program.py: on the card one captured
CUDA graph), the store's own (`bm25_topk_batch`) or a text search's
(search/text_executor.py), over one packed int32 plan (`pack_plans`):

  * dense (`_bm25_score_topk_batch`): one term chunk per step, each
    step's contributions added into a [Q, capacity + 1] score buffer
    whose last column takes the padding slots (JAX's `mode="drop"`).
    Within one step every (query, row) cell receives at most one
    contribution (a term's postings name each row once), so the scatter
    has no order to lose, and across steps the sum runs over terms in
    order as JAX's `fori_loop` does. With each contribution computed as
    XLA computes it (`_contributions`), the scores equal the JAX
    package's on the CPU bit for bit.
  * sparse (`_bm25_sparse_topk_batch`): JAX's candidate-sparse formula,
    a stable sort by row, f32 prefix sums and a difference per run of
    equal rows. The difference of two prefix sums carries the error of
    the running total, not of the row's score: `sparse_error_bound`
    states it, and the tests hold the path to it.

Every top-k here (`topk_stable`) orders exact ties as `jax.lax.top_k`
does, lower position first; BM25 scores tie exactly as a rule (equal
document lengths and tf = 1). The dense path takes `approx` (the
approximate branch of `topk_stable`, ties among the bin winners by lower
row); the sparse path stays exact, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.topk import NEG_INF, topk_stable
from ..search.program import Program, ProgramCache, tensors_key
from .analyzer import Analyzer

BM25_K1 = 1.2
BM25_B = 0.75


@dataclasses.dataclass
class BM25Stats:
    """Corpus statistics for BM25 (BM25InfoInDataParts analogue): summed
    across segments before scoring so ranking is table-consistent."""

    total_docs: int
    total_tokens: int
    doc_freq: Dict[str, int]

    @classmethod
    def merge(cls, parts: Sequence["BM25Stats"]) -> "BM25Stats":
        df: Dict[str, int] = {}
        docs = tokens = 0
        for p in parts:
            docs += p.total_docs
            tokens += p.total_tokens
            for t, c in p.doc_freq.items():
                df[t] = df.get(t, 0) + c
        return cls(docs, tokens, df)

    def idf(self, term: str) -> float:
        n = self.doc_freq.get(term, 0)
        # Lucene/tantivy BM25 idf: ln(1 + (N - n + 0.5)/(n + 0.5))
        return float(np.log(1.0 + (self.total_docs - n + 0.5) / (n + 0.5)))

    @property
    def avg_doc_len(self) -> float:
        return self.total_tokens / max(self.total_docs, 1)


def _round_pow2(x: int, lo: int = 128, hi: int = 1 << 20) -> int:
    p = lo
    while p < min(x, hi):
        p <<= 1
    return p


# Posting-slice size per scan step. Terms with more postings are split
# into ceil(df/BUDGET_CAP) chunks host-side (no silent truncation).
BUDGET_CAP = 8192


def _slices(postings_rows, postings_tf, starts, budget):
    """(rows, tf) [..., budget] slices of the postings at `starts` [...]
    (JAX's per-query `dynamic_slice`; the build's tail padding keeps every
    slice inside the arrays)."""
    pos = starts.to(torch.int64)[..., None] + torch.arange(
        budget, dtype=torch.int64, device=starts.device
    )
    return postings_rows[pos], postings_tf[pos]


# BM25_K1 as the f32 value JAX's weak-typed Python float becomes
_K1_F32 = float(np.float32(BM25_K1))


def _contributions(rows, tf, lengths, idf, doc_len, avg_len, capacity):
    """BM25 contribution of each posting slot, in JAX's operation order
    (`inverted.py:129-133`): every constant reaches the op as f32, as
    JAX's weak-typed Python floats do. XLA on the CPU contracts
    `tf + K1 * x` into one fused multiply-add (one rounding); the port
    takes that step in f64 and rounds once to f32, which is the FMA's
    result here (the product of two f32 values is exact in f64, and the
    sum of tf >= 1 and K1 * x >= 0.3 fits its 53 bits), so the
    contributions equal the JAX package's bit for bit. Padding slots
    (offset >= length) get row `capacity` and a zero contribution."""
    budget = rows.shape[-1]
    offs = torch.arange(budget, dtype=torch.int32, device=rows.device)
    valid = offs < lengths[..., None]
    rows = torch.where(valid, rows, torch.full_like(rows, capacity))
    dl = doc_len[torch.clamp(rows, max=capacity - 1).to(torch.int64)]
    x = (1.0 - BM25_B) + BM25_B * dl / avg_len
    denom = (tf.to(torch.float64) + _K1_F32 * x.to(torch.float64)).to(torch.float32)
    contrib = idf[..., None] * tf * (BM25_K1 + 1.0) / torch.clamp(denom, min=1e-9)
    return rows, torch.where(valid, contrib, torch.zeros_like(contrib)), valid


def _tags(vals: torch.Tensor, rows: torch.Tensor):
    """(rows, tags) with -1 in the empty slots; tag 0 = this segment."""
    rows = torch.where(torch.isfinite(vals), rows, torch.full_like(rows, -1))
    return rows, torch.where(rows >= 0, torch.zeros_like(rows), torch.full_like(rows, -1))


def _bm25_score_topk_batch(
    postings_rows: torch.Tensor,  # int32[nnz_pad]
    postings_tf: torch.Tensor,  # f32[nnz_pad]
    doc_len: torch.Tensor,  # f32[capacity]
    qints: torch.Tensor,  # int32[Q, 2T+1]: starts | lengths | n_required
    idfs: torch.Tensor,  # f32[Q, T] idf of the chunk's term
    avg_len: torch.Tensor,  # f32 scalar
    mask: Optional[torch.Tensor],  # bool[capacity] | bool[Q, capacity] | None
    *,
    budget: int,
    capacity: int,
    k: int,
    need_counts: bool,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched dense BM25: add every query's term chunks into per-row
    scores, one chunk per step in order, then a tie-stable top-k per query
    (with `approx`, its approximate branch).
    A term's chunks partition its posting rows, so the per-row
    matched-term count used for AND semantics is unaffected by chunking.
    need_counts=False (OR queries) skips the matched-term count: a BM25
    contribution is strictly positive, so score > 0 IS the matched test.
    Returns (vals f32[Q, k], rows int32[Q, k], tags int32[Q, k])."""
    nq, nt = idfs.shape
    dev = postings_rows.device
    starts, lengths, n_required = qints[:, :nt], qints[:, nt : 2 * nt], qints[:, 2 * nt]
    # column `capacity` takes the padding slots' zero contributions
    scores = torch.zeros((nq, capacity + 1), dtype=torch.float32, device=dev)
    nmatch = torch.zeros((nq, capacity + 1), dtype=torch.int32, device=dev) if need_counts else None
    for t in range(nt):
        rows, tf = _slices(postings_rows, postings_tf, starts[:, t], budget)
        rows, contrib, valid = _contributions(
            rows, tf, lengths[:, t], idfs[:, t], doc_len, avg_len, capacity
        )
        idx = rows.to(torch.int64)
        scores.scatter_add_(1, idx, contrib)
        if nmatch is not None:
            nmatch.scatter_add_(1, idx, valid.to(torch.int32))
    scores = scores[:, :capacity]
    if need_counts:
        hit = nmatch[:, :capacity] >= n_required[:, None]
    else:
        # OR semantics with >= 1 term present; empty queries are encoded by
        # the caller as n_required > nt and match nothing
        hit = torch.logical_and(scores > 0.0, (n_required <= nt)[:, None])
    if mask is not None:
        hit = torch.logical_and(hit, mask if mask.dim() == 2 else mask[None, :])
    scores = torch.where(hit, scores, torch.full_like(scores, NEG_INF))
    vals, rows = topk_stable(scores, k, approx=approx)
    rows, tags = _tags(vals, rows)
    return vals, rows, tags


def _pad_pow2(x: int, lo: int = 4) -> int:
    p = lo
    while p < x:
        p <<= 1
    return p


# Sparse-path cap: total candidate postings per query (nt * budget) at or
# below this use the sort-based program; above it, the dense one.
SPARSE_CAP = 16384
# below this capacity the dense buffer is small enough that the dense
# program wins (no sort, fewer passes)
SPARSE_MIN_CAPACITY = 256 * 1024
# The sparse path's score of a row is the difference of two f32 prefix
# sums over the query's sorted candidates: its error is a few ulps of the
# running total there, whatever the summation order (a sequential sum, an
# XLA reduce_window or a parallel scan on the card). SPARSE_ULPS ulps of
# the query's largest prefix sum bound it (`sparse_error_bound`).
SPARSE_ULPS = 16
# Both paths' error against an exact BM25 of the same row, apart from the
# sparse path's prefix sums: about eight f32 roundings per contribution
# (the f32 idf, avg_len and constants among them) and one per term added,
# ~1e-6 of the score at eight terms; 2^-18 of the score bounds it.
DENSE_RTOL = 2.0**-18


def sparse_error_bound(prefix_max: torch.Tensor) -> torch.Tensor:
    """The sparse path's error bound for each query: SPARSE_ULPS f32 ulps
    of its largest prefix sum (`prefix_max`, f32[Q]; the total of its
    candidate contributions, all of which are >= 0)."""
    pm = torch.clamp(prefix_max.to(torch.float32), min=torch.finfo(torch.float32).tiny)
    ulp = torch.nextafter(pm, torch.full_like(pm, float("inf"))) - pm
    return SPARSE_ULPS * ulp


def _bm25_sparse_topk_batch(
    postings_rows: torch.Tensor,  # int32[nnz_pad]
    postings_tf: torch.Tensor,  # f32[nnz_pad]
    doc_len: torch.Tensor,  # f32[capacity]
    qints: torch.Tensor,  # int32[Q, 2T+1]: starts | lengths | n_required
    idfs: torch.Tensor,  # f32[Q, T]
    avg_len: torch.Tensor,  # f32 scalar
    mask: Optional[torch.Tensor],  # bool[capacity] | bool[Q, capacity] | None
    *,
    budget: int,
    capacity: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate-sparse BM25: gather every query's candidate postings
    ([Q, T*budget] rows + contributions), sort by row id (stably, as
    `jnp.argsort`), take run totals as differences of prefix sums and
    top-k them. Work scales with the query's own posting mass, not the
    corpus. A term's chunks partition its postings, so a run's length
    equals its distinct matched terms: the AND-semantics counter.
    Returns (vals, rows, tags, prefix_max f32[Q]): the last is the
    largest prefix sum of each query, for `sparse_error_bound`."""
    nq, nt = idfs.shape
    starts, lengths, n_required = qints[:, :nt], qints[:, nt : 2 * nt], qints[:, 2 * nt]
    rows, tf = _slices(postings_rows, postings_tf, starts, budget)  # [Q, T, B]
    rows, contrib, _ = _contributions(rows, tf, lengths, idfs, doc_len, avg_len, capacity)
    rows = rows.reshape(nq, -1)  # pad -> sentinel `capacity` (sorts last)
    contrib = contrib.reshape(nq, -1)
    r_s, order = torch.sort(rows, dim=-1, stable=True)
    c_s = torch.gather(contrib, -1, order)
    csum = torch.cumsum(c_s, dim=-1)
    change = r_s[:, 1:] != r_s[:, :-1]
    ones = torch.ones((nq, 1), dtype=torch.bool, device=rows.device)
    is_end = torch.cat([change, ones], dim=-1)
    is_start = torch.cat([ones, change], dim=-1)
    pos = torch.arange(r_s.shape[-1], dtype=torch.int64, device=rows.device)
    # for every position, the index of its run's start (max start pos <= i)
    start_pos = torch.cummax(
        torch.where(is_start, pos[None, :], torch.full_like(r_s, -1, dtype=torch.int64)), dim=1
    ).values
    before = torch.gather(csum, -1, torch.clamp(start_pos - 1, min=0))
    csum_before = torch.where(start_pos > 0, before, torch.zeros_like(before))
    run_score = csum - csum_before  # valid at run ends
    run_len = pos[None, :] - start_pos + 1
    hit = torch.logical_and(is_end, r_s < capacity)
    hit = torch.logical_and(hit, run_len >= n_required[:, None])
    if mask is not None:
        mrow = torch.clamp(r_s, max=capacity - 1).to(torch.int64)
        mv = torch.gather(mask, -1, mrow) if mask.dim() == 2 else mask[mrow]
        hit = torch.logical_and(hit, mv)
    scores = torch.where(hit, run_score, torch.full_like(run_score, NEG_INF))
    kk = min(k, scores.shape[-1])
    vals, pos2 = topk_stable(scores, kk)
    out_rows = torch.gather(r_s, -1, pos2.to(torch.int64))
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        out_rows = torch.nn.functional.pad(out_rows, (0, k - kk), value=-1)
    out_rows, tags = _tags(vals, out_rows)
    return vals, out_rows, tags, csum[:, -1]


def _phrase_doc_counts(
    stream: torch.Tensor,  # int32[Lpad] (padding = -1)
    tids: torch.Tensor,  # int32[m] phrase term ids
    doc_bounds: torch.Tensor,  # int32[capacity + 1] token offsets per doc
) -> torch.Tensor:
    """Streaming phrase match over the document-ordered token stream:
    position p starts the phrase iff stream[p+i] == tids[i] for all i, and
    a start counts for doc r when it lies in [bounds[r], bounds[r+1] - m
    + 1), which confines the phrase to the doc. Returns int32[capacity]
    phrase-occurrence counts per row: aligned slices, one prefix sum, one
    sorted gather."""
    m = int(tids.shape[0])
    lw = stream.shape[0] - m + 1  # phrase-start window
    match = torch.ones((lw,), dtype=torch.bool, device=stream.device)
    for i in range(m):
        match = torch.logical_and(match, stream[i : i + lw] == tids[i])
    # m0[p] = number of phrase starts strictly before token p
    m0 = torch.zeros((lw + 1,), dtype=torch.int32, device=stream.device)
    m0[1:] = torch.cumsum(match.to(torch.int32), dim=0)
    lo = torch.clamp(doc_bounds[:-1], max=lw)
    hi = torch.maximum(torch.clamp(doc_bounds[1:] - (m - 1), max=lw), lo)
    return m0[hi.to(torch.int64)] - m0[lo.to(torch.int64)]


class Plan(NamedTuple):
    """One store's plan of a batch (`InvertedIndex.plan_terms`)."""

    qints: np.ndarray  # int32[Q, 2T+1]: starts | lengths | n_required
    idfs: np.ndarray  # f32[Q, T]
    budget: int
    route: str  # "sparse" | "dense"
    need_counts: bool


def query_terms(analyzer: Analyzer, queries: Sequence[str]) -> List[List[str]]:
    """Each query's analyzed terms, each term once (first occurrence)."""
    out: List[List[str]] = []
    for query in queries:
        seen: set = set()
        out.append([t for t in analyzer.tokenize_query(query) if not (t in seen or seen.add(t))])
    return out


def pad_queries(nq: int) -> int:
    """A text batch's rows in a program: a multiple of 8, as the vector
    path pads (the JAX package keys on the exact count)."""
    return max(8, -(-nq // 8) * 8)


def pack_plans(plans: Sequence[Plan], avg_len: float, nq_pad: int):
    """The plans of a search's stores in one int32[nq_pad, W] array, the
    program's one host input: column 0 holds avg_len's f32 bits, then
    each store's qints (2T+1 columns) and the f32 bits of its idfs (T).
    Rows past the batch are empty queries (n_required = T + 1, no
    postings), so their slots come out empty in every route. Returns
    (packed, each store's column offset)."""
    width = 1 + sum(3 * p.idfs.shape[1] + 1 for p in plans)
    packed = np.zeros((nq_pad, width), np.int32)
    packed[:, 0] = np.float32(avg_len).view(np.int32)
    offs = []
    col = 1
    for p in plans:
        nq, nt = p.idfs.shape
        packed[:nq, col : col + 2 * nt + 1] = p.qints
        packed[nq:, col + 2 * nt] = nt + 1
        packed[:nq, col + 2 * nt + 1 : col + 3 * nt + 1] = p.idfs.view(np.int32)
        offs.append(col)
        col += 3 * nt + 1
    return packed, offs


def store_topk(tensors, plan: torch.Tensor, off: int, nt: int, mask, *, route: str, budget: int,
               capacity: int, k: int, need_counts: bool, approx: bool):
    """One store's BM25 top-k over its columns of a packed plan (a program
    body): the sparse or the dense path. `tensors` = (postings_rows,
    postings_tf, doc_len). Returns (vals, rows, tags, prefix_max | None)."""
    qints = plan[:, off : off + 2 * nt + 1]
    idfs = plan[:, off + 2 * nt + 1 : off + 3 * nt + 1].view(torch.float32)
    avg_len = plan[0, 0].view(torch.float32)
    args = (*tensors, qints, idfs, avg_len, mask)
    if route == "sparse":
        return _bm25_sparse_topk_batch(*args, budget=budget, capacity=capacity, k=k)
    vals, rows, tags = _bm25_score_topk_batch(
        *args, budget=budget, capacity=capacity, k=k, need_counts=need_counts, approx=approx
    )
    return vals, rows, tags, None


class InvertedIndex:
    """Built per (segment, text columns): the TantivyIndexStore analogue.
    Multi-column: tokens of all indexed columns are concatenated per row.
    `builder` records which build ran: "native" (the C++ tokenizer) or
    "python"."""

    def __init__(
        self,
        capacity: int,
        n_rows: int,
        vocab: Dict[str, int],
        term_offsets: np.ndarray,
        postings_rows: torch.Tensor,
        postings_tf: torch.Tensor,
        doc_len: torch.Tensor,
        stats: BM25Stats,
        analyzer: Analyzer,
        token_stream: Optional[np.ndarray] = None,
        builder: str = "python",
    ):
        self.capacity = capacity
        self.n_rows = n_rows
        self.vocab = vocab
        self.term_offsets = term_offsets  # host int64[V+1]
        self.postings_rows = postings_rows
        self.postings_tf = postings_tf
        self.doc_len = doc_len
        self.stats = stats
        self.analyzer = analyzer
        self.builder = builder
        # Token-id stream in document order (filtered tokens only): the
        # device-side phrase representation. None on stores that predate
        # it (phrase verification then falls back to the host path).
        self._stream_host = token_stream  # int32[total_tokens] or None
        self._stream_dev = None  # (padded stream, doc_bounds), uploaded once
        # the store's own programs (bm25_topk_batch, the phrase counts);
        # they read only its immutable tensors and go with it
        self._programs = ProgramCache()

    @property
    def device(self) -> torch.device:
        return self.postings_rows.device

    @property
    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """What a BM25 body reads of the store: (postings_rows,
        postings_tf, doc_len)."""
        return self.postings_rows, self.postings_tf, self.doc_len

    # ------------------------------------------------------------- build
    @classmethod
    def build(
        cls,
        texts_per_column: List[np.ndarray],
        capacity: int,
        *,
        device,
        analyzer: Optional[Analyzer] = None,
        use_native: bool = True,
    ) -> "InvertedIndex":
        analyzer = analyzer or Analyzer()
        device = torch.device(device)
        n_rows = len(texts_per_column[0])
        if use_native:
            native_out = cls._build_native(texts_per_column, capacity, analyzer, device)
            if native_out is not None:
                return native_out
        vocab: Dict[str, int] = {}
        # first pass: tokenize, count tf per (term, row)
        doc_len = np.zeros(capacity, np.float32)
        tf_maps: List[Dict[int, int]] = []
        stream: List[int] = []
        total_tokens = 0
        for row in range(n_rows):
            tf: Dict[int, int] = {}
            for col in texts_per_column:
                for tok in analyzer.tokenize(str(col[row])):
                    tid = vocab.setdefault(tok, len(vocab))
                    tf[tid] = tf.get(tid, 0) + 1
                    stream.append(tid)
            ntok = sum(tf.values())
            doc_len[row] = ntok
            total_tokens += ntok
            tf_maps.append(tf)
        v = len(vocab)
        df = np.zeros(v, np.int64)
        for tf in tf_maps:
            for tid in tf:
                df[tid] += 1
        offsets = np.zeros(v + 1, np.int64)
        np.cumsum(df, out=offsets[1:])
        nnz = int(offsets[-1])
        # tail padding >= the largest possible slice budget, so a term
        # slice [start, start+budget) never runs off the arrays
        max_df = int(df.max()) if v else 1
        nnz_pad = nnz + _round_pow2(max(max_df, 128))
        prow = np.zeros(nnz_pad, np.int32)
        ptf = np.zeros(nnz_pad, np.float32)
        cursor = offsets[:-1].copy()
        for row, tf in enumerate(tf_maps):
            for tid, c in tf.items():
                p = cursor[tid]
                prow[p] = row
                ptf[p] = c
                cursor[tid] = p + 1
        doc_freq = {t: int(df[i]) for t, i in vocab.items()}
        stats = BM25Stats(n_rows, total_tokens, doc_freq)
        return cls(
            capacity, n_rows, vocab, offsets,
            torch.from_numpy(prow).to(device), torch.from_numpy(ptf).to(device),
            torch.from_numpy(doc_len).to(device), stats, analyzer,
            token_stream=np.asarray(stream, np.int32), builder="python",
        )

    @classmethod
    def _build_native(cls, texts_per_column, capacity: int, analyzer: Analyzer, device):
        """Native (C++) build path: identical output to the Python builder;
        None when the library is unavailable."""
        from . import native

        if not native.available():
            return None
        n_rows = len(texts_per_column[0])
        if len(texts_per_column) == 1:
            docs = [str(x) for x in texts_per_column[0]]
        else:
            # multi-column: concatenate with a separator (space is never a
            # token char, so tokenization is unchanged)
            docs = [
                " ".join(str(col[i]) for col in texts_per_column) for i in range(n_rows)
            ]
        out = native.build_csr(
            docs,
            lower_case=analyzer.lower_case,
            min_token_len=analyzer.min_token_len,
            max_token_len=analyzer.max_token_len,
            stop_words=analyzer.stop_words,
        )
        if out is None:
            return None
        vocab, offsets, rows, tf, doc_len, total_tokens, stream = out
        v = len(vocab)
        df_arr = (offsets[1:] - offsets[:-1]) if v else np.zeros(0, np.int64)
        max_df = int(df_arr.max()) if v else 1
        nnz = int(offsets[-1]) if v else 0
        nnz_pad = nnz + _round_pow2(max(max_df, 128))
        prow = np.zeros(nnz_pad, np.int32)
        ptf = np.zeros(nnz_pad, np.float32)
        prow[:nnz] = rows
        ptf[:nnz] = tf
        dl = np.zeros(capacity, np.float32)
        dl[:n_rows] = doc_len
        terms = sorted(vocab, key=vocab.get)
        doc_freq = {t: int(df_arr[i]) for i, t in enumerate(terms)}
        stats = BM25Stats(n_rows, total_tokens, doc_freq)
        return cls(
            capacity, n_rows, vocab, offsets,
            torch.from_numpy(prow).to(device), torch.from_numpy(ptf).to(device),
            torch.from_numpy(dl).to(device), stats, analyzer,
            token_stream=np.asarray(stream, np.int32), builder="native",
        )

    # ------------------------------------------------------------- query
    def term_range(self, term: str) -> Tuple[int, int]:
        tid = self.vocab.get(term)
        if tid is None:
            return 0, 0
        return int(self.term_offsets[tid]), int(
            self.term_offsets[tid + 1] - self.term_offsets[tid]
        )

    def _stream_arrays(self):
        """(padded device stream, device doc_bounds) for phrase matching,
        uploaded once per store; None when the stream is unavailable."""
        if self._stream_host is None:
            return None
        if self._stream_dev is None:
            st = self._stream_host
            lp = 128
            while lp < len(st) + 1:
                lp <<= 1
            padded = np.full(lp, -1, np.int32)
            padded[: len(st)] = st
            dl = self.doc_len[: self.n_rows].cpu().numpy().astype(np.int64)
            bounds = np.zeros(self.capacity + 1, np.int64)
            np.cumsum(dl, out=bounds[1 : self.n_rows + 1])
            bounds[self.n_rows + 1 :] = bounds[self.n_rows]
            self._stream_dev = (
                torch.from_numpy(padded).to(self.device),
                torch.from_numpy(bounds.astype(np.int32)).to(self.device),
            )
        return self._stream_dev

    def phrase_counts_device(self, tokens: Sequence[str]) -> Optional[torch.Tensor]:
        """int32[capacity] per-row occurrence counts of the analyzed
        phrase `tokens` (adjacent in the filtered stream), or None when
        the store has no token stream. Runs on the store's device, as a
        program keyed as JAX keys `_phrase_doc_counts` (on m) plus the
        stream's tensors; the term ids are its input."""
        got = self._stream_arrays()  # uploaded here, before any capture
        if got is None or not tokens:
            return None
        stream, bounds = got
        tids = np.asarray([self.vocab.get(t, -1) for t in tokens], np.int32)
        if (tids < 0).any():  # absent term: the phrase matches nothing
            return torch.zeros(self.capacity, dtype=torch.int32, device=self.device)
        m = len(tids)
        refs: List[torch.Tensor] = []
        key = ("phrase", m, tensors_key((stream, bounds), refs))

        def body(q, masks, dyn):
            del masks, dyn
            return _phrase_doc_counts(stream, q, bounds)

        def make():
            return Program(body, device=self.device, query=((m,), torch.int32),
                           out_shape=(self.capacity,), label=f"the {m}-term phrase counts",
                           refs=refs)

        return self._programs.get(key, make).run(tids)

    def phrase_bitmap(self, tokens: Sequence[str]) -> Optional[np.ndarray]:
        """bool[n_rows] rows containing the phrase (host view), or None
        when unavailable (the caller verifies on the host)."""
        counts = self.phrase_counts_device(tokens)
        if counts is None:
            return None
        return counts[: self.n_rows].cpu().numpy() > 0

    def term_bitmap(self, term: str) -> np.ndarray:
        """bool[n_rows] rows containing the term (the ffi_query_term_bitmap
        analogue, used for hasToken-style predicate acceleration)."""
        s, ln = self.term_range(term)
        rows = self.postings_rows[s : s + ln].cpu().numpy()
        out = np.zeros(self.n_rows, bool)
        out[rows[rows < self.n_rows]] = True
        return out

    def plan_batch(
        self, queries: Sequence[str], *, stats: BM25Stats, operator: str = "OR"
    ):
        """Host side of a batch: (qints int32[Q, 2T+1], idfs f32[Q, T],
        budget, route "sparse" | "dense", need_counts, per-query terms).
        The route rule is the JAX package's, so both packages take the
        same path on the same store."""
        all_terms = query_terms(self.analyzer, queries)
        return tuple(self.plan_terms(all_terms, stats=stats, operator=operator)) + (all_terms,)

    def plan_terms(
        self, all_terms: Sequence[Sequence[str]], *, stats: BM25Stats, operator: str = "OR"
    ) -> "Plan":
        """`plan_batch` from each query's analyzed terms (`query_terms`): a
        search over several stores tokenizes its batch once and plans
        every store from the same terms."""
        require_all = operator.upper() == "AND"
        ranges: List[List[Tuple[int, int, float]]] = []
        maxlen = 1
        for terms in all_terms:
            rs: List[Tuple[int, int, float]] = []
            for t in terms:
                s, ln = self.term_range(t)
                if ln == 0:
                    continue  # absent here; still counts toward n_required
                rs.append((s, ln, stats.idf(t)))
                maxlen = max(maxlen, ln)
            ranges.append(rs)
        # per-call budget: pow2 of the batch's own largest posting list
        budget = min(BUDGET_CAP, _round_pow2(maxlen, lo=128))
        chunk_lists = [
            [
                (s + off, min(budget, ln - off), idf)
                for (s, ln, idf) in rs
                for off in range(0, ln, budget)
            ]
            for rs in ranges
        ]
        nq = len(all_terms)
        nt = _pad_pow2(max((len(c) for c in chunk_lists), default=1))
        qints = np.zeros((nq, 2 * nt + 1), np.int32)
        idfs = np.zeros((nq, nt), np.float32)
        qints[:, 2 * nt] = 1
        for i, chunks in enumerate(chunk_lists):
            for j, (s, ln, idf) in enumerate(chunks):
                qints[i, j] = s
                qints[i, nt + j] = ln
                idfs[i, j] = idf
            if require_all:
                qints[i, 2 * nt] = max(len(all_terms[i]), 1)
            if not all_terms[i]:
                qints[i, 2 * nt] = nt + 1  # empty query matches nothing
        sparse = nt * budget <= SPARSE_CAP and self.capacity >= SPARSE_MIN_CAPACITY
        need_counts = require_all and any(len(t) > 1 for t in all_terms)
        return Plan(qints, idfs, budget, "sparse" if sparse else "dense", need_counts)

    def bm25_topk_batch(
        self,
        queries: Sequence[str],
        k: int,
        *,
        stats: Optional[BM25Stats] = None,
        operator: str = "OR",
        mask=None,
        approx: bool = False,
        route: Optional[str] = None,
    ):
        """Device BM25 top-k for a batch of query strings against this
        segment, with table-level `stats` (segment-local when None).
        Terms whose posting lists exceed the scan budget are split into
        chunks (never truncated). `approx` takes the dense path's top-k by
        the approximate branch (the sparse path's run totals are few and
        stay exact, as in the JAX package). `route` forces "sparse" or
        "dense" (a measurement hook; None takes the JAX package's rule).

        One program of the store's (search/program.py; on the card one
        CUDA graph), keyed as the JAX package's jitted bodies are (the
        route, budget, nt, k, need_counts, approx) plus the batch padded
        to 8 rows and the mask's shape; the plan and the statistics are
        inputs. Returns
        (vals, rows, tags, per-query terms, bound): tags is the
        single-segment tag column (0 valid / -1 empty), bound the error
        bound of each query's scores on the sparse path (f32[Q],
        `sparse_error_bound`) and None on the dense one. (The JAX
        package's method returns the first four.)"""
        from ..search.filters import as_mask_array, mask_spec

        stats = stats or self.stats
        mask = as_mask_array(mask)
        all_terms = query_terms(self.analyzer, queries)
        plan = self.plan_terms(all_terms, stats=stats, operator=operator)
        route = route or plan.route
        nq = len(all_terms)
        nq_pad = pad_queries(nq)
        packed, (off,) = pack_plans([plan], stats.avg_doc_len, nq_pad)
        if mask is not None and mask.dim() == 2:
            mask = torch.nn.functional.pad(mask, (0, 0, 0, nq_pad - mask.shape[0]))
        spec = mask_spec(None if mask is None else ("rows", mask))
        nt = plan.idfs.shape[1]
        need_counts = plan.need_counts and route == "dense"
        approx = approx and route == "dense"
        refs: List[torch.Tensor] = []
        key = ("bm25", route, plan.budget, nt, need_counts, approx, int(k), nq_pad, spec,
               tensors_key(self.tensors, refs))
        tensors = self.tensors
        capacity = self.capacity

        def body(q, masks, dyn):
            del dyn
            vals, rows, tags, prefix_max = store_topk(
                tensors, q, off, nt, masks[0], route=route, budget=plan.budget,
                capacity=capacity, k=int(k), need_counts=need_counts, approx=approx,
            )
            bound = (torch.zeros_like(vals) if prefix_max is None
                     else sparse_error_bound(prefix_max)[:, None].expand_as(vals))
            return torch.stack([vals.view(torch.int32), rows, tags,
                                bound.contiguous().view(torch.int32)])

        def make():
            return Program(
                body, device=self.device, query=(tuple(packed.shape), torch.int32),
                masks=[None if spec is None else (spec[1], spec[2])],
                out_shape=(4, nq_pad, int(k)), label=f"BM25 ({route} route)", refs=refs,
            )

        out = self._programs.get(key, make).run(packed, [mask])
        vals, rows, tags = out[0, :nq].view(torch.float32), out[1, :nq], out[2, :nq]
        bound = out[3, :nq, 0].view(torch.float32) if route == "sparse" else None
        return vals, rows, tags, all_terms, bound

    def bm25_topk(
        self,
        query: str,
        k: int,
        *,
        stats: Optional[BM25Stats] = None,
        operator: str = "OR",
        mask=None,
        approx: bool = False,
    ):
        """Single-query convenience wrapper over `bm25_topk_batch`: (vals
        f32[1, k], rows int32[1, k], the query's terms)."""
        vals, rows, _tags, terms, _bound = self.bm25_topk_batch(
            [query], k, stats=stats, operator=operator, mask=mask, approx=approx
        )
        return vals, rows, terms[0]

    # ----------------------------------------------------------- persist
    def state_dict(self) -> Dict[str, Any]:
        """The JAX package's layout: numpy arrays, loadable by either
        package."""
        terms = sorted(self.vocab, key=self.vocab.get)
        return {
            "meta": {
                "capacity": self.capacity,
                "n_rows": self.n_rows,
                "total_tokens": self.stats.total_tokens,
                "analyzer": self.analyzer.config(),
            },
            "arrays": {
                "term_offsets": self.term_offsets,
                "postings_rows": self.postings_rows.cpu().numpy(),
                "postings_tf": self.postings_tf.cpu().numpy(),
                "doc_len": self.doc_len.cpu().numpy(),
                "terms": np.asarray(terms, dtype=str),
                **(
                    {"token_stream": np.asarray(self._stream_host)}
                    if self._stream_host is not None
                    else {}
                ),
            },
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any], *, device) -> "InvertedIndex":
        device = torch.device(device)
        m = state["meta"]
        a = state["arrays"]
        terms = [str(t) for t in a["terms"]]
        vocab = {t: i for i, t in enumerate(terms)}
        offsets = np.asarray(a["term_offsets"], np.int64)
        df = {t: int(offsets[i + 1] - offsets[i]) for t, i in vocab.items()}
        stats = BM25Stats(m["n_rows"], m["total_tokens"], df)
        cfg = dict(m["analyzer"])
        if cfg.get("stop_words"):
            cfg["stop_words"] = list(cfg["stop_words"])
        else:
            cfg.pop("stop_words", None)
        ts = a.get("token_stream")

        def up(x, dtype):
            return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

        return cls(
            m["capacity"], m["n_rows"], vocab, offsets,
            up(a["postings_rows"], np.int32), up(a["postings_tf"], np.float32),
            up(a["doc_len"], np.float32), stats, Analyzer(cfg),
            token_stream=None if ts is None else np.asarray(ts, np.int32),
            builder="state_dict",
        )
