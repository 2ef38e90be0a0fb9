"""Text analysis: tokenizer for the FTS index.

A copy of myscaledb_tpu/text/analyzer.py (device-free; the port keeps
its own copy so that it never imports the JAX package). It replaces the tantivy tokenizer chain consumed through
ffi_create_index_with_parameter's JSON params (SURVEY.md §2.4; DDL
`TYPE fts('{json}')`, 02887_tantivy_text_search_single_col.sql). Supported
params: lower_case (default true), stop_words ("english" or list),
min_token_len, max_token_len — the commonly-exercised subset.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

# tantivy's SimpleTokenizer splits on any non-alphanumeric character —
# "history's" tokenizes as ["history", "s"] — and the reference's BM25
# average-doc-length (hence scores) depends on that: replay test
# 00041_mqvs_text_search_multiple_parts pins score 2.1646233, which
# back-solves to avgdl 7.3 (possessives split) not 7.1 (kept whole).
_TOKEN_RE = re.compile(r"[0-9A-Za-z_]+", re.UNICODE)
# query-side: consume a possessive suffix with the word (tokenize_query)
_QUERY_RE = re.compile(r"[0-9A-Za-z_]+(?:'[A-Za-z]+)?", re.UNICODE)

# Minimal english stopword list (tantivy's default set is similar in spirit).
ENGLISH_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


class Analyzer:
    def __init__(self, params: Optional[Dict[str, Any]] = None):
        params = dict(params or {})
        self.lower_case = bool(params.pop("lower_case", True))
        sw = params.pop("stop_words", None)
        if sw == "english":
            self.stop_words = ENGLISH_STOPWORDS
        elif sw:
            self.stop_words = frozenset(
                w.lower() if self.lower_case else w for w in sw
            )
        else:
            self.stop_words = frozenset()
        self.min_token_len = int(params.pop("min_token_len", 1))
        self.max_token_len = int(params.pop("max_token_len", 64))
        # unknown keys are tolerated (forward compat with tantivy JSON)
        self.extra = params

    def tokenize(self, text: str) -> List[str]:
        if not text:
            return []
        if self.lower_case:
            text = text.lower()
        out = []
        for m in _TOKEN_RE.finditer(text):
            tok = m.group(0)
            if not (self.min_token_len <= len(tok) <= self.max_token_len):
                continue
            if tok in self.stop_words:
                continue
            out.append(tok)
        return out

    def tokenize_query(self, text: str) -> List[str]:
        """Query-side tokenization: like tokenize(), but a possessive
        suffix is consumed WITHOUT emitting its own token ("history's"
        queries as just "history"). The reference indexes both tokens
        (BM25 avgdl proves it — replay 00041 score back-solve) yet its
        query parser drops the suffix: querying a full doc text matches
        only genuinely token-sharing docs, never via a bare "s"
        (replay 00040_mqvs_hybrid_search_with_subquery)."""
        if not text:
            return []
        if self.lower_case:
            text = text.lower()
        out = []
        for m in _QUERY_RE.finditer(text):
            tok = m.group(0).split("'", 1)[0]
            if not (self.min_token_len <= len(tok) <= self.max_token_len):
                continue
            if tok in self.stop_words:
                continue
            out.append(tok)
        return out

    def config(self) -> Dict[str, Any]:
        return {
            "lower_case": self.lower_case,
            "stop_words": sorted(self.stop_words) if self.stop_words else None,
            "min_token_len": self.min_token_len,
            "max_token_len": self.max_token_len,
        }
