"""ctypes bridge to the native (C++) FTS build kernel.

The port's own copy of myscaledb_tpu/text/native.py (device-free): it
builds and loads the repository's `native/libmyscale_native.so` (CPU C++,
`make -C native` at first use), as the JAX package does.

The reference does ingest-time text indexing in native code (the tantivy
Rust writer behind TantivyIndexStore); here the equivalent hot path —
tokenize + CSR postings assembly — is native/fts_tokenizer.cpp, loaded via
ctypes (no pybind11 in this image). Builds lazily with `make` on first
use; the pure-Python builder in inverted.py is the fallback, and both
produce byte-identical indexes (tests assert this).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libmyscale_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if os.path.isdir(_NATIVE_DIR):
                # always run make: a stale .so (older ABI) must be rebuilt;
                # an up-to-date one makes this a no-op
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=not os.path.exists(_SO_PATH),
                    capture_output=True,
                    timeout=120,
                )
            lib = ctypes.CDLL(_SO_PATH)
        except (OSError, subprocess.SubprocessError):
            return None
        lib.msql_fts_build.restype = ctypes.c_void_p
        lib.msql_fts_build.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        for f in (
            "msql_fts_nnz",
            "msql_fts_vocab_size",
            "msql_fts_vocab_bytes",
            "msql_fts_total_tokens",
        ):
            getattr(lib, f).restype = ctypes.c_int64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.msql_fts_export.restype = None
        lib.msql_fts_export.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.msql_fts_free.restype = None
        lib.msql_fts_free.argtypes = [ctypes.c_void_p]
        try:
            lib.msql_fts_export_stream.restype = None
            lib.msql_fts_export_stream.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
            ]
        except AttributeError:
            return None  # stale library without the stream ABI: fall back
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _pack_strings(items: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    offsets = np.zeros(len(items) + 1, np.int64)
    chunks: List[bytes] = []
    pos = 0
    for i, s in enumerate(items):
        b = s.encode("utf-8", errors="ignore")
        chunks.append(b)
        pos += len(b)
        offsets[i + 1] = pos
    return b"".join(chunks), offsets


def build_csr(
    docs: Sequence[str],
    *,
    lower_case: bool = True,
    min_token_len: int = 1,
    max_token_len: int = 64,
    stop_words=(),
):
    """Native CSR build. Returns (vocab dict, term_offsets int64[V+1],
    rows int32[nnz], tf f32[nnz], doc_len f32[n], total_tokens,
    token_stream int32[total_tokens]) or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf, offs = _pack_strings([str(d) for d in docs])
    sbuf, soffs = _pack_strings(sorted(stop_words))
    h = lib.msql_fts_build(
        buf,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(docs),
        int(lower_case),
        int(min_token_len),
        int(max_token_len),
        sbuf,
        soffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(stop_words),
    )
    if not h:
        return None
    try:
        nnz = lib.msql_fts_nnz(h)
        v = lib.msql_fts_vocab_size(h)
        vb = lib.msql_fts_vocab_bytes(h)
        total_tokens = lib.msql_fts_total_tokens(h)
        rows = np.zeros(max(nnz, 1), np.int32)
        tf = np.zeros(max(nnz, 1), np.float32)
        term_offsets = np.zeros(v + 1, np.int64)
        doc_len = np.zeros(max(len(docs), 1), np.float32)
        vocab_buf = ctypes.create_string_buffer(max(int(vb), 1))
        vocab_offsets = np.zeros(v + 1, np.int64)
        lib.msql_fts_export(
            h,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            term_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            doc_len.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vocab_buf,
            vocab_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        stream = np.zeros(max(int(total_tokens), 1), np.int32)
        lib.msql_fts_export_stream(
            h, stream.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
    finally:
        lib.msql_fts_free(h)
    raw = vocab_buf.raw[:vb]
    vocab: Dict[str, int] = {}
    for i in range(v):
        vocab[raw[vocab_offsets[i] : vocab_offsets[i + 1]].decode("utf-8")] = i
    return (
        vocab,
        term_offsets,
        rows[:nnz],
        tf[:nnz],
        doc_len[: len(docs)],
        int(total_tokens),
        stream[: int(total_tokens)],
    )
