"""Plain reference of an exact pre-filtered k-nearest-neighbour table
(Cosine).

The semantics the configuration states: the rows are stored in the
configuration's `storage_dtype`, and a search returns the k rows of least
cosine distance, 1 - <q, x> / (|q| |x|), to the f32 query among the rows
that pass the configuration's `filter` ({"column": "id", "op", "value"}:
the id column holds each row's insert position), with that distance. The
reference rounds the benchmark's own f32 rows to the stored type itself
and works in float64 on the device, in blocks of rows and of queries, over
the passing rows of each block only; it imports nothing of the program and
reads nothing the program made.

`distances` gives +inf for a row that fails the filter, so a served row
outside it reads as an infinite distance error.

`control` is the same filtered search one precision lower, for the check
that the comparison can fail: the configuration scores in float32, so the
control rounds the queries to bfloat16 too (bf16 queries against the
stored bf16 rows, products summed in float32, TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 131_072
BLOCK_QUERIES = 1_024
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
OPS = {"<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
       "==": np.equal, "!=": np.not_equal}


def passes(ids: np.ndarray, config) -> np.ndarray:
    """bool: whether the rows of `ids` pass the configuration's filter."""
    f = config["filter"]
    if f["column"] != "id":
        raise ValueError(f"exact_knn_cosine_filter: a filter on {f['column']!r} has no reference")
    return OPS[f["op"]](ids, f["value"])


def _exact_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _stored(rows: np.ndarray, config, device, dtype) -> torch.Tensor:
    """The rows as the configuration stores them, in `dtype`."""
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    return x.to(DTYPES[config["storage_dtype"]]).to(dtype)


def _unit(x: torch.Tensor) -> torch.Tensor:
    """Each row over its norm (a zero row stays zero)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n > 0, n, torch.ones_like(n))


def _require_cosine(config) -> None:
    if config["metric"] != "Cosine":
        raise ValueError(
            f"exact_knn_cosine_filter: metric {config['metric']!r} has no reference here")


def _scan(rows, queries, k, config, device, dtype, round_queries):
    """Top-k of the cosine distance over the stored rows that pass the
    filter, in `dtype`; the queries rounded to bf16 when `round_queries`."""
    _require_cosine(config)
    _exact_precision()
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(device)
    q = _unit((q.to(torch.bfloat16) if round_queries else q).to(dtype))
    nq = q.shape[0]
    best_d = torch.full((nq, 0), float("inf"), dtype=dtype, device=device)
    best_i = torch.empty((nq, 0), dtype=torch.int64, device=device)
    for start in range(0, rows.shape[0], BLOCK_ROWS):
        ids = np.arange(start, min(start + BLOCK_ROWS, rows.shape[0]))
        keep = passes(ids, config)
        if not keep.any():
            continue
        x = _unit(_stored(rows[ids[keep]], config, device, dtype))
        ids = torch.from_numpy(ids[keep]).to(device)
        new_d, new_i = [], []
        for a in range(0, nq, BLOCK_QUERIES):
            b = min(a + BLOCK_QUERIES, nq)
            d = torch.cat([best_d[a:b], 1.0 - q[a:b] @ x.T], 1)
            i = torch.cat([best_i[a:b], ids.expand(b - a, -1)], 1)
            v, pos = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            new_d.append(v)
            new_i.append(torch.gather(i, 1, pos))
        best_d, best_i = torch.cat(new_d), torch.cat(new_i)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def topk(rows: np.ndarray, queries: np.ndarray, k: int, config, device):
    """Exact top-k of every query over the stored rows that pass the
    filter: (distances f64[Q, k] ascending, row ids int64[Q, k]) as numpy
    (fewer than k columns where fewer rows pass)."""
    return _scan(rows, queries, k, config, device, torch.float64, False)


def distances(rows: np.ndarray, queries: np.ndarray, ids: np.ndarray, config, device):
    """f64[Q, k]: the cosine distance of each query to each given row id
    (every id a valid row), +inf where the row fails the filter."""
    _require_cosine(config)
    out = np.empty(ids.shape, np.float64)
    for a in range(0, ids.shape[0], BLOCK_QUERIES):
        sel = ids[a : a + BLOCK_QUERIES]
        q = _unit(torch.from_numpy(queries[a : a + BLOCK_QUERIES]).to(device).to(torch.float64))
        x = _unit(_stored(rows[sel.reshape(-1)], config, device, torch.float64))
        x = x.reshape(*sel.shape, -1)
        out[a : a + BLOCK_QUERIES] = (1.0 - (q[:, None, :] * x).sum(-1)).cpu().numpy()
    return np.where(passes(ids, config), out, np.inf)


def control(rows: np.ndarray, queries: np.ndarray, k: int, config, device):
    """The filtered search one precision below the configuration's:
    (distances f32[Q, k], row ids int64[Q, k])."""
    return _scan(rows, queries, k, config, device, torch.float32, True)
