"""Brute-force scan: chunked score computation + masked top-k.

Counterpart of myscaledb_tpu/ops/bruteforce.py. `scan_topk_t` scans a
device-resident payload: it either takes the tile-max pruned route
(ops/tilescan.py) or computes score chunks with the score kernel
(ops/distance.py), applies the filter/validity mask as a -inf select
(pre-filter semantics: masked rows can never enter the top-k), takes a
per-chunk top-k and merges chunk results exactly. With `approx` it skips
the prune and takes each chunk's top-k by the approximate branch of
`topk_scores`, as the JAX package does. `stream_scan_topk`
scans a host-tier payload: fixed-shape chunks stream through the device
(ops/stream.py) and each goes through `scan_topk_t`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..metrics import Metric
from . import distance, tilescan
from ._cuda import round_up
from .stream import host_chunks
from .topk import NEG_INF, merge_topk, merge_topk_lists, topk_scores, wide_exact_topk

# Rows per scan chunk. 128k rows x 128 dims of bf16 = 32 MiB per chunk read.
DEFAULT_CHUNK_ROWS = 128 * 1024


def _choose_chunk(n: int, target: int) -> int:
    """Largest multiple of 1024 that divides n and is <= target (segments
    are 1024-row aligned). Falls back to n itself for small/odd sizes."""
    if n <= target:
        return n
    if n % 1024 == 0:
        units = n // 1024
        best = 1
        limit = max(1, target // 1024)
        for c in range(1, limit + 1):
            if units % c == 0:
                best = c
        return best * 1024
    return n  # unaligned: single shot


def _chunk_scores(q, block, aux_block, metric):
    """Scores for one chunk. `distance.scores` launches the CUDA kernel
    for a CUDA payload and runs its plain version for a CPU payload."""
    return distance.scores(q, block, aux_block, metric=metric)


def scan_topk_t(
    queries: torch.Tensor,
    base: torch.Tensor,
    aux: Optional[torch.Tensor],
    *,
    k: int,
    metric: Metric,
    n_valid: int,
    mask: Optional[torch.Tensor] = None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    approx: bool = False,
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force top-k over a (possibly padded, possibly filtered) base.

    queries: f32[Q, D] — raw; Cosine normalization is applied here.
    base:    [N, D] storage payload (f32 or bf16), rows >= n_valid are padding.
    aux:     f32[N] per-row metric auxiliary (base_aux), or None to compute.
    mask:    optional bool[N] pre-filter (WHERE bitmap ∩ delete bitmap).
    approx:  each chunk's top-k by the approximate branch of `topk_scores`
             at `recall_target` (the scores stay exact; rows may be missed).
    Returns (scores f32[Q, k], indices int32[Q, k]); missing slots are
    (-inf, -1).
    """
    nq, d = queries.shape
    n = base.shape[0]
    dev = base.device
    queries = distance.normalize_queries(queries.to(torch.float32), metric)
    if aux is None and metric != Metric.IP:
        aux = distance.base_aux(base, metric)
    if aux is None:
        aux = torch.zeros((n,), dtype=torch.float32, device=dev)

    # Pad queries to a multiple of 8, as the JAX package does, so that
    # both packages take the same route on the same segment.
    nq_pad = round_up(max(nq, 1), 8)
    if nq_pad != nq:
        queries = torch.nn.functional.pad(queries, (0, 0, 0, nq_pad - nq))
    queries = queries.contiguous()

    valid = torch.arange(n, device=dev) < n_valid
    if mask is not None:
        valid = torch.logical_and(valid, mask)

    if not approx and tilescan.supports(n, d, nq_pad, k):
        # Strategy gate, the JAX package's byte model: the tile-max prune
        # re-reads ksel*SUB raw rows per query for the exact rescore;
        # the full-scores path pays the [Q, N] score matrix round-trips
        # instead (~3 x Q x N x 4 bytes). At SIFT shapes (1M x 128, batch
        # 100) the prune is taken; at GIST shapes (100k x 960, batch 256)
        # the full path is.
        ksel = min(k + tilescan.TILE_SLACK, n // tilescan.SUB)
        prune_bytes = 2 * nq_pad * ksel * tilescan.SUB * d * base.element_size()
        full_bytes = 3 * nq_pad * n * 4
        if prune_bytes < full_bytes:
            vals, idx = tilescan.tile_topk_scan(
                queries, base, aux, valid.to(torch.uint8), k=k, metric=metric
            )
            return vals[:nq], idx[:nq]

    chunk = _choose_chunk(n, chunk_rows)
    cvals, cidx = [], []
    for off in range(0, n, chunk):
        s = _chunk_scores(
            queries, base[off : off + chunk], aux[off : off + chunk], metric
        )
        s = torch.where(valid[None, off : off + chunk], s, torch.full_like(s, NEG_INF))
        if approx:
            cv, ci = topk_scores(s, k, approx=True, recall_target=recall_target)
        else:
            cv, ci = wide_exact_topk(s, k)
        cvals.append(cv)
        cidx.append(torch.where(ci >= 0, ci + off, ci))
    if len(cvals) == 1:
        vals, idx = cvals[0], cidx[0]
    else:
        # [Q, nc, k] -> exact merge to [Q, k]
        vals, idx = merge_topk_lists(
            torch.stack(cvals, dim=1), torch.stack(cidx, dim=1), k
        )
    idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals[:nq], idx[:nq]


def stream_scan_topk(
    queries: torch.Tensor,
    data: torch.Tensor,
    aux: Optional[torch.Tensor],
    *,
    k: int,
    metric: Metric,
    n_valid: int,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 131_072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a HOST-tier payload (`data` [capacity, D] and its
    `aux` in host memory, pinned for a CUDA device): rows [0, n_valid)
    stream through the queries' device in chunks of `chunk` rows, the last
    one zero-padded, so every chunk has one shape and takes the route
    `scan_topk_t` gives that shape, as in the JAX package. A running top-k
    folds the chunks' results, row ids offset by the chunk's start.

    queries: f32[Q, D] on the device; mask: optional bool[capacity] on the
    device. Returns (scores f32[Q, k], rows int32[Q, k]), missing slots
    (-inf, -1)."""
    dev = queries.device
    nq = queries.shape[0]
    bv = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev)
    br = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    qn = distance.normalize_queries(queries.to(torch.float32), metric)
    if mask is not None:
        total = -(-n_valid // chunk) * chunk
        if mask.shape[0] < total:
            mask = torch.nn.functional.pad(mask, (0, total - mask.shape[0]))
    host = [data] + ([aux] if aux is not None else [])
    zeros = None if aux is not None else torch.zeros((chunk,), dtype=torch.float32, device=dev)
    for i, m, parts in host_chunks(host, n_valid, dev, chunk, pad=True):
        a = parts[1] if aux is not None else zeros
        cm = None if mask is None else mask[i : i + chunk]
        v, r = scan_topk_t(qn, parts[0], a, k=k, metric=metric, n_valid=m, mask=cm)
        r = torch.where(r >= 0, r + i, torch.full_like(r, -1))
        bv, br = merge_topk(bv, br, v, r, k)
    return bv, br
