"""Tile-max pruned exact scan: CUDA tile-max pass + exact torch rescore.

Counterpart of myscaledb_tpu/ops/tilescan.py, a two-phase prune:

  1. TILE-MAX (csrc/tile_max.cu): one pass over the payload computing, per
     query, the max masked score of every SUB(=128)-row sub-tile. The
     score matrix is reduced 128:1 on chip and never reaches device
     memory.
  2. SELECT + RESCORE (torch ops): the top (k+slack) sub-tiles per query
     are gathered in the storage dtype and rescored exactly in f32, then
     cut to k.

Correctness: v_k = the k-th best masked score of a query. Any row with
score > v_k makes its sub-tile's max > v_k, so at most k sub-tiles have
max > v_k and they are exactly the tiles containing rows > v_k. Taking
the top-(k+slack) sub-tiles by max therefore covers the exact top-k (the
slack absorbs boundary ties). The rescore applies the same mask, so the
result equals the exhaustive masked top-k.

`tile_maxes` sends a CUDA tensor to the kernel and a CPU tensor to
`tile_maxes_plain`; there is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..metrics import Metric
from ._cuda import count_launch
from .distance import (
    _apply_metric,
    _check_kernel_operands,
    _check_scan_args,
    dot_plain,
    kernel_error_bound,
    launch_scan,
)

SUB = 128  # rows per sub-tile (one max per query per sub-tile)
OUT_LANES = 128  # the JAX package's output block width; part of its gate
NEG = -3.4e38  # large-negative instead of -inf (NaN-safe diffs)
TILE_SLACK = 2  # extra sub-tiles beyond k (boundary-tie head-room)
MAX_K = 128  # above this the gather outgrows the saved traffic


def supports(n: int, d: int, q_pad: int, k: int) -> bool:
    """Shape gate, the JAX package's own (tilescan.py:54-63), so that both
    packages take the same route on the same segment. Re-deriving it from
    the Hopper kernel's tiles is later work."""
    return (
        k <= MAX_K
        and d % 128 == 0
        and q_pad % 8 == 0
        and n % (SUB * OUT_LANES) == 0
        and n // SUB > 2 * (k + TILE_SLACK)
    )


def tile_maxes_plain(
    queries: torch.Tensor,
    base: torch.Tensor,
    aux: torch.Tensor,
    mask_u8: torch.Tensor,
    metric: Metric,
) -> torch.Tensor:
    """The tile-max kernel's math in torch ops (materializes the scores)."""
    q = queries.shape[0]
    n = base.shape[0]
    s = _apply_metric(dot_plain(queries, base), aux[None, :], metric)
    s = torch.where(mask_u8[None, :] != 0, s, torch.full_like(s, NEG))
    return torch.amax(s.reshape(q, n // SUB, SUB), dim=2)


def tile_error_bound(
    queries: torch.Tensor, base: torch.Tensor, aux: torch.Tensor, metric: Metric
) -> torch.Tensor:
    """f32[Q, N/SUB]: the |kernel - plain| each sub-tile max may show
    (without its KERNEL_RTOL part): the largest bound of the sub-tile's
    scores (`distance.kernel_error_bound`)."""
    b = kernel_error_bound(queries, base, aux, metric)
    return torch.amax(b.reshape(queries.shape[0], base.shape[0] // SUB, SUB), dim=2)


def tile_maxes(
    queries: torch.Tensor,  # f32[Qpad, D]
    base: torch.Tensor,  # f32|bf16[N, D]
    aux: torch.Tensor,  # f32[N]
    mask_u8: torch.Tensor,  # uint8[N]
    *,
    metric: Metric,
) -> torch.Tensor:
    """f32[Qpad, N/SUB] per-sub-tile maxes of the masked score matrix."""
    _check_scan_args(queries, base, aux, metric, need_aux=True)
    n, d = base.shape
    if n % SUB:
        raise ValueError(f"tile_maxes needs N % {SUB} == 0, got N={n}")
    if mask_u8.dtype != torch.uint8 or mask_u8.shape != (n,):
        raise ValueError(f"mask must be uint8[{n}], got {mask_u8.dtype}{list(mask_u8.shape)}")
    if mask_u8.device != base.device:
        raise ValueError("mask must be on the payload's device")
    if base.device.type == "cpu":
        return tile_maxes_plain(queries, base, aux, mask_u8, metric)
    if base.device.type != "cuda":
        raise ValueError(f"unsupported device {base.device}")
    _check_kernel_operands(queries, base, aux, mask_u8, d=d)
    q = queries.shape[0]
    out = torch.empty((q, n // SUB), dtype=torch.float32, device=base.device)
    if q == 0 or n == 0:
        return out
    launch_scan("msd_tile_max", queries, base, aux, mask_u8, out, metric)
    count_launch(tile_maxes, f32=base.dtype == torch.float32)
    return out


tile_maxes.launches = 0
tile_maxes.launches_f32 = 0  # of them, over an f32 payload (the f32 engine)


def tile_topk_scan(
    queries: torch.Tensor,  # f32[Qpad, D] (normalized for Cosine)
    base: torch.Tensor,  # [N, D]
    aux: torch.Tensor,  # f32[N]
    mask_u8: torch.Tensor,  # uint8[N] (1 = candidate; folds validity+filter)
    *,
    k: int,
    metric: Metric,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k via tile-max prune. Returns (f32[Q, k],
    int32[Q, k]); missing slots are (-inf, -1)."""
    q, d = queries.shape
    n = base.shape[0]
    n_sub = n // SUB
    maxes = tile_maxes(queries, base, aux, mask_u8, metric=metric)
    ksel = min(k + TILE_SLACK, n_sub)
    sub = torch.topk(maxes, ksel, dim=1).indices  # [Q, S] sub-tile ids
    # the gather stays in the storage dtype; only the gathered rows widen
    g = base.reshape(n_sub, SUB, d)[sub]  # [Q, S, SUB, D]
    # exact f32 products and sums, widened in the multiply; no matmul, so
    # no global TF32 setting reaches the rescore
    qf = queries.to(torch.float32)
    s = (g * qf[:, None, None, :]).sum(dim=-1).reshape(q, -1)
    asub = aux.reshape(n_sub, SUB)[sub].reshape(q, -1)
    s = _apply_metric(s, asub, metric)
    ok = mask_u8.reshape(n_sub, SUB)[sub].reshape(q, -1) != 0
    s = torch.where(ok, s, torch.full_like(s, float("-inf")))
    rows = (
        sub[:, :, None] * SUB
        + torch.arange(SUB, device=sub.device)[None, None, :]
    ).reshape(q, -1)
    kk = min(k, s.shape[-1])
    v, p = torch.topk(s, kk, dim=1)
    r = torch.gather(rows, 1, p).to(torch.int32)
    r = torch.where(torch.isfinite(v), r, torch.full_like(r, -1))
    if kk < k:
        v = torch.nn.functional.pad(v, (0, k - kk), value=float("-inf"))
        r = torch.nn.functional.pad(r, (0, k - kk), value=-1)
    return v, r
