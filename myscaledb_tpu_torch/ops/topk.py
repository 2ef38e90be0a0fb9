"""Top-k selection and k-way merge primitives.

Counterpart of myscaledb_tpu/ops/topk.py, exact branch only. All
selection happens on max-is-better scores (metrics.py); missing slots
are padded with (-inf, -1). The vector paths select with `torch.topk`;
the text and fusion paths, whose scores tie exactly as a rule, select
with `topk_stable`, which orders ties as `jax.lax.top_k` does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as tnf

NEG_INF = float("-inf")


def _pad_k(vals: torch.Tensor, idx: torch.Tensor, k: int):
    if vals.shape[-1] < k:
        extra = k - vals.shape[-1]
        vals = tnf.pad(vals, (0, extra), value=NEG_INF)
        idx = tnf.pad(idx, (0, extra), value=-1)
    return vals, idx


def topk_scores(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis. Returns (values f32[..., k], idx
    int32[..., k]). The JAX package's approximate branch is not ported
    (ROADMAP queue 2 #4)."""
    kk = min(k, scores.shape[-1])
    vals, idx = torch.topk(scores, kk, dim=-1)
    return _pad_k(vals, idx.to(torch.int32), k)


def _ordered_bits(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of the f32 `scores` (IEEE bits with the
    negatives' magnitude bits flipped, so that signed integer order is
    float order)."""
    b = scores.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis that breaks exact ties as
    `jax.lax.top_k` does: the lower position first. One `torch.topk` over
    int64 keys, the score's ordered bits in the high half and
    (n - 1 - position) in the low half, so equal scores rank by position
    (`torch.topk` itself promises no order among ties). Returns (values
    f32[..., k], idx int32[..., k]), padded as `topk_scores`."""
    n = scores.shape[-1]
    kk = min(k, n)
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=scores.device)
    keys = (_ordered_bits(scores) << 32) | rev
    idx = torch.topk(keys, kk, dim=-1).indices  # keys are distinct: no ties left
    return _pad_k(torch.gather(scores, -1, idx), idx.to(torch.int32), k)


WIDE_SUB = 128  # rows per reduction sub-tile (wide_exact_topk)
WIDE_SLACK = 2  # extra sub-tiles beyond k (tie head-room)


def wide_exact_topk(
    scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EXACT top-k over very wide score rows via a two-level reduce:
    per-128-lane sub-tile maxes, the top (k+slack) sub-tiles per query,
    then an exact top-k over only those sub-tiles' scores. The k best rows
    occupy <= k sub-tiles, each with max >= the k-th best score, so the top
    (k+slack) sub-tiles by max always contain the true top-k (the same
    bound ops/tilescan.py relies on; slack covers max ties at the boundary).

    Falls back to the flat top-k when the shape makes pruning pointless.
    """
    q, n = scores.shape
    nsub = n // WIDE_SUB
    ksel = min(k + WIDE_SLACK, nsub)
    if n % WIDE_SUB or ksel * WIDE_SUB * 2 >= n:
        return topk_scores(scores, k)
    sm = scores.reshape(q, nsub, WIDE_SUB)
    sub = torch.topk(torch.amax(sm, dim=2), ksel, dim=1).indices  # [Q, ksel]
    g = torch.gather(sm, 1, sub[:, :, None].expand(q, ksel, WIDE_SUB))
    rows = sub[:, :, None] * WIDE_SUB + torch.arange(
        WIDE_SUB, device=scores.device
    )[None, None, :]
    v, p = torch.topk(g.reshape(q, -1), min(k, ksel * WIDE_SUB), dim=1)
    r = torch.gather(rows.reshape(q, -1), 1, p)
    v, r = _pad_k(v, r, k)
    return v, torch.where(torch.isfinite(v), r, torch.full_like(r, -1)).to(torch.int32)


def merge_topk(
    vals_a: torch.Tensor,
    idx_a: torch.Tensor,
    vals_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k lists (same leading dims) into one, exactly."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    mvals, pos = torch.topk(vals, min(k, vals.shape[-1]), dim=-1)
    return _pad_k(mvals, torch.gather(idx, -1, pos), k)


def dedup_rows(values: torch.Tensor, rows: torch.Tensor, extra=None):
    """Kill duplicate row ids along the last axis, keeping one copy per
    row (the `extra`-flagged copy when given, e.g. beam-search 'expanded'
    flags). Returns (values, rows, extra or None) in row-id order, the
    killed copies as (-inf, -1, False); padding (-1) sorts last. Row ids
    must be < 2^30."""
    pad_key = torch.full_like(rows, 2**31 - 1, dtype=torch.int32)
    r32 = rows.to(torch.int32)
    if extra is not None:
        key = torch.where(rows >= 0, r32 * 2 + (1 - extra.to(torch.int32)), pad_key)
    else:
        key = torch.where(rows >= 0, r32, pad_key)
    order = torch.sort(key, dim=-1, stable=True).indices
    v_s = torch.gather(values, -1, order)
    r_s = torch.gather(rows, -1, order)
    dup = torch.zeros_like(r_s, dtype=torch.bool)
    dup[..., 1:] = (r_s[..., 1:] == r_s[..., :-1]) & (r_s[..., 1:] >= 0)
    v_s = v_s.masked_fill(dup, NEG_INF)
    r_s = r_s.masked_fill(dup, -1)
    if extra is not None:
        e_s = torch.gather(extra, -1, order).masked_fill(dup, False)
        return v_s, r_s, e_s
    return v_s, r_s, None


def merge_topk_lists(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Collapse a stacked [..., L, k'] set of top-k lists to one [..., k]
    (the global merge across segments and chunks)."""
    flat_v = vals.reshape(*vals.shape[:-2], -1)
    flat_i = idx.reshape(*idx.shape[:-2], -1)
    mvals, pos = torch.topk(flat_v, min(k, flat_v.shape[-1]), dim=-1)
    return _pad_k(mvals, torch.gather(flat_i, -1, pos), k)
