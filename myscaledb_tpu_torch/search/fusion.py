"""Hybrid fusion: RRF and RSF over two ranked lists.

Counterpart of myscaledb_tpu/search/fusion.py. Formulas mirror
src/VectorIndex/Utils/HybridSearchUtils.cpp:

  RankFusion (:164):          score = Σ_legs 1 / (fusion_k + rank)
  RelativeScoreFusion (:212): min-max normalize each leg's scores
      (direction-aware for distance metrics, computeNormalizedScore
      :276-313), then  w·norm_text + (1-w)·norm_vec.

The host functions (`rank_fusion`, `relative_score_fusion`) are copies of
the JAX package's. The device functions (`rrf_fuse_t`, `rsf_fuse_t`) are
torch ops over (segment-tag, row) pairs on the legs' device; their final
cut (`_cut`) breaks exact ties as `jax.lax.top_k` does, lower position
first, so equal fused scores rank as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ..ops.topk import topk_stable

Key = Tuple[int, int]  # (segment_id, row_id)

NEG_INF = float("-inf")


def rank_fusion(
    legs: Sequence[List[Key]],
    k: int,
    *,
    fusion_k: int = 60,
) -> List[Tuple[Key, float]]:
    """RRF: Σ 1/(fusion_k + rank), rank starting at 1 per leg."""
    scores: Dict[Key, float] = {}
    for leg in legs:
        for rank, key in enumerate(leg, start=1):
            scores[key] = scores.get(key, 0.0) + 1.0 / (fusion_k + rank)
    ordered = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    return ordered[:k]


def _minmax_normalize(scores: np.ndarray, ascending_better: bool) -> np.ndarray:
    """Min-max to [0, 1], 1 = best. ascending_better=True for distance
    metrics (smaller distance is better)."""
    if scores.size == 0:
        return scores
    lo, hi = float(np.min(scores)), float(np.max(scores))
    if hi - lo < 1e-12:
        return np.ones_like(scores)
    norm = (scores - lo) / (hi - lo)
    return 1.0 - norm if ascending_better else norm


def relative_score_fusion(
    vec_leg: List[Tuple[Key, float]],
    text_leg: List[Tuple[Key, float]],
    k: int,
    *,
    fusion_weight: float = 0.5,
    vec_ascending_better: bool = True,
) -> List[Tuple[Key, float]]:
    """RSF: fused = w·norm_text + (1-w)·norm_vec. Items missing from a leg
    contribute 0 from that leg (fusion operates on the union of the two
    top-k lists)."""
    w = float(fusion_weight)
    fused: Dict[Key, float] = {}
    if vec_leg:
        keys = [kv[0] for kv in vec_leg]
        norm = _minmax_normalize(
            np.asarray([kv[1] for kv in vec_leg], np.float64), vec_ascending_better
        )
        for key, s in zip(keys, norm):
            fused[key] = fused.get(key, 0.0) + (1.0 - w) * float(s)
    if text_leg:
        keys = [kv[0] for kv in text_leg]
        norm = _minmax_normalize(np.asarray([kv[1] for kv in text_leg], np.float64), False)
        for key, s in zip(keys, norm):
            fused[key] = fused.get(key, 0.0) + w * float(s)
    ordered = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
    return ordered[:k]


# --------------------------------------------------------------- on-device
# Batched fusion over (segment-tag, row) hit pairs; tag/row = -1 marks an
# invalid slot.


def _dedup_sum(tags: torch.Tensor, rows: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Sum `contrib` over equal (tag, row) pairs; only the FIRST occurrence
    keeps the total, the rest get -inf. Returns f32[Q, M]. The [Q, M, M]
    product stays f32 (the port never lets an f32 matmul run in TF32,
    which would round 1/(60 + rank) to 10 bits)."""
    m = tags.shape[-1]
    valid = torch.logical_and(tags >= 0, rows >= 0)
    eq = torch.logical_and(
        torch.logical_and(tags[:, :, None] == tags[:, None, :], rows[:, :, None] == rows[:, None, :]),
        valid[:, None, :],
    )
    tot = torch.einsum("qmn,qn->qm", eq.to(torch.float32), contrib.to(torch.float32))
    # argmax returns the first maximal position, as jnp.argmax does
    first = torch.argmax(eq.to(torch.int32), dim=-1) == torch.arange(m, device=tags.device)[None, :]
    keep = torch.logical_and(first, valid)
    return torch.where(keep, tot, torch.full_like(tot, NEG_INF))


def _cut(tags, rows, tot, k):
    """Top-k of the fused scores (ties: lower position first), invalid
    slots as (-inf, -1, -1)."""
    kk = min(k, tot.shape[-1])
    vals, pos = topk_stable(tot, kk)
    pos = pos.to(torch.int64)
    otag = torch.gather(tags, -1, pos)
    orow = torch.gather(rows, -1, pos)
    ok = torch.isfinite(vals)
    otag = torch.where(ok, otag, torch.full_like(otag, -1))
    orow = torch.where(ok, orow, torch.full_like(orow, -1))
    if kk < k:
        vals = tnf.pad(vals, (0, k - kk), value=NEG_INF)
        otag = tnf.pad(otag, (0, k - kk), value=-1)
        orow = tnf.pad(orow, (0, k - kk), value=-1)
    return vals, otag, orow


def rrf_fuse_t(
    tags_a: torch.Tensor,
    rows_a: torch.Tensor,
    tags_b: torch.Tensor,
    rows_b: torch.Tensor,
    k: int,
    *,
    fusion_k: int = 60,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RRF over ranked (tag, row) lists [Q, k'] (position = rank - 1).
    Returns (scores f32[Q, k], tags, rows)."""
    dev = tags_a.device
    ka, kb = tags_a.shape[-1], tags_b.shape[-1]
    ra = 1.0 / (fusion_k + torch.arange(1, ka + 1, dtype=torch.float32, device=dev))
    rb = 1.0 / (fusion_k + torch.arange(1, kb + 1, dtype=torch.float32, device=dev))
    va = torch.logical_and(tags_a >= 0, rows_a >= 0)
    vb = torch.logical_and(tags_b >= 0, rows_b >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    contrib = torch.cat([torch.where(va, ra[None, :], zero), torch.where(vb, rb[None, :], zero)], dim=-1)
    tags = torch.cat([tags_a, tags_b], dim=-1)
    rows = torch.cat([rows_a, rows_b], dim=-1)
    tot = _dedup_sum(tags, rows, contrib)
    return _cut(tags, rows, tot, k)


def _minmax_norm_t(scores: torch.Tensor, valid: torch.Tensor, ascending_better: bool):
    """Min-max over valid entries per row; 1 = best, invalid -> 0."""
    # no host scalar: the fuse runs inside a captured graph
    lo = torch.amin(torch.where(valid, scores, torch.full_like(scores, 3.4e38)), dim=-1,
                    keepdim=True)
    hi = torch.amax(torch.where(valid, scores, torch.full_like(scores, -3.4e38)), dim=-1,
                    keepdim=True)
    span = hi - lo
    norm = (scores - lo) / torch.where(span > 0, span, torch.ones_like(span))
    if ascending_better:
        norm = 1.0 - norm
    # all-equal leg: every valid item is "best" (matches the host function)
    norm = torch.where(span > 1e-12, norm, torch.ones_like(norm))
    return torch.where(valid, norm, torch.zeros_like(norm))


def rsf_fuse_t(
    tags_v: torch.Tensor,
    rows_v: torch.Tensor,
    scores_v: torch.Tensor,
    tags_t: torch.Tensor,
    rows_t: torch.Tensor,
    scores_t: torch.Tensor,
    k: int,
    *,
    fusion_weight: float = 0.5,
    vec_ascending_better: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RSF (HybridSearchUtils.cpp:212-313): per-leg min-max normalize,
    fused = w·text + (1-w)·vec over the union. scores_v is the internal
    max-better score; because score→distance is affine per metric,
    normalizing it with metrics.score_ascending_better(metric) equals the
    reference's direction-aware normalization of distances."""
    w = float(fusion_weight)
    valid_v = torch.logical_and(tags_v >= 0, rows_v >= 0)
    valid_t = torch.logical_and(tags_t >= 0, rows_t >= 0)
    nv = _minmax_norm_t(scores_v, valid_v, vec_ascending_better) * (1.0 - w)
    nt = _minmax_norm_t(scores_t, valid_t, False) * w
    tags = torch.cat([tags_v, tags_t], dim=-1)
    rows = torch.cat([rows_v, rows_t], dim=-1)
    contrib = torch.cat([nv, nt], dim=-1)
    tot = _dedup_sum(tags, rows, contrib)
    return _cut(tags, rows, tot, k)
