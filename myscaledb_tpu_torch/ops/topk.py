"""Top-k selection and k-way merge primitives.

Counterpart of myscaledb_tpu/ops/topk.py. All selection happens on
max-is-better scores (metrics.py); missing slots are padded with
(-inf, -1). The vector paths select with `torch.topk`; the text and
fusion paths, whose scores tie exactly as a rule, select with
`topk_stable`, which orders ties as `jax.lax.top_k` does.

The approximate branch (`approx=True`, QuerySettings.use_approx_topk) is
the counterpart of `jax.lax.approx_max_k`, the TPU's PartialReduce
top-k: each score row folds into L bins (element i into bin i mod L,
L = `approx_reduction_output_size`, XLA's rule), the max of each bin
with its index (`approx_bin_max`, the CUDA kernel csrc/approx_topk.cu on
a CUDA tensor, its plain version on a CPU tensor), then the exact top-k
of the L winners. It only drops rows from the candidates: every value it
returns is that row's own score.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ._cuda import LIBRARY, cdiv, check_launch, count_launch, round_up, stream_ptr

NEG_INF = float("-inf")
# XLA's tiling of the reduced axis: 128 lanes, or 1,024 for a 1-D operand
LANE_TILING, CHUNK_TILING = 128, 1024


def _pad_k(vals: torch.Tensor, idx: torch.Tensor, k: int):
    if vals.shape[-1] < k:
        extra = k - vals.shape[-1]
        vals = tnf.pad(vals, (0, extra), value=NEG_INF)
        idx = tnf.pad(idx, (0, extra), value=-1)
    return vals, idx


def approx_reduction_output_size(n: int, k: int, recall_target: float, rank: int = 2) -> int:
    """L, the bins `jax.lax.approx_max_k` reduces a row of n scores to
    for the top k at `recall_target` (XLA's ApproxTopKReductionOutputSize,
    for an operand of `rank` dims). L >= n means the selection is exact.

    The expected recall of k neighbours in M bins is (1 - 1/M)^(k-1) ~
    exp((1 - k) / M), so M = (1 - k) / ln(recall_target), truncated; the
    row folds by the largest power of two 2^r with n // M >= 2^r and
    n // tiling >= 2^r, and L is ceil(n / 2^r) rounded up to the tiling.
    k = 1 folds straight to one tile. recall_target is a float32, as XLA
    takes it."""
    if k < 1 or n < 1:
        raise ValueError(f"need n >= 1 and k >= 1, got n={n} k={k}")
    r32 = float(np.float32(recall_target))
    if not 0.0 < r32 <= 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got {recall_target}")
    tiling = CHUNK_TILING if rank == 1 else LANE_TILING
    if n <= tiling:
        return n
    if k == 1:
        return tiling
    if r32 == 1.0:
        return n
    m = int((1.0 - k) / math.log(r32))
    log2_red = (n // m).bit_length() - 1 if m > 0 else 63
    log2_red = min(log2_red, (n // tiling).bit_length() - 1)
    if log2_red <= 0:
        return n
    return round_up(cdiv(n, 1 << log2_red), tiling)


def approx_bin_max_plain(scores: torch.Tensor, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold in torch ops: scores f32[Q, N] padded with -inf to a
    multiple of L and viewed as [Q, N / L, L]; each bin's max (`amax`) and
    the first fold row that holds it (`argmax` of `view == max`, which
    returns the first occurrence). Returns (vals f32[Q, L], idx int32[Q, L]),
    idx the row's position in [0, N)."""
    q, n = scores.shape
    f = cdiv(n, L)
    x = scores if f * L == n else tnf.pad(scores, (0, f * L - n), value=NEG_INF)
    v = x.reshape(q, f, L)
    m = torch.amax(v, dim=1)
    j = torch.argmax((v == m[:, None, :]).to(torch.uint8), dim=1)
    idx = j * L + torch.arange(L, device=scores.device)[None, :]
    return m, idx.to(torch.int32)


def approx_bin_max(scores: torch.Tensor, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each score row's max over L strided bins (bin b holds positions b,
    b + L, b + 2L, ...) with its position; of equal scores the lower
    position. scores: f32[Q, N], any row stride with unit column stride
    (a column slice of a wider matrix is read in place). Returns (vals
    f32[Q, L], idx int32[Q, L]). A CPU tensor runs the plain version, a
    CUDA tensor the kernel (csrc/approx_topk.cu)."""
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise TypeError(f"scores must be f32[Q, N], got {scores.dtype} {list(scores.shape)}")
    q, n = scores.shape
    if not 1 <= L <= n:
        raise ValueError(f"need 1 <= L <= N, got L={L} N={n}")
    if scores.device.type == "cpu":
        return approx_bin_max_plain(scores, L)
    if scores.device.type != "cuda":
        raise ValueError(f"unsupported device {scores.device}")
    if n > 1 and scores.stride(1) != 1:
        raise ValueError("the approx_bin_max kernel needs rows of unit stride")
    ld = scores.stride(0) if q > 1 else n
    if n + L >= 1 << 31 or ld >= 1 << 31:
        raise ValueError(f"rows too wide for the kernel: N={n} L={L} stride={ld}")
    vals = torch.empty((q, L), dtype=torch.float32, device=scores.device)
    idx = torch.empty((q, L), dtype=torch.int32, device=scores.device)
    if q == 0:
        return vals, idx
    err = LIBRARY.get().msd_approx_bin_max(
        scores.data_ptr(), vals.data_ptr(), idx.data_ptr(), q, n, ld, L,
        stream_ptr(scores.device),
    )
    check_launch("msd_approx_bin_max", err)
    count_launch(approx_bin_max)
    return vals, idx


approx_bin_max.launches = 0


def _approx_bins(scores: torch.Tensor, kk: int, recall_target: float):
    """The approximate branch's candidates: (winners f32[M, L], their
    positions int32[M, L]) over the rows of `scores` flattened to 2-D, or
    None where the branch is exact (kk >= N, or L >= N: no kernel runs)."""
    n = scores.shape[-1]
    if kk >= n:
        return None
    L = approx_reduction_output_size(n, kk, recall_target, scores.dim())
    if L >= n:
        return None
    return approx_bin_max(scores.reshape(-1, n), L)


def topk_scores(
    scores: torch.Tensor,
    k: int,
    *,
    approx: bool = False,
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis. Returns (values f32[..., k], idx
    int32[..., k]). With `approx`, the top-k of each row's L bin winners
    (`approx_bin_max`): the counterpart of `jax.lax.approx_max_k`."""
    n = scores.shape[-1]
    kk = min(k, n)
    bins = _approx_bins(scores, kk, recall_target) if approx else None
    if bins is None:
        vals, idx = torch.topk(scores, kk, dim=-1)
        return _pad_k(vals, idx.to(torch.int32), k)
    bv, bi = bins
    vals, pos = torch.topk(bv, kk, dim=-1)
    idx = torch.gather(bi, -1, pos)
    lead = scores.shape[:-1]
    return _pad_k(vals.reshape(*lead, kk), idx.reshape(*lead, kk), k)


def _ordered_bits(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of the f32 `scores` (IEEE bits with the
    negatives' magnitude bits flipped, so that signed integer order is
    float order)."""
    b = scores.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)


def _stable_select(vals: torch.Tensor, rows: Optional[torch.Tensor], n: int, kk: int):
    """The kk largest of `vals` with exact ties ordered by lower row (its
    position in [0, n): `rows`, or the position in `vals` when None): one
    `torch.topk` over int64 keys, the score's ordered bits in the high
    half and (n - 1 - row) in the low half (`torch.topk` itself promises
    no order among ties)."""
    if rows is None:
        rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=vals.device)
    else:
        rev = (n - 1) - rows.to(torch.int64)
    pos = torch.topk((_ordered_bits(vals) << 32) | rev, kk, dim=-1).indices  # distinct keys
    idx = pos if rows is None else torch.gather(rows, -1, pos)
    return torch.gather(vals, -1, pos), idx.to(torch.int32)


def topk_stable(
    scores: torch.Tensor,
    k: int,
    *,
    approx: bool = False,
    recall_target: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis that breaks exact ties as
    `jax.lax.top_k` does: the lower position first. With `approx`, the
    same order over each row's L bin winners (`approx_bin_max`), ties by
    lower original position. Returns (values f32[..., k], idx
    int32[..., k]), padded as `topk_scores`."""
    n = scores.shape[-1]
    kk = min(k, n)
    bins = _approx_bins(scores, kk, recall_target) if approx else None
    if bins is None:
        return _pad_k(*_stable_select(scores, None, n, kk), k)
    vals, idx = _stable_select(*bins, n, kk)
    lead = scores.shape[:-1]
    return _pad_k(vals.reshape(*lead, kk), idx.reshape(*lead, kk), k)


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
