"""Binary-vector scores: Hamming and Jaccard over packed bits, csrc/binary.cu
and its plain version.

Counterpart of myscaledb_tpu/ops/binary.py. Vectors are packed uint8 rows
(FixedString(D/8)); scores use the max-is-better convention of metrics.py:

  Hamming:  score = -popcount(q ^ x)
  Jaccard:  score = |q & x| / |q | x|   (1.0 when the union is empty)

The JAX package counts bits with `lax.population_count`; torch has none.
`binary_scores` (one shared base, `msd_binary_rows`) and
`binary_block_scores` (per-query blocks, `msd_binary_blocks`) send a CUDA
tensor to the hand-written kernel (see csrc/binary.cu for what bounds it)
and a CPU tensor to their plain versions, a 256-entry popcount table over
bytes. There is no fallback from one to the other. Both fuse the row mask:
a row that is not searchable scores -inf. Scores are integers or an f32
quotient of two, so the kernel equals its plain version bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..metrics import Metric
from ._cuda import LIBRARY, check_launch, stream_ptr
from .topk import NEG_INF, merge_topk_lists, topk_scores

DEFAULT_CHUNK_ROWS = 64 * 1024
METRIC_CODES = {Metric.HAMMING: 0, Metric.JACCARD: 1}
# the plain version's [Q, rows, B] byte tensors are cut to this many bytes
PLAIN_BLOCK_BYTES = 1 << 25


def _lut(device) -> torch.Tensor:
    return torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32, device=device)


def _counts_plain(q: torch.Tensor, x: torch.Tensor, metric: Metric):
    """(a, u) int32[..., Q?, N]: for q u8[..., Q, B] and x u8[..., N, B]
    (leading dims broadcast), Hamming: a = popcount(q ^ x), u unused;
    Jaccard: a = |q & x|, u = |q | x|. Summed over bytes with a lookup
    table, in blocks of rows so no [Q, N, B] tensor exceeds
    PLAIN_BLOCK_BYTES."""
    lut = _lut(q.device)
    qe = q[..., :, None, :]
    n, b = x.shape[-2], x.shape[-1]
    step = max(1, PLAIN_BLOCK_BYTES // max(1, q[..., 0].numel() * b))
    a_parts, u_parts = [], []
    for s in range(0, max(n, 1), step):
        xe = x[..., None, s : s + step, :]
        if metric == Metric.HAMMING:
            a_parts.append(lut[(qe ^ xe).to(torch.int64)].sum(-1, dtype=torch.int32))
        else:
            a_parts.append(lut[(qe & xe).to(torch.int64)].sum(-1, dtype=torch.int32))
            u_parts.append(lut[(qe | xe).to(torch.int64)].sum(-1, dtype=torch.int32))
    a = torch.cat(a_parts, dim=-1)
    return a, (torch.cat(u_parts, dim=-1) if u_parts else None)


def _finish(a, u, metric: Metric) -> torch.Tensor:
    if metric == Metric.HAMMING:
        return -(a.to(torch.float32))
    inter, union = a.to(torch.float32), u.to(torch.float32)
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0), torch.ones_like(union))


def _check_metric(metric: Metric) -> None:
    if metric not in METRIC_CODES:
        raise ValueError(f"not a binary metric: {metric}")


def binary_scores_plain(
    q: torch.Tensor, x: torch.Tensor, metric: Metric, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """scores f32[Q, N] for packed u8 q[Q, B], x[N, B]; -inf where
    `valid` (bool[N]) is False."""
    _check_metric(metric)
    s = _finish(*_counts_plain(q, x, metric), metric)
    if valid is not None:
        s = torch.where(valid[None, :], s, torch.full_like(s, NEG_INF))
    return s


def _row_valid(n: int, n_valid: Optional[int], mask, device) -> Optional[torch.Tensor]:
    valid = None
    if n_valid is not None and n_valid < n:
        valid = torch.arange(n, device=device) < n_valid
    if mask is not None:
        m = mask.to(torch.bool)
        valid = m if valid is None else torch.logical_and(valid, m)
    return valid


def _check_u8(*tensors) -> None:
    for t in tensors:
        if t.dtype != torch.uint8:
            raise TypeError(f"packed bits must be uint8, got {t.dtype}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("operands must be on one device")


def _kernel_ready(*tensors) -> None:
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the binary kernel needs contiguous operands")


def _aligned(b: int, *tensors) -> int:
    return int(b % 4 == 0 and all(t.data_ptr() % 4 == 0 for t in tensors))


def binary_scores(
    q: torch.Tensor,  # u8[Q, B]
    x: torch.Tensor,  # u8[N, B]
    metric: Metric,
    *,
    n_valid: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,  # bool|u8[N]
) -> torch.Tensor:
    """f32[Q, N] scores of every query against every row of one shared
    base; rows >= n_valid or where `mask` is False score -inf."""
    _check_metric(metric)
    _check_u8(q, x)
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"need q [Q, B] and x [N, B], got {list(q.shape)}, {list(x.shape)}")
    if mask is not None and mask.shape != (x.shape[0],):
        raise ValueError(f"mask must be [{x.shape[0]}], got {list(mask.shape)}")
    n = x.shape[0]
    if x.device.type == "cpu":
        return binary_scores_plain(q, x, metric, _row_valid(n, n_valid, mask, x.device))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m8 = None if mask is None else mask.to(torch.uint8).contiguous()
    _kernel_ready(q, x)
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=x.device)
    if q.shape[0] == 0 or n == 0:
        return out
    b = x.shape[1]
    err = LIBRARY.get().msd_binary_rows(
        q.data_ptr(), x.data_ptr(), None if m8 is None else m8.data_ptr(), out.data_ptr(),
        q.shape[0], n, b, n if n_valid is None else min(int(n_valid), n), METRIC_CODES[metric],
        _aligned(b, q, x), stream_ptr(x.device),
    )
    check_launch("msd_binary_rows", err)
    binary_scores.launches += 1
    return out


binary_scores.launches = 0


def binary_block_scores_plain(
    q: torch.Tensor, x: torch.Tensor, blk: torch.Tensor, rows: torch.Tensor,
    mask: Optional[torch.Tensor], metric: Metric,
) -> torch.Tensor:
    """The blocks layout's math in torch ops: gather each query's P blocks
    (`index_select` of x[clamp(blk)]) and score them; slots whose row id
    is < 0 or whose row `mask` drops score -inf."""
    _check_metric(metric)
    nq, p = blk.shape
    c, m, b = x.shape
    cl = torch.clamp(blk.reshape(-1).to(torch.int64), 0, c - 1)
    xb = x.index_select(0, cl).reshape(nq, p * m, b)
    a, u = _counts_plain(q[:, None, :], xb, metric)  # [Q, 1, P*M]
    s = _finish(a, u, metric)[:, 0, :]
    r = rows.index_select(0, cl).reshape(nq, p * m)
    valid = r >= 0
    if mask is not None:
        inside = r < mask.shape[0]
        mv = mask.to(torch.bool)[torch.clamp(r, 0, mask.shape[0] - 1).to(torch.int64)]
        valid = valid & inside & mv
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def binary_block_scores(
    q: torch.Tensor,  # u8[Q, B]
    x: torch.Tensor,  # u8[C, M, B]: blocks of M rows
    blk: torch.Tensor,  # int32[Q, P]: the blocks of each query (clamped to [0, C))
    rows: torch.Tensor,  # int32[C, M]: each slot's segment row id, -1 = empty
    metric: Metric,
    *,
    mask: Optional[torch.Tensor] = None,  # bool|u8[N] over segment rows
) -> torch.Tensor:
    """f32[Q, P*M]: query q against the M rows of each of its P blocks
    x[blk[q, p]], read in place; a slot with row id < 0, or whose row
    `mask` drops, scores -inf."""
    _check_metric(metric)
    _check_u8(q, x)
    if q.dim() != 2 or x.dim() != 3 or q.shape[1] != x.shape[2]:
        raise ValueError(f"need q [Q, B] and x [C, M, B], got {list(q.shape)}, {list(x.shape)}")
    if blk.shape[0] != q.shape[0] or blk.dim() != 2 or rows.shape != x.shape[:2]:
        raise ValueError(
            f"need blk [Q, P] and rows [C, M], got {list(blk.shape)}, {list(rows.shape)}"
        )
    if blk.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError("blk and rows must be int32")
    if x.device.type == "cpu":
        return binary_block_scores_plain(q, x, blk, rows, mask, metric)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m8 = None if mask is None else mask.to(torch.uint8).contiguous()
    _kernel_ready(q, x, blk, rows)
    nq, p = blk.shape
    c, m, b = x.shape
    out = torch.empty((nq, p * m), dtype=torch.float32, device=x.device)
    if nq == 0 or p == 0 or m == 0:
        return out
    if c == 0:
        raise ValueError("x holds no blocks")
    err = LIBRARY.get().msd_binary_blocks(
        q.data_ptr(), x.data_ptr(), blk.data_ptr(), rows.data_ptr(),
        None if m8 is None else m8.data_ptr(), out.data_ptr(), nq, p, m, b, c,
        0 if m8 is None else m8.shape[0], METRIC_CODES[metric], _aligned(b, q, x),
        stream_ptr(x.device),
    )
    check_launch("msd_binary_blocks", err)
    binary_block_scores.launches += 1
    return out


binary_block_scores.launches = 0


def binary_chunk_scores(q: torch.Tensor, x: torch.Tensor, metric: Metric) -> torch.Tensor:
    """scores f32[Q, Nc] for packed uint8 q[Q, B], x[Nc, B] (JAX's
    unmasked chunk score; on a CUDA tensor, the rows kernel)."""
    return binary_scores(q, x, metric)


def binary_scan_topk(
    queries: torch.Tensor,  # uint8[Q, B]
    base: torch.Tensor,  # uint8[N, B]
    *,
    k: int,
    metric: Metric,
    n_valid: int,
    mask: Optional[torch.Tensor] = None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked exact binary top-k, in the JAX package's row chunks (the
    largest multiple of 1,024 rows that divides N and is at most
    `chunk_rows`): one kernel launch and one `torch.topk` per chunk, then
    one merge."""
    n, _ = base.shape
    chunk = n
    if n > chunk_rows and n % 1024 == 0:
        units = n // 1024
        best = 1
        for c in range(1, max(1, chunk_rows // 1024) + 1):
            if units % c == 0:
                best = c
        chunk = best * 1024
    cvals, cidx = [], []
    for off in range(0, n, chunk):
        m = None if mask is None else mask[off : off + chunk]
        s = binary_scores(queries, base[off : off + chunk], metric,
                          n_valid=max(0, min(chunk, n_valid - off)), mask=m)
        v, i = topk_scores(s, k)
        cvals.append(v)
        cidx.append(torch.where(i >= 0, i + off, i))
    if len(cvals) == 1:
        vals, idx = cvals[0], cidx[0]
    else:
        vals, idx = merge_topk_lists(torch.stack(cvals, dim=1), torch.stack(cidx, dim=1), k)
    idx = torch.where(torch.isfinite(vals), idx, torch.full_like(idx, -1))
    return vals, idx.to(torch.int32)


def unpack_bits_f32(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """uint8[..., B] -> f32[..., dim] of {0, 1}, most significant bit
    first (numpy's `unpackbits` order), for k-means over binary rows."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :dim].to(torch.float32)
