"""Binary-vector scores: Hamming and Jaccard over packed bits, csrc/binary.cu
and its plain version.

Counterpart of myscaledb_tpu/ops/binary.py. Vectors are packed uint8 rows
(FixedString(D/8)); scores use the max-is-better convention of metrics.py:

  Hamming:  score = -popcount(q ^ x)
  Jaccard:  score = |q & x| / |q | x|   (1.0 when the union is empty)

The JAX package counts bits with `lax.population_count`; torch has none.
`binary_scores` (one shared base, `msd_binary_rows`) and
`binary_block_scores` (per-query blocks: `group_probes`, which orders the
(query, probe) pairs by bucket with `msd_binary_group`, then
`msd_binary_blocks`, which scores each bucket tile against a group of up
to 16 of its queries) send a CUDA tensor to the hand-written kernels (see
csrc/binary.cu for what bounds them) and a CPU tensor to their plain
versions, a 256-entry popcount table over bytes. There is no fallback from
one to the other. Both fuse the row mask: a row that is not searchable
scores -inf. The blocks layout takes each slot's bit count (`popcnt`), so
that Jaccard's union is |q| + |x| - |q & x|: one popcount a word. Scores
are integers or an f32 quotient of two, so the kernels equal their plain
versions bit for bit (and the one-popcount Jaccard the two-popcount one).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..metrics import Metric
from ._cuda import LIBRARY, cdiv, check_launch, count_launch, stream_ptr
from .topk import NEG_INF, merge_topk_lists, topk_scores

DEFAULT_CHUNK_ROWS = 64 * 1024
METRIC_CODES = {Metric.HAMMING: 0, Metric.JACCARD: 1}
# the plain version's [Q, rows, B] byte tensors are cut to this many bytes
PLAIN_BLOCK_BYTES = 1 << 25
# (query, probe) pairs of one group of the blocks layout, and the bucket
# rows of one work item (csrc/binary.cu's BN_QT and BB_ROWS)
QT = 16
BLOCK_ROWS = 256
# buckets the grouping kernel takes: its sort key holds a bucket id in 21 bits
MAX_BUCKETS = (1 << 21) - 1


def _lut(device) -> torch.Tensor:
    return torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32, device=device)


def row_popcounts(x: torch.Tensor) -> torch.Tensor:
    """int32[...]: the number of set bits of each packed row of u8
    x[..., B], in slices of at most PLAIN_BLOCK_BYTES."""
    out = torch.empty(x.shape[:-1], dtype=torch.int32, device=x.device)
    flat, dst = x.reshape(-1, x.shape[-1]), out.reshape(-1)
    step = max(1, PLAIN_BLOCK_BYTES // max(1, x.shape[-1]))
    for s in range(0, flat.shape[0], step):
        v = flat[s : s + step]
        v = v - ((v >> 1) & 0x55)
        v = (v & 0x33) + ((v >> 2) & 0x33)
        dst[s : s + step] = ((v + (v >> 4)) & 0x0F).sum(-1, dtype=torch.int32)
    return out


def _counts_plain(q: torch.Tensor, x: torch.Tensor, metric: Metric, union: bool = True):
    """(a, u) int32[..., Q?, N]: for q u8[..., Q, B] and x u8[..., N, B]
    (leading dims broadcast), Hamming: a = popcount(q ^ x), u unused;
    Jaccard: a = |q & x|, u = |q | x| (None when not `union`). Summed over
    bytes with a lookup table, in blocks of rows so no [Q, N, B] tensor
    exceeds PLAIN_BLOCK_BYTES."""
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
            if union:
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
    count_launch(binary_scores)
    return out


binary_scores.launches = 0


def group_bound(n_pairs: int, c: int) -> int:
    """Most groups `n_pairs` pairs over `c` buckets can make: a bucket with
    n pairs makes ceil(n / QT) <= n / QT + 1."""
    return cdiv(n_pairs, QT) + min(c, n_pairs)


def group_probes_plain(blk: torch.Tensor, c: int, qt: int = QT):
    """The blocks layout's grouping in torch ops. For blk int32[Q, P]
    (clamped to [0, c)), pair i = q * P + p: (pairs int32[Q * P], the pairs
    ordered by (bucket, i); groups int32[group_bound, 3], each bucket's run
    cut into (bucket, first place in pairs, count <= qt), in bucket order,
    rows past the count -1; count int32[1], the number of groups)."""
    dev = blk.device
    b = torch.clamp(blk.reshape(-1).to(torch.int64), 0, c - 1)
    n = b.numel()
    pairs = torch.sort(b, stable=True).indices.to(torch.int32)
    counts = torch.bincount(b, minlength=c)
    first = torch.cumsum(counts, 0) - counts
    per = (counts + qt - 1) // qt
    bucket = torch.repeat_interleave(torch.arange(c, device=dev), per)
    k = torch.arange(bucket.numel(), device=dev) - (torch.cumsum(per, 0) - per)[bucket]
    groups = torch.full((group_bound(n, c), 3), -1, dtype=torch.int32, device=dev)
    groups[: bucket.numel()] = torch.stack(
        [bucket, first[bucket] + k * qt, torch.clamp(counts[bucket] - k * qt, max=qt)], 1
    ).to(torch.int32)
    return pairs, groups, torch.tensor([bucket.numel()], dtype=torch.int32, device=dev)


def group_probes(blk: torch.Tensor, c: int):
    """`group_probes_plain(blk, c)`'s (pairs, groups, count), by one launch
    of `msd_binary_group` on a CUDA tensor: the count stays on the device
    and the groups' rows past it are not written."""
    if blk.dtype != torch.int32 or blk.dim() != 2:
        raise TypeError(f"blk must be int32[Q, P], got {blk.dtype} {list(blk.shape)}")
    if not 1 <= c <= MAX_BUCKETS:
        raise ValueError(f"the grouping takes 1 to {MAX_BUCKETS} buckets, got {c}")
    if blk.device.type == "cpu":
        return group_probes_plain(blk, c)
    if blk.device.type != "cuda":
        raise ValueError(f"unsupported device {blk.device}")
    _kernel_ready(blk)
    n = blk.numel()
    if n >= 1 << 31:
        raise ValueError(f"too many (query, probe) pairs: {n}")
    bound = group_bound(n, c)
    # one allocation: pairs [n], groups [bound, 3], count [1], scratch [c]
    buf = torch.empty(n + 3 * bound + 1 + c, dtype=torch.int32, device=blk.device)
    pairs, groups = buf[:n], buf[n : n + 3 * bound].view(bound, 3)
    count, cursor = buf[n + 3 * bound : n + 3 * bound + 1], buf[n + 3 * bound + 1 :]
    if n == 0:
        count.zero_()
        return pairs, groups, count
    err = LIBRARY.get().msd_binary_group(
        blk.data_ptr(), n, c, cursor.data_ptr(), pairs.data_ptr(), groups.data_ptr(),
        count.data_ptr(), stream_ptr(blk.device),
    )
    check_launch("msd_binary_group", err)
    count_launch(group_probes)
    return pairs, groups, count


group_probes.launches = 0


def binary_block_scores_plain(
    q: torch.Tensor, x: torch.Tensor, blk: torch.Tensor, rows: torch.Tensor,
    mask: Optional[torch.Tensor], metric: Metric, popcnt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The blocks layout's math in torch ops: gather each query's P blocks
    (`index_select` of x[clamp(blk)]) and score them; slots whose row id
    is < 0 or whose row `mask` drops score -inf. With `popcnt` (int32[C,
    M], each slot's bit count), Jaccard's union is |q| + |x| - |q & x|, as
    in the kernel; without it, |q | x| (the two-popcount reference)."""
    _check_metric(metric)
    nq, p = blk.shape
    c, m, b = x.shape
    cl = torch.clamp(blk.reshape(-1).to(torch.int64), 0, c - 1)
    xb = x.index_select(0, cl).reshape(nq, p * m, b)
    one_pass = metric == Metric.JACCARD and popcnt is not None
    a, u = _counts_plain(q[:, None, :], xb, metric, union=not one_pass)  # [Q, 1, P*M]
    if one_pass:
        xn = popcnt.index_select(0, cl).reshape(nq, 1, p * m)
        u = row_popcounts(q)[:, None, None] + xn - a
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
    popcnt: Optional[torch.Tensor] = None,  # int32[C, M]: each slot's bit count
) -> torch.Tensor:
    """f32[Q, P*M]: query q against the M rows of each of its P blocks
    x[blk[q, p]], read in place; a slot with row id < 0, or whose row
    `mask` drops, scores -inf. Jaccard needs `popcnt` (one popcount a
    word); Hamming does not read it. On a CUDA tensor: `group_probes`,
    then one launch of `msd_binary_blocks`."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    pc = popcnt if metric == Metric.JACCARD else None
    if metric == Metric.JACCARD and (popcnt is None or popcnt.shape != rows.shape
                                     or popcnt.dtype != torch.int32 or popcnt.device != x.device):
        raise ValueError(f"Jaccard needs popcnt int32{list(rows.shape)} on {x.device}")
    if x.device.type == "cpu":
        return binary_block_scores_plain(q, x, blk, rows, mask, metric, pc)
    m8 = None if mask is None else mask.to(torch.uint8).contiguous()
    _kernel_ready(q, x, blk, rows, pc)
    nq, p = blk.shape
    c, m, b = x.shape
    out = torch.empty((nq, p * m), dtype=torch.float32, device=x.device)
    if nq == 0 or p == 0 or m == 0:
        return out
    if c == 0:
        raise ValueError("x holds no blocks")
    if group_bound(nq * p, c) * cdiv(m, BLOCK_ROWS) >= 1 << 31:
        raise ValueError(f"too many work items: Q={nq} P={p} C={c} M={m}")
    pairs, groups, count = group_probes(blk, c)
    err = LIBRARY.get().msd_binary_blocks(
        q.data_ptr(), x.data_ptr(), rows.data_ptr(), None if m8 is None else m8.data_ptr(),
        None if pc is None else pc.data_ptr(), pairs.data_ptr(), groups.data_ptr(),
        count.data_ptr(), out.data_ptr(), p, m, b, 0 if m8 is None else m8.shape[0],
        METRIC_CODES[metric], _aligned(b, q, x), int(b % 16 == 0 and x.data_ptr() % 16 == 0),
        stream_ptr(x.device),
    )
    check_launch("msd_binary_blocks", err)
    count_launch(binary_block_scores)
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
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked binary top-k, in the JAX package's row chunks (the largest
    multiple of 1,024 rows that divides N and is at most `chunk_rows`):
    one kernel launch and one `topk_scores` per chunk, then one merge.
    Exact, or with `approx` each chunk's top-k by the approximate branch
    at the JAX package's default recall target (the scores stay exact)."""
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
        v, i = topk_scores(s, k, approx=approx)
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
