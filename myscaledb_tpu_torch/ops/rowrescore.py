"""A two-stage IVF index's exact re-rank: csrc/row_rescore.cu and its plain
version.

IVFSQ, IVFPQ and MSTG rank candidates on their codes, then re-score each
query's C candidates exactly against the segment's stored rows
(`index/ivf.py::IVFIndex._exact_scores`):

    out[q, c] = metric(q[q] · float(data[ids[q, c]]))

in f32, -inf where ids[q, c] < 0, where metric is 2 dot - aux[row] for L2,
the dot for IP, and dot / |x| for Cosine (0 for a zero row), |x| the f32
norm of the same widened row.

`row_rescore` sends a CUDA tensor to the kernel (see the note in
csrc/row_rescore.cu for what bounds it on the H100) and a CPU tensor to
`row_rescore_plain`, the same math in torch ops; there is no fallback from
one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..metrics import Metric
from ._cuda import LIBRARY, METRIC_CODES, check_launch, count_launch, stream_ptr
from .distance import F32_SUM_TOL, _check_kernel_operands
from .topk import NEG_INF
from .windowscan import batched_dot


def _gather(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """f32[Q, C, D]: the rows of `ids` widened, row 0 in place of a negative id."""
    return data[torch.clamp(ids, min=0).to(torch.int64)].to(torch.float32)


def _inv_norms(rows: torch.Tensor) -> torch.Tensor:
    """1 / |x| of each f32 row, 0 for a zero row."""
    nrm = torch.linalg.vector_norm(rows, dim=-1)
    return torch.where(nrm > 0, 1.0 / torch.where(nrm > 0, nrm, torch.ones_like(nrm)), 0.0)


def row_rescore_plain(
    queries: torch.Tensor,
    data: torch.Tensor,
    aux: Optional[torch.Tensor],
    ids: torch.Tensor,
    metric: Metric,
) -> torch.Tensor:
    """The kernel's math in torch ops, the library passes it replaced: a
    gather of the rows, their f32 copy, one batched f32 GEMV, and for
    Cosine the rows' norms; -inf where ids < 0."""
    rows = _gather(data, ids)  # [Q, C, D]
    s = batched_dot(queries, rows)
    if metric == Metric.L2:
        s = 2.0 * s - aux[torch.clamp(ids, min=0).to(torch.int64)]
    elif metric == Metric.COSINE:
        s = s * _inv_norms(rows)
    return s.masked_fill(ids < 0, NEG_INF)


def rerank_error_bound(
    queries: torch.Tensor, data: torch.Tensor, ids: torch.Tensor, metric: Metric
) -> torch.Tensor:
    """f32[Q, C]: the |kernel - plain| each score may show, without its
    KERNEL_RTOL part (the form of `windowscan.scan_error_bound`). Both sum
    the same exact f32 products of the widened row and the f32 query, in
    two orders, so their dots differ by a few f32 ulps of t = sum_i
    |q_i x_i|: F32_SUM_TOL = 2^-18 of it, x2 for L2. For Cosine the dot is
    scaled by 1 / |x|, and the norm, a sum of squares in two orders, is off
    by as much again of the score: F32_SUM_TOL (t + |dot|) / |x|, 0 for a
    zero row (both read 0 there) and for a negative id (both -inf). A
    kernel that rounds the query to bf16 before its products errs by up to
    2^-9 of each product, outside the bound."""
    rows = _gather(data, ids)
    q = queries.to(torch.float32)
    t = (rows.abs() * q.abs()[:, None, :]).sum(dim=-1)
    if metric == Metric.L2:
        t = 2.0 * t
    elif metric == Metric.COSINE:
        dot = (rows * q[:, None, :]).sum(dim=-1)
        t = (t + dot.abs()) * _inv_norms(rows)
    return (F32_SUM_TOL * t).masked_fill(ids < 0, 0.0)


def _check_rescore_args(queries, data, aux, ids, metric) -> None:
    if queries.dim() != 2 or data.dim() != 2 or queries.shape[1] != data.shape[1]:
        raise ValueError(
            f"queries and data must be [Q, D] and [N, D], got {list(queries.shape)}, "
            f"{list(data.shape)}"
        )
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    if data.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"data must be bfloat16 or float32, got {data.dtype}")
    q, n = queries.shape[0], data.shape[0]
    if ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[0] != q or ids.shape[1] < 1:
        raise ValueError(f"ids must be int32[{q}, C >= 1], got {ids.dtype}{list(ids.shape)}")
    if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
        raise ValueError(f"row_rescore does not take metric {metric}")
    if metric == Metric.L2 and (aux is None or aux.dtype != torch.float32 or aux.shape != (n,)):
        got = "None" if aux is None else f"{aux.dtype}{list(aux.shape)}"
        raise ValueError(f"L2 needs aux float32[{n}], got {got}")
    tensors = [queries, ids] + ([aux] if aux is not None else [])
    if any(t.device != data.device for t in tensors):
        raise ValueError("every operand must be on the payload's device")


def row_rescore(
    queries: torch.Tensor,  # f32[Q, D] (normalized for Cosine)
    data: torch.Tensor,  # bf16|f32[N, D]
    aux: Optional[torch.Tensor],  # f32[N] |x|^2 (L2 reads it)
    ids: torch.Tensor,  # int32[Q, C] row ids in [0, N), or negative
    *,
    metric: Metric,
) -> torch.Tensor:
    """f32[Q, C]: the exact score of row ids[q, c] against query q, -inf
    where ids[q, c] < 0 (that row is not read)."""
    _check_rescore_args(queries, data, aux, ids, metric)
    if data.device.type == "cpu":
        return row_rescore_plain(queries, data, aux, ids, metric)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    q, d = queries.shape
    if d % 128:
        raise ValueError(f"row_rescore needs D % 128 == 0, got D={d}")
    _check_kernel_operands(queries, data, d=d)
    if not ids.is_contiguous() or (aux is not None and not aux.is_contiguous()):
        raise ValueError("the CUDA scan kernels need contiguous operands")
    c = ids.shape[1]
    out = torch.empty((q, c), dtype=torch.float32, device=data.device)
    if q == 0:
        return out
    err = LIBRARY.get().msd_row_rescore(
        queries.data_ptr(), data.data_ptr(), aux.data_ptr() if aux is not None else None,
        ids.data_ptr(), out.data_ptr(), q, c, d, data.element_size(),
        METRIC_CODES[metric.value], stream_ptr(data.device),
    )
    check_launch("msd_row_rescore", err)
    count_launch(row_rescore)
    return out


row_rescore.launches = 0
