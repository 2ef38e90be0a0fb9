"""The IVF window step's scores: csrc/window_scan.cu and its plain version.

An IVF index (index/ivf.py) keeps its encoded payload cluster-major in
512-row windows. A search turns each query's probed clusters into a
budget of W window slots (`widx` int64[Q, W], `valid` bool[Q, W]) and
scores every row of every live slot:

    out[q, w*512 + r] = metric(q[q] · dec(data[widx[q, w]*512 + r]))

in f32, -inf for every row of a dead slot (`valid` False), where dec
widens a bf16 or f32 row or decodes an SQ8 code (`quantize.sq8_decode_dev`)
and metric is 2 dot - aux[row] for L2, the dot for IP and Cosine.

`window_scan` sends a CUDA tensor to the kernel (see the note in
csrc/window_scan.cu for what bounds it on the H100) and a CPU tensor to
`window_scan_plain`, the same math in torch ops; there is no fallback from
one to the other. The payload's dtype says how it decodes: u8 codes take
(lo, scale), bf16 and f32 rows take neither. PQ codes have no kernel: the
index sends them to `window_scan_plain` with their codebooks.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..metrics import Metric
from . import quantize
from ._cuda import LIBRARY, METRIC_CODES, check_launch, count_launch, stream_ptr
from .distance import F32_SUM_TOL, _check_kernel_operands
from .topk import NEG_INF

WINDOW = 512  # rows a window
# Bound on one group's f32 transient [Q, G * WINDOW, D'|M] in the plain
# version (the JAX package's cap, which sizes its groups): it gathers and
# decodes at most this many bytes' worth of windows at a time.
GROUP_TRANSIENT_CAP = 512 << 20
# The kernel keeps an SQ8 payload's scale and lo in one block's shared
# memory: 8 bytes a dimension of Hopper's 232,448.
SQ8_MAX_D = 232_448 // 8


def decode_rows(
    gathered: torch.Tensor,
    lo: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    codebooks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gathered payload -> f32 rows for scoring: PQ codes through their
    codebooks, SQ8 codes through (lo, scale), stored rows widened. The JAX
    package scores gathered rows in f32 too: a bf16 hi/lo split of the
    query measured unsafe there."""
    if codebooks is not None:
        return quantize.pq_decode_dev(gathered, codebooks).to(torch.float32)
    if lo is not None:
        return quantize.sq8_decode_dev(gathered, lo, scale).to(torch.float32)
    return gathered.to(torch.float32)


def batched_dot(q: torch.Tensor, rows_mat: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [Q, B, D'] -> f32[Q, B]: one batched f32 matmul (exact
    while TF32 is off, the policy `connect` sets on CUDA)."""
    d = rows_mat.shape[-1]
    return torch.bmm(rows_mat, q[:, :d, None])[:, :, 0]


def window_scan_plain(
    queries: torch.Tensor,
    data: torch.Tensor,
    aux: torch.Tensor,
    widx: torch.Tensor,
    valid: torch.Tensor,
    *,
    metric: Metric,
    lo: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    codebooks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's math in torch ops, and PQ's scores: G window slots at
    a time (as many as keep the f32 copy under GROUP_TRANSIENT_CAP), each
    group one gather, one decode and one bmm for the whole batch; the
    groups' scores side by side, dead slots -inf."""
    nq, w_budget = widx.shape
    pdw = data.view(-1, WINDOW, data.shape[1])
    paw = aux.view(-1, WINDOW)
    elem = 4 * max(1, pdw.shape[-1])
    cap_windows = max(1, GROUP_TRANSIENT_CAP // max(1, nq * WINDOW * elem))
    group = max(1, min(w_budget, cap_windows))
    parts = []
    for s in range(0, w_budget, group):
        sl = widx[:, s : s + group]
        xb = decode_rows(pdw[sl], lo, scale, codebooks).reshape(nq, sl.shape[1] * WINDOW, -1)
        scores = batched_dot(queries, xb)
        del xb
        if metric == Metric.L2:
            scores = 2.0 * scores - paw[sl].reshape(nq, -1)
        parts.append(scores)
    dead = ~valid[:, :, None].expand(nq, w_budget, WINDOW).reshape(nq, -1)
    return torch.cat(parts, dim=1).masked_fill(dead, NEG_INF)


def scan_error_bound(
    queries: torch.Tensor,
    data: torch.Tensor,
    widx: torch.Tensor,
    metric: Metric,
    lo: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32[Q, W*512]: the |kernel - plain| each score may show, without its
    KERNEL_RTOL part. Both sum the same exact f32 products of the decoded
    row and the f32 query, in two orders, so they differ by a few f32 ulps
    of sum_i |q_i x_i|: the bound is F32_SUM_TOL = 2^-18 of that sum, x2
    for L2 (the form of `tilescan.rescore_error_bound`). A kernel that
    rounds the query to bf16 before its products errs by up to 2^-9 of
    each product, outside the bound."""
    nq, d = queries.shape
    g = decode_rows(data.view(-1, WINDOW, d)[widx], lo, scale).abs()  # [Q, W, WINDOW, D]
    t = (g * queries.to(torch.float32).abs()[:, None, None, :]).sum(dim=-1).reshape(nq, -1)
    return F32_SUM_TOL * (2.0 * t if metric == Metric.L2 else t)


def _check_window_args(queries, data, aux, widx, valid, metric, lo, scale) -> None:
    if queries.dim() != 2 or data.dim() != 2 or queries.shape[1] != data.shape[1]:
        raise ValueError(
            f"queries and data must be [Q, D] and [N, D], got {list(queries.shape)}, "
            f"{list(data.shape)}"
        )
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    n, d = data.shape
    if data.dtype == torch.uint8:
        for name, t in (("lo", lo), ("scale", scale)):
            if t is None or t.dtype != torch.float32 or t.shape != (d,):
                got = "None" if t is None else f"{t.dtype}{list(t.shape)}"
                raise ValueError(f"SQ8 codes need {name} float32[{d}], got {got}")
    elif data.dtype in (torch.bfloat16, torch.float32):
        if lo is not None or scale is not None:
            raise ValueError(f"{data.dtype} rows take no lo / scale")
    else:
        raise TypeError(f"data must be uint8 (SQ8), bfloat16 or float32, got {data.dtype}")
    if n % WINDOW:
        raise ValueError(f"data must hold whole {WINDOW}-row windows, got N={n}")
    if aux.dtype != torch.float32 or aux.shape != (n,):
        raise ValueError(f"aux must be float32[{n}], got {aux.dtype}{list(aux.shape)}")
    q = queries.shape[0]
    if widx.dtype != torch.int64 or widx.dim() != 2 or widx.shape[0] != q or widx.shape[1] < 1:
        raise ValueError(f"widx must be int64[{q}, W >= 1], got {widx.dtype}{list(widx.shape)}")
    if valid.dtype != torch.bool or valid.shape != widx.shape:
        raise ValueError(
            f"valid must be bool{list(widx.shape)}, got {valid.dtype}{list(valid.shape)}"
        )
    if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
        raise ValueError(f"window_scan does not take metric {metric}")
    tensors = [queries, aux, widx, valid] + ([lo, scale] if lo is not None else [])
    if any(t.device != data.device for t in tensors):
        raise ValueError("every operand must be on the payload's device")


def window_scan(
    queries: torch.Tensor,  # f32[Q, D] (normalized for Cosine)
    data: torch.Tensor,  # u8|bf16|f32[N, D], N a multiple of 512
    aux: torch.Tensor,  # f32[N] (L2 reads it)
    widx: torch.Tensor,  # int64[Q, W] window ids in [0, N/512)
    valid: torch.Tensor,  # bool[Q, W]
    *,
    metric: Metric,
    lo: Optional[torch.Tensor] = None,  # f32[D], SQ8 codes only
    scale: Optional[torch.Tensor] = None,  # f32[D], SQ8 codes only
) -> torch.Tensor:
    """f32[Q, W*512]: the scores of every row of each query's window slots,
    row w*512 + r of query q being row widx[q, w]*512 + r of the payload;
    -inf for every row of a slot whose `valid` is False."""
    _check_window_args(queries, data, aux, widx, valid, metric, lo, scale)
    if data.device.type == "cpu":
        return window_scan_plain(queries, data, aux, widx, valid, metric=metric, lo=lo,
                                 scale=scale)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    q, d = queries.shape
    if d % 128:
        raise ValueError(f"window_scan needs D % 128 == 0, got D={d}")
    if data.dtype == torch.uint8 and d > SQ8_MAX_D:
        raise ValueError(f"window_scan takes SQ8 codes of D <= {SQ8_MAX_D}, got D={d}")
    sq8 = [lo, scale] if lo is not None else []
    _check_kernel_operands(queries, data, aux, widx, valid, *sq8, d=d)
    w = widx.shape[1]
    out = torch.empty((q, w * WINDOW), dtype=torch.float32, device=data.device)
    if q == 0:
        return out
    err = LIBRARY.get().msd_window_scan(
        queries.data_ptr(), data.data_ptr(), aux.data_ptr(),
        lo.data_ptr() if sq8 else None, scale.data_ptr() if sq8 else None,
        widx.data_ptr(), valid.data_ptr(), out.data_ptr(), q, w, d, data.element_size(),
        METRIC_CODES[metric.value], stream_ptr(data.device),
    )
    check_launch("msd_window_scan", err)
    count_launch(window_scan)
    return out


window_scan.launches = 0
