"""Fused neighbour-block gather + traversal mat-vec: csrc/gathermv.cu and
its plain version.

Counterpart of myscaledb_tpu/ops/gathermv.py. The HNSW frontier
expansion scores each query's BEAM expanded nodes' neighbour-code blocks
(`nbdata` u8[N, m, Dt], the node-block layout of index/hnsw.py):

    out[q, b*m + j] = sum_d bf16(qs[q, d]) * nbdata[rows[q, b], j, d]

in f32. `gather_block_scores` sends a CUDA tensor to the kernel (see the
note in csrc/gathermv.cu for what bounds it on the H100) and a CPU tensor
to `gather_block_scores_plain`, the same math in torch ops. There is no
fallback from one to the other. Row ids are clamped to [0, N) by both.
"""

from __future__ import annotations

import torch

from ._cuda import LIBRARY, check_launch, count_launch, stream_ptr

# The kernel keeps the bf16-rounded query in shared memory as f32; without
# opting in to more, a block may hold 48 KB of it, so Dt <= 12,288.
MAX_DT = (48 * 1024) // 4
# The kernel loads codes in 16-byte chunks, each wholly inside a row.
DT_MULTIPLE = 16

# How far the kernel may lie from its plain version. Each product of a
# bf16 query value and a u8 code is exact in f32, so the two differ only
# in the order of their f32 sums, a few f32 ulps of sum_d |qs_d c_d|. The
# bound is 2^-16 of that sum plus 1e-5 of the score, as for the scan
# kernels (`distance.kernel_error_bound`). A kernel that skips the bf16
# cast of the query errs by up to 2^-9 of the same sum, outside the bound.
KERNEL_RTOL = 1e-5
KERNEL_SUM_TOL = 2.0**-16


def supports(dt: int) -> bool:
    """Whether the kernel takes node blocks of width Dt: 16-byte chunks
    (DT_MULTIPLE) and the query's f32 copy in 48 KB of shared memory
    (MAX_DT). Any m, BEAM and Q are taken. The JAX package's alignment
    rules (m % 32, Dt % 128, BEAM·m % 128) and its VMEM term were Mosaic
    tiling limits, which this kernel does not have."""
    return dt % DT_MULTIPLE == 0 and dt <= MAX_DT


def _gather_blocks(rows: torch.Tensor, nbdata: torch.Tensor) -> torch.Tensor:
    """[Q, BEAM, m, Dt] copy of the blocks of `rows`, clamped to [0, N)."""
    q, beam = rows.shape
    n, m, dt = nbdata.shape
    flat = torch.clamp(rows.reshape(-1).to(torch.int64), 0, n - 1)
    return nbdata.index_select(0, flat).reshape(q, beam, m, dt)


def gather_block_scores_plain(
    qs: torch.Tensor, rows: torch.Tensor, nbdata: torch.Tensor
) -> torch.Tensor:
    """The kernel's math in torch ops: `index_select` of the blocks, then
    an f32 einsum against the queries rounded to bf16 and back."""
    q, beam = rows.shape
    g = _gather_blocks(rows, nbdata).to(torch.float32)
    qb = qs.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("qd,qbmd->qbm", qb, g).reshape(q, beam * nbdata.shape[1])


def kernel_error_bound(qs: torch.Tensor, rows: torch.Tensor, nbdata: torch.Tensor) -> torch.Tensor:
    """f32[Q, BEAM*m]: the |kernel - plain| each score may show, without its
    KERNEL_RTOL part: KERNEL_SUM_TOL times sum_d |bf16(qs_d) c_d|."""
    q, beam = rows.shape
    g = _gather_blocks(rows, nbdata).to(torch.float32)
    qb = qs.to(torch.bfloat16).to(torch.float32).abs()
    return KERNEL_SUM_TOL * torch.einsum("qd,qbmd->qbm", qb, g).reshape(q, -1)


def unrounded_control(qs: torch.Tensor, rows: torch.Tensor, nbdata: torch.Tensor) -> torch.Tensor:
    """What a kernel that skips the bf16 cast of the query would compute:
    the plain version's einsum against the f32 queries. It must fall outside
    `kernel_error_bound`, which shows the bound catches such a kernel."""
    q, beam = rows.shape
    g = _gather_blocks(rows, nbdata).to(torch.float32)
    return torch.einsum("qd,qbmd->qbm", qs, g).reshape(q, beam * nbdata.shape[1])


def outside_kernel_bound(got: torch.Tensor, want: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """bool mask of the entries of `got` outside `bound` + KERNEL_RTOL *
    |want| of the plain version's `want`."""
    return (got - want).abs() > bound + KERNEL_RTOL * want.abs()


def _check_args(qs, rows, nbdata):
    if qs.dim() != 2 or rows.dim() != 2 or nbdata.dim() != 3:
        raise ValueError(
            f"need qs [Q, Dt], rows [Q, BEAM], nbdata [N, m, Dt]; got "
            f"{list(qs.shape)}, {list(rows.shape)}, {list(nbdata.shape)}"
        )
    if qs.shape[0] != rows.shape[0] or qs.shape[1] != nbdata.shape[2]:
        raise ValueError(
            f"shape mismatch: qs {list(qs.shape)}, rows {list(rows.shape)}, "
            f"nbdata {list(nbdata.shape)}"
        )
    if qs.dtype != torch.float32:
        raise TypeError(f"qs must be float32, got {qs.dtype}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if nbdata.dtype != torch.uint8:
        raise TypeError(f"nbdata must be uint8, got {nbdata.dtype}")
    if nbdata.shape[0] == 0 and rows.numel():
        raise ValueError("nbdata holds no blocks")
    if not (qs.device == rows.device == nbdata.device):
        raise ValueError("qs, rows and nbdata must be on one device")


def gather_block_scores(
    qs: torch.Tensor,  # f32[Q, Dt]: the traversal query pre-scaled by the sq8 scale
    rows: torch.Tensor,  # int32[Q, BEAM]: block rows (clamped to [0, N) here)
    nbdata: torch.Tensor,  # u8[N, m, Dt]: node-block neighbour codes
) -> torch.Tensor:
    """f32[Q, BEAM*m] dot scores of bf16(qs[q]) with nbdata[rows[q, b], j]."""
    _check_args(qs, rows, nbdata)
    if nbdata.device.type == "cpu":
        return gather_block_scores_plain(qs, rows, nbdata)
    if nbdata.device.type != "cuda":
        raise ValueError(f"unsupported device {nbdata.device}")
    q, beam = rows.shape
    n, m, dt = nbdata.shape
    if not supports(dt):
        raise ValueError(
            f"the gathermv kernel needs Dt % {DT_MULTIPLE} == 0 and Dt <= {MAX_DT}, got Dt={dt}"
        )
    for t in (qs, rows, nbdata):
        if not t.is_contiguous():
            raise ValueError("the gathermv kernel needs contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("the gathermv kernel needs 16-byte aligned operands")
    out = torch.empty((q, beam * m), dtype=torch.float32, device=nbdata.device)
    if q == 0 or beam == 0 or m == 0:
        return out
    err = LIBRARY.get().msd_gathermv(
        qs.data_ptr(), rows.data_ptr(), nbdata.data_ptr(), out.data_ptr(),
        q, beam, n, m, dt, stream_ptr(nbdata.device),
    )
    check_launch("msd_gathermv", err)
    count_launch(gather_block_scores)
    return out


gather_block_scores.launches = 0
