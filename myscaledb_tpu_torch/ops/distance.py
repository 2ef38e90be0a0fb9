"""Score matrices: the hand-written CUDA score kernel + its plain version.

Counterpart of myscaledb_tpu/ops/distance.py. Max-is-better scores
(`myscaledb_tpu_torch.metrics`):

    IP:     s = q·x
    L2:     s = 2 q·x - |x|^2        (-|q-x|^2 up to the per-query constant
                                      |q|^2, which cancels in top-k; the
                                      constant is reapplied when reporting)
    Cosine: s = (q/|q|)·x * 1/|x|    (queries pre-normalized by the caller)

`scores` replaces the TPU kernel `_score_kernel` with csrc/score.cu (see
the note there for what bounds it on the H100). A CUDA tensor goes to the
kernel; a CPU tensor goes to `scores_plain`, the same math in torch ops.
There is no fallback from one to the other. `scan_geometry` sizes the
bf16 engine and `f32_scan_geometry` the f32 (3xTF32) engine that score.cu
and tile_max.cu share (csrc/score_tile.cuh).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from ..metrics import Metric
from ._cuda import LIBRARY, METRIC_CODES, cdiv, check_launch, count_launch, round_up, stream_ptr

# The kernels take the depth axis in 16-byte pieces (8 bf16 or 4 f32
# values, the bf16 engine's tensor-map row strides and its resident query
# loader's 8 values), each wholly inside or outside D.
D_MULTIPLE = 8

# How far a scan kernel may lie from its plain version.
# * bf16 payload: both compute the same f32 math (the same hi/lo query
#   split) and differ only in the order of their sums, whose error is a few
#   f32 ulps of sum_i |q_i x_i|: at most ~1e-6 of it on an H100 at the main
#   path's shapes. The bound is 2^-16 of that sum plus 1e-5 of the score. A
#   kernel that drops the query's lo half errs by up to 2^-9 of the same
#   sum (typically ~2^-9/sqrt(D)), far outside the bound at every shape.
# * f32 payload: the plain version is the exact f32 product; the kernel
#   computes it as three TF32 products (`split_tf32`: q_hi x_hi + q_hi x_lo
#   + q_lo x_hi), each within ~3 * 2^-22 of |q_i x_i|, plus the same
#   reordered f32 sums. The bound is F32_SUM_TOL = 2^-18 of the sum plus
#   1e-5 of the score: single-pass TF32 (errors ~2^-11 of each product) and
#   the two-term split without q_hi x_lo (~2^-12) fall outside it.
KERNEL_RTOL = 1e-5
KERNEL_SUM_TOL = 2.0**-16
F32_SUM_TOL = 2.0**-18
# the products of the f32 engine, (query half, payload half), and the two
# controls that its bound must reject
TF32X3 = (("hi", "hi"), ("hi", "lo"), ("lo", "hi"))
TF32_SINGLE = (("hi", "hi"),)
TF32_TWO_TERM = (("hi", "hi"), ("lo", "hi"))

# The bf16 scan engine's tiles (csrc/score_tile.cuh, namespace wg): BM
# queries x BN payload rows per output tile, BK depth per ring stage.
SCAN_BM, SCAN_BN, SCAN_BK = 128, 256, 64
SCAN_STAGE_X = SCAN_BN * SCAN_BK * 2  # bf16 payload chunk
SCAN_STAGE_Q = SCAN_BM * SCAN_BK * 4  # f32 query chunk, streamed mode only
SCAN_STAGE_EPI = 2048  # the tile's aux (f32) and mask (u8) for the epilogue
SCAN_STAGING = 2 * 64 * 40 * 4  # score epilogue staging, both warpgroups
SCAN_RESIDENT_MAX_DK = 128  # the resident hi+lo query: 2 x 128 x Dk x 2 B <= 64 KiB
SCAN_MAX_STAGES = 4
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper
H100_SMS = 132


@dataclass(frozen=True)
class ScanGeometry:
    """How the bf16 engine runs one call: `stages` ring stages, the query
    `resident` in shared memory for the block's life or streamed through
    the ring beside the payload, `smem_bytes` of dynamic shared memory and
    `grid` persistent blocks over `tiles` output tiles."""

    stages: int
    resident: bool
    smem_bytes: int
    grid: int
    tiles: int


@functools.lru_cache(maxsize=1024)
def scan_geometry(q: int, n: int, d: int, sms: int = H100_SMS) -> ScanGeometry:
    """The bf16 engine's geometry for Q = q, N = n, D = d on a card with
    `sms` SMs. The query is resident when it is one tile (q <= 128) and its
    hi+lo halves take at most 64 KiB (d <= 128, the SIFT shapes); the ring
    then holds only payload chunks (32 KiB each, 4 stages). Otherwise the
    f32 query chunk rides each stage beside the payload chunk (64 KiB a
    stage, 3 stages). Each stage also has 2 KiB for a tile's aux and mask.
    The byte count matches `Layout` in score_tile.cuh (1,024 bytes of slack
    align the base for the 128B swizzle, 16 bytes of mbarriers a stage);
    the kernel checks it."""
    dk = round_up(max(d, 1), SCAN_BK)
    tiles = cdiv(q, SCAN_BM) * cdiv(n, SCAN_BN)
    resident = q <= SCAN_BM and dk <= SCAN_RESIDENT_MAX_DK
    stage = SCAN_STAGE_X + (0 if resident else SCAN_STAGE_Q) + SCAN_STAGE_EPI + 16
    fixed = 1024 + SCAN_STAGING + (2 * SCAN_BM * dk * 2 if resident else 0)
    stages = min(SCAN_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    return ScanGeometry(stages, resident, fixed + stages * stage, max(1, min(sms, tiles)), tiles)


# The f32 engine's tiles (csrc/score_tile.cuh, namespace tf): F32_BN
# payload rows x NT queries (one of F32_WIDTHS, the wgmmas' n; 104 is a
# batch of 100 padded to 8; above 128 queries, several q-tiles of 128) per
# output tile, F32_BK depth per ring stage.
F32_BN, F32_BK = 128, 32
F32_WIDTHS = (64, 104, 128)
F32_STAGE_X = F32_BN * F32_BK * 4  # f32 payload chunk
F32_STAGE_EPI = 1024  # the tile's aux (f32) and mask (u8)
F32_SCRATCH = 2 * 32 * 68 * 4  # score staging, or the tile_max fold
F32_RESIDENT_MAX = 131_072  # the resident hi+lo query: 2 x NT x Dp x 4 B


@dataclass(frozen=True)
class F32Geometry:
    """How the f32 engine runs one call: NT = `nt` queries a tile,
    `stages` ring stages, the query `resident` in shared memory or its
    hi/lo chunks riding the ring, `smem_bytes` of dynamic shared memory,
    `grid` persistent blocks over `tiles` output tiles; the split query
    takes [2 * qp, dp] b32 (`qp` queries padded to NT, `dp` depth padded
    to F32_BK)."""

    nt: int
    stages: int
    resident: bool
    smem_bytes: int
    grid: int
    tiles: int
    qp: int
    dp: int


@functools.lru_cache(maxsize=1024)
def f32_scan_geometry(q: int, n: int, d: int, sms: int = H100_SMS) -> F32Geometry:
    """The f32 engine's geometry for Q = q, N = n, D = d on a card with
    `sms` SMs. NT is the narrowest of F32_WIDTHS that holds q (128 above,
    in several q-tiles). The query is resident when it is one tile and its
    hi+lo halves take at most 128 KiB (Q <= 128 and D <= 128, the SIFT
    shapes); the ring then holds only payload chunks (16 KiB). Otherwise
    each stage carries the payload chunk and the query's hi and lo chunks
    (2 x NT x 128 B). Each stage also has 1 KiB for a tile's aux and mask.
    The byte count matches `Layout` in score_tile.cuh (1,024 bytes of slack
    for the 128B swizzle's alignment, 16 bytes of mbarriers a stage and 8
    for the resident query's); the kernel checks it."""
    nt = next((w for w in F32_WIDTHS if q <= w), F32_WIDTHS[-1])
    dp = round_up(max(d, 1), F32_BK)
    q_tiles = cdiv(q, nt)
    resident = q_tiles == 1 and 2 * nt * dp * 4 <= F32_RESIDENT_MAX
    stage = F32_STAGE_X + (0 if resident else 2 * nt * F32_BK * 4) + F32_STAGE_EPI + 16
    fixed = 1024 + F32_SCRATCH + 8 + (2 * nt * dp * 4 if resident else 0)
    stages = min(SCAN_MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    tiles = q_tiles * cdiv(n, F32_BN)
    return F32Geometry(nt, stages, resident, fixed + stages * stage, max(1, min(sms, tiles)),
                       tiles, q_tiles * nt, dp)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_scan(entry: str, queries, base, aux, mask, out, metric) -> None:
    """Launch a scan kernel's C entry point (`msd_scores` without `mask`,
    `msd_tile_max` with it; `_f32` for an f32 payload, with scratch for
    the query's TF32 halves) with the geometry of `scan_geometry` or
    `f32_scan_geometry`."""
    q, (n, d) = queries.shape[0], base.shape
    sms = sm_count(base.device)
    tail = (
        aux.data_ptr() if aux is not None else None,
        *([mask.data_ptr()] if mask is not None else []),
        out.data_ptr(),
        q, n, d,
        METRIC_CODES[metric.value],
    )
    lib = LIBRARY.get()
    if base.dtype == torch.float32:
        g = f32_scan_geometry(q, n, d, sms)
        # freed when this returns, before the kernel has run: safe, because
        # the caching allocator hands the block out again only to later
        # work on this (the launch) stream
        split = torch.empty((2 * g.qp, g.dp), dtype=torch.float32, device=base.device)
        err = getattr(lib, entry + "_f32")(
            queries.data_ptr(), split.data_ptr(), base.data_ptr(), *tail,
            g.nt, g.stages, int(g.resident), g.smem_bytes, g.grid, stream_ptr(base.device),
        )
    else:
        g = scan_geometry(q, n, d, sms)
        err = getattr(lib, entry)(
            queries.data_ptr(), base.data_ptr(), *tail,
            g.stages, int(g.resident), g.smem_bytes, g.grid, stream_ptr(base.device),
        )
    check_launch(entry, err)


def kernel_error_bound(
    queries: torch.Tensor,
    base: torch.Tensor,
    aux: Optional[torch.Tensor],
    metric: Metric,
) -> torch.Tensor:
    """f32[Q, N]: the |kernel - plain| each score may show, without its
    KERNEL_RTOL part: KERNEL_SUM_TOL (bf16 payload) or F32_SUM_TOL (f32
    payload) times sum_i |q_i x_i|, carried through the metric's scaling
    (x2 for L2, x 1/|x| for Cosine)."""
    t = queries.to(torch.float32).abs() @ base.to(torch.float32).abs().T
    if metric == Metric.L2:
        t = 2.0 * t
    elif metric == Metric.COSINE:
        t = t * aux[None, :]
    return (KERNEL_SUM_TOL if base.dtype == torch.bfloat16 else F32_SUM_TOL) * t


def outside_kernel_bound(
    got: torch.Tensor, want: torch.Tensor, bound: torch.Tensor
) -> torch.Tensor:
    """bool mask of the entries of a kernel's output `got` that lie
    outside `bound` + KERNEL_RTOL * |want| of its plain version's `want`."""
    return (got - want).abs() > bound + KERNEL_RTOL * want.abs()


def split_query_bf16(q: torch.Tensor) -> torch.Tensor:
    """Split f32 queries into bf16 (hi, lo) halves stacked on axis 0.

    q ≈ hi + lo with both bf16 gives ~16 mantissa bits for the query side
    of a bf16 x bf16 product: two tensor-core passes, f32 accumulation, no
    extra payload traffic, and none of the single-pass query quantization
    noise that would reorder near-tied neighbours. The CUDA kernels split
    the query themselves, bit for bit the same; the plain versions split
    with this function."""
    q = q.to(torch.float32)
    hi = q.to(torch.bfloat16)
    lo = (q - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, lo])


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` in torch ops: keep 10 explicit mantissa bits,
    rounding to nearest with ties away from zero, on the int32 view (the
    low 13 bits become 0; a carry moves into the exponent)."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = ((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)


def split_tf32(v: torch.Tensor):
    """Split f32 values into TF32 (hi, lo): hi = rna(v), lo = rna(v - hi),
    bit for bit as the f32 engine splits both operands in the kernel
    (v - hi is exact in f32; hi + lo keeps ~22 significant bits)."""
    v = v.to(torch.float32)
    hi = _tf32_round(v)
    return hi, _tf32_round(v - hi)


def tf32_products(
    queries: torch.Tensor,
    base: torch.Tensor,
    aux: Optional[torch.Tensor],
    metric: Metric,
    terms=TF32X3,
) -> torch.Tensor:
    """f32[Q, N]: the scores from the sum of the given TF32 products
    (query half, payload half) of `split_tf32`, summed in f64 and rounded
    once: TF32X3 is the f32 engine's math without its f32 sums' error;
    TF32_SINGLE and TF32_TWO_TERM are the controls its bound rejects."""
    qs = dict(zip(("hi", "lo"), (h.to(torch.float64) for h in split_tf32(queries))))
    xs = dict(zip(("hi", "lo"), (h.to(torch.float64) for h in split_tf32(base))))
    s = sum(qs[a] @ xs[b].T for a, b in terms)
    a = None if aux is None else aux.to(torch.float64)[None, :]
    return _apply_metric(s, a, metric).to(torch.float32)


def _apply_metric(s: torch.Tensor, aux: Optional[torch.Tensor], metric: Metric):
    if metric == Metric.L2:
        return 2.0 * s - aux
    if metric == Metric.COSINE:
        return s * aux
    return s


def dot_plain(queries: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """q·xᵀ in f32 as the kernels compute it: for a bf16 payload, the sum
    of the products of the query's bf16 hi and lo halves with the payload;
    for an f32 payload, the f32 product (which the f32 engine approximates
    within F32_SUM_TOL by three TF32 products)."""
    xf = base.to(torch.float32).T
    if base.dtype == torch.bfloat16:
        hi, lo = split_query_bf16(queries).to(torch.float32)
        return hi @ xf + lo @ xf
    return queries.to(torch.float32) @ xf


def scores_plain(
    queries: torch.Tensor,
    base: torch.Tensor,
    aux: Optional[torch.Tensor],
    metric: Metric,
) -> torch.Tensor:
    """The score kernel's math in torch ops: `dot_plain`, then the metric."""
    s = dot_plain(queries, base)
    return _apply_metric(s, None if aux is None else aux[None, :], metric)


def _check_scan_args(queries, base, aux, metric, *, need_aux: bool):
    if queries.dim() != 2 or base.dim() != 2:
        raise ValueError(f"queries and base must be 2-D, got {queries.shape}, {base.shape}")
    if queries.shape[1] != base.shape[1]:
        raise ValueError(
            f"dim mismatch: queries D={queries.shape[1]} base D={base.shape[1]}"
        )
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    if base.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"base must be float32 or bfloat16, got {base.dtype}")
    if need_aux:
        if aux is None:
            raise ValueError(f"aux vector required for metric {metric}")
        if aux.dtype != torch.float32 or aux.shape != (base.shape[0],):
            raise ValueError(
                f"aux must be float32[{base.shape[0]}], got {aux.dtype}{list(aux.shape)}"
            )
    tensors = [queries, base] + ([aux] if aux is not None else [])
    if any(t.device != base.device for t in tensors):
        raise ValueError("queries, base and aux must be on one device")


def _check_kernel_operands(*tensors: torch.Tensor, d: int) -> None:
    if d % D_MULTIPLE:
        raise ValueError(f"the CUDA scan kernels need D % {D_MULTIPLE} == 0, got D={d}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA scan kernels need contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA scan kernels need 16-byte aligned operands")


def scores(
    queries: torch.Tensor,
    base: torch.Tensor,
    aux: Optional[torch.Tensor] = None,
    *,
    metric: Metric = Metric.L2,
) -> torch.Tensor:
    """Score matrix f32[Q, N], larger = better.

    queries: f32[Q, D] (pre-normalized for Cosine)
    base:    f32|bf16[N, D]
    aux:     f32[N] metric auxiliary (|x|^2 for L2, 1/|x| for Cosine)
    """
    _check_scan_args(queries, base, aux, metric, need_aux=metric != Metric.IP)
    if base.device.type == "cpu":
        return scores_plain(queries, base, aux, metric)
    if base.device.type != "cuda":
        raise ValueError(f"unsupported device {base.device}")
    q, n, d = queries.shape[0], base.shape[0], base.shape[1]
    _check_kernel_operands(queries, base, *([aux] if aux is not None else []), d=d)
    out = torch.empty((q, n), dtype=torch.float32, device=base.device)
    if q == 0 or n == 0:
        return out
    launch_scan("msd_scores", queries, base, aux, None, out, metric)
    count_launch(scores, f32=base.dtype == torch.float32)
    return out


scores.launches = 0
scores.launches_f32 = 0  # of them, over an f32 payload (the f32 engine)


def scores_ref(
    queries: torch.Tensor,
    base: torch.Tensor,
    aux: Optional[torch.Tensor] = None,
    *,
    metric: Metric = Metric.L2,
) -> torch.Tensor:
    """Torch-ops reference (correctness oracle): the exact f32 product of
    the f32 queries and the widened stored payload, on every device,
    computing the auxiliary vector when none is given."""
    if aux is None:
        aux = base_aux(base, metric)
    s = queries.to(torch.float32) @ base.to(torch.float32).T
    return _apply_metric(s, None if aux is None else aux[None, :], metric)


def base_aux(base: torch.Tensor, metric: Metric) -> Optional[torch.Tensor]:
    """Precompute the per-row auxiliary vector for a base matrix."""
    if metric == Metric.L2:
        return torch.sum(base.to(torch.float32) ** 2, dim=1)
    if metric == Metric.COSINE:
        nrm = torch.linalg.vector_norm(base.to(torch.float32), dim=1)
        return torch.where(nrm > 0.0, 1.0 / nrm, torch.zeros_like(nrm))
    return None


def normalize_queries(queries: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Pre-normalize queries for Cosine (normalize-then-IP)."""
    if metric != Metric.COSINE:
        return queries
    nrm = torch.linalg.vector_norm(queries.to(torch.float32), dim=-1, keepdim=True)
    return queries / torch.where(nrm > 0.0, nrm, torch.ones_like(nrm))
