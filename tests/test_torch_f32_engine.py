"""The f32 scan engine's arithmetic and geometry, on the CPU.

Over an f32 payload the score and tile_max kernels (csrc/score_tile.cuh,
namespace tf) compute q.x as three TF32 tensor-core products of the
operands' hi and lo halves (`distance.split_tf32`: q_hi x_hi + q_hi x_lo +
q_lo x_hi) and are held to `distance.F32_SUM_TOL` (2^-18 of sum |q_i x_i|)
plus 1e-5 of the score around the exact f32 product, their plain version.
The kernels run only on a card (tests/test_torch_kernels.py); here the
split is checked bit for bit against hand-made patterns, the bound
against the split math summed in f64 (inside it with 4x headroom) and
against two controls that must fall outside it (single-pass TF32, and the
two-term split without q_hi x_lo), and the engine's geometry against the
shared memory of a Hopper block.
"""

import numpy as np
import pytest
import torch

from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import distance, tilescan

METRICS = [Metric.L2, Metric.IP, Metric.COSINE]
DEPTHS = [8, 128, 136, 1024]
HEADROOM = 4.0


def _bits(v: torch.Tensor) -> list:
    return [int(b) & 0xFFFFFFFF for b in v.view(torch.int32)]


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor([np.uint32(bits).view(np.int32)], dtype=torch.int32).view(torch.float32)


# (input, hi, lo) as f32 bit patterns, worked out by hand: hi keeps 10
# explicit mantissa bits rounded to nearest with ties away from zero, lo
# is the same rounding of the exact remainder
SPLIT_CASES = {
    "already tf32": (0x3F800000, 0x3F800000, 0x00000000),
    "already tf32, pi-ish": (0x40490000, 0x40490000, 0x00000000),
    "below the tie": (0x3F800FFF, 0x3F800000, 0x3A000000),
    "tie away from zero": (0x3F801000, 0x3F802000, 0xBA000000),
    "above the tie": (0x3F801001, 0x3F802000, 0xBA000000),
    "negative below the tie": (0xBF800FFF, 0xBF800000, 0xBA000000),
    "negative tie away from zero": (0xBF801000, 0xBF802000, 0x3A000000),
    "carry into the exponent": (0x3FFFF000, 0x40000000, 0xBA000000),
    "negative zero": (0x80000000, 0x80000000, 0x00000000),
    "subnormal below half a tf32 step": (0x00000FFF, 0x00000000, 0x00000000),
    "subnormal tie": (0x00003000, 0x00004000, 0x80002000),
    "negative subnormal": (0x80001FFF, 0x80002000, 0x00000000),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_tf32_bit_patterns(case):
    v, hi, lo = SPLIT_CASES[case]
    got_hi, got_lo = distance.split_tf32(_f32(v))
    assert _bits(got_hi) == [hi]
    assert _bits(got_lo) == [lo]


def test_split_tf32_keeps_22_bits_and_zero_low_bits():
    """On random values over many binades: both halves have their 13 low
    bits clear, hi + lo is within 2^-22 of v, and the lo half is at most
    half a TF32 step of hi."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.integers(-8, 8, 100_000))
                         .astype(np.float32))
    hi, lo = distance.split_tf32(v)
    for h in (hi, lo):
        assert not bool((h.view(torch.int32) & 0x1FFF).any())
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0**-22 * v.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0**-11 * hi.double().abs()).all())


def _operands(metric, d, data, q=64, n=2000, seed=0):
    g = torch.Generator().manual_seed(seed + d)
    x = torch.randn((n, d), generator=g)
    qs = torch.randn((q, d), generator=g)
    if data == "nonneg":  # sums that only grow, as SIFT's
        x, qs = x.abs(), qs.abs()
    qs = distance.normalize_queries(qs, metric)
    return qs, x, distance.base_aux(x, metric)


def _worst_ratio(got, want, bound):
    return float(((got - want).abs() / (bound + distance.KERNEL_RTOL * want.abs())).max())


@pytest.mark.parametrize("data", ["normal", "nonneg"])
@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("metric", METRICS)
def test_tf32x3_math_inside_f32_bound(metric, d, data):
    """The engine's three products, summed in f64, lie within a quarter of
    the bound of the plain version (the exact f32 product)."""
    qs, x, aux = _operands(metric, d, data)
    want = distance.scores_plain(qs, x, aux, metric)
    bound = distance.kernel_error_bound(qs, x, aux, metric)
    got = distance.tf32_products(qs, x, aux, metric, distance.TF32X3)
    assert _worst_ratio(got, want, bound) <= 1.0 / HEADROOM


@pytest.mark.parametrize("control", ["single", "two_term"])
@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("metric", METRICS)
def test_tf32_controls_outside_f32_bound(metric, d, control):
    """Single-pass TF32 and the split without q_hi x_lo fall outside the
    bound, on normal and on non-negative data."""
    terms = distance.TF32_SINGLE if control == "single" else distance.TF32_TWO_TERM
    for data in ("normal", "nonneg"):
        qs, x, aux = _operands(metric, d, data)
        want = distance.scores_plain(qs, x, aux, metric)
        bound = distance.kernel_error_bound(qs, x, aux, metric)
        got = distance.tf32_products(qs, x, aux, metric, terms)
        assert distance.outside_kernel_bound(got, want, bound).any()


@pytest.mark.parametrize("metric", METRICS)
def test_tile_bound_admits_tf32x3_and_rejects_single_pass(metric):
    """The same for sub-tile maxima (`tilescan.tile_error_bound`)."""
    qs, x, aux = _operands(metric, 1024, "normal", q=13, n=4 * tilescan.SUB)
    aux = aux if aux is not None else torch.zeros(x.shape[0])  # tile_max's aux is never None
    m8 = (torch.arange(x.shape[0]) % 3 != 0).to(torch.uint8)
    want = tilescan.tile_maxes_plain(qs, x, aux, m8, metric)
    bound = tilescan.tile_error_bound(qs, x, aux, metric)

    def maxes(terms):
        s = distance.tf32_products(qs, x, aux, metric, terms)
        s = torch.where(m8[None, :] != 0, s, torch.full_like(s, tilescan.NEG))
        return torch.amax(s.reshape(s.shape[0], -1, tilescan.SUB), dim=2)

    assert _worst_ratio(maxes(distance.TF32X3), want, bound) <= 1.0 / HEADROOM
    assert distance.outside_kernel_bound(maxes(distance.TF32_SINGLE), want, bound).any()


def test_f32_bound_is_tighter_than_the_bf16_bound():
    qs, x, aux = _operands(Metric.L2, 128, "normal")
    b32 = distance.kernel_error_bound(qs, x, aux, Metric.L2)
    b16 = distance.kernel_error_bound(qs, x.to(torch.bfloat16), aux, Metric.L2)
    ratio = float((b32 / b16).median())
    assert abs(ratio - distance.F32_SUM_TOL / distance.KERNEL_SUM_TOL) < 0.01


# (Q, N, D): NT, stages, resident at the shapes the f32 engine runs
GEOMETRY_CASES = {
    "stream chunk": ((104, 131_072, 1024), 104, 4, False),
    "spilled 128-d chunk": ((104, 131_072, 128), 104, 4, True),
    "SIFT f32 table": ((104, 1_048_576, 128), 104, 4, True),
    "128 queries": ((128, 131_072, 1024), 128, 4, False),
    "GIST f32 table": ((256, 114_688, 1024), 128, 4, False),
    "ragged Q = 300": ((300, 4_099, 136), 128, 4, False),
    "one query": ((1, 1, 8), 64, 4, True),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_f32_scan_geometry_at_main_shapes(case):
    (q, n, d), nt, stages, resident = GEOMETRY_CASES[case]
    g = distance.f32_scan_geometry(q, n, d)
    assert (g.nt, g.stages, g.resident) == (nt, stages, resident)
    assert g.smem_bytes <= 232_448
    assert g.qp == -(-q // nt) * nt and g.dp == -(-d // 32) * 32


def test_f32_scan_geometry_fits_every_shape():
    """Any Q, any D % 8 == 0 up to 2,048: at least two stages, shared
    memory that fits a Hopper block and equals `Layout` in score_tile.cuh,
    one more stage would not fit (unless the ring is at its most), and the
    query resident exactly when it is one tile of <= 128 KiB hi+lo."""
    for d in range(8, 2049, 8):
        for q in (1, 63, 64, 65, 104, 105, 128, 129, 256, 257, 300, 1024):
            for n in (1, 4_099, 131_072):
                g = distance.f32_scan_geometry(q, n, d)
                assert g.nt == min(w for w in distance.F32_WIDTHS if w >= min(q, 128))
                assert 2 <= g.stages <= distance.SCAN_MAX_STAGES
                assert g.smem_bytes <= distance.SMEM_LIMIT
                q_bytes = g.nt * distance.F32_BK * 4
                assert g.resident == (g.qp == g.nt and 2 * g.dp * g.nt * 4 <= 131_072)
                stage = distance.F32_STAGE_X + distance.F32_STAGE_EPI + 16
                stage += 0 if g.resident else 2 * q_bytes
                res = 2 * (g.dp // distance.F32_BK) * q_bytes if g.resident else 0
                assert g.smem_bytes == g.stages * stage + res + distance.F32_SCRATCH + 8 + 1024
                assert (g.stages == distance.SCAN_MAX_STAGES
                        or g.smem_bytes + stage > distance.SMEM_LIMIT)
                assert g.tiles == (g.qp // g.nt) * -(-n // distance.F32_BN)
                assert 1 <= g.grid == min(distance.H100_SMS, g.tiles)
