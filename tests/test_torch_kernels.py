"""The port's CUDA kernels against their plain PyTorch versions.

The tests marked `cuda` need a CUDA GPU and skip without one: a CUDA
kernel has no CPU or interpret mode. The rest check, on any device, that
the bound the kernels are held to is tight enough to matter. The file
imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Bound: a kernel and its plain version compute the same f32 math (for a
bf16 payload, the same hi/lo split of the query) and differ only in the
order of their sums, so a kernel's score may lie at most 2^-16 of
sum_i |q_i x_i| plus 1e-5 of the score from the plain version's
(`distance.kernel_error_bound`). That is far tighter than the JAX
package's cross-package tolerances, and tight enough to catch a kernel
that drops the query's lo half (the control tests below). Over an f32
payload the kernels compute the exact f32 product as three TF32 products
and are held to 2^-18 of the same sum (`distance.F32_SUM_TOL`; its CPU
tests are in tests/test_torch_f32_engine.py); the card tests below add a
bit-level probe (operands whose three products are exact) and a one-hot
probe of the register-fragment layout. The gathermv kernel is held to the
same kind of bound around sum_d |bf16(q_d) c_d|
(`gathermv.kernel_error_bound`), which a kernel that skips the query's
bf16 cast falls outside. The approximate top-k's partial reduce
(`topk.approx_bin_max`) compares and selects only, so it equals its plain
version bit for bit, values and indices, ties included.
"""

import numpy as np
import pytest
import torch

from myscaledb_tpu_torch.index import hnsw
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import binary, distance, gathermv, tilescan, topk
from myscaledb_tpu_torch.storage.schema import FloatVector, Schema, UInt64
from myscaledb_tpu_torch.storage.segment import Segment

METRICS = [Metric.L2, Metric.IP, Metric.COSINE]
SCORE_SHAPES = [(13, 1000, 128), (130, 4099, 24), (8, 50_176, 128)]
# shapes that cross the bf16 engine's tiles (128 queries x 256 rows x 64
# deep) and its resident / streamed query: Q around one and two
# warpgroups and one and two tiles, N from one row to many tiles, D
# under, across and over one depth chunk
RAGGED_Q, RAGGED_N, RAGGED_D = [1, 63, 65, 129, 300], [1, 4099, 50_176], [8, 24, 136, 1024]
# the CPU bound tests take a few of them (the f64 reference is slow)
BOUND_SHAPES = SCORE_SHAPES + [(1, 1, 8), (63, 4099, 24), (65, 4099, 136), (129, 1000, 1024),
                               (300, 4099, 8)]
TILE_Q, TILE_D, TILE_KEEP = [1, 65, 129, 300], [128, 256, 1024], [0.01, 1.0, 0.0]
TILE_N = 16_512  # 129 sub-tiles: the last 256-row tile is half past N
RESCORE_Q, RESCORE_D, RESCORE_S = [1, 65, 300], [128, 256, 1024], [1, 12, 130]
RESCORE_N = 131 * tilescan.SUB  # more sub-tiles than the most a query chooses (k 128 + 2)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _operands(device, dtype, metric, q, n, d, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device).to(dtype)
    qs = distance.normalize_queries(torch.randn((q, d), generator=g, device=device), metric)
    aux = distance.base_aux(x, metric)
    return g, qs, x, aux


def _tile_operands(device, dtype, metric, q, keep, n=16384, d=128):
    g, qs, x, aux = _operands(device, dtype, metric, q, n, d, q)
    aux = aux if aux is not None else torch.zeros(n, device=device)
    m8 = (torch.rand(n, generator=g, device=device) < keep).to(torch.uint8)
    return qs, x, aux, m8


def _exact_split_scores(qs, x, aux, metric):
    """The plain versions' split math with its sums in f64, rounded to f32."""
    hi, lo = distance.split_query_bf16(qs).to(torch.float64)
    xd = x.to(torch.float64).T
    a = None if aux is None else aux.to(torch.float64)[None, :]
    return distance._apply_metric(hi @ xd + lo @ xd, a, metric).to(torch.float32)


def _hi_only(qs):
    """The queries rounded to bf16: split, they have no lo half, so the
    plain version on them computes what a kernel without the lo pass would."""
    return qs.to(torch.bfloat16).to(torch.float32)


def _rescore_operands(device, dtype, metric, q, d, s, n=RESCORE_N, seed=0):
    """Queries, payload, aux (zeros for IP) and s distinct sub-tiles a
    query, in no order, as `torch.topk` over the tile maxes hands them."""
    g, qs, x, aux = _operands(device, dtype, metric, q, n, d, seed)
    aux = aux if aux is not None else torch.zeros(n, device=device)
    sub = torch.rand((q, n // tilescan.SUB), generator=g, device=device).argsort(dim=1)[:, :s]
    return g, qs, x, aux, sub.contiguous()


def _rescore_plain_and_bound(qs, x, aux, m8, sub, metric, rows=16):
    """`tile_rescore_plain` and `rescore_error_bound`, a few queries at a
    time: at Q 300, S 130, D 1,024 the gathered sub-tiles alone are 10 GB."""
    parts = [(tilescan.tile_rescore_plain(qs[i:i + rows], x, aux, m8, sub[i:i + rows], metric),
              tilescan.rescore_error_bound(qs[i:i + rows], x, aux, sub[i:i + rows], metric))
             for i in range(0, qs.shape[0], rows)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _kept_rows(m8, sub):
    """bool[Q, S*SUB]: the chosen rows whose mask byte is not 0."""
    return m8.reshape(-1, tilescan.SUB)[sub].reshape(sub.shape[0], -1) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,n,d", SCORE_SHAPES)
def test_score_kernel_vs_plain(cuda_device, dtype, metric, q, n, d):
    """Ragged Q and N edges are masked by the kernel itself."""
    _, qs, x, aux = _operands(cuda_device, dtype, metric, q, n, d, q * n)
    before = distance.scores.launches
    got = distance.scores(qs, x, aux, metric=metric)
    assert distance.scores.launches == before + 1
    want = distance.scores_plain(qs, x, aux, metric)
    bound = distance.kernel_error_bound(qs, x, aux, metric)
    assert not distance.outside_kernel_bound(got, want, bound).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,keep", [(13, 0.01), (104, 1.0), (104, 0.0)])
def test_tile_max_kernel_vs_plain(cuda_device, dtype, metric, q, keep):
    qs, x, aux, m8 = _tile_operands(cuda_device, dtype, metric, q, keep)
    before = tilescan.tile_maxes.launches
    got = tilescan.tile_maxes(qs, x, aux, m8, metric=metric)
    assert tilescan.tile_maxes.launches == before + 1
    want = tilescan.tile_maxes_plain(qs, x, aux, m8, metric)
    bound = tilescan.tile_error_bound(qs, x, aux, metric)
    assert not distance.outside_kernel_bound(got, want, bound).any()
    # masked sub-tiles are -3.4e38 exactly, in both
    assert torch.equal(got == tilescan.NEG, want == tilescan.NEG)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("q", RAGGED_Q)
def test_score_kernel_ragged_shapes(cuda_device, metric, q, n, d):
    """The bf16 engine at shapes that cross its tiles, its depth chunks and
    its resident / streamed query choice."""
    _, qs, x, aux = _operands(cuda_device, torch.bfloat16, metric, q, n, d, q + n + d)
    got = distance.scores(qs, x, aux, metric=metric)
    want = distance.scores_plain(qs, x, aux, metric)
    bound = distance.kernel_error_bound(qs, x, aux, metric)
    assert got.shape == (q, n)
    assert not distance.outside_kernel_bound(got, want, bound).any()


@pytest.mark.cuda
@pytest.mark.parametrize("keep", TILE_KEEP)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", TILE_D)
@pytest.mark.parametrize("q", TILE_Q)
def test_tile_max_kernel_ragged_shapes(cuda_device, q, d, metric, keep):
    qs, x, aux, m8 = _tile_operands(cuda_device, torch.bfloat16, metric, q, keep, TILE_N, d)
    got = tilescan.tile_maxes(qs, x, aux, m8, metric=metric)
    want = tilescan.tile_maxes_plain(qs, x, aux, m8, metric)
    bound = tilescan.tile_error_bound(qs, x, aux, metric)
    assert got.shape == (q, TILE_N // tilescan.SUB)
    assert not distance.outside_kernel_bound(got, want, bound).any()
    assert torch.equal(got == tilescan.NEG, want == tilescan.NEG)


@pytest.mark.cuda
@pytest.mark.parametrize("s", RESCORE_S)
@pytest.mark.parametrize("d", RESCORE_D)
@pytest.mark.parametrize("q", RESCORE_Q)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tile_rescore_kernel_vs_plain(cuda_device, dtype, metric, q, d, s):
    """The rescore kernel against its plain version under masks that keep
    1%, all and none of the rows. Both sum the same exact f32 products of
    the widened row and the f32 query, in other orders, so the kernel lies
    inside `rescore_error_bound` (2^-18 of sum_i |q_i x_i| through the
    metric, plus 1e-5 of the score); a masked row is -inf exactly, and no
    other row is."""
    g, qs, x, aux, sub = _rescore_operands(cuda_device, dtype, metric, q, d, s, seed=q * d + s)
    for keep in TILE_KEEP:
        m8 = (torch.rand(x.shape[0], generator=g, device=cuda_device) < keep).to(torch.uint8)
        before = tilescan.tile_rescore.launches
        got = tilescan.tile_rescore(qs, x, aux, m8, sub, metric=metric)
        assert tilescan.tile_rescore.launches == before + 1
        want, bound = _rescore_plain_and_bound(qs, x, aux, m8, sub, metric)
        kept = _kept_rows(m8, sub)
        assert got.shape == (q, s * tilescan.SUB)
        assert torch.equal(torch.isneginf(got), ~kept)
        assert not distance.outside_kernel_bound(got[kept], want[kept], bound[kept]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,d", [(104, 1024), (300, 128)])
def test_tile_rescore_on_clustered_data(cuda_device, dtype, metric, q, d):
    """On clustered rows, where the sums grow with the depth, over the
    sub-tiles the tile prune chooses (the top 12 by the plain tile maxes)."""
    qs, x, aux = _clustered_operands(cuda_device, metric, q, RESCORE_N, d, q + d, dtype)
    aux = aux if aux is not None else torch.zeros(RESCORE_N, device=cuda_device)
    m8 = (torch.arange(RESCORE_N, device=cuda_device) % 7 != 3).to(torch.uint8)
    sub = torch.topk(tilescan.tile_maxes_plain(qs, x, aux, m8, metric), 12, dim=1).indices
    got = tilescan.tile_rescore(qs, x, aux, m8, sub, metric=metric)
    want, bound = _rescore_plain_and_bound(qs, x, aux, m8, sub, metric)
    kept = _kept_rows(m8, sub)
    assert torch.equal(torch.isneginf(got), ~kept)
    assert not distance.outside_kernel_bound(got[kept], want[kept], bound[kept]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("q,d", [(1, 8), (100, 128), (300, 136), (65, 1024)])
def test_kernel_split_is_bit_exact(cuda_device, q, d):
    """The kernel splits the f32 query into bf16 hi and lo halves itself.
    Against one-hot payload rows (the identity) under IP each score is
    hi + lo of one query entry, exact in f32, so the kernel must equal the
    plain version (split by `split_query_bf16`) bit for bit. Resident
    (d <= 128, q <= 128) and streamed queries both."""
    g = torch.Generator(device=cuda_device).manual_seed(q + d)
    qs = 3.0 * torch.randn((q, d), generator=g, device=cuda_device)
    qs[0, : min(d, 4)] = torch.tensor([1.0 + 2.0**-9, -3.0e-3, 7.0e4, 1.0e-30][: min(d, 4)])
    x = torch.eye(d, device=cuda_device).to(torch.bfloat16)
    got = distance.scores(qs, x, None, metric=Metric.IP)
    assert torch.equal(got, distance.scores_plain(qs, x, None, Metric.IP))
    # and the lo half matters: the hi half alone differs
    assert not torch.equal(got, qs.to(torch.bfloat16).to(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("q", RAGGED_Q)
def test_f32_score_kernel_ragged_shapes(cuda_device, metric, q, n, d):
    """The f32 (3xTF32) engine at shapes that cross its tiles (64 / 104 /
    128 queries x 128 rows x 32 deep) and its resident / ringed query;
    single-pass TF32 falls outside the bound at the same shapes."""
    _, qs, x, aux = _operands(cuda_device, torch.float32, metric, q, n, d, q + n + d)
    got = distance.scores(qs, x, aux, metric=metric)
    want = distance.scores_plain(qs, x, aux, metric)
    bound = distance.kernel_error_bound(qs, x, aux, metric)
    assert got.shape == (q, n)
    assert not distance.outside_kernel_bound(got, want, bound).any()
    if q * n > 1000:  # enough scores that one lies outside
        single = distance.tf32_products(qs, x, aux, metric, distance.TF32_SINGLE)
        assert distance.outside_kernel_bound(single, want, bound).any()


@pytest.mark.cuda
@pytest.mark.parametrize("keep", TILE_KEEP)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", TILE_D)
@pytest.mark.parametrize("q", TILE_Q)
def test_f32_tile_max_kernel_ragged_shapes(cuda_device, q, d, metric, keep):
    qs, x, aux, m8 = _tile_operands(cuda_device, torch.float32, metric, q, keep, TILE_N, d)
    got = tilescan.tile_maxes(qs, x, aux, m8, metric=metric)
    want = tilescan.tile_maxes_plain(qs, x, aux, m8, metric)
    bound = tilescan.tile_error_bound(qs, x, aux, metric)
    assert got.shape == (q, TILE_N // tilescan.SUB)
    assert not distance.outside_kernel_bound(got, want, bound).any()
    assert torch.equal(got == tilescan.NEG, want == tilescan.NEG)


def _clustered_operands(device, metric, q, n, d, seed, dtype=torch.float32):
    """bench.py's corpus shape: rows around 64 centres of 6 x N(0, 1),
    queries near rows, the payload stored as `dtype` (its norms from the
    stored values). Same-cluster sums grow with the depth, the regime
    where one accumulator for a tile's whole depth drifted outside the
    f32 bound on the card; zero-mean data does not show it."""
    g = torch.Generator(device=device).manual_seed(seed)
    centres = 6.0 * torch.randn((64, d), generator=g, device=device)
    pick = torch.randint(0, 64, (n,), generator=g, device=device)
    x = centres[pick] + torch.randn((n, d), generator=g, device=device)
    rows = torch.randint(0, n, (q,), generator=g, device=device)
    qs = x[rows] + 0.3 * torch.randn((q, d), generator=g, device=device)
    x = x.to(dtype)
    return distance.normalize_queries(qs, metric).contiguous(), x, distance.base_aux(x, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,n,d", [(104, 8192, 1024), (256, 4096, 1024), (100, 16384, 128),
                                   (300, 2048, 136)])
def test_engines_on_clustered_data(cuda_device, metric, q, n, d, dtype):
    """Both engines of score and tile_max (bf16: the query's hi/lo split
    on wgmma; f32: split TF32) hold their bound on clustered data."""
    qs, x, aux = _clustered_operands(cuda_device, metric, q, n, d, q + n + d, dtype)
    got = distance.scores(qs, x, aux, metric=metric)
    want = distance.scores_plain(qs, x, aux, metric)
    assert not distance.outside_kernel_bound(
        got, want, distance.kernel_error_bound(qs, x, aux, metric)).any()
    a = aux if aux is not None else torch.zeros(n, device=cuda_device)
    m8 = torch.ones(n, dtype=torch.uint8, device=cuda_device)
    got = tilescan.tile_maxes(qs, x, a, m8, metric=metric)
    want = tilescan.tile_maxes_plain(qs, x, a, m8, metric)
    assert not distance.outside_kernel_bound(
        got, want, tilescan.tile_error_bound(qs, x, a, metric)).any()


def _exact_tf32x3_operands(device, side, q, n, d, seed):
    """Operands whose three TF32 products are exact: one side dense with
    22 significant bits (hi + lo holds it exactly), the other TF32-exact
    (+-1) with at most 4 nonzeros a row, so every partial sum is a multiple
    of 2^-20 below 16 and exact in f32 in any order."""
    rng = np.random.default_rng(seed)

    def dense(rows):
        m = rng.integers(2**21, 2**22, (rows, d)) * rng.choice([-1, 1], (rows, d))
        return torch.from_numpy((m * 2.0**-20).astype(np.float32))

    def sparse(rows):
        v = np.zeros((rows, d), np.float32)
        for r in range(rows):
            cols = rng.choice(d, min(4, d), replace=False)
            v[r, cols] = rng.choice([-1.0, 1.0], len(cols))
        return torch.from_numpy(v)

    qs, x = (sparse(q), dense(n)) if side == "payload" else (dense(q), sparse(n))
    return qs.to(device), x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.IP, Metric.L2])
@pytest.mark.parametrize("side", ["payload", "query"])
@pytest.mark.parametrize("q,n,d", [(104, 4099, 1024), (300, 1000, 136), (13, 50_176, 128)])
def test_f32_engine_bit_exact_where_three_products_are_exact(cuda_device, side, metric, q, n, d):
    """With 22 significant bits on one side (`side`) and TF32-exact
    values on the other, q_hi x_hi + q_hi x_lo + q_lo x_hi is q.x exactly
    and so is every sum: the kernel must equal the f32 plain version bit
    for bit; single-pass TF32 (x_hi or q_hi alone) must not."""
    qs, x = _exact_tf32x3_operands(cuda_device, side, q, n, d, q + n + d)
    aux = distance.base_aux(x, metric)
    got = distance.scores(qs, x, aux, metric=metric)
    want = distance.scores_plain(qs, x, aux, metric)
    assert torch.equal(got, want)
    single = distance.tf32_products(qs, x, aux, metric, distance.TF32_SINGLE)
    assert float((single != want).float().mean()) > 0.5
    m8 = torch.ones((n,), dtype=torch.uint8, device=cuda_device)
    n_t = n - n % tilescan.SUB
    if n_t:
        a = aux[:n_t] if aux is not None else torch.zeros(n_t, device=cuda_device)
        got = tilescan.tile_maxes(qs, x[:n_t], a, m8[:n_t], metric=metric)
        assert torch.equal(got, tilescan.tile_maxes_plain(qs, x[:n_t], a, m8[:n_t], metric))


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d", [(64, 512, 64), (104, 1024, 128), (256, 640, 96), (300, 256, 40)])
def test_f32_engine_one_hot_fragment_layout(cuda_device, q, n, d):
    """Payload row r is one-hot at depth (7r + 3) % d with value r + 1;
    query i is one-hot at depth i % d with value 1 + i // d. A score is
    nonzero exactly where the depths meet, so a row, a query or a depth
    that the kernel's fragments or its permuted query put in the wrong
    place shows as a wrong entry: the kernel must equal the plain version
    bit for bit, for score and for tile_max."""
    r = torch.arange(n)
    x = torch.zeros((n, d))
    x[r, (7 * r + 3) % d] = (r + 1).to(torch.float32)
    i = torch.arange(q)
    qs = torch.zeros((q, d))
    qs[i, i % d] = (1 + i // d).to(torch.float32)
    qs, x = qs.to(cuda_device), x.to(cuda_device)
    got = distance.scores(qs, x, None, metric=Metric.IP)
    want = distance.scores_plain(qs, x, None, Metric.IP)
    assert int((want != 0).sum()) > 0
    assert torch.equal(got, want)
    zeros = torch.zeros(n, device=cuda_device)
    m8 = (torch.arange(n, device=cuda_device) % 5 != 1).to(torch.uint8)
    got = tilescan.tile_maxes(qs, x, zeros, m8, metric=Metric.IP)
    assert torch.equal(got, tilescan.tile_maxes_plain(qs, x, zeros, m8, Metric.IP))


def test_scan_geometry_fits_every_shape_the_gate_admits():
    """For every shape the tile-scan gate admits (D up to 2,048, Q up to
    1,024) and the score kernel's depths (any D % 8 == 0 up to 2,048): the
    ring has at least two stages, shared memory fits a Hopper block, the
    grid is non-empty and no larger than the tiles, and the query is
    resident exactly when it is one tile (Q <= 128) of D <= 128, as
    csrc/score_tile.cuh says."""
    for n in (tilescan.SUB * tilescan.OUT_LANES, 1_048_576):
        for d in range(128, 2049, 128):
            for q in range(8, 1025, 8):
                assert tilescan.supports(n, d, q, 10)
                _check_geometry(q, n, d)
    for d in range(8, 2049, 8):
        for q in (1, 63, 64, 65, 128, 129, 256, 300, 1024):
            for n in (1, 4099, 114_688):
                _check_geometry(q, n, d)


def _check_geometry(q, n, d):
    g = distance.scan_geometry(q, n, d)
    assert 2 <= g.stages <= distance.SCAN_MAX_STAGES
    assert g.smem_bytes <= distance.SMEM_LIMIT
    assert g.tiles == -(-q // distance.SCAN_BM) * -(-n // distance.SCAN_BN)
    assert 1 <= g.grid == min(distance.H100_SMS, g.tiles)
    assert g.resident == (q <= 128 and d <= 128)
    stage = distance.SCAN_STAGE_X + distance.SCAN_STAGE_EPI + 16
    stage += 0 if g.resident else distance.SCAN_STAGE_Q
    # one more stage would not fit, unless the ring is at its most
    assert g.stages == distance.SCAN_MAX_STAGES or g.smem_bytes + stage > distance.SMEM_LIMIT


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,n,d", BOUND_SHAPES)
def test_score_bound_admits_exact_math_and_rejects_hi_only(metric, q, n, d):
    """The plain version (f32 sums) lies inside the bound around the same
    split math summed in f64; the hi-only control lies outside it."""
    _, qs, x, aux = _operands(torch.device("cpu"), torch.bfloat16, metric, q, n, d, q * n)
    want = distance.scores_plain(qs, x, aux, metric)
    bound = distance.kernel_error_bound(qs, x, aux, metric)
    exact = _exact_split_scores(qs, x, aux, metric)
    assert not distance.outside_kernel_bound(exact, want, bound).any()
    control = distance.scores_plain(_hi_only(qs), x, aux, metric)
    assert distance.outside_kernel_bound(control, want, bound).any()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,keep,n,d", [(13, 0.01, 16384, 128), (104, 1.0, 16384, 128),
                                        (1, 1.0, TILE_N, 256), (65, 0.01, TILE_N, 1024),
                                        (300, 1.0, TILE_N, 128)])
def test_tile_bound_admits_exact_math_and_rejects_hi_only(metric, q, keep, n, d):
    qs, x, aux, m8 = _tile_operands(torch.device("cpu"), torch.bfloat16, metric, q, keep, n, d)
    want = tilescan.tile_maxes_plain(qs, x, aux, m8, metric)
    bound = tilescan.tile_error_bound(qs, x, aux, metric)
    s = _exact_split_scores(qs, x, aux, metric)
    s = torch.where(m8[None, :] != 0, s, torch.full_like(s, tilescan.NEG))
    exact = torch.amax(s.reshape(q, -1, tilescan.SUB), dim=2)
    assert not distance.outside_kernel_bound(exact, want, bound).any()
    control = tilescan.tile_maxes_plain(_hi_only(qs), x, aux, m8, metric)
    assert distance.outside_kernel_bound(control, want, bound).any()


def _exact_rescore(qs, x, aux, sub, metric):
    """The rescore's products and sums in f64, rounded to f32 once."""
    q, d = qs.shape
    g = x.reshape(-1, tilescan.SUB, d)[sub].to(torch.float64)
    s = torch.einsum("qd,qsrd->qsr", qs.to(torch.float64), g).reshape(q, -1)
    a = aux.reshape(-1, tilescan.SUB)[sub].reshape(q, -1).to(torch.float64)
    return distance._apply_metric(s, a, metric).to(torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,d,s", [(13, 128, 12), (8, 1024, 12), (65, 256, 3)])
def test_rescore_bound_admits_exact_math_and_rejects_bf16_query(dtype, metric, q, d, s):
    """The plain version (f32 products and sums) lies inside
    `rescore_error_bound` around the same products summed in f64; a control
    that rounds the query to bf16 before its products lies outside it. On
    the CPU the wrapper is the plain version, bit for bit, and a row whose
    mask byte is 0 scores -inf."""
    cpu = torch.device("cpu")
    g, qs, x, aux, sub = _rescore_operands(cpu, dtype, metric, q, d, s, n=32 * tilescan.SUB,
                                           seed=q + d + s)
    m8 = torch.ones(x.shape[0], dtype=torch.uint8)
    want = tilescan.tile_rescore_plain(qs, x, aux, m8, sub, metric)
    bound = tilescan.rescore_error_bound(qs, x, aux, sub, metric)
    exact = _exact_rescore(qs, x, aux, sub, metric)
    assert not distance.outside_kernel_bound(exact, want, bound).any()
    control = tilescan.tile_rescore_plain(_hi_only(qs), x, aux, m8, sub, metric)
    assert distance.outside_kernel_bound(control, want, bound).any()
    half = (torch.rand(x.shape[0], generator=g) < 0.5).to(torch.uint8)
    masked = tilescan.tile_rescore(qs, x, aux, half, sub, metric=metric)
    assert torch.equal(masked, tilescan.tile_rescore_plain(qs, x, aux, half, sub, metric))
    kept = _kept_rows(half, sub)
    assert torch.equal(torch.isneginf(masked), ~kept) and kept.any()
    assert torch.equal(masked[kept], want[kept])


def _rescore_rejections(device):
    """What every device's wrapper refuses: shapes, types, devices."""
    x = torch.randn((1024, 128), device=device).to(torch.bfloat16)
    ok = dict(queries=torch.randn((8, 128), device=device), base=x,
              aux=torch.zeros(1024, device=device),
              mask_u8=torch.ones(1024, dtype=torch.uint8, device=device),
              sub=torch.zeros((8, 2), dtype=torch.int64, device=device), metric=Metric.L2)

    def call(**kw):
        return tilescan.tile_rescore(**{**ok, **kw})

    assert call().shape == (8, 2 * tilescan.SUB)
    with pytest.raises(ValueError, match="N % 128"):
        call(base=x[:1000], aux=ok["aux"][:1000], mask_u8=ok["mask_u8"][:1000])
    with pytest.raises(ValueError, match="D % 128"):
        call(queries=ok["queries"][:, :64].contiguous(), base=x[:, :64].contiguous())
    with pytest.raises(TypeError):
        call(base=x.half())
    with pytest.raises(TypeError):
        call(queries=ok["queries"].double())
    with pytest.raises(ValueError, match="mask must be uint8"):
        call(mask_u8=ok["mask_u8"].bool())
    with pytest.raises(ValueError, match="sub must be int64"):
        call(sub=ok["sub"].int())
    with pytest.raises(ValueError, match="sub must be int64"):
        call(sub=ok["sub"][:4])
    with pytest.raises(ValueError, match="sub must choose"):
        call(sub=ok["sub"][:, :0])
    with pytest.raises(ValueError, match="sub must choose"):
        call(sub=torch.zeros((8, 9), dtype=torch.int64, device=device))  # 8 sub-tiles
    return call, ok


def test_rescore_wrapper_rejects_bad_operands_on_the_cpu():
    _rescore_rejections(torch.device("cpu"))


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn((256, 128), device=cuda_device)
    q = torch.randn((8, 128), device=cuda_device)
    aux = distance.base_aux(x, Metric.L2)
    with pytest.raises(ValueError, match="contiguous"):
        distance.scores(q, x.t().contiguous().t(), aux, metric=Metric.L2)
    with pytest.raises(ValueError, match="D % 8"):
        distance.scores(q[:, :12].contiguous(), x[:, :12].contiguous(), aux, metric=Metric.L2)
    with pytest.raises(TypeError):
        distance.scores(q.half(), x, aux, metric=Metric.L2)
    with pytest.raises(ValueError, match="N % 128"):
        tilescan.tile_maxes(q, x[:200], aux[:200], torch.ones(200, dtype=torch.uint8,
                            device=cuda_device), metric=Metric.L2)


@pytest.mark.cuda
def test_tile_rescore_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    call, ok = _rescore_rejections(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        call(sub=torch.zeros((2, 8), dtype=torch.int64, device=cuda_device).t())
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(queries=torch.randn(8 * 128 + 1, device=cuda_device)[1:].view(8, 128))
    with pytest.raises(ValueError, match="payload's device"):
        call(sub=ok["sub"].cpu())
    with pytest.raises(ValueError, match="one device"):
        call(aux=ok["aux"].cpu())


def _gathermv_operands(device, q, beam, m, dt, n=500, seed=0):
    """Codes, block rows (some outside [0, N), which the kernel clamps) and
    queries scaled as the traversal scales them."""
    g = torch.Generator(device=device).manual_seed(seed)
    nb = torch.randint(0, 256, (n, m, dt), generator=g, device=device, dtype=torch.uint8)
    rows = torch.randint(-3, n + 3, (q, beam), generator=g, device=device, dtype=torch.int32)
    rows[0, 0], rows[-1, -1] = -1, n  # both sides, whatever the draw
    qs = 0.01 * torch.randn((q, dt), generator=g, device=device)
    return qs, rows, nb


@pytest.mark.cuda
@pytest.mark.parametrize("q", [13, 256])
@pytest.mark.parametrize("beam", [2, 4, 5, 8])
@pytest.mark.parametrize("m", [16, 32, 64])
@pytest.mark.parametrize("dt", [128, 256, 1024])
def test_gathermv_kernel_vs_plain(cuda_device, q, beam, m, dt):
    """Ragged Q, a beam narrower than 8 (ef_s < 8), m from 16 to 64, the
    three widths and clamped rows; a control that skips the query's bf16
    cast falls outside the bound on most entries."""
    qs, rows, nb = _gathermv_operands(cuda_device, q, beam, m, dt, seed=q * beam + m + dt)
    assert gathermv.supports(dt)
    before = gathermv.gather_block_scores.launches
    got = gathermv.gather_block_scores(qs, rows, nb)
    assert gathermv.gather_block_scores.launches == before + 1
    want = gathermv.gather_block_scores_plain(qs, rows, nb)
    bound = gathermv.kernel_error_bound(qs, rows, nb)
    assert got.shape == (q, beam * m)
    assert not gathermv.outside_kernel_bound(got, want, bound).any()
    clamped = gathermv.gather_block_scores_plain(qs, rows.clamp(0, nb.shape[0] - 1), nb)
    torch.testing.assert_close(want, clamped, rtol=0, atol=0)
    control = gathermv.unrounded_control(qs, rows, nb)
    assert gathermv.outside_kernel_bound(control, want, bound).float().mean() > 0.5


@pytest.mark.cuda
def test_gathermv_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    qs, rows, nb = _gathermv_operands(cuda_device, 8, 8, 32, 128)
    with pytest.raises(ValueError, match="contiguous"):
        gathermv.gather_block_scores(qs, rows.t().contiguous().t(), nb)
    with pytest.raises(ValueError, match="Dt % 16"):
        gathermv.gather_block_scores(
            qs[:, :40].contiguous(), rows, nb[:, :, :40].contiguous()
        )
    with pytest.raises(TypeError, match="uint8"):
        gathermv.gather_block_scores(qs, rows, nb.to(torch.int8))
    with pytest.raises(ValueError, match="one device"):
        gathermv.gather_block_scores(qs.cpu(), rows, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("m,ef_s,k", [(16, 64, 10), (32, 5, 5), (48, 4, 3), (32, 1, 3)])
def test_hnsw_search_launches_gathermv_every_iteration(cuda_device, m, ef_s, k):
    """A graph search on the card scores every frontier iteration with the
    kernel, at any m and at a beam narrower than 8 (ef_s < 8), and finds
    what the same index finds on the CPU (the kernel's plain version):
    recall of the card's rows against the CPU's >= 0.95 (only the order of
    the f32 sums differs, which can turn a near-tie), every query gets k
    distinct live rows, even at a small ef (a neighbour that two expanded
    nodes share enters the result pool once), and every returned row's
    score is within rtol 2e-4 / atol 2e-3 of its exact f32 score."""
    rng = np.random.default_rng(m + ef_s)
    centers = 8.0 * rng.standard_normal((20, 128)).astype(np.float32)
    vecs = (centers[rng.integers(0, 20, 2000)] + rng.standard_normal((2000, 128))).astype(np.float32)
    schema = Schema({"id": UInt64(), "vec": FloatVector(128)})
    seg = Segment.from_columns(
        0, schema, {"id": np.arange(2000, dtype=np.uint64), "vec": vecs}, device=cuda_device
    )
    idx = hnsw.HNSWFlatIndex.build(seg.vector("vec"), 2000, metric=Metric.L2, dim=128,
                                   params={"m": m, "ef_c": 40})
    assert idx.nbdata is not None and idx.nbdata.shape[1] == m
    q = torch.from_numpy(vecs[:16] + 0.3 * rng.standard_normal((16, 128)).astype(np.float32))
    before = gathermv.gather_block_scores.launches
    v, r = idx.search_t(q.to(cuda_device), k, params=(("ef_s", ef_s),))
    assert gathermv.gather_block_scores.launches - before == hnsw.n_iterations(max(ef_s, k))
    cpu = hnsw.HNSWFlatIndex.from_state_dict(idx.state_dict(), device="cpu")
    _, rc = cpu.search_t(q, k, params=(("ef_s", ef_s),))
    r = r.cpu().numpy()
    same = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(r, rc.numpy()))
    assert same >= 0.95 * (rc.numpy() >= 0).sum()
    assert (r >= 0).all() and all(len(set(row.tolist())) == k for row in r)
    v = v.cpu().numpy()
    stored = seg.vector("vec").data[:2000, :128].float().cpu().numpy()[r]
    exact = 2.0 * np.einsum("qd,qkd->qk", q.numpy(), stored) - (stored**2).sum(-1)
    np.testing.assert_allclose(v, exact, rtol=2e-4, atol=2e-3)


BIN_METRICS = [Metric.HAMMING, Metric.JACCARD]


def _bits(g, shape, device, density=0.5):
    """Random packed bytes whose bits are set with probability `density`."""
    bits = (torch.rand((*shape, 8), generator=g, device=device) < density).to(torch.uint8)
    return (bits << torch.arange(8, dtype=torch.uint8, device=device)).sum(-1, dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", BIN_METRICS)
@pytest.mark.parametrize("q,n,b", [(1, 1, 4), (13, 1000, 128), (100, 65_536, 128), (17, 4099, 5),
                                   (33, 777, 13), (300, 2048, 129), (8, 300, 256)])
def test_binary_rows_kernel_vs_plain(cuda_device, metric, q, n, b, masked):
    """The shared-base layout: ragged Q (past a 16-query tile), N (past a
    256-row block) and B (not a multiple of 4: the byte tail), all-zero
    rows, rows past n_valid and masked rows; bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(q * n + b)
    qb = _bits(g, (q, b), cuda_device)
    x = _bits(g, (n, b), cuda_device, density=0.2)
    x[: min(n, 3)] = 0
    qb[0] = 0
    mask = (torch.rand(n, generator=g, device=cuda_device) < 0.7) if masked else None
    n_valid = max(0, n - 5)
    before = binary.binary_scores.launches
    got = binary.binary_scores(qb, x, metric, n_valid=n_valid, mask=mask)
    assert binary.binary_scores.launches == before + 1
    valid = torch.arange(n, device=cuda_device) < n_valid
    if mask is not None:
        valid &= mask
    want = binary.binary_scores_plain(qb, x, metric, valid)
    assert torch.equal(got, want)
    if n_valid < n:
        assert bool((got[:, n_valid:] == float("-inf")).all())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", BIN_METRICS)
@pytest.mark.parametrize("q,p,c,m,b", [(100, 16, 64, 2000, 128), (7, 3, 5, 257, 5), (300, 1, 2, 64, 128),
                                       (1, 4, 4, 1, 12)])
def test_binary_blocks_kernel_vs_plain(cuda_device, metric, q, p, c, m, b):
    """Per-query blocks, read in place: ragged Q, P blocks per query, M
    (past a 256-row block) and B; empty slots (row -1), block ids out of
    [0, C) (clamped, as the plain version does) and a row mask; bit for
    bit with the plain version (Jaccard: the two-popcount one, while the
    kernel takes the slots' bit counts)."""
    g = torch.Generator(device=cuda_device).manual_seed(q + p + c + m + b)
    qb = _bits(g, (q, b), cuda_device)
    x = _bits(g, (c, m, b), cuda_device)
    rows = torch.randperm(c * m, generator=g, device=cuda_device).to(torch.int32).reshape(c, m)
    rows[:, -max(1, m // 9):] = -1
    blk = torch.randint(-1, c + 1, (q, p), generator=g, device=cuda_device, dtype=torch.int32)
    popcnt = binary.row_popcounts(x)
    for mask in (None, torch.rand(c * m, generator=g, device=cuda_device) < 0.6):
        before = binary.binary_block_scores.launches
        got = binary.binary_block_scores(qb, x, blk, rows, metric, mask=mask, popcnt=popcnt)
        assert binary.binary_block_scores.launches == before + 1
        want = binary.binary_block_scores_plain(qb, x, blk, rows, mask, metric)
        assert got.shape == (q, p * m)
        assert torch.equal(got, want)


def _skewed_probes(g, device, case, q, p, c):
    """blk int32[q, p] of one skew: every pair on one bucket, every pair on
    its own bucket, or uniform draws (with ids outside [0, c), clamped)."""
    if case == "one":
        return torch.full((q, p), c // 2, dtype=torch.int32, device=device)
    if case == "distinct":
        return torch.randperm(c, generator=g, device=device)[: q * p].reshape(q, p).to(torch.int32)
    return torch.randint(-2, c + 2, (q, p), generator=g, device=device, dtype=torch.int32)


# (skew, Q, P, C): all queries on one bucket; all pairs on distinct buckets;
# C = 1; Q * P not a multiple of 16; P > C (repeats within a query); a
# BinaryMSTG-sized batch; 10^5 pairs over 65,536 buckets, spread and on one
GROUP_KERNEL_CASES = [("one", 100, 16, 1024), ("distinct", 64, 16, 1024), ("uniform", 7, 5, 1),
                      ("uniform", 13, 7, 20), ("uniform", 9, 12, 4), ("uniform", 100, 16, 1024),
                      ("uniform", 6250, 16, 65_536), ("one", 6250, 16, 65_536),
                      ("uniform", 3, 1, 2_000_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,q,p,c", GROUP_KERNEL_CASES)
def test_binary_group_kernel_vs_plain(cuda_device, case, q, p, c):
    """The blocks layout's grouping kernel equals `group_probes_plain`:
    the pair order and the groups up to the count, under torch.equal."""
    g = torch.Generator(device=cuda_device).manual_seed(q * p + c)
    blk = _skewed_probes(g, cuda_device, case, q, p, c)
    before = binary.group_probes.launches
    pairs, groups, count = binary.group_probes(blk, c)
    assert binary.group_probes.launches == before + 1
    wp, wg, wc = binary.group_probes_plain(blk, c)
    assert torch.equal(count, wc)
    assert torch.equal(pairs, wp)
    n = int(wc[0])
    assert torch.equal(groups[:n], wg[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("with_popcnt", [False, True])
@pytest.mark.parametrize("metric", BIN_METRICS)
@pytest.mark.parametrize("b", [128, 13])
@pytest.mark.parametrize("case,q,p,c,m", [("one", 100, 16, 64, 300), ("distinct", 40, 8, 320, 257),
                                          ("uniform", 9, 5, 1, 100), ("uniform", 13, 7, 20, 96),
                                          ("uniform", 9, 12, 4, 513)])
def test_binary_blocks_kernel_skewed_probes(cuda_device, case, q, p, c, m, b, metric, with_popcnt):
    """The grouped blocks layout under skewed probes (one bucket for all,
    a bucket per pair, C = 1, Q * P not a multiple of 16, P > C with
    repeats), aligned and ragged B, with and without a mask: bit for bit
    with the plain version (Jaccard: the two-popcount one), in one grouping
    and one scoring launch. Hamming does not read the bit counts; Jaccard
    without them raises before any launch."""
    g = torch.Generator(device=cuda_device).manual_seed(q + p + c + m + b)
    qb = _bits(g, (q, b), cuda_device)
    x = _bits(g, (c, m, b), cuda_device, density=0.3)
    x[0, :2] = 0
    qb[0] = 0
    rows = torch.randperm(c * m, generator=g, device=cuda_device).to(torch.int32).reshape(c, m)
    rows[:, -max(1, m // 9):] = -1
    blk = _skewed_probes(g, cuda_device, case, q, p, c)
    popcnt = binary.row_popcounts(x) if with_popcnt else None
    for mask in (None, torch.rand(c * m, generator=g, device=cuda_device) < 0.6):
        before = (binary.group_probes.launches, binary.binary_block_scores.launches)
        if metric == Metric.JACCARD and popcnt is None:
            with pytest.raises(ValueError, match="Jaccard needs popcnt"):
                binary.binary_block_scores(qb, x, blk, rows, metric, mask=mask)
            assert (binary.group_probes.launches, binary.binary_block_scores.launches) == before
            continue
        got = binary.binary_block_scores(qb, x, blk, rows, metric, mask=mask, popcnt=popcnt)
        assert (binary.group_probes.launches, binary.binary_block_scores.launches) == (
            before[0] + 1, before[1] + 1)
        want = binary.binary_block_scores_plain(qb, x, blk, rows, mask, metric)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", BIN_METRICS)
def test_binary_index_search_on_the_card(cuda_device, metric):
    """BinaryFLAT and BinaryMSTG built and searched on the card launch the
    kernel (rows layout for the scan and the overflow, blocks layout for
    the buckets) and find the CPU's top-k scores exactly."""
    from myscaledb_tpu_torch.index import binary as bidx
    from myscaledb_tpu_torch.storage.schema import BinaryVector

    rng = np.random.default_rng(5)
    protos = rng.random((16, 512)) < 0.5
    bits = protos[rng.integers(0, 16, 20_000)] ^ (rng.random((20_000, 512)) < 0.1)
    schema = Schema({"id": UInt64(), "bv": BinaryVector(512)})
    cols = {"id": np.arange(20_000, dtype=np.uint64), "bv": np.packbits(bits, axis=1)}
    q = torch.from_numpy(np.packbits(bits[:32] ^ (rng.random((32, 512)) < 0.05), axis=1))
    for cls in (bidx.BinaryFlatIndex, bidx.BinaryMSTGIndex):
        card = cls.build(Segment.from_columns(0, schema, cols, device=cuda_device).vector("bv"),
                         20_000, metric=metric, dim=512)
        if cls is bidx.BinaryMSTGIndex:  # the card's build, carried to the CPU
            host = cls.from_state_dict(card.state_dict(), device="cpu")
            params = (("nprobe", card.n_clusters),)  # every bucket: no probe near-ties
        else:
            host = cls.build(Segment.from_columns(0, schema, cols, device="cpu").vector("bv"),
                             20_000, metric=metric, dim=512)
            params = ()
        before = (binary.binary_scores.launches, binary.binary_block_scores.launches)
        v, _ = card.search_t(q.to(cuda_device), 10, params=params)
        rows_launches = binary.binary_scores.launches - before[0]
        block_launches = binary.binary_block_scores.launches - before[1]
        if cls is bidx.BinaryMSTGIndex:
            assert block_launches == 1 and rows_launches == (1 if card.n_overflow else 0)
        else:
            assert rows_launches == 1 and block_launches == 0
        want, _ = host.search_t(q, 10, params=params)
        assert torch.equal(v.cpu(), want)


# ------------------------------------------------------------- host tier
@pytest.mark.cuda
def test_host_chunks_bring_the_pinned_rows(cuda_device):
    """`host_chunks` on the card: every chunk (the padded last one too)
    holds its pinned host rows while the caller works on it; a pageable
    host tensor raises instead of taking a staging copy."""
    from myscaledb_tpu_torch.ops.stream import host_chunks

    n, d, chunk = 300_000, 256, 65_536
    x = torch.empty((n, d), pin_memory=True).copy_(torch.randn((n, d)))
    a = torch.empty((n,), pin_memory=True).copy_(torch.arange(n, dtype=torch.float32))
    for _ in range(2):  # the second call reuses the first one's buffers
        for i, m, (xc, ac) in host_chunks([x, a], n, cuda_device, chunk, pad=True):
            _ = (xc * 2.0).sum()  # work on the chunk, enqueued before the next
            assert torch.equal(xc[:m].cpu(), x[i : i + m]) and torch.equal(ac[:m].cpu(), a[i : i + m])
            assert not xc[m:].any() and xc.shape == (chunk, d)
    with pytest.raises(ValueError, match="pinned"):
        list(host_chunks([torch.zeros((10, 4))], 10, cuda_device, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_stream_scan_over_segments_matches_the_cpu(cuda_device, metric):
    """Host-tier segments scanned one after another on the card (each scan
    queued behind the last, no sync between them) return the CPU plain
    version's rows, and scores within the f32 engine's bound; the rows are
    pinned and each chunk launches the f32 score kernel."""
    from myscaledb_tpu_torch.ops import bruteforce

    n, d, nq, k = 200_000, 256, 24, 10
    schema = Schema({"id": UInt64(), "vec": FloatVector(d)})
    rng = np.random.default_rng(3)
    segs = []
    for s in range(3):
        v = rng.standard_normal((n, d)).astype(np.float32)
        cols = {"id": np.arange(n, dtype=np.uint64), "vec": v}
        segs.append((Segment.from_columns(s, schema, cols, device=cuda_device,
                                          storage_tier="host"),
                     Segment.from_columns(s, schema, cols, device="cpu", storage_tier="host")))
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    before = distance.scores.launches_f32
    got = []
    for card, _ in segs:
        p = card.vector("vec")
        assert p.is_host and p.data.is_pinned() and p.sqnorm.is_pinned()
        got.append(bruteforce.stream_scan_topk(q.to(cuda_device), p.data, p.aux_for(metric), k=k,
                                               metric=metric, n_valid=n, chunk=65_536))
    assert distance.scores.launches_f32 - before == 3 * 4  # 4 chunks a segment
    for (v, r), (_, host) in zip(got, segs):
        p = host.vector("vec")
        wv, wr = bruteforce.stream_scan_topk(q, p.data, p.aux_for(metric), k=k, metric=metric,
                                             n_valid=n, chunk=65_536)
        assert torch.equal(r.cpu(), wr)
        qn = distance.normalize_queries(q, metric)
        aux = p.aux_for(metric)
        bound = distance.kernel_error_bound(qn, p.data[:n], None if aux is None else aux[:n],
                                            metric)
        bound = torch.gather(bound, 1, wr.to(torch.int64))
        assert not distance.outside_kernel_bound(v.cpu(), wv, bound).any()


# (Q, N, L, share kept, ties): the approximate top-k's partial reduce at the
# main path's shapes (a SIFT chunk at L 1,024 and 128, the GIST segment, a
# binary chunk, the 50k dense text store), -inf rows, an N that is not a
# multiple of L, and a Q past one grid row of 65,535 blocks
APPROX_SHAPES = [(104, 131_072, 1_024, 1.0, False), (104, 131_072, 128, 1.0, False),
                 (256, 114_688, 896, 1.0, False), (100, 65_536, 1_024, 1.0, False),
                 (100, 50_176, 1_664, 1.0, False), (104, 131_072, 1_024, 0.01, False),
                 (37, 100_003, 896, 0.5, True), (70_000, 256, 128, 1.0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,L,keep,ties", APPROX_SHAPES)
def test_approx_bin_max_kernel_vs_plain(cuda_device, q, n, L, keep, ties):
    g = torch.Generator(device=cuda_device).manual_seed(n + L)
    s = 3.0 * torch.randn((q, n + 5), generator=g, device=cuda_device)
    if ties:
        s = torch.round(2.0 * s) / 2.0
    if keep < 1.0:
        s = s.masked_fill(torch.rand(s.shape, generator=g, device=cuda_device) >= keep,
                          float("-inf"))
    for x in (s[:, :n].contiguous(), s[:, 5:]):  # dense rows, and a column slice in place
        before = topk.approx_bin_max.launches
        v, i = topk.approx_bin_max(x, L)
        pv, pi = topk.approx_bin_max_plain(x, L)
        torch.cuda.synchronize()
        assert topk.approx_bin_max.launches == before + 1
        assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.cuda
def test_approx_bin_max_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    s = torch.zeros((4, 1_000), device=cuda_device)
    with pytest.raises(TypeError):
        topk.approx_bin_max(s.to(torch.float16), 128)
    with pytest.raises(ValueError):
        topk.approx_bin_max(s, 1_001)
    with pytest.raises(ValueError):
        topk.approx_bin_max(s.T.contiguous().T, 128)  # columns not of unit stride


# ------------------------------------------------ search programs (graphs)
def _program_index(device, kind, metric, n, d=128, seed=0):
    """A port index of `kind` built on `device` over n clustered rows, its
    padded queries and a mask over its segment's capacity."""
    from myscaledb_tpu_torch.index import registry
    from myscaledb_tpu_torch.index.base import IndexKind
    from myscaledb_tpu_torch.index.flat import FlatIndex

    rng = np.random.default_rng(seed)
    centers = 6.0 * rng.standard_normal((40, d)).astype(np.float32)
    vecs = (centers[rng.integers(0, 40, n)] + rng.standard_normal((n, d))).astype(np.float32)
    seg = Segment.from_columns(0, Schema({"id": UInt64(), "vec": FloatVector(d)}),
                               {"id": np.arange(n, dtype=np.uint64), "vec": vecs}, device=device)
    p = seg.vector("vec")
    if kind.startswith("FLAT"):
        idx = FlatIndex(p.data, p.aux_for(metric), metric=metric, dim=d, n_rows=n,
                        approx=kind == "FLAT_APPROX", recall_target=0.95)
    else:
        extra = {"m": 16, "ef_c": 64} if kind.startswith("HNSW") else {"ncentroids": 64}
        if kind in ("IVFPQ", "HNSWPQ"):
            extra["M"] = 16
        idx = registry.implementation(IndexKind(kind)).build(p, n, metric=metric, dim=d,
                                                             params=extra)
    q = torch.from_numpy(vecs[rng.choice(n, 16, replace=False)] + 0.1).to(device)
    q = torch.nn.functional.pad(q, (0, p.data.shape[1] - d))
    mask = torch.from_numpy(np.arange(seg.capacity) % 5 != 2).to(device)
    return idx, q, mask


PROGRAM_CASES = [
    ("FLAT", Metric.L2, 20_000, {}),  # the score kernel
    ("FLAT", Metric.COSINE, 20_000, {}),
    ("FLAT_TILE", Metric.L2, 70_000, {}),  # capacity 81,920: tile_max
    ("FLAT_APPROX", Metric.IP, 70_000, {}),  # approx_bin_max
    ("IVFFLAT", Metric.L2, 20_000, {"nprobe": 4}),
    ("IVFSQ", Metric.L2, 20_000, {"nprobe": 4}),
    ("IVFPQ", Metric.L2, 20_000, {"nprobe": 4}),
    ("MSTG", Metric.COSINE, 20_000, {"nprobe": 4}),
    ("HNSWFLAT", Metric.L2, 20_000, {"ef_s": 64}),  # gathermv
    ("HNSWSQ", Metric.L2, 20_000, {"ef_s": 64}),
    ("HNSWPQ", Metric.L2, 20_000, {"ef_s": 64}),
]


def _replays_bit_for_bit(idx, q, mask, params):
    from myscaledb_tpu_torch.index.base import params_key
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    wrappers = (distance.scores, tilescan.tile_maxes, tilescan.tile_rescore,
                gathermv.gather_block_scores, topk.approx_bin_max, binary.binary_scores,
                binary.binary_block_scores, binary.group_probes)
    caps = GLOBAL_COUNTERS.get("SearchProgramCaptures")
    first = idx.search(q, 10, params=params, mask=mask)  # warm-up, capture, replay
    before = [w.launches for w in wrappers]
    again = idx.search(q, 10, params=params, mask=mask)  # a replay
    replay = [w.launches - b for w, b in zip(wrappers, before)]
    before = [w.launches for w in wrappers]
    eager = idx.search_t(q, 10, mask=mask, params=params_key(params))
    torch.cuda.synchronize()
    assert replay == [w.launches - b for w, b in zip(wrappers, before)]  # the same launches
    assert GLOBAL_COUNTERS.get("SearchProgramCaptures") - caps == 1
    prog, = idx._programs.programs()
    assert prog.graph is not None and prog.runs == 2
    for got in (first, again):
        assert torch.equal(got[1], eager[1].to(torch.int32))
        assert torch.equal(got[0].view(torch.int32), eager[0].contiguous().view(torch.int32))
    assert first[0].data_ptr() != again[0].data_ptr()  # each search its own copy
    return dict(zip(wrappers, replay))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,metric,n,params", PROGRAM_CASES,
                         ids=[f"{c[0]}-{c[1].value}" for c in PROGRAM_CASES])
def test_program_replay_equals_the_eager_body(cuda_device, kind, metric, n, params):
    idx, q, mask = _program_index(cuda_device, kind, metric, n)
    _replays_bit_for_bit(idx, q, mask, params)


@pytest.mark.cuda
def test_exact_flat_search_launches_tile_max_and_rescore_once(cuda_device):
    """An exact FLAT search over a 1,000,000-row segment (capacity
    1,048,576, the benchmark's SIFT table) takes the tile prune: a replay
    of its program launches tile_max once and the rescore once, and equals
    the eager body."""
    idx, q, mask = _program_index(cuda_device, "FLAT", Metric.L2, 1_000_000)
    launched = _replays_bit_for_bit(idx, q, mask, {})
    assert launched[tilescan.tile_maxes] == launched[tilescan.tile_rescore] == 1
    assert sum(launched.values()) == 2


@pytest.mark.cuda
def test_decoupled_program_replay_equals_the_eager_body(cuda_device):
    """A DecoupledIndex over two IVFFLAT sources (a merge's serving
    window): the row maps put the second source's rows after the first's."""
    from myscaledb_tpu_torch.index.decoupled import DecoupledIndex

    a, q, cap_mask = _program_index(cuda_device, "IVFFLAT", Metric.L2, 20_000, seed=1)
    b, _, _ = _program_index(cuda_device, "IVFFLAT", Metric.L2, 20_000, seed=2)
    rows = torch.arange(cap_mask.shape[0], dtype=torch.int32, device=cuda_device)
    maps = [torch.where(rows < 20_000, rows + off, torch.full_like(rows, -1))
            for off in (0, 20_000)]
    idx = DecoupledIndex([a, b], maps, metric=Metric.L2, dim=128, n_rows=40_000)
    mask = torch.from_numpy(np.arange(40_960) % 7 != 3).to(cuda_device)
    _replays_bit_for_bit(idx, q, mask, {"nprobe": 4})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["BinaryFLAT", "BinaryMSTG"])
@pytest.mark.parametrize("metric", BIN_METRICS)
def test_binary_program_replay_equals_the_eager_body(cuda_device, kind, metric):
    from myscaledb_tpu_torch.index.binary import BinaryFlatIndex, BinaryMSTGIndex
    from myscaledb_tpu_torch.storage.schema import BinaryVector

    rng = np.random.default_rng(5)
    n, dim = 70_000, 512
    bits = np.packbits(rng.random((n, dim)) < 0.5, axis=1)
    seg = Segment.from_columns(0, Schema({"id": UInt64(), "bv": BinaryVector(dim)}),
                               {"id": np.arange(n, dtype=np.uint64), "bv": bits},
                               device=cuda_device)
    p = seg.vector("bv")
    cls = BinaryFlatIndex if kind == "BinaryFLAT" else BinaryMSTGIndex
    idx = cls.build(p, n, metric=metric, dim=dim, params={"ncentroids": 64})
    q = torch.from_numpy(bits[:16]).to(cuda_device)
    mask = torch.from_numpy(np.arange(seg.capacity) % 3 != 0).to(cuda_device)
    _replays_bit_for_bit(idx, q, mask, {} if kind == "BinaryFLAT" else {"nprobe": 4})


@pytest.mark.cuda
def test_table_search_replays_the_fused_body(cuda_device):
    """Table.search (two segments, one with IVFFLAT, a filter) against
    `_fused_multi_search` run eagerly on the same searchers and masks."""
    import myscaledb_tpu_torch as tms

    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 30_000
    db = tms.connect(st, device=cuda_device)
    t = db.create_table("t", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(128)}))
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((90_000, 128)).astype(np.float32)
    t.insert({"id": np.arange(70_000, dtype=np.uint64), "vec": vecs[:70_000]})
    t.insert({"id": np.arange(70_000, 90_000, dtype=np.uint64), "vec": vecs[70_000:]})
    t.add_vector_index("i", "vec", type="IVFFLAT", ncentroids=64)
    assert t.wait_index_built()
    q = vecs[:20] + 0.1
    for _ in range(2):
        res = t.search("vec", q, k=10, params={"nprobe": 3},
                       filter=(tms.F("id") < 60_000) | (tms.F("id") >= 75_000))
    prog, = t._programs.programs()
    assert prog.graph is not None and prog.dyn is not None
    # the eager body over the program's own static inputs
    packed = prog.body(prog.q, prog.masks, prog.dyn)
    torch.cuda.synchronize()
    assert torch.equal(packed[:, :20], res._packed[:, :20])
    # every program dropped (the pool's other graphs gone): the next
    # search captures into the same pool again
    t._segments_changed()
    del prog
    again = t.search("vec", q, k=10, params={"nprobe": 3},
                     filter=(tms.F("id") < 60_000) | (tms.F("id") >= 75_000))
    assert torch.equal(again._packed, res._packed)
    db.close()


@pytest.mark.cuda
def test_a_body_that_syncs_raises_at_capture(cuda_device):
    from myscaledb_tpu_torch.index.flat import FlatIndex

    class Syncing(FlatIndex):
        def search_t(self, queries, k, *, mask=None, params=()):
            if float(queries.abs().sum().item()) < 0:  # a host sync: capture refuses it
                raise AssertionError
            return super().search_t(queries, k, mask=mask, params=params)

    idx, q, _ = _program_index(cuda_device, "FLAT", Metric.L2, 20_000)
    bad = Syncing(idx.data, idx.aux, metric=idx.metric, dim=idx.dim, n_rows=idx.n_rows)
    with pytest.raises(RuntimeError, match="FLAT failed to capture"):
        bad.search(q, 10)
    torch.cuda.synchronize()
    assert idx.search(q, 10)[1].shape == (16, 10)  # the card still serves
