"""The gathermv module of the port (myscaledb_tpu_torch/ops/gathermv.py)
against the JAX package's `gather_block_scores` (Pallas, interpret mode on
the CPU), and the bound its CUDA kernel is held to.

On the CPU the port's wrapper runs its plain version: `index_select` of
the u8 blocks and an f32 einsum against the queries rounded to bf16. The
JAX kernel computes the same products (bf16 x u8 is exact in f32), so the
two differ only in the order of their f32 sums: they are held to the
kernel bound, 2^-16 of sum_d |bf16(q_d) c_d| plus 1e-5 of the score
(`gathermv.kernel_error_bound`). The card-only kernel cases are in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myscaledb_tpu.ops import gathermv as jgm

from myscaledb_tpu_torch.ops import gathermv

SHAPES = [(32, 256, 8), (32, 128, 4), (64, 128, 8)]  # tests/test_gathermv.py's


def _operands(seed, n, m, dt, q, beam, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 256, (n, m, dt), dtype=np.uint8)
    rows = rng.integers(lo, n if hi is None else hi, (q, beam)).astype(np.int32)
    qs = rng.standard_normal((q, dt)).astype(np.float32)
    return nb, rows, qs


def _jax(qs, rows, nb):
    return np.array(
        jgm.gather_block_scores(jnp.asarray(qs), jnp.asarray(rows), jnp.asarray(nb))
    )


def _port(qs, rows, nb):
    t = [torch.from_numpy(a) for a in (qs, rows, nb)]
    got = gathermv.gather_block_scores(*t)
    return got, gathermv.kernel_error_bound(*t)


@pytest.mark.parametrize("m,dt,beam", SHAPES)
def test_plain_matches_jax_kernel(m, dt, beam):
    nb, rows, qs = _operands(m + dt + beam, 300, m, dt, 5, beam)
    assert gathermv.supports(dt) and jgm.supports(beam, m, dt)
    want = torch.from_numpy(_jax(qs, rows, nb))
    got, bound = _port(qs, rows, nb)
    assert got.shape == (5, beam * m) and got.dtype == torch.float32
    assert not gathermv.outside_kernel_bound(got, want, bound).any()


def test_repeated_and_clamped_rows():
    """Repeated rows score alike; rows outside [0, N) score as the clamped
    rows the JAX kernel's callers pass."""
    n, m, dt, q, beam = 64, 32, 128, 3, 4
    nb, _, qs = _operands(0, n, m, dt, q, beam)
    rows = np.zeros((q, beam), np.int32)  # all the same block
    got, _ = _port(qs, rows, nb)
    got = got.reshape(q, beam, m)
    for b in range(1, beam):
        torch.testing.assert_close(got[:, 0], got[:, b], rtol=0, atol=0)
    _, wild, _ = _operands(1, n, m, dt, q, beam, lo=-5, hi=n + 5)
    wild[0, 0], wild[1, 1], wild[2, 3] = -1, n, n + 4  # both sides, whatever the draw
    assert (wild < 0).any() and (wild >= n).any()
    got, bound = _port(qs, wild, nb)
    want = torch.from_numpy(_jax(qs, np.clip(wild, 0, n - 1), nb))
    assert not gathermv.outside_kernel_bound(got, want, bound).any()


@pytest.mark.parametrize("beam,m,dt", [(8, 16, 256), (8, 32, 100), (3, 32, 256), (8, 32, 1024),
                                       (4, 64, 128), (8, 32, 12_288)])
def test_supports_gate_matches_jax_alignment(beam, m, dt):
    """The kernel takes every shape the JAX kernel takes, and more: any m
    and BEAM, and any Dt in 16-byte chunks up to its shared-memory limit
    (MAX_DT). The JAX alignment rules were Mosaic tiling limits."""
    assert gathermv.supports(dt) == (dt % 16 == 0 and dt <= gathermv.MAX_DT)
    if dt <= 1024 and jgm.supports(beam, m, dt):
        assert gathermv.supports(dt)
    assert not gathermv.supports(gathermv.MAX_DT + 16)


@pytest.mark.parametrize("m,dt,beam", SHAPES)
def test_bound_admits_exact_sums_and_rejects_unrounded_queries(m, dt, beam):
    """The plain version's f32 sums lie inside the bound around the same
    products summed in f64; a version that skips the bf16 cast of the query
    (the control) lies outside it on most entries."""
    nb, rows, qs = _operands(7 * m + dt, 500, m, dt, 13, beam)
    got, bound = _port(qs, rows, nb)
    g = nb[rows].astype(np.float64)  # [Q, B, m, Dt]
    qb = torch.from_numpy(qs).to(torch.bfloat16).to(torch.float64).numpy()
    exact = torch.from_numpy(np.einsum("qd,qbmd->qbm", qb, g).reshape(13, -1).astype(np.float32))
    assert not gathermv.outside_kernel_bound(exact, got, bound).any()
    control = torch.from_numpy(
        np.einsum("qd,qbmd->qbm", qs.astype(np.float64), g).reshape(13, -1).astype(np.float32)
    )
    outside = gathermv.outside_kernel_bound(control, got, bound)
    assert outside.float().mean() > 0.5


def test_wrapper_rejects_bad_operands():
    nb, rows, qs = (torch.from_numpy(a) for a in _operands(3, 16, 32, 128, 2, 4))
    with pytest.raises(TypeError, match="float32"):
        gathermv.gather_block_scores(qs.double(), rows, nb)
    with pytest.raises(TypeError, match="int32"):
        gathermv.gather_block_scores(qs, rows.long(), nb)
    with pytest.raises(TypeError, match="uint8"):
        gathermv.gather_block_scores(qs, rows, nb.to(torch.int8))
    with pytest.raises(ValueError, match="mismatch"):
        gathermv.gather_block_scores(qs[:, :64], rows, nb)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in (qs, rows, nb)]
    with pytest.raises(ValueError, match="unsupported device"):
        gathermv.gather_block_scores(*meta)
    before = gathermv.gather_block_scores.launches
    gathermv.gather_block_scores(qs, rows, nb)  # a CPU tensor: plain version, no launch
    assert gathermv.gather_block_scores.launches == before
