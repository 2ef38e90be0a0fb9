"""K-means (Lloyd's) for the IVF coarse quantizer, on the device.

Counterpart of myscaledb_tpu/ops/kmeans.py:

  * assignment = argmax over the score matrix (2 x·cᵀ - |c|²), chunked
    over rows so no [N, C] matrix is materialized at once;
  * centroid update = `index_add_` scatter-add (the JAX package's
    `segment_sum`);
  * training runs on a bounded random sample of the rows;
  * the `*_host` variants take a host-tier corpus (ops/stream.py::HostRep):
    the sample is gathered on the host and moved once, and the assignment
    streams the rows through the device in chunks.

The JAX package draws its random indices with `jax.random`; the port
draws them from an explicit `torch.Generator`. The two streams differ, so
every random draw can also be passed in (`init_idx`, `idx`): a test feeds
JAX's own draws and compares the fit. The host sample is drawn with numpy
exactly as the JAX package draws it, so it equals JAX's row for row. The
`fori_loop`s are Python loops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def assign_chunked(
    data: torch.Tensor, centroids: torch.Tensor, chunk: int = 65_536
) -> torch.Tensor:
    """argmin_c ||x - c||^2 for each row, in row chunks.

    data: [N, D] (any float dtype), centroids: f32[C, D] -> int32[N]. Ties
    go to the lowest centroid index, as `jnp.argmax` breaks them."""
    csq = torch.sum(centroids * centroids, dim=1)
    out = []
    for off in range(0, data.shape[0], chunk):
        s = 2.0 * (data[off : off + chunk].to(torch.float32) @ centroids.T) - csq[None, :]
        out.append(torch.argmax(s, dim=1).to(torch.int32))
    if not out:
        return torch.empty((0,), dtype=torch.int32, device=data.device)
    return torch.cat(out)


def lloyd_stats(
    data: torch.Tensor, centroids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd's E+M statistic pass: per-centroid (sums f32[C, D],
    counts f32[C])."""
    c, d = centroids.shape
    a = assign_chunked(data, centroids).to(torch.int64)
    sums = torch.zeros((c, d), dtype=torch.float32, device=data.device)
    sums.index_add_(0, a, data.to(torch.float32))
    counts = torch.zeros((c,), dtype=torch.float32, device=data.device)
    counts.index_add_(0, a, torch.ones((data.shape[0],), dtype=torch.float32, device=data.device))
    return sums, counts


def _jitter(rows: int, d: int, device) -> torch.Tensor:
    """The deterministic per-slot perturbation 1e-3 * sin(slot * (j + 1))."""
    slot = torch.arange(rows, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(d, dtype=torch.float32, device=device)[None, :]
    return 1e-3 * torch.sin(slot * (j + 1.0))


def lloyd_update(
    centroids: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """M step: mean of assigned rows. Empty clusters are reseeded by
    splitting the largest clusters (perturbed copies of their centroids),
    which keeps the cluster-size histogram tight."""
    c, d = centroids.shape
    safe = torch.clamp(counts, min=1.0)[:, None]
    new = torch.where(counts[:, None] > 0, sums / safe, centroids)
    empty = counts <= 0
    # rank of each empty slot among empties -> round-robin over the
    # largest clusters
    order = torch.argsort(-counts, stable=True)
    n_targets = max(1, min(32, c))
    empty_rank = torch.cumsum(empty.to(torch.int64), dim=0) - 1
    target = order[torch.clamp(empty_rank % n_targets, 0, c - 1)]
    donor = new[target]
    scale = torch.clamp(torch.abs(donor), min=1e-3)
    reseed = donor + _jitter(c, d, centroids.device) * scale
    return torch.where(empty[:, None], reseed, new)


def kmeans_fit(
    data: torch.Tensor,
    *,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    init_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain Lloyd's -> centroids f32[n_clusters, D], from `n_clusters`
    distinct random rows (`init_idx`, or a permutation drawn with `seed`)."""
    if init_idx is None:
        init_idx = torch.randperm(
            data.shape[0], generator=_generator(data.device, seed), device=data.device
        )[:n_clusters]
    cents = data[init_idx.to(device=data.device, dtype=torch.int64)].to(torch.float32)
    for _ in range(n_iters):
        cents = lloyd_update(cents, *lloyd_stats(data, cents))
    return cents


def kmeans_fit_balanced(
    data: torch.Tensor,
    *,
    n_clusters: int,
    n_extra: int,
    n_iters: int = 10,
    refine_iters: int = 4,
    seed: int = 0,
    init_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Balanced k-means -> centroids f32[n_clusters + n_extra, D].

    `kmeans_fit` (plain Lloyd's from `n_clusters` distinct random rows,
    `init_idx` or drawn with `seed`), then `n_extra` centroids seeded on the
    heaviest clusters proportionally to their size (systematic sampling
    over the size histogram), then `refine_iters` more Lloyd steps so the
    copies drift apart and split their donors. Centroids that end up
    owning no rows are fine: the IVF probe masks empty clusters out."""
    d = data.shape[1]
    cents = kmeans_fit(data, n_clusters=n_clusters, n_iters=n_iters, seed=seed, init_idx=init_idx)
    if n_extra <= 0:
        return cents

    _, counts = lloyd_stats(data, cents)
    order = torch.argsort(-counts, stable=True)
    cum = torch.cumsum(counts[order], dim=0)
    total = torch.clamp(cum[-1], min=1.0)
    pos = (torch.arange(n_extra, dtype=torch.float32, device=data.device) + 0.5) * (
        total / n_extra
    )
    idx = torch.searchsorted(cum, pos)
    target = order[torch.clamp(idx, 0, n_clusters - 1)]
    donors = cents[target]
    extra = donors + _jitter(n_extra, d, data.device) * torch.clamp(torch.abs(donors), min=1e-3)
    cents = torch.cat([cents, extra], dim=0)
    for _ in range(refine_iters):
        cents = lloyd_update(cents, *lloyd_stats(data, cents))
    return cents


def training_sample(
    data: torch.Tensor,
    n_valid: int,
    n_clusters: int,
    *,
    sample_per_centroid: int = 128,
    seed: int = 0,
    max_rows: Optional[int] = None,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bounded training subset of the valid rows, drawn with replacement
    on the device (`idx`, or uniform draws made with `seed`). `max_rows`
    is the byte-budget bound from max_build_index_train_block_bytes."""
    target = min(n_valid, max(n_clusters * sample_per_centroid, n_clusters))
    if max_rows is not None:
        target = max(min(target, max_rows), min(n_valid, n_clusters))
    if idx is None:
        idx = torch.randint(
            0, n_valid, (target,), generator=_generator(data.device, seed), device=data.device
        )
    return data[idx.to(device=data.device, dtype=torch.int64)].to(torch.float32)


def assign_chunked_host(rep, centroids: torch.Tensor, chunk: int = 262_144) -> torch.Tensor:
    """`assign_chunked` over a host-tier corpus (`HostRep`), its rows
    streamed through the centroids' device `chunk` rows at a time ->
    int32[n] on that device."""
    out = torch.empty((rep.n,), dtype=torch.int32, device=centroids.device)
    for i, m, x in rep.chunks(centroids.device, chunk):
        out[i : i + m] = assign_chunked(x, centroids)
    return out


def training_sample_host(
    rep,
    n_valid: int,
    n_clusters: int,
    *,
    device,
    sample_per_centroid: int = 128,
    seed: int = 0,
    max_rows: Optional[int] = None,
) -> torch.Tensor:
    """`training_sample` of a host-tier corpus (`HostRep`): the rows drawn
    by `np.random.default_rng(seed).integers` (the JAX package's draws, so
    the same rows), gathered on the host and moved to `device` once."""
    target = min(n_valid, max(n_clusters * sample_per_centroid, n_clusters))
    if max_rows is not None:
        target = max(min(target, max_rows), min(n_valid, n_clusters))
    idx = np.random.default_rng(seed).integers(0, n_valid, target)
    return rep.take(idx, device)
