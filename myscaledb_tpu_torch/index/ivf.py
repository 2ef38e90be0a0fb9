"""IVF build side: balanced k-means over a cluster-major window layout.

Counterpart of the build half of myscaledb_tpu/index/ivf.py, as far as
the HNSW build needs it (its candidate generation runs over a throwaway
IVF index, index/hnsw.py):

  * centroids f32[C, D] from balanced k-means (ops/kmeans.py);
  * ONE cluster-major permutation of the rows, `perm_data[N', D']`, with
    per-cluster row offsets `cluster_start[C+1]`, zero padding beyond
    rounding N up to the 512-row window size;
  * `windows_for_probes` turns probed clusters into per-query lists of
    512-row windows.

Only the device path and the raw codec are ported. IVF search
(`_scan_stage`, the window masks), the SQ/PQ codecs and the IVFFLAT /
IVFSQ / IVFPQ / MSTG index kinds are ROADMAP queue 1 #5.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..errors import IndexParameterError
from ..metrics import Metric
from ..ops import kmeans
from ..ops._cuda import round_up
from .base import ParamsKey, VectorIndex, check_cancel

WINDOW = 512  # rows per scan window


def default_ncentroids(n_rows: int) -> int:
    """~4*sqrt(N), power-of-two-ish, clamped (FAISS-style heuristic)."""
    c = int(4 * math.sqrt(max(n_rows, 1)))
    c = 1 << max(4, int(round(math.log2(max(c, 16)))))
    return int(min(c, max(16, n_rows // 8), 65_536))


def _scan_rep(payload, n_rows: int, metric: Metric) -> torch.Tensor:
    """Rows in 'scan representation', f32: raw for L2/IP, normalized (times
    the stored 1/|x|) for Cosine."""
    data = payload.data[:n_rows].to(torch.float32)
    if metric == Metric.COSINE and payload.invnorm is not None:
        data = data * payload.invnorm[:n_rows, None]
    return data


def balanced_kmeans(
    rep: torch.Tensor,
    n_rows: int,
    c: int,
    *,
    extra_frac: float = 0.5,
    seed: int = 0,
    max_train_rows: Optional[int] = None,
    cancel_cb=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-means with size-proportional cluster splitting: after the main
    fit, `extra_frac*c` extra centroids are seeded onto the heaviest
    clusters and refined, which bounds the tail of the size histogram.
    Returns (centroids f32[C', D], assign int32[n])."""
    n_extra = int(c * extra_frac) if c >= 4 else 0
    sample = kmeans.training_sample(rep, n_rows, c, seed=seed, max_rows=max_train_rows)
    check_cancel(cancel_cb)
    cents = kmeans.kmeans_fit_balanced(
        sample, n_clusters=c, n_extra=n_extra, n_iters=10, seed=seed
    )
    check_cancel(cancel_cb)
    return cents, kmeans.assign_chunked(rep, cents)


def windows_for_probes(
    cluster_start: torch.Tensor,
    probe: torch.Tensor,
    n_windows: int,
    w_budget: int,
    limit=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probed clusters -> per-query deduplicated window lists.

    probe int[Q, P] -> (widx int64[Q, W], valid bool[Q, W]). A window can
    be listed by several adjacent probed clusters; the lists are sorted
    and deduplicated. Windows past the budget W are dropped (those of the
    least promising probes); `limit` masks the windows of probes ranked at
    or past it."""
    nprobe = probe.shape[1]
    probe = probe.to(torch.int64)
    cs = cluster_start.to(torch.int64)
    starts = cs[probe]  # [Q, P]
    ends = cs[probe + 1]
    ws = starts // WINDOW
    wcnt = torch.where(ends > starts, -((-ends) // WINDOW) - ws, torch.zeros_like(ws))
    cum = torch.cumsum(wcnt, dim=1)  # [Q, P]
    j = torch.arange(w_budget, device=probe.device)[None, :]  # [1, W]
    # p_idx[q, j] = which probe the j-th window belongs to
    p_idx = (cum[:, None, :] <= j[:, :, None]).sum(dim=2)  # [Q, W]
    valid_w = p_idx < (nprobe if limit is None else limit)
    p_clip = torch.clamp(p_idx, max=nprobe - 1)
    prev = torch.where(
        p_idx > 0,
        torch.gather(cum, 1, torch.clamp(p_clip - 1, min=0)),
        torch.zeros_like(p_idx),
    )
    wbase = torch.gather(ws, 1, p_clip)
    widx = torch.where(valid_w, wbase + (j - prev), torch.zeros_like(wbase))
    dead = n_windows + 1
    keyw = torch.sort(torch.where(valid_w, widx, torch.full_like(widx, dead)), dim=1).values
    dup = torch.zeros_like(keyw, dtype=torch.bool)
    dup[:, 1:] = keyw[:, 1:] == keyw[:, :-1]
    valid_w = (keyw < dead) & ~dup
    return torch.where(valid_w, keyw, torch.zeros_like(keyw)), valid_w


class IVFIndex(VectorIndex):
    """The IVF layout over one segment, raw codec (the HNSW build's
    candidate generator). Not registered for `add_vector_index`: its
    search is ROADMAP queue 1 #5."""

    def __init__(
        self,
        *,
        centroids: torch.Tensor,
        csq: torch.Tensor,
        perm_data: torch.Tensor,
        perm_rows: torch.Tensor,
        perm_aux: torch.Tensor,
        cluster_start: torch.Tensor,
        metric: Metric,
        dim: int,
        n_rows: int,
        n_clusters: int,
        n_windows: int,
        wpp: int,
    ):
        self.centroids = centroids  # f32[C, D]
        self.csq = csq  # f32[C]
        self.perm_data = perm_data  # [N', D'] cluster-major payload
        self.perm_rows = perm_rows  # int32[N'] original row ids (-1 pad)
        self.perm_aux = perm_aux  # f32[N'] |x|^2 (inf on padding)
        self.cluster_start = cluster_start  # int32[C+1] row offsets
        self.metric = metric
        self.dim = dim
        self.n_rows = n_rows
        self.n_clusters = n_clusters
        self.n_windows = n_windows
        self.wpp = wpp  # typical windows per probed cluster

    @classmethod
    def _build_common(
        cls,
        payload,
        n_rows: int,
        *,
        metric: Metric,
        dim: int,
        params: Dict[str, Any],
        settings,
        codec: str = "raw",
        cancel_cb=None,
    ) -> "IVFIndex":
        if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            raise IndexParameterError(f"IVF does not support metric {metric}")
        if codec != "raw":
            raise NotImplementedError(
                f"IVF codec {codec!r} is not ported yet (ROADMAP queue 1 #5)"
            )
        c = int(params.get("ncentroids", default_ncentroids(n_rows)))
        c = max(1, min(c, n_rows))
        storage_dtype = payload.data.dtype
        dpad = payload.data.shape[1]
        rep = _scan_rep(payload, n_rows, metric)
        max_train = None
        if settings is not None:
            max_train = max(
                settings.query.max_build_index_train_block_bytes // (dpad * 4), c
            )
        cents, assign = balanced_kmeans(
            rep, n_rows, c, seed=0, max_train_rows=max_train, cancel_cb=cancel_cb
        )
        check_cancel(cancel_cb)
        c = int(cents.shape[0])
        npad = round_up(max(n_rows, WINDOW), WINDOW)
        dev = rep.device

        # permutation and sqnorms never leave the device
        assign = assign.to(torch.int64)
        order = torch.argsort(assign, stable=True)
        counts = torch.bincount(assign, minlength=c)
        starts = torch.zeros(c + 1, dtype=torch.int64, device=dev)
        starts[1:] = torch.cumsum(counts, dim=0)
        perm_rows = torch.full((npad,), -1, dtype=torch.int32, device=dev)
        perm_rows[:n_rows] = order.to(torch.int32)
        rep_perm = rep[order]
        perm_data = torch.zeros((npad, dpad), dtype=storage_dtype, device=dev)
        perm_data[:n_rows] = rep_perm.to(storage_dtype)
        perm_aux = torch.full((npad,), float("inf"), dtype=torch.float32, device=dev)
        perm_aux[:n_rows] = torch.sum(rep_perm * rep_perm, dim=1)
        check_cancel(cancel_cb)

        return cls(
            centroids=cents,
            csq=torch.sum(cents * cents, dim=1),
            perm_data=perm_data,
            perm_rows=perm_rows,
            perm_aux=perm_aux,
            cluster_start=starts.to(torch.int32),
            metric=metric,
            dim=dim,
            n_rows=n_rows,
            n_clusters=c,
            n_windows=npad // WINDOW,
            wpp=int(math.ceil((n_rows / max(c, 1)) / WINDOW)) + 1,
        )

    def cluster_heads(self) -> torch.Tensor:
        """Representative row of each cluster (entry points for graph
        indexes): the first row in its window range, -1 for empty. The
        start is clamped into perm_rows explicitly (a JAX take clamps)."""
        starts = self.cluster_start[:-1].to(torch.int64)
        sizes = self.cluster_start[1:].to(torch.int64) - starts
        heads = self.perm_rows[torch.clamp(starts, max=self.perm_rows.shape[0] - 1)]
        return torch.where(sizes > 0, heads, torch.full_like(heads, -1))

    def search_t(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        mask: Optional[torch.Tensor] = None,
        params: ParamsKey = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError("IVF search is not ported yet (ROADMAP queue 1 #5)")
