"""Decoupled index: serve a merged segment through its sources' indexes.

Counterpart of myscaledb_tpu/index/decoupled.py. Reference semantics
(SURVEY.md §3.4, MergeTask.cpp:319-405 + VIWithDataPart.cpp:56-127): when
parts with built indexes merge, the new part keeps the old indexes plus
row-id maps; searches fan out over the old indexes with label translation
until a fresh index for the merged part is built in the background.

The wrapper holds the source index objects (their tensors already on the
device) and per source a `row_map` int32[old_capacity] on the same device:
old row -> merged row, -1 = dropped or deleted at merge. The merged
segment's mask (filter ∩ deletes) is carried INTO each source search by
one gather, `mask[max(row_map, 0)]`, and each source's labels come back
through another, so the pre-filter guarantee holds as everywhere; no step
waits for the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..metrics import Metric
from ..ops.topk import NEG_INF
from .base import ParamsKey, VectorIndex


class DecoupledIndex(VectorIndex):
    """Transient: replaced by the merged segment's own index once its
    rebuild lands, and never persisted."""

    def __init__(self, subs, row_maps, *, metric: Metric, dim: int, n_rows: int):
        self.subs = tuple(subs)
        self.row_maps = tuple(row_maps)  # int32[old_capacity] each, on the device
        self.metric = metric
        self.dim = dim
        self.n_rows = n_rows

    @property
    def supports_dyn_nprobe(self) -> bool:
        return any(getattr(s, "supports_dyn_nprobe", False) for s in self.subs)

    def search_t(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        mask: Optional[torch.Tensor] = None,
        params: ParamsKey = (),
        dyn_nprobe: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        vs, rs = [], []
        for sub, rmap in zip(self.subs, self.row_maps):
            idx = torch.clamp(rmap, min=0).to(torch.int64)
            old_mask = rmap >= 0
            if mask is not None:
                old_mask = old_mask & mask[idx]
            kw = (
                {"dyn_nprobe": dyn_nprobe}
                if dyn_nprobe is not None and getattr(sub, "supports_dyn_nprobe", False)
                else {}
            )
            v, r_old = sub.search_t(queries, k, mask=old_mask, params=params, **kw)
            r_new = torch.where(
                r_old >= 0, rmap[torch.clamp(r_old, min=0).to(torch.int64)], -1
            )
            vs.append(torch.where(r_new >= 0, v, torch.full_like(v, NEG_INF)))
            rs.append(r_new)
        vals = torch.cat(vs, dim=-1)
        rows = torch.cat(rs, dim=-1)
        mv, pos = torch.topk(vals, min(k, vals.shape[-1]), dim=-1)
        mr = torch.gather(rows, 1, pos)
        mr = torch.where(torch.isfinite(mv), mr, torch.full_like(mr, -1))
        if mv.shape[-1] < k:
            pad = k - mv.shape[-1]
            mv = torch.nn.functional.pad(mv, (0, pad), value=NEG_INF)
            mr = torch.nn.functional.pad(mr, (0, pad), value=-1)
        return mv, mr

    @property
    def memory_bytes(self) -> int:
        return sum(s.memory_bytes for s in self.subs) + sum(
            m.numel() * m.element_size() for m in self.row_maps
        )
