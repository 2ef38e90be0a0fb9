"""FLAT index: exact scan, recall 1.0.

Counterpart of myscaledb_tpu/index/flat.py: the scan of ops/bruteforce.py
over the segment's own payload (no memory beyond the stored
auxiliaries); over a host-tier payload, the streamed scan
(`stream_scan_topk`, exact). With `approx` (QuerySettings.use_approx_topk)
a device payload's scan takes the approximate top-k at `recall_target`
when the segment holds more than 4k rows, as in the JAX package. The
executor instantiates it ad hoc for index-less
segments (the brute-force path); `add_vector_index(type="FLAT")` builds
it as a segment's index, and a checkpoint keeps only its metadata (it is
rebuilt from the segment payload on load).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..metrics import Metric
from ..ops import bruteforce
from .base import IndexKind, ParamsKey, VectorIndex
from .registry import register


@register(IndexKind.FLAT)
class FlatIndex(VectorIndex):
    def __init__(
        self,
        data: torch.Tensor,
        aux: Optional[torch.Tensor],
        *,
        metric: Metric,
        dim: int,
        n_rows: int,
        host: bool = False,
        approx: bool = False,
        recall_target: float = 0.99,
    ):
        self.data = data
        self.aux = aux
        self.metric = metric
        self.dim = dim
        self.n_rows = n_rows
        self.host = host  # the payload is in the host tier
        self.approx = approx
        self.recall_target = recall_target

    @classmethod
    def build(cls, payload, n_rows: int, *, metric: Metric, dim: int, params=None,
              settings=None, cancel_cb=None) -> "FlatIndex":
        del params, cancel_cb
        return cls(payload.data, payload.aux_for(metric), metric=metric, dim=dim, n_rows=n_rows,
                   host=payload.is_host,
                   approx=bool(settings and settings.query.use_approx_topk),
                   recall_target=settings.query.approx_topk_recall_target if settings else 0.99)

    def search_t(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        mask: Optional[torch.Tensor] = None,
        params: ParamsKey = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        del params  # FLAT has no search parameters
        if self.host:  # the host tier streams exactly, as in the JAX package
            return bruteforce.stream_scan_topk(
                queries, self.data, self.aux, k=k, metric=self.metric, n_valid=self.n_rows,
                mask=mask,
            )
        return bruteforce.scan_topk_t(
            queries,
            self.data,
            self.aux,
            k=k,
            metric=self.metric,
            n_valid=self.n_rows,
            mask=mask,
            approx=self.approx and self.n_rows > 4 * k,
            recall_target=self.recall_target,
        )

    def search(self, queries, k, *, params=None, mask=None, programs=None):
        """Over a host-tier payload the streamed scan runs eagerly, outside
        any graph (its copy stream moves the rows); otherwise one program."""
        if not self.host:
            return super().search(queries, k, params=params, mask=mask, programs=programs)
        from ..search.filters import as_mask_array

        return self.search_t(queries, k, mask=as_mask_array(mask))

    @property
    def memory_bytes(self) -> int:
        # FLAT references the segment payload; only device auxiliaries count
        if self.aux is None or self.host:
            return 0
        return self.aux.numel() * self.aux.element_size()

    def state_dict(self) -> Dict[str, Any]:
        return {"meta": {"kind": self.kind.value, "metric": self.metric.value,
                         "dim": self.dim, "n_rows": self.n_rows}}
