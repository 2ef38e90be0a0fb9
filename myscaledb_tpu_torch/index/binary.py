"""Binary vector indexes: BinaryFLAT (exact) and BinaryMSTG (IVF-bucketed).

Counterpart of myscaledb_tpu/index/binary.py. Metrics: Hamming and
Jaccard, scored by the popcount kernel (ops/binary.py, csrc/binary.cu).

BinaryMSTG: the coarse quantizer clusters the unpacked {0, 1} float view
of the rows with k-means (probing by L2 on the bits is probing by
expected Hamming distance), while the bucket payloads stay packed uint8.
A search scores each query's `nprobe` buckets in place through the
kernel's blocks layout (the (query, probe) pairs grouped by bucket, then
one scoring launch), and the rows that overflowed the bucket capacity
through its rows layout; `torch.topk` selects. Each slot's bit count,
`bucket_popcnt`, is derived from `bucket_data` whenever an index is made
(a build or a state dict, the JAX package's included), so that Jaccard
takes one popcount a word; it is not part of the state.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from ..errors import IndexParameterError
from ..metrics import Metric
from ..ops import binary as binops
from ..ops import kmeans
from ..ops._cuda import round_up
from ..ops.topk import NEG_INF, topk_scores, topk_stable
from .base import IndexKind, ParamsKey, VectorIndex
from .ivf import DEFAULT_NPROBE, default_ncentroids
from .registry import register

# rows unpacked to f32 bits at a time for the cluster assignment
ASSIGN_CHUNK = 16_384


def _check_metric(metric: Metric) -> None:
    if metric not in (Metric.HAMMING, Metric.JACCARD):
        raise IndexParameterError(f"binary index does not support {metric}")


def _choose_bucket_cap(sizes: np.ndarray, n_rows: int) -> int:
    """Smallest bucket capacity with <= 2% of rows spilling to overflow,
    capped at 4x the mean (binary payloads are small enough that the
    padded-bucket layout is cheap)."""
    mean = max(1.0, n_rows / max(len(sizes), 1))
    hi = int(round_up(max(32, int(math.ceil(4.0 * mean))), 8))
    lo = int(round_up(max(32, int(math.ceil(1.0 * mean))), 8))
    cap = hi
    for cand in range(lo, hi + 1, 8):
        if np.maximum(sizes - cand, 0).sum() <= 0.02 * n_rows:
            cap = cand
            break
    return int(cap)


@register(IndexKind.BINARYFLAT)
class BinaryFlatIndex(VectorIndex):
    """The exact scan over the segment's packed payload (a reference: the
    index owns no tensor of its own)."""

    def __init__(self, data: torch.Tensor, *, metric: Metric, dim: int, n_rows: int):
        self.data = data
        self.metric = metric
        self.dim = dim
        self.n_rows = n_rows

    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None, cancel_cb=None):
        _check_metric(metric)
        return cls(payload.data, metric=metric, dim=dim, n_rows=n_rows)

    def search_t(self, queries, k, *, mask=None, params: ParamsKey = ()):
        del params
        return binops.binary_scan_topk(
            queries, self.data, k=k, metric=self.metric, n_valid=self.n_rows, mask=mask
        )

    @property
    def memory_bytes(self) -> int:
        return 0  # references the segment payload

    def state_dict(self):
        return {"meta": {"kind": self.kind.value, "metric": self.metric.value,
                         "dim": self.dim, "n_rows": self.n_rows}}


@register(IndexKind.BINARYMSTG)
class BinaryMSTGIndex(VectorIndex):
    _array_fields = (
        "centroids",  # f32[C, dim] in unpacked-bit space
        "csq",  # f32[C] |c|^2
        "bucket_data",  # u8[C, cap, nbytes]
        "bucket_rows",  # int32[C, cap], -1 = empty slot
        "over_data",  # u8[opad, nbytes]: rows past a bucket's capacity
        "over_rows",  # int32[opad]
    )
    _static_fields = ("metric", "dim", "n_rows", "n_clusters", "bucket_cap", "n_overflow")

    def __init__(self, **kw):
        for f in self._array_fields + self._static_fields:
            setattr(self, f, kw.pop(f))
        if kw:
            raise TypeError(f"unexpected fields {sorted(kw)}")
        self.bucket_popcnt = binops.row_popcounts(self.bucket_data)  # int32[C, cap]

    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None, cancel_cb=None):
        _check_metric(metric)
        params = dict(params or {})
        c = int(params.get("ncentroids", max(4, default_ncentroids(n_rows) // 4)))
        c = max(1, min(c, n_rows))
        packed = payload.data[:n_rows]  # u8[n, nbytes] on the device
        dev = packed.device
        # the training sample, drawn as the JAX package draws it (uniform
        # with replacement, c * 128 rows), and unpacked alone: the whole
        # f32 view of the bits is never materialized
        target = min(n_rows, max(c * 128, c))
        idx = torch.randint(
            0, n_rows, (target,), generator=torch.Generator(device=dev).manual_seed(0), device=dev
        )
        cents = kmeans.kmeans_fit(binops.unpack_bits_f32(packed[idx], dim), n_clusters=c,
                                  n_iters=8, seed=0)
        assign = torch.cat([
            kmeans.assign_chunked(binops.unpack_bits_f32(packed[off : off + ASSIGN_CHUNK], dim),
                                  cents)
            for off in range(0, n_rows, ASSIGN_CHUNK)
        ]).cpu().numpy()

        sizes = np.bincount(assign, minlength=c)
        cap = _choose_bucket_cap(sizes, n_rows)
        order = np.argsort(assign, kind="stable")
        packed_h = packed.cpu().numpy()
        nbytes = packed_h.shape[1]
        bucket_rows = np.full((c, cap), -1, np.int32)
        overflow: list = []
        starts = np.zeros(c + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        for ci in range(c):
            rows = order[starts[ci] : starts[ci + 1]]
            take = min(len(rows), cap)
            bucket_rows[ci, :take] = rows[:take]
            if len(rows) > take:
                overflow.extend(rows[take:].tolist())
        over = np.asarray(overflow, dtype=np.int64)
        n_over = len(over)
        opad = round_up(max(n_over, 8), 8)
        safe = np.maximum(bucket_rows.reshape(-1), 0)
        bucket_data = packed_h[safe].reshape(c, cap, nbytes)
        bucket_data[bucket_rows < 0] = 0
        over_data = np.zeros((opad, nbytes), np.uint8)
        over_rows = np.full(opad, -1, np.int32)
        if n_over:
            over_data[:n_over] = packed_h[over]
            over_rows[:n_over] = over

        def up(a):
            return torch.from_numpy(a).to(dev)

        return cls(
            centroids=cents,
            csq=torch.sum(cents * cents, dim=1),
            bucket_data=up(bucket_data),
            bucket_rows=up(bucket_rows),
            over_data=up(over_data),
            over_rows=up(over_rows),
            metric=metric,
            dim=dim,
            n_rows=n_rows,
            n_clusters=c,
            bucket_cap=cap,
            n_overflow=n_over,
        )

    def _nprobe(self, params: ParamsKey) -> int:
        d = dict(params)
        p = d.get("nprobe", DEFAULT_NPROBE)
        if "alpha" in d and "nprobe" not in d:
            p = max(1, int(float(d["alpha"]) * DEFAULT_NPROBE))
        return int(max(1, min(int(p), self.n_clusters)))

    def search_t(self, queries, k, *, mask=None, params: ParamsKey = ()):
        nprobe = self._nprobe(params)
        nq = queries.shape[0]
        qbits = binops.unpack_bits_f32(queries, self.dim)  # [Q, dim]
        cs = 2.0 * (qbits @ self.centroids.T) - self.csq[None, :]
        _, probe = topk_stable(cs, nprobe)  # the probe order of jax.lax.top_k
        kk = min(k, self.bucket_cap)
        # every probed bucket of every query, read in place
        scores = binops.binary_block_scores(
            queries, self.bucket_data, probe, self.bucket_rows, self.metric, mask=mask,
            popcnt=self.bucket_popcnt,
        )  # [Q, nprobe * cap]
        bv, pos = topk_scores(scores, kk)
        slot_rows = self.bucket_rows.index_select(0, probe.reshape(-1).to(torch.int64))
        br = torch.gather(slot_rows.reshape(nq, -1), 1, torch.clamp(pos, min=0).to(torch.int64))
        if self.n_overflow > 0:
            omask = None
            if mask is not None:
                hit = mask[torch.clamp(self.over_rows, min=0).to(torch.int64)]
                omask = torch.logical_and(self.over_rows >= 0, hit)
            ov, op = binops.binary_scan_topk(
                queries, self.over_data, k=kk, metric=self.metric, n_valid=self.n_overflow,
                mask=omask,
            )
            orr = self.over_rows[torch.clamp(op, min=0).to(torch.int64)]
            orr = torch.where(op >= 0, orr, torch.full_like(orr, -1))
            bv, p2 = torch.topk(torch.cat([bv, ov], -1), kk, dim=-1)
            br = torch.gather(torch.cat([br, orr], -1), -1, p2)
        br = torch.where(torch.isfinite(bv), br, torch.full_like(br, -1))
        if kk < k:
            bv = torch.nn.functional.pad(bv, (0, k - kk), value=NEG_INF)
            br = torch.nn.functional.pad(br, (0, k - kk), value=-1)
        return bv, br.to(torch.int32)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "meta": {
                "kind": self.kind.value,
                "metric": self.metric.value,
                "dim": self.dim,
                "n_rows": self.n_rows,
                "n_clusters": self.n_clusters,
                "bucket_cap": self.bucket_cap,
                "n_overflow": self.n_overflow,
            },
            "arrays": {f: getattr(self, f).cpu().numpy() for f in self._array_fields},
        }

    @classmethod
    def from_state_dict(cls, state, *, device) -> "BinaryMSTGIndex":
        m, a = state["meta"], state["arrays"]
        dtypes = dict(centroids=np.float32, csq=np.float32, bucket_data=np.uint8,
                      bucket_rows=np.int32, over_data=np.uint8, over_rows=np.int32)
        return cls(
            **{f: torch.from_numpy(np.array(a[f], dtype=dtypes[f])).to(device)
               for f in cls._array_fields},
            metric=Metric(m["metric"]),
            dim=m["dim"],
            n_rows=m["n_rows"],
            n_clusters=m["n_clusters"],
            bucket_cap=m["bucket_cap"],
            n_overflow=m["n_overflow"],
        )
