"""Immutable segment: the analogue of a MergeTree data part.

Counterpart of myscaledb_tpu/storage/segment.py. A segment is:

  * a statically-shaped vector payload per vector column
    (`f32|bf16[capacity, D_pad]`, rows >= n_rows are zero padding), plus
    precomputed per-row metric auxiliaries (|x|^2, 1/|x|) so scans never
    recompute norms; a binary column holds its packed bits
    (`u8[capacity, dim/8]`);
  * host-resident scalar columns (numpy) for filtering and result gather;
  * a delete bitmap (lightweight DELETE, intersected into every search).

A float payload lives in one of two tiers (`VectorPayload.tier`):

  * "hbm": on the segment's `device`;
  * "host": in host memory, pinned when the segment's device is a CUDA
    card, so exact scans stream it through the card in chunks
    (ops/bruteforce.py::stream_scan_topk) and disk-mode indexes gather
    their re-rank rows from it. A table asks for it
    (`vector_storage_tier = "host"`: the raw f32 rows are kept), or the
    device budget refuses the payload, or its upload runs out of device
    memory twice (storage/hbm.py): the payload then spills with the
    bf16-rounded values the device tier would have scored, so a spill
    changes no score. Binary columns have no host tier.

Row ids ("labels") are segment-local.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import SchemaError
from ..metrics import Metric
from ..ops._cuda import round_up
from ..service.event_log import GLOBAL_COUNTERS
from .hbm import GOVERNOR, guarded_put
from .schema import BinaryVector, FloatVector, Schema


def _pad_dim(d: int) -> int:
    return round_up(d, 128)


TIERS = ("hbm", "host")


@dataclasses.dataclass
class VectorPayload:
    """Tensors for one vector column of a segment: on the segment's device
    (tier "hbm"), or in host memory (tier "host"). The tier is explicit: a
    tensor's device cannot tell the tiers apart when the segment's device
    is the CPU."""

    data: torch.Tensor  # [capacity, D_pad] storage dtype, or u8 packed bits
    sqnorm: Optional[torch.Tensor] = None  # f32[capacity] |x|^2 (float cols)
    invnorm: Optional[torch.Tensor] = None  # f32[capacity] 1/|x| (float cols)
    tier: str = "hbm"
    # the device that scans the payload and builds its indexes, for the
    # host tier (the segment's device, not where `data` lives)
    home: Optional[torch.device] = None

    @property
    def is_host(self) -> bool:
        return self.tier == "host"

    @property
    def device(self) -> torch.device:
        return self.home if self.home is not None else self.data.device

    def aux_for(self, metric: Metric) -> Optional[torch.Tensor]:
        if metric == Metric.L2:
            return self.sqnorm
        if metric == Metric.COSINE:
            return self.invnorm
        return None

    @property
    def nbytes(self) -> int:
        total = self.data.numel() * self.data.element_size()
        for a in (self.sqnorm, self.invnorm):
            if a is not None:
                total += a.numel() * a.element_size()
        return total


_SEGMENT_UID = itertools.count()


def segment_capacity(n_rows: int, alignment: int) -> int:
    """Row capacity of an `n_rows` segment. Large segments align to the
    scan chunk (128k rows) so the chunked scan divides evenly; mid-size
    segments (>= 64k rows) align to the tile-max scan's 16384-row gate
    (ops/tilescan.supports) so they take the pruned route; smaller ones
    align to `alignment`. The rule is the JAX package's, so both packages
    give a segment the same shape and the same scan route."""
    if n_rows >= 128 * 1024:
        eff_align = 128 * 1024
    elif n_rows >= 64 * 1024:
        eff_align = 16 * 1024
    else:
        eff_align = alignment
    return round_up(n_rows, eff_align)


def payload_norms(stored: np.ndarray):
    """(|x|^2, 1/|x|) as f32 from the stored (rounded) payload values, by
    the JAX package's host numpy computation, so that the two packages
    hold bit-identical auxiliaries."""
    sq = np.einsum("ij,ij->i", stored, stored)
    nrm = np.sqrt(sq)
    inv = np.where(nrm > 0, 1.0 / np.where(nrm > 0, nrm, 1.0), 0.0).astype(np.float32)
    return sq, inv


def host_tensor(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` as a host-tier tensor for a segment on `device`: in pinned host
    memory when `device` is a CUDA card (so chunks reach the card by DMA,
    without a staging copy; a pinning failure raises), copied there unless
    it already is; else `t` itself."""
    if device.type != "cuda" or t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def host_payload(data: torch.Tensor, sq: np.ndarray, inv: np.ndarray, device) -> VectorPayload:
    """A host-tier float payload over the stored values `data` (f32) and
    their norms."""
    return VectorPayload(
        data=host_tensor(data, device),
        sqnorm=host_tensor(torch.from_numpy(sq), device),
        invnorm=host_tensor(torch.from_numpy(inv), device),
        tier="host",
        home=torch.device(device),
    )


def upload_payload(
    cname: str,
    codes: torch.Tensor,
    aux: Dict[str, np.ndarray],
    device: torch.device,
    server_settings=None,
) -> VectorPayload:
    """Admit one vector column's stored payload against the device budget
    (storage/hbm.py) and move it, with its per-row auxiliaries (`aux`:
    sqnorm and invnorm of a float column, none for a binary one), to
    `device`. A float payload the budget refuses, or whose upload runs out
    of device memory twice, spills to the host tier with the values the
    device tier would have scored (so a spill changes no score); a binary
    one raises MemoryError, as binary columns have no host tier."""
    capacity = codes.shape[0]
    est = codes.numel() * codes.element_size() + capacity * 4 * len(aux)
    up = None
    if GOVERNOR.admit(est, device, server_settings):
        try:
            up = guarded_put([codes] + [torch.from_numpy(a) for a in aux.values()], device)
        except BaseException:
            GOVERNOR.release(est)
            raise
        if up is None:
            GOVERNOR.release(est)
    if up is not None:
        payload = VectorPayload(data=up[0], **dict(zip(aux, up[1:])))
        GOVERNOR.register(payload, est)
        return payload
    if not aux:
        raise MemoryError(
            f"binary column {cname!r} ({codes.numel()} bytes) does not fit on "
            f"{device}, after one retry: binary columns have no host tier"
        )
    GLOBAL_COUNTERS.bump("SegmentPayloadsSpilledToHost")
    return host_payload(codes.to(torch.float32), aux["sqnorm"], aux["invnorm"], device)


class Segment:
    """One slab of rows with immutable vector payloads. Mutable state is the
    delete bitmap (lightweight DELETE, lock-guarded) and the host scalar
    columns (UPDATE, ADD / DROP COLUMN, under the table's locks)."""

    def __init__(
        self,
        segment_id: int,
        schema: Schema,
        n_rows: int,
        capacity: int,
        vectors: Dict[str, VectorPayload],
        scalars: Dict[str, np.ndarray],
        *,
        device: torch.device,
        storage_dtype: torch.dtype = torch.bfloat16,
    ):
        self.segment_id = segment_id
        self.schema = schema
        self.n_rows = n_rows
        self.capacity = capacity
        self.vectors = vectors
        self.scalars = scalars
        self.device = torch.device(device)
        self.storage_dtype = storage_dtype
        self._lock = threading.RLock()
        # Delete bitmap: True = row deleted. Host copy is authoritative;
        # the device copy is rebuilt lazily on change.
        self._deleted_host = np.zeros(capacity, dtype=bool)
        self._deleted_dev: Optional[torch.Tensor] = None
        self._n_deleted = 0  # kept by delete_rows: n_rows reads it per search
        # bumped on every delete, UPDATE and ADD/DROP COLUMN; the filter-mask
        # caches and the device mirrors of scalar columns key on it
        self.mutation_generation = 0
        # per-column (min, max) stats for predicate const-folding
        self._minmax_cache: Dict[str, tuple] = {}
        # device mirrors of numeric scalar columns (predicate lowering)
        self._scalar_dev_cache: Dict[str, tuple] = {}
        # (filter repr, mutation generation) -> a host-evaluated predicate's
        # device mask / passing share (search/executor.py): they die with
        # the segment
        self.mask_cache: Dict[tuple, torch.Tensor] = {}
        self.selectivity_cache: Dict[tuple, float] = {}
        # process-unique id (segment_ids restart per table)
        self.uid = next(_SEGMENT_UID)
        # exact f32 rows per bf16-stored float-vector column (column reads)
        self._exact_f32: Dict[str, np.ndarray] = {}
        # vector columns that went to the host tier under memory pressure
        self.spilled_columns: set = set()

    # ---------------------------------------------------------------- build
    @classmethod
    def from_columns(
        cls,
        segment_id: int,
        schema: Schema,
        columns: Dict[str, np.ndarray],
        *,
        device: torch.device,
        alignment: int = 1024,
        storage_dtype: torch.dtype = torch.bfloat16,
        storage_tier: str = "hbm",
        server_settings=None,
    ) -> "Segment":
        device = torch.device(device)
        if storage_tier not in TIERS:
            raise SchemaError(f"unknown vector_storage_tier {storage_tier!r}")
        names = set(schema.columns)
        if set(columns) != names:
            missing = names - set(columns)
            extra = set(columns) - names
            raise SchemaError(f"column mismatch: missing={missing} extra={extra}")
        n_rows = None
        validated: Dict[str, np.ndarray] = {}
        for cname, ctype in schema.columns.items():
            v = ctype.validate(columns[cname])
            if n_rows is None:
                n_rows = len(v)
            elif len(v) != n_rows:
                raise SchemaError(
                    f"column {cname} has {len(v)} rows, expected {n_rows}"
                )
            validated[cname] = v
        if not n_rows:
            raise SchemaError("an insert needs at least one row")
        capacity = segment_capacity(n_rows, alignment)
        bf16_store = storage_dtype == torch.bfloat16

        vectors: Dict[str, VectorPayload] = {}
        scalars: Dict[str, np.ndarray] = {}
        spilled = set()
        for cname, ctype in schema.columns.items():
            v = validated[cname]
            if isinstance(ctype, BinaryVector):
                buf = np.zeros((capacity, ctype.nbytes), dtype=np.uint8)
                buf[:n_rows] = v
                # no per-row popcounts: the binary kernel counts every bit it needs
                vectors[cname] = upload_payload(
                    cname, torch.from_numpy(buf), {}, device, server_settings
                )
                continue
            if not isinstance(ctype, FloatVector):
                scalars[cname] = v
                continue
            dpad = _pad_dim(ctype.dim)
            if storage_tier == "host":
                # the raw f32 rows, written straight into their host buffer
                buf = torch.empty(
                    (capacity, dpad), dtype=torch.float32, pin_memory=device.type == "cuda"
                )
                buf[:n_rows, : ctype.dim] = torch.from_numpy(v)
                buf[:n_rows, ctype.dim :] = 0.0
                buf[n_rows:] = 0.0
                vectors[cname] = host_payload(buf, *payload_norms(buf.numpy()), device)
                continue
            buf = np.zeros((capacity, dpad), dtype=np.float32)
            buf[:n_rows, : ctype.dim] = v
            # the norms come from the STORED values (what scans score
            # against), so scores and distances are exact w.r.t. stored
            # data. torch's f32 -> bf16 cast rounds to nearest even, as
            # ml_dtypes does in the JAX package.
            codes = torch.from_numpy(buf).to(storage_dtype)
            stored = codes.to(torch.float32).numpy() if bf16_store else buf
            sq, inv = payload_norms(stored)
            payload = upload_payload(
                cname, codes, {"sqnorm": sq, "invnorm": inv}, device, server_settings
            )
            if payload.is_host:  # spilled under memory pressure
                spilled.add(cname)
            vectors[cname] = payload
        seg = cls(
            segment_id,
            schema,
            n_rows,
            capacity,
            vectors,
            scalars,
            device=device,
            storage_dtype=storage_dtype,
        )
        seg.spilled_columns = spilled
        # exact (pre-quantization) float rows for column READS: SELECTing
        # a vector column returns what was inserted, independent of the
        # bf16 scoring payload. A host-tier column keeps no second copy:
        # requested-host rows are the raw f32 already, and a spilled
        # column reads back its bf16-rounded values, as in the JAX package
        if bf16_store:
            for cname, ctype in schema.columns.items():
                if isinstance(ctype, FloatVector) and not vectors[cname].is_host:
                    seg._exact_f32[cname] = np.asarray(validated[cname], dtype=np.float32)
        return seg

    # --------------------------------------------------------------- access
    def vector(self, column: str) -> VectorPayload:
        if column not in self.vectors:
            raise SchemaError(f"segment has no vector column {column}")
        return self.vectors[column]

    def scalar(self, column: str) -> np.ndarray:
        if column not in self.scalars:
            raise SchemaError(f"segment has no scalar column {column}")
        return self.scalars[column]

    def vector_rows(self, column: str, rows: np.ndarray) -> np.ndarray:
        """Exact float rows of a vector column for output (SELECT vector).
        Prefers the retained pre-quantization copy; otherwise reads the
        stored payload."""
        exact = self._exact_f32.get(column)
        if exact is not None:
            return exact[rows]
        payload = self.vector(column)
        dim = self.schema.columns[column].dim
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=payload.data.device)
        return payload.data[idx].to(torch.float32).cpu().numpy()[:, :dim]

    def scalar_minmax(self, column: str):
        """(min, max) over the segment's rows for a NUMERIC scalar column;
        None for string columns. Cached per mutation generation."""
        col = self.scalar(column)
        if col.dtype == object:
            return None
        with self._lock:
            hit = self._minmax_cache.get(column)
            if hit is not None and hit[0] == self.mutation_generation:
                return hit[1]
        live = col[: self.n_rows]
        mm = (live.min(), live.max()) if len(live) else None
        with self._lock:
            self._minmax_cache[column] = (self.mutation_generation, mm)
        return mm

    def scalar_device(self, column: str) -> Optional[torch.Tensor]:
        """Device mirror of a NUMERIC scalar column, [capacity] (zero pad),
        for predicate lowering. Integer columns mirror as int32 (only when
        their values fit, as in the JAX package), float32 as-is;
        strings/Float64/oversized ints return None (host path). Cached per
        mutation generation."""
        col = self.scalar(column)
        if col.dtype == object or col.dtype == np.float64:
            return None
        with self._lock:
            hit = self._scalar_dev_cache.get(column)
            if hit is not None and hit[0] == self.mutation_generation:
                return hit[1]
        dev = None
        if np.issubdtype(col.dtype, np.integer):
            mm = self.scalar_minmax(column)
            if mm is not None and int(mm[0]) >= -(2**31) and int(mm[1]) < 2**31:
                buf = np.zeros(self.capacity, np.int32)
                buf[: self.n_rows] = col[: self.n_rows].astype(np.int64)
                dev = torch.from_numpy(buf).to(self.device)
        else:
            buf = np.zeros(self.capacity, np.float32)
            buf[: self.n_rows] = col[: self.n_rows]
            dev = torch.from_numpy(buf).to(self.device)
        with self._lock:
            self._scalar_dev_cache[column] = (self.mutation_generation, dev)
        return dev

    # --------------------------------------------------------------- delete
    def delete_rows(self, row_ids: np.ndarray) -> int:
        """Mark rows deleted (lightweight DELETE). Returns #newly deleted."""
        with self._lock:
            row_ids = np.asarray(row_ids, dtype=np.int64)
            ok = (row_ids >= 0) & (row_ids < self.n_rows)
            row_ids = np.unique(row_ids[ok])
            fresh = row_ids[~self._deleted_host[row_ids]]
            self._deleted_host[fresh] = True
            self._deleted_dev = None
            self.mutation_generation += 1
            self._n_deleted += len(fresh)
            return len(fresh)

    @property
    def num_deleted(self) -> int:
        return self._n_deleted

    @property
    def num_live(self) -> int:
        return self.n_rows - self.num_deleted

    def deleted_host(self) -> np.ndarray:
        return self._deleted_host

    def alive_mask_device(self) -> Optional[torch.Tensor]:
        """bool[capacity] True = searchable; None when nothing is deleted
        (the common case — avoids building a mask at all)."""
        with self._lock:
            if not self._n_deleted:
                return None
            if self._deleted_dev is None:
                self._deleted_dev = torch.from_numpy(~self._deleted_host).to(self.device)
            return self._deleted_dev

    @property
    def device_bytes(self) -> int:
        """Bytes of the vector payloads, on the device or, for the host
        tier, in host memory (system.parts)."""
        return sum(p.nbytes for p in self.vectors.values())

    def __repr__(self):
        return (
            f"Segment(id={self.segment_id}, rows={self.n_rows}/{self.capacity}, "
            f"deleted={self.num_deleted}, device={self.device})"
        )
