"""Vector index interfaces and descriptors.

Counterpart of myscaledb_tpu/index/base.py. Indexes are plain classes
holding tensors on their segment's device; there is no pytree
registration and no jit: `search`, the standalone entry point, runs
`search_t` as one program (search/program.py: a captured CUDA graph on
the card). Search results use max-is-better scores
(metrics.py); `mask` is the pre-filter ∩ delete bitmap (bool[capacity],
True = searchable) applied INSIDE the search, never after.
"""

from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..metrics import Metric
from ..search.filters import mask_argument, mask_spec, materialize_mask
from ..search.program import (
    Program,
    ProgramCache,
    normalize_device,
    pack_topk,
    tensors_key,
    unpack_topk,
)

# Search-time parameters as a hashable tuple of sorted (name, value) pairs.
ParamsKey = Tuple[Tuple[str, Any], ...]


def params_key(params: Optional[Dict[str, Any]]) -> ParamsKey:
    return tuple(sorted((params or {}).items()))


def split_dyn_nprobe(pkey: ParamsKey) -> Tuple[ParamsKey, Optional[int]]:
    """Bucket the `nprobe` entry of a params key to the next power of two.

    Returns (bucketed_pkey, actual_nprobe_or_None). An IVF search sizes its
    probe list and window budget from the bucket and masks the probes
    ranked at or past the actual value, as the JAX package's fused program
    does (it compiles one program per bucket). The bucket changes which
    windows a search reads, so the port keeps it: the same nprobe returns
    the JAX package's rows."""
    out = []
    actual = None
    for name, val in pkey:
        if name == "nprobe":
            try:
                actual = max(1, int(val))
            except (TypeError, ValueError):
                out.append((name, val))
                continue
            out.append((name, 1 << (actual - 1).bit_length()))
        else:
            out.append((name, val))
    return tuple(out), actual


def check_cancel(cancel_cb) -> None:
    """Raise IndexBuildCanceledError when the build's cancel callback
    fires. Index builds call this at chunk boundaries (the index->build(...,
    cancel_cb) contract of the reference library, VIWithDataPart.h:338)."""
    if cancel_cb is not None and cancel_cb():
        from ..errors import IndexBuildCanceledError

        raise IndexBuildCanceledError("index build canceled")


class IndexKind(enum.Enum):
    # Index types exercised by the reference tests (SURVEY.md §2.3).
    FLAT = "FLAT"
    IVFFLAT = "IVFFLAT"
    IVFPQ = "IVFPQ"
    IVFSQ = "IVFSQ"
    HNSWFLAT = "HNSWFLAT"
    HNSWPQ = "HNSWPQ"
    HNSWSQ = "HNSWSQ"
    MSTG = "MSTG"
    BINARYFLAT = "BinaryFLAT"
    BINARYMSTG = "BinaryMSTG"

    @classmethod
    def parse(cls, s: str) -> "IndexKind":
        key = s.strip().upper()
        aliases = {
            "DEFAULT": "MSTG",  # Search::getDefaultIndexType (VIDescriptions.cpp:41)
            "BINARYFLAT": "BinaryFLAT",
            "BINARYMSTG": "BinaryMSTG",
        }
        key = aliases.get(key, key)
        for k in cls:
            if k.value.upper() == key.upper():
                return k
        from ..errors import IndexParameterError

        raise IndexParameterError(f"unknown vector index type: {s!r}")


BINARY_KINDS = {IndexKind.BINARYFLAT, IndexKind.BINARYMSTG}


class IndexStatus(enum.Enum):
    """Per-(segment, column) index state machine (VIInfo.h:41-49)."""

    SMALL_PART = "Small"
    PENDING = "Pending"
    BUILDING = "InProgress"
    BUILT = "Built"
    LOADED = "Loaded"
    ERROR = "Error"


@dataclasses.dataclass
class IndexDescription:
    """DDL-level descriptor (the VIDescription analogue,
    src/VectorIndex/Storages/VIDescriptions.cpp:108-212)."""

    name: str
    column: str
    kind: IndexKind
    metric: Metric
    dim: int
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # verbatim DDL tail ("v1 vector TYPE IVFFLAT('ncentroids = 1')") —
    # surfaced as system.vector_indices.expr like the reference's
    # formatted VIDescription expression
    definition: str = ""
    # the user's TYPE spelling ("IVFFlat") — system.vector_indices.type
    # echoes it verbatim like the reference (00018_mqvs_drop_index)
    declared_type: str = ""

    def is_binary(self) -> bool:
        return self.kind in BINARY_KINDS


class VectorIndex(abc.ABC):
    """A built, device-resident index over one segment's vector column.

    Subclasses that can be built (`add_vector_index`) also define
    `build(payload, n_rows, *, metric, dim, params, settings, cancel_cb)`,
    `state_dict` and `from_state_dict(state, *, device)`."""

    kind: IndexKind
    metric: Metric
    dim: int
    n_rows: int

    @abc.abstractmethod
    def search_t(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        mask: Optional[torch.Tensor] = None,
        params: ParamsKey = (),
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k (scores f32[Q,k], row_ids int32[Q,k]); -inf/-1 padding.

        mask: bool[capacity] True = searchable (pre-filter ∩ deletes),
        applied inside selection.
        """

    # the standalone search's programs, made at its first call
    _programs: Optional[ProgramCache] = None

    def search(
        self,
        queries,
        k: int,
        *,
        params: Optional[Dict[str, Any]] = None,
        mask=None,
        programs: Optional[ProgramCache] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standalone entry point (the JAX package's jitted `search`):
        `search_t` as one program, keyed as the JAX package's
        `_jitted_index_search` is (k, the params, the queries' shape and
        type, the mask's kind) plus what a graph bakes in (the index's
        tensors). queries: [Q, D] on the index's device (or host data,
        uploaded); mask: None, a bool[capacity] bitmap, a DeviceMask or a
        WindowMask. `programs` is the cache to keep the program in (a
        table's; by default the index's own). Returns copies (scores
        f32[Q, k], rows int32[Q, k])."""
        k = int(k)
        pkey = params_key(params)
        device = _index_device(self)
        if isinstance(queries, torch.Tensor):
            on_device = normalize_device(queries.device) == device
            q = queries if on_device else queries.detach().cpu().numpy()
        else:
            q = np.ascontiguousarray(np.asarray(queries))
        m = materialize_mask(mask)
        ms = mask_spec(m)
        refs: List[torch.Tensor] = []
        key = ("index", signature(self, refs), k, pkey, tuple(q.shape), str(q.dtype), ms)
        if programs is None:
            if self._programs is None:
                self._programs = ProgramCache()
            programs = self._programs
        kind = None if ms is None else ms[0]

        def body(qb, masks, dyn):
            del dyn
            v, r = self.search_t(qb, k, mask=mask_argument(kind, masks[0]), params=pkey)
            return pack_topk(v, r)

        def make():
            qdtype = q.dtype if isinstance(q, torch.Tensor) else torch.from_numpy(q[:0]).dtype
            return Program(
                body, device=device, query=(tuple(q.shape), qdtype),
                masks=[None if ms is None else (ms[1], ms[2])], out_shape=(2, q.shape[0], k),
                label=label_of([self]), refs=refs,
            )

        prog = programs.get(key, make)
        return unpack_topk(prog.run(q, [None if m is None else m[1]]))

    @classmethod
    def estimate_build_bytes(cls, payload, n_rows: int, params=None) -> int:
        """Conservative device-memory estimate for building this index
        over `payload`, checked against the build budget before anything
        is allocated (VIBuildMemoryUsageHelper::checkBuildMemory analogue).
        Default: an f32 copy of the rows plus ~2 payload-sized transients.
        A host-tier payload never comes to the device whole: only a bounded
        training sample (<= 256k f32 rows) and the compressed codes (~1
        byte a dimension, twice for the transients) do, so its host bytes
        are not counted."""
        del params
        dpad = payload.data.shape[1]
        if getattr(payload, "is_host", False):
            return 4 * min(n_rows, 256 * 1024) * dpad + 2 * n_rows * dpad
        return 4 * n_rows * dpad + 2 * int(payload.nbytes)

    def prefer_exact_scan(self, nq: int, k: int, params, scan_bytes: int) -> bool:
        """Cost-based routing hook: True when the exact scan of
        `scan_bytes` bytes is modeled cheaper than searching this index for
        an nq-query batch. Default: never; graph indexes override it."""
        del nq, k, params, scan_bytes
        return False

    def supports_two_stage(self) -> bool:
        """Whether the index returns approximate candidates for an exact
        re-rank (supportTwoStageSearch, VIWithDataPart.cpp:128-133)."""
        return False

    def requires_two_stage(self) -> bool:
        """Whether every search must take the executor's two-stage path: a
        disk-mode index does (index/ivf.py: its re-rank rows live in host
        memory)."""
        return False

    def search_first_stage(
        self,
        queries: torch.Tensor,
        num_candidates: int,
        *,
        params: Optional[Dict[str, Any]] = None,
        mask=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Approximate candidates (scores, rows) for an exact re-rank."""
        raise NotImplementedError(f"{self.kind} has no first-stage search")

    def compute_scores_subset(self, queries: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
        """Exact scores of the given candidate rows (computeTopDistanceSubset)."""
        raise NotImplementedError(f"{self.kind} has no exact re-rank")

    @property
    def memory_bytes(self) -> int:
        """Device bytes held by the index's own tensors (the LRU cache
        weight, once there is a cache): every tensor attribute counted once
        by storage."""
        seen, total = set(), 0
        for v in vars(self).values():
            if isinstance(v, torch.Tensor) and v.untyped_storage().data_ptr() not in seen:
                seen.add(v.untyped_storage().data_ptr())
                total += v.numel() * v.element_size()
        return total


# ------------------------------------------------------------ program keys
def _sig_value(v, refs: List[torch.Tensor]):
    if isinstance(v, torch.Tensor):
        return tensors_key((v,), refs)[0]
    if isinstance(v, VectorIndex):
        return signature(v, refs)
    if isinstance(v, (tuple, list)):
        return tuple(_sig_value(x, refs) for x in v)
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"a search program cannot key a {type(v).__name__} attribute")


def signature(searcher, refs: List[torch.Tensor]) -> tuple:
    """A searcher's part of a program key: its class, its static
    configuration and the pointer, shape, strides, type and device of
    every tensor it holds, a sub-index's included (attributes whose name
    starts with `_` are caches the body does not read). The tensors are
    appended to `refs`."""
    attrs = tuple(
        (name, _sig_value(v, refs))
        for name, v in sorted(vars(searcher).items())
        if not name.startswith("_")
    )
    return (type(searcher).__module__, type(searcher).__qualname__, attrs)


def _index_device(index) -> torch.device:
    """The device an index searches on: that of its first tensor off the
    host (a disk-mode index keeps host rows too), or its sub-indexes'."""
    for v in vars(index).values():
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            return normalize_device(v.device)
    for v in vars(index).values():
        for s in v if isinstance(v, (tuple, list)) else (v,):
            if hasattr(s, "search_t"):
                return _index_device(s)
    return torch.device("cpu")


def label_of(searchers) -> str:
    """The searchers' index kinds (class names where there is no kind),
    for messages."""
    names = []
    for s in searchers:
        kind = getattr(s, "kind", None)
        name = getattr(kind, "value", None) or type(s).__name__
        if name not in names:
            names.append(name)
    return ", ".join(names)
