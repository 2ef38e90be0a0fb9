"""Carry a segment's or an index's state across from the JAX package.

`segment_from_arrays` builds the port's `Segment` over the same stored
bytes as a JAX segment, given its arrays as numpy. `hnsw_from_state_dict`,
`ivf_from_state_dict` and `binary_from_state_dict` build the port's HNSW,
IVF and binary indexes from a JAX index's `state_dict()`
(`index_from_state_dict` picks one by kind); `inverted_from_state_dict`
builds a segment's fts store from a JAX `InvertedIndex.state_dict()`;
`mesh_indexes_from_arrays` installs a JAX MeshTable's sharded IVF or
two-stage index on a port MeshTable that holds the same rows.
They let the port search exactly what the JAX package searches (the
parity tests use them), and are the route by which a segment or an index
built by one package serves in the other.

numpy has no bfloat16, so a bf16 payload crosses as raw bits: the caller
passes `np.asarray(x).view(np.uint16)` (or an array whose dtype is named
bfloat16, which is viewed so here), and the bits are reinterpreted with
`torch.Tensor.view(torch.bfloat16)`, not converted.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..errors import SchemaError
from ..index.base import IndexKind
from .schema import BinaryVector, Schema
from .segment import TIERS, Segment, host_payload, upload_payload


def _payload_codes(cname: str, data: np.ndarray) -> torch.Tensor:
    """The stored payload as a tensor over its own copy of the bytes (the
    source may be read-only, e.g. a view of a JAX array)."""
    if data.ndim != 2:
        raise SchemaError(f"payload of {cname!r} must be 2-D, got {data.shape}")
    if data.dtype == np.uint16:
        return torch.from_numpy(np.array(data)).view(torch.bfloat16)
    if data.dtype == np.float32:
        return torch.from_numpy(np.array(data))
    raise SchemaError(
        f"payload of {cname!r} must be float32 or bf16 bits as uint16, got {data.dtype}"
    )


def segment_from_arrays(
    segment_id: int,
    schema: Schema,
    *,
    n_rows: int,
    capacity: int,
    vectors: Dict[str, Dict[str, np.ndarray]],
    scalars: Dict[str, np.ndarray],
    device,
    deleted: Optional[np.ndarray] = None,
    server_settings=None,
) -> Segment:
    """Build a Segment on `device` from one segment's numpy arrays.

    vectors: column -> {"data": f32 or uint16 (bf16 bits) [capacity, D_pad],
             "sqnorm": f32[capacity], "invnorm": f32[capacity], and
             optionally "tier": "hbm" (the default) or "host"} for a float
             column, {"data": u8[capacity, dim/8]} for a binary one (a JAX
             segment's "popcnt" is not carried: no path of the port reads
             it). A JAX host-tier payload (numpy f32 rows) crosses with
             "tier": "host" and lands in the port's host tier; a payload the
             device budget refuses spills there, as an insert's does.
    scalars: column -> [n_rows] host column
    deleted: optional bool[capacity] delete bitmap (True = deleted)
    """
    device = torch.device(device)
    want_vec = set(schema.vector_columns())
    if set(vectors) != want_vec or set(scalars) != set(schema.columns) - want_vec:
        raise SchemaError("arrays do not match the schema's columns")
    payloads = {}
    spilled = set()
    dtypes = set()
    for cname, arrs in vectors.items():
        if isinstance(schema.columns[cname], BinaryVector):
            payloads[cname] = _binary_payload(
                cname, schema.columns[cname], arrs, capacity, device, server_settings
            )
            continue
        codes = _payload_codes(cname, arrs["data"])
        if codes.shape[0] != capacity:
            raise SchemaError(
                f"payload of {cname!r} has {codes.shape[0]} rows, capacity is {capacity}"
            )
        dtypes.add(codes.dtype)
        sq = np.array(arrs["sqnorm"], dtype=np.float32)
        inv = np.array(arrs["invnorm"], dtype=np.float32)
        if sq.shape != (capacity,) or inv.shape != (capacity,):
            raise SchemaError(f"norms of {cname!r} must be f32[{capacity}]")
        tier = arrs.get("tier", "hbm")
        if tier not in TIERS:
            raise SchemaError(f"unknown tier {tier!r} of {cname!r}")
        if tier == "host":
            payloads[cname] = host_payload(codes.to(torch.float32), sq, inv, device)
            continue
        payloads[cname] = upload_payload(
            cname, codes, {"sqnorm": sq, "invnorm": inv}, device, server_settings
        )
        if payloads[cname].is_host:  # spilled under memory pressure
            spilled.add(cname)
    for cname, col in scalars.items():
        if len(col) != n_rows:
            raise SchemaError(f"column {cname} has {len(col)} rows, expected {n_rows}")
    if len(dtypes) > 1:
        raise SchemaError("all vector payloads of a segment share one storage dtype")
    seg = Segment(
        segment_id,
        schema,
        n_rows,
        capacity,
        payloads,
        dict(scalars),
        device=device,
        storage_dtype=dtypes.pop() if dtypes else torch.bfloat16,
    )
    seg.spilled_columns = spilled
    if deleted is not None:
        deleted = np.asarray(deleted, dtype=bool)
        if deleted.shape != (capacity,):
            raise SchemaError(f"deleted bitmap must be bool[{capacity}]")
        rows = np.nonzero(deleted)[0]
        if len(rows):
            seg.delete_rows(rows)
    return seg


def _binary_payload(cname, ctype, arrs, capacity, device, server_settings):
    """A binary column's packed u8 payload."""
    data = np.array(arrs["data"], dtype=np.uint8)
    if data.shape != (capacity, ctype.nbytes):
        raise SchemaError(
            f"binary payload of {cname!r} must be u8[{capacity}, {ctype.nbytes}], got {data.shape}"
        )
    return upload_payload(cname, torch.from_numpy(data), {}, device, server_settings)


def _bf16_bits(arrays: Dict, field: str) -> Dict:
    """`arrays` with `field` viewed as uint16 when its dtype is named
    bfloat16 (numpy has no bf16; the bits cross, not the values)."""
    arrays = dict(arrays)
    v = arrays.get(field)
    if v is not None and np.asarray(v).dtype.name == "bfloat16":
        arrays[field] = np.asarray(v).view(np.uint16)
    return arrays


def hnsw_from_state_dict(state: Dict, device):
    """The port's HNSW index (HNSWFLAT, HNSWSQ or HNSWPQ) from a JAX HNSW
    index's `state_dict()`: {"meta": {kind, metric, dim, n_rows, m,
    ef_default, codec, storage_dtype}, "arrays": {field: numpy array}},
    every array moved to `device`. A bf16 payload crosses as its stored
    bits."""
    from ..index import hnsw

    classes = {
        IndexKind.HNSWFLAT.value: hnsw.HNSWFlatIndex,
        IndexKind.HNSWSQ.value: hnsw.HNSWSQIndex,
        IndexKind.HNSWPQ.value: hnsw.HNSWPQIndex,
    }
    kind = state["meta"]["kind"]
    if kind not in classes:
        raise ValueError(f"{kind!r} is not an HNSW index kind")
    return classes[kind].from_state_dict(
        {"meta": state["meta"], "arrays": _bf16_bits(state["arrays"], "data")},
        device=torch.device(device),
    )


def ivf_from_state_dict(state: Dict, device, payload=None):
    """The port's IVF index (IVFFLAT, IVFSQ, IVFPQ or MSTG) from a JAX IVF
    index's `state_dict()`: {"meta": {kind, metric, dim, n_rows,
    n_clusters, n_windows, wpp, codec, two_stage, rerank_multiple,
    storage_dtype}, "arrays": {field: numpy array}}, every array moved to
    `device`. A raw bf16 `perm_data` crosses as its stored bits. The state
    holds no payload: a two-stage index re-attaches `payload` (the
    segment's VectorPayload) when it is given, and raises on search until
    it has one. A disk-mode index (a JAX MSTG over a host-tier payload, or
    one built with disk_mode=1) re-attaches a host-tier payload as its
    host re-rank rows (`raw_host`)."""
    from ..index import ivf

    classes = {
        IndexKind.IVFFLAT.value: ivf.IVFFlatIndex,
        IndexKind.IVFSQ.value: ivf.IVFSQIndex,
        IndexKind.IVFPQ.value: ivf.IVFPQIndex,
        IndexKind.MSTG.value: ivf.MSTGIndex,
    }
    kind = state["meta"]["kind"]
    if kind not in classes:
        raise ValueError(f"{kind!r} is not an IVF index kind")
    idx = classes[kind].from_state_dict(
        {"meta": state["meta"], "arrays": _bf16_bits(state["arrays"], "perm_data")},
        device=torch.device(device),
    )
    if payload is not None:
        idx.reattach_payload(payload)
    return idx


def binary_from_state_dict(state: Dict, device, payload=None):
    """The port's binary index from a JAX binary index's `state_dict()`.
    BinaryMSTG: {"meta": {kind, metric, dim, n_rows, n_clusters,
    bucket_cap, n_overflow}, "arrays": {centroids, csq, bucket_data,
    bucket_rows, over_data, over_rows}}, moved to `device`. BinaryFLAT
    holds no arrays of its own: it is rebuilt over `payload` (the
    segment's VectorPayload), which it then needs."""
    from ..index import binary
    from ..metrics import Metric

    meta = state["meta"]
    kind = meta["kind"]
    if kind == IndexKind.BINARYMSTG.value:
        return binary.BinaryMSTGIndex.from_state_dict(state, device=torch.device(device))
    if kind == IndexKind.BINARYFLAT.value:
        if payload is None:
            raise ValueError("a BinaryFLAT index is rebuilt over its segment's payload")
        return binary.BinaryFlatIndex(
            payload.data, metric=Metric(meta["metric"]), dim=meta["dim"], n_rows=meta["n_rows"]
        )
    raise ValueError(f"{kind!r} is not a binary index kind")


def inverted_from_state_dict(state: Dict, device):
    """A segment's fts store (`text/inverted.py::InvertedIndex`) from a JAX
    `InvertedIndex.state_dict()`: {"meta": {capacity, n_rows,
    total_tokens, analyzer}, "arrays": {term_offsets, postings_rows,
    postings_tf, doc_len, terms, token_stream}}, the postings moved to
    `device`."""
    from ..text.inverted import InvertedIndex

    return InvertedIndex.from_state_dict(state, device=torch.device(device))


def index_from_state_dict(state: Dict, device, payload=None):
    """Any index kind the port can load, from its `state_dict()` (either
    package's layout)."""
    kind = state["meta"]["kind"]
    if kind.startswith("HNSW"):
        return hnsw_from_state_dict(state, device)
    if kind.startswith("Binary"):
        return binary_from_state_dict(state, device, payload)
    return ivf_from_state_dict(state, device, payload)


def _mesh_parts(mesh, arr):
    """A JAX [S, ...] per-shard stack (numpy; a bf16 array as its bits)
    as the port's list of [1, ...] parts, one on each shard's device."""
    from ..parallel.distributed import shard_rows

    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return [p.view(torch.bfloat16) for p in shard_rows(mesh, a.view(np.uint16))]
    return shard_rows(mesh, a)


def mesh_indexes_from_arrays(table, ivf=None, mstg=None) -> None:
    """Install a JAX MeshTable's index on the port MeshTable `table`,
    which must hold the same rows in the same slot layout (the same rows
    inserted in the same order over the same shard count, e.g. through
    `save` / `load`). `ivf` is the JAX table's `_ivf` tuple (centroids
    [S, C, D], csq, perm_data, perm_aux, perm_rows, cluster_start,
    bucket_pad), `mstg` its `_mstg` tuple (centroids, csq, lo, scale,
    codes, psq, perm_rows, cluster_start, bucket_pad), every array as
    numpy. Rows appended after the install are served by the delta scan,
    as after a build."""
    from ..parallel.distributed import replicate

    if (ivf is None) == (mstg is None):
        raise ValueError("pass exactly one of ivf= and mstg=")
    s = table._seal()
    rows = np.asarray((ivf if ivf is not None else mstg)[-3])  # perm_rows in both
    if rows.shape != (table.n_shards, s.cap):
        raise SchemaError(
            f"the index covers [shards, slots] {rows.shape}, the table "
            f"({table.n_shards}, {s.cap})"
        )
    mesh = table.mesh
    if ivf is not None:
        *arrays, bpad = ivf
        table._install_index(ivf=tuple(_mesh_parts(mesh, a) for a in arrays) + (int(bpad),))
    else:
        cents, csq, lo, scale, *arrays, bpad = mstg
        table._install_index(mstg=(
            _mesh_parts(mesh, cents), _mesh_parts(mesh, csq),
            replicate(mesh, np.asarray(lo, np.float32)),
            replicate(mesh, np.asarray(scale, np.float32)),
            *(_mesh_parts(mesh, a) for a in arrays), int(bpad),
        ))
