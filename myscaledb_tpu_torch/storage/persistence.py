"""Durable storage: segments + built indexes on disk, with checksums.

The reference persists indexes as `<index>-<component>.vidx3` files +
description + checksums inside the part directory (VICommon.h:55-62;
VIUtils.cpp:267-380 dumpCheckSums/getVectorIndexChecksums), and reloads
lazily into the LRU cache on restart (VIWithDataPart.cpp:1279
loadVectorIndexFromLocalFile). Layout here:

  <root>/<table>/
    schema.json                     table schema + settings fingerprint
    segment_<id>/
      columns.npz                   scalar + vector columns (unpadded)
      deletes.npy                   delete bitmap (present iff any)
      meta.json
      index_<name>/
        arrays.npz                  device arrays of the built index
        meta.json                   kind/metric/params
        checksums.json              sha256 per file — verified on load

Checksum mismatch -> PersistenceError (the reference's checksum guard).

The port's copy of myscaledb_tpu/storage/persistence.py, byte for byte in
the same format, so a checkpoint written by one package loads in the
other. numpy has no bfloat16 (and the port does not use ml_dtypes): a bf16
array is written as its uint16 bits under the key suffix `__bf16`, as the
JAX package writes it, and read back as those bits; the port's state
dicts carry bf16 fields as uint16 bits (and no other field as uint16), and
`convert.py`'s loaders view them as `torch.bfloat16`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..errors import PersistenceError
from ..index.base import IndexKind
from .schema import (
    BinaryVector,
    ColumnType,
    Float32,
    Float64,
    FloatVector,
    Int32,
    Int64,
    Schema,
    String,
    UInt64,
)

_TYPE_TAGS = {
    "UInt64": UInt64,
    "Int64": Int64,
    "Int32": Int32,
    "Float32": Float32,
    "Float64": Float64,
    "String": String,
}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_checksums(dirpath: str, names) -> None:
    sums = {n: _sha256(os.path.join(dirpath, n)) for n in names}
    with open(os.path.join(dirpath, "checksums.json"), "w") as f:
        json.dump(sums, f)


def _verify_checksums(dirpath: str) -> None:
    cpath = os.path.join(dirpath, "checksums.json")
    if not os.path.exists(cpath):
        raise PersistenceError(f"missing checksums in {dirpath}")
    with open(cpath) as f:
        sums = json.load(f)
    for name, want in sums.items():
        p = os.path.join(dirpath, name)
        if not os.path.exists(p):
            raise PersistenceError(f"missing file {p}")
        got = _sha256(p)
        if got != want:
            raise PersistenceError(f"checksum mismatch for {p}")


# ------------------------------------------------------------------ schema
def schema_to_json(schema: Schema) -> Dict[str, Any]:
    out = {}
    for name, t in schema.columns.items():
        if isinstance(t, FloatVector):
            out[name] = {"type": "FloatVector", "dim": t.dim}
        elif isinstance(t, BinaryVector):
            out[name] = {"type": "BinaryVector", "dim": t.dim}
        else:
            out[name] = {"type": t.name}
    return out


def schema_from_json(d: Dict[str, Any]) -> Schema:
    cols: Dict[str, ColumnType] = {}
    for name, spec in d.items():
        t = spec["type"]
        if t == "FloatVector":
            cols[name] = FloatVector(spec["dim"])
        elif t == "BinaryVector":
            cols[name] = BinaryVector(spec["dim"])
        elif t in _TYPE_TAGS:
            cols[name] = _TYPE_TAGS[t]()
        else:
            raise PersistenceError(f"unknown column type {t}")
    return Schema(cols)


# ----------------------------------------------------------------- segment
def save_segment(segment, dirpath: str) -> None:
    os.makedirs(dirpath, exist_ok=True)
    cols: Dict[str, np.ndarray] = {}
    for name, t in segment.schema.columns.items():
        if isinstance(t, FloatVector):
            # the stored payload as f32 (exact for bf16), unpadded
            data = segment.vector(name).data[: segment.n_rows, : t.dim]
            cols[name] = data.to(torch.float32).cpu().numpy()
        elif isinstance(t, BinaryVector):
            cols[name] = segment.vector(name).data[: segment.n_rows].cpu().numpy()
        else:
            col = segment.scalar(name)
            cols[name] = (
                col.astype(str) if col.dtype == object else col
            )
    # uncompressed npz: embedding payloads are near-incompressible, and
    # single-threaded zlib writes at ~3 MB/s — 100x slower than the disk.
    # np.load reads STORED and DEFLATED members identically, so older
    # compressed checkpoints keep loading (no format bump needed).
    np.savez(os.path.join(dirpath, "columns.npz"), **cols)
    names = ["columns.npz", "meta.json"]
    deleted = segment.deleted_host()[: segment.n_rows]
    if deleted.any():
        np.save(os.path.join(dirpath, "deletes.npy"), deleted)
        names.append("deletes.npy")
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(
            {"segment_id": segment.segment_id, "n_rows": segment.n_rows}, f
        )
    _write_checksums(dirpath, names)


def load_segment_columns(dirpath: str, schema: Schema):
    """-> (segment_id, columns dict, deleted bool[n] or None), verified."""
    _verify_checksums(dirpath)
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(dirpath, "columns.npz"), allow_pickle=False) as z:
        cols = {}
        for name, t in schema.columns.items():
            arr = z[name]
            if isinstance(t, String):
                arr = arr.astype(object)
            cols[name] = arr
    dpath = os.path.join(dirpath, "deletes.npy")
    deleted = np.load(dpath) if os.path.exists(dpath) else None
    return meta["segment_id"], cols, deleted


# ------------------------------------------------------------------- index
# On-disk index format version. Bump on layout changes; old dirs upgrade
# on load through the migration chain (convertIndexFileForUpgrade,
# VIWithDataPart.h:456) and are rewritten in the current format.
INDEX_FORMAT_VERSION = 2

# from_version -> fn(meta, arrays) -> (meta, arrays) migrated ONE step
_FORMAT_MIGRATIONS: Dict[int, Any] = {}


def register_format_migration(from_version: int, fn) -> None:
    _FORMAT_MIGRATIONS[from_version] = fn


def _migrate_v1(meta: Dict[str, Any], arrays: Dict[str, np.ndarray]):
    """v1 (round-1) -> v2. v1 wrote bfloat16 arrays straight into npz,
    which numpy stores as opaque void `|V2`. v2 stores them as uint16 views
    with a name tag; here the old void arrays are reinterpreted as the bf16
    bits (uint16) the port's state dicts carry."""
    fixed = {}
    for k, v in arrays.items():
        if v.dtype.kind == "V" and v.dtype.itemsize == 2:
            v = v.view(np.uint16)
        fixed[k] = v
    return meta, fixed


register_format_migration(1, _migrate_v1)

# npz cannot represent bfloat16; store as uint16 views under a tagged name
_BF16_TAG = "__bf16"


def _npz_encode(arrays: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A state dict's arrays for np.savez: bf16 bits (uint16, the only
    uint16 a port state dict holds) under the `__bf16` tag."""
    out = {}
    for k, v in arrays.items():
        if v is None:
            continue
        v = np.asarray(v)
        if v.dtype == np.uint16:
            out[k + _BF16_TAG] = v
        else:
            out[k] = v
    return out


def _npz_decode(z) -> Dict[str, np.ndarray]:
    """np.load's arrays by name; a `__bf16`-tagged array comes back as its
    uint16 bits under the untagged name."""
    out = {}
    for k in z.files:
        v = z[k]
        if k.endswith(_BF16_TAG):
            out[k[: -len(_BF16_TAG)]] = v.view(np.uint16)
        else:
            out[k] = v
    return out


def save_index(instance, dirpath: str) -> None:
    """Serialize an index ATOMICALLY: write into `<dir>.tmp`, fsync, then
    rename over the target (the reference's vector_tmp_* + move protocol,
    VIBuilderUpdater.cpp:541-554, TryMoveVIFiles). A crash leaves either
    the old dir, or a resumable tmp dir with checksums — never a torn mix."""
    import shutil

    tmp = dirpath.rstrip("/\\") + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    state = instance.state_dict()
    meta = dict(state["meta"])
    meta["format_version"] = INDEX_FORMAT_VERSION
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    names = ["meta.json"]
    arrays = state.get("arrays")
    if arrays:
        np.savez(  # uncompressed: see save_segment
            os.path.join(tmp, "arrays.npz"), **_npz_encode(arrays)
        )
        names.append("arrays.npz")
    _write_checksums(tmp, names)
    if os.path.isdir(dirpath):
        shutil.rmtree(dirpath)
    os.rename(tmp, dirpath)


def resume_tmp_index_dirs(segment_dir: str) -> int:
    """Finish interrupted index persists: a `index_*.tmp` dir with valid
    checksums and no final dir is moved into place (the resume-from-
    vector_tmp path, VIBuilderUpdater.cpp:541-551); invalid tmp dirs are
    discarded. Returns the number of resumed dirs."""
    import shutil

    n = 0
    if not os.path.isdir(segment_dir):
        return 0
    for name in os.listdir(segment_dir):
        if not name.endswith(".tmp") or not name.startswith("index_"):
            continue
        tmp = os.path.join(segment_dir, name)
        final = tmp[: -len(".tmp")]
        if os.path.isdir(final):
            shutil.rmtree(tmp)  # completed build superseded the tmp
            continue
        try:
            _verify_checksums(tmp)
            os.rename(tmp, final)
            n += 1
        except PersistenceError:
            shutil.rmtree(tmp)  # torn write: discard, rebuild normally
    return n


def load_index(dirpath: str, device, payload=None):
    """Rebuild a VectorIndex on `device` from disk (checksums verified; old
    formats migrated through the upgrade chain and rewritten in place),
    through `convert.index_from_state_dict`; a two-stage or BinaryFLAT
    index takes its segment's `payload`. Returns None for FLAT, which
    rebuilds from the segment payload."""
    from .convert import index_from_state_dict

    _verify_checksums(dirpath)
    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    apath = os.path.join(dirpath, "arrays.npz")
    arrays: Dict[str, np.ndarray] = {}
    if os.path.exists(apath):
        with np.load(apath, allow_pickle=False) as z:
            arrays = _npz_decode(z)
    version = int(meta.get("format_version", 1))
    if version > INDEX_FORMAT_VERSION:
        raise PersistenceError(
            f"index format v{version} is newer than this engine "
            f"(v{INDEX_FORMAT_VERSION}): {dirpath}"
        )
    upgraded = version < INDEX_FORMAT_VERSION
    while version < INDEX_FORMAT_VERSION:
        fn = _FORMAT_MIGRATIONS.get(version)
        if fn is None:
            raise PersistenceError(
                f"no migration from index format v{version}: {dirpath}"
            )
        meta, arrays = fn(dict(meta), dict(arrays))
        version += 1
    meta.pop("format_version", None)
    if IndexKind.parse(meta["kind"]) == IndexKind.FLAT:
        return None  # payload-backed: rebuilt from the segment
    inst = index_from_state_dict({"meta": meta, "arrays": arrays}, device, payload)
    if upgraded:
        save_index(inst, dirpath)  # rewrite in the current format
    return inst
