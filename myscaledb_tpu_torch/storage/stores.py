"""Object-store cold tier for durable artifacts.

The reference stores parts (and their vector indexes) on S3/remote disks
through storage policies (`00036_mqvs_vector_index_s3.sh`; disk-backed
part storage under `src/Disks`). TPU-native layout keeps the LOCAL
directory tree as the warm cache and an object store as the cold tier:
`Table.persist()` writes locally then syncs the tree up; `Database.
load_table()` pulls the tree down when the local cache is cold.

Object stores have no atomic rename, so the commit protocol is
manifest-last: data objects are uploaded first, `<prefix>/MANIFEST.json`
last. A reader treats manifest presence as the commit point and verifies
every object against the manifest's sha256 — a torn upload is simply an
absent or stale manifest, never a torn tree (the role the reference's
vector_tmp_* + move protocol plays on POSIX disks).

Backends: MemoryStore (tests / fake S3), LocalStore (any mounted path:
NFS, fuse mounts), S3Store (boto3 when available; the client is
injectable so the protocol is testable without network egress).

A copy of myscaledb_tpu/storage/stores.py (it has no device code), so a
tree that one package synced up loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional

from ..errors import PersistenceError

MANIFEST = "MANIFEST.json"


class ObjectStore:
    """Minimal key->bytes protocol every backend implements."""

    scheme = "object"

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        for k in self.list_prefix(prefix):
            self.delete(k)


class MemoryStore(ObjectStore):
    """Dict-backed store — the test double for S3 (and a correctness
    reference for the manifest protocol)."""

    scheme = "mem"

    def __init__(self):
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key: str) -> bytes:
        with self._lock:
            if key not in self._objects:
                raise PersistenceError(f"no such object: {key}")
            return self._objects[key]

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def list_prefix(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)


class LocalStore(ObjectStore):
    """Files under a root path (covers NFS / fuse-mounted buckets)."""

    scheme = "file"

    def __init__(self, root: str):
        self.root = root

    def _path(self, key: str) -> str:
        root = os.path.normpath(self.root)
        p = os.path.normpath(os.path.join(root, key))
        # commonpath, not a string prefix: '/data/store-other' shares the
        # prefix '/data/store' but is NOT inside it
        if p != root and os.path.commonpath([p, root]) != root:
            raise PersistenceError(f"key escapes store root: {key}")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def get(self, key: str) -> bytes:
        p = self._path(key)
        if not os.path.isfile(p):
            raise PersistenceError(f"no such object: {key}")
        with open(p, "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def list_prefix(self, prefix: str) -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for name in files:
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix) and not rel.endswith(".tmp"):
                    out.append(rel)
        return sorted(out)

    def delete(self, key: str) -> None:
        p = self._path(key)
        if os.path.isfile(p):
            os.remove(p)


class S3Store(ObjectStore):
    """S3 bucket/prefix via boto3 (injectable client for tests — this
    image has no network egress, so the real client path is exercised
    only in deployments that ship boto3)."""

    scheme = "s3"

    def __init__(self, bucket: str, prefix: str = "", client=None):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        if client is None:
            try:
                import boto3  # type: ignore
            except ImportError as e:  # pragma: no cover
                raise PersistenceError(
                    "s3:// stores need boto3 (not bundled); pass an "
                    "explicit client or use file://"
                ) from e
            client = boto3.client("s3")  # pragma: no cover
        self.client = client

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def put(self, key: str, data: bytes) -> None:
        self.client.put_object(Bucket=self.bucket, Key=self._key(key), Body=data)

    def get(self, key: str) -> bytes:
        try:
            r = self.client.get_object(Bucket=self.bucket, Key=self._key(key))
        except Exception as e:
            raise PersistenceError(f"no such object: {key}") from e
        body = r["Body"]
        return body.read() if hasattr(body, "read") else bytes(body)

    def exists(self, key: str) -> bool:
        try:
            self.client.head_object(Bucket=self.bucket, Key=self._key(key))
            return True
        except Exception:
            return False

    def list_prefix(self, prefix: str) -> List[str]:
        full = self._key(prefix)
        out = []
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": full}
            if token:
                kw["ContinuationToken"] = token
            r = self.client.list_objects_v2(**kw)
            for obj in r.get("Contents", []):
                k = obj["Key"]
                if self.prefix:
                    k = k[len(self.prefix) + 1 :]
                out.append(k)
            if not r.get("IsTruncated"):
                return sorted(out)
            token = r.get("NextContinuationToken")

    def delete(self, key: str) -> None:
        self.client.delete_object(Bucket=self.bucket, Key=self._key(key))


def store_from_url(url: str) -> ObjectStore:
    """'mem://', 'file:///path', 's3://bucket[/prefix]'."""
    if url.startswith("mem://"):
        return MemoryStore()
    if url.startswith("file://"):
        return LocalStore(url[len("file://") :])
    if url.startswith("s3://"):
        rest = url[len("s3://") :]
        bucket, _, prefix = rest.partition("/")
        return S3Store(bucket, prefix)
    raise PersistenceError(f"unknown store url scheme: {url}")


# ------------------------------------------------------------------- sync
def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def read_manifest(store: ObjectStore, prefix: str) -> Optional[Dict[str, str]]:
    key = f"{prefix}/{MANIFEST}"
    if not store.exists(key):
        return None
    return json.loads(store.get(key).decode())


def sync_dir_to_store(store: ObjectStore, prefix: str, dirpath: str) -> Dict[str, str]:
    """Upload a local tree. Unchanged files (same sha as the previous
    manifest) are skipped; the manifest is written LAST (commit point).
    Objects no longer in the tree are deleted after the manifest commit —
    a reader that raced the sync still saw a consistent older tree."""
    prev = read_manifest(store, prefix) or {}
    manifest: Dict[str, str] = {}
    for walkdir, _dirs, files in os.walk(dirpath):
        for name in files:
            if name.endswith(".tmp"):
                continue
            p = os.path.join(walkdir, name)
            rel = os.path.relpath(p, dirpath).replace(os.sep, "/")
            sha = _sha256_file(p)
            manifest[rel] = sha
            if prev.get(rel) != sha:
                with open(p, "rb") as f:
                    store.put(f"{prefix}/{rel}", f.read())
    store.put(f"{prefix}/{MANIFEST}", json.dumps(manifest).encode())
    for rel in prev:
        if rel not in manifest:
            store.delete(f"{prefix}/{rel}")
    return manifest


def sync_dir_from_store(store: ObjectStore, prefix: str, dirpath: str) -> bool:
    """Materialize a committed tree into a local directory. Returns False
    when no manifest exists (nothing committed). Files already present
    with the right sha are kept; every downloaded object is verified
    against the manifest."""
    manifest = read_manifest(store, prefix)
    if manifest is None:
        return False
    for rel, sha in manifest.items():
        p = os.path.join(dirpath, rel.replace("/", os.sep))
        if os.path.isfile(p) and _sha256_file(p) == sha:
            continue
        data = store.get(f"{prefix}/{rel}")
        got = hashlib.sha256(data).hexdigest()
        if got != sha:
            raise PersistenceError(
                f"remote object {prefix}/{rel} sha mismatch "
                f"(manifest {sha[:12]}…, got {got[:12]}…)"
            )
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)
    return True
