"""Replicated index builds: one replica builds, the others fetch.

Reference semantics (SURVEY.md §2.1/§5): with
build_vector_index_on_random_single_replica (MergeTreeSettings.h:189), a
deterministic hash over the (zk path, part) picks the building replica
(ReplicatedMergeTreeBuildVIStrategyPicker.cpp); other replicas fetch the
built .vidx3 files over HTTP (DataPartsExchange.cpp:127-217, with status
cookies + retry-by-rebuild on failure).

TPU-native mapping: replicas are Database processes sharing a durable
store (the checkpoint directory plays the part-exchange channel — on a
pod this is the shared filesystem / object store). The picker is the same
deterministic hash; fetching = loading the builder's persisted index
files; a fetch that never materializes falls back to a local build (the
reference's failure path).

A copy of myscaledb_tpu/service/replication.py (device-free). In the port
the fetched index loads onto the fetching table's own device, on a
scheduler thread that enters that device first (storage/table.py).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Optional


def pick_build_replica(
    table: str, segment_id: int, index_name: str, n_replicas: int
) -> int:
    """Deterministic builder choice — same on every replica (the
    BuildVIStrategyPicker hash)."""
    h = hashlib.sha256(f"{table}/{segment_id}/{index_name}".encode()).digest()
    return int.from_bytes(h[:4], "big") % max(n_replicas, 1)


class ReplicaContext:
    """Attached to a Table when it participates in a replica set."""

    def __init__(
        self,
        replica_id: int,
        n_replicas: int,
        *,
        fetch_timeout_s: float = 60.0,
        poll_interval_s: float = 0.1,
        peers=None,
    ):
        if not (0 <= replica_id < n_replicas):
            raise ValueError(f"replica_id {replica_id} out of range 0..{n_replicas-1}")
        self.replica_id = replica_id
        self.n_replicas = n_replicas
        self.fetch_timeout_s = fetch_timeout_s
        self.poll_interval_s = poll_interval_s
        # peers[replica_id] -> IndexExchangeServer base URL (or None).
        # When set, index fetch goes over HTTP (the DataPartsExchange
        # network path, service/exchange.py) instead of shared-dir polling.
        self.peers = list(peers) if peers is not None else None

    def i_build(self, table: str, segment_id: int, index_name: str) -> bool:
        return (
            pick_build_replica(table, segment_id, index_name, self.n_replicas)
            == self.replica_id
        )


def index_dir(storage_dir: str, segment_id: int, index_name: str) -> str:
    return os.path.join(storage_dir, f"segment_{segment_id}", f"index_{index_name}")


def wait_for_peer_index(
    storage_dir: str,
    segment_id: int,
    index_name: str,
    ctx: ReplicaContext,
) -> Optional[str]:
    """Poll the shared store for the builder's persisted index (the fetch).
    Returns the index dir, or None on timeout (caller rebuilds locally)."""
    path = index_dir(storage_dir, segment_id, index_name)
    deadline = time.time() + ctx.fetch_timeout_s
    while time.time() < deadline:
        # checksums.json is written last — its presence marks a complete set
        if os.path.exists(os.path.join(path, "checksums.json")):
            return path
        time.sleep(ctx.poll_interval_s)
    return None
