"""Weighted LRU cache for loaded index objects.

A copy of myscaledb_tpu/cache/lru.py (it has no device code), except that
`on_evict` is called after the cache's lock is released: an eviction
calls back into the owning table, whose lock a search may hold while it
touches the cache. The VICacheManager analogue (src/VectorIndex/Cache/VICacheManager.h:83):
process-wide LRU keyed by (table uuid, segment, index name), weight =
index device-memory bytes, capacity derived from
vector_index_cache_size_ratio_of_memory (Server.cpp:1312-1323). Eviction
drops the device arrays; the index reloads lazily from its persisted files
on next use (loadVectorIndexFromLocalFile analogue).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Hashable, Optional, Tuple


class LRUCache:
    def __init__(self, capacity_bytes: int, on_evict: Optional[Callable] = None):
        self.capacity_bytes = max(int(capacity_bytes), 0)
        self._items: "collections.OrderedDict[Hashable, Tuple[Any, int]]" = (
            collections.OrderedDict()
        )
        self._weight = 0
        self._lock = threading.RLock()
        self._on_evict = on_evict
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            item = self._items.get(key)
            if item is None:
                self.misses += 1
                return None
            self._items.move_to_end(key)
            self.hits += 1
            return item[0]

    def put(self, key: Hashable, value: Any, weight: int) -> None:
        weight = max(int(weight), 1)
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._weight -= old[1]
            self._items[key] = (value, weight)
            self._weight += weight
            evicted = self._evict_locked()
        self._notify(evicted)

    def force_expire(self, key: Hashable) -> bool:
        """VICacheManager::forceExpire analogue (drop one entry)."""
        with self._lock:
            old = self._items.pop(key, None)
            if old is None:
                return False
            self._weight -= old[1]
        self._notify([(key, old[0])])
        return True

    def expire_prefix(self, prefix: Tuple) -> int:
        """Drop all entries whose tuple key starts with `prefix` (e.g. all
        indexes of a dropped table/segment)."""
        with self._lock:
            keys = [
                k
                for k in self._items
                if isinstance(k, tuple) and k[: len(prefix)] == prefix
            ]
        n = 0
        for k in keys:
            n += bool(self.force_expire(k))
        return n

    def shrink_by(self, free_bytes: int) -> int:
        """Evict LRU entries until at least `free_bytes` of weight is
        released (or the cache is empty). Returns bytes freed — the
        make-room-for-a-build path of the reference's memory governor."""
        freed = 0
        evicted = []
        with self._lock:
            while freed < free_bytes and self._items:
                key, (value, weight) = self._items.popitem(last=False)
                self._weight -= weight
                freed += weight
                self.evictions += 1
                evicted.append((key, value))
        self._notify(evicted)
        return freed

    def _evict_locked(self):
        """Pop LRU entries past the capacity (keeping the newest); returns
        them for `_notify` once the lock is released."""
        evicted = []
        while self._weight > self.capacity_bytes and len(self._items) > 1:
            key, (value, weight) = self._items.popitem(last=False)
            self._weight -= weight
            self.evictions += 1
            evicted.append((key, value))
        return evicted

    def _notify(self, evicted) -> None:
        if self._on_evict:
            for key, value in evicted:
                self._on_evict(key, value)

    @property
    def weight_bytes(self) -> int:
        with self._lock:
            return self._weight

    def items(self):
        """getAllItems analogue — snapshot of (key, value, weight)."""
        with self._lock:
            return [(k, v, w) for k, (v, w) in self._items.items()]

    def __len__(self):
        with self._lock:
            return len(self._items)
