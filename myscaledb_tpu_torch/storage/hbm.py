"""Device-memory admission control for segment payloads.

Counterpart of myscaledb_tpu/storage/hbm.py. Every payload upload is
admitted against a budget first: the live device memory of a CUDA device
(`torch.cuda.mem_get_info`: in use + bytes must stay under ratio x
capacity), or an explicit byte budget tracked across live payloads (which
also works for the CPU device). A payload the budget refuses goes to the
host tier (storage/segment.py), and so does one whose upload runs out of
device memory twice (`guarded_put`: one retry after a collection), so the
engine absorbs memory pressure instead of dying on it.

Unlike the JAX package, admission and accounting are one step: `admit`
reserves the bytes under the lock, so two concurrent inserts cannot both
pass a check that only one of them fits (the JAX package's admit and
register are separate calls).
"""

from __future__ import annotations

import gc
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import torch


def device_memory_stats(device: torch.device) -> Optional[Tuple[int, int]]:
    """(bytes_in_use, bytes_total) of a CUDA device, or None for a device
    without memory stats (the CPU)."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return int(total - free), int(total)


class HbmGovernor:
    """Process-wide admission control for device payload uploads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tracked = 0  # bytes reserved by live payloads
        self._pending = 0  # bytes reserved but not yet allocated

    @property
    def tracked_bytes(self) -> int:
        with self._lock:
            return self._tracked

    def admit(self, nbytes: int, device: torch.device, server=None) -> bool:
        """Reserve `nbytes` for a payload on `device` if the budget allows.
        True means the bytes are now reserved: the caller must `register`
        the allocated payload, or `release` the bytes if the upload fails."""
        budget = getattr(server, "device_payload_budget_bytes", None)
        with self._lock:
            if budget is not None:
                ok = self._tracked + nbytes <= budget
            else:
                stats = device_memory_stats(device)
                if stats is None:
                    ok = True
                else:
                    in_use, cap = stats
                    ratio = getattr(server, "vector_storage_budget_ratio", 0.92) or 0.92
                    # reserved bytes not yet allocated are not in `in_use`
                    ok = in_use + self._pending + nbytes <= ratio * cap
            if ok:
                self._tracked += nbytes
                self._pending += nbytes
            return ok

    def release(self, nbytes: int) -> None:
        """Give back a reservation whose upload failed."""
        with self._lock:
            self._pending -= nbytes
            self._tracked -= nbytes

    def register(self, owner, nbytes: int) -> None:
        """The reserved payload is allocated: keep its bytes counted for
        `owner`'s lifetime (released when it is garbage collected, so table
        drops free budget without explicit hooks)."""
        with self._lock:
            self._pending -= nbytes
        weakref.finalize(owner, _release_ref, weakref.ref(self), nbytes)


def guarded_put(
    tensors: Sequence[torch.Tensor], device: torch.device
) -> Optional[List[torch.Tensor]]:
    """Move `tensors` to `device`, or return None after a retried device
    out-of-memory error: the first failure drops the partial copies,
    collects garbage and empties the allocator's cache, then tries once
    more. Any other error is raised."""
    for _ in range(2):
        try:
            return [t.to(device) for t in tensors]
        except torch.OutOfMemoryError:
            pass  # collect outside the handler: its traceback holds the partial copies
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return None


def _release_ref(governor_ref, nbytes: int) -> None:
    g = governor_ref()
    if g is not None:
        with g._lock:
            g._tracked -= nbytes


GOVERNOR = HbmGovernor()
