"""Background index-build pools.

The reference schedules builds on two dedicated executors — a fast pool and
a slow-mode pool for huge parts (Context.cpp:3900-3965,
BackgroundJobsAssignee.cpp:84-98; split at
max_rows_for_slow_mode_single_vector_index_build). A copy of
myscaledb_tpu/service/background.py: two small thread pools. A job that
launches device work sets its own device (storage/table.py wraps every
build in its table's `torch.device`); it launches on that device's
current stream, which a worker thread shares with the table's searches.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable, Optional


class _Pool:
    def __init__(self, name: str, n_threads: int):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            for i in range(max(1, n_threads))
        ]
        self._inflight = 0
        self._cv = threading.Condition()
        self._stopped = False
        for t in self._threads:
            t.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job()
            except Exception:  # jobs report their own errors; never kill the pool
                traceback.print_exc()
            finally:
                # let go of the job while waiting for the next one: its
                # closure may hold a dropped store or index
                job = None
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def submit(self, job: Callable[[], None]) -> None:
        with self._cv:
            if self._stopped:
                raise RuntimeError("pool stopped")
            self._inflight += 1
        self._q.put(job)

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(
                lambda: self._inflight == 0 and self._q.empty(), timeout
            )

    def shutdown(self):
        with self._cv:
            self._stopped = True
        for _ in self._threads:
            self._q.put(None)


class BuildScheduler:
    """Fast + slow-mode build pools (VITask / slow-mode VITask analogue)."""

    def __init__(self, n_fast: int = 1, n_slow: int = 1):
        self._fast = _Pool("vi-build", n_fast)
        self._slow = _Pool("vi-build-slow", n_slow)

    def submit(self, job: Callable[[], None], *, slow: bool = False) -> None:
        (self._slow if slow else self._fast).submit(job)

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        ok = self._fast.wait_idle(timeout)
        return self._slow.wait_idle(timeout) and ok

    def shutdown(self):
        self._fast.shutdown()
        self._slow.shutdown()
