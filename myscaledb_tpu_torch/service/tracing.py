"""Span tracing for the search and build paths.

The reference wraps every stage in OpenTelemetry spans flowing into
system.opentelemetry_span_log (SURVEY.md §5: MergeTreeVSManager.cpp:261,
ReadWithHybridSearch.cpp:262, VIWithDataPart.h:306). Here a span is a
context manager, `with span("program.load"): ...`, around host code at a
layer boundary. A span:

- reads its start on entry: the wall clock for its row, the monotonic
  clock for its length;
- runs inside the span open on its thread and takes that span's trace
  id, or draws a new one at a root: a random prefix drawn once a process,
  then a counter;
- on exit, counts its self time (its length less the lengths of the
  spans opened directly inside it) in `GLOBAL_COUNTERS` as
  `<name>.self_us` (whole microseconds) and itself as `<name>.calls`:
  `system_table('profile_events')`, which the benchmark reads over its
  window;
- appends a row to a bounded ring, `system_table('span_log')`. A row is a
  tuple of scalars, which the garbage collector untracks, so a full
  collection does not walk the ring. The ring is kept in memory only:
  service/system_log.py persists the query and event logs, not this one;
- while torch.profiler records, opens a `record_function(name)` range as
  well: the span is then a `user_annotation` event of the trace, on the
  clock of the card's kernels. With the profiler off no range is opened.

With the profiler off a span costs three clock reads, one hold of the
counters' lock and a ring append: PERF.md gives the cost on an H100
machine's host. No span opens inside a search program's body
(search/program.py): a captured body runs once, at capture, so a span
there would count differently on the CPU, where the body runs on every
call, and the card.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
from time import perf_counter_ns, time
from typing import Any, Dict, List, Tuple

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from .event_log import GLOBAL_COUNTERS

_open = threading.local()  # .span: the innermost span open on this thread

# trace id = this process's random 32-bit prefix, then a 32-bit counter
_TRACE_PREFIX = int.from_bytes(os.urandom(4), "big") << 32
_trace_seq = itertools.count(1)
_span_seq = itertools.count(1)  # span ids; 0 is a root's parent_id

# name -> the profile events its spans add to: (`<name>.self_us`, `<name>.calls`)
_COUNTER_NAMES: Dict[str, Tuple[str, str]] = {}


class SpanLog:
    """The ring of finished spans: (trace id, span id, parent id, name,
    depth, wall-clock start, duration us, self us, error, then each
    attribute's name and value) tuples."""

    def __init__(self, max_spans: int = 100_000):
        # a deque's append, clear and copy are each one step under the
        # interpreter lock: no lock of its own
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self.record = self._spans.append  # record(row)

    def raw(self) -> List[tuple]:
        """The stored rows as they are kept."""
        return list(self._spans)

    def rows(self) -> List[Dict[str, Any]]:
        out = []
        for tid, sid, pid, name, depth, ts, dur, self_us, err, *attrs in self.raw():
            row = {"trace_id": f"{tid:016x}", "span_id": sid, "parent_id": pid, "span": name,
                   "depth": depth, "start_ts": ts, "duration_us": dur, "self_us": self_us,
                   "error": err}
            row.update(zip(attrs[::2], attrs[1::2]))
            out.append(row)
        return out

    def clear(self) -> None:
        self._spans.clear()


GLOBAL_SPAN_LOG = SpanLog()


class span:
    """`with span(name, **attrs) as s:` records one span of `name` (see the
    module docstring); attributes that are not None go into its row.
    `s.elapsed_ms()` reads its length so far on the monotonic clock."""

    __slots__ = ("name", "attrs", "parent", "trace_id", "span_id", "depth", "start_ts", "_t0",
                 "_child_ns", "_range")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        parent = self.parent = getattr(_open, "span", None)
        if parent is None:
            self.trace_id = _TRACE_PREFIX | (next(_trace_seq) & 0xFFFFFFFF)
            self.depth = 0
        else:
            self.trace_id = parent.trace_id
            self.depth = parent.depth + 1
        self.span_id = next(_span_seq)
        self._child_ns = 0
        _open.span = self
        self._range = record_function(self.name).__enter__() if _profiler_enabled() else None
        self.start_ts = time()
        self._t0 = perf_counter_ns()
        return self

    def elapsed_ms(self) -> float:
        return (perf_counter_ns() - self._t0) / 1e6

    def __exit__(self, etype, exc, tb) -> bool:
        dur = perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        parent = _open.span = self.parent
        if parent is not None:
            parent._child_ns += dur
        self_us = (dur - self._child_ns + 500) // 1000
        # a flat tuple of scalars, which the collector untracks in one pass
        row = (self.trace_id, self.span_id, 0 if parent is None else parent.span_id, self.name,
               self.depth, self.start_ts, (dur + 500) // 1000, self_us,
               "" if exc is None else f"{etype.__name__}: {exc}")
        if self.attrs:
            for k, v in self.attrs.items():
                if v is not None:
                    row += (k, v)
        names = _COUNTER_NAMES.get(self.name)
        if names is None:
            names = _COUNTER_NAMES[self.name] = (f"{self.name}.self_us", f"{self.name}.calls")
        GLOBAL_COUNTERS.bump_many(names, (self_us, 1))
        GLOBAL_SPAN_LOG.record(row)
        return False
