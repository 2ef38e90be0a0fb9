"""Search programs: one captured CUDA graph a search.

The counterpart of `jax.jit`'s cache on the JAX package's search programs
(`_fused_multi_search`, `_jitted_index_search`). Where JAX compiles one
program per static key and runs it on every call, the port captures the
search's launches once into a CUDA graph and replays it: a search costs
the query upload, one copy per mask, one graph launch and one copy of the
outputs, however many kernels the body holds.

A `Program` is one cache entry. It owns static buffers: the query input
(filled through a pinned staging buffer; a text search's packed int32
plan, the fuse's tag maps), one buffer per mask (a device input copied
in: a mask, or a hybrid leg's packed result), the actual nprobe as a
device scalar, and the packed int32 output. The body reads
only those and the searchers' own tensors, which the entry keeps alive
(`refs`): a graph over a freed tensor would read whatever the allocator
put there next. A `ProgramCache` maps keys to entries, least recently
used first out past `MAX_PROGRAMS`. Beside them it keeps its callers'
plans: what a caller resolved before it built a program's key, kept under
a key of the caller's own, each tied to the program it runs (`keep_plan`).
Its owner drops it whenever a tensor a program reads may go: a table
holds one for all its searches and drops it, plans included, in one place
(storage/table.py); a standalone index search (`VectorIndex.search`) uses
one on the index, an fts store one of its own. This module knows no
index, filter or table: its callers build the keys (`tensors_key` for the
tensors a body reads), the bodies and the plans.

On a CUDA device the first run warms the body up on a side stream (the
kernels' build, their shared-memory opt-in and tensor-map entry point,
cuBLAS's handles), then captures it (`capture_error_mode="thread_local"`:
the server's dispatcher, background builds and SQL statements run on
other threads). A body that does not capture raises and names the index
kinds: there is no eager fallback on the card. On the CPU the same entry
runs the body eagerly through the same static buffers and output copy, so
a buffer-reuse fault shows in the CPU tests too.

Every entry of one device captures into that device's one memory pool,
so no two of its replays may overlap: a device's entries share one lock,
held from the input copy until the output copy is enqueued, and a run on
another stream than the last one waits for it first.

A run is a `program.run` span (service/tracing.py): the lock, the
capture on the first run, the launch (on the CPU the eager body) and the
output's copy, around a `program.load` span (the inputs). No span opens
inside a body, whose work on the card is the graph's. The amounts of
work a body knows from shapes (rows gathered, rows re-ranked) it counts
with `ops._cuda.count_work`: a capture records them and every replay adds
them with `SearchProgramReplays`, under one hold of the counters' lock; on
the CPU the eager body counts them on every run.

A `GridProgram` is one entry over several devices (the mesh's programs,
parallel/distributed.py): a `Program` a device, so no graph holds work of
two devices. Every part but the last runs first; the last, on the merging
device, takes each part's output as an input copied in after its own: a
copy between devices that torch orders behind the part's replay with
events on both streams, with no host wait.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops._cuda import add_launches, recording_launches
from ..service.event_log import GLOBAL_COUNTERS
from ..service.tracing import span

# Entries a cache holds; the least recently used one goes past it.
MAX_PROGRAMS = 64


class _DeviceState:
    """What every program of one device shares: the lock over runs, the
    graph memory pool, the capture and warm-up streams, and the stream and
    event of the last run. The pool lives as long as a graph captured into
    it does: `keeper`, a one-kernel graph made with the state, holds it,
    so that a table's dropping every program it had (and with them every
    other graph in the pool) does not retire the pool under the next
    capture."""

    def __init__(self, device: torch.device):
        self.lock = threading.RLock()
        self.last: Optional[Tuple[torch.cuda.Stream, torch.cuda.Event]] = None
        self.pool = self.capture_stream = self.warm_stream = self.keeper = None
        if device.type != "cuda":
            return
        with torch.cuda.device(device):
            self.capture_stream = torch.cuda.Stream(device)
            self.warm_stream = torch.cuda.Stream(device)
            self.renew_pool()

    def renew_pool(self) -> None:
        """A fresh pool and its keeper: at the start, and after a failed
        capture, whose pool may still be marked as recording (a second
        capture into it is refused); the graphs already in the old pool
        keep their memory and go on replaying."""
        device = self.capture_stream.device
        self.pool = torch.cuda.graph_pool_handle()
        self.keeper = capture(lambda: torch.zeros(1, device=device), self)


def capture(fn: Callable[[], object], st: "_DeviceState") -> "torch.cuda.CUDAGraph":
    """`fn`'s launches captured into a graph in the device's pool, on its
    capture stream, in thread-local mode. torch.cuda.graph's context would
    leave the capture stream current and the pool's routing open when the
    capture fails; here the caller's stream comes back, and the routing
    ends, whatever happens."""
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK, torch.cuda.stream(st.capture_stream):
        graph.capture_begin(pool=st.pool, capture_error_mode="thread_local")
        try:
            fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture is invalid already: the body's error is the one to raise
            _end_routing(st)
            raise
        try:
            graph.capture_end()
        except RuntimeError:
            _end_routing(st)
            raise
    return graph


def _end_routing(st: "_DeviceState") -> None:
    """Stop routing the capture stream's allocations to the pool after a
    failed capture (a capture_end that raised may have left it open)."""
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is None:
        return  # this torch has no such call: renew_pool covers it
    try:
        end(st.capture_stream.device.index, st.pool)
    except RuntimeError:
        pass  # capture_end had ended it


_DEVICES: Dict[torch.device, _DeviceState] = {}
_DEVICES_LOCK = threading.Lock()
# one capture at a time in a process (torch.cuda.graph's own rule)
_CAPTURE_LOCK = threading.Lock()


def _device_state(device: torch.device) -> _DeviceState:
    with _DEVICES_LOCK:
        st = _DEVICES.get(device)
        if st is None:
            st = _DEVICES[device] = _DeviceState(device)
        return st


def normalize_device(device) -> torch.device:
    """`cuda` means the current card: the key of a device's state."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Program:
    """One search program: `body(q, masks, dyn)` over static inputs, its
    packed int32 output copied out on every run.

    q: the query buffer, `query` = (shape, dtype); masks: one buffer per
    entry of `masks` ((shape, dtype), or None for an unmasked searcher);
    dyn: a 0-d int64 device scalar when `dyn` is set, else None. The body
    returns an int32 tensor of `out_shape`."""

    def __init__(
        self,
        body: Callable[[torch.Tensor, List[Optional[torch.Tensor]], Optional[torch.Tensor]],
                       torch.Tensor],
        *,
        device,
        query: Tuple[Tuple[int, ...], torch.dtype],
        masks: Sequence[Optional[Tuple[Tuple[int, ...], torch.dtype]]] = (),
        dyn: bool = False,
        out_shape: Tuple[int, ...],
        label: str,
        refs: Sequence[torch.Tensor] = (),
    ):
        self.device = normalize_device(device)
        self.body = body
        self.label = label
        self.refs = tuple(refs)  # every tensor the body reads besides the buffers
        cuda = self.device.type == "cuda"
        foreign = [t for t in self.refs if normalize_device(t.device) != self.device]
        if cuda and foreign:
            raise ValueError(
                f"a search program over {label} cannot capture tensors of another device "
                f"({foreign[0].device}); host-tier reads stream outside the graphs"
            )
        shape, dtype = query
        self.q = torch.zeros(shape, dtype=dtype, device=self.device)
        self.masks: List[Optional[torch.Tensor]] = [
            None if m is None else torch.zeros(m[0], dtype=m[1], device=self.device) for m in masks
        ]
        self.dyn = torch.zeros((), dtype=torch.int64, device=self.device) if dyn else None
        self.out = torch.zeros(out_shape, dtype=torch.int32, device=self.device)
        self._state = _device_state(self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: tuple = ()  # the kernel launches the capture recorded
        # the counters a replay adds under one hold of their lock (the
        # capture's `replay_counts`)
        self.replay_counts: tuple = ((), ())
        self.runs = 0
        # the pinned staging buffer of a host query (made at its first use)
        # and the event of its last copy: the next write waits for it
        self._stage: Optional[torch.Tensor] = None
        self._stage_done: Optional[torch.cuda.Event] = None

    @property
    def lock(self):
        return self._state.lock

    # ------------------------------------------------------------ inputs
    def _load(self, queries, masks, dyn) -> None:
        if isinstance(queries, np.ndarray):
            n = queries.shape[0]
            if self.device.type != "cuda":  # straight into the buffer
                self.q[:n].copy_(torch.from_numpy(queries))
                self.q[n:].zero_()
            else:
                if self._stage is None:
                    self._stage = torch.zeros(self.q.shape, dtype=self.q.dtype, pin_memory=True)
                    self._stage_done = torch.cuda.Event()
                self._stage_done.synchronize()
                host = self._stage.numpy()
                host[:n] = queries
                host[n:] = 0
                self.q.copy_(self._stage, non_blocking=True)
                self._stage_done.record(torch.cuda.current_stream(self.device))
        else:
            self.q.copy_(queries)
        if len(masks) != len(self.masks):
            raise ValueError(f"the program takes {len(self.masks)} masks, got {len(masks)}")
        for buf, m in zip(self.masks, masks):
            if (buf is None) != (m is None):
                raise ValueError("a mask does not match the program's mask layout")
            if buf is not None:
                buf.copy_(m)
        if (self.dyn is None) != (dyn is None):
            raise ValueError("the actual nprobe does not match the program")
        if self.dyn is not None:
            self.dyn.fill_(int(dyn))

    def _call_body(self) -> torch.Tensor:
        return self.body(self.q, self.masks, self.dyn)

    # --------------------------------------------------------------- run
    def run(self, queries, masks: Sequence[Optional[torch.Tensor]] = (), dyn=None) -> torch.Tensor:
        """Load the inputs, run the program, return a copy of its output
        (the next run overwrites the static one). `queries`: a host numpy
        array of at most the query buffer's rows (the rest are zeroed), or
        a tensor of its shape."""
        st = self._state
        with span("program.run"), st.lock:
            if self.device.type != "cuda":
                with span("program.load"):
                    self._load(queries, masks, dyn)
                if self.runs == 0:
                    GLOBAL_COUNTERS.bump("SearchProgramCaptures")
                self.out.copy_(self._call_body())
                self.runs += 1
                GLOBAL_COUNTERS.bump("SearchProgramReplays")
                return self.out.clone()
            with torch.cuda.device(self.device):
                stream = torch.cuda.current_stream(self.device)
                if st.last is not None and st.last[0] != stream:
                    stream.wait_event(st.last[1])
                with span("program.load"):
                    self._load(queries, masks, dyn)
                if self.graph is None:
                    self._capture(stream)
                self.graph.replay()
                add_launches(self.launches)
                self.runs += 1
                GLOBAL_COUNTERS.bump_many(*self.replay_counts)
                out = self.out.clone()
                done = torch.cuda.Event()
                done.record(stream)
                st.last = (stream, done)
                return out

    def _capture(self, stream) -> None:
        """Warm the body up on a side stream, then capture it into the
        device's pool. The warm-up's launches are recorded and dropped
        (counted in SearchProgramWarmupLaunches): they serve no search."""
        st = self._state
        st.warm_stream.wait_stream(stream)
        with torch.cuda.stream(st.warm_stream), recording_launches() as warm:
            self._call_body()
        stream.wait_stream(st.warm_stream)
        GLOBAL_COUNTERS.bump("SearchProgramWarmupLaunches", len(warm))
        with recording_launches() as record:
            try:
                graph = capture(lambda: self.out.copy_(self._call_body()), st)
            except RuntimeError as e:
                st.renew_pool()
                raise RuntimeError(
                    f"the search program over {self.label} failed to capture: {e}"
                ) from e
        self.graph = graph
        self.launches = tuple(record)
        self.replay_counts = replay_counts(record)
        GLOBAL_COUNTERS.bump("SearchProgramCaptures")


def replay_counts(record) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(names, counts) that one replay of a capture adds to the profile
    events: `SearchProgramReplays` 1, and each work amount the capture's
    `LaunchRecord` holds (`ops._cuda.count_work`), summed by name."""
    counts = {"SearchProgramReplays": 1}
    for name, amount in record.work:
        counts[name] = counts.get(name, 0) + amount
    return tuple(counts), tuple(counts.values())


class GridProgram:
    """`parts`: one Program a device, the merging device's last. Each part
    but the last returns its static output's copy; the last part's inputs
    are its own, then those copies in part order. Returns the last part's
    output."""

    def __init__(self, parts: Sequence[Program]):
        self.parts = list(parts)

    def run(self, queries, inputs: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
        """`queries`: every part's query input (each device gets its own
        copy); `inputs[i]`: part i's own copied-in inputs."""
        outs = [p.run(queries, ins) for p, ins in zip(self.parts[:-1], inputs)]
        return self.parts[-1].run(queries, [*inputs[-1], *outs])


class ProgramCache:
    """Key -> Program, bounded by `cap` (least recently used out first),
    and beside them key -> plan, bounded by `cap` the same way. A plan is
    whatever a caller keeps to skip its own planning; it runs one program
    of the cache, and goes when that program goes. `version` counts
    `invalidate` calls: the owner's generation. No entry is older than the
    last `invalidate` (see `get`), so no key carries the generation."""

    def __init__(self, cap: int = MAX_PROGRAMS):
        self.cap = cap
        self.version = 0
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Hashable, Program]" = collections.OrderedDict()
        # plan key -> (plan, the key of the program it runs)
        self._plans: "collections.OrderedDict[Hashable, Tuple[object, Hashable]]" = (
            collections.OrderedDict())

    def get(self, key: Hashable, make: Callable[[], Program],
            version: Optional[int] = None) -> Program:
        """The program of `key`, made on a miss. A program made for an
        older `version` than the cache's (an invalidation landed while the
        search was being planned) runs once and is not kept."""
        with self._lock:
            prog = self._entries.get(key)
            if prog is not None:
                self._entries.move_to_end(key)
                return prog
            prog = make()
            if version is not None and version != self.version:
                return prog
            self._entries[key] = prog
            while len(self._entries) > self.cap:
                old, _ = self._entries.popitem(last=False)
                for gone in [p for p, (_, pk) in self._plans.items() if pk == old]:
                    del self._plans[gone]
                GLOBAL_COUNTERS.bump("SearchProgramEvictions")
            return prog

    def plan(self, key: Hashable):
        """The plan kept under `key`, or None. A hit makes it and its
        program the most recently used."""
        with self._lock:
            found = self._plans.get(key)
            if found is None:
                return None
            self._plans.move_to_end(key)
            self._entries.move_to_end(found[1])
            return found[0]

    def keep_plan(self, key: Hashable, plan, program_key: Hashable, program: Program,
                  version: int) -> None:
        """Keep `plan`, which runs `program` (kept under `program_key`),
        under `key`: not where an invalidation landed after `version` was
        read or the program is not the one kept (a plan over it would
        outlive the drop)."""
        with self._lock:
            if version != self.version or self._entries.get(program_key) is not program:
                return
            self._plans[key] = (plan, program_key)
            self._plans.move_to_end(key)
            while len(self._plans) > self.cap:
                self._plans.popitem(last=False)

    def invalidate(self) -> None:
        """Drop every program and plan (and with them the tensors they
        hold) and move the version on."""
        with self._lock:
            self.version += 1
            self._entries.clear()
            self._plans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def programs(self) -> List[Program]:
        with self._lock:
            return list(self._entries.values())


# --------------------------------------------------------------- keys
def tensors_key(tensors: Sequence[torch.Tensor], refs: List[torch.Tensor]) -> tuple:
    """The key part of tensors a body reads: what a graph bakes in of each
    (pointer, shape, strides, type, device). They are appended to `refs`,
    which the program keeps alive."""
    refs.extend(tensors)
    return tuple(
        ("tensor", t.data_ptr(), tuple(t.shape), tuple(t.stride()), str(t.dtype), str(t.device))
        for t in tensors
    )


# ------------------------------------------------------------ outputs
def pack_topk(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int32[2, Q, k]: the scores' bits and the rows, one buffer."""
    return torch.stack([vals.contiguous().view(torch.int32), rows.to(torch.int32)])


def unpack_topk(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return packed[0].view(torch.float32), packed[1]
