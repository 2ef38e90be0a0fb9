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
used first out past `MAX_PROGRAMS`; each table owns one and drops it when
its segment set changes (storage/table.py), and one for its text searches
that its fts stores' changes drop too; a standalone index search
(`VectorIndex.search`) uses one on the index, an fts store one of its own.

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
inside a body, whose work on the card is the graph's.

A `GridProgram` is one entry over several devices (the mesh's programs,
parallel/distributed.py): a `Program` a device, so no graph holds work of
two devices. Every part but the last runs first; the last, on the merging
device, takes each part's output as an input copied in after its own: a
copy between devices that torch orders behind the part's replay with
events on both streams, with no host wait.
"""

from __future__ import annotations

import collections
import enum
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
                GLOBAL_COUNTERS.bump("SearchProgramReplays")
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
        GLOBAL_COUNTERS.bump("SearchProgramCaptures")


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
    """Key -> Program, bounded by `cap` (least recently used out first).
    `version` counts `invalidate` calls: a table's segment-set version."""

    def __init__(self, cap: int = MAX_PROGRAMS):
        self.cap = cap
        self.version = 0
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Hashable, Program]" = collections.OrderedDict()

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
                self._entries.popitem(last=False)
                GLOBAL_COUNTERS.bump("SearchProgramEvictions")
            return prog

    def invalidate(self) -> None:
        """Drop every program (and with them the tensors they hold) and
        move the version on."""
        with self._lock:
            self.version += 1
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def programs(self) -> List[Program]:
        with self._lock:
            return list(self._entries.values())


# --------------------------------------------------------------- keys
def _sig_value(v, refs: List[torch.Tensor]):
    from ..index.base import VectorIndex

    if isinstance(v, torch.Tensor):
        refs.append(v)
        return ("tensor", v.data_ptr(), tuple(v.shape), tuple(v.stride()), str(v.dtype),
                str(v.device))
    if isinstance(v, VectorIndex):
        return signature(v, refs)
    if isinstance(v, (tuple, list)):
        return tuple(_sig_value(x, refs) for x in v)
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"a search program cannot key a {type(v).__name__} attribute")


def tensors_key(tensors: Sequence[torch.Tensor], refs: List[torch.Tensor]) -> tuple:
    """The key part of tensors a body reads (pointer, shape, strides, type,
    device); they are appended to `refs`."""
    return tuple(_sig_value(t, refs) for t in tensors)


def signature(searcher, refs: List[torch.Tensor]) -> tuple:
    """A searcher's part of a program key: its class, its static
    configuration and the pointer, shape, strides, type and device of
    every tensor it holds (attributes whose name starts with `_` are
    caches the body does not read). The tensors are appended to `refs`."""
    attrs = tuple(
        (name, _sig_value(v, refs))
        for name, v in sorted(vars(searcher).items())
        if not name.startswith("_")
    )
    return (type(searcher).__module__, type(searcher).__qualname__, attrs)


def mask_spec(mask) -> Optional[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(kind, shape, dtype) of a materialized mask: "window" for an index's
    window-layout bitmap, "rows" for a row bitmap; None for no mask."""
    if mask is None:
        return None
    kind, t = mask
    return (kind, tuple(t.shape), t.dtype)


def materialize_mask(mask):
    """The mask a program copies in, built outside the graph: None, or
    (kind, bool tensor). A WindowMask is built in its index's layout (a
    repeated filter's bitmap comes from the index's cache); a DeviceMask
    in row space."""
    from .filters import DeviceMask, WindowMask

    if mask is None:
        return None
    if isinstance(mask, WindowMask):
        return ("window", mask.build())
    if isinstance(mask, DeviceMask):
        return ("rows", mask.build())
    return ("rows", mask)


def mask_argument(kind: str, buf: Optional[torch.Tensor]):
    """What a searcher's `search_t` takes for a program's mask buffer: a
    prebuilt WindowMask over it for the window kind, else the bitmap."""
    if buf is None:
        return None
    if kind == "window":
        from .filters import WindowMask

        n = buf.shape[0]
        return WindowMask(("prebuilt", n, n, False, None), [buf], buf.device)
    return buf


# ------------------------------------------------------- index search
def pack_topk(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int32[2, Q, k]: the scores' bits and the rows, one buffer."""
    return torch.stack([vals.contiguous().view(torch.int32), rows.to(torch.int32)])


def unpack_topk(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return packed[0].view(torch.float32), packed[1]


def index_search(index, queries, k: int, *, params=None, mask=None,
                 programs: Optional[ProgramCache] = None):
    """`VectorIndex.search`: the index's `search_t` as one program, keyed as
    the JAX package's `_jitted_index_search` is (k, params, the query's
    shape and type, the mask's kind) plus what a graph bakes in (the
    index's tensors). Returns (scores f32[Q, k], rows int32[Q, k]), a copy
    of the program's output."""
    from ..index.base import params_key

    k = int(k)
    pkey = params_key(params)
    device = _index_device(index)
    if isinstance(queries, torch.Tensor):
        on_device = normalize_device(queries.device) == device
        q = queries if on_device else queries.detach().cpu().numpy()
    else:
        q = np.ascontiguousarray(np.asarray(queries))
    m = materialize_mask(mask)
    ms = mask_spec(m)
    refs: List[torch.Tensor] = []
    key = ("index", signature(index, refs), k, pkey, tuple(q.shape), str(q.dtype), ms)
    if programs is None:
        programs = index.__dict__.setdefault("_programs", ProgramCache())
    kind = None if ms is None else ms[0]

    def body(qb, masks, dyn):
        del dyn
        v, r = index.search_t(qb, k, mask=mask_argument(kind, masks[0]), params=pkey)
        return pack_topk(v, r)

    def make():
        qdtype = q.dtype if isinstance(q, torch.Tensor) else torch.from_numpy(q[:0]).dtype
        return Program(
            body, device=device, query=(tuple(q.shape), qdtype),
            masks=[None if ms is None else (ms[1], ms[2])], out_shape=(2, q.shape[0], k),
            label=label_of([index]), refs=refs,
        )

    prog = programs.get(key, make)
    return unpack_topk(prog.run(q, [None if m is None else m[1]]))


def _index_device(index) -> torch.device:
    """The device an index searches on: that of its first tensor off the
    host (a disk-mode index keeps host rows too), or its sub-indexes'."""
    for v in vars(index).values():
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            return normalize_device(v.device)
    for v in vars(index).values():
        if isinstance(v, (tuple, list)):
            for s in v:
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
