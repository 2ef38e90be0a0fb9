"""Shared helpers for the hand-written CUDA kernels.

Counterpart of myscaledb_tpu/ops/_pallas.py. The kernels live as CUDA C++
under myscaledb_tpu_torch/csrc/ and are compiled by nvcc for sm_90a into
one shared library with a plain C interface, loaded through ctypes. The
build happens at first use, into myscaledb_tpu_torch/_build/, keyed by a
hash of the sources, so a fresh checkout builds on its first kernel call
and an unchanged checkout reuses the library. Each `.cu` file compiles in
its own nvcc process, all started together, and one more links them.

Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc and no card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from ..service.event_log import GLOBAL_COUNTERS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def set_exact_precision() -> None:
    """The exact-precision policy (the analogue of exact_precision() in
    the JAX package, which forces HIGHEST on the TPU): f32 matmuls must not
    run in TF32, which keeps ~10 mantissa bits and reorders near-tied
    neighbours at SIFT score scale. The matmuls this covers are the
    reference `scores_ref` and the kernels' plain versions (among them
    the IVF window scan's and the two-stage re-rank's `bmm`); the search
    path's own exact rescore (`tilescan.tile_rescore`: f32 FMAs in
    csrc/tile_rescore.cu, an f32 multiply and sum in its plain version)
    and, on the card, its IVF window scan (csrc/window_scan.cu) and
    two-stage re-rank (csrc/row_rescore.cu), both f32 FMAs, use no
    matmul, so they stay exact whatever a caller sets later.
    PyTorch's defaults already say so; `connect(device="cuda")` applies
    the policy once, explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _sources():
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _ptxas_path(lib_path: str) -> str:
    return lib_path[: -len(".so")] + ".ptxas.txt"


class _Library:
    """The kernels' shared library: built once per source hash, loaded once
    per process. `build_seconds` is the nvcc wall time of this process's
    build (0.0 when the library was already built); `ptxas_log()` is what
    `-Xptxas -v` said of each kernel (registers, shared memory, spills)
    when the library was built."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds = 0.0
        self.path = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def ptxas_log(self) -> str:
        with open(_ptxas_path(self.path)) as f:
            return f.read()

    def _build(self, path: str) -> None:
        """nvcc each .cu file to an object, all in parallel, then link the
        objects into `path`. Everything is written under private names and
        renamed at the end: concurrent processes never load a half-written
        library."""
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        jobs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        try:
            log = []
            for cmd, _, proc in jobs:
                out, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}"
                    )
                log.append(f"== {os.path.basename(cmd[-1])}\n{out}{err}")
            with open(_ptxas_path(path), "w") as f:
                f.write("".join(log))
            tmp = f"{path}.{tag}"
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *[o for _, o, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            for _, obj, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(obj):
                    os.remove(obj)

    def _load(self) -> ctypes.CDLL:
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"libmyscaledb_kernels_{_source_hash()}.so")
        if not os.path.exists(path):
            t0 = time.perf_counter()
            self._build(path)
            self.build_seconds = time.perf_counter() - t0
        self.path = path
        lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # every pointer and the stream as c_void_p: a bare Python int would
        # be passed as a 32-bit int and cut the pointer
        lib.msd_scores.argtypes = [vp] * 4 + [ci] * 8 + [vp]
        lib.msd_scores.restype = ci
        lib.msd_tile_max.argtypes = [vp] * 5 + [ci] * 8 + [vp]
        lib.msd_tile_max.restype = ci
        lib.msd_scores_f32.argtypes = [vp] * 5 + [ci] * 9 + [vp]
        lib.msd_scores_f32.restype = ci
        lib.msd_tile_max_f32.argtypes = [vp] * 6 + [ci] * 9 + [vp]
        lib.msd_tile_max_f32.restype = ci
        lib.msd_gathermv.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.msd_gathermv.restype = ci
        lib.msd_binary_rows.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.msd_binary_rows.restype = ci
        lib.msd_binary_group.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp]
        lib.msd_binary_group.restype = ci
        lib.msd_binary_blocks.argtypes = [vp] * 9 + [ci] * 7 + [vp]
        lib.msd_binary_blocks.restype = ci
        lib.msd_approx_bin_max.argtypes = [vp] * 3 + [ci] * 4 + [vp]
        lib.msd_approx_bin_max.restype = ci
        lib.msd_tile_rescore.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.msd_tile_rescore.restype = ci
        lib.msd_window_scan.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.msd_window_scan.restype = ci
        lib.msd_row_rescore.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        lib.msd_row_rescore.restype = ci
        return lib


LIBRARY = _Library()


def check_launch(name: str, err: int) -> None:
    """Raise on a refused launch (the C entry points return
    cudaGetLastError() right after the launch)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


_LAUNCH_COUNT_LOCK = threading.Lock()
# the launches a thread records instead of counting (`recording_launches`)
_RECORDING = threading.local()


class LaunchRecord(list):
    """What a thread recorded: (wrapper, f32) launches, and in `work` the
    (name, amount) work amounts of `count_work`."""

    def __init__(self):
        super().__init__()
        self.work: list = []


def count_launch(wrapper, f32: bool = False) -> None:
    """Add one to a kernel wrapper's `launches` counter, and to its
    `launches_f32` counter when the launch took the f32 engine (the scan
    kernels over an f32 payload). Builds launch kernels on the
    scheduler's threads too, so the add takes a lock. While the calling
    thread records (`recording_launches`: a CUDA graph's capture, or the
    warm-up run before it), the launch is appended to the record instead:
    a captured kernel runs only when the graph replays, and the replay
    adds the record (`add_launches`)."""
    record = getattr(_RECORDING, "launches", None)
    if record is not None:
        record.append((wrapper, f32))
        return
    with _LAUNCH_COUNT_LOCK:
        wrapper.launches += 1
        if f32:
            wrapper.launches_f32 += 1


def count_work(name: str, amount: int) -> None:
    """Add a work amount that the host knows from shapes (rows a window
    step gathers, rows a re-rank scores) to the profile event `name`.
    While the calling thread records (`recording_launches`), the amount
    goes to the record's `work` instead: the captured work runs when the
    graph replays, and each replay adds the record's amounts."""
    record = getattr(_RECORDING, "launches", None)
    if record is not None:
        record.work.append((name, amount))
        return
    GLOBAL_COUNTERS.bump(name, amount)


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's `count_launch` and `count_work`
    calls append to the yielded `LaunchRecord` instead of counting."""
    prev = getattr(_RECORDING, "launches", None)
    record = LaunchRecord()
    _RECORDING.launches = record
    try:
        yield record
    finally:
        _RECORDING.launches = prev


def add_launches(record) -> None:
    """Count the launches of a `recording_launches` record once each (a
    graph replay runs every kernel its capture recorded)."""
    with _LAUNCH_COUNT_LOCK:
        for wrapper, f32 in record:
            wrapper.launches += 1
            if f32:
                wrapper.launches_f32 += 1


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


METRIC_CODES = {"L2": 0, "IP": 1, "Cosine": 2}
