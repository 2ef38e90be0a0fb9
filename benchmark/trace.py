"""Read the device's timeline from torch.profiler.

The profiler pass and its event filter are a frozen copy of
`chip_smoke.py:1044` `trace_events` (kernel, memcpy and memset events on
the device; CUDA runtime and driver calls that launch, copy or set on the
host, `chip_smoke.py:5335` `api_trace`). The traced window is the
`bench.window` range the harness opens around the traced calls; busy time
is the union of the device's events inside it, and an idle gap is labelled
with the host event that covers most of it (the innermost where several
cover half of it or more).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
API_WORDS = ("Launch", "Memcpy", "Memset")
TOP = 10


def record(fn: Callable[[], None], device,
           before: Optional[Callable[[], None]] = None) -> List[dict]:
    """Run `before` and then `fn` under torch.profiler, `fn` alone inside a
    `bench.window` range, and return the chrome trace's events (written to
    a temporary file under TMPDIR and removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if before is not None:
            before()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
        with record_function(WINDOW):
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _label(gap: Tuple[float, float], host: np.ndarray, names: List[str]) -> str:
    a, b = gap
    if host.size == 0:
        return "host"
    over = np.minimum(host[:, 1], b) - np.maximum(host[:, 0], a)
    if over.max() <= 0:
        return "host"
    deep = np.nonzero(over >= 0.5 * (b - a))[0]
    if deep.size:
        pick = deep[np.argmin(host[deep, 1] - host[deep, 0])]
    else:
        pick = int(np.argmax(over))
    return names[pick]


def summary(events: List[dict]) -> Dict[str, object]:
    """busy_s, window_s, launch_calls and the breakdown of one traced
    window (times in seconds)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no bench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def inside(e):
        ts = float(e.get("ts", 0.0))
        return ts < w1 and ts + float(e.get("dur", 0.0)) > w0

    dev = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    spans = _union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                    for e in dev])
    busy = sum(b - a for a, b in spans)
    edges = [w0] + [x for s in spans for x in s] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    api = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and inside(e) and any(w in e.get("name", "") for w in API_WORDS)]

    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    hosts = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
             and "dur" in e and inside(e)]
    hspans = np.array([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in hosts],
                      np.float64).reshape(-1, 2)
    hnames = [e["name"] for e in hosts]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = [[_label(g, hspans, hnames)[:120], (g[1] - g[0]) / 1e6] for g in longest]
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_events": len(dev),
        "launch_calls": len(api),
        "breakdown": {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": idle},
    }
