"""One run of one cell, as a function: set-up, window, optional traced
window, the check against the reference, the metrics, the result line.

`run.py` calls it on the card. The tests call it on the CPU at a small
size with cells of their own (`bench_dir`, `manifest`), and plant faults
in the program underneath it.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from benchmark import corpus, judge, system
from benchmark import trace as tracing
from benchmark.spec import BENCH_DIR, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "myscaledb_tpu")
TRACE_WARM_CALLS = 3  # calls under the profiler before its window opens


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _streams(seed: int):
    """Independent generators for the plan, the window and the trace."""
    return [np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(3)]


def _device_info(device, peak: int) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _texts(loop, text) -> dict:
    """The query texts of the pool, for a loop that reads them
    (`READS_TEXTS = True`)."""
    if not getattr(loop, "READS_TEXTS", False):
        return {}
    if text is None:
        raise ValueError("the loop sends query texts and the configuration has no documents")
    return {"texts": text.queries}


def route_misses(window: dict, traffic, searches: int) -> int:
    """The calls, or queries, that did not take the traffic's route: the
    gap between each route counter's change over the window and the
    searches (or their queries) the loop made."""
    due = {"search": searches, "query": searches * int(traffic["batch"])}
    return int(sum(abs(window.get(name, 0) - due[per])
                   for name, per in system.route_counters(traffic)))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             bench_dir: str = BENCH_DIR, manifest: Optional[str] = None,
             t_start: Optional[float] = None, log: Callable[[str], None] = lambda s: None
             ) -> Dict[str, object]:
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = Cell(name, bench_dir, manifest)
    cfg, traffic = cell.config, cell.traffic
    loop = cell.loop()
    rng_plan, rng_run, rng_trace = _streams(seed)
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the allocator's stats exist once CUDA is up
        torch.cuda.reset_peak_memory_stats(device)

    marks = [time.perf_counter()]
    rows, pool, text = corpus.make(cfg, seed, device)
    marks.append(time.perf_counter())
    sut = system.PortTable(cfg, traffic, rows, device,
                           documents=None if text is None else text.documents)
    marks.append(time.perf_counter())
    plan = loop.plan(traffic, pool, rng_plan, **_texts(loop, text))
    loop.warm(sut, traffic, plan)
    _sync(device)
    # set-up leaves a million young objects (imports, the table, the
    # warm-up); collect them now so the window pays only for its own
    gc.collect()
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    parts = np.diff([t_start] + marks)
    log(f"set-up {setup_s:.3f} s: start and CUDA {parts[0]:.3f}, data {parts[1]:.3f}, "
        f"table and index {parts[2]:.3f}, warm-up {parts[3]:.3f}")
    steps = ", ".join(f"{k} {v:.3f}" for k, v in sut.seconds.items())
    log(f"of the data: documents {0.0 if text is None else text.seconds:.3f} s; "
        f"of the table: {steps} s")

    c0 = system.counters()
    g0 = gc.get_stats()[2]["collections"]
    out = loop.run(sut, traffic, plan, seconds, rng_run)
    window = system.delta(c0, system.counters())
    log(f"window {out['window_s']:.3f} s, {out['attempted']} queries, "
        f"{gc.get_stats()[2]['collections'] - g0} full collections")
    searches = out["searches"]
    if out.get("error"):
        log(f"{out['failed']} queries failed, the first with {out['error']}")

    summary = None
    if trace:
        held = {}
        # a few calls under the profiler before the window opens take its
        # start-up, so the window holds only steady calls
        events = tracing.record(
            lambda: held.update(loop.traced(sut, traffic, plan, rng_trace)), device,
            before=lambda: loop.warm(sut, dict(traffic, warm_calls=TRACE_WARM_CALLS), plan))
        summary = tracing.summary(events)
        summary["searches"] = held["searches"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    sut.close()

    values = judge.numbers(out["sample"], rows, pool, int(traffic["k"]), cfg,
                           cell.reference(), device, text=text, traffic=traffic)
    values["unanswered"] = out["unanswered"]
    values["route_misses"] = route_misses(window, traffic, searches)
    correct, checks = judge.compare(values, cell.cell["checks"])

    obs = {"setup_s": setup_s, "latencies_s": out["latencies_s"], "queries": out["queries"],
           "window_s": out["window_s"], "counters": window,
           "trace": summary, "config": cfg, "traffic": traffic, "searches": searches}
    metrics = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct) and not found, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": _device_info(device, peak)}
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    return {"result": result, "forbidden": found, "values": values}


def control_numbers(name: str, seed: int, *, device="cuda", bench_dir: str = BENCH_DIR,
                    manifest: Optional[str] = None) -> Dict[str, float]:
    """The numbers of the control: the reference one precision lower, put in
    the program's place, over as many of the cell's queries as a run
    judges, drawn from the seed."""
    import torch

    device = torch.device(device)
    cell = Cell(name, bench_dir, manifest)
    cfg, traffic = cell.config, cell.traffic
    ref = cell.reference()
    rows, pool, text = corpus.make(cfg, seed, device)
    count = int(traffic["keep_calls"]) * int(traffic["batch"])
    qi = _streams(seed)[1].integers(0, pool.shape[0], count)
    k = int(traffic["k"])
    uniq, inv = np.unique(qi, return_inverse=True)
    d, ids = ref.control(rows, pool[uniq], k, cfg, device,
                         **judge.reference_args(ref, cfg, text, uniq, traffic))
    values = judge.numbers([(qi, ids[inv], d[inv])], rows, pool, k, cfg, ref, device,
                           text=text, traffic=traffic)
    values["unanswered"] = 0
    values["route_misses"] = 0
    return values
