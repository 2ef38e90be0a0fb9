#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one GPU.

    python3 chip_smoke.py [--profile [--out DIR]]

Run from the root of a checkout on a machine with one CUDA GPU (an H100:
the kernels are built for sm_90a). It imports nothing of JAX and nothing
of the JAX package. Phases, each of which raises on failure:

  1. set-up: versions, the card's name and power limit, the nvcc build of
     the kernels in myscaledb_tpu_torch/csrc/ (one nvcc per source, all
     started together) and what `-Xptxas -v` said of each kernel;
  2. each hand-written kernel against its plain PyTorch version on the
     card, at the shapes the main paths give it and at one ragged shape
     (Q = 300): score and tile_max held to `distance.kernel_error_bound`,
     with a hi-only control (the bf16 payload's query split without its
     lo half) that must fall outside it, and the kernels' own query split
     checked bit for bit against `split_query_bf16`; gathermv held to
     `gathermv.kernel_error_bound`, with a control that skips the query's
     bf16 cast and must fall outside it;
  3. the SIFT1M-shaped exact path through connect / create_table / insert /
     search / delete / gather: a 1,000,000-row segment (tile-max kernel)
     and a 50,000-row segment (score kernel), recall@10 against an exact
     f32 scan of the stored values, a pre-filter and deletes;
  4. the GIST-shaped exact path: 100,000 x 960, Cosine, batch 256 (score
     kernel);
  5. the exact paths' QPS; with --profile, each cell's QPS spread, device
     time, kernels per search, device busy share and top host functions
     (traces and host profiles under --out);
  6. the HNSW path on phase 4's table: add_vector_index(HNSWFLAT, m=32,
     ef_c=100, Cosine), graph searches at ef_s 50 / 100 / 200 (gathermv
     kernel) with recall against phase 4's exact results and QPS, a
     filtered search, the routed default search and a search after
     deletes (--profile adds the graph search's cell);
  7. times: each kernel beside its plain version, the library call that
     computes the same function (where there is one) and its bound, and
     for score one bf16 torch.matmul over the same tensor-core work; the
     routing cost model's constants, as medians over COST_RUNS runs of the
     graph search at two batch sizes (host and device time) and of phase
     5's exact scan, with their spread and the HNSW cell's routing at both
     ends of it;
  8. the IVF family on phase 3's table: IVFFLAT (ncentroids 1024) with its
     build time, an nprobe sweep that stops at the first recall_ids@10 >=
     0.95 (bench.py's rule), QPS at that operating point at batch 100 and
     500, an nprobe-3 search (dyn_nprobe), a 10% filter through the
     index's WindowMask (built once, then cached) and a 0.5% filter that
     falls back to the exact scan (tile_max); then IVFSQ, IVFPQ and the
     default MSTG (add_vector_index with no type), one at a time, and MSTG
     under two_stage_search. Every hit must be a live row with its exact
     f32 score. Then HNSWPQ (m=32, ef_c=100) on phase 4's table, searched
     at ef_s 100 (gathermv). --profile adds the ivf_flat cell and the
     window step's gathered bytes beside the exact scan's device time.

Each path's launch counters are zeroed just before it is driven and read
just after: score and tile_max over phases 3-4, gathermv over phase 6, all
three over phase 8; every kernel must have launched on its path, and the
record's launches are the sums over those paths. The last line of standard
output is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON record. Without CUDA, or without the package beside this
file, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

K = 10
SIFT_N, SIFT_SMALL_N, SIFT_D, SIFT_NQ, SIFT_BATCH = 1_000_000, 50_000, 128, 1_000, 100
SIFT_CAPS = (1_048_576, 50_176)  # the segments' capacities (storage/segment.py)
GIST_N, GIST_D, GIST_NQ, GIST_BATCH = 100_000, 960, 1_024, 256
GIST_CAP = 114_688
# the HNSW path (BASELINE.json config 3 at the JAX bench's hnsw_100k size):
# build params, the ef_s grid, the 256-query batches it searches, and the
# graph recall_ids@10 floor at ef_s = 100
HNSW_PARAMS = dict(m=32, ef_c=100)
HNSW_EFS = (50, 100, 200)
HNSW_BATCHES = 2
HNSW_MIN_RECALL = 0.98
# (Q, BEAM, m, Dt, N) of the gathermv comparisons: the main path's shape,
# a ragged one, and a narrow beam (ef_s < 8) over m = 16 blocks
GATHERMV_SHAPES = [(256, 8, 32, 1024, 100_000), (13, 8, 64, 128, 5_000),
                   (256, 5, 16, 1024, 20_000)]
# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PROFILE_RUNS = 9  # one-pass runs per cell for --profile's QPS spread
# the device's sleep while the host enqueues a timed run (~25 ms at the
# H100's clock; the longest run enqueues in a few ms)
SLEEP_CYCLES = 50_000_000
# runs of the cost model's measurements (phase 5's scan, phase 7's graph
# searches at two batch sizes, in turns); the constants are their medians
COST_RUNS = 5
COST_SMALL_BATCH, COST_SMALL_BATCHES = 32, 4
# near-tie tolerance of the recall checks: the JAX package's f32
# tolerance (tests/test_distance_ops.py:37)
F32_TOL = dict(rtol=2e-4, atol=2e-3)
# (kernel, Q, N, D, metric) of the kernel-vs-plain comparisons and times:
# the shapes and metric the exact paths give each kernel; a kernel's
# record line takes its last shape here
KERNEL_SHAPES = [("score", 104, 50_176, 128, "L2"), ("score", 256, 114_688, 1024, "Cosine"),
                 ("tile_max", 104, 1_048_576, 128, "L2")]
# ragged shapes phase 2 also compares (not timed): Q = 300 is three query
# tiles (streamed query), N = 4,099 ends mid-tile with rows that are not
# 16-byte aligned, D = 136 ends mid-chunk; tile_max's 16,512 rows end half
# way through a 256-row tile
RAGGED_SHAPES = [("score", 300, 4_099, 136, "L2"), ("tile_max", 300, 16_512, 1024, "L2")]
# (Q, D) of the split check: a resident and a streamed query
SPLIT_SHAPES = [(100, 128), (300, 1024)]
# the IVF path (BASELINE.json config 2, SIFT1M IVFFLAT at ncentroids 1024,
# as bench.py:424 builds it): the nprobe sweep and its stopping rule
# (bench.py:443-457), the large batch, the filters (10% of the 1M segment
# goes through the index, 0.5% falls back to the exact scan) and the
# dyn_nprobe probe; then HNSWPQ on the GIST table
IVF_NCENT = 1024
IVF_NPROBES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
IVF_RECALL_TARGET = 0.95
IVF_BIG_BATCH = 500
IVF_FILTERS = (100_000, 5_000)
IVF_DYN_NPROBE = 3
HNSWPQ_PARAMS = dict(m=32, ef_c=100)


def make_corpus(n, d, seed=0, centers=None):
    """Clustered synthetic (mixture of Gaussians), as bench.py makes it."""
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = 6.0 * rng.standard_normal((1000, d)).astype(np.float32)
    n_blobs = centers.shape[0]
    out = np.empty((n, d), np.float32)
    bs = 100_000
    for i in range(0, n, bs):
        m = min(bs, n - i)
        which = rng.integers(0, n_blobs, m)
        out[i : i + m] = centers[which] + rng.standard_normal((m, d)).astype(np.float32)
    return out


def corpus_centers(d, seed=0):
    """The blob centres make_corpus(seed=seed) draws first."""
    return 6.0 * np.random.default_rng(seed).standard_normal((1000, d)).astype(np.float32)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_time_ms(fn, iters=20, warmup=3, padded=True):
    """Milliseconds per call of `fn`, by CUDA events around `iters` calls
    after `warmup`. Padded (the default), the device first sleeps for
    SLEEP_CYCLES while the host enqueues the calls, so the host's time
    between calls does not show: the device's own time per call. Unpadded,
    the calls run as the host issues them (this script's earlier method), which a
    call shorter than its host overhead cannot fill."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if padded:
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def log_ptxas(text):
    """What `-Xptxas -v` said of each kernel: registers, shared memory,
    barriers, spills (one line per kernel)."""
    name = None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            log(f"  ptxas {name[:60]}: {line.split(':', 1)[-1].strip()}")


# ---------------------------------------------------------------- phase 2
def compare_kernels(dev):
    """Each kernel against its plain version on the same device inputs,
    held to `distance.kernel_error_bound`: both compute the same f32 math
    and differ only in the order of their sums. For a bf16 payload a
    control -- the plain version on the queries rounded to bf16, which is
    what a kernel without the query's lo half computes -- must fall outside
    that bound, so the bound is shown to catch a kernel that drops it."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"score": 0.0, "tile_max": 0.0}

    def operands(q, n, d, dtype, metric):
        x = (3.0 * torch.randn((n, d), generator=gen, device=dev)).to(dtype)
        qs = distance.normalize_queries(
            3.0 * torch.randn((q, d), generator=gen, device=dev), metric
        ).contiguous()
        aux = distance.base_aux(x, metric)
        if aux is None:
            aux = torch.zeros((n,), dtype=torch.float32, device=dev)
        return qs, x, aux

    def worst(got, want, bound):
        """(max |got - want|, max ratio of |got - want| to its bound)."""
        diff = (got - want).abs()
        ratio = diff / (bound + distance.KERNEL_RTOL * want.abs())
        return float(diff.max()), float(ratio.max())

    def close(name, got, want, bound, what, control=None):
        e, r = worst(got, want, bound)
        err[name] = max(err[name], e)
        line = f"  {name:8s} {what}: max_abs_err={e:.6g} (worst err/bound {r:.3g})"
        if control is not None:
            ce, cr = worst(control, want, bound)
            n_out = int(distance.outside_kernel_bound(control, want, bound).sum())
            line += (f"; hi-only control max_abs_err={ce:.6g} (worst err/bound {cr:.3g},"
                     f" {n_out} of {want.numel()} outside)")
            check(n_out > 0, f"the bound does not catch a hi-only {name} kernel: {what}")
        log(line)
        check(not bool(distance.outside_kernel_bound(got, want, bound).any()),
              f"{name} disagrees with its plain version: {what}")

    for name, q, n, d, _ in KERNEL_SHAPES + RAGGED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for metric in (Metric.L2, Metric.IP, Metric.COSINE):
                qs, x, aux = operands(q, n, d, dtype, metric)
                # a bf16-valued query splits into hi = q, lo = 0
                hi_only = qs.to(torch.bfloat16).to(torch.float32)
                split = dtype == torch.bfloat16
                what = f"Q={q} N={n} D={d} {str(dtype)[6:]} {metric.value}"
                if name == "score":
                    want = distance.scores_plain(qs, x, aux, metric)
                    close(name, distance.scores(qs, x, aux, metric=metric), want,
                          distance.kernel_error_bound(qs, x, aux, metric), what,
                          distance.scores_plain(hi_only, x, aux, metric) if split else None)
                    del want
                    continue
                bound = tilescan.tile_error_bound(qs, x, aux, metric)
                for mname, mask in (
                    ("1% kept", (torch.rand((n,), generator=gen, device=dev) < 0.01)),
                    ("all kept", torch.ones((n,), dtype=torch.bool, device=dev)),
                    ("all masked", torch.zeros((n,), dtype=torch.bool, device=dev)),
                ):
                    m8 = mask.to(torch.uint8)
                    got = tilescan.tile_maxes(qs, x, aux, m8, metric=metric)
                    want = tilescan.tile_maxes_plain(qs, x, aux, m8, metric)
                    check(torch.equal(got == tilescan.NEG, want == tilescan.NEG),
                          f"tile_max masks other sub-tiles than its plain version: {what}")
                    if mname == "all masked":
                        check(bool((got == tilescan.NEG).all()),
                              f"tile_max all-masked must give -3.4e38: {what}")
                    control = None
                    if split and mname != "all masked":
                        control = tilescan.tile_maxes_plain(hi_only, x, aux, m8, metric)
                    close(name, got, want, bound, f"{what} {mname}", control)
                del qs, x, aux
    check_split(dev, gen)
    sync(dev)
    return err


def check_split(dev, gen):
    """The bf16 engine splits the f32 query into hi and lo halves itself:
    against one-hot payload rows (the identity) under IP each score is
    hi + lo of one query entry, exact in f32, so the score kernel must
    equal its plain version (`split_query_bf16`) bit for bit."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance

    for q, d in SPLIT_SHAPES:
        qs = 3.0 * torch.randn((q, d), generator=gen, device=dev)
        x = torch.eye(d, device=dev).to(torch.bfloat16)
        got = distance.scores(qs, x, None, metric=Metric.IP)
        want = distance.scores_plain(qs, x, None, Metric.IP)
        n_diff = int((got != want).sum())
        g = distance.scan_geometry(q, d, d)
        log(f"  split    Q={q} D={d} ({'resident' if g.resident else 'streamed'} query): "
            f"{n_diff} of {want.numel()} scores differ from split_query_bf16's")
        check(n_diff == 0, f"the kernel's query split is not split_query_bf16's: Q={q} D={d}")


def compare_gathermv(dev):
    """gathermv against its plain version at GATHERMV_SHAPES, held to
    `gathermv.kernel_error_bound`; the control that skips the query's bf16
    cast must fall outside it on most entries. Some block rows lie outside
    [0, N): the kernel clamps them as the plain version does."""
    import torch

    from myscaledb_tpu_torch.ops import gathermv

    gen = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    for q, beam, m, dt, n in GATHERMV_SHAPES:
        check(gathermv.supports(dt), f"gathermv does not support Dt={dt}")
        nb = torch.randint(0, 256, (n, m, dt), generator=gen, device=dev, dtype=torch.uint8)
        rows = torch.randint(-3, n + 3, (q, beam), generator=gen, device=dev, dtype=torch.int32)
        qs = 0.01 * torch.randn((q, dt), generator=gen, device=dev)
        got = gathermv.gather_block_scores(qs, rows, nb)
        want = gathermv.gather_block_scores_plain(qs, rows, nb)
        bound = gathermv.kernel_error_bound(qs, rows, nb)
        control = gathermv.unrounded_control(qs, rows, nb)
        diff = (got - want).abs()
        ratio = float((diff / (bound + gathermv.KERNEL_RTOL * want.abs())).max())
        n_out = int(gathermv.outside_kernel_bound(control, want, bound).sum())
        err = max(err, float(diff.max()))
        what = f"Q={q} BEAM={beam} m={m} Dt={dt} N={n}"
        log(f"  gathermv {what}: max_abs_err={float(diff.max()):.6g} (worst err/bound "
            f"{ratio:.3g}); unrounded control {n_out} of {want.numel()} outside")
        check(not bool(gathermv.outside_kernel_bound(got, want, bound).any()),
              f"gathermv disagrees with its plain version: {what}")
        check(n_out > want.numel() // 2,
              f"the bound does not catch a gathermv kernel without the bf16 cast: {what}")
        del nb, rows, qs, got, want, bound, control
    sync(dev)
    return err


# ---------------------------------------------------------------- phase 3/4
def exact_topk(table, column, queries, k, metric, mask_fn=None):
    """Ground truth: the exact f32 score (`scores_ref`) of the STORED values
    of every segment on the card, masked to live (and filter-passing) rows,
    merged.
    Returns (scores f32[Q,k], segment ids, rows)."""
    import torch

    from myscaledb_tpu_torch.ops import distance

    dev = table.device
    q = torch.from_numpy(queries).to(dev)
    allv, alls, allr = [], [], []
    for seg in table.live_segments():
        p = seg.vector(column)
        d = p.data.shape[1]
        qq = distance.normalize_queries(
            torch.nn.functional.pad(q, (0, d - q.shape[1])), metric
        )
        s = distance.scores_ref(qq, p.data, p.aux_for(metric), metric=metric)
        ok = torch.arange(seg.capacity, device=dev) < seg.n_rows
        alive = seg.alive_mask_device()
        if alive is not None:
            ok &= alive
        if mask_fn is not None:
            keep = np.zeros(seg.capacity, bool)
            keep[: seg.n_rows] = mask_fn(seg)
            ok &= torch.from_numpy(keep).to(dev)
        s = torch.where(ok[None, :], s, torch.full_like(s, float("-inf")))
        v, r = torch.topk(s, k, dim=1)
        allv.append(v)
        allr.append(r)
        alls.append(torch.full_like(r, seg.segment_id))
    v, pos = torch.topk(torch.cat(allv, 1), k, dim=1)
    segs = torch.gather(torch.cat(alls, 1), 1, pos)
    rows = torch.gather(torch.cat(allr, 1), 1, pos)
    return v.cpu().numpy(), segs.cpu().numpy(), rows.cpu().numpy()


def check_recall(label, results, gt, tol):
    """recall@k of the port against the exact scan. Ids are compared where
    the scores have no ties; a query whose id sets differ passes only if
    its sorted scores agree with the exact ones within `tol` (a near-tie
    resolved the other way)."""
    vals = np.concatenate([r.scores for r in results])
    segs = np.concatenate([r.segments for r in results])
    rows = np.concatenate([r.rows for r in results])
    gv, gs, gr = gt
    nq, k = gv.shape
    hits, tied = 0, 0
    for i in range(nq):
        got = set(zip(segs[i].tolist(), rows[i].tolist()))
        want = set(zip(gs[i].tolist(), gr[i].tolist()))
        hits += len(got & want)
        if got != want:
            same = np.allclose(np.sort(vals[i]), np.sort(gv[i]), **tol)
            check(same, f"{label}: query {i} differs from the exact top-{k}")
            tied += 1
    recall_ids = hits / (nq * k)
    log(f"  {label}: recall@{k} = 1.0 ({nq} queries; id recall {recall_ids:.6f}, "
        f"{tied} queries differ only by near-tied scores)")
    return recall_ids


def sift_path(ms, dev):
    import torch

    from myscaledb_tpu_torch import F

    db = ms.connect(device=dev)
    t = db.create_table(
        "sift", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(SIFT_D)})
    )
    t0 = time.perf_counter()
    corpus = make_corpus(SIFT_N, SIFT_D, seed=0)
    small = make_corpus(SIFT_SMALL_N, SIFT_D, seed=1, centers=corpus_centers(SIFT_D))
    t1 = time.perf_counter()
    t.insert({"id": np.arange(SIFT_N, dtype=np.uint64), "vec": corpus})
    t.insert({"id": np.arange(SIFT_N, SIFT_N + SIFT_SMALL_N, dtype=np.uint64),
              "vec": small})
    sync(dev)
    t2 = time.perf_counter()
    caps = [(s.n_rows, s.capacity) for s in t.live_segments()]
    log(f"  corpus {t1 - t0:.2f} s, insert {t2 - t1:.2f} s, segments (rows, capacity) {caps}")
    check(caps == [(SIFT_N, SIFT_CAPS[0]), (SIFT_SMALL_N, SIFT_CAPS[1])],
          f"segment shapes {caps}")

    rng = np.random.default_rng(1)
    qidx = rng.choice(SIFT_N, SIFT_NQ, replace=False)
    queries = (corpus[qidx] + 0.3 * rng.standard_normal((SIFT_NQ, SIFT_D))).astype(np.float32)
    batches = [queries[i : i + SIFT_BATCH] for i in range(0, SIFT_NQ, SIFT_BATCH)]
    from myscaledb_tpu_torch.metrics import Metric

    res = [t.search("vec", qb, k=K, metric="L2") for qb in batches]
    check_recall("SIFT L2 unfiltered", res,
                 exact_topk(t, "vec", queries, K, Metric.L2), F32_TOL)
    d = np.concatenate([r.distances for r in res])
    check(np.isfinite(d).all() and d.shape == (SIFT_NQ, K), "distances must be finite [Q, k]")
    check((np.diff(d, axis=1) >= 0).all(), "L2 distances must be ascending")

    flt = F("id") < 10_000
    fres = [t.search("vec", qb, k=K, metric="L2", filter=flt) for qb in batches]
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in fres])
    check((ids < 10_000).all() and np.concatenate([r.rows for r in fres]).min() >= 0,
          "every filtered hit must pass id < 10000")
    check_recall("SIFT L2 id<10000", fres,
                 exact_topk(t, "vec", queries, K, Metric.L2,
                            lambda s: s.scalar("id")[: s.n_rows] < 10_000), F32_TOL)
    log("  filtered search: every hit passes id < 10000")

    n_del = t.delete(F("id") < 100)
    check(n_del == 100, f"delete removed {n_del} rows, expected 100")
    dres = [t.search("vec", qb, k=K, metric="L2") for qb in batches]
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in dres])
    check((ids >= 100).all(), "a deleted row came back")
    # the queries built on deleted rows must now find other rows
    gt = exact_topk(t, "vec", queries, K, Metric.L2)
    check_recall("SIFT L2 after delete", dres, gt, F32_TOL)
    log("  delete: 100 rows deleted, none returned, gather(['id']) agrees")
    return t, batches, flt, queries, gt


def gist_path(ms, dev):
    from myscaledb_tpu_torch.metrics import Metric

    st = ms.Settings()
    st.table.float_vector_search_metric_type = "Cosine"
    db = ms.connect(st, device=dev)
    t = db.create_table(
        "gist", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(GIST_D)})
    )
    corpus = make_corpus(GIST_N, GIST_D, seed=3)
    t.insert({"id": np.arange(GIST_N, dtype=np.uint64), "vec": corpus})
    sync(dev)
    caps = [(s.n_rows, s.capacity) for s in t.live_segments()]
    check(caps == [(GIST_N, GIST_CAP)], f"GIST segment shape {caps}")
    rng = np.random.default_rng(4)
    qidx = rng.choice(GIST_N, GIST_NQ, replace=False)
    queries = (corpus[qidx] + 0.3 * rng.standard_normal((GIST_NQ, GIST_D))).astype(np.float32)
    batches = [queries[i : i + GIST_BATCH] for i in range(0, GIST_NQ, GIST_BATCH)]
    res = [t.search("vec", qb, k=K) for qb in batches]
    check(all(r.metric == Metric.COSINE for r in res), "GIST table must search in Cosine")
    gt = exact_topk(t, "vec", queries, K, Metric.COSINE)
    check_recall("GIST Cosine", res, gt, F32_TOL)
    d = np.concatenate([r.distances for r in res])
    check(np.isfinite(d).all() and (d > -1e-3).all() and (d < 2.001).all(),
          "Cosine distances must lie in [0, 2]")
    return t, batches, gt


# ---------------------------------------------------------------- phase 6
def graph_recall(results, gt):
    """(recall_ids@k, recall_dist@k) against the exact (scores, segments,
    rows) `gt` of the same queries. recall_dist counts the returned hits
    whose Cosine distance is within the exact k-th distance (1e-4 relative
    plus 1e-4, as bench.py's hnsw_100k cell counts it)."""
    rows = np.concatenate([r.rows for r in results])
    dist = np.concatenate([r.distances for r in results])
    gv, _, gr = gt
    nq, k = rows.shape
    hits = sum(len(set(rows[i].tolist()) & set(gr[i].tolist())) for i in range(nq))
    kth = 1.0 - gv[:nq, k - 1 : k]  # Cosine distance = 1 - score
    return hits / (nq * k), float((dist <= kth * (1 + 1e-4) + 1e-4).mean())


def hnsw_path(ms, dev, t, batches, gt, card):
    """Build HNSWFLAT on phase 4's table and search it through the table's
    entry points. Returns (graph settings, the batches searched, the
    index, ef_s -> (recall_ids, recall_dist, QPS))."""
    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.index import hnsw
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import gathermv
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    t0 = time.perf_counter()
    t.add_vector_index("h", "vec", type="HNSWFLAT", metric_type="Cosine", **HNSW_PARAMS)
    sync(dev)
    build_s = time.perf_counter() - t0
    check(t.index_status("h") == {0: IndexStatus.LOADED},
          f"HNSW build did not load: {t.index_status('h')} {t.event_log.rows()[-1:]}")
    idx = t.loaded_index(0, "vec", Metric.COSINE)
    nb = idx.nbdata
    check(nb is not None and idx.tproj is None and nb.shape[2] == idx.data.shape[1],
          "the 100k x 960 index must hold full-width node blocks the gathermv kernel takes")
    log(f"  HNSWFLAT build {build_s:.2f} s (m={HNSW_PARAMS['m']}, ef_c={HNSW_PARAMS['ef_c']}; "
        f"node blocks {tuple(nb.shape)} = {nb.numel() / 1e9:.3f} GB, "
        f"{idx.centroids.shape[0]} entries, index {idx.memory_bytes / 1e9:.3f} GB)  [{card}]")

    graph = ms.Settings()
    graph.query.cost_based_index_routing = False
    hb = batches[:HNSW_BATCHES]
    nq = sum(len(qb) for qb in hb)
    curve, found = {}, {}
    for ef in HNSW_EFS:
        before = (gathermv.gather_block_scores.launches, GLOBAL_COUNTERS.get("VectorIndexSearches"))
        res = [t.search("vec", qb, k=K, params={"ef_s": ef}, settings=graph) for qb in hb]
        sync(dev)
        n_launch = gathermv.gather_block_scores.launches - before[0]
        check(GLOBAL_COUNTERS.get("VectorIndexSearches") - before[1] == len(hb),
              f"ef_s={ef}: the graph searches did not go through the index")
        check(n_launch == hnsw.n_iterations(ef) * len(hb),
              f"ef_s={ef}: {n_launch} gathermv launches, expected "
              f"{hnsw.n_iterations(ef)} iterations x {len(hb)} batches")
        rid, rdist = graph_recall(res, gt)
        rate = qps(lambda qb: t.search("vec", qb, k=K, params={"ef_s": ef}, settings=graph),
                   hb, GIST_BATCH)
        curve[ef], found[ef] = (rid, rdist, rate), res
        log(f"  graph ef_s={ef}: recall_ids@{K} {rid:.4f}, recall_dist {rdist:.4f}, "
            f"{n_launch} gathermv launches ({hnsw.n_iterations(ef)} iterations x {len(hb)}), "
            f"QPS {rate:.1f} (batch {GIST_BATCH}, {nq} queries)  [{card}]")
        for r in res:
            check(np.isfinite(r.distances).all() and (r.rows >= 0).all(),
                  f"ef_s={ef}: a graph search returned fewer than {K} hits")
    check(curve[100][0] >= HNSW_MIN_RECALL,
          f"graph recall_ids@{K} {curve[100][0]:.4f} < {HNSW_MIN_RECALL} at ef_s=100")

    flt = F("id") < 50_000
    before = GLOBAL_COUNTERS.get("VectorIndexSearches")
    fres = [t.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph, filter=flt) for qb in hb]
    check(GLOBAL_COUNTERS.get("VectorIndexSearches") - before == len(hb),
          "the filtered search (selectivity 0.5) must search the graph")
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in fres])
    check((np.concatenate([r.rows for r in fres]) >= 0).all() and (ids < 50_000).all(),
          "every filtered graph hit must pass id < 50000")
    log(f"  filtered graph search (id < 50000, ef_s=100): all {ids.size} hits pass")

    names = ("VectorIndexSearches", "VectorIndexCostRouteToScan")
    before = {n: GLOBAL_COUNTERS.get(n) for n in names}
    rres = [t.search("vec", qb, k=K, params={"ef_s": 100}) for qb in hb]
    routed = {n: GLOBAL_COUNTERS.get(n) - before[n] for n in names}
    rid, rdist = graph_recall(rres, gt)
    if routed["VectorIndexCostRouteToScan"] == len(hb):
        check_recall("routed default search (exact scan)", rres,
                     tuple(a[:nq] for a in gt), F32_TOL)
    else:
        check(routed["VectorIndexSearches"] == len(hb), f"routed search took no route: {routed}")
        check(rid >= HNSW_MIN_RECALL, f"routed graph search recall_ids@{K} {rid:.4f}")
    log(f"  routed default search (ef_s=100): counters {routed}, recall_ids@{K} {rid:.4f}")

    # deletes last: the rows each query found first, then the graph again
    first = sorted({int(i) for r in found[100] for i in t.gather(r, ["id"])["id"][:, 0]})
    check(t.delete(F("id").isin(first)) == len(first), "delete removed another count of rows")
    dres = [t.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph) for qb in hb]
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in dres])
    check(not set(ids.ravel().tolist()) & set(first), "a deleted row came back from the graph")
    log(f"  delete: {len(first)} rows deleted, none returned by the graph")
    return graph, hb, idx, curve


def search_seconds(search, batches, rounds=3):
    """Best-of-`rounds` host seconds per search, after a warm-up pass;
    results stay on the device (as a pipelined server would keep them) and
    each timed window ends in torch.cuda.synchronize()."""
    import torch

    for qb in batches:
        search(qb)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for qb in batches:
            search(qb)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / len(batches))
    return best


def qps(search, batches, nq_per_batch):
    """Best-of-3 QPS (see search_seconds)."""
    return nq_per_batch / search_seconds(search, batches)


def device_trace(search, batches, trace_path):
    """One pass of `search` over `batches` under torch.profiler; its chrome
    trace's kernel, memcpy and memset events give (device ms of the pass,
    device ms by name, kernels launched). The trace goes to `trace_path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for qb in batches:
            search(qb)
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(dev, f"{trace_path}: the profiler saw no device activity")
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    return sum(by_name.values()), by_name, sum(e["cat"] == "kernel" for e in dev)


def profile_cells(cells, runs, out_dir, card):
    """Where the time goes, per cell (--profile): the spread of one-pass
    QPS over `runs` passes; one torch.profiler pass, whose chrome trace's
    kernel, memcpy and memset events give the device time, the kernels
    launched and the largest device shares; the device busy share (device
    time over the median unprofiled pass); and one cProfile pass for the
    host functions with the most own time. Traces and full host profiles
    go to `out_dir`."""
    import cProfile
    import pstats
    import statistics

    import torch

    os.makedirs(out_dir, exist_ok=True)
    for label, search, batches in cells:
        def one_pass():
            t0 = time.perf_counter()
            for qb in batches:
                search(qb)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        nq, nb = sum(len(qb) for qb in batches), len(batches)
        one_pass()  # warm-up
        walls = [one_pass() for _ in range(runs)]
        rates = sorted(nq / w for w in walls)
        wall_ms = 1e3 * statistics.median(walls)
        log(f"  {label}: one-pass QPS over {runs} passes min {rates[0]:.1f} / median "
            f"{statistics.median(rates):.1f} / max {rates[-1]:.1f}  [{card}]")

        dev_ms, by_name, n_kernels = device_trace(
            search, batches, os.path.join(out_dir, f"trace_{label}.json"))
        log(f"  {label}: device {dev_ms / nb:.4f} ms / search, "
            f"{n_kernels / nb:.1f} kernels / search, busy share {dev_ms / wall_ms:.3f} "
            f"({dev_ms:.3f} ms device over a median {wall_ms:.3f} ms pass of {nb} searches)")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
            log(f"    {100 * ms / dev_ms:5.1f}%  {ms / nb:.4f} ms / search  {name[:90]}")

        host = cProfile.Profile()
        host.enable()
        one_pass()
        host.disable()
        with open(os.path.join(out_dir, f"host_{label}.txt"), "w") as f:
            pstats.Stats(host, stream=f).sort_stats("tottime").print_stats(40)
        rows = sorted(pstats.Stats(host).stats.items(), key=lambda kv: -kv[1][2])
        for (fname, line, func), (_, ncalls, tottime, _, _) in rows[:5]:
            log(f"    host {1e3 * tottime / nb:.4f} ms / search own time, "
                f"{ncalls / nb:.0f} calls: {func} ({os.path.basename(fname)}:{line})")


# ---------------------------------------------------------------- phase 7
def bound(nbytes, flops, kind):
    """(bound_ms, bound_by): the least time the card could take to move
    `nbytes` or to do `flops` operations of type `kind`, at its published
    peaks."""
    b, o = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return 1e3 * max(b, o), "bytes" if b >= o else "operations"


def time_kernels(dev, idx, card):
    """Each kernel, its plain version and the library call (where one
    computes the same function) at the shapes of the main paths, with the
    bound of the kernel's work. Returns kernel name -> the fields of its
    record line, from its last shape."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, gathermv, tilescan

    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}

    def done(name, rec, call):
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        log(f"  {name:8s} {rec['shape']}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
            f" ms, library {lib}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it); back to back from the host "
            f"{cuda_time_ms(call, padded=False):.4f} ms  [{card}]")
        out[name] = rec

    for name, qn, n, d, mname in KERNEL_SHAPES:
        metric = Metric(mname)
        x = (3.0 * torch.randn((n, d), generator=gen, device=dev)).to(torch.bfloat16)
        q = distance.normalize_queries(torch.randn((qn, d), generator=gen, device=dev), metric)
        aux = distance.base_aux(x, metric)
        flops = 2 * 2 * qn * n * d  # bf16 hi and lo products
        if name == "tile_max":
            m8 = torch.ones((n,), dtype=torch.uint8, device=dev)
            call = lambda: tilescan.tile_maxes(q, x, aux, m8, metric=metric)  # noqa: E731
            rec = dict(
                ms=cuda_time_ms(call),
                plain_ms=cuda_time_ms(lambda: tilescan.tile_maxes_plain(q, x, aux, m8, metric)),
                library_ms=None,  # no one PyTorch call computes masked sub-tile maxima
            )
            nbytes = 2 * n * d + 4 * n + n + 4 * qn * d + 4 * qn * (n // tilescan.SUB)
        else:
            xf = x.to(torch.float32)  # the library call's operand, made outside its timing
            call = lambda: distance.scores(q, x, aux, metric=metric)  # noqa: E731
            rec = dict(
                ms=cuda_time_ms(call),
                plain_ms=cuda_time_ms(lambda: distance.scores_plain(q, x, aux, metric)),
                library_ms=cuda_time_ms(lambda: torch.matmul(q, xf.T)),
            )
            nbytes = 2 * n * d + 4 * n + 4 * qn * d + 4 * qn * n
            # a yardstick, not a kernel of the port: one bf16 tensor-core
            # GEMM over the same work (the stacked [2Q, D] hi/lo query
            # against the payload), without the epilogue
            hl = distance.split_query_bf16(q).reshape(2 * qn, d)
            gemm = cuda_time_ms(lambda: torch.matmul(hl, x.T))
            log(f"  {name:8s} Q={qn} N={n} D={d}: one bf16 torch.matmul [2Q, D] x [D, N] takes "
                f"{gemm:.4f} ms (a yardstick for the tensor-core work; bound "
                f"{bound(0, flops, 'bf16')[0]:.4f} ms)  [{card}]")
            del xf, hl
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, "bf16")
        rec["shape"] = f"Q={qn} N={n} D={d} bf16 {mname}"
        done(name, rec, call)
        del x, q, aux
    # gathermv at the HNSW path's shape, over the index's own node blocks
    nb = idx.nbdata
    n, m, dt = nb.shape
    qn, beam = GIST_BATCH, 8
    rows = torch.randint(0, n, (qn, beam), generator=gen, device=dev, dtype=torch.int32)
    qs = 0.01 * torch.randn((qn, dt), generator=gen, device=dev)
    blocks = int(torch.unique(rows).numel())  # the distinct blocks the data needs
    call = lambda: gathermv.gather_block_scores(qs, rows, nb)  # noqa: E731
    rec = dict(
        ms=cuda_time_ms(call),
        plain_ms=cuda_time_ms(lambda: gathermv.gather_block_scores_plain(qs, rows, nb)),
        library_ms=None,  # no one PyTorch call gathers and reduces in one
        shape=f"Q={qn} BEAM={beam} m={m} Dt={dt} N={n} u8 ({blocks} distinct blocks)",
    )
    rec["bound_ms"], rec["bound_by"] = bound(
        blocks * m * dt + 4 * qn * dt + 4 * qn * beam + 4 * qn * beam * m,
        2 * qn * beam * m * dt, "f32")  # f32 FMA, no tensor cores
    done("gathermv", rec, call)
    return out


def scan_cost_runs(gist, batches, out_dir):
    """COST_RUNS measurements of the exact scan on phase 4's table (batch
    256), each a one-pass host time and a torch.profiler pass's device
    time. Returns (payload bytes, [(host s, device s) per search])."""
    import torch

    def search(qb):
        gist.search("vec", qb, k=K)

    runs = []
    for i in range(COST_RUNS):
        t0 = time.perf_counter()
        for qb in batches:
            search(qb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(batches)
        dev_ms, _, _ = device_trace(search, batches, os.path.join(out_dir, f"cost_scan_{i}.json"))
        runs.append((wall, 1e-3 * dev_ms / len(batches)))
    return int(gist.live_segments()[0].vector("vec").nbytes), runs


def spread(values):
    """(min, median, max)."""
    import statistics

    return min(values), statistics.median(values), max(values)


def cost_model(gist, scan, graph, hb, card, out_dir):
    """The H100 values of index/hnsw.py's routing constants, as medians
    over COST_RUNS runs, with their spread. Each run times the graph search
    (ef_s = 100) at batch 256 and at batch COST_SMALL_BATCH in turns, each
    by a one-pass host time and a torch.profiler pass's device time:
    ITER_PER_QUERY_S is the device time's slope per query per frontier
    iteration, ITER_FIXED_S the small batch's host time per iteration less
    its per-query part. The exact scan's runs (`scan`, from
    `scan_cost_runs`) give SCAN_BYTES_PER_S = payload bytes over device
    seconds and SCAN_FIXED_S = the host seconds the device does not cover.
    Then the routing of the HNSW cell (batch 256, ef_s 100, phase 4's
    payload) at the medians and at both corners of the spread."""
    import torch

    from myscaledb_tpu_torch.index import hnsw

    iters = hnsw.n_iterations(100)
    sb = COST_SMALL_BATCH
    small = [qb[i : i + sb] for qb in hb for i in range(0, len(qb), sb)][:COST_SMALL_BATCHES]

    def search(qb):
        gist.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph)

    def measure(batches, tag):
        """(host s, device s) per search: one pass each."""
        t0 = time.perf_counter()
        for qb in batches:
            search(qb)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(batches)
        dev_ms, _, _ = device_trace(search, batches, os.path.join(out_dir, f"cost_{tag}.json"))
        return wall, 1e-3 * dev_ms / len(batches)

    for qb in hb + small:  # warm-up
        search(qb)
    consts = {k: [] for k in ("SCAN_BYTES_PER_S", "SCAN_FIXED_S", "ITER_FIXED_S",
                              "ITER_PER_QUERY_S")}
    nbytes, scan_runs = scan
    for i in range(COST_RUNS):
        w_big, d_big = measure(hb, f"graph{GIST_BATCH}_{i}")
        w_small, d_small = measure(small, f"graph{sb}_{i}")
        per_q = (d_big - d_small) / iters / (GIST_BATCH - sb)
        consts["ITER_PER_QUERY_S"].append(per_q)
        consts["ITER_FIXED_S"].append(w_small / iters - sb * per_q)
        wall, dev = scan_runs[i]
        consts["SCAN_BYTES_PER_S"].append(nbytes / dev)
        consts["SCAN_FIXED_S"].append(max(wall - dev, 0.0))
        log(f"  run {i}: graph ef_s=100 host {1e3 * w_big:.4f} / device {1e3 * d_big:.4f} ms "
            f"per batch of {GIST_BATCH}, host {1e3 * w_small:.4f} / device {1e3 * d_small:.4f} "
            f"ms per batch of {sb}; exact scan host {1e3 * wall:.4f} / device {1e3 * dev:.4f} "
            f"ms per batch of {GIST_BATCH} over {nbytes} bytes  [{card}]")
    sp = {k: spread(v) for k, v in consts.items()}
    med = {k: v[1] for k, v in sp.items()}
    log("  cost model on this card (median of %d runs; min / max): " % COST_RUNS + ", ".join(
        f"{k} = {v[1]:.6g} ({v[0]:.6g} / {v[2]:.6g})" for k, v in sp.items()) + f"  [{card}]")

    def route(c):
        scan_s = c["SCAN_FIXED_S"] + nbytes / c["SCAN_BYTES_PER_S"]
        graph_s = iters * (c["ITER_FIXED_S"] + GIST_BATCH * c["ITER_PER_QUERY_S"])
        return ("scan" if scan_s < graph_s else "graph"), scan_s, graph_s

    # the corners: every constant at the end of its spread that favours
    # one route
    to_scan = dict(SCAN_BYTES_PER_S=sp["SCAN_BYTES_PER_S"][2], SCAN_FIXED_S=sp["SCAN_FIXED_S"][0],
                   ITER_FIXED_S=sp["ITER_FIXED_S"][2], ITER_PER_QUERY_S=sp["ITER_PER_QUERY_S"][2])
    to_graph = dict(SCAN_BYTES_PER_S=sp["SCAN_BYTES_PER_S"][0], SCAN_FIXED_S=sp["SCAN_FIXED_S"][2],
                    ITER_FIXED_S=sp["ITER_FIXED_S"][0], ITER_PER_QUERY_S=sp["ITER_PER_QUERY_S"][0])
    routes = {}
    for label, c in (("median", med), ("scan-favoured corner", to_scan),
                     ("graph-favoured corner", to_graph)):
        routes[label], scan_s, graph_s = route(c)
        log(f"  HNSW cell (batch {GIST_BATCH}, ef_s 100, {nbytes} bytes) at the {label}: "
            f"{routes[label]} (scan {1e3 * scan_s:.4f} ms, graph {1e3 * graph_s:.4f} ms)")
    if len(set(routes.values())) == 1:
        log(f"  the same route, {routes['median']}, at the medians and at both corners")
    else:
        deciders = [k for k in med if route({**med, k: to_graph[k]})[0] != routes["median"]
                    or route({**med, k: to_scan[k]})[0] != routes["median"]]
        log(f"  the routing of the HNSW cell turns within the spread; alone, {deciders} turn it")
    _, scan_s, graph_s = route(med)
    break_even = (graph_s - med["SCAN_FIXED_S"]) * med["SCAN_BYTES_PER_S"]
    log(f"  at the medians the graph beats the scan at batch {GIST_BATCH}, ef_s 100 only above "
        f"{break_even / 1e9:.4f} GB of payload")
    return med


# ---------------------------------------------------------------- phase 8
def check_hits_exact(table, queries, results, label):
    """Every hit is a live row whose score is the exact f32 L2 score of its
    stored row (2 q.x - |x|^2 over the widened bf16 values, `scores_ref`'s
    formula on that row alone), within F32_TOL."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric

    dev = table.device
    q = torch.from_numpy(queries).to(dev)
    scores = np.concatenate([r.scores for r in results])
    segs = np.concatenate([r.segments for r in results])
    rows = np.concatenate([r.rows for r in results])
    check((rows >= 0).all(), f"{label}: a query got fewer than {K} hits")
    want = np.full(rows.shape, np.nan, np.float32)
    for seg in table.live_segments():
        sel = segs == seg.segment_id
        if not sel.any():
            continue
        qi = torch.from_numpy(np.nonzero(sel)[0]).to(dev)
        r = torch.from_numpy(rows[sel].astype(np.int64)).to(dev)
        alive = seg.alive_mask_device()
        check(alive is None or bool(alive[r].all()), f"{label}: a deleted row came back")
        p = seg.vector("vec")
        x = p.data[r].to(torch.float32)
        qq = torch.nn.functional.pad(q[qi], (0, x.shape[1] - q.shape[1]))
        want[sel] = (2.0 * (qq * x).sum(-1) - p.aux_for(Metric.L2)[r]).cpu().numpy()
    ok = np.isclose(scores, want, **F32_TOL)
    check(ok.all(), f"{label}: {int((~ok).sum())} hits differ from their exact f32 scores "
          f"(worst {float(np.nanmax(np.abs(scores - want))):.6g})")


def ivf_recall(results, gt, queries):
    """(recall_ids@k, recall_dist@k) against the exact (scores, segments,
    rows) `gt`, as bench.py:431-441 counts them: ids by (segment, row),
    distances within the exact k-th one (1e-4 relative plus 1e-3)."""
    segs = np.concatenate([r.segments for r in results])
    rows = np.concatenate([r.rows for r in results])
    dist = np.concatenate([r.distances for r in results])
    gv, gs, gr = gt
    nq, k = rows.shape
    hits = sum(len(set(zip(segs[i].tolist(), rows[i].tolist()))
                   & set(zip(gs[i].tolist(), gr[i].tolist()))) for i in range(nq))
    qsq = np.einsum("ij,ij->i", queries, queries)
    kth = (qsq - gv[:, k - 1])[:, None]  # L2 distance = |q|^2 - score
    return hits / (nq * k), float((dist <= kth * (1 + 1e-4) + 1e-3).mean())


def counted(names, fn):
    """fn()'s result and how far each named counter moved in it."""
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    before = {n: GLOBAL_COUNTERS.get(n) for n in names}
    out = fn()
    return out, {n: GLOBAL_COUNTERS.get(n) - before[n] for n in names}


def ivf_path(dev, t, batches, queries, gt, card, args):
    """The IVF family on phase 3's SIFT table (1M-row segment indexed, the
    50k-row segment scanned by the score kernel): IVFFLAT's nprobe sweep,
    QPS at its operating point, a dyn_nprobe search, a filtered search
    through the index's WindowMask and one that falls back to the exact
    scan (tile_max); then IVFSQ, IVFPQ and a default MSTG one at a time."""
    import torch

    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.index import ivf
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    names = ("VectorIndexSearches", "VectorBruteForceSearches", "VectorIndexFallbackToFlat",
             "IvfWindowMaskBuilds", "IvfWindowMaskCacheHits")
    nb = len(batches)

    def search_all(params=None, flt=None, bs=batches, **kw):
        return counted(names, lambda: [t.search("vec", qb, k=K, metric="L2", params=params,
                                                filter=flt, **kw) for qb in bs])

    if args.profile:
        scan_ms, _, _ = device_trace(lambda qb: t.search("vec", qb, k=K, metric="L2"), batches,
                                     os.path.join(args.out, "trace_ivf_exact_scan.json"))
        log(f"  exact scan on this table before the index: device {scan_ms / nb:.4f} ms / search "
            f"(batch {SIFT_BATCH})  [{card}]")

    def build(name, **kw):
        t0 = time.perf_counter()
        t.add_vector_index(name, "vec", **kw)
        sync(dev)
        secs = time.perf_counter() - t0
        check(t.index_status(name) == {0: IndexStatus.LOADED, 1: IndexStatus.SMALL_PART},
              f"{name} did not load: {t.index_status(name)} {t.event_log.rows()[-1:]}")
        idx = t.loaded_index(0, "vec", Metric.L2)
        log(f"  {type(idx).kind.value} build {secs:.2f} s ({kw}; {idx.n_clusters} clusters, "
            f"{idx.n_windows} windows, wpp {idx.wpp}, codec {idx.codec}, index "
            f"{idx.memory_bytes / 1e9:.4f} GB)  [{card}]")
        return idx, secs

    idx, _ = build("ivf", type="IVFFLAT", ncentroids=IVF_NCENT, metric_type="L2")
    check(isinstance(idx, ivf.IVFFlatIndex) and idx.perm_data.dtype == torch.bfloat16,
          "the IVFFLAT index must hold the bf16 rows")

    def sweep_point(nprobe, label):
        res, b = search_all({"nprobe": nprobe})
        check(b["VectorIndexSearches"] == nb and b["VectorBruteForceSearches"] == nb,
              f"{label}: the 1M segment must go through the index, the 50k one the scan: {b}")
        check_hits_exact(t, queries, res, label)
        return ivf_recall(res, gt, queries)

    op = None
    for nprobe in IVF_NPROBES:
        rid, rdist = sweep_point(nprobe, f"IVFFLAT nprobe={nprobe}")
        log(f"  IVFFLAT nprobe={nprobe}: recall_ids@{K} {rid:.4f}, recall_dist {rdist:.4f} "
            f"({SIFT_NQ} queries; every hit exact within F32_TOL, none deleted)")
        if rid >= IVF_RECALL_TARGET:
            op = nprobe
            break
    check(op is not None, f"IVFFLAT never reached recall_ids@{K} {IVF_RECALL_TARGET}")

    def search_op(qb):
        return t.search("vec", qb, k=K, metric="L2", params={"nprobe": op})

    before = distance.scores.launches
    for qb in batches:
        search_op(qb)
    log(f"  IVFFLAT nprobe={op}: score launches per search "
        f"{(distance.scores.launches - before) / nb:g} (the 50k-row segment)")
    big = [queries[i : i + IVF_BIG_BATCH] for i in range(0, SIFT_NQ, IVF_BIG_BATCH)]
    rate = qps(search_op, batches, SIFT_BATCH)
    rate_big = qps(search_op, big, IVF_BIG_BATCH)
    res_big = [search_op(qb) for qb in big]
    check_hits_exact(t, queries, res_big, f"IVFFLAT nprobe={op} batch {IVF_BIG_BATCH}")
    log(f"  IVFFLAT operating point nprobe={op}: QPS {rate:.1f} (batch {SIFT_BATCH}), "
        f"{rate_big:.1f} (batch {IVF_BIG_BATCH}; recall_ids@{K} "
        f"{ivf_recall(res_big, gt, queries)[0]:.4f})  [{card}]")
    rid, rdist = sweep_point(IVF_DYN_NPROBE, f"IVFFLAT nprobe={IVF_DYN_NPROBE}")
    log(f"  IVFFLAT nprobe={IVF_DYN_NPROBE} (probe list sized by its pow2 bucket, the rest "
        f"masked): recall_ids@{K} {rid:.4f}, recall_dist {rdist:.4f}")

    # a filter through the index: 10% of the 1M segment, above the fallback
    hi, lo = IVF_FILTERS
    flt = F("id") < hi
    fres, b = search_all({"nprobe": op}, flt)
    check(b["VectorIndexSearches"] == nb and b["VectorIndexFallbackToFlat"] == 0,
          f"id < {hi} must search the 1M segment through the index: {b}")
    check(b["IvfWindowMaskBuilds"] == 1 and b["IvfWindowMaskCacheHits"] == nb - 1,
          f"id < {hi}: the window bitmap must be built once and then come from the cache: {b}")
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in fres])
    check((ids < hi).all(), f"every filtered IVF hit must pass id < {hi}")
    check_hits_exact(t, queries, fres, f"IVFFLAT id < {hi}")
    fgt = exact_topk(t, "vec", queries, K, Metric.L2, lambda s: s.scalar("id")[: s.n_rows] < hi)
    log(f"  IVFFLAT nprobe={op}, id < {hi}: WindowMask built once, {b['IvfWindowMaskCacheHits']} "
        f"cache hits, all {ids.size} hits pass; recall_ids@{K} "
        f"{ivf_recall(fres, fgt, queries)[0]:.4f}; QPS "
        f"{qps(lambda qb: t.search('vec', qb, k=K, metric='L2', params={'nprobe': op}, filter=flt), batches, SIFT_BATCH):.1f}"
        f"  [{card}]")
    # an over-selective filter: the exact masked scan, through tile_max
    flt = F("id") < lo
    tm = tilescan.tile_maxes.launches
    fres, b = search_all({"nprobe": op}, flt)
    check(b["VectorIndexFallbackToFlat"] == nb and b["VectorIndexSearches"] == 0,
          f"id < {lo} must fall back to the exact scan: {b}")
    check(tilescan.tile_maxes.launches > tm, f"id < {lo}: the fallback did not launch tile_max")
    log(f"  id < {lo}: fell back to the exact scan in all {nb} searches, tile_max launches per "
        f"search {(tilescan.tile_maxes.launches - tm) / nb:g}")
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in fres])
    check((ids < lo).all(), f"every fallback hit must pass id < {lo}")
    check_recall(f"IVFFLAT id < {lo} (fallback to the exact scan)", fres,
                 exact_topk(t, "vec", queries, K, Metric.L2,
                            lambda s: s.scalar("id")[: s.n_rows] < lo), F32_TOL)
    if args.profile:
        ivf_profile(t, idx, op, batches, search_op, card, args)
    t.drop_vector_index("ivf")

    # the other kinds, one at a time, at IVFFLAT's operating nprobe
    for name, kw in (("ivfsq", dict(type="IVFSQ", ncentroids=IVF_NCENT)),
                     ("ivfpq", dict(type="IVFPQ", ncentroids=IVF_NCENT)),
                     ("mstg", {})):
        idx, _ = build(name, **kw)
        label = f"{type(idx).kind.value} nprobe={op}"
        rid, rdist = sweep_point(op, label)
        log(f"  {label}: recall_ids@{K} {rid:.4f}, recall_dist {rdist:.4f}, QPS "
            f"{qps(search_op, batches, SIFT_BATCH):.1f} (batch {SIFT_BATCH}; every hit exact "
            f"within F32_TOL: re-ranked)  [{card}]")
        if name == "ivfpq":
            check(idx.perm_data.shape[1] == ivf._default_pq_m(SIFT_D) == 32,
                  "IVFPQ at 128-d takes M = 32 by default")
            log(f"  IVFPQ's codec limit: the exact re-rank of the {K * idx.rerank_multiple} best "
                f"ADC candidates over all rows (every cluster probed) has recall_ids@{K} "
                f"{pq_oracle_recall(t, idx, queries, gt, K * idx.rerank_multiple):.4f}")
        if name == "mstg":
            check(isinstance(idx, ivf.MSTGIndex) and idx.raw_data is
                  t.live_segments()[0].vector("vec").data,
                  "the default index is MSTG, re-ranking against the segment's own payload")
            res, b = search_all()
            check(b["VectorIndexSearches"] == nb, f"MSTG default search: {b}")
            check_hits_exact(t, queries, res, "MSTG default params")
            log(f"  MSTG at its default nprobe ({ivf.DEFAULT_NPROBE}): recall_ids@{K} "
                f"{ivf_recall(res, gt, queries)[0]:.4f}")
            res, b = search_all({"nprobe": op}, two_stage=True)
            check(b["VectorIndexSearches"] == 0 and b["VectorBruteForceSearches"] == nb,
                  f"two_stage_search=1: the MSTG segment takes the first-stage path: {b}")
            check_hits_exact(t, queries, res, "MSTG two-stage")
            log(f"  MSTG nprobe={op}, two_stage_search=1: recall_ids@{K} "
                f"{ivf_recall(res, gt, queries)[0]:.4f}")
        t.drop_vector_index(name)


def pq_oracle_recall(t, idx, queries, gt, ncand):
    """recall_ids@k of the best a PQ first stage can hand its exact
    re-rank: the `ncand` rows of the 1M segment with the highest ADC
    scores (decoded codes), re-scored exactly, merged with the exact top-k
    of the scanned segments."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import quantize

    seg = t.live_segments()[0]
    p = seg.vector("vec")
    live = idx.perm_rows >= 0
    rows = idx.perm_rows[live].to(torch.int64)
    dec = quantize.pq_decode_dev(idx.perm_data[live], idx.codec_a).to(torch.float32)
    q = torch.from_numpy(queries).to(dec.device)
    adc = 2.0 * q @ dec.T - idx.perm_aux[live][None, :]
    alive = seg.alive_mask_device()
    if alive is not None:
        adc = adc.masked_fill(~alive[rows][None, :], float("-inf"))
    cand = rows[torch.topk(adc, ncand, dim=1).indices]  # [Q, ncand] segment rows
    del dec, adc
    x = p.data[cand].to(torch.float32)[..., : q.shape[1]]
    exact = 2.0 * torch.einsum("qd,qcd->qc", q, x) - p.aux_for(Metric.L2)[cand]
    best = torch.topk(exact, K, dim=1)
    got = [set(zip([seg.segment_id] * K, r)) for r in torch.gather(cand, 1, best.indices).tolist()]
    gv, gs, gr = gt
    hits = 0
    for i in range(len(queries)):
        want = set(zip(gs[i].tolist(), gr[i].tolist()))
        # the scanned segments' hits are exact: count them as found
        hits += len(want & got[i]) + sum(s != seg.segment_id for s, _ in want)
    return hits / (len(queries) * K)


def ivf_profile(t, idx, op, batches, search_op, card, args):
    """--profile's ivf_flat cell (operating nprobe, batch 100), with the
    window step's gathered bytes per search: the bf16 windows read by the
    gather and the f32 copy the decode writes."""
    from myscaledb_tpu_torch.index import ivf
    from myscaledb_tpu_torch.index.base import split_dyn_nprobe

    log(f"[8p] where the time goes on {card}")
    profile_cells([("ivf_flat", search_op, batches)], PROFILE_RUNS, args.out, card)
    (_, bucket), = split_dyn_nprobe((("nprobe", op),))[0]
    p = min(bucket, idx.n_clusters)
    w = int(min(idx.n_windows + p, p * idx.wpp + 4))
    elems = SIFT_BATCH * w * ivf.WINDOW * idx.perm_data.shape[1]
    log(f"  ivf_flat window step: {w} windows per query (nprobe bucket {p}, wpp {idx.wpp}); "
        f"gathered per search {2 * elems / 1e6:.1f} MB of bf16 rows read and {4 * elems / 1e6:.1f} "
        f"MB of f32 copy written; the exact scan reads {t.live_segments()[0].vector('vec').nbytes / 1e6:.1f}"
        f" MB for the 1M segment")


def hnswpq_path(ms, dev, t, batches, queries, card):
    """HNSWPQ on phase 4's GIST table (after phase 6's HNSWFLAT is
    dropped): build, the graph search at ef_s 100 with routing off, and
    recall_ids@10 against the exact results over the rows still live."""
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import gathermv

    t.drop_vector_index("h")
    t0 = time.perf_counter()
    t.add_vector_index("hpq", "vec", type="HNSWPQ", metric_type="Cosine", **HNSWPQ_PARAMS)
    sync(dev)
    secs = time.perf_counter() - t0
    check(t.index_status("hpq") == {0: IndexStatus.LOADED},
          f"HNSWPQ build did not load: {t.index_status('hpq')} {t.event_log.rows()[-1:]}")
    idx = t.loaded_index(0, "vec", Metric.COSINE)
    check(idx.codec == "pq" and idx.nbdata is not None,
          "HNSWPQ must hold PQ codes and node blocks for the gathermv kernel")
    log(f"  HNSWPQ build {secs:.2f} s ({HNSWPQ_PARAMS}, M {idx.data.shape[1]}; index "
        f"{idx.memory_bytes / 1e9:.4f} GB)  [{card}]")
    graph = ms.Settings()
    graph.query.cost_based_index_routing = False
    before = gathermv.gather_block_scores.launches
    res = [t.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph) for qb in batches]
    sync(dev)
    n_launch = gathermv.gather_block_scores.launches - before
    check(n_launch > 0, "HNSWPQ's search did not launch gathermv")
    gt = exact_topk(t, "vec", queries, K, Metric.COSINE)
    rid, rdist = graph_recall(res, gt)
    rate = qps(lambda qb: t.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph),
               batches, GIST_BATCH)
    log(f"  HNSWPQ ef_s=100: recall_ids@{K} {rid:.4f}, recall_dist {rdist:.4f} (against the "
        f"exact results over the live rows), {n_launch} gathermv launches "
        f"({n_launch / len(batches):g} per search), QPS {rate:.1f} "
        f"(batch {GIST_BATCH})  [{card}]")
    for r in res:
        check(np.isfinite(r.distances).all(), "HNSWPQ returned a non-finite distance")
    t.drop_vector_index("hpq")


# ---------------------------------------------------------------- main
def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="show where each cell's time goes (phases 5 and 6)")
    ap.add_argument("--out", default=os.path.join("myscaledb_tpu_torch", "_build", "profile"),
                    help="directory for --profile's traces and host profiles")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to drive",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "myscaledb_tpu_torch")):
        print("chip_smoke: run it from a checkout: myscaledb_tpu_torch/ is missing",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    import myscaledb_tpu_torch as ms
    from myscaledb_tpu_torch.ops import _cuda, distance, gathermv, tilescan

    # ---- 1. set-up
    card = card_line()
    dev = torch.device("cuda", 0)
    _cuda.set_exact_precision()  # the plain versions' matmuls in f32, not TF32
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card)  # name and power limit, as nvidia-smi prints them
    t0 = time.perf_counter()
    _cuda.LIBRARY.get()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.LIBRARY.build_seconds:.2f} s) -> {_cuda.LIBRARY.path}")
    log_ptxas(_cuda.LIBRARY.ptxas_log())

    # ---- 2. kernels vs their plain versions
    log("[2] kernels vs plain versions on the card")
    errs = compare_kernels(dev)
    errs["gathermv"] = compare_gathermv(dev)

    # ---- 3./4. the exact paths, with their launch counters zeroed
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    log("[3] SIFT1M-shaped exact path (1,000,000 + 50,000 rows x 128, L2, batch 100, k=10)")
    sift, sift_batches, flt, sift_queries, sift_gt = sift_path(ms, dev)
    log("[4] GIST-shaped exact path (100,000 x 960, Cosine, batch 256, k=10)")
    gist, gist_batches, gist_gt = gist_path(ms, dev)
    launches = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches}
    log(f"  kernel launches on the exact paths: {launches}")
    for name in ("score", "tile_max"):
        check(launches[name] > 0, f"kernel {name} was not launched on the exact paths")

    # ---- 5. the exact paths' QPS (before phase 6 indexes the GIST table)
    log(f"[5] exact-path QPS on {card}")
    sift_qps = qps(lambda qb: sift.search("vec", qb, k=K, metric="L2"), sift_batches, SIFT_BATCH)
    sift_fqps = qps(lambda qb: sift.search("vec", qb, k=K, metric="L2", filter=flt),
                    sift_batches, SIFT_BATCH)
    gist_qps = qps(lambda qb: gist.search("vec", qb, k=K), gist_batches, GIST_BATCH)
    gist_scan = scan_cost_runs(gist, gist_batches, args.out)
    log(f"  SIFT1M-shaped exact L2 QPS (batch 100, k=10): {sift_qps:.1f}  [{card}]")
    log(f"  SIFT1M-shaped filtered (id<10000) QPS: {sift_fqps:.1f}  [{card}]")
    log(f"  GIST-shaped exact Cosine QPS (batch 256, k=10): {gist_qps:.1f}  [{card}]")
    if args.profile:
        log(f"[5p] where the time goes on {card}")
        profile_cells([
            ("sift_exact", lambda qb: sift.search("vec", qb, k=K, metric="L2"), sift_batches),
            ("sift_filtered", lambda qb: sift.search("vec", qb, k=K, metric="L2", filter=flt),
             sift_batches),
            ("gist_exact", lambda qb: gist.search("vec", qb, k=K), gist_batches),
        ], PROFILE_RUNS, args.out, card)

    # ---- 6. the HNSW path, with the gathermv launch counter zeroed
    log("[6] HNSW path on phase 4's table (HNSWFLAT m=32 ef_c=100, Cosine, batch 256, k=10)")
    gathermv.gather_block_scores.launches = 0
    graph, hb, idx, _ = hnsw_path(ms, dev, gist, gist_batches, gist_gt, card)
    launches["gathermv"] = gathermv.gather_block_scores.launches
    log(f"  gathermv launches on the HNSW path: {launches['gathermv']}")
    check(launches["gathermv"] > 0, "kernel gathermv was not launched on the HNSW path")
    if args.profile:
        log(f"[6p] where the time goes on {card}")
        profile_cells([("hnsw_graph_ef100", lambda qb: gist.search(
            "vec", qb, k=K, params={"ef_s": 100}, settings=graph), hb)],
            PROFILE_RUNS, args.out, card)

    # ---- 7. times
    log(f"[7] times on {card}")
    timing = time_kernels(dev, idx, card)
    cost_model(gist, gist_scan, graph, hb, card, args.out)

    # ---- 8. the IVF family and HNSWPQ, with the launch counters zeroed
    log(f"[8] IVF path on phase 3's table (IVFFLAT ncentroids={IVF_NCENT}, then IVFSQ, IVFPQ "
        f"and a default MSTG; L2, k=10) and HNSWPQ on phase 4's")
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    gathermv.gather_block_scores.launches = 0
    ivf_path(dev, sift, sift_batches, sift_queries, sift_gt, card, args)
    hnswpq_path(ms, dev, gist, gist_batches, np.concatenate(gist_batches), card)
    p8 = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
          "gathermv": gathermv.gather_block_scores.launches}
    log(f"  kernel launches on the IVF and HNSWPQ paths: {p8}")
    for name, n in p8.items():
        check(n > 0, f"kernel {name} was not launched on phase 8's paths")
        launches[name] += n

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    record = {"kernels": [
        {"name": "score", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/score.cu",
         "replaces": "myscaledb_tpu/ops/distance.py:57",
         "launches": launches["score"], "max_abs_err": errs["score"],
         **{k: timing["score"][k] for k in keys}},
        {"name": "tile_max", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/tile_max.cu",
         "replaces": "myscaledb_tpu/ops/tilescan.py:66",
         "launches": launches["tile_max"], "max_abs_err": errs["tile_max"],
         **{k: timing["tile_max"][k] for k in keys}},
        {"name": "gathermv", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/gathermv.cu",
         "replaces": "myscaledb_tpu/ops/gathermv.py:52",
         "launches": launches["gathermv"], "max_abs_err": errs["gathermv"],
         **{k: timing["gathermv"][k] for k in keys}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
