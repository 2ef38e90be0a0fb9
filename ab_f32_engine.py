#!/usr/bin/env python3
"""Same-call A/B of the f32 (3xTF32) scan engine against variants of it.

    python3 ab_f32_engine.py [--out DIR]

Run from the root of a checkout on a machine with one H100. Each variant is
the engine of myscaledb_tpu_torch/csrc/ with one textual change, copied to
DIR/<variant>/ (default myscaledb_tpu_torch/_build/ab/), built by nvcc into
its own library (all builds started together) and called through its C
entry points (`msd_scores_f32`, `msd_tile_max_f32`) on the same tensors:
clustered data as bench.py makes it (rows around 1,000 centres of
6 x N(0, 1)), queries near rows. For each shape the variants run in turns
(a, b, ..., ..., b, a), each timed with chip_smoke's `cuda_time_ms`, and
each output is held to `distance.kernel_error_bound`; a variant marked
timing-only computes something else on purpose and is not held to it.

Variants:
  final            the engine as it is
  one_accumulator  one accumulator for a tile's whole depth (no part sums)
  parts_1, parts_2 a part accumulator every 1 or 2 chunks (final: 4)
  nt128            Q <= 128 in one 128-query tile (no 104 width)
  two_products     timing only: x_hi.q_hi + x_hi.q_lo (no x_lo.q_hi)
  no_shuffles      timing only: tile_max without its three shfl_xor folds
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "myscaledb_tpu_torch", "csrc")
PART = "constexpr int PART_CHUNKS = 4;"
SHUFFLES = """                            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
                            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
                            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
"""
THIRD = "                        wgmma_tf32<NT>(part, xl[i], dh + 2 * i, 1);\n"
# name -> ((old, new) edits of score_tile.cuh, query widths, held to the bound)
VARIANTS = {
    "final": ((), None, True),
    "one_accumulator": (((PART, "constexpr int PART_CHUNKS = 1 << 20;"),), None, True),
    "parts_1": (((PART, "constexpr int PART_CHUNKS = 1;"),), None, True),
    "parts_2": (((PART, "constexpr int PART_CHUNKS = 2;"),), None, True),
    "nt128": ((), (64, 128), True),
    "two_products": (((THIRD, ""),), None, False),
    "no_shuffles": (((SHUFFLES, ""),), None, False),
}
# (kernel, Q, N, D, metric): a host-tier stream chunk, a spilled 128-d chunk,
# the SIFT f32 table's 1M segment, the GIST f32 segment
SHAPES = [("score", 104, 131_072, 1024, "L2"), ("tile_max", 104, 131_072, 1024, "L2"),
          ("score", 104, 131_072, 128, "L2"), ("tile_max", 104, 131_072, 128, "L2"),
          ("tile_max", 104, 1_048_576, 128, "L2"), ("score", 256, 114_688, 1024, "Cosine"),
          ("score", 104, 131_072, 1024, "IP")]


def build(out_dir, nvcc, flags):
    """Copy csrc/ per variant, apply its edits, build all libraries in
    parallel; returns name -> ctypes library."""
    procs = {}
    for name, (edits, _, _) in VARIANTS.items():
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        path = os.path.join(d, "score_tile.cuh")
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: the edit does not apply once")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", lib, os.path.join(d, "score.cu"),
             os.path.join(d, "tile_max.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].msd_scores_f32.argtypes = [vp] * 5 + [ci] * 9 + [vp]
        libs[name].msd_tile_max_f32.argtypes = [vp] * 6 + [ci] * 9 + [vp]
    return libs


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "myscaledb_tpu_torch", "_build", "ab"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_f32_engine: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import _cuda, distance, tilescan

    dev = torch.device("cuda", 0)
    _cuda.set_exact_precision()
    card = cs.card_line()
    libs = build(args.out, _cuda._nvcc(), _cuda.NVCC_FLAGS)
    sms = distance.sm_count(dev)

    def call(name, kernel, qs, x, aux, m8, out, metric):
        q, (n, d) = qs.shape[0], x.shape
        widths = VARIANTS[name][1] or distance.F32_WIDTHS
        old, distance.F32_WIDTHS = distance.F32_WIDTHS, widths
        try:
            g = distance.f32_scan_geometry.__wrapped__(q, n, d, sms)
        finally:
            distance.F32_WIDTHS = old
        split = torch.empty((2 * g.qp, g.dp), dtype=torch.float32, device=dev)
        ptrs = [qs.data_ptr(), split.data_ptr(), x.data_ptr(),
                aux.data_ptr() if aux is not None else None]
        if kernel == "tile_max":
            ptrs.append(m8.data_ptr())
        fn = libs[name].msd_tile_max_f32 if kernel == "tile_max" else libs[name].msd_scores_f32
        err = fn(*ptrs, out.data_ptr(), q, n, d, _cuda.METRIC_CODES[metric.value], g.nt,
                 g.stages, int(g.resident), g.smem_bytes, g.grid, torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"{name}: launch failed ({err})")

    gen = torch.Generator(device=dev).manual_seed(0)
    names = list(VARIANTS)
    for kernel, q, n, d, mname in SHAPES:
        metric = Metric(mname)
        centres = 6.0 * torch.randn((1000, d), generator=gen, device=dev)
        x = centres[torch.randint(0, 1000, (n,), generator=gen, device=dev)]
        x += torch.randn((n, d), generator=gen, device=dev)
        qs = x[torch.randint(0, n, (q,), generator=gen, device=dev)]
        qs = distance.normalize_queries(
            qs + 0.3 * torch.randn((q, d), generator=gen, device=dev), metric).contiguous()
        aux = distance.base_aux(x, metric)
        m8 = torch.ones(n, dtype=torch.uint8, device=dev)
        if kernel == "score":
            out = torch.empty((q, n), device=dev)
            want = distance.scores_plain(qs, x, aux, metric)
            bound = distance.kernel_error_bound(qs, x, aux, metric)
        else:
            aux = aux if aux is not None else torch.zeros(n, device=dev)
            out = torch.empty((q, n // tilescan.SUB), device=dev)
            want = tilescan.tile_maxes_plain(qs, x, aux, m8, metric)
            bound = tilescan.tile_error_bound(qs, x, aux, metric)
        ratio = {}
        for name in names:
            call(name, kernel, qs, x, aux, m8, out, metric)
            torch.cuda.synchronize()
            ratio[name] = float(((out - want).abs()
                                 / (bound + distance.KERNEL_RTOL * want.abs())).max())
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(cs.cuda_time_ms(
                lambda: call(name, kernel, qs, x, aux, m8, out, metric)))
        cs.log(f"{kernel} Q={q} N={n} D={d} {mname} clustered  [{card}]")
        for name in names:
            held = VARIANTS[name][2]
            cs.log(f"  {name:16s} {times[name][0]:.4f} {times[name][1]:.4f} ms; worst err/bound "
                   f"{ratio[name]:.3f}{'' if held else ' (timing only)'}")
            if held and name != "one_accumulator":
                cs.check(ratio[name] <= 1.0, f"{name} lies outside the bound at {kernel} Q={q}")
        del x, qs, aux, out, want, bound
    return 0


if __name__ == "__main__":
    sys.exit(main())
