"""Multi-device execution: corpus sharding, top-k merge, sharded k-means.

Counterpart of myscaledb_tpu/parallel/distributed.py. The JAX package runs
each function as one single-controller SPMD program (`shard_map`) over a
`jax.sharding.Mesh`. The port keeps the single controller: one process
holds a grid of torch devices (`Mesh`), rows along the "query" axis and
columns along the "data" axis, and

  * a row-sharded array is a list of per-shard tensors, shard d on the
    data axis's device d (the grid's first row); an array stacked per
    shard ([S, ...], an index's layout) is a list of [1, ...] parts, as
    `shard_map` hands its body a [1, ...] block;
  * each `local(...)` body of a `shard_map` is a `Leg`: a plain function
    over one shard's tensors, run for each query group and data shard on
    that grid entry's device (the query axis splits the padded batch
    into `query_axis` groups, group q on row q of the grid), with a
    combine on the grid's first device (the top-k merge, or the Lloyd
    step's sum and update);
  * the ICI collectives are the two functions under "collectives" below:
    copies onto one merging device and a sum in shard order.

Legs run two ways. `run_legs` runs them eagerly (the public
`distributed_*` functions, `sharded_lloyd_step`): each item on its device
in turn, operands and query rows copied there when they live elsewhere.
A `MeshProgram` runs them as one program a device of the grid (the
counterpart of the `shard_map` program under `jax.jit`; MeshTable's
searches and the two fused steps): on a one-card grid one CUDA graph holds
every shard's body, the merge and the tail; across cards each card's graph
holds its own shards, their outputs are copied onto the first card
between the graphs, and its graph holds the merge (search/program.py::
GridProgram).

A device may repeat in the grid: that is the counterpart of XLA's virtual
CPU devices. The tests use eight `cpu` entries, and four `cuda:0` entries
put four shards on one card.
"""

from __future__ import annotations

import contextlib
import math
import types
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..metrics import Metric
from ..ops import kmeans
from ..ops.bruteforce import scan_topk_t
from ..ops.topk import NEG_INF, topk_stable

AXES = ("query", "data")


def _device(d) -> torch.device:
    """A grid entry as a torch.device: "cuda" needs a visible card (the
    index must exist), "cpu" is the CPU, nothing else is accepted."""
    from ..api.client import resolve_device

    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {d!r} requested but only {torch.cuda.device_count()} CUDA devices are visible"
        )
    return dev


class Mesh:
    """An immutable grid of torch devices with axis names ("query",
    "data"): `devices[q][d]` runs query group q's work on data shard d.
    A flat list is one row (query axis 1). `shape` maps each axis name to
    its length, as `jax.sharding.Mesh.shape` does."""

    def __init__(self, devices, axis_names: Tuple[str, str] = AXES):
        rows = list(devices)
        if rows and not isinstance(rows[0], (list, tuple)):
            rows = [rows]
        grid = tuple(tuple(_device(d) for d in row) for row in rows)
        if not grid or not grid[0] or any(len(r) != len(grid[0]) for r in grid):
            raise ValueError("Mesh needs a non-empty rectangular grid of devices")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = types.MappingProxyType(
            {self.axis_names[0]: len(grid), self.axis_names[1]: len(grid[0])}
        )

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The devices that hold the data shards (the grid's first row)."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[[str(d) for d in row] for row in self.devices]}, {self.axis_names})"


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    query_axis: int = 1,
    axis_names: Tuple[str, str] = AXES,
    device: str = "cuda",
) -> Mesh:
    """A query_axis x (n / query_axis) grid over the first n cards (all
    visible cards by default). It raises when fewer cards exist than
    asked for; `Mesh([[torch.device("cuda:0")] * n])` puts n shards on one
    card. device="cpu" gives n CPU entries (1 by default)."""
    if torch.device(device).type == "cpu":
        n = n_devices or 1
        devs = [torch.device("cpu")] * n
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"make_mesh({n_devices}) asks for CUDA devices but torch.cuda.is_available() "
                "is False; pass device='cpu' for the CPU"
            )
        avail = torch.cuda.device_count()
        n = n_devices or avail
        if n > avail:
            raise RuntimeError(
                f"make_mesh({n}) needs {n} CUDA devices and {avail} are visible; to put "
                f"several shards on one card, build the grid: "
                f"Mesh([[torch.device('cuda:0')] * {n}])"
            )
        devs = [torch.device("cuda", i) for i in range(n)]
    if n % query_axis:
        raise ValueError(f"n_devices={n} not divisible by query_axis={query_axis}")
    cols = n // query_axis
    return Mesh([devs[r * cols : (r + 1) * cols] for r in range(query_axis)], axis_names)


def _current(dev: torch.device):
    """Make `dev` the current CUDA device for a shard's work: the hand
    kernels launch on the current device (their stream, shared-memory
    attributes and SM count are that device's). Nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on `dev`: itself when it is there already, else a copy."""
    return t if t.device == dev else t.to(dev, non_blocking=True)


def _tensor(x) -> torch.Tensor:
    """A tensor over `x`: itself, or a numpy array's storage (copied first
    when it is read-only or not contiguous)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a)


def shard_rows(mesh: Mesh, host_array) -> List[torch.Tensor]:
    """Split [N, ...] rows into one equal slice per data shard, slice d on
    the data axis's device d. N must divide evenly (pad first)."""
    x = _tensor(host_array)
    n_data = mesh.shape["data"]
    if x.shape[0] % n_data:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over {n_data} shards")
    per = x.shape[0] // n_data
    return [_to(x[d * per : (d + 1) * per], dev).contiguous()
            for d, dev in enumerate(mesh.data_devices)]


def replicate(mesh: Mesh, host_array) -> List[torch.Tensor]:
    """One copy of the array per data shard on its device (shards on the
    same device share one copy)."""
    x = _tensor(host_array)
    copies = {}
    out = []
    for dev in mesh.data_devices:
        if dev not in copies:
            copies[dev] = _to(x, dev).contiguous()
        out.append(copies[dev])
    return out


# ------------------------------------------------------------ collectives
def all_gather(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The shards' tensors stacked on `dst` in shard order: [S, ...]."""
    return torch.stack([_to(p, dst) for p in parts])


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards' tensors summed in shard order on the first shard's
    device; each shard gets the total on its own device (one copy per
    distinct device)."""
    dst = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + _to(p, dst)
    copies = {dst: total}
    out = []
    for p in parts:
        if p.device not in copies:
            copies[p.device] = _to(total, p.device)
        out.append(copies[p.device])
    return out


# ------------------------------------------------------------------- legs
class Fresh:
    """An operand that a program copies in on every run (a filter's mask):
    `key` names it among the run's inputs, `shape` and `dtype` size its
    buffer."""

    __slots__ = ("key", "shape", "dtype")

    def __init__(self, key, shape, dtype):
        self.key, self.shape, self.dtype = key, tuple(shape), dtype


class Leg:
    """One `shard_map` body of a mesh computation. `fn(d, q, *ops)` is
    data shard d's work -> a tuple of tensors, run for every query group
    and data shard (`grouped`: q is the group's rows of the leg's query) or
    once a data shard over the whole query; `ops[d]` are shard d's
    operands (tensors on its device, `Fresh` inputs in a program);
    `specs(rows)` the shapes and types of fn's outputs for an input of
    `rows` rows; `combine(per_group, dst)` makes the leg's result on the
    merging device `dst` from the outputs [group][shard]; `view(q)` takes
    the leg's query out of a program's packed input (None: all of it)."""

    __slots__ = ("fn", "ops", "specs", "combine", "grouped", "view")

    def __init__(self, fn, ops, specs, combine, *, grouped=True, view=None):
        self.fn, self.ops, self.specs, self.combine = fn, ops, specs, combine
        self.grouped, self.view = grouped, view

    def rows(self, mesh: Mesh, rows: int) -> int:
        """The query rows of one of its items."""
        return rows // mesh.shape["query"] if self.grouped else rows

    def items(self, mesh: Mesh):
        """(query group, data shard) of every item."""
        if self.grouped:
            return [(qi, d) for qi in range(mesh.shape["query"]) for d in range(mesh.shape["data"])]
        return [(0, d) for d in range(mesh.shape["data"])]


def _operands(x, n: int) -> List:
    """Shard d's operand of x for every shard: element d of a list of
    parts, or the whole of a replicated tensor / array."""
    if isinstance(x, (list, tuple)):
        return [p if isinstance(p, Fresh) else _tensor(p) for p in x]
    t = _tensor(x)
    return [t] * n


def _group(q: Optional[torch.Tensor], leg: Leg, mesh: Mesh, qi: int):
    if q is None or not leg.grouped:
        return q
    per = q.shape[0] // mesh.shape["query"]
    return q[qi * per : (qi + 1) * per]


def run_legs(mesh: Mesh, queries, legs: Sequence[Leg]) -> List[tuple]:
    """The legs run eagerly: every item's body on its grid device (the
    current device while it runs, its operands and query rows copied
    there when they live elsewhere), then each leg's combine on the grid's
    first device."""
    q_all = None if queries is None else _tensor(queries)
    n_groups = mesh.shape["query"]
    if q_all is not None and q_all.shape[0] % n_groups:
        raise ValueError(f"{q_all.shape[0]} queries do not split over query axis {n_groups}")
    dst = mesh.devices[0][0]
    out = []
    for leg in legs:
        q_leg = q_all if leg.view is None or q_all is None else leg.view(q_all)
        per_group: List[List[tuple]] = [[] for _ in range(n_groups if leg.grouped else 1)]
        for qi, d in leg.items(mesh):
            dev = mesh.devices[qi][d]
            q = _group(q_leg, leg, mesh, qi)
            with _current(dev):
                per_group[qi].append(leg.fn(d, None if q is None else _to(q, dev),
                                            *(_to(o, dev) for o in leg.ops[d])))
        out.append(leg.combine(per_group, dst))
    return out


def _merge_groups(per_group, k: int, dst: torch.device):
    """Each group's shard lists merged on `dst`, the groups stacked."""
    outs = [_merge([v for v, _ in g], [r for _, r in g], k, dst) for g in per_group]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([v for v, _ in outs]), torch.cat([r for _, r in outs])


def _topk_leg(fn, ops, k: int, *, grouped=True, view=None, rows=None) -> Leg:
    """A leg whose items return ([Q', k] scores, global rows), merged a
    group (`_merge`). `rows`: the items' fixed query rows (else the
    input's)."""
    def specs(n):
        n = rows if rows is not None else n
        return [((n, k), torch.float32), ((n, k), torch.int32)]

    return Leg(fn, ops, specs, lambda per_group, dst: _merge_groups(per_group, k, dst),
               grouped=grouped, view=view)


# ---------------------------------------------------------------- programs
def _graph_key(mesh: Mesh, qi: int, d: int):
    """The graph that runs the grid entry's work: one a device."""
    from ..search.program import normalize_device

    return normalize_device(mesh.devices[qi][d])


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """4-byte tensors as one int32 vector, in order."""
    return torch.cat([t.contiguous().view(torch.int32).reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, specs) -> List[torch.Tensor]:
    out, off = [], 0
    for shape, dtype in specs:
        n = math.prod(shape)
        out.append(flat[off : off + n].view(dtype).view(shape))
        off += n
    return out


class MeshProgram:
    """The legs and their tail as one program a device of the grid
    (search/program.py::GridProgram), the counterpart of a `shard_map`
    program under `jax.jit`. Every device gets the host input (`query`:
    (shape, dtype)) and runs its items; the graph of the grid's first
    device runs last: its items, every leg's combine over those and the
    other devices' outputs (copied in), then `tail(results)`, the
    program's output (`out_specs`). An operand is read in place where the
    item runs on its shard's device, else copied in on every run, as a
    `Fresh` operand is. `run(queries, fresh)` -> the output tensors (views
    of one copy on the first device)."""

    def __init__(self, mesh: Mesh, legs: Sequence[Leg], tail: Callable, *, query, out_specs,
                 label: str):
        from ..search.program import GridProgram, Program, normalize_device

        self.out_specs = list(out_specs)
        rows = query[0][0]
        first = _graph_key(mesh, 0, 0)
        work = {first: []}
        for li, leg in enumerate(legs):
            for qi, d in leg.items(mesh):
                work.setdefault(_graph_key(mesh, qi, d), []).append((li, qi, d))
        keys = [g for g in work if g != first] + [first]  # the merging graph last
        item_specs = {g: [s for li, _, _ in work[g]
                          for s in legs[li].specs(legs[li].rows(mesh, rows))] for g in keys}
        parts, self.sources = [], []
        for g in keys:
            sources, own, items = [], [], []
            _, qi0, d0 = work[g][0]
            dev = normalize_device(mesh.devices[qi0][d0])
            for li, qi, d in work[g]:
                ops = []
                for o in legs[li].ops[d]:
                    if (isinstance(o, Fresh) or _graph_key(mesh, 0, d) != g
                            or normalize_device(o.device) != dev):
                        ops.append(len(sources))  # an input buffer's position
                        sources.append(o)
                    else:
                        ops.append(o)
                        own.append(o)
                items.append((li, qi, d, ops))
            inputs = [(o.shape, o.dtype) if isinstance(o, Fresh) else (tuple(o.shape), o.dtype)
                      for o in sources]
            if g == first:
                inputs += [((_numel(item_specs[p]),), torch.int32) for p in keys[:-1]]
                body = _merge_body(mesh, legs, tail, items, [work[p] for p in keys[:-1]],
                                   [item_specs[p] for p in keys[:-1]])
                n_out = _numel(self.out_specs)
            else:
                body = _part_body(mesh, legs, items)
                n_out = _numel(item_specs[g])
            parts.append(Program(body, device=dev, query=query, masks=inputs,
                                 out_shape=(n_out,), label=label, refs=own))
            self.sources.append(sources)
        self.grid = GridProgram(parts)

    @property
    def parts(self):
        return self.grid.parts

    def run(self, queries, fresh=None) -> List[torch.Tensor]:
        fresh = fresh or {}
        inputs = [[fresh[o.key] if isinstance(o, Fresh) else o for o in srcs]
                  for srcs in self.sources]
        return _unflat(self.grid.run(queries, inputs), self.out_specs)


def _numel(specs) -> int:
    return sum(math.prod(shape) for shape, _ in specs)


def _run_items(mesh, legs, items, q, bufs):
    """Each item's body over its operands (in place or an input buffer)
    and its query rows: {(leg, group, shard): outputs}."""
    views = [q if leg.view is None else leg.view(q) for leg in legs]
    return {(li, qi, d): legs[li].fn(d, _group(views[li], legs[li], mesh, qi),
                                     *(bufs[o] if isinstance(o, int) else o for o in ops))
            for li, qi, d, ops in items}


def _part_body(mesh, legs, items):
    def body(q, bufs, dyn):
        del dyn
        return _flat([t for out in _run_items(mesh, legs, items, q, bufs).values() for t in out])

    return body


def _merge_body(mesh, legs, tail, items, part_work, part_specs):
    def body(q, bufs, dyn):
        del dyn
        got = _run_items(mesh, legs, items, q, bufs)
        flats = bufs[len(bufs) - len(part_work):]
        for flat, work, specs in zip(flats, part_work, part_specs):
            outs = iter(_unflat(flat, specs))
            for li, qi, d in work:  # the part's outputs, in its items' order
                got[(li, qi, d)] = tuple(next(outs) for _ in legs[li].specs(1))
        results = []
        for li, leg in enumerate(legs):
            per_group = [[] for _ in range(mesh.shape["query"] if leg.grouped else 1)]
            for qi, d in leg.items(mesh):
                per_group[qi].append(got[(li, qi, d)])
            results.append(leg.combine(per_group, q.device))
        return _flat(tail(results))

    return body



# ---------------------------------------------------------------- helpers
def _merge(vs, rs, k: int, dst: torch.device):
    """Gather the shards' [Q, k] lists onto `dst`, then one top-k over the
    [Q, S·k] candidates (ties: lower shard first, as `lax.top_k`); -1
    where the score is not finite."""
    gv = all_gather(vs, dst)  # [S, Q, k]
    gr = all_gather(rs, dst)
    nq = gv.shape[1]
    gv = gv.transpose(0, 1).reshape(nq, -1)
    gr = gr.transpose(0, 1).reshape(nq, -1)
    mv, pos = topk_stable(gv, k)
    mr = torch.gather(gr, 1, pos.to(torch.int64))
    return mv, torch.where(torch.isfinite(mv), mr, torch.full_like(mr, -1))


def _globalize(v, r, k: int, base: int):
    """Local rows -> global rows (`base` + local; -1 where the score is
    not finite), padded to k columns with (-inf, -1)."""
    r = torch.where(torch.isfinite(v), r + base, torch.full_like(r, -1)).to(torch.int32)
    if v.shape[-1] < k:
        pad = k - v.shape[-1]
        v = torch.nn.functional.pad(v, (0, pad), value=NEG_INF)
        r = torch.nn.functional.pad(r, (0, pad), value=-1)
    return v, r


def _probe_windows(q, cents, cq, cstart, nprobe: int, bucket_pad: int):
    """The probe of one shard's IVF layout: the nprobe best clusters of
    each query and the [Q, P·B] window slots (0 where past a cluster's
    end) with their validity."""
    nq = q.shape[0]
    cs = 2.0 * (q @ cents.T) - cq[None, :]
    probe = torch.topk(cs, min(nprobe, cents.shape[0]), dim=1).indices  # [Q, P]
    cstart = cstart.to(torch.int64)
    starts = cstart[probe]
    sizes = cstart[probe + 1] - starts
    offs = torch.arange(bucket_pad, dtype=torch.int64, device=q.device)
    idx = starts[..., None] + offs[None, None, :]  # [Q, P, B]
    valid = offs[None, None, :] < sizes[..., None]
    idx = torch.where(valid, idx, torch.zeros_like(idx)).reshape(nq, -1)
    return idx, valid.reshape(nq, -1)


def _and_masks(masks):
    """The AND of a shard's masks (None where there is none)."""
    out = None
    for m in masks:
        out = m if out is None else torch.logical_and(out, m)
    return out


def _mask_ops(masks, n: int) -> List[tuple]:
    """Per shard, the operands of `masks` (a list of row-sharded masks,
    ANDed by the body; None entries dropped)."""
    per = [_operands(m, n) for m in masks if m is not None]
    return [tuple(m[d] for m in per) for d in range(n)]


# ------------------------------------------------------------------- legs
def scan_leg(data, aux, masks=(), *, k: int, metric: Metric, rows_per_shard: int,
             approx: bool = False, view=None) -> Leg:
    """The exact scan's leg: a shard's `scan_topk_t` (score / tile_max)
    under the AND of `masks` (row-sharded bool lists). A missing `aux` is
    zero, as in the JAX package."""
    n = len(data)
    data_ops = _operands(data, n)
    if aux is None:
        aux_ops = [torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
                   for x in data_ops]
    else:
        aux_ops = _operands(aux, n)
    mask_ops = _mask_ops(masks, n)

    def fn(d, q, x, a, *ms):
        v, r = scan_topk_t(q, x, a, k=k, metric=metric, n_valid=rows_per_shard,
                           mask=_and_masks(ms), approx=approx)
        return _globalize(v, r, k, d * rows_per_shard)

    ops = [(data_ops[d], aux_ops[d], *mask_ops[d]) for d in range(n)]
    return _topk_leg(fn, ops, k, view=view)


def ivf_leg(centroids, csq, perm_data, perm_aux, perm_rows, cluster_start, masks=(), *,
            k: int, nprobe: int, bucket_pad: int, rows_per_shard: int, view=None) -> Leg:
    """Per-shard IVF (L2): the probe, the window gather and its scores,
    the AND of `masks` (over each shard's LOCAL rows) applied through the
    windows' rows."""
    n = len(perm_data)
    parts = [_operands(x, n) for x in (centroids, csq, perm_data, perm_aux, perm_rows,
                                       cluster_start)]
    mask_ops = _mask_ops(masks, n)

    def fn(d, q, cents, cq, pdata, paux, prows, cstart, *ms):
        cents, cq, pdata, paux, prows, cstart = (
            t[0] for t in (cents, cq, pdata, paux, prows, cstart))
        qs = q.to(torch.float32)
        idx, valid = _probe_windows(qs, cents, cq, cstart, nprobe, bucket_pad)
        rows_mat = pdata[idx].to(torch.float32)  # [Q, P·B, D]
        scores = 2.0 * torch.bmm(rows_mat, qs[:, :, None])[:, :, 0] - paux[idx]
        rows = prows[idx]
        ok = torch.logical_and(valid, rows >= 0)
        if ms:
            ok = torch.logical_and(ok, _and_masks(ms)[torch.clamp(rows, min=0).to(torch.int64)])
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        v, pos = torch.topk(scores, min(k, scores.shape[-1]), dim=-1)
        return _globalize(v, torch.gather(rows, 1, pos), k, d * rows_per_shard)

    ops = [tuple(p[d] for p in parts) + mask_ops[d] for d in range(n)]
    return _topk_leg(fn, ops, k, view=view)


def twostage_leg(centroids, csq, lo, scale, perm_codes, perm_sq, perm_rows, cluster_start,
                 raw, raw_aux, masks=(), *, k: int, nprobe: int, num_reorder: int,
                 bucket_pad: int, rows_per_shard: int, view=None) -> Leg:
    """Per-shard two-stage (L2): an SQ8 first pass over the probed
    clusters keeps `num_reorder` candidates, re-ranked exactly against the
    shard's own full-precision slots, under the AND of `masks`."""
    n = len(perm_codes)
    parts = [_operands(x, n) for x in (centroids, csq, lo, scale, perm_codes, perm_sq,
                                       perm_rows, cluster_start, raw, raw_aux)]
    mask_ops = _mask_ops(masks, n)

    def fn(d, q, cents, cq, lo_d, scale_d, pcodes, psq, prows, cstart, x, a, *ms):
        cents, cq, pcodes, psq, prows, cstart = (
            t[0] for t in (cents, cq, pcodes, psq, prows, cstart))
        qs = q.to(torch.float32)
        idx, valid = _probe_windows(qs, cents, cq, cstart, nprobe, bucket_pad)
        # first pass: q.decode(c) = (q*scale).c + q.lo
        codes_mat = pcodes[idx].to(torch.float32)
        qlo = qs @ lo_d  # [Q]
        dots = torch.bmm(codes_mat, (qs * scale_d[None, :])[:, :, None])[:, :, 0] + qlo[:, None]
        approx = 2.0 * dots - psq[idx]
        rows = prows[idx]
        ok = torch.logical_and(valid, rows >= 0)
        if ms:
            ok = torch.logical_and(ok, _and_masks(ms)[torch.clamp(rows, min=0).to(torch.int64)])
        approx = torch.where(ok, approx, torch.full_like(approx, NEG_INF))
        av, apos = torch.topk(approx, min(num_reorder, approx.shape[-1]), dim=-1)
        cand = torch.gather(rows, 1, apos)  # [Q, R] local rows
        # second stage: exact re-rank of the shard's own candidates
        ci = torch.clamp(cand, min=0).to(torch.int64)
        xi = x[ci].to(torch.float32)
        exact = 2.0 * torch.bmm(xi, qs[:, :, None])[:, :, 0] - a[ci]
        exact = torch.where(torch.isfinite(av), exact, torch.full_like(exact, NEG_INF))
        v, pos = torch.topk(exact, min(k, exact.shape[-1]), dim=-1)
        return _globalize(v, torch.gather(cand, 1, pos), k, d * rows_per_shard)

    ops = [tuple(p[d] for p in parts) + mask_ops[d] for d in range(n)]
    return _topk_leg(fn, ops, k, view=view)


def _bm25_shard(st, ln, idf, al, prow, ptf, dl, alive, *, k, budget, base, k1, b):
    """One shard's batched BM25 top-k: each term's posting slice [Q,
    budget] (a start past the end is clamped, as `dynamic_slice` clamps)
    scatter-added into a [Q, cap] f32 accumulator (padding slots add 0 to
    a dropped column), then a tie-stable top-k over the rows that score >
    0 and are alive."""
    dev = prow.device
    cap = dl.shape[0]
    nq, n_terms = st.shape
    width = prow.shape[0]
    offs = torch.arange(budget, dtype=torch.int64, device=dev)
    acc = torch.zeros((nq, cap + 1), dtype=torch.float32, device=dev)
    for t in range(n_terms):
        s0 = torch.clamp(st[:, t].to(torch.int64), 0, max(width - budget, 0))
        pos = s0[:, None] + offs[None, :]
        rows, tf = prow[pos].to(torch.int64), ptf[pos]
        valid = offs[None, :] < ln[:, t].to(torch.int64)[:, None]
        rows = torch.where(valid, rows, torch.full_like(rows, cap))
        dlen = dl[torch.clamp(rows, max=cap - 1)]
        denom = tf + k1 * (1.0 - b + b * dlen / al)
        contrib = idf[:, t][:, None] * tf * (k1 + 1.0) / torch.clamp(denom, min=1e-9)
        acc.scatter_add_(1, rows, torch.where(valid, contrib, torch.zeros_like(contrib)))
    scores = acc[:, :cap]
    hit = scores > 0
    if alive is not None:
        hit = torch.logical_and(hit, alive[None, :])
    scores = torch.where(hit, scores, torch.full_like(scores, NEG_INF))
    v, r = topk_stable(scores, min(k, cap))
    return _globalize(v, r, k, base)


def bm25_leg(starts, lengths, idfs, avg_len, postings_rows, postings_tf, doc_len, alive, *,
             k: int, budget: int, rows_per_shard: int, rows: int, k1: float = 1.2,
             b: float = 0.75) -> Leg:
    """The BM25 scatter a shard over its inverted index, with GLOBAL
    statistics: the plan (starts / lengths [1, Q, T] a shard, idfs [Q, T],
    avg_len) as operands; `rows` = Q."""
    n = len(postings_rows)
    parts = [_operands(x, n) for x in (starts, lengths, idfs, avg_len, postings_rows,
                                       postings_tf, doc_len)]
    mask_ops = _mask_ops([alive], n)

    def fn(d, q, st, ln, idf, al, prow, ptf, dl, *ms):
        del q
        return _bm25_shard(st[0], ln[0], idf, al.to(torch.float32), prow[0], ptf[0], dl[0],
                           ms[0] if ms else None, k=k, budget=budget,
                           base=d * rows_per_shard, k1=k1, b=b)

    ops = [tuple(p[d] for p in parts) + mask_ops[d] for d in range(n)]
    return _topk_leg(fn, ops, k, grouped=False, rows=rows)


def packed_bm25_leg(postings_rows, postings_tf, doc_len, masks=(), *, n_terms: int, k: int,
                    budget: int, rows_per_shard: int, view=None, k1: float = 1.2,
                    b: float = 0.75) -> Leg:
    """The BM25 leg over a packed plan (`pack_bm25_plan`), a program's
    input: each shard reads its starts and lengths, the idfs and avg_len
    out of the plan's columns; a row scores only where the AND of
    `masks` holds."""
    n = len(postings_rows)
    parts = [_operands(x, n) for x in (postings_rows, postings_tf, doc_len)]
    mask_ops = _mask_ops(masks, n)
    T = n_terms

    def fn(d, plan, prow, ptf, dl, *ms):
        al = plan[0, 0].view(torch.float32)
        idf = plan[:, 1 : 1 + T].view(torch.float32)
        c = 1 + T + 2 * T * d
        return _bm25_shard(plan[:, c : c + T], plan[:, c + T : c + 2 * T], idf, al, prow[0],
                           ptf[0], dl[0], _and_masks(ms), k=k, budget=budget,
                           base=d * rows_per_shard, k1=k1, b=b)

    ops = [tuple(p[d] for p in parts) + mask_ops[d] for d in range(n)]
    return _topk_leg(fn, ops, k, grouped=False, view=view)


def pack_bm25_plan(starts: np.ndarray, lengths: np.ndarray, idfs: np.ndarray,
                   avg_len: float) -> np.ndarray:
    """The mesh's BM25 plan as one int32[Q, 1 + T + S·2T] host array: avg_len's
    f32 bits (column 0), the idfs' f32 bits, then each shard's starts and
    lengths. starts / lengths: [S, Q, T]; idfs: [Q, T]. A row with no
    lengths is an empty query."""
    S, Q, T = starts.shape
    out = np.zeros((Q, 1 + T + 2 * S * T), np.int32)
    out[:, 0] = np.float32(avg_len).view(np.int32)
    out[:, 1 : 1 + T] = np.asarray(idfs, np.float32).view(np.int32)
    for d in range(S):
        c = 1 + T + 2 * T * d
        out[:, c : c + T] = starts[d]
        out[:, c + T : c + 2 * T] = lengths[d]
    return out


def lloyd_leg(data, centroids) -> Leg:
    """One Lloyd's iteration: each shard's (sums, counts), summed in shard
    order on the merging device (`all_reduce_sum`), then the centroid
    update there."""
    n = len(data)
    data_ops, cent_ops = _operands(data, n), _operands(centroids, n)
    c, dim = cent_ops[0].shape

    def fn(d, q, x, cents):
        del q
        sums, counts = kmeans.lloyd_stats(x, cents)
        return sums, counts, cents

    def combine(per_group, dst):
        stats = per_group[0]
        sums = all_reduce_sum([_to(s, dst) for s, _, _ in stats])[0]
        counts = all_reduce_sum([_to(m, dst) for _, m, _ in stats])[0]
        return (kmeans.lloyd_update(_to(stats[0][2], dst), sums, counts),)

    def specs(rows):
        del rows
        return [((c, dim), torch.float32), ((c,), torch.float32), ((c, dim), torch.float32)]

    return Leg(fn, [(data_ops[d], cent_ops[d]) for d in range(n)], specs, combine,
               grouped=False)


# --------------------------------------------------------------- search
def distributed_scan_topk(
    mesh: Mesh,
    queries,
    data: Sequence[torch.Tensor],
    aux: Optional[Sequence[torch.Tensor]],
    *,
    k: int,
    metric: Metric,
    rows_per_shard: int,
    approx: bool = False,
    mask: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scan over a corpus sharded on the "data" axis, queries split
    over the "query" axis. Returns the globally merged (scores f32[Q, k],
    global rows int32[Q, k]). `mask` is an optional row-sharded bool
    pre-filter (WHERE ∩ alive). Per shard: the port's `scan_topk_t`
    (the score / tile_max kernels), then the shards' top-k lists gathered
    onto the grid's first device and merged. A missing `aux` is zero, as
    in the JAX package. `approx` takes each shard's top-k by the
    approximate branch at the JAX package's default recall target."""
    leg = scan_leg(data, aux, [mask], k=k, metric=metric, rows_per_shard=rows_per_shard,
                   approx=approx)
    return run_legs(mesh, queries, [leg])[0]


# --------------------------------------------------------------- k-means
def sharded_lloyd_step(mesh: Mesh, data: Sequence[torch.Tensor], centroids) -> List[torch.Tensor]:
    """One Lloyd's iteration over the row-sharded corpus: each shard's
    (sums, counts), `all_reduce_sum`, the centroid update on the grid's
    first device. Returns the new centroids replicated (one per shard, one
    copy a distinct device)."""
    (new,) = run_legs(mesh, None, [lloyd_leg(data, centroids)])[0]
    return replicate(mesh, new)


def sharded_kmeans_fit(
    mesh: Mesh,
    data: Sequence[torch.Tensor],
    *,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
) -> List[torch.Tensor]:
    """k-means over a row-sharded corpus, from the first `n_clusters` rows
    of the corpus (deterministic; callers pre-shuffle). Returns the
    centroids replicated (one per shard)."""
    dst = data[0].device
    first, need = [], n_clusters
    for x in data:
        if need <= 0:
            break
        first.append(_to(x[:need], dst))
        need -= first[-1].shape[0]
    cents = replicate(mesh, torch.cat(first).to(torch.float32))
    for _ in range(n_iters):
        cents = sharded_lloyd_step(mesh, data, cents)
    return cents


# ------------------------------------------------------ sharded IVF search
def distributed_ivf_topk(
    mesh: Mesh,
    queries,
    centroids: Sequence[torch.Tensor],  # [1, C, D] a shard (its quantizer)
    csq: Sequence[torch.Tensor],  # [1, C]
    perm_data: Sequence[torch.Tensor],  # [1, NP, D] cluster-major rows
    perm_aux: Sequence[torch.Tensor],  # [1, NP] |x|^2 (inf pad)
    perm_rows: Sequence[torch.Tensor],  # [1, NP] local row ids (-1 pad)
    cluster_start: Sequence[torch.Tensor],  # [1, C+1]
    *,
    k: int,
    nprobe: int,
    bucket_pad: int,
    rows_per_shard: int,
    mask: Optional[Sequence[torch.Tensor]] = None,  # bool [rows_per_shard] a shard
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF search where every shard holds its own index layout, merged as
    the exact scan is. L2; rows returned are global. `mask` is an optional
    pre-filter over each shard's LOCAL rows, applied to the candidates
    through their [Q, P·B] window rows."""
    leg = ivf_leg(centroids, csq, perm_data, perm_aux, perm_rows, cluster_start, [mask], k=k,
                  nprobe=nprobe, bucket_pad=bucket_pad, rows_per_shard=rows_per_shard)
    return run_legs(mesh, queries, [leg])[0]


# ----------------------------------------------- sharded two-stage (MSTG)
def distributed_twostage_topk(
    mesh: Mesh,
    queries,
    centroids: Sequence[torch.Tensor],  # [1, C, D] a shard
    csq: Sequence[torch.Tensor],  # [1, C]
    lo,  # f32[D] SQ8 codec (global, replicated)
    scale,  # f32[D]
    perm_codes: Sequence[torch.Tensor],  # uint8[1, NP, D] cluster-major SQ8 codes
    perm_sq: Sequence[torch.Tensor],  # f32[1, NP] |decode(code)|^2 (inf pad)
    perm_rows: Sequence[torch.Tensor],  # int32[1, NP] local row ids (-1 pad)
    cluster_start: Sequence[torch.Tensor],  # int32[1, C+1]
    raw: Sequence[torch.Tensor],  # [cap, D] row-sharded full-precision slots
    raw_aux: Sequence[torch.Tensor],  # f32[cap] |x|^2
    *,
    k: int,
    nprobe: int,
    num_reorder: int,
    bucket_pad: int,
    rows_per_shard: int,
    mask: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage sharded search: per shard, an SQ8 first pass over the
    probed clusters keeps `num_reorder` candidates by approximate score,
    then the shard re-ranks ITS OWN candidates exactly against the
    full-precision slots it holds, and the exact per-shard lists merge.
    L2, like distributed_ivf_topk."""
    leg = twostage_leg(centroids, csq, lo, scale, perm_codes, perm_sq, perm_rows,
                       cluster_start, raw, raw_aux, [mask], k=k, nprobe=nprobe,
                       num_reorder=num_reorder, bucket_pad=bucket_pad,
                       rows_per_shard=rows_per_shard)
    return run_legs(mesh, queries, [leg])[0]


# ------------------------------------------------------- sharded BM25 leg
def distributed_bm25_topk(
    mesh: Mesh,
    starts: Sequence[torch.Tensor],  # int32[1, T] a shard's posting range starts
    lengths: Sequence[torch.Tensor],  # int32[1, T]
    idfs,  # f32[T] GLOBAL idf (replicated)
    avg_len,  # f32 scalar (global)
    postings_rows: Sequence[torch.Tensor],  # int32[1, NNZ]
    postings_tf: Sequence[torch.Tensor],  # f32[1, NNZ]
    doc_len: Sequence[torch.Tensor],  # f32[1, CAP]
    *,
    k: int,
    budget: int,
    rows_per_shard: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One text query against per-shard inverted indexes with GLOBAL
    corpus statistics (idf and avg_len from cluster-wide counts, so shard
    scores compare), merged. Returns (scores f32[1, k], global rows)."""
    return run_legs(mesh, None, [_single_bm25_leg(
        starts, lengths, idfs, avg_len, postings_rows, postings_tf, doc_len, k=k,
        budget=budget, rows_per_shard=rows_per_shard, k1=k1, b=b)])[0]


def _single_bm25_leg(starts, lengths, idfs, avg_len, postings_rows, postings_tf, doc_len, **kw):
    """`bm25_leg` for one query: [1, T] parts become [1, 1, T] plans."""
    n = len(postings_rows)
    return bm25_leg(
        [s[:, None] for s in _operands(starts, n)], [x[:, None] for x in _operands(lengths, n)],
        [i[None] for i in _operands(idfs, n)], avg_len, postings_rows, postings_tf, doc_len,
        None, rows=1, **kw,
    )


def distributed_bm25_topk_batch(
    mesh: Mesh,
    starts: Sequence[torch.Tensor],  # int32[1, Q, T] a shard's posting range starts
    lengths: Sequence[torch.Tensor],  # int32[1, Q, T]
    idfs,  # f32[Q, T] GLOBAL idf (replicated)
    avg_len,  # f32 scalar (global)
    postings_rows: Sequence[torch.Tensor],  # int32[1, NNZ]
    postings_tf: Sequence[torch.Tensor],  # f32[1, NNZ]
    doc_len: Sequence[torch.Tensor],  # f32[1, CAP]
    alive: Optional[Sequence[torch.Tensor]],  # bool [CAP] a shard (alive ∩ WHERE)
    *,
    k: int,
    budget: int,
    rows_per_shard: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched BM25 over per-shard inverted indexes with GLOBAL
    statistics, merged. Term slots are per query (T = padded term count;
    length 0 = absent term). Returns (scores f32[Q, k], global rows
    int32[Q, k]) on the grid's first device."""
    rows = _operands(idfs, len(postings_rows))[0].shape[0]
    return run_legs(mesh, None, [bm25_leg(
        starts, lengths, idfs, avg_len, postings_rows, postings_tf, doc_len, alive, k=k,
        budget=budget, rows_per_shard=rows_per_shard, rows=rows, k1=k1, b=b)])[0]


# ----------------------------------------------------------- fused steps
def _step_query(queries):
    """A step's query for its program: a device tensor as it is (copied
    in on the device), anything else as a host array."""
    if isinstance(queries, torch.Tensor):
        return queries if queries.device.type == "cuda" else queries.detach().numpy()
    return np.ascontiguousarray(np.asarray(queries))


def _step_program(programs, mesh: Mesh, name: str, queries, operands, legs, tail, out_specs):
    """The step's program, keyed by its query's shape and type and the
    pointers of its operand tensors (as a searcher's tensors key a search
    program): a caller that passes the same tensors replays, one that
    writes into them in place is read by the replay."""
    from ..search.program import tensors_key

    q = _step_query(queries)
    tensors = [t for x in operands if x is not None for t in _operands(x, mesh.shape["data"])]
    key = (name, tuple(q.shape), str(q.dtype), tensors_key(tensors, []))
    qdtype = q.dtype if isinstance(q, torch.Tensor) else torch.from_numpy(q[:0]).dtype
    prog = programs.get(key, lambda: MeshProgram(
        mesh, legs(), tail, query=(tuple(q.shape), qdtype), out_specs=out_specs,
        label=f"the mesh's {name} step"))
    return prog.run(q)


def make_train_and_search_step(mesh: Mesh, *, k: int, metric: Metric, rows_per_shard: int):
    """One 'full step' over the mesh: a Lloyd's training iteration (sum
    over "data") and a sharded exact search with the top-k merge, as one
    program (a graph a device) of the step's own cache."""
    from ..search.program import ProgramCache

    programs = ProgramCache()

    def step(queries, data, aux, centroids):
        n = len(data)
        c, d = _operands(centroids, n)[0].shape
        nq = _step_query(queries).shape[0]
        vals, rows, cents = _step_program(
            programs, mesh, "train_and_search", queries, (data, aux, centroids),
            lambda: [lloyd_leg(data, centroids),
                     scan_leg(data, aux, k=k, metric=metric, rows_per_shard=rows_per_shard)],
            lambda outs: [outs[1][0], outs[1][1], outs[0][0]],
            [((nq, k), torch.float32), ((nq, k), torch.int32), ((c, d), torch.float32)])
        return vals, rows, replicate(mesh, cents)

    step.programs = programs
    return step


def make_full_step(
    mesh: Mesh,
    *,
    k: int,
    metric: Metric,
    rows_per_shard: int,
    nprobe: int,
    bucket_pad: int,
    bm25_budget: int,
):
    """One step over the engine's whole distributed surface: a sharded
    k-means iteration, the exact scan, per-shard IVF, a BM25 text leg with
    global statistics, and RRF fusion of the IVF and text legs, as one
    program (a graph a device) of the step's own cache."""
    from ..search.fusion import rrf_fuse_t
    from ..search.program import ProgramCache

    programs = ProgramCache()

    def tail(outs):
        (new_cents,), (ev, er), (iv, ir), (tv, tr) = outs
        tr_b = tr.expand(ir.shape[0], tr.shape[-1])
        # one global tag space (rows are already global): tag 0 when valid
        fv, _ftag, fr = rrf_fuse_t(
            torch.where(ir >= 0, 0, -1), ir, torch.where(tr_b >= 0, 0, -1), tr_b, k,
        )
        return [ev, er, iv, ir, tv, tr, fv, fr, new_cents]

    def step(queries, data, aux, centroids, ivf_cents, ivf_csq, ivf_pdata, ivf_paux,
             ivf_prows, ivf_cstart, t_starts, t_lengths, t_idfs, t_avglen, t_prow, t_ptf,
             t_dlen):
        n = len(data)
        c, d = _operands(centroids, n)[0].shape
        nq = _step_query(queries).shape[0]
        topk = [((nq, k), torch.float32), ((nq, k), torch.int32)]
        one = [((1, k), torch.float32), ((1, k), torch.int32)]

        def legs():
            return [
                lloyd_leg(data, centroids),
                scan_leg(data, aux, k=k, metric=metric, rows_per_shard=rows_per_shard),
                ivf_leg(ivf_cents, ivf_csq, ivf_pdata, ivf_paux, ivf_prows, ivf_cstart, k=k,
                        nprobe=nprobe, bucket_pad=bucket_pad, rows_per_shard=rows_per_shard),
                _single_bm25_leg(t_starts, t_lengths, t_idfs, t_avglen, t_prow, t_ptf, t_dlen,
                                 k=k, budget=bm25_budget, rows_per_shard=rows_per_shard),
            ]

        outs = _step_program(
            programs, mesh, "full", queries,
            (data, aux, centroids, ivf_cents, ivf_csq, ivf_pdata, ivf_paux, ivf_prows,
             ivf_cstart, t_starts, t_lengths, t_idfs, t_avglen, t_prow, t_ptf, t_dlen),
            legs, tail, topk * 2 + one + topk + [((c, d), torch.float32)])
        return (*outs[:8], replicate(mesh, outs[8]))

    step.programs = programs
    return step
