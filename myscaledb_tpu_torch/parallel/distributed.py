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
  * each `local(...)` body of a `shard_map` is a plain function over one
    shard's tensors, called on that shard's device for each data shard in
    turn (kernel launches are asynchronous, so on several cards the
    shards' scans overlap);
  * the query axis splits the padded batch into `query_axis` groups, group
    q running on row q of the grid (a shard's operands are moved to row
    q's device when it differs from row 0's);
  * the ICI collectives are the two functions under "collectives" below:
    copies onto one merging device and a sum in shard order.

A device may repeat in the grid: that is the counterpart of XLA's virtual
CPU devices. The tests use eight `cpu` entries, and four `cuda:0` entries
put four shards on one card.
"""

from __future__ import annotations

import contextlib
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


def _part(x, d: int, dev: torch.device) -> torch.Tensor:
    """Shard d's operand on `dev`: element d of a list of parts, or the
    whole of a replicated tensor / array."""
    if isinstance(x, (list, tuple)):
        x = x[d]
    return _to(_tensor(x), dev)


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


def _over_mesh(mesh: Mesh, queries, local: Callable, k: int):
    """Run `local(d, q, dev)` -> shard d's ([Q', k] scores, global rows)
    for each query group and data shard on `devices[q][d]` (the current
    device while it runs), merge each group's shards on its row's first
    device and return the groups' results stacked on `devices[0][0]`."""
    q_all = _tensor(queries)
    n_groups = mesh.shape["query"]
    if q_all.shape[0] % n_groups:
        raise ValueError(f"{q_all.shape[0]} queries do not split over query axis {n_groups}")
    per = q_all.shape[0] // n_groups
    outs_v, outs_r = [], []
    for qi, row in enumerate(mesh.devices):
        group = q_all[qi * per : (qi + 1) * per]
        vs, rs = [], []
        for d, dev in enumerate(row):
            with _current(dev):
                v, r = local(d, _to(group, dev), dev)
            vs.append(v)
            rs.append(r)
        mv, mr = _merge(vs, rs, k, row[0])
        outs_v.append(mv)
        outs_r.append(mr)
    dst = mesh.devices[0][0]
    return (torch.cat([_to(v, dst) for v in outs_v]),
            torch.cat([_to(r, dst) for r in outs_r]))


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
    onto the row's first device and merged. A missing `aux` is zero, as
    in the JAX package. `approx` takes each shard's top-k by the
    approximate branch at the JAX package's default recall target."""

    def local(d, q, dev):
        x = _part(data, d, dev)
        a = (_part(aux, d, dev) if aux is not None
             else torch.zeros((x.shape[0],), dtype=torch.float32, device=dev))
        m = _part(mask, d, dev) if mask is not None else None
        v, r = scan_topk_t(q, x, a, k=k, metric=metric, n_valid=rows_per_shard, mask=m,
                           approx=approx)
        return _globalize(v, r, k, d * rows_per_shard)

    return _over_mesh(mesh, queries, local, k)


# --------------------------------------------------------------- k-means
def sharded_lloyd_step(mesh: Mesh, data: Sequence[torch.Tensor], centroids) -> List[torch.Tensor]:
    """One Lloyd's iteration over the row-sharded corpus: each shard's
    (sums, counts), `all_reduce_sum`, the centroid update once per
    distinct device. Returns the new centroids replicated (one per
    shard)."""
    stats = [kmeans.lloyd_stats(x, _part(centroids, d, x.device)) for d, x in enumerate(data)]
    sums = all_reduce_sum([s for s, _ in stats])
    counts = all_reduce_sum([c for _, c in stats])
    new = {}
    out = []
    for d, x in enumerate(data):
        dev = x.device
        if dev not in new:
            new[dev] = kmeans.lloyd_update(_part(centroids, d, dev), sums[d], counts[d])
        out.append(new[dev])
    return out


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

    def local(d, q, dev):
        cents, cq = _part(centroids, d, dev)[0], _part(csq, d, dev)[0]
        pdata, paux = _part(perm_data, d, dev)[0], _part(perm_aux, d, dev)[0]
        prows, cstart = _part(perm_rows, d, dev)[0], _part(cluster_start, d, dev)[0]
        qs = q.to(torch.float32)
        idx, valid = _probe_windows(qs, cents, cq, cstart, nprobe, bucket_pad)
        rows_mat = pdata[idx].to(torch.float32)  # [Q, P·B, D]
        scores = 2.0 * torch.bmm(rows_mat, qs[:, :, None])[:, :, 0] - paux[idx]
        rows = prows[idx]
        ok = torch.logical_and(valid, rows >= 0)
        if mask is not None:
            m = _part(mask, d, dev)
            ok = torch.logical_and(ok, m[torch.clamp(rows, min=0).to(torch.int64)])
        scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
        v, pos = torch.topk(scores, min(k, scores.shape[-1]), dim=-1)
        return _globalize(v, torch.gather(rows, 1, pos), k, d * rows_per_shard)

    return _over_mesh(mesh, queries, local, k)


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

    def local(d, q, dev):
        cents, cq = _part(centroids, d, dev)[0], _part(csq, d, dev)[0]
        lo_d, scale_d = _part(lo, d, dev), _part(scale, d, dev)
        pcodes, psq = _part(perm_codes, d, dev)[0], _part(perm_sq, d, dev)[0]
        prows, cstart = _part(perm_rows, d, dev)[0], _part(cluster_start, d, dev)[0]
        x, a = _part(raw, d, dev), _part(raw_aux, d, dev)
        qs = q.to(torch.float32)
        idx, valid = _probe_windows(qs, cents, cq, cstart, nprobe, bucket_pad)
        # first pass: q.decode(c) = (q*scale).c + q.lo
        codes_mat = pcodes[idx].to(torch.float32)
        qlo = qs @ lo_d  # [Q]
        dots = torch.bmm(codes_mat, (qs * scale_d[None, :])[:, :, None])[:, :, 0] + qlo[:, None]
        approx = 2.0 * dots - psq[idx]
        rows = prows[idx]
        ok = torch.logical_and(valid, rows >= 0)
        if mask is not None:
            m = _part(mask, d, dev)
            ok = torch.logical_and(ok, m[torch.clamp(rows, min=0).to(torch.int64)])
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

    return _over_mesh(mesh, queries, local, k)


# ------------------------------------------------------- sharded BM25 leg
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
    return distributed_bm25_topk_batch(
        mesh, [_tensor(s)[:, None] for s in starts], [_tensor(x)[:, None] for x in lengths],
        _tensor(idfs)[None] if not isinstance(idfs, (list, tuple)) else [i[None] for i in idfs],
        avg_len, postings_rows, postings_tf, doc_len, None,
        k=k, budget=budget, rows_per_shard=rows_per_shard, k1=k1, b=b,
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
    vs, rs = [], []
    for d, dev in enumerate(mesh.data_devices):
        v, r = _bm25_shard(
            _part(starts, d, dev)[0], _part(lengths, d, dev)[0], _part(idfs, d, dev),
            _part(avg_len, d, dev).to(torch.float32), _part(postings_rows, d, dev)[0],
            _part(postings_tf, d, dev)[0], _part(doc_len, d, dev)[0],
            _part(alive, d, dev) if alive is not None else None,
            k=k, budget=budget, base=d * rows_per_shard, k1=k1, b=b,
        )
        vs.append(v)
        rs.append(r)
    return _merge(vs, rs, k, mesh.devices[0][0])


# ----------------------------------------------------------- fused step
def make_train_and_search_step(mesh: Mesh, *, k: int, metric: Metric, rows_per_shard: int):
    """One 'full step' over the mesh: a Lloyd's training iteration (sum
    over "data") and a sharded exact search with the top-k merge."""

    def step(queries, data, aux, centroids):
        new_cents = sharded_lloyd_step(mesh, data, centroids)
        vals, rows = distributed_scan_topk(
            mesh, queries, data, aux, k=k, metric=metric, rows_per_shard=rows_per_shard
        )
        return vals, rows, new_cents

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
    global statistics, and RRF fusion of the IVF and text legs."""
    from ..search.fusion import rrf_fuse_t

    def step(queries, data, aux, centroids, ivf_cents, ivf_csq, ivf_pdata, ivf_paux,
             ivf_prows, ivf_cstart, t_starts, t_lengths, t_idfs, t_avglen, t_prow, t_ptf,
             t_dlen):
        new_cents = sharded_lloyd_step(mesh, data, centroids)
        ev, er = distributed_scan_topk(
            mesh, queries, data, aux, k=k, metric=metric, rows_per_shard=rows_per_shard,
        )
        iv, ir = distributed_ivf_topk(
            mesh, queries, ivf_cents, ivf_csq, ivf_pdata, ivf_paux, ivf_prows, ivf_cstart,
            k=k, nprobe=nprobe, bucket_pad=bucket_pad, rows_per_shard=rows_per_shard,
        )
        tv, tr = distributed_bm25_topk(
            mesh, t_starts, t_lengths, t_idfs, t_avglen, t_prow, t_ptf, t_dlen,
            k=k, budget=bm25_budget, rows_per_shard=rows_per_shard,
        )
        tr_b = _to(tr, ir.device).expand(ir.shape[0], tr.shape[-1])
        # one global tag space (rows are already global): tag 0 when valid
        fv, _ftag, fr = rrf_fuse_t(
            torch.where(ir >= 0, 0, -1), ir, torch.where(tr_b >= 0, 0, -1), tr_b, k,
        )
        return ev, er, iv, ir, tv, tr, fv, fr, new_cents

    return step
