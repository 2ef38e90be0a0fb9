"""MeshTable: ONE logical corpus sharded row-wise over a grid of devices.

Counterpart of myscaledb_tpu/parallel/mesh_table.py. The serving construct
for corpora larger than one card's memory: the payload lives sharded over
the mesh's "data" axis (parallel/distributed.py::Mesh), and every search
runs each shard's scan / IVF probe / BM25 on that shard's device, then
gathers the tiny per-shard top-k lists onto one device and merges them
(the reference's per-part merge + Distributed initiator fusion,
`MergeTreeBaseSearchManager.cpp:207` + `StorageDistributed.cpp:1058`).
One process drives the whole grid, as one JAX controller drives its mesh.

Relation to the other scale-out constructs:
  * `ShardedTable` — N separate tables with initiator-side fusion on the
    host: the reference's Distributed engine over separate servers.
  * `MeshTable` — one table whose rows are spread over the grid: memory
    and scan bandwidth grow with the "data" axis, query throughput with
    the "query" axis.

Storage model (per-part searchability, SURVEY §3.4): each shard owns a
fixed-capacity SLOT RANGE with slack (`GROWTH`); inserts APPEND into free
slots with one scatter a shard (no reseal), deletes flip the alive bitmap
in place, and rows inserted after an IVF build are served by a DELTA
exact scan merged with the index probe. A full reseal happens only when
the slack is exhausted.

Scope: float vectors, L2/IP/Cosine, exact scan + sharded IVF + sharded
two-stage MSTG (all with filters and deletes), BM25 text + hybrid RRF/RSF
over per-shard inverted indexes with GLOBAL statistics, numeric filter
columns (on the devices, evaluated per shard), per-shard save/load in the
JAX package's layout. Rows are identified by the caller's `id` column.

The filter is called eagerly on each shard's columns: the JAX package's
`_PredicateCache` exists only to keep `jax.jit` from retracing a fresh
lambda, and eager PyTorch has nothing to retrace; its mask is copied into
the search's program.

Every search is one program (parallel/distributed.py::MeshProgram: on a
one-card grid one CUDA graph; across cards a graph a card) of the table's
one cache, `_programs`: vector, BM25 and hybrid searches, keyed on their
kind, static arguments, the padded batch and the mask's kind. A graph
reads the table's tensors in place, so in-place inserts and deletes need
no recapture; a reseal, an index build and a text-index rebuild make new
tensors and drop the whole cache, the generation its `version`.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import QueryShapeError, SchemaError
from ..metrics import Metric
from ..ops import kmeans, quantize
from ..ops.topk import topk_stable
from ..search.program import ProgramCache, pack_topk
from .distributed import (
    Fresh,
    Mesh,
    MeshProgram,
    all_gather,
    ivf_leg,
    make_mesh,
    pack_bm25_plan,
    packed_bm25_leg,
    replicate,
    scan_leg,
    shard_rows,
    sharded_kmeans_fit,
    twostage_leg,
)

ALIGN = 8  # row padding multiple per shard
GROWTH = 1.5  # per-shard slot slack: reseal only when a shard overflows


def _pow2(x: int, lo: int = 128) -> int:
    return max(lo, 1 << max(0, int(math.ceil(math.log2(max(1, x))))))


def _merge_topk(va, ra, vb, rb, k):
    """Two [Q, k] lists merged exactly (ties: the first list first, as
    `lax.top_k`), -1 where the score is not finite."""
    vals = torch.cat([va, vb], dim=-1)
    rows = torch.cat([ra, rb], dim=-1)
    mv, pos = topk_stable(vals, k)
    mr = torch.gather(rows, -1, pos.to(torch.int64))
    return mv, torch.where(torch.isfinite(mv), mr, torch.full_like(mr, -1))


def _legs_merged(outs, k):
    """The vector leg's (scores, rows): the route's list, merged with the
    delta scan's when it ran."""
    v, r = outs[0]
    if len(outs) > 1:
        v, r = _merge_topk(v, r, *outs[1], k)
    return v, r


def _cluster_major(x, a, al, cents, c: int):
    """One shard's cluster-major order: each live row assigned to its
    nearest centroid, dead and empty slots parked in a virtual cluster c
    (sorted last). Returns (order, sorted assignment, local rows in that
    order with -1 past the live rows, cluster_start int32[c+1], largest
    cluster)."""
    assign = kmeans.assign_chunked(x, cents).to(torch.int64)
    rows = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    assign = torch.where(al, assign, torch.full_like(assign, c))
    order = torch.argsort(assign, stable=True)
    sa = assign[order]
    prows = torch.where(sa < c, rows[order], torch.full_like(rows, -1))
    cstart = torch.searchsorted(sa, torch.arange(c + 1, device=x.device))
    sizes = cstart[1:] - cstart[:-1]
    return order, sa, prows, cstart.to(torch.int32), int(sizes.max())


class _Sealed:
    """The slot layout on the devices: shard s owns global slots [s*cap,
    (s+1)*cap) (local slots [0, cap) of its tensors); fill[s] slots are
    occupied from the bottom. data / aux / alive and each column are lists
    of per-shard tensors."""

    __slots__ = (
        "cap", "fill", "ids_pad", "id2slot", "data", "aux", "alive",
        "cols", "docs_pad",
    )

    def __init__(self, cap, fill, ids_pad, id2slot, data, aux, alive,
                 cols, docs_pad):
        self.cap = cap
        self.fill = fill
        self.ids_pad = ids_pad
        self.id2slot = id2slot
        self.data = data
        self.aux = aux
        self.alive = alive
        self.cols = cols
        self.docs_pad = docs_pad


class _TextIndex:
    """Per-shard inverted indexes + per-shard posting arrays + GLOBAL
    stats."""

    __slots__ = ("shards", "stats", "prow", "ptf", "dlen", "budget_cap")

    def __init__(self, shards, stats, prow, ptf, dlen, budget_cap):
        self.shards = shards
        self.stats = stats
        self.prow = prow
        self.ptf = ptf
        self.dlen = dlen
        self.budget_cap = budget_cap


class MeshTable:
    def __init__(
        self,
        name: str,
        dim: int,
        *,
        metric: Metric | str = Metric.L2,
        mesh: Optional[Mesh] = None,
        filter_columns: Tuple[str, ...] = (),
        text_column: Optional[str] = None,
        analyzer_params: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.dim = int(dim)
        self.metric = Metric(metric) if isinstance(metric, str) else metric
        self.mesh = mesh if mesh is not None else make_mesh()
        if "data" not in self.mesh.shape:
            raise SchemaError("MeshTable mesh needs a 'data' axis")
        self.n_shards = int(self.mesh.shape["data"])
        self.filter_columns = tuple(filter_columns)
        self.text_column = text_column
        self._analyzer_params = analyzer_params
        # host staging (source of truth; the reference keeps parts on disk)
        self._ids: List[np.ndarray] = []
        self._vecs: List[np.ndarray] = []
        self._cols: Dict[str, List[np.ndarray]] = {c: [] for c in filter_columns}
        self._texts: List[np.ndarray] = []
        self._deleted: set = set()
        self._s: Optional[_Sealed] = None
        self._ivf = None  # (centroids, csq, perm_*, cluster_start, bucket_pad)
        self._mstg = None  # (cents, csq, lo, scale, codes, psq, prows, cstart, bpad)
        self._ivf_fill: Optional[np.ndarray] = None  # fill snapshot at build
        self._delta_mask = None  # per shard bool[cap]: slots not in the index
        self._text: Optional[_TextIndex] = None
        self._text_stale = True
        # every search's program; a hybrid one reads both sides' tensors.
        # Dropped whole before any tensor a program may read is replaced
        self._programs = ProgramCache()

    @property
    def _first(self) -> torch.device:
        return self.mesh.devices[0][0]

    # -------------------------------------------------------------- ingest
    def insert(self, columns: Dict[str, Any]) -> int:
        ids = np.asarray(columns["id"], np.int64)
        vecs = np.asarray(columns["vec"], np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise QueryShapeError(f"vec must be [*, {self.dim}], got {vecs.shape}")
        if len(ids) != len(vecs):
            raise QueryShapeError("id/vec length mismatch")
        cols = {}
        for c in self.filter_columns:
            v = np.asarray(columns[c])
            if len(v) != len(ids):
                raise QueryShapeError(f"column {c!r} length mismatch")
            cols[c] = v
        texts = None
        if self.text_column is not None:
            texts = np.asarray(columns[self.text_column], dtype=object)
            if len(texts) != len(ids):
                raise QueryShapeError(f"column {self.text_column!r} length mismatch")
        self._ids.append(ids)
        self._vecs.append(vecs)
        for c in self.filter_columns:
            self._cols[c].append(cols[c])
        if texts is not None:
            self._texts.append(texts)
        if self._s is not None and not self._append_sealed(ids, vecs, cols, texts):
            self._s = None  # slack exhausted: reseal lazily
            self._ivf = None
            self._mstg = None
            self._delta_mask = None
            self._text = None
            self._text_stale = True
        return len(ids)

    def _alloc_slots(self, m: int) -> Optional[np.ndarray]:
        """Water-fill m new rows into the emptiest shards' free slots.
        Returns global slot ids (grouped by shard, ascending) or None when
        the slack cannot hold them."""
        s = self._s
        free = s.cap - s.fill
        if int(free.sum()) < m:
            return None
        counts = np.zeros(self.n_shards, np.int64)
        rem = m
        # chunked greedy toward balance: repeatedly give the emptiest
        # shard ~rem/S rows (geometric decrease => O(S log m) iterations)
        big = np.int64(1) << 40
        while rem > 0:
            eff = s.fill + counts + np.where(free - counts > 0, 0, big)
            j = int(np.argmin(eff))
            avail = int(free[j] - counts[j])
            take = min(rem, avail, max(1, rem // self.n_shards))
            counts[j] += take
            rem -= take
        slots = np.concatenate(
            [
                sh * s.cap + np.arange(s.fill[sh], s.fill[sh] + counts[sh])
                for sh in range(self.n_shards)
                if counts[sh]
            ]
        ).astype(np.int64)
        return slots

    def _encode(self, vecs: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        """bf16 codes (a CPU tensor; round to nearest even, as ml_dtypes)
        + f32 aux exactly as the JAX package computes them."""
        v = vecs.astype(np.float32).copy()
        if self.metric == Metric.COSINE:
            nrm = np.linalg.norm(v, axis=1, keepdims=True)
            v = v / np.where(nrm > 0, nrm, 1.0)
        codes = torch.from_numpy(v).to(torch.bfloat16)
        if self.metric == Metric.L2:
            dec = codes.to(torch.float32).numpy()
            aux = np.einsum("ij,ij->i", dec, dec).astype(np.float32)
        elif self.metric == Metric.COSINE:
            aux = np.ones(len(v), np.float32)
        else:
            aux = np.zeros(len(v), np.float32)
        return codes, aux

    def _scatter(self, parts: List[torch.Tensor], slots: np.ndarray, values) -> None:
        """parts[shard][local slot] = values, in place, for global `slots`
        grouped by shard (values row-aligned with slots)."""
        s = self._s
        sh_of = slots // s.cap
        for sh in np.unique(sh_of):
            sel = np.nonzero(sh_of == sh)[0]
            dst = parts[int(sh)]
            local = torch.from_numpy(slots[sel] - sh * s.cap).to(dst.device)
            if isinstance(values, torch.Tensor):
                dst[local] = values[torch.from_numpy(sel)].to(dst.device, dst.dtype)
            else:
                dst[local] = values

    def _append_sealed(self, ids, vecs, cols, texts) -> bool:
        """Incremental insert: one scatter a shard into free slots. The IVF
        (if built) keeps serving — appended slots land in the DELTA scan.
        Returns False when slack is exhausted (caller reseals)."""
        s = self._s
        slots = self._alloc_slots(len(ids))
        if slots is None:
            return False
        codes, aux = self._encode(vecs)
        # host bookkeeping: rows are grouped by shard in slot order; the
        # staged order within the batch is not significant
        order = np.argsort(slots // s.cap, kind="stable")
        s.ids_pad[slots] = ids[order]
        for i, sl in zip(ids[order].tolist(), slots.tolist()):
            s.id2slot[i] = sl
        sh_of = slots // s.cap
        for sh in np.unique(sh_of):
            s.fill[sh] += int((sh_of == sh).sum())
        if s.docs_pad is not None and texts is not None:
            s.docs_pad[slots] = texts[order]
            self._text_stale = True
        o = torch.from_numpy(order)
        self._scatter(s.data, slots, codes[o])
        self._scatter(s.aux, slots, torch.from_numpy(aux[order]))
        self._scatter(s.alive, slots, True)
        for c in s.cols:
            self._scatter(s.cols[c], slots, torch.from_numpy(np.asarray(cols[c])[order]))
        return True

    def delete(self, ids) -> int:
        arr = np.atleast_1d(np.asarray(ids, np.int64))
        before = len(self._deleted)
        self._deleted.update(int(i) for i in arr)
        added = len(self._deleted) - before
        if self._s is not None:
            slots = [
                self._s.id2slot[int(i)]
                for i in arr
                if int(i) in self._s.id2slot
            ]
            if slots:
                self._scatter(self._s.alive, np.asarray(slots, np.int64), False)
        return added

    @property
    def n_rows(self) -> int:
        return sum(len(a) for a in self._ids) - len(self._deleted)

    # ---------------------------------------------------------------- seal
    def _seal(self) -> _Sealed:
        """Distribute the staged rows over the grid: shard s gets a
        contiguous run of rows in slots [s*cap, s*cap+fill_s) with
        GROWTH slack; bf16 payload + |x|^2 + alive bitmap + filter
        columns go to each shard's device. Idempotent until a reseal is
        forced (slack exhausted)."""
        if self._s is not None:
            return self._s
        if not self._ids:
            raise SchemaError("MeshTable is empty")
        ids = np.concatenate(self._ids)
        vecs = np.concatenate(self._vecs)
        n = len(ids)
        S = self.n_shards
        per = -(-n // S)
        cap = max(ALIGN, -(-int(math.ceil(per * GROWTH)) // ALIGN) * ALIGN)
        n_slots = cap * S
        fill = np.zeros(S, np.int64)
        ids_pad = np.full(n_slots, -1, np.int64)
        vp = np.zeros((n_slots, self.dim), np.float32)
        docs_pad = None
        if self.text_column is not None:
            docs_pad = np.full(n_slots, "", dtype=object)
            texts = (
                np.concatenate(self._texts)
                if self._texts
                else np.full(n, "", dtype=object)
            )
        col_flat = {c: np.concatenate(self._cols[c]) for c in self.filter_columns}
        col_pad = {c: np.zeros(n_slots, v.dtype) for c, v in col_flat.items()}
        for sh in range(S):
            lo, hi = sh * per, min((sh + 1) * per, n)
            cnt = max(0, hi - lo)
            fill[sh] = cnt
            if cnt:
                base = sh * cap
                ids_pad[base : base + cnt] = ids[lo:hi]
                vp[base : base + cnt] = vecs[lo:hi]
                if docs_pad is not None:
                    docs_pad[base : base + cnt] = texts[lo:hi]
                for c in self.filter_columns:
                    col_pad[c][base : base + cnt] = col_flat[c][lo:hi]
        codes, aux = self._encode(vp)
        del vp
        alive = ids_pad >= 0
        if self._deleted:
            dead = np.isin(
                ids_pad,
                np.fromiter(self._deleted, np.int64, len(self._deleted)),
            )
            alive &= ~dead
        valid = np.nonzero(ids_pad >= 0)[0]
        id2slot = dict(zip(ids_pad[valid].tolist(), valid.tolist()))
        self._programs.invalidate()
        self._s = _Sealed(
            cap,
            fill,
            ids_pad,
            id2slot,
            shard_rows(self.mesh, codes),
            shard_rows(self.mesh, aux),
            shard_rows(self.mesh, alive),
            {c: shard_rows(self.mesh, v) for c, v in col_pad.items()},
            docs_pad,
        )
        return self._s

    # -------------------------------------------------------------- search
    def _mask_inputs(self, filter, s: _Sealed):
        """(the mask's kind, the row-sharded masks a program ANDs, the
        run's inputs): the table's own `alive`, read in place by the
        graph, and a filter's mask (the filter called on each shard's
        columns), copied into the program on every run."""
        if filter is None:
            return "alive", [s.alive], {}
        keep = {}
        for d, alive in enumerate(s.alive):
            m = filter(**{c: s.cols[c][d] for c in s.cols})
            keep[("keep", d)] = torch.as_tensor(m, device=alive.device).to(torch.bool)
        fresh = [Fresh(("keep", d), (s.cap,), torch.bool) for d in range(self.n_shards)]
        return "filter", [s.alive, fresh], keep

    def _queries_host(self, query) -> Tuple[np.ndarray, int]:
        """The queries padded to a multiple of ALIGN a query group, as the
        program's host input (uploaded through pinned staging)."""
        q = np.asarray(query, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise QueryShapeError(f"query must be [*, {self.dim}]")
        nq = q.shape[0]
        qax = int(self.mesh.shape.get("query", 1))
        nq_pad = -(-nq // (qax * ALIGN)) * (qax * ALIGN)
        qp = np.zeros((nq_pad, self.dim), np.float32)
        qp[:nq] = q
        return qp, nq

    def _vector_route(self, k: int, params: Optional[Dict]):
        """(route, whether the delta scan runs, nprobe, num_reorder,
        bucket_pad): exact, or the IVF / two-stage probe merged with the
        DELTA exact scan over slots appended after the build."""
        nprobe = int((params or {}).get("nprobe", 0))
        num_reorder = int((params or {}).get("num_reorder", 0))
        if self._mstg is not None and nprobe > 0:
            return "mstg", self._delta_on(), nprobe, num_reorder or max(4 * k, 64), self._mstg[-1]
        if self._ivf is not None and nprobe > 0:
            return "ivf", self._delta_on(), nprobe, 0, self._ivf[-1]
        return "exact", False, 0, 0, 0

    def _delta_on(self) -> bool:
        return bool((self._s.fill > self._ivf_fill).any())

    def _vector_legs(self, route, delta, k, nprobe, num_reorder, masks, view=None):
        """The vector leg's programs' legs: the route's, then the delta
        scan's (its tail merges the two)."""
        s = self._s
        scan = dict(k=k, metric=self.metric, rows_per_shard=s.cap, view=view)
        if route == "exact":
            return [scan_leg(s.data, s.aux, masks, **scan)]
        probe = dict(k=k, nprobe=nprobe, rows_per_shard=s.cap, view=view)
        if route == "mstg":
            cents, csq, lo, scale, pcodes, psq, prows, cstart, bpad = self._mstg
            legs = [twostage_leg(cents, csq, lo, scale, pcodes, psq, prows, cstart, s.data,
                                 s.aux, masks, num_reorder=num_reorder, bucket_pad=bpad,
                                 **probe)]
        else:
            cents, csq, pdata, paux, prows, cstart, bpad = self._ivf
            legs = [ivf_leg(cents, csq, pdata, paux, prows, cstart, masks, bucket_pad=bpad,
                            **probe)]
        if delta:
            legs.append(scan_leg(s.data, s.aux, [*masks, self._delta_mask], **scan))
        return legs

    def _label(self, what: str) -> str:
        return f"MeshTable {self.name!r}: {what} over {self.n_shards} shards of {self.mesh}"

    def _ids_of(self, rows_host, vals_host):
        out = np.where(
            rows_host >= 0,
            self._s.ids_pad[np.clip(rows_host, 0, len(self._s.ids_pad) - 1)],
            -1,
        )
        return np.where(np.isfinite(vals_host), out, -1)

    def _read(self, packed: torch.Tensor, nq: int):
        """(ids int64[nq, k], scores f32[nq, k]) of a program's packed
        [2, Qpad, k] output (scores' bits, global slot rows): one copy to
        the host."""
        h = packed.cpu().numpy()[:, :nq]
        vh = np.ascontiguousarray(h[0]).view(np.float32)
        return self._ids_of(h[1], vh), vh

    def _vector_run(self, query, k: int, *, filter=None, params=None):
        """The vector search's program run: (packed int32[2, Qpad, k] on
        the grid's first device (scores' bits, global slot rows), nq)."""
        s = self._seal()
        version = self._programs.version
        q, nq = self._queries_host(query)
        kind, masks, fresh = self._mask_inputs(filter, s)
        route, delta, nprobe, num_reorder, bpad = self._vector_route(k, params)
        key = ("vector", route, delta, k, nprobe, num_reorder, bpad, q.shape[0], kind,
               self.metric.value)

        def make():
            legs = self._vector_legs(route, delta, k, nprobe, num_reorder, masks)
            return MeshProgram(
                self.mesh, legs, lambda outs: [pack_topk(*_legs_merged(outs, k))],
                query=(q.shape, torch.float32), out_specs=[((2, q.shape[0], k), torch.int32)],
                label=self._label(f"{route} search" + (" + delta scan" if delta else "")))

        (out,) = self._programs.get(key, make, version).run(q, fresh)
        return out, nq

    def search(
        self, query, k: int, *, filter=None, params: Optional[Dict] = None
    ):
        """Top-k rows for [D] or [Q, D] queries. filter: a callable taking
        the declared filter columns as kwargs (tensors on the shard's
        device) and returning bool, e.g. `lambda price: price < 100`.
        Returns (ids, scores): int64/float32 [Q, k] (-1/-inf empty). With
        `params={"nprobe": p}` and a built IVF the probe is
        index-accelerated; filters/deletes apply on the devices, and rows
        inserted after the build are served by the delta scan."""
        return self._read(*self._vector_run(query, k, filter=filter, params=params))

    # ------------------------------------------------------------- indexes
    def _n_centroids(self, s: _Sealed, ncentroids: int) -> int:
        n = int(s.fill.sum())
        c = int(ncentroids) or max(16, 1 << int(math.log2(max(16, 4 * math.isqrt(n)))))
        return min(c, max(ALIGN, int(s.fill[0])))  # init slices shard 0's rows

    def build_ivf(self, ncentroids: int = 0, *, n_iters: int = 8) -> None:
        """Sharded IVF: GLOBAL k-means (`all_reduce_sum` Lloyd's), then a
        per-shard cluster-major layout built on each shard's device.
        Probe-time bucket padding = the largest cluster. Filters/deletes
        are applied at probe time via the local-row mask; rows inserted
        later are served by the delta scan until rebuild."""
        s = self._seal()
        c = self._n_centroids(s, ncentroids)
        cents = sharded_kmeans_fit(self.mesh, s.data, n_clusters=c, n_iters=n_iters)
        parts = {k: [] for k in ("cents", "csq", "pdata", "paux", "prows", "cstart")}
        bpad = 0
        for sh, (x, a, al) in enumerate(zip(s.data, s.aux, s.alive)):
            cs = cents[sh]
            order, _sa, prows, cstart, big = _cluster_major(x, a, al, cs, c)
            parts["cents"].append(cs[None])
            parts["csq"].append(torch.sum(cs * cs, dim=1)[None])
            parts["pdata"].append(x[order][None])
            parts["paux"].append(a[order][None])
            parts["prows"].append(prows[None])
            parts["cstart"].append(cstart[None])
            bpad = max(bpad, big)
        bpad = max(ALIGN, -(-bpad // ALIGN) * ALIGN)
        self._install_index(ivf=(
            parts["cents"], parts["csq"], parts["pdata"], parts["paux"], parts["prows"],
            parts["cstart"], bpad,
        ))

    def build_mstg(self, ncentroids: int = 0, *, n_iters: int = 8) -> None:
        """Sharded two-stage (MSTG-kind) index: GLOBAL k-means + a GLOBAL
        SQ8 codec (per-dim lo/scale over live rows), then a per-shard
        cluster-major layout of uint8 CODES — 1 byte a dimension where
        build_ivf keeps a full-precision permuted copy. Search probes the
        codes, keeps `num_reorder` candidates, and re-ranks them EXACTLY
        against the shard's own full-precision slots before the merge.
        Delta/deletes/filters behave exactly like build_ivf."""
        s = self._seal()
        c = self._n_centroids(s, ncentroids)
        cents = sharded_kmeans_fit(self.mesh, s.data, n_clusters=c, n_iters=n_iters)
        # the codec over the live rows of every shard: each shard's
        # (min, max) rows gathered, then sq8_train_dev over them
        ext = []
        for x, al in zip(s.data, s.alive):
            xf = x.to(torch.float32)
            inf = torch.tensor(float("inf"), device=x.device)
            ext.append(torch.stack([
                torch.amin(torch.where(al[:, None], xf, inf), dim=0),
                torch.amax(torch.where(al[:, None], xf, -inf), dim=0),
            ]))
        lo, scale = quantize.sq8_train_dev(all_gather(ext, self._first).reshape(-1, self.dim))
        lo_r, scale_r = replicate(self.mesh, lo), replicate(self.mesh, scale)
        parts = {k: [] for k in ("cents", "csq", "codes", "psq", "prows", "cstart")}
        bpad = 0
        for sh, (x, a, al) in enumerate(zip(s.data, s.aux, s.alive)):
            cs = cents[sh]
            order, sa, prows, cstart, big = _cluster_major(x, a, al, cs, c)
            codes = quantize.sq8_encode_dev(x[order].to(torch.float32), lo_r[sh], scale_r[sh])
            dec = codes.to(torch.float32) * scale_r[sh][None, :] + lo_r[sh][None, :]
            psq = torch.where(sa < c, torch.sum(dec * dec, dim=1),
                              torch.full_like(dec[:, 0], float("inf")))
            parts["cents"].append(cs[None])
            parts["csq"].append(torch.sum(cs * cs, dim=1)[None])
            parts["codes"].append(codes[None])
            parts["psq"].append(psq[None])
            parts["prows"].append(prows[None])
            parts["cstart"].append(cstart[None])
            bpad = max(bpad, big)
        bpad = max(ALIGN, -(-bpad // ALIGN) * ALIGN)
        self._install_index(mstg=(
            parts["cents"], parts["csq"], lo_r, scale_r, parts["codes"], parts["psq"],
            parts["prows"], parts["cstart"], bpad,
        ))

    def _install_index(self, *, ivf=None, mstg=None) -> None:
        """Serve `ivf` or `mstg` (device parts a shard): the fill it covers
        and the delta mask of the slots past it (per shard bool[cap],
        static until the next build or reseal), built here, outside any
        search; the programs drop."""
        s = self._s
        self._ivf, self._mstg = ivf, mstg
        self._ivf_fill = s.fill.copy()
        pos = np.arange(s.cap * self.n_shards)
        self._delta_mask = shard_rows(self.mesh, (pos % s.cap) >= self._ivf_fill[pos // s.cap])
        self._programs.invalidate()

    # ---------------------------------------------------------------- text
    def _text_index(self) -> _TextIndex:
        """Per-shard inverted indexes over the slot layout (local doc id =
        local slot), their postings padded to one width and placed on each
        shard's device, with GLOBAL BM25 statistics (idf/avg_len from
        cluster-wide counts so shard scores compare)."""
        if self.text_column is None:
            raise SchemaError("MeshTable has no text_column")
        s = self._seal()
        if self._text is not None and not self._text_stale:
            return self._text
        self._programs.invalidate()
        from ..text.analyzer import Analyzer
        from ..text.inverted import BM25Stats, InvertedIndex

        analyzer = Analyzer(self._analyzer_params)
        shards = []
        for sh in range(self.n_shards):
            docs = s.docs_pad[sh * s.cap : (sh + 1) * s.cap]
            shards.append(
                InvertedIndex.build([docs], s.cap, device="cpu", analyzer=analyzer)
            )
        # global stats over LIVE rows only (empty slots dilute avg_len)
        merged = BM25Stats.merge([ix.stats for ix in shards])
        n_live = int(s.fill.sum())
        stats = BM25Stats(n_live, merged.total_tokens, merged.doc_freq)
        # postings padded to a common width with slack for the largest
        # slice budget (a slice must never clamp its start)
        max_df = max(
            (
                int(np.max(np.diff(ix.term_offsets)))
                for ix in shards
                if len(ix.term_offsets) > 1
            ),
            default=1,
        )
        budget_cap = _pow2(max_df)
        W = max(int(ix.term_offsets[-1]) for ix in shards) + budget_cap
        prow = np.zeros((self.n_shards, W), np.int32)
        ptf = np.zeros((self.n_shards, W), np.float32)
        dlen = np.zeros((self.n_shards, s.cap), np.float32)
        for sh, ix in enumerate(shards):
            nnz = min(W, ix.postings_rows.shape[0])
            prow[sh, :nnz] = ix.postings_rows.numpy()[:nnz]
            ptf[sh, :nnz] = ix.postings_tf.numpy()[:nnz]
            dlen[sh] = ix.doc_len.numpy()
        self._text = _TextIndex(
            shards,
            stats,
            shard_rows(self.mesh, prow),
            shard_rows(self.mesh, ptf),
            shard_rows(self.mesh, dlen),
            budget_cap,
        )
        self._text_stale = False
        return self._text

    def _text_plan(self, ti: _TextIndex, queries: List[str]):
        """The BM25 plan of `queries` (one a row; "" an empty query) as the
        program's packed int32 input (`distributed.pack_bm25_plan`), with
        T (the padded term count) and the posting-slice budget."""
        terms_per_q = []
        for qt in queries:
            toks = ti.shards[0].analyzer.tokenize(str(qt))
            terms_per_q.append(list(dict.fromkeys(toks)))
        T = _pow2(max((len(t) for t in terms_per_q), default=1), lo=4)
        Q = len(queries)
        S = self.n_shards
        starts = np.zeros((S, Q, T), np.int32)
        lengths = np.zeros((S, Q, T), np.int32)
        idfs = np.zeros((Q, T), np.float32)
        max_len = 1
        for qi, terms in enumerate(terms_per_q):
            for tj, term in enumerate(terms):
                idfs[qi, tj] = ti.stats.idf(term)
                for sh, ix in enumerate(ti.shards):
                    st, ln = ix.term_range(term)  # (start, LENGTH)
                    starts[sh, qi, tj] = st
                    lengths[sh, qi, tj] = ln
                    max_len = max(max_len, ln)
        budget = min(_pow2(max_len), ti.budget_cap)
        return pack_bm25_plan(starts, lengths, idfs, ti.stats.avg_doc_len), T, budget

    def _text_leg(self, ti: _TextIndex, T: int, budget: int, k: int, masks, view=None):
        return packed_bm25_leg(ti.prow, ti.ptf, ti.dlen, masks, n_terms=T, k=k, budget=budget,
                               rows_per_shard=self._s.cap, view=view)

    def text_search(self, queries, k: int, *, filter=None):
        """BM25 top-k for one query string or a list of them. Returns
        (ids int64[Q, k], scores f32[Q, k])."""
        return self._read(*self._text_run(queries, k, filter=filter))

    def _text_run(self, queries, k: int, *, filter=None):
        """The text search's program run over the batch padded to a
        multiple of ALIGN (pad rows are empty queries): (packed
        int32[2, Qpad, k] on the grid's first device, nq)."""
        if isinstance(queries, str):
            queries = [queries]
        queries = list(queries)
        s = self._seal()
        ti = self._text_index()
        version = self._programs.version
        nq = len(queries)
        nq_pad = -(-nq // ALIGN) * ALIGN
        plan, T, budget = self._text_plan(ti, queries + [""] * (nq_pad - nq))
        kind, masks, fresh = self._mask_inputs(filter, s)
        key = ("text", k, T, budget, nq_pad, kind)

        def make():
            return MeshProgram(
                self.mesh, [self._text_leg(ti, T, budget, k, masks)],
                lambda outs: [pack_topk(*outs[0])], query=(plan.shape, torch.int32),
                out_specs=[((2, nq_pad, k), torch.int32)], label=self._label("BM25"))

        (out,) = self._programs.get(key, make, version).run(plan, fresh)
        return out, nq

    def hybrid_search(
        self,
        query_vec,
        query_text: str,
        k: int,
        *,
        filter=None,
        params: Optional[Dict] = None,
        fusion_k: int = 60,
        fusion_type: str = "rrf",
        fusion_weight: float = 0.5,
    ):
        """Vector leg (exact or IVF per `params["nprobe"]`) + BM25 leg,
        fused on the grid's first device over global slot ids (the
        Distributed initiator fusion, StorageDistributed.cpp:1058).
        fusion_type "rrf" (rank fusion) or "rsf" (relative-score fusion,
        HybridSearchUtils.cpp:212 — w·norm_text + (1-w)·norm_vec over
        min-max-normalized leg scores). Both legs and the fuse are one
        program. Returns (ids int64[Q, k], fused_scores f32[Q, k])."""
        ids, vh = self._read(*self._hybrid_run(
            query_vec, query_text, k, filter=filter, params=params, fusion_k=fusion_k,
            fusion_type=fusion_type, fusion_weight=fusion_weight))
        return ids, np.where(ids >= 0, vh, -np.inf)

    def _hybrid_run(self, query_vec, query_text, k: int, *, filter, params, fusion_k: int,
                    fusion_type: str, fusion_weight: float):
        """The hybrid search's program run: one packed int32 input a row
        (the query's f32 bits, then its BM25 plan; the text batch padded
        as the vectors are), both legs and the fuse in one program:
        (packed int32[2, Qpad, k] (fused scores' bits, global slot rows),
        nq)."""
        from ..search.fusion import rrf_fuse_t, rsf_fuse_t

        if fusion_type not in ("rrf", "rsf"):
            raise QueryShapeError(f"unknown fusion_type {fusion_type!r}")
        s = self._seal()
        ti = self._text_index()
        version = self._programs.version
        q, nq = self._queries_host(query_vec)
        texts = [query_text] * nq if isinstance(query_text, str) else list(query_text)
        if len(texts) != nq:
            raise QueryShapeError(f"text batch ({len(texts)}) must match the vectors ({nq})")
        nq_pad, dim = q.shape
        plan, T, budget = self._text_plan(ti, texts + [""] * (nq_pad - nq))
        packed = np.concatenate([q.view(np.int32), plan], axis=1)
        kind, masks, fresh = self._mask_inputs(filter, s)
        route, delta, nprobe, num_reorder, bpad = self._vector_route(k, params)
        key = ("hybrid", route, delta, k, nprobe, num_reorder, bpad, T, budget, nq_pad, kind,
               self.metric.value, fusion_type, fusion_k, fusion_weight)

        def tags(r):
            return torch.where(r >= 0, 0, -1).to(torch.int32)

        def tail(outs):
            vv, vr = _legs_merged(outs[:-1], k)
            tv, tr = outs[-1]
            if fusion_type == "rsf":
                fv, _ftag, fr = rsf_fuse_t(
                    tags(vr), vr, vv, tags(tr), tr, tv, k, fusion_weight=fusion_weight,
                    vec_ascending_better=False,  # internal scores: max = best
                )
            else:
                fv, _ftag, fr = rrf_fuse_t(tags(vr), vr, tags(tr), tr, k, fusion_k=fusion_k)
            return [pack_topk(fv, fr)]

        def make():
            legs = self._vector_legs(route, delta, k, nprobe, num_reorder, masks,
                                     view=lambda x: x[:, :dim].view(torch.float32))
            legs.append(self._text_leg(ti, T, budget, k, masks, view=lambda x: x[:, dim:]))
            return MeshProgram(
                self.mesh, legs, tail, query=(packed.shape, torch.int32),
                out_specs=[((2, nq_pad, k), torch.int32)],
                label=self._label(f"hybrid {fusion_type.upper()} ({route} + BM25)"))

        (out,) = self._programs.get(key, make, version).run(packed, fresh)
        return out, nq

    def batch_distance(
        self, queries, k: int, *, filter=None, params: Optional[Dict] = None
    ):
        """batch_distance semantics (LIMIT k BY batch index): [Q, D]
        queries -> flattened (query_index, id, score) triples, k per query,
        rank order within each query."""
        ids, scores = self.search(queries, k, filter=filter, params=params)
        out = []
        for qi in range(ids.shape[0]):
            for j in range(ids.shape[1]):
                if ids[qi, j] >= 0:
                    out.append((qi, int(ids[qi, j]), float(scores[qi, j])))
        return out

    # ------------------------------------------------------------- persist
    def save(self, path: str) -> None:
        """PER-SHARD checkpoint files in the JAX package's layout:
        meshtable.json and shard s's rows (per the sealed slot assignment)
        in shard_{s}.npz, gathered per shard from the chunked host staging
        (peak transient memory is one shard's payload). Device state and
        indexes rebuild on load."""
        os.makedirs(path, exist_ok=True)
        meta = {
            "name": self.name,
            "dim": self.dim,
            "metric": self.metric.value,
            "filter_columns": list(self.filter_columns),
            "text_column": self.text_column,
            "analyzer_params": self._analyzer_params,
            "shards": self.n_shards if self._ids else 0,
        }
        with open(os.path.join(path, "meshtable.json"), "w") as f:
            json.dump(meta, f)
        if not self._ids:
            return
        s = self._seal()
        lens = [len(a) for a in self._ids]
        starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        all_ids = np.concatenate(self._ids)  # int64 index only — not payload
        sorter = np.argsort(all_ids, kind="stable")
        sorted_ids = all_ids[sorter]
        deleted = np.fromiter(
            sorted(self._deleted), np.int64, len(self._deleted)
        )

        def rows_of(chunks: List[np.ndarray], pos: np.ndarray) -> np.ndarray:
            """Gather staged rows at global positions without
            concatenating the chunk list."""
            first = chunks[0]
            out = np.empty((len(pos),) + first.shape[1:], first.dtype)
            ci = np.searchsorted(starts, pos, "right") - 1
            off = pos - starts[ci]
            for c in np.unique(ci):
                m = ci == c
                out[m] = chunks[c][off[m]]
            return out

        for sh in range(self.n_shards):
            sl = slice(sh * s.cap, sh * s.cap + int(s.fill[sh]))
            shard_ids = np.asarray(s.ids_pad[sl], np.int64)
            pos = sorter[np.searchsorted(sorted_ids, shard_ids)]
            arrays = {
                "ids": shard_ids,
                "vecs": rows_of(self._vecs, pos),
                "deleted": shard_ids[np.isin(shard_ids, deleted)],
            }
            for c in self.filter_columns:
                arrays[f"col_{c}"] = rows_of(self._cols[c], pos)
            if self.text_column is not None and self._texts:
                arrays["texts"] = rows_of(self._texts, pos).astype(np.str_)
            np.savez(os.path.join(path, f"shard_{sh}.npz"), **arrays)

    @classmethod
    def load(cls, path: str, *, mesh: Optional[Mesh] = None) -> "MeshTable":
        with open(os.path.join(path, "meshtable.json")) as f:
            meta = json.load(f)
        t = cls(
            meta["name"],
            meta["dim"],
            metric=Metric(meta["metric"]),
            mesh=mesh,
            filter_columns=tuple(meta["filter_columns"]),
            text_column=meta["text_column"],
            analyzer_params=meta["analyzer_params"],
        )

        def ingest(z) -> Optional[np.ndarray]:
            if not len(z["ids"]):
                return None
            cols = {"id": z["ids"], "vec": z["vecs"]}
            for c in t.filter_columns:
                cols[c] = z[f"col_{c}"]
            if t.text_column is not None and "texts" in z:
                cols[t.text_column] = z["texts"].astype(object)
            t.insert(cols)
            return z["deleted"]

        legacy = os.path.join(path, "meshtable.npz")
        deleted_parts: List[np.ndarray] = []
        if os.path.exists(legacy):  # monolithic checkpoints of the older layout
            with np.load(legacy, allow_pickle=False) as z:
                d = ingest(z)
            if d is not None:
                deleted_parts.append(d)
        else:
            # shard files from the SAVING mesh's layout; the loading mesh
            # may have a different shard count — insert() redistributes
            for sh in range(int(meta.get("shards", 0))):
                with np.load(
                    os.path.join(path, f"shard_{sh}.npz"), allow_pickle=False
                ) as z:
                    d = ingest(z)
                if d is not None:
                    deleted_parts.append(d)
        if deleted_parts:
            dead = np.concatenate(deleted_parts)
            if len(dead):
                t.delete(dead)
        return t
