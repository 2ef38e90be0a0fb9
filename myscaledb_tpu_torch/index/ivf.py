"""IVF indexes: k-means coarse quantizer over a cluster-major window
layout, with raw (IVFFLAT), SQ8 (IVFSQ) and PQ (IVFPQ) payloads, plus
MSTG (an SQ8 first pass and an exact re-rank).

Counterpart of myscaledb_tpu/index/ivf.py, device path:

  * centroids f32[C, D] from balanced k-means (ops/kmeans.py);
  * ONE cluster-major permutation of the encoded payload,
    `perm_data[N', D'|M]`, with per-cluster row offsets `cluster_start[C+1]`
    and zero padding beyond rounding N up to the 512-row window size;
  * a search ranks the centroids, turns each query's top-nprobe clusters
    into a list of 512-row windows (`windows_for_probes`, sized to a
    budget W), and scores every window of the budget in one call
    (`ops/windowscan.py::window_scan`: on the card one kernel that reads
    each live window once and decodes it in registers), then takes ONE
    top-k. No loop runs per query or per window.

The pre-filter ∩ delete bitmap applies inside the scan, by row-id lookup
in a row-space mask or by contiguous window lookup in a `WindowMask`
(`to_window_mask`). Cosine is normalize-then-IP.

A table's filtered search takes another route (`filter_layout`): the rows
that pass its filter, kept in the index's cluster-major order once per
(filter, mutation generation), searched as a `FilteredIVF`.
A masked scan of the probed windows keeps about nprobe * selectivity of
their rows, and returns fewer than k where a filter is selective; the
layout takes lists in the same centroid order until it holds the rows
the user's nprobe buys unfiltered, counted in passing rows, and scores
each of them exactly. Whenever k rows pass it returns k.

IVFSQ, IVFPQ and MSTG are two-stage: their first pass ranks candidates on
the codes, then the top k * rerank_multiple are re-scored exactly against
the segment's own payload (`raw_data`, a reference, never a copy;
`ops/rowrescore.py::row_rescore`: on the card one kernel that reads each
candidate row once by its id). An
index loaded from a state dict gets that reference back through
`reattach_payload`; until then its search raises rather than serve
quantized distances.

Disk mode (the reference's disk-mode MSTG, Search::DiskIOManager): the
exact re-rank reads its rows from HOST memory (`raw_host`) and only the
codes occupy the device. MSTG `disk_mode=1` puts a device payload's rows
there; a host-tier payload (storage/segment.py) always re-ranks there, and
its build streams the rows through the device (ops/stream.py::HostRep):
the training sample is gathered on the host, the assignment and the SQ8
or PQ encode run chunk by chunk, each chunk's codes scattered straight to
their cluster-major place. IVFFLAT over a host-tier payload would mirror
the whole payload on the device, so it degrades to that disk-mode SQ8
shape (`IvfFlatDegradedToDiskMode`). The disk-mode re-rank gathers only
the rows that survive the candidate cut, into pinned host memory for a
CUDA card, and scores them in f64 on the device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from ..errors import IndexParameterError
from ..metrics import Metric
from ..ops import distance, kmeans, quantize
from ..ops._cuda import count_work, round_up
from ..ops.stream import HostRep
from ..ops.topk import NEG_INF, dedup_rows
from ..ops.rowrescore import row_rescore
from ..ops.windowscan import WINDOW, window_scan, window_scan_plain
from ..service.event_log import GLOBAL_COUNTERS
from ..storage.segment import host_tensor
from .base import (IndexKind, ParamsKey, VectorIndex, check_cancel, params_key,
                   split_dyn_nprobe)
from .registry import register

DEFAULT_NPROBE = 16


def _pq_m(params: Dict[str, Any], dim: int) -> int:
    """The PQ subquantizer count: params' M, or `_default_pq_m`."""
    m = int(params.get("M", 0)) or _default_pq_m(dim)
    if dim % m:
        raise IndexParameterError(f"dim {dim} not divisible by M={m}")
    return m


def _default_pq_m(dim: int) -> int:
    """Largest power-of-2 subquantizer count <= 32 that divides dim (DDL
    may omit M; the build adapts)."""
    m = 32
    while m > 1 and dim % m:
        m //= 2
    return m


def default_ncentroids(n_rows: int) -> int:
    """~4*sqrt(N), power-of-two-ish, clamped (FAISS-style heuristic)."""
    c = int(4 * math.sqrt(max(n_rows, 1)))
    c = 1 << max(4, int(round(math.log2(max(c, 16)))))
    return int(min(c, max(16, n_rows // 8), 65_536))


def _scan_rep(payload, n_rows: int, metric: Metric) -> torch.Tensor:
    """Rows in 'scan representation', f32: raw for L2/IP, normalized (times
    the stored 1/|x|) for Cosine."""
    data = payload.data[:n_rows].to(torch.float32)
    if metric == Metric.COSINE and payload.invnorm is not None:
        data = data * payload.invnorm[:n_rows, None]
    return data


def balanced_kmeans(
    rep,
    n_rows: int,
    c: int,
    *,
    device=None,
    extra_frac: float = 0.5,
    seed: int = 0,
    max_train_rows: Optional[int] = None,
    cancel_cb=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-means with size-proportional cluster splitting: after the main
    fit, `extra_frac*c` extra centroids are seeded onto the heaviest
    clusters and refined, which bounds the tail of the size histogram.
    `rep` is a device tensor, or a host-tier `HostRep` fitted on `device`.
    Returns (centroids f32[C', D], assign int32[n]) on the device."""
    n_extra = int(c * extra_frac) if c >= 4 else 0
    host = isinstance(rep, HostRep)
    if host:
        sample = kmeans.training_sample_host(
            rep, n_rows, c, device=device, seed=seed, max_rows=max_train_rows
        )
    else:
        sample = kmeans.training_sample(rep, n_rows, c, seed=seed, max_rows=max_train_rows)
    check_cancel(cancel_cb)
    cents = kmeans.kmeans_fit_balanced(
        sample, n_clusters=c, n_extra=n_extra, n_iters=10, seed=seed
    )
    check_cancel(cancel_cb)
    if host:
        return cents, kmeans.assign_chunked_host(rep, cents)
    return cents, kmeans.assign_chunked(rep, cents)


def windows_for_probes(
    cluster_start: torch.Tensor,
    probe: torch.Tensor,
    n_windows: int,
    w_budget: int,
    limit=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probed clusters -> per-query deduplicated window lists.

    probe int[Q, P] -> (widx int64[Q, W], valid bool[Q, W]). A window can
    be listed by several adjacent probed clusters; the lists are sorted
    and deduplicated. Windows past the budget W are dropped (those of the
    least promising probes); `limit` masks the windows of probes ranked at
    or past it."""
    nprobe = probe.shape[1]
    probe = probe.to(torch.int64)
    cs = cluster_start.to(torch.int64)
    starts = cs[probe]  # [Q, P]
    ends = cs[probe + 1]
    ws = starts // WINDOW
    wcnt = torch.where(ends > starts, -((-ends) // WINDOW) - ws, torch.zeros_like(ws))
    cum = torch.cumsum(wcnt, dim=1)  # [Q, P]
    j = torch.arange(w_budget, device=probe.device)[None, :]  # [1, W]
    # p_idx[q, j] = which probe the j-th window belongs to
    p_idx = (cum[:, None, :] <= j[:, :, None]).sum(dim=2)  # [Q, W]
    valid_w = p_idx < (nprobe if limit is None else limit)
    p_clip = torch.clamp(p_idx, max=nprobe - 1)
    prev = torch.where(
        p_idx > 0,
        torch.gather(cum, 1, torch.clamp(p_clip - 1, min=0)),
        torch.zeros_like(p_idx),
    )
    wbase = torch.gather(ws, 1, p_clip)
    widx = torch.where(valid_w, wbase + (j - prev), torch.zeros_like(wbase))
    dead = n_windows + 1
    keyw = torch.sort(torch.where(valid_w, widx, torch.full_like(widx, dead)), dim=1).values
    dup = torch.zeros_like(keyw, dtype=torch.bool)
    dup[:, 1:] = keyw[:, 1:] == keyw[:, :-1]
    valid_w = (keyw < dead) & ~dup
    return torch.where(valid_w, keyw, torch.zeros_like(keyw)), valid_w


def _pad_cols(v: torch.Tensor, r: torch.Tensor, k: int):
    """Pad (scores, rows) [Q, kk] to [Q, k] with (-inf, -1)."""
    if v.shape[1] < k:
        v = tnf.pad(v, (0, k - v.shape[1]), value=NEG_INF)
        r = tnf.pad(r, (0, k - r.shape[1]), value=-1)
    return v, r


def _mask_cache_key(leaf):
    """A hashable key for a comparison-constant leaf of a window mask
    (numpy arrays by their bytes, Python scalars by type and value); None
    for a constant of another kind, which skips the bitmap cache."""
    if isinstance(leaf, np.ndarray):
        return (leaf.dtype.str, leaf.shape, leaf.tobytes())
    if isinstance(leaf, (bool, int, float)):
        return (type(leaf).__name__, leaf)
    return None


class IVFIndex(VectorIndex):
    """Shared IVF machinery; `codec` selects the payload encoding: 'raw' ->
    IVFFLAT, 'sq8' -> IVFSQ and MSTG, 'pq' -> IVFPQ. The HNSW build also
    uses it, unregistered, as its throwaway candidate generator."""

    _array_fields = (
        "centroids",  # f32[C, D]
        "csq",  # f32[C]
        "perm_data",  # [N', D'|M] cluster-major payload (codec-encoded)
        "perm_rows",  # int32[N'] original row ids (-1 pad)
        "perm_aux",  # f32[N'] decoded |x|^2 (inf on padding)
        "cluster_start",  # int32[C+1] row offsets into perm_*
        "codec_a",  # sq8: lo[D'] / pq: codebooks[M, K, ds]
        "codec_b",  # sq8: scale[D'] / pq: None
        "raw_data",  # two-stage only: reference to the segment payload
        "raw_aux",
    )
    _payload_refs = ("raw_data", "raw_aux")
    _static_fields = (
        "metric",
        "dim",
        "n_rows",
        "n_clusters",
        "n_windows",
        "wpp",  # typical windows per probed cluster (sizes the W budget)
        "codec",
        "two_stage",
        "rerank_multiple",
    )
    _defaults = dict(
        codec_a=None, codec_b=None, raw_data=None, raw_aux=None, codec="raw",
        two_stage=False, rerank_multiple=4,
    )
    # the executor may pass the actual nprobe beside its pow2 bucket
    # (base.split_dyn_nprobe)
    supports_dyn_nprobe = True

    def __init__(self, **kw):
        for f in self._array_fields + self._static_fields:
            setattr(self, f, kw.pop(f) if f in kw else self._defaults[f])
        if kw:
            raise TypeError(f"unexpected fields: {sorted(kw)}")
        # disk mode: the exact re-rank's rows in host memory (a reference to
        # a host-tier payload, or a device payload's rows moved there);
        # never serialized
        self.raw_host: Optional[torch.Tensor] = None
        # window-layout mirrors of filterable scalar columns and of the
        # alive bitmap, keyed by (column, mutation generation), and the
        # materialized window bitmaps of repeated filters (to_window_mask)
        self._win_mirrors: Dict[Any, torch.Tensor] = {}
        self._win_mask_built: Dict[Any, torch.Tensor] = {}
        # the passing rows' layouts of repeated filters (filter_layout),
        # keyed by the filter and the mutation generation
        self._filter_layouts: Dict[Any, tuple] = {}

    # --------------------------------------------------- window-space masks
    def to_window_mask(self, dmask, segment):
        """Re-express a row-space DeviceMask over this index's cluster-major
        window layout (WindowMask), so the scan tests candidates by
        contiguous window lookup instead of gathering one bit per row.
        Column mirrors are permuted once per (column, mutation generation)
        and cached; the built bitmap of a repeated filter is cached too.
        Returns None when some leaf cannot be mirrored."""
        from ..search.filters import WindowMask

        _, _, _, has_alive, expr_skel = dmask.skel
        gen = getattr(segment, "mutation_generation", 0)
        leaves = list(dmask.leaves)
        out: list = []
        consts: list = []  # the comparison constants, which key the bitmap cache
        pos = 0
        perm = torch.clamp(self.perm_rows, min=0).to(torch.int64)

        def mirror(key, src):
            hit = self._win_mirrors.get(key)
            if hit is None:
                if len(self._win_mirrors) > 64:
                    self._win_mirrors.clear()
                hit = src[perm]
                self._win_mirrors[key] = hit
            return hit

        if has_alive:
            out.append(mirror(("__alive__", gen), leaves[0]))
            pos = 1

        def rec(s):
            nonlocal pos
            kind = s[0]
            if kind in ("and", "or"):
                return rec(s[1]) and rec(s[2])
            if kind == "not":
                return rec(s[1])
            if kind == "lit":
                return True
            if kind in ("cmp", "in"):
                if len(s) < 3:
                    return False  # no column name: cannot key the mirror
                col, val = leaves[pos], leaves[pos + 1]
                pos += 2
                out.append(mirror((s[2], gen), col))
                out.append(val)
                consts.append(val)
                return True
            return False

        if expr_skel is not None and not rec(expr_skel):
            return None
        n_prime = int(self.perm_rows.shape[0])
        # n_rows == capacity: layout padding is masked by the scan's own
        # rows >= 0 test
        wm = WindowMask(("root", n_prime, n_prime, has_alive, expr_skel), out, dmask.device)
        vals = [_mask_cache_key(v) for v in consts]
        if any(v is None for v in vals):
            return wm  # a constant of another kind: skip the bitmap cache
        ck = (expr_skel, has_alive, tuple(vals), gen)
        hit = self._win_mask_built.get(ck)
        if hit is None:
            if len(self._win_mask_built) > 32:
                self._win_mask_built.clear()
            hit = wm.build()
            self._win_mask_built[ck] = hit
            GLOBAL_COUNTERS.bump("IvfWindowMaskBuilds")
        else:
            GLOBAL_COUNTERS.bump("IvfWindowMaskCacheHits")
        return WindowMask(("prebuilt", n_prime, n_prime, False, None), [hit], dmask.device)

    def filter_layout(self, mask, key, k: int, params: ParamsKey):
        """The index under a pre-filter: (a `FilteredIVF`, the int32
        buffer it searches, its layout of the passing rows). `mask` is the
        filter ∩ the alive bitmap in row space (a bool[capacity] bitmap, or
        a `DeviceMask` that builds one). The layout is built at a filter's
        first search and then taken from the index's cache under `key` (the
        filter and the mutation generation; None builds it every time, as
        for a Lambda); k and the params' nprobe bucket size the searcher's
        probe count. None where the re-rank reads host rows (disk mode):
        such a search keeps the window mask."""
        from ..search.filters import as_mask_array

        if self.raw_host is not None:
            return None
        hit = None if key is None else self._filter_layouts.get(key)
        if hit is not None:
            GLOBAL_COUNTERS.bump("IvfFilterLayoutHits")
        else:
            hit = self._layout_of(as_mask_array(mask))
            GLOBAL_COUNTERS.bump("IvfFilterLayoutBuilds")
            if key is not None:
                if len(self._filter_layouts) >= _FILTER_LAYOUTS:
                    self._filter_layouts.pop(next(iter(self._filter_layouts)))
                self._filter_layouts[key] = hit
        buf, least_rows = hit
        need, per_list = _filtered_need(self, k)
        nprobe = self._nprobe(split_dyn_nprobe(params)[0])
        budget = max(need, nprobe * per_list)
        # the fewest lists that hold the budget whichever non-empty lists
        # they are (at most every non-empty one), and at least nprobe, to a
        # power of two
        n = len(least_rows)
        p = max(1, nprobe, min(n, int(np.searchsorted(least_rows, budget)) + 1))
        # the slots past the budget that nprobe lists may fill, the largest
        # ones: their passing rows are all candidates, as the unfiltered
        # search's probed windows are
        top = int(least_rows[-1] - (least_rows[-1 - nprobe] if nprobe < n else 0)) if n else 0
        over = top - budget
        return FilteredIVF(self, min(self.n_clusters, 1 << (p - 1).bit_length()),
                           0 if over <= 0 else 1 << (over - 1).bit_length()), buf

    def _layout_of(self, rows: torch.Tensor):
        """(int32[C + 1 + M'], the ascending running sums of the non-empty
        lists' passing rows) of a row-space bitmap: each list's first entry
        in the passing rows, then those rows in cluster-major order, as the
        exact scores read them (a row id of the payload for a two-stage
        index, a position in `perm_data` for IVFFLAT), padded to a power of
        two M' (at least 1,024) so that filters of one size share a
        program. The sums are on the host: they size a search's probes."""
        perm = self.perm_rows.to(torch.int64)
        passing = (perm >= 0) & rows[torch.clamp(perm, min=0)]
        pos = torch.nonzero(passing).flatten()  # ascending: cluster-major
        lists = torch.searchsorted(self.cluster_start[1:].to(torch.int64), pos, right=True)
        sizes = torch.bincount(lists, minlength=self.n_clusters)
        c, m = self.n_clusters, int(pos.shape[0])
        buf = torch.zeros(c + 1 + (1 << max(10, (m - 1).bit_length())), dtype=torch.int32,
                          device=pos.device)
        buf[1: c + 1] = torch.cumsum(sizes, dim=0)
        buf[c + 1: c + 1 + m] = perm[pos] if self.two_stage else pos
        held = sizes.cpu().numpy()
        return buf, np.cumsum(np.sort(held[held > 0]))

    # ------------------------------------------------------------- build
    @classmethod
    def _build_common(
        cls,
        payload,
        n_rows: int,
        *,
        metric: Metric,
        dim: int,
        params: Dict[str, Any],
        settings,
        codec: str = "raw",
        two_stage: bool = False,
        cancel_cb=None,
        force_host_raw: bool = False,
    ) -> "IVFIndex":
        if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            raise IndexParameterError(f"IVF does not support metric {metric}")
        host_tier = getattr(payload, "is_host", False)
        if host_tier and codec == "raw":
            raise IndexParameterError(
                "a host-tier segment needs a compressed codec (MSTG, IVFSQ or IVFPQ): "
                "raw IVFFLAT would mirror the whole payload on the device"
            )
        c = int(params.get("ncentroids", default_ncentroids(n_rows)))
        c = max(1, min(c, n_rows))
        storage_dtype = payload.data.dtype
        dpad = payload.data.shape[1]
        dev = payload.device
        if host_tier:
            inv = payload.invnorm if metric == Metric.COSINE else None
            rep = HostRep(payload.data, n_rows, inv)
        else:
            rep = _scan_rep(payload, n_rows, metric)
        max_train = None
        if settings is not None:
            max_train = max(
                settings.query.max_build_index_train_block_bytes // (dpad * 4), c
            )
        cents, assign = balanced_kmeans(
            rep, n_rows, c, device=dev, seed=0, max_train_rows=max_train, cancel_cb=cancel_cb
        )
        check_cancel(cancel_cb)
        c = int(cents.shape[0])
        npad = round_up(max(n_rows, WINDOW), WINDOW)

        # the cluster-major permutation, on the device
        assign = assign.to(torch.int64)
        order = torch.argsort(assign, stable=True)
        counts = torch.bincount(assign, minlength=c)
        starts = torch.zeros(c + 1, dtype=torch.int64, device=dev)
        starts[1:] = torch.cumsum(counts, dim=0)
        perm_rows = torch.full((npad,), -1, dtype=torch.int32, device=dev)
        perm_rows[:n_rows] = order.to(torch.int32)
        if host_tier:
            perm_data, perm_aux, codec_a, codec_b = cls._encode_host(
                rep, order, npad, dpad, dim, codec, params, dev, cancel_cb
            )
        else:
            perm_data, perm_aux, codec_a, codec_b = cls._encode_device(
                rep, order, npad, dpad, dim, codec, params, storage_dtype, cancel_cb
            )
        check_cancel(cancel_cb)

        host_raw = host_tier or force_host_raw
        out = cls(
            centroids=cents,
            csq=torch.sum(cents * cents, dim=1),
            perm_data=perm_data,
            perm_rows=perm_rows,
            perm_aux=perm_aux,
            cluster_start=starts.to(torch.int32),
            codec_a=codec_a,
            codec_b=codec_b,
            raw_data=payload.data if two_stage and not host_raw else None,
            raw_aux=payload.aux_for(metric) if two_stage and not host_raw else None,
            metric=metric,
            dim=dim,
            n_rows=n_rows,
            n_clusters=c,
            n_windows=npad // WINDOW,
            wpp=int(math.ceil((n_rows / max(c, 1)) / WINDOW)) + 1,
            codec=codec,
            two_stage=two_stage,
        )
        if two_stage and host_raw:
            # disk mode: the re-rank gathers its rows from host memory; a
            # device payload's stored rows are moved there (the one
            # deliberate device-to-host copy: the raw tier is evicted)
            out.raw_host = (
                payload.data
                if host_tier
                else host_tensor(payload.data[:n_rows].to(torch.float32).cpu(), dev)
            )
        return out

    @staticmethod
    def _encode_device(rep, order, npad, dpad, dim, codec, params, storage_dtype, cancel_cb):
        """(perm_data, perm_aux, codec_a, codec_b) of a device
        representation: permutation, encode and sqnorms never leave the
        device."""
        dev = rep.device
        n_rows = rep.shape[0]
        rep_perm = rep[order]
        codec_a = codec_b = None
        if codec == "raw":
            perm_data = torch.zeros((npad, dpad), dtype=storage_dtype, device=dev)
            perm_data[:n_rows] = rep_perm.to(storage_dtype)
            dec_sq = torch.sum(rep_perm * rep_perm, dim=1)
        elif codec == "sq8":
            codec_a, codec_b = quantize.sq8_train_dev(rep)
            enc = quantize.sq8_encode_dev(rep_perm, codec_a, codec_b)
            dec = quantize.sq8_decode_dev(enc, codec_a, codec_b).to(torch.float32)
            dec_sq = torch.sum(dec * dec, dim=1)
            del dec
            perm_data = torch.zeros((npad, dpad), dtype=torch.uint8, device=dev)
            perm_data[:n_rows] = enc
        elif codec == "pq":
            m = _pq_m(params, dim)
            codec_a = quantize.pq_train_dev(rep[:, :dim], m, bits=int(params.get("bit_size", 8)))
            check_cancel(cancel_cb)
            enc = quantize.pq_encode_dev(rep_perm[:, :dim], codec_a)
            dec_sq = quantize.pq_decoded_sqnorms(enc, codec_a)
            perm_data = torch.zeros((npad, m), dtype=torch.uint8, device=dev)
            perm_data[:n_rows] = enc
        else:
            raise IndexParameterError(f"unknown IVF codec {codec!r}")
        perm_aux = torch.full((npad,), float("inf"), dtype=torch.float32, device=dev)
        perm_aux[:n_rows] = dec_sq
        return perm_data, perm_aux, codec_a, codec_b

    @staticmethod
    def _encode_host(rep, order, npad, dpad, dim, codec, params, dev, cancel_cb):
        """(perm_data, perm_aux, codec_a, codec_b) of a host-tier `HostRep`:
        the codec trains over all rows (chunked), then each chunk of rows is
        encoded on the device and its codes and decoded |x|^2 scattered to
        their cluster-major places. No f32 copy of the corpus is made on
        the host or on the device."""
        n_rows = rep.n
        pos = torch.empty(n_rows, dtype=torch.int64, device=dev)
        pos[order] = torch.arange(n_rows, dtype=torch.int64, device=dev)
        codec_b = None
        if codec == "sq8":
            codec_a, codec_b = quantize.sq8_train_host(rep, dev)
            width = dpad

            def encode(x):
                enc = quantize.sq8_encode_dev(x, codec_a, codec_b)
                dec = quantize.sq8_decode_dev(enc, codec_a, codec_b).to(torch.float32)
                return enc, torch.sum(dec * dec, dim=1)

        elif codec == "pq":
            width = _pq_m(params, dim)
            codec_a = quantize.pq_train_host(
                rep, width, dim, dev, bits=int(params.get("bit_size", 8))
            )

            def encode(x):
                enc = quantize.pq_encode_dev(x[:, :dim], codec_a)
                dec = quantize.pq_decode_dev(enc, codec_a).to(torch.float32)
                return enc, torch.sum(dec * dec, dim=1)

        else:
            raise IndexParameterError(f"unsupported host-tier codec {codec!r}")
        check_cancel(cancel_cb)
        perm_data = torch.zeros((npad, width), dtype=torch.uint8, device=dev)
        perm_aux = torch.full((npad,), float("inf"), dtype=torch.float32, device=dev)
        for i, m, x in rep.chunks(dev):
            enc, sq = encode(x)
            dst = pos[i : i + m]
            perm_data[dst] = enc
            perm_aux[dst] = sq
            check_cancel(cancel_cb)
        return perm_data, perm_aux, codec_a, codec_b

    def reattach_payload(self, payload) -> None:
        """Re-attach the segment payload references after a state-dict
        load: raw_data / raw_aux belong to the segment and are never
        serialized. A host-tier payload re-attaches as the host re-rank
        tier (`raw_host`), a device payload as device references, unless
        the index already re-ranks from host rows (built with
        disk_mode=1)."""
        if not self.two_stage:
            return
        if getattr(payload, "is_host", False):
            self.raw_host = payload.data
            self.raw_data = self.raw_aux = None
        elif self.raw_host is None:
            self.raw_data = payload.data
            self.raw_aux = payload.aux_for(self.metric)

    def cluster_heads(self) -> torch.Tensor:
        """Representative row of each cluster (entry points for graph
        indexes): the first row in its window range, -1 for empty. The
        start is clamped into perm_rows explicitly (a JAX take clamps)."""
        starts = self.cluster_start[:-1].to(torch.int64)
        sizes = self.cluster_start[1:].to(torch.int64) - starts
        heads = self.perm_rows[torch.clamp(starts, max=self.perm_rows.shape[0] - 1)]
        return torch.where(sizes > 0, heads, torch.full_like(heads, -1))

    # ------------------------------------------------------------- score
    def _nprobe(self, params: ParamsKey) -> int:
        d = dict(params)
        p = d.get("nprobe", DEFAULT_NPROBE)
        # MSTG 'alpha' maps to probe width (its reference role: search
        # expansion factor): alpha * the default probes
        if "alpha" in d and "nprobe" not in d:
            p = max(1, int(float(d["alpha"]) * DEFAULT_NPROBE))
        return int(max(1, min(int(p), self.n_clusters)))

    # ------------------------------------------------------------- search
    def search_t(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        mask=None,
        params: ParamsKey = (),
        dyn_nprobe: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.two_stage:
            return self._scan_stage(queries, k, mask=mask, params=params, dyn_nprobe=dyn_nprobe)
        self._require_payload()
        _, r = self._scan_stage(queries, self._ncand(k), mask=mask, params=params,
                                dyn_nprobe=dyn_nprobe)
        return self._rerank(queries, k, r, self._exact_scores)

    def _list_scores(self, q: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
        """f32[Q, C]: the coarse probe's ranking of the lists for the
        queries `q` (normalized for Cosine), -inf where `sizes` is 0. The
        ranking follows the assignment geometry (rows were L2-assigned):
        L2 and Cosine (|q| = 1) rank by 2 q·c - |c|^2, IP (MIPS) by raw
        q·c."""
        cs = q[:, : self.centroids.shape[1]] @ self.centroids.T
        if self.metric in (Metric.L2, Metric.COSINE):
            cs = 2.0 * cs - self.csq[None, :]
        return cs.masked_fill(~(sizes > 0)[None, :], NEG_INF)

    def _ncand(self, k: int) -> int:
        """Candidates the first pass of a two-stage index hands its re-rank."""
        return min(max(k * self.rerank_multiple, k), self.n_rows)

    def _rerank(self, queries, k: int, r: torch.Tensor, exact):
        """Top k of the first pass's candidates `r` int32[Q, C] by their
        exact scores (`exact(queries, r)`); counts the Q * C rows it
        re-scores in `ivf.rerank_rows`."""
        count_work("ivf.rerank_rows", r.shape[0] * r.shape[1])
        ev = exact(queries, r)
        v2, p2 = torch.topk(ev, min(k, ev.shape[-1]), dim=-1)
        r2 = torch.gather(r, 1, p2)
        r2 = torch.where(torch.isfinite(v2), r2, torch.full_like(r2, -1))
        return _pad_cols(v2, r2, k)

    def _scan_stage(
        self,
        queries: torch.Tensor,
        k: int,
        *,
        mask=None,
        params: ParamsKey = (),
        dyn_nprobe: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The IVF scan over the codes: top-k (scores f32[Q, k], rows
        int32[Q, k]) of the probed windows."""
        from ..search.filters import WindowMask, as_mask_array

        wmask = None
        if isinstance(mask, WindowMask):
            # the predicate over window-layout mirrors, read per window
            wmask = mask.build().reshape(self.n_windows, WINDOW)
            mask = None
        else:
            mask = as_mask_array(mask)
        nprobe = self._nprobe(params)
        nq = queries.shape[0]
        q = distance.normalize_queries(queries.to(torch.float32), self.metric)
        # empty clusters never take a probe slot
        sizes = self.cluster_start[1:] - self.cluster_start[:-1]
        probe = torch.topk(self._list_scores(q, sizes), nprobe, dim=1).indices  # [Q, P]

        w_budget = int(min(self.n_windows + nprobe, nprobe * self.wpp + 4))
        # the rows the window step gathers and scores, padding and
        # repeated windows included
        count_work("ivf.window_rows", nq * w_budget * WINDOW)
        limit = None
        if isinstance(dyn_nprobe, torch.Tensor):  # a program's device scalar
            limit = torch.clamp(dyn_nprobe, max=nprobe)
        elif dyn_nprobe is not None:
            limit = min(int(dyn_nprobe), nprobe)
        widx, valid_w = windows_for_probes(
            self.cluster_start, probe, self.n_windows, w_budget, limit=limit
        )

        kk = min(k, self.n_rows)
        prw = self.perm_rows.view(self.n_windows, WINDOW)
        q = q.contiguous()
        if self.codec == "pq":  # no kernel decodes PQ codes
            scores = window_scan_plain(q, self.perm_data, self.perm_aux, widx, valid_w,
                                       metric=self.metric, codebooks=self.codec_a)
        else:
            scores = window_scan(q, self.perm_data, self.perm_aux, widx, valid_w,
                                 metric=self.metric, lo=self.codec_a, scale=self.codec_b)
        rows = prw[widx].masked_fill(~valid_w[..., None], -1).reshape(nq, -1)
        valid = rows >= 0
        if wmask is not None:
            valid = valid & wmask[widx].reshape(nq, -1)
        elif mask is not None:
            valid = valid & mask[torch.clamp(rows, min=0).to(torch.int64)]
        scores = scores.masked_fill(~valid, NEG_INF)
        bv, sp = torch.topk(scores, min(kk, scores.shape[1]), dim=1)
        bv, br = _pad_cols(bv, torch.gather(rows, 1, sp), kk)

        # boundary windows shared by adjacent probed clusters can score a
        # row twice: dedup before the final cut
        bv, br, _ = dedup_rows(bv, br)
        bv, pos = torch.topk(bv, kk, dim=1)
        br = torch.gather(br, 1, pos)
        br = torch.where(torch.isfinite(bv), br, torch.full_like(br, -1))
        return _pad_cols(bv, br, k)

    # ---------------------------------------------------------- two-stage
    def supports_two_stage(self) -> bool:
        return self.two_stage

    def requires_two_stage(self) -> bool:
        """A disk-mode index always takes the executor's two-stage path: its
        re-rank rows are gathered from host memory once, after the global
        candidate cut."""
        return self.two_stage and self.raw_host is not None

    def search_first_stage(
        self,
        queries: torch.Tensor,
        num_candidates: int,
        *,
        params: Optional[Dict[str, Any]] = None,
        mask=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._scan_stage(queries, num_candidates, mask=mask, params=params_key(params))

    def _require_payload(self) -> None:
        if self.raw_data is None and self.raw_host is None:
            raise RuntimeError(
                f"{self.kind.value} index has no segment payload to re-rank against: "
                "call reattach_payload(segment payload) after loading it"
            )

    def _exact_scores(self, queries: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
        """Exact scores of the candidate rows against the raw payload
        (computeTopDistanceSubset), f32[Q, C]; -inf where row_ids < 0.
        A device payload goes through `ops/rowrescore.py::row_rescore`:
        on the card one kernel (csrc/row_rescore.cu) that reads each
        candidate row once by its id and scores it in f32 in registers,
        the Cosine norm of the same widened row included; on the CPU
        `row_rescore_plain`. A host payload (disk mode) takes
        `_exact_scores_host`."""
        self._require_payload()
        if self.raw_host is not None:
            return self._exact_scores_host(queries, row_ids)
        d = self.raw_data.shape[1]
        q = distance.normalize_queries(queries.to(torch.float32), self.metric)
        return row_rescore(q[:, :d].contiguous(), self.raw_data, self.raw_aux,
                           row_ids.to(torch.int32), metric=self.metric)

    def _exact_scores_host(self, queries: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
        """Disk-mode computeTopDistanceSubset: the distinct candidate rows
        (row_ids >= 0) gathered from host memory, into a pinned buffer
        for a CUDA card, moved once and scored in f64 on the queries'
        device, then cast to f32: an f64 score of the stored rows, as the
        JAX package's numpy re-rank computes it. Cosine scores the
        normalized query (the JAX package's host re-rank leaves it
        unnormalized, so its Cosine scores carry |q|)."""
        dev = row_ids.device
        r = row_ids.to("cpu", torch.int64)  # the rows to fetch: one sync
        keep = r >= 0
        uniq, inv = torch.unique(r[keep], return_inverse=True)
        if not len(uniq):  # every candidate of this segment fell below the cut
            return torch.full(row_ids.shape, NEG_INF, dtype=torch.float32, device=dev)
        raw = self.raw_host
        buf = torch.empty(
            (len(uniq), raw.shape[1]), dtype=raw.dtype, pin_memory=dev.type == "cuda"
        )
        torch.index_select(raw, 0, uniq, out=buf)
        rows = buf.to(dev, non_blocking=True).to(torch.float64)  # [U, D']
        slot = torch.zeros(r.shape, dtype=torch.int64)
        slot[keep] = inv
        rows = rows[slot.to(dev)]  # [Q, C, D']
        q = queries.to(torch.float64)[:, : rows.shape[-1]]
        if self.metric == Metric.COSINE:
            qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
            q = q / torch.where(qn > 0, qn, torch.ones_like(qn))
        s = torch.bmm(rows, q[:, :, None])[:, :, 0]
        if self.metric == Metric.L2:
            s = 2.0 * s - torch.sum(rows * rows, dim=-1)
        elif self.metric == Metric.COSINE:
            nrm = torch.linalg.vector_norm(rows, dim=-1)
            s = s / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        return s.to(torch.float32).masked_fill(row_ids < 0, NEG_INF)

    def compute_scores_subset(self, queries: torch.Tensor, row_ids: torch.Tensor) -> torch.Tensor:
        return self._exact_scores(queries, row_ids)

    def search(self, queries, k, *, params=None, mask=None, programs=None):
        """A disk-mode index searches eagerly in two stages: the SQ8 scan on
        the device, then the exact re-rank against host rows, which no
        graph can read (the JAX package's override of `search`). Otherwise
        one program."""
        if self.raw_host is None:
            return super().search(queries, k, params=params, mask=mask, programs=programs)
        _, r = self.search_first_stage(queries, self._ncand(k), params=params, mask=mask)
        return self._rerank(queries, k, r, self._exact_scores_host)

    # -------------------------------------------------------------- misc
    @property
    def memory_bytes(self) -> int:
        """Bytes of the index's own tensors; raw_data / raw_aux are the
        segment's and do not count."""
        total = 0
        for f in self._array_fields:
            a = getattr(self, f)
            if a is not None and f not in self._payload_refs:
                total += a.numel() * a.element_size()
        return total

    def state_dict(self) -> Dict[str, Any]:
        """numpy arrays + meta, in the JAX package's layout, without the
        payload references; a bf16 payload crosses as its stored bits
        (uint16)."""
        arrays = {}
        for f in self._array_fields:
            v = getattr(self, f)
            if v is None or f in self._payload_refs:
                continue
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                arrays[f] = v.view(torch.int16).numpy().view(np.uint16)
            else:
                arrays[f] = v.numpy()
        meta = {f: getattr(self, f) for f in self._static_fields}
        meta.update(
            kind=self.kind.value,
            metric=self.metric.value,
            storage_dtype=str(self.perm_data.dtype).replace("torch.", ""),
        )
        return {"meta": meta, "arrays": arrays}

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any], *, device) -> "IVFIndex":
        """The index from `state_dict()`'s layout on `device`, without its
        payload references: a two-stage index needs `reattach_payload`
        before it searches. A raw bf16 payload must arrive as its bits."""
        meta, arrays = state["meta"], state["arrays"]
        bf16 = "bfloat16" in meta["storage_dtype"] and meta["codec"] == "raw"
        kw: Dict[str, Any] = {}
        for f in cls._array_fields:
            v = arrays.get(f)
            if v is None or f in cls._payload_refs:
                continue
            a = np.array(v)
            if f == "perm_data" and bf16:
                if a.dtype.itemsize != 2:
                    raise ValueError(f"a bf16 payload must cross as its 16-bit words, got {a.dtype}")
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            kw[f] = t.to(device)
        kw.update(
            metric=Metric(meta["metric"]),
            dim=int(meta["dim"]),
            n_rows=int(meta["n_rows"]),
            n_clusters=int(meta["n_clusters"]),
            n_windows=int(meta["n_windows"]),
            wpp=int(meta["wpp"]),
            codec=meta["codec"],
            two_stage=bool(meta["two_stage"]),
            rerank_multiple=int(meta["rerank_multiple"]),
        )
        return cls(**kw)


class FilteredIVF(VectorIndex):
    """An IVF index under a pre-filter (`IVFIndex.filter_layout`). Its
    search takes the index's layout of the passing rows as its mask:
    int32[C + 1 + M'], each list's first entry, then the passing rows in
    the index's cluster-major order. It ranks the index's lists as the
    unfiltered search does, takes them in that order until it holds
    `budget` candidates (nprobe lists of the index's mean size, and at
    least what the index would re-rank: the rows the user's nprobe buys,
    counted in passing rows) and every passing row of the first nprobe
    lists (in up to `over` slots past the budget), and scores every
    candidate exactly against the stored rows (`row_rescore`: on the card
    one kernel that reads each row once by its id) before one top-k. The
    lists a search ranks (`n_probe`) and its slots are static, the layout
    an input, so filters of one size share one captured program; the
    actual nprobe cuts the candidates past its own budget and lists, as it
    masks probes unfiltered."""

    supports_dyn_nprobe = True

    def __init__(self, index: IVFIndex, n_probe: int, over: int):
        self.index = index
        self.kind = index.kind
        self.metric = index.metric
        self.dim = index.dim
        self.n_rows = index.n_rows
        self.n_probe = n_probe
        self.over = over

    def search_t(self, queries, k, *, mask=None, params=(), dyn_nprobe=None):
        if mask is None or mask.dtype != torch.int32:
            raise ValueError("a filtered IVF search takes its layout of the passing rows as "
                             "its mask")
        idx = self.index
        need, per_list = _filtered_need(idx, k)
        nprobe = idx._nprobe(params)
        budget = max(need, nprobe * per_list)
        nq, c, n_probe = queries.shape[0], idx.n_clusters, self.n_probe
        start = mask[: c + 1].to(torch.int64)
        q = distance.normalize_queries(queries.to(torch.float32), idx.metric)
        count = start[1:] - start[:-1]
        probe = torch.topk(idx._list_scores(q, count), n_probe, dim=1).indices  # [Q, P]
        held = count[probe]  # [Q, P]
        cum = torch.cumsum(held, dim=1)
        slots = budget + self.over
        j = torch.arange(slots, device=q.device)
        # the probe each candidate slot falls in, and its place there
        p_idx = torch.searchsorted(cum, j.expand(nq, slots).contiguous(), right=True)
        if isinstance(dyn_nprobe, torch.Tensor):  # a program's device scalar
            act = torch.clamp(dyn_nprobe, max=nprobe)
            live = (j < torch.clamp(act * per_list, min=need)) | (p_idx < act)
        elif dyn_nprobe is not None:
            act = min(int(dyn_nprobe), nprobe)
            live = (j < max(need, act * per_list)) | (p_idx < act)
        else:
            live = (j < budget) | (p_idx < nprobe)
        live = live & (p_idx < n_probe)
        p_idx = torch.clamp(p_idx, max=n_probe - 1)
        first = torch.gather(cum - held, 1, p_idx)
        pos = start[torch.gather(probe, 1, p_idx)] + (j - first)
        cand = mask[c + 1:][torch.where(live, pos, torch.zeros_like(pos))]
        cand = cand.masked_fill(~live, -1)
        count_work("ivf.window_rows", nq * slots)
        if idx.two_stage:
            scores = idx._exact_scores(queries, cand)
        else:  # IVFFLAT's rows: Cosine's are normalized already
            metric = Metric.IP if idx.metric == Metric.COSINE else idx.metric
            scores = row_rescore(q[:, : idx.perm_data.shape[1]].contiguous(), idx.perm_data,
                                 idx.perm_aux, cand, metric=metric)
        v, p = torch.topk(scores, min(k, slots), dim=1)
        r = torch.gather(cand, 1, p)
        if not idx.two_stage:
            r = idx.perm_rows[torch.clamp(r, min=0).to(torch.int64)]
        r = torch.where(torch.isfinite(v), r, torch.full_like(r, -1))
        return _pad_cols(v, r, k)


# the layouts an index keeps of repeated filters, the oldest out first
_FILTER_LAYOUTS = 32


def _filtered_need(idx: IVFIndex, k: int) -> Tuple[int, int]:
    """(the fewest candidates a filtered search scores: k, or the rows a
    two-stage index re-ranks; the rows of the index's mean list)."""
    need = idx._ncand(k) if idx.two_stage else min(k, idx.n_rows)
    return need, -(-idx.n_rows // idx.n_clusters)


def _build(cls, payload, n_rows, metric, dim, params, settings, cancel_cb, codec, two_stage):
    return cls._build_common(
        payload, n_rows, metric=metric, dim=dim, params=dict(params or {}),
        settings=settings, codec=codec, two_stage=two_stage, cancel_cb=cancel_cb,
    )


@register(IndexKind.IVFFLAT)
class IVFFlatIndex(IVFIndex):
    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None, cancel_cb=None):
        if getattr(payload, "is_host", False):
            # a host-tier payload (asked for, or spilled under memory
            # pressure): raw IVFFLAT would mirror it whole on the device, so
            # the build takes the disk-mode shape instead (SQ8 windows on
            # the device, the exact re-rank against the host rows), whose
            # reported distances stay exact
            GLOBAL_COUNTERS.bump("IvfFlatDegradedToDiskMode")
            return _build(cls, payload, n_rows, metric, dim, params, settings, cancel_cb,
                          "sq8", True)
        return _build(cls, payload, n_rows, metric, dim, params, settings, cancel_cb, "raw", False)


@register(IndexKind.IVFSQ)
class IVFSQIndex(IVFIndex):
    """SQ8 windows ranked, the top k * rerank_multiple re-scored exactly
    against the raw payload (zero extra device memory: raw_data references
    the segment's payload). The reference reports SQ-reconstructed
    distances here; both packages report exact ones."""

    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None, cancel_cb=None):
        return _build(cls, payload, n_rows, metric, dim, params, settings, cancel_cb, "sq8", True)


@register(IndexKind.IVFPQ)
class IVFPQIndex(IVFIndex):
    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None, cancel_cb=None):
        return _build(cls, payload, n_rows, metric, dim, params, settings, cancel_cb, "pq", True)


@register(IndexKind.MSTG)
class MSTGIndex(IVFIndex):
    """Multi-stage tree-graph analogue: an SQ8 IVF first pass and an exact
    re-rank on the raw payload (two-stage)."""

    @classmethod
    def build(cls, payload, n_rows, *, metric, dim, params=None, settings=None, cancel_cb=None):
        params = dict(params or {})
        # disk_mode=1: the exact re-rank's rows move to host memory and only
        # the SQ8 windows stay on the device (the reference's disk-mode
        # MSTG); a host-tier payload implies it
        disk = bool(int(params.pop("disk_mode", 0) or 0))
        return cls._build_common(
            payload, n_rows, metric=metric, dim=dim, params=params, settings=settings,
            codec="sq8", two_stage=True, cancel_cb=cancel_cb, force_host_raw=disk,
        )
