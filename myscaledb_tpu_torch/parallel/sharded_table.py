"""ShardedTable: the Distributed-engine analogue — one logical table over
N shards with initiator-side fusion.

Reference semantics (SURVEY.md §3.3, L6): a Distributed table fans the
(rewritten) query out to shards, each shard runs its local search, and the
initiator merges: vector legs merge by score, text legs score against
CLUSTER-wide BM25 statistics collected first (the `_fts_statistic_info`
scalar, ReadWithHybridSearch.cpp:267-292), hybrid legs are fused on the
initiator (FusionSortingStep / HybridSearchFusionTransform).

Counterpart of myscaledb_tpu/parallel/sharded_table.py: each shard is a
Table of the same Database, its segments on that database's device. On
one card the fan-out is sequential dispatch, as in the JAX package; the
initiator fuses on the host (numpy), so the shards' kernels are the only
device work. Rows are addressed (shard, segment, row). The row-sharded
single corpus over a grid of devices is parallel/mesh_table.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import Settings
from ..errors import QueryShapeError, SchemaError
from ..metrics import Metric, direction
from ..search.filters import Expr
from ..search.fusion import rank_fusion, relative_score_fusion
from ..storage.schema import Schema
from ..text.inverted import BM25Stats


def _stable_shard(key: np.ndarray, n_shards: int) -> np.ndarray:
    """Deterministic shard of each key — stable across processes and
    restarts (the reference uses sipHash in the sharding expression;
    Python's builtin hash() is randomized per process for strings).
    Integers use a splitmix64 mix; other values hash their UTF-8 repr
    via blake2b."""
    if np.issubdtype(key.dtype, np.integer):
        x = key.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
        return (x % np.uint64(n_shards)).astype(np.int64)
    import hashlib

    out = np.empty(len(key), np.int64)
    for i, v in enumerate(key):
        h = hashlib.blake2b(str(v).encode("utf-8"), digest_size=8).digest()
        out[i] = int.from_bytes(h, "little") % n_shards
    return out


@dataclasses.dataclass
class ShardedResult:
    """Global top-k across shards: (shard, segment, row, score)."""

    scores: np.ndarray  # f32[Q, k]
    shards: np.ndarray  # int32[Q, k]
    segments: np.ndarray  # int64[Q, k]
    rows: np.ndarray  # int32[Q, k]
    metric: Metric
    distances: np.ndarray  # user-visible

    @property
    def nq(self):
        return self.scores.shape[0]

    @property
    def k(self):
        return self.scores.shape[1]

    @property
    def valid(self):
        return self.rows >= 0


class ShardedTable:
    def __init__(
        self,
        db,
        name: str,
        schema: Schema,
        *,
        n_shards: int,
        settings: Optional[Settings] = None,
        shard_key: Optional[str] = None,
    ):
        if n_shards < 1:
            raise SchemaError("n_shards must be >= 1")
        self.name = name
        self.schema = schema
        self.n_shards = n_shards
        self.shard_key = shard_key
        self.shards = [
            db.create_table(f"{name}__shard{i}", schema, settings=settings)
            for i in range(n_shards)
        ]
        self._rr = 0

    # ------------------------------------------------------------- ingest
    def insert(self, columns: Dict[str, Any]) -> List[int]:
        """Rows route by hash(shard_key) when set (sharding expression of
        the Distributed DDL), else whole inserts round-robin."""
        first = next(iter(columns.values()))
        n = len(first)
        if self.shard_key is None:
            sid = self._rr % self.n_shards
            self._rr += 1
            return [self.shards[sid].insert(columns)]
        key = np.asarray(columns[self.shard_key])
        which = _stable_shard(key, self.n_shards)
        out = []
        for s in range(self.n_shards):
            sel = which == s
            if not sel.any():
                continue
            out.append(
                self.shards[s].insert(
                    {c: np.asarray(v)[sel] for c, v in columns.items()}
                )
            )
        return out

    def delete(self, filter: Expr) -> int:
        return sum(s.delete(filter) for s in self.shards)

    # -------------------------------------------------------------- index
    def add_vector_index(self, name: str, column: str, type: str = "MSTG", **params):
        return [
            s.add_vector_index(name, column, type=type, **params)
            for s in self.shards
        ]

    def drop_vector_index(self, name: str):
        for s in self.shards:
            s.drop_vector_index(name)

    def add_fts_index(self, name: str, columns, params=None):
        return [s.add_fts_index(name, columns, params) for s in self.shards]

    def wait_index_built(self, timeout: float = 600.0) -> bool:
        return all(s.wait_index_built(timeout) for s in self.shards)

    @property
    def n_rows(self) -> int:
        return sum(s.n_rows for s in self.shards)

    # ------------------------------------------------------------- search
    def search(
        self,
        column: str,
        query,
        k: Optional[int] = None,
        **kw,
    ) -> ShardedResult:
        """Vector search fan-out + initiator score merge."""
        results = [s.search(column, query, k, **kw) for s in self.shards]
        return self._merge_vector(results)

    def _merge_vector(self, results) -> ShardedResult:
        k = results[0].k
        nq = results[0].nq
        metric = results[0].metric
        allv = np.concatenate([r.scores for r in results], axis=1)
        alls = np.concatenate([r.segments for r in results], axis=1)
        allr = np.concatenate([r.rows for r in results], axis=1)
        alld = np.concatenate([r.distances for r in results], axis=1)
        shard_tag = np.concatenate(
            [np.full_like(r.rows, i) for i, r in enumerate(results)], axis=1
        )
        order = np.argsort(-allv, axis=1, kind="stable")[:, :k]
        take = lambda a: np.take_along_axis(a, order, axis=1)
        vals, segs, rows = take(allv), take(alls), take(allr)
        bad = ~np.isfinite(vals) | (rows < 0)
        return ShardedResult(
            scores=vals,
            shards=np.where(bad, -1, take(shard_tag)).astype(np.int32),
            segments=np.where(bad, -1, segs),
            rows=np.where(bad, -1, rows).astype(np.int32),
            metric=metric,
            distances=take(alld),
        )

    def text_search(
        self,
        column_or_index: str,
        query: str,
        k: Optional[int] = None,
        *,
        filter: Optional[Expr] = None,
        operator: str = "OR",
    ) -> ShardedResult:
        """BM25 fan-out with cluster-consistent statistics: the initiator
        first aggregates every shard's corpus stats, then every shard
        scores against the same numbers."""
        from ..search.text_executor import TextSearchExecutor

        stats = BM25Stats.merge(
            [
                TextSearchExecutor(s)._resolve(column_or_index).merged_stats(
                    [seg.segment_id for seg in s.live_segments()]
                )
                for s in self.shards
            ]
        )
        results = [
            s.text_search(
                column_or_index, query, k,
                filter=filter, operator=operator, stats_override=stats,
            )
            for s in self.shards
        ]
        return self._merge_vector(results)

    def hybrid_search(
        self,
        vector_column: str,
        text_column: str,
        vector_query,
        text_query: str,
        k: Optional[int] = None,
        *,
        fusion_type: str = "rsf",
        fusion_weight: Optional[float] = None,
        fusion_k: Optional[int] = None,
        filter: Optional[Expr] = None,
        operator: str = "OR",
        params: Optional[Dict[str, Any]] = None,
    ) -> ShardedResult:
        """Distributed hybrid: both legs run on every shard (vector leg as
        is; text leg with cluster stats), the initiator fuses the two
        global top-k lists (StorageDistributed.cpp:1058 split + fusion)."""
        st = self.shards[0].settings
        k = int(k if k is not None else st.query.default_topk)
        n_cand = min(
            k * st.query.hybrid_search_top_k_multiple_base,
            st.query.max_search_result_window,
        )
        vres = self.search(vector_column, vector_query, n_cand, filter=filter, params=params)
        if vres.nq != 1:
            raise QueryShapeError("hybrid search takes a single vector query")
        tres = self.text_search(
            text_column, text_query, n_cand, filter=filter, operator=operator
        )
        vkeys, vdists = [], []
        for j in range(vres.k):
            if vres.rows[0, j] >= 0:
                vkeys.append(
                    (int(vres.shards[0, j]), int(vres.segments[0, j]), int(vres.rows[0, j]))
                )
                vdists.append(float(vres.distances[0, j]))
        tkeys, tscores = [], []
        for j in range(tres.k):
            if tres.rows[0, j] >= 0:
                tkeys.append(
                    (int(tres.shards[0, j]), int(tres.segments[0, j]), int(tres.rows[0, j]))
                )
                tscores.append(float(tres.scores[0, j]))
        if fusion_type.lower() == "rrf":
            fused = rank_fusion(
                [vkeys, tkeys], k,
                fusion_k=int(fusion_k or st.query.hybrid_search_fusion_k),
            )
        else:
            fused = relative_score_fusion(
                list(zip(vkeys, vdists)),
                list(zip(tkeys, tscores)),
                k,
                fusion_weight=(
                    st.query.hybrid_search_fusion_weight
                    if fusion_weight is None
                    else fusion_weight
                ),
                vec_ascending_better=direction(vres.metric) == "asc",
            )
        scores = np.full((1, k), -np.inf, np.float32)
        shards = np.full((1, k), -1, np.int32)
        segs = np.full((1, k), -1, np.int64)
        rows = np.full((1, k), -1, np.int32)
        for i, ((sh, sg, rw), sc) in enumerate(fused):
            scores[0, i] = sc
            shards[0, i] = sh
            segs[0, i] = sg
            rows[0, i] = rw
        return ShardedResult(
            scores=scores, shards=shards, segments=segs, rows=rows,
            metric=Metric.IP, distances=scores.copy(),
        )

    # -------------------------------------------------------------- read
    def gather(self, result: ShardedResult, columns: List[str]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for cname in columns:
            ctype = self.schema.require(cname)
            if ctype.np_dtype == np.dtype(object):
                arr = np.full(result.rows.shape, "", dtype=object)
            else:
                arr = np.zeros(result.rows.shape, dtype=ctype.np_dtype)
            out[cname] = arr
        for si, shard in enumerate(self.shards):
            sel_shard = result.shards == si
            if not sel_shard.any():
                continue
            segs = {s.segment_id: s for s in shard.live_segments()}
            for sid, seg in segs.items():
                sel = sel_shard & (result.segments == sid) & (result.rows >= 0)
                if not sel.any():
                    continue
                for cname in columns:
                    out[cname][sel] = seg.scalar(cname)[result.rows[sel]]
        return out
