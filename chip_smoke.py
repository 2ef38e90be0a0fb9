#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one GPU.

    python3 chip_smoke.py [--profile] [--out DIR] [--f32-tables-only] [--root DIR]
                          [--mesh-cards] [--approx-only] [--programs-only]
                          [--rescore-only] [--window-scan-only] [--row-rescore-only]

Run from the root of a checkout on a machine with one CUDA GPU (an H100:
the kernels are built for sm_90a). It imports nothing of JAX and nothing
of the JAX package. Phases, each of which raises on failure:

  1. set-up: versions, the card's name and power limit, the nvcc build of
     the kernels in myscaledb_tpu_torch/csrc/ (one nvcc per source, all
     started together) and what `-Xptxas -v` said of each kernel;
  2. each hand-written kernel against its plain PyTorch version on the
     card, at the shapes the main paths give it and at one ragged shape
     (Q = 300): score and tile_max held to `distance.kernel_error_bound`
     on zero-mean and on clustered data (the worst err/bound of each
     printed), with a hi-only control (the bf16 payload's query split
     without its lo half) that must fall outside it, and the kernels' own
     query split
     checked bit for bit against `split_query_bf16`; over an f32 payload
     (the 3xTF32 engine, F32_SUM_TOL) with two controls that must fall
     outside (single-pass TF32, the two-term split without q_hi x_lo),
     the worst err/bound printed, and two bit-level probes (one-hot rows
     and depths for the fragment layout; operands whose three TF32
     products are exact); gathermv held to
     `gathermv.kernel_error_bound`, with a control that skips the query's
     bf16 cast and must fall outside it; the binary kernel, both layouts,
     bit for bit;
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
     kernel) with recall against phase 4's exact results and QPS, the
     kernels a graph batch launches at ef_s 100 (one profiled pass), a
     filtered search, the routed default search and a search after
     deletes (--profile adds the graph search's cell);
  7. times: each kernel beside its plain version, the library call that
     computes the same function (where there is one) and its bound, and
     for score one bf16 torch.matmul over the same tensor-core work; the
     f32 engine at a stream chunk, a spilled 128-d chunk and the GIST f32
     segment beside `torch.matmul` f32, the CUDA-core FMA bound and the
     3xTF32 tensor-core bound; the
     routing cost model's constants, as medians over COST_RUNS runs of the
     graph search at two batch sizes (host and device time) and of phase
     5's exact scan, with their spread and the HNSW cell's routing at both
     ends of it; the tile prune's rescore kernel at the benchmark's SIFT
     and GIST exact shapes (`rescore_path`: against its plain version with
     a bf16-query control, then timed; `--rescore-only` runs phase 1 and
     this alone); the IVF window scan kernel at the benchmark's two IVF
     cells' shapes (`window_scan_path`: against its plain version, then
     timed beside the bound of the live windows' bytes;
     `--window-scan-only` runs phase 1 and this alone); the two-stage IVF
     re-rank kernel at the Cohere MSTG cell's shape and a 128-d IVFSQ
     shape (`row_rescore_path`: against its plain version with a
     bf16-query control, then timed beside the four library passes it
     replaced and its byte bound; `--row-rescore-only` runs phase 1 and
     this alone);
  8. the IVF family on phase 3's table: IVFFLAT (ncentroids 1024) with its
     build time, an nprobe sweep that stops at the first recall_ids@10 >=
     0.95 (bench.py's rule), QPS at that operating point at batch 100 and
     500, an nprobe-3 search (dyn_nprobe), a 10% filter through the
     index's layout of the passing rows (built once, then cached) and a 0.5% filter that
     falls back to the exact scan (tile_max); then IVFSQ, IVFPQ and the
     default MSTG (add_vector_index with no type), one at a time, and MSTG
     under two_stage_search. Every hit must be a live row with its exact
     f32 score. Then HNSWPQ (m=32, ef_c=100) on phase 4's table, searched
     at ef_s 100 (gathermv). --profile adds the ivf_flat cell and the
     window step's gathered bytes beside the exact scan's device time;
  9. text and hybrid search on a 1,000,000 + 50,000-row table (bench.py's
     12-word documents, phase 3's vectors): add_fts_index (which builder
     ran, build seconds), 1,000 three-word queries (the sparse BM25 path on
     the 1M store), 8-word queries (the dense path), AND, a filter, an NLQ
     phrase, RRF and RSF hybrid search, then 100 deletes. Every text hit
     lies within its bound of an f64 BM25 of its row (and no row left out
     of the first batch beats the k-th beyond it); each fused list equals a
     numpy fuse of its own two legs; the vector leg launches tile_max and
     score. Both BM25 paths on the same 100 queries (score difference,
     device ms), text and hybrid QPS; --profile adds text_bm25 and
     hybrid_rrf;
 10. binary vectors: 1,000,000 x 1,024-bit rows (the sign bits of a
     clustered 1,024-d corpus), Hamming and Jaccard exact scans (binary
     kernel, rows layout), then BinaryMSTG with default params (blocks
     layout: the grouping kernel, then the scoring kernel; build seconds,
     recall against the exact scan), a filter and deletes. Hits' scores
     are recomputed in numpy and the first queries' top-k equal a full
     numpy scan's. The binary kernels are compared with their plain
     versions bit for bit in phase 2, and here at BinaryMSTG's own inputs
     (both metrics, with and without the mask and the slots' bit counts)
     and under skewed probes; the rows layout, the blocks call of each
     metric and the grouping alone are timed beside their bounds;
     --profile adds binary_exact and binary_mstg;
 11. the rest of Table and Database, with the builds on the database's
     background scheduler: (a) on phase 3's table ADD COLUMN tag, UPDATE
     tag = 1 WHERE id < 10000, a search filtered on tag == 1 against one
     filtered on id < 10000 (the same hits), compute_distances against the
     search's distances, DROP COLUMN; (b) phase 3's table, and phase 4's
     with a fresh HNSWFLAT, persisted to a temporary directory and
     reloaded through connect(path=...) / load_table: the same hits as the
     live tables, the graph reloaded on its first search (gathermv);
     (c) phase 3's corpus in two 500,000-row parts with IVFFLAT each and
     100 deletes, merge() behind a gated scheduler: the DecoupledIndex
     returns the pre-merge ids, then the rebuild's nprobe sweep, truncate
     and a fresh insert; (d) a ReplacingMergeTree(ver) table of 1,000,000
     rows and 100,000 newer versions: search(final=True) equal to a numpy
     scan over the winners, before and after merge(). Phase 11 logs its
     seconds;
 12. the host tier: (a) the pinned host -> device copy rate (one 1 GiB
     copy), the streamed scan's bound; (b) a vector_storage_tier='host'
     table of bench.py's beyond-HBM corpus (10,000,000 x 960 f32, L2, ten
     1M-row inserts of 1,048,576-row segments, 42.9 GB of pinned host
     memory; made on the card from seeded generators; cut in 1M-row steps
     while MemAvailable is under 2.2x the payload, logged); (c) its exact
     scan streamed through the card (copy stream, two device buffers): two
     timed passes, GB/s against (a), the f32 score launches (8 chunks a
     segment), the first queries against an f64 numpy scan and every hit
     against its row's f64 score, a filter that const-folds nine segments
     away, deletes, and the f32 engine of score and tile_max against its
     plain version at one stream chunk's operands; (d) a default
     MSTG over it (disk mode: SQ8 windows on the card, the exact re-rank
     from host rows): build seconds, device bytes, the nprobe sweep to
     recall_ids@10 >= 0.95 against (c), QPS and the speedup over (c);
     (e) phase 3's corpus in a table whose device budget refuses it: the
     spill (bf16-rounded values, counter, TierSpill), phase 3's hits, then
     MSTG disk_mode=1 persisted and reloaded; (f) MSTG disk_mode=1 on phase
     3's table against phase 8's MSTG ids; (g) HNSWFLAT over phase 4's
     corpus in a host-tier table (gathermv): recall_ids@10 against phase
     4's exact results within 0.01 of phase 6's, and against the f32 rows;
 13. device f32 tables (storage_dtype='float32'): phase 3's SIFT corpus
     (L2, batch 100: the f32 tile_max on the 1M segment, the f32 score on
     the 50k one) and phase 4's GIST corpus (Cosine, batch 256: the f32
     score), recall@10 = 1.0 against an f64 numpy scan of the f32 rows
     (near-tie rule), the f32 launches a search, then one-pass QPS over 9
     passes, device ms and kernels a search (torch.profiler; traces under
     --out). `--f32-tables-only` runs phase 1 and this phase alone, and
     `--root DIR` imports the package from another checkout (a parent
     commit unpacked with `git archive`), for a same-machine comparison;
 14. the front ends, after phase 11 and before phase 12 (which needs the
     host memory phase 9's table holds until then): (a) 100 one-query
     distance() statements on phase 3's table against the exact oracle
     (near-tie rule), a batch_distance of the same queries (and with
     WHERE id < 10000) equal to Table.search of the batch exactly, EXPLAIN,
     and each statement's host ms outside its search; (b) textsearch()
     and hybridsearch('fusion_type=rrf') statements on phase 9's table
     equal to Table.text_search / hybrid_search; (c) an HNSWFLAT index made
     by ALTER TABLE on phase 4's table, distance('ef_s=100') statements
     equal to Table.search with routing off (gathermv) and on; (d) the
     host syncs of one search (torch.cuda.set_sync_debug_mode "warn"),
     then SearchServer(max_batch=256, max_delay_ms=2.0) under bench.py's
     sync and async connection grids (1, 8, 32, 64; windows cut to 2 s),
     every response against the exact oracle, with QPS, groups and each
     group's dispatcher and resolution times; (e) HttpFrontend on
     127.0.0.1 (/ping, /search, /text_search, /hybrid_search, /sql)
     against the in-process calls, and `python3 -m myscaledb_tpu_torch.cli`
     as subprocesses: remote against the frontend, local on the card, and
     local without a visible card (it must raise);
 15. replication and the sharded table, after phase 14 and before phase
     12, at phase 3's size: (a) two ReplicatedNodes on 127.0.0.1, each over
     its own Database on the card: A inserts phase 3's corpus (seconds with
     and without the commit listener), B syncs (seconds, MB/s over
     loopback) and its 1,000 searches return A's ids under the exact
     oracle; then through B's sync thread A's 100 deletes (none comes
     back), an UPDATE tag = 1 WHERE id < 10000 (B's tag == 1 searches,
     after tag == 2 ones filled its caches, return only marked rows) and a
     leader merge of two 500,000-row parts (the follower's merge deferred;
     the same hits on both after); each replica's device bytes; (b)
     build_vector_index_on_random_single_replica: IVFFLAT (ncentroids
     1,024) on the 1M segment built by one replica and fetched by the
     other, over a shared path and over the HTTP exchange, no local build
     on the fetcher, its ids at phase 8's nprobe the builder's on 1,000 of
     1,000 queries; (c) phase 3's corpus in a 4-shard table (its hits,
     unfiltered and under the 1% filter, phase 3's), phase 9's documents
     in a 4-shard text table (phase 9's 3-word queries score as phase 9's
     table, within the sparse path's bound: cluster-wide BM25
     statistics), hybrid RRF against a numpy fuse of its legs; CommitListenerErrors and ReplicationSyncErrors must read 0, and
     the phase must end within 90 s;
 16. MeshTable (one corpus sharded row-wise over a grid of devices held by
     one process) over four shards of the card, `Mesh([[cuda:0] * 4])`,
     after phase 15 and before phase 12: first `make_mesh` must refuse
     more cards than the machine has; (a) phase 3's corpus with an Int32
     price column: exact search against phase 3's oracle (near-tie rule),
     a 1% filter (price < 10) against the filtered oracle, the top hit of
     100 queries deleted, a 2x2 grid (query axis 2) returning the same
     hits, QPS beside phase 3's table (now and in phase 5) and 15c's
     ShardedTable; (b) build_ivf(1024) with build seconds and each
     shard's window-gather bytes estimated from bucket_pad (the batch cut
     while they pass MESH_GATHER_BYTES), an nprobe sweep to recall_ids@10
     >= 0.95 against (a), every hit's exact f32 score, QPS; 10,000 rows
     appended without a rebuild, each its own nearest neighbour through
     the delta scan; (c) build_mstg(1024) from IVF's nprobe, the same
     checks; (e) save / load of (a)'s table (before (d), which needs the
     host memory) returning its hits; (d) phase 9's documents and
     vectors with its deletes in a text MeshTable: 1,000 3-word queries,
     every hit within DENSE_RTOL of the f64 BM25 under the global
     statistics, 20 hybrid RRF and 20 RSF searches equal to a numpy fuse
     of their own legs. The phase logs its seconds and score's launches.
     `--mesh-cards` (two or more cards) runs phase 1 and phase 3's corpus
     in a MeshTable with a shard on each card against the same shards on
     one card (and a 2 x n/2 grid): the same hits, QPS, each card's bytes;
 17. the approximate top-k (use_approx_topk: each score row folded into L
     strided bins, the bins' winners' exact top-k), after phase 5 and
     before phase 6 indexes phase 4's table: (a) its partial-reduce
     kernel (`approx_bin_max`) against its plain version bit for bit,
     values and indices, at the main path's shapes (a SIFT chunk at L
     1,024 and 128, the GIST segment, a binary chunk, the dense text
     store), with -inf rows, exact ties, an N that is not a multiple of L
     and a column slice read in place; its time beside its plain
     version, the library call (`torch.max` over the [Q, N/L, L] view)
     and its bound, and `torch.topk`'s; (b) phase 3's SIFT table and (c)
     phase 4's GIST table at recall targets 0.9, 0.95 and 0.99:
     recall_ids@10 against phase 3's / 4's exact oracle (>= the target -
     0.01, and >= 0.98 at 0.99), every hit's exact f32 score, device ms a
     search and QPS beside the exact search; (d) phase 10's 1M x 1,024-bit
     rows through `binary_scan_topk(approx=True)`: recall of the exact
     top-k's scores and every Hamming distance numpy's; (f)
     `distributed_scan_topk(approx=True)` over phase 3's 1M segment on
     `Mesh([[cuda:0] * 4])` against the exact mesh scan; (g) an IVFFLAT
     and an HNSWFLAT index on phase 4's table return the same ids with
     the setting as without it. (e) runs after phase 9: the 50k store's
     dense BM25 path with `approx=True`, every hit within DENSE_RTOL of
     the f64 BM25 and the exact call's top-k scores recalled. With the
     setting off no other phase launches the kernel (checked).
     `--approx-only` runs phases 1, 3, 4 and 17 (without (e));
 18. the search programs (every search above already replays one CUDA
     graph a search: search/program.py), after phase 10: on phase 3's
     and phase 4's tables exact, HNSWFLAT at ef_s 100 on phase 4's table
     and IVFFLAT at phase 8's nprobe on phase 3's (both built fresh and
     dropped after), and phase 10's binary table (the Jaccard exact scan,
     BinaryMSTG), each batch through the table's program (a graph replay)
     and through the same program's body run eagerly (`eager_bodies`):
     ids, tags and scores bit-equal; for both paths the host launch-API
     calls, kernels, device ms and busy share a search (torch.profiler)
     and the median QPS of 5 one-pass rounds run in turns; captures,
     replays and the recapture after a mutation (an ADD / DROP COLUMN
     pair, or a delete). 18h-k, on phase 9's table: text BM25 over the
     3-word and the 8-word batches, hybrid RRF and RSF (a hybrid search
     replays three programs: vector, text, fuse), at most 8 / 16 host
     launch-API calls a search, no host sync inside one, and the graph
     pool's reserved bytes. 18l-o: MeshTable's programs (one CUDA graph a
     search on `Mesh([[cuda:0] * 4])`) on 16a's table: exact and price <
     10 (1%), IVF at phase 8's nprobe, then 10,000 appended rows (the
     delta route), the two-stage route, and on phase 9's documents 3-word
     BM25 and hybrid RRF / RSF (one graph each): bit-equal, no host sync
     in one search, at most 8 launch calls a vector or text search (16 a
     hybrid one; a filtered one 2 a shard more for its filter's kernel and
     mask copy), in-place deletes and appends read by the next replay
     with no recapture. 18g, inside 14d: the server's sync 8 and async
     64 points, 5 one-second windows a path in turns, every response
     against the exact oracle. `--programs-only` runs phases 1, 3, 4 and
     18 (IVFFLAT at nprobe 2, its own binary table, phase 9's table
     without phase 9's checks, 18g on its own server).

Each path's launch counters are zeroed just before it is driven and read
just after: score and tile_max over phases 3-4, gathermv over phase 6, all
three over phase 8, score and tile_max over phase 9, approx_bin_max
(with score and tile_max) over phase 17, the binary rows
layout, blocks layout and grouping over phase 10, those three with
score, tile_max and gathermv over phase 18, score, tile_max and
gathermv over phases 11 and 14, score and tile_max over phases 15 and 16
(tile_max need not launch there: no mesh shard meets its alignment), and
over phases 12 and 13 also the f32
engine's launches of score and tile_max (the record's score_f32 and
tile_max_f32 lines);
every kernel must have launched on its path, and the record's launches
are the sums over those paths. A graph replay counts the launches its
capture recorded; a program's warm-up run before its capture counts
apart (SearchProgramWarmupLaunches).
The last line of standard output is {"ok": true, "device": {...}};
the line before it is the per-kernel JSON record. Without CUDA, or without
the package beside this file, it exits non-zero and prints no result.
"""

import contextlib
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
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
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
# (Q, S, D, metric) of the rescore kernel's comparison and times: the
# benchmark's SIFT (batch 1,000) and GIST (batch 256, D padded to 1,024)
# exact cells over a 1,048,576-row segment at k 10 (S = k + TILE_SLACK)
RESCORE_SHAPES = [(1_000, 12, 128, "L2"), (256, 12, 1024, "L2")]
RESCORE_N = 1_048_576
# (cell, Q, D, payload, metric, rows, lists, nprobe) of the window scan's
# comparison and times: the benchmark's IVF cells (SIFT1M IVFFLAT, 1,024
# lists asked, 1,536 built, nprobe 2, batch 1,000; Cohere1M MSTG, 4,096
# asked, 6,144 built, nprobe 4, batch 256, SQ8 codes); the window budget
# follows from them as the index sizes it (10 and 12 slots)
WINDOW_SHAPES = [("sift1m-ivfflat-b1000", 1_000, 128, "bf16", "L2", 1_000_000, 1_536, 2),
                 ("cohere1m-mstg-b256", 256, 768, "sq8", "Cosine", 1_000_000, 6_144, 4)]
# (cell, Q, C, D, metric, rows) of the two-stage re-rank's comparison and
# times: the Cohere1M MSTG cell (k 100 x rerank_multiple 4 candidates,
# batch 256, bf16 rows); its filtered cell, whose layout of the passing
# rows scores nprobe 4 x 163 rows a list (6,144 lists); phase 8's filtered
# IVFFLAT search on the rows of its layout (nprobe 2 x 652 rows a list of
# 1,536, batch 100); and a 128-d IVFSQ search over phase 3's SIFT1M table
# (k 10 x 4, batch 1,000); the candidates random rows of the table
RERANK_SHAPES = [("cohere1m-mstg-b256", 256, 400, 768, "Cosine", 1_000_000),
                 ("cohere1m-mstg-f99-b256", 256, 652, 768, "Cosine", 1_000_000),
                 ("sift1m-ivfflat-filter", 100, 1_304, 128, "L2", 1_000_000),
                 ("sift1m-ivfsq-b1000", 1_000, 40, 128, "L2", 1_000_000)]
# (Q, D) of the split check: a resident and a streamed query
SPLIT_SHAPES = [(100, 128), (300, 1024)]
# (Q, N, D) of the f32 engine's bit-level probes: NT 64 / 104 / 256 / two
# q-tiles, resident and ringed queries, D across and within 32-deep chunks
TF32_PROBE_SHAPES = [(64, 512, 64), (104, 4096, 1024), (256, 640, 96), (300, 1024, 136)]
# (Q, N, D, metric) the f32 engine is timed at (phase 7): one host-tier
# stream chunk (the record's line), a spilled 128-d chunk, and the GIST
# f32 table's segment (phase 13)
F32_TIME_SHAPES = [(104, 131_072, 1024, "L2"), (104, 131_072, 128, "L2"),
                   (256, 114_688, 1024, "Cosine")]
# phase 13: one-pass runs per f32-table cell, and the oracle's rows a step
F32_TABLE_RUNS = 9
ORACLE_CHUNK = 65_536
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
# the text and hybrid path (bench.py::sec_hybrid_text, :580-620, at phase
# 3's sizes): documents of 12 words from term0..term4999 drawn with seed 3,
# 1,000 queries in batches of 100 (3 words: the sparse BM25 path on the 1M
# store; 8 words: the dense one), a filter, and RRF / RSF at k 10
TEXT_VOCAB, TEXT_WORDS, TEXT_SEED = 5_000, 12, 3
TEXT_NQ, TEXT_BATCH, TEXT_LONG_WORDS = 1_000, 100, 8
TEXT_FILTER = 100_000
HYBRID_FUSION_K, HYBRID_WEIGHT = 60, 0.5
# the binary path: 1,000,000 rows of 1,024 bits (1,024-d binary-quantised
# embeddings, 128 B a row), batch 100, k 10; the share of BinaryMSTG's hits
# at or above the exact k-th score it must reach at its default nprobe
BIN_N, BIN_DIM, BIN_NQ, BIN_BATCH = 1_000_000, 1_024, 1_000, 100
BIN_FILTER = 500_000
BIN_MIN_SCORE_RECALL = 0.9
# (skew, Q, P, C, M) of the blocks layout's skewed-probe checks: every pair
# on one bucket; every pair on its own bucket; C = 1; Q * P = 91, not a
# multiple of 16; P = 12 > C = 4, with repeats
SKEW_CASES = [("one", BIN_BATCH, 16, 64, 300), ("distinct", 40, 8, 320, 257),
              ("uniform", 9, 5, 1, 100), ("uniform", 13, 7, 20, 96), ("uniform", 9, 12, 4, 513)]
# popcounts an H100 SM retires per clock (CUDA C++ Programming Guide,
# throughput of native arithmetic instructions, compute capability 9.0)
POPC_PER_CLK_PER_SM = 16
# csrc/binary.cu: the buckets the grouping counts in shared memory
# (BG_SMEM_BUCKETS) and the step of a group's queries (BB_QSTEP)
GROUP_SMEM_BUCKETS = 2_048
BB_QSTEP = 4
# calls of the blocks layout in phase 10's trace, and the launch fields of
# a kernel event that it prints
BLOCKS_TRACE_CALLS = 20
LAUNCH_KEYS = ("grid", "block", "registers per thread", "shared memory", "blocks per SM",
               "warps per SM", "est. achieved occupancy %")
# phase 11: the rows the UPDATE marks (id < MUT_IDS), the rows inserted
# after TRUNCATE (above min_rows_to_build_vector_index, so they build), and
# the ReplacingMergeTree table's superseded keys and FINAL queries
MUT_IDS = 10_000
MERGE_REFILL = 100_000
FINAL_DUP, FINAL_NQ = 100_000, 200
# phase 12, the host tier, at bench.py::sec_beyond_hbm's size (:824-905):
# 10M x 960 f32 rows, L2, in ten 1M-row inserts (one 1,048,576-row segment
# each, 42.9 GB of pinned host memory), 1,000 blob centres from seed 11,
# chunk i drawn from seed 100 + i, 100 queries; the corpus is cut in 1M-row
# steps while MemAvailable is under HOST_RAM_FACTOR x its payload. The
# stream scan's chunk, the copy whose rate bounds it, the queries the f64
# oracle scans whole, the deletes, and the disk-mode MSTG's nprobe sweep
# and recall target (bench.py:890-905)
HOST_N, HOST_D, HOST_CHUNK, HOST_NQ = 10_000_000, 960, 1_000_000, 100
HOST_CAP, HOST_DPAD = 1_048_576, 1_024
HOST_RAM_FACTOR = 2.2
STREAM_CHUNK = 131_072
LINK_BYTES = 1 << 30
HOST_ORACLE_NQ, HOST_DELETES = 10, 100
HOST_NPROBES = (8, 16, 32, 64, 128, 256)
HOST_RECALL_TARGET = 0.95
# a top-k small enough that the spilled 128-d f32 chunks take the tile-max
# route by the JAX package's byte gate (at k 10 its two byte counts tie)
SPILL_TILE_K = 5


# phase 14, the front ends: one-query distance() statements (then one
# batch_distance of the same queries), text / hybrid statements, HNSW
# statements; the serving grid (bench.py::sec_serving, :622-694) with its
# window cut from 4 s; the local CLI's table
SQL_NQ, SQL_TEXT_NQ, SQL_HNSW_NQ = 100, 10, 20
SERVER_CONNS = (1, 8, 32, 64)
SERVER_WINDOW = 4
SERVER_SECONDS = 2.0
CLI_ROWS, CLI_D = 256, 16
# phase 15, replication and the sharded table at phase 3's size: B's sync
# thread's interval and the wait for it, the shards, and the hybrid
# queries checked against a numpy fuse
REP_SYNC_INTERVAL_S, REP_WAIT_S = 0.05, 120.0
REP_SHARDS = 4
REP_HYBRID_NQ = 20
REP_PHASE_S = 90.0
# phase 16, MeshTable over four shards of the card at phase 3's size: the
# 1% filter (price < 10 of 0..999), rows appended after each index build,
# and the most bytes one shard's IVF window gather may take
MESH_SHARDS = 4
MESH_PRICE_CUT = 10
MESH_NEW = 10_000
MESH_GATHER_BYTES = 8 << 30
MESH_CARDS_DOCS = 100_000  # --mesh-cards: the documents of its text table
# phase 17, the approximate top-k: the recall targets driven, the recall_ids@10
# floor at 0.99 and the slack below each target, the ids a (g) index is
# held to, and the (Q, N, L, share of rows kept, exact ties) the partial
# reduce is compared at: a SIFT chunk (batch 100 padded to 104) at r 0.99
# (the record's line) and 0.9, the GIST segment (batch 256) at 0.99, a
# binary chunk and the 50k text store at 0.99 (batch 100), -inf rows with
# 1% kept, and an N that is not a multiple of L with exact ties
APPROX_TARGETS = (0.9, 0.95, 0.99)
APPROX_MIN_RECALL, APPROX_SLACK = 0.98, 0.01
APPROX_SHAPES = [(104, 131_072, 1_024, 1.0, False), (104, 131_072, 128, 1.0, False),
                 (256, 114_688, 896, 1.0, False), (100, 65_536, 1_024, 1.0, False),
                 (100, 50_176, 1_664, 1.0, False), (104, 131_072, 1_024, 0.01, False),
                 (100, 100_003, 896, 1.0, True)]
APPROX_TIMED = 3  # the first shapes are timed; the record takes the first
APPROX_IVF_NCENT = 256
APPROX_BIN_CAP = 1_048_576  # phase 10's segment capacity: 16 chunks of 65,536


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


def check_rescores(launches, where):
    """A pruned exact scan launches tile_max and then the rescore kernel,
    once each, so over any phase their two counters agree."""
    check(launches["tile_rescore"] == launches["tile_max"],
          f"{where}: tile_max launched {launches['tile_max']} times, the rescore "
          f"{launches['tile_rescore']}")


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
    that bound, so the bound is shown to catch a kernel that drops it. For
    an f32 payload (the 3xTF32 engine, bound `F32_SUM_TOL`) two controls
    must fall outside it: single-pass TF32 and the two-term split without
    q_hi x_lo (`distance.tf32_products`, summed in f64)."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"score": 0.0, "tile_max": 0.0, "score_f32": 0.0, "tile_max_f32": 0.0}
    ratio = {}  # (kernel name, data) -> worst err/bound

    def operands(q, n, d, dtype, metric, data):
        if data == "clustered":  # bench.py's corpus shape: sums that grow with D
            centres = 6.0 * torch.randn((64, d), generator=gen, device=dev)
            pick = torch.randint(0, 64, (n,), generator=gen, device=dev)
            x = centres[pick] + torch.randn((n, d), generator=gen, device=dev)
            rows = torch.randint(0, n, (q,), generator=gen, device=dev)
            qs = x[rows] + 0.3 * torch.randn((q, d), generator=gen, device=dev)
            x = x.to(dtype)
        else:
            x = (3.0 * torch.randn((n, d), generator=gen, device=dev)).to(dtype)
            qs = 3.0 * torch.randn((q, d), generator=gen, device=dev)
        qs = distance.normalize_queries(qs, metric).contiguous()
        aux = distance.base_aux(x, metric)
        if aux is None:
            aux = torch.zeros((n,), dtype=torch.float32, device=dev)
        return qs, x, aux

    def worst(got, want, bound):
        """(max |got - want|, max ratio of |got - want| to its bound)."""
        diff = (got - want).abs()
        ratio = diff / (bound + distance.KERNEL_RTOL * want.abs())
        return float(diff.max()), float(ratio.max())

    def close(name, data, got, want, bound, what, controls=()):
        e, r = worst(got, want, bound)
        err[name] = max(err[name], e)
        ratio[name, data] = max(ratio.get((name, data), 0.0), r)
        line = f"  {name:12s} {what}: max_abs_err={e:.6g} (worst err/bound {r:.3g})"
        for label, control in controls:
            ce, cr = worst(control, want, bound)
            n_out = int(distance.outside_kernel_bound(control, want, bound).sum())
            line += (f"; {label} control max_abs_err={ce:.6g} (worst err/bound {cr:.3g},"
                     f" {n_out} of {want.numel()} outside)")
            check(n_out > 0, f"the bound does not catch a {label} {name} kernel: {what}")
        log(line)
        check(not bool(distance.outside_kernel_bound(got, want, bound).any()),
              f"{name} disagrees with its plain version: {what}")

    def masked_maxes(s, m8):
        s = torch.where(m8[None, :] != 0, s, torch.full_like(s, tilescan.NEG))
        return torch.amax(s.reshape(s.shape[0], -1, tilescan.SUB), dim=2)

    tf32_controls = (("single-pass TF32", distance.TF32_SINGLE),
                     ("two-term (no q_hi x_lo)", distance.TF32_TWO_TERM))
    for kname, q, n, d, _ in KERNEL_SHAPES + RAGGED_SHAPES:
        for dtype, data in ((torch.float32, "normal"), (torch.float32, "clustered"),
                            (torch.bfloat16, "normal"), (torch.bfloat16, "clustered")):
            for metric in (Metric.L2, Metric.IP, Metric.COSINE):
                qs, x, aux = operands(q, n, d, dtype, metric, data)
                split = dtype == torch.bfloat16
                name = kname if split else f"{kname}_f32"
                what = f"Q={q} N={n} D={d} {str(dtype)[6:]} {metric.value} {data}"
                # a bf16-valued query splits into hi = q, lo = 0
                hi_only = qs.to(torch.bfloat16).to(torch.float32)
                if kname == "score":
                    want = distance.scores_plain(qs, x, aux, metric)
                    if split:
                        controls = [("hi-only", distance.scores_plain(hi_only, x, aux, metric))]
                    else:
                        controls = [(label, distance.tf32_products(qs, x, aux, metric, terms))
                                    for label, terms in tf32_controls]
                    close(name, data, distance.scores(qs, x, aux, metric=metric), want,
                          distance.kernel_error_bound(qs, x, aux, metric), what, controls)
                    del want, controls
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
                    controls = []
                    if mname != "all masked":
                        if split:
                            controls = [("hi-only", tilescan.tile_maxes_plain(
                                hi_only, x, aux, m8, metric))]
                        else:
                            controls = [(label, masked_maxes(distance.tf32_products(
                                qs, x, aux, metric, terms), m8)) for label, terms in tf32_controls]
                    close(name, data, got, want, bound, f"{what} {mname}", controls)
                del qs, x, aux
    worst_of = lambda name: max(r for (n, _), r in ratio.items() if n == name)
    log(f"  f32 engine: worst err/bound over every shape and metric: score "
        f"{worst_of('score_f32'):.4g}, tile_max {worst_of('tile_max_f32'):.4g} (bound: "
        f"F32_SUM_TOL 2^-18 of sum |q_i x_i| + 1e-5 of the score)")
    log(f"  bf16 engine: worst err/bound over every shape and metric: normal data score "
        f"{ratio['score', 'normal']:.4g}, tile_max {ratio['tile_max', 'normal']:.4g}; "
        f"clustered data score {ratio['score', 'clustered']:.4g}, tile_max "
        f"{ratio['tile_max', 'clustered']:.4g} (bound: kernel_error_bound, 2^-16 of "
        f"sum |q_i x_i| + 1e-5 of the score)")
    check_split(dev, gen)
    check_tf32_exact(dev)
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


def check_tf32_exact(dev):
    """Two probes of the f32 engine that must hold bit for bit. (a) The
    register fragments and the permuted query: payload row r one-hot at
    depth (7r + 3) % D with value r + 1, query i one-hot at depth i % D:
    every score is one exact product, so a row, query or depth put in the
    wrong place shows as a wrong entry. (b) The three products: one side
    with 22 significant bits (hi + lo holds it exactly), the other +-1 with
    at most 4 nonzeros a row, so q.x and every partial sum are exact in
    f32: the kernel must equal the plain version, single-pass TF32 must
    not."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    rng = np.random.default_rng(7)
    for q, n, d in TF32_PROBE_SHAPES:
        r = torch.arange(n)
        x = torch.zeros((n, d))
        x[r, (7 * r + 3) % d] = (r + 1).to(torch.float32)
        i = torch.arange(q)
        qs = torch.zeros((q, d))
        qs[i, i % d] = (1 + i // d).to(torch.float32)
        qs, x = qs.to(dev), x.to(dev)
        zeros = torch.zeros(n, device=dev)
        m8 = (torch.arange(n, device=dev) % 5 != 1).to(torch.uint8)
        same = (torch.equal(distance.scores(qs, x, None, metric=Metric.IP),
                            distance.scores_plain(qs, x, None, Metric.IP))
                and torch.equal(tilescan.tile_maxes(qs, x, zeros, m8, metric=Metric.IP),
                                tilescan.tile_maxes_plain(qs, x, zeros, m8, Metric.IP)))
        g = distance.f32_scan_geometry(q, n, d)
        log(f"  tf32     one-hot layout Q={q} N={n} D={d} (NT {g.nt}, "
            f"{'resident' if g.resident else 'ringed'} query): score and tile_max "
            f"{'equal' if same else 'DIFFER from'} their plain versions bit for bit")
        check(same, f"the f32 engine misplaces a fragment: Q={q} N={n} D={d}")
        for side in ("payload", "query"):
            dense = (rng.integers(2**21, 2**22, (n if side == "payload" else q, d))
                     * rng.choice([-1, 1], (n if side == "payload" else q, d)) * 2.0**-20)
            sparse = np.zeros((q if side == "payload" else n, d), np.float32)
            for row in sparse:
                row[rng.choice(d, min(4, d), replace=False)] = rng.choice([-1.0, 1.0], min(4, d))
            qn, xn = (sparse, dense) if side == "payload" else (dense, sparse)
            qs = torch.from_numpy(qn.astype(np.float32)).to(dev)
            x = torch.from_numpy(xn.astype(np.float32)).to(dev)
            got = distance.scores(qs, x, None, metric=Metric.IP)
            want = distance.scores_plain(qs, x, None, Metric.IP)
            single = distance.tf32_products(qs, x, None, Metric.IP, distance.TF32_SINGLE)
            n_diff = int((got != want).sum())
            n_single = int((single != want).sum())
            log(f"  tf32     22-bit {side}, Q={q} N={n} D={d}: {n_diff} of {want.numel()} "
                f"scores differ from the f32 plain version; single-pass TF32 {n_single}")
            check(n_diff == 0, f"the f32 engine's three products are not exact: {side} Q={q}")
            check(n_single > want.numel() // 2, "single-pass TF32 should differ on most scores")


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
    return t, batches, flt, queries, gt, db


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
    return t, batches, gt, db


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


def hnsw_path(ms, dev, t, batches, gt, card, out_dir):
    """Build HNSWFLAT on phase 4's table and search it through the table's
    entry points; one profiled pass at ef_s 100 counts the kernels a graph
    batch launches (its trace goes to `out_dir`). Returns (graph settings,
    the batches searched, the index, ef_s -> (recall_ids, recall_dist,
    QPS))."""
    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.index import hnsw
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import gathermv
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    t0 = time.perf_counter()
    t.add_vector_index("h", "vec", type="HNSWFLAT", metric_type="Cosine", **HNSW_PARAMS)
    check(t.wait_index_built(), "the HNSWFLAT build did not end")
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
    # what the per-iteration dedup of the neighbours costs: kernels a batch
    dev_ms, _, n_kernels = device_trace(
        lambda qb: t.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph), hb,
        os.path.join(out_dir, "trace_hnsw_kernels.json"))
    log(f"  graph ef_s=100: {n_kernels / len(hb):.1f} kernels / search (batch {GIST_BATCH}), "
        f"device {dev_ms / len(hb):.4f} ms / search, recall_ids@{K} {curve[100][0]:.4f} "
        f"(limit {HNSW_MIN_RECALL})  [{card}]")

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


def trace_events(search, batches, trace_path):
    """One pass of `search` over `batches` under torch.profiler: the chrome
    trace's events (the trace goes to `trace_path`) and its kernel, memcpy
    and memset events, which must not be empty."""
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
    return events, dev


def device_trace(search, batches, trace_path):
    """One profiled pass (`trace_events`): (device ms of the pass, device
    ms by name, kernels launched)."""
    _, dev = trace_events(search, batches, trace_path)
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
    go to `out_dir`. A cell may give its queries per batch as a fourth
    element (else each batch's len() counts them)."""
    import cProfile
    import pstats
    import statistics

    import torch

    os.makedirs(out_dir, exist_ok=True)
    for label, search, batches, *per_batch in cells:
        def one_pass():
            t0 = time.perf_counter()
            for qb in batches:
                search(qb)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        nb = len(batches)
        nq = per_batch[0] * nb if per_batch else sum(len(qb) for qb in batches)
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
    out.update(time_f32_engine(dev, gen, card))
    return out


def rescore_path(dev, card):
    """The rescore kernel (`tilescan.tile_rescore`) at the exact cells'
    shapes over a clustered bf16 payload, on the sub-tiles the tile_max
    kernel chooses for queries near rows: against its plain version within
    `rescore_error_bound` (bf16 payload) and on the f32 copy of the
    payload, with a control that rounds the query to bf16 and must fall
    outside it, masked rows -inf; then its time (20 launches after 3
    warm-up), the plain version's and the bound of its work (the chosen
    rows, their aux and mask bytes, the queries and sub-tile ids read
    once, the scores written once). Returns the record fields of the
    last shape."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    gen = torch.Generator(device=dev).manual_seed(7)
    rec, err = {}, 0.0
    for qn, sn, d, mname in RESCORE_SHAPES:
        metric = Metric(mname)
        # make_corpus's clusters, drawn on the card
        centres = 6.0 * torch.randn((1000, d), generator=gen, device=dev)
        pick = torch.randint(0, 1000, (RESCORE_N,), generator=gen, device=dev)
        x32 = centres[pick] + torch.randn((RESCORE_N, d), generator=gen, device=dev)
        rows = torch.randint(0, RESCORE_N, (qn,), generator=gen, device=dev)
        q = (x32[rows] + 0.3 * torch.randn((qn, d), generator=gen, device=dev)).contiguous()
        del centres, pick
        m8 = (torch.arange(RESCORE_N, device=dev) % 97 != 5).to(torch.uint8)
        shape = f"Q={qn} S={sn} D={d} N={RESCORE_N} {mname}"
        for x in (x32.to(torch.bfloat16), x32):
            aux = distance.base_aux(x, metric)
            sub = torch.topk(tilescan.tile_maxes(q, x, aux, m8, metric=metric), sn, dim=1).indices
            got = tilescan.tile_rescore(q, x, aux, m8, sub, metric=metric)
            want = tilescan.tile_rescore_plain(q, x, aux, m8, sub, metric)
            tol = tilescan.rescore_error_bound(q, x, aux, sub, metric)
            kept = m8.reshape(-1, tilescan.SUB)[sub].reshape(qn, -1) != 0
            check(torch.equal(torch.isneginf(got), ~kept),
                  f"tile_rescore masks other rows than its mask: {shape}")
            diff = (got - want).abs()[kept]
            ratio = float((diff / (tol + distance.KERNEL_RTOL * want.abs())[kept]).max())
            control = tilescan.tile_rescore_plain(
                q.to(torch.bfloat16).to(torch.float32), x, aux, m8, sub, metric)
            n_out = int(distance.outside_kernel_bound(control[kept], want[kept], tol[kept]).sum())
            what = f"{shape} {str(x.dtype)[6:]}"
            err = max(err, float(diff.max()))
            log(f"  tile_rescore {what}: max_abs_err={float(diff.max()):.6g} (worst err/bound "
                f"{ratio:.3g}); bf16-query control {n_out} of {int(kept.sum())} outside")
            check(ratio <= 1.0, f"tile_rescore disagrees with its plain version: {what}")
            check(n_out > 0, f"the bound does not catch a bf16-query rescore: {what}")
            del got, want, tol, control, diff
            if x.dtype != torch.bfloat16:
                continue
            call = lambda: tilescan.tile_rescore(q, x, aux, m8, sub, metric=metric)  # noqa: E731
            rec = dict(
                ms=cuda_time_ms(call),
                plain_ms=cuda_time_ms(
                    lambda: tilescan.tile_rescore_plain(q, x, aux, m8, sub, metric)),
                library_ms=None,  # no one PyTorch call gathers sub-tiles and dots them
                shape=f"{shape} bf16",
            )
            rows_read = qn * sn * tilescan.SUB
            rec["bound_ms"], rec["bound_by"] = bound(
                rows_read * (2 * d + 4 + 1) + 4 * qn * d + 8 * qn * sn + 4 * rows_read,
                2 * rows_read * d, "f32")
            log(f"  tile_rescore {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
                f"{rec['plain_ms']:.4f} ms, library n/a, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}; {100 * rec['bound_ms'] / rec['ms']:.1f}% of it)  [{card}]")
        del x32, x, aux, sub, q, m8
        torch.cuda.empty_cache()
    rec["max_abs_err"] = err
    return rec


def window_scan_path(dev, card):
    """The IVF window scan kernel (`windowscan.window_scan`) at the IVF
    cells' shapes (WINDOW_SHAPES): a cluster-major payload of balanced
    lists (sizes 0.5-1.5x the mean), each query probing nprobe distinct
    random lists, its window budget from `ivf.windows_for_probes` as the
    index makes it. Against its plain version (the library passes it
    replaced) within `scan_error_bound`, -inf where the plain version is;
    then its time (20 launches after 3 warm-up), the plain version's and
    the bound of its work: the live windows' bytes read once a (query,
    window) pair, the aux of their rows under L2, the queries, window ids
    and flags, the scores written once. Returns the record fields of the
    last shape."""
    import torch

    from myscaledb_tpu_torch.index import ivf
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, quantize, windowscan

    gen = torch.Generator(device=dev).manual_seed(11)
    rec, err = {}, 0.0
    for cell, qn, d, payload, mname, rows, lists, nprobe in WINDOW_SHAPES:
        metric = Metric(mname)
        npad = -(-rows // windowscan.WINDOW) * windowscan.WINDOW
        n_windows = npad // windowscan.WINDOW
        w = torch.rand(lists, generator=gen, device=dev) + 0.5
        sizes = torch.floor(w / w.sum() * rows).to(torch.int64)
        sizes[-1] += rows - int(sizes.sum())
        starts = torch.zeros(lists + 1, dtype=torch.int64, device=dev)
        starts[1:] = torch.cumsum(sizes, 0)
        wpp = -(-rows // lists // windowscan.WINDOW) + 1
        w_budget = min(n_windows + nprobe, nprobe * wpp + 4)
        probe = torch.rand((qn, lists), generator=gen, device=dev).argsort(dim=1)[:, :nprobe]
        widx, valid = ivf.windows_for_probes(starts.to(torch.int32), probe, n_windows, w_budget)
        live = int(valid.sum())
        x = torch.randn((npad, d), generator=gen, device=dev)
        x[rows:] = 0.0
        q = distance.normalize_queries(torch.randn((qn, d), generator=gen, device=dev), metric)
        lo = scale = None
        if payload == "sq8":
            lo, scale = quantize.sq8_train_dev(x[:rows])
            data = quantize.sq8_encode_dev(x, lo, scale)
        else:
            data = x.to(torch.bfloat16)
        del x
        dec_sq = torch.zeros(npad, device=dev)
        if metric == Metric.L2:
            dec_sq = torch.sum(data.to(torch.float32) ** 2, dim=1)
            dec_sq[rows:] = float("inf")
        shape = (f"{cell}: Q={qn} W={w_budget} D={d} {payload} {mname} ({live / qn:.2f} live "
                 f"windows a query)")
        got = windowscan.window_scan(q, data, dec_sq, widx, valid, metric=metric, lo=lo,
                                     scale=scale)
        ratio = 0.0
        for i in range(0, qn, 50):
            sl = slice(i, i + 50)
            want = windowscan.window_scan_plain(q[sl], data, dec_sq, widx[sl], valid[sl],
                                                metric=metric, lo=lo, scale=scale)
            tol = windowscan.scan_error_bound(q[sl], data, widx[sl], metric, lo, scale)
            check(torch.equal(torch.isneginf(got[sl]), torch.isneginf(want)),
                  f"window_scan reads -inf elsewhere than its plain version: {shape}")
            ok = torch.isfinite(want)
            diff = (got[sl] - want).abs()[ok]
            ratio = max(ratio, float((diff / (tol + distance.KERNEL_RTOL * want.abs())[ok]).max()))
            err = max(err, float(diff.max()))
            del want, tol, diff
        log(f"  window_scan {shape}: worst err/bound {ratio:.3g}")
        check(ratio <= 1.0, f"window_scan disagrees with its plain version: {shape}")
        call = lambda: windowscan.window_scan(  # noqa: E731
            q, data, dec_sq, widx, valid, metric=metric, lo=lo, scale=scale)
        rec = dict(
            ms=cuda_time_ms(call),
            plain_ms=cuda_time_ms(lambda: windowscan.window_scan_plain(
                q, data, dec_sq, widx, valid, metric=metric, lo=lo, scale=scale)),
            library_ms=None,  # no one PyTorch call gathers windows, decodes and dots
            shape=shape,
        )
        live_rows = live * windowscan.WINDOW
        aux_bytes = 4 * live_rows if metric == Metric.L2 else 0
        nbytes = (live_rows * d * data.element_size() + aux_bytes + 4 * qn * d
                  + 9 * qn * w_budget + 4 * qn * w_budget * windowscan.WINDOW)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * live_rows * d, "f32")
        log(f"  window_scan {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, library n/a, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}: {nbytes / 1e6:.1f} MB; {100 * rec['bound_ms'] / rec['ms']:.1f}% "
            f"of it)  [{card}]")
        del data, dec_sq, q, got, widx, valid
        torch.cuda.empty_cache()
    rec["max_abs_err"] = err
    return rec


def row_rescore_path(dev, card):
    """The two-stage IVF re-rank kernel (`rowrescore.row_rescore`) at
    RERANK_SHAPES over a bf16 payload of the table's size, each query's
    candidates random rows, every one live (as a filtered search hands
    them) and then with about one in eight -1 (the rows a global cut
    drops), for the comparison: against its plain version within
    `rerank_error_bound`, -inf exactly at the -1 ids, with a control that
    rounds the query to bf16 and must fall outside; then, with every id
    live as the search hands them, its time (20 launches after 3 warm-up),
    the plain version's, each of the four library passes it replaced
    (gather, f32 copy, `bmm`, norms) and the bound of its work: the
    candidate rows read once, their aux under L2, the queries and ids, the
    scores written once. Returns the record fields of the last shape."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, rowrescore

    gen = torch.Generator(device=dev).manual_seed(13)
    rec, err = {}, 0.0
    for cell, qn, c, d, mname, rows in RERANK_SHAPES:
        metric = Metric(mname)
        data = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
        aux = distance.base_aux(data, metric)
        q = distance.normalize_queries(torch.randn((qn, d), generator=gen, device=dev), metric)
        ids = torch.randint(0, rows, (qn, c), generator=gen, device=dev, dtype=torch.int32)
        cut = ids.masked_fill(torch.rand((qn, c), generator=gen, device=dev) < 0.125, -1)
        shape = f"{cell}: Q={qn} C={c} D={d} bf16 {mname} (N {rows:,})"
        for which, cand in (("every id live", ids), ("1 in 8 cut", cut)):
            got = rowrescore.row_rescore(q, data, aux, cand, metric=metric)
            want = rowrescore.row_rescore_plain(q, data, aux, cand, metric)
            tol = rowrescore.rerank_error_bound(q, data, cand, metric)
            live = cand >= 0
            check(torch.equal(torch.isneginf(got), ~live),
                  f"row_rescore reads -inf elsewhere than at the -1 ids: {shape}, {which}")
            diff = (got - want).abs()[live]
            ratio = float((diff / (tol + distance.KERNEL_RTOL * want.abs())[live]).max())
            control = rowrescore.row_rescore_plain(q.to(torch.bfloat16).to(torch.float32), data,
                                                   aux, cand, metric)
            n_out = int(distance.outside_kernel_bound(control[live], want[live], tol[live]).sum())
            err = max(err, float(diff.max()))
            log(f"  row_rescore {shape}, {which}: max_abs_err={float(diff.max()):.6g} (worst "
                f"err/bound {ratio:.3g}); bf16-query control {n_out} of {int(live.sum())} outside")
            check(ratio <= 1.0, f"row_rescore disagrees with its plain version: {shape}, {which}")
            check(n_out > 0, f"the bound does not catch a bf16-query re-rank: {shape}, {which}")
            del got, want, tol, control, diff
        del cut
        call = lambda: rowrescore.row_rescore(q, data, aux, ids, metric=metric)  # noqa: E731
        rec = dict(
            ms=cuda_time_ms(call),
            plain_ms=cuda_time_ms(lambda: rowrescore.row_rescore_plain(q, data, aux, ids, metric)),
            library_ms=None,  # no one PyTorch call gathers rows by id and dots them
            shape=shape,
        )
        # the library passes the kernel replaced, one at a time
        ids64 = ids.to(torch.int64)
        g = data[ids64]
        g32 = g.to(torch.float32)
        passes = {"gather": cuda_time_ms(lambda: data[ids64]),
                  "f32 copy": cuda_time_ms(lambda: g.to(torch.float32)),
                  "bmm": cuda_time_ms(lambda: torch.bmm(g32, q[:, :, None]))}
        if metric == Metric.COSINE:
            passes["norms"] = cuda_time_ms(lambda: torch.linalg.vector_norm(g32, dim=-1))
        del g, g32, ids64
        n_rows = qn * c
        aux_bytes = 4 * n_rows if metric == Metric.L2 else 0
        nbytes = n_rows * d * data.element_size() + aux_bytes + 4 * qn * d + 8 * qn * c
        flops = 2 * n_rows * d * (2 if metric == Metric.COSINE else 1)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, "f32")
        log(f"  row_rescore {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms (" + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
            + f"), library n/a, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB; {100 * rec['bound_ms'] / rec['ms']:.1f}% of it)  [{card}]")
        del data, aux, q, ids
        torch.cuda.empty_cache()
    rec["max_abs_err"] = err
    return rec


def time_f32_engine(dev, gen, card):
    """The f32 (3xTF32) engine of score and tile_max at F32_TIME_SHAPES,
    each beside its plain version, `torch.matmul` f32 (score), the
    CUDA-core FMA bound (what the engine it replaced ran on) and the
    tensor-core bound of its three TF32 products. The record lines
    score_f32 and tile_max_f32 take the first shape (one stream chunk)."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    out = {}
    for qn, n, d, mname in F32_TIME_SHAPES:
        metric = Metric(mname)
        x = 3.0 * torch.randn((n, d), generator=gen, device=dev)
        q = distance.normalize_queries(torch.randn((qn, d), generator=gen, device=dev), metric)
        aux = distance.base_aux(x, metric)
        m8 = (torch.rand((n,), generator=gen, device=dev) < 0.99).to(torch.uint8)
        g = distance.f32_scan_geometry(qn, n, d)
        shape = f"Q={qn} N={n} D={d} f32 {mname} (NT {g.nt}, {g.stages} stages, " \
                f"{'resident' if g.resident else 'ringed'} query)"
        flops = 2 * qn * n * d  # one f32 product
        fma_ms = bound(0, flops, "f32")[0]
        for name in ("score_f32", "tile_max_f32"):
            if name == "score_f32":
                call = lambda: distance.scores(q, x, aux, metric=metric)  # noqa: E731
                rec = dict(ms=cuda_time_ms(call),
                           plain_ms=cuda_time_ms(lambda: distance.scores_plain(q, x, aux, metric)),
                           library_ms=cuda_time_ms(lambda: torch.matmul(q, x.T)))
                nbytes = 4 * n * d + 4 * n + 4 * qn * d + 4 * qn * n
            else:
                a = aux if aux is not None else torch.zeros((n,), device=dev)
                call = lambda: tilescan.tile_maxes(q, x, a, m8, metric=metric)  # noqa: E731
                rec = dict(ms=cuda_time_ms(call),
                           plain_ms=cuda_time_ms(lambda: tilescan.tile_maxes_plain(
                               q, x, a, m8, metric)),
                           library_ms=None)  # no one PyTorch call takes masked sub-tile maxima
                nbytes = 4 * n * d + 5 * n + 4 * qn * d + 4 * qn * (n // tilescan.SUB)
            # the least time for the same work: the bytes, or the three TF32
            # products at the tensor cores' TF32 peak
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * flops, "tf32")
            lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
            log(f"  {name:12s} {shape}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
                f"ms, library (torch.matmul f32) {lib}; bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}; bytes {1e3 * nbytes / PEAK_BYTES_PER_S:.4f}, 3xTF32 "
                f"{bound(0, 3 * flops, 'tf32')[0]:.4f}, f32 FMA {fma_ms:.4f}): "
                f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it  [{card}]")
            if name == "score_f32" and rec["ms"] > rec["library_ms"]:
                log(f"  NOTE: the f32 score engine is slower than torch.matmul f32 at {shape}")
            rec["shape"] = shape
            out.setdefault(name, rec)
        del x, q, aux, m8
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
def check_hits_exact(table, queries, results, label, metric="L2"):
    """Every hit is a live row whose score is the exact f32 score of its
    stored row (L2: 2 q.x - |x|^2 over the widened bf16 values, Cosine:
    the normalised query's q.x times 1 / |x|, IP: q.x; `scores_ref`'s
    formula on that row alone), within F32_TOL."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance

    metric = Metric(metric)

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
        qq = distance.normalize_queries(
            torch.nn.functional.pad(q[qi], (0, x.shape[1] - q.shape[1])), metric)
        dot = (qq * x).sum(-1)
        if metric == Metric.L2:
            dot = 2.0 * dot - p.aux_for(metric)[r]
        elif metric == Metric.COSINE:
            dot = dot * p.aux_for(metric)[r]
        want[sel] = dot.cpu().numpy()
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
    through the index's layout of the passing rows and one that falls back
    to the exact scan (tile_max); then IVFSQ, IVFPQ and a default MSTG one
    at a time.
    Returns IVFFLAT's operating nprobe and the MSTG's hits there."""
    import torch

    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.index import ivf
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    names = ("VectorIndexSearches", "VectorBruteForceSearches", "VectorIndexFallbackToFlat",
             "IvfFilterLayoutBuilds", "IvfFilterLayoutHits")
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
        check(t.wait_index_built(), f"the {name} build did not end")
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
    check(b["IvfFilterLayoutBuilds"] == 1 and b["IvfFilterLayoutHits"] == nb - 1,
          f"id < {hi}: the passing rows' layout must be built once and then come from the "
          f"cache: {b}")
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in fres])
    check((ids < hi).all(), f"every filtered IVF hit must pass id < {hi}")
    check_hits_exact(t, queries, fres, f"IVFFLAT id < {hi}")
    fgt = exact_topk(t, "vec", queries, K, Metric.L2, lambda s: s.scalar("id")[: s.n_rows] < hi)
    log(f"  IVFFLAT nprobe={op}, id < {hi}: layout built once, {b['IvfFilterLayoutHits']} "
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
            mstg_op = hits(t, search_all({"nprobe": op})[0])  # phase 12f's reference
            res, b = search_all({"nprobe": op}, two_stage=True)
            check(b["VectorIndexSearches"] == 0 and b["VectorBruteForceSearches"] == nb,
                  f"two_stage_search=1: the MSTG segment takes the first-stage path: {b}")
            check_hits_exact(t, queries, res, "MSTG two-stage")
            log(f"  MSTG nprobe={op}, two_stage_search=1: recall_ids@{K} "
                f"{ivf_recall(res, gt, queries)[0]:.4f}")
        t.drop_vector_index(name)
    return op, mstg_op


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
    check(t.wait_index_built(), "the HNSWPQ build did not end")
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


# ---------------------------------------------------------------- phase 9
def text_corpus(n, seed=TEXT_SEED):
    """bench.py:586-590's documents: TEXT_WORDS words drawn uniformly from
    term0..term4999 with `seed`, drawn in one call. Returns (docs, rng)."""
    rng = np.random.default_rng(seed)
    words = np.array([f"term{i}" for i in range(TEXT_VOCAB)], dtype=object)
    picks = words[rng.integers(0, TEXT_VOCAB, (n, TEXT_WORDS))]
    return np.array([" ".join(r) for r in picks], dtype=object), rng


class Bm25Oracle:
    """A numpy f64 BM25 built from the documents themselves, independent of
    the port's analyzer, stores and statistics: each document split on
    whitespace (the corpus is lower-case `termN` words, which the analyzer
    keeps whole), and the term frequencies, document frequencies, lengths
    and average length counted here over every indexed document (a store's
    statistics cover its deleted rows too: it is immutable once built).
    Rows are the documents' indices, which are the table's `id` values."""

    def __init__(self, docs, step=100_000):
        index, parts = {}, []
        lens = np.empty(len(docs), np.int64)
        for s in range(0, len(docs), step):
            toks = [d.split() for d in docs[s : s + step]]
            lens[s : s + len(toks)] = [len(x) for x in toks]
            parts.append(np.fromiter((index.setdefault(w, len(index)) for x in toks for w in x),
                                     np.int64, int(lens[s : s + len(toks)].sum())))
        n = len(docs)
        pairs, tf = np.unique(np.concatenate(parts) * n + np.repeat(np.arange(n), lens),
                              return_counts=True)
        self.index, self.n = index, n
        self.rows = pairs % n  # ascending within each term
        self.tf = tf.astype(np.float64)
        self.offsets = np.searchsorted(pairs // n, np.arange(len(index) + 1))
        self.dl = lens.astype(np.float64)
        self.avg_len = float(lens.sum()) / n

    def term(self, term):
        """(rows, f64 contributions) of one term's postings (rows ascend)."""
        t = self.index.get(term)
        if t is None:
            return np.zeros(0, np.int64), np.zeros(0)
        s, e = self.offsets[t], self.offsets[t + 1]
        r, tf = self.rows[s:e], self.tf[s:e]
        df = float(e - s)
        idf = np.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
        return r, idf * tf * 2.2 / (tf + 1.2 * (0.25 + 0.75 * self.dl[r] / self.avg_len))

    def full(self, terms):
        """(f64 score, matched-term count) of every document."""
        score = np.zeros(self.n)
        count = np.zeros(self.n, np.int32)
        for tm in terms:
            r, c = self.term(tm)
            score[r] += c
            count[r] += 1
        return score, count

    def at(self, terms, rows):
        """(f64 score, matched-term count) of the given documents."""
        score = np.zeros(len(rows))
        count = np.zeros(len(rows), np.int32)
        for tm in terms:
            r, c = self.term(tm)
            pos = np.minimum(np.searchsorted(r, rows), max(len(r) - 1, 0))
            hit = (r[pos] == rows) if len(r) else np.zeros(len(rows), bool)
            score[hit] += c[pos[hit]]
            count[hit] += 1
        return score, count

    def prefix_total(self, terms, member):
        """The sparse path's largest prefix sum in one segment (`member`:
        bool over documents): the total of the query's candidate
        contributions there."""
        return float(sum(c[member[r]].sum() for r, c in map(self.term, terms)))


def check_text(label, t, oracle, results, query_batches, *, operator="OR", row_ok=None, full=1):
    """Every hit of `results` (one SearchResult per batch of
    `query_batches`) is a live, qualifying document whose f32 score lies
    within its bound of `oracle`'s f64 BM25: DENSE_RTOL of the score,
    plus, where a segment's batch took the sparse path, the sparse bound
    of the query's prefix total there. For the first `full` batches, no
    qualifying document left out outscores the k-th hit by more than that
    bound, and a query with fewer than k hits has no other qualifying
    document. `row_ok` takes document indices. Returns the largest
    |score - f64| / bound seen."""
    import torch

    from myscaledb_tpu_torch.text import inverted

    tdef = t._text_indexes["ft"]
    segs = t.live_segments()
    stats = tdef.merged_stats([s.segment_id for s in segs])
    doc = {s.segment_id: s.scalar("id")[: s.n_rows].astype(np.int64) for s in segs}
    alive = np.zeros(oracle.n, bool)
    member = {}
    for s in segs:
        alive[doc[s.segment_id]] = ~s.deleted_host()[: s.n_rows]
        member[s.segment_id] = np.zeros(oracle.n, bool)
        member[s.segment_id][doc[s.segment_id]] = True
    if row_ok is not None:
        alive &= row_ok(np.arange(oracle.n))
    worst = 0.0
    for b, (qs, res) in enumerate(zip(query_batches, results)):
        routes = {s.segment_id: tdef.store(s.segment_id).plan_batch(qs, stats=stats)[3]
                  for s in segs}
        for i, q in enumerate(qs):
            terms = list(dict.fromkeys(q.split()))
            need = max(len(terms), 1) if operator == "AND" else 1
            extra = 0.0
            for sid, route in routes.items():
                if route == "sparse":
                    pm = torch.tensor([np.float32(oracle.prefix_total(terms, member[sid]))])
                    extra = max(extra, float(inverted.sparse_error_bound(pm)[0]))
            valid = res.valid[i]
            got = res.scores[i][valid]
            hit = np.full(len(got), -1, np.int64)
            for sid in doc:
                on = res.segments[i][valid] == sid
                hit[on] = doc[sid][res.rows[i][valid][on]]
            check((hit >= 0).all(), f"{label}: query {i} of batch {b} returned a row of no live "
                  "segment")
            sc, cnt = oracle.at(terms, hit)
            want = np.where((cnt >= need) & (sc > 0) & alive[hit], sc, -np.inf)
            check(np.isfinite(want).all(), f"{label}: query {i} of batch {b} returned a row that "
                  "does not qualify (deleted, filtered or not matching)")
            bnd = inverted.DENSE_RTOL * np.abs(want) + extra
            if len(got):
                err = np.abs(got - want)
                worst = max(worst, float((err / bnd).max()))
                check((err <= bnd).all(), f"{label}: query {i} of batch {b}: a score lies "
                      f"{float(err.max()):.6g} from its f64 BM25 (bound {float(bnd.max()):.6g})")
            if b >= full:
                continue
            sc, cnt = oracle.full(terms)
            ok = (cnt >= need) & (sc > 0) & alive
            ok[hit] = False
            left = sc[ok]
            if valid.sum() < res.k:
                check(len(left) == 0, f"{label}: query {i} left out {len(left)} qualifying rows")
            elif len(left):
                kth = float(got[-1])
                check(left.max() <= kth + inverted.DENSE_RTOL * abs(kth) + extra,
                      f"{label}: query {i}: a row left out scores {left.max():.6g} above the "
                      f"k-th hit's {kth:.6g}")
    return worst


def best_and_median_qps(search, batches, nq_per_batch, rounds=3):
    """(best, median) QPS over `rounds` timed passes after a warm-up pass,
    each pass ending in torch.cuda.synchronize()."""
    import statistics

    import torch

    for qb in batches:
        search(qb)
    torch.cuda.synchronize()
    walls = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for qb in batches:
            search(qb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / len(batches))
    return nq_per_batch / min(walls), nq_per_batch / statistics.median(walls)


def numpy_fuse(vres, tres, k, fusion_type, fusion_k=HYBRID_FUSION_K, weight=HYBRID_WEIGHT):
    """RRF / RSF of the two legs' results in numpy f32, as the reference
    defines them: first occurrence keeps the key's place (vector leg
    first), ties keep that order. Returns (scores, segments, rows)."""
    nq = vres.nq
    out_v = np.full((nq, k), -np.inf, np.float32)
    out_s = np.full((nq, k), -1, np.int64)
    out_r = np.full((nq, k), -1, np.int64)
    f32 = np.float32
    for i in range(nq):
        fused = {}
        for leg, res, w in ((0, vres, f32(1.0) - f32(weight)), (1, tres, f32(weight))):
            ok = res.valid[i]
            keys = list(zip(res.segments[i][ok].tolist(), res.rows[i][ok].tolist()))
            if fusion_type == "rrf":
                contrib = [f32(1.0) / (f32(fusion_k) + f32(rank)) for rank in range(1, len(keys) + 1)]
            else:
                s = res.scores[i][ok].astype(np.float32)
                lo, hi = (s.min(), s.max()) if len(s) else (f32(0), f32(0))
                span = f32(hi - lo)
                norm = (s - lo) / (span if span > 0 else f32(1.0))
                norm = norm if span > 1e-12 else np.ones_like(s)
                contrib = list(norm.astype(np.float32) * w)
            for key, c in zip(keys, contrib):
                fused[key] = f32(fused.get(key, f32(0.0)) + f32(c))
        ordered = sorted(fused.items(), key=lambda kv: -kv[1])[:k]  # stable: first place wins ties
        for j, ((sg, r), v) in enumerate(ordered):
            out_v[i, j], out_s[i, j], out_r[i, j] = v, sg, r
    return out_v, out_s, out_r


def text_table(ms, dev, card, db):
    """Phase 9's table: "hybrid" in `db`, 1,000,000 + 50,000 rows with
    `body String` (bench.py's 12-word documents) and `vec
    FloatVector(128)` (phase 3's corpus), its fts index "ft", and the
    query batches (3-word `tb`, 8-word `lb`, 2-word `pb`, vectors `vb`).
    Returns (table, docs, the rng after the queries, tb, lb, pb, vb)."""
    n_all = SIFT_N + SIFT_SMALL_N
    t0 = time.perf_counter()
    docs, rng = text_corpus(n_all)
    vecs = np.concatenate([make_corpus(SIFT_N, SIFT_D, seed=0),
                           make_corpus(SIFT_SMALL_N, SIFT_D, seed=1, centers=corpus_centers(SIFT_D))])
    ids = np.arange(n_all, dtype=np.uint64)
    t = db.create_table("hybrid", ms.Schema({"id": ms.UInt64(), "body": ms.String(),
                                              "vec": ms.FloatVector(SIFT_D)}))
    t1 = time.perf_counter()
    for p in (slice(0, SIFT_N), slice(SIFT_N, n_all)):
        t.insert({"id": ids[p], "body": docs[p], "vec": vecs[p]})
    sync(dev)
    t2 = time.perf_counter()
    t.add_fts_index("ft", "body")
    sync(dev)
    t3 = time.perf_counter()
    tdef = t._text_indexes["ft"]
    stores = [tdef.store(s.segment_id) for s in t.live_segments()]
    log(f"  documents and vectors made in {t1 - t0:.2f} s, insert {t2 - t1:.2f} s; fts build "
        f"{t3 - t2:.2f} s by the {stores[0].builder} builder ({[s.builder for s in stores]}; "
        f"postings {[int(s.postings_rows.numel()) for s in stores]}, vocabulary "
        f"{[len(s.vocab) for s in stores]})  [{card}]")
    check(all(s.builder == "native" for s in stores) or all(s.builder == "python" for s in stores),
          "the stores were built by different builders")
    words = [f"term{i}" for i in range(TEXT_VOCAB)]
    picks = rng.integers(0, TEXT_VOCAB, (TEXT_NQ, TEXT_LONG_WORDS))
    texts = [" ".join(words[j] for j in r[:3]) for r in picks]
    longs = [" ".join(words[j] for j in r) for r in picks]
    pairs = [" ".join(words[j] for j in r[:2]) for r in picks]
    vq = (vecs[rng.choice(n_all, TEXT_NQ, replace=False)]
          + 0.3 * rng.standard_normal((TEXT_NQ, SIFT_D))).astype(np.float32)
    tb = [texts[i : i + TEXT_BATCH] for i in range(0, TEXT_NQ, TEXT_BATCH)]
    lb = [longs[i : i + TEXT_BATCH] for i in range(0, TEXT_NQ, TEXT_BATCH)]
    pb = [pairs[i : i + TEXT_BATCH] for i in range(0, TEXT_NQ, TEXT_BATCH)]
    vb = [vq[i : i + TEXT_BATCH] for i in range(0, TEXT_NQ, TEXT_BATCH)]
    stats = tdef.merged_stats([s.segment_id for s in t.live_segments()])
    routes = [(s.plan_batch(tb[0], stats=stats)[3], s.plan_batch(lb[0], stats=stats)[3])
              for s in stores]
    log(f"  BM25 routes (3-word, 8-word queries) per segment: {routes}")
    check(routes[0] == ("sparse", "dense") and routes[1] == ("dense", "dense"),
          f"the 1M store must take the sparse path for 3-word queries only: {routes}")
    return t, docs, rng, tb, lb, pb, vb


def text_path(ms, dev, card, args, db):
    """Phase 9: full-text and hybrid search on phase 9's table
    (`text_table`) through add_fts_index, insert, text_search and
    hybrid_search. Returns the launch counts, the table (phase 14 searches
    it, then drops it), the vector and text query batches (3-word and
    8-word) and the f64 BM25 oracle."""
    import torch

    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.ops import distance, tilescan
    from myscaledb_tpu_torch.text import inverted

    n_all = SIFT_N + SIFT_SMALL_N
    t, docs, rng, tb, lb, pb, vb = text_table(ms, dev, card, db)
    tdef = t._text_indexes["ft"]
    segs = t.live_segments()
    stores = [tdef.store(s.segment_id) for s in segs]
    t0 = time.perf_counter()
    oracle = Bm25Oracle(docs)
    log(f"  f64 BM25 oracle from the {n_all:,} documents' whitespace tokens: "
        f"{len(oracle.index):,} terms, {oracle.rows.size:,} postings, average length "
        f"{oracle.avg_len:.4f} ({time.perf_counter() - t0:.2f} s)")
    stats = tdef.merged_stats([s.segment_id for s in segs])

    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    res = [t.text_search("body", qb, k=K) for qb in tb]
    sync(dev)
    w = check_text("text OR 3-word", t, oracle, res, tb, full=1)
    log(f"  text_search, {TEXT_NQ} 3-word queries (batch {TEXT_BATCH}): every hit within its "
        f"bound of the f64 BM25 (worst err/bound {w:.3g}); no row left out of batch 1 beats "
        f"the k-th beyond the bound")
    w = check_text("text OR 8-word", t, oracle, [t.text_search("body", lb[0], k=K)], lb[:1])
    log(f"  8-word queries (the dense path on both stores): worst err/bound {w:.3g}")
    ares = [t.text_search("body", qb, k=K, operator="AND") for qb in pb[:2]]
    w = check_text("text AND 2-word", t, oracle, ares, pb[:2], operator="AND", full=2)
    n_and = sum(int(r.valid.sum()) for r in [t.text_search("body", pb[0], k=K, operator="AND")])
    log(f"  AND over 2-word queries: worst err/bound {w:.3g}, {n_and} hits in batch 1")
    flt = F("id") < TEXT_FILTER
    fres = [t.text_search("body", qb, k=K, filter=flt) for qb in tb[:2]]
    ids_f = np.concatenate([t.gather(r, ["id"])["id"][r.valid] for r in fres])
    check((ids_f < TEXT_FILTER).all(), f"a filtered text hit fails id < {TEXT_FILTER}")
    w = check_text("text filtered", t, oracle, fres, tb[:2], full=2,
                   row_ok=lambda d: d < TEXT_FILTER)
    log(f"  filter id < {TEXT_FILTER}: all {ids_f.size} hits pass, worst err/bound {w:.3g}")
    # an NLQ phrase: two adjacent words of a document, plus a scored word
    doc_id = int(rng.integers(n_all))
    doc = docs[doc_id].split()
    phrase = f"{doc[4]} {doc[5]}"
    nres = t.text_search("body", f'"{phrase}" {doc[0]}', k=K, enable_nlq=True)
    got = t.gather(nres, ["id", "body"])
    hits = list(zip(got["id"][nres.valid].tolist(), got["body"][nres.valid].tolist()))
    check(any(i == doc_id for i, _ in hits) and all(f" {phrase} " in f" {b} " for _, b in hits),
          f"NLQ phrase {phrase!r}: hits {hits[:3]}")
    log(f"  NLQ '\"{phrase}\" {doc[0]}': {len(hits)} hits, each holding the phrase, the source "
        f"document among them")

    # the two BM25 paths on the 1M store, the same 100 three-word queries
    store0 = stores[0]
    sp = store0.bm25_topk_batch(tb[0], K, stats=stats, route="sparse")
    de = store0.bm25_topk_batch(tb[0], K, stats=stats, route="dense")
    sv, dv = sp[0].cpu().numpy(), de[0].cpu().numpy()
    fin = np.isfinite(dv)
    check((np.isfinite(sv) == fin).all(), "the two paths find different numbers of hits")
    diff = np.abs(np.sort(sv, 1) - np.sort(dv, 1))[np.sort(fin, 1)]
    bnd = sp[4].cpu().numpy()
    allowed = bnd[:, None] + 2 * inverted.DENSE_RTOL * np.abs(np.sort(dv, 1))
    check((np.abs(np.sort(sv, 1) - np.sort(dv, 1)) <= allowed)[np.sort(fin, 1)].all(),
          "the sparse path's scores lie outside their bound")
    times = {}
    for route in ("sparse", "dense"):
        dms, _, nk = device_trace(
            lambda qb: store0.bm25_topk_batch(qb, K, stats=stats, route=route), tb[:1],
            os.path.join(args.out, f"trace_bm25_{route}.json"))
        times[route] = (dms, nk)
    log(f"  BM25 on the 1M store, batch {TEXT_BATCH} 3-word queries: sparse {times['sparse'][0]:.4f} "
        f"ms device ({times['sparse'][1]} kernels), dense {times['dense'][0]:.4f} ms device "
        f"({times['dense'][1]} kernels); max |sparse - dense| of the sorted top-{K} "
        f"{float(diff.max()):.6g} (sparse bound {float(bnd.min()):.6g}-{float(bnd.max()):.6g}, "
        f"{inverted.SPARSE_ULPS} ulps of the prefix total)  [{card}]")

    # hybrid: each fused list against a numpy fuse of the port's own legs
    n_cand = K * t.settings.query.hybrid_search_top_k_multiple_base
    for ftype, kw in (("rrf", {"fusion_k": HYBRID_FUSION_K}), ("rsf", {"fusion_weight": HYBRID_WEIGHT})):
        for qv, qt in list(zip(vb, tb))[:3]:
            hres = t.hybrid_search("vec", "body", qv, qt, k=K, fusion_type=ftype, **kw)
            legs = (t.search("vec", qv, k=n_cand), t.text_search("body", qt, k=n_cand))
            nv, ns, nr = numpy_fuse(*legs, K, ftype)
            if ftype == "rrf":
                check(np.array_equal(hres.scores, nv) and np.array_equal(hres.segments, ns)
                      and np.array_equal(hres.rows, nr), "RRF differs from the numpy fuse of its legs")
            else:
                check(np.allclose(hres.scores, nv, rtol=0, atol=1e-6),
                      "RSF scores differ from the numpy fuse of its legs")
                nb = np.pad(nv, ((0, 0), (1, 1)), constant_values=np.nan)
                with np.errstate(invalid="ignore"):
                    apart = ~(np.abs(nv - nb[:, :-2]) <= 1e-6) & ~(np.abs(nv - nb[:, 2:]) <= 1e-6)
                apart &= np.isfinite(nv)
                check((hres.rows[apart] == nr[apart]).all() and
                      (hres.segments[apart] == ns[apart]).all(),
                      "RSF ids differ from the numpy fuse of its legs")
        log(f"  hybrid {ftype.upper()} ({kw}): 3 batches equal a numpy fuse of their own legs "
            f"(k {K}, {n_cand} candidates a leg)")
    launches = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
                "tile_rescore": tilescan.tile_rescore.launches}
    check(launches["score"] > 0 and launches["tile_max"] > 0 and launches["tile_rescore"] > 0,
          f"the hybrid vector leg did not launch score, tile_max and the rescore: {launches}")
    check_rescores(launches, "the hybrid vector leg")

    # deletes last: 100 of batch 1's hits, then batch 1 again
    first = sorted({int(i) for r in res[:1] for i in t.gather(r, ["id"])["id"][r.valid]})[:100]
    check(t.delete(F("id").isin(first)) == len(first), "delete removed another count of rows")
    dres = [t.text_search("body", tb[0], k=K)]
    left = set(t.gather(dres[0], ["id"])["id"][dres[0].valid].tolist())
    check(not left & set(first), "a deleted row came back from the text search")
    check_text("text after deletes", t, oracle, dres, tb[:1])
    hd = t.hybrid_search("vec", "body", vb[0], tb[0], k=K, fusion_type="rrf")
    check(not set(t.gather(hd, ["id"])["id"][hd.valid].tolist()) & set(first),
          "a deleted row came back from the hybrid search")
    log(f"  delete: {len(first)} of batch 1's hits deleted, none returned by text or hybrid search")

    def text(qb):
        return t.text_search("body", qb, k=K)

    pairs_h = list(zip(vb, tb))

    def hybrid(p):
        return t.hybrid_search("vec", "body", p[0], p[1], k=K, fusion_type="rrf")

    tq = best_and_median_qps(text, tb, TEXT_BATCH)
    hq = best_and_median_qps(hybrid, pairs_h, TEXT_BATCH)
    log(f"  text_search QPS (batch {TEXT_BATCH}, 3-word, k {K}): best {tq[0]:.1f}, median "
        f"{tq[1]:.1f}; hybrid RRF QPS: best {hq[0]:.1f}, median {hq[1]:.1f}  [{card}]")
    if args.profile:
        log(f"[9p] where the time goes on {card}")
        profile_cells([("text_bm25", text, tb), ("hybrid_rrf", hybrid, pairs_h, TEXT_BATCH)],
                      PROFILE_RUNS, args.out, card)
    launches = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
                "tile_rescore": tilescan.tile_rescore.launches}
    return launches, t, vb, tb, lb, oracle


# ---------------------------------------------------------------- phase 10
def binary_corpus(dev, n, dim, seed):
    """The sign bits of a clustered dim-d corpus (make_corpus's mixture
    around corpus_centers(dim, seed), drawn on the card), packed as
    numpy.packbits packs them: u8[n, dim / 8] on the card."""
    import torch

    centers = torch.from_numpy(corpus_centers(dim, seed)).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    weights = (2 ** torch.arange(7, -1, -1, device=dev)).to(torch.int32)
    out = torch.empty((n, dim // 8), dtype=torch.uint8, device=dev)
    for i in range(0, n, 100_000):
        m = min(100_000, n - i)
        x = centers[torch.randint(0, centers.shape[0], (m,), generator=g, device=dev)]
        x = x + torch.randn((m, dim), generator=g, device=dev)
        out[i : i + m] = ((x > 0).to(torch.int32).reshape(m, dim // 8, 8) * weights).sum(-1)
    return out


def popcount_u64(a):
    """Bit counts of a uint64 array (numpy >= 2 has bitwise_count)."""
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(a)
    lut = np.array([bin(i).count("1") for i in range(1 << 16)], np.uint8)
    return sum(lut[(a >> s) & 0xFFFF] for s in (0, 16, 32, 48))


def binary_oracle(x64, q64, metric):
    """numpy f32 scores of packed rows viewed as uint64 words against one
    query: -popcount(q ^ x), or |q & x| / |q | x| (1.0 when empty)."""
    if metric == "Hamming":
        return -popcount_u64(x64 ^ q64).sum(1, dtype=np.int64).astype(np.float32)
    inter = popcount_u64(x64 & q64).sum(1, dtype=np.int64).astype(np.float32)
    union = popcount_u64(x64 | q64).sum(1, dtype=np.int64).astype(np.float32)
    return np.where(union > 0, inter / np.maximum(union, np.float32(1.0)), np.float32(1.0))


def check_binary_hits(label, t, x64, queries, results, metric, oracle_queries=0, row_ok=None):
    """Every hit is a live (and filter-passing) row whose score is the
    numpy score of its packed row; for the first `oracle_queries` queries
    the top-k scores equal a full numpy scan's exactly."""
    seg = t.live_segments()[0]
    ok_rows = ~seg.deleted_host()[: seg.n_rows]
    if row_ok is not None:
        ok_rows &= row_ok(seg)
    q64 = queries.view(np.uint64)
    scores = np.concatenate([r.scores for r in results])
    rows = np.concatenate([r.rows for r in results])
    check((rows >= 0).all(), f"{label}: a query got fewer than {K} hits")
    check(ok_rows[rows].all(), f"{label}: a deleted or filtered-out row came back")
    for i in range(len(queries)):
        want = binary_oracle(x64[rows[i]], q64[i : i + 1], metric)
        check(np.array_equal(scores[i], want), f"{label}: query {i}'s hits differ from their "
              "recomputed scores")
    for i in range(oracle_queries):
        s = binary_oracle(x64, q64[i : i + 1], metric)
        top = np.sort(s[ok_rows])[::-1][:K]
        check(np.array_equal(scores[i], top), f"{label}: query {i}'s top-{K} scores differ from "
              "a full numpy scan's")


def popc_rate():
    """Population counts per second the card can retire: 16 per clock per
    SM (CUDA C++ Programming Guide, throughput of native arithmetic
    instructions, compute capability 9.0) on every SM at the maximum SM
    clock nvidia-smi reports."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLK_PER_SM * sms * mhz * 1e6, sms, mhz


def kernel_timeline(fn, reps, trace_path, part):
    """The kernels whose name holds `part` of `reps` calls of `fn`, in
    device order, from a torch.profiler chrome trace (written to
    `trace_path`) taken while the device first sleeps for SLEEP_CYCLES, so
    that the host's enqueue does not show between them: [(name, start us,
    duration us, args)]. The args hold what the profiler read of each
    launch (grid, block, registers per thread, blocks per SM, estimated
    achieved occupancy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ks = sorted((e for e in events if e.get("cat") == "kernel" and part in e["name"]),
                key=lambda e: e["ts"])
    check(ks, f"{trace_path}: the profiler saw no {part}* kernel")
    return [(e["name"], float(e["ts"]), float(e["dur"]), e.get("args", {})) for e in ks]


def exact_err(got, want):
    """max |got - want|, an entry where both are -inf counting 0 (inf
    where only one side is infinite)."""
    import torch

    d = torch.where(got == want, torch.zeros_like(got), (got - want).abs())
    return float(d.max()) if d.numel() else 0.0


def compare_binary(dev):
    """The binary kernel against its plain version, bit for bit: the rows
    layout at the exact scan's chunk shape and a ragged one, the blocks
    layout at a made-up shape and a ragged one (phase 10 holds it at
    BinaryMSTG's own); masks, rows past n_valid, empty slots and clamped
    block ids included. The blocks layout's Jaccard takes the slots' bit
    counts and is held to the two-popcount plain version. Returns the
    largest |kernel - plain| measured."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import binary

    g = torch.Generator(device=dev).manual_seed(9)

    def bits(shape):
        return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)

    n_cmp, err = 0, 0.0
    for metric in (Metric.HAMMING, Metric.JACCARD):
        for q, n, b in ((BIN_BATCH, 65_536, BIN_DIM // 8), (300, 4_099, 13)):
            qb, x = bits((q, b)), bits((n, b))
            x[:3] = 0
            mask = torch.rand(n, generator=g, device=dev) < 0.7
            got = binary.binary_scores(qb, x, metric, n_valid=n - 7, mask=mask)
            valid = (torch.arange(n, device=dev) < n - 7) & mask
            want = binary.binary_scores_plain(qb, x, metric, valid)
            check(torch.equal(got, want),
                  f"binary rows kernel differs from its plain version: Q={q} N={n} B={b} {metric}")
            err = max(err, exact_err(got, want))
            n_cmp += got.numel()
        for q, p, c, m, b in ((BIN_BATCH, 16, 64, 1_200, BIN_DIM // 8), (7, 3, 5, 257, 5)):
            qb, x = bits((q, b)), bits((c, m, b))
            rows = torch.randperm(c * m, generator=g, device=dev).to(torch.int32).reshape(c, m)
            rows[:, -(m // 9 + 1):] = -1
            blk = torch.randint(-1, c + 1, (q, p), generator=g, device=dev, dtype=torch.int32)
            mask = torch.rand(c * m, generator=g, device=dev) < 0.6
            got = binary.binary_block_scores(qb, x, blk, rows, metric, mask=mask,
                                             popcnt=binary.row_popcounts(x))
            want = binary.binary_block_scores_plain(qb, x, blk, rows, mask, metric)
            check(torch.equal(got, want), f"binary blocks kernel differs from its plain version: "
                  f"Q={q} P={p} C={c} M={m} B={b} {metric}")
            err = max(err, exact_err(got, want))
            n_cmp += got.numel()
    log(f"  binary   rows (Q={BIN_BATCH} N=65,536 B={BIN_DIM // 8}; Q=300 N=4,099 B=13) and blocks "
        f"(Q={BIN_BATCH} P=16 M=1,200; Q=7 P=3 M=257 B=5), Hamming and Jaccard: {n_cmp} scores "
        f"equal to the plain version's bit for bit (max |kernel - plain| {err:g})")
    sync(dev)
    return err


def compare_group(blk, c, label):
    """The grouping kernel against group_probes_plain under torch.equal:
    the pair order and the groups up to the count. Returns the largest
    |kernel - plain| over them (0)."""
    import torch

    from myscaledb_tpu_torch.ops import binary

    pairs, groups, count = binary.group_probes(blk, c)
    wp, wg, wc = binary.group_probes_plain(blk, c)
    n = int(wc[0])
    check(torch.equal(count, wc) and torch.equal(pairs, wp) and torch.equal(groups[:n], wg[:n]),
          f"binary grouping kernel differs from group_probes_plain ({label})")
    err = max(exact_err(pairs.float(), wp.float()), exact_err(groups[:n].float(), wg[:n].float()))
    log(f"  binary   grouping {label} (Q={blk.shape[0]} P={blk.shape[1]} C={c}): {blk.numel()} "
        f"pairs in {n} groups, equal to group_probes_plain")
    return err


def compare_blocks_skewed(dev):
    """The grouped blocks layout under skewed probes, bit for bit with its
    plain version: all queries on one bucket, every pair on its own
    bucket, C = 1, Q * P not a multiple of 16, P > C with repeats, each at
    B = 128 and a ragged B = 13, both metrics, with and without a mask
    (Jaccard from the slots' bit counts, held to the two-popcount plain
    version; Hamming with and without them, which it does not read); and
    the grouping kernel alone at 10^5 pairs over 65,536 buckets, spread and
    all on one. Returns the largest |kernel - plain|."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import binary

    g = torch.Generator(device=dev).manual_seed(11)

    def probes(case, q, p, c):
        if case == "one":
            return torch.full((q, p), c // 2, dtype=torch.int32, device=dev)
        if case == "distinct":
            return torch.randperm(c, generator=g, device=dev)[: q * p].reshape(q, p).to(torch.int32)
        return torch.randint(-2, c + 2, (q, p), generator=g, device=dev, dtype=torch.int32)

    err, n_cmp = 0.0, 0
    for case, q, p, c, m in SKEW_CASES:
        blk = probes(case, q, p, c)
        err = max(err, compare_group(blk, c, f"skew {case}"))
        for b in (BIN_DIM // 8, 13):
            qb = torch.randint(0, 256, (q, b), generator=g, device=dev, dtype=torch.uint8)
            x = torch.randint(0, 256, (c, m, b), generator=g, device=dev, dtype=torch.uint8)
            x[0, :2] = 0
            qb[0] = 0
            rows = torch.randperm(c * m, generator=g, device=dev).to(torch.int32).reshape(c, m)
            rows[:, -(m // 9 + 1):] = -1
            pc = binary.row_popcounts(x)
            for mask in (None, torch.rand(c * m, generator=g, device=dev) < 0.6):
                for metric in (Metric.HAMMING, Metric.JACCARD):
                    want = binary.binary_block_scores_plain(qb, x, blk, rows, mask, metric)
                    for popcnt in ((None, pc) if metric == Metric.HAMMING else (pc,)):
                        got = binary.binary_block_scores(qb, x, blk, rows, metric, mask=mask,
                                                         popcnt=popcnt)
                        check(torch.equal(got, want), f"binary blocks kernel differs from its plain "
                              f"version: skew {case} Q={q} P={p} C={c} M={m} B={b} {metric} mask "
                              f"{mask is not None} popcnt {popcnt is not None}")
                        err, n_cmp = max(err, exact_err(got, want)), n_cmp + got.numel()
    for case in ("uniform", "one"):
        err = max(err, compare_group(probes(case, 6_250, 16, 65_536), 65_536, f"skew {case}"))
    log(f"  binary   blocks under skewed probes ({', '.join(c[0] for c in SKEW_CASES)}; B = 128 and "
        f"13; both metrics, with and without mask; Hamming with and without bit counts): {n_cmp} "
        f"scores equal to the plain version's bit for bit (max |kernel - plain| {err:g})")
    sync(dev)
    return err


def binary_path(ms, dev, card, args):
    """Phase 10: BinaryVector(1024) search over 1,000,000 rows, exact
    (BinaryFLAT scan) and through BinaryMSTG with default params, Hamming
    and Jaccard, batch 100, k 10, with a filter and deletes. Returns
    (launches, timing records and largest |kernel - plain| at the path's
    shapes, each by kernel: binary (rows layout), binary_blocks (grouping
    and scoring) and binary_group)."""
    import statistics

    import torch

    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import binary
    from myscaledb_tpu_torch.ops.topk import topk_stable
    from myscaledb_tpu_torch.search.executor import segment_mask
    from myscaledb_tpu_torch.search.filters import as_mask_array

    t0 = time.perf_counter()
    packed_dev = binary_corpus(dev, BIN_N, BIN_DIM, seed=5)
    packed = packed_dev.cpu().numpy()
    del packed_dev
    rng = np.random.default_rng(6)
    flips = np.packbits(rng.random((BIN_NQ, BIN_DIM)) < 0.05, axis=1)
    queries = packed[rng.choice(BIN_N, BIN_NQ, replace=False)] ^ flips
    batches = [queries[i : i + BIN_BATCH] for i in range(0, BIN_NQ, BIN_BATCH)]
    t1 = time.perf_counter()
    db = ms.connect(device=dev)
    t = db.create_table("bin", ms.Schema({"id": ms.UInt64(), "bv": ms.BinaryVector(BIN_DIM)}))
    t.insert({"id": np.arange(BIN_N, dtype=np.uint64), "bv": packed})
    sync(dev)
    t2 = time.perf_counter()
    seg = t.live_segments()[0]
    log(f"  {BIN_N} x {BIN_DIM}-bit rows made in {t1 - t0:.2f} s, inserted in {t2 - t1:.2f} s "
        f"(payload {tuple(seg.vector('bv').data.shape)} u8 = "
        f"{seg.vector('bv').data.numel() / 1e6:.1f} MB on the card)")
    x64 = packed.view(np.uint64)
    binary.binary_scores.launches = 0
    binary.binary_block_scores.launches = 0
    binary.group_probes.launches = 0
    exact = {}
    for metric in ("Hamming", "Jaccard"):
        res = [t.search("bv", qb, k=K, metric=metric) for qb in batches]
        check_binary_hits(f"{metric} exact scan", t, x64, queries, res, metric, oracle_queries=20)
        exact[metric] = res
        rate = best_and_median_qps(lambda qb: t.search("bv", qb, k=K, metric=metric), batches,
                                   BIN_BATCH)
        log(f"  {metric} exact scan: every hit's score recomputed, the first 20 queries' top-{K} "
            f"equal a full numpy scan's; QPS best {rate[0]:.1f}, median {rate[1]:.1f} "
            f"(batch {BIN_BATCH})  [{card}]")
    if args.profile:
        log(f"[10p] where the time goes on {card}")
        profile_cells([("binary_exact", lambda qb: t.search("bv", qb, k=K), batches[:4])],
                      PROFILE_RUNS, args.out, card)
    n_scan = binary.binary_scores.launches
    check(n_scan > 0, "the exact binary scan did not launch the kernel")
    log(f"  rows-layout launches over the exact scans: {n_scan} (one per 64k-row chunk of "
        f"each search)")
    flt = F("id") < BIN_FILTER
    fres = [t.search("bv", qb, k=K, filter=flt) for qb in batches[:2]]
    check_binary_hits("Hamming filtered", t, x64, queries[: 2 * BIN_BATCH], fres, "Hamming",
                      oracle_queries=5, row_ok=lambda s: s.scalar("id")[: s.n_rows] < BIN_FILTER)
    log(f"  filter id < {BIN_FILTER}: every hit passes and is exact")

    t0 = time.perf_counter()
    t.add_vector_index("bm", "bv", type="BinaryMSTG")
    check(t.wait_index_built(), "the BinaryMSTG build did not end")
    sync(dev)
    build_s = time.perf_counter() - t0
    check(t.index_status("bm") == {0: IndexStatus.LOADED},
          f"BinaryMSTG did not load: {t.index_status('bm')} {t.event_log.rows()[-1:]}")
    idx = t.loaded_index(0, "bv", Metric.HAMMING)
    log(f"  BinaryMSTG build {build_s:.2f} s ({idx.n_clusters} clusters, bucket capacity "
        f"{idx.bucket_cap}, {idx.n_overflow} rows in overflow; index "
        f"{idx.memory_bytes / 1e9:.4f} GB)  [{card}]")
    blocks_before = (binary.binary_block_scores.launches, binary.group_probes.launches)
    mres = [t.search("bv", qb, k=K) for qb in batches]
    check((binary.binary_block_scores.launches - blocks_before[0],
           binary.group_probes.launches - blocks_before[1]) == (len(batches), len(batches)),
          "BinaryMSTG must group its probes and score its buckets in one launch each per search")
    check_binary_hits("BinaryMSTG", t, x64, queries, mres, "Hamming")
    ev = np.concatenate([r.scores for r in exact["Hamming"]])
    mv = np.concatenate([r.scores for r in mres])
    er = np.concatenate([r.rows for r in exact["Hamming"]])
    mr = np.concatenate([r.rows for r in mres])
    rid = np.mean([len(set(a.tolist()) & set(b.tolist())) / K for a, b in zip(mr, er)])
    rscore = float((mv >= ev[:, -1:]).mean())
    rate = best_and_median_qps(lambda qb: t.search("bv", qb, k=K), batches, BIN_BATCH)
    log(f"  BinaryMSTG at its default nprobe: recall_ids@{K} {rid:.4f}, hits at or above the "
        f"exact k-th score {rscore:.4f}; QPS best {rate[0]:.1f}, median {rate[1]:.1f}  [{card}]")
    check(rscore >= BIN_MIN_SCORE_RECALL, f"BinaryMSTG finds too few of the exact top-{K}")
    # deletes last: every query's best hit
    gone = sorted({int(r) for r in mr[:, 0]})
    check(t.delete(F("id").isin(gone)) == len(gone), "delete removed another count of rows")
    jres = [t.search("bv", qb, k=K, metric="Jaccard") for qb in batches]  # the exact scan
    check_binary_hits("Jaccard after deletes", t, x64, queries, jres, "Jaccard", oracle_queries=5)
    dres = [t.search("bv", qb, k=K) for qb in batches]
    check(not set(np.concatenate([r.rows for r in dres]).ravel().tolist()) & set(gone),
          "a deleted row came back from the BinaryMSTG search")
    log(f"  delete: {len(gone)} rows deleted, none returned by the exact or BinaryMSTG search")
    launches = {"binary": binary.binary_scores.launches,
                "binary_blocks": binary.binary_block_scores.launches,
                "binary_group": binary.group_probes.launches}
    log(f"  binary kernel launches on phase 10: rows layout {launches['binary']}, blocks layout "
        f"{launches['binary_blocks']}, grouping {launches['binary_group']}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the binary path")

    # times, at the main path's shapes
    rate, sms, mhz = popc_rate()
    qd = torch.from_numpy(queries[:BIN_BATCH]).to(dev)
    xd = seg.vector("bv").data[:65_536]
    w = BIN_DIM // 32
    call = lambda: binary.binary_scores(qd, xd, Metric.HAMMING)  # noqa: E731
    rec = dict(
        ms=cuda_time_ms(call),
        plain_ms=cuda_time_ms(lambda: binary.binary_scores_plain(qd, xd, Metric.HAMMING), iters=3,
                              warmup=1),
        library_ms=None,  # torch has no popcount: no one call computes it
    )
    nbytes = xd.numel() + qd.numel() + 4 * BIN_BATCH * 65_536
    b_s, o_s = nbytes / PEAK_BYTES_PER_S, BIN_BATCH * 65_536 * w / rate
    rec["bound_ms"], rec["bound_by"] = 1e3 * max(b_s, o_s), ("bytes" if b_s >= o_s else "operations")
    log(f"  binary   rows Q={BIN_BATCH} N=65,536 B={BIN_DIM // 8} Hamming: kernel {rec['ms']:.4f} ms,"
        f" plain {rec['plain_ms']:.4f} ms, library n/a, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {BIN_BATCH * 65_536 * w / 1e6:.1f}M popcounts at {rate / 1e12:.3f}e12/s "
        f"= 16 x {sms} SMs x {mhz:.0f} MHz; {100 * rec['bound_ms'] / rec['ms']:.1f}% of it)  [{card}]")
    # the blocks layout at the search's own inputs: its probe, its buckets,
    # its slots' bit counts and its mask (the filter's after the deletes),
    # and the overflow scan's
    nprobe = idx._nprobe(())
    qbits = binary.unpack_bits_f32(qd, BIN_DIM)
    probe = topk_stable(2.0 * (qbits @ idx.centroids.T) - idx.csq[None, :], nprobe)[1].contiguous()
    smask = as_mask_array(segment_mask(seg, flt))
    omask = torch.logical_and(idx.over_rows >= 0,
                              smask[torch.clamp(idx.over_rows, min=0).to(torch.int64)])
    opad = idx.over_data.shape[0]
    perr, n_cmp = 0.0, 0
    for metric in (Metric.HAMMING, Metric.JACCARD):
        for m in (None, smask):
            want = binary.binary_block_scores_plain(qd, idx.bucket_data, probe, idx.bucket_rows,
                                                    m, metric)
            for pc in ((None, idx.bucket_popcnt) if metric == Metric.HAMMING
                       else (idx.bucket_popcnt,)):
                got = binary.binary_block_scores(qd, idx.bucket_data, probe, idx.bucket_rows,
                                                 metric, mask=m, popcnt=pc)
                check(torch.equal(got, want), f"binary blocks kernel differs from its plain version "
                      f"at BinaryMSTG's shape ({metric}, mask {m is not None}, popcnt "
                      f"{pc is not None})")
                perr, n_cmp = max(perr, exact_err(got, want)), n_cmp + got.numel()
        for m in (None, omask):
            got = binary.binary_scores(qd, idx.over_data, metric, n_valid=idx.n_overflow, mask=m)
            valid = torch.arange(opad, device=dev) < idx.n_overflow
            want = binary.binary_scores_plain(qd, idx.over_data, metric,
                                              valid if m is None else valid & m)
            check(torch.equal(got, want), f"binary rows kernel differs from its plain version on "
                  f"BinaryMSTG's overflow rows ({metric}, mask {m is not None})")
            perr, n_cmp = max(perr, exact_err(got, want)), n_cmp + got.numel()
    log(f"  binary   blocks Q={BIN_BATCH} P={nprobe} C={idx.n_clusters} M={idx.bucket_cap} and "
        f"overflow rows N={opad} (n_valid {idx.n_overflow}), Hamming and Jaccard, with and "
        f"without the filtered search's mask (Jaccard from the slots' bit counts, Hamming with "
        f"and without them): {n_cmp} scores equal to the plain version's bit for bit (max "
        f"|kernel - plain| {perr:g})")
    gerr = compare_group(probe, idx.n_clusters, "BinaryMSTG's probe")
    skew_err = compare_blocks_skewed(dev)
    perr = max(perr, skew_err)

    # the blocks call (grouping and scoring) for each metric, with its bound:
    # bytes = each distinct bucket the probe reads once (payload, row ids
    # and, for Jaccard, the slots' bit counts), the queries, the probe and
    # the output; popcounts = one a word a slot, for both metrics (Jaccard's
    # union comes from the bit counts)
    n_blk = int(torch.unique(probe).numel())
    bpop = BIN_BATCH * nprobe * idx.bucket_cap * w
    blocks = {}
    for metric in (Metric.HAMMING, Metric.JACCARD):
        call = lambda: binary.binary_block_scores(  # noqa: E731
            qd, idx.bucket_data, probe, idx.bucket_rows, metric, popcnt=idx.bucket_popcnt)
        r = dict(ms=cuda_time_ms(call),
                 plain_ms=cuda_time_ms(lambda: binary.binary_block_scores_plain(
                     qd, idx.bucket_data, probe, idx.bucket_rows, None, metric), iters=3, warmup=1),
                 library_ms=None)  # torch has no popcount: no one call computes it
        per_slot = BIN_DIM // 8 + 4 + (4 if metric == Metric.JACCARD else 0)
        bbytes = (n_blk * idx.bucket_cap * per_slot + qd.numel() + 4 * probe.numel()
                  + 4 * BIN_BATCH * nprobe * idx.bucket_cap)
        b_s, o_s = bbytes / PEAK_BYTES_PER_S, bpop / rate
        r["bound_ms"], r["bound_by"] = 1e3 * max(b_s, o_s), ("bytes" if b_s >= o_s else "operations")
        blocks[metric] = r
        log(f"  binary   blocks Q={BIN_BATCH} P={nprobe} M={idx.bucket_cap} B={BIN_DIM // 8} "
            f"{metric.value} (grouping + scoring): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library n/a, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{bbytes / 1e6:.1f} MB over the {n_blk} distinct buckets probed, {bpop / 1e6:.1f}M "
            f"popcounts at {rate / 1e12:.3f}e12/s; {100 * r['bound_ms'] / r['ms']:.1f}% of it)  "
            f"[{card}]")
    # the grouping alone: its bytes are the probe read and the pairs and
    # groups written
    pairs, groups, count = binary.group_probes(probe, idx.n_clusters)
    n_groups = int(count[0])
    gbytes = 4 * probe.numel() + 4 * pairs.numel() + 12 * n_groups + 4
    grec = dict(ms=cuda_time_ms(lambda: binary.group_probes(probe, idx.n_clusters)),
                plain_ms=cuda_time_ms(lambda: binary.group_probes_plain(probe, idx.n_clusters),
                                      iters=3, warmup=1),
                library_ms=None,  # no one call sorts and cuts into groups
                bound_ms=1e3 * gbytes / PEAK_BYTES_PER_S, bound_by="bytes")
    log(f"  binary   grouping Q={BIN_BATCH} P={nprobe} C={idx.n_clusters}: {n_groups} groups over "
        f"{n_blk} buckets; kernel {grec['ms']:.4f} ms, plain {grec['plain_ms']:.4f} ms, bound "
        f"{grec['bound_ms']:.6f} ms (bytes: {gbytes} B; one block, bound by its latency)  [{card}]")
    # the grouping's shared-memory path against its global counting sort on
    # the same pairs, in turns: C passed one past the buckets the shared-
    # memory path takes sends them down the global path (the extra buckets
    # stay empty, so the result is the same)
    cg = GROUP_SMEM_BUCKETS + 1
    out_g = binary.group_probes(probe, cg)
    check(torch.equal(out_g[2], count) and torch.equal(out_g[0], pairs)
          and torch.equal(out_g[1][:n_groups], groups[:n_groups]),
          "the grouping's global path differs from its shared-memory path")
    paths = {"shared": [], "global": []}
    for _ in range(2):
        paths["shared"].append(cuda_time_ms(lambda: binary.group_probes(probe, idx.n_clusters)))
        paths["global"].append(cuda_time_ms(lambda: binary.group_probes(probe, cg)))
    log(f"  binary   grouping at BinaryMSTG's probe, in turns: shared-memory path "
        f"{', '.join(f'{v:.4f}' for v in paths['shared'])} ms, global counting sort (C passed as "
        f"{cg}) {', '.join(f'{v:.4f}' for v in paths['global'])} ms  [{card}]")

    # where a Hamming blocks call's time goes on the device: a trace of
    # BLOCKS_TRACE_CALLS calls, each call's grouping kernel, the gap to its
    # scoring kernel, the scoring kernel and the gap to the next call
    ks = kernel_timeline(lambda: binary.binary_block_scores(
        qd, idx.bucket_data, probe, idx.bucket_rows, Metric.HAMMING), BLOCKS_TRACE_CALLS,
        os.path.join(args.out, "trace_binary_blocks.json"), "binary_group")
    kind = ["g" if "binary_group_kernel" in k[0] else "s" for k in ks]
    grp = [k for k, c in zip(ks, kind) if c == "g"]
    sco = [k for k, c in zip(ks, kind) if c == "s"]
    # neighbours in the timeline: a grouping then its scoring kernel, a
    # scoring kernel then the next call's grouping, and one call's grouping
    # to the next's
    pairs_gs = [(a, b) for a, b, x, y in zip(ks, ks[1:], kind, kind[1:]) if (x, y) == ("g", "s")]
    pairs_sg = [(a, b) for a, b, x, y in zip(ks, ks[1:], kind, kind[1:]) if (x, y) == ("s", "g")]
    calls = [(a, c) for a, c, x, y, z in zip(ks, ks[2:], kind, kind[1:], kind[2:])
             if (x, y, z) == ("g", "s", "g")]
    check(len(pairs_gs) >= BLOCKS_TRACE_CALLS // 2 and pairs_sg and calls,
          f"the trace of the blocks call holds {len(grp)} grouping and {len(sco)} scoring kernels "
          f"in an order that pairs too few of them")
    med = statistics.median
    log(f"  binary   blocks call traced ({BLOCKS_TRACE_CALLS} Hamming calls, the device first "
        f"asleep; the trace holds {len(grp)} grouping and {len(sco)} scoring kernels; median us): "
        f"grouping kernel {med(g[2] for g in grp):.2f}, gap {med(b[1] - a[1] - a[2] for a, b in pairs_gs):.2f}, "
        f"scoring kernel {med(c[2] for c in sco):.2f}, gap to the next call's grouping "
        f"{med(b[1] - a[1] - a[2] for a, b in pairs_sg):.2f}; a call start to start "
        f"{med(c[1] - a[1] for a, c in calls):.2f}  [{card}]")
    for name, k in (("grouping", grp[0]), ("scoring", sco[0])):
        log(f"  binary   {name} kernel launch as the profiler read it: " + ", ".join(
            f"{key} {k[3][key]}" for key in LAUNCH_KEYS if key in k[3]))
    # how the persistent scoring blocks split the work: item i is group
    # i % n_groups, tile i // n_groups, taken by block i % grid
    grid = int(sco[0][3].get("grid", [0])[0])
    gl = groups[:n_groups].cpu().numpy()
    tiles = -(-idx.bucket_cap // binary.BLOCK_ROWS)
    tile_rows = np.minimum(binary.BLOCK_ROWS, idx.bucket_cap - binary.BLOCK_ROWS * np.arange(tiles))
    item_q, item_rows = np.tile(gl[:, 2], tiles), np.repeat(tile_rows, n_groups)
    need = item_q * item_rows  # (query, row) pairs an item scores
    issued = -(-item_q // BB_QSTEP) * BB_QSTEP * item_rows
    if grid > 0:
        owner = np.arange(need.size) % grid
        per_block = np.bincount(owner, weights=need, minlength=grid)
        n_items = np.bincount(owner, minlength=grid)
        log(f"  binary   scoring work split: {need.size} items ({n_groups} groups of "
            f"{gl[:, 2].mean():.2f} queries on average x {tiles} tiles) over {grid} persistent "
            f"blocks: items a block {n_items.min()} / {n_items.mean():.2f} / {n_items.max()} "
            f"(min / mean / max); (query, row) pairs a block mean / busiest "
            f"{per_block.mean() / per_block.max():.3f}; popcounts issued / needed "
            f"{issued.sum() / need.sum():.3f} (queries in steps of {BB_QSTEP})")
    timing = {"binary": rec, "binary_blocks": blocks[Metric.HAMMING], "binary_group": grec}
    errs = {"binary": perr, "binary_blocks": perr, "binary_group": gerr}
    if args.profile:
        profile_cells([("binary_mstg", lambda qb: t.search("bv", qb, k=K), batches)],
                      PROFILE_RUNS, args.out, card)
    return launches, timing, errs, (db, t, batches)


# ---------------------------------------------------------------- phase 11
def hits(t, results):
    """(ids, scores, distances) of a list of SearchResults, the ids gathered
    now (gather before the segments change)."""
    return (np.concatenate([t.gather(r, ["id"])["id"] for r in results]),
            np.concatenate([r.scores for r in results]),
            np.concatenate([r.distances for r in results]))


def same_hits(label, got, want, tol=F32_TOL):
    """`got` and `want` (`hits` of the same queries) hold the same hits: per
    query the same ids, or, where they differ, sorted scores within `tol`
    (a near-tie resolved the other way). Returns (queries, near-tied
    queries, largest |distance difference| over the queries whose ids
    agree)."""
    (gi, gv, gd), (wi, wv, wd) = got, want
    tied, worst = 0, 0.0
    for i in range(len(gi)):
        if (gi[i] == wi[i]).all():
            worst = max(worst, float(np.abs(gd[i] - wd[i]).max()))
            continue
        check(np.allclose(np.sort(gv[i]), np.sort(wv[i]), **tol),
              f"{label}: query {i} returned other ids {gi[i].tolist()} than {wi[i].tolist()}")
        tied += 1
    return len(gi), tied, worst


def tree_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def mutation_path(ms, t, batches, queries):
    """Phase 11a on phase 3's SIFT table: ADD COLUMN, UPDATE, a search
    filtered on the new column against one filtered on the rows it marks,
    compute_distances against the search's own distances, DROP COLUMN."""
    from myscaledb_tpu_torch import F

    t.add_column("tag", ms.Int32(), 0)
    n = t.update(F("id") < MUT_IDS, {"tag": 1})
    check(n == MUT_IDS - 100, f"UPDATE marked {n} rows, expected {MUT_IDS - 100} (100 deleted)")
    by_tag = [t.search("vec", qb, k=K, metric="L2", filter=F("tag") == 1) for qb in batches]
    by_id = [t.search("vec", qb, k=K, metric="L2", filter=F("id") < MUT_IDS) for qb in batches]
    nq, tied, worst = same_hits("tag == 1 against id < 10000", hits(t, by_tag), hits(t, by_id),
                                tol=dict(rtol=0, atol=0))
    check(tied == 0, f"tag == 1 and id < {MUT_IDS} differ on {tied} queries")
    tags = np.concatenate([t.gather(r, ["tag"])["tag"] for r in by_tag])
    check((tags == 1).all(), "a hit of the tag filter is not tagged")
    log(f"  ADD COLUMN tag Int32 DEFAULT 0, UPDATE tag = 1 WHERE id < {MUT_IDS} ({n} rows; 100 "
        f"of them deleted in phase 3): the tag filter's {nq} queries return the id filter's "
        f"hits (largest |distance difference| {worst:g})")
    # compute_distances (f64 on the host, from the stored rows) against the
    # kernels' distances, in score units as check_hits_exact holds them:
    # distance = |q|^2 - score
    worst, n_cmp = 0.0, 0
    for qb, r in zip(batches, by_tag):
        cd = t.compute_distances("vec", qb, r)
        qsq = np.einsum("ij,ij->i", qb.astype(np.float64), qb.astype(np.float64))[:, None]
        ok = np.isclose(qsq - cd, r.scores, **F32_TOL)
        check(ok.all(), f"compute_distances differs from the search's distances on {(~ok).sum()} hits")
        worst = max(worst, float(np.abs(cd - r.distances).max()))
        n_cmp += cd.size
    log(f"  compute_distances on {n_cmp} hits agrees with the search within F32_TOL (largest "
        f"|f64 distance - search distance| {worst:.6g})")
    t.drop_column("tag")
    check("tag" not in t.schema.columns, "DROP COLUMN left the column")


def restart_path(ms, dev, sift, sift_batches, gist, gist_batches, card):
    """Phase 11b: phase 3's SIFT table and phase 4's GIST table (with a
    fresh HNSWFLAT) persisted, reloaded through connect(path=...) /
    load_table, searched against the live tables."""
    import gc
    import shutil
    import tempfile

    import torch

    from myscaledb_tpu_torch.index import hnsw
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.ops import gathermv

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        sift.persist(os.path.join(root, "sift"))
        t1 = time.perf_counter()
        db = ms.connect(path=root, device=dev)
        sl = db.load_table("sift")
        sync(dev)
        t2 = time.perf_counter()
        check(sl.n_rows == sift.n_rows == SIFT_N + SIFT_SMALL_N - 100,
              f"reloaded rows {sl.n_rows}, live {sift.n_rows}")
        live = [sift.search("vec", qb, k=K, metric="L2") for qb in sift_batches]
        back = [sl.search("vec", qb, k=K, metric="L2") for qb in sift_batches]
        for a, b in zip(live, back):
            check((a.segments == b.segments).all() and (a.rows == b.rows).all(),
                  "the reloaded SIFT table returned other hits than the live one")
        ids = np.concatenate([sl.gather(r, ["id"])["id"] for r in back])
        check((ids >= 100).all(), "a row deleted before the checkpoint came back")
        worst = max(float(np.abs(a.distances - b.distances).max()) for a, b in zip(live, back))
        log(f"  SIFT: persist {t1 - t0:.2f} s ({tree_bytes(os.path.join(root, 'sift')) / 1e9:.3f}"
            f" GB), connect + load_table {t2 - t1:.2f} s; {SIFT_NQ} queries, every batch's hits "
            f"equal the live table's (largest |distance difference| {worst:g}), no deleted row  "
            f"[{card}]")

        gist.add_vector_index("h11", "vec", type="HNSWFLAT", metric_type="Cosine", **HNSW_PARAMS)
        check(gist.wait_index_built(), "the HNSWFLAT build did not end")
        check(gist.index_status("h11") == {0: IndexStatus.LOADED}, "HNSWFLAT did not load")
        graph = ms.Settings()
        graph.query.cost_based_index_routing = False
        t0 = time.perf_counter()
        gist.persist(os.path.join(root, "gist"))
        t1 = time.perf_counter()
        gl = db.load_table("gist")
        t2 = time.perf_counter()
        check(gl.index_status("h11") == {0: IndexStatus.BUILT},
              f"the reloaded index must wait on disk: {gl.index_status('h11')}")
        before = gathermv.gather_block_scores.launches
        back = [gl.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph) for qb in gist_batches]
        sync(dev)
        n_launch = gathermv.gather_block_scores.launches - before
        t3 = time.perf_counter()
        check(gl.index_status("h11") == {0: IndexStatus.LOADED},
              "the first search did not load the index")
        check(n_launch == hnsw.n_iterations(100) * len(gist_batches),
              f"{n_launch} gathermv launches on the reloaded graph")
        live = [gist.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph)
                for qb in gist_batches]
        exact = exact_topk(gist, "vec", np.concatenate(gist_batches), K, gist.index_metric_for("vec"))
        r_live, r_back = graph_recall(live, exact)[0], graph_recall(back, exact)[0]
        check(r_back == r_live, f"recall_ids@{K} reloaded {r_back:.4f} != live {r_live:.4f}")
        for a, b in zip(live, back):
            check((a.rows == b.rows).all(), "the reloaded graph returned other hits")
        log(f"  GIST + HNSWFLAT {HNSW_PARAMS}: persist {t1 - t0:.2f} s "
            f"({tree_bytes(os.path.join(root, 'gist')) / 1e9:.3f} GB), load_table {t2 - t1:.2f} s, "
            f"first search pass with the lazy reload {t3 - t2:.2f} s; {n_launch} gathermv launches "
            f"on the reloaded table; recall_ids@{K} at ef_s 100 {r_back:.4f} (live {r_live:.4f}), "
            f"hits equal  [{card}]")
        gist.drop_vector_index("h11")
        db.close()
        del db, sl, gl
        gc.collect()  # the database and its index cache hold each other
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


class GatedScheduler:
    """Holds build jobs until released (the decoupled window stays open;
    tests/test_decoupled_merge.py:17-30)."""

    def __init__(self):
        self.jobs = []

    def submit(self, job, slow=False):
        self.jobs.append(job)

    def release(self):
        jobs, self.jobs = self.jobs, []
        for job in jobs:
            job()


def merge_path(ms, dev, sift, queries, op, card):
    """Phase 11c: phase 3's 1M corpus in two 500,000-row parts, each with
    IVFFLAT (ncentroids 1,024), 100 deletes; merge() behind a gated
    scheduler serves the merged segment through a DecoupledIndex; then the
    rebuild, its nprobe sweep, truncate and a fresh insert."""
    import torch

    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.index.decoupled import DecoupledIndex
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    seg = sift.live_segments()[0]
    corpus = seg.vector("vec").data[:SIFT_N, :SIFT_D].to(torch.float32).cpu().numpy()
    half = SIFT_N // 2
    db = ms.connect(device=dev)
    t = db.create_table("merge", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(SIFT_D)}))
    ids = np.arange(SIFT_N, dtype=np.uint64)
    t0 = time.perf_counter()
    for p in (slice(0, half), slice(half, SIFT_N)):
        t.insert({"id": ids[p], "vec": corpus[p]})
    t.add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=IVF_NCENT, metric_type="L2")
    check(t.wait_index_built(), "the IVFFLAT builds did not end")
    check(t.index_status("ivf") == {0: IndexStatus.LOADED, 1: IndexStatus.LOADED},
          f"both parts must carry IVFFLAT: {t.index_status('ivf')}")
    check(t.delete(F("id") < 100) == 100, "delete removed another count of rows")
    batches = [queries[i : i + SIFT_BATCH] for i in range(0, SIFT_NQ, SIFT_BATCH)]
    pre = hits(t, [t.search("vec", qb, k=K, params={"nprobe": op}) for qb in batches])
    check((pre[0] >= 100).all(), "a deleted row came back before the merge")
    t1 = time.perf_counter()

    gate = GatedScheduler()
    t._scheduler = gate
    new_id = t.merge()
    sync(dev)
    t2 = time.perf_counter()
    segs = t.live_segments()
    check([s.segment_id for s in segs] == [new_id] and segs[0].n_rows == SIFT_N - 100,
          f"merge left {[(s.segment_id, s.n_rows) for s in segs]}")
    slot = t._slots[(new_id, "ivf")]
    check(slot.status == IndexStatus.PENDING and isinstance(slot.instance, DecoupledIndex),
          f"the merged segment is not served by a DecoupledIndex: {slot}")
    before = GLOBAL_COUNTERS.get("VectorIndexSearches")
    dec = [t.search("vec", qb, k=K, params={"nprobe": op}) for qb in batches]
    check(GLOBAL_COUNTERS.get("VectorIndexSearches") - before == len(batches),
          "the decoupled searches did not go through the index")
    got = hits(t, dec)
    nq, tied, worst = same_hits("decoupled window", got, pre)
    check((got[0] >= 100).all(), "a deleted row came back through the decoupled index")
    log(f"  two parts of {half:,} rows with IVFFLAT ({t1 - t0:.2f} s with the builds), 100 "
        f"deletes; merge {t2 - t1:.2f} s into segment {new_id} ({SIFT_N - 100:,} rows) served by "
        f"a DecoupledIndex over {len(slot.instance.subs)} sources; at nprobe {op} its {nq} queries "
        f"return the pre-merge ids ({tied} near-tied, largest |distance difference| {worst:g}), "
        f"no deleted row  [{card}]")

    t3 = time.perf_counter()
    gate.release()
    check(t.wait_index_built(), "the rebuild did not end")
    t._scheduler = db.scheduler
    slot = t._slots[(new_id, "ivf")]
    check(slot.status == IndexStatus.LOADED and not isinstance(slot.instance, DecoupledIndex),
          f"the rebuild did not replace the DecoupledIndex: {slot}")
    t4 = time.perf_counter()
    gt = exact_topk(t, "vec", queries, K, Metric.L2)
    picked = None
    for nprobe in IVF_NPROBES:
        res = [t.search("vec", qb, k=K, params={"nprobe": nprobe}) for qb in batches]
        rid = ivf_recall(res, gt, queries)[0]
        if rid >= IVF_RECALL_TARGET:
            picked = nprobe
            break
    check(picked is not None, f"the rebuilt index never reached recall_ids@{K} {IVF_RECALL_TARGET}")
    check_hits_exact(t, queries, res, f"rebuilt IVFFLAT nprobe={picked}")
    log(f"  rebuild after the gate {t4 - t3:.2f} s; the sweep picks nprobe {picked} (phase 8: "
        f"{op}) at recall_ids@{K} {rid:.4f}  [{card}]")

    t.truncate()
    check(t.n_rows == 0 and not t.live_segments(), "truncate left rows")
    check(not t.search("vec", queries[:SIFT_BATCH], k=K).valid.any(), "a hit after truncate")
    t.insert({"id": ids[:MERGE_REFILL], "vec": corpus[:MERGE_REFILL]})
    check(t.wait_index_built(), "the build after truncate did not end")
    (sid, status), = t.index_status("ivf").items()
    check(status == IndexStatus.LOADED and sid == new_id + 1,
          f"the insert after truncate did not build afresh: {t.index_status('ivf')}")
    r = t.search("vec", corpus[:SIFT_BATCH], k=1, params={"nprobe": IVF_NCENT})
    check((t.gather(r, ["id"])["id"][:, 0] == ids[:SIFT_BATCH]).all(),
          "the fresh index does not find the inserted rows")
    log(f"  truncate: 0 rows, no hit; an insert of {MERGE_REFILL:,} rows builds IVFFLAT afresh "
        f"(segment {sid})")
    db.drop_table("merge")


def final_path(ms, dev, sift, card):
    """Phase 11d: a ReplacingMergeTree(ver) table keyed by id over phase
    3's 1M corpus at ver 0, then FINAL_DUP of the same ids at ver 1 with
    new vectors; search(final=True) against an exact numpy scan over the
    winners, before and after merge()."""
    import torch

    seg = sift.live_segments()[0]
    corpus = seg.vector("vec").data[:SIFT_N, :SIFT_D].to(torch.float32).cpu().numpy()
    rng = np.random.default_rng(11)
    dup = np.sort(rng.choice(SIFT_N, FINAL_DUP, replace=False))
    fresh = make_corpus(FINAL_DUP, SIFT_D, seed=12, centers=corpus_centers(SIFT_D))
    db = ms.connect(device=dev)
    t = db.create_table("final", ms.Schema({"id": ms.UInt64(), "ver": ms.UInt64(),
                                            "vec": ms.FloatVector(SIFT_D)}),
                        engine="ReplacingMergeTree", key_column="id", version_column="ver")
    t.insert({"id": np.arange(SIFT_N, dtype=np.uint64), "ver": np.zeros(SIFT_N, np.uint64),
              "vec": corpus})
    t.insert({"id": dup.astype(np.uint64), "ver": np.ones(FINAL_DUP, np.uint64), "vec": fresh})
    # the winners' stored rows: the unsuperseded old rows and every new one
    stored_new = t.live_segments()[1].vector("vec").data[:FINAL_DUP, :SIFT_D].to(torch.float32)
    keep = np.ones(SIFT_N, bool)
    keep[dup] = False
    win_x = np.concatenate([corpus[keep], stored_new.cpu().numpy()])
    win_id = np.concatenate([np.nonzero(keep)[0], dup]).astype(np.uint64)
    # half the queries sit on superseded rows' old vectors, half on new ones
    q = np.concatenate([corpus[dup[: FINAL_NQ // 2]], fresh[: FINAL_NQ // 2]])
    q = (q + 0.3 * rng.standard_normal(q.shape)).astype(np.float32)
    batches = [q[i : i + SIFT_BATCH] for i in range(0, FINAL_NQ, SIFT_BATCH)]
    xsq = np.einsum("ij,ij->i", win_x, win_x)

    def oracle(qb):
        """The exact f32 L2 scores (2 q.x - |x|^2) of the winners' stored
        rows, top k, in numpy."""
        s = 2.0 * (qb @ win_x.T) - xsq[None, :]
        part = np.argpartition(-s, K, axis=1)[:, :K]
        v = np.take_along_axis(s, part, 1)
        order = np.argsort(-v, axis=1, kind="stable")
        return np.take_along_axis(v, order, 1), win_id[np.take_along_axis(part, order, 1)]

    def check_final(label):
        worst, tied = 0.0, 0
        for qb in batches:
            r = t.search("vec", qb, k=K, final=True)
            got = t.gather(r, ["id", "ver"])
            check(r.valid.all(), f"{label}: FINAL returned fewer than {K} hits")
            old = np.isin(got["id"], dup) & (got["ver"] == 0)
            check(not old.any(), f"{label}: FINAL returned {int(old.sum())} superseded rows")
            v, ids = oracle(qb)
            for i in range(len(qb)):
                if not (got["id"][i] == ids[i]).all():
                    check(np.allclose(np.sort(r.scores[i]), np.sort(v[i]), **F32_TOL),
                          f"{label}: query {i} differs from the numpy scan over the winners")
                    tied += 1
            worst = max(worst, float(np.abs(r.scores - v).max()))
        return tied, worst

    t0 = time.perf_counter()
    tied, worst = check_final("FINAL before merge")
    t1 = time.perf_counter()
    log(f"  ReplacingMergeTree(ver): {SIFT_N:,} rows at ver 0 + {FINAL_DUP:,} of the same ids at "
        f"ver 1; search(final=True) over {FINAL_NQ} queries ({t1 - t0:.2f} s): no superseded row, "
        f"the winners' exact top-{K} ({tied} near-tied, largest |score difference| {worst:.6g})")
    t0 = time.perf_counter()
    t.merge()
    t1 = time.perf_counter()
    check(t.n_rows == SIFT_N and len(t.live_segments()) == 1,
          f"the merge left {t.n_rows} rows in {len(t.live_segments())} segments")
    tied, worst = check_final("FINAL after merge")
    log(f"  merge {t1 - t0:.2f} s drops the {FINAL_DUP:,} superseded rows ({t.n_rows:,} left); "
        f"FINAL still equals the numpy scan ({tied} near-tied, largest |score difference| "
        f"{worst:.6g})  [{card}]")
    db.drop_table("final")


# ---------------------------------------------------------------- main
# --------------------------------------------------------------- phase 12
def mem_available():
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def link_rate(dev, card):
    """GB/s of one LINK_BYTES copy from pinned host memory to the card
    (CUDA events, best of 5 after one warm-up): the host link's rate, which
    bounds a streamed scan."""
    import torch

    src = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    src.fill_(1)
    dst = torch.empty(LINK_BYTES, dtype=torch.uint8, device=dev)
    ms_ = min(cuda_time_ms(lambda: dst.copy_(src, non_blocking=True), iters=1, warmup=1,
                           padded=False) for _ in range(5))
    rate = LINK_BYTES / ms_ / 1e6
    log(f"  pinned host -> device copy of {LINK_BYTES / 2**30:.0f} GiB: {ms_:.3f} ms, "
        f"{rate:.2f} GB/s  [{card}]")
    del src, dst
    return rate


def host_corpus(ms, dev, card):
    """The host-tier table of phase 12b: bench.py's beyond-HBM corpus made
    on the card in 1M-row chunks (seeded torch.Generator) and inserted
    through Table.insert into pinned host memory. Returns (db, table,
    queries, segments, payload bytes)."""
    import torch

    per_seg = HOST_CAP * HOST_DPAD * 4 + HOST_CAP * 8  # f32 rows and two f32 norms
    avail = mem_available()
    n_seg = HOST_N // HOST_CHUNK
    while n_seg > 1 and HOST_RAM_FACTOR * n_seg * per_seg > avail:
        n_seg -= 1
    if n_seg < HOST_N // HOST_CHUNK:
        log(f"  CUT: MemAvailable {avail / 1e9:.1f} GB is under {HOST_RAM_FACTOR} x the "
            f"{HOST_N:,}-row payload ({HOST_N // HOST_CHUNK * per_seg / 1e9:.1f} GB): the corpus "
            f"is cut to {n_seg * HOST_CHUNK:,} rows ({n_seg * per_seg / 1e9:.1f} GB)")
    else:
        log(f"  MemAvailable {avail / 1e9:.1f} GB holds {HOST_RAM_FACTOR} x the payload "
            f"({n_seg * per_seg / 1e9:.1f} GB): no cut")
    st = ms.Settings()
    st.table.vector_storage_tier = "host"
    st.table.min_rows_to_build_vector_index = 1
    db = ms.connect(st, device=dev)
    t = db.create_table("host", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(HOST_D)}))
    rng = np.random.default_rng(11)
    centers = torch.from_numpy(6.0 * rng.standard_normal((1000, HOST_D)).astype(np.float32)).to(dev)
    qsrc = None
    t0 = time.perf_counter()
    gen_s = 0.0
    stage = torch.empty((HOST_CHUNK, HOST_D), dtype=torch.float32,
                        pin_memory=dev.type == "cuda")
    for i in range(n_seg):
        g0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        which = torch.randint(0, 1000, (HOST_CHUNK,), generator=gen, device=dev)
        stage.copy_(centers[which] + torch.randn((HOST_CHUNK, HOST_D), generator=gen, device=dev))
        chunk = stage.numpy()
        del which
        gen_s += time.perf_counter() - g0
        if qsrc is None:
            qsrc = chunk[:HOST_NQ].copy()
        t.insert({"id": np.arange(i * HOST_CHUNK, (i + 1) * HOST_CHUNK, dtype=np.uint64),
                  "vec": chunk})
    del stage, chunk
    ingest_s = time.perf_counter() - t0
    queries = (qsrc + 0.1 * rng.standard_normal((HOST_NQ, HOST_D))).astype(np.float32)
    segs = t.live_segments()
    for seg in segs:
        p = seg.vector("vec")
        check(p.is_host and p.data.is_pinned() == (dev.type == "cuda")
              and p.data.dtype == torch.float32
              and tuple(p.data.shape) == (HOST_CAP, HOST_DPAD) and seg.n_rows == HOST_CHUNK,
              f"segment {seg.segment_id} is not a pinned f32 host-tier payload of "
              f"({HOST_CAP}, {HOST_DPAD}): {p.tier} {tuple(p.data.shape)}")
    payload = sum(seg.device_bytes for seg in segs)
    log(f"  {n_seg * HOST_CHUNK:,} x {HOST_D} f32 in {n_seg} inserts: {ingest_s:.2f} s "
        f"({gen_s:.2f} s of it making the rows on the card and copying them down); {n_seg} "
        f"segments of {HOST_CAP:,} rows, {payload / 1e9:.2f} GB of pinned host memory; "
        f"MemAvailable now {mem_available() / 1e9:.1f} GB  [{card}]")
    return db, t, queries, segs, payload


def host_oracle(t, queries):
    """The exact L2 top-K of `queries` over the live stored rows of the
    host-tier table `t`, in f64 with numpy (blocks of STREAM_CHUNK rows on
    8 threads). Returns (scores 2 q.x - |x|^2, f64[Q, K] best first,
    segment ids, rows)."""
    from concurrent.futures import ThreadPoolExecutor

    q = queries.astype(np.float64)
    jobs = []
    for seg in t.live_segments():
        x = seg.vector("vec").data.numpy()
        dead = seg.deleted_host()
        for i in range(0, seg.n_rows, STREAM_CHUNK):
            jobs.append((seg, x, dead, i, min(seg.n_rows, i + STREAM_CHUNK)))

    def one(job):
        seg, x, dead, i, j = job
        xb = x[i:j, :HOST_D].astype(np.float64)
        s = 2.0 * (q @ xb.T) - np.einsum("ij,ij->i", xb, xb)[None, :]
        s[:, dead[i:j]] = -np.inf
        top = np.argsort(-s, axis=1)[:, :K]
        return (np.take_along_axis(s, top, 1), np.full(top.shape, seg.segment_id), top + i)

    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(one, jobs))
    s = np.concatenate([p[0] for p in parts], 1)
    g = np.concatenate([p[1] for p in parts], 1)
    r = np.concatenate([p[2] for p in parts], 1)
    top = np.argsort(-s, axis=1, kind="stable")[:, :K]
    return tuple(np.take_along_axis(a, top, 1) for a in (s, g, r))


def check_host_hits(t, queries, res, label):
    """Every hit of `res` is a live row whose score is the f64 L2 score
    (2 q.x - |x|^2) of its stored host row, within F32_TOL. Returns the
    largest |distance - f64 distance|."""
    segs = {s.segment_id: s for s in t.live_segments()}
    check((res.rows[: len(queries)] >= 0).all(), f"{label}: a query got fewer than {K} hits")
    want = np.empty(res.rows.shape)
    q = queries.astype(np.float64)
    for i in range(len(queries)):
        for j in range(res.rows.shape[1]):
            seg = segs[int(res.segments[i, j])]
            r = int(res.rows[i, j])
            check(not seg.deleted_host()[r], f"{label}: a deleted row came back")
            x = seg.vector("vec").data[r, :HOST_D].numpy().astype(np.float64)
            want[i, j] = 2.0 * q[i] @ x - x @ x
    ok = np.isclose(res.scores, want, **F32_TOL)
    check(ok.all(), f"{label}: {int((~ok).sum())} hits differ from their rows' f64 scores "
          f"(worst {float(np.abs(res.scores - want).max()):.6g})")
    qsq = np.einsum("ij,ij->i", q, q)[:, None]
    return float(np.abs(res.distances - (qsq - want)).max())


def compare_oracle(label, res, oracle, n):
    """The first `n` queries' sorted scores agree with the oracle's within
    F32_TOL; where their ids differ, that is a near-tie. Returns the
    near-tied count."""
    osc, og, orow = oracle
    tied = 0
    for i in range(n):
        check(np.allclose(-np.sort(-res.scores[i]), osc[i], **F32_TOL),
              f"{label}: query {i}'s scores {res.scores[i]} differ from the f64 oracle's {osc[i]}")
        got = set(zip(res.segments[i].tolist(), res.rows[i].tolist()))
        if got != set(zip(og[i].tolist(), orow[i].tolist())):
            tied += 1
    return tied


def stream_path(ms, dev, t, queries, segs, payload, link, card):
    """Phase 12c: the exact scan of the host-tier table (no index, brute
    force on): two timed passes, the launches, the f64 oracle, a filter
    that const-folds all but the first segment away, deletes, and the f32
    engine of score and tile_max against its plain version at one stream
    chunk's operands (phase 7 times it). Returns (the exact results after
    the deletes, seconds per pass, the f32 engine's max errors)."""
    import torch

    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan

    bf = ms.Settings()
    bf.query.enable_brute_force_vector_search = True
    n_seg = len(segs)
    passes = []
    for i in range(2):
        before = (distance.scores.launches_f32, tilescan.tile_maxes.launches_f32)
        sync(dev)
        t0 = time.perf_counter()
        res = t.search("vec", queries, k=K, metric="L2", settings=bf)
        res.rows  # the results reach the host: the pass has ended
        passes.append(time.perf_counter() - t0)
        n_score = distance.scores.launches_f32 - before[0]
        n_tile = tilescan.tile_maxes.launches_f32 - before[1]
        chunks = n_seg * HOST_CAP // STREAM_CHUNK
        check(n_score == chunks and n_tile == 0,
              f"stream pass {i}: f32 score launches {n_score}, tile_max {n_tile}; expected "
              f"{chunks} score launches (960-d chunks take the full-score route)")
    best = min(passes)
    streamed = n_seg * HOST_CAP * (HOST_DPAD + 1) * 4  # rows and the L2 aux
    rate = streamed / best / 1e9
    log(f"  stream scan, {HOST_NQ} queries: passes {passes[0]:.3f} s, {passes[1]:.3f} s; "
        f"{streamed / 1e9:.2f} GB streamed at {rate:.2f} GB/s = {100 * rate / link:.1f}% of the "
        f"pinned copy rate; f32 score launches per pass {n_score} ({n_score // n_seg} chunks of "
        f"{STREAM_CHUNK:,} rows a segment), tile_max {n_tile}; QPS {HOST_NQ / best:.1f}  [{card}]")

    t0 = time.perf_counter()
    oracle = host_oracle(t, queries[:HOST_ORACLE_NQ])
    tied = compare_oracle("stream scan", res, oracle, HOST_ORACLE_NQ)
    worst = check_host_hits(t, queries, res, "stream scan")
    log(f"  the first {HOST_ORACLE_NQ} queries equal an f64 numpy scan of the stored rows "
        f"({tied} near-tied; {time.perf_counter() - t0:.1f} s); all {HOST_NQ * K} hits carry "
        f"their rows' f64 scores within F32_TOL (largest |distance - f64 distance| {worst:.6g})")

    flt = F("id") < HOST_CHUNK
    before = distance.scores.launches_f32
    fres = t.search("vec", queries, k=K, metric="L2", settings=bf, filter=flt)
    ids = t.gather(fres, ["id"])["id"]
    check((ids < HOST_CHUNK).all() and (fres.segments == segs[0].segment_id).all(),
          f"every hit of id < {HOST_CHUNK} must come from the first segment")
    n_f = distance.scores.launches_f32 - before
    check(n_f == HOST_CAP // STREAM_CHUNK,
          f"id < {HOST_CHUNK}: {n_f} score launches, expected the first segment's chunks only")
    log(f"  filter id < {HOST_CHUNK:,}: {n_seg - 1} segments const-folded away, {n_f} score "
        f"launches, every hit from segment 0")
    first = sorted({int(i) for i in t.gather(res, ["id"])["id"][:, 0]})[:HOST_DELETES]
    n_del = t.delete(F("id").isin(first))
    check(n_del == len(first), f"delete removed {n_del} rows, expected {len(first)}")
    dres = t.search("vec", queries, k=K, metric="L2", settings=bf)
    check(not set(t.gather(dres, ["id"])["id"].ravel().tolist()) & set(first),
          "a deleted row came back from the stream scan")
    check_host_hits(t, queries, dres, "stream scan after deletes")
    log(f"  delete: {n_del} rows (each query's nearest), none returned; every hit exact")

    # the f32 engine at one stream chunk's operands (phase 7 times it); these
    # launches compare the kernels, so they stay out of the path's counts
    counts = [(w, w.launches, w.launches_f32) for w in (distance.scores, tilescan.tile_maxes)]
    seg = segs[0]
    p = seg.vector("vec")
    x = p.data[:STREAM_CHUNK].to(dev)
    aux = p.sqnorm[:STREAM_CHUNK].to(dev)
    qn = 104  # the batch of 100 padded to 8
    q = torch.nn.functional.pad(torch.from_numpy(queries).to(dev), (0, HOST_DPAD - HOST_D,
                                                                      0, qn - HOST_NQ))
    m8 = torch.from_numpy(~seg.deleted_host()[:STREAM_CHUNK]).to(dev).to(torch.uint8)
    bound_s = distance.kernel_error_bound(q, x, aux, Metric.L2)
    got = distance.scores(q, x, aux, metric=Metric.L2)
    want = distance.scores_plain(q, x, aux, Metric.L2)
    err_s = float((got - want).abs().max())
    check(not bool(distance.outside_kernel_bound(got, want, bound_s).any()),
          "the f32 score engine disagrees with its plain version at a stream chunk")
    tb = tilescan.tile_error_bound(q, x, aux, Metric.L2)
    got = tilescan.tile_maxes(q, x, aux, m8, metric=Metric.L2)
    want = tilescan.tile_maxes_plain(q, x, aux, m8, Metric.L2)
    err_t = float((got - want).abs().max())
    check(not bool(distance.outside_kernel_bound(got, want, tb).any()),
          "the f32 tile_max engine disagrees with its plain version at a stream chunk")
    log(f"  f32 engine at a stream chunk (Q={qn} N={STREAM_CHUNK:,} D={HOST_DPAD} f32 L2): score "
        f"max_abs_err {err_s:.6g}, tile_max {err_t:.6g}, within distance.kernel_error_bound (F32_SUM_TOL)")
    del got, want, bound_s, tb, x, aux, q, m8
    for w, n_all, n_f32 in counts:
        w.launches, w.launches_f32 = n_all, n_f32
    return dres, best, {"score_f32": err_s, "tile_max_f32": err_t}


def disk_mstg_path(dev, t, queries, gt, stream_s, payload, card):
    """Phase 12d: a default MSTG over the host-tier table (disk mode: SQ8
    windows on the card, the exact re-rank from host rows), its nprobe
    sweep against the stream scan's results, QPS at the operating nprobe."""
    from myscaledb_tpu_torch.index import ivf
    from myscaledb_tpu_torch.metrics import Metric

    t0 = time.perf_counter()
    t.add_vector_index("m", "vec")
    check(t.wait_index_built(timeout=1800), "the disk-mode MSTG build did not end")
    sync(dev)
    build_s = time.perf_counter() - t0
    segs = t.live_segments()
    idxs = [t.loaded_index(s.segment_id, "vec", Metric.L2) for s in segs]
    for s, idx in zip(segs, idxs):
        check(isinstance(idx, ivf.MSTGIndex) and idx.raw_host is s.vector("vec").data
              and idx.raw_data is None and idx.requires_two_stage(),
              f"segment {s.segment_id}: the MSTG must re-rank from the host payload")
    dev_bytes = sum(i.memory_bytes for i in idxs)
    log(f"  MSTG (default params, disk mode) built in {build_s:.2f} s: {len(idxs)} segments, "
        f"{idxs[0].n_clusters} clusters each; index device bytes {dev_bytes / 1e9:.2f} GB "
        f"(SQ8 windows) beside {payload / 1e9:.2f} GB of host payload  [{card}]")
    gd, gs, gr = gt.distances, gt.segments, gt.rows
    op = None
    for nprobe in HOST_NPROBES:
        res = t.search("vec", queries, k=K, params={"nprobe": nprobe})
        hits = sum(len(set(zip(res.segments[i].tolist(), res.rows[i].tolist()))
                       & set(zip(gs[i].tolist(), gr[i].tolist()))) for i in range(HOST_NQ))
        rid = hits / (HOST_NQ * K)
        rdist = float((res.distances <= gd[:, K - 1 : K] * (1 + 1e-4) + 1e-3).mean())
        log(f"  disk-mode MSTG nprobe={nprobe}: recall_ids@{K} {rid:.4f}, recall_dist {rdist:.4f}")
        if rid >= HOST_RECALL_TARGET:
            op = (nprobe, rid, rdist, res)
            break
    check(op is not None, f"disk-mode MSTG never reached recall_ids@{K} {HOST_RECALL_TARGET}")
    nprobe, rid, rdist, res = op
    worst = check_host_hits(t, queries, res, f"disk-mode MSTG nprobe={nprobe}")
    rate = qps(lambda qb: t.search("vec", qb, k=K, params={"nprobe": nprobe}), [queries], HOST_NQ)
    log(f"  disk-mode MSTG operating point nprobe={nprobe}: recall_ids@{K} {rid:.4f}, recall_dist "
        f"{rdist:.4f}, QPS {rate:.1f} (batch {HOST_NQ}) = {rate * stream_s / HOST_NQ:.1f}x the "
        f"stream scan; every hit carries its row's f64 score within F32_TOL (largest "
        f"|distance - f64 distance| {worst:.6g})  [{card}]")


def spill_path(ms, dev, sift, sift_batches, card):
    """Phase 12e: phase 3's 1M x 128 corpus into a table whose device
    budget refuses it: the payload spills to the host tier (bf16-rounded),
    searches return phase 3's hits; then an MSTG with disk_mode=1,
    persisted and reloaded."""
    import gc
    import shutil
    import tempfile

    import torch

    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
    from myscaledb_tpu_torch.storage.hbm import GOVERNOR

    corpus = sift.live_segments()[0]._exact_f32["vec"]
    st = ms.Settings()
    st.server.device_payload_budget_bytes = GOVERNOR.tracked_bytes  # nothing more fits
    db = ms.connect(st, device=dev)
    t = db.create_table("spill", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(SIFT_D)}))
    before = GLOBAL_COUNTERS.get("SegmentPayloadsSpilledToHost")
    t0 = time.perf_counter()
    t.insert({"id": np.arange(SIFT_N, dtype=np.uint64), "vec": corpus})
    ins_s = time.perf_counter() - t0
    seg = t.live_segments()[0]
    p = seg.vector("vec")
    check(p.is_host and p.data.dtype == torch.float32
          and p.data.is_pinned() == (dev.type == "cuda") and seg.spilled_columns == {"vec"},
          "the refused payload did not spill to the host tier")
    check(GLOBAL_COUNTERS.get("SegmentPayloadsSpilledToHost") - before == 1,
          "SegmentPayloadsSpilledToHost did not count the spill")
    check(any(r["event"] == "TierSpill" for r in t.event_log.rows()), "no TIER_SPILL event")
    rounded = torch.from_numpy(corpus).to(torch.bfloat16).to(torch.float32)
    check(torch.equal(p.data[:SIFT_N, :SIFT_D], rounded),
          "the spilled payload must hold the bf16-rounded values the device tier scores")
    t.delete(F("id") < 100)  # phase 3's deletes
    flt = F("id") < SIFT_N  # phase 3's table without its 50k-row segment (const-folded away)
    launches = (distance.scores.launches_f32,)
    got = [t.search("vec", qb, k=K, metric="L2") for qb in sift_batches]
    want = [sift.search("vec", qb, k=K, metric="L2", filter=flt) for qb in sift_batches]
    nq, tied, worst = same_hits("spilled table against phase 3's", hits(t, got), hits(sift, want))
    # distances: within the kernel bound (phase 3's bf16 hi/lo scan) plus F32_TOL
    for qb, a, b in zip(sift_batches, got, want):
        x = p.data[torch.from_numpy(a.rows.astype(np.int64).clip(0))][..., :SIFT_D]
        qq = torch.from_numpy(qb)[:, None, :]
        kb = (2 * distance.KERNEL_SUM_TOL * (qq.abs() * x.abs()).sum(-1)).numpy()
        same = (a.rows == b.rows).all(axis=1)
        ok = np.isclose(a.distances[same], b.distances[same], rtol=F32_TOL["rtol"],
                        atol=F32_TOL["atol"]) | (np.abs(a.distances - b.distances)[same]
                                                  <= kb[same] + F32_TOL["atol"])
        check(ok.all(), "a spilled hit's distance lies outside the kernel bound + F32_TOL")
    log(f"  {SIFT_N:,} x {SIFT_D} into a table with no device budget left: spilled to the host "
        f"tier ({p.data.numel() * 4 / 1e9:.3f} GB pinned, bf16-rounded; insert {ins_s:.2f} s), "
        f"SegmentPayloadsSpilledToHost +1, TierSpill logged; {nq} queries return phase 3's hits "
        f"({tied} near-tied; largest |distance difference| {worst:.6g}); "
        f"f32 score launches {distance.scores.launches_f32 - launches[0]} (at k {K} the 128-d "
        f"f32 chunks tie the tile route's byte count and take the full score, as in JAX)  [{card}]")
    # at k = SPILL_TILE_K the prune reads fewer bytes: the f32 tile-max route
    before = tilescan.tile_maxes.launches_f32
    got = [t.search("vec", qb, k=SPILL_TILE_K, metric="L2") for qb in sift_batches]
    want = [sift.search("vec", qb, k=SPILL_TILE_K, metric="L2", filter=flt) for qb in sift_batches]
    n_tile = tilescan.tile_maxes.launches_f32 - before
    check(n_tile == len(sift_batches) * HOST_CAP // STREAM_CHUNK,
          f"k={SPILL_TILE_K} over the spilled table: {n_tile} f32 tile_max launches, expected "
          f"one per {STREAM_CHUNK:,}-row chunk")
    nq, tied, worst = same_hits(f"spilled table at k={SPILL_TILE_K}", hits(t, got), hits(sift, want))
    log(f"  k={SPILL_TILE_K}: the f32 tile_max route, {n_tile} launches ({HOST_CAP // STREAM_CHUNK}"
        f" chunks a search); {nq} queries return phase 3's hits ({tied} near-tied; largest "
        f"|distance difference| {worst:.6g})")

    t.add_vector_index("m", "vec", type="MSTG", disk_mode=1)
    check(t.wait_index_built(), "the spilled table's MSTG build did not end")
    idx = t.loaded_index(0, "vec", Metric.L2)
    check(idx.raw_host is p.data and idx.requires_two_stage(), "the MSTG must re-rank from host")
    live = [t.search("vec", qb, k=K, params={"nprobe": 16}) for qb in sift_batches]
    root = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        t0 = time.perf_counter()
        t.persist(os.path.join(root, "spill"))
        db2 = ms.connect(st, path=root, device=dev)
        tl = db2.load_table("spill")
        back = [tl.search("vec", qb, k=K, params={"nprobe": 16}) for qb in sift_batches]
        rl_s = time.perf_counter() - t0
        check(tl.index_status("m") == {0: IndexStatus.LOADED}, "the reloaded MSTG did not load")
        seg2 = tl.live_segments()[0]
        idx2 = tl.loaded_index(0, "vec", Metric.L2)
        check(seg2.spilled_columns == {"vec"} and idx2.raw_host is seg2.vector("vec").data,
              "the reloaded table must spill again and re-attach raw_host to its payload")
        for a, b in zip(live, back):
            check((a.rows == b.rows).all() and (a.distances == b.distances).all(),
                  "the reloaded disk-mode MSTG returned other hits")
        log(f"  MSTG disk_mode=1 on the spilled table, nprobe 16: persisted and reloaded in "
            f"{rl_s:.2f} s (spilled again, raw_host re-attached); every hit and distance equal "
            f"(recall_ids@{K} against phase 3's exact results "
            f"{ivf_recall_rows(live, want)[0]:.4f})")
        db2.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    db.close()
    del db, t
    gc.collect()


def ivf_recall_rows(results, exact):
    """recall_ids@k of `results` against `exact` (both lists of
    SearchResults of the same queries), by (segment, row)."""
    hit = tot = 0
    for a, b in zip(results, exact):
        for i in range(a.rows.shape[0]):
            hit += len(set(zip(a.segments[i].tolist(), a.rows[i].tolist()))
                       & set(zip(b.segments[i].tolist(), b.rows[i].tolist())))
            tot += b.rows.shape[1]
    return hit / tot, tot


def disk_mode_hbm_path(dev, sift, sift_batches, op, mstg_op, card):
    """Phase 12f: MSTG disk_mode=1 on phase 3's (device-tier) SIFT table:
    its ids at phase 8's operating nprobe against phase 8's MSTG (disk_mode
    0), except for near-ties."""
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric

    t0 = time.perf_counter()
    sift.add_vector_index("mdisk", "vec", type="MSTG", disk_mode=1)
    check(sift.wait_index_built(), "the disk-mode MSTG build did not end")
    build_s = time.perf_counter() - t0
    check(sift.index_status("mdisk") == {0: IndexStatus.LOADED, 1: IndexStatus.SMALL_PART},
          f"disk-mode MSTG did not load: {sift.index_status('mdisk')}")
    idx = sift.loaded_index(0, "vec", Metric.L2)
    check(idx.raw_host is not None and idx.raw_host.is_pinned() == (dev.type == "cuda")
          and idx.raw_data is None
          and idx.requires_two_stage(), "disk_mode=1 must move the re-rank rows to pinned host memory")
    res = [sift.search("vec", qb, k=K, metric="L2", params={"nprobe": op}) for qb in sift_batches]
    nq, tied, worst = same_hits(f"disk-mode MSTG against phase 8's MSTG at nprobe {op}",
                                hits(sift, res), mstg_op)
    log(f"  MSTG disk_mode=1 on phase 3's table: build {build_s:.2f} s, raw_host "
        f"{idx.raw_host.numel() * 4 / 1e9:.3f} GB pinned, index {idx.memory_bytes / 1e9:.4f} GB on "
        f"the card; nprobe {op}: {nq} queries, ids equal phase 8's MSTG (disk_mode 0) but "
        f"{tied} near-tied; largest |distance difference| {worst:.6g}  [{card}]")
    sift.drop_vector_index("mdisk")


def host_hnsw_path(ms, dev, gist_batches, gist_gt, phase6_recall, card):
    """Phase 12g: phase 4's 100,000 x 960 Cosine corpus in a host-tier
    table with HNSWFLAT (m 32, ef_c 100), searched at ef_s 100 (gathermv).
    Like phase 6, its recall_ids@10 is taken against phase 4's exact scan
    of the bf16-stored corpus, the values the graph's re-score reads (the
    device copy of a host payload is bf16, as in the JAX package), and
    must lie within 0.01 of phase 6's; against the stream scan of the f32
    host rows it is logged beside."""
    from myscaledb_tpu_torch.index import hnsw
    from myscaledb_tpu_torch.index.base import IndexStatus
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import gathermv

    st = ms.Settings()
    st.table.vector_storage_tier = "host"
    st.table.float_vector_search_metric_type = "Cosine"
    db = ms.connect(st, device=dev)
    t = db.create_table("ghost", ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(GIST_D)}))
    t.insert({"id": np.arange(GIST_N, dtype=np.uint64), "vec": make_corpus(GIST_N, GIST_D, seed=3)})
    check(t.live_segments()[0].vector("vec").is_host, "the GIST corpus must be in the host tier")
    bf = ms.Settings()
    bf.query.enable_brute_force_vector_search = True
    exact = [t.search("vec", qb, k=K, settings=bf) for qb in gist_batches]
    t0 = time.perf_counter()
    t.add_vector_index("h", "vec", type="HNSWFLAT", metric_type="Cosine", **HNSW_PARAMS)
    check(t.wait_index_built(), "the host-tier HNSWFLAT build did not end")
    build_s = time.perf_counter() - t0
    check(t.index_status("h") == {0: IndexStatus.LOADED}, f"{t.index_status('h')}")
    graph = ms.Settings()
    graph.query.cost_based_index_routing = False
    before = gathermv.gather_block_scores.launches
    res = [t.search("vec", qb, k=K, params={"ef_s": 100}, settings=graph) for qb in gist_batches]
    n_launch = gathermv.gather_block_scores.launches - before
    check(n_launch == hnsw.n_iterations(100) * len(gist_batches),
          f"{n_launch} gathermv launches on the host-tier graph")
    rid, rdist = graph_recall(res, gist_gt)
    rid_f32, _ = ivf_recall_rows(res, exact)
    check(abs(rid - phase6_recall) <= 0.01,
          f"host-tier HNSWFLAT recall_ids@{K} {rid:.4f} is not within 0.01 of phase 6's "
          f"{phase6_recall:.4f}")
    idx = t.loaded_index(0, "vec", Metric.COSINE)
    log(f"  HNSWFLAT over a host-tier payload: build {build_s:.2f} s, index "
        f"{idx.memory_bytes / 1e9:.3f} GB on the card (bf16 rows); ef_s 100: recall_ids@{K} "
        f"{rid:.4f}, recall_dist {rdist:.4f} against phase 4's exact scan (phase 6: "
        f"{phase6_recall:.4f}); recall_ids@{K} {rid_f32:.4f} against the stream scan of the f32 "
        f"host rows; {n_launch} gathermv launches  [{card}]")
    db.close()


def host_tier_path(ms, dev, sift, sift_batches, gist_batches, gist_gt, op, mstg_op,
                   phase6_recall, card):
    """Phase 12: the host tier. Returns the f32 engine's max errors at a
    stream chunk."""
    import gc

    import torch

    log("[12a] the host link")
    link = link_rate(dev, card)
    log(f"[12b] host-tier corpus (bench.py beyond-HBM: up to {HOST_N:,} x {HOST_D} f32, L2, "
        f"vector_storage_tier='host')")
    db, t, queries, segs, payload = host_corpus(ms, dev, card)
    log("[12c] streamed exact scan (copy stream, two device buffers, pinned rows)")
    gt, stream_s, errs = stream_path(ms, dev, t, queries, segs, payload, link, card)
    log("[12d] disk-mode MSTG over the host-tier table")
    disk_mstg_path(dev, t, queries, gt, stream_s, payload, card)
    db.close()
    del db, t, segs, gt
    gc.collect()
    torch.cuda.empty_cache()
    log("[12e] spill: a payload the device budget refuses")
    spill_path(ms, dev, sift, sift_batches, card)
    log("[12f] MSTG disk_mode=1 on phase 3's device-tier table")
    disk_mode_hbm_path(dev, sift, sift_batches, op, mstg_op, card)
    log("[12g] HNSWFLAT over a host-tier table")
    host_hnsw_path(ms, dev, gist_batches, gist_gt, phase6_recall, card)
    return errs


# ---------------------------------------------------------------- phase 13
def numpy_exact(corpus, queries, k, metric):
    """The exact top-k of an f64 numpy scan of the f32 rows: ids and
    max-is-better scores as the engine reports them (L2: 2 q.x - |x|^2,
    Cosine: q/|q| . x/|x|), ORACLE_CHUNK rows at a time."""
    q = queries.astype(np.float64)
    if metric == "Cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    best_s = np.full((len(q), k), -np.inf)
    best_i = np.zeros((len(q), k), np.int64)
    for i0 in range(0, len(corpus), ORACLE_CHUNK):
        x = corpus[i0 : i0 + ORACLE_CHUNK].astype(np.float64)
        s = q @ x.T
        if metric == "L2":
            s = 2.0 * s - (x * x).sum(1)[None, :]
        else:
            s = s / np.linalg.norm(x, axis=1)[None, :]
        s = np.concatenate([best_s, s], axis=1)
        ids = np.concatenate([best_i, np.broadcast_to(np.arange(i0, i0 + len(x)), s[:, k:].shape)],
                             axis=1)
        top = np.argpartition(-s, k - 1, axis=1)[:, :k]
        best_s = np.take_along_axis(s, top, 1)
        best_i = np.take_along_axis(ids, top, 1)
    order = np.argsort(-best_s, axis=1)
    return np.take_along_axis(best_i, order, 1), np.take_along_axis(best_s, order, 1)


def check_ids(label, t, results, oracle, tol):
    """recall@k = 1.0 against `oracle` (ids, scores) under section 2's
    near-tie rule: a query whose ids differ passes only if its sorted
    scores agree with the oracle's within `tol`."""
    ids = np.concatenate([t.gather(r, ["id"])["id"] for r in results]).astype(np.int64)
    vals = np.concatenate([r.scores for r in results]).astype(np.float64)
    oi, os_ = oracle
    tied = 0
    for i in range(len(oi)):
        if set(ids[i].tolist()) != set(oi[i].tolist()):
            check(np.allclose(np.sort(vals[i]), np.sort(os_[i]), **tol),
                  f"{label}: query {i} differs from the exact top-{K}")
            tied += 1
    log(f"  {label}: recall@{K} = 1.0 against an f64 numpy scan of the f32 rows "
        f"({len(oi)} queries, {tied} differ only by near-tied scores)")


def f32_table_path(ms, dev, card, out_dir):
    """Phase 13: exact search over two device-resident f32 tables
    (storage_dtype="float32"): phase 3's SIFT corpus (1,000,000 + 50,000 x
    128, L2, batch 100: tile_max's f32 engine on the 1M segment, score's
    on the 50k one) and phase 4's GIST corpus (100,000 x 960, Cosine,
    batch 256: score's f32 engine). Each: recall@10 = 1.0 against an f64
    numpy scan (near-tie rule), the f32 launches a search, then
    profile_cells (one-pass QPS over F32_TABLE_RUNS passes, device ms and
    kernels a search from torch.profiler). Returns the launch counts."""
    import torch

    from myscaledb_tpu_torch.ops import distance, tilescan

    wrappers = (distance.scores, tilescan.tile_maxes)
    for w in wrappers:
        w.launches = w.launches_f32 = 0
    tilescan.tile_rescore.launches = 0
    cells, dbs = [], []
    for label, n, d, metric, batch in (("sift_f32", SIFT_N, SIFT_D, "L2", SIFT_BATCH),
                                       ("gist_f32", GIST_N, GIST_D, "Cosine", GIST_BATCH)):
        st = ms.Settings()
        st.table.storage_dtype = "float32"
        st.table.float_vector_search_metric_type = metric
        db = ms.connect(st, device=dev)
        dbs.append(db)
        t = db.create_table(label, ms.Schema({"id": ms.UInt64(), "vec": ms.FloatVector(d)}))
        t0 = time.perf_counter()
        if label == "sift_f32":  # phase 3's corpus and queries
            corpus = np.concatenate([make_corpus(n, d, seed=0), make_corpus(
                SIFT_SMALL_N, d, seed=1, centers=corpus_centers(d))])
            qrng, nq = np.random.default_rng(1), SIFT_NQ
        else:  # phase 4's
            corpus = make_corpus(n, d, seed=3)
            qrng, nq = np.random.default_rng(4), GIST_NQ
        qidx = qrng.choice(n, nq, replace=False)
        queries = (corpus[qidx] + 0.3 * qrng.standard_normal((nq, d))).astype(np.float32)
        for i0, i1 in ((0, n), (n, len(corpus))) if label == "sift_f32" else ((0, n),):
            t.insert({"id": np.arange(i0, i1, dtype=np.uint64), "vec": corpus[i0:i1]})
        sync(dev)
        segs = t.live_segments()
        check(all(s.vector("vec").data.dtype == torch.float32
                  and s.vector("vec").data.device.type == dev.type for s in segs),
              f"{label}: the payload must be f32 on the device")
        batches = [queries[i : i + batch] for i in range(0, nq, batch)]
        before = [w.launches_f32 for w in wrappers]
        res = [t.search("vec", qb, k=K, metric=metric) for qb in batches]
        n_score, n_tile = (w.launches_f32 - b for w, b in zip(wrappers, before))
        want = (len(batches), len(batches)) if label == "sift_f32" else (len(batches), 0)
        check((n_score, n_tile) == want,
              f"{label}: f32 launches score {n_score}, tile_max {n_tile}; expected {want}")
        t1 = time.perf_counter()
        check_ids(label, t, res, numpy_exact(corpus, queries, K, metric), F32_TOL)
        log(f"  {label}: {len(corpus):,} x {d} f32 on the card in {[(s.n_rows, s.capacity) for s in segs]}"
            f"; {n_score / len(batches):.0f} f32 score and {n_tile / len(batches):.0f} f32 tile_max "
            f"launches a search (batch {batch}); set-up and first pass {t1 - t0:.1f} s, oracle "
            f"{time.perf_counter() - t1:.1f} s")
        cells.append((label, (lambda tt, m: lambda qb: tt.search("vec", qb, k=K, metric=m))(
            t, metric), batches))
        del corpus
    log(f"  where the time goes on {card}:")
    profile_cells(cells, F32_TABLE_RUNS, out_dir, card)
    counts = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
              "tile_rescore": tilescan.tile_rescore.launches,
              "score_f32": distance.scores.launches_f32,
              "tile_max_f32": tilescan.tile_maxes.launches_f32}
    for db in dbs:
        db.close()
    return counts


# --------------------------------------------------------------- phase 14
def vec_literal(v):
    """A query vector as SQL text; each float32 reads back exactly."""
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def id_map(t):
    """segment id -> the segment's id column."""
    return {s.segment_id: np.asarray(s.scalar("id")) for s in t.live_segments()}


def hit_ids(idmap, segs, rows):
    """The id column at (segment, row) pairs; -1 where there is no hit."""
    segs, rows = np.asarray(segs), np.asarray(rows)
    out = np.full(rows.shape, -1, np.int64)
    for sid, ids in idmap.items():
        m = (segs == sid) & (rows >= 0)
        out[m] = ids[rows[m]]
    return out


def l2_scores(queries, dists):
    """L2 distances of `queries`' hits in score units (the exact scan's
    2 q.x - |x|^2 = |q|^2 - distance), where check_recall holds them."""
    q = np.asarray(queries, np.float64)
    return np.einsum("ij,ij->i", q, q)[:, None] - np.asarray(dists, np.float64)


def check_oracle(label, ids, scores, want_ids, want_scores, tol=F32_TOL):
    """check_recall's rule over arrays: each row holds the exact oracle's
    ids, or, where the id sets differ, sorted scores within `tol` of the
    oracle's (a near-tie resolved the other way); every row's sorted scores
    lie within `tol` of the oracle's. Returns the near-tied rows."""
    ids, scores = np.asarray(ids), np.asarray(scores, np.float64)
    check(ids.shape == want_ids.shape and (ids >= 0).all(),
          f"{label}: {ids.shape} hits (some missing) where the oracle has {want_ids.shape}")
    same = (np.sort(ids, 1) == np.sort(want_ids, 1)).all(1)
    close = np.isclose(np.sort(scores, 1), np.sort(want_scores, 1), **tol).all(1)
    bad = np.nonzero(~close)[0]
    check(not bad.size, f"{label}: {bad.size} rows differ from the exact top-{ids.shape[1]} "
                        f"(first: row {bad[:1].tolist()})")
    return int((~same).sum())


def timed_search(t):
    """Wrap `t.search` on the instance: each call's seconds, its result's
    host copy included, go to the returned list (unwrap with `del t.search`)."""
    spent = []
    orig = t.search

    def search(*a, **kw):
        t0 = time.perf_counter()
        res = orig(*a, **kw)
        res.rows  # the host copy: the search's device work ends here
        spent.append(time.perf_counter() - t0)
        return res

    t.search = search
    return spent


def host_syncs(fn, here):
    """Run `fn` with torch's sync debug mode on "warn": the host syncs it
    makes, as {file:line (function): count} of the innermost frame of the
    package on the stack at each warning. Returns (fn's result, the sites)."""
    import traceback
    import warnings

    import torch

    pkg = os.path.join(here, "myscaledb_tpu_torch")
    sites = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if os.path.basename(f.filename) != "warnings.py"]
        # the package's innermost frame, else the innermost one outside torch
        frames = ([f for f in stack if f.filename.startswith(pkg)]
                  or [f for f in stack if os.sep + "torch" + os.sep not in f.filename])
        f = frames[-1]
        if f.name == "host_syncs":  # set_sync_debug_mode's own first call
            return
        key = f"{os.path.relpath(f.filename, here)}:{f.lineno} ({f.name}; torch at {filename}:{lineno})"
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def parse_seconds(parser, statement, runs=3):
    """Median seconds of `runs` parses of `statement` (host only)."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        parser.parse(statement)
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def sql_exact_path(db, t, queries, oracle, card):
    """14a: distance() and batch_distance() SELECTs on phase 3's table,
    against the exact oracle and against Table.search; EXPLAIN; the host
    time of a statement outside its search."""
    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.sql import parser

    qs = queries[:SQL_NQ]
    want_ids, want_s = oracle[0][:SQL_NQ], oracle[1][:SQL_NQ]
    stmts = [f"SELECT id, distance(vec, {vec_literal(q)}) AS d FROM {t.name} "
             f"ORDER BY d LIMIT {K}" for q in qs]
    db.sql(stmts[0])  # warm
    spent = timed_search(t)
    try:
        ids = np.zeros((SQL_NQ, K), np.int64)
        dists = np.zeros((SQL_NQ, K))
        stmt_s, search_s = [], []
        for i, st in enumerate(stmts):
            spent.clear()
            t0 = time.perf_counter()
            rows = db.sql(st)
            stmt_s.append(time.perf_counter() - t0)
            check(len(rows) == K and len(spent) == 1,
                  f"statement {i}: {len(rows)} rows, {len(spent)} searches")
            search_s.append(spent[0])
            ids[i] = [r["id"] for r in rows]
            dists[i] = [r["d"] for r in rows]
        check((np.diff(dists, axis=1) >= 0).all(), "SQL L2 distances must be ascending")
        tied = check_oracle("SQL distance()", ids, l2_scores(qs, dists), want_ids, want_s)
        parse_s = [parse_seconds(parser, st) for st in stmts[:20]]
        one = (1e3 * np.median(stmt_s), 1e3 * np.median(search_s),
               1e3 * np.median(np.subtract(stmt_s, search_s)), 1e3 * np.median(parse_s))
        log(f"  {SQL_NQ} distance() statements of one query ({len(stmts[0]):,} characters): every "
            f"statement's ids are the exact oracle's ({tied} near-tied), scores within "
            f"F32_TOL; median host ms: statement {one[0]:.3f}, its Table.search (host copy "
            f"included) {one[1]:.3f}, outside the search {one[2]:.3f} (parse alone "
            f"{one[3]:.3f}, median of 3 parses)  [{card}]")

        def batch_stmt(where):
            return (f"SELECT id, batch_distance(vec, [{', '.join(vec_literal(q) for q in qs)}]) "
                    f"AS d FROM {t.name}{where} ORDER BY d.2 LIMIT {K} BY d.1")

        for where, flt in (("", None), (" WHERE id < 10000", F("id") < 10_000)):
            st = batch_stmt(where)
            db.sql(st)  # warm
            spent.clear()
            t0 = time.perf_counter()
            rows = db.sql(st)
            stmt_ms = 1e3 * (time.perf_counter() - t0)
            parse_ms = 1e3 * parse_seconds(parser, st)
            check(len(spent) == 1 and len(rows) == SQL_NQ * K,
                  f"batch_distance{where}: {len(rows)} rows, {len(spent)} searches")
            ref = t.search("vec", qs, k=K, filter=flt)
            ref_ids = t.gather(ref, ["id"])["id"]
            got = {}
            for r in rows:
                got.setdefault(r["d"][0], []).append((r["d"][1], r["id"]))
            for i in range(SQL_NQ):
                want = sorted((float(ref.distances[i, j]), int(ref_ids[i, j])) for j in range(K))
                check(sorted(got.get(i, [])) == want,
                      f"batch_distance{where}: query {i} differs from Table.search of the batch")
            if flt is not None:
                check(all(r["id"] < 10_000 for r in rows), "a batch_distance hit fails id < 10000")
            log(f"  batch_distance{where} over the same {SQL_NQ} queries ({len(st):,} characters): "
                f"ids and distances equal Table.search of the batch exactly"
                f"{'; every hit passes id < 10000' if flt is not None else ''}; host ms: "
                f"statement {stmt_ms:.3f}, its Table.search {1e3 * spent[0]:.3f}, outside the "
                f"search {stmt_ms - 1e3 * spent[0]:.3f} (parse alone {parse_ms:.3f}, median of 3)  "
                f"[{card}]")
    finally:
        del t.search
    plan = [r["explain"] for r in db.sql("EXPLAIN " + stmts[0])]
    routed = {int(ln.split()[1].rstrip(":")) for ln in plan if ln.strip().startswith("segment ")}
    check(routed == {s.segment_id for s in t.live_segments()},
          f"EXPLAIN names segments {routed}: {plan}")
    log(f"  EXPLAIN: {' | '.join(ln.strip() for ln in plan)}")


def sql_text_path(db, t, vb, tb, card):
    """14b: textsearch() and hybridsearch('fusion_type=rrf') SELECTs on
    phase 9's table against Table.text_search / hybrid_search."""
    for i in range(SQL_TEXT_NQ):
        qv, qt = vb[0][i], tb[0][i]
        for kind in ("text", "hybrid"):
            if kind == "text":
                rows = db.sql(f"SELECT id, textsearch(body, '{qt}') AS s FROM {t.name} "
                              f"ORDER BY s DESC LIMIT {K}")
                ref = t.text_search("body", qt, k=K)
            else:
                rows = db.sql(f"SELECT id, hybridsearch('fusion_type=rrf')(vec, body, "
                              f"{vec_literal(qv)}, '{qt}') AS s FROM {t.name} "
                              f"ORDER BY s DESC LIMIT {K}")
                ref = t.hybrid_search("vec", "body", qv[None], [qt], k=K, fusion_type="rrf")
            ref_ids = t.gather(ref, ["id"])["id"]
            want = [(int(ref_ids[0, j]), float(ref.distances[0, j]))
                    for j in range(K) if ref.valid[0, j]]
            check([(r["id"], r["s"]) for r in rows] == want,
                  f"SQL {kind} query {i} {qt!r} differs from the Table call")
    log(f"  {SQL_TEXT_NQ} textsearch() and {SQL_TEXT_NQ} hybridsearch('fusion_type=rrf') "
        f"statements: ids and scores equal Table.text_search / hybrid_search exactly  [{card}]")


def sql_index_path(db, t, queries, card):
    """14c: an HNSWFLAT index made by ALTER TABLE on phase 4's table;
    distance('ef_s=100') SELECTs with cost routing off equal
    Table.search(params={"ef_s": 100}) with it off (and launch gathermv),
    with routing on they equal the routed Table.search."""
    from myscaledb_tpu_torch.index import hnsw
    from myscaledb_tpu_torch.ops import gathermv
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    t0 = time.perf_counter()
    db.sql(f"ALTER TABLE {t.name} ADD VECTOR INDEX h14 vec TYPE HNSWFLAT("
           f"'metric_type=Cosine', 'm={HNSW_PARAMS['m']}', 'ef_c={HNSW_PARAMS['ef_c']}')")
    check(t.wait_index_built(), "the HNSWFLAT build (ALTER TABLE) did not end")
    build_s = time.perf_counter() - t0
    graph = t.settings.override({"cost_based_index_routing": False})
    base = "SELECT id, distance('ef_s=100')(vec, {}) AS d FROM " + t.name + f" ORDER BY d LIMIT {K}"
    n_launch, routed = 0, 0
    for i, q in enumerate(queries[:SQL_HNSW_NQ]):
        for off in (True, False):
            st = base.format(vec_literal(q)) + (" SETTINGS cost_based_index_routing=0" if off else "")
            g0 = gathermv.gather_block_scores.launches
            r0 = GLOBAL_COUNTERS.get("VectorIndexCostRouteToScan")
            rows = db.sql(st)
            if off:
                n = gathermv.gather_block_scores.launches - g0
                check(n == hnsw.n_iterations(100),
                      f"statement {i}: {n} gathermv launches, expected {hnsw.n_iterations(100)}")
                n_launch += n
                ref = t.search("vec", q[None], k=K, params={"ef_s": 100}, settings=graph)
            else:
                routed += GLOBAL_COUNTERS.get("VectorIndexCostRouteToScan") - r0
                ref = t.search("vec", q[None], k=K, params={"ef_s": 100})
            ref_ids = t.gather(ref, ["id"])["id"]
            want = [(int(ref_ids[0, j]), float(ref.distances[0, j]))
                    for j in range(K) if ref.valid[0, j]]
            check([(r["id"], r["d"]) for r in rows] == want,
                  f"HNSW SQL statement {i} (routing {'off' if off else 'on'}) differs from "
                  f"Table.search")
    plans = {}
    for off in (False, True):
        st = "EXPLAIN " + base.format(vec_literal(queries[0]))
        st += " SETTINGS cost_based_index_routing=0" if off else ""
        plans[off] = " | ".join(r["explain"].strip() for r in db.sql(st) if "segment" in r["explain"])
    check("HNSWFLAT search" in plans[True], f"EXPLAIN with routing off: {plans[True]}")
    db.sql(f"ALTER TABLE {t.name} DROP VECTOR INDEX h14")
    log(f"  ALTER TABLE ADD VECTOR INDEX HNSWFLAT built in {build_s:.2f} s; {SQL_HNSW_NQ} "
        f"distance('ef_s=100') statements with cost routing off equal Table.search exactly "
        f"({n_launch} gathermv launches, {hnsw.n_iterations(100)} a statement), and with it on "
        f"({routed} of {SQL_HNSW_NQ} routed to the exact scan); EXPLAIN: routing on '{plans[False]}', "
        f"off '{plans[True]}'  [{card}]")


class GroupClock:
    """A SearchServer's dispatch and resolve steps, wrapped on the instance
    (the server's code runs as it is): per group, its seconds on the
    dispatcher thread and its seconds from dispatch to resolution."""

    def __init__(self, srv):
        self.execute, self.finish = srv._execute_group, srv._finish_group
        self.started, self.groups = {}, []
        srv._execute_group, srv._finish_group = self._execute, self._finish

    def _execute(self, batch):
        t0 = time.perf_counter()
        out = self.execute(batch)
        self.started[id(batch)] = (t0, time.perf_counter())
        return out

    def _finish(self, batch, t, res):
        try:
            self.finish(batch, t, res)
        finally:
            t2 = time.perf_counter()
            t0, t1 = self.started.pop(id(batch))
            self.groups.append((t1 - t0, t2 - t0))


def serving_grid(srv, clock, table, queries, conns, mode, seconds=None):
    """bench.py's serving protocol (:622-694) for `seconds` (by default
    SERVER_SECONDS): `conns`
    threads, each blocking on one request at a time ("sync") or keeping
    SERVER_WINDOW submits outstanding ("async"). Returns (QPS, [(query
    index, response)], groups, requests, group seconds)."""
    import threading
    from collections import deque

    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    nq = len(queries)
    got = [[] for _ in range(conns)]
    errs = []
    b0, r0 = GLOBAL_COUNTERS.get("ServerBatches"), GLOBAL_COUNTERS.get("ServerRequests")
    clock.groups = []
    stop_at = time.perf_counter() + (SERVER_SECONDS if seconds is None else seconds)

    def client(w):
        try:
            i = w
            if mode == "sync":
                while time.perf_counter() < stop_at:
                    got[w].append((i % nq, srv.search(table, "vec", queries[i % nq], K)))
                    i += conns
                return
            pend = deque()
            while time.perf_counter() < stop_at:
                pend.append((i % nq, srv.submit_search(table, "vec", queries[i % nq], K)))
                if len(pend) >= SERVER_WINDOW:
                    qi, f = pend.popleft()
                    got[w].append((qi, f.result()))
                i += conns
            while pend:
                qi, f = pend.popleft()
                got[w].append((qi, f.result()))
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(w,)) for w in range(conns)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    secs = time.perf_counter() - t0
    check(not errs, f"{mode} grid at {conns} connections: {errs[:1]}")
    out = [x for g in got for x in g]
    return (len(out) / secs, out, GLOBAL_COUNTERS.get("ServerBatches") - b0,
            GLOBAL_COUNTERS.get("ServerRequests") - r0, list(clock.groups))


def serving_path(db, t, queries, oracle, here, card):
    """14d: the coalescing SearchServer on phase 3's table: the host syncs
    of one search, then bench.py's sync and async connection grids with
    every response checked against the exact oracle."""
    from myscaledb_tpu_torch.service.server import SearchServer

    for nq in (1, 64):
        res, s_search = host_syncs(lambda: t.search("vec", queries[:nq], k=K), here)
        _, s_copy = host_syncs(lambda: res.rows, here)
        log(f"  host syncs of one search at Q {nq} (torch.cuda.set_sync_debug_mode 'warn'): "
            f"{sum(s_search.values())} inside Table.search (the dispatcher's part) at "
            f"{s_search or 'no site'}; {sum(s_copy.values())} in the result's host copy (the "
            f"resolver's part) at {s_copy or 'no site'}")
    idmap = id_map(t)
    srv = SearchServer(db, max_batch=256, max_delay_ms=2.0)
    clock = GroupClock(srv)
    grid = {}
    try:
        for b in (1, 8, 32, 64, 128, 256):  # warm every group size the grid makes
            for f in [srv.submit_search(t.name, "vec", queries[i % len(queries)], K)
                      for i in range(b)]:
                f.result()
        log(f"  SearchServer(max_batch=256, max_delay_ms=2.0) on {t.name!r}, bench.py's grid "
            f"(sec_serving) with each point's window cut from 4 s to {SERVER_SECONDS:g} s to "
            f"keep this script's time; async window {SERVER_WINDOW}")
        for mode in ("sync", "async"):
            for conns in SERVER_CONNS:
                rate, out, groups, reqs, gsec = serving_grid(srv, clock, t.name, queries, conns, mode)
                qi = np.array([q for q, _ in out])
                rows = np.stack([o["rows"] for _, o in out])
                segs = np.stack([o["segments"] for _, o in out])
                dists = np.stack([o["distances"] for _, o in out])
                tied = check_oracle(f"server {mode} {conns}", hit_ids(idmap, segs, rows),
                                    l2_scores(queries[qi], dists), oracle[0][qi], oracle[1][qi])
                disp = 1e3 * np.median([g[0] for g in gsec])
                resolve = 1e3 * np.median([g[1] for g in gsec])
                grid[(mode, conns)] = rate
                log(f"  {mode} {conns:>2} connections: QPS {rate:.1f}; {groups} groups, mean "
                    f"group {reqs / max(groups, 1):.2f} requests; median ms a group: on the "
                    f"dispatcher {disp:.3f}, dispatch to resolution {resolve:.3f} (share "
                    f"{disp / resolve:.3f}); {len(out)} responses equal the exact oracle "
                    f"({tied} near-tied)  [{card}]")
        log("[18g] the same server, graph replays against eager bodies in turns")
        program_serving(srv, clock, t, queries, oracle, card)
    finally:
        srv.close()
    a32, a64 = grid[("async", 32)], grid[("async", 64)]
    log(f"  async grid at 64 connections {a64:.1f} QPS against {a32:.1f} at 32: "
        f"{'falls below' if a64 < a32 else 'does not fall below'} it ({a64 / a32:.3f}x)  [{card}]")


def post(port, path, payload=None):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def cli(here, *args, **env):
    """`python3 -m myscaledb_tpu_torch.cli ARGS` from the checkout, as a
    subprocess (its CompletedProcess)."""
    path = os.pathsep.join([here] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-m", "myscaledb_tpu_torch.cli", *args], cwd=here,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": path, **env})
    return out


def http_cli_path(db, sift, hyb, queries, vb, tb, here, card):
    """14e: HttpFrontend on 127.0.0.1 (port 0) over phase 3's database:
    each endpoint's reply against the in-process call; then the CLI as
    subprocesses, remote against the frontend and local on the card."""
    from myscaledb_tpu_torch.service.server import HttpFrontend

    front = HttpFrontend(db, host="127.0.0.1", port=0, max_batch=256, max_delay_ms=2.0)
    try:
        check(post(front.port, "/ping") == {"ok": True}, "GET /ping")
        out = post(front.port, "/search", {"table": sift.name, "column": "vec",
                                           "vector": queries[0].tolist(), "k": K, "gather": ["id"]})
        ref = sift.search("vec", queries[:1], k=K)
        ref_ids = sift.gather(ref, ["id"])["id"][0].tolist()
        check(out["rows"] == ref.rows[0].tolist() and out["segments"] == ref.segments[0].tolist()
              and out["distances"] == ref.distances[0].tolist() and out["columns"]["id"] == ref_ids,
              "POST /search (one vector, gather id) differs from Table.search")
        nb = SQL_NQ
        out = post(front.port, "/search", {"table": sift.name, "column": "vec",
                                           "vectors": queries[:nb].tolist(), "k": K})
        check(len(out["results"]) == nb, "POST /search with vectors: result count")
        ref = sift.search("vec", queries[:nb], k=K)
        ids = hit_ids(id_map(sift), [r["segments"] for r in out["results"]],
                      [r["rows"] for r in out["results"]])
        want = sift.gather(ref, ["id"])["id"].astype(np.int64)
        tied = check_oracle("POST /search (vectors)", ids,
                            l2_scores(queries[:nb], [r["distances"] for r in out["results"]]),
                            want, l2_scores(queries[:nb], ref.distances))
        exact = sum(r["distances"] == ref.distances[i].tolist() for i, r in enumerate(out["results"]))
        out = post(front.port, "/text_search", {"table": hyb.name, "index": "body",
                                                "query": tb[0][0], "k": K})
        ref = hyb.text_search("body", tb[0][0], k=K)
        v = ref.valid[0]
        check(out["rows"] == ref.rows[0][v].tolist() and out["distances"] == ref.distances[0][v].tolist(),
              "POST /text_search differs from Table.text_search")
        out = post(front.port, "/hybrid_search", {
            "table": hyb.name, "vector_column": "vec", "text_column": "body",
            "vector": vb[0][0].tolist(), "text_query": tb[0][0], "k": K, "fusion_type": "rrf"})
        ref = hyb.hybrid_search("vec", "body", vb[0][:1], tb[0][:1], k=K, fusion_type="rrf")
        v = ref.valid[0]
        check(out["rows"] == ref.rows[0][v].tolist() and out["distances"] == ref.distances[0][v].tolist(),
              "POST /hybrid_search differs from Table.hybrid_search")
        live = int(sift.n_rows)
        count_st = f"SELECT count() FROM {sift.name}"
        check(post(front.port, "/sql", {"query": count_st})["rows"] == [{"count()": live}]
              == db.sql(count_st), "POST /sql differs from db.sql")
        st = f"SELECT id, distance(vec, {vec_literal(queries[1])}) AS d FROM {sift.name} ORDER BY d LIMIT {K}"
        check(post(front.port, "/sql", {"query": st})["rows"] == db.sql(st),
              "POST /sql (distance) differs from db.sql")
        log(f"  HttpFrontend: GET /ping; POST /search (one vector with gather, equal to Table.search "
            f"exactly; {nb} vectors in one request: ids equal ({tied} near-tied), {exact} of {nb} "
            f"bit-equal, the rest's scores within F32_TOL); /text_search, /hybrid_search and /sql equal the "
            f"in-process calls  [{card}]")
        t0 = time.perf_counter()
        out = cli(here, "--host", "127.0.0.1", "--port", str(front.port), "-q", count_st,
                  "--format", "JSONEachRow")
        check(out.returncode == 0, f"the remote CLI failed: {out.stderr[-2000:]}")
        check(json.loads(out.stdout.strip()) == {"count()": live},
              f"the remote CLI's count {out.stdout!r} is not the live {live}")
        remote_s = time.perf_counter() - t0
    finally:
        front.close()
    rng = np.random.default_rng(14)
    x = rng.standard_normal((CLI_ROWS, CLI_D)).astype(np.float32)
    q = (x[7] + 0.05 * rng.standard_normal(CLI_D)).astype(np.float32)
    import torch

    xs = torch.from_numpy(x).bfloat16().double().numpy()  # the stored (bf16) rows
    d_ref = ((xs - q.astype(np.float64)) ** 2).sum(1)
    order = np.argsort(d_ref, kind="stable")[:5]
    stmts = [f"CREATE TABLE cli_t (id UInt64, vec Array(Float32), CONSTRAINT c CHECK "
             f"length(vec) = {CLI_D})",
             "INSERT INTO cli_t VALUES " + ", ".join(f"({i}, {vec_literal(v)})" for i, v in enumerate(x)),
             f"SELECT id, distance(vec, {vec_literal(q)}) AS d FROM cli_t ORDER BY d LIMIT 5"]
    t0 = time.perf_counter()
    out = cli(here, *[a for st in stmts for a in ("-q", st)], "--format", "JSONEachRow")
    local_s = time.perf_counter() - t0
    check(out.returncode == 0, f"the local CLI failed: {out.stderr[-2000:]}")
    rows = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    check(len(rows) == 5, f"the local CLI returned {rows}")
    check_oracle("local CLI", np.array([[r["id"] for r in rows]]),
                 l2_scores(q[None], [[r["d"] for r in rows]]), order[None].astype(np.int64),
                 l2_scores(q[None], d_ref[order][None]))
    out = cli(here, "-q", "SELECT 1", CUDA_VISIBLE_DEVICES="")
    check(out.returncode != 0 and not out.stdout.strip()
          and "torch.cuda.is_available() is False" in out.stderr,
          f"the local CLI without a visible card must raise: {out.returncode} {out.stderr[-500:]}")
    log(f"  CLI: remote -q 'SELECT count()' = {live} (the live rows) in {remote_s:.2f} s; local "
        f"(default device, the card) CREATE / INSERT {CLI_ROWS} x {CLI_D} / distance() top-5 equal "
        f"to an f64 scan of the stored rows, in {local_s:.2f} s; without a visible card the local "
        f"session raises  [{card}]")


def frontend_path(ms, here, card, sift_db, sift, sift_queries, gist_db, gist, gist_queries,
                  hyb, vb, tb):
    """Phase 14: the front ends on the card: SQL on phase 3's, phase 4's
    and phase 9's tables, the coalescing server, HTTP and the CLI."""
    from myscaledb_tpu_torch.metrics import Metric

    gv, gs, gr = exact_topk(sift, "vec", sift_queries, K, Metric.L2)
    oracle = (hit_ids(id_map(sift), gs, gr), gv.astype(np.float64))  # ids, exact scores
    log(f"[14a] SQL exact search on phase 3's table (L2, k={K})")
    sql_exact_path(sift_db, sift, sift_queries, oracle, card)
    log("[14b] SQL text and hybrid search on phase 9's table")
    sql_text_path(sift_db, hyb, vb, tb, card)
    log(f"[14c] SQL through an HNSWFLAT index on phase 4's table ({HNSW_PARAMS}, Cosine)")
    sql_index_path(gist_db, gist, gist_queries, card)
    log(f"[14d] the coalescing server on phase 3's table (connections {SERVER_CONNS})")
    serving_path(sift_db, sift, sift_queries, oracle, here, card)
    log("[14e] HttpFrontend and the CLI")
    http_cli_path(sift_db, sift, hyb, sift_queries, vb, tb, here, card)


# --------------------------------------------------------------- phase 15
def wait_until(cond, what, timeout=REP_WAIT_S):
    """Poll `cond` until it holds; fail after `timeout` seconds."""
    deadline = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < deadline, f"{what}: not within {timeout} s")
        time.sleep(0.02)


def stored_corpus(t):
    """(ids, f32 rows) of each segment of a bf16 table: the stored values,
    which a replica's insert stores again unchanged."""
    import torch

    return [(s.scalar("id")[: s.n_rows].copy(),
             s.vector("vec").data[: s.n_rows, :SIFT_D].to(torch.float32).cpu().numpy())
            for s in t.live_segments()]


def data_replication_path(ms, dev, sift, queries, card, root):
    """15a: two ReplicatedNodes on 127.0.0.1 in this process, A and B, each
    over its own Database on the card. A inserts phase 3's corpus (timed
    with and without the commit listener), B pulls it (timed, over
    loopback), then B's sync thread applies A's deletes, UPDATE and a
    leader merge of two 500,000-row parts; B's searches are held to the
    exact oracle and to A's hits after each step."""
    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.service.data_replication import ReplicatedNode

    parts = stored_corpus(sift)  # phase 3's 1,000,000 + 50,000 rows
    check([len(i) for i, _ in parts] == [SIFT_N, SIFT_SMALL_N], "phase 3's segments changed")
    schema = lambda: ms.Schema({"id": ms.UInt64(), "tag": ms.Int32(),
                                "vec": ms.FloatVector(SIFT_D)})
    cols = [{"id": i, "tag": (i % 3 + 2).astype(np.int32), "vec": v} for i, v in parts]
    batches = [queries[i : i + SIFT_BATCH] for i in range(0, SIFT_NQ, SIFT_BATCH)]
    search = lambda t, flt=None: [t.search("vec", qb, k=K, metric="L2", filter=flt)
                                  for qb in batches]
    dbs = [ms.connect(device=dev) for _ in range(2)]
    a = ReplicatedNode(dbs[0], "a", os.path.join(root, "a"))
    b = ReplicatedNode(dbs[1], "b", os.path.join(root, "b"))
    a.peers, b.peers = [b.url], [a.url]
    try:
        plain = dbs[0].create_table("plain", schema())
        t0 = time.perf_counter()
        for c in cols:
            plain.insert(c)
        sync(dev)
        t_plain = time.perf_counter() - t0
        dbs[0].drop_table("plain")
        del plain
        ta, tb = (db.create_table("rep", schema()) for db in dbs)
        a.attach(ta)
        b.attach(tb)
        t0 = time.perf_counter()
        for c in cols:
            ta.insert(c)
        sync(dev)
        t_listen = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_ops = b.sync()
        sync(dev)
        t_sync = time.perf_counter() - t0
        fetched = tree_bytes(os.path.join(b.root, "repdata"))
        check(n_ops == 2 and tb.n_rows == ta.n_rows == SIFT_N + SIFT_SMALL_N,
              f"B applied {n_ops} ops, {tb.n_rows} rows")
        log(f"  A's insert of {SIFT_N:,} + {SIFT_SMALL_N:,} rows: {t_plain:.2f} s without the "
            f"commit listener, {t_listen:.2f} s with it (each segment persisted for the peers); "
            f"B's sync {t_sync:.2f} s for {fetched / 1e6:.1f} MB over loopback "
            f"({fetched / 1e6 / t_sync:.1f} MB/s, fetch, sha256, load and insert)  [{card}]")
        res_b = search(tb)
        check_recall("replica B", res_b, exact_topk(tb, "vec", queries, K, Metric.L2), F32_TOL)
        nq, tied, worst = same_hits("B against A", hits(tb, res_b),
                                    hits(ta, search(ta)))
        log(f"  B's {nq} queries return A's ids ({tied} near-tied; largest |distance difference| "
            f"{worst:g})")

        # the rest through B's sync thread (on the card: Database.on_device)
        b.start_sync(REP_SYNC_INTERVAL_S)
        applied = lambda tname: lambda: (b._applied.get(a.url, {}).get(tname, 0)
                                         == len(a._log[tname]))
        check(ta.delete(F("id") < 100) == 100, "delete removed another count of rows")
        wait_until(applied("rep"), "B applying A's deletes")
        check(tb.n_rows == ta.n_rows == SIFT_N + SIFT_SMALL_N - 100, f"B holds {tb.n_rows} rows")
        res_b = search(tb)
        check((hits(tb, res_b)[0] >= 100).all(), "a row deleted on A came back on B")
        check_recall("replica B after A's deletes", res_b,
                     exact_topk(tb, "vec", queries, K, Metric.L2), F32_TOL)
        # fill B's device mirror of `tag`, its min/max and the filter-mask
        # cache at the current generation; the UPDATE must replace them
        two = F("tag") == 2
        check_recall("replica B tag == 2", search(tb, two),
                     exact_topk(tb, "vec", queries, K, Metric.L2,
                                lambda s: s.scalar("tag")[: s.n_rows] == 2), F32_TOL)
        check(ta.update(F("id") < MUT_IDS, {"tag": 1}) == MUT_IDS - 100, "UPDATE count")
        wait_until(applied("rep"), "B applying A's UPDATE")
        one = F("tag") == 1
        res_b = search(tb, one)
        got = hits(tb, res_b)
        live = got[0][np.concatenate([r.valid for r in res_b])]
        check(len(live) == SIFT_NQ * K and (live < MUT_IDS).all() and (live >= 100).all(),
              "B's search on tag == 1 returned a row the UPDATE did not mark")
        check_recall("replica B tag == 1 after A's UPDATE", res_b,
                     exact_topk(tb, "vec", queries, K, Metric.L2,
                                lambda s: s.scalar("tag")[: s.n_rows] == 1), F32_TOL)
        same_hits("B against A, tag == 1", got, hits(ta, search(ta, one)))
        log(f"  A's 100 deletes and UPDATE tag = 1 WHERE id < {MUT_IDS} reach B through its sync "
            f"thread: no deleted row returns; B's tag == 1 searches (after tag == 2 ones filled "
            f"its caches) return only marked rows, as the exact oracle and A do")

        # a leader merge of two 500,000-row parts (phase 11c's layout)
        ma, mb = (db.create_table("rep_merge", schema()) for db in dbs)
        a.attach(ma)
        b.attach(mb)
        half = SIFT_N // 2
        t0 = time.perf_counter()
        for p in (slice(0, half), slice(half, SIFT_N)):
            ma.insert({c: v[p] for c, v in cols[0].items()})
        wait_until(applied("rep_merge"), "B applying A's two parts")
        t1 = time.perf_counter()
        leader, follower = ((a, ma), (b, mb)) if a.is_merge_leader("rep_merge") else ((b, mb), (a, ma))
        check(follower[0].is_merge_leader("rep_merge") is False, "two merge leaders")
        check(follower[1].merge() is None, "the follower's merge was not deferred to the leader")
        new_id = leader[1].merge()
        check(new_id is not None, "the leader did not merge")
        if follower[0] is a:
            a.sync()
        else:
            wait_until(applied("rep_merge"), "B applying A's merge")
        t2 = time.perf_counter()
        check([s.n_rows for s in mb.live_segments()] == [s.n_rows for s in ma.live_segments()]
              == [SIFT_N], "the merge did not converge to one segment on both replicas")
        res_m = search(mb)
        check_recall("replica B after the merge", res_m,
                     exact_topk(mb, "vec", queries, K, Metric.L2), F32_TOL)
        nq, tied, worst = same_hits("B against A after the merge", hits(mb, res_m),
                                    hits(ma, search(ma)))
        log(f"  two {half:,}-row parts on A, on B in {t1 - t0:.2f} s; replica {leader[0].node_id} "
            f"(the leader) merged, replica {follower[0].node_id}'s merge() was deferred; the "
            f"merge reached it in {t2 - t1:.2f} s; {nq} queries return the same ids on both "
            f"({tied} near-tied, largest |distance difference| {worst:g})")
        nbytes = [sum(s.device_bytes for t in ts for s in t.live_segments())
                  for ts in ((ta, ma), (tb, mb))]
        log(f"  device bytes of the vector payloads: replica a {nbytes[0] / 1e6:.1f} MB, "
            f"replica b {nbytes[1] / 1e6:.1f} MB  [{card}]")
    finally:
        a.close()
        b.close()
        for db in dbs:
            db.close()
    check(b.last_sync_error is None, f"B's sync thread failed: {b.last_sync_error}")


def index_replication_path(ms, dev, sift, queries, op, card, root):
    """15b: build_vector_index_on_random_single_replica over two replica
    databases on the card, IVFFLAT (ncentroids 1,024) on phase 3's 1M
    segment: the builder (the JAX package's picker) builds and publishes,
    the other replica fetches and loads, once over a shared path and once
    over the HTTP exchange; the fetcher's searches at phase 8's operating
    nprobe return the builder's ids."""
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
    from myscaledb_tpu_torch.service.exchange import IndexExchangeServer
    from myscaledb_tpu_torch.service.replication import pick_build_replica

    (ids, vecs), _ = stored_corpus(sift)
    batches = [queries[i : i + SIFT_BATCH] for i in range(0, SIFT_NQ, SIFT_BATCH)]
    builder = pick_build_replica("repidx", 0, "ivf", 2)
    other = 1 - builder
    st = ms.Settings()
    st.table.build_vector_index_on_random_single_replica = True
    for mode in ("a shared path", "the HTTP exchange"):
        srv = None
        if mode == "a shared path":
            paths, peers = [os.path.join(root, "shared")] * 2, None
        else:
            paths = [os.path.join(root, f"replica{i}") for i in range(2)]
            srv = IndexExchangeServer(paths[builder])
            peers = [None, None]
            peers[builder] = srv.url
        dbs = [ms.connect(st, path=paths[i], replica_id=i, n_replicas=2, replica_peers=peers,
                          device=dev) for i in range(2)]
        try:
            ts = [db.create_table("repidx", ms.Schema({"id": ms.UInt64(),
                                                       "vec": ms.FloatVector(SIFT_D)}))
                  for db in dbs]
            for t in ts:
                t.insert({"id": ids, "vec": vecs})
            count = lambda: {n: GLOBAL_COUNTERS.get(n) for n in (
                "VectorIndexBuilds", "ReplicatedPartVectorIndexFetches",
                "ReplicatedPartVectorIndexFailedFetches")}
            before = count()
            t0 = time.perf_counter()
            for t in ts:
                t.add_vector_index("ivf", "vec", type="IVFFLAT", ncentroids=IVF_NCENT,
                                   metric_type="L2")
            for t in ts:
                check(t.wait_index_built(), "the replicated index did not land")
            sync(dev)
            t1 = time.perf_counter()
            want = {"VectorIndexBuilds": 1, "ReplicatedPartVectorIndexFetches": 1,
                    "ReplicatedPartVectorIndexFailedFetches": 0}
            moved = lambda: {n: v - before[n] for n, v in count().items()}
            # the builder counts its build just after it publishes, which
            # the fetcher may already have loaded
            wait_until(lambda: moved()["VectorIndexBuilds"] >= 1, "the builder's count", 10)
            check(moved() == want, f"one build and one fetch expected, no local build on the "
                  f"fetcher: {moved()}")
            check(ts[other]._slots[(0, "ivf")].path.startswith(paths[other]),
                  "the fetcher's index is not in its own store")
            res = [[t.search("vec", qb, k=K, metric="L2", params={"nprobe": op})
                    for qb in batches] for t in ts]
            got = [hits(t, r) for t, r in zip(ts, res)]
            same = int((got[other][0] == got[builder][0]).all(axis=1).sum())
            check(same == SIFT_NQ, f"the fetcher's ids equal the builder's on {same} of "
                  f"{SIFT_NQ} queries")
            check(np.array_equal(got[other][1], got[builder][1]),
                  "the fetched index scores otherwise than the builder's")
            check_hits_exact(ts[other], queries, res[other], f"fetched IVFFLAT nprobe={op}")
            log(f"  over {mode}: replica {builder} built, replica {other} fetched "
                f"({moved()}) in {t1 - t0:.2f} s; at nprobe {op} the fetcher returns the "
                f"builder's ids and scores on {same} of {SIFT_NQ} queries  [{card}]")
        finally:
            for db in dbs:
                db.close()
            if srv is not None:
                srv.close()


def sharded_path(ms, dev, sift, queries, hyb, vb, tb, card):
    """15c: phase 3's corpus in a 4-shard table sharded by id against phase
    3's table (no filter and the 1% filter), and its QPS; phase 9's
    documents in a 4-shard text table against phase 9's table (BM25 over
    cluster-wide statistics); hybrid RRF against a numpy fuse of its own
    two legs. Returns the vector search's QPS."""
    from myscaledb_tpu_torch import F
    from myscaledb_tpu_torch.text import inverted
    from myscaledb_tpu_torch.text.inverted import BM25Stats

    db = ms.connect(device=dev)
    try:
        sh = db.create_sharded_table("sift_sh", ms.Schema({"id": ms.UInt64(),
                                                           "vec": ms.FloatVector(SIFT_D)}),
                                     n_shards=REP_SHARDS, shard_key="id")
        t0 = time.perf_counter()
        for ids, vecs in stored_corpus(sift):
            sh.insert({"id": ids, "vec": vecs})
        check(sh.delete(F("id") < 100) == 100, "the sharded delete removed another count")
        sync(dev)
        t1 = time.perf_counter()
        shape = [[(s.n_rows, s.capacity) for s in t.live_segments()] for t in sh.shards]
        log(f"  {REP_SHARDS} shards by id ({t1 - t0:.2f} s): (rows, capacity) {shape}")
        batches = [queries[i : i + SIFT_BATCH] for i in range(0, SIFT_NQ, SIFT_BATCH)]
        for label, flt in (("no filter", None), ("id < 10000", F("id") < 10_000)):
            got = hits(sh, [sh.search("vec", qb, k=K, metric="L2", filter=flt)
                                      for qb in batches])
            want = hits(sift, [sift.search("vec", qb, k=K, metric="L2", filter=flt)
                                         for qb in batches])
            nq, tied, worst = same_hits(f"sharded against phase 3's table, {label}", got, want)
            agree = (got[0] == want[0]).all(axis=1)
            check(np.allclose(got[1][agree], want[1][agree], **F32_TOL),
                  f"sharded scores differ from phase 3's, {label}")
            log(f"  {label}: {nq} queries return phase 3's ids ({tied} near-tied, largest "
                f"|distance difference| {worst:g})")
        sh_qps = qps(lambda qb: sh.search("vec", qb, k=K, metric="L2"), batches, SIFT_BATCH)
        log(f"  {REP_SHARDS}-shard exact L2 QPS (batch {SIFT_BATCH}, k={K}): {sh_qps:.1f}  [{card}]")

        # phase 9's documents and vectors, with its deletes
        src = hyb.live_segments()
        th = db.create_sharded_table("hyb_sh", ms.Schema({"id": ms.UInt64(), "body": ms.String(),
                                                          "vec": ms.FloatVector(SIFT_D)}),
                                     n_shards=REP_SHARDS, shard_key="id")
        th.add_fts_index("ft", "body")
        t0 = time.perf_counter()
        for s, (ids, vecs) in zip(src, stored_corpus(hyb)):
            th.insert({"id": ids, "body": s.scalar("body")[: s.n_rows], "vec": vecs})
        dead = np.concatenate([s.scalar("id")[: s.n_rows][s.deleted_host()[: s.n_rows]]
                               for s in src])
        check(th.delete(F("id").isin(dead.tolist())) == len(dead) > 0, "the text deletes")
        sync(dev)
        t1 = time.perf_counter()
        # phase 9's 3-word queries; a store routed to the sparse path
        # (phase 9's 1M store, and here the 262,144-row shards) carries its
        # bound (`sparse_error_bound`, the query's prefix total), which
        # each side's score may take
        tables = [(hyb, [hyb]), (th, th.shards)]
        worst, tied, sure, n_sparse = 0.0, 0, 0, 0
        for qb in tb:
            extra = np.zeros(len(qb))
            for _, parts in tables:
                stores = [(t._text_indexes["ft"], s.segment_id)
                          for t in parts for s in t.live_segments()]
                stats = BM25Stats.merge([t._text_indexes["ft"].merged_stats(
                    [s.segment_id for s in t.live_segments()]) for t in parts])
                for tdef, sid in stores:
                    store = tdef.store(sid)
                    if store.plan_batch(qb, stats=stats)[3] == "sparse":
                        n_sparse += 1
                        bnd = store.bm25_topk_batch(qb, K, stats=stats, route="sparse")[4]
                        extra = np.maximum(extra, bnd.cpu().numpy())
            r_sh, r_one = th.text_search("body", qb, k=K), hyb.text_search("body", qb, k=K)
            i_sh, i_one = th.gather(r_sh, ["id"])["id"], hyb.gather(r_one, ["id"])["id"]
            for i in range(len(qb)):
                a_sc, b_sc = r_sh.scores[i][r_sh.valid[i]], r_one.scores[i][r_one.valid[i]]
                check(len(a_sc) == len(b_sc), "the sharded text search found another count")
                tol = 2 * inverted.DENSE_RTOL * np.abs(b_sc) + 2 * extra[i]
                err = np.abs(np.sort(a_sc) - np.sort(b_sc))
                check((err <= tol).all(), f"sharded BM25 scores differ from phase 9's by "
                      f"{err.max():.6g} (bound {tol.max():.6g})")
                if len(err):
                    worst = max(worst, float((err / tol).max()))
                # a row scoring clearly above the k-th on one side is a hit
                # on the other (rows near the k-th may differ)
                kth = b_sc.min() if len(b_sc) else 0.0
                cut = kth * (1 + 8 * inverted.DENSE_RTOL) + 4 * extra[i]
                x, y = i_sh[i][r_sh.valid[i]], i_one[i][r_one.valid[i]]
                check(set(x[a_sc > cut].tolist()) <= set(y.tolist())
                      and set(y[b_sc > cut].tolist()) <= set(x.tolist()),
                      "sharded BM25 hits differ from phase 9's above the k-th score")
                sure += int((b_sc > cut).sum())
                tied += int((b_sc <= cut).sum() > 1)
        nq = sum(len(qb) for qb in tb)
        log(f"  text: {REP_SHARDS}-shard table over phase 9's {hyb.n_rows:,} live documents "
            f"(insert {t1 - t0:.2f} s; the fts stores build in the background); its {nq} "
            f"3-word queries score as phase 9's table within DENSE_RTOL and the sparse bounds "
            f"({n_sparse} sparse store-batches; worst err/bound {worst:.3g}); the {sure} hits "
            f"clearly above each k-th score are phase 9's ({tied} queries with rows near the k-th)")

        # hybrid RRF against a numpy fuse of its own legs (the reference's
        # Σ 1 / (fusion_k + rank) in f64, ties by (shard, segment, row))
        n_cand = K * th.shards[0].settings.query.hybrid_search_top_k_multiple_base
        fk = th.shards[0].settings.query.hybrid_search_fusion_k
        qv, texts = np.concatenate(vb), [q for qb in tb for q in qb]
        for j in range(REP_HYBRID_NQ):
            h = th.hybrid_search("vec", "body", qv[j], texts[j], k=K, fusion_type="rrf")
            legs = (th.search("vec", qv[j], k=n_cand), th.text_search("body", texts[j], k=n_cand))
            fused = {}
            for leg in legs:
                ok = leg.valid[0]
                keys = zip(leg.shards[0][ok].tolist(), leg.segments[0][ok].tolist(),
                           leg.rows[0][ok].tolist())
                for rank, key in enumerate(keys, start=1):
                    fused[key] = fused.get(key, 0.0) + 1.0 / (fk + rank)
            want = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:K]
            got = list(zip(zip(h.shards[0].tolist(), h.segments[0].tolist(), h.rows[0].tolist()),
                           h.scores[0].tolist()))[: len(want)]
            check([g[0] for g in got] == [w[0] for w in want]
                  and np.array_equal(np.float32([g[1] for g in got]), np.float32([w[1] for w in want])),
                  f"sharded hybrid RRF differs from the numpy fuse of its legs (query {j})")
        log(f"  hybrid RRF: {REP_HYBRID_NQ} queries equal a numpy fuse of their own two legs "
            f"({n_cand} candidates a leg, fusion_k {fk})  [{card}]")
    finally:
        db.close()
    return sh_qps


def replication_path(ms, dev, sift, queries, op, hyb, vb, tb, card):
    """Phase 15: replication and the sharded table on the card (15a-c);
    the commit listeners and the sync thread must have swallowed no
    error. Returns 15c's QPS."""
    import gc
    import tempfile

    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    t0 = time.perf_counter()
    avail = mem_available()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rep_") as root:
        log(f"[15a] data replication: two ReplicatedNodes on 127.0.0.1, phase 3's corpus, then "
            f"deletes, UPDATE and a leader merge through B's sync thread")
        data_replication_path(ms, dev, sift, queries, card, root)
        gc.collect()  # a closed database and its index cache hold each other
        t1 = time.perf_counter()
        log(f"[15b] index replication: IVFFLAT ncentroids={IVF_NCENT} built once, fetched over a "
            f"shared path and over the HTTP exchange")
        index_replication_path(ms, dev, sift, queries, op, card, root)
        gc.collect()
        t2 = time.perf_counter()
    log(f"[15c] ShardedTable: phase 3's corpus and phase 9's documents in {REP_SHARDS} shards")
    sh_qps = sharded_path(ms, dev, sift, queries, hyb, vb, tb, card)
    gc.collect()
    t3 = time.perf_counter()
    log(f"  15a {t1 - t0:.2f} s, 15b {t2 - t1:.2f} s, 15c {t3 - t2:.2f} s; host MemAvailable "
        f"{avail / 1e9:.1f} GB before, {mem_available() / 1e9:.1f} GB after (phase 12 needs it)")
    errors = {n: GLOBAL_COUNTERS.get(n) for n in ("CommitListenerErrors", "ReplicationSyncErrors")}
    check(errors == {"CommitListenerErrors": 0, "ReplicationSyncErrors": 0},
          f"replication swallowed errors: {errors}")
    log(f"  swallowed errors: {errors}")
    return sh_qps


# --------------------------------------------------------------- phase 16
class IdResult:
    """A MeshTable answer (ids, scores) as numpy_fuse reads a SearchResult:
    one segment, the id in place of the row."""

    def __init__(self, ids, scores):
        self.rows, self.scores = ids, scores
        self.segments = np.zeros_like(ids)
        self.valid = ids >= 0
        self.nq = ids.shape[0]


def mesh_search(t, queries, batch=SIFT_BATCH, **kw):
    """(ids, scores) of a MeshTable's searches over `queries` in batches."""
    out = [t.search(queries[i : i + batch], K, **kw) for i in range(0, len(queries), batch)]
    return np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out])


def mesh_same(label, got, want):
    """same_hits over (ids, scores) pairs (the near-tie rule)."""
    return same_hits(label, (got[0], got[1], got[1]), (want[0], want[1], want[1]))


def mesh_recall(got, want):
    """recall_ids@k of `got` against the exact answers `want` (ids)."""
    return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got[0], want[0])) / got[0].size


def mesh_exact_scores(label, got, queries, rows_by_id, live):
    """Every hit is a live row whose score is its stored row's exact L2
    score 2 q.x - |x|^2 (f64 over the bf16 values), within F32_TOL."""
    ids, scores = got
    check((ids >= 0).all(), f"{label}: a query got fewer than {K} hits")
    check(live[ids].all(), f"{label}: a deleted row came back")
    x = rows_by_id[ids].astype(np.float64)
    want = 2.0 * np.einsum("qd,qkd->qk", queries.astype(np.float64), x) - (x * x).sum(-1)
    ok = np.isclose(scores, want, **F32_TOL)
    check(ok.all(), f"{label}: {int((~ok).sum())} hits differ from their exact f32 scores "
          f"(worst {float(np.abs(scores - want).max()):.6g})")


def bf16_values(x):
    """The values a bf16 table stores for f32 rows (round to nearest even)."""
    import torch

    return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()


def mesh_index_path(label, t, build, queries, exact, start, rows_by_id, live, new, new_ids, card):
    """16b / 16c: `build()`, an nprobe sweep over IVF_NPROBES from `start`
    that stops at recall_ids@10 >= IVF_RECALL_TARGET against `exact`, the
    window gather's bytes estimated from bucket_pad before the first search
    (the batch cut while a shard's would pass MESH_GATHER_BYTES), every
    hit's exact score, QPS at the operating point; then `new` appended
    without a rebuild, each found by the delta scan as its own nearest
    neighbour. Returns the operating nprobe."""
    t0 = time.perf_counter()
    build()
    sync(t.mesh.devices[0][0])
    build_s = time.perf_counter() - t0
    bpad = (t._ivf or t._mstg)[-1]
    # a shard's [Q, P*B, D] window gather: the stored rows and their f32 copy
    # (IVF), or the u8 codes and their f32 copy (two-stage)
    per_value = 2 + 4 if t._ivf is not None else 1 + 4
    log(f"  {label}: build {build_s:.2f} s ({IVF_NCENT} centroids, bucket_pad {bpad})  [{card}]")
    op, res = None, None
    for p in (x for x in IVF_NPROBES if x >= start):
        batch = SIFT_BATCH
        while batch > 8 and batch * p * bpad * SIFT_D * per_value > MESH_GATHER_BYTES:
            batch //= 2
        gather = batch * p * bpad * SIFT_D * per_value
        res = mesh_search(t, queries, batch, params={"nprobe": p})
        rec = mesh_recall(res, exact)
        log(f"  nprobe {p}: recall_ids@{K} {rec:.4f}; window gather {gather / 1e6:.1f} MB a "
            f"shard at batch {batch}" + ("" if batch == SIFT_BATCH else
                                         f" (cut from {SIFT_BATCH}: over {MESH_GATHER_BYTES} bytes)"))
        if rec >= IVF_RECALL_TARGET:
            op = p
            break
    check(op is not None, f"{label}: no nprobe reached recall_ids@{K} {IVF_RECALL_TARGET}")
    mesh_exact_scores(label, res, queries, rows_by_id, live)
    bq = [queries[i : i + batch] for i in range(0, len(queries), batch)]
    rate = qps(lambda qb: t.search(qb, K, params={"nprobe": op}), bq, batch)
    log(f"  {label} operating point nprobe {op}: every hit a live row with its exact f32 score; "
        f"QPS {rate:.1f} (batch {batch}, k={K})  [{card}]")
    # appends after the build: served by the delta exact scan
    sealed, ivf, mstg = t._s, t._ivf, t._mstg
    t.insert({"id": new_ids, "vec": new, "price": np.zeros(len(new), np.int32)})
    rows_by_id[new_ids] = bf16_values(new)
    live[new_ids] = True
    check(t._s is sealed and t._ivf is ivf and t._mstg is mstg,
          f"{label}: the append resealed the table or dropped its index")
    qn = rows_by_id[new_ids[:SIFT_BATCH]]
    got = t.search(qn, K, params={"nprobe": op})
    check((got[0][:, 0] == new_ids[:SIFT_BATCH]).all(),
          f"{label}: the delta scan missed appended rows ({int((got[0][:, 0] != new_ids[:SIFT_BATCH]).sum())})")
    mesh_exact_scores(f"{label} delta", got, qn, rows_by_id, live)
    log(f"  {len(new):,} rows appended without a rebuild ({t.n_rows:,} rows): each of "
        f"{SIFT_BATCH} of them is its own nearest neighbour at nprobe {op} (the delta scan)")
    return op


def mesh_check_text(label, results, query_batches, oracle, alive, full=1):
    """Every BM25 hit of a MeshTable (ids = document indices) is a live,
    matching document whose f32 score lies within DENSE_RTOL of the f64
    BM25 of `oracle` (the mesh's statistics are global: every shard's
    documents, as the oracle counts them); for the first `full` batches no
    matching live document left out beats the k-th hit beyond that.
    Returns the largest |score - f64| / bound."""
    from myscaledb_tpu_torch.text import inverted

    worst = 0.0
    for b, (qs, (ids, scores)) in enumerate(zip(query_batches, results)):
        for i, q in enumerate(qs):
            terms = list(dict.fromkeys(q.split()))
            valid = ids[i] >= 0
            hit, got = ids[i][valid], scores[i][valid]
            sc, _ = oracle.at(terms, hit)
            want = np.where((sc > 0) & alive[hit], sc, -np.inf)
            check(np.isfinite(want).all(), f"{label}: query {i} of batch {b} returned a row that "
                  "is deleted or matches no term")
            bnd = inverted.DENSE_RTOL * np.abs(want)
            if len(got):
                err = np.abs(got - want)
                worst = max(worst, float((err / bnd).max()))
                check((err <= bnd).all(), f"{label}: query {i} of batch {b}: a score lies "
                      f"{float(err.max()):.6g} from its f64 BM25 (bound {float(bnd.max()):.6g})")
            if b >= full:
                continue
            sc, _ = oracle.full(terms)
            ok = (sc > 0) & alive
            ok[hit] = False
            left = sc[ok]
            if valid.sum() < K:
                check(len(left) == 0, f"{label}: query {i} left out {len(left)} matching rows")
            elif len(left):
                kth = float(got[-1])
                check(left.max() <= kth + inverted.DENSE_RTOL * abs(kth),
                      f"{label}: query {i}: a row left out scores {left.max():.6g} above the "
                      f"k-th hit's {kth:.6g}")
    return worst


def mesh_path(ms, dev, sift, queries, hyb, oracle, vb, tb, ref_qps, card):
    """Phase 16: MeshTable over a grid of MESH_SHARDS entries of this card
    (one controller; each shard's scan is the score kernel): (a) phase 3's
    corpus with a price column, exact search against phase 3's oracle, a
    1% filter, deletes, a 2x2 grid, QPS; (b) sharded IVF; (c) sharded
    two-stage; (d) phase 9's documents, BM25 under global statistics and
    hybrid RRF / RSF; (e) save / load. Returns the launches of phase 3's
    table's QPS passes (16a times it beside the mesh)."""
    import tempfile

    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import distance, tilescan
    from myscaledb_tpu_torch.parallel.distributed import Mesh, make_mesh

    batches = [queries[i : i + SIFT_BATCH] for i in range(0, SIFT_NQ, SIFT_BATCH)]
    n_cards = torch.cuda.device_count()
    try:
        make_mesh(n_cards + 1)
    except RuntimeError as e:
        check("Mesh(" in str(e), f"make_mesh's refusal does not say how to share a card: {e}")
    else:
        raise RuntimeError(f"make_mesh({n_cards + 1}) did not raise with {n_cards} card(s)")
    grid = Mesh([[dev] * MESH_SHARDS])

    log(f"[16a] MeshTable over {grid}: phase 3's corpus, exact search, a 1% filter, deletes")
    t0 = time.perf_counter()
    parts = stored_corpus(sift)
    ids = np.concatenate([p[0] for p in parts]).astype(np.int64)
    n0 = len(ids)
    check(np.array_equal(np.sort(ids), np.arange(n0)), "phase 3's ids are not 0 .. n-1")
    rows_by_id = np.zeros((n0 + 2 * MESH_NEW, SIFT_D), np.float32)
    rows_by_id[ids] = np.concatenate([p[1] for p in parts])
    del parts
    live = np.zeros(len(rows_by_id), bool)
    live[ids] = True
    price = np.random.default_rng(16).integers(0, 1000, n0).astype(np.int32)  # by id
    t = ms.MeshTable("mesh_sift", SIFT_D, mesh=grid, filter_columns=("price",))
    t.insert({"id": np.arange(n0), "vec": rows_by_id[:n0], "price": price})
    check(t.delete(np.arange(100)) == 100, "the mesh delete removed another count")
    live[:100] = False
    t1 = time.perf_counter()
    t._seal()
    sync(dev)
    t2 = time.perf_counter()
    s = t._s
    log(f"  {n0:,} rows: insert {t1 - t0:.2f} s, seal {t2 - t1:.2f} s (bf16 codes, |x|^2, alive, "
        f"price onto {MESH_SHARDS} shards of {s.cap:,} slots, fill {s.fill.tolist()})  [{card}]")
    idm = id_map(sift)
    gv, gs, gr = exact_topk(sift, "vec", queries, K, Metric.L2)
    want = (hit_ids(idm, gs, gr), gv)
    got = mesh_search(t, queries)
    nq, tied, worst = mesh_same("4-shard exact against phase 3's oracle", got, want)
    check((got[0] >= 100).all(), "a row deleted before the seal came back")
    log(f"  exact: {nq} queries return phase 3's oracle ids ({tied} near-tied, largest |score "
        f"difference| {worst:g})")

    def cheap(price):
        return price < MESH_PRICE_CUT

    def seg_cheap(sg):
        return price[sg.scalar("id")[: sg.n_rows].astype(np.int64)] < MESH_PRICE_CUT

    fgot = mesh_search(t, queries, filter=cheap)
    fv, fs, fr = exact_topk(sift, "vec", queries, K, Metric.L2, seg_cheap)
    nq, tied, _ = mesh_same("4-shard filtered against phase 3's oracle", fgot,
                            (hit_ids(idm, fs, fr), fv))
    check((price[fgot[0]] < MESH_PRICE_CUT).all() and live[fgot[0]].all(),
          "a filtered hit fails the filter or is deleted")
    log(f"  filter price < {MESH_PRICE_CUT} ({(price < MESH_PRICE_CUT).mean():.4f} of the rows): "
        f"every hit passes, {nq} queries equal the filtered oracle ({tied} near-tied)")
    dead = np.unique(got[0][:SIFT_BATCH, 0])
    check(t.delete(dead) == len(dead), "the mesh delete removed another count")
    live[dead] = False
    got = mesh_search(t, queries)
    check(live[got[0]].all(), "a deleted row came back")

    def seg_live(sg):
        return live[sg.scalar("id")[: sg.n_rows].astype(np.int64)]

    dv, ds, dr = exact_topk(sift, "vec", batches[0], K, Metric.L2, seg_live)
    mesh_same("4-shard after deletes", (got[0][:SIFT_BATCH], got[1][:SIFT_BATCH]),
              (hit_ids(idm, ds, dr), dv))
    log(f"  delete: the top hit of each of the first {SIFT_BATCH} queries ({len(dead)} rows), none "
        f"returned; batch 1 equals the oracle without them")
    t0 = time.perf_counter()
    g22 = ms.MeshTable("mesh_sift_2x2", SIFT_D, mesh=Mesh([[dev] * 2] * 2),
                       filter_columns=("price",))
    g22.insert({"id": np.arange(n0), "vec": rows_by_id[:n0], "price": price})
    g22.delete(np.nonzero(~live[:n0])[0])
    got22 = mesh_search(g22, queries)
    nq, tied, _ = mesh_same("2x2 grid against the 4-shard table", got22, got)
    log(f"  2x2 grid (query axis 2, {g22.n_shards} data shards of {g22._s.cap:,} slots, "
        f"{time.perf_counter() - t0:.2f} s): {nq} queries return the 4-shard table's ids "
        f"({tied} near-tied)")
    del g22
    mesh_qps = qps(lambda qb: t.search(qb, K), batches, SIFT_BATCH)
    before = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
              "tile_rescore": tilescan.tile_rescore.launches}
    one_qps = qps(lambda qb: sift.search("vec", qb, k=K, metric="L2"), batches, SIFT_BATCH)
    ref_launches = {"score": distance.scores.launches - before["score"],
                    "tile_max": tilescan.tile_maxes.launches - before["tile_max"],
                    "tile_rescore": tilescan.tile_rescore.launches - before["tile_rescore"]}
    log(f"  exact L2 QPS (batch {SIFT_BATCH}, k={K}, best of 3 passes): MeshTable {MESH_SHARDS} "
        f"shards {mesh_qps:.1f} (host arrays back each batch); phase 3's table now {one_qps:.1f}, "
        f"in phase 5 {ref_qps['phase 5']:.1f}; 15c's {REP_SHARDS}-shard ShardedTable "
        f"{ref_qps['15c']:.1f}  [{card}]")

    new = make_corpus(2 * MESH_NEW, SIFT_D, seed=16, centers=corpus_centers(SIFT_D))
    new_ids = np.arange(n0, n0 + 2 * MESH_NEW)
    log(f"[16b] sharded IVF (build_ivf({IVF_NCENT}): global k-means, a cluster-major layout a "
        f"shard), nprobe sweep against 16a's exact answers")
    op = mesh_index_path("IVF", t, lambda: t.build_ivf(IVF_NCENT), queries, got, 1, rows_by_id,
                         live, new[:MESH_NEW], new_ids[:MESH_NEW], card)
    log(f"[16c] sharded two-stage (build_mstg({IVF_NCENT}): SQ8 codes, the exact re-rank on each "
        f"shard), from IVF's nprobe {op}")
    exact_c = mesh_search(t, queries)  # 16a's path, with the appended rows
    mesh_index_path("two-stage", t, lambda: t.build_mstg(IVF_NCENT), queries, exact_c, op,
                    rows_by_id, live, new[MESH_NEW:], new_ids[MESH_NEW:], card)

    log(f"[16e] save / load of 16a's table ({t.n_rows:,} rows) in the per-shard layout")
    want = mesh_search(t, queries)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
        t0 = time.perf_counter()
        t.save(root)
        t1 = time.perf_counter()
        t2 = ms.MeshTable.load(root, mesh=grid)
        back = mesh_search(t2, queries)
        t3 = time.perf_counter()
        files = sorted(os.listdir(root))
        size = tree_bytes(root)
    check(t2.n_rows == t.n_rows, f"the reloaded table holds {t2.n_rows} rows, not {t.n_rows}")
    check(files == ["meshtable.json"] + [f"shard_{i}.npz" for i in range(MESH_SHARDS)],
          f"checkpoint files {files}")
    nq, tied, _ = mesh_same("reloaded against the saved table", back, want)
    log(f"  save {t1 - t0:.2f} s ({size / 1e6:.1f} MB in {files}), load and search "
        f"{t3 - t1:.2f} s: {nq} queries return the saved table's hits ({tied} near-tied)")
    del t, t2

    log(f"[16d] MeshTable with a text column over phase 9's documents and vectors, "
        f"{MESH_SHARDS} shards")
    segs = hyb.live_segments()
    hids = np.concatenate([sg.scalar("id")[: sg.n_rows] for sg in segs]).astype(np.int64)
    docs = np.concatenate([sg.scalar("body")[: sg.n_rows] for sg in segs]).astype(object)
    dead_t = hids[np.concatenate([sg.deleted_host()[: sg.n_rows] for sg in segs])]
    check(np.array_equal(np.sort(hids), np.arange(oracle.n)), "phase 9's ids are not 0 .. n-1")
    hv = np.concatenate([v for _, v in stored_corpus(hyb)])
    alive = np.ones(oracle.n, bool)
    alive[dead_t] = False
    t0 = time.perf_counter()
    tt = ms.MeshTable("mesh_text", SIFT_D, mesh=grid, text_column="body")
    tt.insert({"id": hids, "vec": hv, "body": docs})
    check(tt.delete(dead_t) == len(dead_t) > 0, "the text deletes")
    del hv, docs
    t1 = time.perf_counter()
    ti = tt._text_index()
    sync(dev)
    t2 = time.perf_counter()
    log(f"  insert {t1 - t0:.2f} s; per-shard inverted indexes {t2 - t1:.2f} s by the "
        f"{[ix.builder for ix in ti.shards]} builders (postings a shard "
        f"{[int(ix.term_offsets[-1]) for ix in ti.shards]}, budget cap {ti.budget_cap}); global "
        f"statistics: {ti.stats.total_docs:,} documents, average length "
        f"{ti.stats.avg_doc_len:.4f} (the oracle's {oracle.avg_len:.4f})  [{card}]")
    res = [tt.text_search(qb, K) for qb in tb]
    sync(dev)
    w = mesh_check_text("mesh text", res, tb, oracle, alive)
    t3 = time.perf_counter()
    check(not np.isin(np.concatenate([r[0] for r in res]), dead_t).any(),
          "a deleted document came back")
    log(f"  text_search, {TEXT_NQ} 3-word queries (batch {TEXT_BATCH}, {t3 - t2:.2f} s with the "
        f"checks): every hit a live document within DENSE_RTOL of its f64 BM25 under the global "
        f"statistics (worst err/bound {w:.3g}); no row left out of batch 1 beats the k-th")
    qv, texts = np.concatenate(vb), [q for qb in tb for q in qb]
    for ftype in ("rrf", "rsf"):
        for j in range(REP_HYBRID_NQ):
            h = tt.hybrid_search(qv[j], texts[j], K, fusion_type=ftype)
            legs = (IdResult(*tt.search(qv[j], K)), IdResult(*tt.text_search(texts[j], K)))
            nv, _, nr = numpy_fuse(*legs, K, ftype)
            if ftype == "rrf":
                check(np.array_equal(h[0], nr) and np.array_equal(h[1], nv),
                      f"mesh hybrid RRF differs from the numpy fuse of its legs (query {j})")
            else:
                check(np.allclose(h[1], nv, rtol=0, atol=1e-6),
                      f"mesh hybrid RSF scores differ from the numpy fuse of its legs (query {j})")
                nb = np.pad(nv, ((0, 0), (1, 1)), constant_values=np.nan)
                with np.errstate(invalid="ignore"):
                    apart = ~(np.abs(nv - nb[:, :-2]) <= 1e-6) & ~(np.abs(nv - nb[:, 2:]) <= 1e-6)
                apart &= np.isfinite(nv)
                check((h[0][apart] == nr[apart]).all(),
                      f"mesh hybrid RSF ids differ from the numpy fuse of its legs (query {j})")
            check(alive[h[0][h[0] >= 0]].all(), "a deleted document came back from hybrid search")
    log(f"  hybrid RRF and RSF: {REP_HYBRID_NQ} queries each equal a numpy fuse of their own two "
        f"legs (k {K} candidates a leg)")
    del tt
    return ref_launches


def mesh_cards_path(ms, devices, card):
    """--mesh-cards: phase 3's corpus (with 16a's price column and deletes)
    in a MeshTable with one shard on each of `devices` (a card each),
    against the same shards all on the first card and, with four or more
    cards, a 2 x n/2 grid: exact and 1% filtered hits (near-tie rule), IVF
    and two-stage at nprobe 2 (ids against the one-card table where the
    shard count is the same, else recall against the exact answers), BM25 and hybrid RRF over 100,000 of phase
    9's documents (the one-card table's ids), QPS, seconds, each card's
    bytes and the score launches."""
    import torch

    from myscaledb_tpu_torch.ops import distance
    from myscaledb_tpu_torch.parallel.distributed import Mesh

    n = len(devices)
    corpus = np.concatenate([make_corpus(SIFT_N, SIFT_D, seed=0),
                             make_corpus(SIFT_SMALL_N, SIFT_D, seed=1,
                                         centers=corpus_centers(SIFT_D))])
    rows = len(corpus)
    rng = np.random.default_rng(1)
    qidx = rng.choice(SIFT_N, SIFT_NQ, replace=False)
    queries = (corpus[qidx] + 0.3 * rng.standard_normal((SIFT_NQ, SIFT_D))).astype(np.float32)
    batches = [queries[i : i + SIFT_BATCH] for i in range(0, SIFT_NQ, SIFT_BATCH)]
    price = np.random.default_rng(16).integers(0, 1000, rows).astype(np.int32)
    docs, trng = text_corpus(MESH_CARDS_DOCS)
    words = [f"term{i}" for i in range(TEXT_VOCAB)]
    texts = [" ".join(words[j] for j in r) for r in trng.integers(0, TEXT_VOCAB, (TEXT_BATCH, 3))]
    grids = {"one card": Mesh([[devices[0]] * n]), f"{n} cards": Mesh([devices])}
    if n >= 4 and n % 2 == 0:
        grids[f"2 x {n // 2} over {n} cards"] = Mesh([devices[: n // 2], devices[n // 2 :]])
    first = None
    for label, grid in grids.items():
        t0 = time.perf_counter()
        t = ms.MeshTable("cards", SIFT_D, mesh=grid, filter_columns=("price",))
        t.insert({"id": np.arange(rows), "vec": corpus, "price": price})
        t.delete(np.arange(100))
        t._seal()
        for d in devices:
            sync(d)
        seal_s = time.perf_counter() - t0
        held = [torch.cuda.memory_allocated(d) if d.type == "cuda" else 0 for d in devices]
        distance.scores.launches = 0
        got = {"exact": mesh_search(t, queries),
               "filtered": mesh_search(t, queries, filter=lambda price: price < MESH_PRICE_CUT)}
        rate = {"exact": qps(lambda qb: t.search(qb, K), batches, SIFT_BATCH)}
        builds = {}
        for kind, build in (("IVF", "build_ivf"), ("two-stage", "build_mstg")):
            t0 = time.perf_counter()
            getattr(t, build)(IVF_NCENT)
            for d in devices:
                sync(d)
            builds[kind] = time.perf_counter() - t0
            got[kind] = mesh_search(t, queries, params={"nprobe": 2})
            rate[kind] = qps(lambda qb: t.search(qb, K, params={"nprobe": 2}), batches, SIFT_BATCH)
        tt = ms.MeshTable("cards_text", SIFT_D, mesh=grid, text_column="body")
        tt.insert({"id": np.arange(MESH_CARDS_DOCS), "vec": corpus[:MESH_CARDS_DOCS], "body": docs})
        got["text"] = tt.text_search(texts, K)
        got["hybrid"] = tt.hybrid_search(queries[:TEXT_BATCH], texts, K)
        launches = distance.scores.launches
        log(f"  {label} ({grid}): seal {seal_s:.2f} s; bytes a card "
            f"{[round(b / 1e6, 1) for b in held]} MB; builds IVF {builds['IVF']:.2f} s, two-stage "
            f"{builds['two-stage']:.2f} s; QPS exact {rate['exact']:.1f}, IVF nprobe 2 "
            f"{rate['IVF']:.1f}, two-stage {rate['two-stage']:.1f} (batch {SIFT_BATCH}); score "
            f"launches {launches}  [{card}]")
        check(launches > 0, f"{label}: kernel score was not launched")
        # with another shard count the k-means sums run in another order:
        # the indexes are held to recall there, not to the one-card ids
        same_layout = grid.shape["data"] == n
        if first is None or not same_layout:
            for kind in ("IVF", "two-stage"):
                rec = mesh_recall(got[kind], got["exact"])
                log(f"    {kind} recall_ids@{K} at nprobe 2: {rec:.4f}")
                check(rec >= IVF_RECALL_TARGET, f"{kind} at nprobe 2: recall_ids@{K} {rec:.4f}")
        if first is None:
            first = got
        else:
            same = [k for k in ("exact", "filtered") + (("IVF", "two-stage") if same_layout else ())
                    if mesh_same(f"{label} {k} against one card", got[k], first[k])]
            check(all(np.array_equal(got[k][0], first[k][0]) for k in ("text", "hybrid")),
                  f"{label}: BM25 or hybrid ids differ from the one-card table's")
            log(f"    {', '.join(same)}: the one-card table's ids (near-tie rule); BM25 and hybrid "
                f"RRF over {MESH_CARDS_DOCS:,} documents: its ids")
        del t, tt  # before the next grid's bytes are read

# --------------------------------------------------------------- phase 17
def compare_approx(dev):
    """17a: `approx_bin_max` against `approx_bin_max_plain` bit for bit
    (values and indices) at APPROX_SHAPES, each over a column slice of a
    wider matrix (the kernel reads the row stride in place). Returns the
    largest |kernel - plain| value (0)."""
    import torch

    from myscaledb_tpu_torch.ops import topk

    gen = torch.Generator(device=dev).manual_seed(17)
    worst = 0.0
    for q, n, L, keep, ties in APPROX_SHAPES:
        s = 3.0 * torch.randn((q, n + 8), generator=gen, device=dev)
        if ties:
            s = torch.round(4.0 * s) / 4.0
        if keep < 1.0:
            drop = torch.rand(s.shape, generator=gen, device=dev) >= keep
            s = s.masked_fill(drop, float("-inf"))
        view = s[:, 3 : 3 + n]
        before = topk.approx_bin_max.launches
        v, i = topk.approx_bin_max(view, L)
        pv, pi = topk.approx_bin_max_plain(view, L)
        sync(dev)
        check(topk.approx_bin_max.launches == before + 1, "approx_bin_max did not launch")
        err = float(torch.where(v == pv, torch.zeros_like(v), (v - pv).abs()).max())
        bad = int((i != pi).sum())
        check(torch.equal(v, pv) and bad == 0,
              f"approx_bin_max Q={q} N={n} L={L}: kernel differs from plain (max |dv| {err}, "
              f"{bad} indices differ)")
        worst = max(worst, err)
        log(f"  approx_bin_max Q={q} N={n} L={L} kept {keep:g}{' ties' if ties else ''}: kernel "
            f"== plain bit for bit (values and indices)")
    return worst


def time_approx(dev, card):
    """17a's times: the kernel, its plain version and the library call
    (`torch.max` over the [Q, N/L, L] view, which computes the same
    function up to the order of ties) at the first APPROX_TIMED shapes,
    with the bound of the kernel's bytes, and beside them the exact
    selection the branch replaces (`torch.topk` of the row) and the whole
    approximate selection (`topk_scores(approx=True)`). Returns the
    record's fields from the first shape."""
    import torch

    from myscaledb_tpu_torch.ops import topk

    gen = torch.Generator(device=dev).manual_seed(171)
    out = None
    for q, n, L, _, _ in APPROX_SHAPES[:APPROX_TIMED]:
        s = 3.0 * torch.randn((q, n), generator=gen, device=dev)
        r = 0.9 if L == 128 else 0.99
        check(topk.approx_reduction_output_size(n, K, r) == L, f"L at N={n} r={r} is not {L}")
        call = lambda: topk.approx_bin_max(s, L)  # noqa: E731
        fold = s.view(q, n // L, L) if n % L == 0 else None
        rec = dict(
            ms=cuda_time_ms(call),
            plain_ms=cuda_time_ms(lambda: topk.approx_bin_max_plain(s, L)),
            library_ms=None if fold is None else cuda_time_ms(lambda: torch.max(fold, dim=1)),
        )
        # every score read once, each bin's value and index written once; a
        # compare a score
        rec["bound_ms"], rec["bound_by"] = bound(4 * q * n + 8 * q * L, q * n, "f32")
        exact_ms = cuda_time_ms(lambda: torch.topk(s, K, dim=1))
        whole_ms = cuda_time_ms(lambda: topk.topk_scores(s, K, approx=True, recall_target=r))
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        log(f"  approx_bin_max Q={q} N={n} L={L}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, library {lib}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}; {100 * rec['bound_ms'] / rec['ms']:.1f}% of it); the whole "
            f"approximate top-{K} {whole_ms:.4f} ms, torch.topk(s, {K}) {exact_ms:.4f} ms  "
            f"[{card}]")
        out = out or rec
        del s, fold
    return out


def approx_settings(t, r):
    """The table's settings with the approximate top-k at target r."""
    return t.settings.override({"use_approx_topk": "1", "approx_topk_recall_target": str(r)})


def id_recall(results, gt):
    """recall_ids@k by (segment, row) against the exact (scores,
    segments, rows) `gt`."""
    segs = np.concatenate([r.segments for r in results])
    rows = np.concatenate([r.rows for r in results])
    _, gs, gr = gt
    return sum(len(set(zip(segs[i].tolist(), rows[i].tolist()))
                   & set(zip(gs[i].tolist(), gr[i].tolist()))) for i in range(len(rows))) / rows.size


def approx_table_path(label, t, batches, gt, nb, metric, out_dir, card):
    """17b / 17c: the table's exact search and its approximate one at
    each APPROX_TARGETS target: recall_ids@10 against the exact oracle,
    every hit's exact f32 score (`check_hits_exact`), device ms a search
    (torch.profiler) and QPS."""
    queries = np.concatenate(batches)

    def run(settings):
        def search(qb):
            return t.search("vec", qb, k=K, metric=metric, settings=settings)
        return search

    def shares(by_name, total):
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        return "; ".join(f"{name[:48]} {100 * ms_ / total:.1f}%" for name, ms_ in top)

    exact = run(None)
    ex_qps = qps(exact, batches, nb)
    ex_ms = device_trace(exact, batches, os.path.join(out_dir, f"trace_approx_{label}_exact.json"))
    log(f"  {label} exact: {ex_ms[0] / len(batches):.4f} device ms a search ({ex_ms[2]} kernels "
        f"over {len(batches)} searches; {shares(ex_ms[1], ex_ms[0])}), QPS {ex_qps:.1f}  [{card}]")
    for r in APPROX_TARGETS:
        search = run(approx_settings(t, r))
        res = [search(qb) for qb in batches]
        rec = id_recall(res, gt)
        check(rec >= r - APPROX_SLACK, f"{label} at r {r}: recall_ids@{K} {rec:.4f}")
        if r == max(APPROX_TARGETS):
            check(rec >= APPROX_MIN_RECALL, f"{label} at r {r}: recall_ids@{K} {rec:.4f} is under "
                  f"{APPROX_MIN_RECALL}")
        check_hits_exact(t, queries, res, f"{label} approx r {r}", metric=metric)
        d = np.concatenate([r_.distances for r_ in res])
        check(np.isfinite(d).all() and (np.diff(d, axis=1) >= 0).all(),
              f"{label} at r {r}: distances must be finite and ascending")
        rate = qps(search, batches, nb)
        dms = device_trace(search, batches,
                           os.path.join(out_dir, f"trace_approx_{label}_{r}.json"))
        log(f"  {label} approx r {r}: recall_ids@{K} {rec:.4f}, every hit's exact f32 score; "
            f"{dms[0] / len(batches):.4f} device ms a search ({dms[2]} kernels; "
            f"{shares(dms[1], dms[0])}), QPS {rate:.1f} ({rate / ex_qps:.3f} x the exact "
            f"search's)  [{card}]")


def scores_recalled(want, got):
    """How many of `want`'s finite scores (a multiset) `got` holds: the
    recall of a top-k whose scores tie (Hamming, BM25)."""
    a = sorted(x for x in want.tolist() if np.isfinite(x))
    b = sorted(x for x in got.tolist() if np.isfinite(x))
    hit = 0
    while a and b:
        if a[-1] == b[-1]:
            hit, _, _ = hit + 1, a.pop(), b.pop()
        elif a[-1] > b[-1]:
            a.pop()
        else:
            b.pop()
    return hit, int(np.isfinite(want).sum())


def approx_binary_path(dev, card):
    """17d: phase 10's rows (the same corpus and queries, padded to its
    segment's capacity) through `binary_scan_topk` exact and with
    `approx=True`, Hamming: the share of each query's exact top-k scores
    the approximate one recalls, and every Hamming distance numpy's."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import binary

    packed = torch.zeros((APPROX_BIN_CAP, BIN_DIM // 8), dtype=torch.uint8, device=dev)
    packed[:BIN_N] = binary_corpus(dev, BIN_N, BIN_DIM, seed=5)
    x = packed[:BIN_N].cpu().numpy()
    rng = np.random.default_rng(6)
    flips = np.packbits(rng.random((BIN_NQ, BIN_DIM)) < 0.05, axis=1)
    queries = x[rng.choice(BIN_N, BIN_NQ, replace=False)] ^ flips
    q64, x64 = queries.view(np.uint64), x.view(np.uint64)
    hit = tot = 0
    t_ex = t_ap = 0.0
    for i in range(0, BIN_NQ, BIN_BATCH):
        qb = torch.from_numpy(queries[i : i + BIN_BATCH]).to(dev)
        sync(dev)
        t0 = time.perf_counter()
        ev, _ = binary.binary_scan_topk(qb, packed, k=K, metric=Metric.HAMMING, n_valid=BIN_N)
        sync(dev)
        t1 = time.perf_counter()
        av, ar = binary.binary_scan_topk(qb, packed, k=K, metric=Metric.HAMMING, n_valid=BIN_N,
                                         approx=True)
        sync(dev)
        t_ex, t_ap = t_ex + t1 - t0, t_ap + time.perf_counter() - t1
        ev, av, ar = ev.cpu().numpy(), av.cpu().numpy(), ar.cpu().numpy()
        check((ar >= 0).all() and (ar < BIN_N).all(), "17d: a hit outside the rows")
        for j in range(len(ar)):
            want = binary_oracle(x64[ar[j]], q64[i + j : i + j + 1], "Hamming")
            check(np.array_equal(av[j], want), f"17d: query {i + j}'s Hamming distances differ "
                  "from numpy's")
            h, n = scores_recalled(ev[j], av[j])
            hit, tot = hit + h, tot + n
    rec = hit / tot
    check(rec >= 0.99 - APPROX_SLACK, f"17d: the approximate scan recalls {rec:.4f} of the exact "
          "top-k's scores")
    n_b = BIN_NQ // BIN_BATCH
    log(f"  binary {BIN_N:,} x {BIN_DIM} bits, Hamming, batch {BIN_BATCH}: approx (r 0.99) recalls "
        f"{rec:.4f} of the exact top-{K}'s scores, every distance numpy's; host ms a search "
        f"(synchronised) exact {1e3 * t_ex / n_b:.3f}, approx {1e3 * t_ap / n_b:.3f}  [{card}]")


def approx_mesh_path(dev, sift, queries, card):
    """17f: phase 3's 1M segment as four row shards of this card
    (`Mesh([[cuda:0] * 4])`), live rows as the mask, through
    `distributed_scan_topk` exact and with `approx=True`: recall_ids@10 of
    the approximate scan against the exact one, and every hit's exact f32
    score."""
    import torch

    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.parallel.distributed import Mesh, distributed_scan_topk, shard_rows

    grid = Mesh([[dev] * MESH_SHARDS])
    seg = sift.live_segments()[0]
    p = seg.vector("vec")
    ok = torch.arange(seg.capacity, device=dev) < seg.n_rows
    alive = seg.alive_mask_device()
    if alive is not None:
        ok &= alive
    data, aux = shard_rows(grid, p.data), shard_rows(grid, p.aux_for(Metric.L2))
    mask = shard_rows(grid, ok)
    per = seg.capacity // MESH_SHARDS
    hit = 0
    worst = 0.0
    for i in range(0, len(queries), SIFT_BATCH):
        qb = torch.from_numpy(queries[i : i + SIFT_BATCH]).to(dev)
        qb = torch.nn.functional.pad(qb, (0, p.data.shape[1] - qb.shape[1]))
        kw = dict(k=K, metric=Metric.L2, rows_per_shard=per, mask=mask)
        _, er = distributed_scan_topk(grid, qb, data, aux, **kw)
        av, ar = distributed_scan_topk(grid, qb, data, aux, approx=True, **kw)
        check(bool((ar >= 0).all()) and bool(ok[ar.long()].all()), "17f: a masked row came back")
        x = p.data[ar.long()].to(torch.float32)
        want = 2.0 * (qb[:, None, :] * x).sum(-1) - p.aux_for(Metric.L2)[ar.long()]
        close = torch.isclose(av, want, rtol=F32_TOL["rtol"], atol=F32_TOL["atol"])
        check(bool(close.all()), "17f: a hit's score is not its row's exact f32 score")
        worst = max(worst, float((av - want).abs().max()))
        er, ar = er.cpu().numpy(), ar.cpu().numpy()
        hit += sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ar, er))
    rec = hit / (len(queries) * K)
    check(rec >= APPROX_MIN_RECALL, f"17f: recall_ids@{K} {rec:.4f} against the exact mesh scan")
    log(f"  {grid}: distributed_scan_topk(approx=True) over phase 3's {seg.n_rows:,}-row segment "
        f"in {MESH_SHARDS} shards: recall_ids@{K} {rec:.4f} against the exact mesh scan, every "
        f"hit's exact f32 score (largest |diff| {worst:.3g})  [{card}]")


def approx_index_path(dev, t, batches, card):
    """17g: an IVFFLAT, then an HNSWFLAT index on phase 4's table (built,
    searched with cost-based routing off, dropped): the same ids and
    distances with the setting as without it."""
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    for name, kw in (("ivf17", dict(type="IVFFLAT", ncentroids=APPROX_IVF_NCENT)),
                     ("hnsw17", dict(type="HNSWFLAT", **HNSW_PARAMS))):
        t0 = time.perf_counter()
        t.add_vector_index(name, "vec", metric_type="Cosine", **kw)
        check(t.wait_index_built(), f"17g: the {kw['type']} build did not end")
        sync(dev)
        build_s = time.perf_counter() - t0
        plain = t.settings.override({"cost_based_index_routing": "0"})
        appr = approx_settings(t, min(APPROX_TARGETS)).override({"cost_based_index_routing": "0"})
        n0 = GLOBAL_COUNTERS.get("VectorIndexSearches")
        for qb in batches:
            want = t.search("vec", qb, k=K, settings=plain)
            got = t.search("vec", qb, k=K, settings=appr)
            check(np.array_equal(got.rows, want.rows) and np.array_equal(got.segments, want.segments)
                  and np.array_equal(got.distances, want.distances),
                  f"17g: {kw['type']} answers differently with use_approx_topk")
        n_idx = GLOBAL_COUNTERS.get("VectorIndexSearches") - n0
        check(n_idx == 2 * len(batches), f"17g: {kw['type']} searched {n_idx} times, not through "
              "the index every time")
        t.drop_vector_index(name)
        log(f"  {kw['type']} on phase 4's table (built in {build_s:.2f} s): {len(batches)} batches "
            f"return the same ids and distances with use_approx_topk (r {min(APPROX_TARGETS)}) as "
            f"without it")


def approx_path(ms, dev, sift, sift_batches, sift_gt, gist, gist_batches, gist_gt, card, out_dir):
    """Phase 17 (b, c, d, f, g): the approximate top-k's paths."""
    log(f"[17b] phase 3's SIFT table (L2, batch {SIFT_BATCH}) at recall targets {APPROX_TARGETS}")
    approx_table_path("SIFT", sift, sift_batches, sift_gt, SIFT_BATCH, "L2", out_dir, card)
    log(f"[17c] phase 4's GIST table (Cosine, batch {GIST_BATCH}) at recall targets "
        f"{APPROX_TARGETS}")
    approx_table_path("GIST", gist, gist_batches, gist_gt, GIST_BATCH, "Cosine", out_dir, card)
    log(f"[17d] phase 10's rows through binary_scan_topk(approx=True)")
    approx_binary_path(dev, card)
    log(f"[17f] distributed_scan_topk(approx=True) on Mesh([[cuda:0] * {MESH_SHARDS}])")
    approx_mesh_path(dev, sift, np.concatenate(sift_batches), card)
    log("[17g] index searches ignore the setting")
    approx_index_path(dev, gist, gist_batches[:2], card)


def approx_phase(ms, dev, sift, sift_batches, sift_gt, gist, gist_batches, gist_gt, card, args,
                 errs):
    """Phase 17 but (e): the kernel compared (into `errs`) and timed, then
    the paths with the launch counters zeroed just before and read just
    after. Returns (the paths' launches by kernel, the timing record)."""
    from myscaledb_tpu_torch.ops import distance, gathermv, tilescan, topk

    t17 = time.perf_counter()
    log(f"[17a] the approximate top-k's partial reduce against its plain version, and its "
        f"times  [{card}]")
    errs["approx_bin_max"] = compare_approx(dev)
    timing = time_approx(dev, card)
    t_paths = time.perf_counter()
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    gathermv.gather_block_scores.launches = 0
    topk.approx_bin_max.launches = 0
    approx_path(ms, dev, sift, sift_batches, sift_gt, gist, gist_batches, gist_gt, card, args.out)
    p17 = {"approx_bin_max": topk.approx_bin_max.launches, "score": distance.scores.launches,
           "tile_max": tilescan.tile_maxes.launches,
           "tile_rescore": tilescan.tile_rescore.launches,
           "gathermv": gathermv.gather_block_scores.launches}
    log(f"  kernel launches on phase 17's paths: {p17}; phase 17 took "
        f"{time.perf_counter() - t17:.2f} s ({time.perf_counter() - t_paths:.2f} s of paths)")
    for name in ("approx_bin_max", "score", "gathermv"):
        check(p17[name] > 0, f"kernel {name} was not launched on phase 17's paths")
    topk.approx_bin_max.launches = 0
    return p17, timing


def approx_text_path(t, oracle, tb, card):
    """17e, after phase 9: its 50k store's dense BM25 path over its 1,000
    three-word queries with `approx=True` (r 0.99) beside the exact call:
    every hit within DENSE_RTOL of the f64 BM25, and the share of the
    exact call's top-k scores recalled."""
    from myscaledb_tpu_torch.text import inverted

    tdef = t._text_indexes["ft"]
    segs = t.live_segments()
    stats = tdef.merged_stats([s.segment_id for s in segs])
    seg = segs[1]
    store = tdef.store(seg.segment_id)
    doc = seg.scalar("id")[: seg.n_rows].astype(np.int64)
    check(store.plan_batch(tb[0], stats=stats)[3] == "dense", "17e: the 50k store is not dense")
    hit = tot = 0
    worst = 0.0
    for qb in tb:
        ev = store.bm25_topk_batch(qb, K, stats=stats)[0].cpu().numpy()
        av, ar = (a.cpu().numpy() for a in store.bm25_topk_batch(qb, K, stats=stats,
                                                                  approx=True)[:2])
        for i, q in enumerate(qb):
            fin = np.isfinite(av[i])
            sc, cnt = oracle.at(list(dict.fromkeys(q.split())), doc[ar[i][fin]])
            err = np.abs(av[i][fin] - sc)
            bnd = inverted.DENSE_RTOL * np.abs(sc)
            check((cnt >= 1).all() and (err <= bnd).all(),
                  f"17e: query {q!r}: a hit lies outside DENSE_RTOL of its f64 BM25")
            if fin.any():
                worst = max(worst, float((err / bnd).max()))
            h, n = scores_recalled(ev[i], av[i])
            hit, tot = hit + h, tot + n
    rec = hit / max(tot, 1)
    check(rec >= 0.99 - APPROX_SLACK, f"17e: the approximate BM25 recalls {rec:.4f} of the exact "
          "top-k's scores")
    log(f"  the {seg.n_rows:,}-row store's dense BM25, {sum(map(len, tb))} 3-word queries: "
        f"approx (r 0.99) recalls {rec:.4f} of the exact top-{K}'s scores; every hit within "
        f"DENSE_RTOL of the f64 BM25 (worst err/bound {worst:.3g})  [{card}]")



# ---------------------------------------------------------------- phase 18
@contextlib.contextmanager
def eager_bodies():
    """While open, every search program (search/program.py) runs its body
    -- `_fused_multi_search`, a text search's stores and merge, the
    hybrid fuse, the phrase counts -- eagerly on the card through the same
    static buffers and output copy instead of replaying its graph: the
    eager side of phase 18's comparison, made here and nowhere in the
    package (the package has no such setting)."""
    import torch

    from myscaledb_tpu_torch.search import program

    real = program.Program.run

    def run(self, queries, masks=(), dyn=None):
        on_card = torch.cuda.device(self.device) if self.device.type == "cuda" else (
            contextlib.nullcontext())
        with self.lock, on_card:
            self._load(queries, masks, dyn)
            self.out.copy_(self._call_body())
            return self.out.clone()

    program.Program.run = run
    try:
        yield
    finally:
        program.Program.run = real


PROGRAM_ROUNDS = 5  # one-pass QPS rounds of each path, run in turns
PROGRAM_COUNTERS = ("SearchProgramCaptures", "SearchProgramReplays", "SearchProgramEvictions",
                    "SearchProgramWarmupLaunches")
PROGRAM_SERVER_POINTS = (("sync", 8), ("async", 64))
PROGRAM_SERVER_SECONDS = 1.0


def program_counters():
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    return {n: GLOBAL_COUNTERS.get(n) for n in PROGRAM_COUNTERS}


def counter_delta(before):
    now = program_counters()
    return {n[len("SearchProgram"):]: now[n] - before[n] for n in PROGRAM_COUNTERS}


def same_packed(label, got, want):
    """Two lists of SearchResults hold the same ids, tags and scores, bit
    for bit (the packed int32 outputs and the segment tables); or of a
    MeshTable's packed outputs (tensors)."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, torch.Tensor):
            same = torch.equal(g, w)
        else:
            check(g._packed is not None and w._packed is not None,
                  f"{label}: not a program's result")
            same = torch.equal(g._packed, w._packed) and np.array_equal(g._seg_ids, w._seg_ids)
        check(same, f"{label}: batch {i}: the graph replay and the eager body disagree")


def api_trace(search, batches, trace_path):
    """One profiled pass (`trace_events`): (device ms, kernels, host
    launch-API calls, graph launches, the three largest device events by
    name as (share, name)) of the pass. The launch calls are the CUDA
    runtime and driver events that launch, copy or set (cudaLaunchKernel,
    cudaGraphLaunch, cudaMemcpyAsync, cudaMemsetAsync, their driver
    forms): what the host pays a search."""
    events, dev = trace_events(search, batches, trace_path)
    api = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and any(w in e.get("name", "") for w in ("Launch", "Memcpy", "Memset"))]
    graphs = sum("GraphLaunch" in e["name"] for e in api)
    total = sum(e["dur"] for e in dev)
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(((d / total, n[:60]) for n, d in by_name.items()), reverse=True)[:3]
    return total / 1e3, sum(e["cat"] == "kernel" for e in dev), len(api), graphs, top


def one_pass_seconds(search, batches):
    import torch

    t0 = time.perf_counter()
    for qb in batches:
        search(qb)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def program_cells(cells, card, out_dir):
    """Phase 18 over `cells` of (label, search, batches, mutate[, opts]):
    each batch through the table's program (a graph replay) and through
    the same program's body run eagerly (`eager_bodies`), bit for bit; per
    search for both paths the host launch-API calls, the kernels, device
    ms and busy share (device ms over the median unprofiled pass), and the
    median one-pass QPS of PROGRAM_ROUNDS passes, run in turns (graph,
    eager, eager, graph, ...); the captures and replays of the first pass,
    then `mutate()` (which moves the table's segment-set version without
    changing its rows) and the recapture it costs. `opts`: "programs" a
    search replays (1), the "recaptures" after the mutation (1), and the
    most host launch-API calls a replayed search may make ("max_api",
    None: no limit). Returns {label: the numbers}."""
    import statistics

    out = {}
    for label, search, batches, mutate, *rest in cells:
        opts = {"programs": 1, "recaptures": 1, "max_api": None, **(rest[0] if rest else {})}
        # a hybrid cell's batch is a (vectors, texts) pair
        nb = len(batches)
        nq = sum(len(qb[0]) if isinstance(qb, tuple) else len(qb) for qb in batches)
        c0 = program_counters()
        graph = [search(qb) for qb in batches]
        first = counter_delta(c0)
        with eager_bodies():
            eager = [search(qb) for qb in batches]
        same_packed(label, graph, eager)
        check(first["Replays"] == opts["programs"] * nb,
              f"{label}: the first pass made {first}, not {opts['programs'] * nb} replays")
        walls = {"graph": [], "eager": []}
        for r in range(PROGRAM_ROUNDS):
            for side in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
                if side == "eager":
                    with eager_bodies():
                        walls[side].append(one_pass_seconds(search, batches))
                else:
                    walls[side].append(one_pass_seconds(search, batches))
        c1 = program_counters()
        stats = {}
        for side in ("graph", "eager"):
            path = os.path.join(out_dir, f"trace_program_{label}_{side}.json")
            if side == "eager":
                with eager_bodies():
                    dev_ms, kernels, api, graph_launches, top = api_trace(search, batches, path)
            else:
                dev_ms, kernels, api, graph_launches, top = api_trace(search, batches, path)
            wall = statistics.median(walls[side])
            stats[side] = dict(
                qps=statistics.median(nq / w for w in walls[side]), api=api / nb,
                graph_launches=graph_launches / nb, kernels=kernels / nb, dev_ms=dev_ms / nb,
                busy=dev_ms / (1e3 * wall), wall_ms=1e3 * wall / nb, top=top)
        steady = counter_delta(c1)
        check(steady["Captures"] == 0, f"{label}: a steady pass captured again: {steady}")
        mutate()
        c2 = program_counters()
        after = search(batches[0])
        with eager_bodies():
            after_eager = search(batches[0])
        same_packed(f"{label} after the mutation", [after], [after_eager])
        re = counter_delta(c2)
        check(re["Captures"] == opts["recaptures"],
              f"{label}: the search after a mutation made {re}, not {opts['recaptures']} captures")
        g, e = stats["graph"], stats["eager"]
        check(g["graph_launches"] >= opts["programs"],
              f"{label}: the profiled graph pass launched {g['graph_launches']} graphs a search")
        check(opts["max_api"] is None or g["api"] <= opts["max_api"],
              f"{label}: {g['api']:.1f} host launch-API calls a search, more than {opts['max_api']}")
        for side, st in stats.items():
            log(f"  {label} {side:>5}: {st['api']:.1f} host launch-API calls / search "
                f"({st['graph_launches']:.0f} graph launches), {st['kernels']:.1f} kernels / "
                f"search, device {st['dev_ms']:.4f} ms / search, busy share {st['busy']:.3f} "
                f"(median pass {st['wall_ms']:.4f} ms / search), QPS median "
                f"{st['qps']:.1f} of {PROGRAM_ROUNDS} one-pass rounds; largest device shares "
                f"{', '.join(f'{s:.3f} {n}' for s, n in st['top'])}  [{card}]")
        log(f"  {label}: ids, tags and scores bit-equal in all {nb} batches and after the "
            f"mutation; first pass {first}, steady passes {steady}, after the mutation {re}; "
            f"graph / eager QPS {g['qps'] / e['qps']:.3f}")
        out[label] = stats
    return out


def program_path(ms, dev, sift, sift_batches, gist, gist_batches, ivf_op, card, out_dir):
    """18a-d: phase 3's SIFT table (exact: tile_max on the 1M segment,
    score on the 50k one), phase 4's GIST table (exact, score), HNSWFLAT
    on phase 4's table at ef_s 100 (gathermv; a fresh build, dropped
    after) and IVFFLAT on phase 3's at phase 8's nprobe (dropped after).
    The mutation of each cell is an ADD COLUMN and DROP COLUMN pair: the
    segment-set version moves, the rows do not."""
    from myscaledb_tpu_torch.index.base import IndexStatus

    def alter(t):
        def run():
            t.add_column("p18", ms.Int32())
            t.drop_column("p18")
        return run

    graph = ms.Settings()
    graph.query.cost_based_index_routing = False
    hb = gist_batches[:HNSW_BATCHES]
    cells = [
        ("sift_exact", lambda qb: sift.search("vec", qb, k=K, metric="L2"), sift_batches,
         alter(sift)),
        ("gist_exact", lambda qb: gist.search("vec", qb, k=K), gist_batches, alter(gist)),
    ]
    out = program_cells(cells, card, out_dir)
    gist.add_vector_index("h18", "vec", type="HNSWFLAT", metric_type="Cosine", **HNSW_PARAMS)
    sift.add_vector_index("ivf18", "vec", type="IVFFLAT", ncentroids=IVF_NCENT, metric_type="L2")
    check(gist.wait_index_built() and sift.wait_index_built(),
          "phase 18's index builds did not end")
    check(gist.index_status("h18") == {0: IndexStatus.LOADED} and
          sift.index_status("ivf18") == {0: IndexStatus.LOADED, 1: IndexStatus.SMALL_PART},
          "phase 18's indexes did not load")
    out.update(program_cells([
        ("hnsw_ef100", lambda qb: gist.search("vec", qb, k=K, params={"ef_s": 100},
                                              settings=graph), hb, alter(gist)),
        (f"ivfflat_nprobe{ivf_op}", lambda qb: sift.search("vec", qb, k=K, metric="L2",
                                                          params={"nprobe": ivf_op}),
         sift_batches, alter(sift)),
    ], card, out_dir))
    gist.drop_vector_index("h18")
    sift.drop_vector_index("ivf18")
    return out


def program_binary_path(ms, t, batches, card, out_dir):
    """18e-f, on phase 10's table before it is dropped: the binary rows
    layout (the Jaccard exact scan: the index is Hamming's) and
    BinaryMSTG (Hamming). The mutation deletes one row no query found."""
    from myscaledb_tpu_torch import F

    gone = iter(range(BIN_N - 1, 0, -1))

    def delete():
        while True:
            i = next(gone)
            if t.delete(F("id") == i) == 1:
                return

    return program_cells([
        ("binary_rows", lambda qb: t.search("bv", qb, k=K, metric="Jaccard"), batches, delete),
        ("binary_mstg", lambda qb: t.search("bv", qb, k=K), batches, delete),
    ], card, out_dir)


def graph_pool_bytes(device):
    """(reserved, allocated) bytes of the device's graph pool
    (search/program.py: every program of a device captures into it), from
    a memory snapshot: its segments, and the blocks the live graphs hold;
    None off the card."""
    import torch

    from myscaledb_tpu_torch.search import program

    if device.type != "cuda":
        return None
    pool = tuple(program._device_state(program.normalize_device(device)).pool)
    segs = [s for s in torch.cuda.memory._snapshot()["segments"]
            if tuple(s.get("segment_pool_id", ())) == pool]
    return sum(s["total_size"] for s in segs), sum(s["allocated_size"] for s in segs)


TEXT_MAX_API = 8  # host launch-API calls a replayed text search may make
HYBRID_MAX_API = 16  # and a hybrid one (the vector, text and fuse programs)


def program_text_path(ms, t, vb, tb, lb, here, card, out_dir):
    """18h-k, on phase 9's table before it is dropped: text BM25 over the
    3-word batches (the sparse route on the 1M store, dense on the 50k),
    over the 8-word ones (dense on both), hybrid RRF and hybrid RSF, each
    a program (a hybrid search three: the vector, text and fuse programs).
    The mutation is an ADD COLUMN and DROP COLUMN pair: the text program
    recaptures, and a hybrid search's vector program too (the fuse reads
    no table). Also logs the host syncs inside one text and one hybrid
    search and the graph pool's reserved bytes before and after."""
    import torch

    from myscaledb_tpu_torch.search import text_executor

    def alter():
        t.add_column("p18", ms.Int32())
        t.drop_column("p18")

    pairs = list(zip(vb, tb))
    text = {"max_api": TEXT_MAX_API}
    hyb = {"programs": 3, "recaptures": 2, "max_api": HYBRID_MAX_API}
    device = t.live_segments()[0].device
    # the graphs' own bytes: the pool's allocated blocks across one capture
    # of each text program, made afresh
    t._programs.invalidate()
    pools = [graph_pool_bytes(device)]
    for qb in (lb[0], tb[0]):
        t.text_search("body", qb, k=K)
        pools.append(graph_pool_bytes(device))
    if pools[0] is not None:
        log(f"  the graph pool (reserved, allocated bytes): {pools[0]} with no text program, "
            f"{pools[1]} after capturing the 8-word one (dense on both stores: "
            f"{pools[1][1] - pools[0][1]:+,} allocated), {pools[2]} after the 3-word one "
            f"(sparse on the 1M store: {pools[2][1] - pools[1][1]:+,})  [{card}]")
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    out = {}
    for cell in [
        ("text_3word", lambda qb: t.text_search("body", qb, k=K), tb, alter, text),
        ("text_8word", lambda qb: t.text_search("body", qb, k=K), lb, alter, text),
        ("hybrid_rrf", lambda p: t.hybrid_search("vec", "body", p[0], p[1], k=K,
                                                 fusion_type="rrf"), pairs, alter, hyb),
        ("hybrid_rsf", lambda p: t.hybrid_search("vec", "body", p[0], p[1], k=K,
                                                 fusion_type="rsf"), pairs, alter, hyb),
    ]:
        pool0 = graph_pool_bytes(device)
        out.update(program_cells([cell], card, out_dir))
        log(f"  {cell[0]}: the graph pool (reserved, allocated bytes) {pool0} before the cell, "
            f"{graph_pool_bytes(device)} after  [{card}]")
    torch.cuda.synchronize()
    after = torch.cuda.memory_reserved()
    log(f"  18h-k: the caching allocator's reserved bytes {before:,} before the text cells, "
        f"{after:,} after ({after - before:+,}: the graphs' shared pool and the eager bodies' "
        f"cached blocks); {len(t._programs)} programs cached, "
        f"{len(text_executor._FUSE_PROGRAMS)} fuse programs  [{card}]")
    res, s_text = host_syncs(lambda: t.text_search("body", tb[0], k=K), here)
    _, s_hyb = host_syncs(lambda: t.hybrid_search("vec", "body", vb[0], tb[0], k=K,
                                                  fusion_type="rrf"), here)
    log(f"  host syncs inside one text search: {s_text or 0}; inside one hybrid search: "
        f"{s_hyb or 0}")
    check(not s_text and not s_hyb, f"a text or hybrid search synced the host: {s_text} {s_hyb}")
    check(res.valid.any(), "18h's text search found nothing")
    return out


MESH_FILTER_API = 2  # a filtered mesh search's launch calls a shard outside its program


def program_mesh_table(ms, dev, sift):
    """18l-n's table: 16a's (phase 3's corpus with its price column and 100
    deletes) in a MeshTable over MESH_SHARDS entries of this card."""
    from myscaledb_tpu_torch.parallel.distributed import Mesh

    parts = stored_corpus(sift)
    ids = np.concatenate([p[0] for p in parts]).astype(np.int64)
    rows = np.zeros((len(ids), SIFT_D), np.float32)
    rows[ids] = np.concatenate([p[1] for p in parts])
    del parts
    price = np.random.default_rng(16).integers(0, 1000, len(ids)).astype(np.int32)
    t = ms.MeshTable("mesh18", SIFT_D, mesh=Mesh([[dev] * MESH_SHARDS]), filter_columns=("price",))
    t.insert({"id": np.arange(len(ids)), "vec": rows, "price": price})
    t.delete(np.arange(100))
    t._seal()
    return t


def program_mesh_text_table(ms, dev, hyb):
    """18o's table: 16d's (phase 9's documents and vectors, its deletes) in
    a text MeshTable over MESH_SHARDS entries of this card."""
    from myscaledb_tpu_torch.parallel.distributed import Mesh

    segs = hyb.live_segments()
    hids = np.concatenate([sg.scalar("id")[: sg.n_rows] for sg in segs]).astype(np.int64)
    docs = np.concatenate([sg.scalar("body")[: sg.n_rows] for sg in segs]).astype(object)
    dead = hids[np.concatenate([sg.deleted_host()[: sg.n_rows] for sg in segs])]
    hv = np.concatenate([v for _, v in stored_corpus(hyb)])
    t = ms.MeshTable("mesh18_text", SIFT_D, mesh=Mesh([[dev] * MESH_SHARDS]), text_column="body")
    t.insert({"id": hids, "vec": hv, "body": docs})
    if len(dead):
        t.delete(dead)
    t._text_index()
    return t


def program_mesh_path(ms, dev, sift, queries, hyb, vb, tb, op, here, card, out_dir):
    """18l-o: MeshTable's programs (parallel/distributed.py::MeshProgram; on
    this one-card grid one CUDA graph a search) against their bodies run
    eagerly, on 16a's table: 18l exact and price < MESH_PRICE_CUT (1%);
    18m IVF at nprobe `op`, then MESH_NEW rows appended (the delta route);
    18n the two-stage route at `op`; 18o phase 9's documents: 3-word BM25,
    hybrid RRF and RSF. Each cell's mutation is in place (a delete, or in
    the delta cell one more appended row): the replay reads it with no
    recapture. Each cell: bit-equal batches, 0 host syncs in one search,
    launch calls within the bound (MESH_FILTER_API a shard on top for the
    filter's own kernels and its mask's copy), the graph pool's bytes."""
    import torch

    t0 = time.perf_counter()
    t = program_mesh_table(ms, dev, sift)
    log(f"  18l-n's table: {t.n_rows:,} rows over {t.mesh} ({t._s.cap:,} slots a shard) in "
        f"{time.perf_counter() - t0:.2f} s")
    batches = [queries[i : i + SIFT_BATCH] for i in range(0, len(queries), SIFT_BATCH)]
    n_ids = t.n_rows + 100  # ids 0 .. n_ids - 1, the first 100 deleted
    gone = iter(range(n_ids - 1, 100, -1))

    def delete(table):
        def run():
            check(table.delete(next(gone)) == 1, "the mesh delete removed another count")
        return run

    def vector(**kw):
        return lambda qb: t._vector_run(qb, K, **kw)[0]

    def cheap(price):
        return price < MESH_PRICE_CUT

    plain = {"max_api": TEXT_MAX_API, "recaptures": 0}
    filtered = {"max_api": TEXT_MAX_API + MESH_FILTER_API * MESH_SHARDS, "recaptures": 0}
    out = {}

    def cells(cs, syncs_of):
        for cell in cs:
            pool0 = graph_pool_bytes(dev)
            out.update(program_cells([cell], card, out_dir))
            _, s = host_syncs(lambda: syncs_of[cell[0]](cell[2][0]), here)
            check(not s, f"{cell[0]}: one search synced the host: {s}")
            log(f"  {cell[0]}: 0 host syncs in one search; the graph pool (reserved, allocated "
                f"bytes) {pool0} before the cell, {graph_pool_bytes(dev)} after  [{card}]")

    ivf = {"nprobe": op}
    vcells = [("mesh_exact", vector(), batches, delete(t), plain),
              ("mesh_filtered", vector(filter=cheap), batches, delete(t), filtered)]
    cells(vcells, {c[0]: c[1] for c in vcells})
    t0 = time.perf_counter()
    t.build_ivf(IVF_NCENT)
    sync(dev)
    log(f"  build_ivf({IVF_NCENT}) {time.perf_counter() - t0:.2f} s (bucket_pad {t._ivf[-1]})")
    icell = [(f"mesh_ivf_nprobe{op}", vector(params=ivf), batches, delete(t), plain)]
    cells(icell, {icell[0][0]: icell[0][1]})
    n0 = n_ids
    new = make_corpus(MESH_NEW, SIFT_D, seed=18, centers=corpus_centers(SIFT_D))
    sealed = t._s
    t.insert({"id": np.arange(n0, n0 + MESH_NEW), "vec": new,
              "price": np.zeros(MESH_NEW, np.int32)})
    check(t._s is sealed and t._ivf is not None, "the append resealed the table or dropped its IVF")
    extra = iter(range(n0 + MESH_NEW, n0 + 2 * MESH_NEW))
    inserted = []

    def append_one():
        i = next(extra)
        t.insert({"id": np.array([i]), "vec": batches[0][:1] + np.float32(1e-3),
                  "price": np.zeros(1, np.int32)})
        inserted.append(i)

    dcell = [(f"mesh_ivf_delta", vector(params=ivf), batches, append_one, plain)]
    cells(dcell, {dcell[0][0]: dcell[0][1]})
    c0 = program_counters()
    got = t.search(batches[0], K, params=ivf)
    check(counter_delta(c0)["Captures"] == 0 and got[0][0, 0] == inserted[-1],
          f"the row appended in place after the capture is not the replay's top hit: {got[0][0]}")
    log(f"  18m: {MESH_NEW:,} rows appended after the build (the delta route), then one more in "
        f"place after its capture: the next replay returns it first, with no recapture")
    t0 = time.perf_counter()
    t.build_mstg(IVF_NCENT)
    sync(dev)
    log(f"  build_mstg({IVF_NCENT}) {time.perf_counter() - t0:.2f} s")
    ncell = [(f"mesh_twostage_nprobe{op}", vector(params=ivf), batches, delete(t), plain)]
    cells(ncell, {ncell[0][0]: ncell[0][1]})
    del t

    t0 = time.perf_counter()
    tt = program_mesh_text_table(ms, dev, hyb)
    log(f"  18o's table: {tt.n_rows:,} documents over {tt.mesh} in "
        f"{time.perf_counter() - t0:.2f} s")
    gone = iter(range(tt.n_rows - 1, 0, -1))

    def text(qb):
        return tt._text_run(qb, K)[0]

    def hybrid(ftype):
        return lambda p: tt._hybrid_run(p[0], p[1], K, filter=None, params=None,
                                        fusion_k=HYBRID_FUSION_K, fusion_type=ftype,
                                        fusion_weight=HYBRID_WEIGHT)[0]

    def tdelete():
        while tt.delete(next(gone)) != 1:
            pass

    pairs = list(zip(vb, tb))
    hyb_opts = {"max_api": HYBRID_MAX_API, "recaptures": 0}
    tcells = [("mesh_text_3word", text, tb, tdelete, plain),
              ("mesh_hybrid_rrf", hybrid("rrf"), pairs, tdelete, hyb_opts),
              ("mesh_hybrid_rsf", hybrid("rsf"), pairs, tdelete, hyb_opts)]
    cells(tcells, {c[0]: c[1] for c in tcells})
    del tt
    torch.cuda.synchronize()
    return out


def program_serving(srv, clock, t, queries, oracle, card):
    """18g, inside 14d: the coalescing server's grid at PROGRAM_SERVER_POINTS
    with each window cut to PROGRAM_SERVER_SECONDS, PROGRAM_ROUNDS rounds
    of each path in turns: median QPS, groups, and every response against
    the exact oracle."""
    import statistics

    idmap = id_map(t)
    rates = {}
    for mode, conns in PROGRAM_SERVER_POINTS:
        for r in range(PROGRAM_ROUNDS):
            for side in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
                ctx = eager_bodies() if side == "eager" else contextlib.nullcontext()
                with ctx:
                    c0 = program_counters()
                    rate, got, groups, reqs, _ = serving_grid(srv, clock, t.name, queries, conns,
                                                              mode, PROGRAM_SERVER_SECONDS)
                    d = counter_delta(c0)
                qi = np.array([q for q, _ in got])
                check_oracle(f"18g {side} {mode} {conns}",
                             hit_ids(idmap, np.stack([o["segments"] for _, o in got]),
                                     np.stack([o["rows"] for _, o in got])),
                             l2_scores(queries[qi], np.stack([o["distances"] for _, o in got])),
                             oracle[0][qi], oracle[1][qi])
                rates.setdefault((mode, conns, side), []).append((rate, groups, reqs, d))
        for side in ("graph", "eager"):
            runs = rates[(mode, conns, side)]
            log(f"  18g server {mode} {conns:>2} connections {side:>5}: QPS median "
                f"{statistics.median(x[0] for x in runs):.1f} of {PROGRAM_ROUNDS} windows of "
                f"{PROGRAM_SERVER_SECONDS:g} s (min {min(x[0] for x in runs):.1f}, max "
                f"{max(x[0] for x in runs):.1f}); mean group "
                f"{sum(x[2] for x in runs) / max(1, sum(x[1] for x in runs)):.2f} requests; "
                f"program counters over the windows "
                f"{ {k: sum(x[3][k] for x in runs) for k in runs[0][3]} }  [{card}]")
    return rates


def program_binary_table(ms, dev):
    """--programs-only: phase 10's table (the same rows and queries) with
    its BinaryMSTG, without phase 10's checks. Returns (db, table,
    batches)."""
    packed = binary_corpus(dev, BIN_N, BIN_DIM, seed=5).cpu().numpy()
    rng = np.random.default_rng(6)
    flips = np.packbits(rng.random((BIN_NQ, BIN_DIM)) < 0.05, axis=1)
    queries = packed[rng.choice(BIN_N, BIN_NQ, replace=False)] ^ flips
    db = ms.connect(device=dev)
    t = db.create_table("bin", ms.Schema({"id": ms.UInt64(), "bv": ms.BinaryVector(BIN_DIM)}))
    t.insert({"id": np.arange(BIN_N, dtype=np.uint64), "bv": packed})
    t.add_vector_index("bm", "bv", type="BinaryMSTG")
    check(t.wait_index_built(), "the BinaryMSTG build did not end")
    return db, t, [queries[i : i + BIN_BATCH] for i in range(0, BIN_NQ, BIN_BATCH)]


def program_serving_alone(ms, db, t, queries, card):
    """--programs-only: 18g on a server of its own over phase 3's table."""
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.service.server import SearchServer

    gv, gs, gr = exact_topk(t, "vec", queries, K, Metric.L2)
    oracle = (hit_ids(id_map(t), gs, gr), gv.astype(np.float64))
    srv = SearchServer(db, max_batch=256, max_delay_ms=2.0)
    clock = GroupClock(srv)
    try:
        for b in (1, 8, 32, 64, 128, 256):
            for f in [srv.submit_search(t.name, "vec", queries[i % len(queries)], K)
                      for i in range(b)]:
                f.result()
        program_serving(srv, clock, t, queries, oracle, card)
    finally:
        srv.close()


def main(argv=None):
    import argparse
    import gc

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="show where each cell's time goes (phases 5 and 6)")
    ap.add_argument("--out", default=os.path.join("myscaledb_tpu_torch", "_build", "profile"),
                    help="directory for --profile's (and phase 13's) traces and host profiles")
    ap.add_argument("--mesh-cards", action="store_true",
                    help="run the set-up and MeshTable over every visible card (two or more) "
                         "against the same shards on one card, and print no record")
    ap.add_argument("--f32-tables-only", action="store_true",
                    help="run the set-up and phase 13 (the device f32 tables) only, and print "
                         "no record: a side of a same-machine comparison")
    ap.add_argument("--approx-only", action="store_true",
                    help="run the set-up, phases 3-4 and phase 17 (the approximate top-k, "
                         "without its text part) only, and print no record")
    ap.add_argument("--programs-only", action="store_true",
                    help="run the set-up, phases 3-4 and phase 18 (the search programs against "
                         "their eager bodies, on its own IVFFLAT at nprobe 2, its own binary "
                         "table, phase 9's text table and the mesh tables of 18l-o) only, and "
                         "print no record")
    ap.add_argument("--rescore-only", action="store_true",
                    help="run the set-up and the rescore kernel's comparison and times only, "
                         "and print no record")
    ap.add_argument("--window-scan-only", action="store_true",
                    help="run the set-up and the IVF window scan kernel's comparison and times "
                         "only, and print no record")
    ap.add_argument("--row-rescore-only", action="store_true",
                    help="run the set-up and the two-stage re-rank kernel's comparison and "
                         "times only, and print no record")
    ap.add_argument("--root", default=None,
                    help="import myscaledb_tpu_torch from this checkout (another commit's, "
                         "for a same-machine comparison) instead of this file's")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to drive",
              file=sys.stderr)
        return 1
    here = os.path.abspath(args.root or os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(os.path.join(here, "myscaledb_tpu_torch")):
        print("chip_smoke: run it from a checkout: myscaledb_tpu_torch/ is missing",
              file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    import myscaledb_tpu_torch as ms
    from myscaledb_tpu_torch.ops import (
        _cuda, binary, distance, gathermv, rowrescore, tilescan, topk, windowscan)

    # ---- 1. set-up
    t_start = time.perf_counter()
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
    if args.mesh_cards:
        from myscaledb_tpu_torch.parallel.distributed import make_mesh

        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        check(len(devices) >= 2, f"--mesh-cards needs two or more cards, {len(devices)} visible")
        check(make_mesh().devices == (tuple(devices),), "make_mesh() is not one row of the cards")
        for line in subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60).stdout.splitlines():
            log(f"  {line}")
        log(f"[16x] MeshTable over {len(devices)} cards against the same shards on one card")
        mesh_cards_path(ms, devices, card)
        log(f"chip_smoke: the mesh over {len(devices)} cards passed in "
            f"{time.perf_counter() - t_start:.1f} s  [{card}]")
        return 0
    if args.f32_tables_only:
        log(f"[13] device f32 tables (package from {here})")
        log(f"  kernel launches on the f32 tables: {f32_table_path(ms, dev, card, args.out)}")
        log(f"chip_smoke: phase 13 alone passed in {time.perf_counter() - t_start:.1f} s  [{card}]")
        return 0

    if args.rescore_only:
        log("[7r] the rescore kernel at the exact cells' shapes")
        rescore_path(dev, card)
        log(f"chip_smoke: the rescore kernel passed in {time.perf_counter() - t_start:.1f} s  "
            f"[{card}]")
        return 0
    if args.window_scan_only:
        log("[7w] the window scan kernel at the IVF cells' shapes")
        window_scan_path(dev, card)
        log(f"chip_smoke: the window scan kernel passed in {time.perf_counter() - t_start:.1f} s"
            f"  [{card}]")
        return 0
    if args.row_rescore_only:
        log("[7q] the re-rank kernel at the Cohere cells', a filtered IVFFLAT and an IVFSQ shape")
        row_rescore_path(dev, card)
        log(f"chip_smoke: the re-rank kernel passed in {time.perf_counter() - t_start:.1f} s"
            f"  [{card}]")
        return 0

    # ---- 2. kernels vs their plain versions
    errs = {}
    if not args.approx_only:
        log("[2] kernels vs plain versions on the card")
        errs = compare_kernels(dev)
        errs["gathermv"] = compare_gathermv(dev)
        errs["binary"] = compare_binary(dev)

    # ---- 3./4. the exact paths, with their launch counters zeroed
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    log("[3] SIFT1M-shaped exact path (1,000,000 + 50,000 rows x 128, L2, batch 100, k=10)")
    sift, sift_batches, flt, sift_queries, sift_gt, sift_db = sift_path(ms, dev)
    log("[4] GIST-shaped exact path (100,000 x 960, Cosine, batch 256, k=10)")
    gist, gist_batches, gist_gt, gist_db = gist_path(ms, dev)
    launches = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
                "tile_rescore": tilescan.tile_rescore.launches}
    log(f"  kernel launches on the exact paths: {launches}")
    for name in ("score", "tile_max", "tile_rescore"):
        check(launches[name] > 0, f"kernel {name} was not launched on the exact paths")
    check_rescores(launches, "the exact paths")
    check(topk.approx_bin_max.launches == 0, "the exact paths launched approx_bin_max")

    if args.programs_only:
        log("[18] search programs: graph replays against eager bodies")
        program_path(ms, dev, sift, sift_batches, gist, gist_batches, 2, card, args.out)
        bin_db, bin_t, bin_batches = program_binary_table(ms, dev)
        program_binary_path(ms, bin_t, bin_batches, card, args.out)
        bin_db.drop_table("bin")
        del bin_t
        log(f"[18h-k] text and hybrid programs on phase 9's table ({SIFT_N:,} + "
            f"{SIFT_SMALL_N:,} rows)")
        hyb, _, _, text_tb, text_lb, _, text_vb = text_table(ms, dev, card, sift_db)
        program_text_path(ms, hyb, text_vb, text_tb, text_lb, here, card, args.out)
        log(f"[18l-o] MeshTable programs over {MESH_SHARDS} shards of the card")
        program_mesh_path(ms, dev, sift, sift_queries, hyb, text_vb, text_tb, 2, here, card,
                          args.out)
        sift_db.drop_table("hybrid")
        del hyb
        log("[18g] the coalescing server on phase 3's table, graph replays against eager bodies")
        program_serving_alone(ms, sift_db, sift, sift_queries, card)
        log(f"chip_smoke: phases 3, 4 and 18 passed in {time.perf_counter() - t_start:.1f} s  "
            f"[{card}]")
        return 0

    # ---- 5. the exact paths' QPS (before phase 6 indexes the GIST table)
    if args.approx_only:
        approx_phase(ms, dev, sift, sift_batches, sift_gt, gist, gist_batches, gist_gt, card,
                     args, errs)
        log(f"chip_smoke: phases 3, 4 and 17 passed in {time.perf_counter() - t_start:.1f} s  "
            f"[{card}]")
        return 0
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

    # ---- 17. the approximate top-k on phases 3-4's tables (before phase 6
    # indexes phase 4's), with the launch counters zeroed inside
    p17, timing17 = approx_phase(ms, dev, sift, sift_batches, sift_gt, gist, gist_batches,
                                 gist_gt, card, args, errs)

    # ---- 6. the HNSW path, with the gathermv launch counter zeroed
    log("[6] HNSW path on phase 4's table (HNSWFLAT m=32 ef_c=100, Cosine, batch 256, k=10)")
    gathermv.gather_block_scores.launches = 0
    graph, hb, idx, curve = hnsw_path(ms, dev, gist, gist_batches, gist_gt, card, args.out)
    launches["gathermv"] = gathermv.gather_block_scores.launches
    log(f"  gathermv launches on the HNSW path: {launches['gathermv']}")
    check(launches["gathermv"] > 0, "kernel gathermv was not launched on the HNSW path")
    if args.profile:
        log(f"[6p] where the time goes on {card}")
        profile_cells([("hnsw_graph_ef100", lambda qb: gist.search(
            "vec", qb, k=K, params={"ef_s": 100}, settings=graph), hb)],
            PROFILE_RUNS, args.out, card)

    check_rescores(p17, "phase 17")
    for name, n in p17.items():
        launches[name] = launches.get(name, 0) + n

    # ---- 7. times
    log(f"[7] times on {card}")
    timing = time_kernels(dev, idx, card)
    timing["approx_bin_max"] = timing17
    timing["tile_rescore"] = rescore_path(dev, card)
    timing["window_scan"] = window_scan_path(dev, card)
    timing["row_rescore"] = row_rescore_path(dev, card)
    cost_model(gist, gist_scan, graph, hb, card, args.out)

    # ---- 8. the IVF family and HNSWPQ, with the launch counters zeroed
    log(f"[8] IVF path on phase 3's table (IVFFLAT ncentroids={IVF_NCENT}, then IVFSQ, IVFPQ "
        f"and a default MSTG; L2, k=10) and HNSWPQ on phase 4's")
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    gathermv.gather_block_scores.launches = 0
    windowscan.window_scan.launches = 0
    rowrescore.row_rescore.launches = 0
    ivf_op, mstg_op = ivf_path(dev, sift, sift_batches, sift_queries, sift_gt, card, args)
    hnswpq_path(ms, dev, gist, gist_batches, np.concatenate(gist_batches), card)
    p8 = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
          "tile_rescore": tilescan.tile_rescore.launches,
          "gathermv": gathermv.gather_block_scores.launches}
    log(f"  kernel launches on the IVF and HNSWPQ paths: {p8}; window_scan "
        f"{windowscan.window_scan.launches}, row_rescore {rowrescore.row_rescore.launches}")
    check_rescores(p8, "phase 8")
    for name, n in p8.items():
        check(n > 0, f"kernel {name} was not launched on phase 8's paths")
        launches[name] += n
    launches["window_scan"] = windowscan.window_scan.launches
    check(launches["window_scan"] > 0, "kernel window_scan was not launched on phase 8's paths")
    launches["row_rescore"] = rowrescore.row_rescore.launches
    check(launches["row_rescore"] > 0, "kernel row_rescore was not launched on phase 8's paths")

    # ---- 9. text and hybrid search (score and tile_max zeroed inside)
    log(f"[9] text and hybrid path ({SIFT_N:,} + {SIFT_SMALL_N:,} rows: body String of "
        f"{TEXT_WORDS} words from {TEXT_VOCAB:,}, vec FloatVector({SIFT_D}); batch {TEXT_BATCH}, k={K})")
    p9, hyb, text_vb, text_tb, text_lb, text_oracle = text_path(ms, dev, card, args, sift_db)
    log(f"  kernel launches on the text and hybrid path: {p9}")
    check_rescores(p9, "phase 9")
    for name, n in p9.items():
        launches[name] += n

    # ---- 17e. the approximate top-k on phase 9's dense store, with its
    # counter zeroed (phases 6-9 must not have launched it)
    check(topk.approx_bin_max.launches == 0, "a phase without the setting launched approx_bin_max")
    log(f"[17e] phase 9's 50k store's dense BM25 with approx=True")
    approx_text_path(hyb, text_oracle, text_tb, card)
    n17e = topk.approx_bin_max.launches
    check(n17e > 0, "kernel approx_bin_max was not launched on phase 17e's path")
    launches["approx_bin_max"] += n17e
    log(f"  approx_bin_max launches on 17e: {n17e}")
    topk.approx_bin_max.launches = 0

    # ---- 10. binary vectors (the binary counters zeroed inside)
    log(f"[10] binary path ({BIN_N:,} x BinaryVector({BIN_DIM}), Hamming and Jaccard, exact scan "
        f"then BinaryMSTG; batch {BIN_BATCH}, k={K})")
    p10, t10, e10, (bin_db, bin_t, bin_batches) = binary_path(ms, dev, card, args)
    launches.update(p10)
    timing.update(t10)
    errs["binary_blocks"] = max(errs["binary"], e10["binary_blocks"])
    errs["binary"] = max(errs["binary"], e10["binary"])
    errs["binary_group"] = e10["binary_group"]

    # ---- 18. the search programs (a CUDA graph a search) against their
    # bodies run eagerly, with the launch counters zeroed
    t18 = time.perf_counter()
    wrappers18 = {"score": distance.scores, "tile_max": tilescan.tile_maxes,
                  "tile_rescore": tilescan.tile_rescore,
                  "gathermv": gathermv.gather_block_scores, "binary": binary.binary_scores,
                  "binary_blocks": binary.binary_block_scores, "binary_group": binary.group_probes}
    for w in wrappers18.values():
        w.launches = 0
    log(f"[18] search programs: each table's program replayed (a CUDA graph) against its body "
        f"run eagerly, on phase 3's and phase 4's tables, HNSWFLAT ef_s 100, IVFFLAT nprobe "
        f"{ivf_op}, phase 10's binary table and phase 9's text table")
    program_path(ms, dev, sift, sift_batches, gist, gist_batches, ivf_op, card, args.out)
    program_binary_path(ms, bin_t, bin_batches, card, args.out)
    bin_db.drop_table("bin")
    del bin_t
    log(f"[18h-k] text and hybrid programs on phase 9's table")
    program_text_path(ms, hyb, text_vb, text_tb, text_lb, here, card, args.out)
    log(f"[18l-o] MeshTable programs over {MESH_SHARDS} shards of the card")
    program_mesh_path(ms, dev, sift, sift_queries, hyb, text_vb, text_tb, ivf_op, here, card,
                      args.out)
    p18 = {name: w.launches for name, w in wrappers18.items()}
    log(f"  kernel launches on phase 18's paths: {p18}; phase 18 took "
        f"{time.perf_counter() - t18:.2f} s")
    check_rescores(p18, "phase 18")
    for name, n in p18.items():
        check(n > 0, f"kernel {name} was not launched on phase 18's paths")
        launches[name] += n

    # ---- 11. the rest of Table and Database, with the launch counters zeroed
    t11 = time.perf_counter()
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    gathermv.gather_block_scores.launches = 0
    log(f"[11a] mutations on phase 3's table (ADD COLUMN, UPDATE, a filter on the new column, "
        f"compute_distances, DROP COLUMN)")
    mutation_path(ms, sift, sift_batches, sift_queries)
    log("[11b] checkpoint and restart: phase 3's table, and phase 4's with a fresh HNSWFLAT, "
        "through persist / connect(path=...) / load_table")
    restart_path(ms, dev, sift, sift_batches, gist, gist_batches[:HNSW_BATCHES], card)
    log(f"[11c] merge with decoupled serving ({SIFT_N:,} rows in two parts, IVFFLAT "
        f"ncentroids={IVF_NCENT} on each), the rebuild, truncate")
    merge_path(ms, dev, sift, sift_queries, ivf_op, card)
    log(f"[11d] FINAL on a ReplacingMergeTree(ver) table ({SIFT_N:,} + {FINAL_DUP:,} rows)")
    final_path(ms, dev, sift, card)
    p11 = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
           "tile_rescore": tilescan.tile_rescore.launches,
           "gathermv": gathermv.gather_block_scores.launches}
    log(f"  kernel launches on phase 11's paths: {p11}; phase 11 took "
        f"{time.perf_counter() - t11:.2f} s")
    check_rescores(p11, "phase 11")
    for name, n in p11.items():
        check(n > 0, f"kernel {name} was not launched on phase 11's paths")
        launches[name] += n

    # ---- 14. the front ends, with the launch counters zeroed (before phase
    # 12, which needs the host memory that phase 9's table still holds)
    t14 = time.perf_counter()
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    gathermv.gather_block_scores.launches = 0
    frontend_path(ms, here, card, sift_db, sift, sift_queries, gist_db, gist,
                  np.concatenate(gist_batches), hyb, text_vb, text_tb)
    p14 = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
           "tile_rescore": tilescan.tile_rescore.launches,
           "gathermv": gathermv.gather_block_scores.launches}
    log(f"  kernel launches on phase 14's paths: {p14}; phase 14 took "
        f"{time.perf_counter() - t14:.2f} s")
    check_rescores(p14, "phase 14")
    for name, n in p14.items():
        check(n > 0, f"kernel {name} was not launched on phase 14's paths")
        launches[name] += n

    # ---- 15. replication and the sharded table, with the launch counters
    # zeroed (before phase 12 too: it needs phase 9's table)
    t15 = time.perf_counter()
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    sh_qps = replication_path(ms, dev, sift, sift_queries, ivf_op, hyb, text_vb, text_tb, card)
    p15 = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
           "tile_rescore": tilescan.tile_rescore.launches}
    s15 = time.perf_counter() - t15
    log(f"  kernel launches on phase 15's paths: {p15}; phase 15 took {s15:.2f} s")
    check_rescores(p15, "phase 15")
    for name, n in p15.items():
        check(n > 0, f"kernel {name} was not launched on phase 15's paths")
        launches[name] += n
    check(s15 <= REP_PHASE_S, f"phase 15 took {s15:.1f} s, more than {REP_PHASE_S} s")

    # ---- 16. MeshTable over four shards of the card, with the launch
    # counters zeroed (before phase 12 too: it needs phase 9's table, and
    # its objects are collected before phase 12 needs the host memory)
    t16 = time.perf_counter()
    distance.scores.launches = 0
    tilescan.tile_maxes.launches = 0
    tilescan.tile_rescore.launches = 0
    ref16 = mesh_path(ms, dev, sift, sift_queries, hyb, text_oracle, text_vb, text_tb,
                      {"phase 5": sift_qps, "15c": sh_qps}, card)
    p16 = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
           "tile_rescore": tilescan.tile_rescore.launches}
    del text_oracle
    gc.collect()
    log(f"  kernel launches on phase 16's paths: {p16} ({ref16} of them phase 3's table's QPS "
        f"passes in 16a); phase 16 took {time.perf_counter() - t16:.2f} s (host MemAvailable "
        f"{mem_available() / 1e9:.1f} GB after)")
    check(p16["score"] - ref16["score"] > 0, "kernel score was not launched by the mesh")
    check_rescores(p16, "phase 16")
    for name, n in p16.items():
        launches[name] += n
    sift_db.drop_table("hybrid")
    del hyb

    # ---- 12. the host tier, with the launch counters zeroed
    t12 = time.perf_counter()
    for w in (distance.scores, tilescan.tile_maxes):
        w.launches = w.launches_f32 = 0
    tilescan.tile_rescore.launches = 0
    gathermv.gather_block_scores.launches = 0
    e12 = host_tier_path(ms, dev, sift, sift_batches, hb, gist_gt, ivf_op, mstg_op,
                         curve[100][0], card)
    p12 = {"score": distance.scores.launches, "tile_max": tilescan.tile_maxes.launches,
           "tile_rescore": tilescan.tile_rescore.launches,
           "gathermv": gathermv.gather_block_scores.launches,
           "score_f32": distance.scores.launches_f32,
           "tile_max_f32": tilescan.tile_maxes.launches_f32}
    log(f"  kernel launches on phase 12's paths: {p12}; phase 12 took "
        f"{time.perf_counter() - t12:.2f} s")
    check_rescores(p12, "phase 12")
    for name, n in p12.items():
        check(n > 0, f"kernel {name} was not launched on phase 12's paths")
        launches[name] = launches.get(name, 0) + n
    for name, e in e12.items():
        errs[name] = max(errs[name], e)

    # ---- 13. the device f32 tables, with the launch counters zeroed inside
    t13 = time.perf_counter()
    log(f"[13] device f32 tables: phase 3's SIFT corpus (L2, batch {SIFT_BATCH}) and phase 4's "
        f"GIST corpus (Cosine, batch {GIST_BATCH}), storage_dtype='float32', k={K}")
    p13 = f32_table_path(ms, dev, card, args.out)
    log(f"  kernel launches on the f32 tables: {p13}; phase 13 took "
        f"{time.perf_counter() - t13:.2f} s")
    check_rescores(p13, "phase 13")
    for name, n in p13.items():
        check(n > 0, f"kernel {name} was not launched on phase 13's paths")
        launches[name] += n

    check(topk.approx_bin_max.launches == 0, "a phase without the setting launched approx_bin_max")
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
        {"name": "binary", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/binary.cu",
         "replaces": "myscaledb_tpu/ops/binary.py:27",
         "launches": launches["binary"], "max_abs_err": errs["binary"],
         **{k: timing["binary"][k] for k in keys}},
        {"name": "binary_blocks", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/binary.cu",
         "replaces": "myscaledb_tpu/index/binary.py:182",
         "launches": launches["binary_blocks"], "max_abs_err": errs["binary_blocks"],
         **{k: timing["binary_blocks"][k] for k in keys}},
        {"name": "binary_group", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/binary.cu",
         "replaces": "myscaledb_tpu/index/binary.py:223",
         "launches": launches["binary_group"], "max_abs_err": errs["binary_group"],
         **{k: timing["binary_group"][k] for k in keys}},
        # the f32 (3xTF32) engine of score and tile_max (f32 payloads: the
        # host tier, a spill, storage_dtype="float32"); times from phase 7
        {"name": "score_f32", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/score.cu",
         "replaces": "myscaledb_tpu/ops/distance.py:57",
         "launches": launches["score_f32"], "max_abs_err": errs["score_f32"],
         **{k: timing["score_f32"][k] for k in keys}},
        {"name": "tile_max_f32", "route": "cuda", "source": "myscaledb_tpu_torch/csrc/tile_max.cu",
         "replaces": "myscaledb_tpu/ops/tilescan.py:66",
         "launches": launches["tile_max_f32"], "max_abs_err": errs["tile_max_f32"],
         **{k: timing["tile_max_f32"][k] for k in keys}},
        {"name": "tile_rescore", "route": "cuda",
         "source": "myscaledb_tpu_torch/csrc/tile_rescore.cu", "replaces": None,
         "launches": launches["tile_rescore"],
         "max_abs_err": timing["tile_rescore"]["max_abs_err"],
         **{k: timing["tile_rescore"][k] for k in keys}},
        {"name": "window_scan", "route": "cuda",
         "source": "myscaledb_tpu_torch/csrc/window_scan.cu", "replaces": None,
         "launches": launches["window_scan"],
         "max_abs_err": timing["window_scan"]["max_abs_err"],
         **{k: timing["window_scan"][k] for k in keys}},
        {"name": "row_rescore", "route": "cuda",
         "source": "myscaledb_tpu_torch/csrc/row_rescore.cu", "replaces": None,
         "launches": launches["row_rescore"],
         "max_abs_err": timing["row_rescore"]["max_abs_err"],
         **{k: timing["row_rescore"][k] for k in keys}},
        {"name": "approx_bin_max", "route": "cuda",
         "source": "myscaledb_tpu_torch/csrc/approx_topk.cu",
         "replaces": "myscaledb_tpu/ops/topk.py:39",
         "launches": launches["approx_bin_max"], "max_abs_err": errs["approx_bin_max"],
         **{k: timing["approx_bin_max"][k] for k in keys}},
    ]}
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s  [{card}]")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
