"""MSTG over a Cosine table through the port's normal path
(`Table.add_vector_index(..., "MSTG", metric_type="Cosine")`, then
`Table.search`), held to the benchmark's plain Cosine reference
(`benchmark/references/exact_knn_cosine.py`), and the index's work
counters (`ivf.window_rows`, `ivf.rerank_rows`), eager and replayed."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import myscaledb_tpu_torch as tms
from myscaledb_tpu_torch.index import ivf
from myscaledb_tpu_torch.index.base import params_key
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import _cuda
from myscaledb_tpu_torch.search import program
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

N, D, NQ, K, NPROBE, NCENT = 6_000, 64, 20, 20, 4, 16
PARAMS = {"nprobe": NPROBE}
CFG = {"metric": "Cosine", "storage_dtype": "bfloat16"}
COUNTERS = ("ivf.window_rows", "ivf.rerank_rows", "VectorIndexSearches", "SearchProgramReplays")
# the served distance is 1 - <q/|q|, x>/|x| in f32 over D terms: the sum
# of D products of unit vectors errs by at most D units of f32 rounding,
# each of the two norms by D/2, the quotient and the difference by one
# each (first order, u = 2^-24); a bf16 query moves the cosine by ~2^-9
TOL = (2 * D + 4) * 2.0**-24
RECALL_FLOOR = 0.95


def _reference():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "references", "exact_knn_cosine.py")
    spec = importlib.util.spec_from_file_location("exact_knn_cosine", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _corpus(seed=20261018):
    """The benchmark's corpus at a small size: 40 blobs (centres 6 sigma),
    queries a row plus 0.3 sigma noise."""
    rng = np.random.default_rng(seed)
    centres = 6.0 * rng.standard_normal((40, D))
    rows = (centres[rng.integers(0, 40, N)] + rng.standard_normal((N, D))).astype(np.float32)
    q = rows[rng.choice(N, NQ, replace=False)] + 0.3 * rng.standard_normal((NQ, D))
    return rows, q.astype(np.float32)


def _table(device="cpu"):
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 1_000
    st.table.float_vector_search_metric_type = "Cosine"
    db = tms.connect(st, device=device)
    t = db.create_table("c", tms.Schema({"id": tms.UInt64(), "vec": tms.FloatVector(D)}))
    rows, q = _corpus()
    t.insert({"id": np.arange(N, dtype=np.uint64), "vec": rows})
    t.add_vector_index("m", "vec", "MSTG", ncentroids=NCENT, metric_type="Cosine")
    assert t.wait_index_built()
    idx = t.loaded_index(0, "vec", Metric.COSINE)
    assert isinstance(idx, ivf.MSTGIndex) and idx.codec == "sq8" and idx.metric == Metric.COSINE
    return db, t, idx, rows, q


@pytest.fixture(scope="module")
def cosine_table():
    db, t, idx, rows, q = _table()
    yield t, idx, rows, q
    db.close()


def _static(idx, nq_pad):
    """(ivf.window_rows, ivf.rerank_rows) of one search of nq_pad padded
    queries at NPROBE (a power of two: its own bucket)."""
    w_budget = min(idx.n_windows + NPROBE, NPROBE * idx.wpp + 4)
    ncand = min(max(K * idx.rerank_multiple, K), idx.n_rows)
    return nq_pad * w_budget * ivf.WINDOW, nq_pad * ncand


def _delta(before):
    return {n: GLOBAL_COUNTERS.get(n) - before[n] for n in COUNTERS}


def _snap():
    return {n: GLOBAL_COUNTERS.get(n) for n in COUNTERS}


def test_searches_take_the_index_and_count_its_rows(cosine_table):
    """Every search is an index search, and adds the window step's and
    the re-rank's rows of its padded batch (the CPU runs the body
    eagerly, so each run counts them itself)."""
    t, idx, _, q = cosine_table
    calls = 3
    before = _snap()
    for _ in range(calls):
        t.search("vec", q, K, params=PARAMS)
    got = _delta(before)
    window, rerank = _static(idx, 24)  # 20 queries pad to 24
    assert got == {"ivf.window_rows": calls * window, "ivf.rerank_rows": calls * rerank,
                   "VectorIndexSearches": calls, "SearchProgramReplays": calls}


def test_a_replay_adds_what_its_capture_recorded(cosine_table):
    """A capture records the amounts and counts nothing; each replay adds
    them with SearchProgramReplays, as `Program.run` does on the card."""
    _, idx, _, q = cosine_table
    # the executor's padding: 24 rows, the stored width
    qd = torch.from_numpy(np.pad(q, ((0, 4), (0, idx.centroids.shape[1] - D))))
    before = _snap()
    with _cuda.recording_launches() as rec:
        idx.search_t(qd, K, params=params_key(PARAMS))
    assert _delta(before) == dict.fromkeys(COUNTERS, 0)
    window, rerank = _static(idx, 24)
    names, counts = program.replay_counts(rec)
    assert dict(zip(names, counts)) == {"SearchProgramReplays": 1, "ivf.window_rows": window,
                                        "ivf.rerank_rows": rerank}
    for _ in range(5):
        GLOBAL_COUNTERS.bump_many(names, counts)
    got = _delta(before)
    assert got == {"ivf.window_rows": 5 * window, "ivf.rerank_rows": 5 * rerank,
                   "VectorIndexSearches": 0, "SearchProgramReplays": 5}


def test_distances_are_the_references_and_a_bf16_control_is_not(cosine_table):
    t, _, rows, q = cosine_table
    res = t.search("vec", q, K, params=PARAMS)
    ids = t.gather(res, ["id"])["id"].astype(np.int64)
    assert (res.rows >= 0).all() and all(len(set(r)) == K for r in ids)
    want = REF.distances(rows, q, ids, CFG, "cpu")
    err = np.abs(res.distances.astype(np.float64) - want)
    assert err.max() <= TOL, err.max()
    ref_d, ref_i = REF.topk(rows, q, K, CFG, "cpu")
    recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, ref_i)])
    assert recall >= RECALL_FLOOR, recall
    # the same search one precision lower fails the tolerance
    cd, ci = REF.control(rows, q, K, CFG, "cpu")
    cerr = np.abs(cd.astype(np.float64) - REF.distances(rows, q, ci, CFG, "cpu"))
    assert cerr.max() > 4 * TOL, cerr.max()


def test_the_reference_is_the_cosine_distance_of_the_stored_rows():
    rows, q = _corpus(7)
    rows, q = rows[:500], q[:5]
    stored = torch.from_numpy(rows).to(torch.bfloat16).to(torch.float64).numpy()
    qd = q.astype(np.float64)
    full = 1.0 - (qd @ stored.T) / np.outer(np.linalg.norm(qd, axis=1),
                                            np.linalg.norm(stored, axis=1))
    want_i = np.argsort(full, axis=1, kind="stable")[:, :K]
    d, i = REF.topk(rows, q, K, CFG, "cpu")
    np.testing.assert_allclose(d, np.take_along_axis(full, want_i, 1), rtol=0, atol=1e-12)
    assert (i == want_i).mean() > 0.99
    np.testing.assert_allclose(REF.distances(rows, q, want_i, CFG, "cpu"),
                               np.take_along_axis(full, want_i, 1), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        REF.topk(rows, q, K, dict(CFG, metric="L2"), "cpu")


@pytest.mark.cuda
def test_on_the_card_replays_count_the_rows_of_every_search():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the search programs are captured CUDA graphs")
    db, t, idx, rows, q = _table("cuda")
    t.search("vec", q, K, params=PARAMS)  # the capture
    calls = 4
    before = _snap()
    for _ in range(calls):
        res = t.search("vec", q, K, params=PARAMS)
    got = _delta(before)
    window, rerank = _static(idx, 24)
    assert got == {"ivf.window_rows": calls * window, "ivf.rerank_rows": calls * rerank,
                   "VectorIndexSearches": calls, "SearchProgramReplays": calls}
    ids = t.gather(res, ["id"])["id"].astype(np.int64)
    err = np.abs(res.distances.astype(np.float64) - REF.distances(rows, q, ids, CFG, "cpu"))
    assert err.max() <= TOL, err.max()
    db.close()
