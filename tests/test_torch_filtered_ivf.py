"""Pre-filtered IVF searches of the port on the CPU (`IVFIndex.filter_layout`,
`FilteredIVF`): a table's filtered search through IVFFLAT, IVFSQ or MSTG
returns k rows that pass whenever k pass, at the unfiltered search's
recall; the routing rule of `filter_fallback_selectivity`; the layout's
cache; and an unfiltered search that the filtered one leaves as it was.

The data are 40 Gaussian blobs; a filter `id >= N * (1 - s)` keeps a share
s of the rows, spread over every blob, as VectorDBBench's filter cases do.
A string column `tenant` (t0 .. t19, round robin) gives a filter that the
host evaluates.
"""

import numpy as np
import pytest
import torch

import myscaledb_tpu_torch as tms
from myscaledb_tpu_torch.index import ivf
from myscaledb_tpu_torch.index.base import params_key
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.search import executor
from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS
from myscaledb_tpu_torch.service.tracing import GLOBAL_SPAN_LOG

N, D, NQ, K, NCENT, NPROBE = 20_000, 32, 16, 10, 64, 4
KINDS = ["IVFFLAT", "IVFSQ", "MSTG"]
COUNTERS = ("VectorIndexSearches", "VectorBruteForceSearches", "VectorIndexFallbackToFlat",
            "IvfFilterLayoutBuilds", "IvfFilterLayoutHits", "SearchProgramCaptures")


def _bumps(fn):
    before = {n: GLOBAL_COUNTERS.get(n) for n in COUNTERS}
    out = fn()
    return out, {n: GLOBAL_COUNTERS.get(n) - before[n] for n in COUNTERS}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(2026)
    centres = 8.0 * rng.standard_normal((40, D))
    vecs = (centres[rng.integers(0, 40, N)] + rng.standard_normal((N, D))).astype(np.float32)
    q = (vecs[rng.choice(N, NQ, replace=False)]
         + 0.3 * rng.standard_normal((NQ, D))).astype(np.float32)
    return vecs, q


def _table(vecs, kind, metric="L2"):
    st = tms.Settings()
    st.table.min_rows_to_build_vector_index = 1_000
    db = tms.connect(st, device="cpu")
    t = db.create_table("f", tms.Schema({"id": tms.UInt64(), "tenant": tms.String(),
                                         "vec": tms.FloatVector(D)}))
    t.insert({"id": np.arange(N, dtype=np.uint64), "vec": vecs,
              "tenant": np.array([f"t{i % 20}" for i in range(N)], dtype=object)})
    t.add_vector_index("i", "vec", type=kind, ncentroids=NCENT, metric_type=metric)
    assert t.wait_index_built()
    return db, t


@pytest.fixture(scope="module")
def tables(corpus):
    vecs, _ = corpus
    made = {kind: _table(vecs, kind) for kind in KINDS}
    yield made
    for db, _ in made.values():
        db.close()


def _exact(t, q, lo=0, keep=None):
    """The plain filtered exact top-k: squared L2 over the stored rows,
    float64, only rows with id >= lo (and `keep`, a bool[N], where given)."""
    x = t.live_segments()[0].vector("vec").data[:N, :D].to(torch.float64).numpy()
    d = ((q.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
    d[:, :lo] = np.inf
    if keep is not None:
        d[:, ~keep] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :K]


def _layout(t, flt, k, params):
    """The MSTG / IVF index of `t` under `flt`: (searcher, layout), built
    outside the table's cache."""
    seg = t.live_segments()[0]
    idx = t.loaded_index(0, "vec", Metric.L2)
    return idx.filter_layout(executor.segment_mask(seg, flt), None, k, params_key(params))


def _padded(t, q):
    width = t.live_segments()[0].vector("vec").data.shape[1]
    return torch.nn.functional.pad(torch.from_numpy(q), (0, width - D))


def _recall(rows, want):
    return float(np.mean([len(set(r.tolist()) & set(w.tolist())) / K
                          for r, w in zip(rows, want)]))


@pytest.mark.parametrize("share", [0.01, 0.05, 0.5])
@pytest.mark.parametrize("kind", KINDS)
def test_a_filtered_search_returns_k_passing_rows(tables, corpus, kind, share):
    _, q = corpus
    _, t = tables[kind]
    lo = int(N * (1 - share))
    res, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE},
                                     filter=tms.F("id") >= lo))
    assert b["VectorIndexSearches"] == 1 and b["VectorBruteForceSearches"] == 0
    assert (res.rows >= 0).all() and np.isfinite(res.distances).all()
    ids = t.gather(res, ["id"])["id"]
    assert (ids >= lo).all()
    assert all(len(set(r.tolist())) == K for r in res.rows)
    unfiltered = t.search("vec", q, K, params={"nprobe": NPROBE})
    floor = _recall(unfiltered.rows, _exact(t, q)) - 0.05
    assert _recall(res.rows, _exact(t, q, lo)) >= floor
    # each served distance is its stored row's
    x = t.live_segments()[0].vector("vec").data[:, :D].to(torch.float64).numpy()[res.rows]
    np.testing.assert_allclose(res.distances, ((q[:, None].astype(np.float64) - x) ** 2).sum(-1),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_the_masked_window_scan_falls_short_at_one_percent(tables, corpus, kind):
    """The index's masked scan of its probed windows (12 of 512 rows a
    query here) keeps about 1% of their rows: fewer than the top 100 the
    Cohere cell asks for, of the 200 rows that pass. The layout gives 100."""
    _, q = corpus
    _, t = tables[kind]
    seg = t.live_segments()[0]
    idx = t.loaded_index(0, "vec", Metric.L2)
    flt = tms.F("id") >= N - N // 100
    qp = _padded(t, q)
    params = (("nprobe", NPROBE),)
    wm = idx.to_window_mask(executor.segment_mask(seg, flt), seg)
    _, rows = idx.search_t(qp, 100, mask=wm, params=params)
    assert (rows >= 0).sum(1).max() < 100
    layout, buf = _layout(t, flt, 100, {"nprobe": NPROBE})
    _, rows = layout.search_t(qp, 100, mask=buf, params=params)
    assert (rows >= 0).all()


def test_the_fallback_takes_what_passes_below_the_threshold(tables, corpus):
    """At a selectivity of exactly filter_fallback_selectivity (0.01) the
    index answers; one row fewer and the exact masked scan does."""
    _, q = corpus
    _, t = tables["MSTG"]
    assert tms.Settings().query.filter_fallback_selectivity == 0.01
    at = N - N // 100
    res, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE},
                                     filter=tms.F("id") >= at))
    assert (b["VectorIndexSearches"], b["VectorIndexFallbackToFlat"]) == (1, 0)
    res, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE},
                                     filter=tms.F("id") >= at + 1))
    assert (b["VectorIndexSearches"], b["VectorIndexFallbackToFlat"]) == (0, 1)
    assert b["VectorBruteForceSearches"] == 1 and b["IvfFilterLayoutBuilds"] == 0
    np.testing.assert_array_equal(np.sort(res.rows, 1), np.sort(_exact(t, q, at + 1), 1))


def test_a_repeated_filter_hits_the_layout_and_its_program(corpus):
    """The first search of a filter builds its layout and captures its
    program; a repeat takes both from their caches; a delete (a new
    mutation generation) builds anew, and no deleted row comes back."""
    vecs, q = corpus
    db, t = _table(vecs, "IVFSQ")
    flt = tms.F("id") >= N // 2
    first, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE}, filter=flt))
    assert (b["IvfFilterLayoutBuilds"], b["IvfFilterLayoutHits"]) == (1, 0)
    assert b["SearchProgramCaptures"] == 1
    again, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE}, filter=flt))
    assert (b["IvfFilterLayoutBuilds"], b["IvfFilterLayoutHits"]) == (0, 1)
    assert b["SearchProgramCaptures"] == 0
    np.testing.assert_array_equal(again.rows, first.rows)
    gone = sorted({int(i) for i in t.gather(first, ["id"])["id"][:, :3].ravel()})
    assert t.delete(tms.F("id").isin(gone)) == len(gone)
    after, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE}, filter=flt))
    assert (b["IvfFilterLayoutBuilds"], b["IvfFilterLayoutHits"]) == (1, 0)
    ids = t.gather(after, ["id"])["id"]
    assert (after.rows >= 0).all() and (ids >= N // 2).all()
    assert not set(ids.ravel().tolist()) & set(gone)
    db.close()


def test_a_filter_whose_rows_are_all_deleted_finds_none(corpus):
    """The selectivity counts rows before deletes, so the index answers a
    filter whose passing rows are all deleted: its layout is empty, and
    the search returns no row."""
    vecs, q = corpus
    db, t = _table(vecs, "MSTG")
    lo = N - N // 50
    assert t.delete(tms.F("id") >= lo) == N - lo
    res, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE},
                                     filter=tms.F("id") >= lo))
    assert b["VectorIndexSearches"] == 1 and b["IvfFilterLayoutBuilds"] == 1
    assert (res.rows == -1).all() and np.isinf(res.distances).all()
    db.close()


def test_an_unfiltered_search_is_left_as_it_was(tables, corpus):
    """A filtered search adds its own program beside the unfiltered one:
    the unfiltered search keeps its key, replays its program bit for bit,
    and opens no filter.mask span and no layout."""
    _, q = corpus
    _, t = tables["MSTG"]
    t._programs.invalidate()
    before = t.search("vec", q, K, params={"nprobe": NPROBE})
    (key,) = list(t._programs._entries)
    assert not any(sig[1] == "FilteredIVF" for sig in key[8])  # the searchers' signatures
    t.search("vec", q, K, params={"nprobe": NPROBE}, filter=tms.F("id") >= N // 3)
    assert len(t._programs) == 2 and key in t._programs._entries
    GLOBAL_SPAN_LOG.clear()
    after, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE}))
    assert b["SearchProgramCaptures"] == 0 and b["IvfFilterLayoutBuilds"] == 0
    assert b["IvfFilterLayoutHits"] == 0
    np.testing.assert_array_equal(after.rows, before.rows)
    np.testing.assert_array_equal(after.scores, before.scores)
    assert not [r for r in GLOBAL_SPAN_LOG.rows() if r["span"] == "filter.mask"]


@pytest.mark.parametrize("nprobe", [3, 5])
def test_the_actual_nprobe_cuts_the_candidates(tables, corpus, nprobe):
    """The program takes nprobe's pow2 bucket and the actual nprobe as a
    device scalar; the answer is the layout's own search at that nprobe."""
    _, q = corpus
    _, t = tables["IVFFLAT"]
    flt = tms.F("id") >= N // 2
    res = t.search("vec", q, K, params={"nprobe": nprobe}, filter=flt)
    layout, buf = _layout(t, flt, K, {"nprobe": nprobe})
    _, rows = layout.search_t(_padded(t, q), K, mask=buf, params=(("nprobe", nprobe),))
    np.testing.assert_array_equal(res.rows, rows.numpy())


def test_disk_mode_keeps_the_window_mask(tables):
    """A disk-mode index re-ranks host rows: it builds no layout."""
    _, t = tables["MSTG"]
    seg = t.live_segments()[0]
    disk = ivf.MSTGIndex.build(seg.vector("vec"), N, metric=Metric.L2, dim=D,
                               params={"disk_mode": 1, "ncentroids": NCENT})
    mask = executor.segment_mask(seg, tms.F("id") < 1234)
    assert disk.filter_layout(mask, None, K, ()) is None
    assert disk.to_window_mask(mask, seg) is not None


@pytest.mark.parametrize("kind", KINDS)
def test_a_host_evaluated_filter_takes_the_layout(tables, corpus, kind):
    """A string equality (the host evaluates it) searches the layout too,
    cached by the filter: k passing rows at the unfiltered recall."""
    _, q = corpus
    _, t = tables[kind]
    flt = tms.F("tenant") == "t7"
    res, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE}, filter=flt))
    assert b["VectorIndexSearches"] == 1 and b["VectorBruteForceSearches"] == 0
    again, b2 = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE}, filter=flt))
    assert (b["IvfFilterLayoutBuilds"] + b["IvfFilterLayoutHits"], b2["IvfFilterLayoutHits"],
            b2["IvfFilterLayoutBuilds"], b2["SearchProgramCaptures"]) == (1, 1, 0, 0)
    np.testing.assert_array_equal(again.rows, res.rows)
    assert (res.rows >= 0).all()
    assert (t.gather(res, ["tenant"])["tenant"] == "t7").all()
    keep = np.arange(N) % 20 == 7
    floor = _recall(t.search("vec", q, K, params={"nprobe": NPROBE}).rows, _exact(t, q)) - 0.05
    assert _recall(res.rows, _exact(t, q, keep=keep)) >= floor


def test_a_lambda_filter_builds_its_layout_every_time(tables, corpus):
    """A Lambda's closure has no key: its layout is built at every search
    and kept nowhere, and its answer is that of the same filter written
    as a column predicate."""
    _, q = corpus
    _, t = tables["IVFSQ"]
    flt = tms.Lambda(["id"], lambda i: i >= N - N // 20)
    for _ in range(2):
        res, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE}, filter=flt))
        assert (b["IvfFilterLayoutBuilds"], b["IvfFilterLayoutHits"]) == (1, 0)
    want = t.search("vec", q, K, params={"nprobe": NPROBE}, filter=tms.F("id") >= N - N // 20)
    np.testing.assert_array_equal(res.rows, want.rows)


def test_filters_of_one_size_share_a_program(corpus):
    """The layout is the program's input, not part of its key: a filter
    of another constant that passes as many rows builds its own layout and
    replays the program the first one captured."""
    vecs, q = corpus
    db, t = _table(vecs, "MSTG")
    got = []
    for lo in (N // 2, N // 2 + 37, N // 2 - 211):
        res, b = _bumps(lambda: t.search("vec", q, K, params={"nprobe": NPROBE},
                                         filter=tms.F("id") >= lo))
        assert b["IvfFilterLayoutBuilds"] == 1
        got.append(b["SearchProgramCaptures"])
        assert (t.gather(res, ["id"])["id"] >= lo).all() and (res.rows >= 0).all()
    assert got == [1, 0, 0] and len(t._programs) == 1
    db.close()


@pytest.mark.parametrize("kind", KINDS)
def test_the_layout_holds_the_passing_rows_in_list_order(tables, kind):
    _, t = tables[kind]
    idx = t.loaded_index(0, "vec", Metric.L2)
    layout, buf = _layout(t, tms.F("id") >= N - 777, 100, {"nprobe": NPROBE})
    buf = buf.numpy().astype(np.int64)
    c = idx.n_clusters
    start = buf[: c + 1]
    assert buf.shape == (c + 1 + 1024,) and not buf[c + 1 + 777:].any()  # padded to 2^10
    cand = buf[c + 1: c + 1 + 777]
    rows = cand if idx.two_stage else idx.perm_rows.numpy()[cand]
    assert sorted(rows.tolist()) == list(range(N - 777, N))
    owner = np.searchsorted(idx.cluster_start.numpy()[1:],
                            np.argsort(idx.perm_rows.numpy()[:N])[rows], side="right")
    assert (np.diff(owner) >= 0).all()
    np.testing.assert_array_equal(np.bincount(owner, minlength=c), np.diff(start))
    # the probe count, a power of two or every list, holds the budget in
    # any lists it takes; half of it does not
    need, per_list = ivf._filtered_need(idx, 100)
    budget = max(need, NPROBE * per_list)
    least = np.sort(np.diff(start)[np.diff(start) > 0])
    p = layout.n_probe
    assert p & (p - 1) == 0 or p == c
    assert least[:p].sum() >= budget or p >= len(least)
    assert least[: p // 2].sum() < budget
