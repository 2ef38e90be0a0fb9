"""Cells that carry text, on the CPU: a tiny text cell and two tiny hybrid
cells, RRF and RSF (no vector index: the vector leg is the exact scan),
made by adding files only, run whole through the harness; faults planted under them and
their controls; the BM25 and fusion references against plain Python; the
documents the corpus makes; and, pinned, that the configurations without
documents get the rows, pool and judge numbers they got before."""

import hashlib
import json
import os
import re

import numpy as np
import pytest
import texttiny

from benchmark import corpus, harness, judge, system
from benchmark.references import bm25, bm25_fusion, exact_knn, exact_knn_cosine
from benchmark.spec import BENCH_DIR

SEED = 2**31 + 4321


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return texttiny.make(str(tmp_path_factory.mktemp("bench")))


def _run(tiny, kind, trace=False, seed=SEED):
    return harness.run_cell(tiny[kind], seed, 0.4, trace, device="cpu", bench_dir=tiny["dir"],
                            manifest=tiny["manifest"])


@pytest.mark.parametrize("kind", ["text", "hybrid", "hybrid_rsf"])
def test_a_sound_run_is_correct(tiny, kind):
    out = _run(tiny, kind)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert out["forbidden"] == []  # the program's text path loads no JAX
    assert out["values"]["route_misses"] == 0 and out["values"]["recall"] == 1.0
    assert set(res["metrics"]) == set(texttiny.E2E)
    assert set(res["checks"]) == set(texttiny.CHECKS)


@pytest.mark.parametrize("kind", ["text", "hybrid"])
def test_a_traced_run_is_correct_and_reads_its_counters(tiny, kind):
    out = _run(tiny, kind, trace=True)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert out["forbidden"] == []
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    # the CPU has no device timeline: the counters' metrics are read
    assert set(res["metrics"]) == {"program.launch_calls", "program.captures"}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_hybrid_run_is_correct_on_more_seeds(tiny, seed):
    res = _run(tiny, "hybrid", seed=seed)["result"]
    assert res["correct"], res["checks"]


def _idf_off_by_one(monkeypatch):
    """idf with N one document more than the table holds."""
    from myscaledb_tpu_torch.text import inverted

    def idf(self, term):
        n = self.doc_freq.get(term, 0)
        return float(np.log(1.0 + (self.total_docs + 1 - n + 0.5) / (n + 0.5)))

    monkeypatch.setattr(inverted.BM25Stats, "idf", idf)


def _no_length_norm(monkeypatch):
    from myscaledb_tpu_torch.text import inverted

    monkeypatch.setattr(inverted, "BM25_B", 0.0)


def _fusion_k_61(monkeypatch):
    from myscaledb_tpu_torch.search import text_executor

    fuse = text_executor.fuse_legs

    def off(*a, **kw):
        return fuse(*a, **dict(kw, fusion_k=kw["fusion_k"] + 1))

    monkeypatch.setattr(text_executor, "fuse_legs", off)


def _text_leg_dropped(monkeypatch):
    """The hybrid search fuses the vector leg with an empty text leg."""
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.search import executor, text_executor

    def empty(self, column, query, k, **kw):
        return executor.SearchResult.empty(Metric.IP, len(query), k)

    monkeypatch.setattr(text_executor.TextSearchExecutor, "run", empty)


def _ids_shifted(monkeypatch):
    """Every answer names the row after the one it scored."""
    from myscaledb_tpu_torch.search import executor

    orig = executor.SearchResult._materialize

    def shifted(self):
        first = self._host is None
        vals, segs, rows = orig(self)
        if first:
            rows[rows >= 0] = (rows[rows >= 0] + 1) % texttiny.ROWS
        return vals, segs, rows

    monkeypatch.setattr(executor.SearchResult, "_materialize", shifted)


FAULTS = {"idf_n_off_by_one": _idf_off_by_one, "b_0": _no_length_norm,
          "fusion_k_61": _fusion_k_61, "text_leg_dropped": _text_leg_dropped,
          "ids_shifted": _ids_shifted}
# a fault goes where its layer runs: an idf that moves every score alike
# moves no rank, and RRF reads ranks only
CASES = [("text", f) for f in ("idf_n_off_by_one", "b_0", "ids_shifted")] + [
    ("hybrid", f) for f in ("b_0", "fusion_k_61", "text_leg_dropped", "ids_shifted")]


@pytest.mark.parametrize("kind,fault", CASES)
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, kind, fault):
    FAULTS[fault](monkeypatch)
    out = _run(tiny, kind)
    assert not out["result"]["correct"], out["result"]["checks"]
    if fault == "text_leg_dropped":
        assert out["values"]["route_misses"] > 0  # TextSearchQueries did not move
    else:
        assert out["values"]["dist_err"] > texttiny.CHECKS["dist_err"]["max"]


@pytest.mark.parametrize("kind", ["text", "hybrid", "hybrid_rsf"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(tiny, kind, seed):
    values = harness.control_numbers(tiny[kind], seed, device="cpu", bench_dir=tiny["dir"],
                                     manifest=tiny["manifest"])
    ok, checks = judge.compare(values, texttiny.CHECKS)
    assert not ok, checks
    assert values["bad_hits"] == 0 and values["dist_err"] > 10 * texttiny.CHECKS["dist_err"]["max"]


def test_the_route_counters_follow_the_traffics_mode():
    assert system.route_counters({"index": None}) == [("VectorBruteForceSearches", "search")]
    assert system.route_counters({"index": "mstg", "mode": "vector"}) == [
        ("VectorIndexSearches", "search")]
    assert system.route_counters({"mode": "text"}) == [("TextSearchQueries", "query")]
    assert system.route_counters({"index": "mstg", "mode": "hybrid"}) == [
        ("HybridSearchQueries", "query"), ("VectorIndexSearches", "search"),
        ("TextSearchQueries", "query")]
    window = {"TextSearchQueries": 64, "VectorBruteForceSearches": 3}
    assert harness.route_misses(window, {"mode": "text", "batch": 32}, 2) == 0
    assert harness.route_misses(window, {"mode": "text", "batch": 32}, 3) == 32
    assert harness.route_misses(window, {"batch": 32}, 3) == 0


# ---------------------------------------------------------------- corpus


def _config(**documents):
    with open(os.path.join(BENCH_DIR, "configs", "cohere1m-cosine.json")) as f:
        cfg = json.load(f)
    cfg.update(rows=2_000, dim=16, queries=80, corpus=dict(cfg["corpus"], centres=20),
               documents=dict(texttiny.DOCUMENTS, **documents), fts=texttiny.FTS)
    return cfg


def test_documents_are_drawn_from_the_seed():
    cfg = _config()
    a, b, c = (corpus.make(cfg, s, "cpu") for s in (SEED, SEED, SEED + 1))
    assert a.text.documents == b.text.documents and a.text.queries == b.text.queries
    assert a.text.documents != c.text.documents
    # the rows and the pool are those of the same configuration without text
    plain = {k: v for k, v in cfg.items() if k not in ("documents", "fts")}
    rows, pool, text = corpus.make(plain, SEED, "cpu")
    assert text is None
    assert np.array_equal(rows, a.rows) and np.array_equal(pool, a.queries)


def test_a_document_is_its_words_and_a_query_text_words_of_its_row():
    cfg = _config()
    rows, pool, text = corpus.make(cfg, SEED, "cpu")
    n = rows.shape[0]
    assert len(text.documents) == n and len(text.queries) == pool.shape[0]
    assert text.vocab[:len(corpus.ENGLISH_STOPWORDS)] == corpus.ENGLISH_STOPWORDS
    stops = set(corpus.ENGLISH_STOPWORDS)
    for i in range(0, n, 97):
        words = [text.vocab[w] for w in text.ids[text.offsets[i]:text.offsets[i + 1]]]
        assert text.documents[i] == " ".join(words) and words
    lengths = np.diff(text.offsets)
    mean = cfg["documents"]["mean_tokens"]
    assert lengths.min() >= mean // 2 and lengths.max() < 1.5 * mean
    assert abs(lengths.mean() - mean) < 0.05 * mean
    # the rank-1 word is the most frequent; the stop words take a Zipf share
    counts = np.bincount(text.ids, minlength=len(text.vocab))
    assert counts.argmax() == 0 and 0.25 < counts[:len(stops)].sum() / counts.sum() < 0.6
    # each query: 2-6 distinct non-stop words, most of them from the
    # document of the row it was drawn from (the nearest row, as a rule)
    own = 0
    for j, q in enumerate(text.queries):
        words = q.split()
        assert 2 <= len(words) <= 6 and len(set(words)) == len(words)
        assert not stops & set(words)
        row = int(np.argmin(((rows - pool[j]) ** 2).sum(1)))
        own += set(words) <= set(text.documents[row].split())
    assert own >= 0.9 * len(text.queries)


def test_documents_share_their_blobs_words():
    """A share `topical` of a document's words comes from its blob's own
    words, so two rows of one blob share more words than two rows of
    two blobs."""
    cfg = _config(topical=0.5)
    rows, _, text = corpus.make(cfg, SEED, "cpu")
    blob = np.argmin(((rows[:, None, :] - rows[None, :40, :]) ** 2).sum(-1), 1)
    words = [set(d.split()) - set(corpus.ENGLISH_STOPWORDS) for d in text.documents[:400]]
    same, other = [], []
    for i in range(0, 400, 7):
        for j in range(i + 1, 400, 11):
            jac = len(words[i] & words[j]) / max(len(words[i] | words[j]), 1)
            (same if blob[i] == blob[j] else other).append(jac)
    assert np.mean(same) > 3 * np.mean(other)


# the parent's corpus.make on tiny copies of the configurations that have
# no documents, at SEED_PIN: sha256 of the rows' and the pool's bytes
SEED_PIN = 2**31 + 4242
DIGESTS = {
    ("sift1m-l2", 3_000, 64): "8266c99367b113c279633080969801220052c35d5cb16f9fd4713c5930e29073",
    ("gist1m-l2", 3_000, 64): "239828098234af5cc3cca590de204bd26d81148435fad32ed3eadacc6d6fe76f",
    ("cohere1m-cosine", 3_000, 64):
        "85b58fbb2c8cdced3231b4dac195bce5f83c4f1e790b82f09840dd5a10e797f8",
    ("cohere1m-cosine-f99", 3_000, 64):
        "85b58fbb2c8cdced3231b4dac195bce5f83c4f1e790b82f09840dd5a10e797f8",
    ("sift1m-l2", 140_000, 200):  # past one block of rows
        "b3bfc63337686b1ee4665220087eb3553bd84ede846b9179893986cd49fe60de",
}


@pytest.mark.parametrize("name,n,nq", sorted(DIGESTS))
def test_configurations_without_documents_make_what_they_made(name, n, nq):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    assert "documents" not in cfg
    rows, pool, text = corpus.make(dict(cfg, rows=n, queries=nq), SEED_PIN, "cpu")
    assert text is None
    assert hashlib.sha256(rows.tobytes() + pool.tobytes()).hexdigest() == DIGESTS[name, n, nq]


def _recorded_sample(cosine, faults):
    """Answers of an exact top-10 with float32 noise on the distances, and
    where `faults` a row beyond the k-th, an empty slot, a repeated and an
    out-of-range id."""
    rng = np.random.default_rng(20261019)
    rows = (3 * rng.standard_normal((2500, 24)) + (1.0 if cosine else 0.0)).astype(np.float32)
    queries = (rows[:60] + 0.3 * rng.standard_normal((60, 24))).astype(np.float32)
    ref = exact_knn_cosine if cosine else exact_knn
    cfg = {"metric": "Cosine" if cosine else "L2", "storage_dtype": "bfloat16"}
    d, ids = ref.topk(rows, queries, 20, cfg, "cpu")
    ids, d = ids[:, :10].copy(), d[:, :10].astype(np.float32)
    d *= (1 + 1e-6 * rng.standard_normal(d.shape)).astype(np.float32)
    if faults:
        ids[3, 9] = ids[3, 9] + 1  # another row, served with the first's distance
        ids[5, 2] = -1
        ids[7, 4] = ids[7, 3]
        ids[11, 0] = rows.shape[0] + 3
    qi = np.arange(60)
    sample = [(qi[:30], ids[:30], d[:30]), (qi[30:], ids[30:], d[30:])]
    return sample, rows, queries, cfg, ref


# the parent's judge.numbers on the recorded samples
JUDGED = {
    (False, False): {"bad_hits": 0, "dist_err": 2.8649022874866965e-06,
                     "rank_gap": 2.4193377236635575e-16, "recall": 1.0},
    (False, True): {"bad_hits": 3, "dist_err": 0.4870837818984473,
                    "rank_gap": 0.48708288483251616, "recall": 0.9949999999999999},
    (True, False): {"bad_hits": 0, "dist_err": 2.9168110955824087e-06,
                    "rank_gap": 5.333106668859201e-16, "recall": 1.0},
    (True, True): {"bad_hits": 3, "dist_err": 1.8367827518269453,
                   "rank_gap": 1.8367818300904053, "recall": 0.9949999999999999},
}


@pytest.mark.parametrize("cosine,faults", sorted(JUDGED))
def test_an_ascending_reference_is_judged_as_before(cosine, faults):
    sample, rows, queries, cfg, ref = _recorded_sample(cosine, faults)
    assert judge.numbers(sample, rows, queries, 10, cfg, ref, "cpu") == JUDGED[cosine, faults]


# ------------------------------------------------------------ references


def _plain_bm25(docs, query, params):
    """Okapi BM25 over the documents' strings, term by term in Python."""
    lower = params.get("lower_case", True)
    stops = set(bm25.ENGLISH_STOPWORDS) if params.get("stop_words") == "english" else set(
        params.get("stop_words") or ())
    lo, hi = params.get("min_token_len", 1), params.get("max_token_len", 64)

    def terms(s):
        s = s.lower() if lower else s
        return [t for t in re.findall(r"[0-9A-Za-z_]+", s) if lo <= len(t) <= hi and t not in stops]

    toks = [terms(d) for d in docs]
    n = len(docs)
    avgdl = sum(map(len, toks)) / n
    out = np.zeros(n)
    hit = np.zeros(n, bool)
    for t in dict.fromkeys(terms(query)):
        df = sum(t in d for d in toks)
        if not df:
            continue
        idf = np.log(1 + (n - df + 0.5) / (df + 0.5))
        for i, d in enumerate(toks):
            tf = d.count(t)
            if tf:
                out[i] += idf * tf * 2.2 / (tf + 1.2 * (0.25 + 0.75 * len(d) / avgdl))
                hit[i] = True
    return out, hit


def test_the_corpus_and_the_reference_name_the_same_stop_words():
    assert set(corpus.ENGLISH_STOPWORDS) == bm25.ENGLISH_STOPWORDS
    assert len(corpus.ENGLISH_STOPWORDS) == len(bm25.ENGLISH_STOPWORDS)


@pytest.mark.parametrize("params", [{"stop_words": "english"}, {},
                                    {"min_token_len": 3, "lower_case": False}])
def test_the_bm25_reference_is_the_okapi_formula_over_the_documents(params):
    cfg = dict(_config(), rows=600, fts={"name": "fts", "params": params})
    rows, pool, text = corpus.make(cfg, SEED, "cpu")
    texts = text.queries[:12] + ["W5 the of", "nothing here"]
    vals, ids = bm25.topk(rows, pool[:14], 10, cfg, "cpu", texts=texts, text=text)
    for u, q in enumerate(texts):
        want, hit = _plain_bm25(text.documents, q, params)
        order = sorted(np.nonzero(hit)[0], key=lambda r: (-want[r], r))[:10]
        m = len(order)
        assert list(ids[u, :m]) == order and (ids[u, m:] == -1).all()
        np.testing.assert_allclose(vals[u, :m], want[order], rtol=1e-12)
    cv, ci = bm25.control(rows, pool[:14], 10, cfg, "cpu", texts=texts, text=text)
    assert cv.dtype == np.float32
    fin = np.isfinite(vals)
    assert np.abs(cv[fin] - vals[fin]).max() > 1e-4 * np.abs(vals[fin]).max()


def test_the_fusion_reference_is_rrf_over_exact_legs():
    cfg = dict(_config(), rows=900)
    rows, pool, text = corpus.make(cfg, SEED, "cpu")
    traffic = {"fusion_type": "rrf", "fusion_k": 60}
    k, nq = 10, 8
    texts = text.queries[:nq]
    vals, ids = bm25_fusion.topk(rows, pool[:nq], k, cfg, "cpu", texts=texts, text=text,
                                 traffic=traffic, legs={"vector": exact_knn_cosine, "text": bm25})
    full_d, full_i = exact_knn_cosine.topk(rows, pool[:nq], 900, cfg, "cpu")
    for u in range(nq):
        s, hit = _plain_bm25(text.documents, texts[u], cfg["fts"]["params"])
        t_leg = sorted(np.nonzero(hit)[0], key=lambda r: (-s[r], r))[:3 * k]
        fused = {}
        for leg in (list(full_i[u, :3 * k]), t_leg):
            for rank, r in enumerate(leg, 1):
                fused[int(r)] = fused.get(int(r), 0.0) + 1 / (60 + rank)
        want = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        np.testing.assert_allclose(vals[u], [v for _, v in want], rtol=1e-15)
        assert list(ids[u]) == [r for r, _ in want]


def test_the_judge_reads_a_descending_reference():
    """Scores higher-better: the scale is |k-th score|, a row tied with the
    k-th counts as found, a row below it reads as a rank gap."""

    class Ref:
        ORDER = "desc"

        @staticmethod
        def ranked(rows, queries, k, config, device, *, served, inv):
            score = np.array([9.0, 7.0, 5.0, 5.0, 5.0, 1.0])
            top = np.array([[9.0, 7.0, 5.0]])
            s = np.where(served >= 0, score[np.maximum(served, 0)], 0.0)
            return top, None, s, s

    rows = np.zeros((6, 2), np.float32)
    served = np.array([[0, 1, 4], [0, 1, 5], [0, 0, 2]])
    got = np.array([[9.0, 7.0, 5.0], [9.0, 7.0, 1.0], [9.0, 9.0, 5.0]]) * (1 + 1e-7)
    v = judge.numbers([(np.zeros(3, int), served, got)], rows, rows, 3, {}, Ref, "cpu")
    assert v["bad_hits"] == 1  # the repeated row
    assert v["dist_err"] == pytest.approx(9e-7 / 5, rel=1e-6)
    assert v["rank_gap"] == pytest.approx(4 / 5)
    assert v["recall"] == pytest.approx((1 + 2 / 3 + 2 / 3) / 3)
