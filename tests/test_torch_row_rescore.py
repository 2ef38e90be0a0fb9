"""The two-stage IVF re-rank (`ops/rowrescore.py`) on the CPU.

`row_rescore_plain`, which the wrapper runs on a CPU tensor, against the
expression `IVFIndex._exact_scores` ran before the re-rank became one call
(a gather by id, the f32 copy, a `bmm`, the rows' norms for Cosine): bit
for bit, for bf16 and f32 payloads and every metric, over negative ids
(-inf), repeated ids and an all-zero row (a Cosine score of 0). IVFSQ and
MSTG searches, and the executor's eager re-rank over ids the global cut
set to -1, against the same searches through that expression: the same
ids and scores. `rerank_error_bound` admits the same products summed in
f64 and rejects a control that rounds the query to bf16. The kernel
itself runs only on a card (tests/test_torch_kernels.py, marker `cuda`).
"""

import numpy as np
import pytest
import torch

from myscaledb_tpu_torch.index import registry
from myscaledb_tpu_torch.index.base import IndexKind, params_key
from myscaledb_tpu_torch.metrics import Metric
from myscaledb_tpu_torch.ops import distance, rowrescore
from myscaledb_tpu_torch.ops.topk import NEG_INF
from myscaledb_tpu_torch.storage.schema import FloatVector, Schema, UInt64
from myscaledb_tpu_torch.storage.segment import Segment

METRICS = [Metric.L2, Metric.IP, Metric.COSINE]
DTYPES = [torch.bfloat16, torch.float32]


# --------------------------------------------- the expression it replaced
def _old_exact_scores(metric, raw_data, raw_aux, queries, row_ids):
    """IVFIndex._exact_scores over a device payload as it was."""
    safe = torch.clamp(row_ids, min=0).to(torch.int64)
    rows = raw_data[safe].to(torch.float32)  # [Q, C, D']
    q = distance.normalize_queries(queries.to(torch.float32), metric)
    d = rows.shape[-1]
    s = torch.bmm(rows, q[:, :d, None])[:, :, 0]
    if metric == Metric.L2:
        s = 2.0 * s - raw_aux[safe]
    elif metric == Metric.COSINE:
        nrm = torch.linalg.vector_norm(rows, dim=-1)
        s = s * torch.where(nrm > 0, 1.0 / torch.where(nrm > 0, nrm, torch.ones_like(nrm)), 0.0)
    return s.masked_fill(row_ids < 0, NEG_INF)


def _operands(dtype, metric, q=9, c=37, n=300, d=128, seed=0):
    """A payload of `n` rows (row 5 all zero), its aux as a segment keeps
    it (|x|^2 for L2, 1/|x| for Cosine, none for IP), raw queries and
    int32 ids with negative ids, repeats and the zero row."""
    g = torch.Generator().manual_seed(seed)
    data = torch.randn((n, d), generator=g).to(dtype)
    data[5] = 0
    aux = distance.base_aux(data, metric)
    queries = 3.0 * torch.randn((q, d), generator=g)
    ids = torch.randint(0, n, (q, c), generator=g, dtype=torch.int32)
    ids[:, 0] = 5  # the zero row
    ids[:, 1] = ids[:, 2]  # a repeat
    ids[0, 3:] = -1  # the tail a global cut drops
    ids[1:, -4:] = -1
    return queries, data, aux, ids


def _queries_for(metric, queries):
    return distance.normalize_queries(queries.to(torch.float32), metric)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_is_the_old_expression_bit_for_bit(dtype, metric):
    queries, data, aux, ids = _operands(dtype, metric)
    want = _old_exact_scores(metric, data, aux, queries, ids)
    q = _queries_for(metric, queries)
    for got in (rowrescore.row_rescore_plain(q, data, aux, ids, metric),
                rowrescore.row_rescore(q, data, aux, ids, metric=metric)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(torch.isneginf(want), ids < 0)
    if metric == Metric.COSINE:
        assert (want[:, 0] == 0).all()  # the zero row
    assert torch.equal(want[:, 1], want[:, 2])


def _exact_rerank(queries, data, aux, ids, metric):
    """The re-rank's products, sums and norms in f64, rounded to f32 once."""
    rows = data[torch.clamp(ids, min=0).to(torch.int64)].to(torch.float64)
    s = torch.einsum("qd,qcd->qc", queries.to(torch.float64), rows)
    if metric == Metric.L2:
        s = 2.0 * s - aux.to(torch.float64)[torch.clamp(ids, min=0).to(torch.int64)]
    elif metric == Metric.COSINE:
        nrm = torch.linalg.vector_norm(rows, dim=-1)
        s = torch.where(nrm > 0, s / torch.where(nrm > 0, nrm, torch.ones_like(nrm)), 0.0)
    return s.to(torch.float32).masked_fill(ids < 0, NEG_INF)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q,c,d", [(9, 37, 128), (4, 100, 768), (17, 5, 1024)])
def test_rerank_bound_admits_exact_math_and_rejects_bf16_query(dtype, metric, q, c, d):
    """The plain version (f32 products, sums and norms) lies inside
    `rerank_error_bound` around the same math in f64; a control that
    rounds the query to bf16 before its products lies outside it. The
    bound is 0 where both must agree exactly: negative ids and the zero
    row under Cosine."""
    queries, data, aux, ids = _operands(dtype, metric, q=q, c=c, d=d, seed=q + c + d)
    qs = _queries_for(metric, queries)
    want = rowrescore.row_rescore_plain(qs, data, aux, ids, metric)
    bound = rowrescore.rerank_error_bound(qs, data, ids, metric)
    assert bound.shape == want.shape and (bound >= 0).all()
    assert (bound[ids < 0] == 0).all()
    if metric == Metric.COSINE:
        assert (bound[:, 0] == 0).all()
    live = ids >= 0
    exact = _exact_rerank(qs, data, aux, ids, metric)
    assert torch.equal(torch.isneginf(exact), ~live)
    assert not distance.outside_kernel_bound(exact[live], want[live], bound[live]).any()
    control = rowrescore.row_rescore_plain(qs.to(torch.bfloat16).to(torch.float32), data, aux,
                                           ids, metric)
    assert distance.outside_kernel_bound(control[live], want[live], bound[live]).any()


def test_row_rescore_wrapper_rejects_bad_operands_on_the_cpu():
    x = torch.randn((256, 128)).to(torch.bfloat16)
    ok = dict(queries=torch.randn((8, 128)), data=x, aux=torch.zeros(256),
              ids=torch.zeros((8, 5), dtype=torch.int32), metric=Metric.L2)

    def call(**kw):
        return rowrescore.row_rescore(**{**ok, **kw})

    assert call().shape == (8, 5)
    assert call(aux=None, metric=Metric.IP).shape == (8, 5)
    with pytest.raises(ValueError, match="queries and data"):
        call(queries=ok["queries"][:, :64])
    with pytest.raises(TypeError, match="queries must be float32"):
        call(queries=ok["queries"].double())
    with pytest.raises(TypeError, match="data must be"):
        call(data=x.half())
    with pytest.raises(ValueError, match="ids must be int32"):
        call(ids=ok["ids"].long())
    with pytest.raises(ValueError, match="ids must be int32"):
        call(ids=ok["ids"][:4])
    with pytest.raises(ValueError, match="ids must be int32"):
        call(ids=ok["ids"][:, :0])
    with pytest.raises(ValueError, match="L2 needs aux"):
        call(aux=None)
    with pytest.raises(ValueError, match="L2 needs aux"):
        call(aux=ok["aux"][:100])
    with pytest.raises(ValueError, match="does not take metric"):
        call(metric=Metric.HAMMING)


# ------------------------------------------------- the two-stage searches
N, D, NCENT, NQ, K = 6_000, 64, 16, 24, 10
SEARCH_CASES = [("IVFSQ", Metric.L2), ("IVFSQ", Metric.IP), ("IVFSQ", Metric.COSINE),
                ("MSTG", Metric.COSINE), ("MSTG", Metric.L2)]


@pytest.fixture(scope="module")
def index_of():
    built = {}

    def get(kind, metric):
        if (kind, metric) not in built:
            rng = np.random.default_rng(11)
            centres = 6.0 * rng.standard_normal((40, D)).astype(np.float32)
            vecs = (centres[rng.integers(0, 40, N)]
                    + rng.standard_normal((N, D))).astype(np.float32)
            seg = Segment.from_columns(
                0, Schema({"id": UInt64(), "vec": FloatVector(D)}),
                {"id": np.arange(N, dtype=np.uint64), "vec": vecs}, device="cpu")
            p = seg.vector("vec")
            idx = registry.implementation(IndexKind(kind)).build(
                p, N, metric=metric, dim=D, params={"ncentroids": NCENT})
            q = vecs[rng.choice(N, NQ, replace=False)] + 0.3 * rng.standard_normal((NQ, D))
            q = torch.nn.functional.pad(torch.from_numpy(q.astype(np.float32)),
                                        (0, p.data.shape[1] - D))
            built[(kind, metric)] = idx, q
        return built[(kind, metric)]

    return get


def _old(idx):
    return lambda queries, row_ids: _old_exact_scores(idx.metric, idx.raw_data, idx.raw_aux,
                                                      queries, row_ids)


@pytest.mark.parametrize("kind,metric", SEARCH_CASES,
                         ids=[f"{k}-{m.value}" for k, m in SEARCH_CASES])
def test_two_stage_search_equals_the_old_rerank(index_of, kind, metric):
    """A two-stage search re-ranks its first pass's candidates through
    `row_rescore` and returns what the old expression's re-rank returned,
    ids and scores, and counts the rows it re-scores."""
    from myscaledb_tpu_torch.service.event_log import GLOBAL_COUNTERS

    idx, q = index_of(kind, metric)
    assert idx.two_stage and idx.raw_host is None
    params = params_key({"nprobe": 4})
    rows_before = GLOBAL_COUNTERS.get("ivf.rerank_rows")
    v, r = idx.search_t(q, K, params=params)
    assert GLOBAL_COUNTERS.get("ivf.rerank_rows") - rows_before == NQ * idx._ncand(K)
    _, cand = idx._scan_stage(q, idx._ncand(K), params=params)
    ov, orow = idx._rerank(q, K, cand, _old(idx))
    assert torch.equal(r, orow)
    assert torch.equal(v.view(torch.int32), ov.view(torch.int32))
    assert (r >= 0).all()


@pytest.mark.parametrize("kind,metric", SEARCH_CASES,
                         ids=[f"{k}-{m.value}" for k, m in SEARCH_CASES])
def test_subset_scores_after_a_global_cut_equal_the_old_expression(index_of, kind, metric):
    """The executor's eager two-stage path hands `compute_scores_subset`
    the candidates above a global cut, the rest -1: the same scores as the
    old expression bit for bit, -inf exactly at the -1 ids."""
    idx, q = index_of(kind, metric)
    v, r = idx.search_first_stage(q, idx._ncand(K), params={"nprobe": 4})
    cut = torch.topk(v, 2 * K, dim=-1).values[:, -1:]
    rows_kept = torch.where(v >= cut, r, torch.full_like(r, -1))
    assert (rows_kept < 0).any() and (rows_kept >= 0).any()
    got = idx.compute_scores_subset(q, rows_kept)
    want = _old(idx)(q, rows_kept)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(torch.isneginf(got), rows_kept < 0)
