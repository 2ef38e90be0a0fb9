"""`tests/test_sql_fuzz.py`'s seeded generator against the port.

The port (`myscaledb_tpu_torch.connect(device="cpu")`) is held to the
same two contracts as the JAX package, on the same generated statements:

  1. crash safety: a statement runs or raises one of the engine's typed
     errors (the port's `MyScaleTPUError` family, or `ValueError` from
     settings), never anything else;
  2. oracle agreement: well-formed WHERE + ORDER BY id + LIMIT selects
     equal a numpy oracle over the raw columns.

A sample of the generated statements (every `SAMPLE_EVERY`-th SELECT or
search, and the head of the mutation stream) also runs through a
`DualDB` (`tests/test_torch_sql.py`), which holds the port's rows to the
JAX package's (exactly, but searched distances within rtol 2e-4 / atol
2e-3) and its errors to JAX's by type.
"""

import random

import numpy as np
import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from test_sql_fuzz import (
    N_GRAMMAR,
    N_MUTATION,
    N_ORACLE,
    NOISE,
    STMT_HEADS,
    _gen_search,
    _gen_select,
)
from test_torch_sql import DualDB

ALLOWED = (tms.MyScaleTPUError, ValueError)
SAMPLE_EVERY = 10
N_MUTATION_SAMPLE = 400


def _fill(db):
    db.sql(
        "CREATE TABLE fz (id UInt64, price Float32, tag String, "
        "vec Array(Float32), CONSTRAINT c CHECK length(vec) = 4) "
        "ENGINE = MergeTree ORDER BY id"
    )
    rng = np.random.default_rng(7)
    n = 500
    db.table("fz").insert({
        "id": np.arange(n, dtype=np.uint64),
        "price": rng.random(n).astype(np.float32) * 100,
        "tag": np.asarray([f"t{i % 7}" for i in range(n)], object),
        "vec": rng.standard_normal((n, 4)).astype(np.float32),
    })
    return db


@pytest.fixture(scope="module")
def pdb():
    db = _fill(tms.connect(device="cpu"))
    yield db
    db.close()


def _grammar(seed, n):
    r = random.Random(seed)
    for _ in range(n):
        yield _gen_search(r) if r.random() < 0.2 else _gen_select(r)


def _mutations(seed, n):
    r = random.Random(seed)
    for _ in range(n):
        parts = [r.choice(STMT_HEADS)]
        for _ in range(r.randint(1, 14)):
            parts.append(r.choice(NOISE))
        yield " ".join(parts)


def test_fuzz_grammar_no_crashes(pdb):
    for sql in _grammar(1234, N_GRAMMAR):
        try:
            assert isinstance(pdb.sql(sql), list)
        except ALLOWED:
            pass


def test_fuzz_mutation_no_crashes(pdb):
    for sql in _mutations(99, N_MUTATION):
        try:
            pdb.sql(sql)
        except ALLOWED:
            pass


def test_fuzz_select_oracle_agreement(pdb):
    pdb.sql("DROP TABLE IF EXISTS fzo")
    pdb.sql(
        "CREATE TABLE fzo (id UInt64, price Float32, tag String) "
        "ENGINE = MergeTree ORDER BY id"
    )
    rng = np.random.default_rng(7)
    n = 500
    ids = np.arange(n, dtype=np.uint64)
    price = rng.random(n).astype(np.float32) * 100
    tag = np.asarray([f"t{i % 7}" for i in range(n)], object)
    pdb.table("fzo").insert({"id": ids, "price": price, "tag": tag})
    r = random.Random(5)
    for _ in range(N_ORACLE):
        lo, hi = sorted((r.randint(0, 100), r.randint(0, 100)))
        tg = f"t{r.randint(0, 6)}"
        lim = r.randint(1, 30)
        rows = pdb.sql(
            f"SELECT id FROM fzo WHERE price >= {lo} AND price <= {hi} "
            f"AND tag = '{tg}' ORDER BY id LIMIT {lim}"
        )
        want = np.sort(ids[(price >= lo) & (price <= hi) & (tag == tg)])[:lim]
        assert [row["id"] for row in rows] == want.tolist()


@pytest.mark.parametrize("stream", ["grammar", "mutation"])
def test_fuzz_sample_matches_jax(stream):
    """The port's rows (or error type) equal the JAX package's on a sample
    of the generated statements; a mutation may DROP or TRUNCATE the
    table, and then both lose it."""
    db = _fill(DualDB())
    try:
        if stream == "grammar":
            stmts = [s for i, s in enumerate(_grammar(1234, N_GRAMMAR)) if i % SAMPLE_EVERY == 0]
        else:
            stmts = list(_mutations(99, N_MUTATION_SAMPLE))
        for sql in stmts:
            try:
                db.sql(sql)
            except ALLOWED + (jms.MyScaleTPUError,):
                pass
        assert db.statements == len(stmts) + 1
    finally:
        db.close()

