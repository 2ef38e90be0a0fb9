"""The SQL dialect: the port (myscaledb_tpu_torch, on the CPU) against the
JAX package, statement by statement.

This file holds the dual harness that the other `test_torch_sql_*.py`
files share, and mirrors `tests/test_sql.py` with it.

A mirrored test is the JAX package's own test function, imported from its
file and run unchanged. While it runs, `myscaledb_tpu.connect` (and with
it the `db` fixture of `tests/conftest.py`) returns a `DualDB`: one
JAX database and one `myscaledb_tpu_torch.connect(device="cpu")`
database fed the same calls. `DualDB.sql` runs every statement through
both, holds the port's result to JAX's, and hands the test JAX's result,
so the test's own asserts run as they always did. Every test of the
source file that issues a SQL statement is mirrored; the others test the
Table API, which `test_torch_table.py` and its siblings hold to JAX.

What is compared, statement by statement:

  * an error: both raise, and the exception types have the same name;
  * rows: the same count, the same column names in the same order, and
    every int, string, None and stored float equal exactly;
  * floats that a search computes (a column that is no stored column, in
    a statement that calls distance / batch_distance / hybridsearch):
    rtol 2e-4, atol 2e-3 (`tests/test_distance_ops.py:37`, the
    reference's f32 tolerance); BM25 scores (textsearch,
    full_text_search) within the port's dense-path bound,
    `text/inverted.py::DENSE_RTOL` (2^-18 relative);
  * order: rows in the same order, except that rows whose searched
    values tie within that tolerance may come in either order, and at
    the last tie group the port may hold another row of the same value
    (which of two tied rows a LIMIT keeps is not part of the result).

A test that switches the JAX runner to its row-dict oracle (it sets
`columnar.run_composite` or `SQLRunner._grouped_fast` to a lambda) gets
the same switch on the port for each statement, so both take one path.
BACKUP / RESTORE paths are given to the port with a `_torch` suffix, and
`connect(path=p)` gives the port `p + "_torch"`, so the two packages
never write into one directory (`test_torch_sql_state.py` carries
checkpoints across on purpose).
"""

from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu.sql import columnar as jcolumnar
from myscaledb_tpu.sql import runner as jrunner
from myscaledb_tpu_torch.sql import columnar as tcolumnar
from myscaledb_tpu_torch.sql import runner as trunner
from myscaledb_tpu_torch.storage import schema as tschema
from myscaledb_tpu_torch.text.inverted import DENSE_RTOL

DIST_RTOL, DIST_ATOL = 2e-4, 2e-3
TEXT_RTOL = DENSE_RTOL
PORT_PATH_SUFFIX = "_torch"

_JAX_CONNECT = jms.connect
_VECTOR_SEARCH = re.compile(r"\b(batch_distance|distance|hybridsearch)\s*[\(\[]", re.I)
_TEXT_SEARCH = re.compile(r"\b(textsearch|full_text_search)\s*[\(\[]", re.I)
_BACKUP_PATH = re.compile(r"^(\s*(?:BACKUP|RESTORE)\b.*?\b(?:TO|FROM)\s+')([^']*)(')", re.I | re.S)

# the JAX runner's path switches, as the package defines them; a test
# that replaces one with a lambda asks for the row-dict oracle
_SWITCHES = (
    (jcolumnar, tcolumnar, "run_composite"),
    (jrunner.SQLRunner, trunner.SQLRunner, "_grouped_fast"),
)
_ORIGINAL = {(id(j), name): j.__dict__[name] for j, _, name in _SWITCHES}


# ----------------------------------------------------------------- translation
def port_path(path):
    return None if path is None else str(path).rstrip("/") + PORT_PATH_SUFFIX


def port_statement(statement: str) -> str:
    return _BACKUP_PATH.sub(lambda m: m.group(1) + port_path(m.group(2)) + m.group(3), statement)


def port_settings(settings):
    """A JAX `Settings` as the port's (the two dataclasses share names)."""
    if settings is None:
        return None
    out = tms.Settings()
    for part in ("query", "table", "server"):
        src, dst = getattr(settings, part), getattr(out, part)
        for f in dataclasses.fields(src):
            setattr(dst, f.name, getattr(src, f.name))
    return out


def port_schema(schema):
    cols = {}
    for name, ct in schema.columns.items():
        cls = getattr(tschema, type(ct).__name__)
        cols[name] = cls(**dataclasses.asdict(ct)) if dataclasses.is_dataclass(ct) else cls()
    return tms.Schema(cols)


def _settings_dict(settings):
    return {p: dataclasses.asdict(getattr(settings, p)) for p in ("query", "table", "server")}


# ------------------------------------------------------------------ comparison
class Tolerance:
    """Which float values are compared with a tolerance, and which one."""

    def __init__(self, statement: str, stored_columns):
        self.rtol = self.atol = None
        if _VECTOR_SEARCH.search(statement):
            self.rtol, self.atol = DIST_RTOL, DIST_ATOL
        elif _TEXT_SEARCH.search(statement):
            self.rtol, self.atol = TEXT_RTOL, 0.0
        self.stored = set(stored_columns)

    def applies(self, column) -> bool:
        return self.rtol is not None and column not in self.stored


def _float_eq(a, b, tol) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    if tol is None:
        return a == b
    return abs(a - b) <= tol.atol + tol.rtol * abs(a)


def values_equal(a, b, tol=None) -> bool:
    """`a` (JAX) and `b` (port) are equal: exactly, or, for floats, within
    `tol` when it is given."""
    if isinstance(a, (bool, np.bool_)) or isinstance(b, (bool, np.bool_)):
        return bool(a) == bool(b) and type(a) is type(b)
    if isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        return (
            isinstance(a, (float, np.floating)) and isinstance(b, (float, np.floating))
            and _float_eq(float(a), float(b), tol)
        )
    if isinstance(a, dict) or isinstance(b, dict):
        return (
            isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b)
            and all(values_equal(a[k], b[k], tol) for k in a)
        )
    if isinstance(a, (list, tuple, np.ndarray)) or isinstance(b, (list, tuple, np.ndarray)):
        if type(a) is not type(b) and not (
            isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        ):
            return False
        return len(a) == len(b) and all(values_equal(x, y, tol) for x, y in zip(a, b))
    if type(a).__module__.startswith(("myscaledb_tpu.", "myscaledb_tpu_torch.")):
        # an object of each package (an index description, an enum)
        return type(a).__name__ == type(b).__name__ and repr(a) == repr(b)
    return type(a) is type(b) and a == b


def _row_equal(ra, rb, tol, searched_only=False) -> bool:
    if list(ra) != list(rb):
        return False
    compared = 0
    for c in ra:
        t = tol if tol is not None and tol.applies(c) else None
        if searched_only and t is None:
            continue
        if not values_equal(ra[c], rb[c], t):
            return False
        compared += 1
    return compared > 0 or not searched_only


def _tie_key_equal(ra, rb, tol) -> bool:
    """The searched values of two rows tie within the tolerance."""
    cols = [c for c in ra if tol.applies(c)]
    return bool(cols) and all(c in rb and values_equal(ra[c], rb[c], tol) for c in cols)


def rows_match(jax_rows, port_rows, tol: Tolerance) -> bool:
    if not isinstance(jax_rows, list) or not isinstance(port_rows, list):
        return values_equal(jax_rows, port_rows, None)
    if len(jax_rows) != len(port_rows):
        return False
    if all(_row_equal(a, b, tol) for a, b in zip(jax_rows, port_rows)):
        return True
    if tol.rtol is None:
        return False
    # rows that tie on their searched values may come in either order
    i, n = 0, len(jax_rows)
    while i < n:
        j = i + 1
        while j < n and _tie_key_equal(jax_rows[i], jax_rows[j], tol):
            j += 1
        group, cand = jax_rows[i:j], list(port_rows[i:j])
        last = j == n
        for a in group:
            hit = next((b for b in cand if _row_equal(a, b, tol)), None)
            if hit is None and last:
                # the LIMIT may keep another row of the same searched value
                hit = next((b for b in cand if _row_equal(a, b, tol, searched_only=True)), None)
            if hit is None:
                return False
            cand.remove(hit)
        i = j
    return True


def assert_same_result(statement, jax_out, jax_err, port_out, port_err, stored=()):
    if jax_err is not None or port_err is not None:
        assert jax_err is not None and port_err is not None, (
            f"{statement!r}: JAX {'raised ' + repr(jax_err) if jax_err else 'returned'}, "
            f"port {'raised ' + repr(port_err) if port_err else 'returned ' + repr(port_out)[:400]}"
        )
        assert type(jax_err).__name__ == type(port_err).__name__, (
            f"{statement!r}: JAX raised {jax_err!r}, port {port_err!r}"
        )
        return
    tol = Tolerance(statement, stored)
    assert rows_match(jax_out, port_out, tol), (
        f"{statement!r}:\n JAX  {repr(jax_out)[:1500]}\n port {repr(port_out)[:1500]}"
    )


def _call(fn, *a, **kw):
    try:
        return fn(*a, **kw), None
    except Exception as e:  # noqa: BLE001 — compared, then re-raised
        return None, e


class _MirroredSwitches:
    """Give the port each path switch that the JAX side has turned off."""

    def __enter__(self):
        self._undo = []
        for j, t, name in _SWITCHES:
            cur = j.__dict__[name]
            fn = cur.__func__ if isinstance(cur, staticmethod) else cur
            if cur is not _ORIGINAL[(id(j), name)] and getattr(fn, "__name__", "") == "<lambda>":
                self._undo.append((t, name, t.__dict__[name]))
                setattr(t, name, cur)
        return self

    def __exit__(self, *exc):
        for t, name, orig in self._undo:
            setattr(t, name, orig)


# ---------------------------------------------------------------- dual handles
class DualTable:
    """A table of both databases; calls go to both and are compared."""

    def __init__(self, jt, tt):
        self.j, self.t = jt, tt

    def insert(self, columns, **kw):
        a, b = self.j.insert(columns, **kw), self.t.insert(columns, **kw)
        assert a == b, (a, b)
        return a

    def _both(self, name, *a, **kw):
        ra, ea = _call(getattr(self.j, name), *a, **kw)
        rb, eb = _call(getattr(self.t, name), *a, **kw)
        assert_same_result(f"Table.{name}", ra, ea, rb, eb)
        if ea is not None:
            raise ea
        return ra

    def add_vector_index(self, *a, **kw):
        return self._both("add_vector_index", *a, **kw)

    def add_fts_index(self, *a, **kw):
        a_def, b_def = self.j.add_fts_index(*a, **kw), self.t.add_fts_index(*a, **kw)
        assert (a_def.name, a_def.columns, a_def.params) == (b_def.name, b_def.columns, b_def.params)
        return a_def

    def wait_index_built(self, *a, **kw):
        return self._both("wait_index_built", *a, **kw)

    def live_segments(self):
        a, b = self.j.live_segments(), self.t.live_segments()
        assert [(s.segment_id, s.n_rows, int(s.num_live)) for s in a] == [
            (s.segment_id, s.n_rows, int(s.num_live)) for s in b
        ]
        return a

    @property
    def schema(self):
        assert repr(self.j.schema.columns) == repr(self.t.schema.columns)
        return self.j.schema

    @property
    def settings(self):
        assert _settings_dict(self.j.settings) == _settings_dict(self.t.settings)
        return self.j.settings


class DualDB:
    """A JAX database and a port database (CPU) fed the same calls."""

    def __init__(self, settings=None, **kw):
        path = kw.pop("path", None)
        self.j = _JAX_CONNECT(settings, path=path, **kw)
        self.t = tms.connect(port_settings(settings), path=port_path(path), device="cpu", **kw)
        self.statements = 0

    def _stored_columns(self):
        return {c for n in self.j.tables() for c in self.j.table(n).schema.columns}

    def sql(self, statement):
        ra, ea = _call(self.j.sql, statement)
        ported = port_statement(statement)
        with _MirroredSwitches():
            rb, eb = _call(self.t.sql, ported)
        if ported != statement and rb:
            # the port names its own directory where JAX names the original
            m = _BACKUP_PATH.match(statement)
            own, orig = port_path(m.group(2)), m.group(2)
            rb = [{c: orig if v == own else v for c, v in r.items()} for r in rb]
        self.statements += 1
        assert_same_result(statement, ra, ea, rb, eb, self._stored_columns())
        if ea is not None:
            raise ea
        return ra

    def tables(self):
        a, b = self.j.tables(), self.t.tables()
        assert a == b, (a, b)
        return a

    def table(self, name):
        ta, ea = _call(self.j.table, name)
        tb, eb = _call(self.t.table, name)
        assert_same_result(f"table({name!r})", None, ea, None, eb)
        if ea is not None:
            raise ea
        return DualTable(ta, tb)

    def create_table(self, name, schema, settings=None, **kw):
        ta = self.j.create_table(name, schema, settings, **kw)
        tb = self.t.create_table(name, port_schema(schema), port_settings(settings), **kw)
        return DualTable(ta, tb)

    @property
    def settings(self):
        assert _settings_dict(self.j.settings) == _settings_dict(self.t.settings)
        return self.j.settings

    def full_text_search(self, *a, **kw):
        ra, ea = _call(self.j.full_text_search, *a, **kw)
        rb, eb = _call(self.t.full_text_search, *a, **kw)
        assert_same_result("full_text_search(", ra, ea, rb, eb, self._stored_columns())
        if ea is not None:
            raise ea
        return ra

    def close(self):
        self.j.close()
        self.t.close()


def dual_connect(settings=None, **kw):
    return DualDB(settings, **kw)


@pytest.fixture(scope="module", autouse=True)
def dual_databases():
    """`myscaledb_tpu.connect` returns a DualDB for this module's tests
    (the conftest `db` fixture included)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jms, "connect", dual_connect)
        yield


def mirror(source, namespace) -> list:
    """Bind into `namespace` every fixture of the JAX test module `source`
    and every test function of it that issues a SQL statement."""
    import inspect

    names = []
    for name, obj in vars(source).items():
        if name == "db":
            continue
        if hasattr(obj, "_fixture_function_marker") or type(obj).__name__ == "FixtureFunctionDefinition":
            namespace[name] = obj
        elif name.startswith("test_") and callable(obj):
            if ".sql(" in inspect.getsource(obj):
                namespace[name] = obj
                names.append(name)
    return names


import test_sql as _source  # noqa: E402

MIRRORED = mirror(_source, globals())


# -------------------------------------------------------- the harness itself
def test_mirror_binds_the_sql_tests():
    assert len(MIRRORED) >= 15
    assert "test_distance_query" in MIRRORED and "test_settings_override_coercion" not in MIRRORED


def test_settings_override_coercion_port():
    """test_sql.py's settings test on the port's Settings."""
    st = tms.Settings()
    out = st.override({"use_approx_topk": "true", "default_topk": "50",
                       "hybrid_search_fusion_weight": "0.25",
                       "vector_index_cache_size": "1000"})
    assert out.query.use_approx_topk is True and out.query.default_topk == 50
    assert abs(out.query.hybrid_search_fusion_weight - 0.25) < 1e-9
    assert out.server.vector_index_cache_size == 1000
    assert st.query.default_topk != 50
    with pytest.raises(ValueError):
        st.override({"no_such": 1})
    with pytest.raises(ValueError):
        st.override({"use_approx_topk": "yes"})


_SEARCH = "SELECT id, distance(vec, [0.0]) AS d FROM t ORDER BY d LIMIT 3"


@pytest.mark.parametrize(
    "jax_rows, port_rows, statement, same",
    [
        # a distance inside the tolerance, and one outside it
        ([{"id": 1, "d": 1.0}], [{"id": 1, "d": 1.0002}], _SEARCH, True),
        ([{"id": 1, "d": 1.0}], [{"id": 1, "d": 1.01}], _SEARCH, False),
        # a stored float is exact, also in a search statement
        ([{"id": 1, "price": 1.0}], [{"id": 1, "price": 1.0001}], _SEARCH, False),
        # no tolerance outside a search
        ([{"s": 6.0}], [{"s": 6.0000001}], "SELECT sum(price) AS s FROM t", False),
        # ids: a swap of two distinct distances fails, of tied ones passes
        ([{"id": 1, "d": 1.0}, {"id": 2, "d": 2.0}],
         [{"id": 2, "d": 2.0}, {"id": 1, "d": 1.0}], _SEARCH, False),
        ([{"id": 1, "d": 1.0}, {"id": 2, "d": 1.0}, {"id": 3, "d": 5.0}],
         [{"id": 2, "d": 1.0}, {"id": 1, "d": 1.0}, {"id": 3, "d": 5.0}], _SEARCH, True),
        # another row of the k-th value, at the end only
        ([{"id": 1, "d": 1.0}, {"id": 2, "d": 2.0}],
         [{"id": 1, "d": 1.0}, {"id": 7, "d": 2.0}], _SEARCH, True),
        ([{"id": 1, "d": 1.0}, {"id": 2, "d": 2.0}],
         [{"id": 9, "d": 1.0}, {"id": 2, "d": 2.0}], _SEARCH, False),
        # column names and order, types, lengths
        ([{"id": 1, "d": 1.0}], [{"d": 1.0, "id": 1}], _SEARCH, False),
        ([{"x": 1}], [{"x": 1.0}], "SELECT x FROM t", False),
        ([{"x": 1}], [], "SELECT x FROM t", False),
        # batch_distance's (query, distance) tuples
        ([{"id": 1, "d": (0, 1.0)}], [{"id": 1, "d": (0, 1.0001)}],
         "SELECT id, batch_distance(vec, [[0.0]]) AS d FROM t ORDER BY d.2 LIMIT 1 BY d.1", True),
        ([{"id": 1, "d": (0, 1.0)}], [{"id": 1, "d": (1, 1.0)}],
         "SELECT id, batch_distance(vec, [[0.0]]) AS d FROM t ORDER BY d.2 LIMIT 1 BY d.1", False),
        # BM25 scores: the port's dense-path bound
        ([{"id": 1, "s": 3.0}], [{"id": 1, "s": 3.0 * (1 + 2**-20)}],
         "SELECT id, textsearch(body, 'a') AS s FROM t ORDER BY s DESC LIMIT 1", True),
        ([{"id": 1, "s": 3.0}], [{"id": 1, "s": 3.0001}],
         "SELECT id, textsearch(body, 'a') AS s FROM t ORDER BY s DESC LIMIT 1", False),
    ],
)
def test_comparison_rules(jax_rows, port_rows, statement, same):
    tol = Tolerance(statement, {"id", "price", "vec", "body", "x"})
    assert rows_match(jax_rows, port_rows, tol) is same


def test_errors_compare_by_type():
    assert_same_result("s", None, jms.SQLError("x"), None, tms.SQLError("y"))
    with pytest.raises(AssertionError):
        assert_same_result("s", None, jms.SQLError("x"), None, tms.QueryShapeError("x"))
    with pytest.raises(AssertionError):
        assert_same_result("s", None, jms.SQLError("x"), [], None)


def test_backup_paths_are_kept_apart():
    assert port_statement("BACKUP TABLE t TO '/x/bk'") == "BACKUP TABLE t TO '/x/bk_torch'"
    assert port_statement("RESTORE TABLE t FROM '/x/bk'") == "RESTORE TABLE t FROM '/x/bk_torch'"
    assert port_statement("SELECT 'TO' FROM t") == "SELECT 'TO' FROM t"


def test_db_fixture_is_dual(db):
    assert isinstance(db, DualDB)
    assert db.sql("SELECT 2 + 3 AS five") == [{"five": 5}] and db.statements == 1


def test_dual_catches_a_port_fault(db, monkeypatch):
    """A port that loses its last row fails the comparison."""
    db.sql("CREATE TABLE f (id UInt64, vec Array(Float32), CONSTRAINT c CHECK length(vec) = 2)")
    db.sql("INSERT INTO f VALUES (1, [0.0, 0.0]), (2, [1.0, 1.0]), (3, [2.0, 2.0])")
    q = "SELECT id, distance(vec, [0.0, 0.1]) AS d FROM f ORDER BY d LIMIT 3"
    assert [r["id"] for r in db.sql(q)] == [1, 2, 3]
    execute = trunner.SQLRunner.execute
    monkeypatch.setattr(trunner.SQLRunner, "execute", lambda self, s: execute(self, s)[:-1])
    with pytest.raises(AssertionError):
        db.sql(q)
