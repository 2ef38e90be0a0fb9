"""SHOW / DESCRIBE / EXPLAIN (the routing text), DISTINCT, TRUNCATE, RENAME, INSERT SELECT, BACKUP / RESTORE: `tests/test_sql_introspection.py` on the port.

Each test of the source that issues a SQL statement runs unchanged
against a `DualDB` (`tests/test_torch_sql.py`): every statement goes to
the JAX package and to `myscaledb_tpu_torch.connect(device="cpu")`, and
the port's rows are held to JAX's as that file's docstring states
(ints, strings and stored values exactly; searched distances within
rtol 2e-4 / atol 2e-3; BM25 scores within 2^-18; errors by type).
"""

from test_torch_sql import dual_databases, mirror  # noqa: F401 (the autouse fixture)

import test_sql_introspection as _test_sql_introspection  # noqa: E402

MIRRORED = mirror(_test_sql_introspection, globals())


def test_mirror_binds_the_sql_tests():
    assert MIRRORED
