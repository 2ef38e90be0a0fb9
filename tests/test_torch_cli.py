"""The port's SQL command-line client (`python -m myscaledb_tpu_torch.cli`),
after `tests/test_cli.py`: statement splitting and the output formats
(each equal to the JAX client's on the same rows), the local one-shot mode
on the CPU (`--device cpu`; the default device is the card, and
`tests/test_torch_imports.py` holds that it raises without one), the
error exit code, and the remote mode against the port's `HttpFrontend`,
whose rows equal the JAX frontend's for the same statements (exactly:
these statements search nothing).
"""

import json

import pytest

import myscaledb_tpu as jms
import myscaledb_tpu_torch as tms
from myscaledb_tpu import cli as jcli
from myscaledb_tpu.service.server import HttpFrontend as JHttpFrontend
from myscaledb_tpu_torch import cli
from myscaledb_tpu_torch.service.server import HttpFrontend

SCRIPTS = [
    "CREATE TABLE t (x UInt64); INSERT INTO t VALUES ('a;b'); SELECT 1",
    "SELECT 1;;  ; SELECT 'x;y' AS s;\nSELECT 2",
    "",
]
ROWS = [
    [{"a": 1, "b": "x"}, {"a": 2.5, "b": "y"}],
    [{"n": None, "f": 1.0 / 3.0, "s": "tab\there"}],
    [],
]


@pytest.mark.parametrize("script", SCRIPTS)
def test_split_statements(script):
    assert cli.split_statements(script) == jcli.split_statements(script)
    parts = cli.split_statements(SCRIPTS[0])
    assert len(parts) == 3 and parts[1] == "INSERT INTO t VALUES ('a;b')"


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("fmt", sorted(cli.FORMATS))
def test_formats_match_jax(rows, fmt):
    assert sorted(cli.FORMATS) == sorted(jcli.FORMATS)
    assert cli.FORMATS[fmt](rows) == jcli.FORMATS[fmt](rows)


def test_formats():
    rows = ROWS[0]
    pretty = cli.format_pretty(rows)
    assert "a" in pretty and "2.5" in pretty and "(2 rows)" in pretty
    assert json.loads(cli.format_json_each_row(rows).splitlines()[0]) == {"a": 1, "b": "x"}
    tsv = cli.FORMATS["TSV"](rows).splitlines()
    assert tsv[0] == "a\tb" and tsv[1] == "1\tx"
    assert cli.FORMATS["CSV"](rows).splitlines()[2] == "2.5,y"
    assert cli.format_pretty([]) == "Ok. (0 rows)"


def test_local_oneshot(capsys):
    rc = cli.main([
        "--device", "cpu",
        "-q", "CREATE TABLE cli_t (id UInt64, v Float32, vec Array(Float32), "
              "CONSTRAINT c CHECK length(vec) = 2)",
        "-q", "INSERT INTO cli_t VALUES (1, 1.5, [0.0, 1.0]), (2, 2.5, [1.0, 1.0])",
        "-q", "SELECT id, v FROM cli_t ORDER BY id",
        "-q", "SELECT id, distance(vec, [1.0, 1.0]) AS d FROM cli_t ORDER BY d LIMIT 1",
        "--format", "JSONEachRow",
    ])
    assert rc == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert rows == [{"id": 1, "v": 1.5}, {"id": 2, "v": 2.5}, {"id": 2, "d": 0.0}]


def test_local_session_takes_the_device():
    s = cli.LocalSession(device="cpu")
    try:
        assert s.db.device.type == "cpu"
    finally:
        s.close()


def test_local_error_exit_code(capsys):
    rc = cli.main(["--device", "cpu", "-q", "SELECT FROM nowhere !!"])
    assert rc == 1
    assert "Error" in capsys.readouterr().err


def test_stdin_script(capsys, monkeypatch):
    import io

    monkeypatch.setattr("sys.stdin", io.StringIO("SELECT 1 AS a; SELECT 2 AS b;"))
    assert cli.main(["--device", "cpu", "--format", "JSONEachRow"]) == 0
    assert capsys.readouterr().out.split() == ['{"a":', '1}', '{"b":', '2}']


STATEMENTS = [
    "SELECT id FROM cli_r ORDER BY id",
    "SELECT count() FROM cli_r",
    "SELECT sum(v) AS s, max(id) AS m FROM cli_r WHERE id > 7",
    "SHOW TABLES",
]


@pytest.mark.parametrize("fmt", ["JSONEachRow", "TSV", "CSV"])
def test_remote_mode_matches_jax(capsys, fmt):
    outs = []
    for ms, front_cls, client in ((jms, JHttpFrontend, jcli), (tms, HttpFrontend, cli)):
        db = ms.connect() if ms is jms else ms.connect(device="cpu")
        front = front_cls(db, port=0)
        try:
            db.sql("CREATE TABLE cli_r (id UInt64, v Float32)")
            db.sql("INSERT INTO cli_r VALUES (7, 0.5), (9, 1.25), (8, 2.0)")
            args = ["--host", "127.0.0.1", "--port", str(front.port), "--format", fmt]
            for st in STATEMENTS:
                args += ["-q", st]
            assert client.main(args) == 0
            outs.append(capsys.readouterr().out)
        finally:
            front.close()
            db.close()
    assert outs[0] == outs[1]
    if fmt == "JSONEachRow":
        assert json.loads(outs[1].splitlines()[0]) == {"id": 7}


def test_remote_error_exit_code(capsys):
    db = tms.connect(device="cpu")
    front = HttpFrontend(db, port=0)
    try:
        rc = cli.main(["--host", "127.0.0.1", "--port", str(front.port), "-q", "SELECT x FROM nowhere"])
        assert rc == 1
        assert "Error" in capsys.readouterr().err
    finally:
        front.close()
        db.close()
