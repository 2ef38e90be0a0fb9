"""SQL command-line client — the `clickhouse-client` analogue (L7).

Reference parity: programs/client (clickhouse-client) — an interactive
SQL REPL plus one-shot `-q/--query` batch mode with selectable output
formats. The port's counterpart of myscaledb_tpu/cli.py. Two transports:

  * local (default): an in-process Database on the card (`--device
    cuda`, the default; `--device cpu` asks for the CPU); statements run
    through the SQL runner directly (`myscaledb-cli --data-dir ./db`).
    Without CUDA a local session on the default device raises, as
    `connect()` does; it never carries on on the CPU.
  * remote: POST {query} to a running HttpFrontend's /sql endpoint
    (`myscaledb-cli --host 10.0.0.2 --port 8123`).

Formats mirror the reference's common ones: PrettyCompact (default,
aligned table), JSONEachRow, TSV, CSV.

Usage:
  python -m myscaledb_tpu_torch.cli [--data-dir DIR [--device cuda|cpu]
                                     | --host H --port P]
                                    [-q SQL ...] [--format NAME]

With no -q, reads statements from stdin: interactively (with readline
history) when stdin is a TTY, else as a ';'-separated script.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


# ------------------------------------------------------------- formats
def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if v is None:
        return "\\N"
    return str(v)


def format_pretty(rows: List[Dict[str, Any]]) -> str:
    """PrettyCompact-style aligned table."""
    if not rows:
        return "Ok. (0 rows)"
    cols = list(rows[0].keys())
    cells = [[_fmt_value(r.get(c)) for c in cols] for r in rows]
    widths = [
        max(len(c), *(len(row[i]) for row in cells))
        for i, c in enumerate(cols)
    ]
    sep = "─"
    head = " ┃ ".join(c.ljust(w) for c, w in zip(cols, widths))
    bar = "━".join(sep * (w + 2) for w in widths)
    lines = [head, bar[: len(head)]]
    lines += [" │ ".join(row[i].ljust(w) for i, w in enumerate(widths)) for row in cells]
    lines.append(f"({len(rows)} rows)")
    return "\n".join(lines)


def format_json_each_row(rows: List[Dict[str, Any]]) -> str:
    return "\n".join(json.dumps(r, default=str) for r in rows)


def _sv(rows: List[Dict[str, Any]], sep: str) -> str:
    if not rows:
        return ""
    cols = list(rows[0].keys())
    out = [sep.join(cols)]
    out += [sep.join(_fmt_value(r.get(c)) for c in cols) for r in rows]
    return "\n".join(out)


FORMATS = {
    "PrettyCompact": format_pretty,
    "JSONEachRow": format_json_each_row,
    "TSV": lambda rows: _sv(rows, "\t"),
    "CSV": lambda rows: _sv(rows, ","),
}


# ----------------------------------------------------------- transports
class LocalSession:
    """In-process Database session on `device` ("cuda" unless the caller
    asks for the CPU)."""

    def __init__(self, data_dir: Optional[str] = None, device: str = "cuda"):
        from .api.client import connect

        self.db = connect(path=data_dir, device=device)

    def execute(self, statement: str) -> List[Dict[str, Any]]:
        return self.db.sql(statement)

    def close(self):
        self.db.close()


class RemoteSession:
    """HTTP session against a running HttpFrontend (/sql endpoint)."""

    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def execute(self, statement: str) -> List[Dict[str, Any]]:
        import urllib.request

        req = urllib.request.Request(
            self.base + "/sql",
            data=json.dumps({"query": statement}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if isinstance(out, dict) and "error" in out:
            raise RuntimeError(out["error"])
        return out.get("rows", []) if isinstance(out, dict) else out

    def close(self):
        pass


# ---------------------------------------------------------------- REPL
def split_statements(text: str) -> List[str]:
    """Split a script on ';' outside single-quoted strings."""
    out, cur, in_str = [], [], False
    for ch in text:
        if ch == "'":
            in_str = not in_str
            cur.append(ch)
        elif ch == ";" and not in_str:
            s = "".join(cur).strip()
            if s:
                out.append(s)
            cur = []
        else:
            cur.append(ch)
    s = "".join(cur).strip()
    if s:
        out.append(s)
    return out


def run_statement(session, statement: str, fmt: str, out=None) -> bool:
    """Execute + print one statement; returns False on error."""
    import time

    out = out if out is not None else sys.stdout
    t0 = time.time()
    try:
        rows = session.execute(statement)
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"Error: {e}", file=sys.stderr)
        return False
    print(FORMATS[fmt](rows), file=out)
    if fmt == "PrettyCompact":
        print(f"Elapsed: {time.time() - t0:.3f}s", file=out)
    return True


def repl(session, fmt: str) -> int:
    try:
        import readline  # noqa: F401 — history/editing side effect
    except ImportError:
        pass
    print("myscaledb_tpu_torch client. Statements end with ';'; \\q quits.")
    buf: List[str] = []
    while True:
        try:
            line = input(":) " if not buf else "   ")
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if line.strip() in ("\\q", "exit", "quit") and not buf:
            return 0
        buf.append(line)
        joined = "\n".join(buf)
        if joined.rstrip().endswith(";"):
            buf = []
            for st in split_statements(joined):
                run_statement(session, st, fmt)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="myscaledb-cli", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--data-dir", help="local database directory (in-process mode)")
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="the local database's device (in-process mode)",
    )
    ap.add_argument("--host", help="remote HttpFrontend host")
    ap.add_argument("--port", type=int, default=8123, help="remote port")
    ap.add_argument(
        "-q", "--query", action="append",
        help="run statement(s) and exit (repeatable)",
    )
    ap.add_argument(
        "--format", default="PrettyCompact", choices=sorted(FORMATS),
        help="output format",
    )
    args = ap.parse_args(argv)

    if args.host:
        session: Any = RemoteSession(args.host, args.port)
    else:
        session = LocalSession(args.data_dir, args.device)
    try:
        if args.query:
            ok = True
            for q in args.query:
                for st in split_statements(q):
                    ok = run_statement(session, st, args.format) and ok
            return 0 if ok else 1
        if sys.stdin.isatty():
            return repl(session, args.format)
        script = sys.stdin.read()
        ok = True
        for st in split_statements(script):
            ok = run_statement(session, st, args.format) and ok
        return 0 if ok else 1
    finally:
        session.close()


if __name__ == "__main__":
    sys.exit(main())
