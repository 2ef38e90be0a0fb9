"""HTTP index exchange between replicas (DataPartsExchange analogue).

The reference fetches built `.vidx3` files replica-to-replica over HTTP
with a `?vector_index=<name>` param and a cookie-based status protocol
(the reference's `src/Storages/MergeTree/DataPartsExchange.cpp:127-217`).
TPU-native mapping: the builder replica persists each built index
(checksums.json written LAST marks a complete set — the same
commit-marker idea as the reference's checksums file) and serves the
directory over a small stdlib HTTP endpoint; fetchers download the file
set into a `vector_tmp_*` staging dir, verify every sha256, and
atomically `os.replace` it into their own store — the reference's
tmp-dir + atomic-move protocol (`VIBuilderUpdater.cpp:664-763`).

Status signalling (the cookie analogue) rides in the `X-Index-Status`
response header: `ok`, `building` (dir exists but incomplete), or
`absent`.

A copy of myscaledb_tpu/service/exchange.py: the wire (routes, manifest,
`X-Index-Status`) and the layout are the JAX package's, so a port replica
fetches from a JAX builder and the reverse. The server only reads files
and touches no tensor.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ..storage.persistence import _verify_checksums
from .event_log import GLOBAL_COUNTERS


def _index_dir(root: str, table: str, segment_id: int, name: str) -> str:
    return os.path.join(root, table, f"segment_{segment_id}", f"index_{name}")


class IndexExchangeServer:
    """Serves persisted index directories to peer replicas.

    Routes:
      GET /index/<table>/<segment_id>/<name>            -> manifest JSON
      GET /index/<table>/<segment_id>/<name>/<file>     -> file bytes
    """

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        self.root = os.path.abspath(root)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                parts = [p for p in self.path.split("/") if p]
                if len(parts) not in (4, 5) or parts[0] != "index":
                    self.send_error(404)
                    return
                _, table, seg, name = parts[:4]
                if any(os.sep in p or p in ("..", ".") for p in parts[1:]):
                    self.send_error(400)
                    return
                d = _index_dir(outer.root, table, int(seg), name)
                complete = os.path.exists(os.path.join(d, "checksums.json"))
                if len(parts) == 4:
                    if not os.path.isdir(d):
                        self.send_response(404)
                        self.send_header("X-Index-Status", "absent")
                        self.end_headers()
                        return
                    if not complete:
                        self.send_response(404)
                        self.send_header("X-Index-Status", "building")
                        self.end_headers()
                        return
                    files = sorted(
                        f for f in os.listdir(d)
                        if os.path.isfile(os.path.join(d, f))
                    )
                    body = json.dumps({"files": files}).encode()
                    self.send_response(200)
                    self.send_header("X-Index-Status", "ok")
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                fpath = os.path.join(d, parts[4])
                if not (complete and os.path.isfile(fpath)):
                    self.send_error(404)
                    return
                with open(fpath, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="index-exchange", daemon=True
        )
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self._thread.join(timeout=5)
        # the listening socket too: a fetcher's next poll is refused at once
        self.httpd.server_close()


def fetch_index(
    base_url: str,
    table: str,
    segment_id: int,
    index_name: str,
    dest_root: str,
    *,
    timeout_s: float = 60.0,
    poll_interval_s: float = 0.25,
) -> Optional[str]:
    """Download a peer's built index into `dest_root`'s table layout.

    Polls the manifest until the peer reports a complete set (status
    `ok`), downloads every file into a vector_tmp_* staging dir, verifies
    checksums, and atomically moves it into place. Returns the final dir,
    or None on timeout/verification failure (caller rebuilds locally)."""
    prefix = f"{base_url}/index/{table}/{segment_id}/{index_name}"
    deadline = time.time() + timeout_s
    files: Optional[List[str]] = None
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(prefix, timeout=10) as r:
                files = json.loads(r.read())["files"]
                break
        except Exception:  # noqa: BLE001 — absent/building/conn refused: poll
            time.sleep(poll_interval_s)
    if files is None:
        return None
    seg_dir = os.path.join(dest_root, f"segment_{segment_id}")
    os.makedirs(seg_dir, exist_ok=True)
    tmp = os.path.join(seg_dir, f"vector_tmp_{index_name}")
    final = os.path.join(seg_dir, f"index_{index_name}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        for fname in files:
            # Peer-supplied names must be plain file names: a malicious
            # manifest entry like '../../x' or an absolute path would
            # escape the staging dir BEFORE checksum verification runs
            # (mirror of the server-side path sanitization above).
            if (
                not fname
                or os.path.isabs(fname)
                or "/" in fname
                or os.sep in fname
                or (os.altsep and os.altsep in fname)
                or fname in (".", "..")
            ):
                raise ValueError(f"unsafe manifest entry: {fname!r}")
            with urllib.request.urlopen(f"{prefix}/{fname}", timeout=60) as r:
                with open(os.path.join(tmp, fname), "wb") as f:
                    shutil.copyfileobj(r, f)
        _verify_checksums(tmp)
    except Exception:  # noqa: BLE001 — bad download: no partial installs
        shutil.rmtree(tmp, ignore_errors=True)
        GLOBAL_COUNTERS.bump("ReplicatedPartVectorIndexFailedFetches")
        return None
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final
