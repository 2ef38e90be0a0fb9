"""The port stands alone: importing it pulls in neither JAX, ml_dtypes nor
the JAX package, nothing builds at import time, and nothing falls back
to the CPU quietly when CUDA is asked for."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "myscaledb_tpu_torch")
FORBIDDEN = ("jax", "ml_dtypes", "myscaledb_tpu")


def _run(code, cwd=REPO, **env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={**os.environ, **env},
    )


def test_import_pulls_in_no_jax():
    code = (
        "import sys, myscaledb_tpu_torch, myscaledb_tpu_torch.storage.convert\n"
        "from myscaledb_tpu_torch.ops import _cuda, binary, bruteforce, gathermv, kmeans, quantize\n"
        "from myscaledb_tpu_torch.ops import distance, stream, tilescan\n"
        "from myscaledb_tpu_torch.index import base, binary, flat, hnsw, ivf\n"
        "from myscaledb_tpu_torch.search import executor\n"
        "from myscaledb_tpu_torch.storage import convert, hbm, segment, table\n"
        "from myscaledb_tpu_torch.text import analyzer, inverted, native\n"
        "from myscaledb_tpu_torch.search import fusion, text_executor\n"
        "from myscaledb_tpu_torch.cache import lru\n"
        "from myscaledb_tpu_torch.index import decoupled\n"
        "from myscaledb_tpu_torch.service import background, system_log\n"
        "from myscaledb_tpu_torch.storage import persistence, stores\n"
        "from myscaledb_tpu_torch.sql import columnar, parser, runner\n"
        "from myscaledb_tpu_torch.service import server\n"
        "from myscaledb_tpu_torch import cli\n"
        "from myscaledb_tpu_torch.service import data_replication, exchange, replication\n"
        "from myscaledb_tpu_torch.parallel import sharded_table\n"
        "assert myscaledb_tpu_torch.ShardedTable is sharded_table.ShardedTable\n"
        "from myscaledb_tpu_torch.parallel import distributed, mesh_table\n"
        "assert myscaledb_tpu_torch.MeshTable is mesh_table.MeshTable\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'myscaledb_tpu'))\n"
        "assert not bad, bad\n"
        "assert _cuda.LIBRARY._lib is None  # nothing is built at import\n"
        "print('clean')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _python_files():
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build output, git-ignored
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_python_files()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_connect_cuda_without_cuda_raises():
    code = (
        "import myscaledb_tpu_torch as ms\n"
        "try:\n"
        "    ms.connect(device='cuda')\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    print('no error')\n"
    )
    out = _run(code, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:"), out.stdout


def test_replica_database_without_cuda_raises():
    """A replica of a set (and so its tables, the sync thread's applies and
    its index fetches) is on the card unless the caller asks for the CPU."""
    code = (
        "import myscaledb_tpu_torch as ms\n"
        "try:\n"
        "    ms.connect(replica_id=0, n_replicas=2, replica_peers=['http://127.0.0.1:9', None])\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    print('no error')\n"
    )
    out = _run(code, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised:"), out.stdout


def _cli(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "myscaledb_tpu_torch.cli", *args], cwd=REPO,
        capture_output=True, text=True, timeout=120, env={**os.environ, **env},
    )


def test_cli_local_session_without_cuda_raises():
    """The CLI's local session is on the card unless `--device cpu` asks
    for the CPU: without CUDA it raises and prints no rows."""
    out = _cli("-q", "SELECT 1", "--format", "JSONEachRow", CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_cli_local_session_on_cpu_runs():
    out = _cli("--device", "cpu", "-q", "SELECT 1", "--format", "JSONEachRow",
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '{"1": 1}'


def test_chip_smoke_without_cuda_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout == ""


def test_no_quiet_fallback_for_other_devices():
    """A tensor that is neither on the CPU nor on CUDA reaches no plain
    version and no kernel: the wrappers raise, and so does connect()."""
    import torch

    import myscaledb_tpu_torch as ms
    from myscaledb_tpu_torch.metrics import Metric
    from myscaledb_tpu_torch.ops import binary, distance, gathermv, tilescan

    q = torch.empty((8, 128), device="meta")
    x = torch.empty((256, 128), device="meta")
    aux = torch.empty((256,), device="meta")
    m8 = torch.empty((256,), dtype=torch.uint8, device="meta")
    rows = torch.empty((8, 8), dtype=torch.int32, device="meta")
    nb = torch.empty((256, 32, 128), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gathermv.gather_block_scores(q, rows, nb)
    with pytest.raises(ValueError, match="unsupported device"):
        distance.scores(q, x, aux, metric=Metric.L2)
    with pytest.raises(ValueError, match="unsupported device"):
        tilescan.tile_maxes(q, x, aux, m8, metric=Metric.L2)
    with pytest.raises(ValueError, match="unsupported device"):
        ms.connect(device="meta")
    qb = torch.empty((8, 16), dtype=torch.uint8, device="meta")
    xb = torch.empty((256, 16), dtype=torch.uint8, device="meta")
    blocks = torch.empty((4, 64, 16), dtype=torch.uint8, device="meta")
    blk = torch.empty((8, 2), dtype=torch.int32, device="meta")
    brows = torch.empty((4, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        binary.binary_scores(qb, xb, Metric.HAMMING)
    with pytest.raises(ValueError, match="unsupported device"):
        binary.binary_block_scores(qb, blocks, blk, brows, Metric.JACCARD)


def test_program_runtime_knows_none_of_its_callers():
    """search/program.py is the bottom of the search stack: it imports
    nothing from the index, filter, executor or storage layers, and sets
    attributes only on its own objects (`self`, a device's state `st`)."""
    path = os.path.join(PKG, "search", "program.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    callers = ("myscaledb_tpu_torch.index", "myscaledb_tpu_torch.search.filters",
               "myscaledb_tpu_torch.search.executor", "myscaledb_tpu_torch.storage")
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:  # relative to the package myscaledb_tpu_torch.search
                pkg = ["myscaledb_tpu_torch", "search"][: 3 - node.level]
                module = ".".join(pkg + ([module] if module else []))
            names = [module] + [f"{module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            names = []
        for name in names:
            assert not any(name == c or name.startswith(c + ".") for c in callers), name
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tg in targets:
                for t in ast.walk(tg):
                    if isinstance(t, ast.Attribute) and isinstance(t.ctx, ast.Store):
                        assert isinstance(t.value, ast.Name) and t.value.id in ("self", "st"), (
                            f"program.py:{t.lineno} sets an attribute on another object")
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id != "setattr", f"program.py:{node.lineno} calls setattr"
        if isinstance(node, ast.Attribute):
            assert node.attr != "__dict__", f"program.py:{node.lineno} reaches into a __dict__"
