"""MeshTable checkpoints cross between the packages: the port (a Mesh of
`cpu` entries) loads the JAX package's per-shard layout (meshtable.json
and shard_{s}.npz) and the older monolithic meshtable.npz, and the JAX
package loads the port's; the reloaded tables return the same hits as the
table that saved them (ids equal, scores within rtol 2e-4 / atol 2e-3,
BM25 ties broken by slot on both). Also: `MeshTable` is exported, and
`make_mesh` / a MeshTable with no mesh raise without CUDA."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import myscaledb_tpu_torch as tms
from myscaledb_tpu.parallel.mesh_table import MeshTable as JMeshTable
from myscaledb_tpu_torch.parallel.distributed import Mesh, make_mesh
from myscaledb_tpu_torch.parallel.mesh_table import MeshTable as TMeshTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-3)
N, D = 3000, 24
TEXTS = ["needle5", "alpha", "gamma beta", "doc77"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    ids = np.arange(N, dtype=np.int64) * 5 + 1
    price = rng.integers(0, 1000, N).astype(np.int32)
    docs = np.array([f"needle{i} gamma" if i % 4 == 0 else f"alpha beta doc{i}"
                     for i in range(N)], dtype=object)
    q = (vecs[rng.choice(N, 8, replace=False)]
         + 0.05 * rng.standard_normal((8, D))).astype(np.float32)
    return ids, vecs, price, docs, q


def _fill(t, data):
    ids, vecs, price, docs, _ = data
    t.insert({"id": ids[:2000], "vec": vecs[:2000], "price": price[:2000], "body": docs[:2000]})
    t.insert({"id": ids[2000:], "vec": vecs[2000:], "price": price[2000:], "body": docs[2000:]})
    t.delete(ids[[3, 100, 2500]])
    return t


def _answers(t, q):
    return [
        t.search(q, 10),
        t.search(q, 5, filter=lambda price: price < 300),
        t.text_search(TEXTS, 6),
    ]


def _same(got, want):
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, **TOL)


def _cpu_mesh(n=8):
    return make_mesh(n, device="cpu")


def test_jax_checkpoint_loads_in_port(tmp_path, data):
    q = data[4]
    j = _fill(JMeshTable("x", D, filter_columns=("price",), text_column="body"), data)
    want = _answers(j, q)
    j.save(str(tmp_path / "j"))
    t = TMeshTable.load(str(tmp_path / "j"), mesh=_cpu_mesh())
    assert t.n_rows == j.n_rows == N - 3
    assert t.n_shards == j.n_shards
    _same(_answers(t, q), want)
    # a loading mesh of another shard count redistributes the rows
    t4 = TMeshTable.load(str(tmp_path / "j"), mesh=_cpu_mesh(4))
    assert t4.n_shards == 4 and t4.n_rows == N - 3
    got = t4.search(q, 10)
    np.testing.assert_array_equal(got[0], want[0][0])
    np.testing.assert_allclose(got[1], want[0][1], **TOL)


def test_port_checkpoint_loads_in_jax(tmp_path, data):
    q = data[4]
    t = _fill(TMeshTable("x", D, mesh=_cpu_mesh(), filter_columns=("price",),
                         text_column="body"), data)
    want = _answers(t, q)
    t.save(str(tmp_path / "t"))
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == ["meshtable.json"] + [f"shard_{s}.npz" for s in range(8)]
    j = JMeshTable.load(str(tmp_path / "t"))
    assert j.n_rows == t.n_rows == N - 3
    _same(_answers(j, q), want)


def test_legacy_monolithic_checkpoint_in_both(tmp_path, data):
    ids, vecs, price, docs, q = data
    root = tmp_path / "legacy"
    root.mkdir()
    np.savez(root / "meshtable.npz", ids=ids[:500], vecs=vecs[:500],
             deleted=np.array([int(ids[5]), int(ids[9])], np.int64), col_price=price[:500])
    with open(root / "meshtable.json", "w") as f:
        json.dump({"name": "mleg", "dim": D, "metric": "L2", "filter_columns": ["price"],
                   "text_column": None, "analyzer_params": None}, f)
    t = TMeshTable.load(str(root), mesh=_cpu_mesh())
    j = JMeshTable.load(str(root))
    assert t.n_rows == j.n_rows == 498
    got, want = t.search(vecs[[5, 7, 9]], 5), j.search(vecs[[5, 7, 9]], 5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[0][0, 0] != ids[5] and got[0][1, 0] == ids[7] and got[0][2, 0] != ids[9]


def test_meshtable_is_exported():
    from myscaledb_tpu_torch import MeshTable

    assert tms.MeshTable is MeshTable is TMeshTable
    with pytest.raises(AttributeError):
        tms.NoSuchTable  # noqa: B018


def test_mesh_on_one_device_repeats_it():
    """Four shards on one device: the counterpart of XLA's virtual devices
    (and of four shards on one card)."""
    mesh = Mesh([["cpu"] * 4])
    assert mesh.shape == {"query": 1, "data": 4}
    t = TMeshTable("one", 8, mesh=mesh)
    t.insert({"id": np.arange(100), "vec": np.eye(100, 8, dtype=np.float32)})
    assert t.search(np.eye(1, 8, dtype=np.float32), 1)[0][0, 0] == 0


def test_cuda_mesh_without_cuda_raises():
    """make_mesh asks for cards; nothing falls back to the CPU quietly, and
    a MeshTable with no mesh is on the cards."""
    code = (
        "import myscaledb_tpu_torch as ms\n"
        "from myscaledb_tpu_torch.parallel.distributed import make_mesh\n"
        "for make in (lambda: make_mesh(2), lambda: ms.MeshTable('t', 8)):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        print('raised:', e)\n"
        "    else:\n"
        "        print('no error')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and all(ln.startswith("raised:") for ln in lines), out.stdout
    assert "torch.cuda.is_available() is False" in lines[0]
