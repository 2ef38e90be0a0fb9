"""myscaledb_tpu_torch — the PyTorch + CUDA port of myscaledb_tpu.

The exact, optionally pre-filtered vector search on one NVIDIA H100:
segmented columnar vector storage on the device, pre-filter masks, the
exact scan through two hand-written CUDA kernels (csrc/), and the global
top-k merge. It imports torch and numpy and never JAX; myscaledb_tpu
stays the reference it is tested against. ROADMAP.md lists what is still
to port.
"""

from .api.client import Database, connect
from .config import QuerySettings, ServerSettings, Settings, TableSettings
from .errors import (
    IndexBuildError,
    IndexNotReadyError,
    IndexParameterError,
    MyScaleTPUError,
    QueryShapeError,
    SchemaError,
    SQLError,
)
from .metrics import Metric
from .search.executor import SearchResult
from .search.filters import F, Expr, Lambda
from .storage.schema import (
    BinaryVector,
    Float32,
    Float64,
    FloatVector,
    Int32,
    Int64,
    Schema,
    String,
    UInt64,
)
from .storage.table import Table


def __getattr__(name):
    # the scale-out constructs load lazily, as in the JAX package
    if name == "ShardedTable":
        from .parallel.sharded_table import ShardedTable

        return ShardedTable
    if name == "MeshTable":
        from .parallel.mesh_table import MeshTable

        return MeshTable
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "Database",
    "connect",
    "Settings",
    "QuerySettings",
    "TableSettings",
    "ServerSettings",
    "Metric",
    "Schema",
    "Table",
    "SearchResult",
    "F",
    "Expr",
    "Lambda",
    "FloatVector",
    "BinaryVector",
    "UInt64",
    "Int64",
    "Int32",
    "Float32",
    "Float64",
    "String",
    "MyScaleTPUError",
    "SchemaError",
    "IndexParameterError",
    "IndexBuildError",
    "IndexNotReadyError",
    "QueryShapeError",
    "SQLError",
]
