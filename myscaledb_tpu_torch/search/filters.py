"""Filter expressions → per-segment row bitmaps (pre-filter semantics).

Counterpart of myscaledb_tpu/search/filters.py. The reference evaluates
WHERE/PREWHERE over each part *before* ANN search, collecting surviving
`_part_offset`s into a DenseBitmap that is passed INTO the index search
(performPrefilter). Post-filtering is never used for correctness-critical
paths.

A filter is a small expression tree over scalar columns. Numeric
predicates lower to a `DeviceMask` that builds a bool[capacity] tensor
on the segment's device from mirrored scalar columns; the rest evaluate
to a bool[n_rows] numpy mask on the host, which the executor extends to
capacity, intersects with the delete bitmap and moves to the device.

Usage:
    from myscaledb_tpu_torch import F
    t.search("vec", q, k=10, filter=(F("id") < 1000) & (F("tag") == "news"))
"""

from __future__ import annotations

import re
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import SchemaError


class DeviceMask:
    """A predicate LOWERED TO THE DEVICE: an expression skeleton plus its
    leaves, the mirrored scalar columns (tensors on the segment's device)
    and the comparison constants. `build()` produces the bool[capacity]
    bitmap with torch ops on that device, without host evaluation of the
    predicate or a mask upload. WindowMask is its IVF-layout variant."""

    def __init__(self, skel, leaves, device):
        self.skel = skel  # ("root", capacity, n_rows, has_alive, expr_skel|None)
        self.leaves = list(leaves)
        self.device = torch.device(device)

    _TOPS = {
        "<": torch.lt,
        "<=": torch.le,
        ">": torch.gt,
        ">=": torch.ge,
        "==": torch.eq,
        "!=": torch.ne,
    }

    def build(self) -> torch.Tensor:
        """bool[capacity] mask (False beyond n_rows and on deleted rows)."""
        _, capacity, n_rows, has_alive, expr_skel = self.skel
        it = iter(self.leaves)
        alive = next(it) if has_alive else None

        def full(value: bool) -> torch.Tensor:
            return torch.full((capacity,), value, dtype=torch.bool, device=self.device)

        def rec(s):
            kind = s[0]
            if kind == "and":
                return torch.logical_and(rec(s[1]), rec(s[2]))
            if kind == "or":
                return torch.logical_or(rec(s[1]), rec(s[2]))
            if kind == "not":
                return torch.logical_not(rec(s[1]))
            if kind == "lit":
                return full(bool(s[1]))
            if kind == "cmp":
                col = next(it)
                val = next(it)
                return self._TOPS[s[1]](col, val)
            if kind == "in":
                col = next(it)
                vals = torch.from_numpy(next(it)).to(self.device)
                m = torch.isin(col, vals)
                return torch.logical_not(m) if s[1] else m
            raise AssertionError(f"bad skel {s!r}")

        out = rec(expr_skel) if expr_skel is not None else None
        if alive is not None:
            out = alive if out is None else torch.logical_and(out, alive)
        if out is None:
            out = full(True)
        # padding rows are never valid (pad slots of the mirrored column
        # hold 0 and could otherwise satisfy e.g. `id == 0`)
        if expr_skel is not None and n_rows < capacity:
            out = torch.logical_and(
                out, torch.arange(capacity, device=self.device) < n_rows
            )
        return out


class WindowMask(DeviceMask):
    """A DeviceMask re-expressed in an index's own row layout (the IVF
    cluster-major window permutation): the column leaves are
    layout-permuted mirrors, so the IVF scan reads the mask window by
    window, contiguously, instead of gathering one row-space bit per
    candidate. skel n_rows == capacity == N' (layout padding is excluded by
    the scan's own row-validity test).

    A "prebuilt" skeleton carries the bool[N'] bitmap itself as its only
    leaf: a repeated filter hits the index's cache of materialized window
    bitmaps and the search does no mask arithmetic at all."""

    def build(self) -> torch.Tensor:
        if self.skel[0] == "prebuilt":
            return self.leaves[0]
        return super().build()


def as_mask_array(mask):
    """Materialize a mask input (None | bool tensor | DeviceMask) to a
    bool[capacity] device tensor (or None). A WindowMask is not a
    row-space mask: a path that reaches here with one raises."""
    if isinstance(mask, WindowMask):
        raise TypeError("a window-layout mask reached a row-space path")
    if isinstance(mask, DeviceMask):
        return mask.build()
    return mask


def materialize_mask(mask):
    """The mask a search program copies in, built outside the graph: None,
    or (kind, tensor). A WindowMask is built in its index's layout
    ("window"; a repeated filter's bitmap comes from the index's cache); a
    DeviceMask or a bitmap in row space ("rows"); an IVF index's int32
    layout of the passing rows ("layout", `IVFIndex.filter_layout`)."""
    if mask is None:
        return None
    if isinstance(mask, WindowMask):
        return ("window", mask.build())
    if isinstance(mask, DeviceMask):
        return ("rows", mask.build())
    return ("rows" if mask.dtype == torch.bool else "layout", mask)


def mask_spec(mask) -> Optional[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(kind, shape, dtype) of a materialized mask, None for no mask: the
    mask's part of a program key."""
    if mask is None:
        return None
    kind, t = mask
    return (kind, tuple(t.shape), t.dtype)


def mask_argument(kind: str, buf: Optional[torch.Tensor]):
    """What a searcher's `search_t` takes for a program's mask buffer: a
    prebuilt WindowMask over it for the window kind, else the buffer itself
    (a bitmap, or an IVF index's layout)."""
    if buf is None:
        return None
    if kind == "window":
        n = buf.shape[0]
        return WindowMask(("prebuilt", n, n, False, None), [buf], buf.device)
    return buf


def _numeric_minmax(segment, column):
    """(min, max) of a numeric scalar column over the segment's rows, or
    None for string/missing columns. Cached on the segment per mutation
    generation (the minmax-index analogue used by canSkipPrewhereForPart)."""
    try:
        return segment.scalar_minmax(column)
    except Exception:  # noqa: BLE001 — missing column/odd dtype: no fold
        return None


def _device_scalar(segment, column):
    """Device mirror of a numeric scalar column, or None when the column
    cannot be represented exactly on a 32-bit device (strings, Float64,
    integers beyond int32 range)."""
    try:
        return segment.scalar_device(column)
    except Exception:  # noqa: BLE001
        return None


def _value_fits(segment, column, value) -> bool:
    """The comparison constant must be exactly representable in the
    mirrored column's device dtype, or device and host paths would
    disagree at the boundary."""
    col = segment.scalar(column)
    if np.issubdtype(col.dtype, np.integer):
        if isinstance(value, float) and not float(value).is_integer():
            return False  # fractional compare vs int col: host semantics
        v = int(value)
        return -(2**31) <= v < 2**31
    # float32 column
    return float(np.float32(value)) == float(value)


def _np_dtype(col: torch.Tensor) -> np.dtype:
    """numpy dtype of a mirrored scalar column (int32 or float32)."""
    return np.dtype(np.int32) if col.dtype == torch.int32 else np.dtype(np.float32)


class Expr:
    """Boolean filter expression over scalar columns."""

    def evaluate(self, segment) -> np.ndarray:  # -> bool[n_rows]
        raise NotImplementedError

    def const_fold(self, segment):
        """Try to prove the predicate TRUE or FALSE for the WHOLE segment
        from per-segment column min/max stats (the canSkipPrewhereForPart
        fast path, MergeTreeSelectWithHybridSearchProcessor.cpp:224-290,
        gated by optimize_prefilter_in_search). Returns True/False/None."""
        return None

    def lower_t(self, segment) -> Optional[Tuple[tuple, list]]:
        """Lower to a device-evaluable (skeleton, leaves) pair, or None
        when this node needs host evaluation (strings, Lambda, regex)."""
        return None

    def columns(self) -> set:
        raise NotImplementedError

    def __and__(self, other: "Expr") -> "Expr":
        return And(self, other)

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, other)

    def __invert__(self) -> "Expr":
        return Not(self)


class And(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def evaluate(self, segment):
        return self.a.evaluate(segment) & self.b.evaluate(segment)

    def const_fold(self, segment):
        fa, fb = self.a.const_fold(segment), self.b.const_fold(segment)
        if fa is False or fb is False:
            return False
        if fa is True and fb is True:
            return True
        return None

    def lower_t(self, segment):
        la, lb = self.a.lower_t(segment), self.b.lower_t(segment)
        if la is None or lb is None:
            return None
        return ("and", la[0], lb[0]), la[1] + lb[1]

    def columns(self):
        return self.a.columns() | self.b.columns()

    def __repr__(self):
        return f"({self.a} AND {self.b})"


class Or(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def evaluate(self, segment):
        return self.a.evaluate(segment) | self.b.evaluate(segment)

    def const_fold(self, segment):
        fa, fb = self.a.const_fold(segment), self.b.const_fold(segment)
        if fa is True or fb is True:
            return True
        if fa is False and fb is False:
            return False
        return None

    def lower_t(self, segment):
        la, lb = self.a.lower_t(segment), self.b.lower_t(segment)
        if la is None or lb is None:
            return None
        return ("or", la[0], lb[0]), la[1] + lb[1]

    def columns(self):
        return self.a.columns() | self.b.columns()

    def __repr__(self):
        return f"({self.a} OR {self.b})"


class Not(Expr):
    def __init__(self, a: Expr):
        self.a = a

    def evaluate(self, segment):
        return ~self.a.evaluate(segment)

    def const_fold(self, segment):
        f = self.a.const_fold(segment)
        return None if f is None else (not f)

    def lower_t(self, segment):
        la = self.a.lower_t(segment)
        if la is None:
            return None
        return ("not", la[0]), la[1]

    def columns(self):
        return self.a.columns()

    def __repr__(self):
        return f"(NOT {self.a})"


class Literal(Expr):
    """Constant TRUE/FALSE (e.g. a partition predicate folded per segment —
    the canSkipPrewhereForPart fast path, SURVEY.md §2.1)."""

    def __init__(self, value: bool):
        self.value = bool(value)

    def evaluate(self, segment):
        return np.full(segment.n_rows, self.value, dtype=bool)

    def const_fold(self, segment):
        return self.value

    def lower_t(self, segment):
        return ("lit", self.value), []

    def columns(self):
        return set()

    def __repr__(self):
        return "TRUE" if self.value else "FALSE"


class Compare(Expr):
    _OPS: dict = {
        "<": np.less,
        "<=": np.less_equal,
        ">": np.greater,
        ">=": np.greater_equal,
        "==": np.equal,
        "!=": np.not_equal,
    }

    def __init__(self, column: str, op: str, value: Any):
        self.column, self.op, self.value = column, op, value

    def evaluate(self, segment):
        col = segment.scalar(self.column)
        if col.dtype == object:  # string column
            vals = np.array([str(self.value)] * 1, dtype=object)
            if self.op == "==":
                return np.fromiter(
                    (c == self.value for c in col), dtype=bool, count=len(col)
                )
            if self.op == "!=":
                return np.fromiter(
                    (c != self.value for c in col), dtype=bool, count=len(col)
                )
            raise SchemaError(f"op {self.op} not supported on string column")
        return self._OPS[self.op](col[: segment.n_rows], self.value)

    def const_fold(self, segment):
        mm = _numeric_minmax(segment, self.column)
        if mm is None:
            return None
        lo, hi = mm
        v = self.value
        try:
            if self.op == "<":
                return True if hi < v else (False if lo >= v else None)
            if self.op == "<=":
                return True if hi <= v else (False if lo > v else None)
            if self.op == ">":
                return True if lo > v else (False if hi <= v else None)
            if self.op == ">=":
                return True if lo >= v else (False if hi < v else None)
            if self.op == "==":
                return True if lo == hi == v else (False if v < lo or v > hi else None)
            if self.op == "!=":
                return False if lo == hi == v else (True if v < lo or v > hi else None)
        except TypeError:
            return None
        return None

    def lower_t(self, segment):
        col = _device_scalar(segment, self.column)
        if col is None or not isinstance(self.value, (int, float, np.number)):
            return None
        if not _value_fits(segment, self.column, self.value):
            return None
        # a Python scalar of the mirror's dtype: torch compares against it
        # without an upload; the column NAME rides in the skeleton so index
        # layouts can re-express the predicate over their own mirrors
        return ("cmp", self.op, self.column), [col, _np_dtype(col).type(self.value).item()]

    def columns(self):
        return {self.column}

    def __repr__(self):
        return f"{self.column} {self.op} {self.value!r}"


class In(Expr):
    def __init__(self, column: str, values: Sequence[Any], negate: bool = False):
        self.column, self.values, self.negate = column, list(values), negate

    def evaluate(self, segment):
        col = segment.scalar(self.column)[: segment.n_rows]
        if col.dtype == object:
            vs = set(self.values)
            out = np.fromiter((c in vs for c in col), dtype=bool, count=len(col))
        else:
            out = np.isin(col, np.asarray(self.values, dtype=col.dtype))
        return ~out if self.negate else out

    def const_fold(self, segment):
        if not self.values:
            return self.negate  # IN () is always false, NOT IN () true
        mm = _numeric_minmax(segment, self.column)
        if mm is None:
            return None
        lo, hi = mm
        try:
            if all(v < lo or v > hi for v in self.values):
                return self.negate  # no row can be IN
        except TypeError:
            return None
        return None

    def lower_t(self, segment):
        col = _device_scalar(segment, self.column)
        if col is None or not self.values:
            return None
        for v in self.values:
            if not isinstance(v, (int, float, np.number)):
                return None
            if not _value_fits(segment, self.column, v):
                return None
        vals = np.asarray(self.values, dtype=_np_dtype(col))
        return ("in", self.negate, self.column), [col, vals]

    def columns(self):
        return {self.column}

    def __repr__(self):
        kw = "NOT IN" if self.negate else "IN"
        return f"{self.column} {kw} {self.values!r}"


class Like(Expr):
    """SQL LIKE over a string column (% and _ wildcards)."""

    def __init__(self, column: str, pattern: str, negate: bool = False):
        self.column, self.pattern, self.negate = column, pattern, negate
        rx = re.escape(pattern).replace("%", ".*").replace("_", ".")
        self._rx = re.compile(f"^{rx}$", re.DOTALL)

    def evaluate(self, segment):
        col = segment.scalar(self.column)[: segment.n_rows]
        out = np.fromiter(
            (self._rx.match(c) is not None for c in col), dtype=bool, count=len(col)
        )
        return ~out if self.negate else out

    def columns(self):
        return {self.column}

    def __repr__(self):
        kw = "NOT LIKE" if self.negate else "LIKE"
        return f"{self.column} {kw} {self.pattern!r}"


class Lambda(Expr):
    """Escape hatch: arbitrary numpy predicate over named columns."""

    def __init__(self, cols: Sequence[str], fn: Callable[..., np.ndarray]):
        self._cols, self._fn = list(cols), fn

    def evaluate(self, segment):
        args = [segment.scalar(c)[: segment.n_rows] for c in self._cols]
        out = np.asarray(self._fn(*args), dtype=bool)
        if out.shape != (segment.n_rows,):
            raise SchemaError("Lambda filter must return bool[n_rows]")
        return out

    def columns(self):
        return set(self._cols)


class F:
    """Column handle for building filter expressions: F('id') < 100."""

    def __init__(self, column: str):
        self.column = column

    def __lt__(self, v):
        return Compare(self.column, "<", v)

    def __le__(self, v):
        return Compare(self.column, "<=", v)

    def __gt__(self, v):
        return Compare(self.column, ">", v)

    def __ge__(self, v):
        return Compare(self.column, ">=", v)

    def __eq__(self, v):  # type: ignore[override]
        return Compare(self.column, "==", v)

    def __ne__(self, v):  # type: ignore[override]
        return Compare(self.column, "!=", v)

    def isin(self, values):
        return In(self.column, values)

    def notin(self, values):
        return In(self.column, values, negate=True)

    def like(self, pattern):
        return Like(self.column, pattern)

    def between(self, lo, hi):
        return Compare(self.column, ">=", lo) & Compare(self.column, "<=", hi)

    __hash__ = None  # type: ignore[assignment]
