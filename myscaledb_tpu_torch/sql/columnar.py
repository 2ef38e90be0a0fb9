"""Columnar JOIN / filter / projection engine for composite SELECTs.

The row-dict algebra in runner._select_composite is the correctness
oracle but costs O(rows) Python per operation — fine at the reference
contract tests' sizes, unusable at millions of rows. This module runs
the common analytic shape

    SELECT [DISTINCT] cols/exprs FROM A [INNER|LEFT JOIN B ON a = b]
    [WHERE pred] [ORDER BY ...] [LIMIT n [OFFSET m]]

entirely in numpy: a vectorized sort/searchsorted equality join (LEFT
JOIN fills unmatched right columns with None), vectorized predicates
and scalar expressions, stable multi-key sort, unique-code DISTINCT.
Row dicts are materialized only for the final (post-LIMIT) output.

`run_composite` returns None whenever any element falls outside the
vectorizable subset (text predicates on None-bearing columns,
unknown functions, mixed-type keys, ...) — the caller then
falls back to the row-dict path, so semantics never change; the fast
path only widens the workable size range.

Reference parity: the reference inherits ClickHouse's columnar hash
join (src/Interpreters/HashJoin.cpp) and expression pipeline
(src/Interpreters/ExpressionActions.cpp); this is the numpy analogue
over host metadata columns (vector payloads stay on device and are not
joinable columns).

A copy of myscaledb_tpu/sql/columnar.py (numpy only, no device code).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import parser as P


class Unsupported(Exception):
    """Element outside the vectorizable subset; caller falls back."""


Frame = Dict[str, np.ndarray]


def _col(frame: Frame, name: str) -> np.ndarray:
    v = frame.get(name)
    if v is None:
        v = frame.get(name.split(".")[-1])
    if v is None:
        raise Unsupported(name)
    return v


def _frame_of_source(runner, source) -> Tuple[Frame, int]:
    kind, payload, alias = source
    if kind == "table":
        alias = alias or payload
        t = runner.db.table(payload)
        cols = t.schema.scalar_columns()
        per_col: Dict[str, List[np.ndarray]] = {c: [] for c in cols}
        for seg in sorted(t.live_segments(), key=lambda s: s.segment_id):
            alive = np.nonzero(~seg.deleted_host()[: seg.n_rows])[0]
            for c in cols:
                per_col[c].append(np.asarray(seg.scalar(c))[alive])
        frame: Frame = {
            c: (np.concatenate(v) if v else np.empty(0))
            for c, v in per_col.items()
        }
        n = len(next(iter(frame.values()))) if frame else 0
    elif kind == "sub":
        rows = runner._select(payload)
        if not isinstance(rows, list):
            raise Unsupported("non-row subquery")
        if not rows:
            return {}, 0
        keys = list(rows[0].keys())
        frame = {k: np.asarray([r.get(k) for r in rows]) for k in keys}
        n = len(rows)
    else:
        raise Unsupported("table function source")
    if alias:
        for k in list(frame.keys()):
            if "." not in k:
                frame[f"{alias}.{k}"] = frame[k]
    return frame, n


def _join(
    lf: Frame,
    ln: int,
    rf: Frame,
    rn: int,
    on_left: str,
    on_right: str,
    kind: str,
) -> Tuple[Frame, int]:
    """Vectorized equality join (inner or left); match order identical
    to the row-dict path (left order outer, right original order inner;
    an unmatched LEFT JOIN row sits at its left-row position with None
    in every right-side column — the row oracle leaves those keys
    absent, which projects to the same None)."""
    lk = _col(lf, on_left)
    rk = _col(rf, on_right)
    if ln == 0 or (rn == 0 and kind == "inner"):
        return {k: v[:0] for k, v in {**rf, **lf}.items()}, 0
    if rn == 0:  # LEFT JOIN against an empty right side
        out: Frame = {
            k: np.full(ln, None, dtype=object) for k in rf
        }
        out.update(lf)
        return out, ln
    try:
        order = np.argsort(rk, kind="stable")
        rs = rk[order]
        lo = np.searchsorted(rs, lk, "left")
        hi = np.searchsorted(rs, lk, "right")
    except TypeError as e:  # incomparable / mixed-type keys
        raise Unsupported(str(e))
    cnt = hi - lo
    out_cnt = np.maximum(cnt, 1) if kind == "left" else cnt
    total = int(out_cnt.sum())
    lidx = np.repeat(np.arange(ln), out_cnt)
    seq = np.arange(total) - np.repeat(np.cumsum(out_cnt) - out_cnt, out_cnt)
    matched = seq < np.repeat(cnt, out_cnt)
    ridx = order[np.where(matched, np.repeat(lo, out_cnt) + seq, 0)]
    # dict-merge semantics of the row path ({**right, **left}): left
    # wins bare-name collisions, alias-qualified names keep both sides
    has_unmatched = not bool(matched.all())
    out = {}
    for k, v in rf.items():
        col = v[ridx]
        if has_unmatched:
            col = col.astype(object)
            col[~matched] = None
        out[k] = col
    out.update({k: v[lidx] for k, v in lf.items()})
    return out, total


def _distinct(frame: Frame, n: int) -> Tuple[Frame, int]:
    """Order-preserving vectorized row dedup over ALL frame columns
    (the row oracle dedups full row dicts before the LIMIT slice)."""
    codes = []
    for v in frame.values():
        if v.dtype.kind == "f" and np.isnan(v).any():
            # the row oracle's tuple-key dedup treats distinct NaN
            # objects as unequal; stay out of that corner
            raise Unsupported("NaN in DISTINCT key")
        try:
            _, inv = np.unique(v, return_inverse=True)
        except TypeError as e:
            raise Unsupported(str(e))
        codes.append(inv.astype(np.int64))
    if not codes:
        return frame, n
    _, first = np.unique(np.stack(codes, axis=1), axis=0, return_index=True)
    keep = np.sort(first)
    return {k: v[keep] for k, v in frame.items()}, len(keep)


_CMP = {
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "==": np.equal,
    "!=": np.not_equal,
}


def _eval_pred(expr, frame: Frame, n: int) -> np.ndarray:
    if isinstance(expr, P.Cmp):
        col = _col(frame, expr.column)
        try:
            with np.errstate(invalid="ignore"):
                out = np.asarray(_CMP[expr.op](col, expr.value))
        except TypeError as e:
            raise Unsupported(str(e))
        # mismatched-type comparisons can collapse to a scalar, and object
        # columns produce object results — both outside the fast subset
        if out.dtype != np.bool_ or out.shape != (n,):
            raise Unsupported("non-vectorizable comparison")
        return out
    if isinstance(expr, P.InList):
        col = _col(frame, expr.column)
        out = np.isin(col, np.asarray(expr.values))
        return ~out if expr.negate else out
    if isinstance(expr, P.LikeExpr):
        col = _col(frame, expr.column)
        # LIKE -> anchored regex (the row path's semantics)
        rx = re.compile(
            "^"
            + re.escape(expr.pattern).replace("%", ".*").replace("_", ".")
            + "$",
            re.DOTALL,
        )
        out = np.fromiter(
            (isinstance(v, str) and rx.match(v) is not None for v in col),
            dtype=bool,
            count=n,
        )
        return ~out if expr.negate else out
    if isinstance(expr, P.BoolOp):
        if expr.op == "and":
            m = _eval_pred(expr.args[0], frame, n)
            for a in expr.args[1:]:
                m = m & _eval_pred(a, frame, n)
            return m
        if expr.op == "or":
            m = _eval_pred(expr.args[0], frame, n)
            for a in expr.args[1:]:
                m = m | _eval_pred(a, frame, n)
            return m
        return ~_eval_pred(expr.args[0], frame, n)
    raise Unsupported(type(expr).__name__)


_VMATH = {
    "abs": np.abs,
    "floor": np.floor,
    "ceil": np.ceil,
    "sqrt": np.sqrt,
    "exp": np.exp,
    "ln": np.log,
    "log": np.log,
}


def _eval_scalar(node, frame: Frame, n: int):
    tag = node[0]
    if tag == "num":
        return node[1]
    if tag == "str":
        return node[1]
    if tag == "const":
        # substituted scalar WITH alias; arrays are row-invariant objects
        v = node[1]
        if isinstance(v, list):
            raise Unsupported("array const in columnar expression")
        return v
    if tag == "col":
        return _col(frame, node[1])
    if tag == "neg":
        return -_eval_scalar(node[1], frame, n)
    if tag == "bin":
        a = _eval_scalar(node[2], frame, n)
        b = _eval_scalar(node[3], frame, n)
        op = node[1]
        try:
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a / b
            return a % b
        except TypeError as e:
            raise Unsupported(str(e))
    if tag == "call":
        name = node[1]
        args = [_eval_scalar(x, frame, n) for x in node[2]]
        if name == "round":
            dec = int(args[1]) if len(args) > 1 else 0
            out = np.round(np.asarray(args[0], np.float64), dec)
            return out if dec else out  # row path returns floats either way
        if name in _VMATH and len(args) == 1:
            return _VMATH[name](np.asarray(args[0], np.float64))
        if name in ("pow", "power") and len(args) == 2:
            return np.power(
                np.asarray(args[0], np.float64), np.asarray(args[1], np.float64)
            )
        if name == "least":
            return _reduce_minmax(args, np.minimum, n)
        if name == "greatest":
            return _reduce_minmax(args, np.maximum, n)
        raise Unsupported(f"function {name}()")
    raise Unsupported(f"scalar node {tag!r}")


def _reduce_minmax(args, fn, n):
    out = args[0]
    for a in args[1:]:
        out = fn(out, a)
    return out


def _codes_of(col: np.ndarray) -> np.ndarray:
    """Dense int codes of a column (np.unique inverse); Unsupported on
    mixed/object keys."""
    if col.dtype == object:
        raise Unsupported("object-typed key")
    try:
        _, inv = np.unique(col, return_inverse=True)
    except TypeError as e:
        raise Unsupported(str(e))
    return inv.astype(np.int64)


def _win_sort(frame: Frame, wc, part: np.ndarray, n: int) -> np.ndarray:
    """Sorted order for one window spec: stable by ORDER BY keys, then
    stably grouped by partition (same tie behavior as the row oracle's
    successive stable sorts)."""
    order = np.arange(n)
    for colname, d in reversed(wc.order_by):
        key = _col(frame, colname)
        if key.dtype == object or key.ndim != 1:
            raise Unsupported("object-typed or non-scalar window sort key")
        if d == "desc":
            if key.dtype.kind in "iuf":
                key = -key.astype(np.float64)
            else:
                _, inv = np.unique(key, return_inverse=True)
                key = -inv
        try:
            order = order[np.argsort(key[order], kind="stable")]
        except TypeError as e:
            raise Unsupported(str(e))
    return order[np.argsort(part[order], kind="stable")]


def _range_reduce(v64, a_g, b_g, op) -> np.ndarray:
    """Vectorized range min/max (RMQ) over inclusive index ranges
    [a_g[i], b_g[i]] of v64 via a sparse table: O(n log n) build, two
    overlapping power-of-two lookups per query. Rows are bucketed by
    their window-length exponent so each level answers all its queries
    with one fancy-index — this is what lets sliding-frame min/max
    OVER (... ROWS BETWEEN ...) run columnar instead of on the row
    oracle (reference: WindowTransform.cpp frame aggregation)."""
    if len(a_g) == 0:
        return np.empty(0, np.float64)
    lens = b_g - a_g + 1  # every range non-empty by construction
    k = np.floor(np.log2(lens)).astype(np.int64)
    levels = [v64]
    for j in range(1, int(k.max()) + 1):
        prev = levels[-1]
        step = 1 << (j - 1)
        levels.append(op(prev[: len(prev) - step], prev[step:]))
    res = np.empty(len(a_g), np.float64)
    for j, tbl in enumerate(levels):
        m = k == j
        if m.any():
            res[m] = op(tbl[a_g[m]], tbl[b_g[m] - (1 << j) + 1])
    return res


def _range_frame_bounds(frame, wc, order, ps, start_of, size_of, n):
    """Inclusive global [a_g, b_g] for a RANGE frame (bounds are VALUES
    on the single ORDER BY key; bound 0 = peer group). Vectorized via
    ONE global searchsorted: each partition's (per-partition ascending)
    keys get a per-partition shift large enough that the composite key
    is globally nondecreasing and a row's value band never crosses into
    a neighboring partition; falls back to the row oracle when the
    shift would lose float64 precision."""
    lo, hi = wc.frame
    col0, d0 = wc.order_by[0]
    keys = _col(frame, col0)
    if keys.ndim != 1 or keys.dtype.kind not in "iuf":
        raise Unsupported("RANGE frame key must be a numeric column")
    keys = keys[order].astype(np.float64)
    if d0 == "desc":
        keys = -keys
    if n and not np.isfinite(keys).all():
        raise Unsupported("non-finite RANGE key")
    span = float(keys.max() - keys.min()) if n else 0.0
    unit = span + abs(lo or 0) + abs(hi or 0) + 1.0
    g = keys + ps * unit
    if not np.isfinite(g).all() or np.any(np.diff(g) < 0):
        raise Unsupported("RANGE composite key lost precision")
    a_g = (
        start_of if lo is None
        else np.searchsorted(g, g + lo, side="left")
    )
    b_g = (
        start_of + size_of - 1 if hi is None
        else np.searchsorted(g, g + hi, side="right") - 1
    )
    return np.maximum(a_g, start_of), np.minimum(b_g, start_of + size_of - 1)


def _apply_window_items(runner, frame: Frame, n: int, win_items) -> Frame:
    """Vectorized window functions over the (joined, filtered) frame —
    the columnar counterpart of runner._apply_windows (the row oracle):
    per-partition segmentation via sorted codes, reduceat partition
    aggregates, prefix-sum ROWS frames, shifted lag/lead. O(n log n)
    instead of the oracle's per-partition Python sorts (reference:
    src/Processors/Transforms/WindowTransform.cpp)."""
    from .runner import _window_name

    out: Frame = {}
    for it in win_items:
        wc = it.expr
        name = it.alias or _window_name(wc)
        if n == 0:
            out[name] = np.empty(0)
            continue
        part = (
            _codes_of(_col(frame, wc.partition_by))
            if wc.partition_by
            else np.zeros(n, np.int64)
        )
        order = _win_sort(frame, wc, part, n)
        ps = part[order]
        chg_p = np.r_[True, ps[1:] != ps[:-1]]
        starts = np.nonzero(chg_p)[0]
        sizes = np.diff(np.r_[starts, n])
        start_of = np.repeat(starts, sizes)
        size_of = np.repeat(sizes, sizes)
        pos = np.arange(n) - start_of
        vals = None
        if wc.arg is not None:
            if isinstance(wc.arg, tuple):  # scalar-expression argument
                vals = np.asarray(_eval_scalar(wc.arg, frame, n))
                if vals.ndim == 0:
                    vals = np.full(n, vals[()])
            else:
                vals = _col(frame, wc.arg)
            if vals.dtype == object:
                raise Unsupported("object-typed window argument")
            vals = vals[order]

        if wc.func == "row_number":
            res = pos + 1
        elif wc.func in ("rank", "dense_rank"):
            chg = chg_p.copy()
            for colname, _d in wc.order_by:
                kv = _col(frame, colname)[order]
                chg |= np.r_[True, kv[1:] != kv[:-1]]
            if wc.func == "rank":
                grp_start = np.maximum.accumulate(
                    np.where(chg, np.arange(n), -1)
                )
                res = grp_start - start_of + 1
            else:
                cs = np.cumsum(chg)
                res = cs - cs[start_of] + 1
        elif wc.func == "ntile":
            nb = wc.offset
            q_ = size_of // nb
            r_ = size_of % nb
            boundary = r_ * (q_ + 1)
            res = np.where(
                q_ == 0,
                pos + 1,
                np.where(
                    pos < boundary,
                    pos // np.maximum(q_ + 1, 1) + 1,
                    r_ + (pos - boundary) // np.maximum(q_, 1) + 1,
                ),
            )
        elif wc.func in ("lag", "lead"):
            j = pos + (-wc.offset if wc.func == "lag" else wc.offset)
            valid = (j >= 0) & (j < size_of)
            src = np.clip(start_of + j, 0, n - 1)
            if wc.default is None:
                res = vals[src].astype(object)
                res[~valid] = None
            else:
                res = np.where(valid, vals[src], wc.default)
        elif wc.frame is not None:
            lo, hi = wc.frame
            if wc.frame_mode == "range" and lo in (None, 0) and hi in (None, 0):
                # Peer-group bounds need only EQUALITY on the ORDER BY
                # keys (no value arithmetic), so they work over any key
                # type — strings included — exactly like the reference's
                # WindowTransform peer rows (ClickHouse requires numeric
                # keys only for nonzero offsets). Also used for numeric
                # keys: equality over ALL order keys is the correct peer
                # definition (the searchsorted path bands on col0 only).
                chg = chg_p.copy()
                for colname, _d in wc.order_by:
                    kv = _col(frame, colname)[order]
                    chg |= np.r_[True, kv[1:] != kv[:-1]]
                pidx = np.nonzero(chg)[0]
                psz = np.diff(np.r_[pidx, n])
                pstart = np.repeat(pidx, psz)
                pend = np.repeat(pidx + psz - 1, psz)
                a_g_all = start_of if lo is None else pstart
                b_g_all = start_of + size_of - 1 if hi is None else pend
            elif wc.frame_mode == "range":
                a_g_all, b_g_all = _range_frame_bounds(
                    frame, wc, order, ps, start_of, size_of, n
                )
            else:
                a_rel = (
                    np.zeros(n, np.int64) if lo is None
                    else np.maximum(pos + lo, 0)
                )
                b_rel = (
                    size_of - 1 if hi is None
                    else np.minimum(pos + hi, size_of - 1)
                )
                a_g_all = start_of + a_rel
                b_g_all = start_of + b_rel
            cnt = np.maximum(b_g_all - a_g_all + 1, 0)
            if wc.func == "count":
                res = cnt
            else:
                ne = cnt > 0
                a_g = a_g_all[ne]
                b_g = b_g_all[ne]
                if wc.func in ("first_value", "last_value"):
                    body = vals[a_g if wc.func == "first_value" else b_g]
                    if ne.all():
                        res = body
                    else:
                        res = np.full(n, None, object)
                        res[ne] = body
                    inv = np.empty(n, np.int64)
                    inv[order] = np.arange(n)
                    out[name] = res[inv]
                    continue
                v64 = vals.astype(np.float64)
                if wc.func in ("sum", "avg"):
                    prefix = np.cumsum(v64)
                    s = prefix[b_g] - np.where(a_g > 0, prefix[a_g - 1], 0.0)
                    body = s if wc.func == "sum" else s / cnt[ne]
                else:
                    op = np.minimum if wc.func == "min" else np.maximum
                    body = _range_reduce(v64, a_g, b_g, op)
                if ne.all():
                    res = body
                else:
                    # frames entirely outside the partition (e.g. ROWS
                    # BETWEEN 3 PRECEDING AND 2 PRECEDING near the
                    # partition head) aggregate over zero rows -> None
                    res = np.full(n, None, object)
                    res[ne] = body
        elif wc.func == "count":
            res = size_of
        elif wc.func in ("first_value", "last_value"):
            res = (
                vals[start_of]
                if wc.func == "first_value"
                else vals[start_of + size_of - 1]
            )
        else:  # whole-partition sum/avg/min/max
            v64 = vals.astype(np.float64)
            if wc.func == "sum":
                res = np.repeat(np.add.reduceat(v64, starts), sizes)
            elif wc.func == "avg":
                res = np.repeat(np.add.reduceat(v64, starts) / sizes, sizes)
            elif wc.func == "min":
                res = np.repeat(np.minimum.reduceat(v64, starts), sizes)
            else:
                res = np.repeat(np.maximum.reduceat(v64, starts), sizes)

        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        out[name] = res[inv]
    return out


def _agg_name(it) -> str:
    if it.expr[0] == "count":
        return it.alias or "count()"
    return it.alias or f"{it.expr[0]}({it.expr[1]})"


def _group_frame(
    runner, st, frame: Frame, n: int, agg_items
) -> List[Dict[str, Any]]:
    """Vectorized GROUP BY over the (joined, filtered) frame: the
    unique-code / bincount / ufunc.at machinery of
    runner.SQLRunner._grouped_fast lifted onto columnar frames, so
    GROUP-BY-over-JOIN runs at millions of rows (round-3 verdict #6).
    Output rows, HAVING names, group order (sorted key tuples) and value
    types match the row-path aggregate exactly."""
    from .runner import _eval_plain, _pyval, _sort_rows

    group_by = st.group_by or []
    for it in agg_items:
        if it.expr[0] not in (
            "count", "sum", "avg", "min", "max", "uniq", "uniqexact", "any"
        ):
            raise Unsupported(f"aggregate {it.expr[0]}")

    def having_rows(rows):
        if st.having is None:
            return rows
        out = []
        for r in rows:
            aug = dict(r)
            for it in agg_items:
                nm = _agg_name(it)
                if nm not in r:
                    continue
                inline = (
                    "count()" if it.expr[0] == "count"
                    else f"{it.expr[0]}({it.expr[1]})"
                )
                aug.setdefault(inline, r[nm])
                if it.alias:
                    aug.setdefault(it.alias, r[nm])
            if _eval_plain(st.having, aug):
                out.append(r)
        return out

    if not group_by:
        row = {}
        for it in agg_items:
            fn = it.expr[0]
            if fn == "count":
                row[_agg_name(it)] = int(n)
                continue
            v = _col(frame, it.expr[1])
            if v.dtype == object:
                raise Unsupported("object-typed aggregate argument")
            if n == 0:
                row[_agg_name(it)] = None
            elif fn in ("uniq", "uniqexact"):
                row[_agg_name(it)] = int(len(np.unique(v)))
            elif fn == "any":
                row[_agg_name(it)] = _pyval(v[0])
            else:
                out = {
                    "sum": np.sum, "avg": np.mean,
                    "min": np.min, "max": np.max,
                }[fn](v.astype(np.float64))
                row[_agg_name(it)] = (
                    _pyval(out) if fn in ("min", "max") else float(out)
                )
        rows = having_rows([row])
        return rows

    key_arrays = [_col(frame, g) for g in group_by]
    if n == 0:
        return []
    uniqs, invs = [], []
    for kc in key_arrays:
        if kc.dtype == object:
            raise Unsupported("object-typed group key")
        try:
            u, inv = np.unique(kc, return_inverse=True)
        except TypeError as e:
            raise Unsupported(str(e))
        uniqs.append(u)
        invs.append(inv.astype(np.int64))
    gid = invs[0]
    for u, inv in zip(uniqs[1:], invs[1:]):
        gid = gid * len(u) + inv
    codes, gidx = np.unique(gid, return_inverse=True)
    G = len(codes)
    counts = np.bincount(gidx, minlength=G)
    key_vals = []
    rem = codes.copy()
    for u in reversed(uniqs):
        key_vals.append(u[rem % len(u)])
        rem //= len(u)
    key_vals.reverse()
    cols_out: Dict[str, Any] = dict(zip(group_by, key_vals))
    kinds: Dict[str, str] = {g: "key" for g in group_by}
    for it in agg_items:
        nm = _agg_name(it)
        if it.expr[0] == "count":
            cols_out[nm], kinds[nm] = counts, "int"
            continue
        fn = it.expr[0]
        v = _col(frame, it.expr[1])
        if v.dtype == object:
            raise Unsupported("object-typed aggregate argument")
        try:
            if fn in ("sum", "avg"):
                s = np.bincount(
                    gidx, weights=v.astype(np.float64), minlength=G
                )
                cols_out[nm] = s if fn == "sum" else s / counts
                kinds[nm] = "float"
            elif fn in ("min", "max"):
                out = np.full(G, np.inf if fn == "min" else -np.inf)
                getattr(np, "minimum" if fn == "min" else "maximum").at(
                    out, gidx, v.astype(np.float64)
                )
                cols_out[nm], kinds[nm] = out, "key"
            elif fn in ("uniq", "uniqexact"):
                vu, vinv = np.unique(v, return_inverse=True)
                pairs = np.unique(gidx * np.int64(len(vu)) + vinv)
                cols_out[nm] = np.bincount(
                    (pairs // len(vu)).astype(np.int64), minlength=G
                )
                kinds[nm] = "int"
            else:  # any
                firsts = np.full(G, n, np.int64)
                np.minimum.at(firsts, gidx, np.arange(n, dtype=np.int64))
                cols_out[nm], kinds[nm] = v[firsts], "key"
        except (TypeError, ValueError) as e:
            raise Unsupported(str(e))
    names = list(cols_out)

    def cast(nm, x):
        k = kinds[nm]
        return int(x) if k == "int" else float(x) if k == "float" else _pyval(x)

    out_rows = [
        {nm: cast(nm, cols_out[nm][i]) for nm in names} for i in range(G)
    ]
    out_rows = having_rows(out_rows)
    if st.order_by:
        _sort_rows(out_rows, st.order_by)
    hi = None if st.limit is None else st.offset + st.limit
    return out_rows[st.offset : hi]


def _sort_order(frame: Frame, order_by, n: int) -> np.ndarray:
    """Stable multi-key argsort matching _sort_rows (successive stable
    sorts from the last key to the first; descending keys rank-encoded
    so ties keep their prior order exactly like list.sort(reverse=True))."""
    order = np.arange(n)
    for expr, d in reversed(order_by):
        if isinstance(expr, P.ScalarExpr):
            key = np.asarray(_eval_scalar(expr.node, frame, n))
            if key.ndim == 0:
                key = np.broadcast_to(key, (n,))
        else:
            name = expr[0] if isinstance(expr, tuple) else expr
            key = _col(frame, name)
        if key.dtype == object or key.ndim != 1:
            raise Unsupported("object-typed or non-scalar sort key")
        if d == "desc":
            if key.dtype.kind in "iuf":
                key = -key.astype(np.float64)
            else:
                _, inv = np.unique(key, return_inverse=True)
                key = -inv
        try:
            order = order[np.argsort(key[order], kind="stable")]
        except TypeError as e:
            raise Unsupported(str(e))
    return order


def run_composite(runner, st: "P.Select") -> Optional[List[Dict[str, Any]]]:
    """Columnar execution of a composite SELECT; None = use the row path."""
    try:
        left_src = st.source or ("table", st.table, None)
        frame, n = _frame_of_source(runner, left_src)
        if st.join is not None:
            rf, rn = _frame_of_source(runner, st.join.right)
            frame, n = _join(
                frame, n, rf, rn,
                st.join.on_left, st.join.on_right, st.join.kind,
            )
        if st.where is not None and n:
            m = _eval_pred(st.where, frame, n)
            frame = {k: v[m] for k, v in frame.items()}
            n = int(m.sum())
        agg_items = [it for it in st.items if isinstance(it.expr, tuple)]
        win_items = [
            it for it in st.items if isinstance(it.expr, P.WindowCall)
        ]
        if (agg_items or st.group_by) and win_items:
            raise Unsupported("windows with aggregates")  # row path errors
        if agg_items or st.group_by:
            # GROUP BY path: every non-aggregate item must be a group key
            # (the row-path aggregate emits keys + aggregates only)
            for it in st.items:
                if isinstance(it.expr, tuple) or it.expr == "*":
                    continue
                if isinstance(it.expr, str) and it.expr in (st.group_by or []):
                    continue
                raise Unsupported("non-key select item with GROUP BY")
            return _group_frame(runner, st, frame, n, agg_items)
        keep: List[Tuple[str, str]] = []
        star = False
        computed: Frame = {}
        from .runner import _window_name

        for it in st.items:
            if it.expr == "*":
                star = True
            elif isinstance(it.expr, str):
                _col(frame, it.expr) if n else None
                keep.append((it.expr, it.alias or it.expr))
            elif isinstance(it.expr, P.ScalarExpr):
                from .runner import _render_scalar

                name = it.alias or _render_scalar(it.expr.node)
                if n:
                    val = np.asarray(_eval_scalar(it.expr.node, frame, n))
                    if val.ndim == 0:
                        val = np.broadcast_to(val, (n,)).copy()
                    computed[name] = val
                keep.append((name, name))
            elif isinstance(it.expr, P.WindowCall):
                keep.append((it.alias or _window_name(it.expr),) * 2)
            else:
                raise Unsupported("search item")
        if win_items:
            computed.update(_apply_window_items(runner, frame, n, win_items))
        frame = {**frame, **computed}
        if st.order_by and n:
            order = _sort_order(frame, st.order_by, n)
            frame = {k: v[order] for k, v in frame.items()}
        if st.distinct and n:
            frame, n = _distinct(frame, n)
        lo = st.offset
        hi = None if st.limit is None else st.offset + st.limit
        frame = {k: v[lo:hi] for k, v in frame.items()}
        n = len(next(iter(frame.values()))) if frame else 0
        if star:
            names = list(frame.keys())
            out_cols = [(c, c) for c in names]
        else:
            out_cols = [(c, a) for c, a in keep]
        lists = {}
        for c, a in out_cols:
            arr = frame.get(c)
            if arr is None:
                arr = frame.get(c.split(".")[-1])
            if arr is None:
                raise Unsupported(c)
            lists[a] = arr.tolist()
        names = [a for _, a in out_cols]
        return [
            dict(zip(names, vals)) for vals in zip(*(lists[a] for a in names))
        ] if n else []
    except Unsupported:
        return None
