"""SQL parser for the reference's query surface (SURVEY.md §2.7).

Hand-written lexer + recursive-descent parser covering the dialect the
reference's vector tests exercise:

  CREATE TABLE t (id UInt64, body String, vec Array(Float32),
                  CONSTRAINT c CHECK length(vec) = 128
                  [, VECTOR INDEX vidx vec TYPE MSTG('metric_type=L2')]
                  [, INDEX fts_idx body TYPE fts('{...}')])
         [ENGINE = MergeTree] [ORDER BY id]
  ALTER TABLE t ADD VECTOR INDEX v vec TYPE IVFFLAT('ncentroids=1024')
  ALTER TABLE t DROP VECTOR INDEX v
  ALTER TABLE t ADD INDEX f body TYPE fts('{"lower_case": true}')
  CREATE VECTOR INDEX v ON t vec TYPE HNSWFLAT
  INSERT INTO t (id, vec) VALUES (1, [0.1, 0.2]), (2, [0.3, 0.4])
  SELECT id, distance[('nprobe=32')](vec, [..]) AS d FROM t
    [PREWHERE/WHERE pred] ORDER BY d [ASC|DESC] LIMIT n [OFFSET m]
  SELECT id, batch_distance(vec, [[..],[..]]) AS d FROM t
    ORDER BY d.2 LIMIT k BY d.1
  SELECT id, textsearch(body, 'query') AS s FROM t ORDER BY s DESC LIMIT k
  SELECT id, hybridsearch('fusion_type=rsf')(vec, body, [..], 'q') AS s
    FROM t ORDER BY s DESC LIMIT k
  DELETE FROM t WHERE pred
  DROP TABLE t
  SELECT * FROM system.vector_indices

Parse errors raise SQLError with position info. (Reference analogues:
ParserAlterQuery.cpp:113-114, ParserCreateIndexQuery.h:10,
ParserCreateQuery.cpp:266, TreeRewriter.cpp:904-1000.)

A copy of myscaledb_tpu/sql/parser.py (device-free; the port keeps its
own copy so that it never imports the JAX package).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from ..errors import SQLError

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<float>\d+\.\d*(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<string>'(?:[^'\\]|\\.|'')*')
  | (?P<bq>`[A-Za-z_][A-Za-z0-9_]*`)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>->|<=|>=|!=|<>|==|=|<|>|\(|\)|\[|\]|,|\.|\*|\+|-|/|%)
""",
    re.VERBOSE,
)

KEYWORDS = {
    "create", "table", "alter", "add", "drop", "vector", "index", "on",
    "type", "constraint", "check", "length", "engine", "order", "by",
    "insert", "into", "values", "select", "from", "where", "prewhere",
    "limit", "offset", "asc", "desc", "delete", "and", "or", "not", "in",
    "like", "as", "exists", "if",
}


@dataclasses.dataclass
class Token:
    kind: str  # 'int' | 'float' | 'string' | 'name' | 'op' | 'eof'
    value: Any
    pos: int

    def lower(self):
        return self.value.lower() if isinstance(self.value, str) else self.value


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SQLError(f"unexpected character {sql[i]!r} at position {i}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group(0)
        if kind == "int":
            out.append(Token("int", int(text), m.start()))
        elif kind == "float":
            out.append(Token("float", float(text), m.start()))
        elif kind == "string":
            body = text[1:-1].replace("''", "'").replace("\\'", "'")
            out.append(Token("string", body, m.start()))
        elif kind == "bq":
            # `quoted` identifier -> plain name token
            out.append(Token("name", text[1:-1], m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("eof", None, len(sql)))
    return out


# ----------------------------------------------------------------- AST
@dataclasses.dataclass
class ColumnDef:
    name: str
    type_name: str
    type_arg: Optional[Any] = None  # Array inner type / FixedString size


@dataclasses.dataclass
class VectorIndexDef:
    name: str
    column: str
    type_name: str
    params: Dict[str, Any]
    # verbatim source of "name col TYPE T(...)" for system.vector_indices.expr
    raw: str = ""


@dataclasses.dataclass
class FtsIndexDef:
    name: str
    columns: List[str]
    params_json: Optional[str]


@dataclasses.dataclass
class CreateTable:
    table: str
    columns: List[ColumnDef]
    constraints: Dict[str, int]  # column -> dim from CHECK length(col)=D
    vector_indexes: List[VectorIndexDef]
    fts_indexes: List[FtsIndexDef]
    if_not_exists: bool = False
    engine: str = "MergeTree"
    engine_args: List[str] = dataclasses.field(default_factory=list)
    order_by: Optional[str] = None
    # CREATE TABLE ... SETTINGS k=v (MergeTreeSettings overrides)
    settings: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModifySetting:
    """ALTER TABLE t MODIFY SETTING k = v [, ...]
    (00038_mqvs_brute_force_setting.sql)."""

    table: str
    assigns: Dict[str, Any]


@dataclasses.dataclass
class SystemCommand:
    """SYSTEM STOP/START MERGES / FLUSH LOGS (ParserSystemQuery)."""

    command: str


@dataclasses.dataclass
class SetStatement:
    """`SET k = v [, ...]` — session-level settings, applied under every
    later statement's own SETTINGS clause (reference scripts open with
    e.g. `set enable_brute_force_vector_search = 1;`)."""

    assigns: Dict[str, Any]


@dataclasses.dataclass
class AddVectorIndex:
    table: str
    index: VectorIndexDef


@dataclasses.dataclass
class DropVectorIndex:
    table: str
    name: str


@dataclasses.dataclass
class AddFtsIndex:
    table: str
    index: FtsIndexDef


@dataclasses.dataclass
class Insert:
    table: str
    columns: Optional[List[str]]
    rows: List[List[Any]]
    select: Optional["Select"] = None  # INSERT INTO t [cols] SELECT ...


@dataclasses.dataclass
class Delete:
    table: str
    where: Any


@dataclasses.dataclass
class Update:
    table: str
    assignments: Dict[str, Any]
    where: Any


@dataclasses.dataclass
class OptimizeTable:
    table: str
    final: bool = False


@dataclasses.dataclass
class DropTable:
    table: str
    if_exists: bool = False


# WHERE expression nodes
@dataclasses.dataclass
class Cmp:
    column: str
    op: str
    value: Any


@dataclasses.dataclass
class InList:
    column: str
    values: List[Any]
    negate: bool = False


@dataclasses.dataclass
class LikeExpr:
    column: str
    pattern: str
    negate: bool = False


@dataclasses.dataclass
class BoolOp:
    op: str  # and | or | not
    args: List[Any]


@dataclasses.dataclass
class ScalarExpr:
    """Scalar expression tree in SELECT / ORDER BY (the ClickHouse
    ExpressionAnalyzer tail): nodes are tuples —
    ("num", v) | ("str", s) | ("col", name) | ("neg", e) |
    ("bin", op, a, b) | ("call", fname, [args]) — plus const-only forms
    ("cmp", op, a, b) | ("lambda", [params], body) | ("subq", Select) |
    ("const", value) (a substituted WITH-scalar alias)."""

    node: Any


# one-column aggregate functions (count() is parsed separately); all
# lowercase — the tokenizer lowercases names, so uniqExact == uniqexact
AGG_FUNCS = {"sum", "avg", "min", "max", "uniq", "uniqexact", "any"}


@dataclasses.dataclass
class SearchCall:
    func: str  # distance | batch_distance | textsearch | hybridsearch
    params: Dict[str, Any]
    args: List[Any]  # column names / literal vectors / strings
    alias: str


@dataclasses.dataclass
class WindowCall:
    """Window function item: func(arg) OVER ([PARTITION BY p]
    [ORDER BY c [ASC|DESC], ...] [ROWS BETWEEN a AND b]) — the
    reference inherits ClickHouse window functions,
    src/Processors/Transforms/WindowTransform.cpp; this covers the
    ranking forms, partition aggregates (whole-partition default frame,
    explicit ROWS frames), and lag/lead."""

    func: str  # row_number | rank | dense_rank | count | sum | avg |
    # min | max | lag | lead
    arg: Optional[str]  # aggregated column (None for ranking funcs/count)
    partition_by: Optional[str]
    order_by: List[Tuple[str, str]]  # [(column, asc|desc)]
    # ROWS/RANGE BETWEEN frame as (lo, hi) offsets relative to the
    # current row (negative = preceding); None bound = unbounded.
    # frame_mode "rows": offsets count rows. "range": offsets are VALUES
    # added to the (single) ORDER BY key; bound 0 = the peer group.
    # None frame = whole partition for aggregates WITHOUT ORDER BY;
    # aggregates WITH ORDER BY default to RANGE UNBOUNDED PRECEDING AND
    # CURRENT ROW — the running-aggregate-over-peers default the
    # reference inherits (WindowTransform.cpp default frame).
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None
    frame_mode: str = "rows"
    offset: int = 1  # lag/lead row offset
    default: Any = None  # lag/lead out-of-partition fill
    # OVER w: unresolved named-window reference, filled in from the
    # statement's WINDOW clause once it parses (None after resolution)
    ref: Optional[str] = None


@dataclasses.dataclass
class FuncPred:
    """String-function predicate in WHERE: hasToken(col, 'tok') /
    multiSearchAny(col, ['a', 'b']) — fts-index-accelerated when the
    column has one (MergeTreeConditionTantivy atoms)."""

    func: str
    column: str
    args: List[str]


@dataclasses.dataclass
class JoinSpec:
    """[INNER|LEFT] JOIN <table|(subquery)> ON a = b (single equality)."""

    kind: str  # inner | left
    right: Any  # FromSource tuple
    on_left: str
    on_right: str


@dataclasses.dataclass
class TableFunc:
    """FROM-clause table function: full_text_search(table, index, 'query'
    [, with_score]) / ftsIndex(table, col_or_index, 'query')."""

    name: str
    args: List[Any]


@dataclasses.dataclass
class AddColumn:
    table: str
    column: "ColumnDef"
    default: Any = None
    if_not_exists: bool = False


@dataclasses.dataclass
class DropColumn:
    table: str
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class BackupTable:
    table: str
    dest: str


@dataclasses.dataclass
class RestoreTable:
    table: str
    src: str


@dataclasses.dataclass
class TruncateTable:
    table: str


@dataclasses.dataclass
class DetachTable:
    table: str


@dataclasses.dataclass
class AttachTable:
    table: str


@dataclasses.dataclass
class RenameTable:
    table: str
    new_name: str


@dataclasses.dataclass
class ShowTables:
    pass


@dataclasses.dataclass
class ShowCreateTable:
    table: str


@dataclasses.dataclass
class Describe:
    table: str


@dataclasses.dataclass
class Explain:
    select: "Select"


@dataclasses.dataclass
class SelectItem:
    expr: Any  # str column name | '*' | SearchCall | ('count',)
    alias: Optional[str] = None


@dataclasses.dataclass
class Select:
    items: List[SelectItem]
    table: str
    distinct: bool = False
    where: Any = None
    prewhere: Any = None
    order_by: List[Tuple[Any, str]] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    limit_by: Optional[Any] = None  # the LIMIT n BY expr column
    group_by: Optional[List[str]] = None  # GROUP BY key columns (aggregates)
    having: Any = None  # predicate over aggregate aliases
    settings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    final: bool = False  # FROM t FINAL (Replacing-engine dedup)
    table_func: Optional["TableFunc"] = None  # FROM full_text_search(...)
    source: Any = None  # ("sub", Select, alias) when FROM (subquery)
    join: Optional["JoinSpec"] = None
    # WITH scalar aliases: name -> const-expr tree | ("subq", Select).
    # The reference evaluates these to const columns at analysis time
    # (ExpressionAnalyzer.cpp:902-944); the runner does the same before
    # dispatching the search.
    scalar_withs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Parser:
    def __init__(self, sql: str):
        self.src = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -------------------------------------------------------------- utils
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def error(self, msg: str):
        t = self.peek()
        raise SQLError(f"{msg} (near {t.value!r} at {t.pos})")

    def accept_kw(self, *words: str) -> bool:
        t = self.peek()
        if t.kind == "name" and t.lower() == words[0]:
            for j, w in enumerate(words[1:], 1):
                tj = self.peek(j)
                if not (tj.kind == "name" and tj.lower() == w):
                    return False
            self.i += len(words)
            return True
        return False

    def expect_kw(self, *words: str):
        if not self.accept_kw(*words):
            self.error(f"expected {' '.join(words).upper()}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == op:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            self.error(f"expected {op!r}")

    def expect_name(self) -> str:
        t = self.next()
        if t.kind != "name":
            raise SQLError(f"expected identifier, got {t.value!r} at {t.pos}")
        return t.value

    def table_name(self) -> str:
        n = self.expect_name()
        if self.accept_op("."):
            n = f"{n}.{self.expect_name()}"
        return n

    # ------------------------------------------------------------ entry
    def parse(self):
        t = self.peek()
        if t.kind != "name":
            self.error("expected statement")
        kw = t.lower()
        if kw == "create":
            if self.peek(1).lower() == "table":
                return self.create_table()
            if self.peek(1).lower() == "vector":
                return self.create_vector_index()
            self.error("expected CREATE TABLE or CREATE VECTOR INDEX")
        if kw == "alter":
            return self.alter()
        if kw == "insert":
            return self.insert()
        if kw == "select":
            return self.select()
        if kw == "with":
            return self.with_select()
        if kw == "backup":
            self.next()
            self.expect_kw("table")
            table = self.table_name()
            self.expect_kw("to")
            t = self.next()
            if t.kind != "string":
                self.error("BACKUP TABLE ... TO expects a path string")
            return BackupTable(table, t.value)
        if kw == "restore":
            self.next()
            self.expect_kw("table")
            table = self.table_name()
            self.expect_kw("from")
            t = self.next()
            if t.kind != "string":
                self.error("RESTORE TABLE ... FROM expects a path string")
            return RestoreTable(table, t.value)
        if kw == "truncate":
            self.next()
            self.accept_kw("table")
            return TruncateTable(self.table_name())
        if kw == "detach":
            self.next()
            self.expect_kw("table")
            return DetachTable(self.table_name())
        if kw == "attach":
            self.next()
            self.expect_kw("table")
            return AttachTable(self.table_name())
        if kw == "rename":
            self.next()
            self.expect_kw("table")
            table = self.table_name()
            self.expect_kw("to")
            return RenameTable(table, self.table_name())
        if kw == "show":
            self.next()
            if self.accept_kw("tables"):
                return ShowTables()
            if self.accept_kw("create", "table"):
                return ShowCreateTable(self.table_name())
            self.error("expected SHOW TABLES or SHOW CREATE TABLE")
        if kw in ("describe", "desc"):
            self.next()
            self.accept_kw("table")
            return Describe(self.table_name())
        if kw == "explain":
            self.next()
            inner = (
                self.with_select()
                if self.peek().lower() == "with"
                else self.select()
            )
            return Explain(inner)
        if kw == "delete":
            return self.delete()
        if kw == "drop":
            return self.drop_table()
        if kw == "optimize":
            self.expect_kw("optimize", "table")
            table = self.table_name()
            final = self.accept_kw("final")
            return OptimizeTable(table, final)
        if kw == "set":
            self.next()
            return SetStatement(self._settings_assigns())
        if kw == "system":
            # SYSTEM STOP/START MERGES [t] — accepted for script parity
            # (merges here run only on explicit OPTIMIZE / replication
            # leader action, so stop/start is the default state);
            # SYSTEM FLUSH LOGS — flush the system-log buffers
            self.next()
            verb = self.expect_name().lower()
            if verb in ("stop", "start") and self.accept_kw("merges"):
                if self.peek().kind == "name":
                    self.table_name()
                return SystemCommand(f"{verb}_merges")
            if verb == "flush" and self.accept_kw("logs"):
                return SystemCommand("flush_logs")
            self.error(f"unsupported SYSTEM command {verb.upper()}")
        self.error(f"unsupported statement {kw.upper()}")

    # ------------------------------------------------------------- DDL
    def _index_params(self) -> Dict[str, Any]:
        """TYPE name('k=v', 'k2=v2') / ('{json}') argument list."""
        params: Dict[str, Any] = {}
        if not self.accept_op("("):
            return params
        while not self.accept_op(")"):
            t = self.next()
            if t.kind == "string":
                s = t.value.strip()
                if s.startswith("{"):
                    params["__json__"] = s
                else:
                    for piece in s.split(","):
                        if "=" in piece:
                            k, v = piece.split("=", 1)
                            params[k.strip()] = _auto(v.strip())
            elif t.kind in ("int", "float"):
                params.setdefault("__args__", []).append(t.value)
            else:
                self.error("bad index parameter")
            self.accept_op(",")
        return params

    def create_table(self) -> CreateTable:
        self.expect_kw("create", "table")
        ine = self.accept_kw("if", "not", "exists")
        table = self.table_name()
        self.expect_op("(")
        cols: List[ColumnDef] = []
        constraints: Dict[str, int] = {}
        vidx: List[VectorIndexDef] = []
        fts: List[FtsIndexDef] = []
        while True:
            if self.accept_kw("constraint"):
                self.expect_name()  # constraint name
                self.expect_kw("check")
                self.expect_kw("length")
                self.expect_op("(")
                col = self.expect_name()
                self.expect_op(")")
                self.expect_op("=")
                dim = self.next()
                if dim.kind != "int":
                    self.error("CHECK length() = <int> expected")
                constraints[col] = dim.value
            elif self.accept_kw("vector", "index"):
                start = self.peek().pos
                name = self.expect_name()
                col = self.expect_name()
                tname, tp = self._index_type()
                raw = self.src[start : self.peek().pos].strip().rstrip(",").strip()
                vidx.append(VectorIndexDef(name, col, tname, tp, raw))
            elif self.accept_kw("index"):
                name = self.expect_name()
                cols_l: List[str] = []
                if self.accept_op("("):
                    while not self.accept_op(")"):
                        cols_l.append(self.expect_name())
                        self.accept_op(",")
                else:
                    cols_l.append(self.expect_name())
                self.expect_kw("type")
                fname = self.expect_name()
                if fname.lower() != "fts":
                    self.error("only TYPE fts skip indexes are supported")
                p = self._index_params()
                # GRANULARITY n (ignored — no mark granularity here)
                if self.accept_kw("granularity"):
                    self.next()
                fts.append(FtsIndexDef(name, cols_l, p.get("__json__")))
            else:
                cname = self.expect_name()
                tname = self.expect_name()
                arg = None
                if self.accept_op("("):
                    if tname.lower() in ("enum8", "enum16", "enum"):
                        # Enum8('person' = 1, ...): values are stored as
                        # their string names (host scalar), so the value
                        # list itself only needs consuming
                        depth = 1
                        while depth:
                            tk = self.next()
                            if tk.kind == "op" and tk.value == "(":
                                depth += 1
                            elif tk.kind == "op" and tk.value == ")":
                                depth -= 1
                            elif tk.kind == "eof":
                                self.error("unterminated Enum value list")
                    else:
                        inner = self.next()
                        arg = inner.value
                        self.expect_op(")")
                cols.append(ColumnDef(cname, tname, arg))
            if self.accept_op(","):
                continue
            self.expect_op(")")
            break
        # ENGINE = [Replacing]MergeTree[(version)] / ORDER BY key
        engine, eargs, order_by = "MergeTree", [], None
        if self.accept_kw("engine"):
            self.accept_op("=")
            engine = self.expect_name()
            if self.accept_op("("):
                while not self.accept_op(")"):
                    t = self.next()
                    if t.kind in ("name", "str", "string", "int", "float"):
                        eargs.append(str(t.value))
        # ORDER BY k / PRIMARY KEY k in either order (reference tests use
        # `engine=MergeTree primary key id SETTINGS ...` —
        # 00014_mqvs_distance_cosine_bruteforce.sql); PRIMARY KEY doubles
        # as the sort key when ORDER BY is absent
        while True:
            if self.accept_kw("order", "by"):
                order_by = self.expect_name()
            elif self.accept_kw("primary", "key"):
                pk = self.expect_name()
                if order_by is None:
                    order_by = pk
            else:
                break
        tsettings: Dict[str, Any] = {}
        if self.accept_kw("settings"):
            tsettings = self._settings_assigns()
        return CreateTable(
            table, cols, constraints, vidx, fts, ine,
            engine=engine, engine_args=eargs, order_by=order_by,
            settings=tsettings,
        )

    def _index_type(self) -> Tuple[str, Dict[str, Any]]:
        """Optional `TYPE <name>[(params)]` tail of a vector-index DDL.
        Omitted TYPE (or `TYPE DEFAULT`) selects the default index kind,
        resolved per column type at ADD time (MSTG / BinaryMSTG —
        VIDescriptions.cpp:133, 00041_mqvs_support_create_default_index)."""
        if not self.accept_kw("type"):
            return "default", {}
        return self.expect_name(), self._index_params()

    def create_vector_index(self) -> AddVectorIndex:
        self.expect_kw("create", "vector", "index")
        self.accept_kw("if", "not", "exists")
        name = self.expect_name()
        self.expect_kw("on")
        table = self.table_name()
        start = self.peek().pos
        col = self.expect_name()
        tname, tp = self._index_type()
        raw = name + " " + self.src[start : self.peek().pos].strip().rstrip(";").strip()
        return AddVectorIndex(table, VectorIndexDef(name, col, tname, tp, raw))

    def alter(self):
        self.expect_kw("alter", "table")
        table = self.table_name()
        if self.accept_kw("add", "vector", "index"):
            start = self.peek().pos
            name = self.expect_name()
            col = self.expect_name()
            tname, tp = self._index_type()
            raw = self.src[start : self.peek().pos].strip().rstrip(";").strip()
            return AddVectorIndex(table, VectorIndexDef(name, col, tname, tp, raw))
        if self.accept_kw("drop", "vector", "index"):
            return DropVectorIndex(table, self.expect_name())
        if self.accept_kw("add", "column"):
            ine = self.accept_kw("if", "not", "exists")
            cname = self.expect_name()
            tname = self.expect_name()
            arg = None
            if self.accept_op("("):
                inner = self.next()
                arg = inner.value
                self.expect_op(")")
            default = None
            if self.accept_kw("default"):
                neg = self.accept_op("-")
                default = self.literal()
                if neg:
                    if not isinstance(default, (int, float)):
                        self.error("DEFAULT '-' needs a numeric literal")
                    default = -default
            return AddColumn(
                table, ColumnDef(cname, tname, arg), default, ine
            )
        if self.accept_kw("drop", "column"):
            ie = self.accept_kw("if", "exists")
            return DropColumn(table, self.expect_name(), ie)
        if self.accept_kw("modify", "setting"):
            return ModifySetting(table, self._settings_assigns())
        if self.accept_kw("update"):
            assigns: Dict[str, Any] = {}
            while True:
                col = self.expect_name()
                self.expect_op("=")
                assigns[col] = self.literal()
                if not self.accept_op(","):
                    break
            self.expect_kw("where")
            return Update(table, assigns, self.where_expr())
        if self.accept_kw("add", "index"):
            name = self.expect_name()
            cols_l = []
            if self.accept_op("("):
                while not self.accept_op(")"):
                    cols_l.append(self.expect_name())
                    self.accept_op(",")
            else:
                cols_l.append(self.expect_name())
            self.expect_kw("type")
            if self.expect_name().lower() != "fts":
                self.error("only TYPE fts supported")
            p = self._index_params()
            if self.accept_kw("granularity"):
                self.next()
            return AddFtsIndex(table, FtsIndexDef(name, cols_l, p.get("__json__")))
        if self.accept_kw("materialize", "index") or self.accept_kw(
            "materialize", "vector", "index"
        ):
            # builds here are scheduled automatically at insert/merge time,
            # so MATERIALIZE is a no-op (accepted for script parity)
            self.expect_name()
            return SystemCommand("materialize_index")
        self.error("unsupported ALTER")

    # ------------------------------------------------------------- DML
    def literal(self):
        t = self.peek()
        if t.kind in ("int", "float", "string"):
            self.next()
            return t.value
        if self.accept_op("["):
            out = []
            while not self.accept_op("]"):
                out.append(self.literal())
                self.accept_op(",")
            return out
        if self.accept_op("-"):
            v = self.literal()
            return -v
        if t.kind == "name" and t.lower() in ("true", "false"):
            self.next()
            return t.lower() == "true"
        if t.kind == "name" and t.lower() == "null":
            self.next()
            return None
        if (
            t.kind == "name"
            and t.lower() in ("todate", "todatetime", "tofloat32", "tofloat64",
                              "touint32", "touint64", "toint32")
            and self.peek(1).kind == "op"
            and self.peek(1).value == "("
        ):
            # conversion functions in literal position: toDate('..','UTC')
            # evaluates to its first argument (dates are host strings)
            fname = t.lower()
            self.next()
            self.expect_op("(")
            args = []
            while not self.accept_op(")"):
                args.append(self.literal())
                self.accept_op(",")
            if fname in ("todate", "todatetime"):
                return str(args[0])
            if fname in ("tofloat32", "tofloat64"):
                return float(args[0])
            return int(args[0])
        if (
            t.kind == "name"
            and t.lower() in ("currentdatabase", "today", "now")
            and self.peek(1).kind == "op"
            and self.peek(1).value == "("
        ):
            # niladic const functions usable as literals (reference tests:
            # `where database = currentDatabase()`)
            fname = t.lower()
            self.next()
            self.expect_op("(")
            self.expect_op(")")
            if fname == "currentdatabase":
                return "default"
            import time as _t

            return (
                _t.strftime("%Y-%m-%d")
                if fname == "today"
                else _t.strftime("%Y-%m-%d %H:%M:%S")
            )
        self.error("expected literal")

    def insert(self) -> Insert:
        self.expect_kw("insert", "into")
        table = self.table_name()
        cols = None
        if self.accept_op("("):
            cols = []
            while not self.accept_op(")"):
                cols.append(self.expect_name())
                self.accept_op(",")
        if self.peek().lower() in ("select", "with"):
            inner = (
                self.with_select()
                if self.peek().lower() == "with"
                else self.select()
            )
            return Insert(table, cols, [], select=inner)
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = []
            while not self.accept_op(")"):
                row.append(self.literal())
                self.accept_op(",")
            rows.append(row)
            if not self.accept_op(","):
                break
        return Insert(table, cols, rows)

    def delete(self) -> Delete:
        self.expect_kw("delete", "from")
        table = self.table_name()
        self.expect_kw("where")
        return Delete(table, self.where_expr())

    def drop_table(self) -> DropTable:
        self.expect_kw("drop", "table")
        ie = self.accept_kw("if", "exists")
        return DropTable(self.table_name(), ie)

    # ------------------------------------------------------------ WHERE
    def where_expr(self):
        return self._or_expr()

    def _or_expr(self):
        left = self._and_expr()
        while self.accept_kw("or"):
            left = BoolOp("or", [left, self._and_expr()])
        return left

    def _and_expr(self):
        left = self._not_expr()
        while self.accept_kw("and"):
            left = BoolOp("and", [left, self._not_expr()])
        return left

    def _not_expr(self):
        if self.accept_kw("not"):
            return BoolOp("not", [self._not_expr()])
        return self._atom()

    def _atom(self):
        if self.accept_op("("):
            e = self._or_expr()
            self.expect_op(")")
            return e
        col = self.expect_name()
        if (
            self.peek().kind == "op"
            and self.peek().value == "."
            and self.peek(1).kind == "name"
        ):
            self.next()
            col = f"{col}.{self.expect_name()}"
        if (
            (col.lower() == "count" or col.lower() in AGG_FUNCS)
            and self.peek().kind == "op"
            and self.peek().value == "("
        ):
            # HAVING over an aggregate spelled inline: the predicate column
            # is the aggregate's output name ("count()" / "sum(col)")
            self.expect_op("(")
            if self.accept_op(")"):
                col = f"{col.lower()}()"
            else:
                inner = self.expect_name()
                self.expect_op(")")
                col = f"{col.lower()}({inner})"
        if col.lower() in ("hastoken", "multisearchany") and (
            self.peek().kind == "op" and self.peek().value == "("
        ):
            fname = "hasToken" if col.lower() == "hastoken" else "multiSearchAny"
            self.expect_op("(")
            target = self.expect_name()
            self.expect_op(",")
            if fname == "multiSearchAny":
                self.expect_op("[")
                needles = []
                while not self.accept_op("]"):
                    needles.append(str(self.literal()))
                    self.accept_op(",")
                self.expect_op(")")
                return FuncPred(fname, target, needles)
            tok = str(self.literal())
            self.expect_op(")")
            return FuncPred(fname, target, [tok])
        if self.accept_kw("not", "in") or self.accept_kw("not", "like"):
            prev = self.toks[self.i - 1].lower()
            if prev == "in":
                self.expect_op("(")
                vals = []
                while not self.accept_op(")"):
                    vals.append(self.literal())
                    self.accept_op(",")
                return InList(col, vals, negate=True)
            return LikeExpr(col, str(self.literal()), negate=True)
        if self.accept_kw("in"):
            self.expect_op("(")
            vals = []
            while not self.accept_op(")"):
                vals.append(self.literal())
                self.accept_op(",")
            return InList(col, vals)
        if self.accept_kw("like"):
            return LikeExpr(col, str(self.literal()))
        if self.accept_kw("between"):
            lo = self.literal()
            self.expect_kw("and")
            hi = self.literal()
            return BoolOp("and", [Cmp(col, ">=", lo), Cmp(col, "<=", hi)])
        t = self.next()
        if t.kind != "op" or t.value not in ("<", "<=", ">", ">=", "=", "==", "!=", "<>"):
            self.error("expected comparison operator")
        op = {"=": "==", "<>": "!="}.get(t.value, t.value)
        return Cmp(col, op, self.literal())

    # ---------------------------------------------------- scalar exprs
    MATH_FUNCS = {
        "round", "abs", "floor", "ceil", "sqrt", "exp", "ln", "log",
        "pow", "power", "least", "greatest",
    }

    def _scalar_expr(self):
        node = self._s_term()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                node = ("bin", t.value, node, self._s_term())
            else:
                return node

    def _s_term(self):
        node = self._s_factor()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                node = ("bin", t.value, node, self._s_factor())
            else:
                return node

    def _s_factor(self):
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.peek().kind == "name" and self.peek().lower() == "select":
                # scalar subquery: (SELECT ...) — evaluated to a const
                # (first row, first column) by the runner at analysis time
                body = self._select_body()
                self.expect_op(")")
                return ("subq", body)
            node = self._scalar_expr()
            self.expect_op(")")
            return node
        if t.kind == "op" and t.value == "-":
            self.next()
            return ("neg", self._s_factor())
        if t.kind == "op" and t.value == "[":
            # array literal in expression position (WITH [..] AS v)
            self.next()
            elems = []
            while not self.accept_op("]"):
                elems.append(self._scalar_expr())
                self.accept_op(",")
            return ("array", elems)
        if t.kind in ("int", "float"):
            self.next()
            return ("num", t.value)
        if t.kind == "string":
            self.next()
            return ("str", t.value)
        if t.kind == "name":
            if self.peek(1).kind == "op" and self.peek(1).value == "(":
                fname = self.next().lower()
                self.expect_op("(")
                if fname == "cast":
                    # CAST(expr AS Type) — 00025_mqvs_distance_with_subquery
                    inner = self._scalar_expr()
                    self.expect_kw("as")
                    tname = self.expect_name()
                    if self.accept_op("("):  # e.g. Decimal(10, 2)
                        while not self.accept_op(")"):
                            self.next()
                    self.expect_op(")")
                    return ("call", "cast", [inner, ("str", tname)])
                args = []
                if not self.accept_op(")"):
                    while True:
                        args.append(self._call_arg())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                return ("call", fname, args)
            return ("col", self._qual_name())
        self.error("expected a scalar expression")

    def _call_arg(self):
        """One function-call argument: a lambda (`x -> expr` /
        `(x, y) -> expr`), or a comparison/scalar expression. Lambdas and
        comparisons only ever appear inside call parens (arrayMap bodies,
        if() conditions — 00036_mqvs_with_clause_process_function.sql), so
        parsing them here never changes a top-level SELECT item."""
        t = self.peek()
        if (
            t.kind == "name"
            and self.peek(1).kind == "op"
            and self.peek(1).value == "->"
        ):
            param = self.expect_name()
            self.expect_op("->")
            return ("lambda", [param], self._call_arg())
        if t.kind == "op" and t.value == "(":
            # (a, b) -> body
            pos = self.i
            self.next()
            params: List[str] = []
            closed = False
            while self.peek().kind == "name":
                params.append(self.expect_name())
                if self.accept_op(")"):
                    closed = True
                    break
                if not self.accept_op(","):
                    break
            if (
                closed
                and params
                and self.peek().kind == "op"
                and self.peek().value == "->"
            ):
                self.next()
                return ("lambda", params, self._call_arg())
            self.i = pos
        node = self._scalar_expr()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            op = {"=": "==", "<>": "!="}.get(self.next().value, t.value)
            return ("cmp", op, node, self._scalar_expr())
        return node

    def _order_element(self):
        """ORDER BY element: col | col.N (tuple index) | scalar expr |
        (e1, e2, ...) tuple shorthand for multiple keys sharing one
        direction (`ORDER BY (d, id)` —
        00036_mqvs_with_clause_process_function.sql)."""
        if self.peek().kind == "op" and self.peek().value == "(":
            pos = self.i
            self.next()
            elems = [self._order_element()]
            is_tuple = False
            while self.accept_op(","):
                elems.append(self._order_element())
                is_tuple = True
            if is_tuple and self.accept_op(")"):
                return ("__tuple__", elems)
            self.i = pos
        t0, t1, t2 = self.peek(), self.peek(1), self.peek(2)
        if (
            t0.kind == "name"
            and t1.kind == "op"
            and t1.value == "."
            and t2.kind == "int"
        ):
            name = self.expect_name()
            self.expect_op(".")
            part = self.next()
            return (name, int(part.value))
        node = self._scalar_expr()
        return node[1] if node[0] == "col" else ScalarExpr(node)

    # ----------------------------------------------------------- SELECT
    SEARCH_FUNCS = {"distance", "batch_distance", "textsearch", "hybridsearch"}

    def _search_call(self, fname: str) -> SearchCall:
        params: Dict[str, Any] = {}
        self.expect_op("(")
        # parametrized form: distance('nprobe=1')(col, [..])
        if self.peek().kind == "string":
            while not self.accept_op(")"):
                s = self.next()
                if s.kind != "string":
                    self.error("expected parameter string")
                for piece in s.value.split(","):
                    if "=" in piece:
                        k, v = piece.split("=", 1)
                        params[k.strip()] = _auto(v.strip())
                self.accept_op(",")
            self.expect_op("(")
        args: List[Any] = []
        while not self.accept_op(")"):
            t = self.peek()
            if t.kind == "name":
                if self.peek(1).kind == "op" and self.peek(1).value == "(":
                    # const expression query vector: arrayMap(x -> ..,
                    # range(..)) — evaluated at analysis time like the
                    # reference (ExpressionAnalyzer.cpp:902-944)
                    args.append(("expr", self._call_arg()))
                else:
                    args.append(("col", self.expect_name()))
            elif t.kind == "op" and t.value == "(":
                args.append(("expr", self._call_arg()))
            elif t.kind == "op" and t.value == "[":
                # array argument: elements may be const expressions
                # (batch_distance(vec, [unhex('FF'), char(0, 255)]))
                args.append(("expr", self._call_arg()))
            else:
                args.append(("lit", self.literal()))
            self.accept_op(",")
        alias = fname
        if self.accept_kw("as"):
            alias = self.expect_name()
        return SearchCall(fname, params, args, alias)

    def select(self) -> Select:
        sel = self._select_body()
        if self.peek().kind != "eof":
            self.error("unexpected trailing input")
        return sel

    def with_select(self) -> Select:
        """WITH name AS (subquery) [, ...] SELECT ... — common table
        expressions, resolved by parse-time substitution into the FROM /
        JOIN sources (ClickHouse's CTE form) — plus the scalar forms
        `WITH (expr) AS name`, `WITH expr AS name` and
        `WITH (SELECT ...) AS name`, recorded on Select.scalar_withs and
        evaluated to consts by the runner at analysis time, like the
        reference (ExpressionAnalyzer.cpp:902-944;
        00036_mqvs_with_clause_process_function.sql). Later CTEs may
        reference earlier ones; each reference gets its own deep copy."""
        self.expect_kw("with")
        ctes: Dict[str, Select] = {}
        scalars: Dict[str, Any] = {}
        while True:
            t0, t1, t2, t3 = (self.peek(i) for i in range(4))
            if (
                t0.kind == "name"
                and t1.kind == "name" and t1.lower() == "as"
                and t2.kind == "op" and t2.value == "("
                and t3.kind == "name" and t3.lower() == "select"
            ):
                name = self.expect_name()
                self.expect_kw("as")
                self.expect_op("(")
                body = self._select_body()
                self.expect_op(")")
                _substitute_ctes(body, ctes)  # earlier CTEs visible here
                ctes[name.lower()] = body
            else:
                node = self._call_arg()
                self.expect_kw("as")
                scalars[self.expect_name()] = node
            if not self.accept_op(","):
                break
        sel = self.select()
        _substitute_ctes(sel, ctes)
        sel.scalar_withs.update(scalars)
        return sel

    def _qual_name(self) -> str:
        name = self.expect_name()
        if (
            self.peek().kind == "op"
            and self.peek().value == "."
            and self.peek(1).kind == "name"
        ):
            self.next()
            name = f"{name}.{self.expect_name()}"
        return name

    def _from_source(self):
        """FROM source: ("table", name, alias) | ("sub", Select, alias) |
        ("func", TableFunc, None)."""
        if self.accept_op("("):
            inner = self._select_body()
            self.expect_op(")")
            alias = self.expect_name() if self.accept_kw("as") else None
            return ("sub", inner, alias)
        name = self.table_name()
        if name.lower() == "numbers" and (
            self.peek().kind == "op" and self.peek().value == "("
        ):
            # numbers(N) / numbers(start, N): the ClickHouse row generator
            # every reference test feeds INSERT ... SELECT from
            self.expect_op("(")
            nargs: List[Any] = []
            while not self.accept_op(")"):
                nargs.append(self.literal())
                self.accept_op(",")
            return ("func", TableFunc("numbers", nargs), None)
        if name.lower() in ("full_text_search", "ftsindex") and (
            self.peek().kind == "op" and self.peek().value == "("
        ):
            self.expect_op("(")
            fargs: List[Any] = []
            while not self.accept_op(")"):
                t = self.peek()
                if t.kind == "name":
                    fargs.append(self.table_name())
                else:
                    fargs.append(self.literal())
                self.accept_op(",")
            fn = (
                "full_text_search"
                if name.lower() == "full_text_search"
                else "ftsIndex"
            )
            return ("func", TableFunc(fn, fargs), None)
        alias = self.expect_name() if self.accept_kw("as") else None
        return ("table", name, alias)

    def _at_over(self) -> bool:
        t = self.peek()
        return t.kind == "name" and t.lower() == "over"

    def _frame_bound(self, is_start: bool, mode: str = "rows"):
        """One ROWS/RANGE BETWEEN bound -> offset (None = unbounded).
        ROWS offsets are row counts (int); RANGE offsets are values added
        to the ORDER BY key (int or float)."""
        if self.accept_kw("unbounded"):
            self.expect_kw("preceding" if is_start else "following")
            return None
        if self.accept_kw("current", "row"):
            return 0
        t = self.peek()
        if t.kind != "int" and not (mode == "range" and t.kind == "float"):
            self.error("expected UNBOUNDED, CURRENT ROW, or <n> in frame")
        v = self.next().value
        n = float(v) if "." in str(v) else int(v)
        if self.accept_kw("preceding"):
            return -n
        self.expect_kw("following")
        return n

    def _window_spec(self):
        """([PARTITION BY p] [ORDER BY c [ASC|DESC], ...]
        [ROWS|RANGE BETWEEN a AND b]) -> (part, ob, frame, fmode).
        Shared by inline OVER (...) and the statement-level WINDOW
        clause (named windows)."""
        self.expect_op("(")
        part = None
        if self.accept_kw("partition", "by"):
            part = self._qual_name()
        ob: List[Tuple[str, str]] = []
        if self.accept_kw("order", "by"):
            while True:
                name = self._qual_name()
                d = "asc"
                if self.accept_kw("desc"):
                    d = "desc"
                else:
                    self.accept_kw("asc")
                ob.append((name, d))
                if not self.accept_op(","):
                    break
        frame = None
        if self.accept_kw("rows", "between"):
            fmode = "rows"
        elif self.accept_kw("range", "between"):
            fmode = "range"
        else:
            fmode = None
        if fmode is not None:
            lo = self._frame_bound(True, fmode)
            self.expect_kw("and")
            hi = self._frame_bound(False, fmode)
            if lo is not None and hi is not None and lo > hi:
                self.error("frame start is after frame end")
            if fmode == "range":
                if not ob:
                    self.error("RANGE frame requires ORDER BY inside OVER()")
                if len(ob) > 1 and ((lo not in (None, 0)) or (hi not in (None, 0))):
                    self.error(
                        "RANGE frame with value offsets requires exactly "
                        "one ORDER BY column"
                    )
            frame = (lo, hi)
        self.expect_op(")")
        return part, ob, frame, fmode

    def _finish_window(
        self, func, arg, part, ob, frame, fmode, offset=1, default=None
    ) -> WindowCall:
        """Validate a (func, spec) pairing and build the WindowCall —
        the same rules whether the spec was inline or a named window."""
        if func in ("rank", "dense_rank", "lag", "lead", "ntile") and not ob:
            self.error(f"{func}() requires ORDER BY inside OVER()")
        if frame is not None and func in (
            "row_number", "rank", "dense_rank", "lag", "lead", "ntile"
        ):
            self.error(f"{func}() does not accept a frame clause")
        if frame is None and ob and func in (
            "count", "sum", "avg", "min", "max", "first_value", "last_value"
        ):
            # the reference's inherited default frame for aggregates with
            # ORDER BY: RANGE UNBOUNDED PRECEDING AND CURRENT ROW — a
            # running aggregate over the peer group (WindowTransform.cpp)
            frame, fmode = (None, 0), "range"
        return WindowCall(
            func, arg, part, ob, frame, fmode or "rows", offset, default
        )

    def _window_item(
        self, func: str, arg: Optional[str], offset: int = 1, default=None
    ) -> SelectItem:
        """OVER ( <window spec> ) [AS a], or OVER w referencing a named
        window declared in the statement's WINDOW clause."""
        self.expect_kw("over")
        t = self.peek()
        if t.kind == "name":  # OVER w — resolved after the WINDOW clause
            ref = self.next().value
            wc = WindowCall(
                func, arg, None, [], None, "rows", offset, default, ref=ref
            )
            return SelectItem(
                wc, self.expect_name() if self.accept_kw("as") else None
            )
        part, ob, frame, fmode = self._window_spec()
        return SelectItem(
            self._finish_window(func, arg, part, ob, frame, fmode, offset, default),
            self.expect_name() if self.accept_kw("as") else None,
        )

    def _select_body(self) -> Select:
        self.expect_kw("select")
        distinct = self.accept_kw("distinct")
        items: List[SelectItem] = []
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == "*":
                self.next()
                items.append(SelectItem("*"))
            elif t.kind == "name" and t.lower() in self.SEARCH_FUNCS:
                fname = self.next().lower()
                items.append(SelectItem(self._search_call(fname)))
            elif t.kind == "name" and t.lower() == "count":
                self.next()
                self.expect_op("(")
                if self.peek().kind == "op" and self.peek().value == "*":
                    self.next()
                self.expect_op(")")
                if self._at_over():
                    items.append(self._window_item("count", None))
                else:
                    alias = None
                    if self.accept_kw("as"):
                        alias = self.expect_name()
                    items.append(SelectItem(("count",), alias))
            elif (
                t.kind == "name"
                and t.lower() in ("row_number", "rank", "dense_rank")
                and self.peek(1).kind == "op"
                and self.peek(1).value == "("
            ):
                fname = self.next().lower()
                self.expect_op("(")
                self.expect_op(")")
                items.append(self._window_item(fname, None))
            elif (
                t.kind == "name"
                and t.lower() == "ntile"
                and self.peek(1).kind == "op"
                and self.peek(1).value == "("
            ):
                # ntile(n): n equal-ish buckets over the ordered partition
                # (WindowTransform.cpp:1972; larger buckets first)
                self.next()
                self.expect_op("(")
                nb = self.literal()
                if not isinstance(nb, int) or nb <= 0:
                    self.error("ntile() needs a positive integer bucket count")
                self.expect_op(")")
                items.append(self._window_item("ntile", None, offset=nb))
            elif (
                t.kind == "name"
                and t.lower() in ("first_value", "last_value")
                and self.peek(1).kind == "op"
                and self.peek(1).value == "("
            ):
                fname = self.next().lower()
                self.expect_op("(")
                anode = self._scalar_expr()
                acol = anode[1] if anode[0] == "col" else anode
                self.expect_op(")")
                items.append(self._window_item(fname, acol))
            elif (
                t.kind == "name"
                and t.lower() in ("lag", "lead")
                and self.peek(1).kind == "op"
                and self.peek(1).value == "("
            ):
                # lag(col_or_expr[, n[, default]]) OVER (...) —
                # WindowTransform's lagInFrame/leadInFrame family
                fname = self.next().lower()
                self.expect_op("(")
                anode = self._scalar_expr()
                acol = anode[1] if anode[0] == "col" else anode
                off, dflt = 1, None
                if self.accept_op(","):
                    off = self.literal()
                    if not isinstance(off, int) or off < 0:
                        self.error(f"{fname}() offset must be a non-negative integer")
                    if self.accept_op(","):
                        dflt = self.literal()
                self.expect_op(")")
                items.append(self._window_item(fname, acol, off, dflt))
            elif (
                t.kind == "name"
                and t.lower() in AGG_FUNCS
                and self.peek(1).kind == "op"
                and self.peek(1).value == "("
            ):
                fname = self.next().lower()
                self.expect_op("(")
                # full scalar expression as the argument; a plain column
                # keeps its historical string form
                anode = self._scalar_expr()
                self.expect_op(")")
                acol = anode[1] if anode[0] == "col" else anode
                if self._at_over():
                    if fname not in ("sum", "avg", "min", "max"):
                        self.error(f"{fname}() is not a window function")
                    items.append(self._window_item(fname, acol))
                else:
                    if anode[0] != "col":
                        self.error(
                            f"{fname}() over an expression is only "
                            "supported as a window function"
                        )
                    alias = None
                    if self.accept_kw("as"):
                        alias = self.expect_name()
                    items.append(SelectItem((fname, acol), alias))
            else:
                node = self._scalar_expr()
                alias = None
                if self.accept_kw("as"):
                    alias = self.expect_name()
                if node[0] == "col":  # plain column: the historical form
                    items.append(SelectItem(node[1], alias))
                else:
                    items.append(SelectItem(ScalarExpr(node), alias))
            if not self.accept_op(","):
                break
        if self.accept_kw("from"):
            source = self._from_source()
        else:
            # FROM-less SELECT (const expressions / scalar subqueries:
            # `SELECT 1`, `WITH (SELECT arrayMap(...)) AS v ...`)
            source = ("table", "", None)
        sel = Select(
            items=items,
            table=source[1] if source[0] == "table" else "",
            distinct=distinct,
            table_func=source[1] if source[0] == "func" else None,
        )
        if source[0] == "sub" or (source[0] == "table" and source[2]):
            sel.source = source
        if self.accept_kw("final"):
            sel.final = True
        jkind = None
        if self.accept_kw("inner", "join"):
            jkind = "inner"
        elif self.accept_kw("left", "join"):
            jkind = "left"
        elif self.accept_kw("join"):
            jkind = "inner"
        if jkind is not None:
            right = self._from_source()
            self.expect_kw("on")
            lq = self._qual_name()
            t = self.next()
            if t.kind != "op" or t.value not in ("=", "=="):
                self.error("JOIN ... ON expects col = col")
            rq = self._qual_name()
            sel.join = JoinSpec(jkind, right, lq, rq)
            if sel.source is None:
                sel.source = source
        if self.accept_kw("prewhere"):
            sel.prewhere = self.where_expr()
        if self.accept_kw("where"):
            sel.where = self.where_expr()
        if self.accept_kw("group", "by"):
            gb = [self._qual_name()]
            while self.accept_op(","):
                gb.append(self._qual_name())
            sel.group_by = gb
        if self.accept_kw("having"):
            sel.having = self.where_expr()
        named_windows: Dict[str, tuple] = {}
        if self.accept_kw("window"):
            # WINDOW w AS (<spec>) [, w2 AS (<spec>)] — named windows
            # shared by several OVER w items (WindowTransform.cpp)
            while True:
                wname = self.expect_name()
                self.expect_kw("as")
                named_windows[wname] = self._window_spec()
                if not self.accept_op(","):
                    break
        for it in items:
            if isinstance(it.expr, WindowCall) and it.expr.ref is not None:
                spec = named_windows.get(it.expr.ref)
                if spec is None:
                    self.error(f"undefined window {it.expr.ref!r}")
                wc = it.expr
                it.expr = self._finish_window(
                    wc.func, wc.arg, *spec, wc.offset, wc.default
                )
        if self.accept_kw("order", "by"):
            while True:
                expr = self._order_element()
                direction = "asc"
                if self.accept_kw("desc"):
                    direction = "desc"
                elif self.accept_kw("asc"):
                    direction = "asc"
                if isinstance(expr, tuple) and expr[0] == "__tuple__":
                    sel.order_by.extend((e, direction) for e in expr[1])
                else:
                    sel.order_by.append((expr, direction))
                if not self.accept_op(","):
                    break
        if self.accept_kw("limit"):
            n = self.next()
            if n.kind != "int":
                self.error("LIMIT expects an integer")
            if self.accept_op(","):
                m = self.next()
                sel.offset = n.value
                sel.limit = m.value
            else:
                sel.limit = n.value
            if self.accept_kw("by"):
                name = self.expect_name()
                if self.accept_op("."):
                    part = self.next()
                    sel.limit_by = (name, int(part.value))
                else:
                    sel.limit_by = name
            if self.accept_kw("offset"):
                o = self.next()
                sel.offset = o.value
        if self.accept_kw("settings"):
            # per-query SETTINGS k=v, ... (Settings.h query settings)
            sel.settings.update(self._settings_assigns())
        return sel

    def _settings_assigns(self) -> Dict[str, Any]:
        """k = v [, ...] list shared by per-query SETTINGS, CREATE TABLE
        ... SETTINGS, and ALTER TABLE ... MODIFY SETTING."""
        out: Dict[str, Any] = {}
        while True:
            name = self.expect_name()
            self.expect_op("=")
            neg = self.accept_op("-")
            t = self.next()
            if t.kind not in ("int", "float", "str", "string", "name"):
                self.error("SETTINGS expects name = literal")
            v = -t.value if neg and t.kind in ("int", "float") else t.value
            if neg and t.kind not in ("int", "float"):
                self.error("SETTINGS '-' needs a numeric literal")
            out[name] = v
            if not self.accept_op(","):
                break
        return out


def _cte_source(src, ctes):
    """Rewrite one FromSource tuple against the CTE map (or recurse)."""
    import copy

    if src is None:
        return None
    if src[0] == "table" and src[1].lower() in ctes:
        alias = src[2] if len(src) > 2 and src[2] else src[1]
        return ("sub", copy.deepcopy(ctes[src[1].lower()]), alias)
    if src[0] == "sub":
        _substitute_ctes(src[1], ctes)
    return src


def _substitute_ctes(sel: "Select", ctes) -> None:
    """Replace CTE-name table references with their subquery bodies."""
    import copy

    if not ctes:
        return
    if sel.source is not None:
        new = _cte_source(sel.source, ctes)
        if new is not sel.source:
            sel.source = new
            sel.table = ""
    elif sel.table and sel.table.lower() in ctes:
        sel.source = ("sub", copy.deepcopy(ctes[sel.table.lower()]), sel.table)
        sel.table = ""
    if sel.join is not None:
        new_r = _cte_source(sel.join.right, ctes)
        if new_r is not sel.join.right:
            sel.join = dataclasses.replace(sel.join, right=new_r)


def _auto(s: str) -> Any:
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def parse(sql: str):
    """Parse one statement (trailing semicolon allowed)."""
    sql = sql.strip().rstrip(";")
    return Parser(sql).parse()
