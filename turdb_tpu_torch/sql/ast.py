"""SQL AST nodes (reference src/sql/ast.rs:83-299 Statement inventory +
vector distance operators ast.rs:907-909), as plain dataclasses."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


@dataclass
class Expr:
    def __str__(self):
        return render_expr(self)


@dataclass
class Literal(Expr):
    value: Any            # None | bool | int | float | str | bytes | list


@dataclass
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None


@dataclass
class Param(Expr):
    index: int            # 1-based ? / $n position


@dataclass
class Star(Expr):
    table: Optional[str] = None


@dataclass
class BinaryOp(Expr):
    op: str               # '+','-','*','/','%','=','<>','<','<=','>','>=',
    #                       'AND','OR','||','<->','<#>','<=>','->','->>','@>','<@'
    left: Expr = None
    right: Expr = None


@dataclass
class UnaryOp(Expr):
    op: str               # '-', '+', 'NOT'
    operand: Expr = None


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class IsDistinct(Expr):
    """IS [NOT] DISTINCT FROM — null-safe comparison, never NULL."""
    left: Expr
    right: Expr
    negated: bool = False


@dataclass
class Like(Expr):
    operand: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False   # ILIKE
    escape: Optional[Expr] = None    # ESCAPE 'c'
    similar: bool = False            # SIMILAR TO (SQL regex subset)


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    operand: Expr
    items: list
    negated: bool = False


@dataclass
class InSubquery(Expr):
    operand: Expr
    subquery: "Select"
    negated: bool = False


@dataclass
class Quantified(Expr):
    """<operand> <op> ANY/ALL (<subquery>) (reference quantified
    subqueries, sql/subquery/classifier.rs:44-95)."""

    op: str                  # comparison operator
    operand: Expr
    kind: str                # "ANY" | "ALL" (SOME parses as ANY)
    subquery: "Select"


@dataclass
class Exists(Expr):
    subquery: "Select"
    negated: bool = False


@dataclass
class ScalarSubquery(Expr):
    subquery: "Select"


@dataclass
class FuncCall(Expr):
    name: str
    args: list = field(default_factory=list)
    distinct: bool = False
    star: bool = False            # COUNT(*)
    filter: Optional[Expr] = None  # FILTER (WHERE ...)
    over: Optional["WindowSpec"] = None
    order_by: list = field(default_factory=list)  # agg(x ORDER BY ..)
    within_group: bool = False    # fn(..) WITHIN GROUP (ORDER BY ..)


@dataclass
class WindowSpec:
    partition_by: list = field(default_factory=list)
    order_by: list = field(default_factory=list)   # [OrderItem]
    # ("ROWS"|"RANGE", lo, hi); bounds: "up" = UNBOUNDED PRECEDING,
    # "uf" = UNBOUNDED FOLLOWING, int = offset (0 CURRENT ROW, -k
    # PRECEDING, +k FOLLOWING). None = no explicit frame (SQL default).
    frame: Optional[tuple] = None


@dataclass
class Case(Expr):
    operand: Optional[Expr] = None
    whens: list = field(default_factory=list)      # [(cond, result)]
    else_: Optional[Expr] = None


@dataclass
class Cast(Expr):
    operand: Expr
    type_name: str
    type_params: list = field(default_factory=list)


@dataclass
class ArrayLiteral(Expr):
    items: list = field(default_factory=list)


@dataclass
class ArrayIndex(Expr):
    base: Expr
    index: Expr


@dataclass
class TypedLiteral(Expr):
    type_name: str        # DATE / TIME / TIMESTAMP / INTERVAL / VECTOR
    text: str


# ---------------------------------------------------------------------------
# query structure
# ---------------------------------------------------------------------------


@dataclass
class OrderItem:
    expr: Expr
    desc: bool = False
    nulls_last: Optional[bool] = None


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class TableRef:
    name: str
    schema: Optional[str] = None
    alias: Optional[str] = None
    sample: Optional["TableSample"] = None   # TABLESAMPLE clause


@dataclass
class SubqueryRef:
    subquery: "Select"
    alias: str
    lateral: bool = False    # LATERAL (...): re-run per left row with
                             # that row's columns as outer bindings


@dataclass
class Join:
    left: Any             # TableRef | SubqueryRef | Join
    right: Any
    kind: str             # INNER/LEFT/RIGHT/FULL/CROSS
    on: Optional[Expr] = None
    using: Optional[list] = None
    natural: bool = False  # NATURAL JOIN: using = shared column names


@dataclass
class CTE:
    name: str
    query: "Select"
    columns: Optional[list] = None
    recursive: bool = False       # WITH RECURSIVE (reference ast.rs:172)


@dataclass
class Select:
    items: list = field(default_factory=list)        # [SelectItem|Star]
    from_: Any = None                                # TableRef|SubqueryRef|Join|None
    where: Optional[Expr] = None
    group_by: list = field(default_factory=list)
    grouping_sets: Optional[list] = None   # ROLLUP/CUBE/GROUPING SETS
    having: Optional[Expr] = None
    order_by: list = field(default_factory=list)     # [OrderItem]
    limit: Optional[Expr] = None
    offset: Optional[Expr] = None
    distinct: bool = False
    distinct_on: Optional[list] = None   # DISTINCT ON (exprs)
    ctes: list = field(default_factory=list)         # [CTE]
    set_op: Optional[tuple] = None   # ('UNION'|'INTERSECT'|'EXCEPT', all, Select)
    # False = absent, else a LockClause (reference ast.rs ForClause).
    # Truthy test = "has a FOR locking clause" stays valid.
    for_update: Any = False


@dataclass
class TableSample:
    """TABLESAMPLE {BERNOULLI|SYSTEM} (pct) [REPEATABLE (seed)] on a
    table reference (reference lexes TABLESAMPLE/REPEATABLE, never
    parses them; PostgreSQL 7.2.1.1 semantics — SYSTEM samples
    contiguous blocks, BERNOULLI samples rows)."""
    method: str                  # 'bernoulli' | 'system'
    percent: float
    seed: Optional[int] = None   # REPEATABLE (seed)


@dataclass
class TableFunc:
    """Table function in FROM: UNNEST(arrays..) [WITH ORDINALITY]
    [AS alias [(col_aliases..)]] (reference lexes UNNEST/ORDINALITY,
    never parses them; PostgreSQL 7.2.1.4 semantics)."""
    name: str
    args: list = field(default_factory=list)
    ordinality: bool = False
    alias: Optional[str] = None
    col_aliases: Optional[list] = None


@dataclass
class LockClause:
    """FOR {UPDATE | NO KEY UPDATE | SHARE | KEY SHARE} [OF tables]
    [NOWAIT | SKIP LOCKED] (reference ast.rs:132-157 ForClause). All
    modes take the same exclusive row locks here (single-writer MVCC
    has no shared locks; exclusive is the conservative superset)."""
    mode: str = "update"      # update | no key update | share | key share
    tables: Optional[list] = None    # OF t1, t2 (restricts lock targets)
    policy: str = "wait"             # wait | nowait | skip locked


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------


@dataclass
class Insert:
    table: TableRef
    columns: Optional[list] = None
    values: Optional[list] = None        # list of rows (list of Expr)
    query: Optional[Select] = None       # INSERT ... SELECT
    on_conflict: Optional[tuple] = None  # (cols|None, 'NOTHING'|[(col, expr)])
    returning: Optional[list] = None


@dataclass
class Update:
    table: TableRef
    assignments: list = field(default_factory=list)  # [(col, Expr)]
    from_: Any = None
    where: Optional[Expr] = None
    returning: Optional[list] = None


@dataclass
class Delete:
    table: TableRef
    where: Optional[Expr] = None
    returning: Optional[list] = None
    using: Any = None       # DELETE .. USING <from> (reference ast.rs:318)


@dataclass
class ColumnSpec:
    name: str
    type_name: str
    type_params: list = field(default_factory=list)
    not_null: bool = False
    primary_key: bool = False
    unique: bool = False
    default: Optional[Expr] = None
    check: Optional[Expr] = None
    references: Optional[tuple] = None   # (table, col, on_delete, on_update)
    auto_increment: bool = False         # AUTO_INCREMENT attribute (ref README)


@dataclass
class TableConstraint:
    kind: str                             # PRIMARY KEY/UNIQUE/CHECK/FOREIGN KEY
    columns: list = field(default_factory=list)
    expr: Optional[Expr] = None
    ref_table: Optional[str] = None
    ref_columns: list = field(default_factory=list)
    on_delete: Optional[str] = None
    on_update: Optional[str] = None
    name: Optional[str] = None


@dataclass
class CreateTable:
    table: TableRef
    columns: list = field(default_factory=list)       # [ColumnSpec]
    constraints: list = field(default_factory=list)   # [TableConstraint]
    if_not_exists: bool = False
    temporary: bool = False      # CREATE TEMP TABLE (reference ast.rs:330)


@dataclass
class CreateIndex:
    name: str
    table: TableRef
    columns: list = field(default_factory=list)       # [(expr, desc)]
    unique: bool = False
    using: Optional[str] = None                       # BTREE | HNSW
    options: dict = field(default_factory=dict)       # WITH (m=16, ...)
    if_not_exists: bool = False
    where: Optional[Expr] = None       # partial index (table.rs:273)
    where_text: Optional[str] = None   # predicate source text


@dataclass
class CreateSchema:
    name: str
    if_not_exists: bool = False


@dataclass
class CreateFunction:
    """CREATE [OR REPLACE] FUNCTION f(x INT, ...) RETURNS T AS 'body'
    LANGUAGE SQL (reference ast.rs:555 — parsed there, executed here).
    The body is a scalar expression or a single-item SELECT without
    FROM."""
    name: str
    schema: Optional[str]
    params: list                    # [(name, type_name)]
    return_type: str
    body: str
    language: str = "sql"
    or_replace: bool = False


@dataclass
class CreateProcedure:
    """CREATE PROCEDURE p(x INT) AS '<stmt>; <stmt>' LANGUAGE SQL
    (reference ast.rs CreateProcedureStmt — parsed there, executed
    here via CALL)."""
    name: str
    schema: Optional[str]
    params: list                    # [(name, type_name)]
    body: str                       # SQL statement script
    language: str = "sql"
    or_replace: bool = False


@dataclass
class Call:
    """CALL p(args) (reference ast.rs CallStmt)."""
    name: str
    schema: Optional[str]
    args: list = field(default_factory=list)


@dataclass
class Grant:
    """GRANT / REVOKE (reference ast.rs:743 GrantStmt / :752 RevokeStmt).
    A single-user embedded engine has no principals to enforce against —
    like the reference, grants are accepted and recorded, not enforced;
    they surface in turdb_catalog.grants."""
    kind: str                      # GRANT | REVOKE
    privileges: list               # ["SELECT", ...] or ["ALL"]
    object_type: Optional[str]     # TABLE/SCHEMA/... or None
    object_name: Optional[str]
    grantees: list
    grant_option: bool = False     # WITH GRANT OPTION (grant only)
    cascade: bool = False          # CASCADE (revoke only)


@dataclass
class CreateTrigger:
    """CREATE TRIGGER (reference ast.rs:582 — parsed there, executed
    here). Bodies: SQLite-style BEGIN <stmt>; ... END with NEW./OLD.
    references, or the reference's EXECUTE FUNCTION f() form (calls a
    user SQL function per row, result discarded)."""
    name: str
    table: str
    timing: str                    # BEFORE | AFTER | INSTEAD OF (views)
    events: list                   # ["INSERT", "UPDATE", "DELETE"]
    body: list                     # SQL statement strings
    when: Optional[str] = None     # WHEN condition (SQL text)
    or_replace: bool = False
    level: str = "ROW"             # FOR EACH ROW | FOR EACH STATEMENT


@dataclass
class CreateType:
    """CREATE TYPE name AS ENUM (...) | AS (field type, ...) — the
    reference parses this (parser.rs parse_create_type) but never wired
    execution; here it executes."""
    name: str
    schema: Optional[str]
    kind: str                       # "enum" | "composite"
    values: list                    # enum labels | (field, type, params)


@dataclass
class Drop:
    kind: str                # TABLE | INDEX | SCHEMA | VIEW
    name: str
    schema: Optional[str] = None
    if_exists: bool = False


@dataclass
class CreateView:
    """CREATE [OR REPLACE] VIEW name [(cols)] AS select.

    The reference parses views (ast.rs CreateViewStmt, parser.rs:2132)
    but its executor bails "unsupported statement type"
    (database.rs:4397); here views EXECUTE — stored as SQL text in the
    catalog and expanded as subqueries at name resolution."""
    name: str
    query: Any               # parsed Select
    sql: str                 # the SELECT body text (persisted verbatim)
    schema: Optional[str] = None
    columns: Optional[list] = None   # optional output column renames
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class AlterTable:
    table: TableRef
    action: str              # ADD_COLUMN/DROP_COLUMN/RENAME_TABLE/
                             # RENAME_COLUMN/ALTER_COLUMN/ADD_CONSTRAINT/
                             # DROP_CONSTRAINT
    column: Optional[ColumnSpec] = None
    name: Optional[str] = None
    new_name: Optional[str] = None
    # ALTER COLUMN payload (reference ast.rs AlterColumnAction)
    col_action: Optional[str] = None   # SET_TYPE/SET_DEFAULT/DROP_DEFAULT/
                                       # SET_NOT_NULL/DROP_NOT_NULL
    expr: Optional[Expr] = None        # SET DEFAULT value
    type_name: Optional[str] = None    # SET DATA TYPE
    type_params: Optional[list] = None
    constraint: Optional["TableConstraint"] = None   # ADD CONSTRAINT


@dataclass
class Merge:
    """MERGE INTO target USING source ON cond WHEN [NOT] MATCHED THEN ...
    (reference ast.rs:635 MergeStmt — parsed there, executed here).
    Clauses: ("update", assignments) | ("delete",) |
    ("insert", cols_or_None, value_exprs)."""
    target: TableRef
    source: Any            # TableRef | SubqueryRef
    on: Expr
    clauses: list = field(default_factory=list)


@dataclass
class Truncate:
    table: TableRef
    restart_identity: bool = False


@dataclass
class TxnStmt:
    kind: str                # BEGIN/COMMIT/ROLLBACK/SAVEPOINT/RELEASE/ROLLBACK_TO
    name: Optional[str] = None
    read_only: bool = False  # BEGIN READ ONLY
    isolation: Optional[str] = None  # ISOLATION LEVEL ... (all = snapshot)


@dataclass
class Explain:
    stmt: Any
    analyze: bool = False
    format: str = "text"     # EXPLAIN (FORMAT JSON)


@dataclass
class Pragma:
    name: str
    value: Any = None


@dataclass
class Vacuum:
    table: Optional[str] = None


@dataclass
class Analyze:
    """ANALYZE [table]: collect planner statistics (row counts,
    per-column distinct estimates) into turdb_catalog.statistics."""
    table: Optional[str] = None


# ---------------------------------------------------------------------------
# rendering (for EXPLAIN/errors; not a full SQL serializer)
# ---------------------------------------------------------------------------


def render_expr(e) -> str:
    if isinstance(e, Literal):
        if isinstance(e.value, str):
            return "'" + e.value.replace("'", "''") + "'"
        if e.value is None:
            return "NULL"
        return str(e.value)
    if isinstance(e, ColumnRef):
        return f"{e.table}.{e.name}" if e.table else e.name
    if isinstance(e, Star):
        return f"{e.table}.*" if e.table else "*"
    if isinstance(e, Param):
        return f"${e.index}"
    if isinstance(e, BinaryOp):
        return f"({render_expr(e.left)} {e.op} {render_expr(e.right)})"
    if isinstance(e, UnaryOp):
        return f"({e.op} {render_expr(e.operand)})"
    if isinstance(e, IsNull):
        return f"({render_expr(e.operand)} IS {'NOT ' if e.negated else ''}NULL)"
    if isinstance(e, FuncCall):
        inner = "*" if e.star else ", ".join(render_expr(a) for a in e.args)
        ob_txt = ""
        if e.order_by:
            ob_txt = "ORDER BY " + ", ".join(
                render_expr(ob.expr) + (" DESC" if ob.desc else "")
                for ob in e.order_by
            )
        if ob_txt and not e.within_group:
            inner += " " + ob_txt
        out = f"{e.name}({'DISTINCT ' if e.distinct else ''}{inner})"
        if e.within_group:
            out += f" WITHIN GROUP ({ob_txt})"
        # FILTER is part of the aggregate's identity: the engine dedups
        # aggregates by rendered text, so count(*) FILTER (WHERE p) must
        # not collapse into a bare count(*) (differential-fuzz-found)
        if e.filter is not None:
            out += f" FILTER (WHERE {render_expr(e.filter)})"
        return out
    if isinstance(e, Cast):
        return f"CAST({render_expr(e.operand)} AS {e.type_name})"
    if isinstance(e, Case):
        parts = ["CASE"]
        if e.operand is not None:
            parts.append(render_expr(e.operand))
        for c, r in e.whens:
            parts.append(f"WHEN {render_expr(c)} THEN {render_expr(r)}")
        if e.else_ is not None:
            parts.append(f"ELSE {render_expr(e.else_)}")
        parts.append("END")
        return " ".join(parts)
    if isinstance(e, TypedLiteral):
        return f"{e.type_name} '{e.text}'"
    if isinstance(e, Quantified):
        return f"({render_expr(e.operand)} {e.op} {e.kind} (<subquery>))"
    if dataclasses.is_dataclass(e):
        return type(e).__name__
    return repr(e)
