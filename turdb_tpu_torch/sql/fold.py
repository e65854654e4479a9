"""Constant-folding optimizer rule.

Counterpart of the reference's constant-folding rewrite
(src/sql/optimizer/ rule set, SURVEY.md 2.6). Parameter-free,
column-free, pure-function expression subtrees are replaced by Literal
nodes ONCE per distinct SQL text (the statement parse cache), so a
cached plan never re-evaluates them per execution — and fold-time
semantics are identical to run-time semantics by construction, because
folding evaluates through the SAME columnar evaluator the executor
uses, on a one-row batch.

Volatile and statement-stable functions (random, now, current_*) are
never folded: folded statements outlive the statement that parsed them.
Expressions that RAISE at fold time (1/0) are left in place so the
error still surfaces at execution, where SQL semantics put it.
"""

from __future__ import annotations

import dataclasses

from turdb_tpu_torch.sql import ast as A

# nodes whose value is fully determined by constant children
_CONST_NODES = (
    A.BinaryOp, A.UnaryOp, A.IsNull, A.Like, A.Between, A.InList,
    A.Case, A.Cast, A.ArrayLiteral, A.ArrayIndex, A.TypedLiteral,
)

_VOLATILE = {
    "random", "rand", "uuid", "gen_random_uuid",
    # stable-per-statement: folding into the parse cache would freeze them
    "now", "current_timestamp", "current_date", "current_time",
    "curdate", "curtime", "localtime", "localtimestamp", "sysdate",
    "last_insert_id",
}


def _is_const(e) -> bool:
    if isinstance(e, A.Literal):
        return True
    if isinstance(e, A.FuncCall):
        if (
            e.name.lower() in _VOLATILE or e.over is not None or e.star
            or e.distinct or e.filter is not None
        ):
            return False
        from turdb_tpu_torch.sql.functions import AGGREGATES, WINDOW_FUNCS

        nm = e.name.lower()
        if nm in AGGREGATES or nm in WINDOW_FUNCS:
            return False
        return all(_is_const(a) for a in e.args)
    if not isinstance(e, _CONST_NODES):
        return False
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            if not _is_const(v):
                return False
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, A.Expr):
                    if not _is_const(x):
                        return False
                elif isinstance(x, tuple):
                    if not all(
                        _is_const(y) for y in x if isinstance(y, A.Expr)
                    ):
                        return False
    return True


def _try_fold(e):
    """Evaluate a constant subtree on a one-row batch; Literal on
    success, the original node when evaluation raises or the value has
    no literal form (vectors, jsonb trees keep their structure)."""
    from turdb_tpu_torch.sql.expr import Batch, EvalContext, eval_expr, _py

    try:
        col = eval_expr(e, Batch(1), EvalContext())
        v = None if bool(col.nulls[0]) else _py(col.values[0])
    except Exception:
        return e
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return A.Literal(v)
    return e


def fold_expr(e):
    if not isinstance(e, A.Expr) or isinstance(e, A.Literal):
        return e
    if _is_const(e):
        return _try_fold(e)
    # non-const overall: fold maximal constant children in place
    _fold_children(e)
    return e


def _fold_any(v):
    if isinstance(v, A.Expr):
        return fold_expr(v)
    if isinstance(v, list):
        return [_fold_any(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_fold_any(x) for x in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        _fold_children(v)
        return v
    return v


def _fold_children(node):
    for f in dataclasses.fields(node):
        setattr(node, f.name, _fold_any(getattr(node, f.name)))


def fold_statement(stmt):
    """Fold every expression position in a parsed statement tree
    (selects, DML, subqueries, CTE bodies, join conditions, defaults)."""
    if dataclasses.is_dataclass(stmt) and not isinstance(stmt, type):
        _fold_children(stmt)
    return stmt
