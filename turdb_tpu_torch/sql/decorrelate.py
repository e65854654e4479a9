"""Correlated-subquery decorrelation.

Counterpart of reference src/sql/optimizer/rules/decorrelate.rs:56. A
correlated IN / EXISTS / scalar subquery whose correlation is a
conjunction of `inner = outer` equalities is rewritten to run ONCE:

    EXISTS (SELECT .. WHERE t.x = o.y AND P)
      ->  semi-join o against (SELECT DISTINCT t.x FROM .. WHERE P)
    v IN (SELECT c .. WHERE t.x = o.y AND P)
      ->  membership of (v, o.y) in (SELECT c, t.x .. WHERE P)
    (SELECT agg(c) .. WHERE t.x = o.y AND P)
      ->  left-join o against (SELECT t.x, agg(c) .. WHERE P GROUP BY t.x)

The joins are factorized-code membership tests (sql/factorize.py), so a
decorrelated subquery costs one subquery execution + one C-speed probe
instead of one execution per outer row. Anything the classifier can't
prove safe falls back to the row-wise path (correct, slow) — mirroring
the reference's classifier split (subquery/classifier.rs:44-95)."""

from __future__ import annotations

import numpy as np

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.expr import Batch, Col, EvalContext, eval_expr
from turdb_tpu_torch.sql.lexer import SqlError


def _sub_ctx(ctx: EvalContext) -> EvalContext:
    c = EvalContext(ctx.params, ctx.subquery_fn)  # NO outer: must not leak
    for attr in ("read_ts", "own_txn", "query_budget", "budget", "db", "ctes"):
        if hasattr(ctx, attr):
            setattr(c, attr, getattr(ctx, attr))
    return c


def _split_conjuncts(e) -> list:
    out = []

    def flat(x):
        if isinstance(x, A.BinaryOp) and x.op == "AND":
            flat(x.left)
            flat(x.right)
        else:
            out.append(x)

    flat(e)
    return out


def _and(conjuncts):
    out = None
    for c in conjuncts:
        out = c if out is None else A.BinaryOp("AND", out, c)
    return out


def _from_scope(db, node, ctx):
    """Set of (qualifier, name) visible inside the subquery's FROM, or
    None when the scope can't be derived statically."""
    if node is None:
        return set()
    if isinstance(node, A.TableRef):
        q = node.alias or node.name
        ctes = getattr(ctx, "ctes", None) or {}
        if node.schema is None and node.name in ctes:
            return {(q, nm) for (_, nm) in ctes[node.name].names}
        try:
            info = db.resolve_table(node)
        except Exception:
            return None
        return {(q, c.name) for c in info.columns}
    if isinstance(node, A.SubqueryRef):
        names = set()
        for it in node.subquery.items:
            if isinstance(it, A.Star):
                return None
            names.add((node.alias, it.alias or _name_of(it.expr)))
        return names
    if isinstance(node, A.Join):
        a = _from_scope(db, node.left, ctx)
        b = _from_scope(db, node.right, ctx)
        return None if a is None or b is None else a | b
    return None


def _name_of(e) -> str:
    return e.name if isinstance(e, A.ColumnRef) else A.render_expr(e)


def _refs(e, out: list):
    import dataclasses

    if isinstance(e, A.ColumnRef):
        out.append(e)
        return
    if isinstance(e, (A.Star,)):
        out.append(e)
        return
    if isinstance(e, (A.ScalarSubquery, A.InSubquery, A.Exists, A.Quantified)):
        out.append(e)  # nested subquery: treat as unclassifiable
        return
    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            _refs(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, A.Expr):
                    _refs(x, out)


def _side_of(e, scope, outer: Batch):
    """'inner' | 'outer' | None for one expression's column references."""
    refs: list = []
    _refs(e, refs)
    sides = set()
    names_in_scope = {nm for _, nm in scope}
    for r in refs:
        if not isinstance(r, A.ColumnRef):
            return None  # Star / nested subquery: bail
        if r.table is not None:
            if (r.table, r.name) in scope:
                sides.add("inner")
                continue
        elif r.name in names_in_scope:
            sides.add("inner")  # unqualified: inner scope shadows outer
            continue
        try:
            outer.resolve(r.name, r.table)
            sides.add("outer")
        except SqlError:
            return None
    if len(sides) != 1:
        return None if sides else "const"
    return sides.pop()


def split_correlation(db, sub: A.Select, outer: Batch, ctx):
    """-> (corr_pairs [(inner_expr, outer_expr)], residual_conjuncts)
    or None when this subquery can't be decorrelated."""
    if sub.ctes or sub.set_op or sub.limit or sub.offset or sub.having:
        return None
    scope = _from_scope(db, sub.from_, ctx)
    if scope is None:
        return None
    corr, residual = [], []
    for c in _split_conjuncts(sub.where) if sub.where is not None else []:
        side = _side_of(c, scope, outer)
        if side in ("inner", "const"):
            residual.append(c)
            continue
        if isinstance(c, A.BinaryOp) and c.op == "=":
            ls = _side_of(c.left, scope, outer)
            rs = _side_of(c.right, scope, outer)
            if ls == "inner" and rs == "outer":
                corr.append((c.left, c.right))
                continue
            if ls == "outer" and rs == "inner":
                corr.append((c.right, c.left))
                continue
        return None  # mixed or non-equality correlation
    if not corr:
        return None  # uncorrelated (handled by the direct path)
    return corr, residual


def _run(sub2: A.Select, ctx) -> Batch | None:
    try:
        return ctx.subquery_fn(sub2, _sub_ctx(ctx))
    except SqlError:
        return None  # e.g. residual still references the outer scope


def _count_stat(kind: str):
    from turdb_tpu_torch.sql.engine import STATS

    STATS[kind] = STATS.get(kind, 0) + 1


def exists_decorrelated(e: A.Exists, batch: Batch, ctx) -> Col | None:
    db = getattr(ctx, "db", None)
    if db is None:
        return None
    sp = split_correlation(db, e.subquery, batch, ctx)
    if sp is None:
        return None
    corr, residual = sp
    sub2 = A.Select(
        items=[A.SelectItem(ix, f"__corr{i}") for i, (ix, _) in enumerate(corr)],
        from_=e.subquery.from_,
        where=_and(residual),
        distinct=True,
    )
    res = _run(sub2, ctx)
    if res is None:
        return None
    from turdb_tpu_torch.sql.factorize import joint_codes

    lkeys = [eval_expr(o, batch, ctx) for _, o in corr]
    rkeys = list(res.cols[: len(corr)])
    lc, rc = joint_codes(lkeys, rkeys)
    out = np.isin(lc, rc) & (lc >= 0)
    _count_stat("decorrelated")
    return Col(~out if e.negated else out)


def in_decorrelated(e: A.InSubquery, batch: Batch, ctx) -> Col | None:
    db = getattr(ctx, "db", None)
    if db is None:
        return None
    sub = e.subquery
    if not sub.items or isinstance(sub.items[0], A.Star):
        return None
    sp = split_correlation(db, sub, batch, ctx)
    if sp is None:
        return None
    corr, residual = sp
    items = [sub.items[0]] + [
        A.SelectItem(ix, f"__corr{i}") for i, (ix, _) in enumerate(corr)
    ]
    sub2 = A.Select(items=items, from_=sub.from_, where=_and(residual))
    res = _run(sub2, ctx)
    if res is None:
        return None
    from turdb_tpu_torch.sql.factorize import joint_codes

    v = eval_expr(e.operand, batch, ctx)
    outer_corr = [eval_expr(o, batch, ctx) for _, o in corr]
    lc, rc = joint_codes([v] + outer_corr, list(res.cols[: 1 + len(corr)]))
    match = np.isin(lc, rc) & (lc >= 0)
    # NOT IN 3VL: unknown when the row's correlation group contains a
    # NULL candidate and there was no positive match
    nulls = v.nulls.copy()
    col0 = res.cols[0]
    if col0.nulls.any():
        glc, grc = joint_codes(outer_corr, list(res.cols[1 : 1 + len(corr)]))
        had_null = np.isin(glc, grc[col0.nulls]) & (glc >= 0)
        nulls = nulls | (~match & had_null)
    _count_stat("decorrelated")
    if e.negated:
        return Col(~match, nulls)
    return Col(match, nulls)


def scalar_decorrelated(e: A.ScalarSubquery, batch: Batch, ctx) -> Col | None:
    from turdb_tpu_torch.sql.engine import (
        _contains_aggregate,
        _contains_window,
    )

    db = getattr(ctx, "db", None)
    if db is None:
        return None
    sub = e.subquery
    if len(sub.items) != 1 or isinstance(sub.items[0], A.Star):
        return None
    if sub.group_by or sub.order_by or _contains_window(sub.items[0].expr):
        return None
    sp = split_correlation(db, sub, batch, ctx)
    if sp is None:
        return None
    corr, residual = sp
    item = sub.items[0]
    is_agg = _contains_aggregate(item.expr)
    if is_agg and not isinstance(item.expr, A.FuncCall):
        return None  # only a bare aggregate call maps to grouped execution
    corr_items = [
        A.SelectItem(ix, f"__corr{i}") for i, (ix, _) in enumerate(corr)
    ]
    sub2 = A.Select(
        items=corr_items + [A.SelectItem(item.expr, "__val")],
        from_=sub.from_,
        where=_and(residual),
        group_by=[ix for ix, _ in corr] if is_agg else [],
    )
    res = _run(sub2, ctx)
    if res is None:
        return None
    from turdb_tpu_torch.sql.factorize import joint_codes, match_pairs

    outer_corr = [eval_expr(o, batch, ctx) for _, o in corr]
    lc, rc = joint_codes(outer_corr, list(res.cols[: len(corr)]))
    li, ri = match_pairs(lc, rc)
    if not is_agg and len(li) and len(np.unique(li)) != len(li):
        raise SqlError("scalar subquery returned more than one row")
    val = res.cols[len(corr)]
    n = batch.n
    is_count = (
        is_agg and isinstance(item.expr, A.FuncCall)
        and item.expr.name == "count"
    )
    if is_count:
        out = np.zeros(n, np.int64)
        nulls = np.zeros(n, bool)  # COUNT over an empty group is 0
    else:
        out = np.empty(n, object)
        nulls = np.ones(n, bool)
    out[li] = val.values[ri]
    nulls[li] = val.nulls[ri]
    _count_stat("decorrelated")
    from turdb_tpu_torch.sql.expr import _densify

    return _densify(Col(out, nulls)) if out.dtype == object else Col(out, nulls)
