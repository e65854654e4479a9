"""Query planning + columnar execution.

Counterpart of reference src/sql/planner + optimizer + executor (SURVEY.md
§2.6), collapsed into a batch-columnar pipeline: FROM (scans/joins) →
WHERE → GROUP/HAVING → window → SELECT list → DISTINCT → ORDER/LIMIT,
each stage a whole-column transform (the reference's Volcano per-row
`next()` loop survives only as this stage ordering — SURVEY.md §7).

Includes the ANN fast path the reference designed but never wired
(docs/plans/2026-01-08-hnsw-integration-design.md; planner has zero HNSW
references, SURVEY.md §2.3): `ORDER BY vec_col <-> const LIMIT k` over a
table with an HNSW index becomes an index search with MVCC-visibility
masking and over-fetch, falling back to the exact scan otherwise.
"""

from __future__ import annotations

import numpy as np

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.expr import (
    Batch,
    Col,
    EvalContext,
    _densify,
    _py,
    eval_expr,
    parse_vector_text,
)
from turdb_tpu_torch.sql.functions import AGGREGATES, WINDOW_FUNCS
from turdb_tpu_torch.sql.lexer import SqlError

ROWID = "#rowid"
MAX_NESTED_LOOP = 10_000_000
MAX_RECURSIVE_ITERS = 100_000  # WITH RECURSIVE runaway guard

# observability counters (PRAGMA spill_stats; reference group-commit/lock
# stats analogs, group_commit.rs:126)
STATS = {
    "grace_joins": 0, "spill_partitions": 0, "spilled_bytes": 0,
    "decorrelated": 0, "rowwise_subqueries": 0,
    "ann_filtered_searches": 0,
}


class QueryEngine:
    """Executes Select ASTs against a Database (catalog + tables + txn)."""

    def __init__(self, db):
        self.db = db

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def run_select(self, sel: A.Select, ctx: EvalContext) -> Batch:
        ctes = dict(ctx.__dict__.get("ctes", {}) or {})
        for cte in sel.ctes:
            if (
                cte.recursive
                and cte.query.set_op is not None
                and _refs_cte(cte.query.set_op[2], cte.name)
            ):
                b = self._recursive_cte(cte, self._child_ctx(ctx, ctes))
            else:
                b = self.run_select(cte.query, self._child_ctx(ctx, ctes))
            if cte.columns:
                if len(cte.columns) != len(b.names):
                    raise SqlError("CTE column count mismatch")
                b.names = [(cte.name, c) for c in cte.columns]
            else:
                b.names = [(cte.name, nm) for (_, nm) in b.names]
            ctes[cte.name] = b
        ctx = self._child_ctx(ctx, ctes)

        out = self._select_core(sel, ctx)

        if sel.set_op is not None:
            op, all_, rhs = sel.set_op
            right = self.run_select(rhs, ctx)
            out = _apply_setop(out, right, op, all_)

        if sel.order_by:
            out = self._order(out, sel.order_by, ctx, sel)
        if sel.distinct_on:
            out = self._distinct_on(out, sel, ctx)
        out = self._limit(out, sel, ctx)
        return out

    def _recursive_cte(self, cte: A.CTE, ctx: EvalContext) -> Batch:
        """WITH RECURSIVE fixpoint (reference ast.rs:172 carries the
        flag; semantics per the SQL standard: evaluate the base term,
        then re-evaluate the recursive term against the PREVIOUS
        iteration's rows until it produces nothing new. UNION (without
        ALL) dedups each iteration against everything accumulated."""
        import dataclasses as dc

        from turdb_tpu_torch.sql.factorize import joint_codes

        q = cte.query
        op, all_, rec = q.set_op
        if op != "UNION":
            raise SqlError("recursive CTE requires <base> UNION [ALL] <step>")
        base = dc.replace(q, set_op=None, order_by=[], limit=None,
                          offset=None)
        acc = _strip_hidden(self.run_select(base, ctx))
        if not all_:
            acc = _distinct(acc)
        colnames = cte.columns or [nm for (_, nm) in acc.names]
        if len(colnames) != len(acc.names):
            raise SqlError("CTE column count mismatch")
        work = acc
        for _ in range(MAX_RECURSIVE_ITERS):
            if work.n == 0:
                break
            wb = Batch(work.n)
            for nm, c in zip(colnames, work.cols):
                wb.add(cte.name, nm, c)
            sub = dict(getattr(ctx, "ctes", {}) or {})
            sub[cte.name] = wb
            new = _strip_hidden(self.run_select(rec, self._child_ctx(ctx, sub)))
            if len(new.cols) != len(acc.cols):
                raise SqlError(
                    "recursive term must match the base term's column count"
                )
            if not all_:
                new = _distinct(new)
                lc, rc = joint_codes(new.cols, acc.cols, null_matches=True)
                new = new.take(np.flatnonzero(~np.isin(lc, rc)))
            if new.n == 0:
                break
            new.names = list(acc.names)
            acc = acc.concat(new)
            work = new
        else:
            raise SqlError(
                f"recursive CTE exceeded {MAX_RECURSIVE_ITERS} iterations"
            )
        acc.names = [(cte.name, nm) for nm in colnames]
        if q.order_by:
            acc = self._order(acc, q.order_by, ctx, q)
        return self._limit(acc, q, ctx)

    def _child_ctx(self, ctx: EvalContext, ctes) -> EvalContext:
        c = EvalContext(ctx.params, self._subquery_fn, outer=ctx.outer)
        c.ctes = ctes
        # propagate the MVCC snapshot (read_ts/own_txn ride on the context)
        for attr in ("read_ts", "own_txn", "query_budget", "budget", "db",
                     "view_depth"):
            if hasattr(ctx, attr):
                setattr(c, attr, getattr(ctx, attr))
        return c

    def _subquery_fn(self, sub: A.Select, sub_ctx: EvalContext) -> Batch:
        return self.run_select(sub, sub_ctx)

    # ------------------------------------------------------------------
    # core (FROM..SELECT list)
    # ------------------------------------------------------------------

    def _select_core(self, sel: A.Select, ctx: EvalContext) -> Batch:
        # projection pruning: scan only referenced columns (reference
        # optimizer/rules/projection_pruning.rs). Saved/restored because
        # nested selects (FROM subqueries, CTE bodies) share the ctx.
        prev_needed = getattr(ctx, "needed_cols", None)
        ctx.needed_cols = _collect_needed(sel)
        try:
            return self._select_core_inner(sel, ctx)
        finally:
            ctx.needed_cols = prev_needed

    def _select_core_inner(self, sel: A.Select, ctx: EvalContext) -> Batch:
        # ANN fast path before generic FROM/WHERE
        ann = self._try_ann_path(sel, ctx)
        if ann is not None:
            src = ann
        else:
            src = None
            if sel.where is not None and isinstance(sel.from_, A.TableRef):
                # index point lookup: eq conjuncts covering a B-tree index
                # (reference index_selection.rs:38 / scan bounds)
                hook = getattr(self.db, "_try_index_scan", None)
                if hook is not None:
                    src = hook(sel.from_, sel.where, ctx)
            if src is None and isinstance(sel.from_, A.Join) and sel.where:
                # predicate pushdown: single-side conjuncts filter before
                # the join (reference optimizer/rules predicate pushdown)
                ctx.pushdown = _split_conjuncts(sel.where)
                src = self._from(sel.from_, ctx)
                remaining = [c for c in ctx.pushdown if c is not None]
                ctx.pushdown = None
                pred = None
                for c in remaining:
                    pred = c if pred is None else A.BinaryOp("AND", pred, c)
                if pred is not None:
                    cc = eval_expr(pred, src, ctx)
                    src = src.take(
                        np.flatnonzero(cc.values.astype(bool) & ~cc.nulls)
                    )
            elif src is None:
                src = self._from(sel.from_, ctx)
                if sel.where is not None:
                    c = eval_expr(sel.where, src, ctx)
                    keep = np.flatnonzero(c.values.astype(bool) & ~c.nulls)
                    src = src.take(keep)
            else:
                # index scan found: evaluate the full predicate on the small
                # candidate batch (covers non-indexed conjuncts)
                c = eval_expr(sel.where, src, ctx)
                src = src.take(np.flatnonzero(c.values.astype(bool) & ~c.nulls))

        item_agg = any(
            _contains_aggregate(it.expr)
            for it in sel.items
            if isinstance(it, A.SelectItem)
        )
        # HAVING with no GROUP BY and no aggregates anywhere filters the
        # projected rows on select aliases (reference integration_sql.rs
        # having_without_group_by_filters_on_select_alias); with
        # aggregates it keeps the single-group SQL meaning
        having_filter = (
            sel.having is not None and not sel.group_by and not item_agg
            and not _contains_aggregate(sel.having)
        )
        has_agg = item_agg or bool(sel.group_by) or (
            sel.having is not None and not having_filter
        )

        if has_agg:
            if sel.grouping_sets is not None:
                out = self._grouping_sets_agg(sel, src, ctx)
            else:
                out = self._aggregate(sel, src, ctx)
        else:
            out = self._project(sel, src, ctx)
            if having_filter:
                hv = eval_expr(sel.having, out, ctx)
                keep = np.flatnonzero(hv.values.astype(bool) & ~hv.nulls)
                out = out.take(keep)
                src = src.take(keep)
            if not sel.distinct:
                # row-aligned source lets ORDER BY reference unprojected
                # columns (SELECT name FROM t ORDER BY id)
                out._source = src  # type: ignore[attr-defined]

        if sel.distinct:
            out = _distinct(out)
        return out

    # ------------------------------------------------------------------
    # FROM clause
    # ------------------------------------------------------------------

    def _from(self, node, ctx: EvalContext) -> Batch:
        if node is None:
            # SELECT without FROM: one synthetic row (reference Dual source)
            return Batch(1)
        if isinstance(node, A.TableRef):
            ctes = getattr(ctx, "ctes", {})
            if node.schema is None and node.name in ctes:
                b = ctes[node.name]
                q = node.alias or node.name
                out = Batch(b.n)
                for (_, nm), c in zip(b.names, b.cols):
                    out.add(q, nm, c)
            else:
                vd = getattr(self.db, "views", {}).get(
                    node.schema or "main", {}
                ).get(node.name)
                if vd is not None:
                    out = self._expand_view(vd, node, ctx)
                else:
                    out = self.db._scan_batch(node, ctx)
            if node.sample is not None:
                out = _tablesample(out, node.sample)
            return out
        if isinstance(node, A.SubqueryRef):
            b = self.run_select(node.subquery, ctx)
            out = Batch(b.n)
            for (_, nm), c in zip(b.names, b.cols):
                out.add(node.alias, nm, c)
            return out
        if isinstance(node, A.Join):
            return self._join(node, ctx)
        if isinstance(node, A.TableFunc):
            return self._table_func(node, ctx)
        raise SqlError(f"bad FROM node {type(node).__name__}")

    def _table_func(self, node: A.TableFunc, ctx: EvalContext) -> Batch:
        """UNNEST(a1, a2, ..) [WITH ORDINALITY]: each array becomes a
        column; rows run to the longest array, shorter ones NULL-pad
        (PostgreSQL multi-argument unnest semantics)."""
        if node.name != "unnest":
            raise SqlError(f"unknown table function {node.name}()")
        lists = []
        for a in node.args:
            c = eval_expr(a, Batch(1), ctx)
            if c.nulls[0]:
                lists.append([])
                continue
            v = c.values[0]
            if not isinstance(v, (list, tuple, np.ndarray)):
                raise SqlError("unnest() argument must be an array")
            lists.append([_py(x) for x in np.asarray(v).tolist()]
                         if isinstance(v, np.ndarray) else list(v))
        n = max((len(x) for x in lists), default=0)
        q = node.alias or "unnest"
        names = node.col_aliases
        if names is not None:
            want = len(lists) + (1 if node.ordinality else 0)
            if len(names) != want:
                raise SqlError(
                    f"unnest alias has {len(names)} columns, needs {want}"
                )
        out = Batch(n)
        for j, xs in enumerate(lists):
            vals = np.empty(n, object)
            nulls = np.ones(n, bool)
            for i, x in enumerate(xs):
                if x is not None:
                    vals[i] = x
                    nulls[i] = False
            nm = (names[j] if names is not None
                  else ("unnest" if len(lists) == 1 else f"unnest_{j + 1}"))
            out.add(q, nm, _densify(Col(vals, nulls)))
        if node.ordinality:
            nm = names[-1] if names is not None else "ordinality"
            out.add(q, nm, Col(np.arange(1, n + 1, dtype=np.int64)))
        return out

    def _expand_view(self, vd, node: A.TableRef, ctx: EvalContext) -> Batch:
        """Run a view body as a subquery (reference parses views,
        ast.rs:544, but bails executing them; here they run). The body
        executes under a CHILD context: outer CTEs must not shadow names
        inside the view, and pushdown state belongs to the outer join."""
        depth = getattr(ctx, "view_depth", 0)
        if depth >= 16:
            raise SqlError(
                f"view nesting too deep expanding {node.name!r} (cycle?)"
            )
        sub_ctx = self._child_ctx(ctx, {})
        sub_ctx.view_depth = depth + 1
        b = self.run_select(vd.select_ast(), sub_ctx)
        q = node.alias or node.name
        visible = [(nm, c) for (_, nm), c in zip(b.names, b.cols)
                   if nm != ROWID]    # the hidden rowid is not view output
        if vd.columns is not None and len(vd.columns) != len(visible):
            raise SqlError(
                f"view {vd.name}: {len(vd.columns)} column names for "
                f"{len(visible)} output columns"
            )
        out = Batch(b.n)
        for j, (nm, c) in enumerate(visible):
            out.add(q, vd.columns[j] if vd.columns else nm, c)
        return out

    def _join(self, j: A.Join, ctx: EvalContext) -> Batch:
        if isinstance(j.right, A.SubqueryRef) and j.right.lateral:
            return self._lateral_join(j, ctx)
        # cost-ordered join tree for pure INNER chains (reference
        # optimizer/rules/join_reordering.rs:66): leaves materialize
        # first, so ACTUAL row counts drive the greedy order
        if (
            j.kind in ("INNER", "CROSS")
            and j.using is None
            and (isinstance(j.left, A.Join) or isinstance(j.right, A.Join))
        ):
            flat = _flatten_inner(j)
            if flat is not None and len(flat[0]) > 2:
                return self._join_reordered(flat[0], flat[1], ctx)
        left = self._from(j.left, ctx)
        right = self._from(j.right, ctx)
        # consume pushed-down single-side predicates (outer-join safe:
        # only the non-null-padded side accepts pushdown)
        push = getattr(ctx, "pushdown", None)
        if push:
            can_left = j.kind in ("INNER", "CROSS", "LEFT")
            can_right = j.kind in ("INNER", "CROSS", "RIGHT")
            for idx, c in enumerate(push):
                if c is None:
                    continue
                if can_left and _resolvable(c, left) and _contains_column(c):
                    cc = eval_expr(c, left, ctx)
                    left = left.take(
                        np.flatnonzero(cc.values.astype(bool) & ~cc.nulls)
                    )
                    push[idx] = None
                elif can_right and _resolvable(c, right) and _contains_column(c):
                    cc = eval_expr(c, right, ctx)
                    right = right.take(
                        np.flatnonzero(cc.values.astype(bool) & ~cc.nulls)
                    )
                    push[idx] = None
        cond = j.on
        kind = j.kind
        using = j.using
        if getattr(j, "natural", False) and using is None:
            # NATURAL JOIN: shared unqualified column names of both sides
            lnames = [nm for (_, nm) in left.names if not nm.startswith("#")]
            rset = {nm for (_, nm) in right.names if not nm.startswith("#")}
            using = [nm for nm in dict.fromkeys(lnames) if nm in rset]
        if using:
            for name in using:
                eq = A.BinaryOp(
                    "=",
                    _qualified_ref(left, name),
                    _qualified_ref(right, name),
                )
                cond = eq if cond is None else A.BinaryOp("AND", cond, eq)
        if push and kind in ("INNER", "CROSS"):
            # WHERE conjuncts LINKING the two sides are join conditions,
            # not post-filters (reference optimizer join-condition
            # extraction): a comma join otherwise materializes the full
            # cross product before the filter
            combined = Batch(0)
            for b in (left, right):
                for (q, nm), c0 in zip(b.names, b.cols):
                    combined.add(q, nm, c0)
            for pi, c in enumerate(push):
                if c is None or not _contains_column(c):
                    continue
                if _resolvable(c, combined):
                    cond = c if cond is None else A.BinaryOp("AND", cond, c)
                    push[pi] = None
                    kind = "INNER"
        if kind == "CROSS" or cond is None:
            return _cross_join(left, right, None, ctx)

        equis, residual = _split_equi(cond, left, right)
        if equis:
            out = _hash_join(left, right, equis, residual, kind, ctx)
        elif kind == "INNER":
            out = _cross_join(left, right, cond, ctx)
        else:
            out = _nl_outer_join(left, right, cond, kind, ctx)
        if using:
            out = _coalesce_using(out, using, len(left.cols), kind)
        return out

    def _lateral_join(self, j: A.Join, ctx: EvalContext) -> Batch:
        """LATERAL subquery in FROM (reference parses it, parser.rs:743,
        but bails at planning, planner/select.rs:378-382 — here it runs):
        the subquery re-evaluates once per left row with that row's
        columns visible as outer bindings (the correlated-subquery
        mechanism), then the pairs assemble like a join."""
        import dataclasses

        if j.kind not in ("INNER", "CROSS", "LEFT"):
            raise SqlError(f"LATERAL does not support {j.kind} joins")
        left = self._from(j.left, ctx)
        sub = j.right
        STATS["rowwise_subqueries"] += left.n

        def run_for(orow, limit0=False):
            sel = sub.subquery
            if limit0:
                sel = dataclasses.replace(sel, limit=A.Literal(0))
            sctx = self._child_ctx(ctx, getattr(ctx, "ctes", {}))
            sctx.outer = orow
            b = self.run_select(sel, sctx)
            out = Batch(b.n)
            for (_, nm), c in zip(b.names, b.cols):
                out.add(sub.alias, nm, c)
            return out

        def with_outer(i):
            orow = left.take(np.array([i]))
            if ctx.outer is not None:       # chained correlation levels
                for (q, nm), c in zip(ctx.outer.names, ctx.outer.cols):
                    orow.add(q, nm, c)
            return orow

        n = left.n
        rights = [run_for(with_outer(i)) for i in range(n)]
        if rights:
            proto = rights[0]     # every per-row batch shares the schema
        else:
            # empty left: LIMIT-0 probe against an all-NULL left row
            # (names only; no rows evaluate), with enclosing correlation
            # bindings still visible
            nullrow = Batch(1)
            for (q, nm) in left.names:
                nullrow.add(q, nm, Col(np.array([None], object),
                                       np.array([True])))
            if ctx.outer is not None:
                for (q, nm), c in zip(ctx.outer.names, ctx.outer.cols):
                    nullrow.add(q, nm, c)
            proto = run_for(nullrow, limit0=True)

        counts = np.array([b.n for b in rights], np.int64)
        idx = np.repeat(np.arange(n), counts) if n else np.zeros(0, np.int64)
        left_rep = left.take(idx)
        combined = Batch(left_rep.n)
        for (q, nm), c in zip(left_rep.names, left_rep.cols):
            combined.add(q, nm, c)
        for ci, (q, nm) in enumerate(proto.names):
            vals = [b.cols[ci].values for b in rights if b.n]
            nls = [b.cols[ci].nulls for b in rights if b.n]
            if vals:
                if any(v.dtype != vals[0].dtype or v.ndim != vals[0].ndim
                       for v in vals):
                    vals = [v.astype(object) if v.ndim == 1 else v
                            for v in vals]
                v, nl = np.concatenate(vals), np.concatenate(nls)
            else:
                v, nl = np.zeros(0, object), np.zeros(0, bool)
            combined.add(q, nm, Col(v, nl))

        if j.on is not None:
            cm = eval_expr(j.on, combined, ctx)
            keep = np.flatnonzero(cm.values.astype(bool) & ~cm.nulls)
        else:
            keep = np.arange(combined.n)
        out = combined.take(keep)
        if j.kind == "LEFT":
            matched = np.zeros(n, bool)
            if len(keep):
                matched[idx[keep]] = True
            un = np.flatnonzero(~matched)
            if len(un):
                pad = Batch(len(un))
                padl = left.take(un)
                for (q, nm), c in zip(padl.names, padl.cols):
                    pad.add(q, nm, c)
                for (q, nm) in proto.names:
                    pad.add(q, nm, Col(np.full(len(un), None, object),
                                       np.ones(len(un), bool)))
                out = out.concat(pad)
        return out

    def _join_reordered(self, leaves, conjuncts, ctx: EvalContext) -> Batch:
        """Greedy cost-ordered INNER-join chain: start at the smallest
        relation, repeatedly join the smallest relation reachable through
        an applicable conjunct (cross-join the smallest only when nothing
        connects)."""
        batches = [self._from(leaf, ctx) for leaf in leaves]
        # consume pushed-down single-side predicates per leaf
        push = getattr(ctx, "pushdown", None)
        if push:
            for bi, b in enumerate(batches):
                for pi, c in enumerate(push):
                    if c is None:
                        continue
                    if _resolvable(c, b) and _contains_column(c):
                        cc = eval_expr(c, b, ctx)
                        batches[bi] = b = b.take(
                            np.flatnonzero(cc.values.astype(bool) & ~cc.nulls)
                        )
                        push[pi] = None
        if push:
            # WHERE conjuncts spanning leaves are join conditions for the
            # greedy order (reference join-condition extraction): comma
            # joins carry their equi-conditions in WHERE, not ON
            combined = Batch(0)
            for b in batches:
                for (q, nm), c0 in zip(b.names, b.cols):
                    combined.add(q, nm, c0)
            for pi, c in enumerate(push):
                if c is not None and _contains_column(c) \
                        and _resolvable(c, combined):
                    conjuncts.append(c)
                    push[pi] = None

        # which leaves does each conjunct need?
        def leafset(c):
            s = set()
            for i, b in enumerate(batches):
                refs: list = []
                _collect_refs(c, refs)
                for r in refs:
                    if isinstance(r, A.ColumnRef):
                        try:
                            b.resolve(r.name, r.table)
                            s.add(i)
                        except SqlError:
                            pass
            return s

        pending = [(c, leafset(c)) for c in conjuncts]
        remaining = set(range(len(batches)))
        start = min(remaining, key=lambda i: batches[i].n)
        joined = batches[start]
        in_set = {start}
        remaining.remove(start)
        while remaining:
            connected = [
                i for i in remaining
                if any(ls and ls <= in_set | {i} and i in ls
                       for _, ls in pending)
            ]
            pick = min(connected or remaining, key=lambda i: batches[i].n)
            applicable = [
                c for c, ls in pending
                if ls and ls <= in_set | {pick} and not ls <= in_set
            ]
            pending = [
                (c, ls) for c, ls in pending
                if not (ls and ls <= in_set | {pick} and not ls <= in_set)
            ]
            cond = None
            for c in applicable:
                cond = c if cond is None else A.BinaryOp("AND", cond, c)
            right = batches[pick]
            if cond is None:
                joined = _cross_join(joined, right, None, ctx)
            else:
                equis, residual = _split_equi(cond, joined, right)
                if equis:
                    joined = _hash_join(joined, right, equis, residual,
                                        "INNER", ctx)
                else:
                    joined = _cross_join(joined, right, cond, ctx)
            in_set.add(pick)
            remaining.remove(pick)
        # conjuncts that never became applicable (single-leaf conjuncts on
        # the start relation, constants) filter the final result
        for c, _ls in pending:
            cc = eval_expr(c, joined, ctx)
            joined = joined.take(
                np.flatnonzero(cc.values.astype(bool) & ~cc.nulls)
            )
        return joined

    # ------------------------------------------------------------------
    # ANN fast path
    # ------------------------------------------------------------------

    def _try_ann_path(self, sel: A.Select, ctx: EvalContext):
        """ORDER BY <vector-col> <-> <const> LIMIT k over one HNSW-indexed
        table → graph search + visibility/predicate mask + over-fetch."""
        cand = ann_candidate(sel, ctx)
        if cand is None:
            return None
        col, const, op, k, off = cand
        hook = getattr(self.db, "_ann_search", None)
        if hook is None:
            return None
        qv = eval_expr(const, Batch(1), ctx)
        vec = qv.values[0] if qv.values.ndim == 1 else qv.values[0]
        if isinstance(vec, str):
            vec = parse_vector_text(vec)
        if vec is None:
            return None
        return hook(sel, col, np.asarray(vec, np.float32), op, k + off, ctx)

    # ------------------------------------------------------------------
    # projection
    # ------------------------------------------------------------------

    def _project(self, sel: A.Select, src: Batch, ctx: EvalContext) -> Batch:
        # window functions evaluate against the filtered source
        out = Batch(src.n)
        for it in sel.items:
            expr = it.expr
            if isinstance(expr, A.Star):
                for (q, nm), c in zip(src.names, src.cols):
                    if nm.startswith("#"):
                        continue
                    if expr.table is not None and q != expr.table:
                        continue
                    out.add(q, nm, c)
                continue
            if _contains_window(expr):
                col = self._eval_window(expr, src, ctx)
            else:
                col = eval_expr(expr, src, ctx)
            out.add(None, it.alias or _output_name(expr), col)
        # keep hidden rowids for FOR UPDATE / DML RETURNING chains — one
        # per qualifier, so a FOR clause can lock EVERY joined table
        # (reference ForClause locks all tables unless OF restricts)
        for (q, nm), c in zip(src.names, src.cols):
            if nm == ROWID and all(
                not (qq == q and n == ROWID) for qq, n in out.names
            ):
                out.add(q, nm, c)
        return out

    def _eval_window(self, expr, src: Batch, ctx: EvalContext) -> Col:
        if isinstance(expr, A.FuncCall) and expr.over is not None:
            return _window_call(self, expr, src, ctx)
        raise SqlError("window function must be a top-level select item")

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------

    def _grouping_sets_agg(self, sel: A.Select, src: Batch,
                           ctx: EvalContext) -> Batch:
        """ROLLUP / CUBE / GROUPING SETS: run the grouped aggregation
        once per expanded set and concatenate. Per set, the select list
        and HAVING are rewritten — grouping(e..) folds to its bitmask
        literal, key exprs NOT in the set fold to NULL (outside
        aggregate calls) — so _aggregate itself stays unchanged."""
        import dataclasses as dc

        render = A.render_expr
        all_keys = {render(e) for e in sel.group_by}
        batches = []
        for gs in sel.grouping_sets:
            excluded = all_keys - {render(e) for e in gs}
            items = []
            for it in sel.items:
                if isinstance(it, A.Star):
                    raise SqlError("SELECT * with GROUP BY is not supported")
                ne = _rewrite_gs(it.expr, excluded)
                items.append(
                    A.SelectItem(ne, it.alias or _output_name(it.expr))
                )
            sub = dc.replace(
                sel, items=items, group_by=list(gs),
                having=(_rewrite_gs(sel.having, excluded)
                        if sel.having is not None else None),
                order_by=[], limit=None, offset=None,
                grouping_sets=None, set_op=None, ctes=[],
            )
            batches.append(self._aggregate(sub, src, ctx))
        out = batches[0]
        for b in batches[1:]:
            out = out.concat(b)
        return out

    def _aggregate(self, sel: A.Select, src: Batch, ctx: EvalContext) -> Batch:
        from turdb_tpu_torch.sql.factorize import renumber_first_occurrence, row_codes

        # GROUP BY resolves positions (GROUP BY 1) and select-list aliases
        # (GROUP BY d2) like the executors it mirrors; real source columns
        # win over aliases (SQL standard precedence)
        gexprs = []
        keys = []
        for g in sel.group_by:
            if isinstance(g, A.Literal) and isinstance(g.value, int) and \
                    not isinstance(g.value, bool):
                pos = g.value - 1
                if not (0 <= pos < len(sel.items)):
                    raise SqlError(f"GROUP BY position {g.value} out of range")
                g = sel.items[pos].expr
                if isinstance(g, A.Star):
                    raise SqlError("GROUP BY position refers to *")
            try:
                kcol = eval_expr(g, src, ctx)
            except SqlError:
                alias_expr = None
                if isinstance(g, A.ColumnRef) and g.table is None:
                    for it in sel.items:
                        if isinstance(it, A.SelectItem) and it.alias == g.name:
                            alias_expr = it.expr
                            break
                if alias_expr is None:
                    raise
                g = alias_expr
                kcol = eval_expr(g, src, ctx)
            gexprs.append(g)
            keys.append(kcol)
        n = src.n
        if keys:
            # vectorized grouping: factorize key columns to dense codes
            # (reference HashAggregate, executor.rs:1373 — C-speed here
            # via np.unique instead of a per-row hash table)
            group_of, rep = renumber_first_occurrence(row_codes(keys))
            ngroups = len(rep)
        else:
            group_of = np.zeros(n, np.int64)
            ngroups = 1
            rep = np.zeros(min(n, 1), np.int64)

        # collect aggregate calls across SELECT/HAVING/ORDER BY
        agg_nodes: list[A.FuncCall] = []

        def collect(e):
            if isinstance(e, A.FuncCall) and e.name in AGGREGATES and e.over is None:
                agg_nodes.append(e)
                return
            for ch in _children(e):
                collect(ch)

        for it in sel.items:
            if isinstance(it, A.SelectItem):
                collect(it.expr)
        if sel.having is not None:
            collect(sel.having)
        for ob in sel.order_by:
            collect(ob.expr)

        # evaluate each aggregate per group
        agg_cols: dict[str, Col] = {}
        for node in agg_nodes:
            key = A.render_expr(node) + (":d" if node.distinct else "")
            if key in agg_cols:
                continue
            agg_cols[key] = _eval_aggregate(node, src, ctx, group_of, ngroups)

        # group-key columns: one representative row per group (rep)
        post = Batch(ngroups)
        if n == 0 and ngroups == 1:
            # global aggregate over empty input: key columns are all-NULL
            for gexpr, kcol in zip(gexprs, keys):
                post.add(None, A.render_expr(gexpr), Col.const(None, 1))
            for (q, nm), c in zip(src.names, src.cols):
                post.add(q, nm, Col.const(None, 1))
        else:
            for gexpr, kcol in zip(gexprs, keys):
                post.add(
                    None, A.render_expr(gexpr),
                    Col(kcol.values[rep], kcol.nulls[rep]),
                )
            # also group-key source columns referenced by name
            for (q, nm), c in zip(src.names, src.cols):
                post.add(q, nm, Col(c.values[rep], c.nulls[rep]))
        for key, col in agg_cols.items():
            post.add(None, key, col)

        if sel.having is not None:
            hv = _eval_postagg(sel.having, post, ctx, gexprs)
            keep = np.flatnonzero(hv.values.astype(bool) & ~hv.nulls)
            post = post.take(keep)

        out = Batch(post.n)
        for it in sel.items:
            expr = it.expr
            if isinstance(expr, A.Star):
                raise SqlError("SELECT * with GROUP BY is not supported")
            col = _eval_postagg(expr, post, ctx, gexprs)
            out.add(None, it.alias or _output_name(expr), col)
        # stash post-agg batch for ORDER BY over aggregate exprs
        out._postagg = post  # type: ignore[attr-defined]
        out._group_by = gexprs  # type: ignore[attr-defined]
        return out

    # ------------------------------------------------------------------
    # ORDER BY / LIMIT
    # ------------------------------------------------------------------

    def _resolve_order_col(self, out: Batch, e, ctx: EvalContext) -> Col:
        """Resolve an ORDER BY / DISTINCT ON expression against the
        output batch: position, output alias, post-agg batch, then the
        pre-projection source."""
        # positional: ORDER BY 2
        if isinstance(e, A.Literal) and isinstance(e.value, int):
            pos = e.value - 1
            if not (0 <= pos < len(out.cols)):
                raise SqlError(f"ORDER BY position {e.value} out of range")
            return out.cols[pos]
        # output alias / name
        if isinstance(e, A.ColumnRef) and e.table is None:
            for (q, nm), c in zip(out.names, out.cols):
                if nm == e.name:
                    return c
        post = getattr(out, "_postagg", None)
        if post is not None:
            return _eval_postagg(e, post, ctx, getattr(out, "_group_by", []))
        try:
            return eval_expr(e, out, ctx)
        except SqlError:
            src = getattr(out, "_source", None)
            if src is None:
                raise SqlError(
                    "cannot resolve ORDER BY expression "
                    f"{A.render_expr(e)}"
                )
            return eval_expr(e, src, ctx)

    def _order(self, out: Batch, order_by, ctx: EvalContext, sel) -> Batch:
        keys = [
            (self._resolve_order_col(out, ob.expr, ctx),
             ob.desc, ob.nulls_last)
            for ob in order_by
        ]
        idx = _sort_indices(keys, out.n)
        res = out.take(idx)
        # propagate resolution context (same row permutation) so a later
        # DISTINCT ON can resolve source/post-agg expressions
        src = getattr(out, "_source", None)
        if src is not None and src.n == out.n:
            res._source = src.take(idx)
        post = getattr(out, "_postagg", None)
        if post is not None and post.n == out.n:
            res._postagg = post.take(idx)
            res._group_by = getattr(out, "_group_by", [])
        return res

    def _distinct_on(self, out: Batch, sel: A.Select,
                     ctx: EvalContext) -> Batch:
        """SELECT DISTINCT ON (exprs): keep the FIRST row per key in the
        post-ORDER BY order (PostgreSQL semantics; reference AST carries
        Distinct::DistinctOn, ast.rs:157, parser never emits it)."""
        from turdb_tpu_torch.sql.factorize import factorize_col, combine_codes

        cols = [self._resolve_order_col(out, e, ctx)
                for e in sel.distinct_on]
        codes = combine_codes([factorize_col(c) for c in cols])
        _, first = np.unique(codes, return_index=True)
        return out.take(np.sort(first))

    def _limit(self, out: Batch, sel: A.Select, ctx: EvalContext) -> Batch:
        off = int(_eval_scalar(sel.offset, ctx)) if sel.offset is not None else 0
        if sel.limit is not None:
            k = int(_eval_scalar(sel.limit, ctx))
            return out.take(np.arange(off, min(off + k, out.n)))
        if off:
            return out.take(np.arange(off, out.n))
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def ann_candidate(sel: A.Select, ctx: EvalContext):
    """Shared ANN-path eligibility check (executor + planner): the query
    must be `ORDER BY <vec-col> <-> <const> LIMIT k` over one table with
    no grouping. Returns (colref, const_expr, op, k, offset) or None."""
    if (
        not sel.order_by
        or len(sel.order_by) != 1
        or sel.order_by[0].desc
        or sel.limit is None
        or sel.group_by
        or sel.having is not None
        or not isinstance(sel.from_, A.TableRef)
    ):
        return None
    ob = sel.order_by[0].expr
    if not (isinstance(ob, A.BinaryOp) and ob.op in ("<->", "<#>", "<=>")):
        return None
    col, const = ob.left, ob.right
    if not isinstance(col, A.ColumnRef):
        col, const = ob.right, ob.left
    if not isinstance(col, A.ColumnRef):
        return None
    if _contains_column(const):
        return None
    try:
        k = int(_eval_scalar(sel.limit, ctx))
        off = int(_eval_scalar(sel.offset, ctx)) if sel.offset else 0
    except (TypeError, ValueError):
        return None
    return col, const, ob.op, k, off


def _eval_scalar(expr, ctx: EvalContext):
    if expr is None:
        return None
    c = eval_expr(expr, Batch(1), ctx)
    return None if c.nulls[0] else _py(c.values[0])


def _children(e):
    import dataclasses

    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, A.Expr):
            yield v
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, A.Expr):
                    yield x
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, A.Expr):
                            yield y


def _refs_cte(node, name: str) -> bool:
    """True if any unqualified TableRef in the (sub)tree names the CTE —
    decides whether a WITH RECURSIVE member actually self-references."""
    import dataclasses

    stack = [node]
    while stack:
        x = stack.pop()
        if isinstance(x, A.TableRef):
            if x.schema is None and x.name == name:
                return True
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                stack.append(getattr(x, f.name))
    return False


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


def _flatten_inner(j):
    """Flatten a maximal INNER/CROSS `on`-only join subtree into
    (leaves, conjuncts); outer/USING joins stay intact as leaves."""
    leaves, conjuncts = [], []

    def rec(node):
        if (
            isinstance(node, A.Join)
            and node.kind in ("INNER", "CROSS")
            and node.using is None
        ):
            rec(node.left)
            rec(node.right)
            if node.on is not None:
                conjuncts.extend(_split_conjuncts(node.on))
        else:
            leaves.append(node)

    rec(j)
    if any(isinstance(lf, A.SubqueryRef) and lf.lateral for lf in leaves):
        return None    # lateral leaves depend on join order: no reorder
    return (leaves, conjuncts) if len(leaves) >= 2 else None


def _collect_refs(e, out: list):
    import dataclasses

    if isinstance(e, (A.ColumnRef, A.Star)):
        out.append(e)
        return
    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, (A.Expr, A.Select)) or dataclasses.is_dataclass(v):
            _collect_refs(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if dataclasses.is_dataclass(x):
                    _collect_refs(x, out)
                elif isinstance(x, tuple):
                    for y in x:
                        if dataclasses.is_dataclass(y):
                            _collect_refs(y, out)


def _collect_needed(sel: A.Select):
    """Set of column names the query can touch, or None when pruning is
    unsafe (a bare `*`). Overapproximates by walking nested subqueries
    too (their inner names simply keep extra outer columns alive)."""
    refs: list = []
    for it in sel.items:
        _collect_refs(it, refs)
    for part in (sel.where, sel.having, sel.limit, sel.offset):
        if part is not None:
            _collect_refs(part, refs)
    for g in sel.group_by:
        _collect_refs(g, refs)
    for ob in sel.order_by:
        _collect_refs(ob.expr, refs)
    _collect_refs(sel.from_, refs) if sel.from_ is not None else None
    if sel.set_op is not None:
        sub = _collect_needed(sel.set_op[2])
        if sub is None:
            return None
        refs.extend(A.ColumnRef(nm, q) for q, nm in sub if nm != "*")
        refs.extend(A.Star(q) for q, nm in sub if nm == "*")
    out = set()
    for r in refs:
        if isinstance(r, A.Star):
            if r.table is None:
                return None  # bare *: keep everything
            out.add((r.table, "*"))
        else:
            out.add((r.table, r.name))
    return out


def _contains_aggregate(e) -> bool:
    if isinstance(e, A.FuncCall) and e.name in AGGREGATES and e.over is None:
        return True
    return any(_contains_aggregate(c) for c in _children(e))


def _contains_window(e) -> bool:
    if isinstance(e, A.FuncCall) and e.over is not None:
        return True
    return any(_contains_window(c) for c in _children(e))


def _contains_column(e) -> bool:
    if isinstance(e, (A.ColumnRef, A.Star)):
        return True
    return any(_contains_column(c) for c in _children(e))


def _output_name(e) -> str:
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.FuncCall):
        return e.name
    if isinstance(e, A.Cast):
        return _output_name(e.operand)
    return A.render_expr(e)


def _coalesce_using(out: Batch, using: list, left_ncols: int, kind: str):
    """USING/NATURAL joins expose each join column ONCE (SQL standard):
    keep the left instance (coalesced with the right for RIGHT/FULL,
    whose unmatched rows null-pad the left side), drop the right one."""
    drop = set()
    for name in using:
        li = ri = None
        for i, (_, nm) in enumerate(out.names):
            if nm != name:
                continue
            if li is None and i < left_ncols:
                li = i
            elif i >= left_ncols and ri is None:
                ri = i
        if li is None or ri is None:
            continue
        if kind in ("RIGHT", "FULL"):
            lc, rc = out.cols[li], out.cols[ri]
            vals = np.where(lc.nulls, rc.values, lc.values)
            out.cols[li] = Col(vals, lc.nulls & rc.nulls)
        drop.add(ri)
    if drop:
        out.names = [nm for i, nm in enumerate(out.names) if i not in drop]
        out.cols = [c for i, c in enumerate(out.cols) if i not in drop]
    return out


def _qualified_ref(batch: Batch, name: str) -> A.ColumnRef:
    for q, nm in batch.names:
        if nm == name:
            return A.ColumnRef(name, table=q)
    raise SqlError(f"USING column {name} not found")


def _sort_indices(keys, n: int) -> np.ndarray:
    """Stable multi-key sort. NULLS LAST default for ASC, FIRST for DESC
    (PostgreSQL)."""
    idx = np.arange(n)
    for col, desc, nulls_last in reversed(keys):
        v = col.values
        nl = nulls_last if nulls_last is not None else not desc
        if v.dtype == object or v.ndim > 1:
            keyed = []
            for i in idx:
                if col.nulls[i]:
                    keyed.append((1 if nl else -1, ""))
                else:
                    x = v[i]
                    keyed.append((0, tuple(x) if isinstance(x, (list, np.ndarray)) else x))
            order = sorted(
                range(len(idx)),
                key=lambda j: keyed[j],
                reverse=desc,
            )
            # desc reverse flips null placement; compensate
            if desc:
                nulls_first = [j for j in order if keyed[j][0] != 0]
                rest = [j for j in order if keyed[j][0] == 0]
                order = (rest + nulls_first) if nl else (nulls_first + rest)
            idx = idx[np.asarray(order, np.int64)]
        else:
            vv = v[idx].astype(np.float64 if v.dtype.kind == "f" else v.dtype)
            nn = col.nulls[idx]
            if desc:
                sortv = np.where(nn, -np.inf if nl else np.inf, vv)
                order = np.argsort(-sortv, kind="stable")
            else:
                sortv = np.where(nn, np.inf if nl else -np.inf, vv)
                order = np.argsort(sortv, kind="stable")
            idx = idx[order]
    return idx


def _visible_cols(b: Batch):
    return [c for (q, nm), c in zip(b.names, b.cols) if not nm.startswith("#")]


def _strip_hidden(b: Batch) -> Batch:
    keep = [i for i, (q, nm) in enumerate(b.names) if not nm.startswith("#")]
    if len(keep) == len(b.cols):
        return b
    return b.slice_cols(keep)


def _distinct(b: Batch) -> Batch:
    cols = _visible_cols(b)
    if not cols or b.n == 0:
        return b
    from turdb_tpu_torch.sql.factorize import renumber_first_occurrence, row_codes

    _, first = renumber_first_occurrence(row_codes(cols))
    return b.take(first)  # first-occurrence order = ascending row order


def _apply_setop(left: Batch, right: Batch, op: str, all_: bool) -> Batch:
    left, right = _strip_hidden(left), _strip_hidden(right)
    if len(left.cols) != len(right.cols):
        raise SqlError(f"{op} operands must have the same number of columns")
    if op == "UNION":
        out = left.concat(right)
        return out if all_ else _distinct(out)

    from turdb_tpu_torch.sql.factorize import joint_codes

    # set ops treat NULLs as equal (IS NOT DISTINCT semantics)
    lc, rc = joint_codes(left.cols, right.cols, null_matches=True)
    member = np.isin(lc, rc)
    keep = np.flatnonzero(member if op == "INTERSECT" else ~member)
    out = left.take(keep)
    return out if all_ else _distinct(out)


# -- joins -------------------------------------------------------------------


def _resolvable(e, batch: Batch) -> bool:
    """True if every column in e resolves within `batch`."""
    if isinstance(e, A.ColumnRef):
        try:
            batch.resolve(e.name, e.table)
            return True
        except SqlError:
            return False
    if isinstance(e, A.Star):
        return False
    kids = list(_children(e))
    return all(_resolvable(c, batch) for c in kids) if kids else True


def _split_equi(cond, left: Batch, right: Batch):
    """Split an ON condition into hash-joinable equi pairs + residual."""
    conjuncts = []

    def flat(e):
        if isinstance(e, A.BinaryOp) and e.op == "AND":
            flat(e.left)
            flat(e.right)
        else:
            conjuncts.append(e)

    flat(cond)
    equis, residual = [], []
    for c in conjuncts:
        if isinstance(c, A.BinaryOp) and c.op == "=":
            a, b = c.left, c.right
            if _resolvable(a, left) and _resolvable(b, right) and \
                    _contains_column(a) and _contains_column(b):
                equis.append((a, b))
                continue
            if _resolvable(b, left) and _resolvable(a, right) and \
                    _contains_column(a) and _contains_column(b):
                equis.append((b, a))
                continue
        residual.append(c)
    res = None
    for c in residual:
        res = c if res is None else A.BinaryOp("AND", res, c)
    return equis, res


def _merge_batches(left: Batch, right: Batch, li, ri, lnull=None, rnull=None):
    out = Batch(len(li))
    for (q, nm), c in zip(left.names, left.cols):
        vals = c.values[np.maximum(li, 0)]
        nulls = c.nulls[np.maximum(li, 0)] | (li < 0)
        out.add(q, nm, Col(vals, nulls))
    for (q, nm), c in zip(right.names, right.cols):
        vals = c.values[np.maximum(ri, 0)]
        nulls = c.nulls[np.maximum(ri, 0)] | (ri < 0)
        out.add(q, nm, Col(vals, nulls))
    return out


def _hash_join(left, right, equis, residual, kind, ctx):
    """Equi join on factorized key codes (sort + searchsorted probe —
    whole-column C kernels replacing the reference's per-row hash table,
    executor.rs:1140). Above the query memory budget it becomes a GRACE
    join: both sides partition by key code, partitions SPILL to temp
    files, and pairs join one at a time (partition_spiller.rs:116)."""
    from turdb_tpu_torch.sql.factorize import joint_codes
    from turdb_tpu_torch.sql.spill import estimate_batch_bytes

    lkeys = [eval_expr(a, left, ctx) for a, _ in equis]
    rkeys = [eval_expr(b, right, ctx) for _, b in equis]
    lcodes, rcodes = joint_codes(lkeys, rkeys)

    budget = getattr(ctx, "query_budget", None)
    bobj = getattr(ctx, "budget", None)  # MemoryBudget: hard accounting
    est = estimate_batch_bytes(left) + estimate_batch_bytes(right)
    over = bool(budget and est > budget)
    reserved = 0
    if not over and bobj is not None:
        # reserve the working set against the query pool; failure (pool
        # contended or exhausted) degrades to the spilling path instead
        # of blowing the budget (reference tests/memory_budget.rs)
        if bobj.try_reserve("query", est):
            reserved = est
        else:
            over = True
    try:
        if over and kind == "INNER" and left.n > 64 and right.n > 64:
            return _grace_join(
                left, right, lcodes, rcodes, residual, ctx,
                nparts=max(2, int(est // max(budget or est, 1)) + 1),
            )
        return _join_codes(left, right, lcodes, rcodes, residual, kind, ctx)
    finally:
        if reserved:
            bobj.release("query", reserved)


def _join_codes(left, right, lcodes, rcodes, residual, kind, ctx):
    from turdb_tpu_torch.sql.factorize import match_pairs

    li, ri = match_pairs(lcodes, rcodes)
    out = _merge_batches(left, right, li, ri)
    if residual is not None and out.n:
        c = eval_expr(residual, out, ctx)
        keep = c.values.astype(bool) & ~c.nulls
        li, ri = li[keep], ri[keep]
        out = out.take(np.flatnonzero(keep))
    lmatched = np.zeros(left.n, bool)
    rmatched = np.zeros(right.n, bool)
    lmatched[li] = True
    rmatched[ri] = True

    if kind in ("LEFT", "FULL"):
        extra = np.flatnonzero(~lmatched)
        if len(extra):
            out = out.concat(
                _merge_batches(left, right, extra, np.full(len(extra), -1))
            )
    if kind in ("RIGHT", "FULL"):
        extra = np.flatnonzero(~rmatched)
        if len(extra):
            out = out.concat(
                _merge_batches(left, right, np.full(len(extra), -1), extra)
            )
    return out


def _grace_join(left, right, lcodes, rcodes, residual, ctx, nparts):
    """Partition both sides by key code (value-based, so INT 1 and FLOAT
    1.0 land in the same partition — the representation-hash bug class is
    structurally gone), spill every partition to disk, then join pairs
    one at a time so only one pair is resident."""
    import os
    import shutil
    import tempfile

    from turdb_tpu_torch.sql.spill import SpilledBatch

    tmpdir = tempfile.mkdtemp(prefix="turdb-grace-")
    STATS["grace_joins"] += 1
    try:
        pairs = []
        for p in range(nparts):
            lsel = np.flatnonzero((lcodes >= 0) & (lcodes % nparts == p))
            rsel = np.flatnonzero((rcodes >= 0) & (rcodes % nparts == p))
            if len(lsel) == 0 or len(rsel) == 0:
                continue
            ls = SpilledBatch(left.take(lsel), tmpdir)
            rs = SpilledBatch(right.take(rsel), tmpdir)
            STATS["spill_partitions"] += 2
            STATS["spilled_bytes"] += (
                os.path.getsize(ls.path) + os.path.getsize(rs.path)
            )
            pairs.append((ls, lcodes[lsel], rs, rcodes[rsel]))
        out = None
        for lsp, lc, rsp, rc in pairs:
            sub = _join_codes(lsp.load(), rsp.load(), lc, rc,
                              residual, "INNER", ctx)
            lsp.close()
            rsp.close()
            out = sub if out is None else out.concat(sub)
        if out is None:
            out = _merge_batches(
                left, right, np.zeros(0, np.int64), np.zeros(0, np.int64)
            )
        return out
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _hashable(v):
    v = _py(v)
    if isinstance(v, (list, np.ndarray)):
        return tuple(v)
    return v


def _cross_join(left, right, cond, ctx):
    if left.n * right.n > MAX_NESTED_LOOP:
        raise SqlError("join too large for nested-loop execution")
    li = np.repeat(np.arange(left.n), right.n)
    ri = np.tile(np.arange(right.n), left.n)
    out = _merge_batches(left, right, li, ri)
    if cond is not None and out.n:
        c = eval_expr(cond, out, ctx)
        out = out.take(np.flatnonzero(c.values.astype(bool) & ~c.nulls))
    return out


def _nl_outer_join(left, right, cond, kind, ctx):
    if left.n * right.n > MAX_NESTED_LOOP:
        raise SqlError("join too large for nested-loop execution")
    li = np.repeat(np.arange(left.n), right.n)
    ri = np.tile(np.arange(right.n), left.n)
    pairs = _merge_batches(left, right, li, ri)
    c = eval_expr(cond, pairs, ctx)
    keep = c.values.astype(bool) & ~c.nulls
    li_k, ri_k = li[keep], ri[keep]
    out = pairs.take(np.flatnonzero(keep))
    lmatched = np.zeros(left.n, bool)
    rmatched = np.zeros(right.n, bool)
    lmatched[li_k] = True
    rmatched[ri_k] = True
    if kind in ("LEFT", "FULL"):
        extra = np.flatnonzero(~lmatched)
        if len(extra):
            out = out.concat(_merge_batches(left, right, extra, np.full(len(extra), -1)))
    if kind in ("RIGHT", "FULL"):
        extra = np.flatnonzero(~rmatched)
        if len(extra):
            out = out.concat(_merge_batches(left, right, np.full(len(extra), -1), extra))
    return out


# -- aggregates --------------------------------------------------------------


_VECTOR_AGGS = frozenset([
    "count", "sum", "total", "avg", "min", "max",
    "stddev", "stddev_samp", "variance", "var_samp",
    "bool_and", "bool_or",
])


def _tablesample(b: Batch, s) -> Batch:
    """TABLESAMPLE: BERNOULLI keeps each row with probability pct/100;
    SYSTEM keeps contiguous 1024-row blocks with that probability.
    REPEATABLE(seed) makes the draw deterministic."""
    rng = np.random.default_rng(s.seed)
    f = s.percent / 100.0
    if s.method == "bernoulli":
        keep = np.flatnonzero(rng.random(b.n) < f)
    else:
        blk = 1024
        nblk = -(-b.n // blk)
        hit = np.flatnonzero(rng.random(nblk) < f)
        keep = (np.concatenate([
            np.arange(i * blk, min((i + 1) * blk, b.n)) for i in hit
        ]) if len(hit) else np.empty(0, np.int64))
    return b.take(keep)


def _rewrite_gs(e, excluded: set):
    """Grouping-sets per-set AST rewrite: `grouping(a, b)` folds to its
    bitmask literal (1-bit per argument NOT in the current set, leftmost
    arg = most significant — PostgreSQL GROUPING()); any expression that
    renders equal to an EXCLUDED key folds to NULL. Aggregate-call
    bodies are left intact (sum(b) still sees real b)."""
    import dataclasses as dc

    if not dc.is_dataclass(e) or isinstance(e, type):
        return e
    if isinstance(e, A.Expr) and A.render_expr(e) in excluded:
        return A.Literal(None)
    if isinstance(e, A.FuncCall):
        if e.name == "grouping":
            mask = 0
            for a in e.args:
                mask = (mask << 1) | (1 if A.render_expr(a) in excluded
                                      else 0)
            return A.Literal(mask)
        if e.name in AGGREGATES and e.over is None:
            return e
    changed = False

    def walk(v):
        nonlocal changed
        if dc.is_dataclass(v) and not isinstance(v, type):
            nv = _rewrite_gs(v, excluded)
            if nv is not v:
                changed = True
            return nv
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, tuple):      # e.g. Case.whens (cond, result)
            return tuple(walk(x) for x in v)
        return v

    new_vals = {f.name: walk(getattr(e, f.name)) for f in dc.fields(e)}
    return dc.replace(e, **new_vals) if changed else e


def _eval_aggregate(node: A.FuncCall, src: Batch, ctx, group_of, ngroups) -> Col:
    """Segment aggregation over group codes — whole-column C kernels
    (bincount / add.at / minimum.at) instead of the reference's per-row
    accumulator pulls (executor.rs:1373)."""
    name = node.name
    if node.order_by and not node.within_group and name not in (
        "string_agg", "group_concat", "array_agg"
    ):
        raise SqlError(
            f"ORDER BY inside {name}() is only supported for "
            "string_agg / group_concat / array_agg"
        )
    n = src.n
    mask = np.ones(n, bool)
    if node.filter is not None:
        c = eval_expr(node.filter, src, ctx)
        mask = c.values.astype(bool) & ~c.nulls

    if name in ("percentile_cont", "percentile_disc", "mode"):
        return _agg_ordered_set(node, name, src, ctx, mask, group_of,
                                ngroups)

    if node.star:
        cnt = np.bincount(group_of[mask], minlength=ngroups)
        return Col(cnt.astype(np.int64))

    if not node.args:
        raise SqlError(f"{name}() needs an argument")
    arg = eval_expr(node.args[0], src, ctx)
    valid = mask & ~arg.nulls

    if node.distinct:
        # keep the first row of each distinct (group, value) pair
        from turdb_tpu_torch.sql.factorize import combine_codes, factorize_col

        pair = combine_codes([group_of, factorize_col(arg)])
        vi = np.flatnonzero(valid)
        if len(vi):
            _, first = np.unique(pair[vi], return_index=True)
            keep = np.zeros(n, bool)
            keep[vi[first]] = True
            valid = keep

    vals = arg.values
    numeric = vals.ndim == 1 and vals.dtype != object and vals.dtype.kind in "biuf"
    if name in _VECTOR_AGGS and numeric:
        return _agg_numeric(name, vals, valid, group_of, ngroups)
    return _agg_pergroup(node, name, arg, valid, group_of, ngroups, src, ctx)


def _agg_numeric(name, vals, valid, group_of, ngroups) -> Col:
    g = group_of[valid]
    v = vals[valid]
    cnt = np.bincount(g, minlength=ngroups).astype(np.int64)
    empty = cnt == 0
    if name == "count":
        return Col(cnt)
    if name in ("bool_and", "bool_or"):
        t = np.bincount(g[v.astype(bool)], minlength=ngroups)
        out = (t == cnt) if name == "bool_and" else (t > 0)
        return Col(out, empty)
    if name in ("sum", "total"):
        if v.dtype.kind in "biu":
            acc = np.zeros(ngroups, np.int64)
            np.add.at(acc, g, v.astype(np.int64))
        else:
            acc = np.zeros(ngroups, np.float64)
            np.add.at(acc, g, v.astype(np.float64))
        if name == "total":
            return Col(acc.astype(np.float64))
        return Col(acc, empty)
    if name == "avg":
        acc = np.zeros(ngroups, np.float64)
        np.add.at(acc, g, v.astype(np.float64))
        return Col(acc / np.maximum(cnt, 1), empty)
    if name in ("min", "max"):
        if v.dtype.kind == "f":
            init = np.inf if name == "min" else -np.inf
            acc = np.full(ngroups, init, np.float64)
            ufunc = np.minimum if name == "min" else np.maximum
            ufunc.at(acc, g, v.astype(np.float64))
            return Col(acc, empty)
        info = np.iinfo(np.int64)
        init = info.max if name == "min" else info.min
        acc = np.full(ngroups, init, np.int64)
        ufunc = np.minimum if name == "min" else np.maximum
        ufunc.at(acc, g, v.astype(np.int64))
        return Col(acc, empty)
    # stddev / variance (sample)
    s = np.zeros(ngroups, np.float64)
    s2 = np.zeros(ngroups, np.float64)
    fv = v.astype(np.float64)
    np.add.at(s, g, fv)
    np.add.at(s2, g, fv * fv)
    under = cnt < 2
    c = np.maximum(cnt, 2).astype(np.float64)
    var = np.maximum(s2 - s * s / c, 0.0) / (c - 1.0)
    out = np.sqrt(var) if name.startswith("stddev") else var
    return Col(out, under)


def _agg_ordered_set(node, name, src, ctx, mask, group_of, ngroups) -> Col:
    """Ordered-set aggregates: percentile_cont / percentile_disc / mode
    WITHIN GROUP (ORDER BY measure) — PostgreSQL 9.21.4 semantics."""
    if not node.within_group or not node.order_by:
        raise SqlError(f"{name}() requires WITHIN GROUP (ORDER BY ..)")
    if len(node.order_by) != 1:
        raise SqlError(f"{name}() takes exactly one ORDER BY expression")
    if name == "mode":
        if node.args:
            raise SqlError("mode() takes no direct arguments")
        frac = None
    else:
        if len(node.args) != 1:
            raise SqlError(f"{name}(fraction) takes exactly one argument")
        fc = eval_expr(node.args[0], Batch(1), ctx)
        if fc.nulls[0]:
            return Col(np.full(ngroups, None, object), np.ones(ngroups, bool))
        frac = float(fc.values[0])
        if not 0.0 <= frac <= 1.0:
            raise SqlError(f"{name}() fraction must be in [0, 1]")
    ob = node.order_by[0]
    measure = eval_expr(ob.expr, src, ctx)
    valid = mask & ~measure.nulls
    keys = [(measure, ob.desc, ob.nulls_last)]
    by_key = _sort_indices(keys, src.n)
    by_key = by_key[valid[by_key]]
    order = by_key[np.argsort(group_of[by_key], kind="stable")]
    og = group_of[order]
    bounds = np.flatnonzero(np.diff(og)) + 1
    slices = np.split(order, bounds)
    gids = og[np.concatenate([[0], bounds])] if len(order) else []
    out_v = np.empty(ngroups, object)
    out_n = np.ones(ngroups, bool)
    vals_all = measure.values
    for gid, sl in zip(gids, slices):
        xs = vals_all[sl]
        m = len(xs)
        if m == 0:
            continue
        g = int(gid)
        out_n[g] = False
        if name == "mode":
            # most frequent; ties break to the first in sort order
            best, best_c, cur, cur_c = xs[0], 0, xs[0], 0
            for x in xs:
                if x == cur:
                    cur_c += 1
                else:
                    cur, cur_c = x, 1
                if cur_c > best_c:
                    best, best_c = cur, cur_c
            out_v[g] = _py(best)
        elif name == "percentile_disc":
            # first value whose cumulative fraction >= frac
            idx = min(m - 1, max(0, int(np.ceil(frac * m)) - 1))
            out_v[g] = _py(xs[idx])
        else:   # percentile_cont: linear interpolation at frac*(m-1)
            pos = frac * (m - 1)
            lo = int(np.floor(pos))
            hi = min(lo + 1, m - 1)
            w = pos - lo
            out_v[g] = float(xs[lo]) * (1 - w) + float(xs[hi]) * w
    return _densify(Col(out_v, out_n))


def _agg_pergroup(node, name, arg: Col, valid, group_of, ngroups, src, ctx) -> Col:
    """Aggregates over object columns / list-building aggregates: one
    Python step per GROUP (sorted-slice lists), never per row."""
    if node.order_by:
        # agg(x ORDER BY keys): rows enter each group's list in key
        # order (stable group-sort of an already key-sorted permutation);
        # _eval_aggregate restricts this to order-sensitive aggregates
        keys = [
            (eval_expr(ob.expr, src, ctx), ob.desc, ob.nulls_last)
            for ob in node.order_by
        ]
        by_key = _sort_indices(keys, src.n)
        by_key = by_key[valid[by_key]]
        order = by_key[np.argsort(group_of[by_key], kind="stable")]
        vi = np.flatnonzero(valid)
    else:
        vi = np.flatnonzero(valid)
        order = vi[np.argsort(group_of[vi], kind="stable")]
    og = group_of[order]
    bounds = np.flatnonzero(np.diff(og)) + 1
    slices = np.split(order, bounds)
    gids = og[np.concatenate([[0], bounds])] if len(order) else np.zeros(0, int)
    per: list = [None] * ngroups
    vals_all = arg.values
    for gid, sl in zip(gids, slices):
        xs = vals_all[sl]
        per[int(gid)] = (
            [_py(x) for x in xs] if xs.dtype == object or xs.ndim > 1
            else xs.tolist()
        )

    sep = ","
    if name in ("string_agg", "group_concat") and len(node.args) > 1:
        sc = eval_expr(node.args[1], src, ctx)
        sep = str(sc.values[0]) if not sc.nulls[0] else ","

    out_v = np.empty(ngroups, object)
    out_n = np.zeros(ngroups, bool)
    for g in range(ngroups):
        vals = per[g]
        if name == "count":
            out_v[g] = len(vals) if vals else 0
            continue
        if name == "array_agg":
            out_v[g] = list(vals) if vals else []
            continue
        if not vals:
            if name == "total":
                out_v[g] = 0.0
            else:
                out_n[g] = True
            continue
        if name in ("sum", "total"):
            out_v[g] = sum(vals)
        elif name == "avg":
            from decimal import Decimal

            if isinstance(vals[0], Decimal):
                out_v[g] = sum(vals) / len(vals)   # exact decimal mean
            else:
                out_v[g] = sum(float(v) for v in vals) / len(vals)
        elif name == "min":
            out_v[g] = min(vals)
        elif name == "max":
            out_v[g] = max(vals)
        elif name in ("stddev", "stddev_samp", "variance", "var_samp"):
            if len(vals) < 2:
                out_n[g] = True
            else:
                a = np.asarray([float(v) for v in vals])
                var = a.var(ddof=1)
                out_v[g] = (
                    float(np.sqrt(var)) if name.startswith("stddev") else float(var)
                )
        elif name in ("string_agg", "group_concat"):
            out_v[g] = sep.join(str(v) for v in vals)
        elif name == "bool_and":
            out_v[g] = all(bool(v) for v in vals)
        elif name == "bool_or":
            out_v[g] = any(bool(v) for v in vals)
        else:
            raise SqlError(f"unknown aggregate {name}")
    return _densify(Col(out_v, out_n))


def _eval_postagg(e, post: Batch, ctx, group_by) -> Col:
    """Evaluate a post-aggregation expression: aggregate calls and
    group-key expressions resolve to columns of the post-agg batch."""
    if isinstance(e, A.FuncCall) and e.name in AGGREGATES and e.over is None:
        key = A.render_expr(e) + (":d" if e.distinct else "")
        for (q, nm), c in zip(post.names, post.cols):
            if nm == key:
                return c
        raise SqlError(f"aggregate {key} not computed")
    rendered = A.render_expr(e)
    for g in group_by:
        if A.render_expr(g) == rendered:
            for (q, nm), c in zip(post.names, post.cols):
                if nm == rendered:
                    return c
    if isinstance(e, A.ColumnRef):
        return post.resolve(e.name, e.table)
    if _contains_aggregate(e):
        # rebuild node by node
        import dataclasses

        def rebuild(x):
            if isinstance(x, A.FuncCall) and x.name in AGGREGATES and x.over is None:
                return ("col", A.render_expr(x) + (":d" if x.distinct else ""))
            return None

        return _eval_mixed(e, post, ctx, group_by)
    return eval_expr(e, post, ctx)


def _eval_mixed(e, post: Batch, ctx, group_by) -> Col:
    """Expression mixing aggregates and scalars: recursively substitute."""
    if isinstance(e, A.FuncCall) and e.name in AGGREGATES and e.over is None:
        return _eval_postagg(e, post, ctx, group_by)
    if isinstance(e, A.BinaryOp):
        import copy

        a = _eval_mixed(e.left, post, ctx, group_by)
        b = _eval_mixed(e.right, post, ctx, group_by)
        from turdb_tpu_torch.sql.expr import (
            _binary_numeric,
            _compare,
            _kleene_and,
            _kleene_or,
        )

        if e.op in ("+", "-", "*", "/", "%"):
            return _binary_numeric(e.op, a, b)
        if e.op in ("=", "<>", "<", "<=", ">", ">="):
            return _compare(e.op, a, b)
        if e.op == "AND":
            return _kleene_and(a, b)
        if e.op == "OR":
            return _kleene_or(a, b)
        raise SqlError(f"unsupported post-aggregate operator {e.op}")
    if isinstance(e, A.UnaryOp):
        v = _eval_mixed(e.operand, post, ctx, group_by)
        if e.op == "NOT":
            return Col(~v.values.astype(bool), v.nulls)
        if e.op == "-":
            from turdb_tpu_torch.sql.expr import _numeric

            return Col(-_numeric(v), v.nulls)
        return v
    return eval_expr(e, post, ctx)


# -- window functions --------------------------------------------------------


def _window_call(engine, fc: A.FuncCall, src: Batch, ctx) -> Col:
    """Vectorized window evaluation: ONE global (partition, order-key)
    sort, then run-segmented numpy kernels — no per-row eval_expr (the
    round-2 per-row Python loops crawled on large partitions).

    Reference windows (logical.rs:172-183): row_number/rank/dense_rank/
    ntile/lag/lead + aggregate-over-window. Aggregates with ORDER BY use
    the SQL-standard default frame (RANGE UNBOUNDED PRECEDING..CURRENT
    ROW, peers included) for count/sum/avg/min/max; other aggregates
    evaluate over the whole partition.
    """
    n = src.n
    spec = fc.over
    if isinstance(spec, str):
        raise SqlError(f"no such window: {spec}")
    name = fc.name
    if spec.partition_by:
        from turdb_tpu_torch.sql.factorize import renumber_first_occurrence, row_codes

        pk = [eval_expr(e, src, ctx) for e in spec.partition_by]
        group_of, _ = renumber_first_occurrence(row_codes(pk))
        group_of = np.asarray(group_of, np.int64)
    else:
        group_of = np.zeros(n, np.int64)

    keys = []
    if spec.order_by:
        keys = [
            (eval_expr(ob.expr, src, ctx), ob.desc, ob.nulls_last)
            for ob in spec.order_by
        ]
        korder = _sort_indices(keys, n)
    else:
        korder = np.arange(n)
    # partition-major, key-ordered (stable on top of the key sort)
    ordered = korder[np.argsort(group_of[korder], kind="stable")]
    og = group_of[ordered]
    pos = np.arange(n)
    new_part = np.zeros(n, bool)
    if n:
        new_part[0] = True
        new_part[1:] = og[1:] != og[:-1]
    start = np.maximum.accumulate(np.where(new_part, pos, 0))
    rank_in = pos - start                    # 0-based row index in partition

    if name == "row_number":
        out = np.zeros(n, np.int64)
        out[ordered] = rank_in + 1
        return Col(out)

    if name in ("rank", "dense_rank", "percent_rank", "cume_dist") or (
        spec.order_by
        and (name in AGGREGATES
             or name in ("first_value", "last_value", "nth_value"))
    ):
        # peer detection on the evaluated ORDER BY columns (sorted order)
        same = np.ones(n, bool)
        if n:
            same[0] = False
        a, b = ordered[1:], ordered[:-1]
        for col, _, _ in keys:
            v, nl = col.values, col.nulls
            if n > 1:
                if v.dtype == object or v.ndim > 1:
                    eq = np.fromiter(
                        (_hashable(x) == _hashable(y)
                         for x, y in zip(v[a], v[b])),
                        bool, count=n - 1,
                    )
                else:
                    with np.errstate(invalid="ignore"):
                        eq = v[a] == v[b]
            else:
                eq = np.zeros(0, bool)
            same[1:] &= (eq & ~nl[a] & ~nl[b]) | (nl[a] & nl[b])
        new_key = ~same | new_part

    if name == "rank":
        out = np.zeros(n, np.int64)
        key_start = np.maximum.accumulate(np.where(new_key, pos, 0))
        out[ordered] = key_start - start + 1
        return Col(out)
    if name == "dense_rank":
        out = np.zeros(n, np.int64)
        dr = np.cumsum(new_key)
        out[ordered] = dr - dr[start] + 1
        return Col(out)

    if name in ("percent_rank", "cume_dist"):
        # percent_rank = (rank-1)/(size-1); cume_dist = peers≤current/size
        starts_idx = np.flatnonzero(new_part)
        sizes = np.diff(np.append(starts_idx, n))
        size_row = np.repeat(sizes, sizes) if n else np.zeros(0, np.int64)
        out = np.zeros(n, np.float64)
        if name == "percent_rank":
            key_start = np.maximum.accumulate(np.where(new_key, pos, 0))
            rk = key_start - start                       # rank - 1
            out[ordered] = np.where(
                size_row > 1, rk / np.maximum(size_row - 1, 1), 0.0
            )
        else:
            run_id = np.cumsum(new_key) - 1 if n else np.zeros(0, np.int64)
            nruns = int(run_id[-1]) + 1 if n else 0
            run_end = np.zeros(max(nruns, 1), np.int64)
            np.maximum.at(run_end, run_id, pos)
            out[ordered] = (run_end[run_id] - start + 1) / size_row
        return Col(out)

    if name == "ntile":
        if not fc.args:
            raise SqlError("ntile requires a bucket count")
        nb = int(_eval_scalar(fc.args[0], ctx))
        if nb <= 0:
            raise SqlError("ntile bucket count must be positive")
        starts_idx = np.flatnonzero(new_part)
        sizes = np.diff(np.append(starts_idx, n))
        size_row = np.repeat(sizes, sizes) if n else np.zeros(0, np.int64)
        q, r = np.divmod(size_row, nb)
        cut = r * (q + 1)                    # rows covered by q+1-sized buckets
        bucket = np.where(
            rank_in < cut,
            rank_in // np.maximum(q + 1, 1),
            r + (rank_in - cut) // np.maximum(q, 1),
        ) + 1
        out = np.zeros(n, np.int64)
        out[ordered] = bucket
        return Col(out)

    if name in ("lag", "lead"):
        arg = eval_expr(fc.args[0], src, ctx)
        off = int(_eval_scalar(fc.args[1], ctx)) if len(fc.args) > 1 else 1
        default = (
            _eval_scalar(fc.args[2], ctx) if len(fc.args) > 2 else None
        )
        shift = off if name == "lead" else -off
        j2 = pos + shift
        valid = (j2 >= 0) & (j2 < n) if n else np.zeros(0, bool)
        j2c = np.clip(j2, 0, max(n - 1, 0))
        valid &= og[j2c] == og               # stay inside the partition
        out_f = np.empty(n, object)
        out_fn = np.ones(n, bool)
        if default is not None:
            out_f[:] = default
            out_fn[:] = False
        tgt = ordered[valid]
        sr = ordered[j2c[valid]]
        if len(tgt):
            if arg.values.ndim > 1:
                for t, s in zip(tgt, sr):
                    out_f[t] = arg.values[s]
            else:
                out_f[tgt] = arg.values[sr]
            out_fn[tgt] = arg.nulls[sr]
        return _densify(Col(out_f, out_fn))

    if name in ("first_value", "last_value", "nth_value"):
        # value window functions (SQLite/PostgreSQL surface; the
        # reference's window set stops at logical.rs:172-183): gather the
        # arg at the frame's first/last/nth sorted position
        if not fc.args:
            raise SqlError(f"{name} requires an argument")
        arg = eval_expr(fc.args[0], src, ctx)
        frame = getattr(spec, "frame", None)
        starts_idx = np.flatnonzero(new_part)
        sizes = np.diff(np.append(starts_idx, n))
        end = (np.repeat(starts_idx + sizes, sizes) - 1 if n
               else np.zeros(0, np.int64))
        nk = new_key if spec.order_by else None
        a, b = _frame_bounds(frame, spec, keys, ordered, nk, new_part,
                             pos, start, end, n)
        exc = frame[3] if frame is not None else None
        if name == "nth_value":
            if len(fc.args) < 2:
                raise SqlError("nth_value requires a position argument")
            nth = int(_eval_scalar(fc.args[1], ctx))
            if nth <= 0:
                raise SqlError("nth_value position must be positive")
        if exc is None:
            valid = a <= b
            if name == "nth_value":
                idx = a + nth - 1
                valid &= idx <= b
            else:
                idx = a if name == "first_value" else b
        else:
            # frame minus the excluded run: seg1=[a, xi-1], optional
            # current row (TIES), seg2=[yi+1, b] — all position math
            x, y, keepc = _frame_exclusion(exc, spec, nk, new_part, pos,
                                           start, end, n)
            xi, yi = np.maximum(a, x), np.minimum(b, y)
            no_ex = xi > yi
            len1 = np.where(no_ex, b - a + 1, xi - a)
            cur_in = (np.full(n, keepc) & ~no_ex & (a <= pos)
                      & (pos <= b)).astype(np.int64)
            len2 = np.where(no_ex, 0, b - yi)
            total = len1 + cur_in + len2
            k = (np.zeros(n, np.int64) if name == "first_value"
                 else total - 1 if name == "last_value"
                 else np.full(n, nth - 1))
            valid = (a <= b) & (k >= 0) & (k < total)
            idx = np.where(
                k < len1, a + k,
                np.where(k < len1 + cur_in, pos, yi + 1 + k - len1 - cur_in),
            )
        out_f = np.empty(n, object)
        out_fn = np.ones(n, bool)
        if n:
            src_rows = ordered[np.clip(idx, 0, n - 1)]
            vsel = np.flatnonzero(valid)
            if arg.values.ndim > 1:
                for i in vsel:
                    out_f[ordered[i]] = arg.values[src_rows[i]]
            else:
                out_f[ordered[vsel]] = arg.values[src_rows[vsel]]
            out_fn[ordered[vsel]] = arg.nulls[src_rows[vsel]]
        return _densify(Col(out_f, out_fn))

    if name in AGGREGATES:
        frame = getattr(spec, "frame", None)
        framable = name in ("count", "sum", "avg", "min", "max")
        if frame is not None and framable:
            mode, lo, hi, exc = frame
            # fast paths (no exclusion): ROWS prefix kernels, RANGE
            # default frame as running aggregate, whole-partition frames
            # through the grouped path below. Everything else — GROUPS,
            # RANGE offsets/peer bounds, any EXCLUDE — goes through the
            # generic bounds kernel. (The reference parses no frames at
            # all, parser.rs:1419.)
            whole = mode == "RANGE" and (
                (lo, hi) == ("up", "uf")
                or (not spec.order_by
                    and lo in ("up", 0) and hi in (0, "uf"))
            )
            if exc is None and mode == "ROWS":
                return _frame_aggregate(
                    fc, src, ctx, ordered, new_part, pos, start, lo, hi
                )
            if exc is None and mode == "RANGE" and (lo, hi) == ("up", 0) \
                    and spec.order_by:
                return _running_aggregate(
                    fc, src, ctx, ordered, og, new_part, new_key, pos,
                    start,
                )
            if not (whole and exc is None):
                starts_idx = np.flatnonzero(new_part)
                sizes = np.diff(np.append(starts_idx, n))
                end = (np.repeat(starts_idx + sizes, sizes) - 1 if n
                       else np.zeros(0, np.int64))
                nk = new_key if spec.order_by else None
                a, b = _frame_bounds(frame, spec, keys, ordered, nk,
                                     new_part, pos, start, end, n)
                excl = (_frame_exclusion(exc, spec, nk, new_part, pos,
                                         start, end, n)
                        if exc is not None else None)
                return _bounds_frame_aggregate(fc, src, ctx, ordered,
                                               a, b, excl)
            # whole partition, no exclusion: grouped path below
        elif spec.order_by and framable:
            return _running_aggregate(
                fc, src, ctx, ordered, og, new_part, new_key, pos, start
            )
        ngroups = int(group_of.max()) + 1 if n else 0
        gcol = _eval_aggregate(fc, src, ctx, group_of, max(ngroups, 1))
        out_f = np.empty(n, object)
        out_fn = np.ones(n, bool)
        if n:
            gv = gcol.values
            if gv.ndim > 1:
                for i in range(n):
                    out_f[i] = gv[group_of[i]]
            else:
                out_f[:] = gv[group_of]
            out_fn[:] = gcol.nulls[group_of]
        return _densify(Col(out_f, out_fn))

    raise SqlError(f"unknown window function {name}")


def _sparse_minmax(mv, a, b, op):
    """min/max over arbitrary index ranges [a, b] (vectorized sparse
    table: O(n log L) build for L = the largest queried range, O(1) per
    query). Callers guarantee a <= b."""
    n = len(mv)
    length = b - a + 1
    kq = np.floor(np.log2(np.maximum(length, 1))).astype(np.int64)
    kmax = int(kq.max()) if len(kq) else 0
    st = [mv]
    for k in range(1, kmax + 1):
        prev, half = st[-1], 1 << (k - 1)
        lim = max(n - (1 << k) + 1, 0)
        st.append(op(prev[:lim], prev[half:half + lim]))
    res = np.empty(len(a), mv.dtype)
    for kk in range(len(st)):
        m = kq == kk
        if m.any():
            res[m] = op(st[kk][a[m]], st[kk][b[m] - (1 << kk) + 1])
    return res


def _range_offset_bounds(keys, ordered, new_part, n, lo, hi):
    """Frame bounds (global sorted positions a..b per row) for RANGE with
    numeric offsets: the frame of a row with order-key v is every
    partition row whose key lies in [v+lo, v+hi] (SQLite window-frame
    semantics: exactly one numeric ORDER BY key; NULL-key rows frame
    their NULL peer group; UNBOUNDED sides span the whole partition)."""
    if len(keys) != 1:
        raise SqlError(
            "RANGE with offset requires exactly one ORDER BY expression"
        )
    kcol, desc, _ = keys[0]
    kn = kcol.nulls
    kv = kcol.values
    if kv.dtype == object:
        arr = np.zeros(n, np.float64)
        for i in np.flatnonzero(~kn):
            try:
                arr[i] = float(kv[i])
            except (TypeError, ValueError):
                raise SqlError(
                    "RANGE with offset requires a numeric ORDER BY key"
                )
    elif kv.dtype.kind in "iufb":
        arr = kv.astype(np.float64)
    else:
        raise SqlError("RANGE with offset requires a numeric ORDER BY key")
    sk = arr[ordered]
    if desc:
        sk = -sk            # DESC: x PRECEDING = larger values, negate
    snull = kn[ordered]

    starts_idx = np.flatnonzero(new_part)
    ends_idx = np.append(starts_idx[1:], n)
    a = np.zeros(n, np.int64)
    b = np.full(n, -1, np.int64)        # default: empty frame
    for s, e in zip(starts_idx, ends_idx):
        seg, segn = sk[s:e], snull[s:e]
        nn = np.flatnonzero(~segn)
        nz0, nz1 = (nn[0], nn[-1] + 1) if len(nn) else (0, 0)
        if nz1 > nz0:                    # non-null rows: value-range scan
            vrun = seg[nz0:nz1]
            # float boundaries follow SQLite: the positive offset is
            # ADDED to whichever side keeps the arithmetic an addition
            # (peer + X >= cur for X PRECEDING, never cur - X — the two
            # roundings differ at representable edges, e.g.
            # 215.35 + 100 == 315.35 but 315.35 - 100 > 215.35)
            if lo == "up":
                ai = np.zeros(nz1 - nz0, np.int64)       # partition start
            elif lo < 0:                 # X PRECEDING: peer + X >= cur
                ai = nz0 + np.searchsorted(vrun + (-lo), vrun, side="left")
            else:                        # X FOLLOWING: peer >= cur + X
                ai = nz0 + np.searchsorted(vrun, vrun + lo, side="left")
            if hi == "uf":
                bi = np.full(nz1 - nz0, e - s - 1, np.int64)
            elif hi < 0:                 # Y PRECEDING: peer + Y <= cur
                bi = nz0 + np.searchsorted(
                    vrun + (-hi), vrun, side="right"
                ) - 1
            else:                        # Y FOLLOWING: peer <= cur + Y
                bi = nz0 + np.searchsorted(vrun, vrun + hi, side="right") - 1
            a[s + nz0:s + nz1] = s + ai
            b[s + nz0:s + nz1] = s + bi
        # NULL-key rows: peers are the NULL run (clamped by UNBOUNDED)
        for r0, r1 in ((0, nz0), (nz1, e - s)):
            if r1 > r0:
                a[s + r0:s + r1] = s if lo == "up" else s + r0
                b[s + r0:s + r1] = e - 1 if hi == "uf" else s + r1 - 1
    return a, b


def _peer_runs(new_key, pos, n):
    """(run_start, run_end) global positions of each row's peer group."""
    run_id = np.cumsum(new_key) - 1 if n else np.zeros(0, np.int64)
    nruns = int(run_id[-1]) + 1 if n else 0
    run_end = np.zeros(max(nruns, 1), np.int64)
    if n:
        np.maximum.at(run_end, run_id, pos)
    key_start = np.maximum.accumulate(np.where(new_key, pos, 0)) if n \
        else pos
    return key_start, (run_end[run_id] if n else pos)


def _frame_bounds(frame, spec, keys, ordered, new_key, new_part, pos,
                  start, end, n):
    """(a, b) per-row frame bounds (global sorted positions) for ANY
    frame spec, including the default frame. new_key may be None when
    there is no ORDER BY (peer structure is then the whole partition)."""
    if frame is None:
        if spec.order_by:            # default: RANGE UP..CURRENT (peers)
            _, pe = _peer_runs(new_key, pos, n)
            return start.copy(), pe
        return start.copy(), end
    mode, lo, hi = frame[0], frame[1], frame[2]
    if mode == "ROWS":
        LO = -n - 1 if lo == "up" else int(lo)
        HI = n + 1 if hi == "uf" else int(hi)
        return np.maximum(pos + LO, start), np.minimum(pos + HI, end)
    if mode == "GROUPS":
        if not spec.order_by:
            raise SqlError("GROUPS frame requires ORDER BY")
        return _groups_bounds(new_key, new_part, pos, start, n, lo, hi)
    # RANGE
    if (lo, hi) == ("up", "uf"):
        return start.copy(), end
    if not spec.order_by:
        if lo in ("up", 0) and hi in (0, "uf"):
            # all rows are peers: CURRENT-ROW-bounded frames span the
            # whole partition
            return start.copy(), end
        raise SqlError("RANGE with offset requires ORDER BY")
    if lo in ("up", 0) and hi in (0, "uf"):
        # CURRENT ROW bounds = peer-group edges (any key type)
        ps, pe = _peer_runs(new_key, pos, n)
        return (start.copy() if lo == "up" else ps,
                end if hi == "uf" else pe)
    return _range_offset_bounds(keys, ordered, new_part, n, lo, hi)


def _frame_exclusion(exc, spec, new_key, new_part, pos, start, end, n):
    """(x, y, keep_current) — the excluded position run per row for
    EXCLUDE CURRENT ROW / GROUP / TIES (TIES keeps the current row)."""
    if exc == "CURRENT":
        return pos, pos, False
    if spec.order_by:
        x, y = _peer_runs(new_key, pos, n)
    else:
        x, y = start, end                # no ORDER BY: all rows are peers
    return x, y, exc == "TIES"


def _groups_bounds(new_key, new_part, pos, start, n, lo, hi):
    """Frame bounds for GROUPS mode: offsets count peer groups (runs of
    equal order keys) instead of rows or key distances."""
    dr = np.cumsum(new_key)            # 1-based global group id
    gid = dr - 1
    ngroups = int(dr[-1]) if n else 0
    g_start = np.full(max(ngroups, 1), n, np.int64)
    g_end = np.zeros(max(ngroups, 1), np.int64)
    if n:
        np.minimum.at(g_start, gid, pos)
        np.maximum.at(g_end, gid, pos)
    starts_idx = np.flatnonzero(new_part)
    sizes = np.diff(np.append(starts_idx, n))
    end = (np.repeat(starts_idx + sizes, sizes) - 1 if n
           else np.zeros(0, np.int64))
    first_g, last_g = gid[start] if n else gid, gid[end] if n else gid
    if lo == "up":
        a = start.copy()
    else:
        tl = gid + int(lo)
        a = np.where(
            tl <= first_g, start,
            np.where(tl > last_g, end + 1,
                     g_start[np.clip(tl, 0, max(ngroups - 1, 0))]),
        )
    if hi == "uf":
        b = end.copy()
    else:
        th = gid + int(hi)
        b = np.where(
            th >= last_g, end,
            np.where(th < first_g, start - 1,
                     g_end[np.clip(th, 0, max(ngroups - 1, 0))]),
        )
    return a, b


def _agg_prep(fc, src, ctx):
    """Evaluate a frame aggregate's argument to (float values, nulls,
    is_int) — shared by the ROWS and bounds kernels."""
    n = src.n
    star = bool(fc.args) and isinstance(fc.args[0], A.Star)
    is_int = False
    if star or not fc.args:
        return np.ones(n, np.float64), np.zeros(n, bool), False
    c = eval_expr(fc.args[0], src, ctx)
    nulls = c.nulls.copy()
    if c.values.dtype == object:
        vals = np.zeros(n, np.float64)
        for i in np.flatnonzero(~nulls):
            try:
                vals[i] = float(c.values[i])
            except (TypeError, ValueError):
                raise SqlError(
                    f"{fc.name}() over non-numeric value in a frame"
                )
    else:
        is_int = c.values.dtype.kind in "iub"
        vals = np.where(nulls, 0.0, c.values.astype(np.float64))
    return vals, nulls, is_int


def _bounds_frame_aggregate(fc, src, ctx, ordered, a, b, excl=None):
    """Aggregate over arbitrary per-row frame bounds [a, b] (global
    sorted positions): prefix-sum kernels for count/sum/avg, sparse
    table for min/max. Serves the RANGE-offset, RANGE-peer, GROUPS and
    EXCLUDE modes; excl = (x, y, keep_current) subtracts the excluded
    run [x, y] (adding the current row back for TIES)."""
    n = src.n
    name = fc.name
    vals, nulls, is_int = _agg_prep(fc, src, ctx)
    sv = vals[ordered]
    sn = nulls[ordered]
    w = np.where(sn, 0.0, sv)

    empty = a > b
    csum = np.concatenate([[0.0], np.cumsum(w)])
    ccnt = np.concatenate([[0], np.cumsum((~sn).astype(np.int64))])

    def seg_sum_cnt(lo_arr, hi_arr):
        seg_empty = lo_arr > hi_arr
        lc = np.clip(np.where(seg_empty, 0, lo_arr), 0, n)
        hc = np.clip(np.where(seg_empty, -1, hi_arr) + 1, 0, n)
        return csum[hc] - csum[lc], ccnt[hc] - ccnt[lc]

    fsum, fcnt = seg_sum_cnt(np.where(empty, 1, a), np.where(empty, 0, b))
    pos = np.arange(n)
    if excl is not None:
        x, y, keepc = excl
        xi, yi = np.maximum(a, x), np.minimum(b, y)
        esum, ecnt = seg_sum_cnt(xi, yi)
        fsum -= esum
        fcnt -= ecnt
        cur_in = (np.full(n, keepc) & (xi <= yi) & (a <= pos)
                  & (pos <= b) & ~sn)
        fsum += np.where(cur_in, w, 0.0)
        fcnt += cur_in.astype(np.int64)

    out_f = np.empty(n, object)
    out_fn = np.ones(n, bool)
    if name == "count":
        out_f[ordered] = np.where(empty, 0, fcnt)
        out_fn[ordered] = False
    elif name == "sum":
        out_f[ordered] = fsum.astype(np.int64) if is_int else fsum
        out_fn[ordered] = empty | (fcnt == 0)
    elif name == "avg":
        out_f[ordered] = fsum / np.maximum(fcnt, 1)
        out_fn[ordered] = empty | (fcnt == 0)
    else:                                # min / max
        ident = np.inf if name == "min" else -np.inf
        op = np.minimum if name == "min" else np.maximum
        mv = np.where(sn, ident, sv)

        def seg_minmax(lo_arr, hi_arr):
            seg_empty = (lo_arr > hi_arr) | (n == 0)
            la = np.clip(lo_arr, 0, max(n - 1, 0))
            ha = np.clip(hi_arr, 0, max(n - 1, 0))
            r = _sparse_minmax(mv, la, ha, op) if n else mv
            return np.where(seg_empty, ident, r)

        if excl is None:
            res = seg_minmax(a, b)
        else:
            left = seg_minmax(a, xi - 1)
            right = seg_minmax(yi + 1, b)
            res = op(left, right)
            res = np.where(cur_in, op(res, mv), res)
            # exclusion may not intersect: fall back to the whole frame
            res = np.where(xi > yi, seg_minmax(a, b), res)
        bad = empty | (fcnt == 0) | ~np.isfinite(res)
        res = np.where(bad, 0.0, res)
        out_f[ordered] = res.astype(np.int64) if is_int else res
        out_fn[ordered] = bad
    return _densify(Col(out_f, out_fn))


def _frame_aggregate(fc, src, ctx, ordered, new_part, pos, start, lo, hi):
    """ROWS frame aggregate (ROWS BETWEEN lo AND hi, bounds in rows,
    clipped to the partition): count/sum/avg via prefix differences;
    min/max via directional accumulates (one unbounded side) or a
    sliding window (both sides finite)."""
    n = src.n
    name = fc.name
    vals, nulls, is_int = _agg_prep(fc, src, ctx)
    sv = vals[ordered]
    sn = nulls[ordered]
    w = np.where(sn, 0.0, sv)

    starts_idx = np.flatnonzero(new_part)
    sizes = np.diff(np.append(starts_idx, n))
    end = (np.repeat(starts_idx + sizes, sizes) - 1 if n
           else np.zeros(0, np.int64))
    LO = -n - 1 if lo == "up" else int(lo)
    HI = n + 1 if hi == "uf" else int(hi)
    a = np.maximum(pos + LO, start)
    b = np.minimum(pos + HI, end)
    empty = a > b

    csum = np.concatenate([[0.0], np.cumsum(w)])
    ccnt = np.concatenate([[0], np.cumsum((~sn).astype(np.int64))])
    ac = np.clip(np.where(empty, 0, a), 0, n)
    bc = np.clip(np.where(empty, -1, b) + 1, 0, n)
    fsum = csum[bc] - csum[ac]
    fcnt = ccnt[bc] - ccnt[ac]

    out_f = np.empty(n, object)
    out_fn = np.ones(n, bool)
    if name == "count":
        out_f[ordered] = np.where(empty, 0, fcnt)
        out_fn[ordered] = False
        return _densify(Col(out_f, out_fn))
    if name == "sum":
        out_f[ordered] = fsum.astype(np.int64) if is_int else fsum
        out_fn[ordered] = empty | (fcnt == 0)
        return _densify(Col(out_f, out_fn))
    if name == "avg":
        out_f[ordered] = fsum / np.maximum(fcnt, 1)
        out_fn[ordered] = empty | (fcnt == 0)
        return _densify(Col(out_f, out_fn))

    ident = np.inf if name == "min" else -np.inf
    op = np.minimum if name == "min" else np.maximum
    mv = np.where(sn, ident, sv)
    res = np.full(n, ident, np.float64)
    for k, s in enumerate(starts_idx):
        e = s + sizes[k]
        seg = mv[s:e]
        m = len(seg)
        ix = np.arange(m)
        if lo == "up" and hi == "uf":
            res[s:e] = op.reduce(seg) if m else ident
        elif lo == "up":
            acc = op.accumulate(seg)
            j = np.clip(ix + HI, 0, m - 1)
            res[s:e] = np.where(ix + HI < 0, ident, acc[j])
        elif hi == "uf":
            racc = op.accumulate(seg[::-1])[::-1]
            j = np.clip(ix + LO, 0, m - 1)
            res[s:e] = np.where(ix + LO > m - 1, ident, racc[j])
        else:
            wlen = HI - LO + 1
            if wlen <= 0 or m == 0:
                continue
            padl, padr = max(0, -LO), max(0, HI)
            padded = np.concatenate(
                [np.full(padl, ident), seg, np.full(padr, ident)]
            )
            if len(padded) < wlen:
                padded = np.concatenate(
                    [padded, np.full(wlen - len(padded), ident)]
                )
            from numpy.lib.stride_tricks import sliding_window_view

            swv = sliding_window_view(padded, wlen)
            sw_start = ix + LO + padl
            ok = (sw_start >= 0) & (sw_start < len(swv))
            j = np.clip(sw_start, 0, len(swv) - 1)
            r = op.reduce(swv[j], axis=1)
            res[s:e] = np.where(ok, r, ident)
    isect = empty | (fcnt == 0) | ~np.isfinite(res)
    res = np.where(isect, 0.0, res)
    out_f[ordered] = res.astype(np.int64) if is_int else res
    out_fn[ordered] = isect
    return _densify(Col(out_f, out_fn))


def _running_aggregate(fc, src, ctx, ordered, og, new_part, new_key, pos,
                       start):
    """SQL-standard default frame (RANGE UNBOUNDED PRECEDING..CURRENT ROW):
    cumulative aggregate in partition-major sorted order, with every row
    taking the value at the END of its peer group. Vectorized: cumsum
    with per-partition baseline subtraction; min/max accumulate per
    partition segment (numpy accumulate has no reset, so those iterate
    over partition SLICES — still vectorized within each)."""
    n = src.n
    name = fc.name
    star = bool(fc.args) and isinstance(fc.args[0], A.Star)
    is_int = False
    if star or not fc.args:
        vals = np.ones(n, np.float64)
        nulls = np.zeros(n, bool)
    else:
        c = eval_expr(fc.args[0], src, ctx)
        nulls = c.nulls.copy()
        if c.values.dtype == object:
            vals = np.zeros(n, np.float64)
            ok = ~nulls
            for i in np.flatnonzero(ok):
                try:
                    vals[i] = float(c.values[i])
                except (TypeError, ValueError):
                    raise SqlError(f"{name}() over non-numeric value")
        else:
            is_int = c.values.dtype.kind in "iub"
            vals = np.where(nulls, 0.0, c.values.astype(np.float64))
    sv = vals[ordered]
    sn = nulls[ordered]
    w = np.where(sn, 0.0, sv)
    cnt1 = (~sn).astype(np.int64)

    # counts: global cumsum minus per-partition baseline (integers, exact)
    ccnt = np.cumsum(cnt1)
    base_cnt = np.where(start > 0, ccnt[np.maximum(start - 1, 0)], 0)
    run_cnt = ccnt - base_cnt
    # float sums: cumsum PER PARTITION SLICE, not global-minus-baseline —
    # the subtraction trick leaves ~1e-11 cancellation residue that shows
    # up against engines that sum serially (found by differential fuzz).
    # With MANY tiny partitions the python slice loop dominates (9s at 1M
    # single-row partitions); there the baseline trick's residue is the
    # right trade (well under any comparator tolerance)
    starts_idx = np.flatnonzero(new_part)
    if len(starts_idx) > max(n // 64, 16):
        csum = np.cumsum(w)
        base = np.where(start > 0, csum[np.maximum(start - 1, 0)], 0.0)
        run_sum = csum - base
    else:
        run_sum = np.empty(n, np.float64)
        for i, s in enumerate(starts_idx):
            e = starts_idx[i + 1] if i + 1 < len(starts_idx) else n
            run_sum[s:e] = np.cumsum(w[s:e])

    if name in ("min", "max"):
        ident = np.inf if name == "min" else -np.inf
        mvals = np.where(sn, ident, sv)
        run_mm = np.empty(n, np.float64)
        op = np.minimum if name == "min" else np.maximum
        for i, s in enumerate(starts_idx):
            e = starts_idx[i + 1] if i + 1 < len(starts_idx) else n
            run_mm[s:e] = op.accumulate(mvals[s:e])

    # RANGE frame: peers share the value at the END of their key run
    run_id = np.cumsum(new_key) - 1 if n else np.zeros(0, np.int64)
    nruns = int(run_id[-1]) + 1 if n else 0
    run_end = np.zeros(max(nruns, 1), np.int64)
    np.maximum.at(run_end, run_id, pos)
    at = run_end[run_id]

    out_f = np.empty(n, object)
    out_fn = np.ones(n, bool)
    if name == "count":
        out_f[ordered] = run_cnt[at]
        out_fn[ordered] = False
    elif name == "sum":
        res = run_sum[at]
        out_f[ordered] = res.astype(np.int64) if is_int else res
        out_fn[ordered] = run_cnt[at] == 0
    elif name == "avg":
        cc = run_cnt[at]
        out_f[ordered] = run_sum[at] / np.maximum(cc, 1)
        out_fn[ordered] = cc == 0
    else:
        cc = run_cnt[at]
        res = np.where(cc == 0, 0.0, run_mm[at])   # inf->int is undefined
        out_f[ordered] = res.astype(np.int64) if is_int else res
        out_fn[ordered] = cc == 0
    return _densify(Col(out_f, out_fn))
