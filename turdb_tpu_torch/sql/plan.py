"""Physical plan IR (reference src/sql/planner/mod.rs:77, physical.rs:43).

The round-1 EXPLAIN re-derived a synthetic plan shape inline; this module
makes the plan a first-class tree built by the SAME decision helpers the
executor calls:

  - index selection   -> Database._index_choice  (api.py; eq + range)
  - ANN fast path     -> engine.ann_candidate + Database._ann_choice
  - join algorithm    -> _split_equi outcome (hash vs cross/NL)
  - join reordering   -> _flatten_inner eligibility (greedy chain)
  - pushdown/pruning  -> recorded on the scan/join nodes

Planner and executor cannot drift because neither duplicates the other's
logic: both call the shared choosers. The executor itself remains the
batch-columnar AST pipeline (SURVEY.md §7) — this tree is the DECISION
RECORD that EXPLAIN renders and tests assert against, not a second
execution engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.lexer import SqlError


@dataclasses.dataclass
class Plan:
    """One operator node: `label` is the EXPLAIN line, `children` nest."""

    label: str
    children: list["Plan"] = dataclasses.field(default_factory=list)
    # machine-readable identity for plan-shape tests ("SeqScan",
    # "IndexScan", "AnnIndexScan", "HashJoin", ...)
    op: str = ""
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)

    def render(self, depth: int = 0, out: list[str] | None = None) -> list[str]:
        if out is None:
            out = []
        out.append("  " * depth + self.label)
        for c in self.children:
            c.render(depth + 1, out)
        return out

    def find(self, op: str) -> list["Plan"]:
        hits = [self] if self.op == op else []
        for c in self.children:
            hits.extend(c.find(op))
        return hits


def _ex(e) -> str:
    return A.render_expr(e)


def plan_select(db, sel: A.Select, params: list | None = None) -> Plan:
    """Build the physical plan for a SELECT. Read-only: index probes run
    (they are how selectivity is decided — same as execution), but no
    table rows are materialized."""
    ctx = db._ctx(params or [])
    return _plan_select(db, sel, ctx)


def _plan_select(db, sel: A.Select, ctx) -> Plan:
    from turdb_tpu_torch.sql import engine as E

    root_children: list[Plan] = []
    if sel.ctes:
        known = set(getattr(ctx, "plan_ctes", ()) or ())
        for cte in sel.ctes:
            rec = " (recursive fixpoint)" if getattr(
                cte, "recursive", False
            ) and cte.query.set_op is not None else ""
            root_children.append(
                Plan(f"CTE {cte.name}{rec}",
                     [_plan_select(db, sel=cte.query, ctx=ctx)],
                     op="CTE", detail={"name": cte.name})
            )
            known.add(cte.name)
        ctx.plan_ctes = known

    # --- source: ANN fast path > index scan > seq scan / joins ----------
    ann = E.ann_candidate(sel, ctx)
    src: Plan | None = None
    ann_applies = False
    if ann is not None and getattr(db, "ann_enabled", False):
        colref, _const, op, k, off = ann
        try:
            info = db.resolve_table(sel.from_)
            choice = db._ann_choice(info, colref.name, op)
        except SqlError:
            choice = None
        if choice is not None:
            name, kind = choice
            ann_applies = True
            src = Plan(
                f"AnnIndexScan {sel.from_.name} ({_ex(sel.order_by[0].expr)}) "
                f"[{kind}:{name}, k={k + off}, overfetch x{db.ann_overfetch}]",
                op="AnnIndexScan",
                detail={"table": sel.from_.name, "index": name, "kind": kind,
                        "k": k + off},
            )
            if sel.where is not None:
                src = Plan(f"Filter {_ex(sel.where)}", [src], op="Filter")

    if src is None and sel.where is not None and isinstance(
        sel.from_, A.TableRef
    ):
        choice = getattr(db, "_index_choice", lambda *a: None)(
            sel.from_, sel.where, ctx
        )
        if choice is not None:
            src = Plan(
                f"IndexScan {sel.from_.name} [{choice.kind}:{choice.index} "
                f"({', '.join(choice.cols)}), {choice.nrows} candidates]",
                op="IndexScan",
                detail={"table": sel.from_.name, "index": choice.index,
                        "kind": choice.kind, "nrows": choice.nrows},
            )
            src = Plan(f"Filter {_ex(sel.where)}", [src], op="Filter")

    if src is None:
        if isinstance(sel.from_, A.Join) and sel.where is not None:
            # mirror the executor: WHERE conjuncts spanning join sides
            # become join conditions (join-condition extraction)
            ctx.where_equi = sum(
                1 for c in E._split_conjuncts(sel.where) if _has_equi(c)
            )
        src = _plan_from(db, sel.from_, ctx)
        ctx.where_equi = 0
        if sel.where is not None:
            label = f"Filter {_ex(sel.where)}"
            if isinstance(sel.from_, A.Join):
                label += " [pushdown + join-condition extraction]"
            src = Plan(label, [src], op="Filter")

    # --- aggregate / project -------------------------------------------
    has_agg = any(
        E._contains_aggregate(it.expr)
        for it in sel.items
        if isinstance(it, A.SelectItem)
    ) or (sel.having is not None) or bool(sel.group_by)
    if has_agg:
        keys = ", ".join(_ex(g) for g in sel.group_by)
        label = f"HashAggregate [{keys}]" if keys else "Aggregate"
        if sel.having is not None:
            label += f" HAVING {_ex(sel.having)}"
        src = Plan(label, [src], op="Aggregate")
    if any(
        E._contains_window(it.expr)
        for it in sel.items
        if isinstance(it, A.SelectItem)
    ):
        src = Plan("Window", [src], op="Window")
    items = ", ".join(
        "*" if isinstance(it.expr, A.Star) else _ex(it.expr)
        for it in sel.items
        if isinstance(it, A.SelectItem)
    ) or "*"
    src = Plan(f"Project [{items}]", [src], op="Project")
    if sel.distinct:
        src = Plan("Distinct", [src], op="Distinct")

    # --- set ops --------------------------------------------------------
    if sel.set_op is not None:
        op, all_, rhs = sel.set_op
        src = Plan(
            f"{op}{' ALL' if all_ else ''}",
            [src, _plan_select(db, rhs, ctx)],
            op="SetOp",
        )

    # --- order / limit (suppressed when the ANN scan fuses them) --------
    if sel.order_by and not ann_applies:
        keys = ", ".join(
            _ex(o.expr) + (" DESC" if o.desc else "") for o in sel.order_by
        )
        src = Plan(f"Sort [{keys}]", [src], op="Sort")
    if sel.limit is not None:
        label = f"Limit {_ex(sel.limit)}"
        if sel.offset is not None:
            label += f" OFFSET {_ex(sel.offset)}"
        src = Plan(label, [src], op="Limit")

    if root_children:
        root_children.append(src)
        return Plan("Query", root_children, op="Query")
    return src


def _plan_from(db, node, ctx) -> Plan:
    from turdb_tpu_torch.sql import engine as E

    if node is None:
        return Plan("Dual (1 row)", op="Dual")
    if isinstance(node, A.TableRef):
        ctes = getattr(ctx, "ctes", {}) or {}
        plan_ctes = getattr(ctx, "plan_ctes", ()) or ()
        if node.schema is None and (node.name in ctes or node.name in plan_ctes):
            return Plan(f"CteScan {node.name}", op="CteScan")
        alias = f" AS {node.alias}" if node.alias else ""
        return Plan(
            f"SeqScan {node.schema or 'main'}.{node.name}{alias}",
            op="SeqScan", detail={"table": node.name},
        )
    if isinstance(node, A.SubqueryRef):
        kind = "LateralSubquery" if node.lateral else "Subquery"
        return Plan(
            f"{kind} AS {node.alias}",
            [_plan_select(db, node.subquery, ctx)],
            op=kind,
        )
    if isinstance(node, A.Join):
        # mirror QueryEngine._join: greedy reorder for INNER chains of 3+
        if (
            node.kind in ("INNER", "CROSS")
            and node.using is None
            and (isinstance(node.left, A.Join) or isinstance(node.right, A.Join))
        ):
            flat = E._flatten_inner(node)
            if flat is not None and len(flat[0]) > 2:
                leaves, conjuncts = flat
                nconj = len(conjuncts) + getattr(ctx, "where_equi", 0)
                return Plan(
                    f"GreedyJoinChain ({len(leaves)} relations, "
                    f"{nconj} conjuncts) [cost-ordered]",
                    [_plan_from(db, leaf, ctx) for leaf in leaves],
                    op="GreedyJoinChain",
                )
        left = _plan_from(db, node.left, ctx)
        right = _plan_from(db, node.right, ctx)
        cond = node.on
        if node.using:
            algo = "HashJoin"
        elif node.kind == "CROSS" or cond is None:
            algo = "CrossJoin"
        else:
            # hash join iff at least one equi conjunct resolves two-sided;
            # at plan time we inspect the shape only (col = col)
            algo = "HashJoin" if _has_equi(cond) else (
                "CrossJoin" if node.kind == "INNER" else "NestedLoopJoin"
            )
        label = f"{algo} ({node.kind})"
        if cond is not None:
            label += f" ON {_ex(cond)}"
        return Plan(label, [left, right], op=algo)
    return Plan(f"?{type(node).__name__}", op="Unknown")


def _has_equi(cond) -> bool:
    """Shape check mirroring _split_equi: any `a = b` conjunct whose both
    sides are column refs (the executor additionally checks they resolve
    on opposite sides; a miss there degrades to cross/NL at run time)."""
    if isinstance(cond, A.BinaryOp) and cond.op == "AND":
        return _has_equi(cond.left) or _has_equi(cond.right)
    return (
        isinstance(cond, A.BinaryOp)
        and cond.op == "="
        and isinstance(cond.left, (A.ColumnRef,))
        and isinstance(cond.right, (A.ColumnRef,))
    )
