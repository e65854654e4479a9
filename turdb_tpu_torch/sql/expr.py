"""Vectorized SQL expression evaluation over columnar batches.

Counterpart of reference src/sql/predicate.rs (CompiledPredicate /
CompiledProjection, :9,1774) re-based on columns: instead of compiling an
expression to a per-row closure pulled by the Volcano loop, expressions
evaluate over WHOLE COLUMNS (numpy arrays with null masks, three-valued
logic), one vector op per AST node — the batch-columnar stance of
SURVEY.md §7. Vector distance expressions map to the same math as the
device kernels (ops/distance.py).
"""

from __future__ import annotations

import numpy as np

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.lexer import SqlError


class Col:
    """A column of values + null mask. values dtype: numeric numpy or
    object (strings/json/arrays); vectors are 2-D float32."""

    __slots__ = ("values", "nulls")

    def __init__(self, values, nulls=None):
        self.values = values
        n = len(values)
        self.nulls = (
            np.zeros(n, bool) if nulls is None else np.asarray(nulls, bool)
        )

    def __len__(self):
        return len(self.values)

    @classmethod
    def const(cls, value, n: int):
        if value is None:
            return cls(np.zeros(n, object), np.ones(n, bool))
        if isinstance(value, bool):
            return cls(np.full(n, value, dtype=bool))
        if isinstance(value, int):
            return cls(np.full(n, value, dtype=np.int64))
        if isinstance(value, float):
            return cls(np.full(n, value, dtype=np.float64))
        if isinstance(value, np.ndarray) and value.ndim == 1:
            return cls(np.broadcast_to(value, (n, len(value))).copy())
        arr = np.empty(n, object)
        arr[:] = [value] * n
        return cls(arr)


class Batch:
    """Named columnar batch. Column keys are (qualifier, name)."""

    def __init__(self, n: int):
        self.n = n
        self.names: list[tuple[str | None, str]] = []
        self.cols: list[Col] = []

    @classmethod
    def empty(cls):
        return cls(0)

    def add(self, qualifier, name, col: Col):
        self.names.append((qualifier, name))
        self.cols.append(col)
        return self

    def resolve(self, name: str, qualifier: str | None = None) -> Col:
        hits = [
            c
            for (q, n), c in zip(self.names, self.cols)
            if n == name and (qualifier is None or q == qualifier)
        ]
        if not hits:
            where = f"{qualifier}.{name}" if qualifier else name
            raise SqlError(f"column not found: {where}")
        if len(hits) > 1 and qualifier is None:
            # a group-key/output column (qualifier None) shadowing a
            # source column of the same name is NOT ambiguous — the
            # post-aggregate batch carries both and they hold the same
            # per-group values; genuine t1.a/t2.a ambiguity still errors
            unq = [
                c for (q, n), c in zip(self.names, self.cols)
                if n == name and q is None
            ]
            if len(unq) == 1:
                return unq[0]
            raise SqlError(f"ambiguous column: {name}")
        return hits[0]

    def take(self, idx) -> "Batch":
        out = Batch(len(idx))
        for (q, n), c in zip(self.names, self.cols):
            out.add(q, n, Col(c.values[idx], c.nulls[idx]))
        return out

    def slice_cols(self, keep: list[int]) -> "Batch":
        out = Batch(self.n)
        for i in keep:
            out.add(self.names[i][0], self.names[i][1], self.cols[i])
        return out

    def concat(self, other: "Batch") -> "Batch":
        """Row-wise concatenation (schemas must match)."""
        out = Batch(self.n + other.n)
        for (q, n), a, b in zip(self.names, self.cols, other.cols):
            va, vb = a.values, b.values
            if va.dtype != vb.dtype or (va.ndim != vb.ndim):
                va = va.astype(object) if va.ndim == 1 else va
                vb = vb.astype(object) if vb.ndim == 1 else vb
            out.add(q, n, Col(np.concatenate([va, vb]),
                              np.concatenate([a.nulls, b.nulls])))
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _numeric(a: Col) -> np.ndarray:
    v = a.values
    if v.dtype == object:
        out = np.zeros(len(v), np.float64)
        for i, x in enumerate(v):
            out[i] = float(x) if x is not None and not a.nulls[i] else 0.0
        return out
    return v


def _is_text(a: Col) -> bool:
    return a.values.dtype == object


def _is_decimal(a: Col) -> bool:
    from decimal import Decimal

    v = a.values
    if v.dtype != object or v.ndim != 1:
        return False
    for i, x in enumerate(v):
        if x is not None and not a.nulls[i]:
            return isinstance(x, Decimal)
    return False


def _decimal_vals(a: Col) -> np.ndarray:
    from decimal import Decimal

    n = len(a.values)
    out = np.empty(n, object)
    v = a.values
    for i in range(n):
        x = None if a.nulls[i] else v[i]
        if x is None:
            out[i] = Decimal(0)
        elif isinstance(x, Decimal):
            out[i] = x
        elif isinstance(x, (float, np.floating)):
            out[i] = Decimal(str(float(x)))  # shortest repr: 0.1 stays 0.1
        elif isinstance(x, (int, np.integer)):
            out[i] = Decimal(int(x))
        else:
            out[i] = Decimal(x)
    return out


def _binary_decimal(op, a: Col, b: Col) -> Col:
    """Exact DECIMAL arithmetic (reference src/types/data_type.rs:94):
    both operands lift to Decimal; division is true division."""
    nulls = (a.nulls | b.nulls).copy()
    va, vb = _decimal_vals(a), _decimal_vals(b)
    n = len(va)
    out = np.empty(n, object)
    from decimal import Decimal

    zero = Decimal(0)
    for i in range(n):
        if nulls[i]:
            out[i] = None
            continue
        x, y = va[i], vb[i]
        if op == "+":
            out[i] = x + y
        elif op == "-":
            out[i] = x - y
        elif op == "*":
            out[i] = x * y
        elif op in ("/", "%"):
            if y == zero:
                nulls[i] = True
                out[i] = None
            else:
                out[i] = x / y if op == "/" else x % y
        else:
            raise SqlError(f"bad numeric op {op}")
    return Col(out, nulls)


def _binary_numeric(op, a: Col, b: Col) -> Col:
    if _is_decimal(a) or _is_decimal(b):
        return _binary_decimal(op, a, b)
    nulls = a.nulls | b.nulls
    va, vb = _numeric(a), _numeric(b)
    both_int = va.dtype.kind in "i" and vb.dtype.kind in "i"
    with np.errstate(divide="ignore", invalid="ignore"):
        if op == "+":
            out = va + vb
        elif op == "-":
            out = va - vb
        elif op == "*":
            out = va * vb
        elif op == "/":
            if both_int:
                # SQL integer division truncates toward zero (Rust/SQLite
                # semantics, e.g. -7/2 = -3); numpy // floors
                safe = np.where(vb == 0, 1, vb)
                out = np.abs(va) // np.abs(safe)
                neg = (va < 0) != (safe < 0)
                out = np.where(neg, -out, out)
                nulls = nulls | (vb == 0)
            else:
                safe = np.where(vb == 0, 1.0, vb)
                out = va / safe
                nulls = nulls | (vb == 0)
        elif op == "%":
            # remainder carries the DIVIDEND's sign (C/Rust/SQLite);
            # np.mod would carry the divisor's
            safe = np.where(vb == 0, 1, vb)
            out = np.fmod(va, safe)
            nulls = nulls | (vb == 0)
        else:
            raise SqlError(f"bad numeric op {op}")
    return Col(out, nulls)


def _compare(op, a: Col, b: Col) -> Col:
    nulls = a.nulls | b.nulls
    va, vb = a.values, b.values
    if va.ndim == 2 or vb.ndim == 2:
        # vector equality: rowwise
        if op not in ("=", "<>"):
            raise SqlError("vectors only support =/<> comparison")
        eq = np.all(np.asarray(va) == np.asarray(vb), axis=-1)
        return Col(eq if op == "=" else ~eq, nulls)
    if va.dtype == object or vb.dtype == object:
        # python-level compare (strings etc.)
        n = len(va)
        out = np.zeros(n, bool)
        for i in range(n):
            if nulls[i]:
                continue
            x, y = va[i], vb[i]
            # numpy scalars don't interoperate with Decimal — unwrap
            if isinstance(x, np.generic):
                x = x.item()
            if isinstance(y, np.generic):
                y = y.item()
            try:
                if op == "=":
                    out[i] = x == y
                elif op == "<>":
                    out[i] = x != y
                elif op == "<":
                    out[i] = x < y
                elif op == "<=":
                    out[i] = x <= y
                elif op == ">":
                    out[i] = x > y
                elif op == ">=":
                    out[i] = x >= y
            except TypeError:
                nulls[i] = True
        return Col(out, nulls)
    if op == "=":
        return Col(va == vb, nulls)
    if op == "<>":
        return Col(va != vb, nulls)
    if op == "<":
        return Col(va < vb, nulls)
    if op == "<=":
        return Col(va <= vb, nulls)
    if op == ">":
        return Col(va > vb, nulls)
    if op == ">=":
        return Col(va >= vb, nulls)
    raise SqlError(f"bad comparison {op}")


def _as_vector(col: Col, n: int) -> np.ndarray:
    v = col.values
    if v.ndim == 2:
        return np.asarray(v, np.float32)
    out = None
    for i, x in enumerate(v):
        if col.nulls[i] or x is None:
            continue
        arr = parse_vector_text(x) if isinstance(x, str) else np.asarray(x, np.float32)
        if out is None:
            out = np.zeros((n, len(arr)), np.float32)
        out[i] = arr
    if out is None:
        out = np.zeros((n, 0), np.float32)
    return out


def parse_vector_text(text: str) -> np.ndarray:
    """'[1, 2, 3]' -> float32 array (reference parsing/literal.rs vector)."""
    t = text.strip()
    if t.startswith("[") and t.endswith("]"):
        t = t[1:-1]
    if not t.strip():
        return np.zeros(0, np.float32)
    return np.asarray([float(x) for x in t.split(",")], np.float32)


def _vector_distance(op, a: Col, b: Col) -> Col:
    n = max(len(a), len(b))
    va, vb = _as_vector(a, n), _as_vector(b, n)
    nulls = a.nulls | b.nulls
    if va.shape[1] != vb.shape[1]:
        if va.shape[1] == 0 or vb.shape[1] == 0:
            return Col(np.zeros(n, np.float64), np.ones(n, bool))
        raise SqlError(
            f"vector dimension mismatch: {va.shape[1]} vs {vb.shape[1]}"
        )
    dots = np.einsum("nd,nd->n", va, vb)
    if op == "<->":
        # reference returns EUCLIDEAN distance for <-> in SQL results
        d2 = np.maximum(
            (va * va).sum(-1) + (vb * vb).sum(-1) - 2 * dots, 0.0
        )
        out = np.sqrt(d2)
    elif op == "<#>":
        out = -dots
    else:  # <=>
        na = np.linalg.norm(va, axis=-1)
        nb = np.linalg.norm(vb, axis=-1)
        denom = np.where((na == 0) | (nb == 0), 1.0, na * nb)
        out = 1.0 - dots / denom
    return Col(out.astype(np.float64), nulls)


def _like_to_regex(pattern: str, esc: str | None = None) -> "re.Pattern":
    import re

    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if esc is not None and c == esc and i + 1 < len(pattern):
            # ESCAPE 'c': the next char is literal (incl. % _ and esc)
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _similar_to_regex(pattern: str, esc: str | None = None) -> "re.Pattern":
    """SQL SIMILAR TO → anchored Python regex. % and _ keep their LIKE
    meaning; the SQL-regex metacharacters | * + ? ( ) [ ] { } pass
    through; everything else matches literally (PostgreSQL 9.7.2)."""
    import re

    out = []
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if esc is not None and c == esc and i + 1 < n:
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        elif c == "[":
            # bracket expression passes through verbatim to its ]
            j = pattern.find("]", i + 1 if pattern[i + 1 : i + 2] != "^"
                             else i + 2)
            if j < 0:
                raise SqlError("unterminated [ in SIMILAR TO pattern")
            out.append(pattern[i : j + 1])
            i = j + 1
            continue
        elif c in "|*+?(){},0123456789":
            out.append(c)    # SQL-regex metachars (and {m,n} digits)
        else:
            out.append(re.escape(c))
        i += 1
    try:
        return re.compile("^(?:" + "".join(out) + ")$", re.DOTALL)
    except re.error as e:
        raise SqlError(f"invalid SIMILAR TO pattern: {e}")


def _kleene_and(a: Col, b: Col) -> Col:
    av = a.values.astype(bool) & ~a.nulls
    bv = b.values.astype(bool) & ~b.nulls
    af = ~a.values.astype(bool) & ~a.nulls
    bf = ~b.values.astype(bool) & ~b.nulls
    false = af | bf
    true = av & bv
    return Col(true, ~(true | false))


def _kleene_or(a: Col, b: Col) -> Col:
    av = a.values.astype(bool) & ~a.nulls
    bv = b.values.astype(bool) & ~b.nulls
    af = ~a.values.astype(bool) & ~a.nulls
    bf = ~b.values.astype(bool) & ~b.nulls
    true = av | bv
    false = af & bf
    return Col(true, ~(true | false))


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------


class EvalContext:
    """Execution context: bind params, subquery executor hook, outer row."""

    def __init__(self, params=None, subquery_fn=None, outer: "Batch|None" = None):
        self.params = params or []
        self.subquery_fn = subquery_fn   # callable(Select, EvalContext)->Batch
        self.outer = outer


def eval_expr(e, batch: Batch, ctx: EvalContext) -> Col:
    n = batch.n
    if isinstance(e, A.Literal):
        return Col.const(e.value, n)
    if isinstance(e, A.Param):
        if e.index > len(ctx.params):
            raise SqlError(f"missing bind parameter ${e.index}")
        return Col.const(ctx.params[e.index - 1], n)
    if isinstance(e, A.ColumnRef):
        try:
            return batch.resolve(e.name, e.table)
        except SqlError:
            if ctx.outer is not None:
                oc = ctx.outer.resolve(e.name, e.table)
                # outer batch carries exactly one row during correlation
                return Col(
                    np.repeat(oc.values[:1], n, axis=0),
                    np.repeat(oc.nulls[:1], n),
                )
            raise
    if isinstance(e, A.TypedLiteral):
        return _typed_literal(e, n)
    if isinstance(e, A.BinaryOp):
        if e.op in ("AND", "OR"):
            a = eval_expr(e.left, batch, ctx)
            b = eval_expr(e.right, batch, ctx)
            return _kleene_and(a, b) if e.op == "AND" else _kleene_or(a, b)
        a = eval_expr(e.left, batch, ctx)
        b = eval_expr(e.right, batch, ctx)
        if e.op in ("+", "-", "*", "/", "%"):
            return _binary_numeric(e.op, a, b)
        if e.op in ("=", "<>", "<", "<=", ">", ">="):
            return _compare(e.op, a, b)
        if e.op in ("<->", "<#>", "<=>"):
            return _vector_distance(e.op, a, b)
        if e.op == "||":
            return _concat(a, b)
        if e.op in ("->", "->>"):
            return _json_get(a, b, as_text=(e.op == "->>"))
        if e.op == "@>":
            return _contains_op(a, b)
        if e.op == "<@":
            return _contains_op(b, a)
        if e.op == "&&":
            return _overlaps_op(a, b)
        raise SqlError(f"unsupported operator {e.op}")
    if isinstance(e, A.UnaryOp):
        v = eval_expr(e.operand, batch, ctx)
        if e.op == "NOT":
            bv = v.values.astype(bool)
            return Col(~bv, v.nulls)
        if e.op == "-":
            if _is_decimal(v):
                dv = _decimal_vals(v)
                return Col(
                    np.array([-x for x in dv], object), v.nulls
                )
            return Col(-_numeric(v), v.nulls)
        return v
    if isinstance(e, A.IsNull):
        v = eval_expr(e.operand, batch, ctx)
        out = v.nulls.copy()
        return Col(~out if e.negated else out)
    if isinstance(e, A.IsDistinct):
        a = eval_expr(e.left, batch, ctx)
        b = eval_expr(e.right, batch, ctx)
        eq = _compare("=", a, b)
        # null-safe: NULL vs NULL = not distinct; NULL vs value = distinct
        same = np.where(
            a.nulls | b.nulls,
            a.nulls & b.nulls,
            eq.values.astype(bool) & ~eq.nulls,
        )
        return Col(same if e.negated else ~same)
    if isinstance(e, A.Like):
        v = eval_expr(e.operand, batch, ctx)
        p = eval_expr(e.pattern, batch, ctx)
        esc = None
        if e.escape is not None:
            ec = eval_expr(e.escape, batch, ctx)
            if not ec.nulls[0]:
                esc = str(ec.values[0])
                if len(esc) != 1:
                    raise SqlError("ESCAPE must be a single character")
        nulls = v.nulls | p.nulls
        out = np.zeros(n, bool)
        pat_cache = {}
        for i in range(n):
            if nulls[i]:
                continue
            ptxt = str(p.values[i])
            key = (ptxt, e.case_insensitive)
            rex = pat_cache.get(key)
            if rex is None:
                to_rex = _similar_to_regex if e.similar else _like_to_regex
                rex = to_rex(
                    ptxt.lower() if e.case_insensitive else ptxt, esc
                )
                pat_cache[key] = rex
            s = str(v.values[i])
            out[i] = bool(rex.match(s.lower() if e.case_insensitive else s))
        if e.negated:
            out = ~out
        return Col(out, nulls)
    if isinstance(e, A.Between):
        v = eval_expr(e.operand, batch, ctx)
        lo = eval_expr(e.low, batch, ctx)
        hi = eval_expr(e.high, batch, ctx)
        a = _compare(">=", v, lo)
        b = _compare("<=", v, hi)
        r = _kleene_and(a, b)
        if e.negated:
            return Col(~r.values.astype(bool), r.nulls)
        return r
    if isinstance(e, A.InList):
        v = eval_expr(e.operand, batch, ctx)
        acc = None
        for item in e.items:
            c = _compare("=", v, eval_expr(item, batch, ctx))
            acc = c if acc is None else _kleene_or(acc, c)
        if acc is None:
            acc = Col(np.zeros(n, bool))
        if e.negated:
            return Col(~acc.values.astype(bool), acc.nulls)
        return acc
    if isinstance(e, A.InSubquery):
        return _in_subquery(e, batch, ctx)
    if isinstance(e, A.Quantified):
        return _quantified(e, batch, ctx)
    if isinstance(e, A.Exists):
        return _exists(e, batch, ctx)
    if isinstance(e, A.ScalarSubquery):
        return _scalar_subquery(e, batch, ctx)
    if isinstance(e, A.Case):
        return _case(e, batch, ctx)
    if isinstance(e, A.Cast):
        return _cast(eval_expr(e.operand, batch, ctx), e.type_name)
    if isinstance(e, A.ArrayLiteral):
        items = [eval_expr(x, batch, ctx) for x in e.items]
        out = np.empty(n, object)
        for i in range(n):
            out[i] = [
                None if c.nulls[i] else _py(c.values[i]) for c in items
            ]
        return Col(out)
    if isinstance(e, A.ArrayIndex):
        base = eval_expr(e.base, batch, ctx)
        idx = eval_expr(e.index, batch, ctx)
        out = np.empty(n, object)
        nulls = base.nulls | idx.nulls
        for i in range(n):
            if nulls[i]:
                continue
            arr = base.values[i]
            j = int(idx.values[i])
            if isinstance(arr, (list, tuple)) and 1 <= j <= len(arr):
                out[i] = arr[j - 1]       # SQL arrays are 1-based
            elif isinstance(arr, np.ndarray) and 1 <= j <= len(arr):
                out[i] = float(arr[j - 1])
            else:
                nulls[i] = True
        return Col(out, nulls)
    if isinstance(e, A.FuncCall):
        from turdb_tpu_torch.sql.functions import eval_function

        return eval_function(e, batch, ctx)
    raise SqlError(f"cannot evaluate {type(e).__name__}")


def _py(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _typed_literal(e: A.TypedLiteral, n: int) -> Col:
    if e.type_name == "VECTOR":
        return Col.const(parse_vector_text(e.text), n)
    from turdb_tpu_torch.sql.functions import parse_temporal

    return Col.const(parse_temporal(e.type_name, e.text), n)


def _concat(a: Col, b: Col) -> Col:
    nulls = a.nulls | b.nulls
    n = len(a)
    # array || array / array || elem
    if a.values.dtype == object and len(a.values) and isinstance(
        a.values[0], (list, tuple)
    ):
        out = np.empty(n, object)
        for i in range(n):
            if nulls[i]:
                continue
            bv = b.values[i]
            out[i] = list(a.values[i]) + (
                list(bv) if isinstance(bv, (list, tuple)) else [_py(bv)]
            )
        return Col(out, nulls)
    out = np.empty(n, object)
    for i in range(n):
        if nulls[i]:
            continue
        out[i] = _text(a.values[i]) + _text(b.values[i])
    return Col(out, nulls)


def _text(v) -> str:
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return "true" if v else "false"
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return str(int(f)) if f.is_integer() else str(f)
    return str(_py(v))


def _json_get(a: Col, b: Col, as_text: bool) -> Col:
    n = len(a)
    out = np.empty(n, object)
    nulls = a.nulls | b.nulls
    for i in range(n):
        if nulls[i]:
            continue
        doc = a.values[i]
        if isinstance(doc, str):
            import json

            try:
                doc = json.loads(doc)
            except json.JSONDecodeError:
                nulls[i] = True
                continue
        key = b.values[i]
        if isinstance(doc, dict):
            v = doc.get(str(key))
        elif isinstance(doc, list):
            try:
                v = doc[int(key)]
            except (IndexError, ValueError, TypeError):
                v = None
        else:
            v = None
        if v is None:
            nulls[i] = True
        else:
            if as_text and not isinstance(v, str):
                import json

                v = json.dumps(v)
            out[i] = v
    return Col(out, nulls)


def _contains_op(a: Col, b: Col) -> Col:
    """`a @> b`: range/box/circle containment when `a` parses as one
    (reference data_type.rs range/geometry types), else JSONB
    containment (jsonb.rs)."""
    from turdb_tpu_torch.types.ranges import geo_contains

    n = len(a)
    out = np.zeros(n, bool)
    nulls = a.nulls | b.nulls
    geo_any = False
    for i in range(n):
        if nulls[i]:
            continue
        g = geo_contains(_py(a.values[i]), _py(b.values[i]))
        if g is not None:
            out[i] = g
            geo_any = True
    if geo_any:
        return Col(out, nulls)
    return _json_contains(a, b)


def _overlaps_op(a: Col, b: Col) -> Col:
    """`a && b`: range/geometry overlap."""
    from turdb_tpu_torch.types.ranges import geo_overlaps

    n = len(a)
    out = np.zeros(n, bool)
    nulls = a.nulls | b.nulls
    for i in range(n):
        if nulls[i]:
            continue
        av, bv = _py(a.values[i]), _py(b.values[i])
        if isinstance(av, (list, tuple)) and isinstance(bv, (list, tuple)):
            # array overlap: any shared element (PostgreSQL &&)
            out[i] = bool(set(av) & set(bv))
            continue
        g = geo_overlaps(av, bv)
        if g is None:
            raise SqlError("&& requires array/range/box/circle operands")
        out[i] = g
    return Col(out, nulls)


def _json_contains(a: Col, b: Col) -> Col:
    from turdb_tpu_torch.records.jsonb import jsonb_contains

    n = len(a)
    out = np.zeros(n, bool)
    nulls = a.nulls | b.nulls
    import json

    for i in range(n):
        if nulls[i]:
            continue
        x, y = a.values[i], b.values[i]
        if isinstance(x, str):
            try:
                x = json.loads(x)
            except json.JSONDecodeError:
                nulls[i] = True
                continue
        if isinstance(y, str):
            try:
                y = json.loads(y)
            except json.JSONDecodeError:
                nulls[i] = True
                continue
        out[i] = jsonb_contains(x, y)
    return Col(out, nulls)


def _case(e: A.Case, batch: Batch, ctx: EvalContext) -> Col:
    n = batch.n
    result_v = np.empty(n, object)
    result_n = np.ones(n, bool)
    decided = np.zeros(n, bool)
    operand = eval_expr(e.operand, batch, ctx) if e.operand is not None else None
    for cond, res in e.whens:
        if operand is not None:
            c = _compare("=", operand, eval_expr(cond, batch, ctx))
        else:
            c = eval_expr(cond, batch, ctx)
        hit = c.values.astype(bool) & ~c.nulls & ~decided
        if hit.any():
            rv = eval_expr(res, batch, ctx)
            for i in np.flatnonzero(hit):
                result_v[i] = _py(rv.values[i])
                result_n[i] = rv.nulls[i]
            decided |= hit
    if e.else_ is not None:
        rv = eval_expr(e.else_, batch, ctx)
        rest = ~decided
        for i in np.flatnonzero(rest):
            result_v[i] = _py(rv.values[i])
            result_n[i] = rv.nulls[i]
    return _densify(Col(result_v, result_n))


def _densify(c: Col) -> Col:
    """Collapse an object column to numeric/bool when possible."""
    if c.values.dtype != object:
        return c
    kinds = set()
    for i, v in enumerate(c.values):
        if c.nulls[i] or v is None:
            continue
        kinds.add(type(v))
    if kinds <= {int, np.int64}:
        out = np.zeros(len(c), np.int64)
        for i, v in enumerate(c.values):
            if not c.nulls[i] and v is not None:
                out[i] = v
        return Col(out, c.nulls)
    if kinds <= {int, float, np.int64, np.float64}:
        out = np.zeros(len(c), np.float64)
        for i, v in enumerate(c.values):
            if not c.nulls[i] and v is not None:
                out[i] = v
        return Col(out, c.nulls)
    if kinds <= {bool, np.bool_}:
        out = np.zeros(len(c), bool)
        for i, v in enumerate(c.values):
            if not c.nulls[i] and v is not None:
                out[i] = v
        return Col(out, c.nulls)
    return c


def _cast(v: Col, type_name: str) -> Col:
    from turdb_tpu_torch.types.datatype import DataType

    tn = type_name.upper()
    n = len(v)
    try:
        dt = DataType.from_sql(tn)
    except ValueError:
        raise SqlError(f"unknown cast target {type_name}")
    if dt.is_integer:
        out = np.zeros(n, np.int64)
        nulls = v.nulls.copy()
        for i in range(n):
            if nulls[i]:
                continue
            try:
                x = v.values[i]
                out[i] = int(float(x)) if not isinstance(x, str) else int(
                    float(x.strip())
                )
            except (ValueError, TypeError):
                raise SqlError(f"cannot cast {v.values[i]!r} to {tn}")
        return Col(out, nulls)
    if dt is DataType.DECIMAL:
        from decimal import Decimal, InvalidOperation

        out = np.empty(n, object)
        nulls = v.nulls.copy()
        for i in range(n):
            if nulls[i]:
                out[i] = None
                continue
            x = v.values[i]
            try:
                out[i] = (
                    x if isinstance(x, Decimal)
                    else Decimal(str(x) if isinstance(x, float) else x)
                )
            except (InvalidOperation, ValueError, TypeError):
                raise SqlError(f"cannot cast {x!r} to {tn}")
        return Col(out, nulls)
    if dt in (DataType.REAL, DataType.DOUBLE):
        out = np.zeros(n, np.float64)
        nulls = v.nulls.copy()
        for i in range(n):
            if nulls[i]:
                continue
            try:
                out[i] = float(v.values[i])
            except (ValueError, TypeError):
                raise SqlError(f"cannot cast {v.values[i]!r} to {tn}")
        return Col(out, nulls)
    if dt == DataType.BOOLEAN:
        out = np.zeros(n, bool)
        nulls = v.nulls.copy()
        for i in range(n):
            if nulls[i]:
                continue
            x = v.values[i]
            if isinstance(x, str):
                lx = x.strip().lower()
                if lx in ("t", "true", "1", "yes", "on"):
                    out[i] = True
                elif lx in ("f", "false", "0", "no", "off"):
                    out[i] = False
                else:
                    raise SqlError(f"cannot cast {x!r} to BOOLEAN")
            else:
                out[i] = bool(x)
        return Col(out, nulls)
    if dt == DataType.VECTOR:
        out_rows = []
        for i in range(n):
            x = v.values[i] if not v.nulls[i] else None
            if isinstance(x, str):
                out_rows.append(parse_vector_text(x))
            elif isinstance(x, (list, tuple, np.ndarray)):
                out_rows.append(np.asarray(x, np.float32))
            else:
                out_rows.append(None)
        dim = max((len(r) for r in out_rows if r is not None), default=0)
        arr = np.zeros((n, dim), np.float32)
        nulls = v.nulls.copy()
        for i, r in enumerate(out_rows):
            if r is None:
                nulls[i] = True
            else:
                arr[i] = r
        return Col(arr, nulls)
    if dt.is_textual or dt in (DataType.JSON,):
        out = np.empty(n, object)
        for i in range(n):
            if not v.nulls[i]:
                out[i] = _text(v.values[i])
        return Col(out, v.nulls.copy())
    if dt == DataType.JSONB:
        import json

        out = np.empty(n, object)
        nulls = v.nulls.copy()
        for i in range(n):
            if nulls[i]:
                continue
            x = v.values[i]
            if isinstance(x, str):
                try:
                    out[i] = json.loads(x)
                except json.JSONDecodeError:
                    raise SqlError(f"invalid JSON: {x[:40]!r}")
            else:
                out[i] = _py(x)
        return Col(out, nulls)
    from turdb_tpu_torch.sql.functions import parse_temporal

    if dt in (
        DataType.DATE, DataType.TIME, DataType.TIMESTAMP, DataType.TIMESTAMPTZ,
        DataType.INTERVAL,
    ):
        out = np.zeros(n, np.int64)
        nulls = v.nulls.copy()
        for i in range(n):
            if nulls[i]:
                continue
            x = v.values[i]
            out[i] = (
                parse_temporal(tn, x) if isinstance(x, str) else int(x)
            )
        return Col(out, nulls)
    raise SqlError(f"unsupported cast to {tn}")


# -- subqueries --------------------------------------------------------------


def _run_sub(sub, ctx: EvalContext, outer_row: Batch | None):
    if ctx.subquery_fn is None:
        raise SqlError("subqueries not supported in this context")
    sub_ctx = EvalContext(ctx.params, ctx.subquery_fn, outer=outer_row)
    return ctx.subquery_fn(sub, sub_ctx)


def _count_rowwise():
    from turdb_tpu_torch.sql.engine import STATS

    STATS["rowwise_subqueries"] = STATS.get("rowwise_subqueries", 0) + 1


def _correlated(sub) -> bool:
    # conservative: treat every subquery as potentially correlated unless it
    # has no outer references; cheap detection via column resolution at run
    # time — here we just check for table-qualified refs not in FROM.
    return True


def _in_subquery(e: A.InSubquery, batch: Batch, ctx: EvalContext) -> Col:
    v = eval_expr(e.operand, batch, ctx)
    n = batch.n
    out = np.zeros(n, bool)
    nulls = v.nulls.copy()
    try:
        res = _run_sub(e.subquery, ctx, None)
        corr = False
    except SqlError:
        corr = True
    if not corr:
        # vectorized hash semi/anti join (reference HashSemiJoinExec /
        # HashAntiJoinExec, planner/physical.rs:43-44): shared-coded keys
        # + np.isin instead of a per-row Python set probe
        from turdb_tpu_torch.sql.factorize import joint_codes

        sub_col = res.cols[0]
        lc, rc = joint_codes([v], [sub_col])
        hit = np.isin(lc, rc) & (lc >= 0)
        out = hit
        if res.n and sub_col.nulls.any():
            # x NOT IN (.., NULL, ..) is unknown when unmatched (3VL)
            nulls = nulls | (~hit & ~v.nulls)
    else:
        # decorrelation rewrite first (reference decorrelate.rs:56);
        # row-wise execution is the correctness fallback
        from turdb_tpu_torch.sql.decorrelate import in_decorrelated

        dec = in_decorrelated(e, batch, ctx)
        if dec is not None:
            return dec
        _count_rowwise()
        for i in range(n):
            if nulls[i]:
                continue
            res = _run_sub(e.subquery, ctx, batch.take([i]))
            vals = {
                _py(res.cols[0].values[j])
                for j in range(res.n)
                if not res.cols[0].nulls[j]
            }
            out[i] = _py(v.values[i]) in vals
            if not out[i] and res.n and res.cols[0].nulls.any():
                nulls[i] = True
    if e.negated:
        return Col(~out, nulls)
    return Col(out, nulls)


_QCMP = {
    "=": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<>": lambda a, b: a != b, "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _quant_one(x, op: str, kind: str, svals: list, has_null: bool):
    """Three-valued `x op ANY/ALL (svals ∪ {NULL if has_null})`: ANY is
    the OR over comparisons (empty -> FALSE), ALL the AND (empty -> TRUE).
    Returns True/False/None. O(1) per row via the precomputed extremes:
    x > ANY(S) == x > min(S), x > ALL(S) == x > max(S), etc."""
    if not svals and not has_null:
        return kind == "ALL"
    if x is None:
        return None
    cmp = _QCMP[op]
    if not svals:                      # only NULLs in the set
        return None
    try:
        if op in ("=", "!=", "<>"):
            if op == "=":
                t_any = x in svals
                t_all = all(v == x for v in svals)
            else:
                t_any = any(v != x for v in svals)
                t_all = x not in svals
        else:
            mn, mx = min(svals), max(svals)
            lo_side = op in ("<", "<=")
            if kind == "ANY":
                t_any = cmp(x, mn if not lo_side else mx)
            else:
                t_all = cmp(x, mx if not lo_side else mn)
    except TypeError:
        raise SqlError(
            f"cannot compare {type(x).__name__} in quantified subquery"
        )
    if kind == "ANY":
        if t_any:
            return True
        return None if has_null else False
    if not t_all:
        return False
    return None if has_null else True


def _quantified(e: A.Quantified, batch: Batch, ctx: EvalContext) -> Col:
    """op ANY/ALL (subquery) — reference quantified subqueries
    (sql/subquery/classifier.rs:44-95). Uncorrelated: one subquery run +
    O(1)-per-row comparison against precomputed extremes / membership;
    correlated: row-wise fallback (same policy as IN/EXISTS)."""
    v = eval_expr(e.operand, batch, ctx)
    n = batch.n
    out = np.zeros(n, bool)
    nulls = np.zeros(n, bool)

    def finish(i, r):
        if r is None:
            nulls[i] = True
        else:
            out[i] = r

    try:
        res = _run_sub(e.subquery, ctx, None)
        corr = False
    except SqlError:
        corr = True
    if not corr:
        sub = res.cols[0]
        svals = [
            _py(x) for x, nu in zip(sub.values, sub.nulls) if not nu
        ]
        has_null = bool(res.n and sub.nulls.any())
        if e.op in ("=", "!=", "<>"):
            svals = list(dict.fromkeys(svals))
        for i in range(n):
            x = None if v.nulls[i] else _py(v.values[i])
            finish(i, _quant_one(x, e.op, e.kind, svals, has_null))
    else:
        _count_rowwise()
        for i in range(n):
            res = _run_sub(e.subquery, ctx, batch.take([i]))
            sub = res.cols[0]
            svals = [
                _py(x) for x, nu in zip(sub.values, sub.nulls) if not nu
            ]
            has_null = bool(res.n and sub.nulls.any())
            x = None if v.nulls[i] else _py(v.values[i])
            finish(i, _quant_one(x, e.op, e.kind, svals, has_null))
    return Col(out, nulls)


def _exists(e: A.Exists, batch: Batch, ctx: EvalContext) -> Col:
    n = batch.n
    out = np.zeros(n, bool)
    try:
        res = _run_sub(e.subquery, ctx, None)
        out[:] = res.n > 0
    except SqlError:
        from turdb_tpu_torch.sql.decorrelate import exists_decorrelated

        dec = exists_decorrelated(e, batch, ctx)
        if dec is not None:
            return dec
        _count_rowwise()
        for i in range(n):
            res = _run_sub(e.subquery, ctx, batch.take([i]))
            out[i] = res.n > 0
    if e.negated:
        out = ~out
    return Col(out)


def _scalar_subquery(e: A.ScalarSubquery, batch: Batch, ctx: EvalContext) -> Col:
    n = batch.n
    try:
        res = _run_sub(e.subquery, ctx, None)
        if res.n > 1:
            raise SqlError("scalar subquery returned more than one row")
        if res.n == 0 or res.cols[0].nulls[0]:
            return Col.const(None, n)
        return Col.const(_py(res.cols[0].values[0]), n)
    except SqlError as err:
        if "more than one row" in str(err):
            raise
        from turdb_tpu_torch.sql.decorrelate import scalar_decorrelated

        dec = scalar_decorrelated(e, batch, ctx)
        if dec is not None:
            return dec
        _count_rowwise()
        out = np.empty(n, object)
        nulls = np.ones(n, bool)
        for i in range(n):
            res = _run_sub(e.subquery, ctx, batch.take([i]))
            if res.n > 1:
                raise SqlError("scalar subquery returned more than one row")
            if res.n == 1 and not res.cols[0].nulls[0]:
                out[i] = _py(res.cols[0].values[0])
                nulls[i] = False
        return _densify(Col(out, nulls))
