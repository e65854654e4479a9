"""Scalar SQL builtins.

Counterpart of reference src/sql/functions/ (~90 builtins: string.rs:50,
numeric.rs:50, datetime.rs:51, system.rs:33; inventory README.md:382-476).
Each function operates on whole columns (Col) with NULL propagation.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import math
import uuid as _uuid

import numpy as np

from turdb_tpu_torch.sql import ast as A
from turdb_tpu_torch.sql.expr import (
    Batch,
    Col,
    EvalContext,
    _densify,
    _numeric,
    _py,
    _text,
    eval_expr,
    parse_vector_text,
)
from turdb_tpu_torch.sql.lexer import SqlError

AGGREGATES = {
    "count", "sum", "avg", "min", "max", "stddev", "stddev_samp", "variance",
    "var_samp", "string_agg", "group_concat", "array_agg", "bool_and",
    "bool_or", "total",
    # ordered-set aggregates: fn(frac) WITHIN GROUP (ORDER BY x)
    "percentile_cont", "percentile_disc", "mode",
}

WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "ntile", "lag", "lead",
                "first_value", "last_value", "nth_value",
                "percent_rank", "cume_dist"}


def parse_temporal(type_name: str, text: str):
    """Normalize a temporal literal to canonical ISO text (DATE/TIME/
    TIMESTAMP) or microseconds (INTERVAL). Reference parsing/literal.rs."""
    tn = type_name.upper()
    t = text.strip()

    def _pad_date(d: str) -> str:
        parts = d.split("-")
        if len(parts) == 3 and all(p.isdigit() for p in parts):
            return f"{int(parts[0]):04d}-{int(parts[1]):02d}-{int(parts[2]):02d}"
        return d

    def _pad_time(x: str) -> str:
        parts = x.split(":")
        if 2 <= len(parts) <= 3 and parts[0].isdigit():
            frac = ""
            if len(parts) == 3 and "." in parts[2]:
                parts[2], frac = parts[2].split(".", 1)
                frac = "." + frac
            if all(p.isdigit() for p in parts):
                parts = [f"{int(p):02d}" for p in parts]
                while len(parts) < 3:
                    parts.append("00")
                return ":".join(parts) + frac
        return x

    if tn == "DATE":
        return _dt.date.fromisoformat(_pad_date(t)).isoformat()
    if tn == "TIME":
        return _dt.time.fromisoformat(_pad_time(t)).isoformat()
    if tn in ("TIMESTAMP", "TIMESTAMPTZ", "DATETIME"):
        t = t.replace("T", " ").replace("Z", "")
        if " " in t:
            dpart, tpart = t.split(" ", 1)
            t = _pad_date(dpart) + " " + _pad_time(tpart)
        else:
            t = _pad_date(t)
        return _dt.datetime.fromisoformat(t).strftime(
            "%Y-%m-%d %H:%M:%S.%f"
        ).rstrip("0").rstrip(".")
    if tn == "INTERVAL":
        return _parse_interval(t)
    raise SqlError(f"bad temporal type {type_name}")


_INTERVAL_UNITS = {
    "microsecond": 1, "microseconds": 1,
    "millisecond": 1000, "milliseconds": 1000,
    "second": 10**6, "seconds": 10**6, "sec": 10**6, "secs": 10**6,
    "minute": 60 * 10**6, "minutes": 60 * 10**6, "min": 60 * 10**6,
    "hour": 3600 * 10**6, "hours": 3600 * 10**6,
    "day": 86400 * 10**6, "days": 86400 * 10**6,
    "week": 7 * 86400 * 10**6, "weeks": 7 * 86400 * 10**6,
    "month": 30 * 86400 * 10**6, "months": 30 * 86400 * 10**6,
    "year": 365 * 86400 * 10**6, "years": 365 * 86400 * 10**6,
}


def _parse_interval(t: str) -> int:
    t = t.strip()
    if t[:1] in ("P", "p"):
        return _parse_iso8601_interval(t)
    total = 0
    parts = t.lower().split()
    i = 0
    while i < len(parts):
        try:
            qty = float(parts[i])
        except ValueError:
            raise SqlError(f"bad interval: {t!r}")
        if i + 1 >= len(parts):
            raise SqlError(f"bad interval: {t!r}")
        unit = parts[i + 1]
        if unit not in _INTERVAL_UNITS:
            raise SqlError(f"bad interval unit: {unit}")
        total += int(qty * _INTERVAL_UNITS[unit])
        i += 2
    return total


def _parse_iso8601_interval(t: str) -> int:
    """ISO 8601 duration 'P[nY][nM][nW][nD][T[nH][nM][nS]]' (reference
    parsing/literal.rs:440 parse_iso8601_interval), mapped onto this
    engine's single-microseconds interval representation (month = 30
    days, year = 365 days, matching _INTERVAL_UNITS)."""
    body = t[1:]
    date_part, _, time_part = body.partition("T") if "T" in body \
        else body.partition("t")
    date_units = {"Y": _INTERVAL_UNITS["year"], "M": _INTERVAL_UNITS["month"],
                  "W": _INTERVAL_UNITS["week"], "D": _INTERVAL_UNITS["day"]}
    time_units = {"H": _INTERVAL_UNITS["hour"], "M": _INTERVAL_UNITS["minute"],
                  "S": _INTERVAL_UNITS["second"]}
    total = 0
    for part, units in ((date_part, date_units), (time_part, time_units)):
        num = ""
        for c in part:
            if c.isdigit() or c == ".":
                num += c
            elif num:
                u = units.get(c.upper())
                if u is None:
                    raise SqlError(
                        f"unknown ISO 8601 interval designator: {c!r}"
                    )
                try:
                    total += int(float(num) * u)
                except ValueError:
                    raise SqlError(f"bad interval: {t!r}")
                num = ""
            else:
                raise SqlError(f"bad interval: {t!r}")
        if num:
            raise SqlError(f"bad interval: {t!r}")
    if total == 0 and not date_part and not time_part:
        raise SqlError(f"bad interval: {t!r}")
    return total


def _parse_dt(v) -> _dt.datetime:
    s = str(v).strip()
    try:
        if len(s) == 10:
            return _dt.datetime.fromisoformat(s)
        if ":" in s and "-" not in s and " " not in s:
            # time-only input (HOUR('10:30:00')): dummy epoch date
            t = _dt.time.fromisoformat(s)
            return _dt.datetime(1970, 1, 1, t.hour, t.minute, t.second,
                                t.microsecond)
        return _dt.datetime.fromisoformat(s.replace("T", " "))
    except ValueError:
        raise SqlError(f"bad timestamp: {s!r}")


def _time_secs(v) -> float:
    """'[-]H:MM:SS[.f]' (may exceed 24h) -> signed seconds."""
    s = str(v).strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    parts = s.split(":")
    if len(parts) != 3:
        raise SqlError(f"bad time: {v!r}")
    secs = int(parts[0]) * 3600 + int(parts[1]) * 60 + float(parts[2])
    return -secs if neg else secs


def _secs_time(total: float) -> str:
    sign = "-" if total < 0 else ""
    total = abs(total)
    h = int(total // 3600)
    m = int(total % 3600 // 60)
    s = total % 60
    if s == int(s):
        return f"{sign}{h:02d}:{m:02d}:{int(s):02d}"
    return f"{sign}{h:02d}:{m:02d}:{s:09.6f}".rstrip("0")


def _map(fn, *cols: Col, out_dtype=object) -> Col:
    n = len(cols[0])
    nulls = np.zeros(n, bool)
    for c in cols:
        nulls |= c.nulls
    out = np.empty(n, object)
    for i in range(n):
        if nulls[i]:
            continue
        try:
            out[i] = fn(*[_py(c.values[i]) for c in cols])
        except (ValueError, TypeError, ZeroDivisionError):
            nulls[i] = True
    c = Col(out, nulls)
    return _densify(c) if out_dtype is not object else c


def _mapnum(fn, *cols: Col) -> Col:
    n = len(cols[0])
    nulls = np.zeros(n, bool)
    for c in cols:
        nulls |= c.nulls
    args = [_numeric(c) for c in cols]
    with np.errstate(all="ignore"):
        out = fn(*args)
    bad = ~np.isfinite(out)
    return Col(np.where(bad, 0.0, out), nulls | bad)


# MySQL-style aliases from the reference inventory (README.md:382-476)
_ALIASES = {
    "ucase": "upper",
    "lcase": "lower",
    "len": "length",
    "curdate": "current_date",
    "curtime": "current_time",
    "rand": "random",
    "truncate": "trunc",
    # MySQL-family aliases (reference datetime.rs/system.rs dispatch)
    "adddate": "date_add",
    "subdate": "date_sub",
    "dayofmonth": "day",
    "sysdate": "now",
    "localtime": "now",
    "localtimestamp": "now",
    "weekofyear": "week",
    "current_database": "database",
    "nvl": "ifnull",
    "session_user": "user",
    "system_user": "user",
    "current_user": "user",
    "mid": "substr",
}


def eval_function(e: A.FuncCall, batch: Batch, ctx: EvalContext) -> Col:
    name = _ALIASES.get(e.name, e.name)
    n = batch.n
    if name in AGGREGATES or name in WINDOW_FUNCS:
        raise SqlError(
            f"{name}() must appear in an aggregate/window position"
        )
    args = [eval_expr(a, batch, ctx) for a in e.args]

    def want(k_min, k_max=None):
        k_max = k_max if k_max is not None else k_min
        if not (k_min <= len(args) <= k_max):
            raise SqlError(f"{name}() expects {k_min}..{k_max} args")

    # ---- system / generic -------------------------------------------------
    if name == "coalesce":
        out = Col.const(None, n)
        vals = np.empty(n, object)
        nulls = np.ones(n, bool)
        for c in args:
            fill = nulls & ~c.nulls
            for i in np.flatnonzero(fill):
                vals[i] = _py(c.values[i])
            nulls &= ~fill
        return _densify(Col(vals, nulls))
    if name == "nullif":
        want(2)
        a, b = args
        from turdb_tpu_torch.sql.expr import _compare

        eq = _compare("=", a, b)
        nulls = a.nulls | (eq.values.astype(bool) & ~eq.nulls)
        return Col(a.values.copy(), nulls)
    if name in ("greatest", "least"):
        vals = np.empty(n, object)
        nulls = np.ones(n, bool)
        for c in args:
            for i in range(n):
                if c.nulls[i]:
                    continue
                v = _py(c.values[i])
                if nulls[i]:
                    vals[i], nulls[i] = v, False
                elif (v > vals[i]) == (name == "greatest") and v != vals[i]:
                    vals[i] = v
        return _densify(Col(vals, nulls))
    if name in ("ifnull",):
        want(2)
        a, b = args
        vals = np.where(a.nulls, b.values, a.values)
        return _densify(Col(vals.astype(object), a.nulls & b.nulls))
    if name in ("iif", "if"):
        want(3)
        c, a, b = args
        cond = c.values.astype(bool) & ~c.nulls
        vals = np.where(cond, a.values, b.values)
        nulls = np.where(cond, a.nulls, b.nulls)
        return _densify(Col(vals.astype(object), nulls))
    if name == "typeof":
        want(1)

        def _ty(v):
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, int):
                return "integer"
            if isinstance(v, float):
                return "real"   # reference system.rs: Float -> "real"
            if isinstance(v, str):
                return "text"
            if isinstance(v, bytes):
                return "blob"
            if isinstance(v, np.ndarray):
                return "vector"
            if isinstance(v, (list, dict)):
                return "jsonb"
            return "unknown"

        out = np.empty(n, object)
        for i in range(n):
            out[i] = "null" if args[0].nulls[i] else _ty(_py(args[0].values[i]))
        return Col(out)
    if name == "database":
        return Col.const("main", n)
    if name == "version":
        from turdb_tpu_torch import __version__

        return Col.const(f"turdb-tpu {__version__}", n)
    if name == "gen_random_uuid":
        out = np.empty(n, object)
        for i in range(n):
            out[i] = str(_uuid.uuid4())
        return Col(out)
    if name == "random":
        return Col(np.random.random(n))

    # ---- string -----------------------------------------------------------
    if name in ("length", "char_length", "character_length"):
        want(1)
        return _map(lambda s: len(s) if isinstance(s, str) else len(str(s)), args[0])
    if name == "octet_length":
        want(1)
        return _map(
            lambda s: len(s.encode()) if isinstance(s, str) else len(s), args[0]
        )
    if name == "lower":
        want(1)
        return _map(lambda s: str(s).lower(), args[0])
    if name == "upper":
        want(1)
        return _map(lambda s: str(s).upper(), args[0])
    if name == "initcap":
        want(1)
        return _map(lambda s: str(s).title(), args[0])
    if name in ("substr", "substring", "mid"):
        want(2, 3)

        def _substr(s, a, ln=None):
            # reference string.rs eval_substr: pos>0 is 1-based, pos<0
            # counts from the end (saturating), pos==0 -> '', len<0 -> ''
            s, a = str(s), int(a)
            if a > 0:
                start = a - 1
            elif a < 0:
                start = max(len(s) + a, 0)
            else:
                return ""
            if ln is None:
                return s[start:]
            ln = int(ln)
            return s[start:start + ln] if ln >= 0 else ""

        if len(args) == 2:
            return _map(_substr, args[0], args[1])
        return _map(_substr, args[0], args[1], args[2])
    if name == "trim":
        want(1, 2)
        if len(args) == 1:
            return _map(lambda s: str(s).strip(), args[0])
        return _map(lambda s, ch: str(s).strip(str(ch)), args[0], args[1])
    if name == "ltrim":
        want(1, 2)
        if len(args) == 1:
            return _map(lambda s: str(s).lstrip(), args[0])
        return _map(lambda s, ch: str(s).lstrip(str(ch)), args[0], args[1])
    if name == "rtrim":
        want(1, 2)
        if len(args) == 1:
            return _map(lambda s: str(s).rstrip(), args[0])
        return _map(lambda s, ch: str(s).rstrip(str(ch)), args[0], args[1])
    if name == "replace":
        want(3)
        return _map(
            lambda s, a, b: str(s).replace(str(a), str(b)), args[0], args[1], args[2]
        )
    if name == "concat":
        out = np.empty(n, object)
        for i in range(n):
            out[i] = "".join(
                "" if c.nulls[i] else _text(c.values[i]) for c in args
            )
        return Col(out)
    if name == "concat_ws":
        want(1, 99)
        out = np.empty(n, object)
        nulls = args[0].nulls.copy()
        for i in range(n):
            if nulls[i]:
                continue
            sep = str(args[0].values[i])
            out[i] = sep.join(
                _text(c.values[i]) for c in args[1:] if not c.nulls[i]
            )
        return Col(out, nulls)
    if name == "left":
        want(2)
        return _map(lambda s, k: str(s)[: int(k)], args[0], args[1])
    if name == "right":
        want(2)
        return _map(lambda s, k: str(s)[-int(k):] if int(k) else "", args[0], args[1])
    if name == "repeat":
        want(2)
        return _map(lambda s, k: str(s) * int(k), args[0], args[1])
    if name == "reverse":
        want(1)
        return _map(lambda s: str(s)[::-1], args[0])
    if name == "lpad":
        want(2, 3)
        pad = args[2] if len(args) == 3 else Col.const(" ", n)
        return _map(
            lambda s, k, p: str(s).rjust(int(k), str(p)[0])[: int(k)],
            args[0], args[1], pad,
        )
    if name == "rpad":
        want(2, 3)
        pad = args[2] if len(args) == 3 else Col.const(" ", n)
        return _map(
            lambda s, k, p: str(s).ljust(int(k), str(p)[0])[: int(k)],
            args[0], args[1], pad,
        )
    if name == "locate":
        want(2)   # LOCATE(substr, str): 1-based, 0 when absent
        return _map(
            lambda sub, s: str(s).find(str(sub)) + 1, args[0], args[1]
        )
    if name == "strcmp":
        want(2)
        return _map(
            lambda a, b: (str(a) > str(b)) - (str(a) < str(b)),
            args[0], args[1],
        )
    if name in ("strpos", "position", "instr"):
        want(2)
        return _map(lambda s, sub: str(s).find(str(sub)) + 1, args[0], args[1])
    if name == "split_part":
        want(3)

        def _sp(s, d, k):
            parts = str(s).split(str(d))
            k = int(k)
            return parts[k - 1] if 1 <= k <= len(parts) else ""

        return _map(_sp, args[0], args[1], args[2])
    if name == "starts_with":
        want(2)
        return _map(lambda s, p: str(s).startswith(str(p)), args[0], args[1])
    if name == "md5":
        want(1)
        return _map(
            lambda s: hashlib.md5(
                s if isinstance(s, bytes) else str(s).encode()
            ).hexdigest(),
            args[0],
        )
    if name == "ascii":
        want(1)
        return _map(lambda s: ord(str(s)[0]) if str(s) else 0, args[0])
    if name == "chr":
        want(1)
        return _map(lambda k: chr(int(k)), args[0])
    if name == "to_hex":
        want(1)
        return _map(lambda k: format(int(k), "x"), args[0])
    if name == "quote_ident":
        want(1)
        return _map(lambda s: '"' + str(s).replace('"', '""') + '"', args[0])
    if name == "format":
        want(1, 99)

        def _fmt(f, *rest):
            out, ai = [], 0
            i = 0
            f = str(f)
            while i < len(f):
                if f[i] == "%" and i + 1 < len(f):
                    c = f[i + 1]
                    if c == "s":
                        out.append(_text(rest[ai]))
                        ai += 1
                    elif c == "%":
                        out.append("%")
                    else:
                        out.append(f[i : i + 2])
                    i += 2
                else:
                    out.append(f[i])
                    i += 1
            return "".join(out)

        return _map(_fmt, *args)

    # ---- numeric ----------------------------------------------------------
    if name == "abs":
        want(1)
        v = args[0]
        out = np.abs(_numeric(v))
        if v.values.dtype.kind == "i":
            out = out.astype(np.int64)
        return Col(out, v.nulls)
    if name in ("ceil", "ceiling"):
        want(1)
        return _mapnum(lambda x: np.ceil(x), args[0])
    if name == "floor":
        want(1)
        return _mapnum(lambda x: np.floor(x), args[0])
    if name == "round":
        # half AWAY from zero (reference numeric.rs eval_round uses Rust
        # f64::round; SQLite agrees: round(2.5)=3, round(-2.5)=-3) —
        # np.round would do banker's rounding
        want(1, 2)

        def _r(x, d=0):
            m = 10.0 ** int(d)
            return np.copysign(np.floor(np.abs(x) * m + 0.5), x) / m

        if len(args) == 1:
            return _mapnum(_r, args[0])
        return _mapnum(
            lambda x, d: np.array([
                _r(xx, dd if dd is not None else 0)
                for xx, dd in zip(np.atleast_1d(x), np.atleast_1d(d))
            ]),
            args[0], args[1],
        )
    if name == "trunc":
        want(1, 2)
        if len(args) == 2:
            return _mapnum(
                lambda x, d: np.trunc(x * 10.0 ** d) / 10.0 ** d,
                args[0], args[1],
            )
        return _mapnum(lambda x: np.trunc(x), args[0])
    if name == "sqrt":
        want(1)
        return _mapnum(np.sqrt, args[0])
    if name == "cbrt":
        want(1)
        return _mapnum(np.cbrt, args[0])
    if name == "exp":
        want(1)
        return _mapnum(np.exp, args[0])
    if name == "ln":
        want(1)
        return _mapnum(np.log, args[0])
    if name == "log":
        want(1, 2)
        if len(args) == 1:
            return _mapnum(np.log10, args[0])
        return _mapnum(lambda b, x: np.log(x) / np.log(b), args[0], args[1])
    if name == "log10":
        want(1)
        return _mapnum(np.log10, args[0])
    if name == "log2":
        want(1)
        return _mapnum(np.log2, args[0])
    if name in ("power", "pow"):
        want(2)
        return _mapnum(np.power, args[0], args[1])
    if name == "mod":
        want(2)
        from turdb_tpu_torch.sql.expr import _binary_numeric

        return _binary_numeric("%", args[0], args[1])
    if name == "sign":
        want(1)
        return _mapnum(np.sign, args[0])
    if name == "pi":
        return Col.const(math.pi, n)
    if name == "degrees":
        want(1)
        return _mapnum(np.degrees, args[0])
    if name == "radians":
        want(1)
        return _mapnum(np.radians, args[0])
    if name in ("sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh"):
        want(1)
        return _mapnum(getattr(np, name), args[0])
    if name == "atan2":
        want(2)
        return _mapnum(np.arctan2, args[0], args[1])
    if name == "gcd":
        want(2)
        return _map(lambda a, b: math.gcd(int(a), int(b)), args[0], args[1])
    if name == "width_bucket":
        want(4)
        return _map(
            lambda x, lo, hi, k: max(
                0, min(int(k) + 1, 1 + int((float(x) - lo) / ((hi - lo) / int(k))))
            ),
            *args,
        )

    # ---- datetime ---------------------------------------------------------
    if name in ("now", "current_timestamp"):
        return Col.const(
            _dt.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f"), n
        )
    if name == "current_date":
        return Col.const(_dt.date.today().isoformat(), n)
    if name == "current_time":
        return Col.const(_dt.datetime.now().time().isoformat(), n)
    if name in ("extract", "date_part"):
        want(2)

        def _part(field, v):
            d = _parse_dt(v)
            f = str(field).lower()
            if f == "year":
                return d.year
            if f == "month":
                return d.month
            if f == "day":
                return d.day
            if f == "hour":
                return d.hour
            if f == "minute":
                return d.minute
            if f == "second":
                return d.second + d.microsecond / 1e6
            if f == "dow":
                return (d.weekday() + 1) % 7
            if f == "doy":
                return d.timetuple().tm_yday
            if f == "epoch":
                return d.timestamp()
            if f == "week":
                return d.isocalendar()[1]
            if f == "quarter":
                return (d.month - 1) // 3 + 1
            raise SqlError(f"bad extract field {field}")

        return _map(_part, args[0], args[1])
    if name == "date_trunc":
        want(2)

        def _trunc(field, v):
            d = _parse_dt(v)
            f = str(field).lower()
            if f == "year":
                d = d.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
            elif f == "month":
                d = d.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
            elif f == "day":
                d = d.replace(hour=0, minute=0, second=0, microsecond=0)
            elif f == "hour":
                d = d.replace(minute=0, second=0, microsecond=0)
            elif f == "minute":
                d = d.replace(second=0, microsecond=0)
            elif f == "second":
                d = d.replace(microsecond=0)
            else:
                raise SqlError(f"bad date_trunc field {field}")
            return d.strftime("%Y-%m-%d %H:%M:%S")

        return _map(_trunc, args[0], args[1])
    if name in ("date_add", "date_sub"):
        want(2)
        sign = 1 if name == "date_add" else -1

        def _dshift(v, days):
            d = _parse_dt(v) + sign * _dt.timedelta(days=float(days))
            if len(str(v).strip()) <= 10:        # date in, date out
                return d.date().isoformat()
            return d.strftime("%Y-%m-%d %H:%M:%S.%f").rstrip("0").rstrip(".")

        return _map(_dshift, args[0], args[1])
    if name == "age":
        want(2)
        return _map(
            lambda a, b: int(
                (_parse_dt(a) - _parse_dt(b)).total_seconds() * 1e6
            ),
            args[0], args[1],
        )
    if name == "to_timestamp":
        want(1)
        return _map(
            lambda s: _dt.datetime.fromtimestamp(float(s)).strftime(
                "%Y-%m-%d %H:%M:%S"
            ),
            args[0],
        )
    if name == "strftime":
        want(2)
        return _map(lambda f, v: _parse_dt(v).strftime(str(f)), args[0], args[1])
    if name in (
        "date", "time", "year", "month", "day", "hour", "minute", "second",
        "dayname", "monthname", "dayofweek", "dayofyear", "quarter", "week",
        "last_day",
    ):
        want(1)

        def _dx(v):
            d = _parse_dt(v)
            if name == "date":
                return d.date().isoformat()
            if name == "time":
                return d.time().isoformat()
            if name == "year":
                return d.year
            if name == "month":
                return d.month
            if name == "day":
                return d.day
            if name == "hour":
                return d.hour
            if name == "minute":
                return d.minute
            if name == "second":
                return d.second
            if name == "dayname":
                return d.strftime("%A")
            if name == "monthname":
                return d.strftime("%B")
            if name == "dayofweek":
                return d.isoweekday() % 7 + 1      # 1 = Sunday (MySQL)
            if name == "dayofyear":
                return d.timetuple().tm_yday
            if name == "quarter":
                return (d.month - 1) // 3 + 1
            if name == "week":
                return d.isocalendar()[1]
            import calendar

            return d.date().replace(
                day=calendar.monthrange(d.year, d.month)[1]
            ).isoformat()

        return _map(_dx, args[0])
    if name == "datediff":
        want(2)
        return _map(
            lambda a, b: (_parse_dt(a).date() - _parse_dt(b).date()).days,
            args[0], args[1],
        )
    if name == "date_format":
        want(2)
        # MySQL format tokens -> strftime (%i minutes, %M month name, ...)
        _tok = {"%M": "%B", "%i": "%M", "%s": "%S", "%W": "%A", "%e": "%d"}

        def _df(v, fmt):
            f = str(fmt)
            out, i = "", 0
            while i < len(f):
                if f[i] == "%" and i + 1 < len(f):
                    t = f[i : i + 2]
                    out += _tok.get(t, t)
                    i += 2
                else:
                    out += f[i]
                    i += 1
            return _parse_dt(v).strftime(out)

        return _map(_df, args[0], args[1])

    # ---- vector -----------------------------------------------------------
    if name == "vector_dims":
        want(1)
        v = args[0]
        if v.values.ndim == 2:
            return Col(np.full(n, v.values.shape[1], np.int64), v.nulls)
        return _map(
            lambda x: len(parse_vector_text(x) if isinstance(x, str) else x), v
        )
    if name in ("vector_norm", "l2_norm"):
        want(1)
        from turdb_tpu_torch.sql.expr import _as_vector

        vv = _as_vector(args[0], n)
        return Col(np.linalg.norm(vv, axis=-1).astype(np.float64), args[0].nulls)

    # ---- json -------------------------------------------------------------
    if name in ("json_typeof", "jsonb_typeof"):
        want(1)

        def _jt(v):
            if isinstance(v, bool):
                return "boolean"
            if isinstance(v, (int, float)):
                return "number"
            if isinstance(v, str):
                return "string"
            if isinstance(v, list):
                return "array"
            if isinstance(v, dict):
                return "object"
            return "null"

        return _map(_jt, args[0])
    if name in ("json_array_length", "jsonb_array_length"):
        want(1)
        return _map(lambda v: len(v) if isinstance(v, list) else 0, args[0])
    if name in ("array_length", "cardinality"):
        want(1, 2)
        return _map(
            lambda v: len(v) if isinstance(v, (list, tuple, np.ndarray)) else None,
            args[0],
        )

    # ---- MySQL-family tail (reference string.rs/numeric.rs/datetime.rs/
    # system.rs dispatch names) --------------------------------------------
    if name == "space":
        want(1)
        return _map(lambda k: " " * max(int(k), 0), args[0])
    if name == "field":
        # 1-based index of args[0] among the rest; 0 when absent/NULL
        want(2, 99)
        first, rest = args[0], args[1:]
        out = np.zeros(n, np.int64)
        for j, c in enumerate(rest):
            hit = np.zeros(n, bool)
            for i in range(n):
                if (not first.nulls[i] and not c.nulls[i] and out[i] == 0
                        and str(first.values[i]) == str(c.values[i])):
                    hit[i] = True
            out[hit] = j + 1
        return Col(out, np.zeros(n, bool))
    if name == "find_in_set":
        want(2)

        def _fis(s, lst):
            parts = str(lst).split(",")
            return parts.index(str(s)) + 1 if str(s) in parts else 0

        return _map(_fis, args[0], args[1])
    if name == "substring_index":
        want(3)

        def _si(s, d, c):
            s, d, c = str(s), str(d), int(c)
            if not d:
                return ""
            parts = s.split(d)
            if c > 0:
                return d.join(parts[:c])
            if c < 0:
                return d.join(parts[max(len(parts) + c, 0):])
            return ""

        return _map(_si, args[0], args[1], args[2])
    if name == "insert":
        want(4)

        def _ins(s, pos, ln, new):
            s, pos, ln = str(s), int(pos), int(ln)
            if pos < 1 or pos > len(s):
                return s
            return s[: pos - 1] + str(new) + s[pos - 1 + max(ln, 0):]

        return _map(_ins, args[0], args[1], args[2], args[3])
    if name == "bin":
        want(1)
        return _map(lambda x: format(int(x), "b"), args[0])
    if name == "hex":
        want(1)
        return _map(
            lambda v: (v.hex() if isinstance(v, bytes)
                       else format(v, "X") if isinstance(v, int)
                       else str(v).encode().hex()).upper(),
            args[0],
        )
    if name == "unhex":
        want(1)
        return _map(lambda s: bytes.fromhex(str(s)), args[0])
    if name == "lcm":
        want(2)
        return _map(lambda a, b: math.lcm(int(a), int(b)), args[0], args[1])
    if name == "conv":
        want(3)

        def _conv(s, fb, tb):
            v = int(str(s), int(fb))
            tb = int(tb)
            if tb == 10:
                return str(v)
            digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
            out = ""
            x = abs(v)
            while x:
                out = digits[x % tb] + out
                x //= tb
            return ("-" if v < 0 else "") + (out or "0")

        return _map(_conv, args[0], args[1], args[2])
    if name == "cot":
        want(1)
        return _mapnum(lambda x: 1.0 / np.tan(x), args[0])
    if name == "div":
        # integer division, truncating toward zero (MySQL DIV)
        want(2)

        def _div(a, b):
            b = int(b)
            if b == 0:
                return None
            q = abs(int(a)) // abs(b)
            return -q if (int(a) < 0) != (b < 0) else q

        return _map(_div, args[0], args[1])
    if name == "isnull":
        want(1)
        return Col(args[0].nulls.astype(bool).copy(), np.zeros(n, bool))
    if name == "user":
        return Col.const("turdb", n)
    if name == "connection_id":
        return Col.const(0, n)
    if name == "last_insert_id":
        db = getattr(ctx, "db", None)
        return Col.const(getattr(db, "last_insert_id", 0) if db else 0, n)
    if name == "to_days":
        want(1)
        return _map(lambda v: _parse_dt(v).date().toordinal() + 365, args[0])
    if name == "from_days":
        want(1)
        return _map(
            lambda d: _dt.date.fromordinal(max(int(d) - 365, 1)).isoformat(),
            args[0],
        )
    if name == "makedate":
        want(2)

        def _md(y, doy):
            doy = int(doy)
            if doy < 1:
                return None
            return (_dt.date(int(y), 1, 1)
                    + _dt.timedelta(days=doy - 1)).isoformat()

        return _map(_md, args[0], args[1])
    if name == "maketime":
        want(3)
        return _map(
            lambda h, m, s: f"{int(h):02d}:{int(m):02d}:{int(s):02d}",
            args[0], args[1], args[2],
        )
    if name == "microsecond":
        want(1)
        return _map(lambda v: _parse_dt(v).microsecond, args[0])
    if name == "period_add":
        want(2)

        def _pa(p, m):
            p, m = int(p), int(m)
            months = (p // 100) * 12 + (p % 100) - 1 + m
            return (months // 12) * 100 + months % 12 + 1

        return _map(_pa, args[0], args[1])
    if name == "period_diff":
        want(2)
        return _map(
            lambda a, b: ((int(a) // 100) * 12 + int(a) % 100)
            - ((int(b) // 100) * 12 + int(b) % 100),
            args[0], args[1],
        )
    if name == "sec_to_time":
        want(1)
        return _map(lambda s: _secs_time(float(s)), args[0])
    if name == "time_to_sec":
        want(1)
        return _map(lambda t: int(_time_secs(t)), args[0])
    if name == "str_to_date":
        want(2)
        _tok = {"%i": "%M", "%s": "%S", "%e": "%d"}

        def _std(s, fmt):
            f = str(fmt)
            for k, v in _tok.items():
                f = f.replace(k, v)
            d = _dt.datetime.strptime(str(s), f)
            if "%H" in f or "%M" in f or "%S" in f:
                return d.strftime("%Y-%m-%d %H:%M:%S")
            return d.date().isoformat()

        return _map(_std, args[0], args[1])
    if name in ("timediff", "subtime", "addtime"):
        want(2)
        sign = 1 if name == "addtime" else -1

        def _td(a, b):
            def secs(v):
                try:
                    return _time_secs(v)
                except (SqlError, ValueError):
                    return _parse_dt(v).timestamp()

            if name in ("addtime", "subtime") and "-" in str(a):
                # timestamp ± time -> timestamp
                d = _parse_dt(a) + _dt.timedelta(seconds=sign * secs(b))
                return d.strftime("%Y-%m-%d %H:%M:%S")
            return _secs_time(secs(a) + sign * secs(b))

        return _map(_td, args[0], args[1])
    if name == "timestamp":
        want(1)
        return _map(
            lambda v: _parse_dt(v).strftime("%Y-%m-%d %H:%M:%S"), args[0]
        )
    if name == "time_format":
        want(2)
        _tok = {"%i": "%M", "%s": "%S", "%H": "%H", "%h": "%I"}

        def _tf(t, fmt):
            f = str(fmt)
            out, i = "", 0
            while i < len(f):
                if f[i] == "%" and i + 1 < len(f):
                    out += _tok.get(f[i:i + 2], f[i:i + 2])
                    i += 2
                else:
                    out += f[i]
                    i += 1
            return _parse_dt(t).strftime(out)

        return _map(_tf, args[0], args[1])
    if name == "weekday":
        # Monday = 0 (MySQL WEEKDAY)
        want(1)
        return _map(lambda v: _parse_dt(v).weekday(), args[0])
    if name == "yearweek":
        want(1)

        def _yw(v):
            d = _parse_dt(v)
            iso = d.isocalendar()
            return iso[0] * 100 + iso[1]

        return _map(_yw, args[0])

    # ---- user-defined SQL functions (CREATE FUNCTION) ---------------------
    db = getattr(ctx, "db", None)
    if db is not None:
        fdef = db.functions.get("main", {}).get(name)
        if fdef is not None:
            if len(args) != len(fdef["params"]):
                raise SqlError(
                    f"{name}() takes {len(fdef['params'])} arguments, "
                    f"got {len(args)}"
                )
            body_ast = fdef.get("_ast")
            if body_ast is None:
                body_ast = fdef["_ast"] = parse_function_body(fdef["body"])
            depth = getattr(ctx, "_udf_depth", 0)
            if depth > 16:
                raise SqlError(f"{name}(): user function recursion too deep")
            sub = Batch(n)
            for pn, c in zip(fdef["params"], args):
                sub.add(None, pn, c)
            ctx._udf_depth = depth + 1
            try:
                return eval_expr(body_ast, sub, ctx)
            finally:
                ctx._udf_depth = depth

    raise SqlError(f"unknown function: {name}()")


def parse_function_body(body: str):
    """A function body is a scalar expression or a single-item SELECT
    without FROM (reference parse_function_body takes the string form)."""
    from turdb_tpu_torch.sql.parser import Parser, parse_sql

    text = body.strip().rstrip(";")
    if text[:6].upper() == "SELECT":
        sel = parse_sql(text)
        if (not isinstance(sel, A.Select) or sel.from_ is not None
                or len(sel.items) != 1 or sel.where is not None):
            raise SqlError(
                "function bodies must be a scalar expression or a "
                "single-item SELECT without FROM"
            )
        return sel.items[0].expr
    p = Parser(text)
    e = p._expr()
    if p.peek().type.value != "eof":
        raise SqlError("function body has trailing input")
    return e
