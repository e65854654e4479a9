"""Range and geometry value semantics (reference src/types/data_type.rs:
97-106: Int4Range/Int8Range/DateRange/TimestampRange, Box, Circle).

Values are STORED as canonical text (like the temporal types — see
types/datatype.py storage notes): parsing/validation happens at the
coercion boundary, operators (`@>`, `<@`, `&&`) parse on demand.
Discrete ranges (int, date) canonicalize to the `[lo,hi)` normal form
exactly as PostgreSQL does, so equal ranges compare equal as text.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re

_RANGE_RE = re.compile(r"^\s*([\[\(])\s*([^,\]\)]*?)\s*,\s*([^,\]\)]*?)\s*([\]\)])\s*$")
_BOX_RE = re.compile(
    r"^\s*\(?\s*\(\s*(-?[\d.eE+]+)\s*,\s*(-?[\d.eE+]+)\s*\)\s*,"
    r"\s*\(\s*(-?[\d.eE+]+)\s*,\s*(-?[\d.eE+]+)\s*\)\s*\)?\s*$"
)
_CIRCLE_RE = re.compile(
    r"^\s*<\s*\(\s*(-?[\d.eE+]+)\s*,\s*(-?[\d.eE+]+)\s*\)\s*,"
    r"\s*(-?[\d.eE+]+)\s*>\s*$"
)
_POINT_RE = re.compile(r"^\s*\(?\s*(-?[\d.eE+]+)\s*,\s*(-?[\d.eE+]+)\s*\)?\s*$")


class RangeError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Range:
    """A bounded/unbounded range over a discrete or continuous subtype.

    `lo`/`hi` are None for unbounded ends; `empty` ranges contain
    nothing. `kind` is "int" (discrete step 1), "date" (discrete step
    1 day), or "ts" (continuous)."""

    kind: str
    lo: object = None
    hi: object = None
    lo_inc: bool = True
    hi_inc: bool = False
    empty: bool = False

    def canonical(self) -> "Range":
        if self.empty:
            return Range(self.kind, empty=True)
        lo, hi, lo_inc, hi_inc = self.lo, self.hi, self.lo_inc, self.hi_inc
        if self.kind in ("int", "date"):
            step = 1 if self.kind == "int" else _dt.timedelta(days=1)
            if lo is not None and not lo_inc:
                lo = lo + step
                lo_inc = True
            if hi is not None and hi_inc:
                hi = hi + step
                hi_inc = False
        if lo is not None and hi is not None:
            if lo > hi or (lo == hi and not (lo_inc and hi_inc)):
                return Range(self.kind, empty=True)
        return Range(self.kind, lo, hi, lo_inc, hi_inc)

    # -- predicates --------------------------------------------------------

    def contains_value(self, v) -> bool:
        if self.empty:
            return False
        if self.lo is not None:
            if v < self.lo or (v == self.lo and not self.lo_inc):
                return False
        if self.hi is not None:
            if v > self.hi or (v == self.hi and not self.hi_inc):
                return False
        return True

    def contains_range(self, o: "Range") -> bool:
        if o.empty:
            return True
        if self.empty:
            return False
        if self.lo is not None:
            if o.lo is None:
                return False
            if o.lo < self.lo or (
                o.lo == self.lo and o.lo_inc and not self.lo_inc
            ):
                return False
        if self.hi is not None:
            if o.hi is None:
                return False
            if o.hi > self.hi or (
                o.hi == self.hi and o.hi_inc and not self.hi_inc
            ):
                return False
        return True

    def overlaps(self, o: "Range") -> bool:
        if self.empty or o.empty:
            return False

        def below(a: "Range", b: "Range") -> bool:
            # a entirely below b?
            if a.hi is None or b.lo is None:
                return False
            if a.hi < b.lo:
                return True
            return a.hi == b.lo and not (a.hi_inc and b.lo_inc)

        return not (below(self, o) or below(o, self))

    def render(self) -> str:
        if self.empty:
            return "empty"
        lo = "" if self.lo is None else _rend(self.kind, self.lo)
        hi = "" if self.hi is None else _rend(self.kind, self.hi)
        return (
            ("[" if self.lo_inc and self.lo is not None else "(")
            + lo + "," + hi
            + ("]" if self.hi_inc and self.hi is not None else ")")
        )

    def __str__(self):
        return self.render()


def _rend(kind, v) -> str:
    if kind == "int":
        return str(int(v))
    if kind == "date":
        return v.isoformat()
    return v.isoformat(sep=" ") if isinstance(v, _dt.datetime) else str(v)


def _parse_bound(kind: str, s: str):
    s = s.strip().strip('"')
    if not s:
        return None
    if kind == "int":
        return int(s)
    if kind == "date":
        return _dt.date.fromisoformat(s)
    # timestamp
    return _dt.datetime.fromisoformat(s.replace("T", " ").strip())


def parse_range(text: str, kind: str) -> Range:
    t = text.strip()
    if t.lower() == "empty":
        return Range(kind, empty=True)
    m = _RANGE_RE.match(t)
    if not m:
        raise RangeError(f"invalid range literal: {text!r}")
    lo = _parse_bound(kind, m.group(2))
    hi = _parse_bound(kind, m.group(3))
    return Range(
        kind, lo, hi, m.group(1) == "[", m.group(4) == "]"
    ).canonical()


# ---------------------------------------------------------------------------
# geometry (reference data_type.rs Box / Circle)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Box:
    x1: float
    y1: float
    x2: float
    y2: float

    def canonical(self) -> "Box":
        return Box(
            max(self.x1, self.x2), max(self.y1, self.y2),
            min(self.x1, self.x2), min(self.y1, self.y2),
        )

    def contains_point(self, x, y) -> bool:
        return self.x2 <= x <= self.x1 and self.y2 <= y <= self.y1

    def contains_box(self, o: "Box") -> bool:
        return (
            o.x1 <= self.x1 and o.x2 >= self.x2
            and o.y1 <= self.y1 and o.y2 >= self.y2
        )

    def overlaps(self, o: "Box") -> bool:
        return not (
            self.x1 < o.x2 or o.x1 < self.x2
            or self.y1 < o.y2 or o.y1 < self.y2
        )

    def render(self) -> str:
        return f"({_g(self.x1)},{_g(self.y1)}),({_g(self.x2)},{_g(self.y2)})"

    def __str__(self):
        return self.render()


@dataclasses.dataclass(frozen=True)
class Circle:
    x: float
    y: float
    r: float

    def contains_point(self, x, y) -> bool:
        return (x - self.x) ** 2 + (y - self.y) ** 2 <= self.r**2

    def contains_circle(self, o: "Circle") -> bool:
        d = ((o.x - self.x) ** 2 + (o.y - self.y) ** 2) ** 0.5
        return d + o.r <= self.r

    def overlaps(self, o: "Circle") -> bool:
        d2 = (o.x - self.x) ** 2 + (o.y - self.y) ** 2
        return d2 <= (self.r + o.r) ** 2

    def render(self) -> str:
        return f"<({_g(self.x)},{_g(self.y)}),{_g(self.r)}>"

    def __str__(self):
        return self.render()


def _g(v: float) -> str:
    return f"{v:g}"


def parse_box(text: str) -> Box:
    m = _BOX_RE.match(text.strip())
    if not m:
        raise RangeError(f"invalid box literal: {text!r}")
    return Box(*(float(m.group(i)) for i in range(1, 5))).canonical()


def parse_circle(text: str) -> Circle:
    m = _CIRCLE_RE.match(text.strip())
    if not m:
        raise RangeError(f"invalid circle literal: {text!r}")
    return Circle(float(m.group(1)), float(m.group(2)), float(m.group(3)))


def parse_point(text: str):
    m = _POINT_RE.match(str(text).strip())
    if not m:
        return None
    return float(m.group(1)), float(m.group(2))


# ---------------------------------------------------------------------------
# operator dispatch over TEXT-stored values
# ---------------------------------------------------------------------------

_KIND_BY_TYPE = {
    "INT4RANGE": "int", "INT8RANGE": "int",
    "DATERANGE": "date", "TSRANGE": "ts", "TSTZRANGE": "ts",
}


def sniff(text):
    """Best-effort parse of a stored text value into a Range/Box/Circle
    (operator dispatch has no column-type info at eval time). Returns
    None when the text is not a recognizable range/geometry literal."""
    if not isinstance(text, str):
        return text if isinstance(text, (Range, Box, Circle)) else None
    t = text.strip()
    if t.lower() == "empty":
        return Range("int", empty=True)
    if t.startswith("<"):
        try:
            return parse_circle(t)
        except RangeError:
            return None
    m = _RANGE_RE.match(t)
    if m:
        for kind in ("int", "date", "ts"):
            try:
                return parse_range(t, kind)
            except (RangeError, ValueError):
                continue
        return None
    try:
        return parse_box(t)
    except RangeError:
        return None


def geo_contains(a, b) -> bool | None:
    """a @> b over sniffed values; None = not a geometric pair."""
    ga = sniff(a)
    if ga is None:
        return None
    if isinstance(ga, Range):
        gb = sniff(b)
        if isinstance(gb, Range):
            return ga.contains_range(gb)
        v = _coerce_elem(ga.kind, b)
        return None if v is None else ga.contains_value(v)
    if isinstance(ga, Box):
        gb = sniff(b)
        if isinstance(gb, Box):
            return ga.contains_box(gb)
        p = parse_point(b) if isinstance(b, str) else None
        return None if p is None else ga.contains_point(*p)
    if isinstance(ga, Circle):
        gb = sniff(b)
        if isinstance(gb, Circle):
            return ga.contains_circle(gb)
        p = parse_point(b) if isinstance(b, str) else None
        return None if p is None else ga.contains_point(*p)
    return None


def geo_overlaps(a, b) -> bool | None:
    ga, gb = sniff(a), sniff(b)
    if ga is None or gb is None:
        return None
    if isinstance(ga, Range) and isinstance(gb, Range):
        # align kinds (sniff may guess int for an unbounded side)
        if ga.kind != gb.kind:
            gb = dataclasses.replace(gb, kind=ga.kind)
        return ga.overlaps(gb)
    if isinstance(ga, Box) and isinstance(gb, Box):
        return ga.overlaps(gb)
    if isinstance(ga, Circle) and isinstance(gb, Circle):
        return ga.overlaps(gb)
    return None


def _coerce_elem(kind: str, v):
    try:
        if kind == "int":
            return int(v)
        if kind == "date":
            return _dt.date.fromisoformat(str(v))
        return _dt.datetime.fromisoformat(str(v).replace("T", " "))
    except (TypeError, ValueError):
        return None


def canonical_text(text: str, type_name: str) -> str:
    """Validate + canonicalize a literal for storage (the coercion
    boundary; reference data_type.rs range/geometry types)."""
    tn = type_name.upper()
    if tn in _KIND_BY_TYPE:
        return parse_range(text, _KIND_BY_TYPE[tn]).render()
    if tn == "BOX":
        return parse_box(text).render()
    if tn == "CIRCLE":
        return parse_circle(text).render()
    raise RangeError(f"not a range/geometry type: {type_name}")
