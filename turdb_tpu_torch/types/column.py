"""Column definitions (reference src/types/column.rs:39: name, type, and
per-type metadata — varchar length, vector dim, decimal precision — plus
constraint flags used by the DDL/constraint layers)."""

from __future__ import annotations

import dataclasses

from turdb_tpu_torch.types.datatype import DataType


@dataclasses.dataclass
class ColumnDef:
    name: str
    dtype: DataType
    nullable: bool = True
    primary_key: bool = False
    unique: bool = False
    default: object = None          # AST expression or literal
    has_default: bool = False
    check: object = None            # AST expression
    references: tuple | None = None  # (table, column, on_delete, on_update)
    # type parameters
    max_len: int | None = None      # VARCHAR(n) / CHAR(n)
    vector_dim: int | None = None   # VECTOR(d)
    precision: int | None = None    # DECIMAL(p, s)
    scale: int | None = None
    auto_increment: bool = False    # SERIAL / BIGSERIAL
    enum_values: list | None = None   # ENUM labels (CREATE TYPE .. AS ENUM)
    type_name: str | None = None      # user-defined type name, if any

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dtype"] = int(self.dtype)
        # AST nodes aren't JSON-serializable; persist their SQL rendering.
        # Render from the LIVE attribute: asdict() already recursed the
        # dataclass expr into a plain dict (str() of that gave
        # "{'value': 7}", which broke defaults after reopen)
        for k in ("default", "check"):
            v = getattr(self, k)
            if v is not None and not isinstance(v, (int, float, str, bool)):
                from turdb_tpu_torch.sql.ast import render_expr

                d[k] = render_expr(v)
            else:
                d[k] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ColumnDef":
        d = dict(d)
        d["dtype"] = DataType(d["dtype"])
        if d.get("references") is not None:
            d["references"] = tuple(d["references"])
        return cls(**d)
