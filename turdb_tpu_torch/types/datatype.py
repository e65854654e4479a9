"""Canonical data types.

Mirrors the reference's DataType repr(u8) inventory (reference
src/types/data_type.rs:71; SQL-visible list README.md:107-141): booleans,
the integer ladder, floats, decimal, text/blob, temporal types, UUID,
JSON/JSONB, VECTOR, arrays, ENUM, INET — with stable u8 codes for the
on-disk catalog and key encoding.
"""

from __future__ import annotations

import enum


class StorageClass(enum.Enum):
    """How a column of this type is stored in the columnar engine."""

    NULL = "null"
    INT = "int"          # numpy int64
    FLOAT = "float"      # numpy float64
    FLOAT32 = "float32"  # numpy float32
    BOOL = "bool"        # numpy bool_
    BYTES = "bytes"      # object array of bytes
    TEXT = "text"        # object array of str
    VECTOR = "vector"    # fixed-dim float32 rows (2-D numpy)
    OBJECT = "object"    # object array (json, arrays, composite)
    DECIMAL = "decimal"  # object array of decimal.Decimal (exact)


class DataType(enum.IntEnum):
    """Stable u8 type codes (catalog + record format + key encoding)."""

    NULL = 0
    BOOLEAN = 1
    TINYINT = 2
    SMALLINT = 3
    INT = 4
    BIGINT = 5
    REAL = 6          # f32
    DOUBLE = 7        # f64
    DECIMAL = 8
    VARCHAR = 9
    CHAR = 10
    TEXT = 11
    BLOB = 12
    DATE = 13
    TIME = 14
    TIMESTAMP = 15
    TIMESTAMPTZ = 16
    INTERVAL = 17
    UUID = 18
    JSON = 19
    JSONB = 20
    VECTOR = 21
    ARRAY = 22
    COMPOSITE = 23
    ENUM = 24
    INET = 25
    MACADDR = 26
    POINT = 27
    SERIAL = 28       # alias: INT w/ auto-increment default
    BIGSERIAL = 29
    # ranges + geometry (reference data_type.rs:97-106); stored as
    # canonical text (types/ranges.py)
    INT4RANGE = 30
    INT8RANGE = 31
    DATERANGE = 32
    TSRANGE = 33
    BOX = 34
    CIRCLE = 35

    @property
    def storage_class(self) -> StorageClass:
        return _STORAGE[self]

    @property
    def is_integer(self) -> bool:
        return self in (
            DataType.TINYINT, DataType.SMALLINT, DataType.INT,
            DataType.BIGINT, DataType.SERIAL, DataType.BIGSERIAL,
        )

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self in (
            DataType.REAL, DataType.DOUBLE, DataType.DECIMAL,
        )

    @property
    def is_textual(self) -> bool:
        return self in (DataType.VARCHAR, DataType.CHAR, DataType.TEXT)

    @classmethod
    def from_sql(cls, name: str) -> "DataType":
        """Parse a SQL type name (sans parameters) to a DataType."""
        key = name.strip().upper()
        if key in _SQL_NAMES:
            return _SQL_NAMES[key]
        raise ValueError(f"unknown type: {name}")


_STORAGE = {
    DataType.NULL: StorageClass.NULL,
    DataType.BOOLEAN: StorageClass.BOOL,
    DataType.TINYINT: StorageClass.INT,
    DataType.SMALLINT: StorageClass.INT,
    DataType.INT: StorageClass.INT,
    DataType.BIGINT: StorageClass.INT,
    DataType.SERIAL: StorageClass.INT,
    DataType.BIGSERIAL: StorageClass.INT,
    DataType.REAL: StorageClass.FLOAT32,
    DataType.DOUBLE: StorageClass.FLOAT,
    # exact decimal (reference src/types/data_type.rs:94): Python Decimal
    # objects in an object column; arithmetic/aggregation stay exact
    DataType.DECIMAL: StorageClass.DECIMAL,
    DataType.VARCHAR: StorageClass.TEXT,
    DataType.CHAR: StorageClass.TEXT,
    DataType.TEXT: StorageClass.TEXT,
    DataType.BLOB: StorageClass.BYTES,
    # temporal types store canonical ISO-8601 text: lexicographic order ==
    # chronological order, so comparisons and index keys work unchanged;
    # date arithmetic parses on demand (sql/functions.py)
    DataType.DATE: StorageClass.TEXT,
    DataType.TIME: StorageClass.TEXT,
    DataType.TIMESTAMP: StorageClass.TEXT,
    DataType.TIMESTAMPTZ: StorageClass.TEXT,
    DataType.INTERVAL: StorageClass.INT,    # microseconds
    DataType.UUID: StorageClass.TEXT,       # canonical 36-char form
    DataType.JSON: StorageClass.TEXT,
    DataType.JSONB: StorageClass.OBJECT,
    DataType.VECTOR: StorageClass.VECTOR,
    DataType.ARRAY: StorageClass.OBJECT,
    DataType.COMPOSITE: StorageClass.OBJECT,
    DataType.ENUM: StorageClass.TEXT,
    DataType.INET: StorageClass.TEXT,
    DataType.MACADDR: StorageClass.TEXT,
    DataType.POINT: StorageClass.OBJECT,
    DataType.INT4RANGE: StorageClass.TEXT,
    DataType.INT8RANGE: StorageClass.TEXT,
    DataType.DATERANGE: StorageClass.TEXT,
    DataType.TSRANGE: StorageClass.TEXT,
    DataType.BOX: StorageClass.TEXT,
    DataType.CIRCLE: StorageClass.TEXT,
}

_SQL_NAMES = {
    "BOOLEAN": DataType.BOOLEAN,
    "BOOL": DataType.BOOLEAN,
    "TINYINT": DataType.TINYINT,
    "SMALLINT": DataType.SMALLINT,
    "INT2": DataType.SMALLINT,
    "INT": DataType.INT,
    "INTEGER": DataType.INT,
    "INT4": DataType.INT,
    "BIGINT": DataType.BIGINT,
    "INT8": DataType.BIGINT,
    "REAL": DataType.REAL,
    "FLOAT4": DataType.REAL,
    "DOUBLE": DataType.DOUBLE,
    "FLOAT": DataType.DOUBLE,
    "FLOAT8": DataType.DOUBLE,
    "DECIMAL": DataType.DECIMAL,
    "NUMERIC": DataType.DECIMAL,
    "VARCHAR": DataType.VARCHAR,
    "CHAR": DataType.CHAR,
    "CHARACTER": DataType.CHAR,
    "TEXT": DataType.TEXT,
    "STRING": DataType.TEXT,
    "BLOB": DataType.BLOB,
    "BYTEA": DataType.BLOB,
    "DATE": DataType.DATE,
    "TIME": DataType.TIME,
    "TIMESTAMP": DataType.TIMESTAMP,
    "TIMESTAMPTZ": DataType.TIMESTAMPTZ,
    "DATETIME": DataType.TIMESTAMP,
    "INTERVAL": DataType.INTERVAL,
    "UUID": DataType.UUID,
    "JSON": DataType.JSON,
    "JSONB": DataType.JSONB,
    "VECTOR": DataType.VECTOR,
    "ENUM": DataType.ENUM,
    "ARRAY": DataType.ARRAY,   # T[] columns (element type in ColumnDef)
    "INET": DataType.INET,
    "MACADDR": DataType.MACADDR,
    "POINT": DataType.POINT,
    "SERIAL": DataType.SERIAL,
    "BIGSERIAL": DataType.BIGSERIAL,
    "INT4RANGE": DataType.INT4RANGE,
    "INT8RANGE": DataType.INT8RANGE,
    "DATERANGE": DataType.DATERANGE,
    "TSRANGE": DataType.TSRANGE,
    "TSTZRANGE": DataType.TSRANGE,
    "TIMESTAMPRANGE": DataType.TSRANGE,
    "BOX": DataType.BOX,
    "CIRCLE": DataType.CIRCLE,
}
