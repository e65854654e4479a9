"""Type system: canonical data types and value handling.

Counterpart of reference src/types/ (data_type.rs:71 ~40-type repr(u8)
enum, value.rs zero-copy Value, owned_value.rs) re-based on a columnar
engine: the canonical in-memory representation is a typed COLUMN (numpy
array + null mask), not a row value; scalar Values appear only at API
edges (bind params, results, literals).
"""

from turdb_tpu_torch.types.datatype import DataType, StorageClass  # noqa: F401
from turdb_tpu_torch.types.column import ColumnDef  # noqa: F401
