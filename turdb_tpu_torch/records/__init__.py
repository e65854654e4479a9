"""Record serialization: row format, order-preserving key encoding, varint,
JSONB, arrays.

Counterpart of reference src/records/ + src/encoding/ (SURVEY.md §2.4).
The columnar engine stores data as typed columns; this layer exists for
the serialization *contracts*: WAL row images, order-preserving index
keys, TOAST chunks, JSONB documents — all with the reference's O(1)
column-access property (records/mod.rs:8-22).
"""

from turdb_tpu_torch.records.varint import encode_varint, decode_varint  # noqa: F401
from turdb_tpu_torch.records.keys import encode_key, decode_key  # noqa: F401
from turdb_tpu_torch.records.record import RecordSchema, pack_record, unpack_record  # noqa: F401
from turdb_tpu_torch.records.jsonb import jsonb_encode, jsonb_decode, jsonb_get  # noqa: F401
from turdb_tpu_torch.records.composite import (  # noqa: F401
    CompositeSchema,
    CompositeView,
    pack_composite,
    unpack_composite,
)
