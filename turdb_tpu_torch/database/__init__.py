"""Database API layer (reference src/database/, SURVEY.md §2.7):
open/create with recovery, SQL execute/query pipeline, DML with
constraints and index maintenance, transactions, checkpointing, PRAGMAs,
system tables.
"""

from turdb_tpu_torch.database.api import Database, connect, ExecuteResult  # noqa: F401
