"""SQL engine: lexer, parser, planner, columnar executor.

Counterpart of reference src/sql/ (SURVEY.md §2.6) with the execution
model inverted per the build plan (SURVEY.md §7): the host parses, plans
and orchestrates; OPERATORS run on columnar batches (numpy feeding device
kernels for filters/top-k/vector distance) instead of the reference's
per-row Volcano `next()` pull loop — Volcano survives only as the
operator-tree skeleton.
"""

from turdb_tpu_torch.sql.lexer import Lexer, tokenize  # noqa: F401
from turdb_tpu_torch.sql.parser import Parser, parse_sql  # noqa: F401
