"""MVCC: snapshot isolation over columnar version arrays.

Counterpart of reference src/mvcc/ (SURVEY.md §2.5), re-based for a
columnar engine: instead of a 17-byte header prepended to every B-tree
value with undo-page version chains (record_header.rs:49-80,
undo_page.rs), every row VERSION is a row in the columnar store carrying
(xmin, xmax) transaction stamps — and visibility for a whole batch is one
vectorized predicate over those stamp columns (the reference's per-row
`check_row_visibility`, mvcc_scan.rs:210, becomes a numpy/device mask).
Same semantic contract: snapshot isolation, readers never block,
single-writer-per-row, commit-timestamp visibility via a commit log
(transaction.rs:104).
"""

from turdb_tpu_torch.mvcc.manager import (  # noqa: F401
    Transaction,
    TransactionManager,
    TxnConflict,
)
