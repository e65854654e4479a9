"""Interactive CLI (reference src/cli/ + src/bin/turdb.rs: REPL with
multi-line SQL, dot-commands, ASCII tables, history)."""

from turdb_tpu_torch.cli.repl import Repl, main  # noqa: F401
