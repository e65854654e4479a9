"""The harness: what every cell shares. Nothing here names a cell, a
configuration, a traffic mix or a per-layer metric; those are files found
by name (spec.py)."""
