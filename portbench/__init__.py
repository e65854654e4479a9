"""The port's benchmark: one cell of BENCHMARK.json a run (see README.md)."""
