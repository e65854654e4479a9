"""Host memory budget: 25% of RAM (min 4MB) split into reserved pools
Cache/Query/Recovery/Schema with shared overflow (reference
src/memory/budget.rs:5-25,165, mod.rs:5-35)."""

from __future__ import annotations

import os

from turdb_tpu_torch.config import MEMORY_BUDGET_FRACTION, MEMORY_BUDGET_MIN

_POOL_FRACTIONS = {
    "cache": 0.40,
    "query": 0.30,
    "recovery": 0.20,
    "schema": 0.10,
}


def _total_ram() -> int:
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        return pages * page_size
    except (ValueError, OSError):
        return 8 * 1024**3


class MemoryBudget:
    def __init__(self, total: int):
        self.total = max(total, MEMORY_BUDGET_MIN)
        self._used: dict[str, int] = {k: 0 for k in _POOL_FRACTIONS}

    @classmethod
    def auto_detect(cls) -> "MemoryBudget":
        return cls(int(_total_ram() * MEMORY_BUDGET_FRACTION))

    def pool(self, name: str) -> int:
        return int(self.total * _POOL_FRACTIONS[name])

    def try_reserve(self, pool: str, nbytes: int) -> bool:
        if self._used[pool] + nbytes > self.pool(pool):
            return False
        self._used[pool] += nbytes
        return True

    def release(self, pool: str, nbytes: int):
        self._used[pool] = max(0, self._used[pool] - nbytes)

    def used(self, pool: str) -> int:
        return self._used[pool]

    def stats(self) -> list[tuple]:
        """(pool, budget, used) rows for PRAGMA memory_stats; the
        turdb_catalog.memory_stats system table uses the reference's
        key-value schema instead (system_tables.rs:58-66)."""
        out = [("total", self.total, sum(self._used.values()))]
        for name in _POOL_FRACTIONS:
            out.append((name, self.pool(name), self._used[name]))
        return out
