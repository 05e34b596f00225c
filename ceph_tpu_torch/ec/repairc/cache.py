"""Per-signature repair-program cache.

Generalizes the decode-matrix LRU (matrix_code.DecodeTableCache —
cost-weighted, thread-safe) from decode *matrices* to compiled repair
*programs*: the LRU stores RepairProgram objects weighted by their
matrix footprint, and a per-signature compile counter provides the
"exactly one compile per erasure signature" evidence the repair checks
assert.

One cache per plugin instance (a daemon shares one plugin instance
per profile across all its PGs, so this is also one cache per
profile), attached lazily via `cache_of(ec)`.

The port's copy of `ceph_tpu.ec.repairc.cache`, with the reference's
`make_lock` names.  Each compile also counts under the device guard
(common/devguard.py, site "repairc"): a cache that compiles a signature
twice trips it.
"""
from __future__ import annotations

import itertools

from ...common import devguard
from ...common.lockdep import make_lock
from ..matrix_code import DecodeTableCache
from .compiler import compile_program
from .plan import RepairPlan

#: default capacity in matrix bytes — ~256 full double-erasure
#: programs of a wide code; single-signature steady state uses one
DEFAULT_CAPACITY = 1 << 20

_attach_lock = make_lock("ec.repairc.attach")
_serials = itertools.count()


class RepairProgramCache:
    """Cost-weighted LRU of compiled repair programs + compile stats."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lru = DecodeTableCache(capacity)
        self._lock = make_lock("ec.repairc.stats")
        self._compiles: dict[str, int] = {}
        self._hits = 0
        #: tells this cache's signatures apart from another's in the guard
        self._serial = next(_serials)

    def __len__(self) -> int:
        return len(self._lru)

    def total_cost(self) -> int:
        return self._lru.total_cost()

    def get_or_compile(self, ec, plan: RepairPlan):
        sig = plan.signature()
        prog = self._lru.get(sig)
        if prog is not None:
            with self._lock:
                self._hits += 1
            return prog
        prog = compile_program(ec, plan)
        self._lru.put(sig, prog, cost=prog.cost())
        with self._lock:
            self._compiles[sig] = self._compiles.get(sig, 0) + 1
        devguard.count_compile("repairc", f"cache{self._serial}:{sig}")
        return prog

    def stats(self) -> dict:
        """{"hits", "compiles": {sig: count}} — the compile-once check
        reads this: every signature's count must be exactly 1 (an
        evicted-then-recompiled signature legitimately exceeds it, so
        checks size the capacity above their working set)."""
        with self._lock:
            return {"hits": self._hits,
                    "compiles": dict(self._compiles)}


def cache_of(ec) -> RepairProgramCache:
    """The plugin instance's program cache (lazily attached)."""
    cache = getattr(ec, "_repairc_cache", None)
    if cache is None:
        with _attach_lock:
            cache = getattr(ec, "_repairc_cache", None)
            if cache is None:
                cache = RepairProgramCache()
                ec._repairc_cache = cache
    return cache


def program_for(ec, plan: RepairPlan):
    """Compiled program for this plugin + plan, through the cache."""
    return cache_of(ec).get_or_compile(ec, plan)
