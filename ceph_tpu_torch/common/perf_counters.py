"""Perf counters: typed metric registry with a `perf dump` JSON view.

Models the reference's PerfCounters machinery (ref:
src/common/perf_counters.h:150 — PerfCountersBuilder add_u64_counter /
add_u64 / add_time_avg / add_u64_avg, collection registered per
subsystem and dumped over the admin socket as `perf dump`,
src/common/admin_socket.cc).  Counter kinds mirror PERFCOUNTER_U64 /
_LONGRUNAVG / _TIME / _HISTOGRAM.

The port's copy of `ceph_tpu.common.perf_counters` (ECBackend's `perf`
sink carries the recovery read/rebuilt byte pair); the locks keep the
reference's lockdep names.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from .lockdep import make_lock


U64 = "u64"            # monotonically increasing counter
GAUGE = "gauge"        # settable level
LONGRUNAVG = "avg"     # (sum, count) pair -> average
TIME = "time"          # seconds accumulated (float)
HISTOGRAM = "hist"     # fixed power-of-two buckets
LATHIST = "lathist"    # latency buckets + sum/count (prometheus
                       # histogram family shape: _bucket/_sum/_count)


@dataclass
class _Counter:
    kind: str
    description: str = ""
    value: float = 0
    sum: float = 0.0
    count: int = 0
    buckets: list = field(default_factory=list)


class PerfCounters:
    """One subsystem's counters (e.g. 'osd.3', 'ec_bench')."""

    #: histogram bucket upper bounds (power-of-two byte/latency buckets)
    HIST_BOUNDS = [2 ** i for i in range(1, 33)]
    #: latency histogram upper bounds in seconds — the SLO buckets the
    #: prometheus exporter publishes as a real histogram family (one
    #: implicit +Inf bucket rides at the end)
    LAT_BOUNDS = [0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                  0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                  10.0, 30.0, 60.0]

    def __init__(self, name: str):
        self.name = name
        self._c: dict[str, _Counter] = {}
        self._lock = make_lock(f"perf.{name}")

    # -- builder surface (ref: perf_counters.h PerfCountersBuilder) --
    def add_u64_counter(self, key: str, desc: str = "") -> None:
        # idempotent: re-registration (e.g. a restarted daemon reusing
        # its name) must not zero live counts
        if key not in self._c:
            self._c[key] = _Counter(U64, desc)

    def add_u64(self, key: str, desc: str = "") -> None:
        self._c[key] = _Counter(GAUGE, desc)

    def add_u64_avg(self, key: str, desc: str = "") -> None:
        self._c[key] = _Counter(LONGRUNAVG, desc)

    def add_time(self, key: str, desc: str = "") -> None:
        self._c[key] = _Counter(TIME, desc)

    def add_time_avg(self, key: str, desc: str = "") -> None:
        self._c[key] = _Counter(LONGRUNAVG, desc)

    def add_histogram(self, key: str, desc: str = "") -> None:
        self._c[key] = _Counter(
            HISTOGRAM, desc, buckets=[0] * (len(self.HIST_BOUNDS) + 1))

    def add_latency_histogram(self, key: str, desc: str = "") -> None:
        """Latency histogram over LAT_BOUNDS with sum+count — the
        per-op-class SLO metric kind.  Idempotent like
        add_u64_counter: a restarted daemon reusing its name must not
        zero live samples."""
        if key not in self._c:
            self._c[key] = _Counter(
                LATHIST, desc,
                buckets=[0] * (len(self.LAT_BOUNDS) + 1))

    # -- update surface --
    def inc(self, key: str, amount: float = 1) -> None:
        with self._lock:
            c = self._c[key]
            if c.kind == LONGRUNAVG:
                c.sum += amount
                c.count += 1
            else:
                c.value += amount

    def dec(self, key: str, amount: float = 1) -> None:
        with self._lock:
            self._c[key].value -= amount

    def set(self, key: str, value: float) -> None:
        with self._lock:
            self._c[key].value = value

    def tinc(self, key: str, seconds: float) -> None:
        """Accumulate elapsed time (ref: perf_counters tinc)."""
        with self._lock:
            c = self._c[key]
            if c.kind == LONGRUNAVG:
                c.sum += seconds
                c.count += 1
            else:
                c.value += seconds

    def hinc(self, key: str, sample: float) -> None:
        with self._lock:
            c = self._c[key]
            for i, bound in enumerate(self.HIST_BOUNDS):
                if sample <= bound:
                    c.buckets[i] += 1
                    return
            c.buckets[-1] += 1

    def hobs(self, key: str, seconds: float) -> None:
        """Observe one latency sample into a LATHIST counter."""
        with self._lock:
            c = self._c[key]
            c.sum += seconds
            c.count += 1
            for i, bound in enumerate(self.LAT_BOUNDS):
                if seconds <= bound:
                    c.buckets[i] += 1
                    return
            c.buckets[-1] += 1

    def time_block(self, key: str):
        """Context manager timing a block into a time/avg counter."""
        pc = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                pc.tinc(key, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def get(self, key: str):
        c = self._c[key]
        if c.kind == LONGRUNAVG:
            return {"avgcount": c.count, "sum": c.sum,
                    "avg": c.sum / c.count if c.count else 0.0}
        if c.kind == HISTOGRAM:
            return list(c.buckets)
        if c.kind == LATHIST:
            return {"bounds": list(self.LAT_BOUNDS),
                    "buckets": list(c.buckets),
                    "sum": c.sum, "count": c.count}
        return c.value

    def dump(self) -> dict:
        with self._lock:
            return {k: self.get(k) for k in self._c}

    def reset(self) -> None:
        with self._lock:
            for c in self._c.values():
                c.value = 0
                c.sum = 0.0
                c.count = 0
                c.buckets = [0] * len(c.buckets)


class PerfCountersCollection:
    """Process-wide registry; `perf dump` equivalent of the admin
    socket (ref: src/common/admin_socket.cc perf dump hook)."""

    def __init__(self):
        self._loggers: dict[str, PerfCounters] = {}
        self._lock = make_lock("perf.collection")

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            pc = self._loggers.get(name)
            if pc is None:
                pc = self._loggers[name] = PerfCounters(name)
            return pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def perf_dump(self) -> dict:
        with self._lock:
            return {name: pc.dump()
                    for name, pc in sorted(self._loggers.items())}

    def perf_dump_json(self) -> str:
        return json.dumps(self.perf_dump(), indent=2, sort_keys=True)


_global_collection: PerfCountersCollection | None = None


def global_perf() -> PerfCountersCollection:
    global _global_collection
    if _global_collection is None:
        _global_collection = PerfCountersCollection()
    return _global_collection
