"""mClock op-class queue: QoS between client / recovery / scrub work.

dmclock-lite (ref: src/osd/mClockOpClassQueue.h + the dmclock
submodule's algorithm; Gulati et al.'s mClock): each class has a
(reservation, weight, limit) triple in ops/sec, each enqueued item
gets three virtual tags, and dequeue runs the two-phase scheduler:

1. **reservation phase** — any head item whose R tag <= now runs
   (guaranteed minimum rate per class, regardless of the others);
2. **weight phase** — among classes whose L tag <= now (limit not
   exceeded), the smallest proportional P tag runs (excess capacity
   split by weight);
3. otherwise nothing is eligible: the caller retries when the clock
   reaches `next_eligible()`.

The OSD keeps executing client ops inline (their latency is the whole
point); it *accounts* them here so recovery/scrub tags compete against
real client load, and routes recovery/scrub work items through the
queue so storms are paced instead of flooding the cluster
(ref: osd_mclock_scheduler_* option family).

The port's copy of `ceph_tpu.osd.op_queue`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable

from ..common.lockdep import make_lock


class _Class:
    __slots__ = ("name", "res", "wgt", "lim", "burst", "tokens",
                 "refilled", "r", "p", "q", "deferred")

    def __init__(self, name: str, res: float, wgt: float, lim: float,
                 burst: float, now: float):
        self.name = name
        self.res = res          # reservation, ops/s (0 = none)
        self.wgt = wgt          # proportional weight
        self.lim = lim          # limit, ops/s (0 = unlimited)
        self.burst = burst      # token-bucket capacity (ops)
        self.tokens = burst
        self.refilled = now
        self.r = 0.0            # last reservation tag
        self.p = 0.0            # last proportional tag
        self.q: deque = deque()
        self.deferred = 0       # times the head had to wait

    def refill(self, now: float) -> None:
        if self.lim <= 0:
            return
        self.tokens = min(self.burst,
                          self.tokens + (now - self.refilled) * self.lim)
        self.refilled = now

    def limited(self, now: float) -> bool:
        """Over limit right now?  The token bucket allows bursts up to
        `burst` ops, then caps at `lim` ops/s — a small recovery flows
        immediately, a storm is paced (tag-spaced limits would stall
        short bursts for no benefit)."""
        if self.lim <= 0:
            return False
        self.refill(now)
        return self.tokens < 1.0


class MClockQueue:
    """(ref: dmclock ClientQueue tag math, reduced)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._classes: dict[str, _Class] = {}
        self._lock = make_lock("osd.mclock")

    def set_class(self, name: str, reservation: float = 0.0,
                  weight: float = 1.0, limit: float = 0.0,
                  burst: float = 64.0) -> None:
        with self._lock:
            c = self._classes.get(name)
            if c is None:
                self._classes[name] = _Class(name, reservation, weight,
                                             limit, burst, self.clock())
            else:
                c.res, c.wgt, c.lim = reservation, weight, limit
                c.burst = burst

    def enqueue(self, name: str, item) -> None:
        now = self.clock()
        with self._lock:
            c = self._classes[name]
            c.q.append(self._tagged(c, now, item))

    def _tagged(self, c: _Class, now: float, item):
        r = max(now, c.r + 1.0 / c.res) if c.res > 0 else float("inf")
        p = max(now, c.p + 1.0 / c.wgt)
        # tags advance at enqueue (the dmclock convention) so a burst
        # of enqueues spaces itself even before any dequeue
        c.r = r if c.res > 0 else c.r
        c.p = p
        return (r, p, item)

    def account(self, name: str) -> None:
        """An op of this class executed OUTSIDE the queue (inline
        client ops): advance its tags + consume a token so queued
        classes' shares are computed against the real total load."""
        now = self.clock()
        with self._lock:
            c = self._classes[name]
            if c.res > 0:
                c.r = max(now, c.r + 1.0 / c.res)
            c.p = max(now, c.p + 1.0 / c.wgt)
            if c.lim > 0:
                c.refill(now)
                c.tokens = max(0.0, c.tokens - 1.0)

    def dequeue(self):
        """Next eligible item or None (two-phase mClock pick)."""
        now = self.clock()
        with self._lock:
            best = None            # (tag, class) reservation phase
            for c in self._classes.values():
                if not c.q or c.limited(now):
                    continue
                r = c.q[0][0]
                if r <= now and (best is None or r < best[0]):
                    best = (r, c)
            if best is None:       # weight phase, limit-gated
                for c in self._classes.values():
                    if not c.q or c.limited(now):
                        continue
                    p = c.q[0][1]
                    if best is None or p < best[0]:
                        best = (p, c)
            if best is not None:
                c = best[1]
                _r, _p, item = c.q.popleft()
                if c.lim > 0:
                    c.tokens = max(0.0, c.tokens - 1.0)
                return item
            for c in self._classes.values():
                if c.q:
                    c.deferred += 1
            return None

    def next_eligible(self) -> float | None:
        """Earliest time any queued head becomes eligible."""
        now = self.clock()
        with self._lock:
            best = None
            for c in self._classes.values():
                if not c.q:
                    continue
                t = now
                if c.lim > 0:
                    c.refill(now)
                    if c.tokens < 1.0:
                        t = now + (1.0 - c.tokens) / c.lim
                if best is None or t < best:
                    best = t
            return best

    def __len__(self) -> int:
        with self._lock:
            return sum(len(c.q) for c in self._classes.values())

    def backlog(self, name: str) -> int:
        with self._lock:
            return len(self._classes[name].q)

    def stats(self) -> dict:
        with self._lock:
            return {n: {"queued": len(c.q), "deferred": c.deferred,
                        "reservation": c.res, "weight": c.wgt,
                        "limit": c.lim}
                    for n, c in self._classes.items()}
