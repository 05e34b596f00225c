"""HeartbeatMap: internal thread-liveness watchdog.

Port of src/common/HeartbeatMap.{h,cc}: worker threads register a
handle, reset its timeout every loop iteration, and a health check
(is_healthy, wired to the daemon tick / status surface) flags workers
whose grace expired — the mechanism behind the reference's
"heartbeat_map is_healthy ... had timed out" warnings and suicide
timeouts.

The port's copy of `ceph_tpu.common.heartbeat_map`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from .lockdep import make_lock
from .log import dout


@dataclass
class HeartbeatHandle:
    """(ref: HeartbeatMap.h heartbeat_handle_d)."""
    name: str
    grace: float
    suicide_grace: float = 0.0
    timeout: float = 0.0          # deadline (0 = not armed)
    suicide_timeout: float = 0.0


class SuicideTimeout(RuntimeError):
    """A worker blew past its suicide grace (the reference aborts the
    process; we raise so harnesses can assert on it)."""


class HeartbeatMap:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = make_lock("heartbeat_map")
        self._workers: list[HeartbeatHandle] = []

    def add_worker(self, name: str, grace: float,
                   suicide_grace: float = 0.0,
                   arm: bool = True) -> HeartbeatHandle:
        """``arm=False`` registers the worker UNARMED: the deadline
        only starts at its first reset_timeout, so a daemon
        constructed but never driven (a harness-built mon that never
        ticks) is not unhealthy — only a loop that beat once and then
        stopped is."""
        h = HeartbeatHandle(name=name, grace=grace,
                            suicide_grace=suicide_grace)
        if arm:
            self.reset_timeout(h)
        with self._lock:
            self._workers.append(h)
        return h

    def remove_worker(self, h: HeartbeatHandle) -> None:
        with self._lock:
            if h in self._workers:
                self._workers.remove(h)

    def reset_timeout(self, h: HeartbeatHandle,
                      grace: float | None = None) -> None:
        """Called by the worker each loop pass
        (ref: HeartbeatMap.cc reset_timeout)."""
        now = self._clock()
        if grace is not None:
            h.grace = grace
        h.timeout = now + h.grace
        h.suicide_timeout = now + h.suicide_grace \
            if h.suicide_grace else 0.0

    def clear_timeout(self, h: HeartbeatHandle) -> None:
        h.timeout = 0.0
        h.suicide_timeout = 0.0

    def is_healthy(self) -> bool:
        return not self.get_unhealthy_workers()

    def health_check(self) -> dict:
        """HEARTBEAT_STALE health-check slice ({} when healthy) —
        ONE rendering shared by every daemon that surfaces its hbmap
        through the health path (mon checks, mgr module report)."""
        stale = self.get_unhealthy_workers()
        if not stale:
            return {}
        return {"HEARTBEAT_STALE": {
            "severity": "HEALTH_WARN",
            "summary": f"{len(stale)} worker thread(s) missed their "
                       f"heartbeat grace",
            "detail": [f"{w} had timed out" for w in stale]}}

    def get_unhealthy_workers(self) -> list[str]:
        """(ref: HeartbeatMap.cc check / is_healthy)."""
        now = self._clock()
        out = []
        with self._lock:
            workers = list(self._workers)
        for h in workers:
            if h.suicide_timeout and now > h.suicide_timeout:
                dout("heartbeatmap", 0).write(
                    "%s suicide timed out", h.name)
                raise SuicideTimeout(h.name)
            if h.timeout and now > h.timeout:
                dout("heartbeatmap", 1).write(
                    "%s had timed out after %s", h.name, h.grace)
                out.append(h.name)
        return out
