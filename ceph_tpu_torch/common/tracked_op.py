"""OpTracker: in-flight op tracking with per-stage timestamps.

(ref: src/common/TrackedOp.{h,cc} — TrackedOp::mark_event history,
OpTracker::dump_ops_in_flight / dump_historic_ops /
dump_historic_slow_ops served through the admin socket; the slow-op
age warning mirrors osd_op_complaint_time.)

Every daemon type owns one (the reference constructs an OpTracker in
OSD, mon, mds and rgw alike); aged in-flight ops feed the cluster's
SLOW_OPS health warning through each daemon's report path.

The port's copy of `ceph_tpu.common.tracked_op`.
"""
from __future__ import annotations

import time
from collections import deque

from .lockdep import make_lock


class TrackedOp:
    """(ref: TrackedOp.h:214)."""

    __slots__ = ("desc", "start", "events", "done_at")

    def __init__(self, desc: str, now: float):
        self.desc = desc
        self.start = now
        self.events: list[tuple[float, str]] = [(now, "initiated")]
        self.done_at: float | None = None

    def mark_event(self, name: str, now: float | None = None) -> None:
        self.events.append((time.monotonic() if now is None else now,
                            name))

    def dump(self, now: float) -> dict:
        end = self.done_at if self.done_at is not None else now
        return {"description": self.desc,
                "age": round(now - self.start, 6),
                "duration": round(end - self.start, 6),
                "events": [{"time": round(t - self.start, 6),
                            "event": e} for t, e in self.events]}


class OpTracker:
    """(ref: TrackedOp.h:64 OpTracker).

    `complaint_time=None` reads the live `osd_op_complaint_time`
    option per check, so `config set` retunes every daemon's slow-op
    threshold at runtime (the reference observes the same option)."""

    def __init__(self, history_size: int = 20,
                 complaint_time: float | None = None):
        self._lock = make_lock("optracker")
        self._inflight: dict[object, TrackedOp] = {}
        self._historic: deque[TrackedOp] = deque(maxlen=history_size)
        #: completed ops whose total duration exceeded the complaint
        #: threshold (ref: OpTracker's historic_slow ring behind
        #: dump_historic_slow_ops)
        self._historic_slow: deque[TrackedOp] = deque(
            maxlen=history_size)
        self.complaint_time = complaint_time

    @property
    def complaint(self) -> float:
        if self.complaint_time is not None:
            return self.complaint_time
        from .options import global_config
        return global_config()["osd_op_complaint_time"]

    def start(self, key, desc: str) -> TrackedOp:
        op = TrackedOp(desc, time.monotonic())
        with self._lock:
            self._inflight[key] = op
        return op

    def mark(self, key, event: str) -> None:
        with self._lock:
            op = self._inflight.get(key)
        if op is not None:
            op.mark_event(event)

    def finish(self, key, event: str = "done") -> float | None:
        """Retire one op into history; returns its total duration (the
        per-op-class latency histogram feed) or None when untracked."""
        with self._lock:
            op = self._inflight.pop(key, None)
            if op is None:
                return None
            now = time.monotonic()
            op.events.append((now, event))
            op.done_at = now
            self._historic.append(op)
            dur = now - op.start
            if dur > self.complaint:
                self._historic_slow.append(op)
            return dur

    # -- dumps (ref: OpTracker::dump_ops_in_flight :282) ----------------
    def dump_in_flight(self) -> dict:
        now = time.monotonic()
        with self._lock:
            ops = [op.dump(now) for op in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic(self) -> dict:
        now = time.monotonic()
        with self._lock:
            ops = [op.dump(now) for op in self._historic]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_slow(self) -> dict:
        """(ref: OpTracker::dump_historic_slow_ops)."""
        now = time.monotonic()
        with self._lock:
            ops = [op.dump(now) for op in self._historic_slow]
        return {"num_ops": len(ops), "ops": ops}

    def slow_ops(self) -> list[dict]:
        """Ops older than the complaint threshold
        (ref: OpTracker::check_ops_in_flight)."""
        now = time.monotonic()
        limit = self.complaint
        with self._lock:
            return [op.dump(now) for op in self._inflight.values()
                    if now - op.start > limit]

    def slow_summary(self) -> dict:
        """{count, oldest_age} of aged in-flight ops — the SLOW_OPS
        health feed each daemon ships on its stat report / beacon
        (cleared the moment the ops drain: count 0)."""
        now = time.monotonic()
        limit = self.complaint
        with self._lock:
            ages = [now - op.start for op in self._inflight.values()
                    if now - op.start > limit]
        return {"count": len(ages),
                "oldest_age": round(max(ages), 3) if ages else 0.0}
