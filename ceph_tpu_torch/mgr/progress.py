"""Progress module: long-running cluster operations as trackable
events (ref: src/pybind/mgr/progress/module.py — `ceph progress`).

Events derive from the PG state digest the primaries report: a pool
entering recovery/backfill opens an event whose progress is the
fraction of affected PGs that have since left the state (the
reference's PgRecoveryEvent works the same way from pg_stats).
Completed events retire into a bounded history, mirroring
`progress ls`'s `completed` section.

The port's copy of `ceph_tpu.mgr.progress`, whole."""
from __future__ import annotations

import itertools
import time

from ..common.lockdep import make_lock

#: states that constitute a long-running data-movement operation
#: (substring match on the pg state; "snaptrim" also covers
#: snaptrim_wait/snaptrim_error so queued trim work counts as
#: remaining — the trim analogue of the backfill event)
_TRACKED = ("recovering", "backfilling", "snaptrim")

#: completed-event history bound (ref: the module's max completed)
_MAX_DONE = 50


class ProgressModule:
    """Driven by MgrDaemon.tick(); reads `pg dump` through the mgr's
    mon command channel."""

    def __init__(self, mgr):
        self.mgr = mgr
        self._ids = itertools.count(1)
        #: (pool, state) -> event dict
        self.events: dict[tuple, dict] = {}
        self.completed: list[dict] = []
        #: the prometheus scrape thread reads while the mgr ticks
        self._lock = make_lock("mgr.progress")

    # ------------------------------------------------------------ tick
    def tick(self) -> int:
        """One sampling pass; returns the number of live events."""
        rc, _outs, pgs = self.mgr.mon_command({"prefix": "pg dump"})
        if rc != 0 or not isinstance(pgs, dict):
            with self._lock:
                return len(self.events)
        active: dict[tuple, set] = {}
        for pgid, st in pgs.items():
            state = st.get("state", "")
            pool = pgid.split(".", 1)[0]
            for kind in _TRACKED:
                if kind in state:
                    active.setdefault((pool, kind), set()).add(pgid)
        now = time.time()
        with self._lock:
            return self._apply_sample(active, now)

    def _apply_sample(self, active: dict, now: float) -> int:
        for key, pgset in active.items():
            ev = self.events.get(key)
            if ev is None:
                ev = self.events[key] = {
                    "id": f"pg-{key[1]}-{next(self._ids)}",
                    "message": f"pool {key[0]} PGs {key[1]}",
                    "started": now, "peak": len(pgset),
                    "remaining": len(pgset), "progress": 0.0,
                }
            ev["peak"] = max(ev["peak"], len(pgset))
            ev["remaining"] = len(pgset)
            ev["progress"] = round(1.0 - len(pgset) / ev["peak"], 4)
        for key in [k for k in self.events if k not in active]:
            ev = self.events.pop(key)
            ev["progress"] = 1.0
            ev["remaining"] = 0
            ev["finished"] = now
            self.completed.append(ev)
            del self.completed[:-_MAX_DONE]
        return len(self.events)

    # -- external event API (other modules report through here,
    # ref: the module's update()/complete() RPC used by e.g. the
    # balancer and upgrade orchestrators)
    def update(self, ev_id: str, message: str,
               progress: float) -> None:
        with self._lock:
            self._update(ev_id, message, progress)

    def _update(self, ev_id: str, message: str,
                progress: float) -> None:
        key = ("ext", ev_id)
        ev = self.events.get(key)
        if ev is None:
            ev = self.events[key] = {
                "id": ev_id, "message": message,
                "started": time.time(), "peak": 1, "remaining": 1,
                "progress": 0.0}
        ev["message"] = message
        ev["progress"] = max(0.0, min(1.0, progress))

    def complete(self, ev_id: str) -> None:
        with self._lock:
            ev = self.events.pop(("ext", ev_id), None)
            if ev is not None:
                ev["progress"] = 1.0
                ev["finished"] = time.time()
                self.completed.append(ev)
                del self.completed[:-_MAX_DONE]

    # ------------------------------------------------------------- view
    def ls(self) -> list[dict]:
        """`ceph progress` — the LIVE events (history() holds the
        completed ones)."""
        with self._lock:
            out = [dict(e) for e in self.events.values()]
        out.sort(key=lambda e: e["started"])
        return out

    def history(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self.completed]
