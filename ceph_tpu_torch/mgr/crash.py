"""mgr crash module: the RECENT_CRASH health agent over the mon's
crash table (ref: src/pybind/mgr/crash/module.py — ingest/storage
live mon-side here (mon/crash_service.py); this module is the health
and summary half: it watches the table and raises RECENT_CRASH for
unarchived crashes inside the warn window, cleared by archiving).

Per tick: pull `crash ls`, cache it (telemetry/insights/prometheus
read the cache — module command handlers run on the mgr dispatch
thread where a sync mon command would deadlock), and report the
RECENT_CRASH slice through the mgr's merged module-health report.

The port's copy of `ceph_tpu.mgr.crash`, whole.  Its `summary` feeds
the reference's telemetry and prometheus modules, which the port does
not carry yet.
"""
from __future__ import annotations

import time

from ..common.options import global_config


class CrashModule:
    """(ref: crash/module.py Module)."""

    def __init__(self, mgr, warn_recent_interval: float | None = None):
        self.mgr = mgr
        #: unarchived crashes newer than this raise RECENT_CRASH
        #: (ref: mgr/crash warn_recent_interval, default 2 weeks)
        self.warn_recent_interval = (
            warn_recent_interval if warn_recent_interval is not None
            else global_config()["mgr_crash_warn_recent_interval"])
        #: last `crash ls` snapshot (tick-refreshed)
        self.last_crashes: list[dict] = []
        self.last_checks: dict = {}

    # ------------------------------------------------------------ tick
    def tick(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        rc, _, crashes = self.mgr.mon_command({"prefix": "crash ls"})
        if rc != 0 or not isinstance(crashes, list):
            return
        self.last_crashes = crashes
        recent = [c for c in crashes
                  if not c.get("archived")
                  and now - c.get("stamp", 0.0)
                  <= self.warn_recent_interval]
        checks = {}
        if recent:
            daemons = sorted({c.get("entity_name", "?")
                              for c in recent})
            checks["RECENT_CRASH"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(recent)} daemon crashes recently "
                           f"({len(daemons)} daemons); archive with "
                           "`crash archive-all` once triaged",
                "detail": [f"{c.get('entity_name', '?')} crashed at "
                           f"{c.get('timestamp', '?')}: "
                           f"{c.get('exc_type', '?')}: "
                           f"{c.get('exc_msg', '')}"
                           for c in recent]}
        self.last_checks = checks
        # empty replaces the slice away: archiving clears RECENT_CRASH
        # on the next tick (ref: crash/module.py do_archive + health)
        self.mgr.set_health_checks("crash", checks)

    # ------------------------------------------------------- queries
    def ls(self, new_only: bool = False) -> list[dict]:
        return [c for c in self.last_crashes
                if not (new_only and c.get("archived"))]

    def summary(self) -> dict:
        """Counts by entity type + archive state (telemetry's crash
        channel and the prometheus gauge read this)."""
        by_type: dict[str, int] = {}
        new = 0
        for c in self.last_crashes:
            by_type[c.get("entity_type", "?")] = \
                by_type.get(c.get("entity_type", "?"), 0) + 1
            if not c.get("archived"):
                new += 1
        return {"total": len(self.last_crashes), "new": new,
                "by_entity_type": by_type}

    # ---------------------------------------------------- passthrough
    def info(self, crash_id: str) -> dict | None:
        rc, _, meta = self.mgr.mon_command(
            {"prefix": "crash info", "id": crash_id})
        return meta if rc == 0 else None

    def archive(self, crash_id: str) -> int:
        rc, _, _ = self.mgr.mon_command(
            {"prefix": "crash archive", "id": crash_id})
        return rc

    def archive_all(self) -> int:
        rc, _, _ = self.mgr.mon_command({"prefix": "crash archive-all"})
        return rc

    def prune(self, keep_days: float) -> int:
        rc, _, _ = self.mgr.mon_command(
            {"prefix": "crash prune", "keep": keep_days})
        return rc
