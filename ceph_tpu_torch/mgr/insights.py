"""mgr insights module: a time-windowed cluster snapshot
(ref: src/pybind/mgr/insights/module.py — health-check history,
recent crashes, osdmap epoch deltas, and cluster-log severity counts
over a sliding window, the support-bundle feed).

Per tick the module samples health / osdmap epoch / cluster-log
counts into bounded history rings; `insights` reports the window's
deltas from those rings only, so the mon-proxied command handler
(mgr dispatch thread) never issues a synchronous mon command.

The port's copy of `ceph_tpu.mgr.insights`.
"""
from __future__ import annotations

import time
from collections import deque

from ..common.crash import utc_iso
from ..common.options import global_config

_EINVAL = 22

#: ring bound — independent of the time window so a fast ticker can't
#: grow memory without bound
MAX_SAMPLES = 512


class InsightsModule:
    """(ref: insights/module.py Module)."""

    def __init__(self, mgr, window: float | None = None):
        self.mgr = mgr
        #: report window in seconds (mgr_insights_window)
        self.window = (window if window is not None
                       else global_config()["mgr_insights_window"])
        #: (stamp, status, sorted check names)
        self._health: deque = deque(maxlen=MAX_SAMPLES)
        #: (stamp, osdmap epoch)
        self._epochs: deque = deque(maxlen=MAX_SAMPLES)
        #: (stamp, {level: count}) — cumulative cluster-log counters
        self._log_counts: deque = deque(maxlen=MAX_SAMPLES)

    # ------------------------------------------------------------ tick
    def tick(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        rc, _, health = self.mgr.mon_command({"prefix": "health"})
        if rc == 0 and isinstance(health, dict):
            self._health.append(
                (now, health.get("status", "?"),
                 sorted(health.get("checks", {}))))
        self._epochs.append((now, self.mgr.osdmap.epoch))
        rc, _, counts = self.mgr.mon_command({"prefix": "log counts"})
        if rc == 0 and isinstance(counts, dict):
            self._log_counts.append((now, dict(counts)))

    def prune_health(self, before: float) -> int:
        """Drop health history older than `before` (ref: `insights
        prune-health <hours>`)."""
        kept = [s for s in self._health if s[0] >= before]
        dropped = len(self._health) - len(kept)
        self._health = deque(kept, maxlen=MAX_SAMPLES)
        return dropped

    # ---------------------------------------------------------- report
    def report(self, now: float | None = None) -> dict:
        now = time.time() if now is None else now
        lo = now - self.window
        health = [s for s in self._health if lo <= s[0] <= now]
        epochs = [s for s in self._epochs if lo <= s[0] <= now]
        logs = [s for s in self._log_counts if lo <= s[0] <= now]
        transitions = sum(1 for a, b in zip(health, health[1:])
                          if a[1] != b[1] or a[2] != b[2])
        crashes = []
        if self.mgr.crash is not None:
            crashes = [{
                "entity_name": c.get("entity_name", "?"),
                "timestamp": c.get("timestamp", ""),
                "exc_type": c.get("exc_type", ""),
            } for c in self.mgr.crash.last_crashes
                if not c.get("archived")
                and lo <= c.get("stamp", 0.0) <= now]
        log_delta: dict[str, int] = {}
        if logs:
            first, last = logs[0][1], logs[-1][1]
            for level in ("warn", "error"):
                log_delta[level] = max(
                    0, last.get(level, 0) - first.get(level, 0))
        return {
            "window_seconds": self.window,
            "report_timestamp": utc_iso(now),
            "health": {
                "current": health[-1][1] if health else "unknown",
                "current_checks": list(health[-1][2]) if health else [],
                "samples": len(health),
                "transitions": transitions,
                "history": [{"timestamp": utc_iso(s[0]),
                             "status": s[1], "checks": list(s[2])}
                            for s in health],
            },
            "osdmap": {
                "first_epoch": epochs[0][1] if epochs else 0,
                "last_epoch": epochs[-1][1] if epochs else 0,
                "epoch_delta": (epochs[-1][1] - epochs[0][1])
                if epochs else 0,
            },
            "cluster_log": log_delta,
            "crashes": crashes,
        }

    # -------------------------------------------------------- commands
    def handle_command(self, cmd: dict) -> tuple[int, str, object]:
        pfx = str(cmd.get("prefix", ""))
        if pfx == "insights":
            return 0, "", self.report()
        if pfx == "insights prune-health":
            hours = float(cmd.get("hours", 0))
            if hours < 0:
                return -_EINVAL, "hours must be >= 0", None
            n = self.prune_health(time.time() - hours * 3600.0)
            return 0, f"pruned {n} health history entries", None
        return -_EINVAL, f"unknown insights command {pfx!r}", None
