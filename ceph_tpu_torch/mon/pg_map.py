"""PGMap: cluster-wide PG/usage statistics + health checks.

The mon-side aggregation of per-OSD stat reports (ref: src/mon/
PGMap.{h,cc} — per-pg pg_stat_t and per-osd osd_stat_t digests;
health evaluation src/mon/PGMap.cc get_health_checks and
src/osd/OSDMap.cc check_health; check names src/mon/health_check.h).

OSDs send MPGStats periodically (the reference routes these through
the mgr's DaemonServer into MgrStatMonitor); the mon keeps the digest
in memory and serves `status` / `df` / `health` / `pg stat` from it —
a restarted mon repopulates within one report interval.

The port's copy of `ceph_tpu.mon.pg_map`.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class OSDStatReport:
    """One OSD's periodic report (ref: osd_stat_t + pg_stat_t map)."""
    osd: int = -1
    epoch: int = 0
    stamp: float = 0.0
    #: pgid-str -> {"state": str, "num_objects": int, "bytes": int,
    #:              "acting": [..], "up": [..]}
    pg_stats: dict = field(default_factory=dict)
    kb_total: int = 0
    kb_used: int = 0
    kb_avail: int = 0
    perf: dict = field(default_factory=dict)
    #: {count, oldest_age} of aged in-flight ops from the daemon's
    #: OpTracker (the SLOW_OPS health feed)
    slow_ops: dict = field(default_factory=dict)


class PGMap:
    """(ref: src/mon/PGMap.h:214)."""

    def __init__(self):
        self.osd_reports: dict[int, OSDStatReport] = {}

    def ingest(self, rep: OSDStatReport) -> None:
        cur = self.osd_reports.get(rep.osd)
        if cur is None or rep.stamp >= cur.stamp:
            self.osd_reports[rep.osd] = rep

    def forget(self, osd: int) -> None:
        self.osd_reports.pop(osd, None)

    # ---------------------------------------------------------- digests
    # All digests take the authoritative up-set so a downed OSD's last
    # report (capacity, stale primary claims) drops out of every answer
    # the moment the map marks it down, whichever path marked it.
    def primary_pgs(self, up: set[int] | None = None) -> dict[str, dict]:
        """pgid -> the primary's stat entry (the authoritative one,
        like the reference where only primaries report a PG)."""
        pgs: dict[str, dict] = {}
        for osd, rep in self.osd_reports.items():
            if up is not None and osd not in up:
                continue
            for pgid, st in rep.pg_stats.items():
                if st.get("primary", False) or pgid not in pgs:
                    pgs[pgid] = st
        return pgs

    @staticmethod
    def pg_states(pgs: dict) -> dict[str, int]:
        """state string -> pg count."""
        out: dict[str, int] = {}
        for st in pgs.values():
            out[st["state"]] = out.get(st["state"], 0) + 1
        return out

    def df(self, pgs: dict, up: set[int] | None = None) -> dict:
        """RAW usage + per-pool logical stats (ref: PGMap::dump_fs_stats
        / dump_pool_stats_full)."""
        reps = [r for o, r in self.osd_reports.items()
                if up is None or o in up]
        pools: dict[int, dict] = {}
        for pgid, st in pgs.items():
            pool = int(pgid.split(".")[0])
            p = pools.setdefault(pool, {"objects": 0, "bytes": 0,
                                        "store_bytes": 0,
                                        "snaptrim_pgs": 0})
            p["objects"] += st.get("num_objects", 0)
            p["bytes"] += st.get("bytes", 0)
            # physical bytes incl. snap clones (falls back to the
            # logical count for reports predating the field) — the
            # snaptrim leak-vs-reclaim trend reads from this
            p["store_bytes"] += st.get("store_bytes",
                                       st.get("bytes", 0))
            if "snaptrim" in st.get("state", ""):
                p["snaptrim_pgs"] += 1
        return {"total_kb": sum(r.kb_total for r in reps),
                "used_kb": sum(r.kb_used for r in reps),
                "avail_kb": sum(r.kb_avail for r in reps),
                "pools": pools}

    @staticmethod
    def totals(pgs: dict) -> dict:
        return {"num_pgs": len(pgs),
                "num_objects": sum(s.get("num_objects", 0)
                                   for s in pgs.values()),
                "bytes": sum(s.get("bytes", 0) for s in pgs.values())}


def health_checks(osdmap, pgmap: PGMap, quorum: list[int],
                  mon_ranks: list[int], now: float,
                  stale_after: float = 60.0,
                  pgs: dict | None = None,
                  slow_ops: dict | None = None) -> dict[str, dict]:
    """name -> {severity, summary} (ref: health_check_map_t,
    src/mon/health_check.h; producers OSDMap::check_health
    src/osd/OSDMap.cc:5623 and PGMap::get_health_checks)."""
    checks: dict[str, dict] = {}
    down_in = [o for o in range(osdmap.max_osd)
               if osdmap.exists(o) and not osdmap.is_up(o)
               and osdmap.is_in(o)]
    if down_in:
        checks["OSD_DOWN"] = {
            "severity": "HEALTH_WARN",
            "summary": f"{len(down_in)} osds down",
            "detail": [f"osd.{o} is down" for o in down_in]}
    missing = [r for r in mon_ranks if r not in quorum]
    if missing:
        checks["MON_DOWN"] = {
            "severity": "HEALTH_WARN",
            "summary": f"{len(missing)}/{len(mon_ranks)} mons down, "
                       f"quorum {quorum}",
            "detail": [f"mon.{r} is not in quorum" for r in missing]}
    if pgs is None:
        pgs = pgmap.primary_pgs({o for o in range(osdmap.max_osd)
                                 if osdmap.is_up(o)})
    degraded, recovering = [], []
    for pgid, st in pgs.items():
        state = st.get("state", "")
        if "degraded" in state:
            degraded.append(pgid)
        if "recover" in state:
            recovering.append(pgid)
    if degraded:
        checks["PG_DEGRADED"] = {
            "severity": "HEALTH_WARN",
            "summary": f"Degraded data redundancy: "
                       f"{len(degraded)} pgs degraded",
            "detail": [f"pg {p} is degraded" for p in sorted(degraded)]}
    # SLOW_OPS: any daemon reporting aged in-flight ops (ref: the
    # health_check OSDMap/MDSMonitor derive from per-daemon op
    # trackers under osd_op_complaint_time; cleared the moment every
    # reporter's count drains to 0).  `slow_ops` merges the feeds:
    # OSDs via their MPGStats report, MDSs via beacons, the mon's own
    # tracker directly.
    slow = {ent: s for ent, s in (slow_ops or {}).items()
            if int(s.get("count", 0)) > 0}
    osd_slow = {f"osd.{o}": r.slow_ops
                for o, r in pgmap.osd_reports.items()
                if osdmap.is_up(o)
                and int(r.slow_ops.get("count", 0)) > 0}
    slow.update(osd_slow)
    if slow:
        total = sum(int(s["count"]) for s in slow.values())
        oldest = max(float(s.get("oldest_age", 0.0))
                     for s in slow.values())
        checks["SLOW_OPS"] = {
            "severity": "HEALTH_WARN",
            "summary": f"{total} slow ops, oldest one blocked for "
                       f"{oldest:.0f} sec, daemons "
                       f"{sorted(slow)} have slow ops.",
            "detail": [f"{ent}: {s['count']} ops blocked, oldest "
                       f"{float(s.get('oldest_age', 0.0)):.1f}s"
                       for ent, s in sorted(slow.items())]}
    stale = {o: now - r.stamp for o, r in pgmap.osd_reports.items()
             if osdmap.is_up(o) and now - r.stamp > stale_after}
    if stale:
        checks["OSD_STALE_REPORT"] = {
            "severity": "HEALTH_WARN",
            "summary": f"{len(stale)} osds have not reported recently",
            "detail": [f"osd.{o} last report {age:.0f}s old"
                       for o, age in sorted(stale.items())]}
    return checks


def health_status(checks: dict) -> str:
    if any(c["severity"] == "HEALTH_ERR" for c in checks.values()):
        return "HEALTH_ERR"
    return "HEALTH_WARN" if checks else "HEALTH_OK"
