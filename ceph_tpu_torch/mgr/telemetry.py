"""mgr telemetry module: the anonymized cluster report
(ref: src/pybind/mgr/telemetry/module.py — channel-gated report of
cluster shape, crash summaries, and perf aggregates, with an explicit
anonymization contract: hashed cluster id, NO hostnames, NO raw
filesystem paths, NO entity names, NO pool names).

Channels (ref: telemetry's basic/crash/device/perf/ident):
  basic — daemon/pool/pg counts, EC profile parameters
  crash — crash summaries (entity TYPE only, path-stripped backtrace)
  perf  — cluster-wide perf-counter sums (no per-daemon breakdown)
  ident — OFF by default: entity names (the only channel allowed to
          carry them; everything else must stay anonymous)

The report compiles on the mgr tick from cached inputs, so the
`telemetry show` command handler (which runs on the mgr dispatch
thread) never issues a synchronous mon command.

The port's copy of `ceph_tpu.mgr.telemetry`.
"""
from __future__ import annotations

import hashlib
import time

from ..common.crash import sanitize_backtrace, utc_iso
from ..osd.types import POOL_TYPE_ERASURE

REPORT_VERSION = 1

DEFAULT_CHANNELS = ("basic", "crash", "perf")
ALL_CHANNELS = ("basic", "crash", "perf", "ident")

_EPERM = 1
_EAGAIN = 11
_EINVAL = 22


class TelemetryModule:
    """(ref: telemetry/module.py Module)."""

    def __init__(self, mgr, enabled: bool = True,
                 channels: tuple | None = None):
        self.mgr = mgr
        #: starting the module is the operator's opt-in (the reference
        #: gates on `telemetry on`; `telemetry off` still disables)
        self.enabled = enabled
        self.channels = {c: c in (channels or DEFAULT_CHANNELS)
                         for c in ALL_CHANNELS}
        self.last_report: dict | None = None
        self.last_report_stamp: float | None = None
        #: tick-cached perf aggregate (compile never hits the mon)
        self._perf_totals: dict[str, float] = {}
        #: upload bookkeeping (ref: telemetry's last_upload /
        #: send failure surfacing in `telemetry status`): stamp, the
        #: sink url, success flag, and the error text on failure
        self.last_send: dict | None = None

    # -------------------------------------------------- anonymization
    def cluster_id(self) -> str:
        """Stable hashed cluster identity: the mon set IS the cluster
        (ref: telemetry hashing the fsid — reversible identity never
        leaves the cluster)."""
        ident = ",".join(sorted(self.mgr.mons))
        return hashlib.sha256(ident.encode()).hexdigest()[:32]

    # ------------------------------------------------------------ tick
    def tick(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        if not self.enabled:
            return
        if self.channels.get("perf"):
            rc, _, perf = self.mgr.mon_command(
                {"prefix": "osd perf dump"})
            if rc == 0 and isinstance(perf, dict):
                totals: dict[str, float] = {}
                for counters in perf.values():
                    for key, val in counters.items():
                        if isinstance(val, (int, float)):
                            totals[key] = totals.get(key, 0.0) \
                                + float(val)
                self._perf_totals = totals
        self.last_report = self.compile_report(now)
        self.last_report_stamp = now
        self.maybe_send(now)

    # --------------------------------------------------------- upload
    def maybe_send(self, now: float | None = None) -> bool:
        """Post the compiled report to the configured sink
        (mgr_telemetry_url; ref: the telemetry module's POST to
        telemetry.ceph.com).  file://<path> appends one JSON line
        per send (a local spool/test sink), http(s):// POSTs the
        JSON body.  Failures land in `telemetry status` as
        last_send.ok=False rather than raising into the tick."""
        from ..common.options import global_config
        url = str(global_config()["mgr_telemetry_url"] or "")
        if not url or self.last_report is None:
            return False
        now = time.time() if now is None else now
        import json
        body = json.dumps(self.last_report, sort_keys=True)
        try:
            if url.startswith("file://"):
                with open(url[len("file://"):], "a") as f:
                    f.write(body + "\n")
            elif url.startswith(("http://", "https://")):
                import urllib.request
                req = urllib.request.Request(
                    url, data=body.encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=10) as resp:
                    resp.read()
            else:
                raise ValueError(
                    f"unsupported telemetry sink {url!r} "
                    "(file:// or http(s):// only)")
        except Exception as ex:  # noqa: BLE001 — an unreachable sink
            # must not kill the mgr tick; the failure IS the status
            self.last_send = {"stamp": utc_iso(now), "url": url,
                              "ok": False,
                              "error": f"{type(ex).__name__}: {ex}"}
            return False
        self.last_send = {"stamp": utc_iso(now), "url": url,
                          "ok": True, "error": None}
        return True

    def compile_report(self, now: float | None = None) -> dict:
        """Assemble the channel-gated report from mgr-local state
        (the subscribed osdmap + module caches)."""
        now = time.time() if now is None else now
        report: dict = {
            "report_version": REPORT_VERSION,
            "report_timestamp": utc_iso(now),
            "cluster_id": self.cluster_id(),
            "channels": sorted(c for c, on in self.channels.items()
                               if on),
        }
        m = self.mgr.osdmap
        if self.channels.get("basic"):
            up = sum(1 for o in range(m.max_osd) if m.is_up(o))
            n_in = sum(1 for o in range(m.max_osd) if m.is_in(o))
            exists = sum(1 for o in range(m.max_osd) if m.exists(o))
            ec_profiles = []
            for pool in m.pools.values():
                if pool.type != POOL_TYPE_ERASURE:
                    continue
                prof = m.erasure_code_profiles.get(
                    pool.erasure_code_profile, {})
                ec_profiles.append({
                    "k": int(prof.get("k", 0)),
                    "m": int(prof.get("m", 0)),
                    "plugin": str(prof.get("plugin", ""))})
            report["basic"] = {
                "n_mons": len(self.mgr.mons),
                "osds": {"total": exists, "up": up, "in": n_in},
                "osdmap_epoch": m.epoch,
                "pools": {
                    "count": len(m.pools),
                    "by_type": {
                        "erasure": sum(1 for p in m.pools.values()
                                       if p.type == POOL_TYPE_ERASURE),
                        "replicated": sum(
                            1 for p in m.pools.values()
                            if p.type != POOL_TYPE_ERASURE)},
                    "pg_num_total": sum(p.pg_num
                                        for p in m.pools.values()),
                    "ec_profiles": ec_profiles},
            }
        if self.channels.get("crash") and self.mgr.crash is not None:
            crashes = self.mgr.crash.last_crashes
            report["crash"] = {
                "summary": self.mgr.crash.summary(),
                "reports": [{
                    "entity_type": c.get("entity_type", "?"),
                    "timestamp": c.get("timestamp", ""),
                    "exc_type": c.get("exc_type", ""),
                    "backtrace": sanitize_backtrace(
                        list(c.get("backtrace", []))),
                    "archived": bool(c.get("archived")),
                } for c in crashes],
            }
        if self.channels.get("perf"):
            report["perf"] = {"cluster": dict(self._perf_totals)}
        if self.channels.get("ident"):
            # the ONLY channel carrying entity identity
            report["ident"] = {"mons": sorted(self.mgr.mons),
                               "mgr": self.mgr.name}
        return report

    # -------------------------------------------------------- commands
    def status(self) -> dict:
        from ..common.options import global_config
        return {"enabled": self.enabled,
                "channels": dict(self.channels),
                "last_report_timestamp":
                    None if self.last_report_stamp is None
                    else utc_iso(self.last_report_stamp),
                "url": str(global_config()["mgr_telemetry_url"]
                           or "") or None,
                "last_send": self.last_send}

    def handle_command(self, cmd: dict) -> tuple[int, str, object]:
        """Mon-proxied CLI verbs — answers from cached state only
        (dispatch-thread safe)."""
        pfx = str(cmd.get("prefix", ""))
        if pfx == "telemetry status":
            return 0, "", self.status()
        if pfx == "telemetry on":
            self.enabled = True
            return 0, "telemetry enabled", None
        if pfx == "telemetry off":
            self.enabled = False
            self.last_report = None
            self.last_report_stamp = None
            return 0, "telemetry disabled", None
        if pfx == "telemetry channel":
            name = str(cmd.get("name", ""))
            if name not in self.channels:
                return -_EINVAL, \
                    f"unknown channel {name!r} (of {ALL_CHANNELS})", \
                    None
            self.channels[name] = bool(cmd.get("enabled", True))
            return 0, "", None
        if pfx == "telemetry show":
            if not self.enabled:
                return -_EPERM, "telemetry is off — enable with " \
                    "`telemetry on`", None
            if self.last_report is None:
                return -_EAGAIN, "no report compiled yet — the next " \
                    "mgr tick builds one", None
            return 0, "", self.last_report
        if pfx == "telemetry send":
            # force an upload of the last compiled report NOW (the
            # tick also sends; this is the operator's retry knob)
            if not self.enabled:
                return -_EPERM, "telemetry is off — enable with " \
                    "`telemetry on`", None
            if self.last_report is None:
                return -_EAGAIN, "no report compiled yet — the next " \
                    "mgr tick builds one", None
            from ..common.options import global_config
            if not str(global_config()["mgr_telemetry_url"] or ""):
                # check the live option, not last_send: a url cleared
                # after an earlier success must not surface the stale
                # success record as "send failed: None"
                return -_EINVAL, "no mgr_telemetry_url configured", \
                    None
            ok = self.maybe_send()
            return (0, "report sent", self.last_send) if ok else \
                (-_EAGAIN, f"send failed: {self.last_send['error']}",
                 self.last_send)
        return -_EINVAL, f"unknown telemetry command {pfx!r}", None
