"""devicehealth-lite: device error metrics -> life expectancy ->
health warnings (ref:
src/pybind/mgr/devicehealth/module.py — the reference scrapes SMART
data via smartctl and predicts device life; this framework's devices
are the OSDs' BlueStore instances, whose at-rest checksum machinery
IS the health feed: csum mismatches and read errors are exactly what
a dying medium produces).

Per tick: pull `osd perf dump` from the mon, fold each OSD's
`bluestore_csum_errors` / `bluestore_read_errors` into a per-device
record with a synthetic life-expectancy estimate, and when a device
crosses the warning threshold raise a DEVICE_HEALTH check (merged
into `ceph health` via the mon's module-health report), emit a
progress event, and log to the cluster log.

The port's copy of `ceph_tpu.mgr.devicehealth`.
"""
from __future__ import annotations

import time

from ..common.log import dout

#: error-count thresholds for the synthetic life model (the reference
#: predicts from SMART trends; our media errors are rarer and harsher)
WARN_ERRORS = 1           # any media error is worth a warning
FAIL_ERRORS = 16          # persistent rot: expect imminent failure


class DeviceHealth:
    """(ref: devicehealth/module.py Module)."""

    def __init__(self, mgr):
        self.mgr = mgr
        #: device name -> record (one device per OSD: "osd.N-dev")
        self.devices: dict[str, dict] = {}
        self._warned: set[str] = set()

    # ------------------------------------------------------------ tick
    def tick(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        rc, _, perf = self.mgr.mon_command({"prefix": "osd perf dump"})
        if rc != 0 or not isinstance(perf, dict):
            return
        checks_detail = []
        for daemon, counters in sorted(perf.items()):
            csum = int(counters.get("bluestore_csum_errors", 0))
            rerr = int(counters.get("bluestore_read_errors", 0))
            errors = csum + rerr
            dev = f"{daemon}-dev"
            if errors >= FAIL_ERRORS:
                health, life = "FAILING", "<1w"
            elif errors >= WARN_ERRORS:
                health, life = "WARNING", "<6w"
            else:
                health, life = "GOOD", ">52w"
            self.devices[dev] = {
                "device": dev, "daemon": daemon,
                "csum_errors": csum, "read_errors": rerr,
                "health": health, "life_expectancy": life,
                "stamp": now}
            if health != "GOOD":
                checks_detail.append(
                    f"{dev} ({daemon}): {errors} media errors, "
                    f"life expectancy {life}")
                if dev not in self._warned:
                    self._warned.add(dev)
                    self._on_new_unhealthy(dev, daemon, errors, life)
            else:
                self._warned.discard(dev)
        checks = {}
        if checks_detail:
            checks["DEVICE_HEALTH"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(checks_detail)} devices reporting "
                           "media errors",
                "detail": checks_detail}
        # replace this module's slice: recovered devices clear their
        # check; other modules' slices (RECENT_CRASH) stay intact
        self.mgr.set_health_checks("devicehealth", checks)

    def _on_new_unhealthy(self, dev: str, daemon: str, errors: int,
                          life: str) -> None:
        dout("mgr", 1).write("devicehealth: %s unhealthy (%d errors)",
                             dev, errors)
        self.mgr.mon_command({
            "prefix": "log", "level": "warn", "who": "mgr.devicehealth",
            "logtext": f"device {dev} on {daemon} reports {errors} "
                       f"media errors, life expectancy {life}"})
        if getattr(self.mgr, "progress", None) is not None:
            ev_id = f"devicehealth-{dev}"
            self.mgr.progress.update(
                ev_id, f"devicehealth: {dev} degraded "
                f"(life expectancy {life})", 0.0)
            self.mgr.progress.complete(ev_id)

    # ------------------------------------------------------- queries
    def ls(self) -> list[dict]:
        """`ceph device ls` (ref: devicehealth's device listing)."""
        return [self.devices[d] for d in sorted(self.devices)]

    def get_health(self, dev: str) -> dict | None:
        return self.devices.get(dev)
