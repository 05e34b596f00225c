"""The options the port reads: typed schema entries with the reference's
env layer.

The port's own copy of the entries of `ceph_tpu.common.options` that it
reads (ref: src/common/options.cc `Option(name, type, level)` entries;
src/common/config.cc env layer), with the same types, levels, defaults
and `CEPH_TPU_<NAME>` environment variables, so one environment
configures both packages:

* `lockdep`, `racecheck` — the sanitizers;
* `osd_min_pg_log_entries`, `osd_max_pg_log_entries` — the EC shard's
  durable log trim;
* `memstore_device_bytes` — MemStore's statfs capacity, and
  BlueStore's when the block file is smaller;
* `bluestore_device_bytes` — BlueStore's provisioned statfs capacity;
* `objectstore_debug_inject_read_err` — MemStore's and BlueStore's
  injected EIO;
* the cluster's: heartbeats and failure reports (`osd_heartbeat_*`,
  `mon_osd_min_down_reporters`), the down-out interval, map history
  (`mon_min_osdmap_epochs`), pg-stat reports and their staleness, the
  mClock client and recovery classes, backfill reservations and scan
  windows, op tracking (`osd_op_complaint_time`,
  `osd_op_history_size`) and `blkin_trace_all`;
* the scrub scheduler's (`osd_scrub_auto`, `osd_scrub_min_interval`,
  `osd_deep_scrub_interval`, `osd_max_scrubs`,
  `osd_scrub_auto_repair`);
* the mgr's: the pg_autoscaler's `mon_target_pg_per_osd` and the mon's
  `mon_mgr_health_grace`, which expires a silent mgr's module health;
* the fault plane's and crash capture's: `ms_inject_socket_failures`
  (the messenger's drop shim), `osd_debug_inject_crash_tick` (a crash
  in an OSD's next tick) and `mgr_crash_warn_recent_interval` (the
  RECENT_CRASH window).

Every other option of the reference's schema configures code the port
does not have, and is not read here.
"""
from __future__ import annotations

import enum
import os
from dataclasses import dataclass
from typing import Any


class OptionType(enum.Enum):
    UINT = "uint"
    INT = "int"
    STR = "str"
    FLOAT = "float"
    BOOL = "bool"
    SIZE = "size"       # accepts 4K/1M/2G suffixes
    SECS = "secs"


class OptionLevel(enum.Enum):
    BASIC = "basic"
    ADVANCED = "advanced"
    DEV = "dev"


_SIZE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def _parse_size(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suf, mult in _SIZE_SUFFIX.items():
        for full in (suf + "i", suf):
            if s.endswith(full):
                return int(float(s[:-len(full)]) * mult)
    return int(float(s))


@dataclass(frozen=True)
class Option:
    """One schema entry (ref: options.cc Option chain builders)."""
    name: str
    type: OptionType
    level: OptionLevel = OptionLevel.ADVANCED
    default: Any = None
    description: str = ""
    min: Any = None
    max: Any = None
    enum_values: tuple = ()
    see_also: tuple = ()
    runtime: bool = False   # may be changed on a live daemon

    def parse(self, value):
        t = self.type
        if t is OptionType.BOOL:
            if isinstance(value, bool):
                out = value
            else:
                s = str(value).strip().lower()
                if s in ("true", "yes", "on", "1"):
                    out = True
                elif s in ("false", "no", "off", "0"):
                    out = False
                else:
                    raise ValueError(f"{self.name}: bad bool {value!r}")
        elif t in (OptionType.UINT, OptionType.INT):
            out = int(value)
            if t is OptionType.UINT and out < 0:
                raise ValueError(f"{self.name}: negative uint {value!r}")
        elif t in (OptionType.FLOAT, OptionType.SECS):
            out = float(value)
        elif t is OptionType.SIZE:
            out = _parse_size(value)
        else:
            out = str(value)
        if self.min is not None and out < self.min:
            raise ValueError(f"{self.name}: {out} < min {self.min}")
        if self.max is not None and out > self.max:
            raise ValueError(f"{self.name}: {out} > max {self.max}")
        if self.enum_values and out not in self.enum_values:
            raise ValueError(
                f"{self.name}: {out!r} not in {self.enum_values}")
        return out


T, L = OptionType, OptionLevel

OPTIONS: dict[str, Option] = {opt.name: opt for opt in [
    Option("lockdep", T.BOOL, L.DEV, False,
           "lock-order cycle detection on instrumented locks; read "
           "at lock construction, so set it before daemons start "
           "(ref: src/common/lockdep.cc)"),
    Option("racecheck", T.BOOL, L.DEV, False,
           "Eraser-style lockset data-race sanitizer on classes "
           "marked shared_state()/RaceTracked: attribute accesses "
           "intersect per-(object, attr) candidate locksets against "
           "the thread's held DebugLocks and raise RaceError when "
           "the intersection empties; requires `lockdep` (the held "
           "set comes from it) and is read when "
           "racecheck.enable_if_configured() runs "
           "(see common/racecheck.py)",
           see_also=("lockdep",)),
    # messenger fault injection (ref: options.cc:987)
    Option("ms_inject_socket_failures", T.UINT, L.DEV, 0,
           "inject a transport failure every N messages (0=off)",
           runtime=True),
    Option("memstore_device_bytes", T.SIZE, L.ADVANCED, 1 << 30,
           "capacity reported by MemStore statfs"),
    Option("bluestore_device_bytes", T.SIZE, L.ADVANCED, 0,
           "provisioned capacity reported by BlueStore statfs; 0 = "
           "grow with the block file (never report used > total)"),
    Option("osd_min_pg_log_entries", T.UINT, L.ADVANCED, 250,
           "entries kept after a pg log trim", runtime=True),
    Option("osd_max_pg_log_entries", T.UINT, L.ADVANCED, 500,
           "log length that triggers a trim", runtime=True),
    Option("objectstore_debug_inject_read_err", T.BOOL, L.DEV, False,
           "make MemStore reads of marked objects fail with EIO",
           runtime=True),
    Option("osd_heartbeat_interval", T.SECS, L.ADVANCED, 6.0,
           "peer ping period", min=0.001, runtime=True),
    Option("osd_heartbeat_grace", T.SECS, L.ADVANCED, 20.0,
           "missed-ping window before reporting a peer down",
           runtime=True),
    Option("osd_mclock_client_wgt", T.FLOAT, L.ADVANCED, 10.0,
           "client op-class weight", runtime=True),
    Option("osd_mclock_recovery_res", T.FLOAT, L.ADVANCED, 20.0,
           "recovery reservation, ops/s", runtime=True),
    Option("osd_mclock_recovery_wgt", T.FLOAT, L.ADVANCED, 1.0,
           "recovery op-class weight", runtime=True),
    Option("osd_mclock_recovery_lim", T.FLOAT, L.ADVANCED, 200.0,
           "recovery limit, ops/s (0 = unlimited)", runtime=True),
    # automatic scrub scheduling (ref: options.cc:3351
    # osd_scrub_min_interval / osd_deep_scrub_interval / osd_max_scrubs)
    Option("osd_scrub_auto", T.BOOL, L.ADVANCED, True,
           "schedule scrubs automatically from the heartbeat tick",
           runtime=True),
    Option("osd_scrub_min_interval", T.FLOAT, L.ADVANCED, 24 * 3600.0,
           "seconds between shallow scrubs of a clean PG",
           runtime=True),
    Option("osd_deep_scrub_interval", T.FLOAT, L.ADVANCED,
           7 * 24 * 3600.0,
           "seconds between deep scrubs of a clean PG", runtime=True),
    Option("osd_max_scrubs", T.UINT, L.ADVANCED, 1,
           "concurrent scrubs an OSD will drive or serve",
           runtime=True),
    Option("osd_scrub_auto_repair", T.BOOL, L.ADVANCED, True,
           "repair inconsistencies found by scheduled deep scrubs "
           "(diverges from the reference default=false: BlueStore "
           "at-rest checksums make auto-repair the useful default "
           "here; the repair is re-verified in-round either way)",
           runtime=True),
    Option("mon_osd_down_out_interval", T.SECS, L.BASIC, 600.0,
           "seconds a down OSD stays in before auto-out",
           runtime=True),
    Option("mon_osd_min_down_reporters", T.UINT, L.ADVANCED, 2,
           "distinct failure reporters required to mark an OSD down",
           runtime=True),
    Option("mon_min_osdmap_epochs", T.UINT, L.DEV, 500),
    Option("osd_mon_report_interval", T.SECS, L.ADVANCED, 5.0,
           "seconds between pg-stat reports to the mon", runtime=True),
    Option("mon_osd_stale_report_grace", T.SECS, L.ADVANCED, 60.0,
           "flag osds whose last pg-stat report is older than this"),
    Option("osd_max_backfills", T.UINT, L.ADVANCED, 1,
           "concurrent backfills an OSD serves (local or remote)",
           runtime=True),
    Option("osd_backfill_scan_max", T.UINT, L.ADVANCED, 512,
           "objects per ranged backfill scan chunk", runtime=True),
    Option("osd_op_complaint_time", T.SECS, L.ADVANCED, 30.0,
           "in-flight op age that counts as slow: feeds each "
           "daemon's dump_blocked_ops and the cluster SLOW_OPS "
           "health warning", runtime=True),
    Option("osd_op_history_size", T.UINT, L.ADVANCED, 20,
           "completed ops kept for dump_historic_ops (and the slow "
           "subset for dump_historic_slow_ops)"),
    Option("blkin_trace_all", T.BOOL, L.DEV, False,
           "trace every client op with distributed spans",
           runtime=True),
    Option("mon_target_pg_per_osd", T.UINT, L.ADVANCED, 100,
           "pg_autoscaler target PG replicas per OSD", runtime=True),
    # mgr crash module (ref: options mgr/crash warn_recent_interval)
    Option("mgr_crash_warn_recent_interval", T.SECS, L.ADVANCED,
           14 * 24 * 3600.0,
           "unarchived crashes newer than this raise RECENT_CRASH "
           "(ref: mgr/crash warn_recent_interval)", runtime=True),
    Option("osd_debug_inject_crash_tick", T.BOOL, L.DEV, False,
           "inject an unhandled exception into the OSD's next "
           "heartbeat tick (crash-capture exerciser)", runtime=True),
    Option("mon_mgr_health_grace", T.SECS, L.ADVANCED, 60.0,
           "expire mgr-module health checks (RECENT_CRASH, "
           "DEVICE_HEALTH...) not re-reported within this window — a "
           "dead mgr's last report must not warn forever (0 = never "
           "expire)", runtime=True),
]}


class Config:
    """Option values: the default, then the environment, then `set`
    (ref: src/common/config.cc md_config_t)."""

    def __init__(self):
        self._values: dict[str, Any] = {}
        # env source: CEPH_TPU_<NAME>=value (ref env layer of config.cc)
        for name, opt in OPTIONS.items():
            env = os.environ.get("CEPH_TPU_" + name.upper())
            if env is not None:
                self._values[name] = opt.parse(env)

    def get(self, name: str):
        return self._values.get(name, OPTIONS[name].default)

    def __getitem__(self, name: str):
        return self.get(name)

    def dump(self) -> dict:
        """Every option's live value (`config show`)."""
        return {name: self.get(name) for name in sorted(OPTIONS)}

    def set(self, name: str, value) -> None:
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        self._values[name] = opt.parse(value)


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config
