"""Typed configuration schema + live config with observers.

The port's copy of `ceph_tpu.common.options`: the reference's single
typed option schema, all of its entries with the same types, levels,
defaults, bounds, enum values and runtime flags (ref:
src/common/options.cc `Option(name, type, level)` entries), and its
layered apply/observe machinery (ref: src/common/config.cc md_config_t
value application with registered observers for runtime-updatable
options).  Values resolve default < file (`load_file`, the JSON
ceph.conf layer) < env < `set`.

The environment layer reads ``CEPH_TPU_<NAME>``, the reference's own
prefix, so one environment configures both packages.  Two entries
configure JAX code the port does not have: `ec_tpu_backend` (the
reference's kernel route; the port's is chosen by `device=`) and
`jaxguard` (its counterpart is `common.devguard`, armed by
``CEPH_TPU_TORCH_DEVGUARD``).  They stay in the schema so that a
config file or `config set` valid for the reference is valid here, and
nothing reads them.
"""
from __future__ import annotations

import enum
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable


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


@dataclass
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


def _o(name, type_, default, level=OptionLevel.ADVANCED, desc="",
       min=None, max=None, enum=(), see_also=(), runtime=False):
    return Option(name=name, type=type_, level=level, default=default,
                  description=desc, min=min, max=max, enum_values=enum,
                  see_also=see_also, runtime=runtime)


T, L = OptionType, OptionLevel

# The live schema, the reference's entries in the reference's order.
OPTIONS: dict[str, Option] = {opt.name: opt for opt in [
    # messenger / transport (ref: options.cc ms_* family)
    _o("ms_type", T.STR, "local", L.BASIC,
       "transport backend", enum=("local", "ici", "grpc")),
    _o("ms_inject_socket_failures", T.UINT, 0, L.DEV,
       "inject a transport failure every N messages (0=off)",
       runtime=True),
    _o("ms_dispatch_threads", T.UINT, 1, desc="dispatcher threads"),
    # osd daemon (ref: options.cc osd_* family)
    _o("osd_pool_default_size", T.UINT, 3, L.BASIC,
       "replica count for new replicated pools", runtime=True),
    _o("osd_pool_default_pg_num", T.UINT, 32, L.BASIC,
       "pg count for new pools"),
    _o("osd_heartbeat_interval", T.SECS, 6.0, desc="peer ping period",
       min=0.001, runtime=True),
    _o("osd_heartbeat_grace", T.SECS, 20.0,
       desc="missed-ping window before reporting a peer down",
       runtime=True),
    _o("osd_max_markdown_count", T.UINT, 5, L.DEV),
    _o("osd_recovery_max_active", T.UINT, 3, runtime=True,
       desc="concurrent recovery ops per OSD shard"),
    # mClock op-class QoS (ref: options.cc osd_mclock_scheduler_*)
    _o("osd_mclock_client_wgt", T.FLOAT, 10.0, L.ADVANCED,
       desc="client op-class weight", runtime=True),
    _o("osd_mclock_recovery_res", T.FLOAT, 20.0, L.ADVANCED,
       desc="recovery reservation, ops/s", runtime=True),
    _o("osd_mclock_recovery_wgt", T.FLOAT, 1.0, L.ADVANCED,
       desc="recovery op-class weight", runtime=True),
    _o("osd_mclock_recovery_lim", T.FLOAT, 200.0, L.ADVANCED,
       desc="recovery limit, ops/s (0 = unlimited)", runtime=True),
    _o("osd_mclock_scrub_wgt", T.FLOAT, 1.0, L.ADVANCED,
       desc="scrub op-class weight", runtime=True),
    _o("osd_mclock_scrub_lim", T.FLOAT, 100.0, L.ADVANCED,
       desc="scrub limit, ops/s (0 = unlimited)", runtime=True),
    # automatic scrub scheduling (ref: options.cc:3351
    # osd_scrub_min_interval / osd_deep_scrub_interval / osd_max_scrubs)
    _o("osd_scrub_auto", T.BOOL, True, L.ADVANCED, runtime=True,
       desc="schedule scrubs automatically from the heartbeat tick"),
    _o("osd_scrub_min_interval", T.FLOAT, 24 * 3600.0, L.ADVANCED,
       runtime=True,
       desc="seconds between shallow scrubs of a clean PG"),
    _o("osd_deep_scrub_interval", T.FLOAT, 7 * 24 * 3600.0,
       L.ADVANCED, runtime=True,
       desc="seconds between deep scrubs of a clean PG"),
    _o("osd_max_scrubs", T.UINT, 1, L.ADVANCED, runtime=True,
       desc="concurrent scrubs an OSD will drive or serve"),
    _o("osd_scrub_auto_repair", T.BOOL, True, L.ADVANCED,
       runtime=True,
       desc="repair inconsistencies found by scheduled deep scrubs "
            "(diverges from the reference default=false: BlueStore "
            "at-rest checksums make auto-repair the useful default "
            "here; the repair is re-verified in-round either way)"),
    # MDS beacons / failover (ref: options.cc mds_beacon_interval,
    # mds_beacon_grace, mds_standby_replay)
    _o("mds_beacon_interval", T.SECS, 4.0, L.ADVANCED, runtime=True,
       desc="seconds between MDS beacons to the monitor"),
    _o("mds_beacon_grace", T.SECS, 15.0, L.ADVANCED, runtime=True,
       desc="beacon silence before the monitor marks a rank failed "
            "and promotes a standby"),
    _o("mds_standby_replay", T.BOOL, False, L.ADVANCED,
       desc="standby daemons warm-tail their target rank's journal "
            "so takeover replay starts from a warm cursor"),
    # MDS balancer (ref: options.cc mds_bal_* family)
    _o("mds_bal_interval", T.FLOAT, 5.0, L.ADVANCED, runtime=True,
       desc="seconds between MDS balancer passes"),
    _o("mds_bal_min_load", T.FLOAT, 20.0, L.ADVANCED, runtime=True,
       desc="minimum decayed op load before a rank exports"),
    _o("mds_bal_ratio", T.FLOAT, 1.5, L.ADVANCED, runtime=True,
       desc="load multiple over the coldest rank that triggers an "
            "export"),
    _o("mds_bal_split_size", T.UINT, 10000, L.ADVANCED, runtime=True,
       desc="dentries per directory fragment before it splits "
            "(ref: options.cc mds_bal_split_size)"),
    _o("mds_bal_merge_size", T.UINT, 50, L.ADVANCED, runtime=True,
       desc="total dentries under which a fragmented directory "
            "merges back (ref: options.cc mds_bal_merge_size)"),
    _o("mon_target_pg_per_osd", T.UINT, 100, L.ADVANCED,
       desc="pg_autoscaler target PG replicas per OSD", runtime=True),
    _o("osd_ec_batch_stripes", T.UINT, 64, L.ADVANCED,
       desc="stripes batched per TPU encode dispatch"),
    # monitor (ref: options.cc mon_* family)
    _o("mon_osd_down_out_interval", T.SECS, 600.0, L.BASIC,
       desc="seconds a down OSD stays in before auto-out",
       runtime=True),
    _o("mon_osd_min_up_ratio", T.FLOAT, 0.3, L.ADVANCED,
       desc="refuse to mark OSDs down below this up fraction"),
    _o("mon_osd_report_timeout", T.SECS, 900.0),
    _o("mon_osd_min_down_reporters", T.UINT, 2, L.ADVANCED,
       desc="distinct failure reporters required to mark an OSD down",
       runtime=True),
    _o("mon_min_osdmap_epochs", T.UINT, 500, L.DEV),
    _o("osd_mon_report_interval", T.SECS, 5.0, L.ADVANCED,
       desc="seconds between pg-stat reports to the mon",
       runtime=True),
    _o("mon_osd_stale_report_grace", T.SECS, 60.0, L.ADVANCED,
       desc="flag osds whose last pg-stat report is older than this"),
    _o("mon_mgr_health_grace", T.SECS, 60.0, L.ADVANCED, runtime=True,
       desc="expire mgr-module health checks (RECENT_CRASH, "
            "DEVICE_HEALTH...) not re-reported within this window — a "
            "dead mgr's last report must not warn forever (0 = never "
            "expire)"),
    # mgr observability modules (ref: options mgr/crash
    # warn_recent_interval; mgr/insights health history)
    _o("mgr_crash_warn_recent_interval", T.SECS, 14 * 24 * 3600.0,
       L.ADVANCED, runtime=True,
       desc="unarchived crashes newer than this raise RECENT_CRASH "
            "(ref: mgr/crash warn_recent_interval)"),
    _o("mgr_insights_window", T.SECS, 3600.0, L.ADVANCED, runtime=True,
       desc="time window the insights report summarizes (health "
            "history, osdmap churn, cluster-log counts)"),
    _o("osd_debug_inject_crash_tick", T.BOOL, False, L.DEV,
       runtime=True,
       desc="inject an unhandled exception into the OSD's next "
            "heartbeat tick (crash-capture exerciser)"),
    # balancer (ref: OSDMap.cc calc_pg_upmaps knobs)
    _o("upmap_max_deviation", T.UINT, 5, L.BASIC, runtime=True,
       desc="target max PG-count deviation per OSD"),
    _o("upmap_max_optimizations", T.UINT, 10, runtime=True),
    # EC / bench
    _o("ec_tpu_backend", T.STR, "pallas", L.ADVANCED,
       enum=("xla", "pallas"), desc="bit-matmul kernel backend"),
    _o("ec_profile_default_k", T.UINT, 2, L.DEV),
    _o("ec_profile_default_m", T.UINT, 1, L.DEV),
    # object store
    _o("memstore_device_bytes", T.SIZE, 1 << 30, L.ADVANCED,
       desc="capacity reported by MemStore statfs"),
    _o("bluestore_device_bytes", T.SIZE, 0, L.ADVANCED,
       desc="provisioned capacity reported by BlueStore statfs; 0 = "
            "grow with the block file (never report used > total)"),
    # peering / recovery / backfill (ref: options.cc osd_min_pg_log_
    # entries, osd_max_pg_log_entries, osd_max_backfills,
    # osd_backfill_scan_max)
    _o("osd_min_pg_log_entries", T.UINT, 250, L.ADVANCED, runtime=True,
       desc="entries kept after a pg log trim"),
    _o("osd_max_pg_log_entries", T.UINT, 500, L.ADVANCED, runtime=True,
       desc="log length that triggers a trim"),
    _o("osd_max_backfills", T.UINT, 1, L.ADVANCED, runtime=True,
       desc="concurrent backfills an OSD serves (local or remote)"),
    _o("osd_backfill_scan_max", T.UINT, 512, L.ADVANCED, runtime=True,
       desc="objects per ranged backfill scan chunk"),
    # snaptrim (ref: options.cc osd_max_trimming_pgs,
    # osd_pg_max_concurrent_snap_trims, osd_snap_trim_sleep)
    _o("osd_max_trimming_pgs", T.UINT, 2, L.ADVANCED, runtime=True,
       desc="PGs an OSD will snap-trim concurrently; PGs past the "
            "cap report snaptrim_wait until a slot frees"),
    _o("osd_pg_max_concurrent_snap_trims", T.UINT, 2, L.ADVANCED,
       runtime=True,
       desc="clone trims in flight per trimming PG"),
    _o("osd_snap_trim_sleep", T.SECS, 0.0, L.ADVANCED, runtime=True,
       desc="seconds between clone trims (throttles trim against "
            "client IO; 0 = unthrottled)"),
    # client-side object cache (ref: options.cc client_oc*, rbd_cache*)
    _o("client_oc", T.BOOL, True, L.ADVANCED,
       desc="cephfs write-back object cache under CAP_EXCL/CAP_CACHE"),
    _o("client_oc_size", T.SIZE, 32 << 20, L.ADVANCED),
    _o("client_oc_max_dirty", T.SIZE, 8 << 20, L.ADVANCED),
    _o("rbd_cache", T.BOOL, True, L.ADVANCED,
       desc="librbd write-back object cache (flushed on lock "
            "release, snap create, close)"),
    _o("rbd_cache_size", T.SIZE, 32 << 20, L.ADVANCED),
    _o("rbd_cache_max_dirty", T.SIZE, 8 << 20, L.ADVANCED),
    # fault injection (ref: options.cc:774 heartbeat_inject_failure,
    # :3565 osd_debug_inject_dispatch_delay)
    _o("heartbeat_inject_failure", T.SECS, 0.0, L.DEV, runtime=True),
    _o("lockdep", T.BOOL, False, L.DEV,
       desc="lock-order cycle detection on instrumented locks; read "
            "at lock construction, so set it before daemons start "
            "(ref: src/common/lockdep.cc)"),
    _o("racecheck", T.BOOL, False, L.DEV,
       desc="Eraser-style lockset data-race sanitizer on classes "
            "marked shared_state()/RaceTracked: attribute accesses "
            "intersect per-(object, attr) candidate locksets against "
            "the thread's held DebugLocks and raise RaceError when "
            "the intersection empties; requires `lockdep` (the held "
            "set comes from it) and is read when "
            "racecheck.enable_if_configured() runs "
            "(see common/racecheck.py)",
       see_also=("lockdep",)),
    _o("jaxguard", T.BOOL, False, L.DEV,
       desc="device-contract sanitizer: count jit compilations per "
            "callsite (fail on same-signature recompiles) and arm "
            "jax.transfer_guard around the EC/placement dispatch; "
            "read when jaxguard.enable_if_configured() runs, so set "
            "it before jit wrappers are built (see common/jaxguard.py)"),
    _o("errcheck", T.BOOL, False, L.DEV,
       desc="error-path coverage sanitizer: an import hook recompiles "
            "instrumented packages with a counter bump at the top of "
            "every except handler, so coverage_report() can list the "
            "handlers no test or chaos run has ever entered; read "
            "when errcheck.enable_if_configured() runs — arm it "
            "before the modules you want counted import (see "
            "common/errcheck.py)"),
    _o("osd_debug_inject_dispatch_delay_probability", T.FLOAT, 0.0,
       L.DEV, min=0.0, max=1.0, runtime=True),
    _o("objectstore_debug_inject_read_err", T.BOOL, False, L.DEV,
       runtime=True,
       desc="make MemStore reads of marked objects fail with EIO"),
    # op tracking / slow-op health (ref: options.cc
    # osd_op_complaint_time, osd_op_history_size)
    _o("osd_op_complaint_time", T.SECS, 30.0, L.ADVANCED, runtime=True,
       desc="in-flight op age that counts as slow: feeds each "
            "daemon's dump_blocked_ops and the cluster SLOW_OPS "
            "health warning"),
    _o("osd_op_history_size", T.UINT, 20, L.ADVANCED,
       desc="completed ops kept for dump_historic_ops (and the slow "
            "subset for dump_historic_slow_ops)"),
    # telemetry upload (ref: the telemetry module's endpoint url)
    _o("mgr_telemetry_url", T.STR, "", L.ADVANCED, runtime=True,
       desc="sink the compiled telemetry report posts to on each "
            "mgr tick: file://<path> appends JSON lines, "
            "http(s)://... POSTs; empty = compile only, never send"),
    # logging
    _o("blkin_trace_all", T.BOOL, False, L.DEV, runtime=True,
       desc="trace every client op with distributed spans"),
    _o("log_level", T.UINT, 1, L.BASIC, runtime=True,
       desc="global default debug level", max=30),
]}


class Config:
    """Resolved configuration with observer support
    (ref: src/common/config.cc md_config_t::set_val + observers)."""

    def __init__(self, schema: dict[str, Option] | None = None,
                 values: dict[str, Any] | None = None):
        self.schema = dict(schema or OPTIONS)
        self._values: dict[str, Any] = {}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        # env source: CEPH_TPU_<NAME>=value (ref env layer of config.cc)
        for name in self.schema:
            env = os.environ.get("CEPH_TPU_" + name.upper())
            if env is not None:
                self._values[name] = self.schema[name].parse(env)
        for k, v in (values or {}).items():
            self.set(k, v)

    def get(self, name: str):
        opt = self.schema[name]
        return self._values.get(name, opt.default)

    def __getitem__(self, name: str):
        return self.get(name)

    def set(self, name: str, value) -> None:
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        parsed = opt.parse(value)
        old = self.get(name)
        self._values[name] = parsed
        if parsed != old:
            for cb in self._observers.get(name, []):
                cb(name, parsed)

    def observe(self, name: str, cb: Callable[[str, Any], None]) -> None:
        if name not in self.schema:
            raise KeyError(f"unknown option {name!r}")
        self._observers.setdefault(name, []).append(cb)

    def load_file(self, path: str) -> None:
        """JSON config file — the ceph.conf layer."""
        with open(path) as f:
            for k, v in json.load(f).items():
                self.set(k, v)

    def dump(self, level: OptionLevel | None = None) -> dict:
        """`config show` equivalent."""
        out = {}
        for name, opt in sorted(self.schema.items()):
            if level is not None and opt.level != level:
                continue
            out[name] = self.get(name)
        return out

    def diff(self) -> dict:
        """`config diff` — only values changed from schema defaults."""
        return {k: v for k, v in sorted(self._values.items())
                if v != self.schema[k].default}


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
        from .log import set_default_level
        _global_config.observe(
            "log_level", lambda k, v: set_default_level(int(v)))
        set_default_level(int(_global_config["log_level"]))
    return _global_config
