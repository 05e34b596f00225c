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
* `memstore_device_bytes` — MemStore's statfs capacity;
* `objectstore_debug_inject_read_err` — MemStore's injected EIO.

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
    Option("memstore_device_bytes", T.SIZE, L.ADVANCED, 1 << 30,
           "capacity reported by MemStore statfs"),
    Option("osd_min_pg_log_entries", T.UINT, L.ADVANCED, 250,
           "entries kept after a pg log trim", runtime=True),
    Option("osd_max_pg_log_entries", T.UINT, L.ADVANCED, 500,
           "log length that triggers a trim", runtime=True),
    Option("objectstore_debug_inject_read_err", T.BOOL, L.DEV, False,
           "make MemStore reads of marked objects fail with EIO",
           runtime=True),
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
