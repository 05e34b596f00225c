"""The options the port reads, with the reference's env layer.

The port's own copy of the two entries of `ceph_tpu.common.options` that
it reads, `lockdep` and `racecheck` (ref: src/common/options.cc `Option`
entries; src/common/config.cc env layer), with the same defaults and the
same `CEPH_TPU_<NAME>` environment variables, so one environment arms
the sanitizers of both packages.  Every other option of the reference's
schema configures code the port does not have, and is not read here.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Option:
    """One schema entry: a dev-level bool, as both of the port's are."""
    name: str
    default: bool
    description: str
    see_also: tuple = ()

    def parse(self, value) -> bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in ("true", "yes", "on", "1"):
            return True
        if s in ("false", "no", "off", "0"):
            return False
        raise ValueError(f"{self.name}: bad bool {value!r}")


OPTIONS: dict[str, Option] = {opt.name: opt for opt in [
    Option("lockdep", False,
           "lock-order cycle detection on instrumented locks; read "
           "at lock construction, so set it before daemons start "
           "(ref: src/common/lockdep.cc)"),
    Option("racecheck", False,
           "Eraser-style lockset data-race sanitizer on classes "
           "marked shared_state()/RaceTracked: attribute accesses "
           "intersect per-(object, attr) candidate locksets against "
           "the thread's held DebugLocks and raise RaceError when "
           "the intersection empties; requires `lockdep` (the held "
           "set comes from it) and is read when "
           "racecheck.enable_if_configured() runs "
           "(see common/racecheck.py)",
           see_also=("lockdep",)),
]}


class Config:
    """Option values: the default, then the environment, then `set`
    (ref: src/common/config.cc md_config_t)."""

    def __init__(self):
        self._values: dict[str, bool] = {}
        # env source: CEPH_TPU_<NAME>=value (ref env layer of config.cc)
        for name, opt in OPTIONS.items():
            env = os.environ.get("CEPH_TPU_" + name.upper())
            if env is not None:
                self._values[name] = opt.parse(env)

    def get(self, name: str) -> bool:
        return self._values.get(name, OPTIONS[name].default)

    def __getitem__(self, name: str) -> bool:
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
