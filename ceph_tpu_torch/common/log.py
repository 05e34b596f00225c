"""Leveled per-subsystem logging — the dout/ldout analogue.

Models the reference's debug macros and per-subsystem gather levels
(ref: src/common/debug.h:23-31 dout/ldout/derr, src/common/subsys.h
per-subsystem level table, src/log/Log.cc async ring buffer).  Python's
stdlib logging supplies the sink machinery; this module supplies the
subsystem level table and `dout(subsys, level)` gating so call sites
read like the reference's.

The port's copy of `ceph_tpu.common.log`.  Its loggers are
``ceph_tpu_torch.<subsys>``; each writes to stderr through one handler
and does not propagate.
"""
from __future__ import annotations

import logging
import sys

#: the gather level of a subsystem without an override until the
#: `log_level` option says otherwise (ref: subsys.h defaults)
GATHER_LEVEL = 1

_default_level = GATHER_LEVEL

#: subsystem -> explicit gather level override
#: (ref: subsys.h per-subsystem table; unset subsystems use the
#: default, which the `log_level` config option drives)
_levels: dict[str, int] = {}
_loggers: dict[str, logging.Logger] = {}


class _StderrHandler(logging.StreamHandler):
    """Resolves sys.stderr per record (not at import) so redirection
    — and pytest capture — see the log stream."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):   # StreamHandler.__init__ assigns; ignore
        pass


_handler = _StderrHandler()
_handler.setFormatter(logging.Formatter(
    "%(asctime)s %(name)s %(levelname).1s %(message)s"))


def set_subsys_level(subsys: str, level: int) -> None:
    """`debug_<subsys> = N` equivalent."""
    with _lock:
        _levels[subsys] = level


def set_default_level(level: int) -> None:
    """Gather level for subsystems without an explicit override —
    driven by the `log_level` config option."""
    global _default_level
    _default_level = level


# imported (and _lock constructed) AFTER set_default_level exists:
# make_lock -> global_config() re-enters this half-initialized module
# for exactly that symbol while resolving the `log_level` observer
from .lockdep import make_lock  # noqa: E402

_lock = make_lock("log.registry")


def _logger(subsys: str) -> logging.Logger:
    lg = _loggers.get(subsys)
    if lg is None:
        with _lock:
            lg = _loggers.get(subsys)
            if lg is None:
                lg = logging.getLogger(f"ceph_tpu_torch.{subsys}")
                if not lg.handlers:
                    lg.addHandler(_handler)
                    lg.propagate = False
                lg.setLevel(logging.DEBUG)
                _loggers[subsys] = lg
    return lg


class _NullCtx:
    def write(self, *a, **kw):
        pass

    def __bool__(self):
        return False


_null = _NullCtx()


class _DoutCtx:
    __slots__ = ("_lg", "_level")

    def __init__(self, lg: logging.Logger, level: int):
        self._lg = lg
        self._level = level

    def write(self, msg: str, *args) -> None:
        # level 0 errors -> ERROR, 1 -> INFO, deeper -> DEBUG, matching
        # the reference's derr(=level -1/0) vs dout(>=10 verbose) split
        if self._level <= 0:
            self._lg.error(msg, *args)
        elif self._level <= 1:
            self._lg.info(msg, *args)
        else:
            self._lg.debug(msg, *args)

    def __bool__(self):
        return True


def dout(subsys: str, level: int):
    """`dout(subsys, level).write("...")` — returns a falsy no-op sink
    when the subsystem's gather level is below `level`, so message
    construction cost is skipped exactly like the dout macro."""
    if level > _levels.get(subsys, _default_level):
        return _null
    return _DoutCtx(_logger(subsys), level)


def derr(subsys: str):
    return dout(subsys, 0)
