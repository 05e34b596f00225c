"""Leveled per-subsystem logging: the dout analogue the balancer calls.

Models the reference's debug macro (ref: src/common/debug.h:23-31 dout):
`dout(subsys, level).write(fmt, *args)` emits only when `level` is at or
below the subsystem's gather level, which is `GATHER_LEVEL` for every
subsystem here (the reference's default).  At or below it, the line goes
to the stdlib logger ``ceph_tpu_torch.<subsys>`` at INFO; above it, the
returned sink drops the line, as the macro skips its formatting.

The port's copy of the part of `ceph_tpu.common.log` that the balancer
uses: its lines are at level 10, so they are dropped.
"""
from __future__ import annotations

import logging

#: gather level of every subsystem (ref: subsys.h defaults)
GATHER_LEVEL = 1


class _Sink:
    __slots__ = ("write",)

    def __init__(self, write):
        self.write = write


_null = _Sink(lambda msg, *args: None)


def dout(subsys: str, level: int) -> _Sink:
    """`dout(subsys, level).write("...", *args)`."""
    if level > GATHER_LEVEL:
        return _null
    return _Sink(logging.getLogger(f"ceph_tpu_torch.{subsys}").info)
