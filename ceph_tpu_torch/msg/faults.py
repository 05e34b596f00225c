"""FaultPlane: the delivery stage between the messenger and a peer.

The reference's FaultPlane (ref: the ms_inject_* options of
src/common/options.cc and the qa netem/iptables helpers of
qa/tasks/ceph_manager.py) holds a seeded per-link rule table: drop,
partition, delay, reorder and duplicate.  `LocalNetwork` sends every
message through `intercept`, and `MiniCluster.pump` releases held
traffic through `flush` against the cluster's clock.

The port's copy of `ceph_tpu.msg.faults` in part: the plane with no
rules.  Every message is delivered at once, in order, so nothing is
ever held and `flush` releases nothing; the surface `LocalNetwork` and
`MiniCluster` call (`intercept`, `flush`, `pending`, `clock`,
`deliver_cb`) is the reference's.  The rules, their seed and RNG
streams, the delay/duplicate/reorder effects and the digest wait for
the thrasher's slice.
"""
from __future__ import annotations

import time
from typing import Callable, Optional


class Effects:
    """The decided fate of one message."""
    __slots__ = ("verdict", "dropped", "reset")

    def __init__(self, verdict: str, dropped: bool = False,
                 reset: bool = False):
        self.verdict = verdict
        self.dropped = dropped
        self.reset = reset


_DELIVER = Effects("deliver")


class FaultPlane:
    """The rule-free plane: deliver every message now."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        #: default delivery callback for flush() callers that have
        #: none (set by LocalNetwork)
        self.deliver_cb: Optional[Callable] = None

    def intercept(self, src: str, dst: str, msg,
                  deliver: Callable[[str, str, object], None]) -> Effects:
        """Decide this message's fate and apply it through
        `deliver(src, dst, msg)`: with no rules, deliver it."""
        deliver(src, dst, msg)
        return _DELIVER

    def flush(self, deliver: Callable | None = None) -> int:
        """Release held traffic whose time has come; returns the number
        of messages released (none are ever held here)."""
        return 0

    def pending(self) -> int:
        """Messages currently held for delay/reorder."""
        return 0
