"""MonHunter: shared mon-session failover for daemons/clients.

The MonClient hunting behavior (ref: src/mon/MonClient.cc
reopen_session / _reopen_session rank rotation): an entity holds a mon
list, talks to one, and on a connection reset rotates to the next,
re-sending its session greeting (subscription/boot).  The walk is
iterative — a hunt send to another dead mon reports its reset
synchronously and must not recurse.

The port's copy of `ceph_tpu.msg.mon_client`.
"""
from __future__ import annotations

from ..common.backoff import Backoff
from ..common.log import dout


class MonHunter:
    """Mixin; the host class must expose `self.ms` and override
    `_hunt_greeting()` with the session (re)establishment messages.

    A lap that reaches NO mon at all (every greeting send failed —
    the whole quorum dead or partitioned away) arms a capped
    exponential backoff: further resets inside the window are
    absorbed instead of re-walking the ring, so an unreachable quorum
    costs a handful of greetings per window rather than a greeting
    storm per dropped message (the chaos harness's mon-partition
    schedules hit exactly this)."""

    #: full-lap failure pacing (wall-clock; resets on any success)
    HUNT_BACKOFF_BASE_S = 0.05
    HUNT_BACKOFF_CAP_S = 2.0

    def _init_mons(self, mon) -> None:
        self.mons = [mon] if isinstance(mon, str) else list(mon)
        self._mon_i = 0
        self._mon_hunting = False
        self._hunt_backoff = Backoff(base_s=self.HUNT_BACKOFF_BASE_S,
                                     cap_s=self.HUNT_BACKOFF_CAP_S,
                                     jitter=False)

    @property
    def mon(self) -> str:
        return self.mons[self._mon_i]

    def _hunt_greeting(self) -> list:
        """Messages that re-establish the session at a new mon."""
        return []

    def _maybe_hunt(self, peer: str) -> bool:
        """Handle a reset of our current mon; True when it was ours
        (hunted, paced out, or nothing else to do)."""
        if peer != self.mon:
            return False
        if len(self.mons) <= 1 or self._mon_hunting:
            return True
        if not self._hunt_backoff.ready():
            return True         # all-mons-dead window: stay put
        self._mon_hunting = True
        reached = False
        try:
            for _ in range(len(self.mons) - 1):
                self._mon_i = (self._mon_i + 1) % len(self.mons)
                dout("ms", 1).write("%s: mon hunt -> %s",
                                    getattr(self, "name", "?"), self.mon)
                msgs = self._hunt_greeting()
                if not msgs:
                    reached = True
                    break
                if self.ms.connect(self.mon).send_message(msgs[0]):
                    for m in msgs[1:]:
                        self.ms.connect(self.mon).send_message(m)
                    reached = True
                    break
        finally:
            self._mon_hunting = False
        if reached:
            self._hunt_backoff.reset()
        else:
            self._hunt_backoff.fail()
        return True
