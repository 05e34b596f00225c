"""Shared capped-exponential retry backoff with jitter.

One policy for every "peer unreachable, try again later" loop in the
tree (ref: the reference's ExponentialBackoff in common/, and
MonClient::schedule_tick's reopen interval doubling).  Extracted from
the RGW SyncAgent, which grew the canonical form first: delay =
min(cap, base * 2^(fails-1)), multiplied by a jitter factor in
[0.5, 1.5) so peers recovering together do not re-stampede in
lockstep.

Two usage shapes:

* Blocking loops call ``next_delay()`` (or ``sleep()``) per failure —
  the objecter's EAGAIN command retry, the MDS client's send retry.
* Deadline-driven loops (an agent tick, a mon tick on simulated time)
  call ``fail(now)`` to arm a next-try stamp and ``ready(now)`` to
  test it — the caller owns its clock, so simulated-time harnesses
  pace exactly like wall-clock daemons.

A success MUST call ``reset()``; a Backoff that is never reset climbs
to its cap and stays there, which is the correct behavior for a peer
that stays dead but would mis-pace the next incident.

The port's copy of `ceph_tpu.common.backoff`.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional


def full_jitter(delay: float, rng: Optional[random.Random] = None) -> float:
    """Spread a delay over [0.5, 1.5) * delay (the SyncAgent's jitter
    shape; callers that need a seeded stream pass their own rng)."""
    r = rng.random() if rng is not None else random.random()
    return delay * (0.5 + r)


class Backoff:
    """Capped exponential backoff: one instance per retried peer/op.

    Not thread-safe by itself — every current user mutates it under
    its own daemon lock or from a single thread.
    """

    def __init__(self, base_s: float = 0.1, cap_s: float = 5.0,
                 jitter: bool = True,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic):
        if base_s <= 0 or cap_s < base_s:
            raise ValueError(f"bad backoff bounds ({base_s}, {cap_s})")
        self.base_s = base_s
        self.cap_s = cap_s
        self.jitter = jitter
        self._rng = rng
        self._clock = clock
        self._fails = 0
        self._next_ok = 0.0

    @property
    def failures(self) -> int:
        return self._fails

    def reset(self) -> None:
        """The operation succeeded: the next failure starts at base."""
        self._fails = 0
        self._next_ok = 0.0

    def next_delay(self) -> float:
        """Record a failure, return how long to wait before retrying."""
        self._fails += 1
        delay = min(self.cap_s, self.base_s * 2 ** (self._fails - 1))
        if self.jitter:
            delay = full_jitter(delay, self._rng)
        return delay

    def sleep(self) -> float:
        """Blocking-loop form: record a failure and sleep it out."""
        delay = self.next_delay()
        time.sleep(delay)
        return delay

    # -- deadline form (simulated-clock friendly) ----------------------
    def fail(self, now: float | None = None) -> float:
        """Record a failure and arm the next-try stamp; returns the
        delay so callers can log it."""
        delay = self.next_delay()
        self._next_ok = (self._clock() if now is None else now) + delay
        return delay

    def ready(self, now: float | None = None) -> bool:
        """True when enough time has passed to try again."""
        return (self._clock() if now is None else now) >= self._next_ok
