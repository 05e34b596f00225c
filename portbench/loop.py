"""The closed loop: a fixed number of calls in flight, on one stream.

The host submits a call, records an event behind it, and submits the
next while fewer than `in_flight` are outstanding; otherwise it waits
for the oldest.  Every call submitted in the window is waited for, and
the window ends when the last of them completes, so a rate taken over
it holds all the work and all the time.  The host clock is read around
each call into the program (its enqueue cost) and at each completion
the host sees.  A reservoir drawn from the seed picks the calls whose
outputs are kept for the check.  The loop keeps no Python object per
call past its completion (the readings go into a typed array, the
completion events are reused), so the harness does not feed the
interpreter's full collections, whose pauses of some 100 ms would empty
the card's queue, and its own cost per call stays small beside the
program's.
"""
from __future__ import annotations

import random
import time
from array import array
from collections import deque
from dataclasses import dataclass, field

import torch

from .workload import derive_seed


class Reservoir:
    """A uniform sample of `size` calls out of however many the window
    makes, decided at each call's submission from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items: list = []
        self.offered = 0
        self._rng = random.Random(derive_seed(seed, 4))

    def offer(self) -> int | None:
        """The slot the next call takes, or None if it is not kept."""
        self.offered += 1
        if len(self.items) < self.size:
            self.items.append(None)
            return len(self.items) - 1
        j = self._rng.randrange(self.offered)
        return j if j < self.size else None


class _Done:
    """A completion marker for a device that runs calls synchronously."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


def _markers(device: torch.device, n: int) -> list:
    if device.type == "cuda":
        return [torch.cuda.Event() for _ in range(n)]
    return [_Done() for _ in range(n)]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    enqueue_s: float = 0.0
    #: host seconds from each call's submission to when the host saw it
    #: complete (printed for reading, never a metric: a call is shorter
    #: than the host clock can time alone)
    latency_s: array = field(default_factory=lambda: array("d"))


def run(op, device: torch.device, first: int, seconds: float | None = None,
        calls: int | None = None, in_flight: int = 1,
        sample: Reservoir | None = None) -> Window:
    """Drive `op` from call index `first` for `seconds` of host time (or
    exactly `calls` calls), then wait for every call submitted."""
    if (seconds is None) == (calls is None):
        raise ValueError("give seconds or calls")
    win = Window()
    pending: deque = deque()
    free = _markers(device, in_flight)
    clock = time.perf_counter
    synchronize(device)
    start = clock()
    deadline = start + seconds if seconds is not None else None
    i = first
    while True:
        more = (clock() < deadline) if deadline is not None \
            else (i - first < calls)
        if more and len(pending) < in_flight:
            slot = sample.offer() if sample is not None else None
            t0 = clock()
            out, info = op.submit(i, slot is not None)
            t1 = clock()
            win.enqueue_s += t1 - t0
            if slot is not None:
                sample.items[slot] = (i, info, out)
            marker = free.pop()
            marker.record()
            pending.append((t0, marker))
            del out
            i += 1
            continue
        if not pending:
            break
        t0, marker = pending.popleft()
        marker.synchronize()
        win.latency_s.append(clock() - t0)
        free.append(marker)
    win.seconds = clock() - start
    win.calls = i - first
    return win
