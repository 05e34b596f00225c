"""lockdep: lock-order cycle detection for debug builds.

The reference's lockdep (ref: src/common/lockdep.cc:154-192 —
every debug Mutex registers acquisition ORDER edges in a global
follows-graph and asserts when a new edge closes a cycle, catching
potential deadlocks on the first interleaving that *could* deadlock,
not the unlucky run that does).

`make_lock(name)` returns a plain RLock unless the `lockdep` config
option is on, so production paths pay nothing.

The port's own copy of `ceph_tpu.common.lockdep`, with its own graph:
the option (env `CEPH_TPU_LOCKDEP`) arms both packages, but an edge
recorded by one never reaches the other's.
"""
from __future__ import annotations

import threading

from .options import global_config

#: global follows-graph: edge a -> b means "a was held while b was
#: acquired" (ref: lockdep.cc follows matrix)
_graph: dict[str, set[str]] = {}
_graph_lock = threading.Lock()
_tls = threading.local()


class LockOrderError(RuntimeError):
    """A lock acquisition closed a cycle in the order graph — this
    interleaving can deadlock (ref: lockdep.cc assert on cycle)."""


def reset() -> None:
    with _graph_lock:
        _graph.clear()


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def held_lock_names() -> tuple[str, ...]:
    """Names of the DebugLocks the CURRENT thread holds, innermost
    last.  This is the lockset feed for the racecheck sanitizer
    (common/racecheck.py): lockdep already tracks every instrumented
    acquisition per thread, so the Eraser-style candidate-lockset
    intersection reuses that bookkeeping instead of double-counting.
    Plain-RLock locks (lockdep off) are invisible — racecheck
    therefore requires the `lockdep` option to be armed too."""
    return tuple(n for n, _c in _held())


def _reaches(src: str, dst: str) -> bool:
    """DFS over the follows-graph (callers hold _graph_lock)."""
    seen = set()
    work = [src]
    while work:
        n = work.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        work.extend(_graph.get(n, ()))
    return False


class DebugLock:
    """Order-checked reentrant lock (ref: mutex_debug + lockdep)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        stack = _held()
        if self.name not in [n for n, _c in stack]:
            for held_name, _cnt in stack:
                # fast path: the edge was recorded (and cycle-checked)
                # by an earlier acquisition — a GIL-atomic read keeps
                # steady-state nesting off the global graph lock
                bucket = _graph.get(held_name)
                if bucket is not None and self.name in bucket:
                    continue
                with _graph_lock:
                    if self.name in _graph and \
                            _reaches(self.name, held_name):
                        order = " -> ".join(n for n, _ in stack)
                        raise LockOrderError(
                            f"lock order cycle: acquiring "
                            f"{self.name!r} while holding [{order}] "
                            f"but {self.name!r} -> {held_name!r} "
                            "already recorded")
                    _graph.setdefault(held_name, set()).add(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            for i, (n, c) in enumerate(stack):
                if n == self.name:
                    stack[i] = (n, c + 1)
                    break
            else:
                stack.append((self.name, 1))
        return got

    def release(self) -> None:
        stack = _held()
        for i in range(len(stack) - 1, -1, -1):
            n, c = stack[i]
            if n == self.name:
                if c > 1:
                    stack[i] = (n, c - 1)
                else:
                    del stack[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def make_lock(name: str):
    """Config-gated factory (ref: the CEPH_DEBUG_MUTEX build switch):
    DebugLock when `lockdep` is on, plain RLock otherwise."""
    if global_config()["lockdep"]:
        return DebugLock(name)
    return threading.RLock()
