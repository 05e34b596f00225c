"""Distributed tracing: blkin/Zipkin-style spans across daemons.

The reference threads a ZTracer::Trace through every Message
(ref: src/msg/Message.h:263-264, src/common/zipkin_trace.h; spans
emitted from the OSD pipeline via OpRequest::pg_trace,
src/osd/ECBackend.cc:1508) with LTTng/blkin as the sink.  Here the
trace context is a small dict riding the Message `trace` field —
{"trace_id", "span", "parent"} — and each daemon keeps its own
in-memory ring of finished spans, dumped via the admin socket
(`dump_traces`); assembling a cross-daemon trace = filtering every
daemon's ring by trace_id.

The port's copy of `ceph_tpu.common.tracing`; the tracer's lock keeps
the reference's lockdep name.  The port adds a span log for its device
path (`SpanLog`, below): spans with no trace context, cheap enough for
every call of the erasure-code plugin.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from array import array
from collections import deque

from .lockdep import make_lock


def _new_id() -> str:
    return os.urandom(8).hex()


def new_trace() -> dict:
    """Root context for one client op (ref: ZTracer::Trace init)."""
    return {"trace_id": _new_id(), "span": _new_id(), "parent": None}


def child_of(ctx: dict | None) -> dict | None:
    """Child context to ride a fan-out message."""
    if not ctx:
        return None
    return {"trace_id": ctx["trace_id"], "span": _new_id(),
            "parent": ctx["span"]}


#: ambient trace context for the current thread of execution — a
#: frontend (RGW request handler, MDS op dispatch) roots a trace and
#: scopes it here so the layers below (objecter submit) parent their
#: own spans under it without every intermediate API growing a trace
#: parameter (the OpRequest::pg_trace plumbing the reference threads
#: explicitly through call signatures).
_current_ctx: contextvars.ContextVar[dict | None] = \
    contextvars.ContextVar("ceph_tpu_torch_trace_ctx", default=None)


def current_trace() -> dict | None:
    """The ambient trace context, if a frontend scoped one."""
    return _current_ctx.get()


@contextlib.contextmanager
def trace_scope(ctx: dict | None):
    """Scope `ctx` as the ambient parent for nested op submissions."""
    token = _current_ctx.set(ctx)
    try:
        yield ctx
    finally:
        _current_ctx.reset(token)


class Span:
    __slots__ = ("trace_id", "span_id", "parent", "name", "service",
                 "start", "end", "events")

    def __init__(self, ctx: dict, name: str, service: str):
        self.trace_id = ctx["trace_id"]
        self.span_id = ctx["span"]
        self.parent = ctx.get("parent")
        self.name = name
        self.service = service
        self.start = time.monotonic()
        self.end: float | None = None
        self.events: list[tuple[float, str]] = []

    def event(self, msg: str) -> None:
        """(ref: ZTracer::Trace::event)."""
        self.events.append((time.monotonic() - self.start, msg))

    def dump(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent": self.parent, "name": self.name,
                "service": self.service,
                "duration": round((self.end or time.monotonic())
                                  - self.start, 6),
                "events": [{"t": round(t, 6), "event": e}
                           for t, e in self.events]}


class Tracer:
    """Per-daemon span sink (the blkin collector stand-in)."""

    def __init__(self, service: str = "", keep: int = 256):
        self.service = service
        self._lock = make_lock("tracer")
        self._done: deque[Span] = deque(maxlen=keep)

    def start_span(self, ctx: dict | None, name: str) -> Span | None:
        if not ctx:
            return None
        return Span(ctx, name, self.service)

    def finish(self, span: Span | None) -> None:
        if span is None:
            return
        span.end = time.monotonic()
        with self._lock:
            self._done.append(span)

    def record_span(self, ctx: dict | None, name: str, start: float,
                    end: float) -> Span | None:
        """Record a span whose interval was MEASURED elsewhere (same
        monotonic clock): sub-stage instrumentation (e.g. the EC read
        path's survivor-stage vs kernel split) times its regions
        inline and reports them as child spans after the fact, instead
        of threading live Span objects through library code."""
        if not ctx:
            return None
        sp = Span(ctx, name, self.service)
        sp.start = start
        sp.end = end
        with self._lock:
            self._done.append(sp)
        return sp

    def dump(self, trace_id: str | None = None) -> list[dict]:
        with self._lock:
            spans = list(self._done)
        return [s.dump() for s in spans
                if trace_id is None or s.trace_id == trace_id]


# ------------------------------------------------- device-path span log
# A blkin Span costs a Python object and a random id, and is kept only
# under a trace context; the erasure-code plugin runs thousands of calls
# a second with none.  Its spans go to a preallocated ring of typed
# arrays instead, one entry per span: the name's id, the call id its
# root took, the parent's slot (-1 for a root), start and end on
# time.monotonic_ns() (the clock Span reads through time.monotonic())
# and one integer argument.  The log records only while a torch profiler
# session is on or an operator has called enable_spans(True); otherwise
# a span site costs one check and writes nothing.

#: entries the log keeps: over 3x the 5 spans a call of an 8000-call
#: profiled stretch writes
SPAN_LOG_CAPACITY = 1 << 17

_SPAN_NAMES: list[str] = []


def span_name(name: str) -> int:
    """The id of span `name`; a module registers its names once, at
    import."""
    if name not in _SPAN_NAMES:
        _SPAN_NAMES.append(name)
    return _SPAN_NAMES.index(name)


class SpanLog:
    """A ring of finished and open spans, oldest overwritten first.

    A span opened while a root span is open on the same thread is that
    root's child and carries its call id; any other span is a root and
    takes a new call id.  Entries lost to wrapping are counted, so a
    reader can refuse a window the ring no longer holds whole."""

    def __init__(self, capacity: int = SPAN_LOG_CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        #: recording switched on by an operator (enable_spans)
        self.on = False
        self._profiler = None   # torch.autograd.profiler, bound at first use
        self._tls = threading.local()
        self._alloc()

    def _alloc(self) -> None:
        n = self.capacity
        self._seqno = array("q", [-1]) * n
        self._name = array("h", [0]) * n
        self._call = array("q", [0]) * n
        self._parent = array("l", [-1]) * n
        self._start = array("q", [0]) * n
        self._end = array("q", [0]) * n
        self._arg = array("q", [0]) * n
        self._seq = itertools.count()
        self._calls = itertools.count(1)

    def clear(self) -> None:
        """Drop every entry (spans open now are forgotten)."""
        self._alloc()
        self._tls = threading.local()

    def _bind_profiler(self):
        from torch.autograd import profiler
        self._profiler = profiler
        return profiler

    def begin(self, name: int) -> int:
        """Open span `name` (an id from span_name); the handle end()
        takes, or -1 when the log is not recording."""
        if not (self.on or (self._profiler or
                            self._bind_profiler())._is_profiler_enabled):
            return -1
        i = next(self._seq)
        slot = i & self._mask
        tls = self._tls
        root = getattr(tls, "root", -1)
        if root < 0:
            # the open root lives in the thread's state, not in the
            # ring, which may overwrite its entry before it ends
            tls.root = i
            tls.call = call = next(self._calls)
            parent = -1
        else:
            call = tls.call
            parent = root & self._mask
        self._seqno[slot] = i
        self._name[slot] = name
        self._call[slot] = call
        self._parent[slot] = parent
        self._arg[slot] = 0
        self._end[slot] = 0
        self._start[slot] = time.monotonic_ns()
        return i

    def end(self, handle: int, arg: int = 0) -> None:
        """Close the span begin() returned `handle` for, with `arg`; a
        span the ring has overwritten since is left to its new owner."""
        if handle < 0:
            return
        now = time.monotonic_ns()
        slot = handle & self._mask
        if self._seqno[slot] == handle:
            self._end[slot] = now
            self._arg[slot] = arg
        if getattr(self._tls, "root", -1) == handle:
            self._tls.root = -1

    def snapshot(self) -> dict:
        """The entries the ring holds, oldest first, as parallel lists
        (`end_ns` 0 marks a span still open), with the name table,
        the count ever written and the count lost to wrapping."""
        written = max(self._seqno) + 1
        cut = written & self._mask if written > self.capacity else 0
        n = min(written, self.capacity)

        def ordered(a):
            return (a[cut:] + a[:cut])[:n].tolist()

        return {"names": list(_SPAN_NAMES), "name": ordered(self._name),
                "call": ordered(self._call),
                "parent": ordered(self._parent),
                "start_ns": ordered(self._start),
                "end_ns": ordered(self._end), "arg": ordered(self._arg),
                "slot": (list(range(cut, self.capacity)) +
                         list(range(cut)))[:n],
                "written": written,
                "lost": max(0, written - self.capacity)}


#: the process's device-path span log
SPANS = SpanLog()


def enable_spans(on: bool = True) -> None:
    """Record device-path spans (on) or only under a torch profiler
    session (off, the default)."""
    SPANS.on = bool(on)


# ------------------------------------------------- trace assembly
# Stitching a cross-daemon trace back together = collect every
# daemon's `dump_traces` ring, filter by trace_id, and rebuild the
# parent/child tree (the blkin/zipkin UI's job; here a CLI one).

def span_tree(spans: list[dict]) -> list[dict]:
    """Group dumped spans into root trees: each node is the span dict
    plus a "children" list.  Spans whose parent is not in the set
    (e.g. a daemon's ring already evicted it) surface as roots so
    partial traces still render."""
    nodes = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots = []
    for sid, node in nodes.items():
        parent = node.get("parent")
        if parent is not None and parent in nodes and parent != sid:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: (n["service"], n["name"]))
    roots.sort(key=lambda n: (n["service"], n["name"]))
    return roots


def format_tree(spans: list[dict]) -> list[str]:
    """Indented one-span-per-line rendering of an assembled trace."""
    lines: list[str] = []

    def walk(node: dict, depth: int) -> None:
        lines.append("{}{} [{}] {:.6f}s".format(
            "  " * depth, node["name"], node["service"],
            node["duration"]))
        for ev in node.get("events", []):
            lines.append("{}  @{:.6f} {}".format(
                "  " * depth, ev["t"], ev["event"]))
        for child in node["children"]:
            walk(child, depth + 1)

    for root in span_tree(spans):
        walk(root, 0)
    return lines
