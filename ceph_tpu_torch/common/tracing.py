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
the reference's lockdep name.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
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
