"""The program's own spans, placed on the device timeline of a traced stretch.

The port records the spans of its erasure-code path in a ring
(`ceph_tpu_torch.common.tracing.SPANS`) on time.monotonic_ns() while a
torch profiler session is on, which the traced stretch is
(`trace.capture`); the profiler's timeline keeps a clock of its own.
The launches join the two.  Each `ec.launch` span holds the host's
CUDA launch call of its kernel, which the timeline keeps in
`Timeline.host`, and nothing else launches in the stretch (no copies:
it keeps no sample).  So on one stream, in order, the n-th `ec.launch`
of the stretch pairs with the n-th launch call after the window's
opening marker, as many of them as the stretch ran kernels.  Each pair
bounds the offset from the span clock to the trace clock to
[launch end - span end, launch start - span start]; the offset taken is
the one the most pairs allow (every pair, where they agree).  The join
reports the share of pairs that offset satisfies, and its drift: the
offset the last EDGE pairs allow less the one the first EDGE allow.
No wall-clock arithmetic is used.

A program without the span log gives no reading.  A log that wrapped,
or that holds no root span inside the window, is an error.  `read`
prints on standard error the join, the spans written and inside the
window (where the two counts are equal, the log wrote nothing outside
the traced stretch), the harness's own host time per call in the
stretch, and the mean length of each span name inside it.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

#: the host's CUDA call that puts a kernel on a stream
LAUNCH_CALL = "cudaLaunchKernel"
#: pairs at each end of the stretch whose offsets give the drift
EDGE = 1000
LAUNCH = "ec.launch"


class SpanLogError(RuntimeError):
    """The span log cannot give the traced window's spans."""


@dataclass
class Join:
    offset_us: float    # trace clock (us) less span clock (us)
    pairs: int
    satisfied: float    # share of pairs the offset puts the launch in the span
    drift_us: float


@dataclass
class Spans:
    """The log's finished spans on the trace clock, `inside` marking
    those wholly inside the traced window."""
    name: np.ndarray     # str
    call: np.ndarray
    parent: np.ndarray   # slot, -1 for a root
    arg: np.ndarray
    start_us: np.ndarray
    end_us: np.ndarray
    inside: np.ndarray   # bool
    join: Join
    written: int

    def select(self, name: str, under: str | None = None) -> np.ndarray:
        """Mask of the spans `name` inside the window, only those of
        calls whose root is named `under` where it is given."""
        mask = self.inside & (self.name == name)
        if under is not None:
            roots = (self.parent < 0) & (self.name == under)
            mask &= np.isin(self.call, self.call[roots])
        if not mask.any():
            raise SpanLogError(f"no {name} span inside the traced window"
                               + (f" under {under}" if under else ""))
        return mask

    def mean_us(self, name: str, under: str | None = None) -> float:
        mask = self.select(name, under)
        return float((self.end_us[mask] - self.start_us[mask]).mean())

    def arg_pct(self, name: str, value: int) -> float:
        """Percent of the spans `name` inside the window whose argument
        is `value`."""
        mask = self.select(name)
        return 100.0 * float((self.arg[mask] == value).mean())

    def root_intervals(self) -> list[tuple[float, float]]:
        """The union of the root spans inside the window."""
        mask = self.inside & (self.parent < 0)
        return _union(zip(self.start_us[mask], self.end_us[mask]))


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def allowed(lo: np.ndarray, hi: np.ndarray) -> float:
    """The offset the most intervals [lo_i, hi_i] hold: the middle of
    the stretch they share."""
    ok = lo <= hi
    lo, hi = lo[ok], hi[ok]
    if not len(lo):
        raise SpanLogError("no launch pair allows any offset")
    points = np.concatenate([lo, hi])
    step = np.concatenate([np.ones(len(lo)), -np.ones(len(hi))])
    order = np.lexsort((-step, points))      # opens before closes
    depth = np.cumsum(step[order])
    j = int(np.argmax(depth))
    left, right = points[order][j], points[order][j + 1]
    return float(left + right) / 2


def join(spans: list[tuple[float, float]],
         launches: list[tuple[float, float]]) -> Join:
    """The offset from launch spans (span clock, us) to the launch calls
    they hold (trace clock, us), paired in order."""
    n = min(len(spans), len(launches))
    if not n:
        raise SpanLogError("no ec.launch span to pair with a launch call")
    s = np.asarray(spans[-n:], dtype=np.float64)
    c = np.asarray(launches[:n], dtype=np.float64)
    lo, hi = c[:, 1] - s[:, 1], c[:, 0] - s[:, 0]
    offset = allowed(lo, hi)
    satisfied = float(((lo <= offset) & (offset <= hi)).mean())
    edge = min(EDGE, n)
    drift = allowed(lo[-edge:], hi[-edge:]) - allowed(lo[:edge], hi[:edge])
    return Join(offset, n, satisfied, drift)


def _log():
    from ceph_tpu_torch.common import tracing
    return getattr(tracing, "SPANS", None)


_last: tuple | None = None   # (timeline, Spans) of the last read


def read(r) -> Spans | None:
    """The span log of the run `r` read, on its timeline's clock; None
    without a timeline or without a span log in the program."""
    global _last
    tl = r.timeline
    if tl is None:
        return None
    if _last is not None and _last[0] is tl:
        return _last[1]
    log = _log()
    if log is None:
        return None
    spans = place(log.snapshot(), tl)
    _last = (tl, spans)
    j = spans.join
    print(f"spans: {spans.written} written, {int(spans.inside.sum())} "
          f"inside the traced window; join: {j.pairs} launch pairs, "
          f"offset {j.offset_us:.3f} us, {100 * j.satisfied:.3f} % "
          f"satisfied, drift {j.drift_us:.3f} us", file=sys.stderr)
    traced = getattr(r, "traced", None)
    if traced is not None and traced.calls:
        print(f"spans: the harness's host us per call in the traced "
              f"stretch (not a metric): "
              f"{traced.enqueue_s / traced.calls * 1e6:.3f}",
              file=sys.stderr)
    print("spans, mean us inside the window: " + ", ".join(
        f"{n} {spans.mean_us(n):.3f}" for n in dict.fromkeys(
            spans.name[spans.inside])), file=sys.stderr)
    return spans


def place(snap: dict, tl) -> Spans:
    """A span log snapshot (`SpanLog.snapshot()`) on the clock of the
    timeline `tl`."""
    if snap["lost"]:
        raise SpanLogError(f"the span log wrapped: {snap['lost']} spans "
                           "lost before they were read")
    end_ns = np.asarray(snap["end_ns"], dtype=np.int64)
    done = end_ns > 0
    names = np.asarray(snap["names"], dtype=object)
    name = names[np.asarray(snap["name"], dtype=np.int64)][done]
    start = np.asarray(snap["start_ns"], dtype=np.int64)[done] / 1e3
    end = end_ns[done] / 1e3
    lo, hi = tl.window
    kernels = sum(1 for cat, *_ in tl.device if cat == "kernel")
    calls = sorted((s, e) for n, s, e in tl.host
                   if n == LAUNCH_CALL and s > lo)[:kernels]
    is_launch = name == LAUNCH
    j = join(list(zip(start[is_launch], end[is_launch])), calls)
    start, end = start + j.offset_us, end + j.offset_us
    parent = np.asarray(snap["parent"], dtype=np.int64)[done]
    spans = Spans(name=name,
                  call=np.asarray(snap["call"], dtype=np.int64)[done],
                  parent=parent,
                  arg=np.asarray(snap["arg"], dtype=np.int64)[done],
                  start_us=start, end_us=end,
                  inside=(start >= lo) & (end <= hi), join=j,
                  written=int(snap["written"]))
    if not (spans.inside & (parent < 0)).any():
        raise SpanLogError("the span log holds no root span inside the "
                           "traced window")
    return spans


def idle_inside_pct(spans: Spans, tl) -> float:
    """Percent of the traced window in which the card ran nothing (the
    union `Timeline.busy_intervals` leaves out) while the host was
    inside one of the program's root spans (its `ec.*` calls)."""
    lo, hi = tl.window
    edges = [lo] + [x for iv in tl.busy_intervals() for x in iv] + [hi]
    idle = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
            if edges[j + 1] > edges[j]]
    roots = spans.root_intervals()
    total, k = 0.0, 0
    for s, e in idle:
        while k < len(roots) and roots[k][1] <= s:
            k += 1
        m = k
        while m < len(roots) and roots[m][0] < e:
            total += min(e, roots[m][1]) - max(s, roots[m][0])
            m += 1
    return 100.0 * total / (hi - lo)
