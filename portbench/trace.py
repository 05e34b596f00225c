"""The device timeline of a traced stretch of the loop, from the profiler.

`torch.profiler` records, through CUPTI, every kernel, copy and fill the
card ran, and the CUDA runtime calls the host made.  Only the device
activity is recorded (no host operators), so the trace costs the host
little and the traced stretch runs at the untraced pace.  The window is
marked on the device: a one-element add launched on the idle card just
before the stretch and another just after it, so the window runs from
the first marker's start to the last one's end and the markers are the
first and last device activity of the trace.  The trace goes through a
file in the temporary directory, read back and deleted.  A trace with no
kernel between the markers is an error: nothing falls back to the CPU.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver"}
TOP = 10


@dataclass
class Timeline:
    window: tuple[float, float]            # us, trace clock
    device: list[tuple[str, str, float, float]]  # (cat, name, start, end)
    host: list[tuple[str, float, float]]   # CUDA API calls of the host

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def clipped(self, cats=DEVICE_CATS) -> list[tuple[str, float, float]]:
        lo, hi = self.window
        return [(name, max(s, lo), min(e, hi)) for cat, name, s, e
                in self.device if cat in cats and e > lo and s < hi]

    def busy_intervals(self, cats=DEVICE_CATS) -> list[tuple[float, float]]:
        """Union of the device's activity inside the window."""
        merged: list[list[float]] = []
        for _, s, e in sorted(self.clipped(cats), key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        return sum(e - s for s, e in self.busy_intervals(cats)) * 1e-6

    def device_ops(self) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        total: dict[str, float] = {}
        for name, s, e in self.clipped():
            total[name] = total.get(name, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in
                sorted(total.items(), key=lambda x: -x[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """The longest stretches with nothing on the device, each named
        by the CUDA call the host was in at its middle, or `python` where
        it was in none (the harness or the program's Python)."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
                if edges[j + 1] > edges[j]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:TOP]:
            mid = (s + e) / 2
            inside = [n for n, hs, he in self.host if hs <= mid <= he]
            out.append([f"host:{inside[-1] if inside else 'python'}",
                        (e - s) * 1e-6])
        return out


def parse(events: list[dict]) -> Timeline:
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((cat, name, s, e))
        elif cat in HOST_CATS:
            host.append((name, s, e))
    device.sort(key=lambda x: x[2])
    if len(device) < 3:
        raise RuntimeError("the profiler recorded no device activity "
                           "between the window's markers")
    first, last = device[0], device[-1]
    host.sort(key=lambda x: x[1])
    tl = Timeline((first[2], last[3]), device[1:-1], host)
    if not tl.clipped(("kernel",)):
        raise RuntimeError("the profiler recorded no kernel in the traced "
                           "window: no device time to read")
    return tl


def capture(fn, device: torch.device):
    """Run fn() under the profiler between two device markers; returns
    (fn's result, Timeline).  fn must end with the device synchronized."""
    mark = torch.zeros(1, dtype=torch.int32, device=device)
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        mark.add_(1)
        result = fn()
        mark.add_(1)
        torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return result, parse(events)
