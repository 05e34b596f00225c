"""What the program's span log costs the host, per plugin call.

    python3 -m portbench.span_cost --seconds 2 --rounds 6 <cell> [<cell> ...]

From the root of a checkout, on one card.  It first times one span site
(begin and end) with the log off and on.  Then, per cell, after the
set-up and warm-up a run makes, it drives untraced windows of
`--seconds` in three modes, in alternating orders over `--rounds`
rounds: the span log off (as the benchmark's windows run), on
(`ceph_tpu_torch.common.tracing.enable_spans(True)`), and under a torch
profiler session (as the traced stretch of a `--trace 1` run, where the
span log records by itself).  Each window prints the host's
microseconds per call, as plugin_call_us reads them, and, where the log
recorded, the mean length of each span name.  The `SUMMARY` lines give
per cell the medians of the three modes and on less off.  Not a metric:
the numbers are for PERF.md.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import timeit

import numpy as np
import torch

from ceph_tpu_torch.common import tracing
from portbench import loop, run, spec
from portbench.workload import Shape

MODES = ("off", "on", "prof")
SEED = 4100000000


def site_ns(on: bool, n: int = 200000) -> float:
    """Nanoseconds of one span site (begin and end) with the log off or
    on, outside any profiler session."""
    log, name = tracing.SPANS, tracing.span_name("span_cost.site")
    tracing.enable_spans(on)
    try:
        return timeit.timeit(lambda: log.end(log.begin(name)),
                             number=n) / n * 1e9
    finally:
        tracing.enable_spans(False)
        log.clear()


def span_means() -> dict:
    """Mean microseconds of each span name the log holds finished."""
    s = tracing.SPANS.snapshot()
    if s["lost"]:
        raise RuntimeError(f"the span log wrapped: {s['lost']} lost")
    end = np.asarray(s["end_ns"], dtype=np.int64)
    done = end > 0
    names = np.asarray(s["names"], dtype=object)
    name = names[np.asarray(s["name"], dtype=np.int64)][done]
    dur = (end - np.asarray(s["start_ns"], dtype=np.int64))[done] / 1e3
    return {n: float(dur[name == n].mean()) for n in dict.fromkeys(name)}


def _window(op, device, first: int, seconds: float, in_flight: int,
            mode: str) -> loop.Window:
    tracing.SPANS.clear()
    tracing.enable_spans(mode == "on")
    try:
        if mode != "prof":
            return loop.run(op, device, first, seconds=seconds,
                            in_flight=in_flight)
        activity = torch.profiler.ProfilerActivity.CUDA \
            if device.type == "cuda" else torch.profiler.ProfilerActivity.CPU
        with torch.profiler.profile(activities=[activity]):
            return loop.run(op, device, first, seconds=seconds,
                            in_flight=in_flight)
    finally:
        tracing.enable_spans(False)


def measure(cell: spec.Cell, device: torch.device, seconds: float,
            rounds: int, seed: int = SEED, out=None, **overrides) -> dict:
    """The rounds of one cell: per mode the host us per call of each
    window, the spans written in it, and (on, prof) each span name's
    mean us; printed to `out` (standard output).  `overrides` scale the
    shape down for tests on the CPU."""
    out = out or sys.stdout
    shape = Shape.of(cell.config, cell.traffic, **overrides)
    code = run.program(cell, device)
    op = cell.op_module().Operation(shape, seed, device, code, cell.traffic)
    first = loop.run(op, device, 0, calls=op.warm_calls,
                     in_flight=shape.calls_in_flight).calls
    first += loop.run(op, device, first, seconds=seconds,
                      in_flight=shape.calls_in_flight).calls
    got = {m: {"call_us": [], "written": [], "span_us": []} for m in MODES}
    for r in range(rounds):
        for mode in MODES if r % 2 == 0 else MODES[::-1]:
            w = _window(op, device, first, seconds,
                        shape.calls_in_flight, mode)
            first += w.calls
            us = w.enqueue_s / w.calls * 1e6
            written = tracing.SPANS.snapshot()["written"]
            g = got[mode]
            g["call_us"].append(us)
            g["written"].append(written)
            line = (f"{cell.name} r{r} {mode:4s} host us per call {us:.3f}"
                    f" calls {w.calls} spans written {written}")
            if written:
                g["span_us"].append(span_means())
                line += " | " + ", ".join(
                    f"{n} {v:.3f}" for n, v in g["span_us"][-1].items())
            print(line, file=out, flush=True)
    tracing.SPANS.clear()
    op.free()
    del code, op
    run._free(device)
    med = {m: statistics.median(got[m]["call_us"]) for m in MODES}
    print(f"SUMMARY {cell.name} median host us per call: off "
          f"{med['off']:.3f} on {med['on']:.3f} prof {med['prof']:.3f}; "
          f"on less off {med['on'] - med['off']:+.3f}", file=out, flush=True)
    for mode in ("on", "prof"):
        spans = got[mode]["span_us"]
        if spans:
            print(f"SUMMARY {cell.name} {mode} median span us: " + ", ".join(
                f"{n} {statistics.median(d[n] for d in spans if n in d):.3f}"
                for n in dict.fromkeys(n for d in spans for n in d)),
                file=out, flush=True)
    return got


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench.span_cost",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("cells", nargs="+")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rounds", type=int, default=6)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.span_cost: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(run.card_line(device), flush=True)
    for on in (False, True, False, True):
        print(f"span site begin+end, spans {'on' if on else 'off'}: "
              f"{site_ns(on):.1f} ns", flush=True)
    for k, name in enumerate(args.cells):
        measure(spec.resolve(name), device, args.seconds, args.rounds,
                SEED + k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
