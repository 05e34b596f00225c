"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up imports the port, builds or loads
its kernels (into `ceph_tpu_torch/_build/`, inside the checkout), makes
a `tpu` plugin through the port's registry, makes the cell's working
set on the card from the seed and warms every shape and pattern the
traffic uses.  The window then drives the traffic for `--seconds`.  With
`--trace 1` the same window runs for the host-clock readers, and a
fixed number of calls after it runs under the profiler for the device
readers.  After the window the program's state is freed and the plain
reference (`reference.py`) checks every call the seed's sample kept.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`, each compared number with its limit.
The same checks are the last lines of standard error.  No card, fewer
cards than the cell asks for, or JAX or the JAX package loaded once the
window closed: no result and a non-zero exit.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

import torch  # noqa: E402

from portbench import loop, spec, trace  # noqa: E402
from portbench.work import Work  # noqa: E402
from portbench.workload import Shape  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")


@dataclass
class Readings:
    """What the metric readers read."""
    cell: spec.Cell
    shape: Shape
    kind: str
    setup_s: float
    window: loop.Window
    work_per_call: Work
    traced: loop.Window | None = None
    timeline: trace.Timeline | None = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def card_line(device: torch.device) -> str:
    """The card's name, power limit and clocks."""
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    return f"card: {name}; nvidia-smi: {smi}"


def program(cell: spec.Cell, device: torch.device):
    """The system under test: a plugin of the port made by its registry."""
    from ceph_tpu_torch.ec import registry
    profile = dict(cell.config["profile"])
    return registry.factory(profile["plugin"], profile, device=device)


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def check(op, kept: list, device: torch.device) -> tuple[dict, int]:
    """Every kept call's output against the reference's: (the numbers
    compared, each with its limit; the calls found wrong)."""
    mismatched = failed = checked = 0
    for _, info, out in (x for x in kept if x is not None):
        want = op.expected(info, device)
        if tuple(out.shape) != tuple(want.shape):
            bad = want.numel()
        else:
            bad = int((out != want).sum().item())
        mismatched += bad
        failed += bad > 0
        checked += 1
        del want
    return {"mismatched_bytes": {"value": mismatched, "limit": 0,
                                 "rule": "at most"},
            "checked_calls": {"value": checked, "limit": 1,
                              "rule": "at least"}}, failed


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, make_code=program,
             t0: float | None = None, **overrides) -> dict:
    """One run of `cell`; returns the result object.  `make_code` makes
    what is measured (the program; the control and the fault tests put
    something else in its place); `overrides` scale the shape down for
    tests on the CPU."""
    t0 = time.perf_counter() if t0 is None else t0
    shape = Shape.of(cell.config, cell.traffic, **overrides)
    t_code = time.perf_counter()
    code = make_code(cell, device)
    t_op = time.perf_counter()
    op = cell.op_module().Operation(shape, seed, device, code, cell.traffic)
    loop.synchronize(device)
    t_warm = time.perf_counter()
    warm = loop.run(op, device, 0, calls=op.warm_calls,
                    in_flight=shape.calls_in_flight)
    loop.synchronize(device)
    t_end = time.perf_counter()
    setup_s = t_end - t0
    print(f"setup: {setup_s:.3f} s = to the cell {t_code - t0:.3f} + "
          f"program {t_op - t_code:.3f} + working set {t_warm - t_op:.3f} "
          f"+ warm-up {t_end - t_warm:.3f} ({warm.calls} calls)",
          file=sys.stderr)

    sample = loop.Reservoir(shape.check_sample_calls, seed)
    first = warm.calls
    window = loop.run(op, device, first, seconds=seconds,
                      in_flight=shape.calls_in_flight, sample=sample)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    r = Readings(cell, shape, kind, setup_s, window, op.work_per_call)
    if traced:
        first += window.calls
        r.traced, r.timeline = trace.capture(lambda: loop.run(
            op, device, first, calls=int(cell.traffic["trace_calls"]),
            in_flight=shape.calls_in_flight), device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(m).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    lat = sorted(window.latency_s)
    if lat:
        p = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3  # noqa
        print(f"window: {window.calls} calls in {window.seconds:.6f} s; "
              f"per call, host ms from submission to seen complete "
              f"(not a metric): p50 {p(0.5):.4f} p95 {p(0.95):.4f} "
              f"p99 {p(0.99):.4f}", file=sys.stderr)

    op.free()
    del code
    _free(device)
    checks, failed = check(op, sample.items, device)
    correct = checks["mismatched_bytes"]["value"] <= 0 and \
        checks["checked_calls"]["value"] >= 1

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.calls,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = r.timeline.busy_s()
        dev["window_s"] = r.timeline.window_s
        result["breakdown"] = {"device_ops": r.timeline.device_ops(),
                               "idle_gaps": r.timeline.idle_gaps()}
    result["checks"] = checks
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(card_line(device), file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t0=_T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit: {c['rule']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
