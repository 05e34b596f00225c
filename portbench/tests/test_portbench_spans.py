"""The join of the program's span log with the profiler's timeline
(portbench/spans.py) and the seven readers built on it, on a timeline
made by hand and a span log filled by hand through a clock of the
test's own."""
from types import SimpleNamespace

import pytest

from ceph_tpu_torch.common import tracing
from portbench import span_cost, spans, spec, trace
from portbench.tests.conftest import CPU, small

OFFSET = -900.5          # us, trace clock less span clock
PERIOD = 100.0           # us between calls
FIRST_US = 1000.0        # the first call, span clock
ENCODE, DECODE = "ec.encode_batch", "ec.decode_batch_full"
NAMES = {n: tracing.span_name(n) for n in
         (ENCODE, DECODE, "ec.decode_table", "ec.stage", "ec.launch")}


class Clock:
    """time.monotonic_ns for the span log, set by the test in us."""
    now_us = 0.0

    def monotonic_ns(self) -> int:
        return round(self.now_us * 1e3)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(tracing, "time", c)
    return c


def reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py")


def stretch(clock, calls, root=ENCODE, misses=(),
            shift=lambda i: 0.0, log=None):
    """`calls` plugin calls, PERIOD us apart, in a fresh span log: each a
    50 us root over a 5 us stage and a 30 us launch (and, under
    DECODE, a 2 us table lookup, missing at the indices `misses`); and
    the timeline of the same stretch: each launch call inside its
    launch span at OFFSET (+ shift(i)), pinned to one end of the span
    on the first two and the last two calls, and a kernel per call from
    30 to 120 us into it.  Returns (log, Timeline)."""
    log = log or tracing.SpanLog()
    log.on = True
    device, host = [], []
    for i in range(calls):
        t = FIRST_US + i * PERIOD

        def span(name, a, b, arg=0):
            clock.now_us = t + a
            slot = log.begin(NAMES[name])
            clock.now_us = t + b
            return slot, arg

        r, _ = span(root, 0, 0)
        if root == DECODE:
            log.end(*span("ec.decode_table", 1, 3, int(i in misses)))
        log.end(*span("ec.stage", 2, 7))
        slot, _ = span("ec.launch", 10, 40)
        log.end(slot, 1)
        clock.now_us = t + 50
        log.end(r)
        off = OFFSET + shift(i)
        a = 0.0 if i in (0, calls - 2) else 3.0
        b = 0.0 if i in (1, calls - 1) else 5.0
        host.append(("cudaLaunchKernel", t + 10 + off + a, t + 40 + off - b))
        device.append(("kernel", "gf", t + 30 + off, t + 120 + off))
    lo = FIRST_US + OFFSET - 20
    hi = FIRST_US + (calls - 1) * PERIOD + OFFSET + 200
    host.append(("cudaLaunchKernel", lo - 8, lo - 3))      # the markers
    host.append(("cudaLaunchKernel", hi - 12, hi - 7))
    host.append(("cudaEventSynchronize", hi - 100, hi - 50))
    return log, trace.Timeline((lo, hi), device,
                               sorted(host, key=lambda h: h[1]))


def readings(op, tl):
    return SimpleNamespace(cell=SimpleNamespace(op=op), timeline=tl)


def test_the_join_finds_a_planted_offset(clock):
    log, tl = stretch(clock, 2200)
    s = spans.place(log.snapshot(), tl)
    assert s.join.offset_us == pytest.approx(OFFSET, abs=1e-6)
    assert s.join.pairs == 2200 and s.join.satisfied == 1.0
    assert s.join.drift_us == pytest.approx(0.0, abs=1e-6)


def test_the_join_reports_a_drift(clock):
    log, tl = stretch(clock, 2400, shift=lambda i: 25.0 * (i >= 1200))
    j = spans.place(log.snapshot(), tl).join
    assert j.drift_us == pytest.approx(25.0, abs=8.0)
    assert 0.45 <= j.satisfied <= 0.55


def test_encode_readers(clock, monkeypatch):
    calls = 20
    log, tl = stretch(clock, calls)
    monkeypatch.setattr(spans, "_log", lambda: log)
    r = readings("encode", tl)
    assert reader("plugin_span_us.encode").read(r) == pytest.approx(50.0)
    assert reader("launch_us.encode").read(r) == pytest.approx(30.0)
    # idle: 20 us before the first kernel, 10 us between kernels, 80
    # after the last; the host in a root span for 30 us of the first and
    # for every gap between kernels
    window = (calls - 1) * PERIOD + 220
    idle_in = reader("idle_in_plugin_pct.encode").read(r)
    assert idle_in == pytest.approx(100 * (30 + 10 * (calls - 1)) / window)
    idle = reader("device_idle_pct.encode").read(
        SimpleNamespace(cell=r.cell, timeline=tl))
    assert idle == pytest.approx(100 * (50 + 10 * (calls - 1) + 80) / window)
    assert idle_in <= idle
    for name in ("plugin_span_us.decode", "launch_us.decode",
                 "decode_table_miss_pct", "idle_in_plugin_pct.decode"):
        assert reader(name).read(r) is None


def test_decode_readers(clock, monkeypatch):
    log, tl = stretch(clock, 20, root=DECODE, misses=(3, 11))
    monkeypatch.setattr(spans, "_log", lambda: log)
    r = readings("decode", tl)
    assert reader("plugin_span_us.decode").read(r) == pytest.approx(50.0)
    assert reader("launch_us.decode").read(r) == pytest.approx(30.0)
    assert reader("decode_table_miss_pct").read(r) == pytest.approx(10.0)
    assert 0 < reader("idle_in_plugin_pct.decode").read(r) <= \
        reader("device_idle_pct.decode").read(r)
    assert reader("launch_us.encode").read(r) is None


def test_spans_outside_the_window_are_left_out(clock, monkeypatch):
    log = tracing.SpanLog()
    log.on = True
    slow = NAMES[ENCODE]
    clock.now_us = 10.0          # a long call long before the stretch
    root = log.begin(slow)
    clock.now_us = 500.0
    log.end(log.begin(NAMES["ec.launch"]), 1)
    log.end(root)
    log, tl = stretch(clock, 20, log=log)
    s = spans.place(log.snapshot(), tl)
    assert s.join.pairs == 20 and s.join.satisfied == 1.0
    assert int(s.inside.sum()) == 20 * 3 and s.written == 2 + 20 * 3
    monkeypatch.setattr(spans, "_log", lambda: log)
    r = readings("encode", tl)
    assert reader("plugin_span_us.encode").read(r) == pytest.approx(50.0)
    assert reader("launch_us.encode").read(r) == pytest.approx(30.0)


def test_a_wrapped_or_empty_log_fails(clock):
    log, tl = stretch(clock, 20, log=tracing.SpanLog(32))
    with pytest.raises(spans.SpanLogError, match="wrapped"):
        spans.place(log.snapshot(), tl)
    with pytest.raises(spans.SpanLogError):
        spans.place(tracing.SpanLog(32).snapshot(), tl)
    log, tl = stretch(clock, 20)
    tl.window = (tl.window[0], tl.window[0] + 40)  # ends inside call 0
    with pytest.raises(spans.SpanLogError, match="no root span"):
        spans.place(log.snapshot(), tl)


def test_a_program_without_the_span_log_reads_nothing(clock, monkeypatch):
    _, tl = stretch(clock, 4)
    monkeypatch.delattr(tracing, "SPANS")      # as the parent program
    for op, names in (("encode", ["plugin_span_us.encode",
                                  "launch_us.encode",
                                  "idle_in_plugin_pct.encode"]),
                      ("decode", ["plugin_span_us.decode",
                                  "launch_us.decode", "decode_table_miss_pct",
                                  "idle_in_plugin_pct.decode"])):
        for name in names:
            assert reader(name).read(readings(op, tl)) is None
            assert reader(name).read(readings(op, None)) is None


def test_read_prints_the_join_once_per_timeline(clock, monkeypatch, capsys):
    log, tl = stretch(clock, 8)
    monkeypatch.setattr(spans, "_log", lambda: log)
    r = readings("encode", tl)
    r.traced = SimpleNamespace(calls=8, enqueue_s=8 * 61e-6)
    assert spans.read(r) is spans.read(r)
    err = capsys.readouterr().err.splitlines()
    assert err == ["spans: 24 written, 24 inside the traced window; join: "
                   "8 launch pairs, offset -900.500 us, 100.000 % "
                   "satisfied, drift 0.000 us",
                   "spans: the harness's host us per call in the traced "
                   "stretch (not a metric): 61.000",
                   "spans, mean us inside the window: ec.encode_batch "
                   "50.000, ec.stage 5.000, ec.launch 30.000"]


def test_every_new_metric_lists_the_cells_its_reader_serves():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name, cells in (("plugin_span_us.encode", "encode"),
                        ("launch_us.encode", "encode"),
                        ("idle_in_plugin_pct.encode", "encode"),
                        ("plugin_span_us.decode", "decode2"),
                        ("launch_us.decode", "decode2"),
                        ("decode_table_miss_pct", "decode2"),
                        ("idle_in_plugin_pct.decode", "decode2")):
        listed = per_layer[name]["workloads"]
        assert listed and all(w.endswith("." + cells) for w in listed)
        assert reader(name).SOURCE == per_layer[name]["source"]


@pytest.mark.parametrize("name", ["k4m2.encode", "k4m2.decode2"])
def test_span_cost_records_only_when_on_or_profiled(name, capsys):
    cell = spec.resolve(name)
    got = span_cost.measure(cell, CPU, 0.05, 2, **small(cell))
    assert all(len(got[m]["call_us"]) == 2 for m in span_cost.MODES)
    assert got["off"]["written"] == [0, 0]
    root = "ec.encode_batch" if cell.op == "encode" else \
        "ec.decode_batch_full"
    for mode in ("on", "prof"):
        assert all(w > 0 for w in got[mode]["written"])
        assert all(root in m and "ec.launch" in m
                   for m in got[mode]["span_us"])
    assert tracing.SPANS.snapshot()["written"] == 0
    assert not tracing.SPANS.on
    out = capsys.readouterr().out
    assert f"SUMMARY {name} median host us per call: off" in out
    assert span_cost.site_ns(False, 1000) > 0
