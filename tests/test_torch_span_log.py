"""The device-path span log (`ceph_tpu_torch.common.tracing.SpanLog`) and
its sites in the `tpu` plugin and the kernel operators, on the CPU."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.kernels.bitmatmul import GFMatmul

K, M = 4, 2


@pytest.fixture
def log():
    tracing.SPANS.clear()
    tracing.enable_spans(False)
    yield tracing.SPANS
    tracing.enable_spans(False)
    tracing.SPANS.clear()


def plugin():
    return registry.factory("tpu", {"k": str(K), "m": str(M)},
                            device="cpu")


def stripes(seed=1, n=K + M):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (3, n, 64), dtype=torch.uint8, generator=g)


def entries(log) -> list[dict]:
    """The snapshot as one dict per span."""
    snap = log.snapshot()
    keys = ("name", "call", "parent", "start_ns", "end_ns", "arg", "slot")
    return [dict(zip(keys, row), name=snap["names"][row[0]])
            for row in zip(*(snap[k] for k in keys))]


def test_off_the_plugin_records_nothing_and_answers_alike(log):
    ec = plugin()
    data, full = stripes()[:, :K], stripes(2)
    off = (ec.encode_batch(data), ec.decode_batch_full([0, 5], full))
    assert log.snapshot()["written"] == 0
    tracing.enable_spans(True)
    on = (ec.encode_batch(data), ec.decode_batch_full([0, 5], full))
    assert log.snapshot()["written"] > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_a_profiler_session_records_the_named_spans(log):
    ec = plugin()
    ec.decode_batch_full([1, 2], stripes(3))       # cached before
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ec.encode_batch(stripes()[:, :K])
        ec.decode_batch_full([1, 2], stripes(3))   # a hit
        ec.decode_batch_full([0, 3], stripes(4))   # a miss
    ec.encode_batch(stripes()[:, :K])              # after: not recorded
    spans = entries(log)
    assert [s["name"] for s in spans] == [
        "ec.encode_batch", "ec.stage", "ec.launch",
        "ec.decode_batch_full", "ec.decode_table", "ec.stage", "ec.launch",
        "ec.decode_batch_full", "ec.decode_table", "ec.stage", "ec.launch"]
    roots = [s for s in spans if s["parent"] < 0]
    assert len({r["call"] for r in roots}) == 3
    by_slot = {s["slot"]: s for s in spans}
    for s in spans:
        assert 0 < s["start_ns"] <= s["end_ns"]
        if s["parent"] >= 0:
            root = by_slot[s["parent"]]
            assert root["parent"] < 0 and root["call"] == s["call"]
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]
    assert [s["arg"] for s in spans if s["name"] == "ec.decode_table"] == \
        [0, 1]
    assert [s["arg"] for s in spans if s["name"] == "ec.launch"] == [1, 2, 2]


def test_staged_decode_and_a_bare_launch(log):
    ec = plugin()
    tracing.enable_spans(True)
    survivors = stripes(5, K)
    ec.decode_batch([0, 1, 2, 4], [3], survivors)
    ec.decode_batch([0, 1, 2, 4], [3], survivors)
    GFMatmul(np.eye(K, dtype=np.uint8), "cpu").launch(survivors)
    spans = entries(log)
    # the staged decode runs in no benchmark cell: only its operator's
    # launch is a span, a root of its own like any other launch
    assert [(s["name"], s["arg"], s["parent"]) for s in spans] == \
        [("ec.launch", 1, -1)] * 3
    assert len({s["call"] for s in spans}) == 3


def test_a_failed_call_leaves_no_root_open(log):
    ec = plugin()
    tracing.enable_spans(True)
    with pytest.raises(ValueError):
        ec.encode_batch(torch.zeros((2, K + 1, 32), dtype=torch.uint8))
    ec.encode_batch(stripes()[:, :K])
    spans = entries(log)
    assert spans[0]["end_ns"] > 0 and spans[2]["end_ns"] > 0
    assert [s["parent"] for s in spans[3:]] == [-1, spans[3]["slot"],
                                                spans[3]["slot"]]


def test_threads_keep_their_own_roots(log):
    tracing.enable_spans(True)
    root, child = tracing.span_name("t.root"), tracing.span_name("t.child")
    start = threading.Barrier(4)

    def work():
        start.wait(timeout=10)
        for _ in range(200):
            r = log.begin(root)
            log.end(log.begin(child))
            log.end(r)

    threads = [threading.Thread(target=work) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = entries(log)
    assert len(spans) == 1600
    by_slot = {s["slot"]: s for s in spans}
    for s in spans:
        if s["name"] == "t.child":
            assert by_slot[s["parent"]]["name"] == "t.root"
            assert by_slot[s["parent"]]["call"] == s["call"]


def test_the_ring_reports_what_it_lost():
    ring = tracing.SpanLog(8)
    ring.on = True
    name = tracing.span_name("t.wrap")
    for i in range(11):
        ring.end(ring.begin(name), i)
    snap = ring.snapshot()
    assert snap["written"] == 11 and snap["lost"] == 3
    assert snap["arg"] == list(range(3, 11))       # oldest first
    assert snap["start_ns"] == sorted(snap["start_ns"])
    with pytest.raises(ValueError):
        tracing.SpanLog(6)


def test_a_root_the_ring_overwrote_ends_cleanly():
    ring = tracing.SpanLog(8)
    ring.on = True
    root, child = tracing.span_name("t.root"), tracing.span_name("t.child")
    r = ring.begin(root)
    for i in range(8):               # the eighth child takes the root's slot
        ring.end(ring.begin(child), 10 + i)
    ring.end(r, 99)
    snap = ring.snapshot()
    assert snap["lost"] == 1
    assert snap["arg"] == list(range(10, 18))   # the root's end wrote nothing
    assert all(e > 0 for e in snap["end_ns"])
    assert len(set(snap["call"])) == 1
    ring.end(ring.begin(child))       # the root is closed: a new root
    snap = ring.snapshot()
    assert snap["parent"][-1] == -1
    assert snap["call"][-1] != snap["call"][0]


def test_the_log_and_blkin_spans_read_one_clock(log):
    tracing.enable_spans(True)
    name = tracing.span_name("t.clock")
    log.end(log.begin(name))
    span = tracing.Tracer("osd.0").start_span(tracing.new_trace(), "op")
    log.end(log.begin(name))
    before, after = log.snapshot()["start_ns"]
    assert before / 1e9 <= span.start <= after / 1e9
    assert abs(time.monotonic_ns() / 1e9 - time.monotonic()) < 0.01


def test_enable_spans_records_between_on_and_off(log):
    ec = plugin()
    data = stripes()[:, :K]
    ec.encode_batch(data)
    tracing.enable_spans(True)
    ec.encode_batch(data)
    tracing.enable_spans(False)
    ec.encode_batch(data)
    assert [s["name"] for s in entries(log)] == [
        "ec.encode_batch", "ec.stage", "ec.launch"]
