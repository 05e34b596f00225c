"""The shape of a run's result, the arithmetic of its readers, and the
timeline of a trace, on the CPU."""
import json

import pytest

from portbench import run, trace, work
from portbench.tests.conftest import CPU, small

TOP_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_result_line_of_a_small_run(cell):
    res = run.run_cell(cell, 2**31 + 7, 0.2, False, CPU, **small(cell))
    assert list(res) == TOP_KEYS          # checks last
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"]["mismatched_bytes"]["value"] == 0
    assert res["checks"]["checked_calls"]["value"] == 8
    json.loads(json.dumps(res))


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "k8m4.encode", "--seed", "1",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "needs 1 CUDA device" in err


def test_bound_of_the_north_star_call():
    # 256 x (8 read + 4 written) x 128 KiB over 3.35 TB/s
    w = work.gf_product(256, 8, 4, 131072)
    assert w.bytes == 256 * 12 * 131072 and w.ops == 256 * 131072 * 32
    s, by = work.bound_s(w, "NVIDIA H100 80GB HBM3")
    assert by == "bytes" and s == pytest.approx(1.2019e-4, rel=1e-4)
    s, _ = work.bound_s(work.gf_product(256, 8, 2, 131072) * 2,
                        "NVIDIA H100 80GB HBM3")
    assert s == pytest.approx(2 * 1.0016e-4, rel=1e-4)
    with pytest.raises(KeyError):
        work.peaks("no such card")


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_timeline_between_the_markers():
    events = [
        _ev("kernel", "mark", 100.0, 2.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 101.0, 6.0),
        _ev("kernel", "k1", 110.0, 40.0),
        _ev("gpu_memcpy", "copy", 140.0, 20.0),       # overlaps k1
        _ev("cuda_runtime", "cudaEventSynchronize", 170.0, 10.0),
        _ev("kernel", "k1", 200.0, 50.0),
        _ev("kernel", "mark", 298.0, 2.0),
        {"ph": "i", "cat": "kernel", "name": "x", "ts": 0},
    ]
    tl = trace.parse(events)
    assert tl.window == (100.0, 300.0) and tl.window_s == pytest.approx(2e-4)
    assert tl.busy_s() == pytest.approx(100e-6)        # 110-160, 200-250
    assert tl.busy_s(("kernel",)) == pytest.approx(90e-6)
    ops = dict((n, s) for n, s in tl.device_ops())
    assert ops == pytest.approx({"k1": 90e-6, "copy": 20e-6})
    gaps = tl.idle_gaps()
    assert [g[0] for g in gaps] == ["host:python", "host:cudaEventSynchronize",
                                    "host:cudaLaunchKernel"]
    assert [g[1] for g in gaps] == pytest.approx([50e-6, 40e-6, 10e-6])


def test_a_trace_without_device_time_fails():
    with pytest.raises(RuntimeError):
        trace.parse([_ev("cuda_runtime", "cudaLaunchKernel", 1.0, 1.0)])
    with pytest.raises(RuntimeError):
        trace.parse([_ev("kernel", "mark", 0.0, 1.0),
                     _ev("gpu_memset", "fill", 2.0, 1.0),
                     _ev("kernel", "mark", 5.0, 1.0)])
