"""The port's device-contract guard (ceph_tpu_torch.common.devguard).

Counterparts of the jaxguard cases of tests/test_common.py, on the CPU:
the guard is off unless CEPH_TPU_TORCH_DEVGUARD or enable() arms it, and
a no-op while off; recompile bounds are declared per signature; a second
load of the same kernel library and a second compile of one repair
signature trip RecompileError; a tensor on the wrong device is refused
by the kernel wrappers; a cuda region sets torch's sync debug mode to
"error" and restores the mode the outermost region found (here with a
stand-in for torch's mode functions: this build has no CUDA).  The
guarded paths (ECUtil, compiled repair, the batch CRUSH engine) give
their usual results on the CPU with the guard armed.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import devguard
from ceph_tpu_torch.crush import batch as crush_batch
from ceph_tpu_torch.crush import mapper
from ceph_tpu_torch.crush import testing as crush_testing
from ceph_tpu_torch.crush.types import CrushRule
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.kernels import _build
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.ec.repairc import RepairProgramCache
from ceph_tpu_torch.osd import ecutil

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture
def armed():
    """The guard on, with fresh counts; off and cleared afterwards."""
    was = devguard.enabled()
    devguard.reset()
    devguard.enable()
    try:
        yield
    finally:
        devguard.reset()
        if not was:
            devguard.disable()


@pytest.fixture
def sync_mode(monkeypatch):
    """Stand-ins for torch's process-wide sync debug mode."""
    state = {"mode": 0, "sets": []}
    names = {"default": 0, "warn": 1, "error": 2}

    def set_mode(mode):
        state["mode"] = names.get(mode, mode)
        state["sets"].append(state["mode"])

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return state


def test_guard_is_off_by_default_and_armed_by_env(monkeypatch):
    monkeypatch.delenv(devguard.ENV, raising=False)
    assert not devguard._armed_by_env()
    for value, want in (("1", True), ("on", True), ("0", False),
                        ("", False)):
        monkeypatch.setenv(devguard.ENV, value)
        assert devguard._armed_by_env() is want
    probe = ("from ceph_tpu_torch.common import devguard; "
             "print(devguard.enabled())")
    env = {k: v for k, v in os.environ.items() if k != devguard.ENV}
    for value, want in ((None, "False"), ("1", "True")):
        if value is not None:
            env[devguard.ENV] = value
        out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want


def test_enable_and_disable():
    was = devguard.enabled()
    try:
        devguard.enable()
        assert devguard.enabled()
        devguard.disable()
        assert not devguard.enabled()
    finally:
        if was:
            devguard.enable()


def test_off_is_a_no_op(sync_mode):
    was = devguard.enabled()
    devguard.disable()
    try:
        with devguard.guard_transfers("cuda"):
            pass
        assert sync_mode["sets"] == []
        # off, every region is the one shared null context
        assert devguard.guard_transfers("cuda") is \
            devguard.guard_transfers(CPU)
        devguard.check_device("w", CPU, torch.empty(1, device="meta"))
        devguard.count_compile("site", "sig")
        devguard.count_compile("site", "sig")
        assert devguard.stats() == {}
    finally:
        if was:
            devguard.enable()


def test_recompile_trips_the_default_bound(armed):
    devguard.count_compile("site_a", "sig")           # first compile: legal
    with pytest.raises(devguard.RecompileError, match="site_a"):
        devguard.count_compile("site_a", "sig")
    devguard.count_compile("site_a", "other")
    assert devguard.stats() == {"site_a": {"compiles": 3, "recompiles": 1,
                                           "signatures": 2}}


def test_declared_bound_allows_n_recompiles_per_signature(armed):
    devguard.set_recompile_bound("_bounded", 1)
    devguard.count_compile("x_bounded", "a")          # sig a: compile
    devguard.count_compile("x_bounded", "a")          # sig a: recompile 1
    devguard.count_compile("x_bounded", "b")          # sig b: compile
    devguard.count_compile("x_bounded", "b")          # sig b: recompile 1
    with pytest.raises(devguard.RecompileError):
        devguard.count_compile("x_bounded", "a")      # sig a: recompile 2
    devguard.count_compile("y_other", "a")            # other site: its own


def test_second_load_of_a_library_trips(armed, monkeypatch):
    """Each source's library loads once per process; loading it again
    (a cleared cache) is a recompile."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda *names: {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.load("gf_matmul")
    _build.load("gf_matmul")                          # cached: no compile
    _build.load("crush_rule")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(devguard.RecompileError, match="load:gf_matmul"):
        _build.load("gf_matmul")
    stats = devguard.stats()
    assert stats["load:crush_rule"] == {"compiles": 1, "recompiles": 0,
                                        "signatures": 1}


def test_repair_program_compiles_once_per_signature(armed):
    ec = registry.factory("jerasure", {"technique": "reed_sol_van",
                                       "k": "4", "m": "2"}, device="cpu")
    n = ec.get_chunk_count()
    plans = [ecutil.repair_plan(ec, {i}, set(range(n)) - {i})
             for i in range(2)]
    cache = RepairProgramCache()
    for plan in plans * 2:                            # second round: hits
        cache.get_or_compile(ec, plan)
    assert devguard.stats()["repairc"] == {"compiles": 2, "recompiles": 0,
                                           "signatures": 2}
    # a cache that compiles a signature again (evicted) trips the guard
    tiny = RepairProgramCache(capacity=1)
    tiny.get_or_compile(ec, plans[0])
    tiny.get_or_compile(ec, plans[1])
    with pytest.raises(devguard.RecompileError, match="repairc"):
        tiny.get_or_compile(ec, plans[0])


def test_wrong_device_is_refused_inside_a_region(armed):
    op = bm.GFMatmul(np.arange(8, dtype=np.uint8).reshape(2, 4), CPU)
    data = torch.zeros((1, 4, 16), dtype=torch.uint8)
    with devguard.guard_transfers(CPU):
        assert bm.gf_matmul(op.tables, op.mat_t, data).shape == (1, 2, 16)
        with pytest.raises(devguard.DevGuardError, match="gf_matmul"):
            bm.gf_matmul(op.tables, op.mat_t.to("meta"), data)
        full = bm.GFDecodeFull(np.eye(2, 4, dtype=np.uint8), None, CPU)
        with pytest.raises(devguard.DevGuardError, match="gf_decode_select"):
            bm.gf_decode_select(full.tables, full.sel_t.to("meta"),
                                full.mat_t, full.runs, data)
        m, root = crush_testing.build_hierarchy(seed=1)
        steps, result_max = crush_testing.rule_shapes(root)["ec_indep"]
        m.rules.append(CrushRule(steps=steps))
        cc = crush_batch.compile_map(m, device=CPU)
        cfg = cc.rule_cfg(0, result_max)
        weight = torch.full((m.max_devices,), 0x10000, dtype=torch.int64)
        with pytest.raises(devguard.DevGuardError, match="map_batch_plain"):
            crush_batch.map_batch_plain(cc, cfg, torch.arange(4).to("meta"),
                                        weight)


def test_staged_launch_equals_call():
    """Callers that stage their input once launch the operators with
    launch(); it gives what __call__ gives on the host array."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (3, 4, 64), dtype=np.uint8)
    op = bm.GFMatmul(rng.integers(0, 256, (2, 4), dtype=np.uint8), CPU)
    staged = torch.from_numpy(data)
    assert torch.equal(op.launch(staged), op(data))
    full = bm.GFDecodeFull(rng.integers(1, 256, (2, 4), dtype=np.uint8),
                           None, CPU)
    assert torch.equal(full.launch(staged), full(data))


def test_cuda_region_sets_and_restores_the_sync_mode(armed, sync_mode):
    sync_mode["mode"] = 1                             # a caller's "warn"
    with devguard.guard_transfers("cuda"):
        assert sync_mode["mode"] == 2
        with devguard.guard_transfers(torch.device("cuda", 0)):
            assert sync_mode["mode"] == 2
        assert sync_mode["mode"] == 2                 # inner exit: still on
    assert sync_mode["mode"] == 1
    with pytest.raises(ValueError):
        with devguard.guard_transfers("cuda"):
            raise ValueError("inside")
    assert sync_mode["mode"] == 1
    assert sync_mode["sets"] == [2, 1, 2, 1]
    with devguard.guard_transfers(CPU):               # a cpu region: no mode
        pass
    assert sync_mode["sets"] == [2, 1, 2, 1]


def test_guarded_paths_unchanged_on_the_cpu(armed):
    """ECUtil round trip, compiled repair and map_batch with the guard
    armed: same bytes, no guard error, no recompile."""
    ec = registry.factory("tpu", {"k": "4", "m": "2"}, device="cpu")
    sinfo = ecutil.StripeInfo(4, 4 * 1024)
    data = np.random.default_rng(5).integers(
        0, 256, 3 * sinfo.stripe_width, dtype=np.uint8).tobytes()
    shards = ecutil.encode(sinfo, ec, data)
    degraded = {i: v for i, v in shards.items() if i not in (1, 4)}
    assert ecutil.decode_concat(sinfo, ec, degraded) == data
    plan = ecutil.repair_plan(ec, {0}, set(range(6)) - {0})
    bufs = {h: shards[h] for h in plan.helper_ids()}
    assert ecutil.compiled_repair_streams(ec, plan, 1024, bufs)[0] == shards[0]
    m, root = crush_testing.build_hierarchy(seed=2)
    steps, result_max = crush_testing.rule_shapes(root)["replicated_firstn"]
    m.rules.append(CrushRule(steps=steps))
    cc = crush_batch.compile_map(m, device=CPU)
    weight = [0x10000] * m.max_devices
    got, cnt = cc.map_batch(np.arange(64), np.asarray(weight),
                            result_max=result_max, return_counts=True)
    for x in range(64):
        assert got[x, :cnt[x]].tolist() == \
            mapper.do_rule(m, 0, x, result_max, weight)
    assert all(s["recompiles"] == 0 for s in devguard.stats().values())
