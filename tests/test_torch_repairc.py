"""The port's repair-schedule compiler against the reference package.

The cases of tests/test_repairc.py run against `ceph_tpu_torch` with the
numpy oracle and with K1's plain version on the CPU (`device="cpu"`);
every compiled matrix and every rebuilt stream equals the reference's;
the read/rebuilt ratios equal REPAIR_r01.json; `HashInfo` and crc32c
equal the reference's.  Every output is bytes, compared exactly."""
import itertools
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.common.crc32c import crc32c as ref_crc32c
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ec import repairc as ref_repairc
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu_torch.common import crc32c as port_crc32c
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.repairc import (RepairPlan, RepairProgram,
                                       RepairProgramCache, cache_of,
                                       compile_program, program_for)
from ceph_tpu_torch.osd import ecutil

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

#: the three codes the OSD routes through the compiler, with the
#: fraction of the k-full-chunk baseline a single-failure plan reads
PLUGINS = [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}, 1.0),
    ("clay", {"k": "4", "m": "2"}, 5 / 8),
    ("lrc", {"k": "4", "m": "2", "l": "3"}, 3 / 4),
]
IDS = [p for p, _, _ in PLUGINS]


def factory(plugin, profile):
    return registry.factory(plugin, dict(profile), device="cpu")


def _object(ec, nstripes=3, seed=7):
    """Encode a random object; returns (sinfo, shard streams, data)."""
    k = ec.get_data_chunk_count()
    cs = ec.get_chunk_size(k * 128)
    sinfo = ecutil.StripeInfo(k, k * cs)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, nstripes * sinfo.stripe_width,
                        dtype=np.uint8).tobytes()
    return sinfo, ecutil.encode(sinfo, ec, data), data


def _helper_bufs(plan, shards, cs):
    """Slice each helper's chunk stream down to the plan's extents:
    exactly the bytes ECSubRead ships (per stripe, plan order)."""
    byte_ext = plan.byte_extents(cs)
    out = {}
    for h in plan.helper_ids():
        ext = ecutil.expand_stream_extents(byte_ext[h], cs, len(shards[h]))
        out[h] = b"".join(shards[h][o:o + c] for o, c in ext)
    return out


def _signatures(n):
    for r in (1, 2):
        for lost in itertools.combinations(range(n), r):
            yield set(lost), set(range(n)) - set(lost)


@pytest.mark.parametrize("plugin,profile,frac", PLUGINS, ids=IDS)
def test_parity_sweep_all_signatures(plugin, profile, frac):
    """Every single and double erasure signature with a plan: the
    compiled program's output, numpy oracle and K1's plain version,
    equals the original shards byte for byte."""
    ec = factory(plugin, profile)
    n = ec.get_chunk_count()
    sinfo, shards, _ = _object(ec)
    cs = sinfo.chunk_size
    planned = 0
    for lost, avail in _signatures(n):
        plan = ecutil.repair_plan(ec, lost, avail)
        if len(lost) == 1:
            assert plan is not None, (plugin, lost)
        if plan is None:
            continue
        planned += 1
        assert set(plan.lost) == lost
        bufs = _helper_bufs(plan, shards, cs)
        for kw in ({"backend": "numpy"}, {"device": "cpu"}, {}):
            streams = ecutil.compiled_repair_streams(ec, plan, cs, bufs, **kw)
            for s in lost:
                assert streams[s] == shards[s], (plugin, lost, kw)
    assert planned >= n
    if plugin == "jerasure":
        assert planned == n + n * (n - 1) // 2


@pytest.mark.parametrize("plugin,profile,frac", PLUGINS, ids=IDS)
def test_compiled_matrices_and_streams_match_reference(plugin, profile, frac):
    """For every signature: the same plan, the same probe-extracted
    matrix, and the same rebuilt streams as the reference (its device
    backend, XLA on the CPU)."""
    ec = factory(plugin, profile)
    rc = ref_registry.factory(plugin, dict(profile))
    n = ec.get_chunk_count()
    sinfo, shards, _ = _object(ec, seed=11)
    ref_sinfo = ref_ecutil.StripeInfo(sinfo.stripe_width // sinfo.chunk_size,
                                      sinfo.stripe_width)
    ref_shards = ref_ecutil.encode(ref_sinfo, rc, _object(ec, seed=11)[2])
    assert ref_shards == shards
    cs = sinfo.chunk_size
    for lost, avail in _signatures(n):
        plan = ecutil.repair_plan(ec, lost, avail)
        ref_plan = ref_ecutil.repair_plan(rc, lost, avail)
        assert (plan is None) == (ref_plan is None), lost
        if plan is None:
            continue
        assert plan.signature() == ref_plan.signature()
        assert plan.read_fraction(4) == ref_plan.read_fraction(4)
        prog = compile_program(ec, plan)
        ref_prog = ref_repairc.compile_program(rc, ref_plan)
        assert np.array_equal(prog.matrix, ref_prog.matrix), lost
        bufs = _helper_bufs(plan, shards, cs)
        assert ecutil.compiled_repair_streams(ec, plan, cs, bufs) == \
            ref_ecutil.compiled_repair_streams(rc, ref_plan, cs, bufs)


@pytest.mark.parametrize("plugin,profile,frac", PLUGINS, ids=IDS)
def test_single_failure_read_fraction(plugin, profile, frac):
    ec = factory(plugin, profile)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    for lost in range(n):
        plan = ecutil.repair_plan(ec, {lost}, set(range(n)) - {lost})
        assert plan.read_fraction(k) == pytest.approx(frac), lost


def test_read_per_rebuilt_matches_repair_record():
    """Helper bytes read per byte rebuilt for a single failure (shard 0
    out) equal the reference's recorded ratios: 4.0 jerasure, 2.5 clay,
    3.0 lrc."""
    record = json.loads((ROOT / "REPAIR_r01.json").read_text())
    want = {c["code"]: c["single"]["read_per_rebuilt"] for c in record["codes"]}
    assert want == {"jerasure": 4.0, "clay": 2.5, "lrc": 3.0}
    for plugin, profile, _ in PLUGINS:
        ec = factory(plugin, profile)
        n = ec.get_chunk_count()
        plan = ecutil.repair_plan(ec, {0}, set(range(n)) - {0})
        cs = ec.get_chunk_size(4 * 4096)
        read = sum(c for ext in plan.byte_extents(cs).values() for _, c in ext)
        assert read / (len(plan.lost) * cs) == want[plugin], plugin
        assert plan.total_planes() / plan.output_planes() == want[plugin]


def test_lrc_plan_stays_in_local_group():
    ec = factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = ec.get_chunk_count()
    for lost in range(n):
        plan = ecutil.repair_plan(ec, {lost}, set(range(n)) - {lost})
        group = ec.local_layer(lost).chunks_as_set
        assert lost in group
        assert set(plan.helper_ids()) == group - {lost}
        assert len(plan.helper_ids()) < ec.get_data_chunk_count()


def test_compile_once_per_signature():
    ec = factory("jerasure", {"technique": "reed_sol_van", "k": "4",
                              "m": "2"})
    n = ec.get_chunk_count()
    sinfo, shards, _ = _object(ec)
    cs = sinfo.chunk_size
    for _ in range(3):
        for lost in range(n):
            plan = ecutil.repair_plan(ec, {lost}, set(range(n)) - {lost})
            streams = ecutil.compiled_repair_streams(
                ec, plan, cs, _helper_bufs(plan, shards, cs))
            assert streams[lost] == shards[lost]
    stats = cache_of(ec).stats()
    assert len(stats["compiles"]) == n
    assert all(c == 1 for c in stats["compiles"].values()), stats
    assert stats["hits"] >= 2 * n


def test_compile_counter_splits_probe_launches(monkeypatch):
    """COMPILES counts each compiled program and the K1 launches its
    probes made on the compiling thread, not those another thread makes
    meanwhile."""
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.ec.repairc import compiler

    ec = factory("tpu", {"k": "4", "m": "2"})
    plan = ecutil.repair_plan(ec, {1}, {0, 2, 3, 4, 5})
    plain = bm.gf_matmul
    other = []

    def bump():
        # stands in for the CUDA wrapper's count at the launch
        bm._THREAD.gf_matmul = bm.thread_launches() + 1
        return bm.thread_launches()

    def counted(tables, mat, data):
        bump()
        if not other:       # another thread launches during the compile
            t = threading.Thread(target=lambda: other.append(bump()))
            t.start()
            t.join()
        return plain(tables, mat, data)
    monkeypatch.setattr(bm, "gf_matmul", counted)
    before = dict(compiler.COMPILES)
    compile_program(ec, plan)
    assert other == [1]
    assert compiler.COMPILES["programs"] == before["programs"] + 1
    # total_planes + 1 probes, each one staged decode through K1
    assert compiler.COMPILES["probe_launches"] - \
        before["probe_launches"] == plan.total_planes() + 1


def test_cache_cost_weighted_eviction():
    ec = factory("jerasure", {"technique": "reed_sol_van", "k": "4",
                              "m": "2"})
    n = ec.get_chunk_count()
    plans = [ecutil.repair_plan(ec, {i}, set(range(n)) - {i})
             for i in range(n)]
    one_cost = compile_program(ec, plans[0]).cost()
    cache = RepairProgramCache(capacity=2 * one_cost)
    for p in plans[:3]:
        cache.get_or_compile(ec, p)
    assert len(cache) == 2
    assert cache.total_cost() <= 2 * one_cost
    cache.get_or_compile(ec, plans[1])
    cache.get_or_compile(ec, plans[3])
    sigs = [p.signature() for p in plans]
    assert cache.stats()["compiles"][sigs[1]] == 1
    cache.get_or_compile(ec, plans[2])
    stats = cache.stats()
    assert stats["compiles"][sigs[2]] == 2
    assert stats["compiles"][sigs[0]] == 1


def test_zero_probe_linearity_guard():
    class Affine:
        def decode(self, want, chunks, chunk_size):
            return {i: np.ones(chunk_size, dtype=np.uint8) for i in want}
    plan = RepairPlan.make([0], {1: [(0, 1)], 2: [(0, 1)]}, sub_chunk_no=1)
    with pytest.raises(ErasureCodeError, match="not GF-linear"):
        compile_program(Affine(), plan)


def test_program_shape_and_signature():
    plan = RepairPlan.make([3, 1], {0: [(0, 2)], 2: [(1, 1)]},
                           sub_chunk_no=2)
    assert plan.lost == (1, 3)
    assert plan.signature() == "-1-3+0@0:2+2@1:1/2"
    assert plan.total_planes() == 3
    assert plan.output_planes() == 4
    assert plan.byte_extents(8) == {0: [(0, 8)], 2: [(4, 4)]}
    with pytest.raises(ValueError):
        plan.byte_extents(7)
    with pytest.raises(ValueError):
        RepairPlan.make([0], {0: [(0, 1)]}, 1)
    with pytest.raises(ValueError):
        RepairPlan.make([0], {1: [(0, 0)]}, 1)
    prog = RepairProgram(RepairPlan.make([0], {1: [(0, 1)]}, 1),
                         np.eye(1, dtype=np.uint8))
    assert prog.run({1: b"abcd"}, 2, backend="numpy") == {0: b"abcd"}
    assert prog.run({1: b"abcd"}, 2, device="cpu") == {0: b"abcd"}
    with pytest.raises(ValueError):
        prog.run({1: b"abc"}, 2, backend="numpy")
    with pytest.raises(ValueError, match="backend"):
        prog.run({1: b"abcd"}, 2, backend="xla", device="cpu")


def test_clay_single_failure_vs_interpreted_reference():
    ec = factory("clay", {"k": "4", "m": "2"})
    n = ec.get_chunk_count()
    sinfo, shards, _ = _object(ec)
    cs = sinfo.chunk_size
    for lost in range(n):
        plan = ecutil.repair_plan(ec, {lost}, set(range(n)) - {lost})
        bufs = _helper_bufs(plan, shards, cs)
        compiled = ecutil.compiled_repair_streams(ec, plan, cs, bufs)
        interp = ecutil.repair_shard_stream(ec, cs, lost, bufs)
        assert compiled[lost] == interp == shards[lost]
        assert ecutil.repair_chunk_extents(ec, lost, cs) == \
            plan.byte_extents(cs)[plan.helper_ids()[0]]
    assert ecutil.supports_subchunk_repair(ec)
    assert not ecutil.supports_subchunk_repair(
        factory("jerasure", {"k": "4", "m": "2"}))


def test_clay_k6_m3_d8_matches_reference():
    """The corpus's wider clay profile: 27 sub-chunks, 8 helpers x 9
    planes, so K1's 27 x 72 repair shape."""
    profile = {"k": "6", "m": "3", "d": "8"}
    ec = factory("clay", profile)
    rc = ref_registry.factory("clay", dict(profile))
    sinfo, shards, _ = _object(ec, nstripes=2, seed=3)
    cs = sinfo.chunk_size
    n = ec.get_chunk_count()
    for lost in (0, 5, 8):
        avail = set(range(n)) - {lost}
        plan = ecutil.repair_plan(ec, {lost}, avail)
        assert (plan.output_planes(), plan.total_planes()) == (27, 72)
        prog = program_for(ec, plan)
        ref_prog = ref_repairc.compile_program(
            rc, ref_ecutil.repair_plan(rc, {lost}, avail))
        assert np.array_equal(prog.matrix, ref_prog.matrix)
        bufs = _helper_bufs(plan, shards, cs)
        assert ecutil.compiled_repair_streams(ec, plan, cs, bufs)[lost] == \
            shards[lost]


def test_program_from_reference():
    """A reference program carried across runs on the port unchanged."""
    profile = {"k": "4", "m": "2"}
    rc = ref_registry.factory("clay", dict(profile))
    ec = factory("clay", profile)
    n = ec.get_chunk_count()
    ref_prog = ref_repairc.compile_program(
        rc, ref_ecutil.repair_plan(rc, {2}, set(range(n)) - {2}))
    prog = RepairProgram.from_reference(ref_prog)
    assert prog.plan.signature() == ref_prog.plan.signature()
    assert np.array_equal(prog.matrix, ref_prog.matrix)
    sinfo, shards, _ = _object(ec)
    cs = sinfo.chunk_size
    bufs = _helper_bufs(prog.plan, shards, cs)
    assert prog.run(bufs, cs, device="cpu")[2] == shards[2]
    assert prog.run(bufs, cs, device="cpu") == ref_prog.run(bufs, cs)


def test_program_for_shares_per_instance_cache():
    ec = factory("lrc", {"k": "4", "m": "2", "l": "3"})
    n = ec.get_chunk_count()
    plan = ecutil.repair_plan(ec, {0}, set(range(n)) - {0})
    assert program_for(ec, plan) is program_for(ec, plan)
    ec2 = factory("lrc", {"k": "4", "m": "2", "l": "3"})
    assert program_for(ec2, plan) is not program_for(ec, plan)


def test_compiled_repair_runs_on_the_plugins_device():
    """Without device=, the program's kernel lives on the plugin's
    device; one kernel object per device."""
    ec = factory("jerasure", {"k": "4", "m": "2"})
    n = ec.get_chunk_count()
    sinfo, shards, _ = _object(ec)
    cs = sinfo.chunk_size
    plan = ecutil.repair_plan(ec, {1}, set(range(n)) - {1})
    bufs = _helper_bufs(plan, shards, cs)
    ecutil.compiled_repair_streams(ec, plan, cs, bufs)
    prog = program_for(ec, plan)
    assert list(prog._kernels) == [CPU]
    assert prog.kernel("cpu") is prog.kernel(CPU)
    assert prog.kernel("cpu").tables.device == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prog.run(bufs, cs)            # device None -> cuda


# ---------------------------------------------------------------------------
# HashInfo and crc32c
# ---------------------------------------------------------------------------

def test_crc32c_matches_reference():
    rng = np.random.default_rng(5)
    for size in (0, 1, 7, 4096, 100_003):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for seed in (0, 0xFFFFFFFF, 0x12345678):
            want = ref_crc32c(seed, data)
            assert port_crc32c.crc32c(seed, data) == want
            assert port_crc32c.crc32c(seed, bytearray(data)) == want
            if size < 5000:
                assert port_crc32c._crc32c_py(seed, data) == want
    # the reference's published vector (src/test/common/test_crc32c.cc)
    assert port_crc32c.crc32c(0, b"foo bar baz") == 4119623852


def test_hashinfo_matches_reference():
    rng = np.random.default_rng(9)
    n = 6
    hi, ref_hi = ecutil.HashInfo(n), ref_ecutil.HashInfo(n)
    size = 0
    for step in range(4):
        length = 512 * (step + 1)
        app = {s: rng.integers(0, 256, length, dtype=np.uint8).tobytes()
               for s in range(n)}
        hi.append(size, app)
        ref_hi.append(size, app)
        size += length
    assert hi.to_dict() == ref_hi.to_dict()
    assert [hi.get_chunk_hash(s) for s in range(n)] == \
        ref_hi.cumulative_shard_hashes
    assert hi.get_total_chunk_size() == ref_hi.get_total_chunk_size() == size
    assert ecutil.HashInfo.from_dict(ref_hi.to_dict()) == hi
    with pytest.raises(ValueError, match="append at"):
        hi.append(0, {s: b"x" for s in range(n)})
    with pytest.raises(ValueError, match="every shard"):
        hi.append(size, {0: b"x"})
    one, ref_one = ecutil.HashInfo(n), ref_ecutil.HashInfo(n)
    one.append_shard(3, 0, b"abc")
    ref_one.append_shard(3, 0, b"abc")
    assert one.to_dict() == ref_one.to_dict()
    assert repr(one) == repr(ref_one)


def _rack_wrapper(wrapper_cls):
    """3 racks x 4 hosts x 1 OSD under `default`, built with the
    wrapper's add_bucket / insert_item (osd.i sits in rack i // 4)."""
    cw = wrapper_cls()
    cw.add_bucket("default", "root")
    for r in range(3):
        rack = f"rack{r}"
        cw.add_bucket(rack, "rack")
        for h in range(4):
            osd = r * 4 + h
            host = f"host{osd}"
            cw.add_bucket(host, "host")
            cw.insert_item(osd, 1.0, f"osd.{osd}", host)
            rb = cw.crush.bucket(cw.get_item_id(rack))
            hid = cw.get_item_id(host)
            rb.items.append(hid)
            w = cw.crush.bucket(hid).weight
            rb.item_weights.append(w)
            rb.weight += w
        root = cw.crush.bucket(cw.get_item_id("default"))
        rid_ = cw.get_item_id(rack)
        root.items.append(rid_)
        root.item_weights.append(cw.crush.bucket(rid_).weight)
        root.weight += cw.crush.bucket(rid_).weight
    return cw


def test_lrc_locality_rule_maps_groups_to_fault_domains():
    """crush-locality lines local parity groups up with CRUSH fault
    domains on the port's CrushWrapper: the generated rule picks one rack
    per group and spreads that group's chunks across hosts inside it, and
    maps every x as the reference's rule on the reference's wrapper."""
    from ceph_tpu.crush.wrapper import CrushWrapper as RefCrushWrapper
    from ceph_tpu_torch.crush.wrapper import CrushWrapper
    profile = {"k": "4", "m": "2", "l": "3", "crush-locality": "rack",
               "crush-failure-domain": "host"}
    ec = registry.factory("lrc", dict(profile), device=CPU)
    ref_ec = ref_registry.factory("lrc", dict(profile))
    n = ec.get_chunk_count()
    cw, ref_cw = _rack_wrapper(CrushWrapper), _rack_wrapper(RefCrushWrapper)
    rid = ec.create_rule("lrc_rule", cw)
    assert rid == ref_ec.create_rule("lrc_rule", ref_cw)
    assert cw.rule_name_map[rid] == "lrc_rule"
    for x in range(8):
        osds = cw.do_rule(rid, x, n)
        assert osds == ref_cw.do_rule(rid, x, n)
        assert len(osds) == n and len(set(osds)) == n
        assert all(o >= 0 for o in osds)
        # each local group's 4 chunks land in ONE rack, and the two
        # groups land in DIFFERENT racks
        racks = [{o // 4 for o in osds[g:g + 4]} for g in (0, 4)]
        assert all(len(r) == 1 for r in racks), (x, osds)
        assert racks[0] != racks[1], (x, osds)
