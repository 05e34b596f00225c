"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1/K2 (GF(2^8) products), K3 (CRUSH do_rule over a batch of seeds), and
the paths that reach K1 from the plugin family: compiled repair, the
bit-matrix device form, and the EC placement group's data plane
(ECBackend writes, degraded reads and recovery).

Marked `cuda`: each test skips without a CUDA device.  On a machine with
one (no JAX needed, so the repository conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs, compared exactly.
"""
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import batch as crush_batch
from ceph_tpu_torch.crush import testing as crush_testing
from ceph_tpu_torch.crush.types import CrushRule
from ceph_tpu_torch.ec import bitmatrix, gf, registry
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.ec.matrix_code import make_decode_matrix_full
from ceph_tpu_torch.ec.repairc import cache_of
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd import mapping as osd_mapping
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PGPool

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def k1_against_plain(dev, r, k, s, n, ptr_offset=0):
    rng = np.random.default_rng(r * 1000 + k * 10 + s)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = torch.from_numpy(
        rng.integers(0, 256, (s, k, n), dtype=np.uint8)).to(dev)
    if ptr_offset:
        buf = torch.empty(data.numel() + 32, dtype=torch.uint8, device=dev)
        start = (-buf.data_ptr()) % 16 + ptr_offset
        data = buf[start:start + data.numel()].view(data.shape).copy_(data)
        assert data.data_ptr() % 16 == ptr_offset
    tables = torch.from_numpy(bm.packed_nibble_tables(mat)).to(dev)
    before = bm.LAUNCHES["gf_matmul"]
    got = bm.gf_matmul_cuda(tables, data, r)
    assert bm.LAUNCHES["gf_matmul"] == before + 1
    want = bm.gf_matmul_plain(torch.from_numpy(mat).to(dev), data)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("r,k,s,n", [
    (4, 8, 4, 131072), (2, 8, 3, 4096), (3, 5, 7, 31), (4, 20, 1, 4113),
    (10, 6, 2, 1000), (1, 2, 5, 1),
] + [(r, 8, 3, 4096 + 17) for r in (1, 2, 3, 4, 5, 6, 7, 8, 12)]
  + [(4, k, 2, 8192) for k in (2, 5, 20)])
def test_k1_matches_plain(dev, r, k, s, n):
    k1_against_plain(dev, r, k, s, n)


@pytest.mark.parametrize("r,k,n", [
    (1, 4, 1 << 20), (2, 4, 1 << 20), (1, 3, 1 << 20),   # jerasure, lrc
    (8, 20, 131072), (27, 72, 25920),                    # clay 4/2, 6/3/8
    (16, 64, 65536),                                     # liber8tion k=8
    (16, 256, 65536), (4, 400, 8192), (9, 200, 4099),    # > 48 KiB tables
])
def test_k1_matches_plain_at_repair_shapes(dev, r, k, n):
    """One stripe (S = 1) as compiled repair launches it; k above 192
    (W = 8) or 384 (W = 4) takes the opt-in shared-memory branch."""
    k1_against_plain(dev, r, k, 1, n)


def test_k1_splits_stripes_over_grid_y(dev):
    """65539 stripes: more than grid.y takes, so two launches."""
    k1_against_plain(dev, 1, 2, 65539, 17)


def test_k1_unaligned_pointer(dev):
    k1_against_plain(dev, 4, 8, 3, 4096, ptr_offset=1)


def test_k1_refuses_tables_of_another_layout(dev):
    mat = gf.isa_rs_matrix(8, 4)[8:]
    data = torch.zeros((1, 8, 16), dtype=torch.uint8, device=dev)
    tables = torch.from_numpy(bm.nibble_tables(mat)).to(dev)
    with pytest.raises(ValueError, match="packed_nibble_tables"):
        bm.gf_matmul_cuda(tables, data, 4)


def test_k2_matches_plain_all_double_erasures(dev):
    k, m = 8, 4
    n = k + m
    ec = registry.factory("tpu", {"k": str(k), "m": str(m)}, device=dev)
    rng = np.random.default_rng(3)
    for erasures in itertools.combinations(range(n), 2):
        erasures = list(erasures)
        decode_index = [i for i in range(n) if i not in erasures][:k]
        full = make_decode_matrix_full(ec.encode_matrix, k, n, decode_index,
                                       erasures)
        op = bm.GFDecodeFull(full, None, dev)
        data = rng.integers(0, 256, (2, k, 999), dtype=np.uint8)
        parity = np.stack([gf.gf_matmul_bytes(ec.encode_matrix[k:], d)
                           for d in data])
        arrival = np.concatenate([data, parity], axis=1)
        want = arrival[:, erasures].copy()
        arrival[:, erasures] = rng.integers(0, 256, (2, 2, 999),
                                            dtype=np.uint8)
        a = torch.from_numpy(arrival).to(dev)
        got = bm.gf_decode_select_cuda(op.tables, op.sel_t, a)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy(), want), erasures
        assert torch.equal(got, bm.gf_decode_select_plain(op.mat_t, op.runs, a))


def test_plugin_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (3, 8, 4096), dtype=np.uint8)
    card = registry.factory("tpu", {"k": "8", "m": "4"})
    cpu = registry.factory("tpu", {"k": "8", "m": "4"}, device="cpu")
    assert torch.equal(card.encode_batch(data).cpu(), cpu.encode_batch(data))
    full = np.concatenate([data, cpu.encode_batch(data).numpy()], axis=1)
    outs = list(card.decode_batches_full([1, 9], [full, full[::-1].copy()]))
    assert np.array_equal(outs[0].cpu().numpy(), full[:, [1, 9]])
    assert np.array_equal(outs[1].cpu().numpy(), full[::-1][:, [1, 9]])


# -- K3: CRUSH do_rule -------------------------------------------------------

def k3_against_plain(dev, m, result_max, weight, xs, ruleno=0):
    cc = crush_batch.compile_map(m, device=dev)
    cfg = cc.rule_cfg(ruleno, result_max)
    xs = torch.as_tensor(np.asarray(xs, dtype=np.int64), device=dev)
    weight = torch.as_tensor(np.asarray(weight, dtype=np.int64), device=dev)
    before = crush_batch.LAUNCHES["crush_do_rule"]
    got, got_n = crush_batch.crush_do_rule_cuda(cc, cfg, xs, weight)
    assert crush_batch.LAUNCHES["crush_do_rule"] == before + 1
    want, want_n = crush_batch.map_batch_plain(cc, cfg, xs, weight)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_n, want_n)


@pytest.mark.parametrize("tunables", ["jewel", "firefly"])
@pytest.mark.parametrize("rule", ["replicated_firstn", "ec_indep",
                                  "two_level_firstn", "direct_osd_indep",
                                  "direct_osd_firstn"])
def test_k3_matches_plain(dev, rule, tunables):
    m, root = crush_testing.build_hierarchy(seed=len(rule), tunables=tunables)
    steps, result_max = crush_testing.rule_shapes(root)[rule]
    m.rules.append(CrushRule(steps=steps))
    weight = crush_testing.make_weight(m.max_devices, seed=1)
    k3_against_plain(dev, m, result_max, weight, range(3000))


def test_k3_more_seeds_than_one_grid_row(dev):
    m, root = crush_testing.build_hierarchy(seed=3)
    steps, result_max = crush_testing.rule_shapes(root)["ec_indep"]
    m.rules.append(CrushRule(steps=steps))
    k3_against_plain(dev, m, result_max,
                     crush_testing.make_weight(m.max_devices, seed=2),
                     np.arange(70_000) * 7919)


def test_k3_result_max_at_the_cap(dev):
    cap = crush_batch.CRUSH_MAX_RESULT
    m = crush_testing.build_flat([0x10000] * (2 * cap), numrep=0)
    k3_against_plain(dev, m, cap, crush_testing.make_weight(
        2 * cap, seed=8, frac_out=0.05), range(500))


def test_k3_refuses_result_max_above_the_cap(dev):
    cap = crush_batch.CRUSH_MAX_RESULT
    m = crush_testing.build_flat([0x10000] * (2 * cap), numrep=0)
    cc = crush_batch.compile_map(m, device=dev)
    with pytest.raises(crush_batch.BatchUnsupported, match="result_max"):
        cc.map_batch([1, 2], np.full(2 * cap, 0x10000), result_max=cap + 1)
    cfg = crush_batch._RuleCfg(**{**vars(cc.rule_cfg(0, cap)),
                                  "result_max": cap + 1})
    xs = torch.arange(4, device=dev)
    with pytest.raises(ValueError, match="result_max"):
        crush_batch.crush_do_rule_cuda(
            cc, cfg, xs, torch.full((2 * cap,), 0x10000, device=dev))


def test_mapping_on_card_matches_cpu(dev):
    m = OSDMap()
    m.build_simple(120, PGPool(pg_num=2048, pgp_num=2048), osds_per_host=6)
    m.osd_weight[4] = 0
    m.osd_weight[9] = 0x9000
    card = osd_mapping.OSDMapMapping()
    cpu = osd_mapping.OSDMapMapping(device="cpu")
    card.update(m)
    cpu.update(m)
    for name in ("up", "up_len", "up_primary", "acting", "acting_len",
                 "acting_primary"):
        assert np.array_equal(getattr(card.pools[0], name),
                              getattr(cpu.pools[0], name)), name


# -- the plugin family on the card: compiled repair, bit-matrix form --------

@pytest.mark.parametrize("plugin,profile", [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("clay", {"k": "4", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "6", "m": "3", "d": "8"}),
])
def test_compiled_repair_on_card(dev, plugin, profile):
    """Every single-erasure signature (and every double one that has a
    plan) rebuilt through K1 on the card, one launch per repair, equal
    to the lost shard and to the numpy oracle."""
    ec = registry.factory(plugin, dict(profile))
    assert ec.device.type == "cuda"
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    cs = ec.get_chunk_size(k * 4096)
    sinfo = ecutil.StripeInfo(k, k * cs)
    data = np.random.default_rng(n).integers(
        0, 256, 5 * sinfo.stripe_width, dtype=np.uint8).tobytes()
    shards = ecutil.encode(sinfo, ec, data)
    repaired = 0
    for r in (1, 2):
        for lost in itertools.combinations(range(n), r):
            plan = ecutil.repair_plan(ec, set(lost), set(range(n)) - set(lost))
            if plan is None:
                assert r == 2
                continue
            ext = plan.byte_extents(cs)
            bufs = {h: b"".join(shards[h][o:o + c] for o, c in
                                ecutil.expand_stream_extents(
                                    ext[h], cs, len(shards[h])))
                    for h in plan.helper_ids()}
            before = bm.LAUNCHES["gf_matmul"]
            got = ecutil.compiled_repair_streams(ec, plan, cs, bufs)
            assert bm.LAUNCHES["gf_matmul"] == before + 1
            oracle = ecutil.compiled_repair_streams(ec, plan, cs, bufs,
                                                    backend="numpy")
            for s in lost:
                assert got[s] == shards[s] == oracle[s], (lost, s)
            repaired += 1
    stats = cache_of(ec).stats()
    assert len(stats["compiles"]) == repaired
    assert all(c == 1 for c in stats["compiles"].values())


# -- the EC placement group's data plane on the card ------------------------

def ec_pg_run(plugin, profile, device):
    """One EC PG over MemStores, wired directly: writes, an unaligned
    overwrite, a degraded read, and shard 1 recovered; returns what was
    read and every store's chunk bytes and xattrs."""
    from ceph_tpu_torch.msg.messages import ECSubRead, ECSubWrite
    from ceph_tpu_torch.osd.ec_backend import ECBackend, ECPGShard
    from ceph_tpu_torch.osd.pg_types import EVersion
    from ceph_tpu_torch.store import MemStore

    ec = registry.factory(plugin, dict(profile), device=device)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    stores = [MemStore() for _ in range(n)]
    shards = [ECPGShard("1.0", s, stores[s], k, n - k) for s in range(n)]
    alive = [True] * n

    def send(s, msg):
        if not alive[s]:
            return False
        if isinstance(msg, ECSubWrite):
            reply = shards[s].handle_sub_write(msg)
            if not be.handle_recovery_write_reply(reply):
                be.handle_sub_write_reply(reply)
        elif isinstance(msg, ECSubRead):
            be.handle_sub_read_reply(shards[s].handle_sub_read(msg))
        return True

    be = ECBackend("1.0", ec, 0, list(range(n)), shards[0], send)
    w = be.sinfo.stripe_width
    rng = np.random.default_rng(n)
    objs = {f"o{i}": rng.integers(0, 256, 6 * w + 99 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(3)}
    done = []
    for oid, data in objs.items():
        be.submit_transaction(oid, [("write", 0, data)], done.append)
    patch = rng.integers(0, 256, w + 7, dtype=np.uint8).tobytes()
    be.submit_transaction("o1", [("write", 333, patch)], done.append)
    objs["o1"] = objs["o1"][:333] + patch + objs["o1"][333 + len(patch):]
    assert done == [True] * 4
    alive[1] = alive[n - 1] = False
    for oid in objs:
        be.peer_missing[1].add(oid, EVersion(1, 1))
        be.peer_missing[n - 1].add(oid, EVersion(1, 1))
    reads = {}
    for oid in objs:
        be.objects_read_and_reconstruct(
            {oid: (0, 0)}, lambda r, e, oid=oid: reads.update({oid: (r, e)}))
    alive[1] = alive[n - 1] = True
    be.peer_missing[n - 1] = type(be.peer_missing[1])()
    stores[1] = MemStore()
    shards[1] = ECPGShard("1.0", 1, stores[1], k, n - k)
    for oid in objs:
        be.recover_object(oid, [1], done.append)
    assert done == [True] * 7
    for oid, data in objs.items():
        assert reads[oid] == ({oid: data}, {})
    return reads, [{(o.name, o.shard): (st.read("pg_1.0", o),
                                        st.getattrs("pg_1.0", o))
                    for o in st.collection_list("pg_1.0")} for st in stores]


@pytest.mark.parametrize("plugin,profile", [
    ("tpu", {"k": "8", "m": "4", "technique": "reed_sol_van"}),
    ("clay", {"k": "4", "m": "2"}),
])
def test_ec_backend_on_card_matches_cpu(dev, plugin, profile):
    """ECBackend writes, an overwrite, a degraded read and a compiled
    repair with the plugin on the card equal the same run on the CPU
    (K1's plain version), store for store, and K1 ran on the card."""
    before = bm.LAUNCHES["gf_matmul"]
    card = ec_pg_run(plugin, profile, None)
    launched = bm.LAUNCHES["gf_matmul"] - before
    cpu = ec_pg_run(plugin, profile, "cpu")
    assert bm.LAUNCHES["gf_matmul"] - before == launched > 0
    assert card == cpu


def test_gf2_matmul_device_on_card(dev):
    rng = np.random.default_rng(4)
    for g in (bitmatrix.liber8tion_bitmatrix(8),
              bitmatrix.liberation_bitmatrix(7, 7),
              bitmatrix.blaum_roth_bitmatrix(6, 6)):
        rows = g.shape[1]
        coding = g[rows:]
        packets = rng.integers(0, 256, (rows, 65536 + 3), dtype=np.uint8)
        before = bm.LAUNCHES["gf_matmul"]
        got = bitmatrix.gf2_matmul_device(coding, packets)
        assert bm.LAUNCHES["gf_matmul"] == before + 1
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(),
                              bitmatrix.bitmatrix_apply(coding, packets))


# -- the placement tools and the device guard on the card -------------------

def test_crush_tester_on_card_matches_cpu(dev):
    from ceph_tpu_torch.crush import tester as ctest
    from ceph_tpu_torch.crush.wrapper import CrushWrapper
    w = CrushWrapper.build_flat(120, osds_per_host=6)
    w.add_simple_rule("rep", "default", "host")
    w.add_simple_rule("ec", "default", "host", mode="indep",
                      rule_type="erasure", max_size=12)
    ctest.reset_fallbacks()
    for rule, nr in ((0, 3), (1, 10)):
        flags = {"show_statistics": True, "show_utilization": True,
                 "show_bad_mappings": True}
        card = ctest.CrushTester(w, 0, 4095, nr, nr, rule).test(**flags)
        cpu = ctest.CrushTester(w, 0, 4095, nr, nr, rule,
                                device="cpu").test(**flags)
        assert card == cpu
    assert ctest.FALLBACKS["batch_unsupported"] == 0


def test_balancer_on_card_matches_cpu(dev):
    import random
    from ceph_tpu_torch.osd.balancer import Balancer, calc_pg_upmaps
    from ceph_tpu_torch.osd.osdmap import Incremental
    m = OSDMap()
    m.build_simple(1000, PGPool(pg_num=4096, pgp_num=4096), osds_per_host=20)
    incs = []
    for device in (None, "cpu"):
        inc = Incremental(epoch=m.epoch + 1)
        n = calc_pg_upmaps(m, 0.05, 10, set(), inc, rng=random.Random(1),
                           device=device)
        incs.append((n, inc.new_pg_upmap_items, inc.old_pg_upmap_items))
    assert incs[0] == incs[1] and incs[0][0] > 0
    assert Balancer().optimize(m) == Balancer(device="cpu").optimize(m)


def test_devguard_item_inside_a_region_raises(dev):
    from ceph_tpu_torch.common import devguard
    was = devguard.enabled()
    devguard.enable()
    try:
        t = torch.ones(4, device=dev)
        with pytest.raises(RuntimeError, match="synchronizing"):
            with devguard.guard_transfers(dev):
                t.sum().item()
        assert torch.cuda.get_sync_debug_mode() == 0
        # an operator built inside the region stages without a sync
        ec = registry.factory("tpu", {"k": "4", "m": "2"})
        data = torch.randint(0, 256, (2, 4, 4096), dtype=torch.uint8,
                             device=dev)
        parity = ec.encode_batch(data)
        # list indexing stages an index tensor: a sync, so outside
        survivors = torch.cat([data[:, [0, 2, 3]], parity[:, :1]], dim=1)
        with devguard.guard_transfers(dev):
            rec = ec.decode_batch([0, 2, 3, 4], [1], survivors)
        assert torch.equal(rec[:, 0], data[:, 1])
    finally:
        if not was:
            devguard.disable()


@pytest.mark.parametrize("shard_ways", [1, 2, 4])
def test_mesh_on_one_card(dev, shard_ways):
    """The one-card mesh (["cuda:0"] * 8): parity equals the plugin's
    single launch, a decode rebuilds the lost chunks, K1 per position."""
    from ceph_tpu_torch.dist import MeshECCoder, make_mesh
    ec = registry.factory("tpu", {"k": "8", "m": "4"})
    coder = MeshECCoder(8, 4, make_mesh(8, shard_ways=shard_ways,
                                        devices=[dev] * 8),
                        encode_matrix=ec.encode_matrix)
    rng = np.random.default_rng(shard_ways)
    data = rng.integers(0, 256, (16, 8, 4096 + 32), dtype=np.uint8)
    before = bm.LAUNCHES["gf_matmul"]
    parity = coder.encode(coder.shard_data(data))
    assert bm.LAUNCHES["gf_matmul"] == before + 8
    want = ec.encode_batch(data).cpu().numpy()
    assert np.array_equal(parity.numpy(), want)
    full = np.concatenate([data, want], axis=1)
    idx = [i for i in range(12) if i not in (1, 9)][:8]
    rec = coder.decode(idx, [1, 9], coder.shard_data(
        np.ascontiguousarray(full[:, idx]))).numpy()
    assert np.array_equal(rec, full[:, [1, 9]])


def test_mesh_over_every_card(dev):
    """The mesh over every card present, and K1 and K2 launched on a
    card that is not the current device (the launch must follow the
    tensor's device).  Needs two or more cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    from ceph_tpu_torch.dist import MeshECCoder, make_mesh
    mesh = make_mesh()
    assert mesh.devices.size == n
    coder = MeshECCoder(8, 4, mesh)
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (4 * mesh.devices.shape[0], 8, 8192),
                        dtype=np.uint8)
    parity = coder.encode(coder.shard_data(data))
    assert coder.check_parity(data, parity)
    full = np.concatenate([data, parity.numpy()], axis=1)
    idx = [i for i in range(12) if i not in (0, 11)][:8]
    rec = coder.decode(idx, [0, 11], coder.shard_data(
        np.ascontiguousarray(full[:, idx]))).numpy()
    assert np.array_equal(rec, full[:, [0, 11]])
    other = torch.device("cuda", n - 1)
    with torch.cuda.device(0):
        k1_against_plain(other, 4, 8, 3, 4096)
        ec = registry.factory("tpu", {"k": "8", "m": "4"}, device=other)
        x = torch.from_numpy(data[:4]).to(other)
        arrival = torch.cat([x, ec.encode_batch(x)], dim=1)
        rebuilt = ec.decode_batch_full([1, 9], arrival)
        torch.cuda.synchronize(other)
        assert torch.equal(rebuilt, arrival[:, [1, 9]])
