"""The port's upmap balancer against the JAX package's, on the CPU.

The cases of tests/test_balancer.py, each run through both packages: the
remap tree walks on the same maps, and calc_pg_upmaps / Balancer.optimize
from the same OSDMap (carried across with `OSDMap.from_reference`) and
the same seed give equal `new_pg_upmap_items` / `old_pg_upmap_items`;
score() gives equal numbers; both osdmaptools write the same --upmap
command file.  The port maps on `device="cpu"` (K3's plain version).

The reference balancer builds its PG tables here through its own scalar
pipeline (`pg_to_up_acting_osds`, in a stand-in for its OSDMapMapping)
so that each map shape does not cost a JAX compile; its OSDMapMapping is
held to the port's in tests/test_torch_mapping.py, and
`test_osdmaptool_upmap_cli` runs the reference tool unpatched.
Everything is compared exactly.
"""
import logging
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ceph_tpu.crush import remap as ref_remap
from ceph_tpu.crush.types import CRUSH_ITEM_NONE
from ceph_tpu.osd import balancer as ref_balancer
from ceph_tpu.osd.osdmap import Incremental as RefIncremental
from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
from ceph_tpu.osd.types import PG as RefPG
from ceph_tpu.osd.types import PGPool as RefPGPool
from ceph_tpu.tools import osdmaptool as ref_osdmaptool
from ceph_tpu_torch.common import log
from ceph_tpu_torch.crush import remap
from ceph_tpu_torch.crush.types import (CRUSH_BUCKET_STRAW2, CrushBucket,
                                        CrushMap)
from ceph_tpu_torch.osd import balancer
from ceph_tpu_torch.osd.balancer import Balancer, calc_pg_upmaps
from ceph_tpu_torch.osd.mapping import OSDMapMapping
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.osd.types import PG
from ceph_tpu_torch.tools import osdmaptool

# The plain version runs thousands of small tensor ops; with one
# intra-op thread pool per test worker on a shared CPU they thrash.
torch.set_num_threads(1)


class ScalarTables:
    """The reference balancer's view of OSDMapMapping (`epoch`, `pools`,
    `update`) filled from the reference's scalar pg_to_up_acting_osds."""

    def __init__(self, device=None):
        self.epoch = -1
        self.pools = {}

    def update(self, m, pool_ids=None):
        for pid in sorted(m.pools if pool_ids is None else pool_ids):
            pool = m.pools[pid]
            up = np.full((pool.pg_num, pool.size), CRUSH_ITEM_NONE,
                         dtype=np.int64)
            for ps in range(pool.pg_num):
                row = m.pg_to_up_acting_osds(RefPG(pid, ps))[0]
                up[ps, :len(row)] = row
            self.pools[pid] = SimpleNamespace(up=up)
        self.epoch = m.epoch


@pytest.fixture
def ref_scalar(monkeypatch):
    monkeypatch.setattr(ref_balancer, "OSDMapMapping", ScalarTables)


def build_maps(n_osd=16, osds_per_host=4, pg_num=256, size=3):
    """The same map in both packages."""
    ref = RefOSDMap()
    ref.build_simple(n_osd, RefPGPool(pg_num=pg_num, pgp_num=pg_num,
                                      size=size),
                     osds_per_host=osds_per_host)
    return ref, OSDMap.from_reference(ref)


def add_pool(ref, pool_id, pg_num, size):
    ref.pools[pool_id] = RefPGPool(pg_num=pg_num, pgp_num=pg_num, size=size)
    ref.pool_names[pool_id] = f"pool{pool_id}"
    return OSDMap.from_reference(ref)


def key(inc):
    """(new, old) pg_upmap_items of an Incremental of either package."""
    return ({(pg.pool, pg.ps): [tuple(p) for p in v]
             for pg, v in inc.new_pg_upmap_items.items()},
            sorted((pg.pool, pg.ps) for pg in inc.old_pg_upmap_items))


def both_calc(ref, port, ratio, iters, pools=frozenset(), seed=None,
              **kwargs):
    """calc_pg_upmaps in both packages; asserts equal results and returns
    the port's (count, Incremental)."""
    r_inc = RefIncremental(epoch=ref.epoch + 1)
    p_inc = Incremental(epoch=port.epoch + 1)
    rng = (lambda: random.Random(seed)) if seed is not None else \
        (lambda: None)
    rn = ref_balancer.calc_pg_upmaps(ref, ratio, iters, set(pools), r_inc,
                                     rng=rng(), **kwargs)
    pn = calc_pg_upmaps(port, ratio, iters, set(pools), p_inc, rng=rng(),
                        device="cpu", **kwargs)
    assert pn == rn
    assert key(p_inc) == key(r_inc)
    return pn, p_inc


def host_of(cmap, parent, osd):
    return remap.get_parent_of_type(cmap, osd, 1, parent)


def max_deviation(m):
    mapping = OSDMapMapping(device="cpu")
    mapping.update(m)
    counts = mapping.osd_pg_counts(m.max_osd, acting=False)
    target = counts.sum() / m.max_osd
    return np.abs(counts - target).max(), counts


def apply_pending(m, inc):
    inc.epoch = m.epoch + 1
    m2 = m.clone()
    m2.apply_incremental(inc)
    return m2


# ------------------------------------------------------------- tree walk
def test_parent_and_subtree():
    ref, m = build_maps()
    parent = remap.build_parent_map(m.crush)
    assert dict(parent) == dict(ref_remap.build_parent_map(ref.crush))
    h0 = host_of(m.crush, parent, 0)
    assert h0 < 0 and h0 == host_of(m.crush, parent, 3)
    assert h0 != host_of(m.crush, parent, 4)
    root = remap.get_parent_of_type(m.crush, 0, 10, parent)
    assert root < 0 and root == ref_remap.get_parent_of_type(ref.crush, 0, 10)
    assert remap.subtree_contains(m.crush, root, 7)
    assert remap.subtree_contains(m.crush, h0, 2)
    assert not remap.subtree_contains(m.crush, h0, 4)


def test_rule_weight_osd_map_normalized():
    ref, m = build_maps(n_osd=8)
    w = remap.get_rule_weight_osd_map(m.crush, 0)
    assert w == ref_remap.get_rule_weight_osd_map(ref.crush, 0)
    assert set(w) == set(range(8))
    assert abs(sum(w.values()) - 1.0) < 1e-6


# --------------------------------------------------------- try_remap_rule
def test_try_remap_swaps_overfull_for_underfull_other_host():
    ref, m = build_maps()
    orig = m.pg_to_raw_upmap(PG(0, 0))
    assert orig == ref.pg_to_raw_upmap(RefPG(0, 0)) and len(orig) == 3
    parent = remap.build_parent_map(m.crush)
    hosts = {host_of(m.crush, parent, o) for o in orig}
    victim = orig[1]
    cand = next(o for o in range(16)
                if host_of(m.crush, parent, o) not in hosts)
    out = remap.try_remap_rule(m.crush, 0, 3, {victim}, [cand], orig)
    assert out == ref_remap.try_remap_rule(ref.crush, 0, 3, {victim}, [cand],
                                           orig)
    assert victim not in out and cand in out
    assert len({host_of(m.crush, parent, o) for o in out}) == 3


def test_try_remap_keeps_placement_when_candidate_collides():
    ref, m = build_maps()
    orig = m.pg_to_raw_upmap(PG(0, 0))
    parent = remap.build_parent_map(m.crush)
    victim, other = orig[0], orig[1]
    sib = next(o for o in range(16)
               if o not in orig and
               host_of(m.crush, parent, o) == host_of(m.crush, parent, other))
    out = remap.try_remap_rule(m.crush, 0, 3, {victim}, [sib], orig)
    assert out == orig == ref_remap.try_remap_rule(ref.crush, 0, 3, {victim},
                                                   [sib], orig)


def test_try_remap_no_overfull_is_identity():
    ref, m = build_maps()
    orig = m.pg_to_raw_upmap(PG(0, 0))
    assert remap.try_remap_rule(m.crush, 0, 3, set(), [5], orig) == orig


# --------------------------------------------------------- calc_pg_upmaps
@pytest.mark.parametrize("seed", [None, 0, 7])
def test_calc_pg_upmaps_balances_and_respects_failure_domains(ref_scalar,
                                                              seed):
    ref, m = build_maps(n_osd=16, pg_num=256, size=3)
    before_dev, before_counts = max_deviation(m)
    n, inc = both_calc(ref, m, 0.001, 100, seed=seed)
    assert n > 0 and len(inc.new_pg_upmap_items) > 0
    m2 = apply_pending(m, inc)
    after_dev, after_counts = max_deviation(m2)
    assert after_counts.sum() == before_counts.sum()
    assert after_dev < before_dev and after_dev <= 2.0
    parent = remap.build_parent_map(m2.crush)
    mapping = OSDMapMapping(device="cpu")
    mapping.update(m2)
    for row in mapping.pools[0].up:
        osds = [int(o) for o in row if o != CRUSH_ITEM_NONE]
        assert len(osds) == 3
        assert len({host_of(m2.crush, parent, o) for o in osds}) == 3


def test_calc_pg_upmaps_already_balanced_is_noop(ref_scalar):
    ref, m = build_maps(n_osd=16, pg_num=256, size=3)
    n, inc = both_calc(ref, m, 0.001, 100)
    r_inc = RefIncremental(epoch=ref.epoch + 1)
    r_inc.new_pg_upmap_items = {RefPG(pg.pool, pg.ps): list(v)
                                for pg, v in inc.new_pg_upmap_items.items()}
    ref.apply_incremental(r_inc)
    m2 = apply_pending(m, inc)
    n2, _ = both_calc(ref, m2, 0.001, 100)
    assert n2 <= max(2, n // 10)


def test_calc_pg_upmaps_only_pools_filter(ref_scalar):
    ref, _ = build_maps(n_osd=16, pg_num=128, size=3)
    m = add_pool(ref, 1, 128, 3)
    _, inc = both_calc(ref, m, 0.001, 50, pools={1})
    assert all(pg.pool == 1 for pg in inc.new_pg_upmap_items)
    assert all(pg.pool == 1 for pg in inc.old_pg_upmap_items)


def pile_onto(ref, target, count, sibling_check):
    """Upmap `count` PGs of pool 0 onto OSD `target` in the reference map
    (pairs chosen like tests/test_balancer.py); returns the port map."""
    parent = ref_remap.build_parent_map(ref.crush)
    h = ref_remap.get_parent_of_type(ref.crush, target, 1, parent)
    made = 0
    for ps in range(ref.pools[0].pg_num):
        row = ref.pg_to_up_acting_osds(RefPG(0, ps))[0]
        hosts = [ref_remap.get_parent_of_type(ref.crush, x, 1, parent)
                 for x in row]
        if target in row or (sibling_check and h in hosts):
            continue
        ref.pg_upmap_items[RefPG(0, ps)] = [(row[0], target)]
        made += 1
        if made >= count:
            break
    assert made == count
    return OSDMap.from_reference(ref)


def test_calc_pg_upmaps_retracts_stale_items(ref_scalar):
    ref, _ = build_maps(n_osd=16, pg_num=256, size=3)
    m = pile_onto(ref, 0, 30, True)
    _, counts0 = max_deviation(m)
    assert counts0[0] > counts0.mean() + 10
    n, inc = both_calc(ref, m, 0.001, 200)
    assert n > 0 and len(inc.old_pg_upmap_items) > 0
    _, counts2 = max_deviation(apply_pending(m, inc))
    assert counts2[0] <= counts0[0] - 10


def test_calc_pg_upmaps_inc_collections_disjoint(ref_scalar):
    ref, _ = build_maps(n_osd=16, pg_num=256, size=3)
    m = pile_onto(ref, 0, 40, True)
    _, inc = both_calc(ref, m, 0.001, 300)
    assert not set(inc.new_pg_upmap_items) & set(inc.old_pg_upmap_items)
    m2 = apply_pending(m, inc)
    for pg in inc.new_pg_upmap_items:
        assert m2.pg_upmap_items.get(pg) == inc.new_pg_upmap_items[pg]


def test_calc_pg_upmaps_survives_weightless_upmap_target(ref_scalar):
    ref, _ = build_maps(n_osd=16, pg_num=256, size=3)
    pile_onto(ref, 15, 20, True)
    ref.osd_weight[15] = 0
    m = OSDMap.from_reference(ref)
    n, inc = both_calc(ref, m, 0.001, 24)
    assert n > 0
    _, counts = max_deviation(apply_pending(m, inc))
    assert counts[15] == 0 or counts[15] < 20


@pytest.mark.parametrize("aggressive", [True, False])
def test_calc_pg_upmaps_with_given_mapping(ref_scalar, aggressive):
    """A current mapping is used as given (no update); aggressive off
    stops at the first change that does not lower the deviation."""
    ref, m = build_maps(n_osd=24, osds_per_host=3, pg_num=128, size=3)
    mapping = OSDMapMapping(device="cpu")
    mapping.update(m)
    both_calc(ref, m, 0.01, 40, seed=3, aggressive=aggressive)
    p_inc = Incremental(epoch=m.epoch + 1)
    r_inc = RefIncremental(epoch=ref.epoch + 1)
    pn = calc_pg_upmaps(m, 0.01, 40, set(), p_inc, aggressive=aggressive,
                        rng=random.Random(3), mapping=mapping)
    rn = ref_balancer.calc_pg_upmaps(ref, 0.01, 40, set(), r_inc,
                                     aggressive=aggressive,
                                     rng=random.Random(3))
    assert pn == rn and key(p_inc) == key(r_inc)


def test_calc_pg_upmaps_timings_are_laps_of_the_same_call(ref_scalar):
    """timings receives back-to-back (t0, t1) intervals of one call:
    clone, then _build_pgs_by_osd, then the search; the Incremental is
    the one made without timings."""
    ref, m = build_maps(n_osd=16, osds_per_host=4, pg_num=128, size=3)
    _, want = both_calc(ref, m, 0.01, 20, seed=1)
    inc = Incremental(epoch=m.epoch + 1)
    timings = {}
    calc_pg_upmaps(m, 0.01, 20, set(), inc, rng=random.Random(1),
                   device="cpu", timings=timings)
    assert key(inc) == key(want)
    assert list(timings) == ["clone", "build_pgs_by_osd", "search"]
    (c0, c1), (b0, b1), (s0, s1) = timings.values()
    assert c0 <= c1 <= b0 <= b1 == s0 <= s1


def test_dout_drops_lines_above_the_gather_level(ref_scalar, caplog):
    """The balancer's dout lines (level 10) never reach logging; a line
    at the gather level goes to the subsystem's logger."""
    with caplog.at_level(logging.DEBUG, logger="ceph_tpu_torch"):
        _, m = build_maps(n_osd=16, osds_per_host=4, pg_num=128, size=3)
        calc_pg_upmaps(m, 0.01, 20, set(), Incremental(epoch=m.epoch + 1),
                       device="cpu")
        assert caplog.records == []
        log.dout("osd", log.GATHER_LEVEL).write("changed %d", 3)
    assert [(r.name, r.getMessage()) for r in caplog.records] == \
        [("ceph_tpu_torch.osd", "changed 3")]


def test_balancer_driver_multi_pool(ref_scalar):
    ref, _ = build_maps(n_osd=16, pg_num=128, size=3)
    m = add_pool(ref, 1, 64, 2)
    b = Balancer(max_deviation=1, max_iterations=500, device="cpu")
    rb = ref_balancer.Balancer(max_deviation=1, max_iterations=500)
    before = b.score(m)
    assert before == rb.score(ref)
    inc = b.optimize(m)
    assert key(inc) == key(rb.optimize(ref))
    after = b.score(apply_pending(m, inc))
    assert after["stddev"] < before["stddev"]
    assert after["max_deviation"] <= before["max_deviation"]


def test_balancer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Balancer()
    _, m = build_maps(n_osd=8, osds_per_host=2, pg_num=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calc_pg_upmaps(m, 0.001, 10, set(), Incremental(epoch=m.epoch + 1))


def test_osdmaptool_upmap_cli(tmp_path, capsys):
    """Both tools, the reference's on its own OSDMapMapping: the same
    command files, and the map rewritten only under --upmap-save."""
    files = {}
    for name, tool, dev in (("ref", ref_osdmaptool, []),
                            ("port", osdmaptool, ["--device", "cpu"])):
        mapfile = str(tmp_path / f"{name}.json")
        outfile = str(tmp_path / f"{name}.txt")
        assert tool.main(["--createsimple", "16", mapfile, "--pg-num",
                          "256"]) == 0
        argv = [mapfile, "--upmap", outfile, "--upmap-max", "100",
                "--upmap-deviation", "1", *dev]
        assert tool.main(argv) == 0
        files[name] = open(outfile).read()
        assert len(tool.load_map(mapfile).pg_upmap_items) == 0
        assert tool.main(argv + ["--upmap-save"]) == 0
        assert len(tool.load_map(mapfile).pg_upmap_items) > 0
    capsys.readouterr()
    assert files["port"] == files["ref"]
    cmds = files["port"].strip().splitlines()
    assert cmds and all(c.startswith(("ceph osd pg-upmap-items ",
                                      "ceph osd rm-pg-upmap-items "))
                        for c in cmds)
    dev, _ = max_deviation(osdmaptool.load_map(str(tmp_path / "port.json")))
    assert dev <= 2.0


def test_balancer_score_shape(ref_scalar):
    ref, m = build_maps(n_osd=8, osds_per_host=2, pg_num=64)
    s = Balancer(device="cpu").score(m)
    assert s == ref_balancer.Balancer().score(ref)
    assert set(s) == {"stddev", "max_deviation", "osds"}
    assert len(s["osds"]) == 8
    assert sum(v["pgs"] for v in s["osds"].values()) == 64 * 3


def test_contains_up_matches_subtree_contains_shared_subtree():
    m = CrushMap()
    host = m.add_bucket(CrushBucket(
        id=0, type=1, alg=CRUSH_BUCKET_STRAW2, items=[0, 1],
        item_weights=[0x10000, 0x10000], weight=0x20000))
    roots = [m.add_bucket(CrushBucket(
        id=0, type=2, alg=CRUSH_BUCKET_STRAW2, items=[host],
        item_weights=[0x20000], weight=0x20000)) for _ in range(2)]
    m.max_devices = 2
    parent = remap.build_parent_map(m)
    assert host in parent.multi
    for root in roots:
        for item in (host, 0, 1):
            assert remap._contains_up(m, parent, root, item) == \
                remap.subtree_contains(m, root, item), (root, item)
    assert not remap._contains_up(m, parent, roots[0], 99)


def test_build_pgs_by_osd_equals_reference(ref_scalar):
    ref, _ = build_maps(n_osd=12, osds_per_host=3, pg_num=64)
    m = add_pool(ref, 1, 32, 2)
    got, total = balancer._build_pgs_by_osd(m, [0, 1], device="cpu")
    want, rtotal = ref_balancer._build_pgs_by_osd(ref, [0, 1])
    assert total == rtotal
    assert list(got) == list(want)
    assert {o: {(pg.pool, pg.ps) for pg in s} for o, s in got.items()} == \
        {o: {(pg.pool, pg.ps) for pg in s} for o, s in want.items()}
