"""The port's OSDMapMapping against the JAX package's, on the CPU.

One OSDMap is built with the JAX package (build_simple: 200 OSDs, 4 per
host, 4,096 PGs; an EC k=4 m=2 pool; an OSD out, one reweighted, one
down; primary affinity, pg_upmap_items, pg_upmap, pg_temp and
primary_temp) and carried into the port with `OSDMap.from_reference`.
`OSDMapMapping(device="cpu")` (the batch engine's plain version) must
give the reference's tables byte for byte, before and after a failure
epoch applied to both maps as the same Incremental.
"""
import numpy as np
import pytest
import torch

from ceph_tpu.crush.types import (CRUSH_BUCKET_LIST, CRUSH_ITEM_NONE,
                                  CRUSH_RULE_CHOOSELEAF_INDEP,
                                  CRUSH_RULE_EMIT, CRUSH_RULE_TAKE,
                                  CrushRule, CrushRuleMask, CrushRuleStep)
from ceph_tpu.osd.mapping import OSDMapMapping as JMapping
from ceph_tpu.osd.osdmap import CEPH_OSD_UP, Incremental as JIncremental
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.osd.types import PG as JPG
from ceph_tpu.osd.types import POOL_TYPE_ERASURE, PGPool
from ceph_tpu_torch.osd import mapping as pmapping
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap
from ceph_tpu_torch.osd.types import PG

# The plain version runs thousands of small tensor ops; with one
# intra-op thread pool per test worker on a shared CPU they thrash.
torch.set_num_threads(1)

EC_POOL = 1
FIELDS = ("up", "up_len", "up_primary", "acting", "acting_len",
          "acting_primary")


def reference_map() -> JOSDMap:
    m = JOSDMap()
    m.build_simple(200, PGPool(pg_num=4096, pgp_num=4096), osds_per_host=4)
    root = next(b.id for b in m.crush.buckets if b is not None
                and b.type == 10)
    k, mm = 4, 2
    m.crush.rules.append(CrushRule(
        steps=[CrushRuleStep(CRUSH_RULE_TAKE, root),
               CrushRuleStep(CRUSH_RULE_CHOOSELEAF_INDEP, k + mm, 1),
               CrushRuleStep(CRUSH_RULE_EMIT)],
        mask=CrushRuleMask(ruleset=1, type=POOL_TYPE_ERASURE, min_size=1,
                           max_size=16)))
    m.pools[EC_POOL] = PGPool(type=POOL_TYPE_ERASURE, size=k + mm,
                              min_size=k + 1, crush_rule=1, pg_num=1024,
                              pgp_num=1024)
    m.pool_names[EC_POOL] = "ecpool"
    m.osd_weight[7] = 0                     # out
    m.osd_weight[11] = 0x8000               # partial reweight
    m.osd_state[3] &= ~CEPH_OSD_UP          # down: positional holes
    for osd, aff in ((0, 0), (5, 0x4000), (9, 0x8000), (40, 0)):
        m.set_primary_affinity(osd, aff)
    m.pg_upmap_items[JPG(0, 17)] = [(m_osd, 150) for m_osd in
                                    m.pg_to_raw_osds(JPG(0, 17))[0][:1]]
    m.pg_upmap[JPG(0, 33)] = [10, 20, 30]
    m.pg_temp[JPG(0, 5)] = [1, 2, 4, 6]         # wider than size
    m.pg_temp[JPG(EC_POOL, 9)] = [12, 13]       # partial on an EC pool
    m.primary_temp[JPG(0, 6)] = 25
    return m


def failure_epoch(inc):
    inc.new_weight.update({21: 0, 22: 0, 23: 0x8000, 60: 0x4000})
    inc.new_down_osds.extend([30, 31])
    inc.new_primary_affinity[41] = 0x2000
    return inc


@pytest.fixture(scope="module")
def maps():
    """{epoch: (reference mapping, port mapping, port map)} for the map
    as built and after the failure epoch."""
    jm = reference_map()
    pm = OSDMap.from_reference(jm)
    out = {}
    for epoch in (1, 2):
        if epoch == 2:
            jm.apply_incremental(failure_epoch(JIncremental(epoch=2)))
            pm = pm.clone()
            pm.apply_incremental(failure_epoch(Incremental(epoch=2)))
        ref = JMapping()
        ref.update(jm)
        port = pmapping.OSDMapMapping(device="cpu")
        port.update(pm)
        out[epoch] = (ref, port, pm)
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("pool", [0, EC_POOL])
@pytest.mark.parametrize("epoch", [1, 2])
def test_tables_match_reference(maps, epoch, pool, field):
    ref, port, _ = maps[epoch]
    want = getattr(ref.pools[pool], field)
    got = getattr(port.pools[pool], field)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("epoch", [1, 2])
def test_get_matches_reference(maps, epoch):
    ref, port, pm = maps[epoch]
    for pool_id, pool in pm.pools.items():
        for ps in range(pool.pg_num):
            assert port.get(PG(pool_id, ps)) == ref.get(JPG(pool_id, ps)), \
                (pool_id, ps)
    assert port.get(PG(0, 1 << 20)) == ([], -1, [], -1)
    assert port.get(PG(9, 0)) == ([], -1, [], -1)


@pytest.mark.parametrize("epoch", [1, 2])
def test_reverse_map_and_counts_match_reference(maps, epoch):
    ref, port, pm = maps[epoch]
    for osd in (0, 1, 3, 7, 11, 12, 25, 150, 199):
        assert [(pg.pool, pg.ps) for pg in port.get_osd_acting_pgs(osd)] == \
            [(pg.pool, pg.ps) for pg in ref.get_osd_acting_pgs(osd)], osd
    for acting in (True, False):
        assert np.array_equal(port.osd_pg_counts(pm.max_osd, acting),
                              ref.osd_pg_counts(pm.max_osd, acting))


@pytest.mark.parametrize("epoch", [1, 2])
def test_rows_match_the_port_scalar_pipeline(maps, epoch):
    _, port, pm = maps[epoch]
    rng = np.random.default_rng(epoch)
    for pool_id, pool in pm.pools.items():
        for ps in list(rng.choice(pool.pg_num, 48, replace=False)) + \
                [5, 6, 9, 17, 33]:
            pg = PG(pool_id, int(ps))
            assert port.get(pg) == pm.pg_to_up_acting_osds(pg), pg


def test_the_ec_pool_keeps_positional_holes(maps):
    _, port, pm = maps[1]
    up = port.pools[EC_POOL].up
    assert up.shape == (1024, 6)
    holes = up == CRUSH_ITEM_NONE
    assert holes.any()                        # OSD 3 is down
    assert (port.pools[EC_POOL].up_len == 6).all()
    assert not (port.pools[0].up[:, :3] == CRUSH_ITEM_NONE).all(axis=1).any()


def test_from_reference_copies_every_field():
    jm = reference_map()
    pm = OSDMap.from_reference(jm)
    for name in ("epoch", "fsid", "max_osd", "osd_state", "osd_weight",
                 "osd_primary_affinity", "pool_names", "pool_max", "flags",
                 "erasure_code_profiles"):
        assert getattr(pm, name) == getattr(jm, name), name
    for pid, pool in jm.pools.items():
        assert vars(pm.pools[pid]) == vars(pool)
    for name in ("pg_upmap", "pg_upmap_items", "pg_temp", "primary_temp"):
        assert {(pg.pool, pg.ps): v for pg, v in getattr(pm, name).items()} \
            == {(pg.pool, pg.ps): v for pg, v in getattr(jm, name).items()}
    for a, b in zip(pm.crush.buckets, jm.crush.buckets):
        assert vars(a) == vars(b)
    assert len(pm.crush.rules) == len(jm.crush.rules)
    for a, b in zip(pm.crush.rules, jm.crush.rules):
        assert [vars(s) for s in a.steps] == [vars(s) for s in b.steps]
        assert vars(a.mask) == vars(b.mask)
    for name in ("max_devices", "choose_total_tries", "chooseleaf_stable",
                 "chooseleaf_vary_r", "chooseleaf_descend_once",
                 "choose_local_tries", "straw_calc_version"):
        assert getattr(pm.crush, name) == getattr(jm.crush, name), name


def test_batch_unsupported_pool_goes_through_the_scalar_engine():
    jm = JOSDMap()
    jm.build_simple(24, PGPool(pg_num=64, pgp_num=64), osds_per_host=4)
    jm.crush.buckets[0].alg = CRUSH_BUCKET_LIST   # a legacy host bucket
    pm = OSDMap.from_reference(jm)
    pmapping.reset_fallbacks()
    port = pmapping.OSDMapMapping(device="cpu")
    port.update(pm)
    assert pmapping.FALLBACKS["batch_unsupported"] == 1
    ref = JMapping()
    ref.update(jm)
    for field in FIELDS:
        assert np.array_equal(getattr(port.pools[0], field),
                              getattr(ref.pools[0], field)), field


def test_mapping_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pmapping.OSDMapMapping().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmapping.OSDMapMapping()
