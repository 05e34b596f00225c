"""The port's scrub scheduler held to the reference's, tick for tick.

tests/test_scrub_sched.py's four cases as written there, on its
replicated pool (pg_num 4 over 4 OSDs), and again on an erasure pool:
`tpu` k=2 m=1 over 4 OSDs, pg_num 4, with the reference's shortened
intervals
(`osd_scrub_min_interval` 30 s, `osd_deep_scrub_interval` 60 s), set in
both packages' configs and restored afterwards.  Each case runs on
`ceph_tpu.testing.MiniCluster(threaded=False)` and on
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` under
the same simulated clock, and the test compares at tolerance 0:

* every primary PG's scrub stamps after each `run_idle` (the first
  stamp's jitter is `hash((pool, ps)) % 1000`, which does not depend on
  PYTHONHASHSEED, so both schedules agree tick for tick);
* each OSD's reservation peaks, which stay within `osd_max_scrubs`;
* a bitrotted replica or shard auto-repaired and verified with no
  `pg_scrub` call: its sha256 equal to its value before the rot, in
  both;
* an operator repair's result dict with `verified`.
"""
import hashlib

import pytest

import ceph_tpu.osd.ec_backend as ref_ecb
import ceph_tpu.store as ref_store
import ceph_tpu_torch.osd.ec_backend as port_ecb
import ceph_tpu_torch.store as port_store
from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.testing import MiniCluster as PortCluster

STORE = {"ref": ref_store, "port": port_store}
ECB = {"ref": ref_ecb, "port": port_ecb}
CONFIG = {"ref": ref_config, "port": port_config}
OVERRIDES = {"osd_scrub_min_interval": 30.0,
             "osd_deep_scrub_interval": 60.0}


@pytest.fixture(autouse=True)
def sim_intervals():
    """Sim-clock friendly intervals in both packages: ticks advance
    seconds, not days."""
    saved = {kind: {k: cfg()[k] for k in (*OVERRIDES, "osd_max_scrubs")}
             for kind, cfg in CONFIG.items()}
    for cfg in CONFIG.values():
        for k, v in OVERRIDES.items():
            cfg().set(k, v)
    yield
    for kind, vals in saved.items():
        for k, v in vals.items():
            CONFIG[kind]().set(k, v)


def make(kind: str, replicated: bool = False):
    c = RefCluster(n_osd=4, threaded=False) if kind == "ref" else \
        PortCluster(n_osd=4, threaded=False, device="cpu")
    c.pump()
    c.wait_all_up()
    r = c.rados()
    if replicated:
        r.pool_create("p", pg_num=4)
    else:
        r.mon_command({"prefix": "osd erasure-code-profile set",
                       "name": "k2m1",
                       "profile": {"plugin": "tpu", "k": "2", "m": "1",
                                   "crush-failure-domain": "host"}})
        r.pool_create("p", pg_num=4, pool_type="erasure",
                      erasure_code_profile="k2m1")
    c.pump()
    return c, r


def locate(c, r, oid):
    pid = r.pool_lookup("p")
    m = c.mon.osdmap
    raw = m.object_locator_to_pg(oid, pid)
    pg = m.pools[pid].raw_pg_to_pg(raw)
    _, _, acting, primary = m.pg_to_up_acting_osds(raw)
    return pid, pg, list(acting), primary


def run_idle(c, t0, ticks, step=5.0):
    for i in range(ticks):
        c.tick(t0 + i * step)
    return t0 + ticks * step


def stamps(c) -> dict:
    return {(osd, str(pg)): (st.last_scrub_stamp, st.last_deep_scrub_stamp)
            for osd, d in sorted(c.osds.items())
            for pg, st in sorted(d.pgs.items()) if st.backend is not None}


def peaks(c) -> dict:
    return {osd: (d.scrub_peak_local, d.scrub_peak_remote)
            for osd, d in sorted(c.osds.items())}


def soid(kind, c, pg, oid, idx):
    """The stored object: the shard on an EC pool, the whole replica on
    a replicated one."""
    ec = c.mon.osdmap.pools[pg.pool].type == 3      # erasure
    return STORE[kind].ObjectId(oid, shard=idx) if ec \
        else STORE[kind].ObjectId(oid)


def shard_sum(kind, c, pg, osd, idx, oid) -> str:
    data = c._stores[osd].read(ECB[kind].pg_cid(pg),
                               soid(kind, c, pg, oid, idx), 0, 0)
    return hashlib.sha256(data).hexdigest()


def run(kind: str, scenario, replicated: bool = False) -> dict:
    c, r = make(kind, replicated)
    try:
        return scenario(kind, c, r)
    finally:
        c.shutdown()


def idle_cluster_scrubs_itself(kind, c, r):
    io = r.open_ioctx("p")
    for i in range(8):
        io.write_full(f"o{i}", bytes([i]) * 512)
    c.pump()
    t = run_idle(c, 1000.0, 4)          # seed stamps (jittered)
    seeded = stamps(c)
    run_idle(c, t + 100.0, 30)
    return {"seeded": seeded, "after": stamps(c), "peaks": peaks(c)}


def respects_max_scrubs(kind, c, r):
    io = r.open_ioctx("p")
    for i in range(8):
        io.write_full(f"m{i}", bytes([i + 1]) * 256)
    c.pump()
    t = run_idle(c, 2000.0, 4)
    first = stamps(c)
    run_idle(c, t + 200.0, 30)
    return {"seeded": first, "after": stamps(c), "peaks": peaks(c),
            "limit": CONFIG[kind]()["osd_max_scrubs"]}


def bitrot_no_operator(kind, c, r):
    io = r.open_ioctx("p")
    payload = b"precious" * 512
    io.write_full("victim", payload)
    c.pump()
    _pid, pg, acting, primary = locate(c, r, "victim")
    replica = next(o for o in acting if o != primary)
    idx = acting.index(replica)
    good = shard_sum(kind, c, pg, replica, idx, "victim")
    c.osds[replica].store.queue_transaction(STORE[kind].Transaction().write(
        ECB[kind].pg_cid(pg), soid(kind, c, pg, "victim", idx), 0,
        b"BITROT!!"))
    rotted = shard_sum(kind, c, pg, replica, idx, "victim")
    t = run_idle(c, 3000.0, 4)
    seeded = stamps(c)
    run_idle(c, t + 200.0, 40)
    st = c.osds[primary].pgs[pg]
    return {"rotted": rotted != good,
            "repaired": shard_sum(kind, c, pg, replica, idx, "victim")
            == good,
            "read_equal": io.read("victim") == payload,
            "idle": st.scrub is None, "seeded": seeded,
            "after": stamps(c), "peaks": peaks(c)}


def manual_scrub_verified(kind, c, r):
    io = r.open_ioctx("p")
    io.write_full("manual", b"m" * 2048)
    c.pump()
    pid, pg, acting, primary = locate(c, r, "manual")
    replica = next(o for o in acting if o != primary)
    idx = acting.index(replica)
    good = shard_sum(kind, c, pg, replica, idx, "manual")
    c.osds[replica].store.queue_transaction(STORE[kind].Transaction().write(
        ECB[kind].pg_cid(pg), soid(kind, c, pg, "manual", idx), 0,
        b"ROT"))
    res = r.pg_scrub(pid, pg.ps, repair=True)
    c.pump()
    return {"result": res, "keys": list(res),
            "repaired": shard_sum(kind, c, pg, replica, idx, "manual")
            == good,
            "read_equal": io.read("manual") == b"m" * 2048}


SCENARIOS = {
    "idle_cluster_scrubs_itself": idle_cluster_scrubs_itself,
    "respects_max_scrubs": respects_max_scrubs,
    "bitrot_no_operator": bitrot_no_operator,
    "manual_scrub_verified": manual_scrub_verified,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_equals_reference(name):
    ref = run("ref", SCENARIOS[name])
    port = run("port", SCENARIOS[name])
    assert port == ref


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replicated_scheduler_equals_reference(name):
    """tests/test_scrub_sched.py's own pool: replicated, pg_num 4."""
    ref = run("ref", SCENARIOS[name], replicated=True)
    port = run("port", SCENARIOS[name], replicated=True)
    assert port == ref


def test_replicated_expected_outcomes():
    """tests/test_scrub_sched.py's assertions on the port's replicated
    pool."""
    out = run("port", idle_cluster_scrubs_itself, replicated=True)
    assert out["seeded"]
    for key, (last, _deep) in out["seeded"].items():
        assert out["after"][key][0] > last, f"pg {key} never auto-scrubbed"
    out = run("port", respects_max_scrubs, replicated=True)
    assert all(loc <= out["limit"] and rem <= out["limit"]
               for loc, rem in out["peaks"].values())
    assert any(rem >= 1 for _loc, rem in out["peaks"].values())
    out = run("port", bitrot_no_operator, replicated=True)
    assert out["rotted"] and out["repaired"] and out["read_equal"]
    assert out["idle"]
    out = run("port", manual_scrub_verified, replicated=True)
    assert out["result"] == {"inconsistent": ["manual"], "repaired": 1,
                             "unrepairable": [], "verified": True}
    assert out["repaired"] and out["read_equal"]


def test_idle_cluster_scrubs_itself():
    out = run("port", idle_cluster_scrubs_itself)
    assert out["seeded"] and all(s[0] is not None
                                 for s in out["seeded"].values())
    for key, (last, _deep) in out["seeded"].items():
        assert out["after"][key][0] > last, f"pg {key} never auto-scrubbed"


def test_auto_scrub_respects_max_scrubs():
    out = run("port", respects_max_scrubs)
    assert all(loc <= out["limit"] and rem <= out["limit"]
               for loc, rem in out["peaks"].values())
    assert any(rem >= 1 for _loc, rem in out["peaks"].values())


def test_bitrot_detected_repaired_verified_no_operator():
    out = run("port", bitrot_no_operator)
    assert out["rotted"] and out["repaired"] and out["read_equal"]
    assert out["idle"]


def test_manual_scrub_still_works_and_reports_verified():
    out = run("port", manual_scrub_verified)
    assert out["result"] == {"inconsistent": ["manual"], "repaired": 1,
                             "unrepairable": [], "verified": True}
    assert out["repaired"] and out["read_equal"]
