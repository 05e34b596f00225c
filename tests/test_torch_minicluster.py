"""The port's MiniCluster held to the reference's, step by step.

The same scenario runs twice in one process: once on
`ceph_tpu.testing.MiniCluster(threaded=False)`, once on
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` (the
port's mon, OSD daemons, EC peering and librados client over its
LocalNetwork; K1's plain version).  Both get the same profile, pool,
seeded payloads and simulated clock (`tick(now)`).  The scenario writes
every object through librados, kills the OSD that sits in the most
acting sets, marks it down, reads every object degraded, marks it out,
waits until every PG is clean and reads again.  After each step the
test compares, at tolerance 0:

* what the client read;
* the mon's map epoch and every PG's up and acting set and pg_temp;
* every primary's acting set and peering phase;
* every OSD store (the killed one's too): each object's data, xattrs
  and omap, which holds the PG log;
* every live OSD's op, sub-op, map and recovery counters (recovery
  bytes read over rebuilt is k, and the port takes no full rebuild);
* the message trace under `pump`: (source, destination, type) of every
  message routed, in order, the `config` subscriptions with their
  MConfig replies and the cluster-log traffic (MLog, MLogAck) included.

Two shapes: k=2 m=2 over 7 OSDs (the reference's tests/test_ec_peering.py
shape, 16 objects of 2-3 KB) and `tpu` k=8 m=4 over 16 OSDs with
pg_num=8 (16 objects of up to 64 KiB: object sizes cut to keep the file
well inside a minute on a CPU).  One threaded case on the port alone
checks the reads and that the cluster goes clean.
"""
import numpy as np
import pytest

from ceph_tpu.osd.types import PG as RefPG
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.osd.peering import CLEAN
from ceph_tpu_torch.osd.types import PG as PortPG
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NONE = 0x7FFFFFFF
PG = {"ref": RefPG, "port": PortPG}
COUNTERS = ("op", "op_r", "op_w", "op_w_bytes", "op_r_bytes", "subop_w",
            "map_epochs", "recovery_pull", "recovery_bytes_read",
            "recovery_bytes_rebuilt")

SHAPES = {
    "k2m2_7osd": dict(
        n_osd=7, pg_num=8, objects=16,
        profile={"plugin": "tpu", "k": "2", "m": "2",
                 "crush-failure-domain": "host"},
        size=lambda i: 2000 + 37 * i),
    "tpu_k8m4_16osd": dict(
        n_osd=16, pg_num=8, objects=16,
        profile={"plugin": "tpu", "k": "8", "m": "4",
                 "technique": "reed_sol_van",
                 "crush-failure-domain": "host"},
        size=lambda i: 65536 - 4099 * i),
}


def _norm(name: str) -> str:
    # client ids come from a process-wide counter in each package
    return "client" if name.startswith("client.") else name


def make(kind: str, shape: dict, threaded: bool = False):
    if kind == "ref":
        c = RefCluster(n_osd=shape["n_osd"], threaded=threaded)
    else:
        c = PortCluster(n_osd=shape["n_osd"], threaded=threaded,
                        device="cpu")
    trace = []

    def record(src, dst, msg):
        trace.append((_norm(src), _norm(dst), msg.type_name))
        return True
    c.network.filter = record
    c.pump()
    c.wait_all_up()
    r = c.rados()
    rc = r.mon_command({"prefix": "osd erasure-code-profile set",
                        "name": "ecp", "profile": dict(shape["profile"])})
    assert rc[0] == 0, rc
    r.pool_create("ec", pg_num=shape["pg_num"], pool_type="erasure",
                  erasure_code_profile="ecp")
    c.pump()
    return c, r, trace


def payloads(shape: dict, seed: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    return {f"obj{i:03d}": rng.integers(0, 256, shape["size"](i),
                                       dtype=np.uint8).tobytes()
            for i in range(shape["objects"])}


def wait_clean(c, rounds: int = 80) -> None:
    for _ in range(rounds):
        c.pump()
        if all(d.pgs_recovering() == 0 for d in c.osds.values()):
            return
    raise TimeoutError("EC peering never went clean")


def snapshot(kind: str, c, r, trace: list, objs: dict) -> dict:
    """Everything the test compares, in plain values both packages
    share."""
    io = r.open_ioctx("ec")
    reads = {oid: io.read(oid) for oid in objs}
    m = c.mon.osdmap
    pid = r.pool_lookup("ec")
    pgs = {}
    for ps in range(m.pools[pid].pg_num):
        up, up_p, acting, acting_p = m.pg_to_up_acting_osds(
            PG[kind](pid, ps))
        temp = [list(v) for k, v in m.pg_temp.items()
                if (k.pool, k.ps) == (pid, ps)]
        pgs[ps] = (list(up), up_p, list(acting), acting_p, temp)
    primaries = {}
    for osd, d in sorted(c.osds.items()):
        for pg, st in d.pgs.items():
            if st.backend is not None:
                primaries[str(pg)] = (osd, list(st.acting),
                                      st.peering.phase
                                      if st.peering else None)
    stores = {}
    for osd, st in sorted(c._stores.items()):
        objs_ = {}
        for cid in st.list_collections():
            for o in st.collection_list(cid):
                objs_[(cid, o.name, o.snap, o.shard)] = (
                    st.read(cid, o), st.getattrs(cid, o),
                    st.omap_get(cid, o))
        stores[osd] = objs_
    counters = {osd: {k: d.perf.get(k) for k in COUNTERS}
                for osd, d in sorted(c.osds.items())}
    out = {"reads": reads, "epoch": m.epoch, "pgs": pgs,
           "primaries": primaries, "stores": stores,
           "counters": counters, "trace": list(trace)}
    trace.clear()
    return out


def victim_of(kind: str, c, r) -> int:
    """The OSD in the most acting sets (ties: the lowest id)."""
    m = c.mon.osdmap
    pid = r.pool_lookup("ec")
    count: dict[int, int] = {}
    for ps in range(m.pools[pid].pg_num):
        _, _, acting, _ = m.pg_to_up_acting_osds(PG[kind](pid, ps))
        for o in acting:
            if 0 <= o < NONE:
                count[o] = count.get(o, 0) + 1
    return max(sorted(count), key=lambda o: count[o])


def scenario(kind: str, shape: dict) -> list:
    c, r, trace = make(kind, shape)
    try:
        objs = payloads(shape)
        steps = []
        c.tick(1000.0)
        io = r.open_ioctx("ec")
        for oid, data in objs.items():
            io.write_full(oid, data)
        c.pump()
        steps.append(("written", snapshot(kind, c, r, trace, objs)))
        victim = victim_of(kind, c, r)
        c.kill_osd(victim)
        rc = r.mon_command({"prefix": "osd down", "ids": [victim]})
        assert rc[0] == 0, rc
        c.pump()
        steps.append(("degraded", snapshot(kind, c, r, trace, objs)))
        c.tick(1001.0)
        rc = r.mon_command({"prefix": "osd out", "ids": [victim]})
        assert rc[0] == 0, rc
        wait_clean(c)
        steps.append(("clean", snapshot(kind, c, r, trace, objs)))
        steps.append(("victim", victim))
        if kind == "port":
            steps.append(("full_rebuilds", sum(
                d.perf.get("recovery_full_rebuild")
                for d in c.osds.values())))
        return steps, objs
    finally:
        c.shutdown()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cluster_equals_reference(shape):
    ref, objs = scenario("ref", SHAPES[shape])
    port, _ = scenario("port", SHAPES[shape])
    assert [s for s, _ in port] == [s for s, _ in ref] + ["full_rebuilds"]
    for (step, want), (_, got) in zip(ref, port):
        if step == "victim":
            assert got == want
            continue
        assert got["reads"] == objs, step
        for key in ("reads", "epoch", "pgs", "primaries", "counters",
                    "trace", "stores"):
            assert got[key] == want[key], (step, key)
    clean = dict(port)["clean"]
    assert all(ph == CLEAN for _, _, ph in clean["primaries"].values())
    assert dict(port)["full_rebuilds"] == 0
    read = sum(c["recovery_bytes_read"] for c in clean["counters"].values())
    rebuilt = sum(c["recovery_bytes_rebuilt"]
                  for c in clean["counters"].values())
    k = int(SHAPES[shape]["profile"]["k"])
    assert rebuilt > 0 and read == k * rebuilt


def test_threaded_cluster_reads_back_and_goes_clean():
    shape = SHAPES["k2m2_7osd"]
    c = PortCluster(n_osd=shape["n_osd"], threaded=True, device="cpu")
    try:
        c.wait_all_up()
        r = c.rados()
        r.mon_command({"prefix": "osd erasure-code-profile set",
                       "name": "ecp", "profile": dict(shape["profile"])})
        r.pool_create("ec", pg_num=shape["pg_num"], pool_type="erasure",
                      erasure_code_profile="ecp")
        io = r.open_ioctx("ec")
        objs = payloads(shape, seed=3)
        for oid, data in objs.items():
            io.write_full(oid, data)
        victim = victim_of("port", c, r)
        c.kill_osd(victim)
        r.mon_command({"prefix": "osd down", "ids": [victim]})
        for oid, data in objs.items():
            assert io.read(oid) == data, oid
        r.mon_command({"prefix": "osd out", "ids": [victim]})
        import time
        end = time.monotonic() + 30
        while time.monotonic() < end:
            if c.mon.osdmap.is_out(victim) and all(
                    d.pgs_recovering() == 0 for d in c.osds.values()):
                break
            time.sleep(0.02)
        assert all(d.pgs_recovering() == 0 for d in c.osds.values())
        for oid, data in objs.items():
            assert io.read(oid) == data, oid
        assert sum(d.perf.get("recovery_full_rebuild")
                   for d in c.osds.values()) == 0
        assert c.network.dispatch_errors == 0, c.network.last_dispatch_error
    finally:
        c.shutdown()


def test_cluster_builds_its_plugins_on_its_device():
    """Every OSD of a cpu cluster resolves to the CPU and builds its
    pool's plugin there; without a card, the default (None -> cuda)
    raises instead of falling back to the CPU."""
    import torch

    from ceph_tpu_torch.msg.messenger import LocalNetwork
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    shape = SHAPES["k2m2_7osd"]
    c, r, _ = make("port", shape)
    try:
        assert {d.device.type for d in c.osds.values()} == {"cpu"}
        plugins = [ec for d in c.osds.values() for ec in d._ecs.values()]
        assert plugins and all(ec.device.type == "cpu" for ec in plugins)
    finally:
        c.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PortCluster(n_osd=3, threaded=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OSDDaemon(LocalNetwork(), 0)
