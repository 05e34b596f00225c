"""The port's EC scrub held to the reference's, case by case.

Each scenario runs twice in one process: on
`ceph_tpu.testing.MiniCluster(threaded=False)` and on
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` (the
port's scrub; its repair runs the compiled repair on K1's plain
version).  Both get tests/test_scrub.py's cluster (6 OSDs, one per
host) and `tpu` k=2 m=2 pool of pg_num 8, the same seeded payloads and
the same damage done under the stack.  The test compares, at tolerance
0, every `pg_scrub` result dict (key order included), the errno of every
refused scrub, what the client reads back, and the sha256 of every
shard of the object on its acting OSDs after the repair.

The cases: tests/test_scrub.py's replicated ones (a corrupted replica
detected, repaired from the primary's copy by a forced push and verified;
a replica that lost its copy, pushed back), on a replicated pool `p` of
pg_num 8 made beside the EC pool; its EC ones (a clean scrub; a corrupted
shard detected, repaired, verified and read back), and the other EC
branches of the reference's compare: more than m bad shards
(unrepairable), a shard that missed a delete (the tombstone leg), a peer
with no state for the PG (EAGAIN) and a second scrub while one runs
(EBUSY).  Two more cases run on the port alone: a fault of the repair's
kernel propagates out of the scrub instead of becoming an
`unrepairable` entry; and the scrub over the port's TCP transport,
then with a peer gone from the wire (EAGAIN, nothing held).
"""
import hashlib

import numpy as np
import pytest

import ceph_tpu.osd.ec_backend as ref_ecb
import ceph_tpu.store as ref_store
import ceph_tpu_torch.osd.ec_backend as port_ecb
import ceph_tpu_torch.store as port_store
from ceph_tpu.client import RadosError as RefRadosError
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.client import RadosError as PortRadosError
from ceph_tpu_torch.ec.repairc import compiler as port_repairc
from ceph_tpu_torch.testing import MiniCluster as PortCluster

STORE = {"ref": ref_store, "port": port_store}
ECB = {"ref": ref_ecb, "port": port_ecb}
RADOS_ERROR = (RefRadosError, PortRadosError)
PROFILE = {"plugin": "tpu", "k": "2", "m": "2",
           "crush-failure-domain": "host"}


def make(kind: str):
    c = RefCluster(n_osd=6, threaded=False) if kind == "ref" else \
        PortCluster(n_osd=6, threaded=False, device="cpu")
    c.pump()
    c.wait_all_up()
    r = c.rados()
    r.mon_command({"prefix": "osd erasure-code-profile set",
                   "name": "k2m2", "profile": dict(PROFILE)})
    r.pool_create("ec", pg_num=8, pool_type="erasure",
                  erasure_code_profile="k2m2")
    r.pool_create("p", pg_num=8)
    c.pump()
    return c, r


def locate(c, r, oid, pool="ec"):
    pid = r.pool_lookup(pool)
    m = c.mon.osdmap
    raw = m.object_locator_to_pg(oid, pid)
    pg = m.pools[pid].raw_pg_to_pg(raw)
    _, _, acting, primary = m.pg_to_up_acting_osds(raw)
    return pid, pg, list(acting), primary


def payload(seed: int, n: int = 8192) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def shard_sums(kind, c, pg, acting, oid) -> dict:
    """sha256 of each acting OSD's shard of `oid` (None: absent)."""
    cid = ECB[kind].pg_cid(pg)
    out = {}
    for idx, osd in enumerate(acting):
        soid = STORE[kind].ObjectId(oid, shard=idx)
        st = c._stores[osd]
        out[idx] = hashlib.sha256(st.read(cid, soid, 0, 0)).hexdigest() \
            if st.exists(cid, soid) else None
    return out


def scrub(r, pid, ps, repair=False):
    """The result dict, or the errno name of a refused scrub."""
    try:
        return r.pg_scrub(pid, ps, repair=repair)
    except RADOS_ERROR as e:
        return e.errno_name


def run(kind: str, scenario) -> dict:
    c, r = make(kind)
    try:
        return scenario(kind, c, r)
    finally:
        c.shutdown()


def clean_scrub(kind, c, r):
    io = r.open_ioctx("ec")
    io.write_full("good", payload(1, 2000))
    c.pump()
    pid, pg, _acting, _primary = locate(c, r, "good")
    return {"scrub": scrub(r, pid, pg.ps),
            "shallow_keys": list(scrub(r, pid, pg.ps).keys())}


def corrupt_repair_verify(kind, c, r):
    """tests/test_scrub.py::test_ec_shard_corruption_detected_and_rebuilt
    with every result kept."""
    io = r.open_ioctx("ec")
    data = payload(4)
    io.write_full("ecobj", data)
    c.pump()
    pid, pg, acting, primary = locate(c, r, "ecobj")
    victim = next(o for o in acting
                  if 0 <= o < (1 << 30) and o != primary)
    idx = acting.index(victim)
    before = shard_sums(kind, c, pg, acting, "ecobj")
    c.osds[victim].store.queue_transaction(STORE[kind].Transaction().write(
        ECB[kind].pg_cid(pg), STORE[kind].ObjectId("ecobj", shard=idx), 0,
        b"\xff" * 16))
    out = {"detect": scrub(r, pid, pg.ps)}
    out["repair"] = scrub(r, pid, pg.ps, repair=True)
    c.pump()
    out["rescrub"] = scrub(r, pid, pg.ps)
    out["read_equal"] = io.read("ecobj") == data
    out["shards"] = shard_sums(kind, c, pg, acting, "ecobj")
    out["restored"] = out["shards"] == before
    out["stamped"] = c.osds[primary].pgs[pg].last_deep_scrub_stamp
    return out


def unrepairable(kind, c, r):
    """Three of four shards rotted: more than m, so the repair refuses
    and no verify round runs."""
    io = r.open_ioctx("ec")
    io.write_full("gone", payload(5))
    c.pump()
    pid, pg, acting, _primary = locate(c, r, "gone")
    for idx, osd in list(enumerate(acting))[1:]:
        c.osds[osd].store.queue_transaction(
            STORE[kind].Transaction().write(
                ECB[kind].pg_cid(pg),
                STORE[kind].ObjectId("gone", shard=idx), 0, b"\0" * 32))
    out = {"repair": scrub(r, pid, pg.ps, repair=True)}
    c.pump()
    out["rescrub"] = scrub(r, pid, pg.ps)
    out["shards"] = shard_sums(kind, c, pg, acting, "gone")
    return out


def missed_delete(kind, c, r):
    """One shard keeps its data through a delete (its old copy put
    back under the stack): the repair spreads the tombstone to it."""
    io = r.open_ioctx("ec")
    io.write_full("ghost", payload(6))
    c.pump()
    pid, pg, acting, primary = locate(c, r, "ghost")
    victim = next(o for o in acting if o != primary)
    idx = acting.index(victim)
    cid = ECB[kind].pg_cid(pg)
    soid = STORE[kind].ObjectId("ghost", shard=idx)
    st = c.osds[victim].store
    old_data, old_attrs = st.read(cid, soid, 0, 0), st.getattrs(cid, soid)
    io.remove("ghost")
    c.pump()
    st.queue_transaction(STORE[kind].Transaction()
                         .truncate(cid, soid, 0)
                         .write(cid, soid, 0, old_data)
                         .setattrs(cid, soid, old_attrs))
    out = {"detect": scrub(r, pid, pg.ps)}
    out["repair"] = scrub(r, pid, pg.ps, repair=True)
    c.pump()
    out["rescrub"] = scrub(r, pid, pg.ps)
    out["shards"] = shard_sums(kind, c, pg, acting, "ghost")
    try:
        io.read("ghost")
        out["read"] = "present"
    except RADOS_ERROR as e:
        out["read"] = e.errno_name
    return out


def absent_peer(kind, c, r):
    """A peer with no state for the PG (map lag) answers `absent`: the
    scrub is refused with EAGAIN, and the next one (state back) runs."""
    io = r.open_ioctx("ec")
    io.write_full("lag", payload(7, 3000))
    c.pump()
    pid, pg, acting, primary = locate(c, r, "lag")
    peer = c.osds[next(o for o in acting if o != primary)]
    held = peer.pgs.pop(pg)
    out = {"lagging": scrub(r, pid, pg.ps)}
    out["primary_idle"] = c.osds[primary].pgs[pg].scrub is None
    peer.pgs[pg] = held
    out["after"] = scrub(r, pid, pg.ps)
    return out


def second_scrub_busy(kind, c, r):
    """Two scrubs of one PG submitted before either is answered: the
    second is refused with EBUSY while the first completes."""
    io = r.open_ioctx("ec")
    io.write_full("busy", payload(8, 4000))
    c.pump()
    pid, pg, _acting, _primary = locate(c, r, "busy")
    ob = r.objecter
    futs = [ob.submit(pid, "", "scrub", pg_ps=pg.ps),
            ob.submit(pid, "", "scrub-repair", pg_ps=pg.ps)]
    c.pump()
    return {"futures": [(f.result, f.errno_name, f.attrs) for f in futs]}


def replica_sums(c, pg, acting, oid) -> dict:
    """sha256 of each acting OSD's replica of `oid` (None: absent)."""
    out = {}
    for osd in acting:
        shard = c.osds[osd].pgs[pg].shard
        out[osd] = hashlib.sha256(shard.read(oid)).hexdigest() \
            if shard.exists(oid) else None
    return out


def replicated_corrupt_repair(kind, c, r):
    """tests/test_scrub.py::test_replicated_corruption_detected_and_
    repaired with every result kept."""
    io = r.open_ioctx("p")
    data = b"x" * 4096
    io.write_full("victim", data)
    c.pump()
    pid, pg, acting, primary = locate(c, r, "victim", "p")
    replica = next(o for o in acting if o != primary)
    c.osds[replica].store.queue_transaction(STORE[kind].Transaction().write(
        ECB[kind].pg_cid(pg), STORE[kind].ObjectId("victim"), 0,
        b"CORRUPT!"))
    out = {"detect": scrub(r, pid, pg.ps),
           "bad": c.osds[replica].pgs[pg].shard.read("victim")[:8]}
    out["repair"] = scrub(r, pid, pg.ps, repair=True)
    c.pump()
    out["rescrub"] = scrub(r, pid, pg.ps)
    out["replicas"] = replica_sums(c, pg, acting, "victim")
    out["restored"] = set(out["replicas"].values()) == {
        hashlib.sha256(data).hexdigest()}
    out["read_equal"] = io.read("victim") == data
    return out


def replicated_missing_copy(kind, c, r):
    """tests/test_scrub.py::test_replicated_missing_copy_detected: a
    replica that lost its copy gets it back from the repair."""
    io = r.open_ioctx("p")
    io.write_full("half", b"h" * 1024)
    c.pump()
    pid, pg, acting, primary = locate(c, r, "half", "p")
    replica = next(o for o in acting if o != primary)
    c.osds[replica].store.queue_transaction(
        STORE[kind].Transaction().remove(ECB[kind].pg_cid(pg),
                                         STORE[kind].ObjectId("half")))
    out = {"repair": scrub(r, pid, pg.ps, repair=True)}
    c.pump()
    out["replicas"] = replica_sums(c, pg, acting, "half")
    out["copy"] = c.osds[replica].pgs[pg].shard.read("half")
    return out


SCENARIOS = {
    "replicated_corrupt_repair": replicated_corrupt_repair,
    "replicated_missing_copy": replicated_missing_copy,
    "clean": clean_scrub,
    "corrupt_repair_verify": corrupt_repair_verify,
    "unrepairable": unrepairable,
    "missed_delete": missed_delete,
    "absent_eagain": absent_peer,
    "second_scrub_ebusy": second_scrub_busy,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scrub_equals_reference(name):
    ref = run("ref", SCENARIOS[name])
    port = run("port", SCENARIOS[name])
    assert port == ref


def test_expected_outcomes():
    """The scenarios reach the branches they are named for (so the
    equality above is not two equal no-ops)."""
    out = run("port", corrupt_repair_verify)
    assert out["detect"] == {"inconsistent": ["ecobj"], "repaired": 0,
                             "unrepairable": []}
    assert out["repair"] == {"inconsistent": ["ecobj"], "repaired": 1,
                             "unrepairable": [], "verified": True}
    assert out["rescrub"]["inconsistent"] == []
    assert out["read_equal"] and out["restored"]
    out = run("port", unrepairable)
    assert out["repair"] == {"inconsistent": ["gone"], "repaired": 0,
                             "unrepairable": ["gone"]}
    out = run("port", missed_delete)
    assert out["repair"]["verified"] is True
    assert out["repair"]["repaired"] == 1
    assert out["rescrub"]["inconsistent"] == [] and out["read"] == "ENOENT"
    out = run("port", absent_peer)
    assert out["lagging"] == "EAGAIN" and out["primary_idle"]
    assert out["after"]["inconsistent"] == []
    out = run("port", second_scrub_busy)
    assert [f[1] for f in out["futures"]] == ["", "EBUSY"]


def test_replicated_expected_outcomes():
    """The replicated scenarios reach their branches."""
    out = run("port", replicated_corrupt_repair)
    assert out["detect"] == {"inconsistent": ["victim"], "repaired": 0,
                             "unrepairable": []}
    assert out["bad"] == b"CORRUPT!"
    assert out["repair"] == {"inconsistent": ["victim"], "repaired": 1,
                             "unrepairable": [], "verified": True}
    assert out["rescrub"]["inconsistent"] == []
    assert out["restored"] and out["read_equal"]
    out = run("port", replicated_missing_copy)
    assert out["repair"]["inconsistent"] == ["half"]
    assert out["copy"] == b"h" * 1024


def test_repair_kernel_fault_propagates(monkeypatch):
    """A fault of the compiled repair's launch inside a scrub repair
    raises out of the scrub; it is not reported as unrepairable."""
    c, r = make("port")
    try:
        io = r.open_ioctx("ec")
        io.write_full("fault", payload(9))
        c.pump()
        pid, pg, acting, primary = locate(c, r, "fault")
        victim = next(o for o in acting if o != primary)
        c.osds[victim].store.queue_transaction(port_store.Transaction().write(
            port_ecb.pg_cid(pg),
            port_store.ObjectId("fault", shard=acting.index(victim)), 0,
            b"\x01" * 8))

        def boom(*a, **k):
            raise RuntimeError("K1 launch failed")
        monkeypatch.setattr(port_repairc.RepairProgram, "run", boom)
        with pytest.raises(RuntimeError, match="K1 launch failed"):
            r.pg_scrub(pid, pg.ps, repair=True)
    finally:
        c.shutdown()


def test_scrub_over_tcp_and_a_dead_peer():
    """The same scrub over the port's TCP transport (the scrub maps come
    back with versions as lists; the compare takes them as tuples), then
    a peer that left the wire: the ScrubMapRequest cannot be sent, the
    round is aborted with EAGAIN and holds nothing."""
    from ceph_tpu_torch.dryrun import TcpCluster

    c = TcpCluster(n_osd=4, device="cpu", op_timeout=20.0)
    try:
        c.wait_all_up()
        r = c.rados
        r.pool_create("p", pg_num=8, pool_type="erasure")
        io = r.open_ioctx("p")
        data = payload(10, 20000)
        io.write_full("o", data)
        pid = r.pool_lookup("p")
        m = r.objecter.osdmap
        raw = m.object_locator_to_pg("o", pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        _, _, acting, primary = m.pg_to_up_acting_osds(raw)
        peer = next(o for o in acting if o != primary)
        c.osds[peer].store.queue_transaction(port_store.Transaction().write(
            port_ecb.pg_cid(pg),
            port_store.ObjectId("o", shard=list(acting).index(peer)), 0,
            b"ROT"))
        assert r.pg_scrub(pid, pg.ps) == {
            "inconsistent": ["o"], "repaired": 0, "unrepairable": []}
        assert r.pg_scrub(pid, pg.ps, repair=True) == {
            "inconsistent": ["o"], "repaired": 1, "unrepairable": [],
            "verified": True}
        assert r.pg_scrub(pid, pg.ps)["inconsistent"] == []
        assert io.read("o") == data
        assert c.network.dispatch_errors == 0
        c.kill_osd(peer)
        with pytest.raises(PortRadosError, match="EAGAIN"):
            r.pg_scrub(pid, pg.ps)
        st = c.osds[primary].pgs[pg]
        assert st.scrub is None and st.scrub_reserving is None
        assert st.scrub_granted == set()
    finally:
        c.shutdown()
