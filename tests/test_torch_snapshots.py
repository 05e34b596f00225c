"""Pool snapshots on the port's cluster, held to the reference's.

Every case of tests/test_snapshots.py, each run on one module-wide
`ceph_tpu.testing.MiniCluster(threaded=False)` and one
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` (4
OSDs, a replicated pool `sp` and a `tpu` k=2 m=1 pool `esp`, pg_num 8
each).  Each case records what the client saw (bytes, errnos, snap ids,
`list_snaps`) and what the OSDs hold (every shard's clone tags and snap
index), and the port's record must equal the reference's at tolerance
0: the pool snap commands, the EC pool's refusal, COW and snap reads,
a snap of an unmodified object, an object born after the snap, a delete
under a snap, rollback of data, xattrs and omap, a removed snap that a
lagging client's snapc must not bring back, COW under a lagging OSD
map, clones carried by recovery after `osd out`, and the scrub of a
diverged clone with its repair.  All run in pump mode: the reference's
clone-divergence case is unsteady when its threads share a loaded host.
"""
import pytest

from ceph_tpu.client import RadosError as RefRadosError
from ceph_tpu.client import WriteOp as RefWriteOp
from ceph_tpu.msg.messages import MMap as RefMMap
from ceph_tpu.osd import ec_backend as ref_ecb
from ceph_tpu.osd.snap_mapper import SnapMapper as RefSnapMapper
from ceph_tpu import store as ref_store
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.client import RadosError as PortRadosError
from ceph_tpu_torch.client import WriteOp as PortWriteOp
from ceph_tpu_torch.msg.messages import MMap as PortMMap
from ceph_tpu_torch.osd import ec_backend as port_ecb
from ceph_tpu_torch.osd.snap_mapper import SnapMapper as PortSnapMapper
from ceph_tpu_torch import store as port_store
from ceph_tpu_torch.testing import MiniCluster as PortCluster

ERRORS = (RefRadosError, PortRadosError)
PKG = {"ref": {"cluster": RefCluster, "WriteOp": RefWriteOp,
               "MMap": RefMMap, "ecb": ref_ecb, "store": ref_store,
               "SnapMapper": RefSnapMapper},
       "port": {"cluster": PortCluster, "WriteOp": PortWriteOp,
                "MMap": PortMMap, "ecb": port_ecb, "store": port_store,
                "SnapMapper": PortSnapMapper}}


def make_cluster(kind, n_osd):
    cls = PKG[kind]["cluster"]
    c = cls(n_osd=n_osd, threaded=False) if kind == "ref" else \
        cls(n_osd=n_osd, threaded=False, device="cpu")
    c.pump()
    c.wait_all_up()
    return c


class Side:
    """One package's cluster, client and simulated clock."""

    def __init__(self, kind):
        self.kind = kind
        self.pkg = PKG[kind]
        self.c = make_cluster(kind, 4)
        self.r = self.c.rados()
        self.r.pool_create("sp", pg_num=8)
        self.r.mon_command({"prefix": "osd erasure-code-profile set",
                            "name": "k2m1",
                            "profile": {"plugin": "tpu", "k": "2",
                                        "m": "1",
                                        "crush-failure-domain": "osd"}})
        self.r.pool_create("esp", pg_num=8, pool_type="erasure",
                           erasure_code_profile="k2m1")
        self.c.pump()
        self.now = 1000.0

    def io(self, pool="sp"):
        return self.r.open_ioctx(pool)

    def tick(self, n=1):
        for _ in range(n):
            self.now += 1.0
            self.c.tick(self.now)

    def locate(self, oid, pool="sp"):
        pid = self.r.pool_lookup(pool)
        m = self.r.objecter.osdmap
        raw = m.object_locator_to_pg(oid, pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        _, _, acting, primary = m.pg_to_up_acting_osds(raw)
        return pid, raw, pg, list(acting), primary

    def snap_state(self, oids):
        """Every OSD's clone tags of `oids` and every PG's snap index."""
        out = {}
        for o, d in sorted(self.c.osds.items()):
            for pg, st in sorted(d.pgs.items()):
                if not hasattr(st.shard, "snap_mapper"):
                    continue
                tags = {oid: st.shard.clone_tags(oid) for oid in oids
                        if st.shard.clone_tags(oid)}
                idx = self.pkg["SnapMapper"](d.store, st.shard.cid).dump()
                if tags or idx:
                    out[f"osd.{o}/{pg}"] = (tags, idx)
        return out


@pytest.fixture(scope="module")
def sides():
    out = {kind: Side(kind) for kind in ("ref", "port")}
    yield out
    for s in out.values():
        s.c.shutdown()


def attempt(fn, *a, **kw):
    """("ok", value) or ("err", errno name)."""
    try:
        return ("ok", fn(*a, **kw))
    except ERRORS as e:
        return ("err", e.errno_name)


def run_both(sides, case, *args):
    got = {kind: case(side, *args) for kind, side in sides.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# ---------------------------------------------------------------- cases

def c_mksnap_rmsnap_commands(side):
    io = side.io()
    io.snap_create("alpha")
    listed = sorted(io.list_pool_snaps().items())
    dup = attempt(io.snap_create, "alpha")
    io.snap_remove("alpha")
    after = "alpha" in io.list_pool_snaps().values()
    gone = attempt(io.snap_remove, "alpha")
    return listed, dup, after, gone


def test_mksnap_rmsnap_commands(sides):
    listed, dup, after, gone = run_both(sides, c_mksnap_rmsnap_commands)
    assert "alpha" in dict(listed).values()
    assert dup == ("err", "EEXIST") and gone == ("err", "ENOENT")
    assert not after


def c_ec_pool_refuses_snaps(side):
    e = side.io("esp")
    return (attempt(e.snap_create, "nope"),
            attempt(e.selfmanaged_snap_create))


def test_ec_pool_refuses_snaps(sides):
    assert run_both(sides, c_ec_pool_refuses_snaps) == \
        (("err", "EOPNOTSUPP"), ("err", "EOPNOTSUPP"))


def c_cow_and_snap_reads(side):
    io, oid = side.io(), "cowobj"
    io.write_full(oid, b"version-one")
    io.snap_create("s1")
    s1 = io.snap_lookup("s1")
    io.write_full(oid, b"version-two is longer")
    io.snap_create("s2")
    s2 = io.snap_lookup("s2")
    io.write_full(oid, b"v3")
    return (s1, s2, io.read(oid), io.read(oid, snapid=s1),
            io.read(oid, snapid=s2), io.list_snaps(oid),
            side.snap_state([oid]))


def test_cow_and_snap_reads(sides):
    s1, s2, head, r1, r2, ls, _ = run_both(sides, c_cow_and_snap_reads)
    assert (head, r1, r2) == (b"v3", b"version-one",
                              b"version-two is longer")
    assert ls["head_exists"]
    assert sorted(int(t) for t in ls["clones"]) == [s1, s2]


def c_snap_of_unmodified_object_reads_head(side):
    io, oid = side.io(), "lazy"
    io.write_full(oid, b"unchanged")
    io.snap_create("s-l")
    sid = io.snap_lookup("s-l")
    return io.read(oid, snapid=sid), io.list_snaps(oid)["clones"]


def test_snap_of_unmodified_object_reads_head(sides):
    assert run_both(sides, c_snap_of_unmodified_object_reads_head) == \
        (b"unchanged", {})


def c_object_created_after_snap_absent_at_snap(side):
    io = side.io()
    io.snap_create("s-pre")
    sid = io.snap_lookup("s-pre")
    io.write_full("newborn", b"late")
    io.write_full("newborn", b"later")   # forces a clone decision
    return (attempt(io.read, "newborn", snapid=sid),
            side.snap_state(["newborn"]))


def test_object_created_after_snap_absent_at_snap(sides):
    got, _ = run_both(sides, c_object_created_after_snap_absent_at_snap)
    assert got == ("err", "ENOENT")


def c_delete_preserves_snapshots(side):
    io, oid = side.io(), "ghost"
    io.write_full(oid, b"will be deleted")
    io.snap_create("s-g")
    sid = io.snap_lookup("s-g")
    io.remove(oid)
    return (attempt(io.read, oid), io.read(oid, snapid=sid),
            io.list_snaps(oid), side.snap_state([oid]))


def test_delete_preserves_snapshots(sides):
    head, at_snap, ls, _ = run_both(sides, c_delete_preserves_snapshots)
    assert head == ("err", "ENOENT") and at_snap == b"will be deleted"
    assert not ls["head_exists"]


def c_rollback(side):
    io, oid, W = side.io(), "rb", side.pkg["WriteOp"]
    io.operate(oid, W().write_full(b"good state")
               .set_xattr("tag", b"good").set_omap({"k": b"good"}))
    io.snap_create("s-rb")
    io.operate(oid, W().write_full(b"bad state!")
               .set_xattr("tag", b"bad").set_omap({"k": b"bad"}))
    io.snap_rollback(oid, "s-rb")
    back = (io.read(oid), io.get_xattr(oid, "tag"),
            io.get_omap_vals(oid)[0])
    # rollback of a post-snap object removes it
    io.snap_create("s-rb2")
    io.write_full("rb-new", b"x")
    io.write_full("rb-new", b"y")
    io.snap_rollback("rb-new", "s-rb2")
    return back, attempt(io.read, "rb-new"), \
        side.snap_state([oid, "rb-new"])


def test_rollback(sides):
    back, new, _ = run_both(sides, c_rollback)
    assert back == (b"good state", b"good", {"k": b"good"})
    assert new == ("err", "ENOENT")


def c_removed_snap_never_resurrects(side):
    io, oid = side.io(), "zombie"
    io.write_full(oid, b"content")
    io.snap_create("doomed")
    sid = io.snap_lookup("doomed")
    io.snap_remove("doomed")
    # lagging client: sends the stale snapc by hand
    io.set_write_snapc(sid, [sid])
    try:
        io.write_full(oid, b"after removal")
    finally:
        io.write_snapc = None
    return io.list_snaps(oid)["clones"], attempt(io.read, oid, snapid=sid)


def test_removed_snap_never_resurrects(sides):
    assert run_both(sides, c_removed_snap_never_resurrects) == \
        ({}, ("err", "ENOENT"))


def c_write_cows_with_lagging_osd_map(kind):
    c = make_cluster(kind, 3)
    try:
        r = c.rados()
        r.pool_create("lp", pg_num=8)
        c.pump()
        io = r.open_ioctx("lp")
        MMap = PKG[kind]["MMap"]
        oid = "lagobj"
        io.write_full(oid, b"pre-snap state")
        # freeze map delivery to OSDs, then take the snap (the client
        # sees it; the OSDs don't)
        c.network.filter = lambda src, dst, msg: not (
            dst.startswith("osd.") and isinstance(msg, MMap))
        try:
            io.snap_create("s-lag")
            sid = io.snap_lookup("s-lag")
            io.write_full(oid, b"post-snap state")
        finally:
            c.network.filter = None
        return io.read(oid, snapid=sid), io.read(oid)
    finally:
        c.shutdown()


def test_write_cows_with_lagging_osd_map():
    got = {kind: c_write_cows_with_lagging_osd_map(kind)
           for kind in ("ref", "port")}
    assert got["port"] == got["ref"] == (b"pre-snap state",
                                         b"post-snap state")


def c_clones_survive_recovery(side):
    io, oid = side.io(), "snapdur"
    io.write_full(oid, b"snapshotted data")
    io.snap_create("s-dur")
    sid = io.snap_lookup("s-dur")
    io.write_full(oid, b"newer data")
    pid, raw, pg, acting, primary = side.locate(oid)
    victim = next(o for o in acting if o != primary)
    e0 = side.r.objecter.osdmap.epoch
    side.r.mon_command({"prefix": "osd out", "ids": [victim]})
    side.r.objecter.wait_for_map(e0 + 1)
    newcomer = None
    for _ in range(60):
        side.tick()
        m2 = side.r.objecter.osdmap
        acting2 = m2.pg_to_up_acting_osds(raw)[2]
        new = [o for o in acting2 if o not in acting and o >= 0]
        if new:
            st = side.c.osds[new[0]].pgs.get(pg)
            if st is not None and st.shard is not None and \
                    st.shard.clone_tags(oid):
                newcomer = (new[0], st.shard.clone_tags(oid))
                break
    got = (newcomer, io.read(oid, snapid=sid), io.read(oid))
    side.r.mon_command({"prefix": "osd in", "ids": [victim]})
    for _ in range(60):
        side.tick()
        if all(d.pgs_recovering() == 0 for d in side.c.osds.values()):
            break
    return got


def test_clones_survive_recovery(sides):
    newcomer, at_snap, head = run_both(sides, c_clones_survive_recovery)
    assert newcomer is not None, "newcomer never received the clones"
    assert (at_snap, head) == (b"snapshotted data", b"newer data")


def c_scrub_detects_clone_divergence(side):
    io, oid = side.io(), "scrubsnap"
    io.write_full(oid, b"snap me")
    io.snap_create("s-sc")
    io.write_full(oid, b"head now")
    pid, raw, pg, acting, primary = side.locate(oid)
    victim = next(o for o in acting if o != primary)
    # corrupt the replica's clone
    sid = io.snap_lookup("s-sc")
    st = side.pkg["store"]
    side.c.osds[victim].store.queue_transaction(st.Transaction().write(
        side.pkg["ecb"].pg_cid(pg), st.ObjectId(oid, snap=sid), 0,
        b"EVIL"))
    res = side.r.pg_scrub(pid, pg.ps)
    res2 = side.r.pg_scrub(pid, pg.ps, repair=True)
    res3 = side.r.pg_scrub(pid, pg.ps)
    return res, res2, res3, io.read(oid, snapid=sid)


def test_scrub_detects_clone_divergence(sides):
    res, res2, res3, at_snap = run_both(sides,
                                        c_scrub_detects_clone_divergence)
    assert "scrubsnap" in res["inconsistent"]
    assert res2["repaired"] >= 1
    assert res3["inconsistent"] == []
    assert at_snap == b"snap me"
