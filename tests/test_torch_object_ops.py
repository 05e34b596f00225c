"""The extended librados op surface on the port's cluster, held to the
reference's.

Every case of tests/test_object_ops.py, each run on one module-wide
`ceph_tpu.testing.MiniCluster(threaded=False)` and one
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` (6
OSDs, one per host; a replicated pool `rp` and a `tpu` k=2 m=2 pool
`ecp`, pg_num 16 each), the cases that take any pool on both pools.
Each case records what the client saw (bytes, sizes, xattrs, omap pages,
the errno of every refused op, scrub results) and what the OSDs hold,
and the port's record must equal the reference's at tolerance 0: append
and truncate and zero and create, xattrs, omap with pagination, omap
refused on the EC pool, compound WriteOps (the EC one encodes on K1's
plain version), malformed mutation vectors, an append resolved at the
primary, metadata carried through replicated recovery after `osd out`,
the omap-divergence scrub and its repair, and an EC shard's xattrs
rebuilt by scrub repair.
"""
import numpy as np
import pytest

from ceph_tpu.client import RadosError as RefRadosError
from ceph_tpu.client import WriteOp as RefWriteOp
from ceph_tpu.osd import ec_backend as ref_ecb
from ceph_tpu.osd import mutations as ref_mut
from ceph_tpu import store as ref_store
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.client import RadosError as PortRadosError
from ceph_tpu_torch.client import WriteOp as PortWriteOp
from ceph_tpu_torch.osd import ec_backend as port_ecb
from ceph_tpu_torch.osd import mutations as port_mut
from ceph_tpu_torch import store as port_store
from ceph_tpu_torch.testing import MiniCluster as PortCluster

WRITEOP = {"ref": RefWriteOp, "port": PortWriteOp}
ECB = {"ref": ref_ecb, "port": port_ecb}
MUT = {"ref": ref_mut, "port": port_mut}
STORE = {"ref": ref_store, "port": port_store}
ERRORS = (RefRadosError, PortRadosError)


class Side:
    """One package's cluster, client and simulated clock."""

    def __init__(self, kind):
        self.kind = kind
        self.c = RefCluster(n_osd=6, threaded=False) if kind == "ref" \
            else PortCluster(n_osd=6, threaded=False, device="cpu")
        self.c.pump()
        self.c.wait_all_up()
        self.r = self.c.rados()
        self.r.pool_create("rp", pg_num=16, pool_type="replicated")
        self.r.mon_command({"prefix": "osd erasure-code-profile set",
                            "name": "k2m2",
                            "profile": {"plugin": "tpu", "k": "2",
                                        "m": "2",
                                        "crush-failure-domain": "host"}})
        self.r.pool_create("ecp", pg_num=16, pool_type="erasure",
                           erasure_code_profile="k2m2")
        self.c.pump()
        self.now = 1000.0
        self.WriteOp = WRITEOP[kind]

    def io(self, pool):
        return self.r.open_ioctx(pool)

    def tick(self, n=1):
        for _ in range(n):
            self.now += 1.0
            self.c.tick(self.now)

    def settle(self, ticks=120):
        for _ in range(ticks):
            self.tick()
            if all(d.pgs_recovering() == 0 for d in self.c.osds.values()):
                return
        raise AssertionError(f"{self.kind}: never settled")

    def locate(self, pool, oid):
        pid = self.r.pool_lookup(pool)
        m = self.r.objecter.osdmap
        raw = m.object_locator_to_pg(oid, pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        _, _, acting, primary = m.pg_to_up_acting_osds(raw)
        return pid, raw, pg, list(acting), primary


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


def payload(seed, n):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


POOLS = ["rp", "ecp"]


# ------------------------------------------------------------ data ops

def c_append(side, pool):
    io = side.io(pool)
    io.write_full("append", b"abc")
    io.append("append", b"defgh")
    return io.read("append"), io.stat("append")["size"]


def c_append_creates(side, pool):
    io = side.io(pool)
    io.append("append_creates", b"fresh")
    return io.read("append_creates")


def c_truncate_down_and_up(side, pool):
    io = side.io(pool)
    data = payload(3, 5000)
    io.write_full("trunc", data)
    io.truncate("trunc", 1234)
    down = io.read("trunc")
    io.truncate("trunc", 2000)
    return down, io.read("trunc"), io.stat("trunc")["size"]


def c_truncate_to_zero(side, pool):
    io = side.io(pool)
    io.write_full("trunc0", b"x" * 4096)
    io.truncate("trunc0", 0)
    return io.read("trunc0"), io.stat("trunc0")["size"]


def c_zero_within_and_past_size(side, pool):
    io = side.io(pool)
    io.write_full("zero", b"\xaa" * 1000)
    io.zero("zero", 100, 200)
    first = io.read("zero")
    io.zero("zero", 900, 500)
    return first, io.read("zero"), io.stat("zero")["size"]


def c_create_exclusive(side, pool):
    io = side.io(pool)
    out = [attempt(io.create, "excl", exclusive=True),
           io.stat("excl")["size"],
           attempt(io.create, "excl", exclusive=True),
           attempt(io.create, "excl")]
    return out


def c_write_full_shrinks(side, pool):
    io = side.io(pool)
    io.write_full("shrink", b"L" * 9000)
    io.write_full("shrink", b"s" * 10)
    return io.read("shrink"), io.stat("shrink")["size"]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("case", [
    c_append, c_append_creates, c_truncate_down_and_up,
    c_truncate_to_zero, c_zero_within_and_past_size, c_create_exclusive,
    c_write_full_shrinks], ids=lambda f: getattr(f, "__name__", f)[2:])
def test_data_op(sides, case, pool):
    run_both(sides, case, pool)


def test_expected_data_op_results(sides):
    """Spot checks of the recorded values (the cases above compare the
    two packages; these pin what they must agree on)."""
    port = sides["port"]
    for pool in POOLS:
        assert c_append(port, pool) == (b"abcdefgh", 8)
        down, up, size = c_truncate_down_and_up(port, pool)
        assert up == down + b"\0" * (2000 - 1234) and size == 2000
        first, last, size = c_zero_within_and_past_size(port, pool)
        assert first[100:300] == b"\0" * 200 and size == 1000
        assert last[900:] == b"\0" * 100
        assert c_create_exclusive(port, pool)[2] == ("err", "EEXIST")


# ------------------------------------------------------------- xattrs

def c_xattr_roundtrip(side, pool):
    io = side.io(pool)
    io.write_full("xa", b"body")
    io.set_xattr("xa", "user.k1", b"v1")
    io.set_xattr("xa", "user.k2", b"v2")
    out = [io.get_xattr("xa", "user.k1"), io.get_xattrs("xa")]
    io.rm_xattr("xa", "user.k1")
    out += [io.get_xattrs("xa"), attempt(io.get_xattr, "xa", "user.k1"),
            attempt(io.rm_xattr, "xa", "user.k1"), io.read("xa")]
    return out


def c_xattr_on_missing_object(side, pool):
    io = side.io(pool)
    out = [attempt(io.get_xattr, "xmiss", "a")]
    io.set_xattr("xmiss", "a", b"1")
    return out + [io.stat("xmiss")["size"], io.get_xattr("xmiss", "a")]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("case", [c_xattr_roundtrip,
                                  c_xattr_on_missing_object],
                         ids=lambda f: getattr(f, "__name__", f)[2:])
def test_xattr_op(sides, case, pool):
    got = run_both(sides, case, pool)
    if case is c_xattr_roundtrip:
        assert got[3] == ("err", "ENODATA") and got[4] == ("err", "ENODATA")
    else:
        assert got[0] == ("err", "ENOENT")


# --------------------------------------------------------------- omap

def c_omap_roundtrip(side):
    io = side.io("rp")
    io.write_full("om", b"")
    io.set_omap("om", {"b": b"2", "a": b"1", "c": b"3"})
    out = [io.get_omap_vals("om")]
    io.remove_omap_keys("om", ["b"])
    out += [io.get_omap_keys("om"),
            io.get_omap_vals_by_keys("om", ["a", "zz"])]
    io.set_omap_header("om", b"HDR")
    out.append(io.get_omap_header("om"))
    io.clear_omap("om")
    return out + [io.get_omap_vals("om"), io.get_omap_header("om")]


def test_omap_roundtrip(sides):
    got = run_both(sides, c_omap_roundtrip)
    assert got[0] == ({"a": b"1", "b": b"2", "c": b"3"}, False)
    assert got[-2:] == [({}, False), b""]


def c_omap_pagination(side):
    io = side.io("rp")
    io.set_omap("page", {f"k{i:03d}": str(i).encode() for i in range(20)})
    return (io.get_omap_vals("page", max_return=7),
            io.get_omap_vals("page", after="k006", max_return=50),
            io.get_omap_keys("page", after="k010", max_return=3))


def test_omap_pagination(sides):
    first, rest, keys = run_both(sides, c_omap_pagination)
    assert len(first[0]) == 7 and first[1]
    assert len(rest[0]) == 13 and not rest[1]
    assert keys == (["k011", "k012", "k013"], True)


def c_omap_rejected_on_ec_pool(side):
    io = side.io("ecp")
    io.write_full("ecomap", b"x")
    return (attempt(io.set_omap, "ecomap", {"k": b"v"}),
            attempt(io.get_omap_vals, "ecomap"),
            attempt(io.get_omap_header, "ecomap"))


def test_omap_rejected_on_ec_pool(sides):
    got = run_both(sides, c_omap_rejected_on_ec_pool)
    assert got == (("err", "EOPNOTSUPP"),) * 3


# ----------------------------------------------------- compound WriteOp

def c_writeop_atomic_compound(side):
    io = side.io("rp")
    io.operate("wop", side.WriteOp().write_full(b"payload")
               .set_xattr("tag", b"t1").set_omap({"idx": b"7"}))
    return io.read("wop"), io.get_xattr("wop", "tag"), \
        io.get_omap_vals("wop")


def test_writeop_atomic_compound(sides):
    assert run_both(sides, c_writeop_atomic_compound) == \
        (b"payload", b"t1", ({"idx": b"7"}, False))


def c_writeop_ec_data_plus_xattr(side):
    io = side.io("ecp")
    io.operate("ecwop", side.WriteOp().write_full(b"E" * 4096)
               .set_xattr("m", b"1"))
    out = [io.read("ecwop"), io.get_xattr("ecwop", "m")]
    # EC allows at most one data mutation per compound op
    out.append(attempt(io.operate, "ecwop",
                       side.WriteOp().write(b"a", 0).append(b"b")))
    return out


def test_writeop_ec_data_plus_xattr(sides):
    got = run_both(sides, c_writeop_ec_data_plus_xattr)
    assert got == [b"E" * 4096, b"1", ("err", "EINVAL")]


def c_writev_malformed_rejected(side, pool):
    io = side.io(pool)
    ob = io.rados.objecter
    out = []
    for bad_ops in ([["write", 0]], [["truncate", -5]],
                    [["write", "x", b"d"]], [["nosuch", 1]],
                    [["setxattrs", {"k": 3}]]):
        fut = ob.submit(io.pool_id, "malformed", "writev",
                        args={"ops": bad_ops})
        assert ob.wait_sync(fut.done, 10, ev=fut._ev), bad_ops
        out.append(fut.errno_name)
    return out, "malformed" in io.list_objects()


@pytest.mark.parametrize("pool", POOLS)
def test_writev_malformed_rejected(sides, pool):
    got = run_both(sides, c_writev_malformed_rejected, pool)
    assert got == (["EINVAL"] * 5, False)


def c_append_resolved_at_primary(side):
    io = side.io("rp")
    io.write_full("resolved", b"base")
    io.append("resolved", b"+tail")
    _pid, _raw, pg, acting, _ = side.locate("rp", "resolved")
    side.c.pump()
    return [side.c.osds[o].pgs[pg].shard.read("resolved") for o in acting]


def test_append_resolved_at_primary(sides):
    assert run_both(sides, c_append_resolved_at_primary) == \
        [b"base+tail"] * 3


# ------------------------------------------- metadata through recovery

def c_replicated_recovery_carries_metadata(side):
    io = side.io("rp")
    oid = "recmeta"
    io.operate(oid, side.WriteOp().write_full(b"D" * 2048)
               .set_xattr("x", b"xv").set_omap({"o": b"ov"})
               .set_omap_header(b"H"))
    pid, raw, _pg, acting, primary = side.locate("rp", oid)
    victim = next(o for o in acting if o != primary)
    side.r.mon_command({"prefix": "osd out", "ids": [victim]})
    side.settle()
    m = side.r.objecter.osdmap
    acting2 = m.pg_to_up_acting_osds(raw)[2]
    pg = m.pools[pid].raw_pg_to_pg(raw)
    newcomer = [o for o in acting2 if o not in acting and o >= 0]
    copies = [side.c.osds[o].pgs[pg].shard.push_payload(oid)
              for o in newcomer]
    pushes = sum(d.perf.get("recovery_push") for d in side.c.osds.values())
    side.r.mon_command({"prefix": "osd in", "ids": [victim]})
    side.settle()
    return {"victim": victim, "newcomer": newcomer, "copies": copies,
            "pushes": pushes, "read": io.read(oid)}


def test_replicated_recovery_carries_metadata(sides):
    got = run_both(sides, c_replicated_recovery_carries_metadata)
    assert got["newcomer"] and got["pushes"]
    assert got["copies"] == [(b"D" * 2048, {"x": b"xv"}, {"o": b"ov"},
                              b"H")] * len(got["newcomer"])


def c_scrub_omap_divergence(side):
    kind = side.kind
    io = side.io("rp")
    oid = "scrubomap"
    io.write_full(oid, b"scrubme")
    io.set_omap(oid, {"good": b"1"})
    pid, _raw, pg, acting, primary = side.locate("rp", oid)
    victim = next(o for o in acting if o != primary)
    side.c.osds[victim].store.queue_transaction(
        STORE[kind].Transaction().omap_setkeys(
            ECB[kind].pg_cid(pg), STORE[kind].ObjectId(oid),
            {"evil": b"666"}))
    out = [side.r.pg_scrub(pid, pg.ps),
           side.r.pg_scrub(pid, pg.ps, repair=True)]
    side.c.pump()
    out.append(side.r.pg_scrub(pid, pg.ps))
    out.append(side.c.osds[victim].pgs[pg].shard.omap_get(oid))
    return out


def test_scrub_detects_and_repairs_omap_divergence(sides):
    detect, repair, again, omap = run_both(sides, c_scrub_omap_divergence)
    assert "scrubomap" in detect["inconsistent"]
    assert "scrubomap" in repair["inconsistent"] and repair["repaired"] >= 1
    assert again["inconsistent"] == [] and omap == {"good": b"1"}


def c_ec_xattr_survives_shard_rebuild(side):
    kind = side.kind
    io = side.io("ecp")
    oid = "ecxattr"
    data = payload(11, 8192)
    io.write_full(oid, data)
    io.set_xattr(oid, "keep", b"me")
    pid, _raw, pg, acting, primary = side.locate("ecp", oid)
    sidx, victim = next((i, o) for i, o in enumerate(acting)
                        if o != primary and 0 <= o < (1 << 30))
    cid = ECB[kind].pg_cid(pg)
    soid = STORE[kind].ObjectId(oid, shard=sidx)
    side.c.osds[victim].store.queue_transaction(
        STORE[kind].Transaction().rmattr(cid, soid,
                                         MUT[kind].uxattr_key("keep")))
    res = side.r.pg_scrub(pid, pg.ps, repair=True)
    attrs = side.c.osds[victim].store.getattrs(cid, soid)
    return res, attrs.get(MUT[kind].uxattr_key("keep")), \
        io.read(oid) == data


def test_ec_xattr_survives_shard_rebuild(sides):
    res, kept, read_ok = run_both(sides, c_ec_xattr_survives_shard_rebuild)
    assert "ecxattr" in res["inconsistent"] and kept == b"me" and read_ok


def test_listing_equals_the_references(sides):
    """After every case above: both pools list the same objects."""
    got = {kind: {pool: s.io(pool).list_objects() for pool in POOLS}
           for kind, s in sides.items()}
    assert got["port"] == got["ref"]
    assert "wop" in got["port"]["rp"] and "ecwop" in got["port"]["ecp"]
