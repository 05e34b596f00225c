"""OSDThrasher on the port's cluster, held to the reference's.

The seeds and shapes of tests/test_thrasher.py and tests/test_thrash_ec.py
run on `ceph_tpu.testing.MiniCluster(threaded=False)` with its
`OSDThrasher` and on `ceph_tpu_torch.testing.MiniCluster(device="cpu",
threaded=False)` with the port's, each pumped and ticked on the
thrasher's simulated clock.  Compared at tolerance 0: the thrasher's
action log (kills, revivals, outs, ins, shard EIO injections), the
writes that completed and failed, every object read back after `heal`,
the final map's up and in sets, and every OSD store's contents.  The EC
case is `tpu` k=8 m=4 on 14 OSDs with EIO injection in the mix, as the
reference's.
"""
import random
import time

import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu.testing import OSDThrasher as RefThrasher
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.testing import MiniCluster as PortCluster
from ceph_tpu_torch.testing import OSDThrasher as PortThrasher

from test_torch_split import stores

NS = {
    "ref": dict(cluster=lambda n: RefCluster(n_osd=n, threaded=False),
                thrasher=RefThrasher, config=ref_config),
    "port": dict(cluster=lambda n: PortCluster(n_osd=n, threaded=False,
                                               device="cpu"),
                 thrasher=PortThrasher, config=port_config),
}
K, M = 8, 4


def make(kind, n, pg_num=16, ec=False):
    c = NS[kind]["cluster"](n)
    c.pump()
    c.wait_all_up()
    r = c.rados()
    if ec:
        r.mon_command({"prefix": "osd erasure-code-profile set",
                       "name": "k8m4t",
                       "profile": {"plugin": "tpu", "k": str(K),
                                   "m": str(M),
                                   "crush-failure-domain": "osd"}})
        r.pool_create("ecp", pg_num=pg_num, pool_type="erasure",
                      erasure_code_profile="k8m4t")
    else:
        r.pool_create("p", pg_num=pg_num)
    c.pump()
    return c, r


def drain(c, futures, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        c.pump()
        if all(f.done() for f in futures.values()):
            break
        time.sleep(0.02)
    return sorted(o for o, f in futures.items() if not f.done())


def thrash(kind, n, pool, ec, seed, io_seed, rounds, min_in, min_live,
           writes, size):
    c, r = make(kind, n, pg_num=4 if ec else 16, ec=ec)
    try:
        io = r.open_ioctx(pool)
        rng = random.Random(io_seed)
        expected, futures = {}, {}

        def do_io(i):
            for _ in range(writes):
                oid = f"obj{rng.randrange(30)}" if not ec \
                    else f"e{rng.randrange(10)}"
                data = bytes([rng.randrange(256)]) * size(rng)
                futures[oid] = io.aio_write_full(oid, data)
                expected[oid] = data
            c.pump()

        kw = dict(ec_pools=[pool], rados=r) if ec else {}
        t = NS[kind]["thrasher"](c, seed=seed, min_in=min_in,
                                 min_live=min_live, **kw)
        do_io(-1)
        t.do_thrash(rounds, between=do_io)
        if ec and not t.injected and not any("eio" in e for e in t.log):
            t.inject_shard_eio()
            do_io(99)
        t.heal()
        undone = drain(c, futures)
        failed = {o: f.errno_name for o, f in futures.items()
                  if f.done() and f.result < 0}
        m = c.mon.osdmap
        return {"log": list(t.log), "undone": undone, "failed": failed,
                "reads": {o: io.read(o) == d
                          for o, d in sorted(expected.items())},
                "up_in": [(m.is_up(o), m.is_in(o)) for o in range(n)],
                "eio_flag": NS[kind]["config"]()[
                    "objectstore_debug_inject_read_err"],
                "stores": stores(c)}
    finally:
        c.shutdown()


CASES = {
    # tests/test_thrasher.py's loop: 7 OSDs, 12 rounds, 3 writes each
    "replicated": dict(n=7, pool="p", ec=False, seed=7, io_seed=42,
                       rounds=12, min_in=4, min_live=4, writes=3,
                       size=lambda g: g.randrange(1, 800)),
    # tests/test_thrash_ec.py's loop: k=8 m=4 on 14 OSDs with shard EIO
    "erasure": dict(n=14, pool="ecp", ec=True, seed=7, io_seed=42,
                    rounds=8, min_in=12, min_live=12, writes=2,
                    size=lambda g: g.randrange(256, 4096)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_thrash_equals_the_reference(case):
    kw = CASES[case]
    ref = thrash("ref", **kw)
    port = thrash("port", **kw)
    assert port["log"] == ref["log"]
    assert port == ref
    assert port["undone"] == [] and port["failed"] == {}
    assert all(port["reads"].values())
    assert all(u and i for u, i in port["up_in"])
    assert port["eio_flag"] is False
    kinds = {e.split()[0] for e in port["log"]}
    assert {"kill", "revive"} <= kinds
    if kw["ec"]:
        assert "eio" in kinds


def guards(kind):
    c, _ = make(kind, 4)
    try:
        t = NS[kind]["thrasher"](c, seed=1, min_in=3, min_live=3)
        for _ in range(10):
            t.kill_osd()
            t.out_osd()
        return {"log": t.log, "live": t._live(), "in": t._in()}
    finally:
        c.shutdown()


def test_thrasher_min_guards_equal_the_reference():
    ref, port = guards("ref"), guards("port")
    assert port == ref
    assert len(port["live"]) >= 3 and len(port["in"]) >= 3


def eio_read(kind):
    """tests/test_thrash_ec.py's shard EIO read: a data shard's chunk
    read fails on a non-primary and the primary decodes around it."""
    cfg = NS[kind]["config"]()
    old = cfg["objectstore_debug_inject_read_err"]
    cfg.set("objectstore_debug_inject_read_err", True)
    c, r = make(kind, 13, pg_num=2, ec=True)
    try:
        io = r.open_ioctx("ecp")
        payload = bytes(random.Random(1).randrange(256)
                        for _ in range(1 << 14))
        io.write_full("eobj", payload)
        c.pump()
        pid = r.pool_lookup("ecp")
        m = c.mon.osdmap
        raw = m.object_locator_to_pg("eobj", pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        _, _, acting, primary = m.pg_to_up_acting_osds(raw)
        victim_shard = next(s for s in range(K)
                            if acting[s] != primary and acting[s] >= 0)
        st = c.osds[acting[victim_shard]].pgs[pg]
        st.shard.inject_read_err("eobj")
        degraded = io.read("eobj") == payload
        errors = []
        soid = next(o for o in st.shard.store.collection_list(st.shard.cid)
                    if o.name == "eobj")
        try:
            st.shard.store.read(st.shard.cid, soid)
        except Exception as ex:     # the injected EIO
            errors.append(type(ex).__name__)
        st.shard.clear_read_err("eobj")
        return {"degraded": degraded, "errors": errors,
                "healed": io.read("eobj") == payload,
                "shard": victim_shard}
    finally:
        cfg.set("objectstore_debug_inject_read_err", old)
        c.shutdown()


def test_shard_eio_read_reconstructs_like_the_reference():
    ref, port = eio_read("ref"), eio_read("port")
    assert port == ref
    assert port["degraded"] and port["healed"]
    assert port["errors"] == ["StoreError"]
