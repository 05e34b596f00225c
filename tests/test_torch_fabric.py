"""The port's ICIFabric in the reference's OSD data plane.

tests/test_fabric.py's five cases with `ceph_tpu_torch.dist.ICIFabric`
over ["cpu"] * 8 handed to the reference's MiniCluster: EC-pool writes
whose chunk distribution rides the port's mesh step (K1's plain version
per position, the partials XORed), with host messages as the control
plane (ref: the per-shard fan-out this replaces,
src/osd/ECBackend.cc:2037-2070).  The fabric reads the reference's
plugin only through the plugin interface and `encode_matrix`.
"""
import numpy as np
import pytest

from ceph_tpu.testing import MiniCluster
from ceph_tpu_torch.dist import ICIFabric


@pytest.fixture(scope="module")
def fabric_cluster():
    c = MiniCluster(n_osd=6, threaded=False,
                    fabric=ICIFabric(devices=["cpu"] * 8))
    c.pump()
    c.wait_all_up()
    r = c.rados()
    r.mon_command({"prefix": "osd erasure-code-profile set",
                   "name": "k2m2",
                   "profile": {"plugin": "tpu", "k": "2", "m": "2",
                               "crush-failure-domain": "host"}})
    r.pool_create("ec", pg_num=8, pool_type="erasure",
                  erasure_code_profile="k2m2")
    c.pump()
    yield c, r
    c.shutdown()


def locate(c, r, pool, oid):
    pid = r.pool_lookup(pool)
    m = c.mon.osdmap
    pg = m.pools[pid].raw_pg_to_pg(m.object_locator_to_pg(oid, pid))
    up, up_p, acting, acting_p = m.pg_to_up_acting_osds(pg)
    return pid, pg, acting, acting_p


def test_ec_write_rides_the_mesh(fabric_cluster):
    c, r = fabric_cluster
    io = r.open_ioctx("ec")
    rng = np.random.default_rng(3)
    objs = {f"f{i}": rng.integers(0, 256, 20000 + 17 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(6)}
    before = c.fabric.stats["staged"]
    for oid, data in objs.items():
        io.write_full(oid, data)
    c.pump()
    # the writes ran the mesh fan-out, not the host encode
    assert c.fabric.stats["staged"] >= before + len(objs)
    assert c.fabric.stats["fetched"] >= 4 * len(objs)  # k+m per write
    # staging buffers are released once every shard committed
    assert c.fabric.staged_count() == 0
    for oid, data in objs.items():
        assert io.read(oid) == data


def test_fabric_chunks_match_host_encode(fabric_cluster):
    """Byte parity: each shard's stored chunk stream must equal what
    the reference's host encode path would have produced (the port's
    mesh step is an identical computation, not an alternative
    format)."""
    from ceph_tpu.osd import ecutil
    from ceph_tpu.osd.ec_backend import pg_cid
    from ceph_tpu.store import ObjectId
    c, r = fabric_cluster
    io = r.open_ioctx("ec")
    payload = bytes(range(256)) * 64          # 16 KiB deterministic
    io.write_full("parity_probe", payload)
    c.pump()
    pid, pg, acting, primary = locate(c, r, "ec", "parity_probe")
    backend = c.osds[primary].pgs[pg].backend
    sinfo = backend.sinfo
    padded = payload + b"\0" * (-len(payload) % sinfo.stripe_width)
    want = ecutil.encode(sinfo, backend.ec, padded)
    for s, osd in enumerate(acting):
        if osd < 0:
            continue
        store = c.osds[osd].store
        got = store.read(pg_cid(pg), ObjectId("parity_probe", shard=s),
                         0, 0)
        assert got == want[s], f"shard {s} chunk stream differs"


def test_fabric_append_keeps_hinfo_and_scrub_clean(fabric_cluster):
    c, r = fabric_cluster
    io = r.open_ioctx("ec")
    sinfo = None
    io.write_full("appender", b"")
    # stripe-aligned appends keep the cumulative per-shard crc valid
    pid, pg, acting, primary = locate(c, r, "ec", "appender")
    sinfo = c.osds[primary].pgs[pg].backend.sinfo
    chunk = b"A" * sinfo.stripe_width
    for i in range(3):
        io.append("appender", chunk)
    c.pump()
    assert io.read("appender") == chunk * 3
    res = r.pg_scrub(pid, pg.ps)
    assert res["inconsistent"] == []


def test_fabric_degraded_read(fabric_cluster):
    """Chunks distributed by the mesh decode correctly when a shard
    holder dies — proof the XOR combine placed real, correct parity."""
    c, r = fabric_cluster
    io = r.open_ioctx("ec")
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
    io.write_full("degraded", data)
    c.pump()
    pid, pg, acting, primary = locate(c, r, "ec", "degraded")
    victim = next(o for o in acting if o >= 0 and o != primary)
    c.kill_osd(victim)
    # reads reconstruct from survivors (client retries on reset)
    assert io.read("degraded") == data
    c.revive_osd(victim)
    c.pump()
    c.wait_all_up()


def test_non_resident_acting_falls_back(fabric_cluster):
    """An acting set with a non-resident OSD must use the host path —
    the fabric is an accelerator, not a correctness dependency."""
    c, r = fabric_cluster
    fab = c.fabric
    # simulate one acting OSD not being co-resident
    osd = next(iter(c.osds))
    fab.resident.discard(osd)
    try:
        io = r.open_ioctx("ec")
        staged_before = fab.stats["staged"]
        data = b"host-path" * 1000
        # find an object whose acting set includes the non-resident osd
        for i in range(40):
            oid = f"fb{i}"
            _pid, _pg, acting, _p = locate(c, r, "ec", oid)
            if osd in acting:
                io.write_full(oid, data)
                c.pump()
                assert io.read(oid) == data
                break
        else:
            pytest.skip("no pg maps onto the non-resident osd")
        # that write did not stage on the mesh
        assert fab.stats["staged"] == staged_before
    finally:
        fab.register_resident(osd)
