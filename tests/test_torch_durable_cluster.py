"""The port's cluster on durable stores, held to the reference's step by
step.

The same scenario runs on `ceph_tpu.testing.MiniCluster(threaded=False)`
and on `ceph_tpu_torch.testing.MiniCluster(device="cpu",
threaded=False)`, each OSD on a `BlueStore` of its own package in a
directory of its own (set through the `_stores` slot before any pool
exists, as the reference's tests/test_journaled_store.py does).  Both
get the same profile, pool, seeded payloads and simulated clock.  The
scenario writes every object, kills the OSD in the most acting sets and
marks it down (not out, so it comes back into the same acting sets),
writes more objects while it is down, then starts it again on a
BlueStore freshly mounted on its directory (what a SIGKILL and a restart
leave), and waits until every PG is clean.  The restarted OSD answers
peering from its durable shard log, and only the writes it missed are
rebuilt.  After each step the test compares, at tolerance 0: the
reads, the map epoch, every PG's up and acting sets, every primary's
acting set and peering phase, every OSD store's contents and the
recovery counters.  The port takes no full rebuild, and recovery reads k
bytes for each byte it rebuilds.

Then a shard of one object is bitrotted on a stopped OSD's BlueStore
(`corrupt_blob_bytes`), the OSD is started again, and the object reads
back right in both packages: the checksum turns the rot into EIO and the
primary decodes around it.
"""
import numpy as np
import pytest

from ceph_tpu.osd.types import PG as RefPG
from ceph_tpu.store import BlueStore as RefBlueStore
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.osd.ec_backend import pg_cid
from ceph_tpu_torch.osd.peering import CLEAN
from ceph_tpu_torch.osd.types import PG as PortPG
from ceph_tpu_torch.store import BlueStore as PortBlueStore
from ceph_tpu_torch.store import ObjectId
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NONE = 0x7FFFFFFF
PG = {"ref": RefPG, "port": PortPG}
BLUESTORE = {"ref": RefBlueStore, "port": PortBlueStore}
N_OSD = 7
PG_NUM = 8
PROFILE = {"plugin": "tpu", "k": "2", "m": "2",
           "crush-failure-domain": "host"}
K = 2
COUNTERS = ("op_w", "op_r", "subop_w", "recovery_pull",
            "recovery_bytes_read", "recovery_bytes_rebuilt")


def mount(kind: str, path) -> object:
    st = BLUESTORE[kind](str(path), min_alloc=512)
    st.mkfs()
    st.mount()
    return st


def make(kind: str, root):
    if kind == "ref":
        c = RefCluster(n_osd=N_OSD, threaded=False)
    else:
        c = PortCluster(n_osd=N_OSD, threaded=False, device="cpu")
    c.pump()
    for osd in range(N_OSD):
        c.kill_osd(osd)
        c._stores[osd] = mount(kind, root / f"osd{osd}")
        c.start_osd(osd)
    c.pump()
    c.wait_all_up()
    r = c.rados()
    rc = r.mon_command({"prefix": "osd erasure-code-profile set",
                        "name": "ecp", "profile": dict(PROFILE)})
    assert rc[0] == 0, rc
    r.pool_create("ec", pg_num=PG_NUM, pool_type="erasure",
                  erasure_code_profile="ecp")
    c.pump()
    return c, r


def payloads(first: int, count: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"obj{i:03d}": rng.integers(0, 256, 1500 + 53 * i,
                                       dtype=np.uint8).tobytes()
            for i in range(first, first + count)}


def wait_clean(c, rounds: int = 80) -> None:
    for _ in range(rounds):
        c.pump()
        if all(d.pgs_recovering() == 0 for d in c.osds.values()):
            return
    raise TimeoutError("EC peering never went clean")


def snapshot(kind: str, c, r, objs: dict) -> dict:
    io = r.open_ioctx("ec")
    reads = {oid: io.read(oid) for oid in objs}
    m = c.mon.osdmap
    pid = r.pool_lookup("ec")
    pgs = {}
    for ps in range(m.pools[pid].pg_num):
        up, up_p, acting, acting_p = m.pg_to_up_acting_osds(
            PG[kind](pid, ps))
        pgs[ps] = (list(up), up_p, list(acting), acting_p)
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
    return {"reads": reads, "epoch": m.epoch, "pgs": pgs,
            "primaries": primaries, "stores": stores,
            "counters": counters}


def victim_of(kind: str, c, r) -> int:
    m = c.mon.osdmap
    pid = r.pool_lookup("ec")
    count: dict[int, int] = {}
    for ps in range(m.pools[pid].pg_num):
        _, _, acting, _ = m.pg_to_up_acting_osds(PG[kind](pid, ps))
        for o in acting:
            if 0 <= o < NONE:
                count[o] = count.get(o, 0) + 1
    return max(sorted(count), key=lambda o: count[o])


def scenario(kind: str, root) -> tuple[list, dict]:
    c, r = make(kind, root)
    try:
        objs = payloads(0, 12, seed=21)
        steps = []
        c.tick(1000.0)
        io = r.open_ioctx("ec")
        for oid, data in objs.items():
            io.write_full(oid, data)
        c.pump()
        steps.append(("written", snapshot(kind, c, r, objs)))
        victim = victim_of(kind, c, r)
        c.kill_osd(victim)                   # no umount: a SIGKILL
        rc = r.mon_command({"prefix": "osd down", "ids": [victim]})
        assert rc[0] == 0, rc
        c.pump()
        missed = payloads(12, 8, seed=22)
        for oid, data in missed.items():
            io.write_full(oid, data)
        objs.update(missed)
        c.pump()
        steps.append(("degraded", snapshot(kind, c, r, objs)))
        c._stores[victim] = mount(kind, root / f"osd{victim}")
        c.revive_osd(victim)
        c.tick(1001.0)
        wait_clean(c)
        steps.append(("clean", snapshot(kind, c, r, objs)))
        steps.append(("victim", victim))
        if kind == "port":
            steps.append(("full_rebuilds", sum(
                d.perf.get("recovery_full_rebuild")
                for d in c.osds.values())))
        return steps, objs
    finally:
        c.shutdown()


def test_kill_and_restart_on_bluestore_equals_reference(tmp_path):
    ref, objs = scenario("ref", tmp_path / "ref")
    port, _ = scenario("port", tmp_path / "port")
    assert [s for s, _ in port] == [s for s, _ in ref] + ["full_rebuilds"]
    for (step, want), (_, got) in zip(ref, port):
        if step == "victim":
            assert got == want
            continue
        assert got["reads"] == {k: objs[k] for k in got["reads"]}, step
        for key in ("reads", "epoch", "pgs", "primaries", "counters",
                    "stores"):
            assert got[key] == want[key], (step, key)
    steps = dict(port)
    clean = steps["clean"]
    assert all(ph == CLEAN for _, _, ph in clean["primaries"].values())
    assert steps["full_rebuilds"] == 0
    # the restarted OSD gained a shard of some of the objects written
    # while it was down, and recovery rebuilt exactly those shards,
    # reading k bytes for each byte it rebuilt
    victim = steps["victim"]
    new = set(clean["stores"][victim]) - set(steps["degraded"]["stores"][victim])
    missed = {key for key in new if key[1] != "pgmeta"}
    assert missed and {key[1] for key in missed} <= set(objs) - set(
        steps["written"]["reads"])
    read = sum(c["recovery_bytes_read"] for c in clean["counters"].values())
    rebuilt = sum(c["recovery_bytes_rebuilt"]
                  for c in clean["counters"].values())
    assert rebuilt == sum(len(clean["stores"][victim][key][0])
                          for key in missed)
    assert read == K * rebuilt
    assert sum(c["recovery_bytes_rebuilt"]
               for c in steps["degraded"]["counters"].values()) == 0


def bitrot(kind: str, root) -> tuple[bytes, int, list]:
    """Write, stop one acting OSD of the object cleanly, rot its shard's
    stored bytes, start it again and read the object."""
    c, r = make(kind, root)
    try:
        io = r.open_ioctx("ec")
        data = payloads(0, 1, seed=5)["obj000"] * 3
        io.write_full("rotten", data)
        c.pump()
        m = c.mon.osdmap
        pid = r.pool_lookup("ec")
        pg = m.pools[pid].raw_pg_to_pg(
            m.object_locator_to_pg("rotten", pid))
        _, _, acting, primary = m.pg_to_up_acting_osds(pg)
        # a data shard that is not the primary's: the read needs it
        shard = next(s for s in range(K) if acting[s] != primary)
        victim = acting[shard]
        c.kill_osd(victim)
        c._stores[victim].umount()
        st = mount(kind, root / f"osd{victim}")
        oid = ObjectId("rotten", -2, shard) if kind == "port" else \
            type(st.collection_list(pg_cid(pg))[0])("rotten", -2, shard)
        st.corrupt_blob_bytes(pg_cid(pg), oid)
        fsck = st.fsck()
        c._stores[victim] = st
        c.revive_osd(victim)
        c.pump()
        got = io.read("rotten")
        return got == data, st.media_errors["csum_errors"], fsck
    finally:
        c.shutdown()


def test_bitrotted_shard_is_decoded_around(tmp_path):
    ref = bitrot("ref", tmp_path / "ref")
    port = bitrot("port", tmp_path / "port")
    assert port == ref
    ok, csum_errors, fsck = port
    assert ok and csum_errors >= 1
    assert len(fsck) == 1 and "csum mismatch" in fsck[0]
