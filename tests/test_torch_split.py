"""PG split and the pgp_num reseed on the port's cluster, held to the
reference's.

Each case runs one seeded script on `ceph_tpu.testing.MiniCluster(
threaded=False)` and on `ceph_tpu_torch.testing.MiniCluster(device="cpu",
threaded=False)`, pumped and ticked on one simulated clock, and compares
at tolerance 0: the objects that read back after `osd pool set pg_num`
(every one, where the port before PG split lost 21 of 24), every OSD
store's contents with each child collection, its pgmeta log keys and
tail marker, the snap index after a split, every shard on its acting OSD
after the EC pgp_num reseed, EC growth under IO with an `osd out` and an
`osd in`, and a split on BlueStore whose files have the reference's
sha256.  Two cases are the port's own: its raw CRUSH caches (the
daemons' and the objecter's) give the map's own mappings
through a split, a reseed, out, in, a kill and an upmap, and keep a
pool's results while another pool is created, snapshotted and deleted.
"""
import dataclasses
import hashlib
import os

import numpy as np
import pytest

from ceph_tpu.osd.types import PG as RefPG
from ceph_tpu.store import BlueStore as RefBlueStore
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.osd.replicated_backend import _TAIL_KEY
from ceph_tpu_torch.osd.types import PG as PortPG
from ceph_tpu_torch.store import BlueStore as PortBlueStore
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NONE = 0x7FFFFFFF
PG = {"ref": RefPG, "port": PortPG}
BLUESTORE = {"ref": RefBlueStore, "port": PortBlueStore}
PROFILE = {"plugin": "tpu", "k": "2", "m": "2",
           "crush-failure-domain": "host"}
T0 = 1000.0


def cluster(kind: str, n: int):
    if kind == "ref":
        return RefCluster(n_osd=n, threaded=False)
    return PortCluster(n_osd=n, threaded=False, device="cpu")


def make(kind: str, n: int, pool: str, pg_num: int, erasure: bool,
         stores=None):
    c = cluster(kind, n)
    c.pump()
    if stores is not None:
        for osd in range(n):
            c.kill_osd(osd)
            c._stores[osd] = stores(osd)
            c.start_osd(osd)
        c.pump()
    c.wait_all_up()
    r = c.rados()
    if erasure:
        rc = r.mon_command({"prefix": "osd erasure-code-profile set",
                            "name": "k2m2", "profile": dict(PROFILE)})
        assert rc[0] == 0, rc
        r.pool_create(pool, pg_num=pg_num, pool_type="erasure",
                      erasure_code_profile="k2m2")
    else:
        r.pool_create(pool, pg_num=pg_num)
    c.pump()
    return c, r


def pool_set(r, pool: str, var: str, val: int) -> None:
    rc, outs, _ = r.mon_command({"prefix": "osd pool set", "pool": pool,
                                 "var": var, "val": str(val)})
    assert rc == 0, outs


def tick(c, now: float, n: int) -> float:
    for _ in range(n):
        now += 1.0
        c.pump()
        c.tick(now)
    return now


def wait_clean(c, rounds: int = 120) -> None:
    for _ in range(rounds):
        c.pump()
        if all(d.pgs_recovering() == 0 for d in c.osds.values()):
            return
    raise TimeoutError("peering never went clean")


def payloads(n: int, seed: int, base: int = 700) -> dict:
    rng = np.random.default_rng(seed)
    return {f"o{i:03d}": rng.integers(0, 256, base + 37 * i,
                                      dtype=np.uint8).tobytes()
            for i in range(n)}


def unreadable(io, objs: dict) -> list:
    bad = []
    for k, v in objs.items():
        try:
            if io.read(k) != v:
                bad.append(k)
        except Exception:           # ENOENT from a lost object
            bad.append(k)
    return bad


def plain(v):
    """A value both packages can compare: structs by type name and
    fields, containers element by element."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple(plain(getattr(v, f.name))
                      for f in dataclasses.fields(v)))
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x) for x in v)
    return v


def stores(c) -> dict:
    """Every OSD store's objects: data, xattrs and omap, by collection."""
    out = {}
    for osd, st in sorted(c._stores.items()):
        objs = {}
        for cid in st.list_collections():
            for o in st.collection_list(cid):
                objs[(cid, o.name, o.snap, o.shard)] = (
                    st.read(cid, o), plain(st.getattrs(cid, o)),
                    st.omap_get(cid, o))
        out[osd] = objs
    return out


def children(c, pid: int) -> dict:
    """Per OSD and collection of the pool: the object names, the pgmeta
    log keys and whether the tail marker is there."""
    out = {}
    for osd, st in sorted(c._stores.items()):
        for cid in sorted(st.list_collections()):
            if not cid.startswith(f"pg_{pid}."):
                continue
            names = sorted((o.name, o.shard) for o in
                           st.collection_list(cid) if o.name != "pgmeta")
            meta = [o for o in st.collection_list(cid)
                    if o.name == "pgmeta"]
            omap = st.omap_get(cid, meta[0]) if meta else {}
            out[(osd, cid)] = (names,
                               sorted(k for k in omap if k.startswith("l.")),
                               _TAIL_KEY in omap)
    return out


def shards_on_acting(kind: str, c, r, pool: str, objs: dict) -> list:
    """(oid, shard, osd, present) for every acting shard of every object
    under the current map."""
    pid = r.pool_lookup(pool)
    m = c.mon.osdmap
    out = []
    for oid in sorted(objs):
        raw = m.object_locator_to_pg(oid, pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        _, _, acting, _ = m.pg_to_up_acting_osds(raw)
        for s, osd in enumerate(acting):
            if osd < 0 or osd >= NONE:
                continue
            st = c.osds[osd].pgs.get(pg)
            have = st is not None and any(
                o.name == oid and o.shard == s
                for o in st.shard.store.collection_list(st.shard.cid))
            out.append((oid, s, osd, have))
    return out


def both(case, *args):
    return case("ref", *args), case("port", *args)


# ---------------------------------------------------------------- cases

def grow_pg_num(kind):
    """The regression: 24 objects of 700 B in a replicated pool of
    pg_num 4, then pg_num 16 and five pump + tick rounds."""
    c, r = make(kind, 4, "sp", 4, erasure=False)
    try:
        io = r.open_ioctx("sp")
        objs = {f"o{i}": bytes([i]) * 700 for i in range(24)}
        for k, v in objs.items():
            io.write_full(k, v)
        pool_set(r, "sp", "pg_num", 16)
        tick(c, T0, 5)
        return {"lost": unreadable(io, objs),
                "pg_num": c.mon.osdmap.pools[r.pool_lookup("sp")].pg_num}
    finally:
        c.shutdown()


def test_pg_num_growth_loses_no_object():
    ref, port = both(grow_pg_num)
    assert port == ref
    assert port == {"lost": [], "pg_num": 16}


def split_children(kind, erasure):
    c, r = make(kind, 5, "gp", 4, erasure=erasure)
    try:
        io = r.open_ioctx("gp")
        objs = payloads(32, seed=13)
        for k, v in objs.items():
            io.write_full(k, v)
        io.write_full("o000", b"rewritten")     # a log entry with a prior
        objs["o000"] = b"rewritten"
        c.pump()
        pid = r.pool_lookup("gp")
        before = children(c, pid)
        pool_set(r, "gp", "pg_num", 16)
        wait_clean(c)
        return {"before": before, "after": children(c, pid),
                "stores": stores(c), "lost": unreadable(io, objs)}
    finally:
        c.shutdown()


@pytest.mark.parametrize("erasure", [False, True],
                         ids=["replicated", "erasure"])
def test_split_children_equal_the_reference(erasure):
    ref, port = both(split_children, erasure)
    assert port["lost"] == ref["lost"] == []
    assert port["before"] == ref["before"]
    assert port["after"] == ref["after"]
    assert port["stores"] == ref["stores"]
    # the split really made children: more collections, each child that
    # took objects carries log entries or at least the parent's tail
    assert len(port["after"]) > len(port["before"])
    grown = [v for (osd, cid), v in port["after"].items()
             if int(cid.split(".")[1], 16) >= 4 and v[0]]
    assert grown and all(tail for _names, _keys, tail in grown)
    assert any(keys for _names, keys, _tail in grown)


def split_snaps(kind):
    from ceph_tpu.osd.snap_mapper import SnapMapper as RefSM
    from ceph_tpu_torch.osd.snap_mapper import SnapMapper as PortSM
    sm = RefSM if kind == "ref" else PortSM
    c, r = make(kind, 3, "gp2", 4, erasure=False)
    try:
        io = r.open_ioctx("gp2")
        for i in range(16):
            io.write_full(f"s{i}", bytes([i + 1]) * 1024)
        c.pump()
        rc = r.mon_command({"prefix": "osd pool mksnap", "pool": "gp2",
                            "snap": "s1"})
        assert rc[0] == 0, rc
        c.pump()
        for i in range(16):
            io.write_full(f"s{i}", b"m" * 1024)
        c.pump()

        def index():
            out = {}
            for osd, d in sorted(c.osds.items()):
                for cid in sorted(d.store.list_collections()):
                    if cid.startswith("pg_"):
                        out[(osd, cid)] = [
                            (e["snap"], e["clone"], e["oid"], e["covers"])
                            for e in sm(d.store, cid).dump()]
            return out
        before = index()
        pool_set(r, "gp2", "pg_num", 8)
        c.pump()
        return {"before": before, "after": index(), "stores": stores(c)}
    finally:
        c.shutdown()


def test_snap_index_follows_the_split():
    ref, port = both(split_snaps)
    assert port == ref
    distinct = {(s, cl, o) for entries in port["after"].values()
                for s, cl, o, _cov in entries}
    assert len(distinct) == 16
    assert any(int(cid.split(".")[1], 16) >= 4 and entries
               for (_osd, cid), entries in port["after"].items())


def ec_reseed(kind):
    c, r = make(kind, 7, "ec", 4, erasure=True)
    try:
        io = r.open_ioctx("ec")
        objs = payloads(32, seed=9, base=2000)
        for k, v in objs.items():
            io.write_full(k, v)
        c.pump()
        pool_set(r, "ec", "pg_num", 8)
        wait_clean(c)
        pool_set(r, "ec", "pgp_num", 8)
        wait_clean(c)
        pid = r.pool_lookup("ec")
        pool = c.mon.osdmap.pools[pid]
        return {"lost": unreadable(io, objs),
                "pool": (pool.pg_num, pool.pgp_num),
                "shards": shards_on_acting(kind, c, r, "ec", objs),
                "stores": stores(c),
                "temp": sorted(str(k) for k in c.mon.osdmap.pg_temp)}
    finally:
        c.shutdown()


def test_ec_pgp_num_reseed_puts_every_shard_on_its_acting_osd():
    ref, port = both(ec_reseed)
    assert port["pool"] == ref["pool"] == (8, 8)
    assert port["lost"] == ref["lost"] == []
    assert port["shards"] == ref["shards"]
    assert all(have for *_x, have in port["shards"])
    assert port["temp"] == ref["temp"]
    assert port["stores"] == ref["stores"]


def ec_growth_under_io(kind):
    """tests/test_ec_peering.py's growth under IO: pg_num and pgp_num
    grow while writes go on and osd.2 goes out and back in."""
    c, r = make(kind, 7, "ec", 4, erasure=True)
    try:
        io = r.open_ioctx("ec")
        objs = payloads(16, seed=3, base=2000)
        for k, v in objs.items():
            io.write_full(k, v)
        c.pump()
        pool_set(r, "ec", "pg_num", 8)
        c.pump()
        pool_set(r, "ec", "pgp_num", 8)
        rng = np.random.default_rng(21)
        retried = []
        for i in range(8):
            data = rng.integers(0, 256, 1500 + i, dtype=np.uint8).tobytes()
            objs[f"live{i}"] = data
            try:
                io.write_full(f"live{i}", data)
            except Exception:       # ESTALE-parked in a peering window
                retried.append(i)
                wait_clean(c)
                io.write_full(f"live{i}", data)
            c.pump()
            if i == 3:
                r.mon_command({"prefix": "osd out", "ids": [2]})
            if i == 6:
                r.mon_command({"prefix": "osd in", "ids": [2]})
        wait_clean(c, rounds=180)
        return {"lost": unreadable(io, objs), "retried": retried,
                "shards": shards_on_acting(kind, c, r, "ec", objs),
                "stores": stores(c)}
    finally:
        c.shutdown()


def test_ec_growth_under_io_with_out_and_in():
    ref, port = both(ec_growth_under_io)
    assert port["lost"] == ref["lost"] == []
    assert port["retried"] == ref["retried"]
    assert port["shards"] == ref["shards"]
    assert port["stores"] == ref["stores"]


def tree(path) -> dict:
    """sha256 of every file under `path`, by relative name."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def bluestore_split(kind, root):
    def mount(osd):
        st = BLUESTORE[kind](str(root / f"osd{osd}"), min_alloc=512)
        st.mkfs()
        st.mount()
        return st
    c, r = make(kind, 3, "bs", 2, erasure=False, stores=mount)
    try:
        io = r.open_ioctx("bs")
        objs = payloads(12, seed=5, base=900)
        for k, v in objs.items():
            io.write_full(k, v)
        c.pump()
        pool_set(r, "bs", "pg_num", 8)
        c.pump()
        lost = unreadable(io, objs)
        pid = r.pool_lookup("bs")
        return {"lost": lost, "children": children(c, pid)}
    finally:
        c.shutdown()


def test_split_on_bluestore_files_equal_the_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = bluestore_split("ref", tmp_path / "ref")
    port = bluestore_split("port", tmp_path / "port")
    assert port == ref
    assert port["lost"] == []
    assert any(int(cid.split(".")[1], 16) >= 2 and names
               for (_osd, cid), (names, _k, _t) in port["children"].items())
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")


def test_cached_mapping_equals_the_map():
    """The daemon keeps raw CRUSH results across epochs that leave the
    CRUSH inputs alone; through a split, a reseed, an out, an in, a kill
    and an upmap every cached mapping equals the map's own."""
    c, r = make("port", 6, "ec", 4, erasure=True)
    try:
        pid = r.pool_lookup("ec")
        hits = []

        def check():
            for d in c.osds.values():
                m = d.osdmap
                for ps in range(m.pools[pid].pg_num):
                    pg = PortPG(pid, ps)
                    assert d._pg_mapping(pg) == m.pg_to_up_acting_osds(pg)
                hits.append(len(d._raw))
        check()
        for var in ("pg_num", "pgp_num"):
            pool_set(r, "ec", var, 8)
            wait_clean(c)
            check()
        up = c.mon.osdmap.pg_to_up_acting_osds(PortPG(pid, 0))[0]
        spare = next(o for o in range(6) if o not in up)
        for cmd in ({"prefix": "osd out", "ids": [1]},
                    {"prefix": "osd in", "ids": [1]},
                    {"prefix": "osd pg-upmap-items", "pgid": f"{pid}.0",
                     "id_pairs": [[up[0], spare]]}):
            assert r.mon_command(cmd)[0] == 0, cmd
            wait_clean(c)
            check()
        c.kill_osd(2)
        r.mon_command({"prefix": "osd down", "ids": [2]})
        wait_clean(c)
        check()
        assert min(hits) > 0
    finally:
        c.shutdown()


def test_cached_mapping_is_kept_per_pool_and_the_objecter_agrees():
    """The daemons' and the objecter's raw CRUSH results are kept per
    pool: another pool created, given a self-managed snap and deleted
    keeps the EC pool's cached results, an `osd out` drops them; every
    cached mapping and every op target equals the map's own."""
    c, r = make("port", 6, "ec", 4, erasure=True)
    try:
        pid = r.pool_lookup("ec")
        io = r.open_ioctx("ec")
        objs = payloads(8, seed=9)
        ob = r.objecter

        def check():
            for d in c.osds.values():
                m = d.osdmap
                for ps in range(m.pools[pid].pg_num):
                    pg = PortPG(pid, ps)
                    assert d._pg_mapping(pg) == m.pg_to_up_acting_osds(pg)
            with ob._lock:
                for oid in objs:
                    raw = ob.osdmap.object_locator_to_pg(oid, pid)
                    assert ob._pg_mapping(raw) == \
                        ob.osdmap.pg_to_up_acting_osds(raw)
            for oid, data in objs.items():
                assert io.read(oid) == data

        def caches():
            out = {d.whoami: d._raw.for_pool(d.osdmap, pid)
                   for d in c.osds.values()}
            with ob._lock:
                out["client"] = ob._raw.for_pool(ob.osdmap, pid)
            return out
        for oid, data in objs.items():
            io.write_full(oid, data)
        check()
        kept = caches()
        assert all(kept.values())
        r.pool_create("rp", pg_num=4)
        wait_clean(c)
        r.open_ioctx("rp").selfmanaged_snap_create()
        wait_clean(c)
        assert r.mon_command({"prefix": "osd pool delete", "pool": "rp",
                              "yes_i_really_really_mean_it": True})[0] == 0
        wait_clean(c)
        check()
        assert all(caches()[k] is kept[k] for k in kept)
        assert r.mon_command({"prefix": "osd out", "ids": [1]})[0] == 0
        wait_clean(c)
        assert not any(caches()[k] is kept[k] for k in kept)
        check()
    finally:
        c.shutdown()
