"""The snap trimmer on the port's cluster, held to the reference's.

Every case of tests/test_snaptrim.py runs the same seeded steps on a
`ceph_tpu.testing.MiniCluster(threaded=False)` and on a
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)`, with
the same sim-clock ticks, and the port's record must equal the
reference's at tolerance 0: store bytes before and after the trim,
every OSD's snap index (the crash-resume cursor) and purged snaps, the
PG states the trimmer reports (snaptrim, snaptrim_wait), the `df`
gauges, the progress module's trim event, the SnapTrim messages a
promoted primary sends after the old one dies, the index carried
through a PG split, a replica that slept through the round and trims
its leftovers on revival, and a whole-cluster restart that resumes from
the durable index.  The observability case scrapes the pool gauges
(`ceph_pool_snaptrim_pgs`, `ceph_pool_store_bytes`, `ceph_pool_bytes`)
from each package's prometheus exporter over HTTP mid-trim.
"""
import random
import urllib.request

import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.mgr.progress import ProgressModule as RefProgress
from ceph_tpu.mgr.prometheus import PrometheusExporter as RefExporter
from ceph_tpu.msg.messages import SnapTrim as RefSnapTrim
from ceph_tpu.msg.messages import SnapTrimReply as RefSnapTrimReply
from ceph_tpu.osd.snap_mapper import IntervalSet as RefIntervalSet
from ceph_tpu.osd.snap_mapper import SnapMapper as RefSnapMapper
from ceph_tpu.osd.types import PG as RefPG
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu.testing import OSDThrasher as RefThrasher
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.mgr.progress import ProgressModule as PortProgress
from ceph_tpu_torch.mgr.prometheus import PrometheusExporter as PortExporter
from ceph_tpu_torch.msg.messages import SnapTrim as PortSnapTrim
from ceph_tpu_torch.msg.messages import SnapTrimReply as PortSnapTrimReply
from ceph_tpu_torch.osd.snap_mapper import IntervalSet as PortIntervalSet
from ceph_tpu_torch.osd.snap_mapper import SnapMapper as PortSnapMapper
from ceph_tpu_torch.osd.types import PG as PortPG
from ceph_tpu_torch.testing import MiniCluster as PortCluster
from ceph_tpu_torch.testing import OSDThrasher as PortThrasher

PKG = {"ref": {"cluster": RefCluster, "config": ref_config,
               "SnapMapper": RefSnapMapper, "SnapTrim": RefSnapTrim,
               "SnapTrimReply": RefSnapTrimReply, "PG": RefPG,
               "Thrasher": RefThrasher, "Progress": RefProgress,
               "Exporter": RefExporter},
       "port": {"cluster": PortCluster, "config": port_config,
                "SnapMapper": PortSnapMapper, "SnapTrim": PortSnapTrim,
                "SnapTrimReply": PortSnapTrimReply, "PG": PortPG,
                "Thrasher": PortThrasher, "Progress": PortProgress,
                "Exporter": PortExporter}}
KINDS = ("ref", "port")


def make_cluster(kind, n_osd):
    cls = PKG[kind]["cluster"]
    c = cls(n_osd=n_osd, threaded=False) if kind == "ref" else \
        cls(n_osd=n_osd, threaded=False, device="cpu")
    c.pump()
    c.wait_all_up()
    return c


def store_bytes(cluster) -> int:
    return sum(cluster.osds[o].store.statfs()["used"]
               for o in cluster.osds)


def index_dump(kind, cluster) -> dict:
    """Every live OSD's snap index and purged snaps, by PG collection."""
    out = {}
    for o, d in sorted(cluster.osds.items()):
        for cid in sorted(d.store.list_collections()):
            if cid.startswith("pg_"):
                sm = PKG[kind]["SnapMapper"](d.store, cid)
                out[f"osd.{o}/{cid}"] = (sm.dump(),
                                         sm.purged_snaps().to_list())
    return out


def index_entries(kind, cluster) -> int:
    return sum(len(idx) for idx, _ in index_dump(kind, cluster).values())


def tick_rounds(cluster, start: float, rounds: int,
                step: float = 11.0) -> float:
    now = start
    for _ in range(rounds):
        now += step
        cluster.tick(now)
        cluster.pump()
    return now


def trim_states(cluster) -> list:
    return sorted((d.name, str(pg), st.snaptrim)
                  for d in cluster.osds.values()
                  for pg, st in d.pgs.items() if st.snaptrim is not None)


def both(case):
    got = {kind: case(kind) for kind in KINDS}
    assert got["port"] == got["ref"]
    return got["port"]


@pytest.fixture()
def options():
    """Set an option in both packages' global config; restore after."""
    saved = []

    def set_both(name, value):
        for kind in KINDS:
            cfg = PKG[kind]["config"]()
            saved.append((cfg, name, cfg[name]))
            cfg.set(name, value)
    yield set_both
    for cfg, name, value in reversed(saved):
        cfg.set(name, value)


# ------------------------------------------------------------ unit-ish
@pytest.mark.parametrize("kind", KINDS)
def test_interval_set_coalesces(kind):
    cls = {"ref": RefIntervalSet, "port": PortIntervalSet}[kind]
    s = cls()
    for x in (3, 1, 2, 7, 5):
        s.add(x)
    assert s.to_list() == [[1, 3], [5, 5], [7, 7]]
    assert 2 in s and 5 in s and 4 not in s
    s.add(6)
    assert s.to_list() == [[1, 3], [5, 7]]
    s.add(6)
    assert s.to_list() == [[1, 3], [5, 7]]


# ------------------------------------------------------- reclaim + IO
def c_reclaims_store_bytes_under_io(kind):
    c = make_cluster(kind, 4)
    try:
        r = c.rados()
        r.pool_create("sp", pg_num=8)
        c.pump()
        io = r.open_ioctx("sp")
        objs = {f"o{i}": bytes([i + 1]) * 4096 for i in range(12)}
        for oid, data in objs.items():
            io.write_full(oid, data)
        c.pump()
        base = store_bytes(c)
        io.snap_create("s1")
        sid = io.snap_lookup("s1")
        for oid in objs:
            io.write_full(oid, b"x" * 4096)
        io.remove("o11")
        c.pump()
        cow = (store_bytes(c), index_dump(kind, c),
               io.read("o0", snapid=sid))
        io.snap_remove("s1")
        c.pump()
        rng = random.Random(4)
        now = 10_000.0
        seen = []
        for _ in range(10):
            io.write_full(f"o{rng.randrange(11)}", b"y" * 4096)
            now = tick_rounds(c, now, 1)
            seen.append(trim_states(c))
        now = tick_rounds(c, now, 8)
        gone = sorted(
            (d.name, cid) for d in c.osds.values()
            for cid in d.store.list_collections() if cid.startswith("pg_")
            for o in d.store.collection_list(cid) if o.name == "o11")
        pid = r.pool_lookup("sp")
        purged = sorted(
            (d.name, str(pg), sid in st.shard.purged_snaps())
            for d in c.osds.values() for pg, st in d.pgs.items()
            if pg.pool == pid and hasattr(st.shard, "snap_mapper"))
        return (base, cow, seen, store_bytes(c), index_dump(kind, c),
                gone, purged, io.read("o0"), io.list_snaps("o0"),
                trim_states(c))
    finally:
        c.shutdown()


def test_snap_delete_reclaims_store_bytes_under_io():
    (base, (cow_bytes, cow_idx, at_snap), seen, after, idx, gone, purged,
     head, ls, states) = both(c_reclaims_store_bytes_under_io)
    assert cow_bytes > base, "COW clones must occupy bytes"
    assert any(entries for entries, _ in cow_idx.values())
    assert at_snap == bytes([1]) * 4096
    assert not any(entries for entries, _ in idx.values())
    assert after <= base, (base, after)
    assert gone == []
    assert purged and all(ok for *_, ok in purged)
    assert head in (bytes([1]) * 4096, b"x" * 4096, b"y" * 4096)
    assert ls["clones"] == {} and states == []


def c_reservation_gating(kind):
    c = make_cluster(kind, 3)
    try:
        r = c.rados()
        r.pool_create("gp", pg_num=8)
        c.pump()
        io = r.open_ioctx("gp")
        for i in range(16):
            io.write_full(f"g{i}", bytes([i + 1]) * 2048)
        c.pump()
        io.snap_create("s1")
        for i in range(16):
            io.write_full(f"g{i}", b"z" * 2048)
        c.pump()
        io.snap_remove("s1")
        c.pump()
        waited, rounds = 0, []
        now = 10_000.0
        for _ in range(14):
            now = tick_rounds(c, now, 1)
            states = trim_states(c)
            rounds.append(states)
            waited += sum(1 for *_, st in states if st == "wait")
            if index_entries(kind, c) == 0:
                break
        return waited, rounds, index_dump(kind, c)
    finally:
        c.shutdown()


def test_trim_reservation_gating_waits_past_cap(options):
    options("osd_max_trimming_pgs", 1)
    waited, _, idx = both(c_reservation_gating)
    assert not any(entries for entries, _ in idx.values())
    assert waited > 0, "cap=1 must queue at least one PG"


def c_observability(kind):
    P = PKG[kind]
    c = make_cluster(kind, 3)
    try:
        r = c.rados()
        r.pool_create("op", pg_num=8)
        c.pump()
        io = r.open_ioctx("op")
        for i in range(12):
            io.write_full(f"v{i}", bytes([i + 1]) * 2048)
        c.pump()
        io.snap_create("s1")
        for i in range(12):
            io.write_full(f"v{i}", b"n" * 2048)
        c.pump()
        # stall trim mid-round so the snaptrim state persists across
        # the stat report
        c.network.filter = lambda s, d, m: \
            not isinstance(m, P["SnapTrimReply"])
        io.snap_remove("s1")
        c.pump()
        now = tick_rounds(c, 10_000.0, 2)
        rc, _, status = c.mon.handle_command({"prefix": "status"})
        states = status["pgmap"]["pgs_by_state"]
        _, _, df = c.mon.handle_command({"prefix": "df"})
        pool_df = dict(df["pools"]["op"])
        exp = P["Exporter"](c.mon.handle_command)
        exp.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.port}/metrics",
                    timeout=30) as resp:
                text = resp.read().decode()
        finally:
            exp.shutdown()
        gauges = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                  for ln in text.splitlines()
                  if ln.startswith("ceph_pool_") and '{pool="op"}' in ln}

        class Mgr:
            mon_command = staticmethod(c.mon.handle_command)
        prog = P["Progress"](Mgr())
        opened = prog.tick()
        open_msgs = sorted(e["message"] for e in prog.ls())
        c.network.filter = None
        now = tick_rounds(c, now, 8)
        _, _, df2 = c.mon.handle_command({"prefix": "df"})
        pool_df2 = dict(df2["pools"]["op"])
        prog.tick()
        return (rc, states, pool_df, opened, open_msgs,
                index_entries(kind, c), pool_df2,
                sorted(e["message"] for e in prog.ls()),
                sorted(e["message"] for e in prog.history()), gauges)
    finally:
        c.shutdown()


def test_snaptrim_observability_status_df_progress():
    (rc, states, pool_df, opened, open_msgs, left, pool_df2, still,
     hist, gauges) = both(c_observability)
    assert gauges['ceph_pool_snaptrim_pgs{pool="op"}'] > 0
    assert gauges['ceph_pool_store_bytes{pool="op"}'] > \
        gauges['ceph_pool_bytes{pool="op"}']
    assert rc == 0 and any("snaptrim" in s for s in states), states
    assert pool_df["snaptrim_pgs"] > 0, pool_df
    assert pool_df["store_bytes"] > pool_df["bytes"], pool_df
    assert opened > 0 and any("snaptrim" in m for m in open_msgs)
    assert left == 0
    assert pool_df2["snaptrim_pgs"] == 0
    assert pool_df2["store_bytes"] <= pool_df["bytes"] + 1
    assert not any("snaptrim" in m for m in still)
    assert any("snaptrim" in m for m in hist)


# ------------------------------------------------- crash-safe resume
def c_primary_kill(kind):
    P = PKG[kind]
    c = make_cluster(kind, 5)
    try:
        r = c.rados()
        r.pool_create("kp", pg_num=4)
        c.pump()
        io = r.open_ioctx("kp")
        objs = {f"k{i}": bytes([i + 1]) * 2048 for i in range(16)}
        for oid, data in objs.items():
            io.write_full(oid, data)
        c.pump()
        io.snap_create("s1")
        sid = io.snap_lookup("s1")
        for oid in objs:
            io.write_full(oid, b"y" * 2048)
        c.pump()
        pid = r.pool_lookup("kp")
        m = c.mon.osdmap
        target_pg = primary = acting_set = None
        for ps in range(4):
            pg = P["PG"](pid, ps)
            _, _, acting, ap = m.pg_to_up_acting_osds(pg)
            st = c.osds[ap].pgs.get(pg)
            if st is not None and sum(
                    1 for o in objs if st.shard.clone_tags(o)) >= 3:
                target_pg, primary = pg, ap
                acting_set = [o for o in acting if o >= 0]
                break
        assert target_pg is not None, "no PG collected enough clones"
        # stall the round mid-flight: drop trim acks so the primary
        # holds in-flight work when it dies
        c.network.filter = lambda s, d, msg: \
            not isinstance(msg, P["SnapTrimReply"])
        io.snap_remove("s1")
        c.pump()
        now = tick_rounds(c, 10_000.0, 1)
        survivor = next(o for o in acting_set if o != primary)
        remaining_at_kill = sorted(
            (e["oid"], e["clone"])
            for e in P["SnapMapper"](c.osds[survivor].store,
                                     f"pg_{target_pg}").dump())
        c.network.filter = None
        post_kill: list = []

        def counter(src, dst, msg):
            if isinstance(msg, P["SnapTrim"]) and msg.pgid == target_pg:
                post_kill.append((msg.oid, msg.clone))
            return True
        c.network.filter = counter
        t = P["Thrasher"](c, seed=3, min_in=3, min_live=3)
        t.kill_osd(primary)
        t.now = now + 100
        now = tick_rounds(c, t.now, 12)
        c.network.filter = None
        after = {o: (P["SnapMapper"](c.osds[o].store,
                                     f"pg_{target_pg}").dump(),
                     sid in P["SnapMapper"](c.osds[o].store,
                                            f"pg_{target_pg}")
                     .purged_snaps())
                 for o in acting_set if o != primary}
        head = io.read("k0")
        t.revive_osd(primary)
        tick_rounds(c, now + 50, 2)
        return (str(target_pg), primary, remaining_at_kill, post_kill,
                after, head)
    finally:
        c.shutdown()


def test_primary_kill_mid_trim_resumes_from_cursor(options):
    options("osd_pg_max_concurrent_snap_trims", 1)
    _, _, remaining, post_kill, after, head = both(c_primary_kill)
    assert remaining, "round completed before the kill"
    for entries, purged in after.values():
        assert entries == [] and purged
    assert set(post_kill) <= set(remaining)
    assert head == b"y" * 2048


def c_split(kind):
    c = make_cluster(kind, 3)
    try:
        r = c.rados()
        r.pool_create("gp2", pg_num=4)
        c.pump()
        io = r.open_ioctx("gp2")
        for i in range(16):
            io.write_full(f"s{i}", bytes([i + 1]) * 1024)
        c.pump()
        io.snap_create("s1")
        for i in range(16):
            io.write_full(f"s{i}", b"m" * 1024)
        c.pump()
        before = index_entries(kind, c)
        for var in ("pg_num", "pgp_num"):
            rc, outs, _ = r.mon_command({"prefix": "osd pool set",
                                         "pool": "gp2", "var": var,
                                         "val": "8"})
            assert rc == 0, outs
        c.pump()
        now = tick_rounds(c, 10_000.0, 3)
        distinct = sorted({(e["snap"], e["clone"], e["oid"])
                           for idx, _ in index_dump(kind, c).values()
                           for e in idx})
        io.snap_remove("s1")
        c.pump()
        tick_rounds(c, now, 10)
        reads = [(io.read(f"s{i}"), io.list_snaps(f"s{i}")["clones"])
                 for i in range(16)]
        return before, distinct, index_entries(kind, c), reads
    finally:
        c.shutdown()


def test_snap_index_follows_pg_split_and_trims():
    before, distinct, left, reads = both(c_split)
    assert before > 0 and len(distinct) == 16 and left == 0
    assert reads == [(b"m" * 1024, {})] * 16


def c_replica_down(kind):
    P = PKG[kind]
    c = make_cluster(kind, 4)
    try:
        r = c.rados()
        r.pool_create("dp", pg_num=4)
        c.pump()
        io = r.open_ioctx("dp")
        for i in range(12):
            io.write_full(f"d{i}", bytes([i + 1]) * 2048)
        c.pump()
        io.snap_create("s1")
        for i in range(12):
            io.write_full(f"d{i}", b"z" * 2048)
        c.pump()
        pid = r.pool_lookup("dp")
        m = c.mon.osdmap
        victim = None
        for ps in range(4):
            pg = P["PG"](pid, ps)
            _, _, acting, ap = m.pg_to_up_acting_osds(pg)
            st = c.osds[ap].pgs.get(pg)
            if st is not None and any(st.shard.clone_tags(f"d{i}")
                                      for i in range(12)):
                victim = next(o for o in acting if o >= 0 and o != ap)
                break
        assert victim is not None
        c.kill_osd(victim)
        c.mon.handle_command({"prefix": "osd down", "ids": [victim]})
        c.pump()
        io.snap_remove("s1")
        c.pump()
        now = tick_rounds(c, 10_000.0, 8)
        live = index_entries(kind, c)
        stale = sorted(
            (cid, e["oid"], e["clone"])
            for cid in c._stores[victim].list_collections()
            if cid.startswith("pg_")
            for e in P["SnapMapper"](c._stores[victim], cid).dump())
        c.revive_osd(victim)
        c.pump()
        tick_rounds(c, now, 8)
        d = c.osds[victim]
        clones_left = sorted(
            (cid, o.name, o.snap) for cid in d.store.list_collections()
            if cid.startswith("pg_")
            for o in d.store.collection_list(cid)
            if o.name != "pgmeta" and o.snap != -2)
        return victim, live, stale, index_dump(kind, c), clones_left
    finally:
        c.shutdown()


def test_replica_down_for_whole_trim_round_reconciles_on_revival():
    _, live, stale, idx, clones_left = both(c_replica_down)
    assert live == 0
    assert stale, "victim should hold stale index entries"
    assert not any(entries for entries, _ in idx.values())
    assert clones_left == []


def c_restart(kind):
    c = make_cluster(kind, 3)
    try:
        r = c.rados()
        r.pool_create("rp", pg_num=4)
        c.pump()
        io = r.open_ioctx("rp")
        for i in range(8):
            io.write_full(f"r{i}", bytes([i + 1]) * 1024)
        c.pump()
        io.snap_create("s1")
        sid = io.snap_lookup("s1")
        for i in range(8):
            io.write_full(f"r{i}", b"w" * 1024)
        c.pump()
        io.snap_remove("s1")
        c.pump()
        before = index_dump(kind, c)
        for o in sorted(c.osds):
            c.kill_osd(o)
        for o in sorted(c._stores):
            c.start_osd(o)
        c.pump()
        c.wait_all_up()
        tick_rounds(c, 20_000.0, 10)
        try:
            io.read("r0", snapid=sid)
            snap_read = "ok"
        except Exception as e:
            snap_read = getattr(e, "errno_name", type(e).__name__)
        return before, index_dump(kind, c), io.read("r0"), snap_read
    finally:
        c.shutdown()


def test_osd_restart_resumes_trim_from_durable_state():
    before, after, head, snap_read = both(c_restart)
    assert any(entries for entries, _ in before.values())
    assert not any(entries for entries, _ in after.values())
    assert head == b"w" * 1024 and snap_read != "ok"
