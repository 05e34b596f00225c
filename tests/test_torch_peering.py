"""Replicated-pool peering on the port's cluster, held to the reference's.

tests/test_peering.py's cases, each run on
`ceph_tpu.testing.MiniCluster(threaded=False)` and on
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` with
the same inputs, pumped and ticked on one simulated clock, and compared
at tolerance 0: the durable PG log reloaded from the store, the log trim
bounds, a divergent write rewound on revival, backfill reservations
throttled at `osd_max_backfills`, the mon's pg_temp plumbing, a pg_temp
override that heals itself in a live cluster, strays purged after a
remap, and a ranged PGScan window.  Strays are made both ways: by an
`osd out`, and as the reference's stray case makes them, by growing pg_num
and then pgp_num; the reference's split and reseed under client IO runs
here in pump mode, its writer stepping between the map changes.
"""
import numpy as np

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.osd import replicated_backend as ref_rb
from ceph_tpu.osd import types as ref_types
from ceph_tpu import store as ref_store
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.msg import messenger as port_messenger
from ceph_tpu_torch.osd import replicated_backend as port_rb
from ceph_tpu_torch.osd import types as port_types
from ceph_tpu_torch.osd.peering import CLEAN, PGPeering
from ceph_tpu_torch import store as port_store
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NS = {
    "ref": dict(cluster=lambda n: RefCluster(n_osd=n, threaded=False),
                config=ref_config, messages=ref_messages,
                messenger=ref_messenger, rb=ref_rb, types=ref_types,
                store=ref_store),
    "port": dict(cluster=lambda n: PortCluster(n_osd=n, threaded=False,
                                               device="cpu"),
                 config=port_config, messages=port_messages,
                 messenger=port_messenger, rb=port_rb, types=port_types,
                 store=port_store),
}
T0 = 1000.0


def make(kind, n, pool, pg_num):
    c = NS[kind]["cluster"](n)
    c.pump()
    c.wait_all_up()
    r = c.rados()
    r.pool_create(pool, pg_num=pg_num)
    c.pump()
    return c, r


class Clock:
    def __init__(self, c):
        self.c, self.now = c, T0

    def tick(self, n=1):
        for _ in range(n):
            self.now += 1.0
            self.c.tick(self.now)


def settled(c) -> bool:
    return all(d.pgs_recovering() == 0 for d in c.osds.values())


def settle(c, clock, io, objs, ticks=120) -> int:
    """Tick until no PG recovers and every object reads back; returns
    the ticks it took."""
    for i in range(ticks):
        clock.tick()
        if settled(c) and all(io.read(k) == v for k, v in objs.items()):
            return i
    raise AssertionError("cluster never settled")


def locate(c, r, pool, oid):
    pid = r.pool_lookup(pool)
    m = c.mon.osdmap
    raw = m.object_locator_to_pg(oid, pid)
    pg = m.pools[pid].raw_pg_to_pg(raw)
    _, _, acting, primary = m.pg_to_up_acting_osds(raw)
    return pid, pg, list(acting), primary


def entries(shard):
    return [(e.soid, str(e.version), str(e.prior_version))
            for e in shard.pg_log.log.entries]


def both(case):
    return case("ref"), case("port")


# ---------------------------------------------------------------- cases

def durable_log(kind):
    c, r = make(kind, 3, "pl", 4)
    try:
        io = r.open_ioctx("pl")
        for i in range(12):
            io.write_full(f"o{i}", b"v" * (100 + i))
        io.write_full("o0", b"rewritten")     # an entry with a prior
        c.pump()
        _pid, pg, acting, _ = locate(c, r, "pl", "o0")
        d = c.osds[acting[0]]
        live = d.pgs[pg].shard
        again = NS[kind]["rb"].ReplicatedPGShard(pg, d.store, create=False)
        return {"info": str(live.log_info()),
                "reloaded": str(again.log_info()),
                "entries": entries(live), "again": entries(again),
                "type": type(live).__module__}
    finally:
        c.shutdown()


def test_durable_pg_log_survives_restart():
    ref, port = both(durable_log)
    assert port.pop("type") == "ceph_tpu_torch.osd.replicated_backend"
    ref.pop("type")
    assert port == ref
    assert port["info"] == port["reloaded"] and port["entries"] == \
        port["again"] and port["entries"]
    zero = str(port_rb.ZERO_VERSION)
    assert any(s == "o0" and p != zero for s, _v, p in port["entries"])


def log_trim(kind):
    ns = NS[kind]
    g = ns["config"]()
    old = (g["osd_min_pg_log_entries"], g["osd_max_pg_log_entries"])
    g.set("osd_min_pg_log_entries", 10)
    g.set("osd_max_pg_log_entries", 20)
    try:
        st = ns["store"].MemStore()
        st.mkfs()
        st.mount()
        from importlib import import_module
        pgt = import_module(ns["rb"].__name__.rsplit(".", 1)[0] +
                            ".pg_types")
        shard = ns["rb"].ReplicatedPGShard(ns["types"].PG(0, 0), st)
        for i in range(1, 60):
            e = pgt.PGLogEntry(pgt.MODIFY, f"x{i % 7}", pgt.EVersion(1, i),
                               prior_version=pgt.ZERO_VERSION)
            shard.apply_mutations(f"x{i % 7}", [], pgt.EVersion(1, i), [e])
        again = ns["rb"].ReplicatedPGShard(ns["types"].PG(0, 0), st,
                                           create=False)
        return {"len": len(shard.pg_log.log), "info": str(shard.log_info()),
                "again": str(again.log_info()), "entries": entries(again)}
    finally:
        g.set("osd_min_pg_log_entries", old[0])
        g.set("osd_max_pg_log_entries", old[1])


def test_log_trim_bounds_length():
    ref, port = both(log_trim)
    assert port == ref
    assert port["len"] <= 20 and port["info"] == port["again"]


def divergent(kind):
    ns = NS[kind]
    c, r = make(kind, 3, "dv", 1)
    clock = Clock(c)
    try:
        io = r.open_ioctx("dv")
        io.write_full("obj", b"common history")
        _pid, pg, _acting, primary = locate(c, r, "dv", "obj")
        # cut the primary's replica fan-out: its next write applies ONLY
        # locally (a divergent entry is born)
        RepOpWrite = ns["messages"].RepOpWrite
        c.network.filter = lambda src, dst, msg: not (
            isinstance(msg, RepOpWrite) and src == f"osd.{primary}")
        fut = io.aio_write_full("obj", b"DIVERGENT")
        c.pump()
        local = c.osds[primary].pgs[pg].shard.read("obj")
        c.network.filter = None
        c.kill_osd(primary)
        r.mon_command({"prefix": "osd down", "ids": [primary]})
        c.pump()
        io.write_full("obj", b"new interval wins")
        clock.tick(3)
        c.revive_osd(primary)
        ticks = settle(c, clock, io, {"obj": b"new interval wins"})
        st = c.osds[primary].pgs[pg]
        return {"local": local, "divergent_result": fut.result,
                "revived": st.shard.read("obj"),
                "read": io.read("obj"), "log": entries(st.shard),
                "ticks": ticks, "phase": st.peering and st.peering.phase}
    finally:
        c.shutdown()


def test_divergent_log_rewound_on_revival():
    ref, port = both(divergent)
    assert port == ref
    assert port["local"] == b"DIVERGENT"
    assert port["revived"] == port["read"] == b"new interval wins"
    # a quirk of the reference, reproduced: the revived primary asks the
    # authority for the log since its own head, so the divergent entry
    # (2'2) stays in its log under the new interval's; the object itself
    # is pulled at the new version
    assert [v for s_, v, _p in port["log"]] == ["2'1", "2'2", "3'2", "3'3"]


def backfill_throttle(kind):
    g = NS[kind]["config"]()
    old = g["osd_max_backfills"]
    g.set("osd_max_backfills", 1)
    c, r = make(kind, 4, "bf", 16)
    clock = Clock(c)
    try:
        io = r.open_ioctx("bf")
        rng = np.random.default_rng(7)
        objs = {f"b{i}": rng.integers(0, 256, 512,
                                      dtype=np.uint8).tobytes()
                for i in range(64)}
        for k, v in objs.items():
            io.write_full(k, v)
        r.mon_command({"prefix": "osd out", "ids": [0]})
        c.pump()
        ticks = settle(c, clock, io, objs)
        peaks = {o: (d.bf_peak_local, d.bf_peak_remote)
                 for o, d in c.osds.items()}
        pushes = {o: d.perf.get("recovery_push")
                  for o, d in c.osds.items()}
        return {"peaks": peaks, "pushes": pushes, "ticks": ticks}
    finally:
        g.set("osd_max_backfills", old)
        c.shutdown()


def test_backfill_reservations_throttle():
    ref, port = both(backfill_throttle)
    assert port == ref
    assert all(lo <= 1 and rm <= 1 for lo, rm in port["peaks"].values())
    assert any(lo >= 1 for lo, _ in port["peaks"].values())
    assert any(rm >= 1 for _, rm in port["peaks"].values())


def pg_temp_plumbing(kind):
    """At a mon alone (no OSD daemons to heal the override), as the
    reference's case drives it."""
    ns = NS[kind]
    mm = ns["messages"]
    mon_mod = __import__(ns["rb"].__name__.split(".")[0] +
                         ".mon.monitor", fromlist=["Monitor"])
    m0, w = mon_mod.build_initial(4)
    kw = {"device": "cpu"} if kind == "port" else {}
    mon = mon_mod.Monitor(ns["messenger"].LocalNetwork(), initial_map=m0,
                          initial_wrapper=w, threaded=False, **kw)
    mon.init()
    try:
        for o in range(4):
            boot = mm.MOSDBoot(osd=o)
            boot.src = f"osd.{o}"
            mon.ms_dispatch(boot)
        cmd = mm.MMonCommand(tid=1, cmd={"prefix": "osd pool create",
                                         "pool": "pt", "pg_num": 4})
        cmd.src = "client.1"
        mon.ms_dispatch(cmd)
        pid = next(p for p, n in mon.osdmap.pool_names.items()
                   if n == "pt")
        pg = ns["types"].PG(pid, 0)
        out = {}

        def send(from_osd, osds):
            msg = mm.MOSDPGTemp(pgid=pg, from_osd=from_osd,
                                epoch=mon.osdmap.epoch, osds=osds)
            msg.src = f"osd.{from_osd}"
            mon.ms_dispatch(msg)

        e0 = mon.osdmap.epoch
        send(0, [2, 3])
        out["applied"] = (mon.osdmap.epoch > e0,
                          mon.osdmap.pg_temp.get(pg),
                          mon.osdmap.pg_to_up_acting_osds(pg)[2:])
        e1 = mon.osdmap.epoch
        send(0, [2, 3])
        out["idempotent"] = mon.osdmap.epoch == e1
        send(2, [])
        out["cleared"] = pg not in mon.osdmap.pg_temp
        return out
    finally:
        mon.shutdown()


def test_pg_temp_mon_plumbing():
    ref, port = both(pg_temp_plumbing)
    assert port == ref
    assert port["applied"] == (True, [2, 3], ([2, 3], 2))
    assert port["idempotent"] and port["cleared"]


def pg_temp_heals(kind):
    c, r = make(kind, 3, "pt", 1)
    clock = Clock(c)
    try:
        io = r.open_ioctx("pt")
        io.write_full("x", b"data")
        _pid, pg, acting, primary = locate(c, r, "pt", "x")
        other = next(o for o in acting if o != primary)
        e0 = c.mon.osdmap.epoch
        c.osds[primary].request_pg_temp(pg, [other, primary])
        c.pump()
        for _ in range(60):
            clock.tick()
            if c.mon.osdmap.epoch > e0 and pg not in c.mon.osdmap.pg_temp \
                    and settled(c):
                break
        incs = [c.mon.osdmon.get_incremental(e)
                for e in range(e0 + 1, c.mon.osdmap.epoch + 1)]
        applied = [e0 + 1 + i for i, inc in enumerate(incs)
                   if inc is not None and inc.new_pg_temp.get(pg)]
        cleared = [e0 + 1 + i for i, inc in enumerate(incs)
                   if inc is not None and pg in inc.new_pg_temp
                   and not inc.new_pg_temp[pg]]
        io.write_full("y", b"post-handback")
        return {"applied": applied, "cleared": cleared,
                "pg_temp": dict(c.mon.osdmap.pg_temp),
                "reads": (io.read("x"), io.read("y"))}
    finally:
        c.shutdown()


def test_pg_temp_self_heals_in_cluster():
    ref, port = both(pg_temp_heals)
    assert port == ref
    assert port["applied"] and port["cleared"] and not port["pg_temp"]
    assert port["reads"] == (b"data", b"post-handback")


def strays(kind):
    c, r = make(kind, 4, "stray", 4)
    clock = Clock(c)
    try:
        io = r.open_ioctx("stray")
        objs = {f"s{i}": bytes([i]) * 600 for i in range(16)}
        for k, v in objs.items():
            io.write_full(k, v)
        pid = r.pool_lookup("stray")
        before = {o: sorted(cid for cid in d.store.list_collections()
                            if cid.startswith(f"pg_{pid}."))
                  for o, d in c.osds.items()}
        r.mon_command({"prefix": "osd out", "ids": [1]})
        c.pump()
        settle(c, clock, io, objs)
        clean, ticks = False, 0
        while not clean and ticks < 60:
            clock.tick()
            ticks += 1
            clean = True
            for o, d in c.osds.items():
                m = d.osdmap
                for cid in d.store.list_collections():
                    if not cid.startswith(f"pg_{pid}.") or \
                            not d.store.collection_list(cid):
                        continue
                    ps = int(cid.split(".")[1], 16)
                    up, _, acting, _ = m.pg_to_up_acting_osds(
                        NS[kind]["types"].PG(pid, ps))
                    if o not in list(up) + list(acting):
                        clean = False
        after = {o: sorted(cid for cid in d.store.list_collections()
                           if cid.startswith(f"pg_{pid}."))
                 for o, d in c.osds.items()}
        return {"before": before, "after": after, "clean": clean,
                "reads": {k: io.read(k) for k in objs} == objs}
    finally:
        c.shutdown()


def test_stray_purged_after_remap():
    ref, port = both(strays)
    assert port == ref
    assert port["clean"] and port["reads"]
    assert port["before"][1] and not port["after"][1]


def strays_after_reseed(kind):
    """tests/test_peering.py's own stray case: the strays come from
    growing pg_num and then pgp_num (the interval moves wholesale)."""
    c, r = make(kind, 4, "stray", 2)
    clock = Clock(c)
    try:
        io = r.open_ioctx("stray")
        objs = {f"s{i}": bytes([i]) * 600 for i in range(16)}
        for k, v in objs.items():
            io.write_full(k, v)
        pid = r.pool_lookup("stray")
        before = {o: sorted(cid for cid in d.store.list_collections()
                            if cid.startswith(f"pg_{pid}."))
                  for o, d in c.osds.items()}
        out = {}
        for var in ("pg_num", "pgp_num"):
            rc, outs, _ = r.mon_command({"prefix": "osd pool set",
                                         "pool": "stray", "var": var,
                                         "val": "8"})
            assert rc == 0, outs
            c.pump()
            out[var] = settle(c, clock, io, objs)
        strays, ticks = None, 0
        while strays != [] and ticks < 60:
            clock.tick()
            ticks += 1
            strays = []
            for o, d in sorted(c.osds.items()):
                m = d.osdmap
                for cid in sorted(d.store.list_collections()):
                    if not cid.startswith(f"pg_{pid}.") or \
                            not d.store.collection_list(cid):
                        continue
                    ps = int(cid.split(".")[1], 16)
                    up, _, acting, _ = m.pg_to_up_acting_osds(
                        NS[kind]["types"].PG(pid, ps))
                    if o not in list(up) + list(acting):
                        strays.append((o, cid))
        after = {o: sorted(cid for cid in d.store.list_collections()
                           if cid.startswith(f"pg_{pid}."))
                 for o, d in c.osds.items()}
        pool = c.mon.osdmap.pools[pid]
        return {"before": before, "after": after, "strays": strays,
                "ticks": (out, ticks), "pool": (pool.pg_num, pool.pgp_num),
                "reads": {k: io.read(k) for k in objs} == objs}
    finally:
        c.shutdown()


def test_stray_purged_after_reseed():
    ref, port = both(strays_after_reseed)
    assert port == ref
    assert port["strays"] == [] and port["reads"]
    assert port["pool"] == (8, 8)
    assert sum(map(len, port["after"].values())) > \
        sum(map(len, port["before"].values()))


def split_under_io(kind):
    """tests/test_peering.py's split and reseed under client IO, in
    pump mode: a pool splits 4x while a writer keeps writing between
    the steps, pgp_num follows, and every object reads back with no
    pg_temp override left."""
    c, r = make(kind, 4, "live", 4)
    clock = Clock(c)
    try:
        io = r.open_ioctx("live")
        rng = np.random.default_rng(11)
        objs = {f"L{i}": rng.integers(0, 256, 1024,
                                      dtype=np.uint8).tobytes()
                for i in range(40)}
        for k, v in objs.items():
            io.write_full(k, v)
        step = [0]

        def write(n):
            for _ in range(n):
                i = step[0]
                k, v = f"W{i % 17}", (b"%06d" % i) * 20
                io.write_full(k, v)
                objs[k] = v
                step[0] += 1
                c.pump()
        rc = []
        for var in ("pg_num", "pgp_num"):
            write(6)
            rc.append(r.mon_command({"prefix": "osd pool set",
                                     "pool": "live", "var": var,
                                     "val": "16"})[0])
            write(6)
            clock.tick(2)
        ticks = settle(c, clock, io, objs)
        extra = 0
        while c.mon.osdmap.pg_temp and extra < 30:
            clock.tick()
            extra += 1
        pool = c.mon.osdmap.pools[r.pool_lookup("live")]
        return {"rc": rc, "ticks": (ticks, extra),
                "pool": (pool.pg_num, pool.pgp_num),
                "temp": sorted(str(k) for k in c.mon.osdmap.pg_temp),
                "reads": {k: io.read(k) for k in objs} == objs}
    finally:
        c.shutdown()


def test_split_and_reseed_under_client_io():
    ref, port = both(split_under_io)
    assert port == ref
    assert port["rc"] == [0, 0] and port["pool"] == (16, 16)
    assert port["temp"] == [] and port["reads"]


def ranged_scan(kind):
    ns = NS[kind]
    c, r = make(kind, 2, "rg", 1)
    try:
        io = r.open_ioctx("rg")
        for ch in "abcdefgh":
            io.write_full(ch, ch.encode() * 10)
        _pid, pg, acting, _ = locate(c, r, "rg", "a")
        got = []

        class Sink(ns["messenger"].Dispatcher):
            def ms_dispatch(self, msg):
                if isinstance(msg, ns["messages"].PGScanReply):
                    got.append(msg)
                return True

        ms = ns["messenger"].Messenger.create(c.network, "client.scanprobe",
                                              threaded=False)
        ms.add_dispatcher(Sink())
        ms.start()
        PGScan = ns["messages"].PGScan
        out = []
        for begin, end in (("b", "e"), ("f", ""), ("", "c")):
            ms.connect(f"osd.{acting[0]}").send_message(
                PGScan(pgid=pg, ec=False, ranged=True, begin=begin,
                       end=end))
            for _ in range(5):
                c.pump()
                ms.poll()
            rep = got.pop()
            out.append((sorted(rep.objects), rep.begin, rep.end,
                        rep.ranged))
        ms.shutdown()
        return out
    finally:
        c.shutdown()


def test_ranged_scan_window():
    ref, port = both(ranged_scan)
    assert port == ref
    assert port[0] == (["c", "d", "e"], "b", "e", True)
    assert port[1][0] == ["g", "h"]


def test_every_replicated_primary_runs_the_ported_statechart():
    c, r = make("port", 4, "sc", 8)
    try:
        prim = [st for d in c.osds.values() for st in d.pgs.values()
                if st.backend is not None]
        assert len(prim) == 8
        assert all(isinstance(st.peering, PGPeering) and
                   st.peering.phase == CLEAN for st in prim)
    finally:
        c.shutdown()


def test_dropped_pull_is_counted():
    """A pull that finds no view to push from is dropped, as in the
    reference (the puller's tick re-drives it), and counted in
    `recovery_push_errors`."""
    c, r = make("port", 3, "dp", 1)
    try:
        io = r.open_ioctx("dp")
        io.write_full("x", b"x")
        _pid, pg, acting, primary = locate(c, r, "dp", "x")
        holder = c.osds[acting[1]]

        def no_view(pg_):
            raise KeyError(pg_)
        holder._replicated_view = no_view
        pull = port_messages.PGPull(pgid=pg, oids=["x"])
        pull.src = f"osd.{primary}"
        holder.ms_dispatch(pull)
        assert holder.perf.get("recovery_push_errors") == 1
        assert holder.perf.get("recovery_push") == 0
    finally:
        c.shutdown()
