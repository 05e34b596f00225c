"""Watch/notify and the heartbeat mute hook on the port's cluster, held
to the reference's.

Every case of tests/test_watch_notify.py runs on one module-wide
`ceph_tpu.testing.MiniCluster(threaded=False)` and one
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` (4
OSDs, a replicated pool `wp` and a `tpu` k=2 m=1 pool `wep`, pg_num 8
each), and what the clients saw must be equal at tolerance 0: the
ENOENT of a watch on a missing object, a notify with no watchers, a
round trip between two clients (the callback's payload and notifier,
the replies by cookie), a dead watcher reported in the timeouts, and a
watch that follows its object to a new primary after `osd out`.  One
more case notifies a watcher of an EC-pool object, which the reference
does not refuse.  Last, the case of tests/test_heartbeat.py that mutes
one OSD's ping replies: its peers report it and the mon marks it down.
"""
import time

import pytest

from ceph_tpu.client import RadosError as RefRadosError
from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.client import RadosError as PortRadosError
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.testing import MiniCluster as PortCluster

ERRORS = (RefRadosError, PortRadosError)
KINDS = ("ref", "port")


def make_cluster(kind, n_osd):
    c = RefCluster(n_osd=n_osd, threaded=False) if kind == "ref" else \
        PortCluster(n_osd=n_osd, threaded=False, device="cpu")
    c.pump()
    c.wait_all_up()
    return c


class Side:
    """One package's cluster, client and simulated clock."""

    def __init__(self, kind):
        self.kind = kind
        self.c = make_cluster(kind, 4)
        self.r = self.c.rados()
        self.r.pool_create("wp", pg_num=8)
        self.r.mon_command({"prefix": "osd erasure-code-profile set",
                            "name": "k2m1",
                            "profile": {"plugin": "tpu", "k": "2",
                                        "m": "1",
                                        "crush-failure-domain": "osd"}})
        self.r.pool_create("wep", pg_num=8, pool_type="erasure",
                           erasure_code_profile="k2m1")
        self.c.pump()
        self.now = 1000.0

    def tick(self, n=1):
        for _ in range(n):
            self.now += 1.0
            self.c.tick(self.now)


@pytest.fixture(scope="module")
def sides():
    out = {kind: Side(kind) for kind in KINDS}
    yield out
    for s in out.values():
        s.c.shutdown()


def attempt(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ERRORS as e:
        return ("err", e.errno_name)


def named(obj, names: dict):
    """`obj` with each client name replaced by its role (client ids
    come from a process-wide counter, so they depend on what ran
    before in the process)."""
    if isinstance(obj, str):
        for name, role in names.items():
            obj = obj.replace(name, role)
        return obj
    if isinstance(obj, dict):
        return {named(k, names): named(v, names) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(named(v, names) for v in obj)
    return obj


def run_both(sides, case, *args):
    got = {kind: case(side, *args) for kind, side in sides.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def test_watch_missing_object(sides):
    got = run_both(sides, lambda s: attempt(
        s.r.open_ioctx("wp").watch, "ghost", lambda *a: None,
        cookie="c-ghost"))
    assert got == ("err", "ENOENT")


def test_notify_no_watchers(sides):
    def case(side):
        io = side.r.open_ioctx("wp")
        io.write_full("lonely", b"x")
        return io.notify("lonely", payload={"ping": 1})
    assert run_both(sides, case) == ({}, [])


def c_roundtrip(side, pool):
    io = side.r.open_ioctx(pool)
    oid = f"obj-{pool}"
    io.write_full(oid, b"watched")
    r2 = side.c.rados()
    io2 = r2.open_ioctx(pool)
    got = []

    def cb(notify_id, notifier, payload):
        got.append((notifier, payload))
        return {"seen": payload["n"] + 1}

    cookie = io2.watch(oid, cb, cookie=f"w-{pool}")
    try:
        first = io.notify(oid, payload={"n": 41})
        own = io2.notify(oid, payload={"n": 1})
    finally:
        io2.unwatch(oid, cookie)
        r2.shutdown()
    after = io.notify(oid, payload={"n": 0})
    return named((side.r.objecter.name, r2.objecter.name, first, own, got,
                  after), {side.r.objecter.name: "notifier",
                           r2.objecter.name: "watcher"})


def test_notify_roundtrip_two_clients(sides):
    me, other, first, own, got, after = run_both(sides, c_roundtrip, "wp")
    replies, timeouts = first
    assert timeouts == [] and list(replies.values()) == [{"seen": 42}]
    assert me == "notifier" and got[0] == (me, {"n": 41})
    assert list(own[0].values()) == [{"seen": 2}]
    assert after == ({}, [])


def test_notify_on_an_ec_pool_object(sides):
    """Watch/notify is not refused on an EC pool: the watch lives on the
    primary of the object's PG, as on a replicated pool."""
    me, other, first, own, got, after = run_both(sides, c_roundtrip, "wep")
    assert first == ({f"{other}/w-wep": {"seen": 42}}, [])
    assert got[0] == (me, {"n": 41}) and after == ({}, [])


def test_notify_timeout_on_dead_watcher(sides):
    def case(side):
        io = side.r.open_ioctx("wp")
        io.write_full("tobj", b"x")
        r2 = side.c.rados()
        cookie = r2.open_ioctx("wp").watch("tobj", lambda *a: None,
                                           cookie="w-dead")
        # hard-kill the watcher client (no unwatch)
        r2.shutdown()
        return cookie, named(io.notify("tobj", payload=1, timeout=3.0),
                             {r2.objecter.name: "watcher"})
    cookie, (replies, timeouts) = run_both(sides, case)
    assert replies == {}
    assert len(timeouts) == 1 and cookie in timeouts[0]


def c_primary_move(side):
    io = side.r.open_ioctx("wp")
    io.write_full("mobj", b"x")
    r2 = side.c.rados()
    io2 = r2.open_ioctx("wp")
    got = []
    cookie = io2.watch("mobj", lambda nid, who, p: got.append(p) or "ok",
                       cookie="w-move")
    try:
        pid = side.r.pool_lookup("wp")
        m = side.r.objecter.osdmap
        raw = m.object_locator_to_pg("mobj", pid)
        primary = m.pg_to_up_acting_osds(raw)[3]
        e0 = m.epoch
        side.r.mon_command({"prefix": "osd out", "ids": [primary]})
        side.r.objecter.wait_for_map(e0 + 1)
        r2.objecter.wait_for_map(e0 + 1)
        primary2 = side.r.objecter.osdmap.pg_to_up_acting_osds(raw)[3]
        # the re-registration may park behind the new primary's peering
        # and go out again on the objecter's rescan timer (host clock)
        replies = {}
        deadline = time.monotonic() + 60.0
        while not replies and time.monotonic() < deadline:
            side.tick()
            replies, _ = io.notify("mobj", payload="moved", timeout=2.0)
            if not replies:
                time.sleep(0.05)
    finally:
        io2.unwatch("mobj", cookie)
        r2.shutdown()
        side.r.mon_command({"prefix": "osd in", "ids": [primary]})
        for _ in range(60):
            side.tick()
            if all(d.pgs_recovering() == 0
                   for d in side.c.osds.values()):
                break
    return primary, primary2, named(replies,
                                    {r2.objecter.name: "watcher"}), got


def test_watch_survives_primary_move(sides):
    primary, primary2, replies, got = run_both(sides, c_primary_move)
    assert primary2 != primary
    assert list(replies.values()) == ["ok"] and "moved" in got


# ------------------------------------------------- the heartbeat mute

def c_mute(kind):
    c = make_cluster(kind, 4)
    try:
        r = c.rados()
        r.pool_create("p", pg_num=16)
        c.pump()
        grace = {"ref": ref_config, "port": port_config}[kind]()[
            "osd_heartbeat_grace"]
        victim = 2
        c.osds[victim].inject_heartbeat_mute = True
        now = 1000.0
        c.tick(now)
        c.tick(now + grace / 2)
        up_mid = c.mon.osdmap.is_up(victim)
        e0 = c.mon.osdmap.epoch
        c.tick(now + grace + 1)
        # the first epoch after the silence: the port's OSD, alive, boots
        # again on the map that shows it down (Ceph's "wrongly marked me
        # down"), so the mon's current map may already be a later one
        m = c.mon.osdmon.get_full_map(e0 + 1)
        return (grace, up_mid, m.is_down(victim),
                [m.is_up(o) for o in range(4) if o != victim],
                victim in c.mon._failure_reports)
    finally:
        c.shutdown()


def test_mute_osd_reported_and_marked_down():
    got = {kind: c_mute(kind) for kind in KINDS}
    assert got["port"] == got["ref"]
    _, up_mid, down, others, self_report = got["port"]
    assert up_mid and down and all(others) and not self_report


def c_same_primary_interval(kind):
    c = make_cluster(kind, 5)
    try:
        r = c.rados()
        r.pool_create("wp", pg_num=8)
        c.pump()
        io = r.open_ioctx("wp")
        io.write_full("sobj", b"x")
        r2 = c.rados()
        r2.open_ioctx("wp").watch("sobj", lambda nid, who, p: "ok",
                                  cookie="w-same")
        pid = r.pool_lookup("wp")
        m = r.objecter.osdmap
        raw = m.object_locator_to_pg("sobj", pid)
        _, _, acting, primary = m.pg_to_up_acting_osds(raw)
        other = next(o for o in acting if o != primary)
        e0 = m.epoch
        r.mon_command({"prefix": "osd out", "ids": [other]})
        r.objecter.wait_for_map(e0 + 1)
        now = 1000.0
        for _ in range(20):
            now += 1.0
            c.tick(now)
        _, _, acting2, primary2 = \
            r.objecter.osdmap.pg_to_up_acting_osds(raw)
        replies = named(io.notify("sobj", payload="p", timeout=1.0),
                        {r2.objecter.name: "watcher"})
        r2.shutdown()
        return acting, primary, acting2, primary2, replies
    finally:
        c.shutdown()


def test_watch_kept_across_an_interval_under_the_same_primary():
    """The port's one rule that differs here: a new interval that keeps
    the PG's primary (a replica marked out) keeps the primary's watches.
    The reference builds a fresh PG state with no watchers, and its
    client re-registers only when the primary moves, so its watch is
    lost and the notify finds nobody; the port's notify reaches the
    watcher (Ceph's objecter resends linger ops on every interval
    change; the port keeps them on the primary instead)."""
    ref = c_same_primary_interval("ref")
    port = c_same_primary_interval("port")
    assert port[:4] == ref[:4]
    acting, primary, acting2, primary2, _ = port
    assert primary2 == primary and acting2 != acting
    assert ref[4] == ({}, [])
    assert port[4] == ({"watcher/w-same": "ok"}, [])
