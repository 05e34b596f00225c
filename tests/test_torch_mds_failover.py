"""The port's MDS standby and failover (the mon's MDSMonitor, the FSMap,
`MDSStandby`, the MiniCluster MDS helpers and `MDSThrasher`) held to the
reference's at tolerance 0.

Every case of tests/test_mds_failover.py runs on each package (the
harness of tests/test_torch_cephfs.py) on a threaded 3-OSD cluster of its
own, with `mds_beacon_interval` 0.2 and `mds_beacon_grace` 1.0 in the
package's own config, and with the reference's assertions.  Takeovers
are driven on the mon's sim clock by `MDSThrasher.tick_grace` /
`wait_takeover` (only forward jumps).  The sides must agree on the
replies, both pools (the journal, the completed-request tables, every
dirfrag and data object) and the fsmap by rank, daemon name and state
(gids are pid-scoped and differ).  The TCP case runs each package's mon,
OSDs, MDS and standbys on sockets and compares what the client read.

Where the reference's schedule races, the port's case waits on state:
the standby's registration waits for the fsmap to list it, and the
in-flight create waits for the dentry to land before the kill (both as
the reference's do); ROADMAP.md Queue 3 names the races.
"""
import importlib
import json
import threading
import time

import pytest

from test_torch_cephfs import bare_sides, fs_state, fsmap_view  # noqa: F401
from test_torch_tcp import deadline  # noqa: F401  (per-test timeout)

FAST = {"mds_beacon_interval": 0.2, "mds_beacon_grace": 1.0}


@pytest.fixture()
def sides(bare_sides):  # noqa: F811
    saved = {}
    for s in bare_sides.values():
        cfg = s.p.options.global_config()
        saved[s.kind] = {k: cfg[k] for k in FAST}
        for k, v in FAST.items():
            cfg.set(k, v)
    yield bare_sides
    for s in bare_sides.values():
        cfg = s.p.options.global_config()
        for k, v in saved[s.kind].items():
            cfg.set(k, v)


def run_both(sides, case):
    """`case(side, cluster)` on each side's own 3-OSD cluster; the
    record, the replies, the fsmap view and both pools must be equal."""
    got = {}
    for kind, s in sides.items():
        start = len(s.log)
        c = s.cluster(n_osd=3)
        rec = case(s, c)
        got[kind] = {"rec": s.norm(rec), "replies": s.norm(s.log[start:]),
                     "fsmap": fsmap_view(c.fsmap()),
                     "state": fs_state(s, c.rados())}
    for key in got["ref"]:
        assert got["port"][key] == got["ref"][key], key
    return got["port"]


def c_fsmap_registration_and_status(s, c):
    c.start_mds(0)
    c.start_mds_standby()
    c.wait_mds_active(0)
    m = c.fsmap()
    assert m.ranks[0].state == "active"
    assert m.ranks[0].gid
    end = time.monotonic() + 10
    while time.monotonic() < end and not c.fsmap().standbys:
        time.sleep(0.05)
    assert c.fsmap().standbys
    r, outs, outb = c.mon.handle_command({"prefix": "fs status"})
    assert r == 0
    assert outb["ranks"]["0" if "0" in outb["ranks"] else 0][
        "state"] == "active"
    assert len(outb["standbys"]) == 1
    return [r, outs.split(":", 1)[1],
            {k: [v["name"], v["state"]] for k, v in outb["ranks"].items()},
            [sb["name"] for sb in outb["standbys"]]]


def test_fsmap_registration_and_status(sides):
    run_both(sides, c_fsmap_registration_and_status)


def c_kill_active_rank_promotes_standby(s, c):
    c.start_mds(0)
    c.start_mds_standby()
    c.wait_mds_active(0)
    fs = s.new_fs(c)
    fs.mkdirs("/d/deep")
    for i in range(12):
        fs.write_file(f"/d/deep/f{i}", f"payload-{i}".encode())
    old_gid = c.fsmap().ranks[0].gid
    th = s.p.MDSThrasher(c)
    th.kill_rank(0)
    th.wait_takeover(0, timeout_rounds=40)
    assert c.fsmap().ranks[0].gid != old_gid
    for i in range(12):
        assert fs.read_file(f"/d/deep/f{i}") == f"payload-{i}".encode()
    fs.write_file("/d/after", b"post-takeover")
    assert fs.read_file("/d/after") == b"post-takeover"
    assert fs.wait_rank_active(0, timeout=10)
    return th.log


def test_kill_active_rank_promotes_standby(sides):
    run_both(sides, c_kill_active_rank_promotes_standby)


def c_inflight_op_replayed_exactly_once(s, c):
    c.start_mds(0)
    c.start_mds_standby()
    c.wait_mds_active(0)
    fs = s.new_fs(c)
    fs.mkdirs("/base")
    MClientReply = s.p.messages.MClientReply
    c.network.filter = lambda src, dst, msg: not (
        src == "mds.0" and isinstance(msg, MClientReply))
    result, errors = [], []

    def worker():
        try:
            result.append(fs._session.call(
                "mkdir", {"path": "/base/dropped"}, timeout=60.0))
        except Exception as ex:      # noqa: BLE001
            errors.append(ex)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    meta = c.rados().open_ioctx("cephfs_metadata")
    end = time.monotonic() + 15
    landed = False
    while time.monotonic() < end and not landed:
        vals, _ = meta.get_omap_vals("dir.1")
        if "base" in vals:
            base = json.loads(vals["base"])
            sub, _ = meta.get_omap_vals(f"dir.{base['ino']:x}")
            landed = "dropped" in sub
        if not landed:
            time.sleep(0.05)
    assert landed
    th = s.p.MDSThrasher(c)
    th.kill_rank(0)
    c.network.filter = None
    th.wait_takeover(0, timeout_rounds=40)
    t.join(timeout=60)
    assert not t.is_alive(), "replayed op never completed"
    assert not errors, errors
    assert result and result[0]["type"] == "d"
    assert fs.listdir("/base") == ["dropped"]
    return result


def test_inflight_op_replayed_exactly_once(sides):
    run_both(sides, c_inflight_op_replayed_exactly_once)


def c_client_cap_recovery_after_reconnect(s, c):
    CAP_EXCL = s.p.mds.CAP_EXCL
    c.start_mds(0)
    c.start_mds_standby()
    c.wait_mds_active(0)
    fs = s.new_fs(c)
    fh = fs.open("/capfile", "w")
    assert fh.caps & CAP_EXCL
    fh.write(0, b"A" * 2048)
    th = s.p.MDSThrasher(c)
    th.kill_rank(0)
    th.wait_takeover(0, timeout_rounds=40)
    end = time.monotonic() + 20
    while time.monotonic() < end and not fh.caps & CAP_EXCL:
        time.sleep(0.05)
    assert fh.caps & CAP_EXCL, "caps never recovered after failover"
    fh.write(2048, b"B" * 100)
    fh.close()
    assert fs.read_file("/capfile") == b"A" * 2048 + b"B" * 100
    return fh.caps


def test_client_cap_recovery_after_reconnect(sides):
    run_both(sides, c_client_cap_recovery_after_reconnect)


def c_multi_mds_rank_failover_under_pins(s, c):
    c.start_mds(0)
    c.start_mds(1)
    c.start_mds_standby()
    c.wait_mds_active(0)
    c.wait_mds_active(1)
    fs = s.new_fs(c)
    fs.mkdirs("/t0")
    fs.mkdirs("/t1")
    fs.set_pin("/t1", 1)
    fs.write_file("/t0/a", b"rank0")
    fs.write_file("/t1/a", b"rank1")
    gid0 = c.fsmap().ranks[0].gid
    th = s.p.MDSThrasher(c)
    th.kill_rank(1)
    th.wait_takeover(1, timeout_rounds=40)
    assert c.fsmap().ranks[0].gid == gid0
    assert fs.read_file("/t1/a") == b"rank1"
    fs.write_file("/t1/b", b"post-failover")
    assert fs.read_file("/t1/b") == b"post-failover"
    assert fs.read_file("/t0/a") == b"rank0"
    return th.log


def test_multi_mds_rank_failover_under_pins(sides):
    run_both(sides, c_multi_mds_rank_failover_under_pins)


def c_standby_replay_warm_takeover(s, c):
    g = s.p.options.global_config()
    g.set("mds_standby_replay", True)
    try:
        c.start_mds(0)
        sb = c.start_mds_standby(standby_replay_rank=0)
        c.wait_mds_active(0)
        fs = s.new_fs(c)
        fs.mkdirs("/warm")
        for i in range(10):
            fs.write_file(f"/warm/f{i}", b"x" * 32)
        end = time.monotonic() + 15
        while time.monotonic() < end and sb.tailed == 0:
            time.sleep(0.1)
        assert sb.tailed > 0, "standby-replay never tailed the journal"
        th = s.p.MDSThrasher(c)
        th.kill_rank(0)
        th.wait_takeover(0, timeout_rounds=40)
        assert sb.active is not None and sb.rank == 0
        assert fs.read_file("/warm/f3") == b"x" * 32
        return [sb.name, sb.rank]
    finally:
        g.set("mds_standby_replay", False)


def test_standby_replay_warm_takeover(sides):
    run_both(sides, c_standby_replay_warm_takeover)


def c_beacon_mute_marks_rank_failed_then_rejoin(s, c):
    d = c.start_mds(0)
    c.wait_mds_active(0)
    d.inject_beacon_mute = True
    th = s.p.MDSThrasher(c)
    end = time.monotonic() + 30
    while time.monotonic() < end and c.fsmap().ranks[0].state != "failed":
        th.tick_grace(1)
    assert c.fsmap().ranks[0].state == "failed"
    d.inject_beacon_mute = False
    end = time.monotonic() + 30
    while time.monotonic() < end and c.fsmap().ranks[0].state != "active":
        time.sleep(0.1)
    assert c.fsmap().ranks[0].state == "active"
    assert c.fsmap().ranks[0].gid == d.gid
    return c.fsmap().ranks[0].name


def test_beacon_mute_marks_rank_failed_then_rejoin(sides):
    run_both(sides, c_beacon_mute_marks_rank_failed_then_rejoin)


def c_mds_thrasher_repeated_kill_revive_under_load(s, c):
    c.start_mds(0)
    c.start_mds(1)
    c.start_mds_standby()
    c.wait_mds_active(0)
    c.wait_mds_active(1)
    fs = s.new_fs(c)
    fs.mkdirs("/load0")
    fs.mkdirs("/load1")
    fs.set_pin("/load1", 1)
    th = s.p.MDSThrasher(c, seed=7)

    def between(i):
        for j in range(3):
            fs.write_file(f"/load0/r{i}-{j}", f"{i}:{j}".encode())
            fs.write_file(f"/load1/r{i}-{j}", f"{i}:{j}".encode())

    th.do_thrash(3, between=between)
    for i in range(3):
        for j in range(3):
            want = f"{i}:{j}".encode()
            assert fs.read_file(f"/load0/r{i}-{j}") == want
            assert fs.read_file(f"/load1/r{i}-{j}") == want
    assert th.log, th.log
    return th.log


def test_mds_thrasher_repeated_kill_revive_under_load(sides):
    run_both(sides, c_mds_thrasher_repeated_kill_revive_under_load)


# ------------------------------------------------------------ TCP E2E

def c_tcp_mds_kill_failover(s):
    pkg = "ceph_tpu" if s.kind == "ref" else "ceph_tpu_torch"
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    Rados = mod("client").Rados
    monmod, tcp = mod("mon.monitor"), mod("msg.tcp")
    OSDDaemon = mod("osd.daemon").OSDDaemon
    kw = s.p.kw
    names = ["mon.0", "osd.0", "osd.1", "mds.0", "mds.sb1", "mds.sb2",
             "client.950", "client.951", "client.952", "client.953"]
    ports = tcp.pick_free_ports(len(names))
    net = tcp.TcpNet({n: ("127.0.0.1", p) for n, p in zip(names, ports)})
    m, w = monmod.build_initial(2, osds_per_host=1)
    mon = monmod.Monitor(net, initial_map=m, initial_wrapper=w, **kw)
    mon.init()
    osds = [OSDDaemon(net, i, **kw) for i in range(2)]
    for d in osds:
        d.init()
    r_mds = Rados(net, name="client.951").connect(20.0)
    r_sb = Rados(net, name="client.952").connect(20.0)
    r_cl = Rados(net, name="client.950").connect(20.0)
    mds = s.p.MDSDaemon(net, r_mds, rank=0, mon="mon.0")
    mds.init()
    sb = s.p.MDSStandby(net, r_sb, name="sb1", mon="mon.0")
    sb.init()
    fs = s.p.CephFS(r_cl)
    got = []
    try:
        end = time.monotonic() + 30
        while time.monotonic() < end and \
                mon.mdsmon.fsmap.rank_state(0) != "active":
            mon.tick()
            time.sleep(0.1)
        assert mon.mdsmon.fsmap.rank_state(0) == "active"
        fs.mkdirs("/tcp")
        fs.write_file("/tcp/f", b"over sockets")
        mds.kill()
        end = time.monotonic() + 45
        while time.monotonic() < end:
            mon.tick()
            time.sleep(0.1)
            info = mon.mdsmon.fsmap.ranks.get(0)
            if info is not None and info.state == "active" and \
                    info.gid == sb.gid:
                break
        assert mon.mdsmon.fsmap.ranks[0].gid == sb.gid
        got.append(fs.read_file("/tcp/f"))
        assert got[-1] == b"over sockets"
        fs.write_file("/tcp/g", b"post-kill")
        assert fs.read_file("/tcp/g") == b"post-kill"
        r_sb2 = Rados(net, name="client.953").connect(20.0)
        sb2 = s.p.MDSStandby(net, r_sb2, name="sb2", mon="mon.0")
        sb2.init()
        sb.kill()
        end = time.monotonic() + 45
        while time.monotonic() < end:
            mon.tick()
            time.sleep(0.1)
            info = mon.mdsmon.fsmap.ranks.get(0)
            if info is not None and info.state == "active" and \
                    info.gid == sb2.gid:
                break
        assert mon.mdsmon.fsmap.ranks[0].gid == sb2.gid
        got.append(fs.read_file("/tcp/g"))
        fs.write_file("/tcp/h", b"second cycle")
        got.append(fs.read_file("/tcp/h"))
        assert got == [b"over sockets", b"post-kill", b"second cycle"]
        got.append(fs.listdir("/tcp"))
        got.append(fsmap_view(mon.mdsmon.fsmap))
        sb2.kill()
        r_sb2.shutdown()
    finally:
        sb.kill()
        if not mds.stopped:
            mds.kill()
        for cl in (r_cl, r_mds, r_sb):
            cl.shutdown()
        for d in osds:
            d.shutdown()
        mon.shutdown()
    return got


def test_tcp_mds_kill_failover(sides):
    got = {kind: c_tcp_mds_kill_failover(s) for kind, s in sides.items()}
    assert sides["port"].norm(got["port"]) == sides["ref"].norm(got["ref"])


# ------------------------------------------------- the SLOW_OPS feed

SLOW = {"osd_op_complaint_time": 0.05, "osd_mon_report_interval": 0.0}


def c_mds_slow_ops_ride_beacon(s, c):
    def health():
        rc, _, h = r.mon_command({"prefix": "health"})
        assert rc == 0
        return h

    def wait(pred, timeout=10.0):
        end = time.monotonic() + timeout
        while time.monotonic() < end and not pred():
            time.sleep(0.05)
        return pred()

    r = c.rados()
    c.start_mds(0)
    c.wait_mds_active(0)
    mds = c.mdss[0]
    mds.op_tracker.start(("client.y", 9), "client_request(stuck)")
    time.sleep(0.08)

    def warned():
        h = health()
        return "SLOW_OPS" in h["checks"] and \
            "mds.0" in h["checks"]["SLOW_OPS"]["summary"]

    assert wait(warned), health()
    summary = health()["checks"]["SLOW_OPS"]["summary"]
    mds.op_tracker.finish(("client.y", 9))
    assert wait(lambda: "SLOW_OPS" not in health()["checks"]), health()
    return summary.split(" (")[0]


def test_mds_slow_ops_ride_beacon(sides):
    """tests/test_slow_ops.py's MDS case: an aged client request rides
    the beacon to the mon as SLOW_OPS naming mds.0 and clears when the
    tracker drains, in both packages."""
    saved = {}
    for s in sides.values():
        cfg = s.p.options.global_config()
        saved[s.kind] = {k: cfg[k] for k in SLOW}
        for k, v in SLOW.items():
            cfg.set(k, v)
    try:
        run_both(sides, c_mds_slow_ops_ride_beacon)
    finally:
        for s in sides.values():
            cfg = s.p.options.global_config()
            for k, v in saved[s.kind].items():
                cfg.set(k, v)
