"""The port's centralized config held to the reference's.

The four cases of tests/test_config_monitor.py run on
`ceph_tpu.testing.MiniCluster` and on
`ceph_tpu_torch.testing.MiniCluster(device="cpu")` (threaded, as the
reference's) and compare at tolerance 0: `config set`, `get` (one name
and the merged view, with global < type < entity precedence), `dump`
and `rm` with their codes and text; a committed `config set osd ...`
reaching the OSDs' live options; `config rm` reverting the live value to
its default; and a value committed through a three-mon quorum answering
from the new leader after the old one dies.  A pump-mode case adds the
message flow: every MConfig the mon pushes (destination, version,
values), in order, equals the reference's.  The last case pins the
port's own rule for a single mon restarted on its store: it subscribes
the OSDs it hears from to their config again.
"""
import time

import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.common.options import OPTIONS
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NS = {
    "ref": dict(cluster=RefCluster, config=ref_config, kw={}),
    "port": dict(cluster=PortCluster, config=port_config,
                 kw={"device": "cpu"}),
}
HB = "osd_heartbeat_interval"


def both(scenario):
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


def wait_for(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end and not pred():
        time.sleep(0.05)
    return pred()


def threaded(ns, **kw):
    c = ns["cluster"](n_osd=2, threaded=True, **kw, **ns["kw"])
    c.wait_all_up()
    return c, c.rados()


def test_set_get_dump_rm():
    def s(ns):
        c, r = threaded(ns)
        try:
            out = [r.mon_command({"prefix": "config set", "who": "osd",
                                  "name": HB, "value": "2.5"}),
                   r.mon_command({"prefix": "config get", "who": "osd.1",
                                  "name": HB})]
            r.mon_command({"prefix": "config set", "who": "global",
                           "name": "ms_type", "value": "local"})
            r.mon_command({"prefix": "config set", "who": "osd.1",
                           "name": HB, "value": "9"})
            for who in ("osd.1", "osd.0"):
                out.append(r.mon_command({"prefix": "config get",
                                          "who": who}))
            out.append(r.mon_command({"prefix": "config dump"}))
            out.append(r.mon_command({"prefix": "config rm",
                                      "who": "osd.1", "name": HB}))
            out.append(r.mon_command({"prefix": "config get",
                                      "who": "osd.1"}))
            out.append(r.mon_command({"prefix": "config get",
                                      "who": "osd.1",
                                      "name": "nope_not_set"}))
            out.append(r.mon_command({"prefix": "config set",
                                      "who": "osd"}))
            return out
        finally:
            c.shutdown()
    out = both(s)
    assert out[0][:2] == (0, f"set osd/{HB}") and out[1] == (0, "", "2.5")
    assert out[2][2] == {HB: "9", "ms_type": "local"}
    assert out[3][2] == {HB: "2.5", "ms_type": "local"}
    assert out[4][2] == {"global": {"ms_type": "local"},
                         "osd": {HB: "2.5"}, "osd.1": {HB: "9"}}
    assert out[5][:2] == (0, f"removed osd.1/{HB}")
    assert out[6][2][HB] == "2.5"
    assert out[7][0] == -2 and out[8][0] == -22


def test_config_pushed_to_osds():
    """A committed config set reaches the subscribed daemons and applies
    to their live options."""
    def s(ns):
        cfg = ns["config"]()
        old = cfg[HB]
        c, r = threaded(ns)
        try:
            rc = r.mon_command({"prefix": "config set", "who": "osd",
                                "name": HB, "value": "3.25"})[0]
            return rc, wait_for(lambda: cfg[HB] == 3.25), cfg[HB]
        finally:
            c.shutdown()
            cfg.set(HB, old)
    assert both(s) == (0, True, 3.25)


def test_config_rm_reverts_on_daemons():
    """`config rm` reverts the live value on running daemons to its
    default (ref: md_config_t::set_mon_vals)."""
    def s(ns):
        cfg = ns["config"]()
        c, r = threaded(ns)
        try:
            r.mon_command({"prefix": "config set", "who": "osd",
                           "name": HB, "value": "2.25"})
            applied = wait_for(lambda: cfg[HB] == 2.25)
            r.mon_command({"prefix": "config rm", "who": "osd",
                           "name": HB})
            default = OPTIONS[HB].default
            return applied, wait_for(lambda: cfg[HB] == default), cfg[HB]
        finally:
            c.shutdown()
    assert both(s) == (True, True, OPTIONS[HB].default)


def test_config_survives_quorum_failover():
    """A value committed through a three-mon quorum answers from the new
    leader after the old one dies."""
    def s(ns):
        c, r = threaded(ns, n_mon=3)
        try:
            rc = r.mon_command({"prefix": "config set", "who": "global",
                                "name": "mon_lease", "value": "7"})[:2]
            leader = c.leader()
            c.kill_mon(leader.rank)
            deadline = time.monotonic() + 30
            val = None
            while time.monotonic() < deadline:
                try:
                    got = r.objecter.mon_command(
                        {"prefix": "config get", "who": "mon.1",
                         "name": "mon_lease"}, timeout=5.0)
                    if got[0] == 0:
                        val = got[2]
                        break
                except TimeoutError:
                    pass
                time.sleep(0.25)
            return rc, leader.rank, val
        finally:
            c.shutdown()
    assert both(s) == ((0, "set global/mon_lease"), 0, "7")


def test_mconfig_pushes_equal_the_references():
    """Pump mode: every MConfig the mon sends, in order, with its
    destination, version and values; and what each OSD applied."""
    def s(ns):
        cfg = ns["config"]()
        old = cfg["osd_max_backfills"]
        c = ns["cluster"](n_osd=3, threaded=False, **ns["kw"])
        pushes = []

        def record(src, dst, msg):
            if msg.type_name == "MConfig":
                pushes.append((src, dst, msg.version, dict(msg.values)))
            return True
        c.network.filter = record
        try:
            c.pump()
            c.wait_all_up()
            r = c.rados()
            for cmd in ({"prefix": "config set", "who": "osd",
                         "name": "osd_max_backfills", "value": "2"},
                        {"prefix": "config set", "who": "osd.1",
                         "name": "osd_max_backfills", "value": "3"},
                        {"prefix": "config set", "who": "osd",
                         "name": "no_such_option", "value": "x"},
                        {"prefix": "config rm", "who": "osd.1",
                         "name": "osd_max_backfills"}):
                assert r.mon_command(cmd)[0] == 0
                c.pump()
            applied = cfg["osd_max_backfills"]
            r.mon_command({"prefix": "config rm", "who": "osd",
                           "name": "osd_max_backfills"})
            c.pump()
            return pushes, applied, cfg["osd_max_backfills"]
        finally:
            c.shutdown()
            cfg.set("osd_max_backfills", old)
    pushes, applied, reverted = both(s)
    assert applied == 2 and reverted == OPTIONS["osd_max_backfills"].default
    assert {dst for _s, dst, _v, _vals in pushes} == {"osd.0", "osd.1",
                                                     "osd.2"}
    last = {dst: vals for _s, dst, _v, vals in pushes}
    assert last == {f"osd.{i}": {"no_such_option": "x"} for i in range(3)}
    assert ("mon.0", "osd.1", 3, {"osd_max_backfills": "3"}) in pushes


def test_resumed_single_mon_pushes_config_to_the_osds_again(tmp_path):
    """The port's rule for a single mon restarted on its store (the
    reference's loses its subscribers with its process): an OSD it hears
    from without a subscription is subscribed again, its centralized
    config included, so a later `config set` still reaches it."""
    from ceph_tpu_torch.kv import LogDB
    from ceph_tpu_torch.mon.store import MonitorStore

    path = str(tmp_path / "mon")
    cfg = port_config()
    old = cfg["osd_max_backfills"]
    c = PortCluster(n_osd=3, threaded=False, device="cpu",
                    mon_store=MonitorStore(LogDB(path)))
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        assert r.mon_command({"prefix": "config set", "who": "osd",
                              "name": "osd_max_backfills",
                              "value": "2"})[0] == 0
        c.pump()
        assert cfg["osd_max_backfills"] == 2
        c.kill_mon(0)
        c._mon_stores[0] = MonitorStore(LogDB(path))
        mon = c.revive_mon(0)
        c.pump()
        assert mon._config_subs == {}
        c.tick(1000.0)              # pg-stat reports: the OSDs adopted
        c.pump()
        assert sorted(mon._config_subs) == ["osd.0", "osd.1", "osd.2"]
        assert mon.handle_command({"prefix": "config set", "who": "osd",
                                   "name": "osd_max_backfills",
                                   "value": "3"})[0] == 0
        c.pump()
        assert cfg["osd_max_backfills"] == 3
        assert all(d._mon_config_keys == {"osd_max_backfills"}
                   for d in c.osds.values())
    finally:
        c.shutdown()
        cfg.set("osd_max_backfills", old)
