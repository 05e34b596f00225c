"""The port's ChaosRunner and the quorum's behaviour under faults, held
to the reference's.

tests/test_chaos.py's five cases (the half-blind mon, the late ack, the
ChaosRunner schedule with its replayed digest, the isolated primary, the
rgw zone partitioned mid-sync) run on `ceph_tpu` and on `ceph_tpu_torch`
(with `device="cpu"`) and compare at tolerance 0: the leader and quorum
after every tick, the election epochs, the health checks, and
`report()`'s acked and total ops, fault digest, fault counts, per-phase
op counts and events (the per-phase latencies are host-clock times,
compared to nothing); for the zones, the durable cursors before, during
and after the partition, the source's state, and the converged index
(stamps ranked and ids numbered as tests/test_torch_rgw_multisite.py
does).  Smoke phase 22's schedule runs the same way at the smallest
width that places its `tpu` pool (5 OSDs, k=2 m=1, failure domain osd):
the same report and the same bytes back in both packages, and each of
the three mons answering `log last` with the same mon-originated lines,
which are the reference's but for the auto-out of the isolated primary
that the port's rule below boots again.  The TCP
transport's fault intercept (`TcpNet(faults=)`) partitions and drops on
loopback alike in both packages.  The last case pins the port's one
rule that differs: an OSD that a new map wrongly shows down boots again.
"""
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ceph_tpu.msg import faults as ref_faults
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.msg import tcp as ref_tcp
from ceph_tpu.testing import ChaosRunner as RefRunner
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.msg import faults as port_faults
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.msg import messenger as port_messenger
from ceph_tpu_torch.msg import tcp as port_tcp
from ceph_tpu_torch.testing import ChaosRunner as PortRunner
from ceph_tpu_torch.testing import InvariantViolation
from ceph_tpu_torch.testing import MiniCluster as PortCluster
from test_torch_tcp import deadline  # noqa: F401  (per-test timeout)

NS = {
    "ref": dict(cluster=RefCluster, runner=RefRunner, faults=ref_faults,
                msgs=ref_messages, ms=ref_messenger, tcp=ref_tcp, kw={}),
    "port": dict(cluster=PortCluster, runner=PortRunner, faults=port_faults,
                 msgs=port_messages, ms=port_messenger, tcp=port_tcp,
                 kw={"device": "cpu"}),
}

#: tests/test_chaos.py:84-92
SCHEDULE = [
    {"at": 20.0, "action": "partition", "a": ["mon.2"],
     "b": ["mon.0", "mon.1"], "label": "mon-minority"},
    {"at": 60.0, "action": "heal", "target": "mon-minority"},
    {"at": 80.0, "action": "kill_osd", "osd": 3},
    {"at": 120.0, "action": "revive_osd", "osd": 3},
    {"at": 140.0, "action": "drop", "src": "osd.*", "dst": "osd.*",
     "p": 0.02, "types": ["Ping"], "label": "ping-loss"},
    {"at": 200.0, "action": "heal", "target": "ping-loss"},
]
#: chip_smoke.py phase 22: the above, then tests/test_chaos.py:120-137's
#: primary cut
PHASE22 = SCHEDULE + [
    {"at": 220.0, "action": "isolate_primary", "oid": "chaos_00001",
     "label": "primary-cut"},
    {"at": 280.0, "action": "heal", "target": "primary-cut"},
]


def _mk(ns, n_osd=4, n_mon=3, fault_seed=7):
    c = ns["cluster"](n_osd=n_osd, threaded=False, n_mon=n_mon,
                      fault_seed=fault_seed, **ns["kw"])
    c.pump()
    c.wait_all_up()
    return c


def both(scenario):
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


def comparable(rep: dict) -> dict:
    """report() without its host-clock latencies."""
    return {**{k: rep[k] for k in ("ops_total", "acked", "fault_digest",
                                   "fault_counts", "events")},
            "phases": [(p["phase"], p["ops"]) for p in rep["phases"]]}


# ------------------------------------------------- mon election chaos
def test_asymmetric_partition_quorum_excludes_half_blind_mon():
    """mon.2 can send but hears nothing: the majority re-forms a [0, 1]
    quorum with paced counter-candidacies, MON_DOWN shows, and the heal
    readmits mon.2; tick for tick alike in both packages."""
    def s(ns):
        c = _mk(ns, n_osd=3)
        try:
            start = (c.leader() or c.mons[0]).quorum()
            ids = c.network.faults.partition(
                ["mon.0", "mon.1"], ["mon.2"], symmetric=False)
            now = 50_000.0
            trace = []
            for _ in range(10):
                now += 11.0
                c.tick(now)
                ldr = c.leader()
                trace.append((ldr.rank if ldr else None,
                              ldr.quorum() if ldr else None,
                              c.mons[0].elector.epoch))
            down = sorted(c.leader().handle_command(
                {"prefix": "health"})[2]["checks"])
            c.network.faults.heal(ids)
            healed = None
            for i in range(20):
                now += 11.0
                c.tick(now)
                ldr = c.leader()
                if ldr is not None and ldr.quorum() == [0, 1, 2]:
                    healed = i
                    break
            after = sorted(c.leader().handle_command(
                {"prefix": "health"})[2]["checks"])
            return (start, trace, down, healed, after,
                    c.network.faults.digest(),
                    dict(c.network.faults.counts))
        finally:
            c.shutdown()
    start, trace, down, healed, after, _d, _c = both(s)
    assert start == [0, 1, 2]
    for ldr, quorum, _epoch in trace[3:]:
        assert ldr == 0 and quorum == [0, 1]
    epochs = [e for _l, _q, e in trace]
    assert epochs[-1] - epochs[0] <= 2 * len(epochs)
    assert "MON_DOWN" in down and healed is not None
    assert "MON_DOWN" not in after


def test_late_ack_expands_quorum_instead_of_stranding_voter():
    def s(ns):
        c = _mk(ns, n_osd=3)
        try:
            ldr = c.leader()
            return (ldr.rank, ldr.quorum(),
                    [(mn.leader_rank, list(mn.elector.quorum),
                      mn.elector.epoch) for mn in c.mons.values()])
        finally:
            c.shutdown()
    rank, quorum, _ = both(s)
    assert rank == 0 and quorum == [0, 1, 2]


# ------------------------------------------------- ChaosRunner schedules
def _run_schedule(ns):
    c = _mk(ns, n_osd=5)
    try:
        return comparable(ns["runner"](c, SCHEDULE, rados=c.rados(),
                                       seed=1).run())
    finally:
        c.shutdown()


def test_chaos_schedule_invariants_and_replay_digest():
    """mon-minority partition + OSD flap + heartbeat loss under live IO:
    run() passes every invariant, and the port's report equals the
    reference's and replays from the seed."""
    rep1 = both(_run_schedule)
    assert rep1["acked"] == rep1["ops_total"] > 0
    assert rep1["fault_counts"].get("partition", 0) > 0
    assert "mon-minority" in {p for p, _n in rep1["phases"]}
    assert _run_schedule(NS["port"]) == rep1


def test_isolate_primary_mid_write_recovers():
    def s(ns):
        c = _mk(ns, n_osd=5)
        try:
            r = c.rados()
            r.pool_create("chaos", pg_num=16)
            c.pump()
            sched = [
                {"at": 15.0, "action": "isolate_primary",
                 "oid": "chaos_00001", "label": "primary-cut"},
                {"at": 75.0, "action": "heal", "target": "primary-cut"},
            ]
            return comparable(ns["runner"](c, sched, rados=r,
                                           seed=3).run())
        finally:
            c.shutdown()
    rep = both(s)
    assert rep["fault_counts"].get("partition", 0) > 0
    assert rep["acked"] > 0
    assert any(e.startswith("  -> primary is osd.") for e in rep["events"])


def test_phase22_schedule_at_small_width():
    """Smoke phase 22's schedule on a 5-OSD cluster with a k=2 m=1
    `tpu` pool (failure domain osd) and 16 seeded objects: the same
    report, quorum, crash table and bytes in both packages."""
    rng = np.random.default_rng(22)
    objs = {f"pre{i:02d}": rng.bytes(4096 + 513 * i) for i in range(16)}

    def s(ns):
        c = _mk(ns, n_osd=5)
        try:
            r = c.rados()
            assert r.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "k2m1",
                "profile": {"plugin": "tpu", "k": "2", "m": "1",
                            "crush-failure-domain": "osd"}})[0] == 0
            r.pool_create("ecpool", pg_num=8, pool_type="erasure",
                          erasure_code_profile="k2m1")
            c.pump()
            io = r.open_ioctx("ecpool")
            for oid, data in objs.items():
                io.write_full(oid, data)
            rep = comparable(ns["runner"](c, PHASE22, rados=r,
                                          pool="ecpool", seed=1).run())
            ldr = c.leader()
            # the mons' own cluster-log lines, as each mon answers them
            logs = [[(e["name"], e["level"], e["text"], e["stamp"])
                     for e in mn.handle_command(
                         {"prefix": "log last", "num": 500})[2]
                     if e["name"].startswith("mon.")]
                    for _rank, mn in sorted(c.mons.items())]
            mon_logs[ns["cluster"].__module__] = logs
            return (rep, {oid: io.read(oid) for oid in objs},
                    ldr.handle_command({"prefix": "quorum_status"})[2],
                    ldr.handle_command({"prefix": "crash ls"})[2])
        finally:
            c.shutdown()
    mon_logs = {}
    rep, back, q, crashes = both(s)
    assert rep["acked"] == rep["ops_total"] > 0
    assert rep["fault_counts"]["partition"] > 0
    assert rep["fault_counts"]["drop"] > 0
    assert back == objs and crashes == [] and q["quorum"] == [0, 1, 2]
    ref, port = (mon_logs[NS[k]["cluster"].__module__] for k in ("ref",
                                                                 "port"))
    assert port[0] == port[1] == port[2] and ref[0] == ref[1] == ref[2]
    # one rule differs: the isolated primary, marked down while alive,
    # boots again in the port (Ceph's "wrongly marked me down") and is
    # never auto-marked out; the reference's stays down until it is
    assert port[0] == [e for e in ref[0]
                       if e[2] != "osd.4 auto-marked out after staying "
                       "down past the interval"]
    assert ("warn", "osd.3 marked down after failure reports from its "
            "peers") in [(lvl, text) for _n, lvl, text, _t in port[0]]


def test_unknown_action_and_crash_table_invariant():
    """An unknown action is refused, and a crash in the table is an
    InvariantViolation, alike in both packages."""
    from ceph_tpu.common.crash import crash_meta

    meta = crash_meta("osd.1", RuntimeError("chaos crash"), stamp=1.0e9)

    def s(ns):
        c = _mk(ns, n_osd=3)
        try:
            r = c.rados()
            with pytest.raises(ValueError, match="unknown chaos action"):
                ns["runner"](c, [{"at": 1.0, "action": "melt"}],
                             rados=r).run()
            runner = ns["runner"](c, [], rados=r)
            runner.check_invariants(final=False)
            assert r.mon_command({"prefix": "crash post",
                                  "meta": meta})[0] == 0
            with pytest.raises(AssertionError) as ei:
                runner.check_invariants(final=False)
            return type(ei.value).__name__, str(ei.value)
        finally:
            c.shutdown()
    name, text = both(s)
    assert name == "InvariantViolation" and "crash table not empty" in text
    assert issubclass(InvariantViolation, AssertionError)


# ------------------------------------------------------- TCP intercept
def test_tcp_fault_intercept_partition_and_drop():
    """TcpNet(faults=): a partition black-holes silently, a drop rule
    with reset=True resets the sender, a healed link delivers again;
    the same verdicts, digest and deliveries in both packages."""
    def s(ns):
        ports = ref_tcp.pick_free_ports(2)
        plane = ns["faults"].FaultPlane(seed=3)
        net = ns["tcp"].TcpNet({"a": ("127.0.0.1", ports[0]),
                                "b": ("127.0.0.1", ports[1])},
                               faults=plane)
        got, resets = [], []

        class D(ns["ms"].Dispatcher):
            def ms_dispatch(self, msg):
                got.append(msg.epoch)
                return True

            def ms_handle_reset(self, peer):
                resets.append(peer)
        ma = ns["ms"].Messenger.create(net, "a")
        mb = ns["ms"].Messenger.create(net, "b")
        ma.add_dispatcher(D())
        mb.add_dispatcher(D())
        ma.start()
        mb.start()
        try:
            ping = ns["msgs"].Ping
            ids = plane.partition(["a"], ["b"], symmetric=False)
            sent = [ma.connect("b").send_message(ping(epoch=i))
                    for i in range(3)]
            plane.heal(ids)
            rid = plane.add_rule("a", "b", drop=1.0, reset=True)
            sent += [ma.connect("b").send_message(ping(epoch=10))]
            plane.heal([rid])
            sent += [ma.connect("b").send_message(ping(epoch=20))]
            end = time.monotonic() + 10
            while not got and time.monotonic() < end:
                time.sleep(0.01)
            return (sent, list(got), list(resets), plane.digest(),
                    dict(plane.counts))
        finally:
            ma.shutdown()
            mb.shutdown()
    sent, got, resets, _digest, counts = both(s)
    assert sent == [False, False, False, False, True]
    assert got == [20] and resets == ["b"]
    assert counts == {"partition": 3, "drop": 1}


# --------------------------------------------- the rule that differs
def _down_a_live_osd(ns):
    c = ns["cluster"](n_osd=4, threaded=False, **ns["kw"])
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        r.pool_create("p", pg_num=8)
        c.pump()
        assert r.mon_command({"prefix": "osd down", "ids": [2]})[0] == 0
        c.pump()
        m = c.mon.osdmap
        return m.is_up(2), m.epoch
    finally:
        c.shutdown()


def test_wrongly_marked_down_osd_boots_again():
    """A live OSD that a new map shows down (false failure reports, a
    healed partition, `osd down`) boots again, as Ceph's OSD does (ref:
    OSD.cc _committed_osd_maps "wrongly marked me down"); the
    reference's stays down until it is marked out.  At smoke phase 22's
    width (16 OSDs, k=8 m=4 over hosts) the reference's way leaves the
    2 % Ping loss's falsely downed OSDs out and every PG degraded."""
    ref_up, ref_epoch = _down_a_live_osd(NS["ref"])
    port_up, port_epoch = _down_a_live_osd(NS["port"])
    assert (ref_up, port_up) == (False, True)
    assert port_epoch == ref_epoch + 1        # the boot's epoch


def test_quorum_cluster_defaults_to_the_card():
    """MiniCluster(n_mon=3) builds its daemons on cuda unless the caller
    asks for the CPU: without a card the default raises, nothing falls
    back."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortCluster(n_osd=3, threaded=False, n_mon=3, fault_seed=7)


# --------------------------------------------- rgw multisite partition
def _zone_partition(ns):
    """tests/test_chaos.py:158: the secondary's pulls from the master
    cut on the fault plane mid-sync; backoff engages, its durable
    cursors stay put, and the lag drains after the heal.  Each wait
    before reading the cursors waits for gw2's durable cursor to reach
    the write, where the reference's waits on caught_up()."""
    from types import SimpleNamespace

    from test_torch_rgw_multisite import PKG as MS_PKG
    from test_torch_rgw_multisite import _wait, canon, req, settle, state

    kind = "ref" if ns is NS["ref"] else "port"
    c = ns["cluster"](n_osd=4, threaded=True, **ns["kw"])
    c.wait_all_up()
    try:
        gw1, gw2 = c.rgw_multisite(zones=("c1", "c2"))
        masks = {f":{g.port}": f":<{g.zone}>" for g in (gw1, gw2)}
        req(gw1, "PUT", "/pb")
        req(gw1, "PUT", "/pb/before", b"pre-partition" * 10)

        def pulled(key):
            # gw2's durable cursor for c1's log of the key's shard has
            # reached the head c1 holds now (caught_up() reads the heads
            # of the agent's last round, which may predate the write)
            sh = gw1.shard_of("pb", key)
            head = gw1.datalog.head("pb", sh)
            cur = gw2.sync.markers_for("c1").get("pb", {}).get("cursors",
                                                               {})
            return cur.get(sh, cur.get(str(sh), -1)) >= head

        assert _wait(lambda: pulled("before") and gw2.sync.caught_up()), \
            gw2.sync.status()
        markers_before = gw2.sync.markers_for("c1")
        ids = c.network.faults.partition(["rgw.c2"], ["rgw.c1"])
        req(gw1, "PUT", "/pb/during", b"mid-partition" * 20)
        assert _wait(lambda: (bo := gw2.sync._backoff.get("c1"))
                     is not None and bo.failures >= 2), gw2.sync.status()
        src_rows = {r["source"]: r for r in gw2.sync.status()["sources"]}
        assert src_rows["c1"]["state"] == "backoff", src_rows
        markers_during = gw2.sync.markers_for("c1")
        assert markers_during == markers_before
        with pytest.raises(urllib.error.HTTPError):
            req(gw2, "GET", "/pb/during")
        c.network.faults.heal(ids)
        assert _wait(lambda: pulled("during") and gw2.sync.caught_up()), \
            gw2.sync.status()
        assert req(gw2, "GET", "/pb/during")[2] == b"mid-partition" * 20
        settle(gw1, gw2)
        assert gw2.sync._backoff["c1"].failures == 0
        return canon({"before": markers_before, "during": markers_during,
                      "state": src_rows["c1"]["state"],
                      "after": gw2.sync.markers_for("c1"),
                      "index": state(SimpleNamespace(p=MS_PKG[kind]),
                                     [gw1, gw2], ["pb"])}, masks)
    finally:
        c.shutdown()


def test_rgw_multisite_mid_sync_partition():
    from ceph_tpu_torch.rgw import multisite as port_multisite

    before = sum(port_multisite.SWALLOWED.values()), \
        sum(port_multisite.SYNC_TICK_ERRORS.values())
    got = both(_zone_partition)
    assert got["state"] == "backoff"
    assert (sum(port_multisite.SWALLOWED.values()),
            sum(port_multisite.SYNC_TICK_ERRORS.values())) == before
