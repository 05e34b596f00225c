"""The port's multi-mon quorum held to the reference's, case by case.

Each of tests/test_mon_quorum.py's nine cases runs on the reference's
`MiniCluster(n_mon=3, threaded=False)` and on the port's (with
`device="cpu"`) and compares at tolerance 0: the leaders, every mon's
leader rank, election quorum and election epoch, the OSD monitor's
committed versions and map epochs, the pools each mon holds, the
command results, and every mon's osdmap store after the sync (its keys
and each value's wire bytes).  Paxos version numbers are compared
within each package (every mon converges on one) but not across them:
the reference's mon also bootstraps a ConfigMonitor, LogMonitor and
MDSMonitor, three commits the port's does not make.

The last cases pin what a quorum changes for a restarted mon: the
reference's remedy (MonHunter hunting to another mon) holds, so an
OSD and a client that talked to a killed leader go on through the
survivors and stay served after it returns, in both packages alike;
and a single mon keeps the port's adoption rule
(tests/test_torch_mon_durable.py) while a quorum member does not adopt.
"""
import pytest

from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.msg import encoding as port_wire
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.msg import messenger as port_messenger
from ceph_tpu_torch.testing import MiniCluster as PortCluster

port_wire.ensure_registered()

NS = {
    "ref": dict(cluster=RefCluster, wire=ref_wire, msgs=ref_messages,
                ms=ref_messenger, kw={}),
    "port": dict(cluster=PortCluster, wire=port_wire, msgs=port_messages,
                 ms=port_messenger, kw={"device": "cpu"}),
}


def make_cluster(ns, n_mon=3, n_osd=4):
    c = ns["cluster"](n_osd=n_osd, threaded=False, n_mon=n_mon, **ns["kw"])
    c.pump()
    c.wait_all_up()
    return c


def view(ns, c) -> dict:
    """What the comparison holds: per mon its role, election and maps,
    and its osdmap store; paxos convergence within the package."""
    mons = {}
    for r, mn in sorted(c.mons.items()):
        st = mn.store
        mons[r] = {
            "leader": mn.is_leader, "leader_rank": mn.leader_rank,
            "quorum": list(mn.elector.quorum), "epoch": mn.elector.epoch,
            "osdmap_epoch": mn.osdmap.epoch,
            "osdmon": (mn.osdmon.get_first_committed(),
                       mn.osdmon.get_last_committed()),
            "pools": sorted(mn.osdmap.pool_names.values()),
            "osdmap_store": {k: ns["wire"].encode(st.get("osdmap", k))
                             for k in st.keys("osdmap")}}
    versions = {mn.paxos.last_committed for mn in c.mons.values()}
    return {"mons": mons, "paxos_converged": len(versions) == 1}


def both(scenario):
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


def converged(v) -> bool:
    mons = list(v["mons"].values())
    return v["paxos_converged"] and all(
        m["osdmap_epoch"] == mons[0]["osdmap_epoch"] and
        m["osdmap_store"] == mons[0]["osdmap_store"] for m in mons)


class CmdClient:
    """A bare command client on one mon (a peon in the test below)."""

    def __init__(self, ns, net, name, mon):
        msgs = ns["msgs"]
        self.msgs = msgs
        outer = self

        class D(ns["ms"].Dispatcher):
            def ms_dispatch(self, msg):
                if isinstance(msg, msgs.MMonCommandAck):
                    outer.acks.append((msg.tid, msg.result))
                    return True
                return False
        self.ms = ns["ms"].Messenger.create(net, name, threaded=False)
        self.ms.add_dispatcher(D())
        self.ms.start()
        self.mon = mon
        self.acks = []

    def send(self, tid, cmd):
        self.ms.connect(self.mon).send_message(
            self.msgs.MMonCommand(tid=tid, cmd=cmd))

    def pump_with(self, c, rounds=10):
        for _ in range(rounds):
            c.pump()
            if not self.ms.poll():
                break


def test_election_lowest_rank_wins():
    def s(ns):
        c = make_cluster(ns)
        try:
            return view(ns, c)
        finally:
            c.shutdown()
    v = both(s)
    assert [r for r, m in v["mons"].items() if m["leader"]] == [0]
    assert all(m["leader_rank"] == 0 for m in v["mons"].values())
    q = v["mons"][0]["quorum"]
    assert 0 in q and len(q) >= 2


def test_commit_replicates_to_all_mons():
    def s(ns):
        c = make_cluster(ns)
        try:
            c.rados().pool_create("p", pg_num=8)
            c.pump()
            return view(ns, c)
        finally:
            c.shutdown()
    v = both(s)
    assert converged(v)
    assert all("p" in m["pools"] for m in v["mons"].values())


def test_peon_forwards_write_commands():
    def s(ns):
        c = make_cluster(ns)
        try:
            cl = CmdClient(ns, c.network, "client.77", "mon.2")  # a peon
            cl.send(5, {"prefix": "osd pool create", "pool": "via-peon",
                        "pg_num": 8})
            cl.pump_with(c)
            cl.send(6, {"prefix": "osd stat"})       # read on the peon
            cl.pump_with(c)
            return cl.acks, view(ns, c)
        finally:
            c.shutdown()
    acks, v = both(s)
    assert acks == [(5, 0), (6, 0)]
    assert converged(v) and "via-peon" in v["mons"][0]["pools"]


def test_leader_failover_and_continuity():
    def s(ns):
        c = make_cluster(ns)
        try:
            c.rados().pool_create("before", pg_num=8)
            c.pump()
            c.kill_mon(0)
            now = 50_000.0
            c.tick(now)
            c.tick(now + 20.0)          # > LEASE_TIMEOUT
            c.pump()
            after_kill = view(ns, c)
            io_client = c.rados()
            io_client.pool_create("after", pg_num=8)
            c.pump()
            io = io_client.open_ioctx("after")
            io.write_full("obj", b"post-failover")
            return after_kill, view(ns, c), io.read("obj")
        finally:
            c.shutdown()
    after_kill, v, data = both(s)
    assert [r for r, m in after_kill["mons"].items() if m["leader"]] == [1]
    assert after_kill["mons"][2]["leader_rank"] == 1
    for m in v["mons"].values():
        assert {"before", "after"} <= set(m["pools"])
    assert data == b"post-failover"


def test_peon_death_keeps_majority_working():
    def s(ns):
        c = make_cluster(ns)
        try:
            r = c.rados()
            c.kill_mon(2)
            r.pool_create("still-works", pg_num=8)
            c.pump()
            return view(ns, c)
        finally:
            c.shutdown()
    v = both(s)
    assert sorted(v["mons"]) == [0, 1] and converged(v)
    assert "still-works" in v["mons"][1]["pools"]


def test_revived_mon_catches_up():
    def s(ns):
        c = make_cluster(ns)
        try:
            r = c.rados()
            c.kill_mon(2)
            r.pool_create("while-away", pg_num=8)
            c.pump()
            c.revive_mon(2)
            c.pump()
            now = 90_000.0
            c.tick(now)
            c.tick(now + 6.0)
            c.pump()
            return view(ns, c)
        finally:
            c.shutdown()
    v = both(s)
    assert converged(v) and "while-away" in v["mons"][2]["pools"]


def test_full_store_sync_beyond_trim_window():
    """A mon lagging past the paxos trim window gets a full store
    snapshot (MPaxosStoreSync, MonitorStore.import_data)."""
    def s(ns):
        c = make_cluster(ns)
        try:
            r = c.rados()
            c.kill_mon(2)
            for p in ("a", "b", "c"):
                r.pool_create(p, pg_num=8)
            c.pump()
            lead = c.mons[0]
            lead.paxos.keep_versions = 1
            lead.paxos._maybe_trim()
            gap = lead.paxos.first_committed > 2
            c.revive_mon(2)
            c.pump()
            c.tick(120_000.0)
            c.pump()
            return gap, view(ns, c), (
                c.mons[2].paxos.last_committed ==
                lead.paxos.last_committed,
                c.mons[2].paxos.first_committed ==
                lead.paxos.first_committed)
        finally:
            c.shutdown()
    gap, v, synced = both(s)
    assert gap and synced == (True, True) and converged(v)
    assert {"a", "b", "c"} <= set(v["mons"][2]["pools"])


def test_revived_stale_leader_does_not_fork_history():
    def s(ns):
        c = make_cluster(ns)
        try:
            r = c.rados()
            c.kill_mon(0)
            now = 200_000.0
            c.tick(now)
            c.tick(now + 20.0)
            c.pump()
            failed_over = [rk for rk, mn in c.mons.items() if mn.is_leader]
            c.rados().pool_create("while-0-dead", pg_num=8)
            c.pump()
            v_ahead = c.mons[1].paxos.last_committed
            mn0 = c.revive_mon(0)
            c.pump()
            c.tick(now + 40.0)
            c.pump()
            caught_up = (mn0.is_leader,
                         mn0.paxos.last_committed >= v_ahead)
            c.rados().pool_create("after-revive", pg_num=8)
            c.pump()
            return failed_over, caught_up, view(ns, c), r is not None
        finally:
            c.shutdown()
    failed_over, caught_up, v, _ = both(s)
    assert failed_over == [1] and caught_up == (True, True)
    assert converged(v)
    for m in v["mons"].values():
        assert {"while-0-dead", "after-revive"} <= set(m["pools"])


def test_sync_handle_command_raises_in_quorum():
    def s(ns):
        c = make_cluster(ns)
        try:
            with pytest.raises(RuntimeError):
                c.mons[0].handle_command({"prefix": "osd pool create",
                                          "pool": "x", "pg_num": 8})
            rc, _, _ = c.mons[2].handle_command({"prefix": "osd stat"})
            rc_q, _, q = c.mons[2].handle_command(
                {"prefix": "quorum_status"})
            return rc, rc_q, q, view(ns, c)
        finally:
            c.shutdown()
    rc, rc_q, q, _ = both(s)
    assert rc == 0 and rc_q == 0
    assert q["quorum"] == [0, 1, 2] and q["leader"] == 0
    assert q["mons"] == [0, 1, 2] and q["election_epoch"] > 0


def test_daemons_hunt_past_a_dead_leader_and_back():
    """With three mons the reference's remedy for a restarted mon holds:
    the OSDs and the client that talked to mon.0 hunt to a survivor when
    it dies, keep writing and mapping through the new leader, and the
    revived mon.0 catches up and leads again; both packages alike."""
    def s(ns):
        c = make_cluster(ns, n_osd=5)
        try:
            r = c.rados()
            r.pool_create("p", pg_num=8)
            c.pump()
            io = r.open_ioctx("p")
            io.write_full("a", b"before")
            c.kill_mon(0)
            now = 300_000.0
            for t in (now, now + 20.0, now + 31.0):
                c.tick(t)
            c.pump()
            hunted = sorted({d.mon for d in c.osds.values()})
            # the client learns of the dead mon on its next send: that
            # command is lost with the connection (it times out, in
            # both packages), and the reset moves the client on
            try:
                r.objecter.mon_command({"prefix": "osd pool create",
                                        "pool": "lost", "pg_num": 8},
                                       timeout=1.0)
                first = "served"
            except TimeoutError:
                first = "timed out"
            rehomed = r.objecter.mon
            r.pool_create("q", pg_num=8)
            c.pump()
            io.write_full("b", b"during")
            c.revive_mon(0)
            for t in (now + 42.0, now + 53.0):
                c.tick(t)
            c.pump()
            r.pool_create("after", pg_num=8)
            c.pump()
            io.write_full("c", b"after")
            epochs = sorted({d.osdmap.epoch for d in c.osds.values()})
            return (hunted, first, rehomed, [io.read(o) for o in "abc"],
                    r.objecter.osdmap.epoch, epochs, view(ns, c))
        finally:
            c.shutdown()
    hunted, first, rehomed, reads, client_epoch, epochs, v = both(s)
    assert "mon.0" not in hunted and rehomed != "mon.0"
    assert first == "timed out"
    assert {"q", "after"} <= set(v["mons"][0]["pools"])
    assert reads == [b"before", b"during", b"after"]
    assert v["mons"][0]["leader"] and converged(v)
    assert epochs == [v["mons"][0]["osdmap_epoch"]] == [client_epoch]


def test_quorum_member_does_not_adopt_a_sender():
    """The port's adoption rule (a resumed single mon subscribes an
    entity it hears from) is for a standalone mon only: a revived
    quorum member leaves subscriptions to the daemons' hunting."""
    c = make_cluster(NS["port"])
    try:
        c.kill_mon(2)
        mn = c.revive_mon(2)
        assert not mn.standalone and not mn._resumed
    finally:
        c.shutdown()
    single = PortCluster(n_osd=2, threaded=False, device="cpu")
    try:
        single.pump()
        single.kill_mon(0)
        mn = single.revive_mon(0)
        assert mn.standalone and mn._resumed
    finally:
        single.shutdown()
