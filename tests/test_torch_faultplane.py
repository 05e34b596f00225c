"""The port's fault plane held to the reference's, case by case.

Each of tests/test_faultplane.py's fifteen cases runs on
`ceph_tpu.msg.faults` and on `ceph_tpu_torch.msg.faults` (with their
messengers, and the cluster case on each package's MiniCluster, the
port's with `device="cpu"`) and compares at tolerance 0 what each
produced: the delivered sequences, the fault digests, the fault counts,
the pending and released counts on one clock, the drop totals and the
resets.  The reference's assertions then hold on the port's result.
tests/test_messenger.py::test_inject_socket_failures_drops (the
`ms_inject_socket_failures` shim) is held the same way.
"""
import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.msg import faults as ref_faults
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.msg import faults as port_faults
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.msg import messenger as port_messenger
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NS = {
    "ref": dict(faults=ref_faults, ms=ref_messenger, msgs=ref_messages,
                config=ref_config, cluster=RefCluster, kw={}),
    "port": dict(faults=port_faults, ms=port_messenger, msgs=port_messages,
                 config=port_config, cluster=PortCluster,
                 kw={"device": "cpu"}),
}


class Msg:
    """Minimal message for raw-plane tests."""
    def __init__(self, n=0, type_name="X"):
        self.n = n
        self.type_name = type_name


def plane(ns, seed=0, clock=None):
    fp = ns["faults"].FaultPlane
    return fp(seed=seed) if clock is None else fp(seed=seed, clock=clock)


def drive(p, n=30, src="a", dst="b", type_name="X"):
    got = []
    for i in range(n):
        p.intercept(src, dst, Msg(i, type_name),
                    lambda s, d, m: got.append(m.n))
    return got


def both(scenario):
    """The scenario's result in each package; they must be equal."""
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


# ---------------------------------------------------------- determinism
def test_same_seed_same_fault_sequence_and_digest():
    def s(ns):
        runs = []
        for seed in (42, 42, 43):
            p = plane(ns, seed=seed)
            p.add_rule("a", "b", drop=0.4)
            runs.append((drive(p), p.digest(), dict(p.counts)))
        return runs
    runs = both(s)
    assert runs[0] == runs[1] and runs[2] != runs[0]


def test_digest_insensitive_to_cross_link_interleaving():
    def s(ns):
        pa, pb = plane(ns, seed=1), plane(ns, seed=1)
        pa.add_rule("*", "*", drop=0.3)
        pb.add_rule("*", "*", drop=0.3)
        for i in range(10):
            pa.intercept("x", "y", Msg(i), lambda *a: None)
        for i in range(10):
            pa.intercept("y", "x", Msg(i), lambda *a: None)
        for i in range(10):
            pb.intercept("x", "y", Msg(i), lambda *a: None)
            pb.intercept("y", "x", Msg(i), lambda *a: None)
        return pa.digest(), pb.digest(), list(pa.log)
    da, db, _log = both(s)
    assert da == db


def test_probabilistic_drop_produces_bursts():
    def s(ns):
        p = plane(ns, seed=0)
        p.add_rule("a", "b", drop=0.5)
        return drive(p, 100), p.digest()
    delivered, _ = both(s)
    gaps = [i for i in range(99)
            if i not in delivered and i + 1 not in delivered]
    assert gaps


# ------------------------------------------------------------ partition
def test_asymmetric_partition_is_one_directional():
    def s(ns):
        p = plane(ns)
        p.partition(["a"], ["b"], symmetric=False)
        return (drive(p, 5, "a", "b"), drive(p, 5, "b", "a"),
                dict(p.counts), p.digest())
    ab, ba, counts, _ = both(s)
    assert ab == [] and ba == [0, 1, 2, 3, 4]
    assert counts["partition"] == 5


def test_heal_restores_and_releases_held():
    def s(ns):
        t = [100.0]
        p = plane(ns, clock=lambda: t[0])
        ids = p.partition(["a"], ["b"])
        rid = p.add_rule("c", "d", delay=5.0)
        held = []
        p.intercept("c", "d", Msg(7), lambda s, d, m: held.append(m.n))
        before = (list(held), p.pending())
        p.deliver_cb = lambda s, d, m: held.append(m.n)
        p.heal(ids + [rid])
        return (ids, rid, before, held, p.pending(),
                drive(p, 2, "a", "b"), len(p.rules()), p.digest())
    _ids, _rid, before, held, pending, after, n_rules, _ = both(s)
    assert before == ([], 1) and held == [7] and pending == 0
    assert after == [0, 1] and n_rules == 0


def test_isolate_cuts_both_directions():
    def s(ns):
        p = plane(ns)
        p.isolate("osd.3")
        return (drive(p, 3, "osd.3", "mon.0"), drive(p, 3, "mon.0", "osd.3"),
                drive(p, 3, "osd.1", "mon.0"), p.digest())
    out, inc, other, _ = both(s)
    assert out == [] and inc == [] and other == [0, 1, 2]


# --------------------------------------------------------- delay/reorder
def test_delay_holds_until_clock_passes():
    def s(ns):
        t = [50.0]
        p = plane(ns, clock=lambda: t[0])
        p.add_rule("a", "b", delay=2.0)
        got = []
        deliver = lambda s, d, m: got.append(m.n)   # noqa: E731
        p.intercept("a", "b", Msg(1), deliver)
        early = (list(got), p.pending(), p.flush(deliver))
        t[0] = 52.5
        return early, p.flush(deliver), got, p.digest()
    early, released, got, _ = both(s)
    assert early == ([], 1, 0) and released == 1 and got == [1]


def test_jittered_delay_is_seeded():
    def s(ns):
        out = []
        for _ in range(2):
            t = [0.0]
            p = plane(ns, seed=9, clock=lambda: t[0])
            p.add_rule("a", "b", delay=1.0, jitter=1.0)
            p.intercept("a", "b", Msg(0), lambda *a: None)
            # the drawn delay rides the digest and the log (6dp)
            out.append((p.digest(), list(p.log), p._held[0][0]))
        return out
    runs = both(s)
    assert runs[0] == runs[1]
    assert 1.0 <= runs[0][2] < 2.0


def test_reorder_window_releases_shuffled_deterministically():
    def s(ns):
        out = []
        for _ in range(2):
            p = plane(ns, seed=5)
            p.add_rule("a", "b", reorder=4)
            out.append((drive(p, 8), p.digest(), list(p.log)))
        return out
    (order1, d1, _), (order2, d2, _) = both(s)
    assert order1 == order2 and d1 == d2
    assert sorted(order1) == list(range(8)) and order1 != list(range(8))


def test_partial_reorder_window_latches_out():
    def s(ns):
        t = [10.0]
        p = plane(ns, seed=5, clock=lambda: t[0])
        p.add_rule("a", "b", reorder=10)
        got = drive(p, 3)
        pending = p.pending()
        t[0] += 1.0                             # past REORDER_LATCH_S
        released = []
        p.flush(lambda s, d, m: released.append(m.n))
        return got, pending, released, p.digest()
    got, pending, released, _ = both(s)
    assert got == [] and pending == 3 and sorted(released) == [0, 1, 2]
    assert port_faults.REORDER_LATCH_S == ref_faults.REORDER_LATCH_S


def test_dup_delivers_twice():
    def s(ns):
        p = plane(ns, seed=0)
        p.add_rule("a", "b", dup=1.0)
        return drive(p, 3), dict(p.counts), p.digest()
    got, counts, _ = both(s)
    assert got == [0, 0, 1, 1, 2, 2] and counts["dup"] == 3


def test_type_filter_scopes_the_rule():
    def s(ns):
        p = plane(ns)
        p.partition(["a"], ["b"], symmetric=False, types=("Ping",))
        return (drive(p, 2, type_name="Ping"),
                drive(p, 2, type_name="MOSDOp"), p.digest())
    ping, op, _ = both(s)
    assert ping == [] and op == [0, 1]


# ----------------------------------------------------- network wiring
def test_localnetwork_drop_ring_bounded_total_monotonic():
    def s(ns):
        cfg, ms = ns["config"](), ns["ms"]
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", "local", threaded=False)
        ms.Messenger.create(net, "b", "local", threaded=False)
        try:
            cfg.set("ms_inject_socket_failures", 1)   # p=1: drop all
            n = ms.DROP_RING + 50
            sent = [a.connect("b").send_message(ns["msgs"].Ping(epoch=i))
                    for i in range(n)]
            return (n, sent, net.drops_total, len(net.dropped),
                    net.faults.digest())
        finally:
            cfg.set("ms_inject_socket_failures", 0)
    n, sent, total, ring, _ = both(s)
    assert total == n and ring == port_messenger.DROP_RING
    assert not any(sent)


def test_partition_is_silent_no_resets():
    def s(ns):
        ms = ns["ms"]
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", "local", threaded=False)
        b = ms.Messenger.create(net, "b", "local", threaded=False)
        resets = []

        class D:
            def ms_dispatch(self, m):
                return True

            def ms_handle_reset(self, peer):
                resets.append(peer)
        a.add_dispatcher(D())
        b.add_dispatcher(D())
        net.faults.partition(["a"], ["b"])
        ok = a.connect("b").send_message(ns["msgs"].Ping())
        return ok, resets, net.drops_total, net.faults.digest()
    ok, resets, total, _ = both(s)
    assert ok is False and resets == [] and total == 1


def test_drops_total_exported_through_perf_dump():
    """The drop ledger rides the OSD perf counters up to the mon's
    `osd perf dump`, alike in both packages."""
    def s(ns):
        c = ns["cluster"](n_osd=3, threaded=False, **ns["kw"])
        c.pump()
        c.wait_all_up()
        try:
            r = c.rados()
            r.pool_create("p", pg_num=8)
            c.pump()
            rid = c.network.faults.add_rule(
                "osd.*", "osd.*", drop=1.0, types=("Ping",))
            now = 50_000.0
            c.tick(now)
            c.network.faults.heal([rid])
            now += 11.0
            c.tick(now)
            rc, _, out = c.mon.handle_command({"prefix": "osd perf dump"})
            return (rc, c.network.drops_total, dict(c.network.faults.counts),
                    c.network.faults.digest(),
                    sorted((k, v.get("msgr_drops_total"))
                           for k, v in out.items()))
        finally:
            c.shutdown()
    rc, total, _counts, _digest, vals = both(s)
    assert rc == 0 and total > 0
    assert any(v == total for _k, v in vals), vals


def test_inject_socket_failures_drops():
    """tests/test_messenger.py::test_inject_socket_failures_drops: the
    shim is a seeded 1/N drop per message with resets both ways."""
    def s(ns):
        cfg, ms = ns["config"](), ns["ms"]
        out = []
        try:
            cfg.set("ms_inject_socket_failures", 3)
            for _ in range(2):
                net = ms.LocalNetwork()
                a = ms.Messenger.create(net, "a", "local", threaded=False)
                b = ms.Messenger.create(net, "b", "local", threaded=False)
                got, resets = [], []

                class C:
                    def ms_dispatch(self, m):
                        got.append(m.epoch)
                        return True

                    def ms_handle_reset(self, peer):
                        resets.append(peer)
                b.add_dispatcher(C())
                sent = [a.connect("b").send_message(ns["msgs"].Ping(
                    epoch=i)) for i in range(60)]
                b.poll()
                out.append((sent, got, resets, net.drops_total,
                            len(net.dropped), net.faults.digest()))
        finally:
            cfg.set("ms_inject_socket_failures", 0)
        return out
    (sent, got, resets, total, ring, _), again = both(s)
    dropped = sent.count(False)
    assert 0 < dropped < 60 and dropped == ring == total
    assert dropped + len(got) == 60
    assert len([p for p in resets if p == "a"]) == dropped
    assert again[0] == sent


@pytest.mark.parametrize("kw", [{"drop": 1.5}, {"dup": -0.1}])
def test_probability_out_of_range_is_refused(kw):
    for ns in NS.values():
        with pytest.raises(ValueError, match="probability"):
            plane(ns).add_rule("a", "b", **kw)
