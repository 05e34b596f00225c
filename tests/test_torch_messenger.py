"""The port's messenger, fault plane and cluster messages held to the
reference's.

Each transport case runs the same script on `ceph_tpu.msg` and on
`ceph_tpu_torch.msg` (tests/test_messenger.py's cases, scaled to what
the port carries) and compares what the dispatchers saw: threaded and
polled delivery, FIFO order and bounded polls, a send to an unknown or
shut-down peer (the sender's reset), the filter hook (drop ring, drop
count, resets on both sides) and the pass-through fault plane.  Each
message the port added for its cluster frames to the reference's bytes
(the dencoder sample carried across) and each package decodes the
other's frame.
"""
import threading
import time

import pytest

from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu.msg import faults as ref_faults
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.tools import dencoder
from ceph_tpu_torch.msg import encoding as port_wire
from ceph_tpu_torch.msg import faults as port_faults
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.msg import messenger as port_messenger

port_wire.ensure_registered()
PKGS = {"ref": (ref_messenger, ref_messages, ref_faults),
        "port": (port_messenger, port_messages, port_faults)}

#: the messages of the port's cluster beside the four EC sub-ops
CLUSTER_MESSAGES = [
    "BackfillReserve", "MMap", "MMonCommand", "MMonCommandAck",
    "MMonSubscribe", "MOSDBoot", "MOSDFailure", "MOSDPGTemp", "MPGStats",
    "MPaxosAccept", "MPaxosBegin", "MPaxosCommit", "MPaxosStoreSync",
    "OSDOp", "OSDOpReply", "PGLogPush", "PGLogReq", "PGNotify", "PGPush",
    "PGQuery", "PGRemove", "PGScan", "PGScanReply", "Ping", "PingReply"]


def _collector(ms_mod):
    class Collector(ms_mod.Dispatcher):
        def __init__(self):
            self.msgs = []
            self.resets = []
            self.event = threading.Event()

        def ms_dispatch(self, msg):
            self.msgs.append(msg)
            self.event.set()
            return True

        def ms_handle_reset(self, peer):
            self.resets.append(peer)
    return Collector()


def _wait(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.005)
    return False


def both(script):
    out = {k: script(*mods) for k, mods in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_threaded_send_receive():
    def script(ms, msgs, _f):
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "osd.0", "local")
        b = ms.Messenger.create(net, "osd.1", "local")
        ca, cb = _collector(ms), _collector(ms)
        a.add_dispatcher(ca)
        b.add_dispatcher(cb)
        a.start()
        b.start()
        try:
            sent = a.connect("osd.1").send_message(msgs.Ping(epoch=3))
            assert _wait(lambda: len(cb.msgs) == 1)
            got = cb.msgs[0]
            b.connect(got.src).send_message(msgs.PingReply(epoch=3))
            assert _wait(lambda: len(ca.msgs) == 1)
            return (sent, got.type_name, got.epoch, got.src,
                    got.seq > 0, ca.msgs[0].type_name)
        finally:
            a.shutdown()
            b.shutdown()
    assert both(script) == (True, "Ping", 3, "osd.0", True, "PingReply")


def test_threaded_dispatch_error_is_counted_and_served_past():
    """A handler that raises on a dispatch thread is logged and the loop
    keeps serving, as in the reference; the port also counts it in
    dispatch_errors, with its traceback, so it cannot pass unseen."""
    ms, msgs = port_messenger, port_messages

    class Faulty(ms.Dispatcher):
        def __init__(self):
            self.seen = []

        def ms_dispatch(self, msg):
            if msg.epoch == 1:
                raise RuntimeError("gf_matmul_k1 launch failed")
            self.seen.append(msg.epoch)
            return True
    net = ms.LocalNetwork()
    a = ms.Messenger.create(net, "a")
    b = ms.Messenger.create(net, "b")
    d = Faulty()
    b.add_dispatcher(d)
    b.start()
    try:
        for i in range(3):
            a.connect("b").send_message(msgs.Ping(epoch=i))
        assert _wait(lambda: len(d.seen) == 2)
        assert d.seen == [0, 2]
        assert net.dispatch_errors == 1
        assert net.last_dispatch_error.startswith("b: ")
        assert "gf_matmul_k1 launch failed" in net.last_dispatch_error
        assert net.routed == 3
    finally:
        a.shutdown()
        b.shutdown()


def test_polled_mode_is_fifo_and_bounded():
    def script(ms, msgs, _f):
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", "local", threaded=False)
        b = ms.Messenger.create(net, "b", "local", threaded=False)
        cb = _collector(ms)
        b.add_dispatcher(cb)
        for i in range(5):
            a.connect("b").send_message(msgs.Ping(epoch=i))
        before = list(cb.msgs)
        first = b.poll(2)
        mid = [m.epoch for m in cb.msgs]
        rest = b.poll()
        return (before, first, mid, rest, [m.epoch for m in cb.msgs],
                b.poll())
    assert both(script) == ([], 2, [0, 1], 3, [0, 1, 2, 3, 4], 0)


def test_interleaved_senders_keep_per_link_order():
    def script(ms, msgs, _f):
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", threaded=False)
        b = ms.Messenger.create(net, "b", threaded=False)
        c = ms.Messenger.create(net, "c", threaded=False)
        cc = _collector(ms)
        c.add_dispatcher(cc)
        for i in range(4):
            a.connect("c").send_message(msgs.Ping(epoch=i))
            b.connect("c").send_message(msgs.Ping(epoch=10 + i))
        c.poll()
        return [(m.src, m.epoch) for m in cc.msgs]
    assert both(script)[:2] == [("a", 0), ("b", 10)]


def test_send_to_unknown_peer_resets():
    def script(ms, msgs, _f):
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", "local", threaded=False)
        ca = _collector(ms)
        a.add_dispatcher(ca)
        return a.connect("ghost").send_message(msgs.Ping()), ca.resets
    assert both(script) == (False, ["ghost"])


def test_duplicate_bind_rejected():
    def script(ms, _m, _f):
        net = ms.LocalNetwork()
        ms.Messenger.create(net, "osd.0", "local")
        with pytest.raises(ValueError):
            ms.Messenger.create(net, "osd.0", "local")
        return True
    assert both(script)


def test_shutdown_unregisters_and_marks_the_peer_down():
    def script(ms, msgs, _f):
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", "local", threaded=False)
        ca = _collector(ms)
        a.add_dispatcher(ca)
        b = ms.Messenger.create(net, "b", "local")
        b.start()
        b.shutdown()
        sent = a.connect("b").send_message(msgs.Ping())
        again = ms.Messenger.create(net, "b", "local", threaded=False)
        delivered = a.connect("b").send_message(msgs.Ping(epoch=7))
        return (sent, ca.resets, net.lookup("b") is again, delivered,
                again.poll())
    assert both(script) == (False, ["b"], True, True, 1)


def test_filter_hook_drops_and_resets_both_sides():
    def script(ms, msgs, _f):
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", "local", threaded=False)
        b = ms.Messenger.create(net, "b", "local", threaded=False)
        ca, cb = _collector(ms), _collector(ms)
        a.add_dispatcher(ca)
        b.add_dispatcher(cb)
        net.filter = lambda src, dst, msg: not (
            msg.type_name == "Ping" and msg.epoch == 1)
        sent = [a.connect("b").send_message(msgs.Ping(epoch=i))
                for i in range(3)]
        b.poll()
        return (sent, [m.epoch for m in cb.msgs], net.drops_total,
                [(s, d, m.epoch) for s, d, m in net.dropped],
                ca.resets, cb.resets)
    assert both(script) == ([True, False, True], [0, 2], 1,
                            [("a", "b", 1)], ["b"], ["a"])


def test_fault_plane_without_rules_passes_through():
    def script(ms, msgs, faults):
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", threaded=False)
        b = ms.Messenger.create(net, "b", threaded=False)
        cb = _collector(ms)
        b.add_dispatcher(cb)
        now = [100.0]
        net.faults.clock = lambda: now[0]
        for i in range(3):
            a.connect("b").send_message(msgs.Ping(epoch=i))
        held = net.faults.pending()
        released = net.faults.flush()
        queued = b.poll()
        seen = []
        eff = net.faults.intercept(
            "x", "y", msgs.Ping(epoch=9),
            lambda s, d, m: seen.append((s, d, m.epoch)))
        return (held, released, queued, [m.epoch for m in cb.msgs],
                eff.verdict, eff.dropped, eff.reset, seen,
                net.faults.deliver_cb is not None,
                isinstance(net.faults, faults.FaultPlane))
    assert both(script) == (0, 0, 3, [0, 1, 2], "deliver", False,
                            False, [("x", "y", 9)], True, True)


def test_unhandled_message_is_dropped_after_every_dispatcher():
    def script(ms, msgs, _f):
        class No(ms.Dispatcher):
            def __init__(self):
                self.seen = 0

            def ms_dispatch(self, msg):
                self.seen += 1
                return False
        net = ms.LocalNetwork()
        a = ms.Messenger.create(net, "a", threaded=False)
        b = ms.Messenger.create(net, "b", threaded=False)
        d1, d2 = No(), No()
        b.add_dispatcher(d1)
        b.add_dispatcher(d2)
        a.connect("b").send_message(msgs.Ping())
        return b.poll(), d1.seen, d2.seen
    assert both(script) == (1, 1, 1)


def _carry(obj):
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(_carry(v) for v in obj)
    if isinstance(obj, dict):
        return {_carry(k): _carry(v) for k, v in obj.items()}
    info = ref_wire._by_cls.get(type(obj))
    if info is None:
        return obj
    port = port_wire._by_name[info.name]
    return port.from_fields([_carry(v) for v in info.to_fields(obj)])


@pytest.mark.parametrize("name", CLUSTER_MESSAGES)
def test_cluster_message_frames_equal_the_reference(name):
    sample = dencoder.sample(name)
    ported = _carry(sample)
    assert type(ported) is getattr(port_messages, name)
    frame = port_wire.encode_message(ported)
    assert frame == ref_wire.encode_message(sample)
    back = ref_wire.decode_message(frame)
    assert type(back) is type(sample)
    assert ref_wire.encode_message(back) == frame
    again = port_wire.decode_message(ref_wire.encode_message(sample))
    assert type(again) is type(ported)
    assert port_wire.encode_message(again) == frame
