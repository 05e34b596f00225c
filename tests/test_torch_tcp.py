"""The port's TCP transport (ceph_tpu_torch.msg.tcp), mirroring the
reference's tests/test_tcp.py (the cluster case on an EC k=2 m=1 pool
over 4 OSDs, where the reference's uses a replicated one; the
multi-process
case is tests/test_torch_daemon_main.py's), plus the cross-package
checks: the frames a port endpoint puts on the wire equal the
reference's byte for byte, plain and compressed; a port TcpMessenger and
a reference one exchange Ping/PingReply and an ECSubWrite, plain and in
secure mode; and a handler error a reader thread survives is counted in
`TcpNet.dispatch_errors`.

Every test of this file (and of the other TCP files, which import
`deadline`) fails after TEST_TIMEOUT_S instead of hanging its worker.
"""
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg.messenger import Messenger as RefMessenger
from ceph_tpu.msg.tcp import TcpNet as RefTcpNet
from ceph_tpu.tools import dencoder
from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.msg import encoding
from ceph_tpu_torch.msg.messages import ECSubWrite, Ping, PingReply, PGPush
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.msg.tcp import TcpNet, pick_free_ports, recv_frame
from test_torch_wire import carry, value_eq

TEST_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def deadline():
    """Fail the test after TEST_TIMEOUT_S (SIGALRM in the main thread)."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran over {TEST_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class Collector(Dispatcher):
    def __init__(self):
        self.got = []
        self.resets = []

    def ms_dispatch(self, msg):
        self.got.append(msg)
        return True

    def ms_handle_reset(self, peer):
        self.resets.append(peer)


def wait_for(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def make_net(names, cls=TcpNet, **kw):
    ports = pick_free_ports(len(names))
    return cls({n: ("127.0.0.1", p) for n, p in zip(names, ports)}, **kw)


# ------------------------------------------------- the reference's cases
def test_tcp_send_receive_roundtrip():
    net = make_net(["a", "b"])
    ma, mb = Messenger.create(net, "a"), Messenger.create(net, "b")
    ca, cb = Collector(), Collector()
    ma.add_dispatcher(ca)
    mb.add_dispatcher(cb)
    ma.start()
    mb.start()
    try:
        assert ma.connect("b").send_message(Ping(epoch=7, stamp=1.5))
        assert wait_for(lambda: cb.got)
        msg = cb.got[0]
        assert isinstance(msg, Ping) and msg.epoch == 7
        assert msg.src == "a" and msg.seq == 1
        assert mb.connect("a").send_message(PingReply(stamp=msg.stamp))
        assert wait_for(lambda: ca.got)
        assert isinstance(ca.got[0], PingReply)
    finally:
        ma.shutdown()
        mb.shutdown()


def test_tcp_numpy_payloads_and_ordering():
    net = make_net(["x", "y"])
    mx, my = Messenger.create(net, "x"), Messenger.create(net, "y")
    cy = Collector()
    my.add_dispatcher(cy)
    mx.start()
    my.start()
    try:
        blobs = [np.random.default_rng(i).integers(
            0, 256, 10_000, dtype=np.uint8).tobytes() for i in range(20)]
        for i, b in enumerate(blobs):
            assert mx.connect("y").send_message(PGPush(oid=f"o{i}", data=b))
        assert wait_for(lambda: len(cy.got) == 20)
        assert [m.oid for m in cy.got] == [f"o{i}" for i in range(20)]
        assert all(m.data == b for m, b in zip(cy.got, blobs))
    finally:
        mx.shutdown()
        my.shutdown()


def test_tcp_dead_peer_resets():
    net = make_net(["p", "q"])
    mp = Messenger.create(net, "p")
    cp = Collector()
    mp.add_dispatcher(cp)
    mp.start()
    try:
        assert not mp.connect("q").send_message(Ping())   # never bound
        assert cp.resets == ["q"]
        assert not mp.connect("nobody").send_message(Ping())
    finally:
        mp.shutdown()


def test_cluster_over_tcp_in_process():
    """mon + 4 OSDs + client, each on its own socket (one process), an
    EC k=2 m=1 pool.  The reference's last check, `io.list_objects()`,
    is left out: the port's librados has no object listing yet."""
    from ceph_tpu_torch.mon.monitor import Monitor, build_initial
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    names = ["mon.0"] + [f"osd.{i}" for i in range(4)] + ["client.900"]
    net = make_net(names)
    m, w = build_initial(4, osds_per_host=1)
    mon = Monitor(net, initial_map=m, initial_wrapper=w, device="cpu")
    mon.init()
    osds = [OSDDaemon(net, i, device="cpu") for i in range(4)]
    for d in osds:
        d.init()
    r = Rados(net, name="client.900").connect(10.0)
    try:
        assert wait_for(lambda: all(d.osdmap.epoch >= 1 for d in osds))
        assert wait_for(lambda: sum(r.objecter.osdmap.is_up(o)
                                    for o in range(4)) == 4)
        r.pool_create("p", pg_num=8, pool_type="erasure")
        io = r.open_ioctx("p")
        payload = os.urandom(50_000)
        io.write_full("sock-obj", payload)
        assert io.read("sock-obj") == payload
        assert io.stat("sock-obj")["size"] == len(payload)
        # a heartbeat tick over TCP (the port's tick once read the
        # LocalNetwork-only drop total and raised on a TcpNet)
        for d in osds:
            d.heartbeat_tick()
        assert net.dispatch_errors == 0 and net.frames_sent > 0
    finally:
        r.shutdown()
        for d in osds:
            d.shutdown()
        mon.shutdown()


# ------------------------------------------------- across the packages
def _capture(net_cls, messenger, compress, msg):
    """The raw frame one endpoint of `net_cls` puts on the wire for
    `msg` (the first send of a fresh endpoint: seq 1)."""
    ports = pick_free_ports(2)
    addrs = {"osd.0": ("127.0.0.1", ports[0]),
             "osd.1": ("127.0.0.1", ports[1])}
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(addrs["osd.1"])
    lsock.listen(1)
    got = {}
    done = threading.Event()

    def sniff():
        conn, _ = lsock.accept()
        got["frame"] = recv_frame(conn)
        done.set()
        conn.close()

    threading.Thread(target=sniff, daemon=True).start()
    ms = messenger.create(net_cls(addrs, compress=compress,
                                  compress_min=64), "osd.0")
    ms.start()
    try:
        assert ms.connect("osd.1").send_message(msg)
        assert done.wait(10)
    finally:
        ms.shutdown()
        lsock.close()
    return got["frame"]


@pytest.mark.parametrize("compress", [None, "zlib"])
@pytest.mark.parametrize("name", ["Ping", "ECSubWrite", "OSDOp",
                                  "MAuthRequest"])
def test_frames_on_the_wire_equal_the_references(name, compress):
    sample = dencoder.sample(name)
    ref = _capture(RefTcpNet, RefMessenger, compress, sample)
    port = _capture(TcpNet, Messenger, compress, carry(sample))
    assert port == ref
    assert len(port) > 8


def _interop_pair(secure, compress, port_first):
    names = ["osd.0", "osd.1"]
    ports = pick_free_ports(2)
    addrs = {n: ("127.0.0.1", p) for n, p in zip(names, ports)}
    kw = dict(secure_secret=secure, compress=compress, compress_min=256)
    port_ms = Messenger.create(TcpNet(addrs, **kw), names[0])
    ref_ms = RefMessenger.create(RefTcpNet(addrs, **kw), names[1])
    return port_ms, ref_ms


@pytest.mark.parametrize("secure,compress", [(None, None),
                                             ("cluster-key", None),
                                             ("cluster-key", "zlib")])
def test_port_and_reference_endpoints_talk(secure, compress):
    port_ms, ref_ms = _interop_pair(secure, compress, True)
    cport, cref = Collector(), Collector()
    port_ms.add_dispatcher(cport)
    ref_ms.add_dispatcher(cref)
    port_ms.start()
    ref_ms.start()
    try:
        sample = dencoder.sample("ECSubWrite")
        assert port_ms.connect("osd.1").send_message(Ping(epoch=3,
                                                          stamp=2.5))
        assert port_ms.connect("osd.1").send_message(carry(sample))
        assert wait_for(lambda: len(cref.got) == 2)
        ping, sub = cref.got
        assert isinstance(ping, ref_messages.Ping) and ping.epoch == 3
        assert isinstance(sub, ref_messages.ECSubWrite)
        assert sub.src == "osd.0" and sub.seq == 2
        assert value_eq(carry(sub), carry(sample))
        assert ref_ms.connect("osd.0").send_message(
            ref_messages.PingReply(epoch=3, stamp=ping.stamp))
        assert ref_ms.connect("osd.0").send_message(sample)
        assert wait_for(lambda: len(cport.got) == 2)
        reply, back = cport.got
        assert isinstance(reply, PingReply) and reply.stamp == 2.5
        assert isinstance(back, ECSubWrite)
        assert value_eq(back, carry(sample))
    finally:
        port_ms.shutdown()
        ref_ms.shutdown()


# ----------------------------------------------------------------- the pin
def test_handler_error_is_counted_and_served_past():
    """A handler that raises on a reader thread is logged and served
    past, as the reference does, and counted in the net's
    dispatch_errors with its traceback in last_dispatch_error."""
    net = make_net(["a", "b"])
    ma, mb = Messenger.create(net, "a"), Messenger.create(net, "b")
    got = []

    class Flaky(Dispatcher):
        def ms_dispatch(self, msg):
            if msg.epoch == 1:
                raise RuntimeError("gf_matmul_k1 launch failed: "
                                   "an illegal memory access")
            got.append(msg)
            return True

    mb.add_dispatcher(Flaky())
    ma.start()
    mb.start()
    try:
        assert ma.connect("b").send_message(Ping(epoch=1))
        assert ma.connect("b").send_message(Ping(epoch=2))
        assert wait_for(lambda: got)
        assert [m.epoch for m in got] == [2]
        assert net.dispatch_errors == 1
        assert net.last_dispatch_error.startswith("b: ")
        assert "gf_matmul_k1 launch failed" in net.last_dispatch_error
    finally:
        ma.shutdown()
        mb.shutdown()


def test_frame_helpers_equal_the_references():
    from ceph_tpu.msg import encoding as ref_encoding
    for name in ("Ping", "ECSubWrite", "MMonCommand"):
        sample = dencoder.sample(name)
        assert encoding.encode_message(carry(sample)) == \
            ref_encoding.encode_message(sample)
