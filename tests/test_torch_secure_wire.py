"""The port's secure wire mode (ceph_tpu_torch.msg.secure and the sealed
frames of ceph_tpu_torch.msg.tcp), mirroring the reference's
tests/test_secure_wire.py case for case (the cluster case on an EC
k=2 m=1 pool over 4 OSDs, where the reference's uses a replicated
one), plus
the cross-package checks: a frame the port seals opens in the
reference and the reverse, for the raw session and the per-connection
KEX protocol, and the sealing is byte-for-byte the reference's under
the same nonce and keys."""
import os
import socket
import threading
import time

import pytest

from ceph_tpu.msg import secure as ref_secure
from ceph_tpu_torch.msg import secure
from ceph_tpu_torch.msg.secure import SecureConn, SecureSession
from ceph_tpu_torch.msg.messages import OSDOp
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.msg.tcp import (MAX_FRAME, TcpNet, pick_free_ports,
                                    recv_frame, send_frame)
from test_torch_tcp import deadline  # noqa: F401  (per-test timeout)


class Sink(Dispatcher):
    def __init__(self, want: int = 1):
        self.got = []
        self.ev = threading.Event()
        self.want = want

    def ms_dispatch(self, msg):
        self.got.append(msg)
        if len(self.got) >= self.want:
            self.ev.set()
        return True

    def ms_handle_reset(self, peer):
        pass


def two_addrs():
    ports = pick_free_ports(2)
    return {"osd.0": ("127.0.0.1", ports[0]),
            "osd.1": ("127.0.0.1", ports[1])}


# ------------------------------------------------- the reference's cases
def test_session_roundtrip_and_tamper():
    s = SecureSession("s3cret", "frame")
    for size in (0, 1, 100, 5000, 1 << 16):
        pt = bytes(range(256)) * (size // 256) + b"x" * (size % 256)
        blob = s.seal(pt)
        assert blob != pt
        assert s.open(blob) == pt
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 1
        assert s.open(bytes(bad)) is None
    other = SecureSession("wrong", "frame")
    assert other.open(s.seal(b"secret data")) is None
    assert s.seal(b"same") != s.seal(b"same")


def test_no_plaintext_on_the_wire():
    addrs = two_addrs()
    marker = b"TOP-SECRET-PAYLOAD-MARKER"
    captured = {}
    done = threading.Event()
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(addrs["osd.1"])
    lsock.listen(1)

    def sniff():
        conn, _ = lsock.accept()
        sc = SecureConn("cluster-key", initiator=False)
        captured["kex"] = recv_frame(conn)
        assert sc.ingest_kex(captured["kex"])
        send_frame(conn, sc.kex_frame())
        captured["frame"] = recv_frame(conn)
        done.set()
        conn.close()

    threading.Thread(target=sniff, daemon=True).start()
    ms = Messenger.create(TcpNet(addrs, secure_secret="cluster-key"),
                          "osd.0")
    ms.start()
    try:
        assert ms.connect("osd.1").send_message(
            OSDOp(oid="o", op="write", data=marker))
        assert done.wait(10)
        assert marker not in captured["kex"]
        assert marker not in captured["frame"]
    finally:
        ms.shutdown()
        lsock.close()


def test_secure_endpoints_interoperate_and_reject_plaintext():
    from ceph_tpu_torch.msg.encoding import encode_message
    addrs = two_addrs()
    net = TcpNet(addrs, secure_secret="cluster-key")
    a, b = Messenger.create(net, "osd.0"), Messenger.create(net, "osd.1")
    db = Sink()
    b.add_dispatcher(db)
    a.add_dispatcher(Sink())
    a.start()
    b.start()
    try:
        assert a.connect("osd.1").send_message(
            OSDOp(oid="x", op="write", data=b"over the sealed wire"))
        assert db.ev.wait(10)
        assert db.got[0].data == b"over the sealed wire"
        db.ev.clear()
        db.got.clear()
        raw = socket.create_connection(addrs["osd.1"], timeout=5)
        send_frame(raw, encode_message(OSDOp(oid="evil", op="write")))
        assert not db.ev.wait(0.5)
        assert not db.got
        raw.close()
    finally:
        a.shutdown()
        b.shutdown()


def test_secure_cluster_io():
    """mon + 4 OSDs + client over sealed TCP frames, an EC k=2 m=1
    pool (the reference's case uses a replicated pool on 3 OSDs)."""
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.mon.monitor import Monitor, build_initial
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    names = ["mon.0"] + [f"osd.{i}" for i in range(4)]
    ports = pick_free_ports(len(names))
    net = TcpNet({n: ("127.0.0.1", p) for n, p in zip(names, ports)},
                 secure_secret="cluster-secret")
    m, w = build_initial(4, osds_per_host=1)
    mon = Monitor(net, rank=0, initial_map=m, initial_wrapper=w,
                  device="cpu")
    mon.init()
    osds = [OSDDaemon(net, i, threaded=True, device="cpu")
            for i in range(4)]
    for d in osds:
        d.init()
    r = Rados(net, name="client.960", op_timeout=15.0)
    try:
        r.connect(30.0)
        end = time.monotonic() + 30
        while time.monotonic() < end and sum(
                r.objecter.osdmap.is_up(o) for o in range(4)) < 4:
            time.sleep(0.05)
        r.pool_create("sec", pg_num=8, pool_type="erasure")
        io = r.open_ioctx("sec")
        payload = os.urandom(100_000)
        io.write_full("sealed", payload)
        assert io.read("sealed") == payload
        assert net.dispatch_errors == 0
    finally:
        r.shutdown()
        for d in osds:
            d.shutdown()
        mon.shutdown()


@pytest.mark.parametrize("secret", [None, "cluster-key"])
def test_onwire_compression_roundtrip(secret):
    addrs = two_addrs()
    net = TcpNet(addrs, secure_secret=secret, compress="zlib",
                 compress_min=1024)
    a, b = Messenger.create(net, "osd.0"), Messenger.create(net, "osd.1")
    db = Sink()
    b.add_dispatcher(db)
    a.add_dispatcher(Sink())
    a.start()
    b.start()
    try:
        payload = b"A" * 200_000
        assert a.connect("osd.1").send_message(
            OSDOp(oid="big", op="write", data=payload))
        assert db.ev.wait(10)
        assert db.got[0].data == payload
        db.ev.clear()
        db.got.clear()
        assert a.connect("osd.1").send_message(
            OSDOp(oid="small", op="write", data=b"tiny"))
        assert db.ev.wait(10)
        assert db.got[0].data == b"tiny"
    finally:
        a.shutdown()
        b.shutdown()


def test_compression_shrinks_wire_bytes():
    addrs = two_addrs()
    captured = {}
    done = threading.Event()
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(addrs["osd.1"])
    lsock.listen(1)

    def sniff():
        conn, _ = lsock.accept()
        captured["frame"] = recv_frame(conn)
        done.set()
        conn.close()

    threading.Thread(target=sniff, daemon=True).start()
    net = TcpNet(addrs, compress="zlib", compress_min=1024)
    ms = Messenger.create(net, "osd.0")
    ms.start()
    try:
        payload = b"B" * 300_000
        assert ms.connect("osd.1").send_message(
            OSDOp(oid="z", op="write", data=payload))
        assert done.wait(10)
        assert len(captured["frame"]) < len(payload) // 10
        assert net.frames_sent == 1
        assert net.bytes_sent == 4 + len(captured["frame"])
    finally:
        ms.shutdown()
        lsock.close()


def test_compressed_bomb_and_garbage_rejected():
    from ceph_tpu_torch import compressor
    bomb = compressor.compress(b"\0" * (2 << 20), "zlib")
    with pytest.raises(ValueError):
        compressor.decompress(bomb, max_len=1 << 20)
    assert compressor.decompress(bomb, max_len=4 << 20) == b"\0" * (2 << 20)
    assert MAX_FRAME == 1 << 30
    addrs = two_addrs()
    net = TcpNet(addrs, compress="zlib", compress_min=64)
    b = Messenger.create(net, "osd.1")
    db = Sink()
    b.add_dispatcher(db)
    b.start()
    a = Messenger.create(net, "osd.0")
    try:
        raw = socket.create_connection(addrs["osd.1"], timeout=5)
        send_frame(raw, b"\x01" + b"ctpz\x01\x04zlib" + b"garbage!!")
        time.sleep(0.3)
        assert not db.got
        a.start()
        assert a.connect("osd.1").send_message(
            OSDOp(oid="ok", op="write", data=b"x" * 200))
        assert db.ev.wait(10)
        raw.close()
    finally:
        a.shutdown()
        b.shutdown()


def test_unknown_compressor_fails_fast():
    ports = pick_free_ports(1)
    with pytest.raises(ValueError):
        Messenger.create(TcpNet({"osd.0": ("127.0.0.1", ports[0])},
                                compress="zstd"), "osd.0")


def _pair(mod=secure, mod_b=None, secret="shared-cluster-secret"):
    a = mod.SecureConn(secret, initiator=True)
    b = (mod_b or mod).SecureConn(secret, initiator=False)
    assert b.ingest_kex(a.kex_frame())
    assert a.ingest_kex(b.kex_frame())
    return a, b


def test_per_session_keys_isolate_sessions():
    a1, b1 = _pair()
    a2, b2 = _pair()
    frame = a1.seal(b"session-one confidential bytes")
    assert b1.open(frame) == b"session-one confidential bytes"
    frame2 = a1.seal(b"again")
    assert b2.open(frame2) is None
    assert a2.open(frame2) is None
    assert a1.open(a1.seal(b"direction test")) is None


def test_replay_and_reorder_rejected():
    a, b = _pair()
    f1, f2 = a.seal(b"one"), a.seal(b"two")
    assert b.open(f1) == b"one"
    assert b.open(f1) is None
    assert b.open(f2) == b"two"
    a2, b2 = _pair()
    g1, g2 = a2.seal(b"x"), a2.seal(b"y")
    assert b2.open(g2) is None
    assert b2.open(g1) == b"x"


def test_kex_requires_cluster_secret():
    import hashlib
    import hmac as _hmac
    good = SecureConn("right-secret", initiator=False)
    evil = SecureConn("WRONG-secret", initiator=True)
    assert not good.ingest_kex(evil.kex_frame())
    body = b"KEX1" + b"\x00" * 16 + (1).to_bytes(secure._PUB_LEN, "big")
    mac = _hmac.new(b"right-secret", b"ms-kex|" + body,
                    hashlib.sha256).digest()[:secure.TAG_LEN]
    assert not good.ingest_kex(body + mac)


def test_rekey_rotates_connection_keys(monkeypatch):
    monkeypatch.setattr(secure, "REKEY_FRAMES", 5)
    addrs = two_addrs()
    a = Messenger.create(TcpNet(addrs, secure_secret="k"), "osd.0")
    b = Messenger.create(TcpNet(addrs, secure_secret="k"), "osd.1")
    db = Sink(want=12)
    b.add_dispatcher(db)
    a.add_dispatcher(Sink())
    a.start()
    b.start()
    try:
        sessions_seen = set()
        for i in range(12):
            assert a.connect("osd.1").send_message(
                OSDOp(oid=f"o{i}", op="write", data=b"d" * 64))
            for s in list(a._sessions.values()):
                sessions_seen.add(id(s))
        assert db.ev.wait(10)
        assert len(db.got) == 12
        assert len(sessions_seen) >= 2, "rekey never rotated the session"
    finally:
        a.shutdown()
        b.shutdown()


# ------------------------------------------------- across the packages
@pytest.mark.parametrize("sealer,opener", [(secure, ref_secure),
                                           (ref_secure, secure)])
def test_session_seal_opens_in_the_other_package(sealer, opener):
    for size in (0, 17, 4096, 70_000):
        pt = os.urandom(size)
        blob = sealer.SecureSession("cluster", "frame").seal(pt)
        assert opener.SecureSession("cluster", "frame").open(blob) == pt


def test_session_seal_bytes_equal_the_references(monkeypatch):
    nonce = bytes(range(secure.NONCE_LEN))
    pt = os.urandom(9000)
    blobs = []
    for mod in (secure, ref_secure):
        monkeypatch.setattr(mod.os, "urandom", lambda n: nonce[:n])
        blobs.append(mod.SecureSession("k", "i2r").seal(pt))
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("initiator,responder", [(secure, ref_secure),
                                                 (ref_secure, secure)])
def test_kex_and_frames_interoperate(initiator, responder):
    a, b = _pair(initiator, responder)
    for i in range(5):
        msg = os.urandom(100 * i + 1)
        assert b.open(a.seal(msg)) == msg
        assert a.open(b.seal(msg)) == msg
    # the other package's replay rule holds too
    f = a.seal(b"once")
    assert b.open(f) == b"once" and b.open(f) is None
