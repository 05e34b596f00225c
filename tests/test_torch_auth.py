"""The port's cephx (ceph_tpu_torch.auth), mirroring the reference's
tests/test_auth.py, plus the cross-package checks: a keyring file loads
in either package, a client of either package authenticates against a
key server of the other, a signature made by one verifies in the other,
and a pump-mode `MiniCluster(auth="cephx")` equals the reference's step
by step, the MAuthRequest/MAuthReply handshake included.

Mirrored with substitutions: `test_entity_class_gating` checks
ECSubWrite beside the reference's RepOpWrite, and
`test_client_ticket_bound_to_src` uses OSDOp where the reference uses
MClientCaps; `test_cephx_cluster_io` runs an EC k=2 m=1 pool over 4
OSDs, with the reference's xattr round trip.  `test_cephx_mds_gate` runs
on both packages' cephx clusters (the harness of
tests/test_torch_cephfs.py) and compares what the clients saw and both
file system pools.
"""
import time

import pytest

from ceph_tpu import auth as ref_auth
from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu_torch.auth import (SERVICE_ENTITY, CephxClient, CephxServer,
                                 CephxVerifier, KeyRing, generate_key)
from ceph_tpu_torch.msg import encoding as wire
from ceph_tpu_torch.msg.messages import (ECSubWrite, MAuthRequest,
                                         MMonSubscribe, MOSDFailure, OSDOp,
                                         RepOpWrite)
from ceph_tpu_torch.msg.messenger import Message
from ceph_tpu_torch.testing import MiniCluster
from test_torch_cephfs import bare_sides, fs_state, run_both  # noqa: F401


def _stamp(msg, src, seq=1):
    msg.src, msg.seq = src, seq
    return msg


def _authed(server_kr, client_cls=CephxClient, server_cls=CephxServer,
            ttl=3600.0, entity="client.x"):
    server = server_cls(server_kr, ticket_ttl=ttl)
    client = client_cls(entity, server_kr.get(entity))
    assert client.ingest_reply(server.handle_request(client.build_request()))
    return server, client


# ------------------------------------------------- the reference's cases
def test_keyring_roundtrip(tmp_path):
    kr = KeyRing.generate(["mon.0", "osd.0", "client.a"])
    path = str(tmp_path / "keyring.json")
    kr.save(path)
    assert KeyRing.load(path).keys == kr.keys
    assert set(kr.subset("osd.0").keys) == {"osd.0", SERVICE_ENTITY}


def test_handshake_and_signatures():
    kr = KeyRing.generate(["client.x"])
    _, client = _authed(kr)
    ver = CephxVerifier(kr.get(SERVICE_ENTITY))
    msg = client.sign(_stamp(OSDOp(oid="o", op="write"), "client.x", 7))
    assert ver.verify(msg)
    msg.seq = 8
    assert not ver.verify(msg)
    assert not ver.verify(_stamp(OSDOp(oid="o"), "client.x"))
    assert ver.verify(_stamp(MAuthRequest(), "client.x"))
    assert (ver.verified, ver.rejected) == (1, 2)


def test_replay_rejected():
    kr = KeyRing.generate(["client.x"])
    _, client = _authed(kr)
    ver = CephxVerifier(kr.get(SERVICE_ENTITY))
    msg = client.sign(_stamp(OSDOp(oid="victim", op="delete"),
                             "client.x", 3))
    assert ver.verify(msg)
    assert not ver.verify(msg)
    assert ver.verify(client.sign(_stamp(OSDOp(oid="o2", op="write"),
                                         "client.x", 4)))
    ver2 = CephxVerifier(kr.get(SERVICE_ENTITY))
    assert ver2.verify(msg)
    assert not ver2.verify(msg)


def test_entity_class_gating():
    kr = KeyRing.generate(["client.x", "osd.1"])
    _, client = _authed(kr)
    ver = CephxVerifier(kr.get(SERVICE_ENTITY))
    assert not ver.verify(client.sign(_stamp(ECSubWrite(oid="o"),
                                             "client.x")))
    assert not ver.verify(client.sign(_stamp(RepOpWrite(oid="o"),
                                             "client.x")))
    assert not ver.verify(client.sign(_stamp(MOSDFailure(target_osd=1),
                                             "client.x")))
    assert ver.verify(client.sign(_stamp(MMonSubscribe(), "client.x", 2)))
    osd = CephxClient.self_mint("osd.1", kr.get(SERVICE_ENTITY))
    assert ver.verify(osd.sign(_stamp(ECSubWrite(oid="o"), "osd.1")))
    assert ver.verify(osd.sign(_stamp(RepOpWrite(oid="o"), "osd.1")))


def test_ticket_renewal():
    kr = KeyRing.generate(["client.x"])
    server, client = _authed(kr, ttl=30.0)
    assert client.needs_renewal
    assert client.should_send_renewal()
    assert not client.should_send_renewal()
    server.ttl = 3600.0
    assert client.ingest_reply(server.handle_request(client.build_request()))
    assert not client.needs_renewal
    ver = CephxVerifier(kr.get(SERVICE_ENTITY))
    assert ver.verify(client.sign(_stamp(OSDOp(oid="o"), "client.x")))
    osd = CephxClient.self_mint("osd.0", kr.get(SERVICE_ENTITY), ttl=0.05)
    stale_ticket = dict(osd.ticket)
    time.sleep(0.1)
    fresh = osd.sign(_stamp(Message(), "osd.0"))
    assert fresh.auth["ticket"] != stale_ticket
    assert ver.verify(fresh)


def test_renew_hook_fires_from_sign():
    import threading
    kr = KeyRing.generate(["client.x"])
    _, client = _authed(kr, ttl=30.0)
    fired = threading.Event()
    client.renew_hook = fired.set
    client.sign(_stamp(OSDOp(oid="o"), "client.x"))
    assert fired.wait(5.0)
    fired.clear()
    client.sign(_stamp(OSDOp(oid="o2"), "client.x", 2))
    time.sleep(0.05)
    assert not fired.is_set()


def test_bad_credentials_rejected():
    kr = KeyRing.generate(["client.x"])
    server = CephxServer(kr)
    bad = CephxClient("client.x", generate_key())
    assert server.handle_request(bad.build_request()).result == -13
    ghost = CephxClient("client.ghost", generate_key())
    assert server.handle_request(ghost.build_request()).result == -1
    forged = CephxClient.self_mint("client.x", generate_key())
    ver = CephxVerifier(kr.get(SERVICE_ENTITY))
    assert not ver.verify(forged.sign(_stamp(Message(), "client.x")))


def test_expired_ticket_rejected():
    kr = KeyRing.generate(["client.x"])
    _, client = _authed(kr, ttl=-1.0)
    ver = CephxVerifier(kr.get(SERVICE_ENTITY))
    assert not ver.verify(client.sign(_stamp(Message(), "client.x")))


def test_cephx_cluster_io():
    from ceph_tpu_torch.client import Rados
    c = MiniCluster(n_osd=4, threaded=True, auth="cephx", device="cpu")
    try:
        c.wait_all_up()
        r = c.rados()
        r.pool_create("authp", pg_num=8, pool_type="erasure")
        io = r.open_ioctx("authp")
        io.write_full("sec", b"signed payload")
        assert io.read("sec") == b"signed payload"
        io.set_xattr("sec", "k", b"v")
        assert io.get_xattr("sec", "k") == b"v"
        bad = Rados(c.network, name="client.evil", mon=c.mon_names,
                    auth_secret=generate_key())
        with pytest.raises(PermissionError):
            bad.connect(timeout=10.0)
        bad.shutdown()
        anon = Rados(c.network, name="client.anon", mon=c.mon_names)
        with pytest.raises(TimeoutError):
            anon.connect(timeout=2.0)
        anon.shutdown()
        assert sum(d.ms.auth_verifier.rejected
                   for d in [c.mon, *c.osds.values()]) >= 1
        assert c.network.dispatch_errors == 0
    finally:
        c.shutdown()


def test_client_ticket_bound_to_src():
    kr = KeyRing.generate(["client.a", "client.victim"])
    _, atk = _authed(kr, entity="client.a")
    ver = CephxVerifier(kr.get(SERVICE_ENTITY))
    assert not ver.verify(atk.sign(_stamp(OSDOp(oid="o"), "client.victim")))
    assert ver.verify(atk.sign(_stamp(OSDOp(oid="o"), "client.a", 2)))
    mdsc = CephxClient.self_mint("mds.0", kr.get(SERVICE_ENTITY))
    assert ver.verify(mdsc.sign(_stamp(Message(), "client.mds123")))


# ------------------------------------------------- across the packages
def test_keyring_file_loads_in_either_package(tmp_path):
    kr = KeyRing.generate(["mon.0", "osd.0", "client.a"])
    kr.save(str(tmp_path / "port.json"))
    assert ref_auth.KeyRing.load(str(tmp_path / "port.json")).keys == kr.keys
    rkr = ref_auth.KeyRing.generate(["osd.1"])
    rkr.save(str(tmp_path / "ref.json"))
    assert KeyRing.load(str(tmp_path / "ref.json")).keys == rkr.keys
    assert (tmp_path / "port.json").read_bytes() == \
        _saved(ref_auth.KeyRing(kr.keys), tmp_path / "again.json")


def _saved(kr, path):
    kr.save(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "ref"),
                                                   ("ref", "port")])
def test_handshake_across_packages(client_pkg, server_pkg):
    pkg = {"port": (CephxClient, CephxServer, CephxVerifier),
           "ref": (ref_auth.CephxClient, ref_auth.CephxServer,
                   ref_auth.CephxVerifier)}
    kr = KeyRing.generate(["client.x"])
    client_cls = pkg[client_pkg][0]
    server_cls = pkg[server_pkg][1]
    server = server_cls(ref_auth.KeyRing(kr.keys) if server_pkg == "ref"
                        else kr)
    client = client_cls("client.x", kr.get("client.x"))
    req = client.build_request()
    # the request crosses as wire bytes, as it would on a socket
    enc, dec = (wire, ref_wire) if client_pkg == "port" else (ref_wire, wire)
    req = dec.decode_message(enc.encode_message(_stamp(req, "client.x")))
    rep = server.handle_request(req)
    rep = enc.decode_message(dec.encode_message(_stamp(rep, "mon.0")))
    assert rep.result == 0 and client.ingest_reply(rep)
    # a signed op verifies in both packages' verifiers
    msg = client.sign(_stamp((OSDOp if client_pkg == "port" else
                              __import__("ceph_tpu.msg.messages",
                                         fromlist=["OSDOp"]).OSDOp)(
        oid="o", op="write", data=b"payload"), "client.x", 5))
    blob = enc.encode_message(msg)
    for vpkg, codec in (("port", wire), ("ref", ref_wire)):
        ver = pkg[vpkg][2](kr.get(SERVICE_ENTITY))
        assert ver.verify(codec.decode_message(blob)), vpkg
    assert client.authenticated


def test_mauth_messages_equal_the_wire_corpus():
    import json
    import pathlib
    from ceph_tpu.tools import dencoder
    from test_torch_wire import carry
    corpus = json.loads((pathlib.Path(__file__).parent / "fixtures" /
                         "wire_corpus.json").read_text())
    for name in ("MAuthRequest", "MAuthReply"):
        assert wire.encode(carry(dencoder.sample(name))).hex() == corpus[name]


def _cephx_make(kind, shape, threaded=False):
    """test_torch_minicluster.make with cephx on: one keyring, and the
    client `client.mc1` authenticating through the pumped handshake.
    The reference's MiniCluster refuses pump-mode cephx clients, so its
    client is built by hand the same way the port's `rados()` builds
    it."""
    import test_torch_minicluster as tm
    from ceph_tpu.client import Rados as RefRados
    from ceph_tpu.testing import MiniCluster as RefCluster

    if kind == "ref":
        c = RefCluster(n_osd=shape["n_osd"], threaded=False, auth="cephx")
    else:
        c = MiniCluster(n_osd=shape["n_osd"], threaded=False, device="cpu",
                        auth="cephx")
    trace = []

    def record(src, dst, msg):
        trace.append((tm._norm(src), tm._norm(dst), msg.type_name))
        return True
    c.network.filter = record
    c.pump()
    c.wait_all_up()
    if kind == "ref":
        secret = generate_key()
        c.keyring.keys["client.mc1"] = secret
        r = RefRados(c.network, name="client.mc1", op_timeout=30.0,
                     threaded=False, mon=c.mon_names, auth_secret=secret)
        c.clients.append(r)
        r.objecter.pump_hook = c.pump
        r.objecter.start()
        c.pump()
        r._connected = True
    else:
        r = c.rados()
        assert r.objecter.name == "client.mc1"
    assert r.objecter.osdmap.epoch >= 1 and r.objecter.ms.auth_signer
    rc = r.mon_command({"prefix": "osd erasure-code-profile set",
                        "name": "ecp", "profile": dict(shape["profile"])})
    assert rc[0] == 0, rc
    r.pool_create("ec", pg_num=shape["pg_num"], pool_type="erasure",
                  erasure_code_profile="ecp")
    c.pump()
    return c, r, trace


def test_cephx_pump_cluster_equals_reference(monkeypatch):
    """test_torch_minicluster's scenario (k=2 m=2 over 7 OSDs) with
    cephx on, step by step: reads, epochs, acting sets, primaries,
    counters, stores and the message trace, the handshake included."""
    import test_torch_minicluster as tm
    monkeypatch.setattr(tm, "make", _cephx_make)
    shape = tm.SHAPES["k2m2_7osd"]
    ref, objs = tm.scenario("ref", shape)
    port, _ = tm.scenario("port", shape)
    assert [s for s, _ in port] == [s for s, _ in ref] + ["full_rebuilds"]
    for (step, want), (_, got) in zip(ref, port):
        if step == "victim":
            assert got == want
            continue
        assert got["reads"] == objs, step
        for key in ("reads", "epoch", "pgs", "primaries", "counters",
                    "trace", "stores"):
            assert got[key] == want[key], (step, key)
    assert dict(port)["full_rebuilds"] == 0
    first = dict(port)["written"]["trace"]
    assert ("client", "mon.0", "MAuthRequest") in first
    assert ("mon.0", "client", "MAuthReply") in first


def c_cephx_mds_gate(s):
    """tests/test_auth.py's MDS case on one package's cephx cluster."""
    CAP_EXCL = s.p.mds.CAP_EXCL
    c = s.cluster(n_osd=2, auth="cephx")
    mds = s.p.MDSDaemon(c.network, c.rados(), keyring=c.keyring)
    mds.init()
    try:
        assert mds.ms.auth_verifier is not None
        fs_w, fs_r = s.new_fs(c), s.new_fs(c)
        fs_w.mkdirs("/sec")
        w = fs_w.open("/sec/f", "w")
        assert w.caps & CAP_EXCL
        w.write(0, b"X" * 2048)
        r = fs_r.open("/sec/f", "r")
        assert r.size == 2048
        assert not (w.caps & CAP_EXCL)
        w.close()
        r.close()
        rogue = s.p.messenger.Messenger.create(c.network, "client.rogue",
                                               threaded=True)
        got = []

        class _Sink:
            def ms_dispatch(self, msg):
                got.append(msg)
                return True

        rogue.add_dispatcher(_Sink())
        rogue.start()
        rogue.connect("mds.0").send_message(s.p.messages.MClientRequest(
            tid=1, op="mkdir", args={"path": "/evil", "mode": 0o755}))
        time.sleep(0.5)
        assert not got, "unauthenticated mds request must get no reply"
        assert not s.new_fs(c).exists("/evil")
        rogue.shutdown()
        return {"size": r.size, "got": len(got),
                "state": fs_state(s, fs_w.rados)}
    finally:
        mds.shutdown()


def test_cephx_mds_gate(bare_sides):  # noqa: F811
    """In a cephx cluster the MDS verifies inbound traffic: a signed
    client's open revokes the writer's EXCL through the signed
    MClientCaps ack, and an unauthenticated endpoint's request gets no
    reply; the port's MDS and client equal the reference's."""
    run_both(bare_sides, c_cephx_mds_gate, state=False)
