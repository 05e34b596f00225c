"""The port's admin socket (ceph_tpu_torch.common.admin_socket) and the
daemons' commands on it, mirroring the reference's
tests/test_admin_socket.py, plus the cross-package check that each
package's client talks to the other's socket.  The OSD case runs an EC
k=2 m=1 pool over 4 OSDs where the reference runs a replicated pool
over 2 (an EC pool exercises K1 on the card's path too), and its
`config set` sets
osd_max_backfills where the reference sets log_level, an option the
port does not carry.  One more case pins the port's own rule: the
socket's path appears only once it listens."""
import time

from ceph_tpu.common import admin_socket as ref_asok
from ceph_tpu_torch.common.admin_socket import AdminSocket, admin_command
from ceph_tpu_torch.common.options import global_config
from ceph_tpu_torch.common.tracked_op import OpTracker
from ceph_tpu_torch.testing import MiniCluster


def test_admin_socket_roundtrip(tmp_path):
    sock = str(tmp_path / "a.asok")
    a = AdminSocket(sock)
    a.register("echo", "echo back", lambda c: (0, c.get("x", "?")))
    a.register("fail", "always fails", lambda c: (-5, "EIO"))
    a.start()
    try:
        rc, out = admin_command(sock, {"prefix": "echo", "x": 42})
        assert rc == 0 and out == 42
        rc, out = admin_command(sock, "fail")
        assert rc == -5
        rc, out = admin_command(sock, "nope")
        assert rc == -22 and "unknown" in out
        rc, out = admin_command(sock, "help")
        assert rc == 0 and "echo" in out
    finally:
        a.shutdown()


def test_path_appears_only_once_the_socket_listens(tmp_path, monkeypatch):
    """A caller that finds the path can connect: the socket listens
    under a side name before it is renamed to the path (a stale side
    file from a killed daemon is replaced)."""
    import os
    import socket

    sock = str(tmp_path / "b.asok")
    (tmp_path / "b.asok~").write_text("stale")
    seen = []

    class Probe(socket.socket):
        def listen(self, *a):
            seen.append(os.path.exists(sock))
            super().listen(*a)
    monkeypatch.setattr(socket, "socket", Probe)
    a = AdminSocket(sock)
    a.start()
    monkeypatch.undo()
    try:
        assert seen == [False]
        assert os.path.exists(sock) and not os.path.exists(sock + "~")
        assert admin_command(sock, "help")[0] == 0
    finally:
        a.shutdown()
    assert not os.path.exists(sock)


def test_op_tracker():
    t = OpTracker(history_size=3, complaint_time=0.05)
    t.start("k1", "op one")
    t.mark("k1", "queued")
    assert t.dump_in_flight()["num_ops"] == 1
    time.sleep(0.08)
    assert len(t.slow_ops()) == 1
    t.finish("k1")
    assert t.dump_in_flight()["num_ops"] == 0
    h = t.dump_historic()
    assert h["num_ops"] == 1
    assert [e["event"] for e in h["ops"][0]["events"]] == \
        ["initiated", "queued", "done"]
    for i in range(5):
        t.start(i, f"op{i}")
        t.finish(i)
    assert t.dump_historic()["num_ops"] == 3


def test_osd_admin_socket_end_to_end(tmp_path):
    c = MiniCluster(n_osd=4, threaded=True, device="cpu")
    cfg = global_config()
    try:
        c.wait_all_up()
        r = c.rados()
        r.pool_create("ap", pg_num=8, pool_type="erasure")
        io = r.open_ioctx("ap")
        sock = str(tmp_path / "osd0.asok")
        c.osds[0].start_admin_socket(sock)
        for i in range(6):
            io.write_full(f"o{i}", b"data")
        rc, perf = admin_command(sock, "perf dump")
        assert rc == 0 and perf["op"] > 0 and perf["tick_errors"] == 0
        rc, st = admin_command(sock, "status")
        assert rc == 0 and st["whoami"] == 0 and st["num_pgs"] > 0
        assert st["primary_clean"] == st["num_primary"]
        rc, hist = admin_command(sock, "dump_historic_ops")
        assert rc == 0 and hist["num_ops"] > 0
        ev = [e["event"] for e in hist["ops"][-1]["events"]]
        assert ev[0] == "initiated" and "dispatched" in ev
        rc, infl = admin_command(sock, "dump_ops_in_flight")
        assert rc == 0 and isinstance(infl["ops"], list)
        rc, cfgd = admin_command(sock, "config show")
        assert rc == 0 and "osd_heartbeat_interval" in cfgd
        rc, _ = admin_command(sock, {"prefix": "config set",
                                     "var": "osd_max_backfills", "val": "2"})
        assert rc == 0
        rc, v = admin_command(sock, {"prefix": "config get",
                                     "var": "osd_max_backfills"})
        assert rc == 0 and v == 2
    finally:
        cfg.set("osd_max_backfills", 1)
        c.shutdown()


def test_mon_admin_socket(tmp_path):
    c = MiniCluster(n_osd=2, threaded=True, device="cpu")
    try:
        c.wait_all_up()
        sock = str(tmp_path / "mon.asok")
        c.mon.start_admin_socket(sock)
        rc, s = admin_command(sock, "status")
        assert rc == 0 and s["osdmap"]["num_up_osds"] == 2
        rc, q = admin_command(sock, "quorum_status")
        assert rc == 0 and q["leader"] == 0
        rc, h = admin_command(sock, "health")
        assert rc == 0
        rc, perf = admin_command(sock, "perf dump")
        assert rc == 0 and perf == {"tick_errors": 0}
    finally:
        c.shutdown()


def test_clients_and_sockets_across_packages(tmp_path):
    for i, (server, client) in enumerate(
            [(AdminSocket, ref_asok.admin_command),
             (ref_asok.AdminSocket, admin_command)]):
        sock = str(tmp_path / f"x{i}.asok")
        a = server(sock)
        a.register("echo", "echo back", lambda c: (0, c.get("x")))
        a.start()
        try:
            assert client(sock, {"prefix": "echo", "x": [1, "b"]}) == \
                (0, [1, "b"])
            assert client(sock, "nope")[0] == -22
        finally:
            a.shutdown()
