"""The port's daemon entry point (ceph_tpu_torch.tools.daemon_main):
its arguments, the `--device` default (cuda, which raises without a
card), the one-line refusals of what is not ported yet, the monmap's
secure mode and compression, and the `tick_errors` count of the serve
loop read through the admin socket.  The multi-process cluster (the
reference's tests/test_tcp.py::test_cluster_multiprocess: a mon and
OSD daemons as OS processes, the client in the test) is marked slow,
as the reference's is, and runs with `--device cpu` and cephx."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from ceph_tpu_torch.common.admin_socket import admin_command
from ceph_tpu_torch.tools import daemon_main
from test_torch_tcp import deadline  # noqa: F401  (per-test timeout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_arguments_and_device_default():
    ap = daemon_main.parser()
    a = ap.parse_args(["osd", "--id", "3", "--monmap", "m.json"])
    assert (a.role, a.id, a.device, a.keyring, a.asok) == \
        ("osd", 3, "cuda", "", "")
    a = ap.parse_args(["mon", "--monmap", "m.json", "--device", "cpu",
                       "--keyring", "k.json", "--asok", "m.asok"])
    assert (a.role, a.rank, a.device, a.keyring, a.asok) == \
        ("mon", 0, "cpu", "k.json", "m.asok")
    with pytest.raises(SystemExit):
        ap.parse_args(["osd", "--monmap", "m.json"])          # no --id
    with pytest.raises(SystemExit):
        ap.parse_args(["osd", "--id", "0", "--monmap", "m.json",
                       "--device", "tpu"])


@pytest.mark.parametrize("argv,what", [
    (["mds", "--monmap", "m.json"], "the mds role"),
    (["osd", "--id", "0", "--monmap", "m.json", "--data-dir", "d"],
     "--data-dir"),
    (["mon", "--monmap", "m.json", "--data-dir", "d"], "--data-dir"),
    (["osd", "--id", "0", "--monmap", "m.json", "--crash-dir", "c"],
     "--crash-dir"),
])
def test_not_ported_yet_is_refused_in_one_line(argv, what):
    with pytest.raises(SystemExit) as ei:
        daemon_main.main(argv)
    msg = str(ei.value.code)
    assert what in msg and "not ported yet" in msg and "\n" not in msg


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mm = tmp_path / "mm.json"
    mm.write_text(json.dumps({"addrs": {"osd.0": ["127.0.0.1", 1]},
                              "n_osd": 1}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        daemon_main.main(["osd", "--id", "0", "--monmap", str(mm)])


def test_monmap_secure_mode_and_compression(tmp_path):
    from ceph_tpu_torch.auth import SERVICE_ENTITY, KeyRing
    mm = {"addrs": {"mon.0": ("127.0.0.1", 1)}, "ms_secure_mode": True,
          "ms_compress": "zlib"}
    with pytest.raises(SystemExit, match="requires --keyring"):
        daemon_main.make_net(mm, None)
    with pytest.raises(SystemExit, match="no service secret"):
        daemon_main.make_net(mm, KeyRing({"osd.0": "x"}))
    kr = KeyRing.generate(["mon.0"])
    net = daemon_main.make_net(mm, kr)
    assert net.secure_secret == kr.get(SERVICE_ENTITY)
    assert net.compress == "zlib"
    plain = daemon_main.make_net({"addrs": mm["addrs"]}, kr)
    assert plain.secure_secret is None and plain.compress is None


def test_tick_errors_are_counted_and_read_through_perf_dump(tmp_path):
    """The serve loop logs a tick error and goes on, as the reference's
    does, and counts it in the daemon's perf counters as tick_errors,
    which its admin socket's `perf dump` returns."""
    from ceph_tpu_torch.msg.messenger import LocalNetwork
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    d = OSDDaemon(LocalNetwork(), 0, device="cpu")
    sock = str(tmp_path / "osd.0.asok")
    d.start_admin_socket(sock)
    calls = []

    def tick():
        calls.append(time.monotonic())
        if len(calls) == 1:
            raise RuntimeError("gf_matmul_k1 launch failed: unspecified "
                               "launch failure")
        os.kill(os.getpid(), signal.SIGTERM)     # the second tick stops

    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        daemon_main._serve(tick, interval=0.01, perf=d.perf)
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    try:
        assert len(calls) == 2
        rc, perf = admin_command(sock, "perf dump")
        assert rc == 0 and perf["tick_errors"] == 1
    finally:
        d.shutdown()


def _spawn(args, env, log):
    return subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_main", *args],
        env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)


@pytest.mark.slow
def test_cluster_multiprocess(tmp_path):
    """A mon and 3 OSDs as separate OS processes (`--device cpu`, cephx,
    an admin socket each), the client in this process: an EC k=2 m=1
    pool's write and read over localhost sockets, then every daemon's
    tick_errors, failed queued items and dispatch errors at 0."""
    from ceph_tpu_torch.auth import KeyRing
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.msg.tcp import TcpNet, pick_free_ports

    names = ["mon.0", "osd.0", "osd.1", "osd.2"]
    ports = pick_free_ports(len(names))
    addrs = {n: ["127.0.0.1", p] for n, p in zip(names, ports)}
    (tmp_path / "mm.json").write_text(json.dumps(
        {"addrs": addrs, "mon_ranks": [0], "n_osd": 3, "osds_per_host": 1}))
    kr = KeyRing.generate(names + ["client.901"])
    kr.save(str(tmp_path / "kr.json"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    common = ["--monmap", str(tmp_path / "mm.json"), "--keyring",
              str(tmp_path / "kr.json"), "--device", "cpu"]
    procs = []
    log = open(tmp_path / "daemons.log", "w")
    try:
        procs.append(_spawn(["mon", *common, "--asok",
                             str(tmp_path / "mon.0.asok")], env, log))
        end = time.monotonic() + 60
        while not (tmp_path / "mon.0.asok").exists():
            assert time.monotonic() < end, "mon never served"
            time.sleep(0.05)
        for i in range(3):
            procs.append(_spawn(["osd", "--id", str(i), *common, "--asok",
                                 str(tmp_path / f"osd.{i}.asok")], env, log))
        net = TcpNet({k: tuple(v) for k, v in addrs.items()})
        r = Rados(net, name="client.901", op_timeout=60.0,
                  auth_secret=kr.get("client.901")).connect(60.0)
        try:
            end = time.monotonic() + 60
            while sum(r.objecter.osdmap.is_up(o) for o in range(3)) < 3:
                assert time.monotonic() < end, "osds never came up"
                time.sleep(0.05)
            r.pool_create("mp", pg_num=8, pool_type="erasure")
            io = r.open_ioctx("mp")
            io.write_full("cross-process", b"hello from another pid")
            assert io.read("cross-process") == b"hello from another pid"
        finally:
            r.shutdown()
        for name in names:
            rc, perf = admin_command(str(tmp_path / f"{name}.asok"),
                                     "perf dump")
            assert rc == 0 and perf["tick_errors"] == 0, name
            assert perf.get("queued_op_failures", 0) == 0, name
            rc, ms = admin_command(str(tmp_path / f"{name}.asok"), "msgr")
            assert rc == 0 and ms["dispatch_errors"] == 0, name
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        log.close()
