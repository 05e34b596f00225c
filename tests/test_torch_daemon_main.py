"""The port's daemon entry point (ceph_tpu_torch.tools.daemon_main):
its arguments, the `--device` default (cuda, which raises without a
card), the one-line refusals of what is not ported yet, the monmap's
secure mode and compression, the `tick_errors` count of the serve
loop read through the admin socket, and `--data-dir`: a mon (on a
LogDB) and OSDs (on BlueStore, and one on `--objectstore journaled`)
as OS processes with `--device cpu` and cephx, each SIGKILLed and
started again on its directory, resuming from it; and an OSD SIGKILLed,
written around while down and started again, which then serves its
data.  The multi-process cluster (the
reference's tests/test_tcp.py::test_cluster_multiprocess: a mon and
OSD daemons as OS processes, the client in the test) is marked slow,
as the reference's is, and runs with `--device cpu` and cephx."""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
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
    a = ap.parse_args(["osd", "--id", "1", "--monmap", "m.json",
                       "--data-dir", "d", "--objectstore", "journaled"])
    assert (a.data_dir, a.objectstore) == ("d", "journaled")
    assert ap.parse_args(["osd", "--id", "1", "--monmap", "m.json"]
                         ).objectstore == "bluestore"
    with pytest.raises(SystemExit):
        ap.parse_args(["osd", "--id", "0", "--monmap", "m.json",
                       "--objectstore", "filestore"])
    with pytest.raises(SystemExit):
        ap.parse_args(["osd", "--monmap", "m.json"])          # no --id
    with pytest.raises(SystemExit):
        ap.parse_args(["osd", "--id", "0", "--monmap", "m.json",
                       "--device", "tpu"])


@pytest.mark.parametrize("argv,what", [
    (["mds", "--monmap", "m.json"], "the mds role"),
    (["mds", "--monmap", "m.json", "--crash-dir", "c"], "the mds role"),
    (["mds", "--rank", "1", "--monmap", "m.json", "--keyring", "k.json"],
     "the mds role"),
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


# ------------------------------------------------------------ --data-dir

class DurableCluster:
    """A mon on a LogDB, osd.0 and osd.1 on BlueStore and osd.2 on
    `--objectstore journaled`, each `daemon_main` process on its own
    `--data-dir` with `--device cpu`, cephx and an admin socket; an EC
    k=2 m=1 pool `mp` holds a few objects written by `client.901`."""

    NAMES = ["mon.0", "osd.0", "osd.1", "osd.2"]

    def __init__(self, tmp):
        from ceph_tpu_torch.auth import KeyRing
        from ceph_tpu_torch.msg.tcp import pick_free_ports

        self.tmp = tmp
        ports = pick_free_ports(len(self.NAMES))
        self.addrs = {n: ["127.0.0.1", p] for n, p in zip(self.NAMES, ports)}
        (tmp / "mm.json").write_text(json.dumps(
            {"addrs": self.addrs, "mon_ranks": [0], "n_osd": 3,
             "osds_per_host": 1}))
        self.kr = KeyRing.generate(self.NAMES + ["client.901", "client.902"])
        self.kr.save(str(tmp / "kr.json"))
        # ticks and pg-stat reports each second: a restarted mon hears
        # from every OSD within one
        self.env = dict(os.environ, PYTHONPATH=ROOT,
                        CEPH_TPU_OSD_HEARTBEAT_INTERVAL="1",
                        CEPH_TPU_OSD_MON_REPORT_INTERVAL="1")
        self.log = open(tmp / "daemons.log", "w")
        self.procs = {}
        self.clients = []
        for name in self.NAMES:
            self.spawn(name)
        for name in self.NAMES:
            self.wait_serving(name)
        self.r = self.client("client.901")
        self.wait(lambda: sum(self.r.objecter.osdmap.is_up(o)
                              for o in range(3)) == 3, "osds never came up")
        self.r.pool_create("mp", pg_num=4, pool_type="erasure")
        self.io = self.r.open_ioctx("mp")
        rng = np.random.default_rng(41)
        self.objs = {f"o{i}": rng.bytes(3000 + 101 * i) for i in range(6)}
        for oid, data in self.objs.items():
            self.io.write_full(oid, data)
        self.wait(self.clean, "the pool never went clean")

    def client(self, name):
        from ceph_tpu_torch.client import Rados
        from ceph_tpu_torch.msg.tcp import TcpNet
        net = TcpNet({k: tuple(v) for k, v in self.addrs.items()})
        r = Rados(net, name=name, op_timeout=60.0,
                  auth_secret=self.kr.get(name)).connect(60.0)
        self.clients.append(r)
        return r

    def asok(self, name):
        return str(self.tmp / f"{name}.asok")

    def spawn(self, name):
        role, ident = name.split(".")
        args = [role, "--rank" if role == "mon" else "--id", ident,
                "--monmap", str(self.tmp / "mm.json"), "--keyring",
                str(self.tmp / "kr.json"), "--device", "cpu", "--asok",
                self.asok(name), "--data-dir", str(self.tmp / name)]
        if name == "osd.2":
            args += ["--objectstore", "journaled"]
        if os.path.exists(self.asok(name)):
            os.unlink(self.asok(name))
        self.procs[name] = _spawn(args, self.env, self.log)

    def wait(self, pred, what, timeout=60.0):
        end = time.monotonic() + timeout
        while not pred():
            assert time.monotonic() < end, what
            time.sleep(0.05)

    def wait_serving(self, name):
        self.wait(lambda: os.path.exists(self.asok(name)) or
                  self.procs[name].poll() is not None, f"{name} not serving")
        assert self.procs[name].poll() is None, \
            (self.tmp / "daemons.log").read_text()[-3000:]

    def sigkill(self, name):
        self.procs[name].send_signal(signal.SIGKILL)
        self.procs[name].wait(10)

    def status(self, name):
        rc, out = admin_command(self.asok(name), "status")
        assert rc == 0, out
        return out

    def clean(self):
        st = [self.status(f"osd.{i}") for i in range(3)
              if self.procs[f"osd.{i}"].poll() is None]
        return all(s["pgs_recovering"] == 0 for s in st) and \
            sum(s["primary_clean"] for s in st) == 4

    def counters(self, name):
        rc, perf = admin_command(self.asok(name), "perf dump")
        assert rc == 0, perf
        rc, ms = admin_command(self.asok(name), "msgr")
        assert rc == 0, ms
        return {"tick_errors": perf["tick_errors"],
                "queued_op_failures": perf.get("queued_op_failures", 0),
                "recovery_full_rebuild": perf.get("recovery_full_rebuild",
                                                  0),
                "dispatch_errors": ms["dispatch_errors"]}

    def stop(self):
        for r in self.clients:
            r.shutdown()
        for p in self.procs.values():
            p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        self.log.close()


@pytest.fixture(scope="module")
def durable(tmp_path_factory):
    c = DurableCluster(tmp_path_factory.mktemp("durable"))
    try:
        yield c
    finally:
        c.stop()


@pytest.mark.parametrize("name", ["mon.0", "osd.0", "osd.2"],
                         ids=["mon-logdb", "osd-bluestore", "osd-journaled"])
def test_data_dir_restarts_the_daemon_from_its_dir(durable, name):
    """SIGKILL one daemon and start it again on its --data-dir: the mon
    comes back at the same osdmap epoch with the pool, the OSD with the
    PGs it held; the cluster goes clean and every object reads back."""
    before = durable.status(name)
    durable.sigkill(name)
    durable.spawn(name)
    durable.wait_serving(name)
    after = durable.status(name)
    if name.startswith("mon"):
        assert after["osdmap"]["epoch"] == before["osdmap"]["epoch"]
        r = durable.client("client.902")
        assert r.pool_lookup("mp") == durable.r.pool_lookup("mp")
        assert r.open_ioctx("mp").read("o0") == durable.objs["o0"]
    else:
        durable.wait(lambda: durable.r.objecter.osdmap.is_up(
            int(name[4:])), f"{name} never up again")
        # the client's map marks it up before the OSD itself has that
        # epoch (its PGs are instantiated when it ingests the map)
        up_epoch = durable.r.objecter.osdmap.epoch
        durable.wait(lambda: durable.status(name)["osdmap_epoch"] >=
                     up_epoch, f"{name} never reached epoch {up_epoch}")
        assert durable.status(name)["num_pgs"] == before["num_pgs"] > 0
    durable.wait(durable.clean, f"never clean after {name} restarted")
    for oid, data in durable.objs.items():
        assert durable.io.read(oid) == data, oid
    for n in DurableCluster.NAMES:
        assert not any(durable.counters(n).values()), n


def test_sigkilled_osd_restarts_and_serves_its_data(durable):
    """SIGKILL osd.1 and mark it down, write more objects while it is
    down, start it again on its BlueStore dir: it recovers the writes
    it missed from the PG log (no full rebuild), and with osd.0 then
    down as well, every read needs osd.1's shards."""
    c, io = durable, durable.io
    c.sigkill("osd.1")
    assert c.r.mon_command({"prefix": "osd down", "ids": [1]})[0] == 0
    c.wait(lambda: c.r.objecter.osdmap.is_down(1), "osd.1 never down")
    rng = np.random.default_rng(42)
    missed = {f"m{i}": rng.bytes(2000 + 37 * i) for i in range(4)}
    for oid, data in missed.items():
        io.write_full(oid, data)
    c.objs.update(missed)
    c.spawn("osd.1")
    c.wait_serving("osd.1")
    c.wait(lambda: c.r.objecter.osdmap.is_up(1), "osd.1 never up again")
    c.wait(c.clean, "never clean after osd.1 restarted")
    rebuilt = sum(admin_command(c.asok(f"osd.{i}"), "perf dump")[1]
                  ["recovery_bytes_rebuilt"] for i in range(3))
    assert rebuilt > 0
    c.sigkill("osd.0")
    assert c.r.mon_command({"prefix": "osd down", "ids": [0]})[0] == 0
    c.wait(lambda: c.r.objecter.osdmap.is_down(0), "osd.0 never down")
    for oid, data in c.objs.items():
        assert io.read(oid) == data, oid
    for n in ("mon.0", "osd.1", "osd.2"):
        assert not any(c.counters(n).values()), n
    c.spawn("osd.0")
    c.wait_serving("osd.0")
