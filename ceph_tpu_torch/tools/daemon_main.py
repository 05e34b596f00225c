"""Daemon entrypoint: run a mon or an OSD as its own OS process over TCP.

The ceph-mon/ceph-osd analogue (ref: src/ceph_mon.cc, src/ceph_osd.cc
global_init + daemon loop): a monmap JSON file carries every entity's
bind address plus the cluster bootstrap parameters; each process binds
its own socket and joins.

monmap JSON:
    {"addrs": {"mon.0": ["127.0.0.1", 6789], "osd.0": [...], ...},
     "mon_ranks": [0], "n_osd": 3, "osds_per_host": 1,
     "ms_secure_mode": false, "ms_compress": null}

Usage:
    python -m ceph_tpu_torch.tools.daemon_main mon --rank 0 --monmap m.json \\
        [--data-dir mon0]
    python -m ceph_tpu_torch.tools.daemon_main osd --id 2 --monmap m.json \\
        --keyring k.json --asok osd.2.asok [--device cpu] \\
        [--data-dir osd2 [--objectstore journaled]]

The port's copy of `ceph_tpu.tools.daemon_main` for the mon and OSD
roles: `--monmap` (its `mon_ranks` make the mons a quorum when it
lists more than one), `--keyring` (cephx), `--asok` (admin socket),
`--data-dir`, `--objectstore` and `--crash-dir`, and the monmap's
`ms_secure_mode` and `ms_compress`.  Crash reports spool to
`--crash-dir`, else to `<data-dir>/crash` (the /var/lib/ceph/crash
layout), else nowhere (post only); the daemon's crash reporter also
hooks the process's and its threads' uncaught exceptions.  With `--data-dir` the mon keeps its store in a `LogDB`
there and an OSD its objects in a `BlueStore` (or, with `--objectstore
journaled`, a `JournaledStore`), so a daemon killed with SIGKILL and
started again on the same directory resumes: the mon from its
committed paxos state, the OSD from its PG collections and shard logs.
Without it the daemon keeps its state in memory.  Each daemon runs on
`--device` (cuda, the default, or cpu): its plugins live there, and on
cuda the process makes its CUDA context and loads the EC kernels'
library (built once, by whichever process comes first) before it joins,
so its first write pays neither; an OSD waits until a mon accepts
connections before it boots, so the daemons may start together.  The
admin socket's `startup` command
returns the wall-clock stamps of that start-up (main entered, torch and
the daemon's modules imported, CUDA context made, kernels loaded,
serving), `kernel launches` the process's launch counts and `msgr` the
messenger's dispatch errors and frames and bytes sent.  The
device guard and the race checker arm from the environment
(CEPH_TPU_TORCH_DEVGUARD, CEPH_TPU_RACECHECK) before any daemon module
is imported.  One rule
differs: a tick error the loop logs and survives also counts in the
daemon's perf counters as `tick_errors` (`perf dump`).  Not ported yet,
and refused with a one-line error: the `mds` role.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import time

#: how long an OSD waits for a mon to accept connections before it boots
MON_WAIT_S = 300.0


def load_monmap(path: str) -> dict:
    with open(path) as f:
        mm = json.load(f)
    mm["addrs"] = {k: tuple(v) for k, v in mm["addrs"].items()}
    return mm


def make_net(mm: dict, keyring):
    """TcpNet for this monmap; `"ms_secure_mode": true` in the monmap
    switches every frame to sealed secure mode keyed by the keyring's
    service secret (ref: msgr v2 secure mode; requires --keyring)."""
    from ..msg.tcp import TcpNet
    secret = None
    if mm.get("ms_secure_mode"):
        if keyring is None:
            raise SystemExit("ms_secure_mode requires --keyring")
        from ..auth import SERVICE_ENTITY
        secret = keyring.get(SERVICE_ENTITY)
        if secret is None:
            # failing open to plaintext here would silently void the
            # operator's secure-mode intent
            raise SystemExit("ms_secure_mode: keyring has no service secret")
    return TcpNet(mm["addrs"], secure_secret=secret,
                  compress=mm.get("ms_compress"))


def wait_for_mon(mm: dict, mons: list[str],
                 timeout: float = MON_WAIT_S) -> None:
    """Block until one of `mons` accepts a TCP connection, so an OSD
    started beside its mon boots once the mon listens (ref: MonClient
    keeps hunting until a mon answers)."""
    import socket
    end = time.monotonic() + timeout
    while True:
        for name in mons:
            try:
                socket.create_connection(tuple(mm["addrs"][name]),
                                         timeout=1.0).close()
                return
            except OSError:
                pass
        if time.monotonic() > end:
            raise SystemExit(f"daemon_main: no mon of {mons} accepted a "
                             f"connection within {timeout:.0f} s")
        time.sleep(0.1)


def _crash_dir(args) -> str | None:
    """Spool dir for crash reports: --crash-dir, else <data-dir>/crash
    (the /var/lib/ceph/crash layout), else none (post-only)."""
    if getattr(args, "crash_dir", ""):
        return args.crash_dir
    if getattr(args, "data_dir", ""):
        import os
        return os.path.join(args.data_dir, "crash")
    return None


def _keyring(args):
    if not args.keyring:
        return None
    from ..auth import KeyRing
    return KeyRing.load(args.keyring)


def _warm(device: str, stamps: dict) -> None:
    """Make the CUDA context and load the EC kernels' library now, so
    the daemon's first write pays neither; stamp each step."""
    import torch

    from .. import device as _device
    from ..ec.kernels import bitmatmul
    stamps["imported"] = time.time()
    if device != "cuda":
        return
    dev = _device.resolve(None)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    stamps["cuda"] = time.time()
    bitmatmul._lib()
    stamps["kernels"] = time.time()


def _admin(daemon, args, stamps: dict) -> None:
    if args.asok:
        from ..ec.kernels import bitmatmul
        daemon.start_admin_socket(args.asok)
        daemon.asok.register("startup", "wall-clock stamps of start-up",
                             lambda c: (0, dict(stamps)))
        daemon.asok.register("kernel launches",
                             "launches of each CUDA kernel in this process",
                             lambda c: (0, dict(bitmatmul.LAUNCHES)))
        net = daemon.ms.net
        daemon.asok.register("msgr", "the messenger's counts", lambda c: (
            0, {"dispatch_errors": net.dispatch_errors,
                "last_dispatch_error": net.last_dispatch_error,
                "frames_sent": net.frames_sent,
                "bytes_sent": net.bytes_sent}))


def run_mon(args, stamps: dict) -> int:
    from ..mon.monitor import Monitor, build_initial
    mm = load_monmap(args.monmap)
    m, w = build_initial(mm.get("n_osd", 0),
                         osds_per_host=mm.get("osds_per_host", 1))
    ranks = mm.get("mon_ranks", [0])
    keyring = _keyring(args)
    _warm(args.device, stamps)
    store = None
    if args.data_dir:
        # durable mon store on the KV engine (ref: MonitorDBStore on
        # RocksDB): a restarted mon resumes from committed paxos state
        from ..kv import LogDB
        from ..mon.store import MonitorStore
        store = MonitorStore(LogDB(args.data_dir))
    stamps["store"] = time.time()
    mon = Monitor(make_net(mm, keyring), rank=args.rank, initial_map=m,
                  initial_wrapper=w, store=store,
                  mon_ranks=ranks if len(ranks) > 1 else None,
                  device=args.device, keyring=keyring,
                  crash_dir=_crash_dir(args))
    mon.crash_reporter.install_excepthook()
    mon.init()
    stamps["serving"] = time.time()
    _admin(mon, args, stamps)
    print(f"mon.{args.rank}: serving on "
          f"{mm['addrs'][f'mon.{args.rank}']}", flush=True)
    _serve(lambda: mon.tick(), interval=1.0, perf=mon.perf)
    mon.shutdown()
    if store is not None:
        store.db.close()
    return 0


def run_osd(args, stamps: dict) -> int:
    from ..common.options import global_config
    from ..osd.daemon import OSDDaemon
    mm = load_monmap(args.monmap)
    mons = [f"mon.{r}" for r in mm.get("mon_ranks", [0])]
    keyring = _keyring(args)
    _warm(args.device, stamps)
    store = None
    if args.data_dir:
        if args.objectstore == "journaled":
            from ..store import JournaledStore
            store = JournaledStore(args.data_dir)
        else:
            # the durable default (ref: bluestore as the OSD default;
            # JournaledStore retired to an opt-in legacy engine)
            from ..store import BlueStore
            store = BlueStore(args.data_dir)
            store.mkfs()
        store.mount()
    stamps["store"] = time.time()
    d = OSDDaemon(make_net(mm, keyring), args.id, store=store, mon=mons,
                  threaded=True, device=args.device, keyring=keyring,
                  crash_dir=_crash_dir(args))
    d.crash.install_excepthook()
    wait_for_mon(mm, mons)
    d.init()
    stamps["serving"] = time.time()
    _admin(d, args, stamps)
    print(f"osd.{args.id}: serving on "
          f"{mm['addrs'][f'osd.{args.id}']}", flush=True)
    interval = global_config()["osd_heartbeat_interval"]
    _serve(lambda: d.heartbeat_tick(), interval=interval, perf=d.perf)
    d.shutdown()
    if store is not None:
        store.umount()
    return 0


def _serve(tick, interval: float, perf) -> None:
    stop = {"flag": False}

    def on_sig(_sig, _frm):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_sig)
    signal.signal(signal.SIGINT, on_sig)
    while not stop["flag"]:
        time.sleep(interval)
        try:
            tick()
        except Exception as ex:           # the loop must survive
            perf.inc("tick_errors")
            print(f"tick error: {ex}", file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ceph-tpu-torch-daemon")
    sub = ap.add_subparsers(dest="role", required=True)
    for role in ("mon", "osd"):
        p = sub.add_parser(role)
        if role == "mon":
            p.add_argument("--rank", type=int, default=0)
        else:
            p.add_argument("--id", type=int, required=True)
        p.add_argument("--monmap", required=True)
        p.add_argument("--asok", default="",
                       help="admin socket path (`ceph daemon` endpoint)")
        p.add_argument("--keyring", default="",
                       help="cephx keyring JSON (enables auth)")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the daemon's plugins run (default "
                            "cuda; raises without a card)")
        p.add_argument("--data-dir", default="",
                       help="durable store directory (a LogDB for the "
                            "mon, BlueStore for an OSD); in memory "
                            "when omitted")
        if role == "osd":
            p.add_argument("--objectstore", default="bluestore",
                           choices=["bluestore", "journaled"],
                           help="durable engine (journaled = legacy)")
        p.add_argument("--crash-dir", default="",
                       help="crash-report spool dir (default "
                            "<data-dir>/crash when --data-dir is set)")
    pd = sub.add_parser("mds")
    pd.add_argument("--rank", type=int, default=0)
    pd.add_argument("--monmap", required=True)
    pd.add_argument("--keyring", default="")
    pd.add_argument("--crash-dir", default="")
    return ap


def main(argv=None) -> int:
    stamps = {"main": time.time()}
    # arm the device guard and the race checker (each reads the
    # environment at import) before the daemon modules are imported
    from ..common import devguard, racecheck  # noqa: F401
    args = parser().parse_args(argv)
    if args.role == "mds":
        raise SystemExit("daemon_main: the mds role is not ported yet")
    return {"mon": run_mon, "osd": run_osd}[args.role](args, stamps)


if __name__ == "__main__":
    sys.exit(main())
