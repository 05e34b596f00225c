"""`rados` CLI: pool/object utility and IO benchmark.

The analogue of the reference's rados tool (ref: src/tools/rados/
rados.cc, usage :168; the obj_bencher engine src/common/obj_bencher.cc:
`rados bench` aio pipeline with fixed concurrency, bandwidth/latency
summary :471-560).  Connects to a running cluster through --monmap
(the TCP daemon world of tools/daemon_main.py), or tests inject an
in-process `Rados`.

    rados --monmap mm.json lspools
    rados --monmap mm.json mkpool data 64
    rados --monmap mm.json put data obj ./file
    rados --monmap mm.json --keyring k.json bench data 10 write -t 16

The port's copy of `ceph_tpu.tools.rados_cli` for the verbs the port's
librados carries: `lspools`, `mkpool`, `put`, `get`, `rm`, `stat` and
`bench <pool> <seconds> write|seq -b -t [--no-cleanup]`, with
`--monmap`, `--keyring` and `--timeout`; the output text and return
codes are the reference's.  Three rules differ, each because the port
has no replicated pools and no object listing yet:

* `mkpool` makes an erasure pool on the mon's default profile (the
  port instantiates only EC placement groups);
* `bench ... write --no-cleanup` also writes `benchmark_last_metadata`
  (prefix, object count, size and payload seed), and `bench ... seq`
  reads the objects it names, as Ceph's obj_bencher does, instead of
  listing the pool; each read is checked against the payload, which is
  made from the seed;
* with a keyring that holds `client.admin`, the client authenticates
  (cephx) as `client.admin`.

Not ported yet: `rmpool`, `ls`, the xattr and omap verbs, `crash`,
`telemetry`, `insights`, `trace`, `rgw` and `serve`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

METADATA = "benchmark_last_metadata"


def _keyring(path: str):
    if not path:
        return None
    from ..auth import KeyRing
    return KeyRing.load(path)


def _net_from_monmap(mm_path: str, keyring):
    """TcpNet honoring the monmap's ms_secure_mode and ms_compress
    (secure mode needs a keyring with the service secret)."""
    from ..msg.tcp import TcpNet
    with open(mm_path) as f:
        mm = json.load(f)
    addrs = {k: tuple(v) for k, v in mm["addrs"].items()}
    secret = None
    if mm.get("ms_secure_mode"):
        if keyring is None:
            raise SystemExit("secure cluster: pass --keyring")
        from ..auth import SERVICE_ENTITY
        secret = keyring.get(SERVICE_ENTITY)
        if secret is None:
            raise SystemExit("keyring has no service secret")
    return TcpNet(addrs, secure_secret=secret,
                  compress=mm.get("ms_compress"))


def _connect(args):
    from ..client import Rados
    keyring = _keyring(args.keyring)
    secret = keyring.get("client.admin") if keyring is not None else None
    # an ad-hoc client is not in the monmap: daemons answer over the
    # connections it opens (learned-connection replies)
    name = "client.admin" if secret is not None \
        else f"client.{os.getpid() % 50000 + 10000}"
    net = _net_from_monmap(args.monmap, keyring)
    return Rados(net, name=name, op_timeout=args.timeout,
                 auth_secret=secret).connect(args.timeout)


# ------------------------------------------------------------ commands

def cmd_lspools(r, a, out):
    for p in r.list_pools():
        print(p, file=out)


def cmd_mkpool(r, a, out):
    r.pool_create(a.pool, pg_num=a.pg_num, pool_type="erasure")
    print(f"successfully created pool {a.pool}", file=out)


def cmd_put(r, a, out):
    if a.infile == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(a.infile, "rb") as f:
            data = f.read()
    r.open_ioctx(a.pool).write_full(a.obj, data)


def cmd_get(r, a, out):
    data = r.open_ioctx(a.pool).read(a.obj)
    if a.outfile == "-":
        out.write(data.decode(errors="replace"))
    else:
        with open(a.outfile, "wb") as f:
            f.write(data)


def cmd_rm(r, a, out):
    r.open_ioctx(a.pool).remove(a.obj)


def cmd_stat(r, a, out):
    st = r.open_ioctx(a.pool).stat(a.obj)
    print(f"{a.pool}/{a.obj} size {st['size']}", file=out)


# ---------------------------------------------------------------- bench
# (ref: src/common/obj_bencher.cc ObjBencher::write_bench /
#  seq_read_bench: fixed-depth aio pipeline, per-op latency tracking,
#  bandwidth summary; the metadata object of ObjBencher::write_bench)

def bench_payload(size: int, seed: int) -> bytes:
    """The bytes every object of one write bench holds."""
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _bench(r, a, out):
    io = r.open_ioctx(a.pool)
    size, depth, secs = a.block_size, a.concurrency, a.seconds
    if a.mode == "write":
        seed = os.getpid()
        prefix = f"benchmark_data_{seed}_"
        payload = bench_payload(size, seed)
        submit = lambda i: io.aio_write_full(prefix + str(i), payload)
    else:
        from ..client import RadosError
        try:
            meta = json.loads(io.read(METADATA))
        except RadosError:
            print("no benchmark objects; run write first", file=out)
            return 1
        size, prefix = meta["size"], meta["prefix"]
        payload = bench_payload(size, meta["seed"])
        count = meta["objects"]
        submit = lambda i: io.aio_read(prefix + str(i % count))

    lat: list[float] = []
    t0 = time.monotonic()
    n_done = 0
    in_flight: list[tuple[float, object]] = []
    i = 0
    deadline = t0 + secs
    while True:
        now = time.monotonic()
        if now < deadline:
            while len(in_flight) < depth:
                in_flight.append((time.monotonic(), submit(i)))
                i += 1
        elif not in_flight:
            break
        start, fut = in_flight[0]
        fut.wait(max(1.0, a.timeout))
        in_flight.pop(0)
        lat.append(time.monotonic() - start)
        n_done += 1
        if fut.result < 0:
            print(f"op failed: {fut.errno_name}", file=out)
            return 1
        if a.mode == "seq" and fut.data != payload:
            print("op failed: read data differs from the written "
                  "payload", file=out)
            return 1
    elapsed = time.monotonic() - t0
    mb = n_done * size / 1e6
    print(f"Total time run:         {elapsed:.4f}", file=out)
    print(f"Total {a.mode}s made:      {n_done}", file=out)
    print(f"{a.mode} size:             {size}", file=out)
    print(f"Bandwidth (MB/sec):     {mb / elapsed:.3f}", file=out)
    print(f"Average IOPS:           {n_done / elapsed:.0f}", file=out)
    print(f"Average Latency(s):     {sum(lat) / len(lat):.6f}", file=out)
    print(f"Max latency(s):         {max(lat):.6f}", file=out)
    print(f"Min latency(s):         {min(lat):.6f}", file=out)
    if a.mode == "write":
        if a.no_cleanup:
            io.write_full(METADATA, json.dumps(
                {"prefix": prefix, "objects": i, "size": size,
                 "seed": seed}).encode())
        else:
            from ..client import RadosError
            for j in range(i):
                try:
                    io.remove(prefix + str(j))
                except RadosError:
                    pass        # best-effort cleanup of bench objects
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rados", description="object store utility")
    ap.add_argument("--monmap", help="monmap JSON (TCP cluster)")
    ap.add_argument("--keyring", default="",
                    help="keyring JSON (cephx and secure-mode clusters)")
    ap.add_argument("--timeout", type=float, default=30.0)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("lspools")
    p = sub.add_parser("mkpool")
    p.add_argument("pool")
    p.add_argument("pg_num", type=int, nargs="?", default=32)
    p = sub.add_parser("put")
    p.add_argument("pool"), p.add_argument("obj")
    p.add_argument("infile")
    p = sub.add_parser("get")
    p.add_argument("pool"), p.add_argument("obj")
    p.add_argument("outfile", nargs="?", default="-")
    p = sub.add_parser("rm")
    p.add_argument("pool"), p.add_argument("obj")
    p = sub.add_parser("stat")
    p.add_argument("pool"), p.add_argument("obj")
    p = sub.add_parser("bench")
    p.add_argument("pool")
    p.add_argument("seconds", type=float)
    p.add_argument("mode", choices=["write", "seq"])
    p.add_argument("-b", "--block-size", type=int, default=4 << 20)
    p.add_argument("-t", "--concurrency", type=int, default=16)
    p.add_argument("--no-cleanup", action="store_true")
    return ap


def main(argv=None, rados=None, out=None) -> int:
    out = out or sys.stdout
    ap = parser()
    a = ap.parse_args(argv)
    own = rados is None
    if own:
        if not a.monmap:
            ap.error("--monmap required (or pass rados=)")
        rados = _connect(a)
    try:
        from ..client import RadosError
        try:
            if a.cmd == "bench":
                return _bench(rados, a, out) or 0
            rc = {"lspools": cmd_lspools, "mkpool": cmd_mkpool,
                  "put": cmd_put, "get": cmd_get, "rm": cmd_rm,
                  "stat": cmd_stat}[a.cmd](rados, a, out)
            return rc or 0
        except RadosError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    finally:
        if own:
            rados.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
