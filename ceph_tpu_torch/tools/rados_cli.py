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
    rados --monmap mm.json serve put data ckpt ./shard.bin --shard s0

The port's copy of `ceph_tpu.tools.rados_cli` for the verbs the port's
librados carries: `lspools`, `mkpool` (a replicated pool, as in the
reference), `rmpool`, `ls`, `put`, `get`, `rm`, `stat`, `setxattr`,
`getxattr`, `listxattr`, `setomapval`, `listomapvals`, `bench <pool>
<seconds> write|seq -b -t [--no-cleanup]` (`seq` lists the pool's
`benchmark_data_*` objects, as the reference does), the paged artifact
store's `serve put|get|stat|pages`, the mon's crash table (`crash
ls|ls-new|stat|info|archive|archive-all|prune`), the mgr modules the
mon proxies (`telemetry [show|status|on|off|channel]`, `insights`) and
`trace <id> --asok-dir D`, which needs no cluster: it asks every admin
socket under D for the trace's spans and prints one span tree; the
multisite admin verbs (`rgw realm|zonegroup|zone|period|datalog` on a
zone's pool, `rgw sync-status --endpoint` against a running gateway,
signed with `--access/--secret`); with
`--monmap`, `--keyring` and `--timeout`; the output text and return
codes are the reference's.  Two rules differ:

* `bench ... seq` checks every read: it must hold the block size and
  equal the first read (one write bench stores one payload in every
  object), and a read that differs fails the run;
* with a keyring that holds `client.admin`, the client authenticates
  (cephx) as `client.admin`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


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
    r.pool_create(a.pool, pg_num=a.pg_num)
    print(f"successfully created pool {a.pool}", file=out)


def cmd_rmpool(r, a, out):
    rc, outs, _ = r.mon_command(
        {"prefix": "osd pool delete", "pool": a.pool,
         "yes_i_really_really_mean_it": True})
    if rc < 0:
        print(f"error: {outs}", file=sys.stderr)
        return
    print(f"successfully deleted pool {a.pool}", file=out)


def cmd_ls(r, a, out):
    io = r.open_ioctx(a.pool)
    for o in io.list_objects():
        print(o, file=out)


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


def cmd_setxattr(r, a, out):
    r.open_ioctx(a.pool).set_xattr(a.obj, a.name, a.value.encode())


def cmd_getxattr(r, a, out):
    v = r.open_ioctx(a.pool).get_xattr(a.obj, a.name)
    print(v.decode(errors="replace"), file=out)


def cmd_listxattr(r, a, out):
    for k in sorted(r.open_ioctx(a.pool).get_xattrs(a.obj)):
        print(k, file=out)


def cmd_setomapval(r, a, out):
    r.open_ioctx(a.pool).set_omap(a.obj, {a.key: a.value.encode()})


def cmd_listomapvals(r, a, out):
    vals, _ = r.open_ioctx(a.pool).get_omap_vals(a.obj)
    for k in sorted(vals):
        print(f"{k}\n value ({len(vals[k])} bytes) :", file=out)
        print(vals[k].decode(errors="replace"), file=out)


# ------------------------------------------- crash / telemetry / insights
# (ref: src/ceph.in routing `ceph crash|telemetry|insights ...` to the
#  mon, which serves crash from its table and proxies the rest to the
#  active mgr)

def _mon_verb(r, cmd: dict, out) -> int:
    rc, outs, outb = r.mon_command(cmd)
    if rc < 0:
        print(f"error: {outs}", file=sys.stderr)
        return 1
    if outb is not None:
        print(json.dumps(outb, indent=1, sort_keys=True), file=out)
    elif outs:
        print(outs, file=out)
    return 0


def cmd_crash(r, a, out):
    cmd = {"prefix": f"crash {a.verb}"}
    if a.verb in ("info", "archive"):
        if not a.arg:
            print(f"error: crash {a.verb} wants a crash id",
                  file=sys.stderr)
            return 1
        cmd["id"] = a.arg
    elif a.verb == "prune":
        # an omitted keep-days must NOT default to 0 — that means
        # "drop every archived report"
        try:
            cmd["keep"] = float(a.arg)
        except (TypeError, ValueError):
            print("error: crash prune wants <keep-days> (a number)",
                  file=sys.stderr)
            return 1
    return _mon_verb(r, cmd, out)


def cmd_telemetry(r, a, out):
    cmd = {"prefix": f"telemetry {a.verb}"}
    if a.verb == "channel":
        if not a.name:
            print("error: telemetry channel wants <name> [on|off]",
                  file=sys.stderr)
            return 1
        cmd["name"] = a.name
        cmd["enabled"] = a.state != "off"
    return _mon_verb(r, cmd, out)


def cmd_insights(r, a, out):
    return _mon_verb(r, {"prefix": "insights"}, out)


def cmd_trace(r, a, out):
    """Assemble one cross-daemon trace: query every daemon's
    `dump_traces` ring (admin sockets under --asok-dir) by trace_id
    and print ONE indented span tree with per-span durations (the
    blkin/zipkin-UI job as a CLI verb)."""
    import glob

    from ..common.admin_socket import admin_command
    from ..common.tracing import format_tree, span_tree

    if not a.asok_dir:
        print("error: trace wants --asok-dir <dir of *.asok>",
              file=sys.stderr)
        return 1
    spans, asked = [], 0
    for p in sorted(glob.glob(os.path.join(a.asok_dir, "*.asok"))):
        try:
            rc, got = admin_command(
                p, {"prefix": "dump_traces", "trace_id": a.trace_id})
        except OSError as e:
            print(f"warning: {p}: {e}", file=sys.stderr)
            continue
        asked += 1
        if rc == 0 and isinstance(got, list):
            spans.extend(got)
    if not asked:
        print(f"error: no *.asok under {a.asok_dir}", file=sys.stderr)
        return 1
    if not spans:
        print(f"no spans found for trace {a.trace_id} "
              f"({asked} daemons asked)", file=out)
        return 1
    print(f"trace {a.trace_id}: {len(spans)} spans from {asked} "
          f"daemons, {len(span_tree(spans))} root(s)", file=out)
    for line in format_tree(spans):
        print(line, file=out)
    return 0


# ------------------------------------------------- rgw multisite admin
# (ref: src/rgw/rgw_admin.cc realm/zonegroup/zone/period/datalog verbs
#  + `radosgw-admin sync status`)

def cmd_rgw(r, a, out):
    import json
    import urllib.error
    import urllib.request
    from ..rgw.multisite import (MultisiteAdmin, MultisiteError,
                                 render_sync_status)
    from ..rgw.datalog import DataLog

    def usage(msg):
        print(f"error: {msg}", file=sys.stderr)
        return 1

    if a.verb == "sync-status":
        # live agent state lives in the gateway process, not RADOS:
        # ask its /admin REST surface (ref: radosgw-admin asking the
        # running gateway over the admin socket/REST)
        if not a.endpoint:
            return usage("rgw sync-status wants --endpoint http://gw")
        url = a.endpoint.rstrip("/") + "/admin/sync-status"
        hdrs = {}
        if a.access and a.secret:
            # secured gateways gate /admin to the system user: sign
            # like the sync agents do (gateway.peer_request)
            from urllib.parse import urlparse as _up
            from ..rgw.auth import sign_request
            u = _up(url)
            hdrs = sign_request("GET", u.path, {"host": u.netloc},
                                b"", a.access, a.secret)
        try:
            with urllib.request.urlopen(
                    urllib.request.Request(url, headers=hdrs),
                    timeout=a.timeout) as resp:
                st = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # the gateway answered and REFUSED — saying "unreachable"
            # would send the operator chasing a network problem
            hint = " (secured gateway: pass the system user's " \
                   "--access/--secret)" if e.code == 403 else ""
            return usage(f"gateway refused: HTTP {e.code}"
                         f" {e.reason}{hint}")
        except (urllib.error.URLError, OSError, ValueError) as e:
            # a down gateway is an operator-readable error, not a
            # traceback
            return usage(f"gateway unreachable: {e}")
        for line in render_sync_status(st):
            print(line, file=out)
        return 0
    io = r.open_ioctx(a.pool)
    adm = MultisiteAdmin(io)
    args = a.args
    try:
        if a.verb == "realm":
            if args[:1] != ["create"] or len(args) != 2:
                return usage("rgw realm create <name>")
            adm.realm_create(args[1])
        elif a.verb == "zonegroup":
            if args[:1] != ["create"] or len(args) != 2:
                return usage("rgw zonegroup create <name>")
            adm.zonegroup_create(args[1])
        elif a.verb == "zone":
            if len(args) != 2 or args[0] not in ("create", "modify"):
                return usage("rgw zone create|modify <name> "
                             "--zonegroup <zg> [--endpoint url] "
                             "[--master]")
            if args[0] == "create":
                adm.zone_create(args[1], a.zonegroup,
                                endpoint=a.endpoint or "",
                                master=a.master)
            else:
                adm.zone_modify(args[1], a.zonegroup,
                                endpoint=a.endpoint or None,
                                master=True if a.master else None)
        elif a.verb == "period":
            if args[:1] == ["get"]:
                print(json.dumps(adm.period_get(), indent=1,
                                 sort_keys=True), file=out)
            elif args[:1] == ["commit"]:
                print(f"period epoch {adm.period_commit()}", file=out)
            else:
                return usage("rgw period get|commit")
        elif a.verb == "datalog":
            dl = DataLog(io)
            if args[:1] == ["status"] and len(args) == 2:
                for s, head in sorted(
                        dl.heads(args[1], a.shards).items()):
                    print(f"shard {s}: head {head}", file=out)
            elif args[:1] == ["trim"] and len(args) == 4:
                n = dl.trim(args[1], int(args[2]), int(args[3]))
                print(f"trimmed {n} entries", file=out)
            else:
                return usage("rgw datalog status <bucket> | "
                             "trim <bucket> <shard> <upto>")
        else:
            return usage(f"unknown rgw verb {a.verb}")
    except MultisiteError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_serve(r, a, out):
    """Paged artifact store verbs (serve/): put a checkpoint shard,
    stream it back through a readahead policy, stat the manifest, or
    inspect individual pages."""
    import hashlib
    from ..serve import ArtifactStore

    def usage(msg):
        print(f"error: {msg}", file=sys.stderr)
        return 1

    io = r.open_ioctx(a.pool)
    st = ArtifactStore(io, page_size=a.page_size)
    if a.verb == "put":
        if len(a.args) != 1:
            return usage("serve put <pool> <name> <infile> "
                         "[--shard s] [--page-size n]")
        if a.args[0] == "-":
            data = sys.stdin.buffer.read()
        else:
            with open(a.args[0], "rb") as f:
                data = f.read()
        m = st.put(a.name, shards={a.shard: data})
        si = m.shards[a.shard]
        print(f"published {a.name} epoch {m.epoch}: shard "
              f"{a.shard} {si.size} B in {si.n_pages} pages "
              f"({len(si.vlens)} ragged)", file=out)
    elif a.verb == "get":
        if len(a.args) > 1:
            return usage("serve get <pool> <name> [outfile] "
                         "[--shard s] [--policy p]")
        h = st.open(a.name, policy=a.policy)
        data = h.read_shard(a.shard)
        h.close()
        outfile = a.args[0] if a.args else "-"
        if outfile == "-":
            out.write(data.decode(errors="replace"))
        else:
            with open(outfile, "wb") as f:
                f.write(data)
    elif a.verb == "stat":
        print(json.dumps(st.stat(a.name), indent=1, sort_keys=True),
              file=out)
    elif a.verb == "pages":
        if len(a.args) != 2:
            return usage("serve pages <pool> <name> <shard> "
                         "<id,id,...>")
        shard = a.args[0]
        try:
            ids = [int(x) for x in a.args[1].split(",") if x]
        except ValueError:
            return usage(f"bad page-id list {a.args[1]!r}")
        m = st.manifest(a.name)
        if shard not in m.shards:
            return usage(f"no shard {shard!r} in {a.name}")
        blobs = st.fetch_pages(a.name, shard, ids, manifest=m)
        for pid, blob in zip(ids, blobs):
            digest = hashlib.sha256(blob).hexdigest()[:16]
            print(f"page {pid}: {len(blob)} B sha256 {digest}",
                  file=out)
    return 0


# ---------------------------------------------------------------- bench
# (ref: src/common/obj_bencher.cc ObjBencher::write_bench /
#  seq_read_bench: fixed-depth aio pipeline, per-op latency tracking,
#  bandwidth summary)

def _bench(r, a, out):
    io = r.open_ioctx(a.pool)
    size, depth, secs = a.block_size, a.concurrency, a.seconds
    prefix = f"benchmark_data_{os.getpid()}_"
    payload = os.urandom(size)

    if a.mode == "write":
        submit = lambda i: io.aio_write_full(prefix + str(i), payload)
    else:
        # seq read over whatever a prior write bench left behind
        objs = sorted(o for o in io.list_objects()
                      if o.startswith("benchmark_data_"))
        if not objs:
            print("no benchmark objects; run write first", file=out)
            return 1
        submit = lambda i: io.aio_read(objs[i % len(objs)])
        payload = None              # the first read's bytes

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
        if a.mode == "seq":
            if payload is None and len(fut.data) == size:
                payload = fut.data
            if fut.data != payload:
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
    if a.mode == "write" and not a.no_cleanup:
        from ..client import RadosError
        for j in range(i):
            try:
                io.remove(prefix + str(j))
            except RadosError:
                pass            # best-effort cleanup of bench objects
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
    p = sub.add_parser("rmpool")
    p.add_argument("pool")
    p = sub.add_parser("ls")
    p.add_argument("pool")
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
    p = sub.add_parser("setxattr")
    p.add_argument("pool"), p.add_argument("obj")
    p.add_argument("name"), p.add_argument("value")
    p = sub.add_parser("getxattr")
    p.add_argument("pool"), p.add_argument("obj"), p.add_argument("name")
    p = sub.add_parser("listxattr")
    p.add_argument("pool"), p.add_argument("obj")
    p = sub.add_parser("setomapval")
    p.add_argument("pool"), p.add_argument("obj")
    p.add_argument("key"), p.add_argument("value")
    p = sub.add_parser("listomapvals")
    p.add_argument("pool"), p.add_argument("obj")
    p = sub.add_parser("crash")
    p.add_argument("verb", choices=["ls", "ls-new", "stat", "info",
                                    "archive", "archive-all", "prune"])
    p.add_argument("arg", nargs="?",
                   help="crash id (info/archive) or keep-days (prune)")
    p = sub.add_parser("telemetry")
    p.add_argument("verb", nargs="?", default="show",
                   choices=["show", "status", "on", "off", "channel"])
    p.add_argument("name", nargs="?", help="channel name")
    p.add_argument("state", nargs="?", default="on",
                   choices=["on", "off"])
    sub.add_parser("insights")
    p = sub.add_parser("trace")
    p.add_argument("trace_id", help="trace id to assemble")
    p.add_argument("--asok-dir", default="",
                   help="directory of daemon admin sockets (*.asok) "
                        "to query dump_traces on")
    p = sub.add_parser("rgw")
    p.add_argument("verb", choices=["realm", "zonegroup", "zone",
                                    "period", "datalog",
                                    "sync-status"])
    p.add_argument("args", nargs="*")
    p.add_argument("--pool", default="rgw",
                   help="the zone's rgw pool (period + datalog live "
                        "there)")
    p.add_argument("--zonegroup", default="",
                   help="zonegroup for zone create/modify")
    p.add_argument("--endpoint", default="",
                   help="zone endpoint URL (zone create/modify) or "
                        "gateway URL (sync-status)")
    p.add_argument("--master", action="store_true",
                   help="make the zone the zonegroup's metadata "
                        "master")
    p.add_argument("--shards", type=int, default=8,
                   help="index shards to report (datalog status)")
    p.add_argument("--access", default="",
                   help="system-user access key: secured gateways "
                        "gate /admin to the multisite system user "
                        "(sync-status)")
    p.add_argument("--secret", default="",
                   help="system-user secret key (sync-status)")
    p = sub.add_parser("serve")
    p.add_argument("verb", choices=["put", "get", "stat", "pages"])
    p.add_argument("pool")
    p.add_argument("name", help="artifact name")
    p.add_argument("args", nargs="*")
    p.add_argument("--shard", default="shard0",
                   help="shard name (put/get)")
    p.add_argument("--page-size", type=int, default=1 << 16,
                   help="page size for put (readers take it from "
                        "the manifest)")
    p.add_argument("--policy", default="checkpoint",
                   choices=["checkpoint", "kvcache"],
                   help="readahead policy for get")
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
    if a.cmd == "trace":
        # pure admin-socket verb: needs no cluster connection
        return cmd_trace(None, a, out) or 0
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
                  "rmpool": cmd_rmpool, "ls": cmd_ls, "put": cmd_put,
                  "get": cmd_get, "rm": cmd_rm, "stat": cmd_stat,
                  "setxattr": cmd_setxattr, "getxattr": cmd_getxattr,
                  "listxattr": cmd_listxattr,
                  "setomapval": cmd_setomapval,
                  "listomapvals": cmd_listomapvals,
                  "crash": cmd_crash, "telemetry": cmd_telemetry,
                  "insights": cmd_insights,
                  "rgw": cmd_rgw,
                  "serve": cmd_serve}[a.cmd](rados, a, out)
            return rc or 0
        except RadosError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    finally:
        if own:
            rados.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
