"""vstart: boot a cluster in-process and drive it with ceph-style
commands.

The vstart.sh + `ceph` CLI analogue for this framework (ref:
src/vstart.sh, src/ceph.in): one process hosts mon + mgr + N OSDs over
the local transport; stdin (or -c arguments) takes a ceph-flavored
command language:

    osd stat | osd dump | osd tree | osd down/out/in <id>
    osd pool create <name> <pg_num> [erasure [<profile>]]
    osd erasure-code-profile set <name> k=K m=M [plugin=tpu] [...]
    osd erasure-code-profile ls | get <name>
    pg map <pgid> | pg scrub <pgid> | pg repair <pgid>
    put <pool> <obj> <file|-> | get <pool> <obj> [file]
    rm <pool> <obj> | ls <pool> | stat <pool> <obj>
    balance | balancer status
    fs status | kill-mds <rank> | add-standby
    kill-osd <id> | revive-osd <id> | crash-osd <id> | tick
    crash [ls|ls-new|stat|info <id>|archive <id>|archive-all|prune <d>]
    telemetry [show|status|on|off] | insights
    trace on|off | trace ls | trace <trace_id>
    serve put <pool> <name> <file> | serve get <pool> <name> [file]
    serve stat <pool> <name> | serve pages <pool> <name> <shard> <ids>
    perf dump | status | quit

Example:
    echo "osd stat" | python -m ceph_tpu_torch.tools.vstart --osds 4
    python -m ceph_tpu_torch.tools.vstart --osds 6 \\
        -c "osd pool create p 32" -c "put p hello /etc/hostname" \\
        -c "get p hello -" -c status

The port's copy of `ceph_tpu.tools.vstart`.  It drives the port's
cluster (`testing.MiniCluster` with its mgr, MDS and rgw helpers), so
an EC pool's writes, degraded reads and scrubs run K1 and `balance`
runs K3.  One argument is the port's own, as on its other entry
points: ``device=`` on VstartShell and ``--device cuda|cpu`` on main.
None or cuda means the card, and raises where there is none; cpu runs
the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import shlex
import sys

from ..testing.cluster import MiniCluster


class VstartShell:
    def __init__(self, n_osd: int = 4, osds_per_host: int = 1,
                 out=None, n_mon: int = 1, n_mds: int = 0,
                 n_standby: int = 0, device=None):
        # sys.stdout as it is when the shell starts, so a caller's
        # redirect_stdout reaches it
        self.out = sys.stdout if out is None else out
        self.cluster = MiniCluster(n_osd=n_osd,
                                   osds_per_host=osds_per_host,
                                   threaded=True, n_mon=n_mon,
                                   device=device)
        self.cluster.wait_all_up()
        self.rados = self.cluster.rados()
        self.mgr = self.cluster.start_mgr()
        # observability modules (ref: vstart.sh enabling mgr modules):
        # crash health, anonymized telemetry, windowed insights
        self.mgr.start_crash()
        self.mgr.start_telemetry()
        self.mgr.start_insights()
        self.mgr.observability_tick()
        # MDS ranks + standby pool (ref: vstart.sh MDS=N spawning +
        # standbys): ranks beacon to the mon, standbys wait for
        # promotion
        for rank in range(n_mds):
            self.cluster.start_mds(rank)
        for _ in range(n_standby):
            self.cluster.start_mds_standby()
        for rank in range(n_mds):
            self.cluster.wait_mds_active(rank)
        self._now = 10_000.0
        #: set while commands stream from stdin (put ... - is invalid)
        self.stdin_is_script = False

    def close(self) -> None:
        self.cluster.shutdown()

    def _print(self, *args) -> None:
        print(*args, file=self.out)

    # ----------------------------------------------------------- exec
    def run_line(self, line: str) -> bool:
        """Execute one command; returns False on quit."""
        toks = shlex.split(line.strip())
        if not toks or toks[0].startswith("#"):
            return True
        try:
            return self._dispatch(toks)
        except Exception as ex:                     # CLI surface: report
            self._print(f"Error: {type(ex).__name__}: {ex}")
            return True

    def _dispatch(self, toks: list[str]) -> bool:
        cmd = toks[0]
        if cmd in ("quit", "exit"):
            return False
        if cmd == "status":
            # `ceph -s` (ref: Monitor.cc get_cluster_status)
            _r, _outs, s = self.rados.mon_command({"prefix": "status"})
            st = self.mgr.status()
            pools = ", ".join(self.rados.list_pools()) or "-"
            h = s["health"]
            self._print(f"  health:  {h['status']}"
                        + ("" if not h["checks"] else
                           "  [" + "; ".join(h["checks"].values())
                           + "]"))
            self._print(f"  mon:     quorum {s['monmap']['quorum']} "
                        f"leader mon.{s['monmap']['leader']}")
            om = s["osdmap"]
            self._print(f"  osd:     {om['num_osds']} osds: "
                        f"{om['num_up_osds']} up, "
                        f"{om['num_in_osds']} in (e{om['epoch']})")
            pm = s["pgmap"]
            self._print(f"  data:    {pm['num_pgs']} pgs "
                        f"{dict(pm['pgs_by_state'])}, "
                        f"{pm['num_objects']} objects, "
                        f"{pm['bytes_data']} bytes")
            self._print(f"  pools:   {pools}")
            self._print(f"  balancer: active={st['active']} "
                        f"score={st['score']}")
            return True
        if cmd in ("health", "df"):
            _r, outs, outb = self.rados.mon_command({"prefix": cmd})
            self._print(outs if cmd == "health"
                        else json.dumps(outb, indent=1))
            return True
        if cmd == "osd":
            return self._osd(toks[1:])
        if cmd == "pg":
            return self._pg(toks[1:])
        if cmd == "put":
            pool, obj, src = toks[1], toks[2], toks[3]
            if src == "-":
                if self.stdin_is_script:
                    raise ValueError(
                        "put ... - cannot read stdin while commands "
                        "come from stdin; use a file path")
                data = sys.stdin.buffer.read()
            else:
                data = open(src, "rb").read()
            self.rados.open_ioctx(pool).write_full(obj, data)
            self._print(f"wrote {len(data)} bytes to {pool}/{obj}")
            return True
        if cmd == "get":
            pool, obj = toks[1], toks[2]
            dst = toks[3] if len(toks) > 3 else "-"
            data = self.rados.open_ioctx(pool).read(obj)
            if dst == "-":
                self.out.write(data.decode(errors="replace"))
                self.out.flush()
            else:
                open(dst, "wb").write(data)
                self._print(f"read {len(data)} bytes to {dst}")
            return True
        if cmd == "rm":
            self.rados.open_ioctx(toks[1]).remove(toks[2])
            self._print("removed")
            return True
        if cmd == "ls":
            for oid in self.rados.open_ioctx(toks[1]).list_objects():
                self._print(oid)
            return True
        if cmd == "stat":
            st = self.rados.open_ioctx(toks[1]).stat(toks[2])
            self._print(json.dumps(st))
            return True
        if cmd == "balance":
            n = self.mgr.tick()
            self._print(f"submitted {n} upmap changes; "
                        f"score {self.mgr.status()['score']}")
            return True
        if cmd == "balancer" and toks[1:] == ["status"]:
            self._print(json.dumps(self.mgr.status(), indent=1))
            return True
        if cmd == "fs" and toks[1:] == ["status"]:
            _r, outs, outb = self.rados.mon_command(
                {"prefix": "fs status"})
            self._print(outs)
            self._print(json.dumps(outb, indent=1))
            return True
        if cmd == "kill-mds":
            self.cluster.kill_mds(int(toks[1]))
            self._print(f"mds.{toks[1]} killed")
            return True
        if cmd == "add-standby":
            s = self.cluster.start_mds_standby()
            self._print(f"standby {s.name} (gid {s.gid}) joined")
            return True
        if cmd == "kill-osd":
            self.cluster.kill_osd(int(toks[1]))
            self._print(f"osd.{toks[1]} killed")
            return True
        if cmd == "crash-osd":
            # inject a fault: the OSD posts a crash report and dies
            self.cluster.crash_osd(int(toks[1]))
            self.mgr.observability_tick()
            self._print(f"osd.{toks[1]} crashed (see `crash ls`)")
            return True
        if cmd == "crash":
            verb = toks[1] if len(toks) > 1 else "ls"
            c = {"prefix": f"crash {verb}"}
            if verb in ("info", "archive"):
                c["id"] = toks[2]
            elif verb == "prune":
                # an omitted keep-days must NOT default to 0 — that
                # means "drop every archived report"
                try:
                    c["keep"] = float(toks[2])
                except (IndexError, ValueError):
                    self._print("crash prune wants <keep-days>"
                                " (a number)")
                    return True
            _r, outs, outb = self.rados.mon_command(c)
            self._print(outs if outb is None
                        else json.dumps(outb, indent=1))
            if verb.startswith("archive"):
                self.mgr.observability_tick()   # clears RECENT_CRASH
            return True
        if cmd == "telemetry":
            verb = toks[1] if len(toks) > 1 else "show"
            self.mgr.observability_tick()       # fresh report
            _r, outs, outb = self.rados.mon_command(
                {"prefix": f"telemetry {verb}"})
            self._print(outs if outb is None
                        else json.dumps(outb, indent=1))
            return True
        if cmd == "insights":
            self.mgr.observability_tick()
            _r, outs, outb = self.rados.mon_command(
                {"prefix": "insights"})
            self._print(outs if outb is None
                        else json.dumps(outb, indent=1))
            return True
        if cmd == "revive-osd":
            self.cluster.revive_osd(int(toks[1]))
            self._print(f"osd.{toks[1]} revived")
            return True
        if cmd == "tick":
            import time
            from ..common.options import global_config
            grace = global_config()["osd_heartbeat_grace"]
            for _ in range(3):
                self._now += grace / 2 + 1
                self.cluster.tick(self._now)
                # threaded cluster: let ping replies land before the
                # next round's grace check, else live peers race past
                # the window and get falsely reported
                time.sleep(0.1)
            self.mgr.observability_tick()
            self._print(f"ticked; {self.rados.mon_command({'prefix': 'osd stat'})[1]}")
            return True
        if cmd == "rgw":
            return self._rgw(toks[1:])
        if cmd == "serve":
            return self._serve(toks[1:])
        if cmd == "trace":
            return self._trace(toks[1:])
        if cmd == "perf" and toks[1:] == ["dump"]:
            self._print(json.dumps(
                self.cluster.perf_collection.perf_dump(), indent=1,
                sort_keys=True))
            return True
        raise ValueError(f"unknown command {' '.join(toks)!r} "
                         "(see module docstring)")

    def _osd(self, toks: list[str]) -> bool:
        if toks[0] == "pool" and toks[1] == "create":
            name, pg_num = toks[2], int(toks[3])
            ptype = toks[4] if len(toks) > 4 else "replicated"
            profile = toks[5] if len(toks) > 5 else ""
            self.rados.pool_create(name, pg_num=pg_num, pool_type=ptype,
                                   erasure_code_profile=profile)
            self._print(f"pool '{name}' created")
            return True
        if toks[0] == "erasure-code-profile" and toks[1] == "set":
            name = toks[2]
            profile = dict(kv.split("=", 1) for kv in toks[3:])
            r, outs, _ = self.rados.mon_command(
                {"prefix": "osd erasure-code-profile set", "name": name,
                 "profile": profile, "force": True})
            self._print(outs or f"profile '{name}' set")
            return True
        if toks[0] in ("down", "out", "in"):
            r, outs, _ = self.rados.mon_command(
                {"prefix": f"osd {toks[0]}",
                 "ids": [int(t) for t in toks[1:]]})
            self._print(outs)
            return True
        # passthrough read commands: stat/dump/tree/ls/erasure-code-
        # profile ls|get/pool ls|get
        cmd = {"prefix": "osd " + " ".join(
            t for t in toks if "=" not in t)}
        if toks[0] == "erasure-code-profile" and len(toks) > 2:
            cmd = {"prefix": f"osd erasure-code-profile {toks[1]}",
                   "name": toks[2]}
        elif toks[0] == "pool" and toks[1] == "get":
            cmd = {"prefix": "osd pool get", "pool": toks[2],
                   "var": toks[3]}
        r, outs, outb = self.rados.mon_command(cmd)
        self._print(outs if outs else json.dumps(outb, default=str))
        return True

    def _rgw(self, toks: list[str]) -> bool:
        """rgw multisite verbs (ref: vstart.sh RGW=n + the
        radosgw-admin sync/period surface):
          rgw start [zoneA zoneB ...]  — multisite gateways (first
                                         zone is the metadata master)
          rgw sync-status [zone]       — per-source lag / caught-up
          rgw period [zone]            — the zone's committed period
          rgw put <zone> <bucket> <key> <value>
          rgw get <zone> <bucket> <key>
        """
        import urllib.request
        if not hasattr(self, "rgw_zones"):
            self.rgw_zones: dict[str, object] = {}
        if not toks:
            self._print("rgw start|sync-status|period|put|get ...")
            return True
        sub, rest = toks[0], toks[1:]
        if sub == "start":
            zones = rest or ["z1", "z2"]
            for gw in self.cluster.rgw_multisite(zones):
                self.rgw_zones[gw.zone] = gw
                role = "master" if gw.multisite.is_master() \
                    else "secondary"
                self._print(f"rgw zone {gw.zone} ({role}) "
                            f"on :{gw.port} pool rgw-{gw.zone}")
            return True
        if sub in ("sync-status", "period"):
            for zone in (rest or sorted(self.rgw_zones)):
                gw = self.rgw_zones[zone]
                if sub == "period":
                    self._print(f"{zone}: "
                                f"{json.dumps(gw.multisite.period)}")
                    continue
                from ..rgw.multisite import render_sync_status
                for line in render_sync_status(gw.sync.status()):
                    self._print(line)
            return True
        if sub in ("put", "get"):
            want = 4 if sub == "put" else 3
            if len(rest) != want:
                self._print(f"Error: rgw {sub} wants {want} args")
                return True
            gw = self.rgw_zones[rest[0]]
            url = (f"http://127.0.0.1:{gw.port}"
                   f"/{rest[1]}/{rest[2]}")
            if sub == "put":
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{gw.port}/{rest[1]}",
                    method="PUT"), timeout=30).read()
                urllib.request.urlopen(urllib.request.Request(
                    url, data=rest[3].encode(), method="PUT"),
                    timeout=30).read()
                self._print("ok")
            else:
                with urllib.request.urlopen(url, timeout=30) as r:
                    self._print(r.read().decode(errors="replace"))
            return True
        self._print(f"Error: unknown rgw verb {sub}")
        return True

    def _serve(self, toks: list[str]) -> bool:
        """Paged artifact store verbs (ceph_tpu_torch.serve):
          serve put <pool> <name> <file>    — publish as one shard
          serve get <pool> <name> [file]    — stream a shard back
          serve stat <pool> <name>          — manifest summary
          serve pages <pool> <name> <shard> <id,id,...>
        """
        import hashlib
        from ..serve import ArtifactStore
        if not toks:
            self._print("serve put|get|stat|pages ...")
            return True
        sub, rest = toks[0], toks[1:]
        if sub not in ("put", "get", "stat", "pages") or \
                len(rest) < 2:
            self._print(f"Error: serve {sub} wants "
                        "<pool> <name> ... (see docstring)")
            return True
        st = ArtifactStore(self.rados.open_ioctx(rest[0]))
        name = rest[1]
        if sub == "put":
            if len(rest) != 3:
                self._print("Error: serve put <pool> <name> <file>")
                return True
            data = open(rest[2], "rb").read()
            m = st.put(name, shards={"shard0": data})
            si = m.shards["shard0"]
            self._print(f"published {name} epoch {m.epoch}: "
                        f"{si.size} B in {si.n_pages} pages")
            return True
        if sub == "get":
            h = st.open(name)
            data = h.read_shard("shard0")
            h.close()
            dst = rest[2] if len(rest) > 2 else "-"
            if dst == "-":
                self.out.write(data.decode(errors="replace"))
                self.out.flush()
            else:
                open(dst, "wb").write(data)
                self._print(f"read {len(data)} bytes to {dst}")
            return True
        if sub == "stat":
            self._print(json.dumps(st.stat(name), indent=1,
                                   sort_keys=True))
            return True
        # pages
        if len(rest) != 4:
            self._print("Error: serve pages <pool> <name> <shard> "
                        "<id,id,...>")
            return True
        ids = [int(x) for x in rest[3].split(",") if x]
        for pid, blob in zip(ids, st.fetch_pages(name, rest[2], ids)):
            digest = hashlib.sha256(blob).hexdigest()[:16]
            self._print(f"page {pid}: {len(blob)} B sha256 {digest}")
        return True

    def _trace(self, toks: list[str]) -> bool:
        """Distributed tracing verbs:
          trace on|off         — toggle blkin_trace_all
          trace ls             — recent trace ids (client roots)
          trace <trace_id>     — assemble ONE cross-daemon span tree
        """
        from ..common.options import global_config
        from ..common.tracing import format_tree
        if not toks:
            self._print("trace on|off|ls|<trace_id>")
            return True
        if toks[0] in ("on", "off"):
            global_config().set("blkin_trace_all", toks[0] == "on")
            self._print(f"tracing {toks[0]}")
            return True
        if toks[0] == "ls":
            seen = []
            for s in self.rados.objecter.dump_traces():
                if s["trace_id"] not in seen:
                    seen.append(s["trace_id"])
            for t in seen[-20:]:
                self._print(t)
            return True
        tid = toks[0]
        spans = list(self.rados.objecter.dump_traces(tid))
        for c in self.cluster.clients:
            if c is not self.rados:
                spans += c.objecter.dump_traces(tid)
        daemons = list(self.cluster.mons.values()) \
            + list(self.cluster.osds.values()) \
            + list(self.cluster.mdss.values()) \
            + list(getattr(self, "rgw_zones", {}).values())
        if self.mgr is not None:
            daemons.append(self.mgr)
        for d in daemons:
            tr = getattr(d, "tracer", None)
            if tr is not None:
                spans += tr.dump(tid)
        if not spans:
            self._print(f"no spans for trace {tid}")
            return True
        for line in format_tree(spans):
            self._print(line)
        return True

    def _pg(self, toks: list[str]) -> bool:
        verb, pgid = toks[0], toks[1]
        pool_s, _, ps_s = pgid.partition(".")
        if verb == "map":
            r, outs, _ = self.rados.mon_command(
                {"prefix": "pg map", "pgid": pgid})
            self._print(outs)
            return True
        if verb in ("scrub", "deep-scrub", "repair"):
            res = self.rados.pg_scrub(int(pool_s), int(ps_s, 16),
                                      repair=verb == "repair")
            self._print(json.dumps(res))
            return True
        raise ValueError(f"unknown pg command {verb!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vstart", description="in-process cluster + ceph-style CLI")
    ap.add_argument("--osds", type=int, default=4)
    ap.add_argument("--osds-per-host", type=int, default=1)
    ap.add_argument("--mons", type=int, default=1,
                    help="monitor quorum size")
    ap.add_argument("--mds", type=int, default=0,
                    help="MDS ranks to spawn")
    ap.add_argument("--standby-mds", type=int, default=0,
                    help="standby MDS daemons to spawn")
    ap.add_argument("-c", "--command", action="append", default=[],
                    help="run command and continue (repeatable)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the kernels on the card (raises without "
                         "one); cpu: their plain versions")
    args = ap.parse_args(argv)
    sh = VstartShell(args.osds, args.osds_per_host, n_mon=args.mons,
                     n_mds=args.mds, n_standby=args.standby_mds,
                     device=args.device)
    try:
        for cmd in args.command:
            if not sh.run_line(cmd):
                return 0
        if not args.command or not sys.stdin.isatty():
            sh.stdin_is_script = True
            for line in sys.stdin:
                if not sh.run_line(line):
                    break
    finally:
        sh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
