"""MgrDaemon: the balancer loop as a wire citizen.

The mgr shape (ref: src/mgr/Mgr.cc + the balancer module's serve loop,
src/pybind/mgr/balancer/module.py:340 serve -> optimize -> execute):
subscribe to osdmaps, periodically run the upmap optimizer against the
current map, and submit the resulting pg-upmap-items commands to the
mon, which commits them and publishes the new epoch back.

The optimizer itself is osd/balancer.py (calc_pg_upmaps over the
mapping tables, which K3 computes on the mgr's `device`: cuda unless
the caller passes `device="cpu"`) — the mgr is the scheduling/command
glue around it.

The port's copy of `ceph_tpu.mgr.daemon` in part: map ingest, the
command channel (`_command`, the synchronous `mon_command`), the
module-command dispatch the mon proxies to it, `tick` (one balancer
round submitting `osd upmap-batch`), `status`, the pg_autoscaler
(`start_pg_autoscaler`, `autoscale_tick`), progress (`start_progress`,
`progress_tick`), `set_health_checks`, the crash reporter with its
messenger hook (`crash post` through the command channel), the crash
module (`start_crash`; `observability_tick` ticks it, and its
RECENT_CRASH slice rides the merged module-health report), the hbmap
slice of `observability_tick` and the admin socket.  Left out: the
telemetry and insights modules (so a telemetry or insights command
answers the reference's "module not enabled"), devicehealth,
prometheus and restful.
"""
from __future__ import annotations

import itertools
import threading

from ..common.heartbeat_map import HeartbeatMap
from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.options import global_config
from ..common.racecheck import shared_state
from ..common.tracing import Tracer
from ..common.tracked_op import OpTracker
from ..msg.messages import (MMap, MMgrCommand, MMgrCommandReply,
                            MMonCommand, MMonCommandAck,
                            MMonSubscribe)
from ..msg.messenger import Dispatcher, LocalNetwork, Message, Messenger
from ..msg.mon_client import MonHunter
from ..osd.balancer import Balancer
from ..osd.osdmap import OSDMap

#: mgr modules the reference's mon proxies commands to; none of them is
#: ported yet, so each answers as the reference's does when disabled
_PROXIED_MODULES = ("telemetry", "insights")


# module state shared between the dispatch thread (command replies,
# map ingest) and the observability/balancer tick — racecheck asserts
# every access holds self._lock
@shared_state(only=("_health_reports", "_pending", "_sync_cmds"),
              mutating=("_health_reports", "_pending", "_sync_cmds"))
class MgrDaemon(Dispatcher, MonHunter):
    def __init__(self, network: LocalNetwork, rank: int = 0,
                 mon="mon.0", threaded: bool = False,
                 max_deviation: int = 1, max_iterations: int = 100,
                 device=None):
        self.name = f"mgr.{rank}"
        self._init_mons(mon)
        self.osdmap = OSDMap()
        self.active = True
        self.balancer = Balancer(max_deviation=max_deviation,
                                 max_iterations=max_iterations,
                                 device=device)
        self.last_optimize: dict = {}
        self._tid = itertools.count(1)
        self._pending: set[int] = set()       # unacked command tids
        self._sync_cmds: dict = {}            # tid -> (Event, slot)
        self.failed_commands = 0
        #: pg_autoscaler module (ref: pybind/mgr/pg_autoscaler);
        #: enable with start_pg_autoscaler(), driven by autoscale_tick
        self.pg_autoscaler = None
        #: progress module (ref: pybind/mgr/progress); enable with
        #: start_progress(), driven by progress_tick
        self.progress = None
        #: crash module (ref: pybind/mgr/crash); enable with
        #: start_crash(), driven by observability_tick
        self.crash = None
        #: per-module health-check slices, merged into ONE volatile
        #: `mgr health report` so modules never clobber each other
        self._health_reports: dict[str, dict] = {}
        self._lock = make_lock(f"mgr.{self.name}")
        # op tracking + span ring: module commands proxied from the
        # mon are tracked like any daemon's ops (ref: the mgr's
        # DaemonServer op tracking), and the mgr serves the shared
        # dump_ops_in_flight/dump_traces admin surface
        self.op_tracker = OpTracker(
            history_size=global_config()["osd_op_history_size"])
        self.tracer = Tracer(self.name)
        # internal thread-liveness watchdog (the OSD's hbmap, here for
        # the mgr's observability loop): arms on the first
        # observability_tick; a stalled loop surfaces through the
        # module-health path as HEARTBEAT_STALE and in `status`
        self.hbmap = HeartbeatMap()
        self._hb_handle = self.hbmap.add_worker(
            f"{self.name}.observability", grace=60.0, arm=False)
        self.asok = None
        self.ms = Messenger.create(network, self.name, threaded=threaded)
        self.ms.add_dispatcher(self)
        # own-crash capture: the mgr posts its reports over the wire
        # like any other daemon
        from ..common.crash import CrashReporter
        self.crash_reporter = CrashReporter(
            self.name, post=self._post_crash_meta)
        self.ms.crash_hook = self.crash_reporter.capture

    def _hunt_greeting(self) -> list:
        return [MMonSubscribe(what="osdmap",
                              start=self.osdmap.epoch + 1),
                MMonCommand(tid=0, cmd={"prefix": "mgr register",
                                        "name": self.name})]

    def ms_handle_reset(self, peer: str) -> None:
        self._maybe_hunt(peer)

    # ------------------------------------------------------------ setup
    def init(self) -> None:
        self.ms.start()
        self.ms.connect(self.mon).send_message(
            MMonSubscribe(what="osdmap", start=1))
        self._register_mgr()

    def _register_mgr(self) -> None:
        """Announce ourselves as the active mgr to EVERY mon — module
        commands may arrive at any of them and each proxies from its
        own volatile registration (re-sent every observability tick;
        ref: MgrMonitor beacons)."""
        for m in self.mons:
            self.ms.connect(m).send_message(MMonCommand(
                tid=0, cmd={"prefix": "mgr register",
                            "name": self.name}))

    def _post_crash_meta(self, meta: dict) -> None:
        self._command({"prefix": "crash post", "meta": meta})

    def shutdown(self) -> None:
        if self.asok is not None:
            self.asok.shutdown()
            self.asok = None
        self.ms.shutdown()

    def start_admin_socket(self, path: str) -> None:
        """`ceph daemon mgr.N <cmd>` endpoint."""
        from ..common.admin_socket import AdminSocket
        from ..common.obs import register_obs_commands
        a = AdminSocket(path)
        register_obs_commands(a, self.op_tracker, self.tracer)
        a.register("status", "daemon status",
                   lambda c: (0, self.status()))
        a.start()
        self.asok = a

    # -------------------------------------------------------- dispatch
    def ms_dispatch(self, msg: Message) -> bool:
        if isinstance(msg, MMap):
            with self._lock:
                self.osdmap = self.osdmap.ingest(msg.full_map,
                                                 msg.incrementals)
            return True
        if isinstance(msg, MMonCommandAck):
            with self._lock:
                self._pending.discard(msg.tid)
                entry = self._sync_cmds.pop(msg.tid, None)
                if msg.result != 0 and entry is None:
                    self.failed_commands += 1
                    dout("mgr", 0).write(
                        "%s: mon command failed (%d): %s", self.name,
                        msg.result, msg.outs)
            if entry is not None:
                ev, slot = entry
                slot.update(r=msg.result, outs=msg.outs,
                            outb=msg.outb)
                ev.set()
            return True
        if isinstance(msg, MMgrCommand):
            # mon-proxied module command; answer the MON (it relays to
            # the client).  Handlers run on the dispatch thread, so
            # they answer from module-cached state only — a sync
            # mon_command here would deadlock on our own ack.
            opkey = (msg.src, msg.tid)
            self.op_tracker.start(
                opkey, f"module_command({msg.src} tid={msg.tid} "
                       f"{msg.cmd.get('prefix', '?')})")
            r, outs, outb = self._handle_module_command(msg.cmd)
            self.op_tracker.finish(opkey,
                                   "replied" if r == 0 else f"r={r}")
            self.ms.connect(msg.src).send_message(MMgrCommandReply(
                tid=msg.tid, result=r, outs=outs, outb=outb))
            return True
        return False

    def _handle_module_command(self, cmd: dict
                               ) -> tuple[int, str, object]:
        pfx = str(cmd.get("prefix", ""))
        root = pfx.split(" ", 1)[0]
        if root in _PROXIED_MODULES:
            return -2, f"{root} module not enabled", None
        return -22, f"unknown mgr command {pfx!r}", None

    def mon_command(self, cmd: dict,
                    timeout: float = 30.0) -> tuple[int, str, object]:
        """Synchronous round-trip (the progress module's command
        channel)."""
        tid = next(self._tid)
        ev, slot = threading.Event(), {}
        with self._lock:
            self._sync_cmds[tid] = (ev, slot)
        self.ms.connect(self.mon).send_message(
            MMonCommand(tid=tid, cmd=cmd))
        if not ev.wait(timeout):
            with self._lock:
                self._sync_cmds.pop(tid, None)
            raise TimeoutError(f"mon command {cmd.get('prefix')!r}")
        return slot["r"], slot["outs"], slot["outb"]

    def start_pg_autoscaler(self, **kw):
        from .pg_autoscaler import PGAutoscaler
        self.pg_autoscaler = PGAutoscaler(self, **kw)
        return self.pg_autoscaler

    def autoscale_tick(self, pool_bytes: dict | None = None) -> int:
        """One pg_autoscaler round (scheduled alongside the balancer
        tick the way the reference's module serve loops both run)."""
        if self.pg_autoscaler is None:
            return 0
        with self._lock:
            return self.pg_autoscaler.tick(pool_bytes)

    def start_progress(self):
        """Track long-running operations (ref: pybind/mgr/progress)."""
        from .progress import ProgressModule
        self.progress = ProgressModule(self)
        return self.progress

    def progress_tick(self) -> int:
        if self.progress is None:
            return 0
        return self.progress.tick()

    def start_crash(self, **kw):
        """Crash-report health agent (ref: pybind/mgr/crash)."""
        from .crash import CrashModule
        self.crash = CrashModule(self, **kw)
        return self.crash

    def set_health_checks(self, module: str, checks: dict) -> None:
        """Replace one module's health-check slice and push the MERGED
        report to the mon (ref: MgrModule.set_health_checks — each
        module owns its slice; the wholesale `mgr health report` wire
        contract stays intact)."""
        with self._lock:
            if checks:
                self._health_reports[module] = dict(checks)
            else:
                self._health_reports.pop(module, None)
            merged: dict = {}
            for part in self._health_reports.values():
                merged.update(part)
        self.mon_command({"prefix": "mgr health report",
                          "checks": merged})

    def observability_tick(self, now: float | None = None) -> None:
        """One observability round: refresh the volatile mgr
        registration on every mon, tick crash (RECENT_CRASH health),
        then push the liveness slice (the reference also ticks its
        insights and telemetry modules here)."""
        self.hbmap.reset_timeout(self._hb_handle)
        self._register_mgr()
        if self.crash is not None:
            self.crash.tick(now)
        # liveness slice: unhealthy workers ride the same volatile
        # module-health report every other mgr module uses (cleared
        # the moment the worker beats again)
        self.set_health_checks("hbmap", self.hbmap.health_check())

    # ------------------------------------------------------- balancing
    def tick(self) -> int:
        """One balancer round: optimize the current map and submit the
        upmap commands (ref: balancer module.py execute :1450 —
        pg-upmap-items mon commands per plan item).  Returns the number
        of commands submitted."""
        with self._lock:
            if not self.active or self.osdmap.epoch == 0 or \
                    not self.osdmap.pools:
                return 0
            inc = self.balancer.optimize(self.osdmap)
            rm = [str(pg) for pg in sorted(inc.old_pg_upmap_items)]
            set_ = [(str(pg), items) for pg, items in
                    sorted(inc.new_pg_upmap_items.items())]
            sent = len(rm) + len(set_)
            if sent:
                # one batched command = one map epoch for the whole
                # plan (an epoch per item would fan N incrementals to
                # every subscriber)
                self._command({"prefix": "osd upmap-batch",
                               "rm": rm, "set": set_})
            self.last_optimize = {
                "epoch": self.osdmap.epoch,
                "commands": sent,
            }
            if sent:
                dout("mgr", 1).write("%s: submitted %d upmap changes "
                                     "at e%d", self.name, sent,
                                     self.osdmap.epoch)
            return sent

    def _command(self, cmd: dict) -> None:
        tid = next(self._tid)
        self._pending.add(tid)
        self.ms.connect(self.mon).send_message(
            MMonCommand(tid=tid, cmd=cmd))

    def status(self) -> dict:
        """(ref: `ceph balancer status`)."""
        with self._lock:
            score = self.balancer.score(self.osdmap) \
                if self.osdmap.pools else {}
            return {"active": self.active,
                    "mode": "upmap",
                    "epoch": self.osdmap.epoch,
                    "last_optimize": dict(self.last_optimize),
                    "hbmap_unhealthy":
                        self.hbmap.get_unhealthy_workers(),
                    "score": {k: score.get(k)
                              for k in ("stddev", "max_deviation")}}
