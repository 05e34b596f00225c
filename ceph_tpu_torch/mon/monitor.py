"""Monitor daemon: the map service endpoint on the messenger.

Command, subscription, boot, and failure-report handling over the wire
(ref: src/mon/Monitor.cc dispatch_op; OSDMonitor.cc preprocess/
prepare split; failure handling OSDMonitor.cc:2519 prepare_failure,
down-out: OSDMonitor.cc tick :4965).  Maps propagate to subscribers as
MMap incrementals on every committed epoch (src/mon/Monitor.cc
handle_subscribe).  Mutations are serialized through a change queue:
one staged prepare -> one proposal -> commit -> ack, matching the
reference's paxos plug.

The port's copy of `ceph_tpu.mon.monitor` in part: one rank, which is
its own quorum and leader.  It keeps `build_initial`, command dispatch
to the OSD monitor (and the mon-level `status`, `health`, `df`,
`pg stat`, `pg dump` and `osd perf dump` reads from the PG map), map
publication, boot and failure reports, pg_temp requests, pg-stat
reports and the tick's down-out.  Left out: the elector, leases and
the peon paths of a multi-mon quorum; the ConfigMonitor, LogMonitor,
MDSMonitor and CrashService (so `config` subscriptions get no MConfig
and cluster-log events go to the local log only); mgr command
proxying and the synchronous `handle_command`.  With a `keyring` it
runs the cephx key server and verifies inbound traffic;
`start_admin_socket` serves status, health, df, pg_stat,
quorum_status, perf dump, config show and the op tracker's dumps.
The port adds a perf counter set (`perf`) holding `tick_errors`, the
tick errors a daemon process's loop survived (tools/daemon_main.py).
A mon started on a store that holds committed state (a `MonitorStore`
over `kv.LogDB`) resumes from it, as the reference's does.  One rule
differs there: the subscriptions died with the old process, so the
resumed mon subscribes an entity it hears from without one (an OSD's
pg-stat report, a client's command) and sends it the maps it lacks;
the reference's single mon never hears from them again.
"""
from __future__ import annotations

import time
from collections import deque

from ..common.heartbeat_map import HeartbeatMap
from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.options import global_config
from ..common.racecheck import shared_state
from ..common.tracked_op import OpTracker
from ..crush.wrapper import CrushWrapper
from ..common.perf_counters import PerfCounters
from ..msg.messages import (MAuthRequest, MMap, MMonCommand,
                            MMonCommandAck,
                            MMonSubscribe, MOSDBoot, MOSDFailure,
                            MOSDPGTemp, MPGStats)
from ..msg.messenger import Dispatcher, LocalNetwork, Message, Messenger
from ..osd.osdmap import (CEPH_OSD_AUTOOUT, CEPH_OSD_EXISTS, CEPH_OSD_IN,
                          CEPH_OSD_UP, OSDMap)
from .osd_monitor import OSDMonitor
from .paxos import Paxos
from .pg_map import OSDStatReport, PGMap, health_checks, health_status
from .store import MonitorStore


def build_initial(n_osd: int, osds_per_host: int = 1
                  ) -> tuple[OSDMap, CrushWrapper]:
    """Named crush tree (default/host*/osd.*) + replicated_rule + all
    OSDs up/in — the vstart-style bootstrap a fresh mon starts from
    (ref: OSDMap.cc build_simple with names via CrushWrapper)."""
    w = CrushWrapper.build_flat(n_osd, osds_per_host=osds_per_host)
    w.add_simple_rule("replicated_rule", "default", "host")
    m = OSDMap()
    m.set_max_osd(n_osd)
    for osd in range(n_osd):
        m.osd_state[osd] = CEPH_OSD_EXISTS | CEPH_OSD_UP
        m.osd_weight[osd] = CEPH_OSD_IN
    m.crush = w.crush
    m.epoch = 1
    return m, w


# the down-out table is shared between the dispatch thread (failure
# reports) and the tick thread (auto-out) — racecheck asserts both
# sides hold self._lock
@shared_state(only=("_down_stamp",), mutating=("_down_stamp",))
class Monitor(Dispatcher):
    """mon.<rank> (ref: src/mon/Monitor.h:201)."""

    def __init__(self, network: LocalNetwork, rank: int = 0,
                 initial_map: OSDMap | None = None,
                 initial_wrapper=None, store: MonitorStore | None = None,
                 threaded: bool = True, clock=time.monotonic,
                 device=None, keyring=None):
        self.name = f"mon.{rank}"
        self.rank = rank
        #: injectable clock so harnesses can run the failure/auto-out
        #: machinery on simulated time consistently with OSD ticks
        self.clock = clock
        self.store = store or MonitorStore()
        #: started on a store that holds committed state: it resumes
        #: from it and adopts the subscribers it lost
        self._resumed = not self.store.empty
        self.paxos = Paxos(self.store)
        self.osdmon = OSDMonitor(self.paxos, initial_map, initial_wrapper,
                                 device=device)
        self.ms = Messenger.create(network, self.name, threaded=threaded)
        self.ms.add_dispatcher(self)
        # cephx: the mon runs the key server and gates inbound traffic
        # (ref: AuthMonitor + ms_verify_authorizer)
        self.cephx = None
        if keyring is not None:
            from ..auth import CephxServer, attach_cephx
            self.cephx = CephxServer(keyring)
            attach_cephx(self.ms, self.name, keyring)
        self.asok = None
        self.perf = PerfCounters(self.name)
        self.perf.add_u64_counter("tick_errors")
        # osdmap subscribers: entity -> next epoch they need
        self._subs: dict[str, int] = {}
        # failure reports: target osd -> {reporter: stamp}
        self._failure_reports: dict[int, dict[int, float]] = {}
        # cluster statistics digest (ref: src/mon/PGMap.h)
        self.pgmap = PGMap()
        self._down_stamp: dict[int, float] = {}
        # op tracking: an aged command feeds SLOW_OPS (ref: Monitor.cc's
        # op_tracker member)
        self.op_tracker = OpTracker(
            history_size=global_config()["osd_op_history_size"])
        # internal thread-liveness watchdog (ref: the ceph-mon's
        # HeartbeatMap wired through Monitor::tick): the tick worker
        # arms on its FIRST tick (a constructed-but-never-ticked mon
        # in a harness is not unhealthy)
        self.hbmap = HeartbeatMap()
        self._hb_handle = self.hbmap.add_worker(
            f"{self.name}.tick", grace=60.0, arm=False)
        self._lock = make_lock(f"mon.{rank}")
        # one rank: its own quorum and leader
        self.mon_ranks = [rank]
        self.is_leader = True
        self.leader_rank = rank
        self.paxos.rank = rank
        # serialized map mutations: (stage_fn, reply_cb, svc)
        self._chg_queue: deque = deque()
        self._chg_busy = False
        self._pumping = False

    # ------------------------------------------------------------ setup
    def init(self) -> None:
        self.osdmon.init()
        self.ms.start()

    def shutdown(self) -> None:
        if self.asok is not None:
            self.asok.shutdown()
        self.ms.shutdown()

    def start_admin_socket(self, path: str) -> None:
        """`ceph daemon mon.N <cmd>` endpoint
        (ref: Monitor::do_admin_command)."""
        from ..common.admin_socket import AdminSocket, register_obs_commands
        a = AdminSocket(path)

        def _via_preprocess(prefix):
            def fn(c):
                with self._lock:
                    r, outs, outb = self._preprocess_mon_command(
                        {**c, "prefix": prefix})
                return r, outb if outb is not None else outs
            return fn
        for p in ("status", "health", "df", "pg stat"):
            a.register(p.replace(" ", "_") if p == "pg stat" else p,
                       f"mon {p}", _via_preprocess(p))
        a.register("quorum_status", "mon quorum_status",
                   lambda c: (0, {"quorum": self.quorum(),
                                  "leader": self.leader_rank}))
        a.register("perf dump", "dump perf counters",
                   lambda c: (0, self.perf.dump()))
        a.register("config show", "live config",
                   lambda c: (0, global_config().dump()))
        register_obs_commands(a, self.op_tracker)
        a.start()
        self.asok = a

    @property
    def osdmap(self) -> OSDMap:
        return self.osdmon.osdmap

    # -------------------------------------------------------- dispatch
    def ms_dispatch(self, msg: Message) -> bool:
        with self._lock:
            if isinstance(msg, MAuthRequest):
                if self.cephx is not None:
                    self.ms.connect(msg.src).send_message(
                        self.cephx.handle_request(msg))
                return True
            if isinstance(msg, MMonCommand):
                self._adopt_subscriber(msg.src, None)
                self._handle_wire_command(msg.cmd, msg.src, msg.tid)
                return True
            if isinstance(msg, MMonSubscribe):
                self._handle_subscribe(msg)
                return True
            if isinstance(msg, MOSDBoot):
                self._handle_boot(msg)
                return True
            if isinstance(msg, MOSDFailure):
                self._handle_failure(msg)
                return True
            if isinstance(msg, MOSDPGTemp):
                self._handle_pg_temp(msg)
                return True
            if isinstance(msg, MPGStats):
                self._adopt_subscriber(msg.src, msg.epoch)
                self.pgmap.ingest(OSDStatReport(
                    osd=msg.osd, epoch=msg.epoch, stamp=msg.stamp,
                    pg_stats=msg.pg_stats, kb_total=msg.kb_total,
                    kb_used=msg.kb_used, kb_avail=msg.kb_avail,
                    perf=msg.perf, slow_ops=dict(msg.slow_ops or {})))
                return True
        return False

    # -------------------------------------------------------- commands
    def _handle_wire_command(self, cmdmap: dict, client: str,
                             tid: int) -> None:
        # track the command like the OSD tracks client ops: a command
        # stuck behind a wedged paxos round ages into the SLOW_OPS feed
        self.op_tracker.start(
            (client, tid),
            f"mon_command({client} tid={tid} "
            f"{cmdmap.get('prefix', '?')})")

        def reply(r, outs, outb):
            self.op_tracker.finish((client, tid),
                                   "replied" if r == 0 else f"r={r}")
            self.ms.connect(client).send_message(MMonCommandAck(
                tid=tid, result=r, outs=outs, outb=outb))

        self._dispatch_command(cmdmap, reply)

    def _dispatch_command(self, cmdmap: dict, reply_cb) -> None:
        """preprocess locally; stage writes through the change queue
        (ref: Monitor::dispatch_op -> the OSD monitor's preprocess /
        prepare split)."""
        res = self._preprocess_mon_command(cmdmap)
        if res is not None:
            reply_cb(*res)
            return
        svc = self.osdmon
        try:
            res = svc.preprocess_command(cmdmap)
        except (KeyError, ValueError, TypeError) as ex:
            reply_cb(-22, f"invalid command arguments: {ex}", None)
            return
        if res is not None:
            reply_cb(*res)
            return
        self._submit_change(
            lambda: svc.prepare_command(cmdmap), reply_cb, svc)

    # ------------------------------------------- cluster-level commands
    # (ref: Monitor::handle_command's mon-level table — `ceph -s`
    #  Monitor.cc get_cluster_status, health get_health, df from PGMap)
    def quorum(self) -> list[int]:
        return [self.rank]

    def _preprocess_mon_command(self, cmdmap: dict):
        prefix = cmdmap.get("prefix", "")
        if prefix == "osd perf dump":
            # per-daemon counters as last reported (ref: DaemonState
            # perf_counters aggregation in src/mgr/)
            return 0, "", {f"osd.{o}": r.perf
                           for o, r in sorted(
                               self.pgmap.osd_reports.items())
                           if r.perf}
        if prefix not in ("status", "health", "health detail", "df",
                          "pg stat", "pg dump"):
            return None
        now = self.clock()
        up = {o for o in range(self.osdmap.max_osd)
              if self.osdmap.is_up(o)}
        pgs = self.pgmap.primary_pgs(up)    # one digest per command
        slow = {}
        own = self.op_tracker.slow_summary()
        if own["count"]:
            slow[self.name] = own
        checks = health_checks(
            self.osdmap, self.pgmap, self.quorum(), self.mon_ranks,
            now, stale_after=global_config()
            ["mon_osd_stale_report_grace"], pgs=pgs, slow_ops=slow)
        # own thread-liveness watchdog (ref: "heartbeat_map is_healthy
        # ... had timed out")
        checks.update(self.hbmap.health_check())
        if prefix in ("health", "health detail"):
            out = {"status": health_status(checks),
                   "checks": {k: {"severity": v["severity"],
                                  "summary": v["summary"]}
                              for k, v in checks.items()}}
            if prefix == "health detail":
                for k, v in checks.items():
                    out["checks"][k]["detail"] = v["detail"]
            return 0, out["status"], out
        if prefix == "pg stat":
            t = self.pgmap.totals(pgs)
            states = self.pgmap.pg_states(pgs)
            return 0, (f"{t['num_pgs']} pgs: "
                       + ", ".join(f"{n} {s}" for s, n in
                                   sorted(states.items()))
                       + f"; {t['num_objects']} objects"), \
                {"states": states, **t}
        if prefix == "pg dump":
            return 0, "", pgs
        if prefix == "df":
            d = self.pgmap.df(pgs, up)
            d["pools"] = {
                self.osdmap.pool_names.get(pid, str(pid)): st
                for pid, st in d["pools"].items()}
            return 0, "", d
        # status == `ceph -s`
        n_in = sum(1 for o in range(self.osdmap.max_osd)
                   if self.osdmap.exists(o) and self.osdmap.is_in(o))
        exists = sum(1 for o in range(self.osdmap.max_osd)
                     if self.osdmap.exists(o))
        t = self.pgmap.totals(pgs)
        return 0, "", {
            "health": {"status": health_status(checks),
                       "checks": {k: v["summary"]
                                  for k, v in checks.items()}},
            "monmap": {"mons": list(self.mon_ranks),
                       "quorum": self.quorum(),
                       "leader": self.leader_rank},
            "osdmap": {"epoch": self.osdmap.epoch, "num_osds": exists,
                       "num_up_osds": len(up), "num_in_osds": n_in},
            "pgmap": {"num_pgs": t["num_pgs"],
                      "pgs_by_state": self.pgmap.pg_states(pgs),
                      "num_objects": t["num_objects"],
                      "bytes_data": t["bytes"],
                      **{k: v for k, v in
                         self.pgmap.df(pgs, up).items()
                         if k != "pools"}},
        }

    # ---------------------------------------------- serialized changes
    def _submit_change(self, stage, reply_cb=None, svc=None) -> None:
        """stage() runs prepare handlers against the service's pending
        state and returns (r, outs, outb) or None; the proposal commits
        before the next change stages (the reference's paxos plug)."""
        self._chg_queue.append((stage, reply_cb, svc or self.osdmon))
        self._pump_changes()

    def _pump_changes(self) -> None:
        # Re-entrancy guard: a stage() callback may itself submit a
        # change.  The nested call must only ENQUEUE — running it
        # inline would pop and propose a second change while the outer
        # frame's proposal is still being staged, breaking the
        # one-proposal-at-a-time plug.  The outer drain loop picks
        # nested submissions up in order.
        if self._pumping:
            return
        self._pumping = True
        try:
            while not self._chg_busy and self._chg_queue:
                stage, reply_cb, svc = self._chg_queue.popleft()
                try:
                    res = stage()
                except (KeyError, ValueError, TypeError) as ex:
                    svc.create_pending()
                    if reply_cb is not None:
                        reply_cb(-22,
                                 f"invalid command arguments: {ex}",
                                 None)
                    continue
                r, outs, outb = res if res is not None \
                    else (0, "", None)
                if r != 0 or svc._is_pending_empty():
                    svc.create_pending()
                    if reply_cb is not None:
                        reply_cb(r, outs, outb)
                    continue
                self._chg_busy = True

                def committed(reply_cb=reply_cb, r=r, outs=outs,
                              outb=outb):
                    self._chg_busy = False
                    self._publish()
                    if reply_cb is not None:
                        reply_cb(r, outs, outb)

                svc.propose_pending(on_done=committed)
        finally:
            self._pumping = False

    # ---------------------------------------------------- subscriptions
    def _handle_subscribe(self, msg: MMonSubscribe) -> None:
        if msg.what != "osdmap":
            return      # config/fsmap services are not ported
        self._subs[msg.src] = msg.start or 1
        self._send_maps(msg.src)

    def _adopt_subscriber(self, entity: str, epoch: int | None) -> None:
        """A mon started again on its store lost its subscriptions with
        its process: an entity it hears from without one (an OSD's
        pg-stat report, a client's command) gets the maps past its
        `epoch` (the current full map when the message carries none)
        and stays subscribed.  A mon that bootstrapped does nothing
        here."""
        if self._resumed and entity not in self._subs:
            self._subs[entity] = 1 if epoch is None else epoch + 1
            self._send_maps(entity)

    def _send_maps(self, entity: str) -> None:
        """Send everything from the subscriber's next epoch to current
        (ref: OSDMonitor.cc send_incremental)."""
        start = self._subs.get(entity, 1)
        cur = self.osdmap.epoch
        if start > cur:
            return
        first = self.osdmon.get_first_committed() or 1
        incs = []
        if start > first:
            for e in range(start, cur + 1):
                inc = self.osdmon.get_incremental(e)
                if inc is None:
                    incs = None
                    break
                incs.append(inc)
        else:
            incs = None
        if incs is not None and start > 1:
            m = MMap(incrementals=incs, first=start, last=cur)
        else:
            m = MMap(full_map=self.osdmon.get_full_map(cur),
                     first=cur, last=cur)
        self.ms.connect(entity).send_message(m)
        self._subs[entity] = cur + 1

    def _publish(self) -> None:
        """Push new epochs to all subscribers (post-commit)."""
        for entity in list(self._subs):
            self._send_maps(entity)

    # ------------------------------------------------------------- boot
    def _handle_boot(self, msg: MOSDBoot) -> None:
        """(ref: OSDMonitor.cc:3270 prepare_boot — mark up; a brand-new
        osd also gets EXISTS and full in-weight)."""
        osd = msg.osd
        if osd < 0:
            return
        self._failure_reports.pop(osd, None)
        self._down_stamp.pop(osd, None)

        def stage():
            m = self.osdmap
            if osd < m.max_osd and m.is_up(osd):
                return (1, "", None)      # nothing to do, no proposal
            inc = self.osdmon.pending_inc
            if osd >= m.max_osd:
                inc.new_max_osd = osd + 1
            inc.new_up_osds.append(osd)
            if osd >= m.max_osd or not m.exists(osd):
                inc.new_weight[osd] = CEPH_OSD_IN
            elif m.osd_state[osd] & CEPH_OSD_AUTOOUT and m.is_out(osd):
                # an auto-out osd comes back in on boot
                # (ref: mon_osd_auto_mark_auto_out_in)
                inc.new_weight[osd] = CEPH_OSD_IN
                inc.new_state[osd] = \
                    inc.new_state.get(osd, 0) | CEPH_OSD_AUTOOUT
            dout("mon", 1).write("%s: osd.%d boot", self.name, osd)
            return (0, "", None)

        self._submit_change(stage)

    # ---------------------------------------------------------- failure
    def _handle_failure(self, msg: MOSDFailure) -> None:
        """Quorum-of-reporters mark-down
        (ref: OSDMonitor.cc:2519 prepare_failure / check_failure:
        reporters must be distinct live peers, reports expire after the
        grace window)."""
        target = msg.target_osd
        reporter = msg.reporter
        m = self.osdmap
        if not (0 <= target < m.max_osd) or m.is_down(target):
            return
        if reporter == target or not (0 <= reporter < m.max_osd) or \
                m.is_down(reporter):
            return
        now = self.clock()
        grace = global_config()["osd_heartbeat_grace"]
        reports = self._failure_reports.setdefault(target, {})
        reports[reporter] = now
        for r, stamp in list(reports.items()):
            if now - stamp > grace:
                del reports[r]
        need = global_config()["mon_osd_min_down_reporters"]
        if len(reports) >= need:
            self._mark_down(target)

    def _handle_pg_temp(self, msg: MOSDPGTemp) -> None:
        """pg_temp request from a peering primary (ref:
        OSDMonitor::prepare_pgtemp): pin the PG's acting set to the
        data holders while the up set backfills; an empty list clears
        the override when the backfill finishes."""
        def stage():
            m = self.osdmap
            pg = msg.pgid
            if pg is None or pg.pool not in m.pools or \
                    pg.ps >= m.pools[pg.pool].pg_num:
                return (1, "", None)
            want = [o for o in msg.osds
                    if 0 <= o < m.max_osd and m.is_up(o)]
            if msg.osds and not want:
                # a PIN whose members are all momentarily down must
                # not degenerate into a clear of the live override
                return (1, "", None)
            inc = self.osdmon.pending_inc
            cur = inc.new_pg_temp.get(pg, m.pg_temp.get(pg, []))
            if want == list(cur):
                return (1, "", None)       # no-op, no proposal
            if not want and pg not in m.pg_temp and \
                    pg not in inc.new_pg_temp:
                return (1, "", None)       # clearing nothing
            inc.new_pg_temp[pg] = want
            dout("mon", 4).write("%s: pg_temp %s -> %s (from osd.%d)",
                                 self.name, pg, want, msg.from_osd)
            return (0, "", None)

        self._submit_change(stage)

    def clog_event(self, level: str, text: str) -> None:
        """Mon-originated cluster-log entry (osd down/out).  The
        LogMonitor is not ported: the entry goes to the local log."""
        dout("mon", 1).write("%s: [%s] %s", self.name, level, text)

    def _mark_down(self, osd: int) -> None:
        self._failure_reports.pop(osd, None)
        self._down_stamp[osd] = self.clock()
        # a downed OSD's capacity must leave the df totals and its
        # stale primary claims must not fight the new primary's
        # (ref: PGMap purged on osd removal)
        self.pgmap.forget(osd)

        def stage():
            if self.osdmap.is_down(osd):
                return (1, "", None)
            self.osdmon.pending_inc.new_down_osds.append(osd)
            dout("mon", 1).write("%s: marking osd.%d down", self.name,
                                 osd)
            self.clog_event("warn", f"osd.{osd} marked down after "
                            "failure reports from its peers")
            return (0, "", None)

        self._submit_change(stage)

    # -------------------------------------------------------------- tick
    def tick(self, now: float | None = None) -> None:
        """Periodic: auto-out OSDs down past the interval
        (ref: OSDMonitor.cc:4965 tick)."""
        self.hbmap.reset_timeout(self._hb_handle)
        with self._lock:
            now = self.clock() if now is None else now
            interval = global_config()["mon_osd_down_out_interval"]
            to_out = []
            for osd, stamp in list(self._down_stamp.items()):
                m = self.osdmap
                if m.is_up(osd):
                    del self._down_stamp[osd]
                    continue
                if interval and now - stamp >= interval and m.is_in(osd):
                    to_out.append(osd)
            if not to_out:
                return

            def stage():
                changed = False
                for osd in to_out:
                    m = self.osdmap
                    if m.is_up(osd) or m.is_out(osd):
                        continue
                    self.osdmon.pending_inc.new_weight[osd] = 0
                    self.osdmon.pending_inc.new_state[osd] = \
                        self.osdmon.pending_inc.new_state.get(osd, 0) \
                        | CEPH_OSD_AUTOOUT
                    changed = True
                    dout("mon", 1).write("%s: auto-out osd.%d",
                                         self.name, osd)
                    self.clog_event(
                        "warn", f"osd.{osd} auto-marked out after "
                        "staying down past the interval")
                return (0, "", None) if changed else (1, "", None)

            self._submit_change(stage)
