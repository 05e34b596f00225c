"""Monitor daemon: the map service endpoint on the messenger.

Command, subscription, boot, and failure-report handling over the wire
(ref: src/mon/Monitor.cc dispatch_op; OSDMonitor.cc preprocess/
prepare split; failure handling OSDMonitor.cc:2519 prepare_failure,
down-out: OSDMonitor.cc tick :4965).  Maps propagate to subscribers as
MMap incrementals on every committed epoch (src/mon/Monitor.cc
handle_subscribe).

Quorum (multi-mon): leadership comes from the rank-based Elector
(mon/elector.py); the leader drives every map mutation through the
replicated Paxos pipeline (majority accept before commit, mon/paxos.py)
and peons forward write traffic to it (ref: src/mon/Monitor.cc
forward_request_leader, MForward).  Reads (preprocess commands,
subscriptions) are served by any mon from its committed store.  Leases
keep peons convinced the leader lives; a stale lease (or a reset from
the leader's endpoint) triggers re-election, and lagging mons catch up
by replaying committed paxos values (MPaxosSyncReq).  Mutations are
serialized through a change queue: one staged prepare -> one proposal
-> commit -> ack, matching the reference's paxos plug.

The port's copy of `ceph_tpu.mon.monitor` in part.  It keeps
`build_initial`, command dispatch to the OSD monitor and the crash
table (CrashService, the mon's own-crash capture and spool drain), the
mon-level `status`, `health` (with `MON_DOWN`), `df`, `pg stat`, `pg
dump`, `quorum_status`, `mon stat` and `osd perf dump` reads, map
publication, boot and failure reports, pg_temp requests, pg-stat
reports, the tick's down-out, and the whole multi-mon quorum
(`mon_ranks=`): the Elector with its persisted epoch, leases and lease
acks, the collect phase of a fresh leader, peon relays and
`MMonForward`, the store sync (`MPaxosSyncReq`, `MonitorStore.
import_data`) and the re-election on a stale lease or a reset from the
leader, the ConfigMonitor (`config set|rm|get|dump`, `config`
subscriptions answered with MConfig and pushed again on every commit)
and the LogMonitor (daemons' MLog batches committed through paxos and
acked with MLogAck, the mon's own cluster-log lines, `log`, `log last`
and `log counts`), and the MDSMonitor (MMDSBeacon dispatch and the
fsmap committed through paxos, `fs status`, `mds stat`, `fs dump` and
`mds fail`, beacon-lapse detection and standby promotion in the tick,
`fsmap` subscriptions pushed on every commit, and the MDS half of the
SLOW_OPS feed off the beacons).  The mon's side of the
mgr is here: `mgr register` names the active mgr, module commands
(telemetry, insights) are proxied to it as `MMgrCommand` and its reply
relayed (EAGAIN when none is registered or its connection resets),
and `mgr health report` merges the mgr's module health into `health`
until `mon_mgr_health_grace` passes.  `handle_command` is the
synchronous command path.  With a `keyring` it
runs the cephx key server and verifies inbound traffic;
`start_admin_socket` serves status, health, df, pg_stat,
quorum_status, perf dump, config show, the op tracker's dumps and
`dump_traces`.
The port adds a perf counter set (`perf`) holding `tick_errors`, the
tick errors a daemon process's loop survived (tools/daemon_main.py).
A mon started on a store that holds committed state (a `MonitorStore`
over `kv.LogDB`) resumes from it, as the reference's does.  One rule
differs there, for a single mon only: the subscriptions died with the
old process, so the resumed standalone mon subscribes an entity it
hears from without one (an OSD's pg-stat report, a client's command)
and sends it the maps it lacks, and an OSD its centralized config; the
reference's single mon never hears from them again.  In a quorum the
reference's own remedy holds: the daemons' MonHunter hunts to another
mon and re-greets, and a revived mon catches up through the leader's
leases and the store sync.
"""
from __future__ import annotations

import itertools
import time
from collections import deque

from ..common.heartbeat_map import HeartbeatMap
from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.options import global_config
from ..common.racecheck import shared_state
from ..common.tracing import Tracer
from ..common.tracked_op import OpTracker
from ..crush.wrapper import CrushWrapper
from ..common.perf_counters import PerfCounters
from ..msg.messages import (MGR_UNAVAILABLE_EAGAIN, MAuthRequest,
                            MConfig, MFSMap, MLog, MLogAck, MMap,
                            MMDSBeacon,
                            MMgrCommand, MMgrCommandReply, MMonCommand,
                            MMonCommandAck, MMonElection, MMonForward,
                            MMonLease, MMonLeaseAck, MMonSubscribe,
                            MOSDBoot, MOSDFailure, MOSDPGTemp,
                            MPaxosAccept, MPaxosBegin, MPaxosCommit,
                            MPaxosStoreSync, MPaxosSyncReq, MPGStats)
from ..msg.messenger import Dispatcher, LocalNetwork, Message, Messenger
from ..osd.osdmap import (CEPH_OSD_AUTOOUT, CEPH_OSD_EXISTS, CEPH_OSD_IN,
                          CEPH_OSD_UP, OSDMap)
from .config_monitor import ConfigMonitor
from .crash_service import CrashService
from .elector import Elector
from .mds_monitor import MDSMonitor
from .log_monitor import LogMonitor
from .osd_monitor import OSDMonitor
from .paxos import Paxos
from .pg_map import OSDStatReport, PGMap, health_checks, health_status
from .store import MonitorStore, StoreTransaction

LEASE_INTERVAL = 5.0          # leader lease period (mon_lease)
LEASE_TIMEOUT = 15.0          # peon re-elects after silence (mon_lease_ack)
# stale-lease re-election pacing: a mon that keeps losing its lease
# (partitioned away, or its victories never arrive back) must not
# force a quorum-wide election every tick — capped exponential,
# reset the moment it rejoins a reign (win, lose, or a fresh lease)
ELECTION_BACKOFF_BASE_S = 1.0
ELECTION_BACKOFF_CAP_S = 60.0


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


# health tables shared between the dispatch thread (beacons, mgr
# health reports, failure reports) and the tick thread (auto-out) —
# racecheck asserts both sides hold self._lock
@shared_state(only=("_down_stamp", "_module_health", "_mds_slow"),
              mutating=("_down_stamp", "_module_health", "_mds_slow"))
class Monitor(Dispatcher):
    """mon.<rank> (ref: src/mon/Monitor.h:201)."""

    def __init__(self, network: LocalNetwork, rank: int = 0,
                 initial_map: OSDMap | None = None,
                 initial_wrapper=None, store: MonitorStore | None = None,
                 threaded: bool = True, clock=time.monotonic,
                 mon_ranks: list[int] | None = None, device=None,
                 keyring=None, crash_dir: str | None = None):
        self.name = f"mon.{rank}"
        self.rank = rank
        #: injectable clock so harnesses can run the failure/auto-out
        #: machinery on simulated time consistently with OSD ticks
        self.clock = clock
        self.store = store or MonitorStore()
        self.mon_ranks = sorted(mon_ranks) if mon_ranks else [rank]
        self.standalone = len(self.mon_ranks) == 1
        #: a standalone mon started on a store that holds committed
        #: state: it resumes from it and adopts the subscribers it lost
        self._resumed = self.standalone and not self.store.empty
        self.paxos = Paxos(self.store)
        self.osdmon = OSDMonitor(self.paxos, initial_map, initial_wrapper,
                                 device=device)
        self.configmon = ConfigMonitor(self.paxos)
        self.logmon = LogMonitor(self.paxos)
        self.crashmon = CrashService(self.paxos)
        self.mdsmon = MDSMonitor(self.paxos)
        self.ms = Messenger.create(network, self.name, threaded=threaded)
        # own-crash capture: a mon IS the crash sink, so its reports
        # stage straight into the local crash table (spool covers the
        # window where paxos can't commit yet)
        from ..common.crash import CrashReporter
        self.crash_reporter = CrashReporter(
            self.name, crash_dir=crash_dir, post=self._post_own_crash)
        self.ms.crash_hook = self.crash_reporter.capture
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
        # config subscribers: entity -> last version sent
        self._config_subs: dict[str, int] = {}
        # fsmap subscribers: entity -> last epoch sent
        self._fsmap_subs: dict[str, int] = {}
        #: per-MDS slow-op summaries off beacons: name -> {stamp,
        #: count, oldest_age} (volatile; cleared when a beacon reports
        #: count 0)
        self._mds_slow: dict[str, dict] = {}
        # failure reports: target osd -> {reporter: stamp}
        self._failure_reports: dict[int, dict[int, float]] = {}
        # active mgr (volatile, re-registered every mgr tick): the
        # routing target for mgr-module commands (ref: MgrMonitor's
        # active mgr tracking)
        self._active_mgr: str | None = None
        # in-flight mgr-proxied commands: tid -> client reply callback
        self._mgr_proxy: dict[int, object] = {}
        self._proxy_tids = itertools.count(1)
        # volatile mgr-module health + its report stamp (expired after
        # mon_mgr_health_grace so a dead mgr's warnings don't persist)
        self._module_health: dict[str, dict] = {}
        self._module_health_stamp: float | None = None
        # cluster statistics digest (ref: src/mon/PGMap.h)
        self.pgmap = PGMap()
        self._down_stamp: dict[int, float] = {}
        # op tracking + span ring: an aged command feeds SLOW_OPS, and
        # the mon serves the same dump_ops_in_flight/dump_traces surface
        # as every other daemon (ref: Monitor.cc's op_tracker member)
        self.op_tracker = OpTracker(
            history_size=global_config()["osd_op_history_size"])
        self.tracer = Tracer(self.name)
        # internal thread-liveness watchdog (ref: the ceph-mon's
        # HeartbeatMap wired through Monitor::tick): the tick worker
        # arms on its FIRST tick (a constructed-but-never-ticked mon
        # in a harness is not unhealthy)
        self.hbmap = HeartbeatMap()
        self._hb_handle = self.hbmap.add_worker(
            f"{self.name}.tick", grace=60.0, arm=False)
        self._lock = make_lock(f"mon.{rank}")
        # ---- quorum state ------------------------------------------
        self.is_leader = self.standalone
        self.leader_rank: int | None = rank if self.standalone else None
        self.elector = Elector(rank, self.mon_ranks,
                               send=self._send_rank,
                               on_win=self._on_win,
                               on_lose=self._on_lose)
        self.elector.epoch = self.store.get_int("elector", "epoch", 0)
        self.paxos.rank = rank
        self.paxos.on_peon_commit = self._on_peon_commit
        self._lease_stamp = self.clock()
        self._last_lease_sent = 0.0
        # stale-lease re-election pacing (a partitioned mon re-proposing
        # every tick would drag the surviving quorum through an
        # election each time)
        from ..common.backoff import Backoff
        self._elect_backoff = Backoff(
            base_s=ELECTION_BACKOFF_BASE_S,
            cap_s=ELECTION_BACKOFF_CAP_S, jitter=False,
            clock=self.clock)
        # serialized map mutations: (stage_fn, reply_cb, svc)
        self._chg_queue: deque = deque()
        self._chg_busy = False
        self._chg_inflight_reply = None
        self._pumping = False
        # freshly-won leaders freeze proposals until enough lease acks
        # confirm no peon holds history we lack (collect-phase analogue)
        self._catchup_pending: set[int] = set()

    # ------------------------------------------------------------ setup
    def init(self) -> None:
        self.osdmon.init()
        self.configmon.init()
        self.logmon.init()
        self.crashmon.init()
        self.mdsmon.init()
        self.ms.start()
        if not self.standalone:
            # quorum members drain once the election settles (_on_win/
            # _on_lose) — committing or forwarding here would EAGAIN
            self.elector.start()
            self._persist_elector()
        else:
            self._drain_crash_spool()

    def _drain_crash_spool(self) -> None:
        """Re-post every spooled own-crash report (next boot, or a
        fresh quorum).  A spool file is deleted only when the commit
        or the leader's ack lands; the table dedups by crash_id, so
        re-draining after a failed round is safe."""
        if not self.crash_reporter.crash_dir:
            return
        for meta in self.crash_reporter.spooled():
            self._post_own_crash(meta)

    def _post_own_crash(self, meta: dict) -> None:
        """Ship one of OUR crash reports to the crash table: the
        leader (or a standalone mon) commits it locally; a peon
        forwards it to the leader like a client command and retires
        the spool copy on the MMonCommandAck.  Mid-election (no
        leader yet) the spool keeps the durable copy until the
        post-election drain."""
        cid = meta["crash_id"]
        with self._lock:
            if self.is_leader:
                self._submit_change(
                    lambda: self.crashmon.prepare_command(
                        {"prefix": "crash post", "meta": dict(meta)}),
                    reply_cb=lambda r, outs, outb: (
                        self.crash_reporter.mark_delivered(cid)
                        if r == 0 else None),
                    svc=self.crashmon)
            elif self.leader_rank is not None:
                tid = self.crash_reporter.alloc_tid(cid)
                self._send_rank(self.leader_rank, MMonForward(
                    tid=tid, client=self.name,
                    cmd={"prefix": "crash post", "meta": dict(meta)}))

    def shutdown(self) -> None:
        if self.asok is not None:
            self.asok.shutdown()
        self.ms.shutdown()

    def start_admin_socket(self, path: str) -> None:
        """`ceph daemon mon.N <cmd>` endpoint
        (ref: Monitor::do_admin_command)."""
        from ..common.admin_socket import AdminSocket
        from ..common.obs import register_obs_commands
        a = AdminSocket(path)

        def _via_preprocess(prefix):
            def fn(c):
                with self._lock:
                    r, outs, outb = self._preprocess_mon_command(
                        {**c, "prefix": prefix})
                return r, outb if outb is not None else outs
            return fn
        for p in ("status", "health", "df", "quorum_status",
                  "pg stat"):
            a.register(p.replace(" ", "_") if p == "pg stat" else p,
                       f"mon {p}", _via_preprocess(p))
        a.register("perf dump", "dump perf counters",
                   lambda c: (0, self.perf.dump()))
        a.register("config show", "live config",
                   lambda c: (0, global_config().dump()))
        register_obs_commands(a, self.op_tracker, self.tracer)
        a.start()
        self.asok = a

    @property
    def osdmap(self) -> OSDMap:
        return self.osdmon.osdmap

    # --------------------------------------------------------- election
    def _send_rank(self, r: int, msg: Message) -> None:
        self.ms.connect(f"mon.{r}").send_message(msg)

    def _persist_elector(self) -> None:
        tx = StoreTransaction()
        tx.put("elector", "epoch", self.elector.epoch)
        self.store.apply_transaction(tx)

    def _on_win(self, epoch: int, quorum: list[int]) -> None:
        self.is_leader = True
        self.leader_rank = self.rank
        self._elect_backoff.reset()
        self.paxos.quorum = quorum
        self.paxos.all_ranks = list(self.mon_ranks)
        self.paxos.epoch = epoch
        self.paxos.send = self._send_rank
        self.paxos.abort_inflight()
        self._fail_queued("EAGAIN")
        # collect-phase analogue: don't propose anything until lease
        # acks show whether a peon holds commits we missed (a revived
        # stale low-rank winner must not fork history at old versions)
        self._catchup_pending = {r for r in self.mon_ranks
                                 if r != self.rank}
        # fresh reign: re-stage on top of the committed state
        self.osdmon.update_from_paxos()
        self.osdmon.create_pending()
        self.configmon.update_from_paxos()
        self.configmon.create_pending()
        self.logmon.update_from_paxos()
        self.logmon.create_pending()
        self.crashmon.update_from_paxos()
        self.crashmon.create_pending()
        self.mdsmon.update_from_paxos()
        self.mdsmon.create_pending()
        self._persist_elector()
        self._broadcast_lease()
        self._publish()
        self._drain_crash_spool()

    def _on_lose(self, epoch: int, leader: int,
                 quorum: list[int]) -> None:
        self.is_leader = False
        self.leader_rank = leader
        self.paxos.quorum = quorum
        self.paxos.all_ranks = list(self.mon_ranks)
        self.paxos.epoch = epoch
        self.paxos.send = self._send_rank
        self.paxos.abort_inflight()
        self._fail_queued("EAGAIN")
        self._lease_stamp = self.clock()
        self._elect_backoff.reset()
        self._persist_elector()
        # catch up on anything we missed while electing
        self._send_rank(leader, MPaxosSyncReq(
            version=self.paxos.last_committed, rank=self.rank))
        self._drain_crash_spool()

    def _fail_queued(self, errno_name: str) -> None:
        # the in-flight proposal's client must get a fast EAGAIN too —
        # paxos.abort_inflight drops its commit callback silently
        if self._chg_inflight_reply is not None:
            cb = self._chg_inflight_reply
            self._chg_inflight_reply = None
            cb(-11, errno_name, None)
        while self._chg_queue:
            _stage, reply_cb, _svc = self._chg_queue.popleft()
            if reply_cb is not None:
                reply_cb(-11, errno_name, None)
        self._chg_busy = False

    def _broadcast_lease(self) -> None:
        self._last_lease_sent = self.clock()
        for r in self.mon_ranks:
            if r != self.rank:
                self._send_rank(r, MMonLease(
                    epoch=self.elector.epoch,
                    stamp=self._last_lease_sent,
                    last_committed=self.paxos.last_committed,
                    quorum=tuple(self.elector.quorum)))

    def _on_peon_commit(self) -> None:
        """A replicated value landed on this peon: refresh the services
        and serve our subscribers."""
        self.osdmon.update_from_paxos()
        self.configmon.update_from_paxos()
        self.logmon.update_from_paxos()
        self.crashmon.update_from_paxos()
        self.mdsmon.update_from_paxos()
        self._publish()

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
                if self._relay_if_peon(msg):
                    return True
                self._handle_boot(msg)
                return True
            if isinstance(msg, MOSDFailure):
                if self._relay_if_peon(msg):
                    return True
                self._handle_failure(msg)
                return True
            if isinstance(msg, MOSDPGTemp):
                if self._relay_if_peon(msg):
                    return True
                self._handle_pg_temp(msg)
                return True
            if isinstance(msg, MLog):
                if self._relay_if_peon(msg):
                    return True
                self._handle_log(msg)
                return True
            if isinstance(msg, MMDSBeacon):
                if self._relay_if_peon(msg):
                    return True
                self._handle_mds_beacon(msg)
                return True
            if isinstance(msg, MPGStats):
                self._adopt_subscriber(msg.src, msg.epoch)
                self.pgmap.ingest(OSDStatReport(
                    osd=msg.osd, epoch=msg.epoch, stamp=msg.stamp,
                    pg_stats=msg.pg_stats, kb_total=msg.kb_total,
                    kb_used=msg.kb_used, kb_avail=msg.kb_avail,
                    perf=msg.perf, slow_ops=dict(msg.slow_ops or {})))
                # mirror OSD-originated reports to the other mons so
                # status/health/df answer the same from any rank (the
                # reference replicates the digest via MgrStatMonitor)
                if msg.src.startswith("osd."):
                    for r in self.mon_ranks:
                        if r != self.rank:
                            self._send_rank(r, msg)
                return True
            if isinstance(msg, MMonElection):
                self.elector.handle(msg)
                self._persist_elector()
                return True
            if isinstance(msg, MPaxosBegin):
                if not self.is_leader:
                    self.paxos.handle_begin(
                        msg, int(msg.src.split(".")[1]))
                return True
            if isinstance(msg, MPaxosAccept):
                if self.is_leader:
                    self.paxos.handle_accept(msg)
                return True
            if isinstance(msg, MPaxosCommit):
                self.paxos.handle_commit(msg)
                return True
            if isinstance(msg, MPaxosSyncReq):
                if self.is_leader:
                    for m in self.paxos.sync_reply(msg.version):
                        self._send_rank(msg.rank, m)
                return True
            if isinstance(msg, MMonLease):
                self._handle_lease(msg)
                return True
            if isinstance(msg, MMonLeaseAck):
                if self.is_leader and msg.epoch == self.elector.epoch:
                    self._catchup_pending.discard(msg.rank)
                    # unfreeze on a majority (incl. self): a member
                    # that died right after the election must not
                    # freeze the reign forever
                    have = len(self.mon_ranks) - \
                        len(self._catchup_pending)
                    if have >= len(self.mon_ranks) // 2 + 1:
                        self._catchup_pending = set()
                        self._pump_changes()
                return True
            if isinstance(msg, MMgrCommandReply):
                cb = self._mgr_proxy.pop(msg.tid, None)
                if cb is not None:
                    cb(msg.result, msg.outs, msg.outb)
                return True
            if isinstance(msg, MMonCommandAck):
                # the leader acked an own-crash post we forwarded as
                # a peon: retire the spool copy (a non-zero result —
                # e.g. leadership raced away — leaves it for the next
                # post-election drain)
                self.crash_reporter.on_ack(msg.tid, msg.result)
                return True
            if isinstance(msg, MMonForward):
                if self.is_leader:
                    self._handle_wire_command(msg.cmd, msg.client,
                                              msg.tid)
                else:
                    # leadership raced away mid-forward: fast EAGAIN
                    # beats the client's 30s timeout
                    self.ms.connect(msg.client).send_message(
                        MMonCommandAck(tid=msg.tid, result=-11,
                                       outs="EAGAIN: not the leader"))
                return True
            if isinstance(msg, MPaxosStoreSync):
                if not self.is_leader:
                    self.paxos.apply_store_sync(msg)
                return True
        return False

    def _handle_lease(self, msg: MMonLease) -> None:
        sender = int(msg.src.split(".")[1])
        if msg.epoch < self.elector.epoch:
            return      # stale reign
        if sender != self.leader_rank:
            # a lease is a quorum-backed leadership claim: adopt it
            # (heals diverged views after a double-win epoch)
            self.elector.epoch = msg.epoch
            self.elector.electing = False
            self.elector.leader = sender
            self.is_leader = False
            self.leader_rank = sender
            self.paxos.epoch = msg.epoch
            self.paxos.send = self._send_rank
            self.paxos.all_ranks = list(self.mon_ranks)
            self._persist_elector()
        self._lease_stamp = self.clock()
        if msg.quorum:
            # adopt the reigning quorum: ours may be a stale
            # pre-partition view that still lists us, masking that the
            # leader's election left us out
            self.elector.quorum = list(msg.quorum)
        if self.rank in self.elector.quorum:
            # an out-of-quorum peon keeps its backoff armed: leases
            # alone must not pace-reset the re-propose loop that gets
            # it readmitted
            self._elect_backoff.reset()
        if msg.last_committed > self.paxos.last_committed:
            self._send_rank(sender, MPaxosSyncReq(
                version=self.paxos.last_committed, rank=self.rank))
        elif msg.last_committed < self.paxos.last_committed:
            # the (stale, freshly elected) leader is BEHIND us: push
            # the commits it missed before it proposes conflicting
            # versions
            for m in self.paxos.sync_reply(msg.last_committed):
                self._send_rank(sender, m)
        # lease ack completes the leader's collect phase
        self._send_rank(sender, MMonLeaseAck(
            epoch=msg.epoch, rank=self.rank,
            last_committed=self.paxos.last_committed))

    def ms_handle_reset(self, peer: str) -> None:
        with self._lock:
            if peer and peer == self._active_mgr:
                # the active mgr died: fail its in-flight proxied
                # commands fast instead of letting clients time out
                self._active_mgr = None
                for tid in list(self._mgr_proxy):
                    cb = self._mgr_proxy.pop(tid)
                    cb(-11, MGR_UNAVAILABLE_EAGAIN
                       + "active mgr went away", None)
            if not self.standalone and peer.startswith("mon.") and \
                    self.leader_rank is not None and \
                    peer == f"mon.{self.leader_rank}" and \
                    not self.is_leader and not self.elector.electing:
                # (electing guard: proposing to the dead leader reports
                # a reset synchronously — without it this would recurse)
                dout("mon", 1).write("%s: leader %s gone, re-electing",
                                     self.name, peer)
                self.elector.start()
                self._persist_elector()

    def _relay_if_peon(self, msg: Message) -> bool:
        """Peons relay map-mutating daemon traffic to the leader
        (payloads carry identities, so re-sending is safe)."""
        if self.is_leader:
            return False
        if self.leader_rank is not None:
            self._send_rank(self.leader_rank, msg)
        return True

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

        self._dispatch_command(cmdmap, reply, client=client, tid=tid)

    def _service_for(self, cmdmap: dict):
        """Command prefix -> owning PaxosService (ref:
        Monitor::dispatch_op's service fan-out)."""
        pfx = str(cmdmap.get("prefix", ""))
        if pfx.startswith("config"):
            return self.configmon
        if pfx == "log" or pfx.startswith("log "):
            return self.logmon
        if pfx == "crash" or pfx.startswith("crash "):
            return self.crashmon
        if pfx.startswith(("fs ", "mds ")) or pfx in ("fs", "mds"):
            return self.mdsmon
        return self.osdmon

    def _dispatch_command(self, cmdmap: dict, reply_cb,
                          client: str = "", tid: int = 0) -> None:
        """preprocess locally; stage writes through the change queue
        (leader) or forward them to it (peon,
        ref: Monitor::forward_request_leader).  The prefix routes to
        the owning PaxosService (ref: Monitor::dispatch_op's service
        fan-out).  Mgr-module prefixes (telemetry/insights) proxy to
        the registered active mgr instead (ref: the MgrMonitor routing
        of module commands)."""
        pfx = str(cmdmap.get("prefix", ""))
        if pfx.split(" ", 1)[0] in ("telemetry", "insights"):
            self._proxy_to_mgr(cmdmap, reply_cb)
            return
        res = self._preprocess_mon_command(cmdmap)
        if res is not None:
            reply_cb(*res)
            return
        svc = self._service_for(cmdmap)
        try:
            res = svc.preprocess_command(cmdmap)
        except (KeyError, ValueError, TypeError) as ex:
            reply_cb(-22, f"invalid command arguments: {ex}", None)
            return
        if res is not None:
            reply_cb(*res)
            return
        if not self.is_leader:
            if self.leader_rank is None or not client:
                reply_cb(-11, "EAGAIN: not the quorum leader", None)
                return
            # forward; the leader acks the client directly (so OUR
            # tracked op is done — it must not age into SLOW_OPS)
            self.op_tracker.finish((client, tid), "forwarded")
            self._send_rank(self.leader_rank, MMonForward(
                tid=tid, client=client, cmd=cmdmap))
            return
        self._submit_change(
            lambda: svc.prepare_command(cmdmap), reply_cb, svc)

    def _proxy_to_mgr(self, cmdmap: dict, reply_cb) -> None:
        """Relay a mgr-module command to the active mgr; its reply
        (MMgrCommandReply) comes back HERE and we ack the client over
        our learned connection — the mgr may have no route to an
        ad-hoc client entity (ref: MgrMonitor + MCommand routing)."""
        if self._active_mgr is None:
            reply_cb(-11, MGR_UNAVAILABLE_EAGAIN + "no active mgr",
                     None)
            return
        tid = next(self._proxy_tids)
        self._mgr_proxy[tid] = reply_cb
        ok = self.ms.connect(self._active_mgr).send_message(
            MMgrCommand(tid=tid, cmd=dict(cmdmap)))
        # a failed send resets synchronously (ms_handle_reset already
        # failed every proxied tid, including this one)
        if not ok and self._mgr_proxy.pop(tid, None) is not None:
            self._active_mgr = None
            reply_cb(-11, MGR_UNAVAILABLE_EAGAIN
                     + "active mgr unreachable", None)

    # ------------------------------------------- cluster-level commands
    # (ref: Monitor::handle_command's mon-level table — `ceph -s`
    #  Monitor.cc get_cluster_status, health get_health, df from PGMap)
    def quorum(self) -> list[int]:
        if self.standalone:
            return [self.rank]
        return sorted(self.paxos.quorum or [self.rank])

    def _preprocess_mon_command(self, cmdmap: dict):
        prefix = cmdmap.get("prefix", "")
        if prefix == "mgr register":
            # the active mgr announces itself (volatile; re-sent every
            # mgr tick) — the routing target for telemetry/insights
            # command proxying (ref: MgrMonitor beacon handling)
            self._active_mgr = str(cmdmap.get("name", "")) or None
            return 0, "", None
        if prefix == "mgr health report":
            # volatile module health (devicehealth etc.) — replaces
            # the previous report wholesale so cleared checks vanish,
            # and STAMPED so a dead mgr's last report expires after
            # mon_mgr_health_grace instead of warning forever
            self._module_health = {
                str(k): {"severity": str(v.get("severity",
                                               "HEALTH_WARN")),
                         "summary": str(v.get("summary", "")),
                         "detail": list(v.get("detail", []))}
                for k, v in dict(cmdmap.get("checks", {})).items()}
            self._module_health_stamp = self.clock()
            return 0, "", None
        if prefix == "osd perf dump":
            # per-daemon counters as last reported (ref: DaemonState
            # perf_counters aggregation in src/mgr/)
            return 0, "", {f"osd.{o}": r.perf
                           for o, r in sorted(
                               self.pgmap.osd_reports.items())
                           if r.perf}
        if prefix not in ("status", "health", "health detail", "df",
                          "pg stat", "pg dump", "quorum_status",
                          "mon stat"):
            return None
        now = self.clock()
        up = {o for o in range(self.osdmap.max_osd)
              if self.osdmap.is_up(o)}
        pgs = self.pgmap.primary_pgs(up)    # one digest per command
        # non-OSD slow-op feeds: MDS beacons (expired with the beacon
        # grace so a dead daemon's last report doesn't warn forever)
        # and the mon's own command tracker
        grace_mds = global_config()["mds_beacon_grace"]
        slow = {name: s for name, s in self._mds_slow.items()
                if now - s.get("stamp", now) <= grace_mds}
        own = self.op_tracker.slow_summary()
        if own["count"]:
            slow[self.name] = own
        checks = health_checks(
            self.osdmap, self.pgmap, self.quorum(), self.mon_ranks,
            now, stale_after=global_config()
            ["mon_osd_stale_report_grace"], pgs=pgs, slow_ops=slow)
        # mgr-module health reports merge in (ref: MgrStatMonitor's
        # health contributions — volatile here rather than paxos'd:
        # the mgr re-reports every tick).  A report older than
        # mon_mgr_health_grace is a dead mgr's leftovers: it must not
        # warn forever (0 = never expire).
        grace = global_config()["mon_mgr_health_grace"]
        if self._module_health_stamp is not None and \
                (grace <= 0 or
                 now - self._module_health_stamp <= grace):
            checks.update(self._module_health)
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
        if prefix in ("quorum_status", "mon stat"):
            return 0, "", {"quorum": self.quorum(),
                           "leader": self.leader_rank,
                           "mons": list(self.mon_ranks),
                           "election_epoch": self.elector.epoch}
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

    def handle_command(self, cmdmap: dict) -> tuple[int, str, object]:
        """Synchronous command path (tests/CLI).  Completes inline on a
        standalone mon; in a quorum a write's commit needs peon acks,
        so this API refuses it BEFORE staging anything — use the wire
        path there (reads work everywhere)."""
        slot: dict = {}
        with self._lock:
            if not self.standalone:
                res = self._preprocess_mon_command(cmdmap)
                if res is not None:
                    return res
                svc = self._service_for(cmdmap)
                try:
                    res = svc.preprocess_command(cmdmap)
                except (KeyError, ValueError, TypeError) as ex:
                    return -22, f"invalid command arguments: {ex}", None
                if res is not None:
                    return res
                raise RuntimeError(
                    "write command needs a quorum commit; use the "
                    "wire path")
            self._dispatch_command(
                cmdmap, lambda r, outs, outb: slot.update(
                    r=r, outs=outs, outb=outb))
        if "r" not in slot:
            raise RuntimeError(
                "command awaits a commit; use the wire path")
        return slot["r"], slot["outs"], slot["outb"]

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
                if not self.is_leader:
                    self._fail_queued("EAGAIN")
                    return
                if self._catchup_pending:
                    return   # collect phase: lease acks will pump us
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
                self._chg_inflight_reply = reply_cb

                def committed(reply_cb=reply_cb, r=r, outs=outs,
                              outb=outb):
                    self._chg_busy = False
                    self._chg_inflight_reply = None
                    self._publish()
                    if reply_cb is not None:
                        reply_cb(r, outs, outb)
                    # async completion (paxos round-trip): drain what
                    # queued meanwhile; a SYNCHRONOUS completion
                    # (standalone mon) is suppressed by _pumping and
                    # the outer while-loop continues instead
                    self._pump_changes()

                svc.propose_pending(on_done=committed)
        finally:
            self._pumping = False

    # ---------------------------------------------------- subscriptions
    def _handle_subscribe(self, msg: MMonSubscribe) -> None:
        if msg.what == "config":
            self._config_subs[msg.src] = 0
            self._send_config(msg.src)
            return
        if msg.what == "fsmap":
            self._fsmap_subs[msg.src] = 0
            self._send_fsmap(msg.src)
            return
        if msg.what != "osdmap":
            return
        self._subs[msg.src] = msg.start or 1
        self._send_maps(msg.src)

    def _send_fsmap(self, entity: str) -> None:
        """Push the current fsmap when the subscriber hasn't seen this
        epoch (ref: Monitor handle_subscribe "fsmap" / MDSMonitor
        check_subs)."""
        m = self.mdsmon.fsmap
        if self._fsmap_subs.get(entity, 0) >= m.epoch:
            return
        self._fsmap_subs[entity] = m.epoch
        self.ms.connect(entity).send_message(
            MFSMap(epoch=m.epoch, fsmap=m))

    def _send_config(self, entity: str) -> None:
        """Push the entity's merged config when it changed since the
        last push (ref: ConfigMonitor::send_config / check_all_subs)."""
        ver = self.configmon.get_last_committed()
        if self._config_subs.get(entity, 0) >= ver:
            return
        self._config_subs[entity] = ver
        self.ms.connect(entity).send_message(MConfig(
            version=ver,
            values=self.configmon.entity_config(entity)))

    def _adopt_subscriber(self, entity: str, epoch: int | None) -> None:
        """A mon started again on its store lost its subscriptions with
        its process: an entity it hears from without one (an OSD's
        pg-stat report, a client's command) gets the maps past its
        `epoch` (the current full map when the message carries none)
        and stays subscribed; an OSD also gets its centralized config
        again, which it subscribed to at boot.  A mon that bootstrapped
        does nothing here."""
        if self._resumed and entity not in self._subs:
            self._subs[entity] = 1 if epoch is None else epoch + 1
            self._send_maps(entity)
            if entity.startswith("osd.") and \
                    entity not in self._config_subs:
                self._config_subs[entity] = 0
                self._send_config(entity)

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
        for entity in list(self._config_subs):
            self._send_config(entity)
        for entity in list(self._fsmap_subs):
            self._send_fsmap(entity)

    def _handle_mds_beacon(self, msg: MMDSBeacon) -> None:
        """(ref: MDSMonitor::preprocess_beacon/prepare_beacon): stamp
        the gid, stage any fsmap change, and answer the sender with
        the current map so it learns assignments/standdowns without a
        separate subscription."""
        self.mdsmon.note_beacon(msg.gid, self.clock())
        # SLOW_OPS feed, MDS half: the beacon piggybacks the daemon's
        # op-tracker summary; count 0 clears the entry (drained)
        sl = dict(msg.slow_ops or {})
        if msg.name:
            if int(sl.get("count", 0)) > 0:
                self._mds_slow[msg.name] = dict(sl, stamp=self.clock())
            else:
                self._mds_slow.pop(msg.name, None)
        # reply to the daemon's ENTITY name, not msg.src: a beacon
        # relayed through a peon arrives with the peon's src
        src = msg.name or msg.src

        def reply(_r, _outs, _outb):
            m = self.mdsmon.fsmap
            self.ms.connect(src).send_message(
                MFSMap(epoch=m.epoch, fsmap=m))

        now = self.clock()
        self._submit_change(
            lambda: self.mdsmon.stage_beacon(msg, now),
            reply_cb=reply, svc=self.mdsmon)

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

    def _handle_log(self, msg: MLog) -> None:
        """Daemon LogClient batch: stage through the logm paxos
        service and ack the sender's high-water seq once committed
        (ref: LogMonitor::prepare_log + MLogAck)."""
        src = msg.src
        by_name: dict[str, int] = {}
        for e in msg.entries:
            n = str(e.get("name", "?"))
            by_name[n] = max(by_name.get(n, -1), int(e.get("seq", 0)))

        def stage():
            if not self.logmon.stage_entries(list(msg.entries)):
                # pure resend: ack again without an empty proposal
                for n, s in by_name.items():
                    self.ms.connect(src).send_message(MLogAck(
                        name=n, last_seq=s))
                return (1, "", None)
            return (0, "", None)

        def done(r, _outs, _outb):
            if r == 0:
                for n, s in by_name.items():
                    self.ms.connect(src).send_message(MLogAck(
                        name=n, last_seq=s))

        self._submit_change(stage, reply_cb=done, svc=self.logmon)

    def clog_event(self, level: str, text: str) -> None:
        """Mon-originated cluster-log entry (osd down/out) staged for
        the next logm proposal (ref: the mon_clog channel in
        LogMonitor).  Staging happens inside the serialized stage
        callback so the seq is computed against the pending state it
        actually lands on."""
        def stage():
            seq = self.logmon.last_seq_for(self.name) + 1 + len(
                [e for e in self.logmon.pending
                 if e["name"] == self.name])
            ok = self.logmon.stage_entries([{
                "seq": seq, "stamp": self.clock(),
                "name": self.name, "level": level, "text": text}])
            return (0, "", None) if ok else (1, "", None)
        self._submit_change(stage, svc=self.logmon)

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
        """Periodic: auto-out down OSDs; leases/re-election in a
        quorum (ref: OSDMonitor.cc:4965 tick; Monitor.cc tick).
        Crash-capturing entry: an unhandled tick exception lands in
        the crash table before propagating."""
        try:
            self._tick(now)
        except Exception as exc:
            self.crash_reporter.capture(exc)
            raise

    def _tick(self, now: float | None = None) -> None:
        self.hbmap.reset_timeout(self._hb_handle)
        with self._lock:
            now = self.clock() if now is None else now
            if not self.standalone:
                if self.is_leader:
                    if self._catchup_pending and \
                            now - self._last_lease_sent >= 1.0:
                        self._broadcast_lease()   # re-ask for acks
                    elif now - self._last_lease_sent >= LEASE_INTERVAL:
                        self._broadcast_lease()
                elif (self.leader_rank is None or
                        now - self._lease_stamp > LEASE_TIMEOUT or
                        self.rank not in self.elector.quorum) and \
                        self._elect_backoff.ready(now):
                    # third clause: a lease-fed peon OUTSIDE the
                    # quorum (its election ack got lost) must keep
                    # proposing — paced — until the quorum admits it
                    dout("mon", 1).write(
                        "%s: lease stale, re-electing (attempt %d)",
                        self.name, self._elect_backoff.failures + 1)
                    self._elect_backoff.fail(now)
                    self.elector.start()
                    self._persist_elector()
            if not self.is_leader:
                return
            # MDS beacon-lapse detection + standby promotion
            # (ref: MDSMonitor::tick)
            m = self.mdsmon.fsmap
            if m.ranks or m.standbys:
                self._submit_change(
                    lambda now=now: self.mdsmon.stage_failures(now),
                    svc=self.mdsmon)
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
