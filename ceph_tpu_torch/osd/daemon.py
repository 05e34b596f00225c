"""OSD daemon: the per-OSD process wiring PGs to the wire.

The messenger-facing shell around the PG backends (ref: src/osd/OSD.cc
— init/boot :3054, ms_dispatch/dispatch_op_fast, _dispatch of client
ops to PrimaryLogPG::do_request; map handling handle_osd_map :8010):
boots to the mon, subscribes to osdmap epochs, instantiates shard
services and primary backends for the PGs its map places on it, routes
client MOSDOp traffic into the backends, and fans sub-ops between
peers.  All coding math stays inside ECBackend's batched encode/decode
launches; the daemon is host-side protocol glue.

The port's copy of `ceph_tpu.osd.daemon` in part, for erasure-coded
and replicated pools: boot and map handling, client ops (writes and
compound `writev` ops, reads, stat, xattr and omap reads, `pgls`), the EC
sub-op routing and the replicated fan-out (`RepOpWrite`, `RepOpReply`),
both peering statecharts (ECPGPeering, and PGPeering with its GetMissing
exchange, pulls and pushes) with their log merges, backfill reservations
and scan windows, pg_temp requests, strays and PG removal, the mClock op
queue (recovery pulls and pushes ride its recovery class), heartbeats and
failure reports, pg-stat reports, both pool types' scrub (the client ops
`scrub` / `scrub-repair`, the scheduler on the heartbeat tick with its
reservations, EC repair through `ECBackend.recover_object`, replicated
repair by forced pushes from the primary's copy, and the chained verify
round) and the optional device-mesh `fabric`.  Every plugin the daemon
builds lives on its `device` (cuda unless the caller passes
`device="cpu"`); a replicated PG launches no kernel.  Three rules differ:
a queued recovery item that raises is logged as in the reference and
also counted in the `queued_op_failures` perf counter; a pull that
finds no PG view to push from is dropped as in the reference and also
counted in `recovery_push_errors`; and a live OSD that a new map shows
down boots again, as Ceph's does, where the reference's stays down
until it is marked out.  A pool's pg_num growth splits the
PGs this OSD holds in place (`_split_pgs`: objects, their durable log
entries and snap index move to the child collections in one transaction
per parent), and a later pgp_num growth reseeds placement, which the
peering statecharts chase from the prior interval's holders.  One thing
is the port's own: the daemon keeps each placement seed's raw CRUSH
result across epochs that leave the CRUSH inputs alone (`_pg_mapping`),
where the reference maps every PG again on every epoch; the mappings
are the same.  Left out: snap trim and the snapshot ops (`rollback`,
`list_snaps`), object classes (`exec`), watch/notify (a client op the
daemon does not carry answers EINVAL), the cluster-log client (a scrub
result goes to the debug log only), centralized config and the
heartbeat mute hook.  Crash capture is the reference's: an exception
out of a heartbeat tick or a dispatch thread (or the
`inject_crash_tick` fault) becomes a crash report, spooled to
`crash_dir` when one is given and posted to the mon's crash table as a
`crash post` command, whose ack retires the spool copy; `init` drains
the spool.
With a `keyring` the daemon signs its traffic and verifies inbound
(cephx); `start_admin_socket` serves perf dump, status, config
show/get/set and the op tracker's dumps.
The port adds to the perf counters `tick_errors` (the tick errors a
daemon process's loop survived, tools/daemon_main.py) and, for the
replicated catch-up's accounting, `push_in`, `push_in_bytes` and
`backfill_push_in` (PGPush messages this OSD applied, their data bytes,
and those of them a backfill walk sent).  As the reference's, the
daemon starts on a store that already holds PG collections, pgmeta
omaps and shard logs (a `BlueStore` or `JournaledStore` mounted on its
data dir after a SIGKILL): each PG's shard takes the collection as it
is and loads its durable log, so peering compares real log bounds and
recovers only what the OSD missed.
"""
from __future__ import annotations

import itertools
import threading
import time
import traceback
from typing import Optional

from .. import device as _device
from ..common.heartbeat_map import HeartbeatMap
from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.options import global_config
from ..common.perf_counters import global_perf
from ..common.racecheck import shared_state
from ..common.tracing import Tracer
from ..common.tracked_op import OpTracker
from ..crush.types import CRUSH_ITEM_NONE
from ..ec import registry as ec_registry
from ..mon.osd_monitor import DEFAULT_EC_PROFILE
from ..msg.messages import (BackfillReserve, ECSubRead, ECSubReadReply,
                            ECSubWrite, ECSubWriteReply, MMap,
                            MMonCommand, MMonCommandAck,
                            MMonSubscribe, MOSDBoot, MOSDFailure,
                            MOSDPGTemp, MPGStats, OSDOp, OSDOpReply,
                            PGLogPush, PGLogReq, PGMissingReply,
                            PGNotify, PGPull, PGPush, PGQuery, PGRemove,
                            PGScan, PGScanReply, Ping, PingReply,
                            RepOpReply, RepOpWrite, ScrubMapReply,
                            ScrubMapRequest, ScrubReserve)
from ..msg import encoding as wire
from ..msg.messenger import Dispatcher, LocalNetwork, Message, Messenger
from ..msg.mon_client import MonHunter
from ..store import MemStore, StoreError, Transaction
from . import mutations as mut
from .ec_backend import (ECBackend, ECPGShard, ec_store_inventory,
                         pg_cid, spread_tombstones)
from .ec_peering import ECPGPeering, ECRollbacker
from .mutations import MutationError
from .op_queue import MClockQueue
from .osdmap import CEPH_OSD_EXISTS, OSDMap
from .peering import (CLEAN, GETINFO, GETLOG, GETMISSING, PGPeering,
                      StoreRollbacker, _ev)
from .pg_log import IndexedLog, LogEntryHandler
from .pg_types import ZERO_VERSION, EVersion
from .replicated_backend import (PGMETA, _TAIL_KEY, ReplicatedBackend,
                                 ReplicatedPGShard, _log_key)
from .snap_mapper import SnapMapper
from .types import PG, POOL_TYPE_ERASURE, cbits, ceph_stable_mod

#: errno-name -> numeric result for client replies (ref: the rc values
#: MOSDOpReply carries; errno(3))
_ERRNO = {"ENOENT": -2, "EIO": -5, "EBUSY": -16, "EEXIST": -17,
          "EINVAL": -22, "ENODATA": -61, "EOPNOTSUPP": -95,
          "ESTALE": -116, "ECANCELED": -125}


class _PGState:
    """One PG's services on this OSD."""

    def __init__(self):
        self.shard = None          # ECPGShard | ReplicatedPGShard
        self.backend = None        # primary-only
        self.acting: list[int] = []
        self.acting_primary = -1
        self.up: list[int] = []
        # peering statechart (primary only): PGPeering for replicated
        # pools (osd/peering.py), ECPGPeering for erasure pools
        # (osd/ec_peering.py)
        self.peering = None        # PGPeering | ECPGPeering | None
        self.backfilling = False
        self.recovering = False
        self.scrub = None          # active _ScrubState (primary only)
        # automatic scrub scheduling (primary only; ref: pg_info_t's
        # last_scrub_stamp driving OSD::sched_scrub).  Stamps live in
        # the tick's clock domain (monotonic or simulated) and reset
        # on daemon restart — the first tick seeds them with a
        # deterministic per-PG jitter so a cold cluster doesn't scrub
        # everything at once.
        self.last_scrub_stamp: float | None = None
        self.last_deep_scrub_stamp: float | None = None
        #: remote scrub-reservation grants awaited: set of osds
        self.scrub_reserving: set | None = None
        self.scrub_granted: set = set()
        self.scrub_deep_pending = False
        self.scrub_backoff_until = 0.0


class _ScrubState:
    """One in-flight scrub round (ref: src/osd/scrubber/pg_scrubber).

    `reply_msg` is None for scheduler-initiated scrubs (no client to
    answer).  A repair round that actually dispatched repairs chains a
    VERIFY round (`orig` points back) re-collecting maps so the final
    result proves the repairs landed."""

    def __init__(self, reply_msg, repair: bool, deep: bool = True,
                 auto: bool = False):
        self.reply_msg = reply_msg
        self.repair = repair
        self.deep = deep
        self.auto = auto                      # scheduler-initiated
        self.orig: "_ScrubState | None" = None  # we verify that round
        self.pending: set[int] = set()        # osds awaited
        self.maps: dict[int, dict] = {}       # osd -> scrub map
        self.repairs_pending = 0
        self.comparing = False                # reply gate (see
        self.inconsistent: list[str] = []     # _finish_scrub)
        self.repaired = 0
        self.unrepairable: list[str] = []


# the PG table is shared between the dispatch thread, the tick thread
# and the pacing timer — racecheck asserts every post-publish access
# holds self._lock (the map mutates through reads, so reads count)
@shared_state(only=("pgs",), mutating=("pgs",))
class OSDDaemon(Dispatcher, MonHunter):
    """osd.<id> (ref: src/osd/OSD.h:1036)."""

    def __init__(self, network: LocalNetwork, whoami: int,
                 store: Optional[MemStore] = None, mon="mon.0",
                 threaded: bool = False, perf_collection=None,
                 fabric=None, device=None, keyring=None,
                 crash_dir: str | None = None):
        self.whoami = whoami
        self.name = f"osd.{whoami}"
        #: where every plugin this daemon builds lives (cuda unless
        #: the caller asks for the CPU); resolving raises without a card
        self.device = _device.resolve(device)
        #: ICIFabric this OSD is device-mesh co-resident on (None =
        #: host-only; dist/fabric.py)
        self.fabric = fabric
        if fabric is not None:
            fabric.register_resident(whoami)
        # mon may be a single name or a failover list
        self._init_mons(mon)
        self.store = store or MemStore()
        if not self.store.mounted:
            self.store.mkfs()
            self.store.mount()
        self.osdmap = OSDMap()
        self.pgs: dict[PG, _PGState] = {}
        # previous interval's acting sets (prior-set source for
        # peering; see _prior_acting_for)
        self._acting_hist: dict[PG, list[int]] = {}
        self._acting_hist_pgnum: dict[int, int] = {}
        self._pool_pg_num: dict[int, int] = {}   # split detection
        # raw CRUSH results by (pool, pps) and the inputs they hold for
        # (see _pg_mapping)
        self._raw_cache: dict = {}
        self._raw_inputs: tuple = ()
        self._ecs: dict[str, object] = {}     # profile name -> plugin
        # shared across backend rebuilds: stale sub-replies must never
        # alias a new op's tid
        self._tid_gen = itertools.count(1)
        self._lock = make_lock(f"{self.name}.daemon")
        # heartbeat state (ref: OSD.cc heartbeat_* family)
        self._hb_last: dict[int, float] = {}   # peer -> last reply time
        self._hb_first: dict[int, float] = {}  # peer -> first ping time
        self._hb_reported: set[int] = set()
        self._hb_now: float | None = None      # our last tick stamp
        # backfill reservations (ref: the AsyncReserver pair in OSD.h:
        # local_reserver + remote_reserver, both osd_max_backfills
        # wide).  Requests past capacity QUEUE and are granted as
        # slots free — the reference's AsyncReserver model, so
        # saturation never needs a timer-driven retry
        self._local_backfills: set = set()          # PGs we drive
        self._remote_backfills: set = set()         # (pg, primary osd)
        self._local_waitq: list = []                # PGs awaiting a slot
        self._remote_waitq: list = []               # (key, reply addr)
        #: peak reserver occupancy since boot — recorded at the moment
        #: a slot is taken, so tests can assert throttled backfills ran
        #: without racing the (often sub-tick) hold window
        self.bf_peak_local = 0
        self.bf_peak_remote = 0
        # scrub reservations (ref: the scrub reserver in OSD.h; both
        # sides bounded by osd_max_scrubs)
        self._scrubs_remote: set = set()       # (pg, primary) we serve
        self.scrub_peak_local = 0
        self.scrub_peak_remote = 0
        #: cached stray self-notifies: pg -> (PGNotify, primary osd)
        self._stray_notifies: dict = {}
        #: cached transient EC shard views: (pg, shard) -> ECPGShard
        #: (dropped on map ingest; see _ec_view)
        self._ec_transients: dict = {}
        self._last_stat_report = 0.0
        # in-flight/historic op tracking (ref: src/common/TrackedOp.h)
        self.op_tracker = OpTracker(
            history_size=global_config()["osd_op_history_size"])
        # blkin-style span sink (ref: OpRequest::pg_trace plumbing)
        self.tracer = Tracer(self.name)
        self._op_spans: dict = {}
        self.hbmap = HeartbeatMap()
        self._hb_handle = self.hbmap.add_worker(
            f"{self.name}.tick",
            grace=4 * global_config()["osd_heartbeat_interval"])
        # mClock op-class QoS (ref: src/osd/mClockOpClassQueue.h):
        # client ops execute inline and are ACCOUNTED; recovery work is
        # queued and paced by the two-phase scheduler (a scrub runs in
        # dispatch; the reference's "scrub" class is never fed)
        cfg = global_config()
        self.op_queue = MClockQueue()
        self.op_queue.set_class("client",
                                weight=cfg["osd_mclock_client_wgt"])
        rec_lim = cfg["osd_mclock_recovery_lim"]
        self.op_queue.set_class(
            "recovery", reservation=cfg["osd_mclock_recovery_res"],
            weight=cfg["osd_mclock_recovery_wgt"], limit=rec_lim,
            burst=max(8.0, rec_lim / 4) if rec_lim > 0 else 64.0)
        self._qos_timer: threading.Timer | None = None
        # op counters (ref: src/osd/osd_perf_counters.cc l_osd_op*);
        # multi-cluster harnesses pass their own collection so two
        # same-named daemons never commingle counts
        coll = perf_collection if perf_collection is not None \
            else global_perf()
        self.perf = coll.create(self.name)
        for key in ("op", "op_r", "op_w", "op_r_bytes", "op_w_bytes",
                    "subop_w", "recovery_push", "recovery_pull",
                    "recovery_bytes_read", "recovery_bytes_rebuilt",
                    "map_epochs",
                    # the port's fault counters: rebuilds that took the
                    # full decode + re-encode instead of the compiled
                    # repair, queued items that raised, tick errors a
                    # daemon process's loop survived, and pulls dropped
                    # for want of a view to push from
                    "recovery_full_rebuild", "queued_op_failures",
                    "tick_errors", "recovery_push_errors",
                    # and the pushes this OSD applied (the replicated
                    # catch-up's bytes)
                    "push_in", "push_in_bytes", "backfill_push_in"):
            self.perf.add_u64_counter(key)
        # per-op-class latency histograms (ref: the l_osd_op_*_lat
        # family + mClock op classes)
        for key in ("op_lat_client", "op_lat_recovery"):
            self.perf.add_latency_histogram(key)
        # messenger drops seen by the shared network: a monotonic
        # total exported through the normal perf-dump path
        self.perf.add_u64_counter("msgr_drops_total")
        self.ms = Messenger.create(network, self.name, threaded=threaded)
        self.ms.add_dispatcher(self)
        if keyring is not None:
            from ..auth import attach_cephx
            attach_cephx(self.ms, self.name, keyring)
        self.asok = None
        # crash capture (ref: mgr/crash ingest + the ceph-crash spool
        # agent): unhandled tick/dispatch exceptions serialize into
        # crash metadata, spool to crash_dir (if any), and post to the
        # mon's crash table; the ack retires the spool copy
        from ..common.crash import CrashReporter
        self.crash = CrashReporter(self.name, crash_dir=crash_dir,
                                   post=self._post_crash_meta)
        self.ms.crash_hook = self.crash.capture
        #: fault hook: raise out of the next heartbeat tick (the
        #: osd_debug_inject_crash_tick analogue, settable per-daemon)
        self.inject_crash_tick = \
            bool(global_config()["osd_debug_inject_crash_tick"])

    # ------------------------------------------------------------ setup
    def init(self) -> None:
        self.ms.start()
        self.ms.connect(self.mon).send_message(MOSDBoot(osd=self.whoami))
        self.ms.connect(self.mon).send_message(
            MMonSubscribe(what="osdmap", start=1))
        # next-boot spool drain: crashes captured while the mon was
        # unreachable post now (the table dedups by crash_id)
        self.crash.drain()

    def _post_crash_meta(self, meta: dict) -> None:
        tid = self.crash.alloc_tid(meta["crash_id"])
        self.ms.connect(self.mon).send_message(MMonCommand(
            tid=tid, cmd={"prefix": "crash post", "meta": meta}))

    def shutdown(self) -> None:
        if self.asok is not None:
            self.asok.shutdown()
        if self._qos_timer is not None:
            self._qos_timer.cancel()
        self.ms.shutdown()

    # -------------------------------------------------- admin socket
    def start_admin_socket(self, path: str) -> None:
        """`ceph daemon osd.N <cmd>` endpoint
        (ref: OSD::asok_command src/osd/OSD.cc:2712)."""
        from ..common.admin_socket import AdminSocket
        from ..common.obs import register_obs_commands
        a = AdminSocket(path)

        def _perf_dump(c):
            self._refresh_msgr_perf()
            return 0, self.perf.dump()
        a.register("perf dump", "dump perf counters", _perf_dump)
        a.register("config show", "dump live config values",
                   lambda c: (0, global_config().dump()))
        a.register("config get", "get one option",
                   lambda c: (0, global_config()[c["var"]]))

        def _config_set(c):
            global_config().set(c["var"], c["val"])
            return 0, "success"
        a.register("config set", "set one option", _config_set)
        register_obs_commands(a, self.op_tracker, self.tracer)

        def _status(c):
            with self._lock:
                prim = [st for st in self.pgs.values()
                        if st.backend is not None]
                return 0, {"whoami": self.whoami,
                           "osdmap_epoch": self.osdmap.epoch,
                           "num_pgs": len(self.pgs),
                           "num_primary": len(prim),
                           "primary_clean": sum(
                               1 for st in prim if st.peering is not None
                               and st.peering.phase == CLEAN),
                           "pgs_recovering": self.pgs_recovering(),
                           "hbmap_unhealthy":
                               self.hbmap.get_unhealthy_workers()}
        a.register("status", "daemon status", _status)
        a.start()
        self.asok = a

    def _hunt_greeting(self) -> list:
        return [MOSDBoot(osd=self.whoami),
                MMonSubscribe(what="osdmap",
                              start=self.osdmap.epoch + 1)]

    def ms_handle_reset(self, peer: str) -> None:
        """Our mon went away: hunt to the next one (shared MonHunter
        walk; iterative, never recursive)."""
        self._maybe_hunt(peer)

    # ------------------------------------------------------- dispatch
    def ms_dispatch(self, msg: Message) -> bool:
        # the whole dispatch runs under the daemon lock (the Monitor
        # does the same): the tick and pacing-timer threads walk
        # self.pgs under this lock.  The lock is reentrant, so
        # handlers that take it internally are fine.
        with self._lock:
            return self._dispatch(msg)

    def _dispatch(self, msg: Message) -> bool:
        if isinstance(msg, MMap):
            self._handle_map(msg)
            return True
        if isinstance(msg, MMonCommandAck):
            # only crash posts ride the command channel from an OSD;
            # a successful ack retires the spooled copy
            self.crash.on_ack(msg.tid, msg.result)
            return True
        if isinstance(msg, OSDOp):
            self.op_tracker.start(
                (msg.src, msg.tid),
                f"osd_op({msg.src} tid={msg.tid} {msg.op} "
                f"{msg.pgid} {msg.oid})")
            if msg.trace:
                sp = self.tracer.start_span(
                    msg.trace, f"osd_op:{msg.op}")
                sp.event(f"oid={msg.oid}")
                self._op_spans[(msg.src, msg.tid)] = sp
            self.op_tracker.mark((msg.src, msg.tid), "dispatched")
            # client ops run inline (latency IS the product); the QoS
            # queue accounts them so recovery shares are computed
            # against real client load
            self.op_queue.account("client")
            self._handle_client_op(msg)
            return True
        if isinstance(msg, ECSubWrite):
            st = self.pgs.get(msg.pgid)
            if st is not None and st.shard is not None:
                self.perf.inc("subop_w")
                sp = self.tracer.start_span(msg.trace, "ec_sub_write")
                reply = st.shard.handle_sub_write(msg)
                if sp is not None:
                    sp.event(f"shard={msg.shard} committed="
                             f"{reply.committed}")
                    self.tracer.finish(sp)
            else:
                pool = self.osdmap.pools.get(msg.pgid.pool)
                if pool is not None and \
                        pool.type == POOL_TYPE_ERASURE:
                    # map lag on a backfill target: the pushing (temp)
                    # primary may act on a newer map than ours — apply
                    # through a transient shard view rather than nack,
                    # or every push races the target's map ingest
                    view = self._ec_view(msg.pgid, msg.shard,
                                         create=True)
                    reply = view.handle_sub_write(msg)
                else:
                    # nack so the sender's op/recovery fails fast
                    # instead of waiting on an ack that never comes
                    reply = ECSubWriteReply(pgid=msg.pgid, tid=msg.tid,
                                            shard=msg.shard,
                                            committed=False)
            self.ms.connect(msg.src).send_message(reply)
            return True
        if isinstance(msg, ECSubRead):
            rsp = self.tracer.start_span(msg.trace, "ec_sub_read")
            st = self.pgs.get(msg.pgid)
            if st is not None and isinstance(st.shard, ECPGShard) and \
                    st.shard.shard == msg.shard:
                reply = st.shard.handle_sub_read(msg)
            elif self.store.collection_exists(pg_cid(msg.pgid)):
                # prior-interval holder (or an index we no longer
                # serve live): peering chunk gathers read cross-set,
                # so answer from a transient store view at the
                # REQUESTED shard index (ref: EC backfill reading
                # from the previous interval's shards)
                view = self._ec_view(msg.pgid, msg.shard)
                reply = view.handle_sub_read(msg)
            else:
                # no data here: error every requested object so the
                # reading primary fails fast instead of waiting
                reply = ECSubReadReply(
                    pgid=msg.pgid, tid=msg.tid, shard=msg.shard,
                    errors={**{oid: "ESTALE"
                               for oid, _off, _len in msg.to_read},
                            **{oid: "ESTALE"
                               for oid in msg.subchunks}})
            if rsp is not None:
                rsp.event(f"shard={msg.shard} "
                          f"errors={len(reply.errors)}")
                self.tracer.finish(rsp)
            self.ms.connect(msg.src).send_message(reply)
            return True
        if isinstance(msg, ECSubWriteReply):
            st = self.pgs.get(msg.pgid)
            if st is not None and st.backend is not None:
                if not st.backend.handle_recovery_write_reply(msg):
                    st.backend.handle_sub_write_reply(msg)
            return True
        if isinstance(msg, ECSubReadReply):
            st = self.pgs.get(msg.pgid)
            if st is None:
                return True
            pr = st.peering
            if pr is not None and pr.on_chunk_reply(msg):
                return True
            if st.backend is not None:
                st.backend.handle_sub_read_reply(msg)
            return True
        if isinstance(msg, RepOpWrite):
            st = self.pgs.get(msg.pgid)
            if st is not None and st.shard is not None:
                self.perf.inc("subop_w")
                sp = self.tracer.start_span(msg.trace, "rep_write")
                reply = st.shard.handle_rep_write(msg, self.whoami)
                if sp is not None:
                    sp.event(f"oid={msg.oid} committed="
                             f"{reply.committed}")
                    self.tracer.finish(sp)
                self.ms.connect(msg.src).send_message(reply)
            return True
        if isinstance(msg, RepOpReply):
            st = self.pgs.get(msg.pgid)
            if st is not None and st.backend is not None:
                st.backend.handle_rep_reply(msg)
            return True
        if isinstance(msg, PGScan):
            # answer from the store even if our map (and PG state) lags
            # the scanner's — an unanswered scan would wedge its
            # recovery; the store view is the authority anyway.  The
            # scanner tags its pool type so only that view is built.
            if msg.ec:
                reply = PGScanReply(
                    pgid=msg.pgid, from_osd=self.whoami,
                    ec_shards=ec_store_inventory(self.store,
                                                 pg_cid(msg.pgid)))
            else:
                inv = self._replicated_view(msg.pgid).inventory()
                if msg.ranged:
                    inv = {o: v for o, v in inv.items()
                           if o > msg.begin and
                           (msg.end == "" or o <= msg.end)}
                reply = PGScanReply(
                    pgid=msg.pgid, from_osd=self.whoami, objects=inv,
                    ranged=msg.ranged, begin=msg.begin, end=msg.end)
            self.ms.connect(msg.src).send_message(reply)
            return True
        if isinstance(msg, PGScanReply):
            st = self.pgs.get(msg.pgid)
            pr = st.peering if st is not None else None
            if pr is not None:
                if msg.ranged:
                    pr.on_backfill_scan(msg)
                else:
                    pr.on_primary_backfill_scan(msg)
            # no peering: a stale reply for a superseded round — drop
            return True
        if isinstance(msg, PGQuery):
            # pg_info from the durable shard log — answerable even
            # with no live PG state (GetInfo queries reach
            # prior-interval holders and map-lagging peers)
            if msg.ec:
                shard = self._ec_view(msg.pgid)
                head, tail = shard.log_info()
                inv = shard.shard_inventory()
                shards = sorted({s for m_ in inv.values() for s in m_})
            else:
                rshard = self._replicated_view(msg.pgid)
                head, tail = rshard.log_info()
                inv = rshard.inventory()
                shards = []
            self.ms.connect(msg.src).send_message(PGNotify(
                pgid=msg.pgid, from_osd=self.whoami, epoch=msg.epoch,
                last_update=head, log_tail=tail,
                have_data=bool(inv), n_objects=len(inv),
                shards=shards))
            return True
        if isinstance(msg, PGNotify):
            if msg.stray:
                self._handle_stray_notify(msg)
            else:
                st = self.pgs.get(msg.pgid)
                if st is not None and st.peering is not None:
                    st.peering.on_info(msg)
            return True
        if isinstance(msg, PGLogReq):
            shard = self._ec_view(msg.pgid) if msg.ec \
                else self._replicated_view(msg.pgid)
            head, tail = shard.log_info()
            since = msg.since if msg.since is not None else tail
            if msg.full:
                entries, rtail = list(shard.pg_log.log.entries), tail
            else:
                entries = [e for e in shard.pg_log.log.entries
                           if e.version > since]
                # the advertised tail must not claim history the
                # segment doesn't carry
                rtail = max(tail, since)
            self.ms.connect(msg.src).send_message(PGLogPush(
                pgid=msg.pgid, from_osd=self.whoami, entries=entries,
                head=head, tail=rtail, to_primary=True,
                full=msg.full, epoch=msg.epoch))
            return True
        if isinstance(msg, PGLogPush):
            if msg.to_primary:
                st = self.pgs.get(msg.pgid)
                if st is not None and st.peering is not None:
                    st.peering.on_auth_log(msg)
            elif msg.activate:
                self._replica_merge_log(msg)
            return True
        if isinstance(msg, PGMissingReply):
            st = self.pgs.get(msg.pgid)
            if st is not None and st.peering is not None:
                st.peering.on_missing(msg)
            return True
        if isinstance(msg, BackfillReserve):
            self._handle_backfill_reserve(msg)
            return True
        if isinstance(msg, PGRemove):
            self._handle_pg_remove(msg)
            return True
        if isinstance(msg, PGPull):
            # recovery pushes ride the mClock queue: a storm of pulls
            # drains at the recovery class's reservation/limit instead
            # of flooding the wire ahead of client ops
            for oid in msg.oids:
                self.op_queue.enqueue(
                    "recovery",
                    lambda pgid=msg.pgid, src=msg.src, oid=oid:
                        self._send_recovery_push(pgid, src, oid))
            self._drain_op_queue()
            return True
        if isinstance(msg, PGPush):
            self._handle_push(msg)
            return True
        if isinstance(msg, ScrubMapRequest):
            st = self.pgs.get(msg.pgid)
            if st is None or st.shard is None:
                # map lag: no PG state yet — tell the primary to retry
                # instead of reading "no objects anywhere"
                self.ms.connect(msg.src).send_message(ScrubMapReply(
                    pgid=msg.pgid, from_osd=self.whoami, absent=True))
            else:
                self.ms.connect(msg.src).send_message(ScrubMapReply(
                    pgid=msg.pgid, from_osd=self.whoami,
                    objects=st.shard.scrub_map(msg.deep)))
            return True
        if isinstance(msg, ScrubMapReply):
            self._handle_scrub_reply(msg)
            return True
        if isinstance(msg, ScrubReserve):
            self._handle_scrub_reserve(msg)
            return True
        if isinstance(msg, Ping):
            self.ms.connect(msg.src).send_message(
                PingReply(epoch=self.osdmap.epoch, stamp=msg.stamp))
            return True
        if isinstance(msg, PingReply):
            if msg.src.startswith("osd."):
                peer = int(msg.src[4:])
                self._hb_last[peer] = max(
                    self._hb_last.get(peer, 0.0), msg.stamp)
            return True
        return False

    # ----------------------------------------------------------- maps
    def _handle_map(self, msg: MMap) -> None:
        with self._lock:
            old_up = {o for o in range(self.osdmap.max_osd)
                      if self.osdmap.is_up(o)}
            old_epoch = self.osdmap.epoch
            self.osdmap = self.osdmap.ingest(msg.full_map,
                                             msg.incrementals)
            self.perf.inc("map_epochs",
                          max(0, self.osdmap.epoch - old_epoch))
            dout("osd", 10).write("%s: now at map e%d", self.name,
                                  self.osdmap.epoch)
            # a peer that came (back) up starts with a clean heartbeat
            # slate — its pre-down silence must not trigger an instant
            # re-report (ref: OSD.cc note_up resetting hb peers)
            for o in range(self.osdmap.max_osd):
                if self.osdmap.is_up(o) and o not in old_up:
                    self._hb_first.pop(o, None)
                    self._hb_last.pop(o, None)
                    self._hb_reported.discard(o)
            # reclaim remote backfill slots whose requesting primary
            # died — an explicit release will never come, and at
            # osd_max_backfills=1 a leaked slot wedges every future
            # backfill through this target
            dead = [k for k in self._remote_backfills
                    if not self.osdmap.is_up(k[1])]
            for k in dead:
                self._remote_backfills.discard(k)
            self._remote_waitq = [(k, s) for k, s in self._remote_waitq
                                  if self.osdmap.is_up(k[1])]
            if dead:
                self._grant_queued_reservations()
            # scrub slots whose requesting primary died reclaim the
            # same way (no release will ever come)
            for k in [k for k in self._scrubs_remote
                      if not self.osdmap.is_up(k[1])]:
                self._scrubs_remote.discard(k)
            # transient EC views go stale when PG state changes hands
            self._ec_transients.clear()
            self._update_pgs()
            # wrongly marked down: a live OSD that a new epoch shows down
            # (false failure reports, a healed partition, `osd down`)
            # announces itself again (ref: OSD.cc _committed_osd_maps
            # "wrongly marked me down" -> start_boot)
            me = self.whoami
            if me in old_up and me < self.osdmap.max_osd and \
                    self.osdmap.exists(me) and not self.osdmap.is_up(me):
                dout("osd", 0).write("%s: map e%d wrongly marked me down",
                                     self.name, self.osdmap.epoch)
                self.ms.connect(self.mon).send_message(
                    MOSDBoot(osd=me))

    def _ec_plugin(self, profile_name: str):
        ec = self._ecs.get(profile_name)
        if ec is None:
            profile = self.osdmap.erasure_code_profiles.get(
                profile_name) or (dict(DEFAULT_EC_PROFILE)
                                  if profile_name == "default" else None)
            if profile is None:
                raise KeyError(f"no ec profile {profile_name}")
            ec = ec_registry.factory(profile["plugin"], dict(profile),
                                     device=self.device)
            self._ecs[profile_name] = ec
        return ec

    def _split_pgs(self) -> None:
        """PG splitting: when a pool's pg_num grows (pg_autoscaler or
        operator), locally re-home objects whose placement seed now
        folds to a child PG (ref: OSD.cc split handling /
        PG::split_colls — the reference splits collections the same
        way; cross-OSD placement then converges via normal peering/
        recovery)."""
        m = self.osdmap
        for pool_id, pool in m.pools.items():
            old = self._pool_pg_num.get(pool_id)
            self._pool_pg_num[pool_id] = pool.pg_num
            if old is None or pool.pg_num <= old:
                continue
            replicated = pool.type != POOL_TYPE_ERASURE
            prefix = f"pg_{pool_id}."
            for cid in list(self.store.list_collections()):
                if not cid.startswith(prefix):
                    continue
                try:
                    ps = int(cid[len(prefix):], 16)
                except ValueError:
                    continue
                # one batched transaction per source collection: a
                # per-object txn would fsync the KV WAL once per moved
                # object on BlueStore
                txn = Transaction()
                made: set[str] = set()
                moved_to: dict[str, str] = {}     # oid -> child cid
                for oid in list(self.store.collection_list(cid)):
                    if oid.name == "pgmeta":
                        continue
                    raw = m.object_locator_to_pg(oid.name, pool_id)
                    child = pool.raw_pg_to_pg(raw)
                    if child.ps == ps:
                        continue
                    ccid = f"pg_{child}"
                    if ccid not in made and \
                            not self.store.collection_exists(ccid):
                        txn.create_collection(ccid)
                        made.add(ccid)
                    txn.collection_move_rename(cid, oid, ccid, oid)
                    moved_to[oid.name] = ccid
                if moved_to:
                    self._split_pg_log(PG(pool_id, ps), txn, moved_to)
                    if replicated:
                        # snap index + purged cursor follow their
                        # objects (the snap-mapper leg of
                        # PG::split_into)
                        SnapMapper(self.store, cid).split_keys(
                            txn, moved_to)
                if not txn.empty():
                    self.store.queue_transaction(txn)

    def _pg_mapping(self, pg: PG) -> tuple[list[int], int, list[int], int]:
        """`self.osdmap.pg_to_up_acting_osds(pg)`, keeping the raw CRUSH
        result of each placement seed across epochs that leave the CRUSH
        inputs alone.  A pgp_num reseed, a balancer round or a thrash
        brings a burst of pg_temp, upmap and up/down epochs, on each of
        which every PG of the map is mapped again, and the scalar CRUSH
        is nearly all of that cost.  `OSDMap.ingest` changes the weights
        and states in place, so the inputs are copied and compared by
        value: the CRUSH map, the pools, the OSD weights and which OSDs
        exist."""
        m = self.osdmap
        inputs = (m.crush, tuple(m.pools.items()), tuple(m.osd_weight),
                  tuple(s & CEPH_OSD_EXISTS for s in m.osd_state))
        if inputs != self._raw_inputs:
            self._raw_inputs = inputs
            self._raw_cache = {}
        return m.pg_to_up_acting_osds(pg, raw_cache=self._raw_cache)

    def _prior_acting_for(self, pg: PG) -> list[int]:
        """The previous interval's acting set for `pg` from the
        acting-set cache the last _update_pgs pass recorded — the
        PastIntervals-lite prior set (ref: PeeringState::build_prior).
        The cache (not the pre-ingest OSDMap object) is authoritative
        because OSDMap.ingest mutates in place on the incremental
        path.  A split child folds back to its parent's seed; a
        pgp_num reseed resolves under the cached old interval, which
        is exactly where the data still lives."""
        hit = self._acting_hist.get(pg)
        if hit is not None:
            return list(hit)
        old_pg_num = self._acting_hist_pgnum.get(pg.pool, 0)
        if old_pg_num <= 0 or pg.ps < old_pg_num:
            return []
        mask = (1 << cbits(old_pg_num - 1)) - 1
        parent = PG(pg.pool, ceph_stable_mod(pg.ps, old_pg_num, mask))
        return list(self._acting_hist.get(parent, []))

    def _split_pg_log(self, parent: PG, txn: Transaction,
                      moved_to: dict[str, str]) -> None:
        """Split the parent's durable pg_log along with its objects
        (ref: PG::split_into splitting the log): each child gets the
        entries of the objects it received plus the parent's tail, so
        every acting member computes identical child log bounds and
        peering sees real history instead of empty logs."""
        pool = self.osdmap.pools.get(parent.pool)
        st = self.pgs.get(parent)
        if pool is not None and pool.type == POOL_TYPE_ERASURE:
            # the durable EC shard log shares the pgmeta key format
            shard = self._ec_view(parent)
        elif st is not None and isinstance(st.shard,
                                           ReplicatedPGShard):
            shard = st.shard
        else:
            shard = ReplicatedPGShard(parent, self.store, create=False)
        log = shard.pg_log.log
        if not log.entries and log.tail == log.head:
            return
        by_child: dict[str, list] = {}
        keep = []
        for e in log.entries:
            ccid = moved_to.get(e.soid)
            if ccid is None:
                keep.append(e)
            else:
                by_child.setdefault(ccid, []).append(e)
        for ccid, entries in by_child.items():
            txn.touch(ccid, PGMETA)
            txn.omap_setkeys(ccid, PGMETA, dict(
                {_log_key(e.version): wire.encode(e) for e in entries},
                **{_TAIL_KEY: wire.encode(log.tail)}))
        # children that received objects but no log entries still need
        # the tail marker so their info reflects the parent's history
        for ccid in set(moved_to.values()) - set(by_child):
            txn.touch(ccid, PGMETA)
            txn.omap_setkeys(ccid, PGMETA,
                             {_TAIL_KEY: wire.encode(log.tail)})
        if len(keep) != len(log.entries):
            gone = [e for e in log.entries if e.soid in moved_to]
            txn.omap_rmkeys(f"pg_{parent}", PGMETA,
                            [_log_key(e.version) for e in gone])
            log.entries = keep
            log.index()

    def _update_pgs(self) -> None:
        """Instantiate/refresh services for PGs mapped onto this OSD
        (ref: OSD.cc consume_map -> split/instantiate PGs).
        Membership includes the UP set: an up-but-not-acting OSD is a
        backfill target that must hold live PG state to receive pushes
        and cursor-gated writes (the pg_temp case where the old set
        serves while the new up set fills)."""
        m = self.osdmap
        self._split_pgs()
        seen: set[PG] = set()
        acting_now: dict[PG, list[int]] = {}
        for pool_id, pool in m.pools.items():
            replicated = pool.type != POOL_TYPE_ERASURE
            for ps in range(pool.pg_num):
                pg = PG(pool_id, ps)
                up, up_p, acting, acting_p = self._pg_mapping(pg)
                acting = [-1 if o == CRUSH_ITEM_NONE else o
                          for o in acting]
                up = [-1 if o == CRUSH_ITEM_NONE else o for o in up]
                acting_now[pg] = [o for o in acting if o >= 0]
                if self.whoami not in acting and \
                        self.whoami not in up:
                    continue
                seen.add(pg)
                st = self.pgs.get(pg)
                if st is not None and st.acting == acting and \
                        st.up == up and \
                        st.acting_primary == acting_p and \
                        (st.backend is None) == (acting_p != self.whoami):
                    if st.backend is not None:
                        st.backend.epoch = m.epoch
                        if isinstance(st.backend, ReplicatedBackend):
                            st.backend.pool_snap_seq = pool.snap_seq
                            st.backend.pool_snaps = dict(pool.snaps)
                            st.backend.pool_removed_snaps = \
                                set(pool.removed_snaps)
                        if st.peering is not None:
                            # same interval: unwedge phases waiting on
                            # peers that died with this map
                            st.peering.on_map_advance()
                    continue
                old = self.pgs.get(pg)
                prior: list[int] = []
                if old is not None:
                    prior = [o for o in old.acting if o >= 0]
                    if old.peering is not None:
                        old.peering.abort()
                    # a scrub round dies with its interval: hand back
                    # replica slots or they leak past the remap
                    self._release_scrub_slots(pg, old)
                    old.scrub = None
                    if old.backend is not None:
                        # acting change: abort queued ops so clients
                        # see failures and retry, instead of hanging
                        old.backend.fail_in_flight()
                else:
                    prior = self._prior_acting_for(pg)
                st = _PGState()
                st.acting = acting
                st.acting_primary = acting_p
                st.up = up
                if replicated:
                    st.shard = ReplicatedPGShard(pg, self.store)
                    if acting_p == self.whoami:
                        st.backend = ReplicatedBackend(
                            pg, self.whoami, acting, st.shard,
                            send=self._make_send_osd(), epoch=m.epoch,
                            tid_gen=self._tid_gen)
                        st.backend.pool_snap_seq = pool.snap_seq
                        st.backend.pool_snaps = dict(pool.snaps)
                        st.backend.pool_removed_snaps = \
                            set(pool.removed_snaps)
                else:
                    ec = self._ec_plugin(pool.erasure_code_profile
                                         or "default")
                    # acting position, or — for an up-but-not-acting
                    # backfill target — the UP position it will serve
                    # once the pg_temp override clears
                    shard_idx = acting.index(self.whoami) \
                        if self.whoami in acting \
                        else up.index(self.whoami)
                    st.shard = ECPGShard(
                        pg, shard_idx, self.store,
                        ec.get_data_chunk_count(),
                        ec.get_coding_chunk_count(),
                        fabric=self.fabric)
                    if acting_p == self.whoami:
                        st.backend = ECBackend(
                            pg, ec, whoami=self.whoami, acting=acting,
                            local_shard=st.shard,
                            send=self._make_send(pg),
                            epoch=m.epoch, tid_gen=self._tid_gen,
                            fabric=self.fabric,
                            send_osd=self._make_send_osd())
                        # kernel spans (encode/decode) land in the
                        # primary daemon's ring
                        st.backend.tracer = self.tracer
                        # recovery-bandwidth accounting (sub-chunk
                        # repair saving shows up here)
                        st.backend.perf = self.perf
                self.pgs[pg] = st
                if st.backend is None:
                    continue
                # new interval: run the peering statechart (pool-type
                # specific statechart, shared phases + reservations)
                if replicated:
                    st.peering = PGPeering(self, pg, st,
                                           prior_acting=prior)
                else:
                    st.peering = ECPGPeering(self, pg, st,
                                             prior_acting=prior)
                st.peering.start()
        for pg in list(self.pgs):
            if pg not in seen:
                st = self.pgs.pop(pg)
                if st.peering is not None:
                    st.peering.abort()
                self._release_scrub_slots(pg, st)
                if st.backend is not None:
                    st.backend.fail_in_flight()
        # record this interval's acting sets for the NEXT map's
        # prior-set queries (OSDMap.ingest mutates in place, so the
        # map object itself can't serve as history)
        self._acting_hist = acting_now
        self._acting_hist_pgnum = {pid: p.pg_num
                                   for pid, p in m.pools.items()}
        self._notify_strays()

    # ----------------------------------------------------- QoS drain
    def _drain_op_queue(self) -> None:
        """Run every currently-eligible queued item; if a backlog
        remains, arm a timer for the next eligibility instant
        (ref: the dmclock scheduler's next-request clock).  An item
        that raises is logged, as in the reference, and counted in
        `queued_op_failures`: a recovery that died on a kernel fault
        must show, not vanish into the log."""
        while True:
            item = self.op_queue.dequeue()
            if item is None:
                break
            try:
                # queued recovery work touches PG state like a
                # dispatch handler does — and runs on the tick thread
                # or a pacing Timer thread, so it takes the same
                # daemon lock
                with self._lock:
                    item()
            except Exception:
                self.perf.inc("queued_op_failures")
                dout("osd", 0).write("%s: queued op failed: %s",
                                     self.name,
                                     traceback.format_exc())
        nxt = self.op_queue.next_eligible()
        if nxt is None:
            return
        delay = max(0.01, nxt - time.monotonic())
        with self._lock:
            if self._qos_timer is not None:
                return            # one pending timer is enough
            t = threading.Timer(delay, self._qos_timer_fired)
            t.daemon = True
            self._qos_timer = t
            t.start()

    def _qos_timer_fired(self) -> None:
        # clear BEFORE draining: the drain must be able to arm the
        # next timer (checking is_alive() here would see ourselves
        # and wedge the paced backlog forever)
        with self._lock:
            self._qos_timer = None
        self._drain_op_queue()

    def _send_recovery_push(self, pgid, src, oid) -> None:
        """Answer one pulled object with a full-object push (ref:
        ReplicatedBackend::build_push_op).  A pull that finds no view
        to push from is dropped, as in the reference (the puller's
        tick re-drives it), and counted in `recovery_push_errors`."""
        try:
            shard = self._replicated_view(pgid)
        except (KeyError, AttributeError):
            self.perf.inc("recovery_push_errors")
            return
        if not shard.exists(oid):
            return
        data, attrs, omap, hdr = shard.push_payload(oid)
        self.ms.connect(src).send_message(PGPush(
            pgid=pgid, oid=oid, data=data, size=len(data),
            version=shard.object_version(oid),
            attrs=attrs, omap=omap, omap_hdr=hdr,
            clones=shard.clone_payloads(oid)))

    def _replicated_view(self, pg) -> ReplicatedPGShard:
        """Current PG shard, or a transient read-only store view when
        our PG state lags the sender's map (the view never creates the
        collection)."""
        st = self.pgs.get(pg)
        if st is not None and isinstance(st.shard, ReplicatedPGShard):
            return st.shard
        return ReplicatedPGShard(pg, self.store, create=False)

    def _ec_view(self, pg, shard: int | None = None,
                 create: bool = False) -> ECPGShard:
        """Current EC shard, or a CACHED transient store view (a
        prior-interval holder answers peering queries and serves
        chunk reads/pushes from this).  `shard=None` = any index (log
        and inventory views are index-agnostic).  Constructing a
        fresh view per message would re-decode the whole durable pg
        log on the dispatch thread for every push of a burst; the
        cache is dropped on map ingest."""
        st = self.pgs.get(pg)
        if st is not None and isinstance(st.shard, ECPGShard) and \
                (shard is None or st.shard.shard == shard):
            return st.shard
        key = (pg, 0 if shard is None else shard)
        view = self._ec_transients.get(key)
        if view is None:
            view = ECPGShard(pg, key[1], self.store, 0, 0,
                             create=create)
            self._ec_transients[key] = view
        return view

    def _apply_push(self, shard: ReplicatedPGShard, oid: str,
                    data: bytes, version, whiteout: bool,
                    force: bool = False, attrs: dict | None = None,
                    omap: dict | None = None,
                    omap_hdr: bytes = b"",
                    clones: dict | None = None,
                    backfill: bool = False) -> None:
        """Full-object overwrite, but never let an older version clobber
        newer local data (pushes can race regular writes).  `force`
        (scrub repair) overwrites a same-version corrupted copy;
        `backfill` applies unconditionally — the walking primary's
        interval is authoritative even over a divergent local copy
        whose version reads newer (pre-trim history from a dead
        interval), and the cursor gating guarantees no client write
        for this object can race the push."""
        ver = tuple(version) if version else (0, 0)
        inv = shard.inventory().get(oid)
        if not backfill:
            if inv is not None and not force and inv[0] >= ver:
                return
            if inv is not None and force and inv[0] > ver:
                return
        if whiteout:
            shard.apply_write(oid, 0, b"", True, EVersion(*ver), [])
            shard.apply_clone_payloads(oid, clones or {})
            return
        if inv is not None:
            # whiteout first: apply_mutations then recreates from a
            # clean slate, dropping any stale attrs/omap of the old copy
            shard.apply_write(oid, 0, b"", True, None, [])
        muts: list[tuple] = [(mut.M_WRITEFULL, data)]
        if attrs:
            muts.append((mut.M_SETXATTRS, attrs))
        if omap:
            muts.append((mut.M_OMAP_SETKEYS, omap))
        if omap_hdr:
            muts.append((mut.M_OMAP_SETHEADER, omap_hdr))
        shard.apply_mutations(oid, muts, EVersion(*ver), [])
        shard.apply_clone_payloads(oid, clones or {})

    def _handle_push(self, msg: PGPush) -> None:
        st = self.pgs.get(msg.pgid)
        if st is None or not isinstance(st.shard, ReplicatedPGShard):
            # a delayed push for a PG we no longer own must not write
            # into the store (a later scan would report it)
            return
        t0 = time.perf_counter()
        self._apply_push(st.shard, msg.oid, msg.data, msg.version,
                         msg.whiteout, force=msg.force,
                         attrs=msg.attrs, omap=msg.omap,
                         omap_hdr=msg.omap_hdr, clones=msg.clones,
                         backfill=msg.backfill)
        # recovery-class latency: the apply of one push (pure store
        # work)
        self.perf.hobs("op_lat_recovery", time.perf_counter() - t0)
        self.perf.inc("push_in")
        self.perf.inc("push_in_bytes", len(msg.data))
        if msg.backfill:
            self.perf.inc("backfill_push_in")
        if msg.version:
            # clear any missing-set entry this push satisfied (the
            # replica side of recovery bookkeeping)
            st.shard.pg_log.recover_got(
                msg.oid, EVersion(*tuple(msg.version)))
        if st.peering is not None:
            st.peering.on_pull_done(msg.oid)

    def _push_ec_tombstones(self, pg: PG, st: _PGState, oid: str,
                            ver: tuple, targets: list[int]) -> None:
        """Scrub repair's tombstone leg over the acting set (shared
        implementation with the EC peering statechart)."""
        b = st.backend
        spread_tombstones(pg, b.k + b.m, st.shard, self.whoami,
                          self._make_send_osd(), oid, ver,
                          {s: st.acting[s] for s in targets})

    def pgs_recovering(self) -> int:
        # self-locking: called bare by harnesses/tests while the
        # dispatch thread rebuilds self.pgs
        with self._lock:
            return sum(1 for st in self.pgs.values()
                       if st.recovering or st.backfilling)

    # ------------------------------------------- peering statechart glue
    def _replica_merge_log(self, msg: PGLogPush) -> None:
        """Replica side of GetMissing: merge the primary's
        authoritative log (our own divergent entries resolved by the
        five-case machinery, store effects via the rollbacker), then
        report what we now know we lack
        (ref: PG::merge_log on MOSDPGLog + the activate missing
        exchange)."""
        st = self.pgs.get(msg.pgid)
        pool = self.osdmap.pools.get(msg.pgid.pool)
        if isinstance(st.shard if st is not None else None,
                      ECPGShard) or (
                st is None and pool is not None and
                pool.type == POOL_TYPE_ERASURE):
            self._ec_replica_merge_log(msg, st)
            return
        if st is not None and isinstance(st.shard, ReplicatedPGShard):
            shard = st.shard
        else:
            # map lag: we may not know we're acting yet; the merge is
            # durable so the eventual PG state re-loads it
            shard = ReplicatedPGShard(msg.pgid, self.store)
        head = msg.head if msg.head is not None else ZERO_VERSION
        tail = msg.tail if msg.tail is not None else ZERO_VERSION
        if msg.full:
            # wholesale adoption closing a backfill: the walk already
            # made the store match the primary's interval, so the log
            # simply replaces ours (no overlap requirement)
            shard.pg_log.log = IndexedLog(list(msg.entries), head=head,
                                          tail=tail)
            shard.pg_log.log.can_rollback_to = head
            shard.pg_log.missing.items.clear()
            shard.persist_log()
            self.ms.connect(msg.src).send_message(PGMissingReply(
                pgid=msg.pgid, from_osd=self.whoami, epoch=msg.epoch))
            return
        olog = IndexedLog(list(msg.entries), head=head, tail=tail)
        try:
            shard.pg_log.merge_log(olog, StoreRollbacker(shard))
        except ValueError:
            self.ms.connect(msg.src).send_message(PGMissingReply(
                pgid=msg.pgid, from_osd=self.whoami, epoch=msg.epoch,
                no_overlap=True))
            return
        shard.persist_log()
        missing = {oid: (it.need.epoch, it.need.version)
                   for oid, it in shard.pg_log.missing.items.items()}
        self.ms.connect(msg.src).send_message(PGMissingReply(
            pgid=msg.pgid, from_osd=self.whoami, epoch=msg.epoch,
            missing=missing))

    def _ec_replica_merge_log(self, msg: PGLogPush, st) -> None:
        """EC shard side of log activation: adopt/merge the primary's
        authoritative log so every future interval peers from honest
        bounds.  No missing reply — the EC statechart's reconcile
        derives want-lists from shard inventories, not per-peer
        missing exchanges (chunk versions live in OI attrs)."""
        if st is not None and isinstance(st.shard, ECPGShard):
            shard = st.shard
            roll = ECRollbacker(shard)
        else:
            # map lag: durable merge through a transient view; skip
            # rollback side-effects (the shard index is unknown), the
            # reconcile re-delivers authoritative chunks anyway
            shard = self._ec_view(msg.pgid, create=True)

            class _NoRoll(LogEntryHandler):
                def remove(self, soid):
                    pass

                def rollback(self, entry):
                    pass
            roll = _NoRoll()
        head = msg.head if msg.head is not None else ZERO_VERSION
        tail = msg.tail if msg.tail is not None else ZERO_VERSION
        if msg.full:
            shard.pg_log.log = IndexedLog(list(msg.entries), head=head,
                                          tail=tail)
            shard.pg_log.log.can_rollback_to = head
            shard.pg_log.missing.items.clear()
            shard.persist_log()
            return
        olog = IndexedLog(list(msg.entries), head=head, tail=tail)
        try:
            shard.pg_log.merge_log(olog, roll)
        except ValueError:
            return      # no overlap: the reconcile/backfill covers us
        shard.persist_log()

    def _handle_backfill_reserve(self, msg: BackfillReserve) -> None:
        """Both ends of the reservation handshake (ref:
        MBackfillReserve + the AsyncReserver pair: requests past
        capacity queue and are granted as slots free).  Local and
        remote pools are INDEPENDENT — an OSD can drive one backfill
        while serving another; a combined pool deadlocks the moment
        every primary holds local waiting on a saturated remote."""
        key = (msg.pgid, msg.from_osd)
        if msg.op == "request":
            limit = global_config()["osd_max_backfills"]
            if key in self._remote_backfills or \
                    len(self._remote_backfills) < limit:
                self._remote_backfills.add(key)
                self.bf_peak_remote = max(self.bf_peak_remote,
                                          len(self._remote_backfills))
                if not self.ms.connect(msg.src).send_message(
                        BackfillReserve(pgid=msg.pgid,
                                        from_osd=self.whoami,
                                        op="grant")):
                    self._remote_backfills.discard(key)
            elif (key, msg.src) not in self._remote_waitq:
                self._remote_waitq.append((key, msg.src))
            return
        if msg.op == "release":
            self._remote_backfills.discard(key)
            self._remote_waitq = [(k, s) for k, s in self._remote_waitq
                                  if k != key]
            self._grant_queued_reservations()
            return
        st = self.pgs.get(msg.pgid)         # grant | reject
        pr = st.peering if st is not None else None
        consumed = pr.on_reserve(msg) if pr is not None \
            else msg.op != "grant"
        if not consumed:
            # a grant nobody can use (this round was superseded):
            # hand the slot back or it leaks on the target
            self.ms.connect(msg.src).send_message(BackfillReserve(
                pgid=msg.pgid, from_osd=self.whoami, op="release"))

    def _grant_queued_reservations(self) -> None:
        """Capacity freed: grant queued remote requests, then wake
        queued local backfills (FIFO within each class)."""
        limit = global_config()["osd_max_backfills"]
        while self._remote_waitq and len(self._remote_backfills) < limit:
            key, src = self._remote_waitq.pop(0)
            self._remote_backfills.add(key)
            self.bf_peak_remote = max(self.bf_peak_remote,
                                      len(self._remote_backfills))
            if not self.ms.connect(src).send_message(BackfillReserve(
                    pgid=key[0], from_osd=self.whoami, op="grant")):
                self._remote_backfills.discard(key)   # requester died
        while self._local_waitq and len(self._local_backfills) < limit:
            pg = self._local_waitq.pop(0)
            st = self.pgs.get(pg)
            if st is None or st.peering is None:
                continue
            self._local_backfills.add(pg)
            self.bf_peak_local = max(self.bf_peak_local,
                                     len(self._local_backfills))
            st.peering.local_granted()

    def reserve_local_backfill(self, pg: PG) -> bool:
        """True = slot taken now; False = queued, the peering's
        local_granted() fires when capacity frees."""
        if pg in self._local_backfills:
            return True
        limit = global_config()["osd_max_backfills"]
        if len(self._local_backfills) >= limit:
            if pg not in self._local_waitq:
                self._local_waitq.append(pg)
            return False
        self._local_backfills.add(pg)
        self.bf_peak_local = max(self.bf_peak_local,
                                 len(self._local_backfills))
        return True

    def release_local_backfill(self, pg: PG) -> None:
        self._local_backfills.discard(pg)
        if pg in self._local_waitq:
            self._local_waitq.remove(pg)
        self._grant_queued_reservations()

    def request_pg_temp(self, pg: PG, osds: list[int]) -> None:
        """Ask the mon to pin this PG's acting set (ref:
        src/messages/MOSDPGTemp.h; OSDMonitor::prepare_pgtemp)."""
        self.ms.connect(self.mon).send_message(MOSDPGTemp(
            pgid=pg, from_osd=self.whoami, epoch=self.osdmap.epoch,
            osds=list(osds)))

    def clear_pg_temp(self, pg: PG) -> None:
        self.ms.connect(self.mon).send_message(MOSDPGTemp(
            pgid=pg, from_osd=self.whoami, epoch=self.osdmap.epoch,
            osds=[]))

    def _push_object(self, pg: PG, st: _PGState, oid: str, osd: int,
                     backfill: bool = False) -> None:
        """One recovery/backfill push (the peering statechart tracks
        its own completion)."""
        mine = st.shard.inventory()
        if oid not in mine:
            return
        my_ver, whiteout = mine[oid]
        if whiteout:
            data, attrs, omap, hdr = b"", {}, {}, b""
        else:
            data, attrs, omap, hdr = st.shard.push_payload(oid)
        self.perf.inc("recovery_push")
        self.ms.connect(f"osd.{osd}").send_message(PGPush(
            pgid=pg, oid=oid, data=data, size=len(data),
            version=my_ver, whiteout=whiteout, backfill=backfill,
            attrs=attrs, omap=omap, omap_hdr=hdr,
            clones=st.shard.clone_payloads(oid)))

    def _push_whiteout(self, pg: PG, oid: str, osd: int,
                       over_version) -> None:
        """Authoritative delete for a backfill target's stray object
        (divergent leftover the walking primary does not know)."""
        e, v = tuple(over_version)
        self.ms.connect(f"osd.{osd}").send_message(PGPush(
            pgid=pg, oid=oid, data=b"", size=0,
            version=(e, v + 1), whiteout=True, backfill=True))

    def _handle_stray_notify(self, msg: PGNotify) -> None:
        """A stray announced itself (ref: the stray-notify ->
        purge_strays flow in PeeringState::activate/Clean).  If the
        stray holds history we went clean WITHOUT (multi-interval
        churn the one-interval prior set missed), re-peer including
        it; otherwise tell it to delete its copy."""
        st = self.pgs.get(msg.pgid)
        if st is None or st.backend is None or \
                st.acting_primary != self.whoami:
            return
        pr = st.peering
        if pr is None or pr.phase != CLEAN or st.recovering or \
                st.backfilling:
            return        # busy: the stray re-notifies on its tick
        head, _tail = st.shard.log_info()
        if _ev(msg.last_update) > head:
            dout("osd", 1).write(
                "%s: stray osd.%d has newer history for pg %s "
                "(%s > %s): re-peering", self.name, msg.from_osd,
                msg.pgid, msg.last_update, head)
            if isinstance(st.shard, ECPGShard):
                st.peering = ECPGPeering(self, msg.pgid, st,
                                         prior_acting=[msg.from_osd])
            else:
                st.peering = PGPeering(self, msg.pgid, st,
                                       prior_acting=[msg.from_osd])
            st.peering.start()
            return
        self.ms.connect(msg.src).send_message(PGRemove(
            pgid=msg.pgid, epoch=self.osdmap.epoch))

    def _notify_strays(self, rebuild: bool = True) -> None:
        """Announce every PG collection we hold but are no longer
        mapped to (up OR acting) to its current primary — the stray
        side of the purge flow, both pool types.  The candidate scan (store walk +
        CRUSH + log decode) runs only on map ingest; ticks re-send the
        cached notifies so a primary that was mid-peering on the first
        one hears from us again.  Strays get no writes, so the cached
        info cannot go stale; PGRemove drops the cache entry."""
        if rebuild:
            self._stray_notifies = {}
            m = self.osdmap
            for cid in self.store.list_collections():
                if not cid.startswith("pg_") or "." not in cid:
                    continue
                try:
                    pool_part, ps_part = cid[3:].split(".", 1)
                    pg = PG(int(pool_part), int(ps_part, 16))
                except ValueError:
                    continue
                pool = m.pools.get(pg.pool)
                if pool is None or pg.ps >= pool.pg_num:
                    continue
                if pg in self.pgs:
                    continue
                up, _, acting, ap = self._pg_mapping(pg)
                if self.whoami in list(up) + list(acting) or ap < 0 \
                        or ap >= CRUSH_ITEM_NONE:
                    continue
                if not any(o.name != "pgmeta"
                           for o in self.store.collection_list(cid)):
                    continue
                if pool.type == POOL_TYPE_ERASURE:
                    eshard = self._ec_view(pg)
                    head, tail = eshard.log_info()
                    einv = eshard.shard_inventory()
                    self._stray_notifies[pg] = PGNotify(
                        pgid=pg, from_osd=self.whoami, epoch=m.epoch,
                        last_update=head, log_tail=tail,
                        have_data=bool(einv), n_objects=len(einv),
                        stray=True,
                        shards=sorted({s for sm in einv.values()
                                       for s in sm})), ap
                    continue
                shard = self._replicated_view(pg)
                head, tail = shard.log_info()
                inv = shard.inventory()
                self._stray_notifies[pg] = PGNotify(
                    pgid=pg, from_osd=self.whoami, epoch=m.epoch,
                    last_update=head, log_tail=tail,
                    have_data=bool(inv), n_objects=len(inv),
                    stray=True), ap
        for pg, (note, ap) in list(self._stray_notifies.items()):
            self.ms.connect(f"osd.{ap}").send_message(note)

    def _handle_pg_remove(self, msg: PGRemove) -> None:
        """Delete a stray PG copy (ref: MOSDPGRemove ->
        PG::_delete_some).  Refused while our own map still places the
        PG on us — a lagging primary must not void live data."""
        m = self.osdmap
        pool = m.pools.get(msg.pgid.pool)
        if pool is not None:
            up, _, acting, _ = self._pg_mapping(msg.pgid)
            if self.whoami in list(up) + list(acting):
                return
        st = self.pgs.pop(msg.pgid, None)
        if st is not None and st.backend is not None:
            st.backend.fail_in_flight()
        self._stray_notifies.pop(msg.pgid, None)
        cid = pg_cid(msg.pgid)
        if not self.store.collection_exists(cid):
            return
        txn = Transaction()
        for soid in self.store.collection_list(cid):
            txn.remove(cid, soid)
        txn.remove_collection(cid)
        self.store.queue_transaction(txn)
        dout("osd", 4).write("%s: removed stray pg %s", self.name,
                             msg.pgid)

    def _make_send(self, pg: PG):
        def send(shard_idx: int, payload) -> bool:
            st = self.pgs.get(pg)
            if st is None or not (0 <= shard_idx < len(st.acting)):
                return False
            osd = st.acting[shard_idx]
            if osd < 0:
                return False
            return self.ms.connect(f"osd.{osd}").send_message(payload)
        return send

    def _make_send_osd(self):
        """OSD-id addressed send (recovery pushes may target
        up-but-not-acting backfill targets, which have no acting shard
        index)."""
        def send(osd: int, payload) -> bool:
            if osd < 0:
                return False
            return self.ms.connect(f"osd.{osd}").send_message(payload)
        return send

    # ------------------------------------------------------------ scrub
    # Primary-driven deep scrub (ref: src/osd/scrubber/pg_scrubber.cc:
    # collect replica scrub maps, compare against the authoritative
    # copy, optionally repair): replicated PGs compare
    # version/size/crc per copy and repair by forced pushes; EC PGs
    # aggregate each shard's local HashInfo-crc verification and
    # rebuild bad shards through the recovery path (compiled repair,
    # one K1 launch per object).
    def _start_scrub(self, pg: PG, st: _PGState, msg,
                     repair: bool, deep: bool = True,
                     auto: bool = False) -> None:
        if st.scrub is not None:
            self._reply(msg, -16, "EBUSY")
            return
        sc = _ScrubState(msg, repair, deep=deep, auto=auto)
        st.scrub = sc
        sc.maps[self.whoami] = st.shard.scrub_map(deep=deep)
        peers = {o for o in st.acting if o >= 0 and o != self.whoami}
        sc.pending = set(peers)
        for p in peers:
            if not self.ms.connect(f"osd.{p}").send_message(
                    ScrubMapRequest(pgid=pg, deep=deep)):
                # unreachable peer: abort rather than wedge in
                # scrubbing state (retry after the remap settles)
                st.scrub = None
                self._release_scrub_slots(pg, st)
                self._reply(msg, -11, "EAGAIN")
                return
        if not sc.pending:
            self._finish_scrub(pg, st)

    # ---------------------------------------- automatic scrub scheduling
    def _scrubs_driving(self) -> int:
        return sum(1 for st in self.pgs.values()
                   if st.scrub is not None or
                   st.scrub_reserving is not None)

    def _sched_scrub(self, now: float) -> None:
        """Scheduler pass from the heartbeat tick (ref: OSD.cc:7581
        OSD::sched_scrub + PG.cc:4276 PG::sched_scrub): pick ONE due,
        clean, primary PG per tick and start its reservation
        handshake.  Stamps live in the tick's clock domain; a fresh
        PG's first stamp carries a deterministic jitter so a cold
        cluster staggers its first pass (ref: the
        osd_scrub_interval_randomize_ratio idea)."""
        cfg = global_config()
        if not cfg["osd_scrub_auto"]:
            return
        if self._scrubs_driving() >= cfg["osd_max_scrubs"]:
            return
        min_iv = cfg["osd_scrub_min_interval"]
        deep_iv = cfg["osd_deep_scrub_interval"]
        for pg, st in sorted(self.pgs.items()):
            if st.backend is None or st.scrub is not None or \
                    st.scrub_reserving is not None:
                continue
            if st.recovering or st.backfilling:
                continue
            if st.peering is not None and st.peering.phase != CLEAN:
                continue
            if now < st.scrub_backoff_until:
                continue
            if st.last_scrub_stamp is None:
                # deterministic per-PG jitter inside one interval
                j = (hash((pg.pool, pg.ps)) % 1000) / 1000.0
                st.last_scrub_stamp = now - j * min_iv
                st.last_deep_scrub_stamp = now - j * deep_iv
                continue
            deep = now - st.last_deep_scrub_stamp > deep_iv
            if not deep and now - st.last_scrub_stamp <= min_iv:
                continue
            self._begin_auto_scrub(pg, st, deep=deep)
            return              # one new handshake per tick

    def _begin_auto_scrub(self, pg: PG, st: _PGState,
                          deep: bool) -> None:
        peers = {o for o in st.acting
                 if o >= 0 and o != self.whoami and
                 self.osdmap.is_up(o)}
        st.scrub_deep_pending = deep
        st.scrub_granted = set()
        if not peers:
            st.scrub_reserving = None
            self._auto_scrub_go(pg, st)
            return
        st.scrub_reserving = set(peers)
        self.scrub_peak_local = max(self.scrub_peak_local,
                                    self._scrubs_driving())
        for p in peers:
            if not self.ms.connect(f"osd.{p}").send_message(
                    ScrubReserve(pgid=pg, from_osd=self.whoami,
                                 op="request")):
                st.scrub_reserving.discard(p)
        if not st.scrub_reserving:
            st.scrub_reserving = None
            self._auto_scrub_go(pg, st)

    def _auto_scrub_go(self, pg: PG, st: _PGState) -> None:
        deep = st.scrub_deep_pending
        repair = deep and global_config()["osd_scrub_auto_repair"]
        self._start_scrub(pg, st, None, repair=repair, deep=deep,
                          auto=True)

    def _release_scrub_slots(self, pg: PG, st: _PGState) -> None:
        """Release every replica-side slot this round held or asked
        for (granted, still-pending, or in flight)."""
        for p in set(st.scrub_granted) | set(st.scrub_reserving or ()):
            self.ms.connect(f"osd.{p}").send_message(ScrubReserve(
                pgid=pg, from_osd=self.whoami, op="release"))
        st.scrub_reserving = None
        st.scrub_granted = set()

    def _handle_scrub_reserve(self, msg: ScrubReserve) -> None:
        key = (msg.pgid, msg.from_osd)
        if msg.op == "request":
            limit = global_config()["osd_max_scrubs"]
            if key in self._scrubs_remote or \
                    len(self._scrubs_remote) < limit:
                self._scrubs_remote.add(key)
                self.scrub_peak_remote = max(self.scrub_peak_remote,
                                             len(self._scrubs_remote))
                op = "grant"
            else:
                op = "reject"   # saturated: the primary backs off
            self.ms.connect(msg.src).send_message(ScrubReserve(
                pgid=msg.pgid, from_osd=self.whoami, op=op))
            return
        if msg.op == "release":
            self._scrubs_remote.discard(key)
            return
        st = self.pgs.get(msg.pgid)         # grant | reject
        if st is None or st.scrub_reserving is None or \
                msg.from_osd not in st.scrub_reserving:
            if msg.op == "grant":
                # unusable grant: hand the slot back or it leaks
                self.ms.connect(msg.src).send_message(ScrubReserve(
                    pgid=msg.pgid, from_osd=self.whoami, op="release"))
            return
        st.scrub_reserving.discard(msg.from_osd)
        if msg.op == "grant":
            st.scrub_granted.add(msg.from_osd)
            if not st.scrub_reserving:
                st.scrub_reserving = None
                self._auto_scrub_go(msg.pgid, st)
        else:
            # one reject kills the round: release what we hold and
            # back off (ref: the REJECT path re-queuing the scrub)
            self._release_scrub_slots(msg.pgid, st)
            st.scrub_backoff_until = (self._hb_now or 0.0) + \
                global_config()["osd_heartbeat_grace"]

    def _handle_scrub_reply(self, msg: ScrubMapReply) -> None:
        st = self.pgs.get(msg.pgid)
        if st is None or st.scrub is None or \
                msg.from_osd not in st.scrub.pending:
            return
        if msg.absent:
            sc = st.scrub
            st.scrub = None
            self._reply(sc.reply_msg, -11, "EAGAIN")
            return
        st.scrub.pending.discard(msg.from_osd)
        st.scrub.maps[msg.from_osd] = dict(msg.objects)
        if not st.scrub.pending:
            self._finish_scrub(msg.pgid, st)

    def _finish_scrub(self, pg: PG, st: _PGState) -> None:
        # guard against synchronous repair completions firing the
        # client reply while the compare loop is still running
        st.scrub.comparing = True
        try:
            if isinstance(st.shard, ReplicatedPGShard):
                self._scrub_compare_replicated(pg, st)
            else:
                self._scrub_compare_ec(pg, st)
        finally:
            if st.scrub is not None:
                st.scrub.comparing = False
        self._maybe_scrub_done(pg, st)

    @staticmethod
    def _copies_match(a: dict, b: dict) -> bool:
        return (a["version"] == b["version"] and a["size"] == b["size"]
                and a["crc"] == b["crc"]
                and a.get("attrs_crc") == b.get("attrs_crc")
                and a.get("omap_crc") == b.get("omap_crc")
                and a.get("clones_crc") == b.get("clones_crc")
                and a["whiteout"] == b["whiteout"] and b["ok"])

    def _scrub_compare_replicated(self, pg: PG, st: _PGState) -> None:
        sc = st.scrub
        all_oids = sorted({o for m in sc.maps.values() for o in m})
        for oid in all_oids:
            copies = {osd: m[oid] for osd, m in sc.maps.items()
                      if oid in m}
            # authoritative selection: highest version among healthy
            # copies (ref: PrimaryLogPG::be_select_auth_object)
            healthy = {o: c for o, c in copies.items() if c["ok"]}
            if not healthy:
                sc.inconsistent.append(oid)
                sc.unrepairable.append(oid)
                continue
            auth_osd = max(healthy,
                           key=lambda o: (tuple(healthy[o]["version"]),
                                          o == self.whoami))
            auth = healthy[auth_osd]
            bad = [osd for osd in sc.maps
                   if osd not in copies or
                   not self._copies_match(auth, copies[osd])]
            if not bad:
                continue
            sc.inconsistent.append(oid)
            if not sc.repair:
                continue
            if auth_osd != self.whoami:
                # repairing from a remote authority needs a pull the
                # scrub path doesn't do yet
                sc.unrepairable.append(oid)
                continue
            ver = tuple(auth["version"])
            if auth["whiteout"]:
                data, attrs, omap, hdr = b"", {}, {}, b""
            else:
                data, attrs, omap, hdr = st.shard.push_payload(oid)
            clones = st.shard.clone_payloads(oid)
            for osd in bad:
                self.ms.connect(f"osd.{osd}").send_message(PGPush(
                    pgid=pg, oid=oid, data=data, size=len(data),
                    version=ver, whiteout=auth["whiteout"],
                    force=True, attrs=attrs, omap=omap,
                    omap_hdr=hdr, clones=clones))
            sc.repaired += 1    # per object, matching the EC path

    def _scrub_compare_ec(self, pg: PG, st: _PGState) -> None:
        sc = st.scrub
        osd_to_shard = {osd: idx for idx, osd in enumerate(st.acting)
                        if osd >= 0}
        all_oids = sorted({o for m in sc.maps.values() for o in m})
        for oid in all_oids:
            # authoritative (version, whiteout) among healthy entries
            entries = {osd: m[oid] for osd, m in sc.maps.items()
                       if oid in m}
            healthy = [e for e in entries.values() if e["ok"]]
            auth_ver = max((tuple(e.get("version", (0, 0)))
                            for e in healthy), default=(0, 0))
            auth_whiteout = any(
                e.get("whiteout") for e in healthy
                if tuple(e.get("version", (0, 0))) == auth_ver)
            # majority user-xattr digest among healthy current shards
            # (attrs are replicated on every shard, so a divergent
            # digest marks that shard inconsistent)
            attr_counts: dict = {}
            for e in healthy:
                if tuple(e.get("version", (0, 0))) == auth_ver and \
                        e.get("attrs_crc") is not None:
                    attr_counts[e["attrs_crc"]] = \
                        attr_counts.get(e["attrs_crc"], 0) + 1
            auth_attrs = max(attr_counts, key=attr_counts.get) \
                if attr_counts else None
            bad_shards = []
            for osd, m in sc.maps.items():
                e = m.get(oid)
                if e is None or not e["ok"] or \
                        tuple(e.get("version", (0, 0))) < auth_ver or \
                        bool(e.get("whiteout")) != auth_whiteout or \
                        (auth_attrs is not None and not auth_whiteout
                         and e.get("attrs_crc") is not None
                         and e["attrs_crc"] != auth_attrs):
                    bad_shards.append(osd_to_shard[osd])
            if not bad_shards:
                continue
            sc.inconsistent.append(oid)
            if not sc.repair or st.backend is None:
                continue
            if auth_whiteout:
                # the delete is authoritative: spread tombstones, no
                # data reconstruction
                self._push_ec_tombstones(pg, st, oid, auth_ver,
                                         bad_shards)
                sc.repaired += 1
                continue
            if len(bad_shards) > self._ec_m(st):
                sc.unrepairable.append(oid)
                continue
            for s in bad_shards:
                st.backend.peer_missing[s].add(oid, EVersion(*auth_ver))
            sc.repairs_pending += 1

            def on_done(ok, oid=oid, pg=pg, st=st):
                sc2 = st.scrub
                if sc2 is None:
                    return
                sc2.repairs_pending -= 1
                if ok:
                    sc2.repaired += 1
                else:
                    sc2.unrepairable.append(oid)
                self._maybe_scrub_done(pg, st)

            st.backend.recover_object(oid, bad_shards, on_done,
                                      version=EVersion(*auth_ver))

    def _ec_m(self, st: _PGState) -> int:
        return st.backend.m if st.backend is not None else 0

    def _maybe_scrub_done(self, pg: PG, st: _PGState) -> None:
        sc = st.scrub
        if sc is None or sc.pending or sc.repairs_pending or \
                sc.comparing:
            return
        if sc.repair and sc.repaired > 0 and sc.orig is None:
            # repairs were dispatched: chain a VERIFY round that
            # re-collects maps and proves they landed (repair is not
            # fire-and-forget; ref: scrub_finish re-checking through
            # the recovery machinery, src/osd/PG.cc)
            st.scrub = None
            verify = _ScrubState(sc.reply_msg, repair=False,
                                 deep=sc.deep, auto=sc.auto)
            verify.orig = sc
            st.scrub = verify
            verify.maps[self.whoami] = st.shard.scrub_map(deep=sc.deep)
            peers = {o for o in st.acting
                     if o >= 0 and o != self.whoami}
            verify.pending = set(peers)
            for p in peers:
                if not self.ms.connect(f"osd.{p}").send_message(
                        ScrubMapRequest(pgid=pg, deep=sc.deep)):
                    verify.pending.discard(p)
            if not verify.pending:
                self._finish_scrub(pg, st)
            return
        st.scrub = None
        self._release_scrub_slots(pg, st)
        if sc.orig is not None:
            # verify round: the original's repairs count only if this
            # re-scrub came back clean for them
            still_bad = set(sc.inconsistent)
            orig = sc.orig
            verified = [o for o in set(orig.inconsistent)
                        if o not in still_bad]
            result = {
                "inconsistent": sorted(set(orig.inconsistent)),
                "repaired": len([o for o in verified
                                 if o not in set(orig.unrepairable)]),
                "unrepairable": sorted(set(orig.unrepairable) |
                                       still_bad),
                "verified": True,
            }
        else:
            result = {
                "inconsistent": sorted(set(sc.inconsistent)),
                "repaired": sc.repaired,
                "unrepairable": sorted(set(sc.unrepairable)),
            }
        # stamps record WHEN the scrub ran (ref: pg_history_t
        # last_scrub_stamp set at scrub_finish regardless of outcome)
        # — stamping only clean results would re-scrub a persistently
        # unrepairable PG every tick forever
        now = self._hb_now if self._hb_now is not None else 0.0
        st.last_scrub_stamp = now
        if sc.deep:
            st.last_deep_scrub_stamp = now
        self.clog_scrub_result(pg, result)
        self._reply(sc.reply_msg, 0, attrs=result)

    def clog_scrub_result(self, pg: PG, result: dict) -> None:
        """Scrub outcome into the debug log (ref: the scrub-result
        lines PG::scrub_finish emits; the cluster-log client that also
        carries them to the mon is not ported)."""
        if result["inconsistent"]:
            bad = len(result["inconsistent"])
            dout("osd", 0).write(
                "%s: pg %s scrub found %d inconsistent "
                "(repaired=%s unrepairable=%s verified=%s)",
                self.name, pg, bad,
                result["repaired"], result["unrepairable"],
                bool(result.get("verified")))

    # ------------------------------------------------------ heartbeats
    def heartbeat_peers(self) -> set[int]:
        """OSDs sharing PGs with this one (ref: OSD.cc
        maybe_update_heartbeat_peers — PG peers, not the whole
        cluster)."""
        peers: set[int] = set()
        with self._lock:
            for st in self.pgs.values():
                peers.update(o for o in st.acting if o >= 0)
                peers.update(o for o in st.up if o >= 0)
        peers.discard(self.whoami)
        return peers

    def heartbeat_tick(self, now: float | None = None) -> None:
        """Ping peers; report silent ones to the mon after the grace
        window (ref: OSD.cc heartbeat() + heartbeat_check :4583).
        `now` may be simulated time for deterministic tests; stamps
        echo through PingReply so the clocks stay consistent.

        Crash-capturing entry: an unhandled exception (or the
        inject_crash_tick fault) serializes into a crash report —
        posted to the mon while the messenger still lives — and then
        propagates, so the harness reaps the daemon like an abort()."""
        try:
            if self.inject_crash_tick:
                self.inject_crash_tick = False
                raise RuntimeError(
                    "injected crash (osd_debug_inject_crash_tick)")
            self._heartbeat_tick(now)
        except Exception as exc:
            self.crash.capture(exc)
            raise

    def _heartbeat_tick(self, now: float | None = None) -> None:
        self._drain_op_queue()      # paced recovery backlog
        now = time.monotonic() if now is None else now
        self.hbmap.reset_timeout(self._hb_handle)
        # peering retry hooks (backfill reservation backoff) + stray
        # re-notify (a primary that was mid-peering on our first
        # notify hears from us again)
        with self._lock:
            for st in self.pgs.values():
                if st.peering is not None:
                    st.peering.tick(now)
            self._notify_strays(rebuild=False)
            self._sched_scrub(now)
        # work a peering retry just enqueued drains through the QoS
        # queue now (or arms the pacing timer)
        self._drain_op_queue()
        grace = global_config()["osd_heartbeat_grace"]
        # clock-domain sanity: if our own ticks stopped for more than a
        # grace (or time went backwards — e.g. a test switching between
        # real and simulated clocks), everyone gets a fresh window; a
        # daemon that missed its own ticks cannot blame its peers
        # (ref: the osd_heartbeat_min_healthy_ratio self-check idea)
        last_tick = self._hb_now
        if last_tick is not None and (now < last_tick or
                                      now - last_tick > grace):
            self._hb_first.clear()
            self._hb_last.clear()
            self._hb_reported.clear()
        self._hb_now = now
        # periodic pg-stat report (ref: OSD.cc tick -> send MPGStats
        # through the mgr in the reference; direct to the mon here)
        if now - self._last_stat_report >= \
                global_config()["osd_mon_report_interval"] or \
                now < self._last_stat_report:
            self._last_stat_report = now
            self._send_pg_stats(now)
        # mon keepalive: a dead mon only becomes visible when we send
        # to it — the failed send triggers the hunt to the next mon
        # (ref: MonClient tick/keepalive)
        if len(self.mons) > 1:
            self.ms.connect(self.mon).send_message(MMonSubscribe(
                what="osdmap", start=self.osdmap.epoch + 1))
        peers = self.heartbeat_peers()
        # prune state for ex-peers (any of the three maps may hold the
        # only record of a peer that never replied)
        for p in (set(self._hb_last) | set(self._hb_first) |
                  self._hb_reported):
            if p not in peers:
                self._hb_last.pop(p, None)
                self._hb_first.pop(p, None)
                self._hb_reported.discard(p)
        for p in peers:
            self._hb_first.setdefault(p, now)
            self.ms.connect(f"osd.{p}").send_message(
                Ping(epoch=self.osdmap.epoch, stamp=now))
        for p in peers:
            if not self.osdmap.is_up(p):
                self._hb_reported.discard(p)
                continue
            last = self._hb_last.get(p, self._hb_first[p])
            if now - last > grace:
                if p not in self._hb_reported:
                    dout("osd", 1).write(
                        "%s: no reply from osd.%d in %.1fs, reporting",
                        self.name, p, now - last)
                self._hb_reported.add(p)
                self.ms.connect(self.mon).send_message(MOSDFailure(
                    target_osd=p, reporter=self.whoami,
                    failed_for=now - last, epoch=self.osdmap.epoch))
            else:
                self._hb_reported.discard(p)

    # ------------------------------------------------------- pg stats
    def _refresh_msgr_perf(self) -> None:
        """Pull the network's drop total into our counter set
        (LocalNetwork only; TcpNet has no shared drop ledger)."""
        net = getattr(self.ms, "network", None)
        total = getattr(net, "drops_total", None)
        if total is not None:
            self.perf.set("msgr_drops_total", total)

    def _send_pg_stats(self, now: float) -> None:
        """Primary-reported per-PG stats + store usage
        (ref: src/osd/OSD.cc collect_pg_stats / pg_stat_t states
        src/osd/osd_types.cc pg_state_string)."""
        pg_stats: dict[str, dict] = {}
        with self._lock:
            pg_items = list(self.pgs.items())
        for pg, st in pg_items:
            if st.shard is None or st.acting_primary != self.whoami:
                continue
            pool = self.osdmap.pools.get(pg.pool)
            width = pool.size if pool is not None else len(st.acting)
            alive = sum(1 for o in st.acting
                        if 0 <= o < CRUSH_ITEM_NONE)
            state = ["active"]
            if st.recovering:
                state.append("recovering")
            if st.backfilling:
                state.append("backfilling")
            if alive < width:
                state.append("degraded")
            elif not st.recovering and not st.backfilling:
                state.append("clean")
            if st.scrub is not None:
                state.append("scrubbing")
            # one collection pass per PG: client objects, logical
            # bytes, and physical store bytes (EC chunk streams)
            n_objs, nbytes, store_b = st.shard.stat_summary()
            order = ["active", "clean", "degraded", "recovering",
                     "backfilling", "scrubbing"]
            pg_stats[str(pg)] = {
                "state": "+".join(sorted(state, key=order.index)),
                "num_objects": n_objs, "bytes": nbytes,
                "store_bytes": store_b,
                "acting": list(st.acting), "primary": True}
        fs = self.store.statfs()
        self._refresh_msgr_perf()
        self.ms.connect(self.mon).send_message(MPGStats(
            osd=self.whoami, epoch=self.osdmap.epoch, stamp=now,
            pg_stats=pg_stats, kb_total=fs["total"] // 1024,
            kb_used=fs["used"] // 1024,
            kb_avail=fs["available"] // 1024,
            perf=self.perf.dump(),
            # SLOW_OPS feed: aged in-flight ops (count + oldest age);
            # a drained tracker reports count 0, clearing the warning
            # on the mon within one report interval
            slow_ops=self.op_tracker.slow_summary()))

    # ---------------------------------------------------- client ops
    def _reply(self, msg, result: int, errno_name: str = "",
               data: bytes = b"", attrs: dict | None = None) -> None:
        if msg is None:
            return      # scheduler-initiated op: no client to answer
        dur = self.op_tracker.finish((msg.src, msg.tid),
                                     "commit_sent" if result == 0
                                     else f"error:{errno_name}")
        if dur is not None:
            self.perf.hobs("op_lat_client", dur)
        sp = self._op_spans.pop((msg.src, msg.tid), None)
        if sp is not None:
            sp.event("reply_sent" if result == 0
                     else f"error:{errno_name}")
            self.tracer.finish(sp)
        self.ms.connect(msg.src).send_message(OSDOpReply(
            tid=msg.tid, result=result, errno_name=errno_name,
            data=data, attrs=attrs or {}, epoch=self.osdmap.epoch))

    def _handle_client_op(self, msg: OSDOp) -> None:
        st = self.pgs.get(msg.pgid)
        if st is None or st.backend is None or \
                st.acting_primary != self.whoami:
            # not the primary for this pg (stale client map)
            self._reply(msg, -1, "ESTALE")
            return
        if st.recovering:
            # ops wait out recovery via the client's retry machinery
            # (the reference queues them on the PG; ESTALE re-parks the
            # op until the rescan timer retries)
            self._reply(msg, -1, "ESTALE")
            return
        pr = st.peering
        if pr is not None and pr.phase in (GETINFO, GETLOG,
                                           GETMISSING):
            # pre-active peering: the acting set's logs are not
            # reconciled yet, so a write's fan-out could land on shards
            # that will be rolled by log adoption.  The reference parks
            # ops on waiting_for_peered until Active; here ESTALE sends
            # them through the same client rescan-retry as recovery.
            self._reply(msg, -1, "ESTALE")
            return
        self.perf.inc("op")
        if msg.op == "read":
            self.perf.inc("op_r")
        b = st.backend
        try:
            muts = self._op_to_mutations(st, msg)
            if muts is not None:
                self.perf.inc("op_w")
                self.perf.inc("op_w_bytes", mut.mutation_bytes(muts))
                # failed writes answer ESTALE, not EIO: a fan-out that
                # lost a shard mid-map-change may be partially applied,
                # and the client's retry against the re-peered acting
                # set is the converging behavior
                b.submit_transaction(
                    msg.oid, muts,
                    lambda ok, m=msg: self._reply(
                        m, 0 if ok else -116, "" if ok else "ESTALE"),
                    snapc=(msg.args or {}).get("snapc"),
                    trace=msg.trace)
            elif msg.op == "read":
                self._do_read(st, msg)
            elif msg.op == "stat":
                if not self._object_exists(st, msg.oid):
                    self._reply(msg, -2, "ENOENT")
                    return
                self._reply(msg, 0,
                            attrs={"size": b.object_size(msg.oid)})
            elif msg.op in ("getxattr", "getxattrs", "omap_get_vals",
                            "omap_get_keys", "omap_get_vals_by_keys",
                            "omap_get_header"):
                self._do_meta_read(st, msg)
            elif msg.op == "pgls":
                # PG object listing (ref: MOSDOp CEPH_OSD_OP_PGLS /
                # PrimaryLogPG::do_pg_op)
                self._reply(msg, 0,
                            attrs={"objects": st.shard.objects()})
            elif msg.op in ("scrub", "scrub-repair"):
                self._start_scrub(msg.pgid, st, msg,
                                  repair=msg.op == "scrub-repair")
            else:
                self._reply(msg, -22, "EINVAL")
        except MutationError as err:
            self._reply(msg, _ERRNO.get(err.errno_name, -22),
                        err.errno_name)
        except StoreError as err:
            self._reply(msg, _ERRNO.get(err.errno_name, -5),
                        err.errno_name)

    def _op_to_mutations(self, st: _PGState, msg: OSDOp):
        """Translate a client op into its mutation vector, or None for
        non-mutating ops (ref: PrimaryLogPG::do_osd_ops's op switch).
        Raises MutationError/StoreError for precondition failures."""
        op = msg.op
        a = msg.args or {}
        if op == "write":
            muts = [(mut.M_WRITE, msg.offset, msg.data)]
        elif op == "write_full":
            muts = [(mut.M_WRITEFULL, msg.data)]
        elif op == "append":
            muts = [(mut.M_APPEND, msg.data)]
        elif op == "truncate":
            muts = [(mut.M_TRUNCATE, int(a.get("size", msg.offset)))]
        elif op == "zero":
            muts = [(mut.M_ZERO, msg.offset, msg.length)]
        elif op == "delete":
            if not self._object_exists(st, msg.oid):
                raise StoreError("ENOENT", msg.oid)
            muts = [(mut.M_DELETE,)]
        elif op == "create":
            if a.get("exclusive") and self._object_exists(st, msg.oid):
                raise StoreError("EEXIST", msg.oid)
            muts = [(mut.M_CREATE,)]
        elif op == "setxattr":
            muts = [(mut.M_SETXATTRS, {a["name"]: a["value"]})]
        elif op == "rmxattr":
            # ENODATA when absent (ref: PrimaryLogPG CEPH_OSD_OP_RMXATTR)
            st.shard.getxattr(msg.oid, a["name"])
            muts = [(mut.M_RMXATTR, a["name"])]
        elif op == "omap_setkeys":
            muts = [(mut.M_OMAP_SETKEYS, dict(a["kv"]))]
        elif op == "omap_rmkeys":
            muts = [(mut.M_OMAP_RMKEYS, list(a["keys"]))]
        elif op == "omap_clear":
            muts = [(mut.M_OMAP_CLEAR,)]
        elif op == "omap_set_header":
            muts = [(mut.M_OMAP_SETHEADER, a["data"])]
        elif op == "writev":
            # atomic compound mutation vector (ObjectWriteOperation)
            muts = [tuple(m) for m in a["ops"]]
        else:
            return None
        return mut.validate(muts, ec_pool=isinstance(st.shard,
                                                     ECPGShard))

    def _do_meta_read(self, st: _PGState, msg: OSDOp) -> None:
        """xattr/omap reads served from the primary's local shard
        (attrs are on every EC shard; omap is replicated-only)."""
        shard, a = st.shard, msg.args or {}
        ec = isinstance(shard, ECPGShard)
        if msg.op == "getxattr":
            self._reply(msg, 0, attrs={"value": shard.getxattr(
                msg.oid, a["name"])})
        elif msg.op == "getxattrs":
            self._reply(msg, 0, attrs={"xattrs": shard.getxattrs(
                msg.oid)})
        elif ec:
            raise MutationError(
                "EOPNOTSUPP", "erasure-coded pools do not support omap")
        elif msg.op == "omap_get_header":
            self._reply(msg, 0,
                        attrs={"header": shard.omap_get_header(msg.oid)})
        elif msg.op == "omap_get_vals_by_keys":
            vals = shard.omap_get(msg.oid)
            self._reply(msg, 0, attrs={"vals": {
                k: vals[k] for k in a.get("keys", []) if k in vals}})
        else:       # omap_get_vals / omap_get_keys with pagination
            vals = shard.omap_get(msg.oid)
            after = a.get("after", "")
            maxn = int(a.get("max", 1 << 30))
            keys = sorted(k for k in vals if k > after)
            page, more = keys[:maxn], len(keys) > maxn
            if msg.op == "omap_get_keys":
                self._reply(msg, 0, attrs={"keys": page, "more": more})
            else:
                self._reply(msg, 0, attrs={
                    "vals": {k: vals[k] for k in page}, "more": more})

    def _object_exists(self, st: _PGState, oid: str) -> bool:
        return st.shard.exists(oid)

    def _do_read(self, st: _PGState, msg: OSDOp) -> None:
        b = st.backend
        snapid = (msg.args or {}).get("snapid")
        if snapid is not None and not isinstance(
                st.shard, ReplicatedPGShard):
            self._reply(msg, _ERRNO["EOPNOTSUPP"], "EOPNOTSUPP")
            return
        if isinstance(b, ReplicatedBackend):
            try:
                if snapid is not None:
                    res = st.shard.resolve_snap(msg.oid, int(snapid))
                    if res is None:
                        self._reply(msg, -2, "ENOENT")
                        return
                    if res == "head":
                        data = b.read(msg.oid, msg.offset, msg.length)
                    else:
                        data = st.shard.read_clone(
                            msg.oid, res, msg.offset, msg.length)
                else:
                    data = b.read(msg.oid, msg.offset, msg.length)
                self.perf.inc("op_r_bytes", len(data))
                self._reply(msg, 0, data=data)
            except StoreError as err:
                self._reply(msg, -2 if err.errno_name == "ENOENT"
                            else -5, err.errno_name)
            return
        if not self._object_exists(st, msg.oid):
            self._reply(msg, -2, "ENOENT")
            return
        window = None if (msg.offset == 0 and msg.length == 0) \
            else (msg.offset, msg.length)

        def on_complete(results, errors, m=msg):
            if m.oid in errors:
                self._reply(m, -5, errors[m.oid])
            else:
                data = bytes(results.get(m.oid, b""))
                self.perf.inc("op_r_bytes", len(data))
                self._reply(m, 0, data=data)

        b.objects_read_and_reconstruct({msg.oid: window}, on_complete,
                                       trace=msg.trace)
