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
pools: boot and map handling, client ops (writes, reads, stat, xattr
reads), the EC sub-op routing, the EC peering statechart with its log
merge, backfill reservations, pg_temp requests, strays and PG removal,
the mClock op queue, heartbeats and failure reports, pg-stat reports
and the optional device-mesh `fabric`.  Every plugin the daemon builds
lives on its `device` (cuda unless the caller passes `device="cpu"`).
One rule differs: a queued recovery item that raises is logged as in
the reference and also counted in the `queued_op_failures` perf
counter.  Left out: replicated pools (their PGs are not instantiated),
scrub, snap trim, object classes, watch/notify, snapshot ops and omap
reads (a client op the daemon does not carry answers EINVAL), PG split
on pg_num growth, crash capture, the cluster-log client, centralized
config and the heartbeat mute hook.  With a `keyring` the daemon signs
its traffic and verifies inbound (cephx); `start_admin_socket` serves
perf dump, status, config show/get/set and the op tracker's dumps.
The port adds `tick_errors` to the perf counters: the tick errors a
daemon process's loop survived (tools/daemon_main.py).  As the
reference's, the daemon starts on a store that already holds PG
collections, pgmeta omaps and shard logs (a `BlueStore` or
`JournaledStore` mounted on its data dir after a SIGKILL): each PG's
shard takes the collection as it is and loads its durable log, so EC
peering compares real log bounds and rebuilds only what the OSD missed.
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
                            MMonSubscribe, MOSDBoot, MOSDFailure,
                            MOSDPGTemp, MPGStats, OSDOp, OSDOpReply,
                            PGLogPush, PGLogReq, PGNotify, PGQuery,
                            PGRemove, PGScan, PGScanReply, Ping,
                            PingReply)
from ..msg.messenger import Dispatcher, LocalNetwork, Message, Messenger
from ..msg.mon_client import MonHunter
from ..store import MemStore, StoreError, Transaction
from . import mutations as mut
from .ec_backend import (ECBackend, ECPGShard, ec_store_inventory,
                         pg_cid)
from .ec_peering import ECPGPeering, ECRollbacker
from .mutations import MutationError
from .op_queue import MClockQueue
from .osdmap import OSDMap
from .peering import CLEAN, GETINFO, GETLOG, GETMISSING, _ev
from .pg_log import IndexedLog, LogEntryHandler
from .pg_types import ZERO_VERSION
from .types import PG, POOL_TYPE_ERASURE, cbits, ceph_stable_mod

#: errno-name -> numeric result for client replies (ref: the rc values
#: MOSDOpReply carries; errno(3))
_ERRNO = {"ENOENT": -2, "EIO": -5, "EBUSY": -16, "EEXIST": -17,
          "EINVAL": -22, "ENODATA": -61, "EOPNOTSUPP": -95,
          "ESTALE": -116, "ECANCELED": -125}


class _PGState:
    """One PG's services on this OSD."""

    def __init__(self):
        self.shard = None          # ECPGShard
        self.backend = None        # primary-only
        self.acting: list[int] = []
        self.acting_primary = -1
        self.up: list[int] = []
        # peering statechart (primary only): ECPGPeering
        self.peering = None
        self.backfilling = False
        self.recovering = False


# the PG table is shared between the dispatch thread, the tick thread
# and the pacing timer — racecheck asserts every post-publish access
# holds self._lock (the map mutates through reads, so reads count)
@shared_state(only=("pgs",), mutating=("pgs",))
class OSDDaemon(Dispatcher, MonHunter):
    """osd.<id> (ref: src/osd/OSD.h:1036)."""

    def __init__(self, network: LocalNetwork, whoami: int,
                 store: Optional[MemStore] = None, mon="mon.0",
                 threaded: bool = False, perf_collection=None,
                 fabric=None, device=None, keyring=None):
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
        # queued and paced by the two-phase scheduler
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
                    # repair, queued items that raised, and tick errors
                    # a daemon process's loop survived
                    "recovery_full_rebuild", "queued_op_failures",
                    "tick_errors"):
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

    # ------------------------------------------------------------ setup
    def init(self) -> None:
        self.ms.start()
        self.ms.connect(self.mon).send_message(MOSDBoot(osd=self.whoami))
        self.ms.connect(self.mon).send_message(
            MMonSubscribe(what="osdmap", start=1))

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
        from ..common.admin_socket import AdminSocket, register_obs_commands
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
        if isinstance(msg, PGScan):
            # answer from the store even if our map (and PG state) lags
            # the scanner's — an unanswered scan would wedge its
            # recovery; the store view is the authority anyway.  Only
            # EC pools exist in the port: a replicated scan finds no
            # objects.
            if msg.ec:
                reply = PGScanReply(
                    pgid=msg.pgid, from_osd=self.whoami,
                    ec_shards=ec_store_inventory(self.store,
                                                 pg_cid(msg.pgid)))
            else:
                reply = PGScanReply(
                    pgid=msg.pgid, from_osd=self.whoami,
                    ranged=msg.ranged, begin=msg.begin, end=msg.end)
            self.ms.connect(msg.src).send_message(reply)
            return True
        if isinstance(msg, PGScanReply):
            st = self.pgs.get(msg.pgid)
            pr = st.peering if st is not None else None
            if pr is not None and not msg.ranged:
                pr.on_primary_backfill_scan(msg)
            # no peering: a stale reply for a superseded round — drop
            return True
        if isinstance(msg, PGQuery):
            # pg_info from the durable shard log — answerable even
            # with no live PG state (GetInfo queries reach
            # prior-interval holders and map-lagging peers)
            shard = self._ec_view(msg.pgid)
            head, tail = shard.log_info()
            inv = shard.shard_inventory()
            shards = sorted({s for m_ in inv.values() for s in m_})
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
            shard = self._ec_view(msg.pgid)
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
                self._ec_replica_merge_log(msg, self.pgs.get(msg.pgid))
            return True
        if isinstance(msg, BackfillReserve):
            self._handle_backfill_reserve(msg)
            return True
        if isinstance(msg, PGRemove):
            self._handle_pg_remove(msg)
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
            # transient EC views go stale when PG state changes hands
            self._ec_transients.clear()
            self._update_pgs()

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

    def _update_pgs(self) -> None:
        """Instantiate/refresh services for PGs mapped onto this OSD
        (ref: OSD.cc consume_map -> instantiate PGs).  Membership
        includes the UP set: an up-but-not-acting OSD is a backfill
        target that must hold live PG state to receive pushes (the
        pg_temp case where the old set serves while the new up set
        fills)."""
        m = self.osdmap
        seen: set[PG] = set()
        acting_now: dict[PG, list[int]] = {}
        for pool_id, pool in m.pools.items():
            if pool.type != POOL_TYPE_ERASURE:
                continue        # replicated pools are not ported
            for ps in range(pool.pg_num):
                pg = PG(pool_id, ps)
                up, up_p, acting, acting_p = m.pg_to_up_acting_osds(pg)
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
                # new interval: run the peering statechart
                st.peering = ECPGPeering(self, pg, st,
                                         prior_acting=prior)
                st.peering.start()
        for pg in list(self.pgs):
            if pg not in seen:
                st = self.pgs.pop(pg)
                if st.peering is not None:
                    st.peering.abort()
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

    def pgs_recovering(self) -> int:
        # self-locking: called bare by harnesses/tests while the
        # dispatch thread rebuilds self.pgs
        with self._lock:
            return sum(1 for st in self.pgs.values()
                       if st.recovering or st.backfilling)

    # ------------------------------------------- peering statechart glue
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
            st.peering = ECPGPeering(self, msg.pgid, st,
                                     prior_acting=[msg.from_osd])
            st.peering.start()
            return
        self.ms.connect(msg.src).send_message(PGRemove(
            pgid=msg.pgid, epoch=self.osdmap.epoch))

    def _notify_strays(self, rebuild: bool = True) -> None:
        """Announce every EC PG collection we hold but are no longer
        mapped to (up OR acting) to its current primary — the stray
        side of the purge flow.  The candidate scan (store walk +
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
                if pool is None or pg.ps >= pool.pg_num or \
                        pool.type != POOL_TYPE_ERASURE:
                    continue
                if pg in self.pgs:
                    continue
                up, _, acting, ap = m.pg_to_up_acting_osds(pg)
                if self.whoami in list(up) + list(acting) or ap < 0 \
                        or ap >= CRUSH_ITEM_NONE:
                    continue
                if not any(o.name != "pgmeta"
                           for o in self.store.collection_list(cid)):
                    continue
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
        for pg, (note, ap) in list(self._stray_notifies.items()):
            self.ms.connect(f"osd.{ap}").send_message(note)

    def _handle_pg_remove(self, msg: PGRemove) -> None:
        """Delete a stray PG copy (ref: MOSDPGRemove ->
        PG::_delete_some).  Refused while our own map still places the
        PG on us — a lagging primary must not void live data."""
        m = self.osdmap
        pool = m.pools.get(msg.pgid.pool)
        if pool is not None:
            up, _, acting, _ = m.pg_to_up_acting_osds(msg.pgid)
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
        echo through PingReply so the clocks stay consistent."""
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
            # one collection pass per PG: client objects, logical
            # bytes, and physical store bytes (EC chunk streams)
            n_objs, nbytes, store_b = st.shard.stat_summary()
            order = ["active", "clean", "degraded", "recovering",
                     "backfilling"]
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
            elif msg.op in ("getxattr", "getxattrs"):
                self._do_meta_read(st, msg)
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
        return mut.validate(muts, ec_pool=True)

    def _do_meta_read(self, st: _PGState, msg: OSDOp) -> None:
        """xattr reads served from the primary's local shard (attrs
        are on every EC shard)."""
        shard, a = st.shard, msg.args or {}
        if msg.op == "getxattr":
            self._reply(msg, 0, attrs={"value": shard.getxattr(
                msg.oid, a["name"])})
        else:
            self._reply(msg, 0, attrs={"xattrs": shard.getxattrs(
                msg.oid)})

    def _object_exists(self, st: _PGState, oid: str) -> bool:
        return st.shard.exists(oid)

    def _do_read(self, st: _PGState, msg: OSDOp) -> None:
        if (msg.args or {}).get("snapid") is not None:
            self._reply(msg, _ERRNO["EOPNOTSUPP"], "EOPNOTSUPP")
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

        st.backend.objects_read_and_reconstruct(
            {msg.oid: window}, on_complete, trace=msg.trace)
