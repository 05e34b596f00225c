"""PG peering statechart + backfill machinery (replicated pools).

The reference's peering phase machine (ref: src/osd/PG.h:2085-2195 —
the boost::statechart with GetInfo / GetLog / GetMissing / Activating
/ Active{Recovering, Backfilling, Clean}; driven from
src/osd/PeeringState.cc) rebuilt as an explicit phase object owned by
the primary's _PGState:

* **GetInfo** — query pg_info (durable log bounds + data presence)
  from every OSD in the prior set: current up ∪ acting ∪ the previous
  interval's acting set (ref: PastIntervals; prior-set build in
  PeeringState::build_prior).  Peers answer from their persisted
  shard log even without live PG state.
* **GetLog** — choose the authoritative log (newest last_update,
  ref: PeeringState::find_best_info), fetch the segment we lack and
  `merge_log` it (divergent local entries resolved by the five-case
  machinery in pg_log.py, store effects applied via a rollbacker).
  A primary whose log has NO overlap with the authoritative one
  requests a **pg_temp** override from the mon (the data-holding old
  set keeps primacy and serves clients while the new set backfills,
  ref: src/messages/MOSDPGTemp.h + PeeringState choose_acting's
  want_temp) and, in parallel, runs a direct full-copy pull so small
  PGs converge even before the override lands.
* **GetMissing** — replicas with log overlap receive the
  authoritative segment, merge it locally (their own divergence
  handled by the same five-case code), and reply with their missing
  sets (ref: PeeringState::proc_replica_log + activate's missing
  exchange).  Peers with NO overlap (pre-tail last_update, or an
  empty log) become **backfill targets**.
* **Activating/Recovering** — log-based recovery: the primary pulls
  objects from its own missing set, then pushes every (peer, object)
  in peer_missing; client IO resumes when log recovery completes
  (the daemon's existing ESTALE-retry contract).
* **Backfilling** — reservation-gated (osd_max_backfills on BOTH
  ends, ref: src/messages/MBackfillReserve.h REQUEST/GRANT/REJECT +
  the local/remote reservers in PeeringState), then a ranged cursor
  walk: compare the primary's and target's inventories over aligned
  (begin, end] windows of osd_backfill_scan_max objects, push
  stale/missing ones, whiteout-push the target's strays, advance
  last_backfill (ref: PrimaryLogPG::recover_backfill /
  PG::scan_range).  Client writes stay live during backfill: the
  backend fans ops to a backfill target only for objects at or
  before its cursor — later objects are copied by the walk itself
  (ref: last_backfill gating in PrimaryLogPG::issue_repop).
* **Clean** — strays (prior-interval holders no longer in up/acting)
  are told to delete their copy (ref: src/messages/MOSDPGRemove.h);
  a temp primary clears its pg_temp override, flipping the map back
  to the true up set.

EC pools run the same phase machine with shard-aware semantics in
`osd/ec_peering.py` (ECPGPeering): per-shard pg_info from durable EC
shard logs, cross-set chunk sources, and reservation-gated chunk
backfill — sharing this module's phase constants, the daemon's
reservation pools, and the pg_temp plumbing.

The port's copy of `ceph_tpu.osd.peering`, whole, with one rule that
differs: a clean primary whose map pins the PG to exactly its up set
hands the redundant pin back (Ceph's mon drops such pins in
`OSDMap::clean_temps`; the reference keeps them).  A split child (the
daemon's `_split_pgs` on pg_num growth) starts with its parent's objects
and log tail and takes its prior set from its parent's seed; a pgp_num
reseed resolves the prior set under the previous interval, where the
data still lives, so GetInfo queries the old holders, and the strays
they leave are purged by PGRemove once the PG is clean.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from ..common.log import dout
from ..common.options import global_config
from ..crush.types import CRUSH_ITEM_NONE
from ..msg.messages import (BackfillReserve, PGLogPush, PGLogReq,
                            PGNotify, PGPull, PGQuery, PGRemove, PGScan)
from .pg_log import IndexedLog, LogEntryHandler
from .pg_types import EVersion, ZERO_VERSION

if TYPE_CHECKING:  # pragma: no cover
    from .daemon import OSDDaemon

# phases (ref: the statechart's state names)
GETINFO = "getinfo"
GETLOG = "getlog"
GETMISSING = "getmissing"
RECOVERING = "recovering"
WAIT_BACKFILL = "wait_backfill"
BACKFILLING = "backfilling"
CLEAN = "clean"

#: heartbeat ticks a phase may sit without progress before its
#: outstanding messages are re-driven (lost-message recovery)
_RETRY_TICKS = 3


def _ev(v) -> EVersion:
    if v is None:
        return ZERO_VERSION
    if isinstance(v, EVersion):
        return v
    return EVersion(*v)


class StoreRollbacker(LogEntryHandler):
    """Divergence side-effects on the local store: an entry that can't
    roll back removes the object (it re-arrives through recovery at
    the authoritative version; ref: PGLog::LogEntryHandler ->
    PrimaryLogPG::remove_missing_object)."""

    def __init__(self, shard):
        self.shard = shard

    def remove(self, soid: str) -> None:
        from ..store import StoreError
        try:
            self.shard.apply_write(soid, 0, b"", True, None, [])
        except StoreError:
            pass

    def rollback(self, entry) -> None:
        # rollback blobs are not recorded (entries carry
        # rollbackable=False), so statechart case 4 never fires;
        # remove-and-repull is the conservative resolution
        self.remove(entry.soid)


class _Info:
    """One peer's pg_info (ref: pg_info_t reduced to what peering
    consumes)."""

    def __init__(self, osd: int, last_update: EVersion,
                 log_tail: EVersion, have_data: bool):
        self.osd = osd
        self.last_update = last_update
        self.log_tail = log_tail
        self.have_data = have_data

    def __repr__(self):
        return (f"info(osd.{self.osd} lu={self.last_update} "
                f"tail={self.log_tail} data={self.have_data})")


class PGPeering:
    """Primary-side peering statechart for one replicated PG.  All entry
    points run under the daemon lock (message dispatch + tick)."""

    def __init__(self, daemon: "OSDDaemon", pg, st,
                 prior_acting: list[int] | None = None):
        self.d = daemon
        self.pg = pg
        self.st = st
        self.epoch = daemon.osdmap.epoch
        self.phase = GETINFO
        self.prior_acting = [o for o in (prior_acting or []) if o >= 0]
        self.infos: dict[int, _Info] = {}
        self.pending_info: set[int] = set()
        self.auth: _Info | None = None
        self.log_peers: list[int] = []
        self.pending_missing: set[int] = set()
        #: osd -> {oid: EVersion} objects each log-peer lacks
        self.peer_missing: dict[int, dict] = {}
        #: peers needing a full-copy walk (no log overlap)
        self.backfill_targets: list[int] = []
        self.pull_pending: set[str] = set()
        self.push_pending = 0
        #: set while we ourselves full-copy from the auth holder
        self.primary_backfill_from: int | None = None
        #: the auth holder's full log landed (_on_full_log); a primary
        #: backfill may not go clean before this — testing head ==
        #: ZERO_VERSION instead would let a stale non-empty local log
        #: slip through when pulls finish before the log reply
        self._log_adopted = False
        # backfill walk state
        self.bf_target: int | None = None
        self.bf_cursor = ""            # exclusive lower bound
        self.bf_end = ""               # current window's end
        self.bf_final_window = False   # this window drains our list
        self.bf_reserved_local = False
        self.bf_reserved_remote = False
        self.bf_pushes_in_chunk = 0
        #: ticks since the current phase last made progress; the tick
        #: hook re-drives a phase stuck past _RETRY_TICKS (lost
        #: message / dropped connection that never marked the peer
        #: down) — every re-drive is idempotent
        self._phase_ticks = 0

    # ------------------------------------------------------------ util
    def _shard(self):
        return self.st.shard

    def _send(self, osd: int, msg) -> bool:
        return self.d.ms.connect(f"osd.{osd}").send_message(msg)

    def _log(self, lvl: int, fmt: str, *args) -> None:
        dout("pg", lvl).write(
            f"{self.d.name}: pg {self.pg} peering[{self.phase}] " + fmt,
            *args)

    def _up_acting_peers(self) -> list[int]:
        up, _, acting, _ = self.d._pg_mapping(self.pg)
        peers = []
        for o in list(acting) + list(up):
            if 0 <= o < CRUSH_ITEM_NONE and o != self.d.whoami \
                    and o not in peers:
                peers.append(o)
        return peers

    # ---------------------------------------------------------- GetInfo
    def start(self) -> None:
        self.st.recovering = True
        self.st.backfilling = False
        peers = self._up_acting_peers()
        for o in self.prior_acting:
            if o != self.d.whoami and o not in peers:
                peers.append(o)
        peers = [o for o in peers if self.d.osdmap.is_up(o)]
        if not peers:
            self._choose_auth()
            return
        self.pending_info = set(peers)
        self._log(10, "querying %s", peers)
        for o in list(peers):
            if not self._send(o, PGQuery(pgid=self.pg,
                                         epoch=self.epoch)):
                self.pending_info.discard(o)
        if not self.pending_info:
            self._choose_auth()

    def on_info(self, msg: PGNotify) -> None:
        if self.phase != GETINFO or msg.epoch != self.epoch or \
                msg.from_osd not in self.pending_info:
            return
        self._phase_ticks = 0
        self.pending_info.discard(msg.from_osd)
        self.infos[msg.from_osd] = _Info(
            msg.from_osd, _ev(msg.last_update), _ev(msg.log_tail),
            msg.have_data)
        if not self.pending_info:
            self._choose_auth()

    def _my_info(self) -> _Info:
        head, tail = self._shard().log_info()
        return _Info(self.d.whoami, head, tail,
                     bool(self._shard().inventory()))

    def _choose_auth(self) -> None:
        """find_best_info: newest last_update wins, self on ties
        (ref: PeeringState::find_best_info; the longest-log and
        up-primary tiebreaks don't change outcomes here because logs
        share trim policy)."""
        mine = self._my_info()
        best = mine
        for info in self.infos.values():
            if info.last_update > best.last_update:
                best = info
        self.auth = best
        self._log(10, "auth=%r mine=%r", best, mine)
        if best.osd != self.d.whoami and \
                best.last_update > mine.last_update:
            if best.log_tail <= mine.last_update:
                # overlap: fetch just the segment we lack
                self.phase = GETLOG
                if not self._send(best.osd, PGLogReq(
                        pgid=self.pg, since=mine.last_update,
                        epoch=self.epoch)):
                    self._log(1, "auth osd.%d unreachable", best.osd)
                return
            self._primary_backfill(best.osd)
            return
        self._enter_getmissing()

    # ----------------------------------------------------------- GetLog
    def on_auth_log(self, msg: PGLogPush) -> None:
        if msg.full:
            self._on_full_log(msg)
            return
        if self.phase != GETLOG or msg.epoch != self.epoch:
            return
        self._phase_ticks = 0
        shard = self._shard()
        olog = IndexedLog(list(msg.entries), head=_ev(msg.head),
                          tail=_ev(msg.tail))
        try:
            shard.pg_log.merge_log(olog, StoreRollbacker(shard))
        except ValueError:
            # the auth trimmed between info and log reply
            self._primary_backfill(msg.from_osd)
            return
        shard.persist_log()
        self._enter_getmissing()

    def _primary_backfill(self, auth_osd: int) -> None:
        """Our own log has no overlap with the authoritative one.  Two
        converging tracks (whichever lands first wins):

        * ask the mon for pg_temp = the data holder, so IT becomes
          acting primary, serves clients, and backfills US through its
          own statechart (the reference's model — client IO keeps
          flowing);
        * run a direct full-copy pull from the holder, so small PGs
          converge even before the override propagates (clients retry
          on ESTALE meanwhile — the pre-pg_temp availability mode).

        A map flip from the first track tears this round down and the
        holder takes over; completion of the second goes clean and
        clears the override."""
        self.phase = RECOVERING
        self.primary_backfill_from = auth_osd
        holders = sorted(
            o for o, info in self.infos.items()
            if info.last_update == self.infos[auth_osd].last_update
            and self.d.osdmap.is_up(o)) or [auth_osd]
        self.d.request_pg_temp(self.pg, holders)
        self._log(4, "primary backfill from osd.%d (pg_temp=%s)",
                  auth_osd, holders)
        self._send(auth_osd, PGScan(pgid=self.pg, ec=False))

    def on_primary_backfill_scan(self, msg) -> None:
        """Full inventory from the auth holder: pull everything newer,
        drop local objects it does not know (divergent leftovers past
        trimmed history), then adopt its log wholesale."""
        if self.primary_backfill_from != msg.from_osd or \
                self.phase != RECOVERING:
            return
        shard = self._shard()
        mine = shard.inventory()
        theirs = dict(msg.objects)
        rb = StoreRollbacker(shard)
        for oid in set(mine) - set(theirs):
            rb.remove(oid)
        pulls = []
        for oid, (ver, whiteout) in theirs.items():
            my = mine.get(oid, ((0, 0), False))
            if tuple(ver) > tuple(my[0]):
                if whiteout:
                    shard.apply_write(oid, 0, b"", True,
                                      EVersion(*ver), [])
                else:
                    pulls.append(oid)
        self.pull_pending = set(pulls)
        if pulls:
            self.d.perf.inc("recovery_pull", len(pulls))
            self._send(msg.from_osd, PGPull(pgid=self.pg, oids=pulls))
        self._send(msg.from_osd, PGLogReq(
            pgid=self.pg, since=ZERO_VERSION, epoch=self.epoch,
            full=True))

    def _on_full_log(self, msg: PGLogPush) -> None:
        """Wholesale log adoption closing a primary backfill."""
        if self.primary_backfill_from != msg.from_osd or \
                msg.epoch != self.epoch:
            return
        shard = self._shard()
        shard.pg_log.log = IndexedLog(list(msg.entries),
                                      head=_ev(msg.head),
                                      tail=_ev(msg.tail))
        shard.pg_log.log.can_rollback_to = _ev(msg.head)
        shard.persist_log()
        self._log_adopted = True
        self._maybe_pulls_done()

    # ------------------------------------------------------- GetMissing
    def _enter_getmissing(self) -> None:
        self.phase = GETMISSING
        shard = self._shard()
        head, tail = shard.log_info()
        self.log_peers = []
        self.backfill_targets = []
        for o in self._up_acting_peers():
            info = self.infos.get(o)
            if info is None:
                continue
            if head == ZERO_VERSION and \
                    info.last_update == ZERO_VERSION and \
                    not info.have_data:
                continue            # both empty: nothing to recover
            overlap = info.last_update >= tail and \
                info.last_update != ZERO_VERSION
            if overlap:
                self.log_peers.append(o)
            else:
                self.backfill_targets.append(o)
        self.pending_missing = set(self.log_peers)
        self._log(10, "log_peers=%s backfill=%s", self.log_peers,
                  self.backfill_targets)
        entries = list(shard.pg_log.log.entries)
        for o in self.log_peers:
            self._send(o, PGLogPush(
                pgid=self.pg, from_osd=self.d.whoami, entries=entries,
                head=head, tail=tail, activate=True, epoch=self.epoch))
        if not self.pending_missing:
            self._activate()

    def on_missing(self, msg) -> None:
        if self.phase != GETMISSING or msg.epoch != self.epoch or \
                msg.from_osd not in self.pending_missing:
            return
        self._phase_ticks = 0
        self.pending_missing.discard(msg.from_osd)
        if msg.no_overlap:
            self.backfill_targets.append(msg.from_osd)
        else:
            self.peer_missing[msg.from_osd] = {
                oid: _ev(v) for oid, v in msg.missing.items()}
        if not self.pending_missing:
            self._activate()

    # ------------------------------------------------- Active/Recovering
    def _activate(self) -> None:
        self.phase = RECOVERING
        shard = self._shard()
        missing = shard.pg_log.missing
        pulls: dict[int, list[str]] = {}
        for oid, item in list(missing.items.items()):
            if item.is_delete:
                StoreRollbacker(shard).remove(oid)
                missing.rm(oid)
                continue
            holder = self._holder_for(oid, item.need)
            if holder is None:
                self._log(0, "object %s UNFOUND (need %s)", oid,
                          item.need)
                continue
            pulls.setdefault(holder, []).append(oid)
            self.pull_pending.add(oid)
        for osd, oids in pulls.items():
            self.d.perf.inc("recovery_pull", len(oids))
            self._send(osd, PGPull(pgid=self.pg, oids=oids))
        self._maybe_pulls_done()

    def _holder_for(self, oid: str, need: EVersion) -> int | None:
        """A live peer whose log covers `need` and whose own missing
        set does not include the object."""
        for o, info in self.infos.items():
            if info.last_update >= need and \
                    oid not in self.peer_missing.get(o, {}) and \
                    self.d.osdmap.is_up(o):
                return o
        return None

    def on_pull_done(self, oid: str) -> None:
        """A pulled object arrived (the daemon applied it AND ran the
        missing-set recover_got before routing here)."""
        if oid not in self.pull_pending:
            return
        self._phase_ticks = 0
        self.pull_pending.discard(oid)
        self._maybe_pulls_done()

    def _maybe_pulls_done(self) -> None:
        if self.phase != RECOVERING or self.pull_pending:
            return
        if self.primary_backfill_from is not None and \
                not self._log_adopted:
            return      # primary backfill: log adoption still in flight
        jobs = [(oid, osd) for osd, objs in self.peer_missing.items()
                for oid in objs]
        self.push_pending = len(jobs)
        if not jobs:
            self._log_recovery_done()
            return
        for oid, osd in jobs:
            self.d.op_queue.enqueue(
                "recovery",
                lambda oid=oid, osd=osd: self._push_one(oid, osd))
        self.d._drain_op_queue()

    def _push_one(self, oid: str, osd: int) -> None:
        try:
            self.d._push_object(self.pg, self.st, oid, osd)
        finally:
            self.push_pending -= 1
            if self.push_pending <= 0 and self.phase == RECOVERING:
                self._log_recovery_done()

    def _log_recovery_done(self) -> None:
        """Log recovery complete: client IO resumes; backfill targets
        proceed under reservations with IO live."""
        self.st.recovering = False
        if not self.backfill_targets:
            self._enter_clean()
            return
        self.phase = WAIT_BACKFILL
        self.st.backfilling = True
        # install cursor gating BEFORE any backfill traffic: writes
        # fan out to a target only for objects <= its cursor
        b = self.st.backend
        if b is not None:
            for o in self.backfill_targets:
                b.backfill_peers[o] = ""       # nothing copied yet
        self._next_backfill_target()

    # ------------------------------------------------------- Backfilling
    def _next_backfill_target(self) -> None:
        if not self.backfill_targets:
            self._enter_clean()
            return
        self.bf_target = self.backfill_targets[0]
        self.bf_cursor = ""
        self.bf_reserved_remote = False
        self.phase = WAIT_BACKFILL
        self.st.backfilling = True
        if not self.bf_reserved_local and \
                not self.d.reserve_local_backfill(self.pg):
            return          # queued: local_granted() resumes us
        self.bf_reserved_local = True
        self._send(self.bf_target, BackfillReserve(
            pgid=self.pg, from_osd=self.d.whoami, op="request"))

    def local_granted(self) -> None:
        """A queued local reservation came through (AsyncReserver
        callback): proceed to the remote request."""
        if self.phase != WAIT_BACKFILL or self.bf_target is None:
            self.d.release_local_backfill(self.pg)
            return
        self._phase_ticks = 0
        self.bf_reserved_local = True
        self._send(self.bf_target, BackfillReserve(
            pgid=self.pg, from_osd=self.d.whoami, op="request"))

    def on_reserve(self, msg: BackfillReserve) -> bool:
        """Returns False for a grant this round cannot use (superseded
        peering): the caller releases it, or the target's slot leaks
        and jams every later backfill at osd_max_backfills=1.  A
        DUPLICATE grant for the reservation we actively hold (the
        retry tick re-requested, the target re-granted) is consumed
        silently — releasing it would free the in-use slot."""
        if msg.from_osd == self.bf_target and msg.op == "grant" and \
                self.bf_reserved_remote:
            return True                    # duplicate for a held slot
        if self.phase != WAIT_BACKFILL or msg.from_osd != self.bf_target:
            return msg.op != "grant"
        if msg.op == "grant":
            self.bf_reserved_remote = True
            self.phase = BACKFILLING
            self._phase_ticks = 0
            self._log(4, "backfill -> osd.%d starts", self.bf_target)
            self._scan_window()
        elif msg.op == "reject":
            # saturated target (the reference's REJECT_TOOFULL): the
            # retry tick re-requests after the backoff window
            self._phase_ticks = -2 * _RETRY_TICKS
        return True

    def tick(self, now: float) -> None:
        """Stuck-phase re-drive (from heartbeat_tick; `now` may be
        simulated, so pacing is tick-counted, not wall-clock).  Any
        phase whose expected reply got lost — a send that failed, a
        connection that dropped without the peer going down — is
        re-driven idempotently after _RETRY_TICKS."""
        if self.phase == CLEAN:
            return
        self._phase_ticks += 1
        if self._phase_ticks < _RETRY_TICKS:
            return
        self._phase_ticks = 0
        if self.phase == GETINFO and self.pending_info:
            for o in list(self.pending_info):
                if not self._send(o, PGQuery(pgid=self.pg,
                                             epoch=self.epoch)):
                    self.pending_info.discard(o)
            if not self.pending_info:
                self._choose_auth()
        elif self.phase == GETLOG and self.auth is not None:
            self._send(self.auth.osd, PGLogReq(
                pgid=self.pg, since=self._my_info().last_update,
                epoch=self.epoch))
        elif self.phase == GETMISSING and self.pending_missing:
            shard = self._shard()
            head, tail = shard.log_info()
            entries = list(shard.pg_log.log.entries)
            for o in list(self.pending_missing):
                self._send(o, PGLogPush(
                    pgid=self.pg, from_osd=self.d.whoami,
                    entries=entries, head=head, tail=tail,
                    activate=True, epoch=self.epoch))
        elif self.phase == RECOVERING and \
                (self.pull_pending or
                 (self.primary_backfill_from is not None and
                  not self._log_adopted)):
            if self.primary_backfill_from is not None:
                self._send(self.primary_backfill_from,
                           PGScan(pgid=self.pg, ec=False))
            else:
                shard = self._shard()
                missing = shard.pg_log.missing
                by_holder: dict[int, list] = {}
                for oid in list(self.pull_pending):
                    item = missing.items.get(oid)
                    holder = self._holder_for(
                        oid, item.need if item else ZERO_VERSION)
                    if holder is not None:
                        by_holder.setdefault(holder, []).append(oid)
                for osd, oids in by_holder.items():
                    self._send(osd, PGPull(pgid=self.pg, oids=oids))
        elif self.phase == WAIT_BACKFILL and self.bf_target is not None \
                and not self.bf_reserved_remote:
            if not self.bf_reserved_local and \
                    not self.d.reserve_local_backfill(self.pg):
                return
            self.bf_reserved_local = True
            self._send(self.bf_target, BackfillReserve(
                pgid=self.pg, from_osd=self.d.whoami, op="request"))
        elif self.phase == BACKFILLING and \
                self.bf_pushes_in_chunk <= 0:
            # a scan (or its reply) was lost: reissue the window
            self._scan_window()

    def _scan_window(self) -> None:
        """Open the next aligned (begin, end] window: end is our n-th
        object past the cursor, or unbounded on the final window so
        trailing strays on the target surface."""
        n = global_config()["osd_backfill_scan_max"]
        mine = sorted(o for o in self._shard().inventory()
                      if o > self.bf_cursor)
        window = mine[:n]
        self.bf_final_window = len(mine) <= n
        self.bf_end = "" if self.bf_final_window else window[-1]
        self._send(self.bf_target, PGScan(
            pgid=self.pg, ec=False, ranged=True,
            begin=self.bf_cursor, end=self.bf_end))

    def on_backfill_scan(self, msg) -> None:
        """One aligned window of the target's inventory: push what it
        lacks or holds stale, whiteout its strays, advance the cursor
        (ref: PrimaryLogPG::recover_backfill interval comparison)."""
        if self.phase != BACKFILLING or msg.from_osd != self.bf_target \
                or msg.begin != self.bf_cursor or msg.end != self.bf_end:
            return
        self._phase_ticks = 0
        shard = self._shard()
        inv = shard.inventory()
        window = [o for o in sorted(inv) if o > self.bf_cursor and
                  (self.bf_end == "" or o <= self.bf_end)]
        theirs = dict(msg.objects)
        jobs = []
        for oid in window:
            th = theirs.get(oid)
            # push on ANY difference, not just older: a divergent
            # survivor past trimmed history can carry a NEWER version
            # that must not outlive the authoritative interval
            if th is None or tuple(th[0]) != tuple(inv[oid][0]) or \
                    bool(th[1]) != bool(inv[oid][1]):
                jobs.append(oid)
        # target objects in this window that we do not have: divergent
        # strays — whiteout them (a versioned delete outranking the
        # stray's own version)
        for oid, (ver, _wo) in theirs.items():
            if oid not in inv:
                self.d._push_whiteout(self.pg, oid, self.bf_target,
                                      ver)
        self.bf_cursor = window[-1] if window else (self.bf_end or
                                                   self.bf_cursor)
        self.bf_pushes_in_chunk = len(jobs)
        if not jobs:
            self._window_done()
            return
        for oid in jobs:
            self.d.op_queue.enqueue(
                "recovery",
                lambda oid=oid: self._backfill_push(oid))
        self.d._drain_op_queue()

    def _backfill_push(self, oid: str) -> None:
        try:
            self.d._push_object(self.pg, self.st, oid, self.bf_target,
                                backfill=True)
        finally:
            self.bf_pushes_in_chunk -= 1
            if self.bf_pushes_in_chunk <= 0:
                self._window_done()

    def _window_done(self) -> None:
        if self.phase != BACKFILLING:
            return
        # advance write gating only after the window's pushes were
        # sent: a subsequent replica write for an object at or before
        # the cursor rides the same ordered connection as its push
        b = self.st.backend
        target = self.bf_target
        if not self.bf_final_window:
            if b is not None and target in b.backfill_peers:
                b.backfill_peers[target] = self.bf_cursor
            self._scan_window()
            return
        # complete: install the authoritative log on the target (or
        # its pg_info stays pre-tail and every subsequent interval
        # re-walks the whole PG), then drop the gating entry — the
        # target is an ordinary replica now and receives every write
        shard = self._shard()
        head, tail = shard.log_info()
        self._send(target, PGLogPush(
            pgid=self.pg, from_osd=self.d.whoami,
            entries=list(shard.pg_log.log.entries), head=head,
            tail=tail, activate=True, full=True, epoch=self.epoch))
        if b is not None:
            b.backfill_peers.pop(target, None)
        self._log(4, "backfill -> osd.%d complete", target)
        self._send(target, BackfillReserve(
            pgid=self.pg, from_osd=self.d.whoami, op="release"))
        self.bf_reserved_remote = False
        self.backfill_targets.pop(0)
        self.bf_target = None
        self._next_backfill_target()

    # ------------------------------------------------------------ Clean
    def _enter_clean(self) -> None:
        self.phase = CLEAN
        self.st.recovering = False
        self.st.backfilling = False
        if self.bf_reserved_local:
            self.d.release_local_backfill(self.pg)
            self.bf_reserved_local = False
        cleared = False
        if self.primary_backfill_from is not None:
            # direct pull converged first: drop the pg_temp request
            self.d.clear_pg_temp(self.pg)
            self.primary_backfill_from = None
            cleared = True
        up, _, acting, _ = self.d._pg_mapping(self.pg)
        current = {o for o in list(up) + list(acting)
                   if 0 <= o < CRUSH_ITEM_NONE}
        if self.d.whoami in current and set(acting) != set(up):
            # we are the temp primary: hand the interval back
            self.d.clear_pg_temp(self.pg)
        elif not cleared and up and \
                list(self.d.osdmap.pg_temp.get(self.pg, ())) == list(up):
            # a redundant override (the up set came back to it): hand
            # it back (ref: Ceph's OSDMap::clean_temps; the reference
            # keeps it)
            self.d.clear_pg_temp(self.pg)
        for o, info in self.infos.items():
            if o not in current and (info.have_data or
                                     info.last_update != ZERO_VERSION):
                self._send(o, PGRemove(pgid=self.pg,
                                       epoch=self.d.osdmap.epoch))
        self._log(10, "clean")

    # ---------------------------------------------------------- aborts
    def on_map_advance(self) -> None:
        """Same-interval map advance: drop peers that died so a phase
        cannot wedge on a reply that will never come."""
        alive = lambda o: self.d.osdmap.is_up(o)   # noqa: E731
        if self.phase == GETINFO:
            dead = {o for o in self.pending_info if not alive(o)}
            if dead:
                self.pending_info -= dead
                if not self.pending_info:
                    self._choose_auth()
        elif self.phase == GETLOG and self.auth is not None and \
                not alive(self.auth.osd):
            # auth died: re-choose among the survivors
            self.infos.pop(self.auth.osd, None)
            self.phase = GETINFO
            self._choose_auth()
        elif self.phase == GETMISSING:
            dead = {o for o in self.pending_missing if not alive(o)}
            if dead:
                self.pending_missing -= dead
                if not self.pending_missing:
                    self._activate()
        elif self.phase in (WAIT_BACKFILL, BACKFILLING) and \
                self.bf_target is not None and not alive(self.bf_target):
            self.backfill_targets = [o for o in self.backfill_targets
                                     if alive(o)]
            self.bf_target = None
            self.bf_reserved_remote = False
            self._next_backfill_target()

    def abort(self) -> None:
        """A new interval superseded this round: release reservations
        (held OR queued) so the restart — or another PG — can take
        them."""
        self.d.release_local_backfill(self.pg)   # also dequeues
        self.bf_reserved_local = False
        if self.bf_target is not None:
            # release any held/queued remote slot; an unconsumed
            # in-flight grant bounces back via the daemon's
            # release-unconsumed path
            self._send(self.bf_target, BackfillReserve(
                pgid=self.pg, from_osd=self.d.whoami, op="release"))
            self.bf_reserved_remote = False
        self.phase = CLEAN          # inert: no handler acts on us
