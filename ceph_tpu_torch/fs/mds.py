"""MDS: the metadata server rank.

Reference shapes kept (ref: src/mds/MDSRank.cc dispatch;
src/mds/CDir.cc dirfrag storage — directories are RADOS objects whose
omap maps dentry name -> inode; src/mds/MDLog.cc + src/osdc/
Journaler.cc — every metadata mutation is journaled to a RADOS object
before the dirfrag update, and replayed on startup):

* `dir.<ino:x>` objects in the metadata pool hold one directory each:
  omap dentry name -> JSON inode record (primary dentries embed the
  inode, like CDentry::linkage).
* the write-ahead log is a per-rank `journal.Journaler`
  (`journal.mds.<rank>` + framed data objects): each op appends one
  entry (seq, op, omap deltas) BEFORE the dirfrag omap update;
  `mds.meta` tracks `applied_seq` (advanced lazily every few ops, so
  a crash leaves a replay window) and the inode allocator, and the
  rank's journal commit position trims consumed objects.  On boot —
  or standby takeover — the MDS replays entries past applied_seq;
  all deltas are idempotent upserts/deletes, so replay converges
  (ref: MDLog::replay over src/osdc/Journaler.cc).
* high availability (this round, ref: MDSMonitor + FSMap): daemons
  beacon to the mon cluster; a rank whose beacon lapses past
  `mds_beacon_grace` is marked failed and a registered `MDSStandby`
  is promoted through replay -> resolve -> active.  Mutating ops
  record their reply in a per-rank completed-request table
  (`mds.completed.<rank>`) keyed by the client's reqid, so a client
  replaying an unreplied op after failover gets the original answer
  instead of a re-execution (ref: Session::completed_requests).
* File data never touches the MDS: clients stripe `{ino:x}.{objno:08x}`
  objects into the data pool themselves (ref: file_layout_t +
  Striper), and report size growth via setattr like cap flushes.

Single rank, one dispatch at a time.  Round 3 adds the Locker-lite
concurrency model (ref: src/mds/Locker.cc + client caps,
src/messages/MClientCaps.h):

* clients OPEN files and are granted **capabilities**: CAP_CACHE (may
  cache reads) and CAP_EXCL (may buffer writes and own the size);
* a conflicting open triggers **revoke-on-conflict**: the MDS sends
  MClientCaps revokes to the holders and answers the opener EAGAIN;
  holders flush dirty size/caches, ack, and the retried open gets a
  grant consistent with the surviving sharers (two writers -> nobody
  caches, the reference's LOCK_MIX outcome);
* caps are leases, not journaled — they die with the session like the
  reference's session reconnect rebuild.

Hardlinks use the reference's primary/remote dentry split
(ref: CDentry::linkage_t): the first link migrates the embedded inode
into the `mds.itable` omap (ino -> record, the anchor-table analogue)
and both dentries become remote references carrying just the ino;
nlink reaches 0 -> the itable entry dies and the client purges data.

The port's copy of `ceph_tpu.fs.mds`: the same objects, omap records and
journal entries, byte for byte.  The rules that differ (an EOPNOTSUPP
answer to `mksnap` on an erasure-coded data pool, `SWALLOWED`, `perf`)
are in fs/__init__.py.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from collections import Counter

from ..common.backoff import Backoff
from ..common.lockdep import make_lock
import time
import zlib

from ..client import RadosError, WriteOp
from ..common.log import dout
from ..journal import Journaler
from ..msg.messages import (MClientCaps, MClientReply, MClientRequest,
                            MFSMap, MMDSBeacon, MMonCommandAck)
from ..msg.messenger import Dispatcher, Message, Messenger

ROOT_INO = 1
META_OBJ = "mds.meta"
ITABLE_OBJ = "mds.itable"
#: realm table (ref: src/mds/SnapServer.cc's snap table): omap key =
#: realm dir ino -> {name: {"id": snapid, "stamp": t}}
SNAPTABLE_OBJ = "mds.snaptable"
#: subtree authority table (ref: the subtree map MDSRank/Migrator
#: maintain + the ceph.dir.pin export pin): omap key = normalized
#: directory path -> owning rank; longest prefix wins, "/" -> 0
SUBTREE_OBJ = "mds.subtrees"
#: balancer-made subtree assignments (ref: MDBalancer's export
#: decisions): same shape as SUBTREE_OBJ; explicit pins override on
#: path conflicts and are never auto-migrated
AUTO_SUBTREE_OBJ = "mds.auto_subtrees"
#: per-rank load publication for the balancer (ref: mds_load_t
#: exchanged via MHeartbeat in src/mds/MDBalancer.cc)
LOAD_OBJ = "mds.load"
#: in-flight cross-rank rename intents (ref: the slave-request
#: journaling Server::handle_client_rename does for multi-rank
#: renames): omap key = intent id -> json{src, dst, dent, dst_rank}
XRENAME_OBJ = "mds.xrename"
#: per-rank inode-number spaces (ref: each rank's InoTable range):
#: ino = (rank << INO_RANK_SHIFT) | n, so allocations never collide
INO_RANK_SHIFT = 48
#: applied_seq persists every N ops: the gap is the replay window
APPLY_EVERY = 8
#: per-rank completed-request table (ref: the per-session
#: completed_requests the reference journals so a reconnecting client
#: can safely replay an unreplied op): omap key = client entity ->
#: json {reqid: reply}, capped per client
COMPLETED_RETAIN = 16

#: ops that mutate the namespace — replay of these consults the
#: completed table (read ops are naturally replay-safe)
_MUTATING_OPS = frozenset({"mkdir", "create", "setattr", "unlink",
                           "rmdir", "rename", "link", "mksnap",
                           "rmsnap", "set_pin"})

_GID_SEQ = itertools.count(1)

#: swallowed RadosErrors other than ENOENT/EEXIST, by site (the MDS's
#: and the client's best-effort calls)
SWALLOWED: Counter = Counter()


def _swallow(site: str, err: RadosError) -> None:
    if err.errno_name not in ("ENOENT", "EEXIST"):
        SWALLOWED[site] += 1


def _alloc_gid() -> int:
    """Cluster-unique daemon gid (the mds_gid_t analogue): pid-scoped
    so multi-process (TCP) daemons never collide."""
    return (os.getpid() << 20) | next(_GID_SEQ)


def journal_id(rank: int) -> str:
    """The rank's metadata WAL journal id (journal/ naming:
    header `journal.mds.<rank>`, data `journal_data.mds.<rank>.*`)."""
    return f"mds.{rank}"


def completed_obj(rank: int) -> str:
    return f"mds.completed.{rank}"

# capability bits (reduced from src/include/ceph_fs.h CEPH_CAP_*)
CAP_CACHE = 1          # may cache reads
CAP_EXCL = 2           # may buffer writes; cached size is authoritative

_ERRNO = {"ENOENT": -2, "EEXIST": -17, "ENOTDIR": -20, "EISDIR": -21,
          "EROFS": -30, "EXDEV": -18,
          "EINVAL": -22, "ENOTEMPTY": -39, "EAGAIN": -11,
          "EMLINK": -31, "EOPNOTSUPP": -95}


class MDSForward(Exception):
    """Request belongs to another rank's subtree (ref: the
    MDS_OP forward the reference sends when it is not auth)."""

    def __init__(self, rank: int):
        self.rank = rank
        super().__init__(f"forward to mds.{rank}")


class _CrossRankRename(Exception):
    """A rename whose source we own but whose destination another
    rank owns: handled off the dispatch thread through the two-phase
    slave protocol (ref: Server::handle_client_rename:7310 +
    Migrator.h:51 slave requests)."""

    def __init__(self, dst_rank: int):
        self.dst_rank = dst_rank


def snap_dir_obj(snapid: int, ino: int) -> str:
    """Snapped dirfrag: the realm's namespace as captured at mksnap
    (ref: the snapped CDentry versions a SnapRealm preserves)."""
    return f"mds.snapdir.{snapid}.{ino:x}"


def dir_obj(ino: int) -> str:
    return f"dir.{ino:x}"


def dir_frag_obj(ino: int, frag: int) -> str:
    """One fragment of a directory (ref: src/mds/CDir.cc dirfrags —
    a dir's dentries hash across 2^bits RADOS objects once it grows
    past mds_bal_split_size).  Fragment 0 IS the base object: it
    always exists and its omap HEADER records the current bits, so
    every rank resolves the layout from shared state."""
    return dir_obj(ino) if frag == 0 else f"{dir_obj(ino)}.f{frag}"


def name_frag(name: str, bits: int) -> int:
    """dentry -> fragment placement (ref: CDir::pick_dirfrag via
    ceph_str_hash; any stable hash works, split points are ours)."""
    if bits <= 0:
        return 0
    return zlib.crc32(name.encode()) & ((1 << bits) - 1)


class MDSError(Exception):
    def __init__(self, errno_name: str, msg: str = ""):
        self.errno_name = errno_name
        super().__init__(f"{errno_name}: {msg}" if msg else errno_name)


class MDSDaemon(Dispatcher):
    """mds.<rank> (ref: src/mds/MDSDaemon.cc + MDSRank).  Multiple
    ranks serve one filesystem: each rank is authoritative for the
    subtrees pinned to it (SUBTREE_OBJ, default everything -> rank 0),
    forwards requests outside its subtrees, journals to its own
    per-rank journal, and allocates inos from its own range.
    `set_pin` migrates a subtree's authority (the Migrator's export,
    collapsed: metadata already lives in shared RADOS omaps, so only
    serving authority and cap ownership move)."""

    def __init__(self, network, rados, rank: int = 0,
                 metadata_pool: str = "cephfs_metadata",
                 data_pool: str = "cephfs_data",
                 threaded: bool = True, keyring=None,
                 mon=None, gid: int | None = None,
                 crash_dir: str | None = None):
        self.name = f"mds.{rank}"
        self.rank = rank
        self.rados = rados
        # beacon/failover plumbing (ref: MDSDaemon beacon_sender):
        # with `mon` set the daemon announces itself and walks
        # resolve -> active; without it the legacy standalone behavior
        # is unchanged (no beacons, no fsmap)
        self.mons = [mon] if isinstance(mon, str) else list(mon or [])
        self.gid = gid if gid is not None else _alloc_gid()
        self._mds_state = "resolve"
        self._beacon_seq = itertools.count(1)
        self._beacon_stop = threading.Event()
        #: test/fault hook: True = stop sending beacons (a "hung" MDS,
        #: the inject_heartbeat_mute analogue on the OSD)
        self.inject_beacon_mute = False
        self.fsmap_epoch = 0
        self.stopped = False
        for pool in (metadata_pool, data_pool):
            try:
                rados.pool_lookup(pool)
            except RadosError:
                try:
                    rados.pool_create(pool, pg_num=32)
                except RadosError:
                    # raced another booting rank to the create: wait
                    # for the winner's pool to reach our map
                    end = time.monotonic() + 30
                    wait = Backoff(base_s=0.2, cap_s=2.0)
                    while True:
                        try:
                            rados.pool_lookup(pool)
                            break
                        except RadosError:
                            if time.monotonic() >= end:
                                raise
                            wait.sleep()
        self.meta = rados.open_ioctx(metadata_pool)
        self.data_pool = data_pool
        # per-rank WAL over the generic journal library (ref:
        # src/osdc/Journaler.cc — the MDS log IS a Journaler client);
        # the rank itself is the committing client, standby-replay
        # followers tail without registering
        self.jr = Journaler(self.meta, journal_id(rank),
                            client_id=f"rank{rank}")
        self._jpos = (0, 0)
        self._k_applied = "applied_seq" if rank == 0 \
            else f"applied_seq.{rank}"
        self._k_next_ino = "next_ino" if rank == 0 \
            else f"next_ino.{rank}"
        # completed-request table: client -> {reqid: reply} (rebuilt
        # from the omap on boot so a replayed op after failover never
        # re-executes; ref: Session::completed_requests)
        self._completed: dict[str, dict[str, object]] = {}
        self._ino_base = rank << INO_RANK_SHIFT
        self._lock = make_lock(f"mds.{rank}")
        self._seq = 0
        self._next_ino = self._ino_base + ROOT_INO + 1
        self._ops_since_apply = 0
        # capability leases (volatile; ref: Locker + session caps):
        # ino -> {client: capbits}; open intents: ino -> {client: wants_write}
        self._caps: dict[int, dict[str, int]] = {}
        self._opens: dict[int, dict[str, bool]] = {}
        self._chain: list[int] = [ROOT_INO]   # last-resolve dir chain
        self._subtree_cache: dict | None = None
        self._subtree_cache_at = 0.0
        self._pending_revokes: list[tuple[str, MClientCaps]] = []
        self._revoking: dict[tuple[int, str], float] = {}
        # internal thread-liveness watchdog (ref: MDSRank's hbmap
        # reset in dispatch): the dispatch worker arms on the first
        # client request and a wedged dispatch surfaces via asok
        # status instead of silent beacon loss
        from ..common.heartbeat_map import HeartbeatMap
        self.hbmap = HeartbeatMap()
        self._hb_handle = self.hbmap.add_worker(
            f"mds.{rank}.dispatch", grace=60.0, arm=False)
        # MDS-to-MDS slave calls (cross-rank rename): tid -> (event,
        # reply slot); replies ride MClientReply like client traffic
        self._peer_tids = itertools.count(1)
        self._peer_pending: dict[int, tuple] = {}
        # balancer heat: top-level dir -> decayed op count
        # (ref: MDBalancer's per-subtree load)
        self._heat: dict[str, float] = {}
        self._ops_handled = 0
        self._last_bal = 0.0
        self._mkfs_or_replay()
        # subtree-table invalidation channel: set_pin on any rank
        # notifies every MDS to drop its cached pin table
        try:
            self.meta.create(SUBTREE_OBJ)
        except RadosError as err:
            _swallow("init", err)
        self._subtree_watch = None
        try:
            self._subtree_watch = self.meta.watch(SUBTREE_OBJ,
                                                  self._subtree_notify)
        except RadosError as err:
            _swallow("init", err)  # TTL refresh covers a failed watch
        self.ms = Messenger.create(network, self.name,
                                   threaded=threaded)
        if keyring is not None:
            # like the OSD: the MDS holds the service secret, mints its
            # ticket locally, and gates inbound client traffic — an
            # auth-enabled cluster must not leave the metadata server
            # as the one unauthenticated daemon (advisor r3 medium)
            from ..auth import attach_cephx
            attach_cephx(self.ms, self.name, keyring)
        self.ms.add_dispatcher(self)
        # crash capture: dispatch-thread exceptions serialize into the
        # mon crash table, spooled to crash_dir until the mon's ack
        # (the table dedups crash_id, so spool+post lands once)
        from ..common.crash import CrashReporter
        self.crash_reporter = CrashReporter(
            self.name, crash_dir=crash_dir,
            post=self._post_crash_meta)
        self.ms.crash_hook = self.crash_reporter.capture
        #: crash-post targets; defaults to the beacon mons but is
        #: settable independently — a standalone MDS (no beacons, no
        #: fsmap) still reports crashes to the cluster
        self.crash_mons = list(self.mons)
        # op tracking + span ring (ref: MDSDaemon's op_tracker +
        # OpRequest tracing): every client request is tracked, aged
        # ones ride the beacon as the SLOW_OPS feed, and traced
        # requests root a span whose journal/objecter legs nest under
        # the ambient scope
        from ..common.options import global_config
        from ..common.tracked_op import OpTracker
        from ..common.tracing import Tracer
        self.op_tracker = OpTracker(
            history_size=global_config()["osd_op_history_size"])
        self.tracer = Tracer(self.name)
        self.asok = None
        # the tick errors a daemon process's loop survived
        # (tools/daemon_main.py)
        from ..common.perf_counters import PerfCounters
        self.perf = PerfCounters(self.name)
        self.perf.add_u64_counter("tick_errors")

    def start_admin_socket(self, path: str) -> None:
        """`ceph daemon mds.N <cmd>` endpoint (ref:
        MDSDaemon::asok_command)."""
        from ..common.admin_socket import AdminSocket
        from ..common.obs import register_obs_commands
        a = AdminSocket(path)
        register_obs_commands(a, self.op_tracker, self.tracer)
        a.register("perf dump", "dump perf counters",
                   lambda c: (0, self.perf.dump()))
        a.register("status", "daemon status",
                   lambda c: (0, {"whoami": self.rank,
                                  "state": self._mds_state,
                                  "gid": self.gid,
                                  "hbmap_unhealthy":
                                      self.hbmap.get_unhealthy_workers()}))
        a.start()
        self.asok = a

    def _post_crash_meta(self, meta: dict) -> None:
        from ..msg.messages import MMonCommand
        tid = self.crash_reporter.alloc_tid(meta["crash_id"])
        for m in self.crash_mons:
            if self.ms.connect(m).send_message(MMonCommand(
                    tid=tid,
                    cmd={"prefix": "crash post", "meta": meta})):
                return
        self.crash_reporter.forget_tid(tid)   # nothing sent: no ack

    def init(self) -> None:
        self.ms.start()
        # resolve phase off-thread: finish coordinator-crashed
        # cross-rank renames (the slave call needs the messenger
        # live), then go active and keep beaconing
        threading.Thread(target=self._startup_and_beacon,
                         daemon=True).start()

    def _startup_and_beacon(self) -> None:
        """resolve -> active walk + the periodic beacon loop
        (ref: MDSRank::resolve_done/active_start + Beacon::_send)."""
        from ..common.options import global_config
        self._send_beacon()                      # announce "resolve"
        try:
            self._recover_xrenames()
        except Exception as ex:      # noqa: BLE001 — must reach active
            dout("mds", 0).write("%s: resolve recovery failed: %r",
                                 self.name, ex)
        self._mds_state = "active"
        self._send_beacon()
        while self.mons and not self._beacon_stop.wait(
                global_config()["mds_beacon_interval"]):
            self._send_beacon()

    def _send_beacon(self) -> None:
        if not self.mons or self.inject_beacon_mute or self.stopped:
            return
        msg = MMDSBeacon(gid=self.gid, name=self.name, rank=self.rank,
                         state=self._mds_state,
                         seq=next(self._beacon_seq),
                         # SLOW_OPS feed: aged in-flight client
                         # requests; count 0 clears the mon's entry
                         slow_ops=self.op_tracker.slow_summary())
        for m in self.mons:
            if self.ms.connect(m).send_message(msg):
                return

    def _handle_fsmap(self, msg: MFSMap) -> None:
        """Beacon reply / subscription push: stand down when another
        gid holds our rank (the split-brain fence — a muted-but-alive
        daemon must not keep serving after its replacement took over;
        ref: MDSDaemon::handle_mds_map respawning on removal)."""
        if msg.epoch < self.fsmap_epoch:
            return          # stale push must not stand us down
        self.fsmap_epoch = msg.epoch
        m = msg.fsmap
        info = m.ranks.get(self.rank) if m is not None else None
        if info is not None and info.gid and info.gid != self.gid \
                and info.state != "failed" and not self.stopped:
            dout("mds", 0).write(
                "%s: fsmap e%d says gid %d holds our rank (we are "
                "gid %d) — standing down", self.name, msg.epoch,
                info.gid, self.gid)
            # kill() joins the dispatch thread: must run off it
            threading.Thread(target=self.kill, daemon=True).start()

    def kill(self) -> None:
        """Hard stop for tests/standdown: no flush, no journal commit
        — the next holder of the rank replays (the SIGKILL model the
        thrasher uses)."""
        self.stopped = True
        self._beacon_stop.set()
        if self.asok is not None:
            self.asok.shutdown()
            self.asok = None
        if self._subtree_watch is not None:
            try:
                self.meta.unwatch(SUBTREE_OBJ, self._subtree_watch)
            except Exception as ex:
                dout("mds", 10).write(
                    "kill: unwatch failed (already dead): %s", ex)
            self._subtree_watch = None
        self.ms.shutdown()

    def shutdown(self) -> None:
        self.stopped = True
        self._beacon_stop.set()
        if self.asok is not None:
            self.asok.shutdown()
            self.asok = None
        with self._lock:
            self._persist_applied()
        if self._subtree_watch is not None:
            try:
                self.meta.unwatch(SUBTREE_OBJ, self._subtree_watch)
            except Exception as ex:   # noqa: BLE001
                dout("mds", 10).write(
                    "%s: subtree unwatch on shutdown failed: %s",
                    self.name, ex)
            self._subtree_watch = None
        self.ms.shutdown()

    # ------------------------------------------------------ journal/WAL
    def _mkfs_or_replay(self) -> None:
        """(ref: MDSRank boot: journal replay before going active).
        The WAL rides the generic journal library: the rank is a
        registered journal client whose commit position IS the
        applied checkpoint — a takeover (standby promotion after a
        kill) replays the dead holder's tail from that position, with
        idempotent deltas making double-apply safe."""
        self.jr.create()
        self.jr.register_client()
        try:
            meta = self.meta.get_omap_vals(META_OBJ)[0]
        except RadosError:
            # fresh fs: root dir + meta + itable
            # (exclusive create arbitrates racing first-boot ranks:
            # the loser re-reads the winner's state)
            try:
                self.meta.create(META_OBJ, exclusive=True)
            except RadosError:
                meta = self.meta.get_omap_vals(META_OBJ)[0]
            else:
                for obj in (dir_obj(ROOT_INO), ITABLE_OBJ):
                    try:
                        self.meta.create(obj)
                    except RadosError as err:
                        _swallow("mkfs_or_replay", err)
                self.meta.set_omap(META_OBJ, {
                    self._k_applied: b"0",
                    self._k_next_ino:
                        str(self._ino_base + ROOT_INO + 1).encode()})
                self._load_completed()
                return
        applied = int(meta.get(self._k_applied, b"0"))
        self._seq = applied          # stay monotonic across journal trims
        self._next_ino = max(
            self._ino_base + ROOT_INO + 1,
            int(meta.get(self._k_next_ino,
                         str(self._ino_base + ROOT_INO + 1).encode())))
        replayed = [0]

        def handler(_tag, ent):
            self._seq = max(self._seq, ent["seq"])
            self._next_ino = max(self._next_ino,
                                 ent.get("next_ino", 0))
            if ent["seq"] <= applied:
                return
            self._apply_deltas(ent["deltas"])
            replayed[0] += 1

        self._jpos = self.jr.replay(handler)
        if replayed[0]:
            dout("mds", 1).write("%s: replayed %d journal entries",
                                 self.name, replayed[0])
        self._load_completed()
        self._persist_applied()

    def _journal(self, op: str, deltas: list) -> None:
        """Append-then-apply: the WAL entry lands before the dirfrag
        mutation (ref: Journaler::append_entry + flush)."""
        self._seq += 1
        self._jpos = self.jr.append(op, {
            "seq": self._seq, "op": op, "next_ino": self._next_ino,
            "deltas": deltas})
        self._apply_deltas(deltas)
        self._ops_since_apply += 1
        if self._ops_since_apply >= APPLY_EVERY:
            self._persist_applied()

    def _apply_deltas(self, deltas: list) -> None:
        """Idempotent omap upserts/deletes on dirfrag objects."""
        for d in deltas:
            kind, obj = d[0], d[1]
            if kind == "set":
                self.meta.operate(obj, WriteOp().set_omap(
                    {k: v.encode() for k, v in d[2].items()}))
            elif kind == "rm":
                try:
                    self.meta.remove_omap_keys(obj, d[2])
                except RadosError as err:
                    _swallow("apply_deltas", err)
            elif kind == "rmobj":
                try:
                    self.meta.remove(obj)
                except RadosError as err:
                    _swallow("apply_deltas", err)
            elif kind == "mkobj":
                try:
                    self.meta.create(obj)
                except RadosError as err:
                    # replay idempotency (EEXIST)
                    _swallow("apply_deltas", err)
            elif kind == "sethdr":
                self.meta.set_omap_header(obj, d[2].encode())

    def _persist_applied(self) -> None:
        self.meta.set_omap(META_OBJ, {
            self._k_applied: str(self._seq).encode(),
            self._k_next_ino: str(self._next_ino).encode()})
        self._ops_since_apply = 0
        # Checkpoint + trim (ref: MDLog::trim via the Journaler's
        # commit position): everything <= applied_seq is fully
        # applied, so the commit cursor advances and whole data
        # objects behind every client's cursor are reclaimed.
        # Ordering matters — applied_seq persists first; a crash in
        # between just replays already-applied idempotent deltas.
        try:
            self.jr.commit(self._jpos)
            self.jr.trim()
        except RadosError as err:
            # journal may be mid-create on first boot
            _swallow("persist_applied", err)

    # -------------------------------------------- completed requests
    def _load_completed(self) -> None:
        """Rebuild the replay dedup table on boot (a promoted standby
        must answer a dead rank's unreplied ops from it)."""
        try:
            vals, _ = self.meta.get_omap_vals(completed_obj(self.rank))
        except RadosError:
            self._completed = {}
            return
        self._completed = {c: json.loads(v) for c, v in vals.items()}

    def _completed_get(self, client: str, reqid: str):
        ent = self._completed.get(client)
        if ent is None or reqid not in ent:
            return None
        return (ent[reqid],)          # 1-tuple: a None reply is a hit

    def _completed_put(self, client: str, reqid: str, out) -> None:
        """Record the reply BEFORE it goes on the wire: a client that
        never saw it can replay the op and get the same answer
        (ref: the journaled completed_requests table).  Eviction is
        insertion-ordered — comparing reqid sequence numbers across
        session nonces would evict a live session's fresh entries
        before a dead session's stale ones."""
        ent = self._completed.setdefault(client, {})
        ent[reqid] = out
        while len(ent) > COMPLETED_RETAIN:
            del ent[next(iter(ent))]
        obj = completed_obj(self.rank)
        try:
            self.meta.operate(obj, WriteOp().set_omap(
                {client: json.dumps(ent).encode()}))
        except RadosError:
            try:
                self.meta.create(obj)
                self.meta.set_omap(obj, {client:
                                         json.dumps(ent).encode()})
            except RadosError as err:
                # volatile fallback: in-memory table serves
                _swallow("completed_put", err)

    def _replay_tolerate(self, op: str, args: dict, err: MDSError):
        """A replayed mutating op that re-executed into the tiny
        journal-applied-but-completed-unrecorded window: map the
        already-done outcome to success instead of surfacing EEXIST/
        ENOENT to a client that is just retrying its own op.  Only
        reachable for DELIVERED ops whose result was never recorded
        (genuine errors of executed ops replay from the completed
        table; never-delivered retries don't carry the replay flag)."""
        if err.errno_name == "EEXIST":
            if op == "mksnap":
                # answer in the mksnap reply shape: the existing
                # snap's id, not the directory dentry
                _p, _n, dent = self._resolve(args["path"])
                if dent is not None:
                    snaps = self._snaps_of(dent["ino"])
                    name = args.get("name", "")
                    if name in snaps:
                        return {"id": snaps[name]["id"],
                                "name": name}
            elif op in ("mkdir", "link"):
                _p, _n, dent = self._resolve(
                    args.get("path") or args.get("dst") or "/")
                if dent is not None:
                    return self._record_of(dent)
        if err.errno_name == "ENOENT":
            if op in ("unlink", "rmdir", "rmsnap"):
                return {"purge": False} if op == "unlink" else None
            if op == "rename":
                _p, _n, ddent = self._resolve(args["dst"])
                if ddent is not None:
                    return ddent      # already moved
        raise err

    # ------------------------------------------------------- name space
    def _frag_bits(self, ino: int) -> int:
        """Current fragmentation of a directory, from the base
        object's omap header.  Deliberately UNCACHED: the bits are
        shared cluster state (another rank's authority may split a dir
        we later walk for a snapshot), and a stale-cached layout would
        silently drop the suffixed fragments' dentries."""
        try:
            hdr = self.meta.get_omap_header(dir_obj(ino))
        except RadosError:
            return 0
        if not hdr:
            return 0
        try:
            return int(json.loads(hdr).get("bits", 0))
        except (ValueError, AttributeError):
            return 0

    def _dent_obj(self, ino: int, name: str) -> str:
        """The fragment object holding (or due to hold) this dentry."""
        return dir_frag_obj(ino, name_frag(name, self._frag_bits(ino)))

    def _dir_rmobj_deltas(self, ino: int) -> list:
        """rmobj deltas covering EVERY fragment of a directory."""
        bits = self._frag_bits(ino)
        return [("rmobj", dir_frag_obj(ino, f))
                for f in range(1 << bits)]

    def _lookup_dentry(self, ino: int, name: str) -> dict | None:
        """Single-dentry lookup reading only its fragment — the
        resolve fast path (a fragmented dir's full listing would read
        every fragment)."""
        obj = self._dent_obj(ino, name)
        try:
            vals = self.meta.get_omap_vals_by_keys(obj, [name])
        except RadosError:
            if obj == dir_obj(ino):
                raise MDSError("ENOENT", f"dir ino {ino:x}")
            return None       # absent fragment object = no dentry
        return json.loads(vals[name]) if name in vals else None

    def _readdir(self, ino: int) -> dict[str, dict]:
        bits = self._frag_bits(ino)
        out: dict[str, dict] = {}
        for f in range(1 << bits):
            try:
                vals, _ = self.meta.get_omap_vals(dir_frag_obj(ino, f))
            except RadosError:
                if f == 0:
                    raise MDSError("ENOENT", f"dir ino {ino:x}")
                continue      # empty fragment was never materialized
            for k, v in vals.items():
                out[k] = json.loads(v)
        return out

    # ------------------------------------------------- dir fragmentation
    def _refrag(self, ino: int, new_bits: int) -> None:
        """Rewrite a directory into 2^new_bits fragments as ONE
        journaled entry (ref: CDir::split/merge + the EFragment event
        MDLog records — crash mid-refrag replays the whole layout
        change).  Deviation from the reference: fragments stay uniform
        (one global bits per dir) instead of an arbitrary frag tree —
        a split rewrites the whole directory, which is bounded by
        split_size * fragments."""
        old_bits = self._frag_bits(ino)
        if new_bits == old_bits:
            return
        ents = self._readdir(ino)
        buckets: dict[int, dict[str, str]] = {}
        for nm, rec in ents.items():
            buckets.setdefault(name_frag(nm, new_bits),
                               {})[nm] = json.dumps(rec)
        deltas: list = []
        for f in range(1, 1 << old_bits):
            deltas.append(("rmobj", dir_frag_obj(ino, f)))
        gone = [nm for nm in ents if name_frag(nm, new_bits) != 0]
        if gone:
            deltas.append(("rm", dir_obj(ino), gone))
        for f, kv in sorted(buckets.items()):
            if f:
                deltas.append(("mkobj", dir_frag_obj(ino, f)))
            deltas.append(("set", dir_frag_obj(ino, f), kv))
        deltas.append(("sethdr", dir_obj(ino),
                       json.dumps({"bits": new_bits})))
        self._journal("refrag", deltas)
        dout("mds", 4).write("%s: dir %x refrag %d -> %d bits "
                             "(%d dentries)", self.name, ino,
                             old_bits, new_bits, len(ents))

    def _maybe_refrag(self, ino: int, name: str | None = None,
                      removed: bool = False) -> None:
        """Split/merge check after a dentry change (ref:
        MDBalancer::maybe_fragment).  Split looks only at the TOUCHED
        fragment (per-frag threshold, like mds_bal_split_size); merge
        pre-gates on that fragment before paying a full count."""
        from ..common.options import global_config
        cfg = global_config()
        bits = self._frag_bits(ino)
        frag_obj = self._dent_obj(ino, name) if name else dir_obj(ino)
        try:
            vals, _ = self.meta.get_omap_vals(frag_obj)
            n = len(vals)
        except RadosError:
            n = 0
        if not removed:
            if n > int(cfg["mds_bal_split_size"]) and bits < 12:
                self._refrag(ino, bits + 1)
            return
        if bits == 0:
            return
        merge = int(cfg["mds_bal_merge_size"])
        if n * (1 << bits) < merge and \
                len(self._readdir(ino)) < merge:
            self._refrag(ino, 0)

    def _readdir_at(self, ino: int, snapid: int | None) -> dict:
        """Directory listing now, or as captured at `snapid` (the
        snapped dirfrag written by mksnap)."""
        if snapid is None:
            return self._readdir(ino)
        try:
            vals, _ = self.meta.get_omap_vals(snap_dir_obj(snapid,
                                                           ino))
        except RadosError:
            return {}        # dir did not exist at the snap
        return {k: json.loads(v) for k, v in vals.items()}

    def _resolve(self, path: str) -> tuple[int, str, dict | None]:
        """path -> (parent ino, final name, dentry|None)
        (ref: MDCache::path_traverse).  Understands `.snap/<name>`
        components (ref: SnapRealm's snapdir traversal): past one, the
        walk continues through the snapped dirfrags and the final
        dentry carries "snapid".  Side effect: self._chain holds the
        traversed directory-ino chain (root..parent) for snap-context
        resolution — handle_op serializes under the daemon lock."""
        parts = [p for p in path.strip("/").split("/") if p]
        self._chain = [ROOT_INO]
        if not parts:
            return 0, "", {"ino": ROOT_INO, "type": "d"}
        ino = ROOT_INO
        snapid = None
        i = 0
        while i < len(parts):
            comp = parts[i]
            is_last = i == len(parts) - 1
            if comp == ".snap":
                if snapid is not None:
                    raise MDSError("EINVAL", ".snap inside .snap")
                if is_last:
                    # the snapdir pseudo-directory itself
                    return ino, ".snap", {"ino": ino,
                                          "type": "snapdir"}
                name = parts[i + 1]
                snaps = self._snaps_of(ino)
                if name not in snaps:
                    raise MDSError("ENOENT", f".snap/{name}")
                snapid = snaps[name]["id"]
                if i + 1 == len(parts) - 1:
                    # the snap root: the realm dir at that snap
                    return ino, name, {"ino": ino, "type": "d",
                                       "snapid": snapid}
                i += 2
                continue
            if snapid is None:
                # live namespace: read only the dentry's fragment
                d = self._lookup_dentry(ino, comp)
            else:
                d = self._readdir_at(ino, snapid).get(comp)
            if is_last:
                if d is not None and snapid is not None:
                    d = dict(d)
                    d["snapid"] = snapid
                return ino, comp, d
            if d is None:
                raise MDSError("ENOENT", "/".join(parts[:i + 1]))
            if d["type"] != "d":
                raise MDSError("ENOTDIR", comp)
            ino = d["ino"]
            self._chain.append(ino)
            i += 1
        raise MDSError("EINVAL", path)     # unreachable

    # ------------------------------------------------------- snaprealms
    def _snaps_of(self, ino: int) -> dict[str, dict]:
        """Realm snaps of a directory ino (ref: SnapRealm::srnode)."""
        try:
            vals = self.meta.get_omap_vals_by_keys(SNAPTABLE_OBJ,
                                                   [str(ino)])
        except RadosError:
            return {}
        raw = vals.get(str(ino))
        return json.loads(raw) if raw is not None else {}

    def _snapc_for_chain(self, chain: list[int]) -> dict | None:
        """The snap context a file under this directory chain writes
        with (ref: SnapRealm::get_snap_context — the union of every
        ancestor realm's snapids; self-managed, so it exists only in
        the client's snapc, the librbd model)."""
        ids: set[int] = set()
        for ino in chain:
            for ent in self._snaps_of(ino).values():
                ids.add(ent["id"])
        if not ids:
            return None
        return {"seq": max(ids), "snaps": sorted(ids, reverse=True)}

    def _walk_realm(self, realm: int) -> list[tuple[int, dict, list]]:
        """Subtree walk from the realm dir: [(dir ino, entries with
        remote dentries materialized, chain-below-realm)].  Remote
        (hardlink) dentries are resolved NOW so the snapped dirfrag
        freezes the inode state at snap time."""
        out = []
        stack = [(realm, [realm])]
        while stack:
            ino, chain = stack.pop()
            ents = {}
            for name, d in self._readdir(ino).items():
                if "remote" in d:
                    rec = self._iget(d["remote"])
                    ents[name] = dict(rec) if rec is not None else d
                else:
                    ents[name] = d
                if d.get("type") == "d":
                    stack.append((d["ino"], chain + [d["ino"]]))
            out.append((ino, ents, chain))
        return out

    def _alloc_snapid(self) -> int:
        """Allocate a self-managed snapid on the data pool (ref:
        SnapServer's table; riding the pool's self-managed allocator
        keeps removed-snap bookkeeping on the OSD path)."""
        return self.rados.open_ioctx(self.data_pool) \
            .selfmanaged_snap_create()

    def _op_mksnap(self, a):
        """Create a realm snapshot (ref: Server::handle_client_mksnap
        + SnapRealm COW).  EAGAIN while EXCL holders under the realm
        still buffer sizes — the client retries after the revokes
        flush them, so the snapped dirfrags capture true sizes."""
        _p, _n, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent.get("snapid") is not None or dent["type"] != "d":
            raise MDSError("EINVAL", a["path"])
        name = a.get("name", "")
        if not name or "/" in name or name == ".snap":
            raise MDSError("EINVAL", f"snap name {name!r}")
        realm = dent["ino"]
        realm_chain = self._chain + [realm]
        snaps = self._snaps_of(realm)
        if name in snaps:
            raise MDSError("EEXIST", name)
        walk = self._walk_realm(realm)
        # flush gate: any EXCL holder's buffered size would be frozen
        # stale into the snap
        excl = []
        for _ino, ents, _chain in walk:
            for d in ents.values():
                if d.get("type") != "f":
                    continue
                holders = [c for c, b in
                           self._caps.get(d["ino"], {}).items()
                           if b & CAP_EXCL]
                if holders:
                    excl.append((d["ino"], holders))
        if excl:
            for ino, holders in excl:
                self._queue_revoke(ino, holders)
            raise MDSError("EAGAIN", "flushing EXCL holders")
        try:
            snapid = self._alloc_snapid()
        except RadosError as err:
            # an erasure-coded data pool refuses self-managed snaps:
            # answer the client instead of raising on the dispatch
            # thread
            raise MDSError(err.errno_name or "EIO", "mksnap") from err
        snaps = dict(snaps)
        snaps[name] = {"id": snapid, "stamp": time.time(),
                       "dirs": [ino for ino, _e, _c in walk]}
        deltas = [("set", SNAPTABLE_OBJ, {str(realm):
                                          json.dumps(snaps)})]
        for ino, ents, _chain in walk:
            obj = snap_dir_obj(snapid, ino)
            deltas.append(("mkobj", obj))
            if ents:
                deltas.append(("set", obj,
                               {k: json.dumps(v)
                                for k, v in ents.items()}))
        self._journal("mksnap", deltas)
        # push the widened snap context to every open handle under the
        # realm (ref: the SnapRealm update broadcast): without it their
        # next write carries the old snapc and the OSD never COWs for
        # this snap
        prefix = realm_chain[:-1]
        for ino, ents, chain in walk:
            snapc = None          # one computation per directory
            for d in ents.values():
                if d.get("type") != "f" or \
                        d["ino"] not in self._opens:
                    continue
                if snapc is None:
                    snapc = self._snapc_for_chain(prefix + chain)
                for client in self._opens[d["ino"]]:
                    # the getattr dispatch in handle_op hides its caller
                    # from the call graph
                    # cephck: ignore[guarded-by] every _op_* runs under handle_op's self._lock
                    self._pending_revokes.append((client, MClientCaps(
                        op="snapc", ino=d["ino"], snapc=snapc)))
        return {"id": snapid, "name": name}

    def _op_rmsnap(self, a):
        """(ref: Server::handle_client_rmsnap; the snapid joins the
        pool's removed set so OSD snap contexts stop carrying it)."""
        _p, _n, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent.get("snapid") is not None or dent["type"] != "d":
            raise MDSError("EINVAL", a["path"])
        realm = dent["ino"]
        snaps = dict(self._snaps_of(realm))
        ent = snaps.pop(a.get("name", ""), None)
        if ent is None:
            raise MDSError("ENOENT", a.get("name", ""))
        deltas = [("set", SNAPTABLE_OBJ,
                   {str(realm): json.dumps(snaps)})]
        for ino in ent.get("dirs", []):
            deltas.append(("rmobj", snap_dir_obj(ent["id"], ino)))
        self._journal("rmsnap", deltas)
        try:
            self.rados.open_ioctx(self.data_pool) \
                .selfmanaged_snap_remove(ent["id"])
        except RadosError as err:
            # snapid leak on failure: ids are never reused
            _swallow("op_rmsnap", err)
        return None

    def _op_lssnap(self, a):
        _p, _n, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent["type"] not in ("d", "snapdir"):
            raise MDSError("ENOTDIR", a["path"])
        return self._snaps_of(dent["ino"])

    def _alloc_ino(self) -> int:
        ino = self._next_ino
        self._next_ino += 1
        return ino

    # ------------------------------------------- hardlinks / itable
    def _iget(self, ino: int) -> dict | None:
        """itable record for a multiply-linked inode."""
        try:
            vals = self.meta.get_omap_vals_by_keys(ITABLE_OBJ,
                                                   [str(ino)])
        except RadosError:
            return None
        raw = vals.get(str(ino))
        return json.loads(raw) if raw is not None else None

    def _record_of(self, dent: dict) -> dict:
        """Resolve a dentry to its inode record — remote dentries
        (ref: CDentry remote linkage) indirect through the itable."""
        if dent is not None and "remote" in dent:
            rec = self._iget(dent["remote"])
            if rec is None:
                raise MDSError("ENOENT", f"ino {dent['remote']:x}")
            return rec
        return dent

    def _update_record(self, parent: int, name: str, dent: dict,
                       rec: dict, op: str) -> None:
        """Persist an updated inode record where it lives: the itable
        for remote dentries, the primary dentry otherwise."""
        if "remote" in dent:
            self._journal(op, [("set", ITABLE_OBJ,
                                {str(dent["remote"]): json.dumps(rec)})])
        else:
            self._journal(op, [("set", self._dent_obj(parent, name),
                                {name: json.dumps(rec)})])

    # --------------------------------------------------- capabilities
    #: unacked revoke grace before caps are force-dropped (the session
    #: timeout analogue, ref: mds_session_autoclose)
    REVOKE_GRACE = 5.0

    def _queue_revoke(self, ino: int, clients) -> None:
        now = time.monotonic()
        for c in clients:
            key = (ino, c)
            started = self._revoking.setdefault(key, now)
            if now - started > self.REVOKE_GRACE:
                # client never acked (dead/hung): force-drop its caps
                # and session so the opener can make progress
                self._caps.get(ino, {}).pop(c, None)
                self._opens.get(ino, {}).pop(c, None)
                self._revoking.pop(key, None)
                continue
            # callers: the _op_* dispatch of handle_op (a getattr the
            # call graph cannot follow), _revoke_and_wait and the moves'
            # _evict_moved, each under the lock
            # cephck: ignore[guarded-by] every caller holds self._lock
            self._pending_revokes.append((c, MClientCaps(
                op="revoke", ino=ino,
                caps=self._caps.get(ino, {}).get(c, 0))))

    def _grant_caps(self, ino: int, client: str,
                    wants_write: bool) -> int:
        """Revoke-on-conflict grant (ref: Locker file lock states,
        collapsed): raises EAGAIN after queueing revokes."""
        other_caps = {c: b for c, b in self._caps.get(ino, {}).items()
                      if c != client and b}
        others = {c: w for c, w in self._opens.get(ino, {}).items()
                  if c != client}
        if wants_write:
            if other_caps:
                self._queue_revoke(ino, other_caps)
                raise MDSError("EAGAIN", "caps being revoked")
            caps = (CAP_EXCL | CAP_CACHE) if not others else 0
        else:
            excl = [c for c, b in other_caps.items() if b & CAP_EXCL]
            if excl:
                self._queue_revoke(ino, excl)
                raise MDSError("EAGAIN", "caps being revoked")
            caps = CAP_CACHE if not any(others.values()) else 0
        self._opens.setdefault(ino, {})[client] = wants_write
        if caps:
            self._caps.setdefault(ino, {})[client] = caps
        else:
            self._caps.get(ino, {}).pop(client, None)
        return caps

    def handle_caps(self, msg: MClientCaps) -> None:
        """Client returned caps (ack after flushing dirty state)."""
        with self._lock:
            if msg.op == "ack":
                m = self._caps.get(msg.ino)
                if m is not None:
                    m.pop(msg.src, None)
                self._revoking.pop((msg.ino, msg.src), None)

    # --------------------------------------------- subtree authority
    @staticmethod
    def _norm(path: str) -> str:
        return "/" + "/".join(p for p in path.strip("/").split("/")
                              if p)

    #: staleness bound when the invalidation notify was missed
    _SUBTREE_TTL = 2.0

    def _subtrees(self) -> dict[str, int]:
        """The pin table, cached in memory (the reference keeps the
        subtree map resident) and invalidated by set_pin's notify on
        SUBTREE_OBJ — a per-op omap read would sit on every metadata
        op's hot path."""
        now = time.monotonic()
        cached = self._subtree_cache
        if cached is not None and \
                now - self._subtree_cache_at < self._SUBTREE_TTL:
            return cached
        try:
            vals, _ = self.meta.get_omap_vals(AUTO_SUBTREE_OBJ)
            table = {k: int(v) for k, v in vals.items()}
        except RadosError:
            table = {}
        try:
            vals, _ = self.meta.get_omap_vals(SUBTREE_OBJ)
            # explicit pins overwrite balancer assignments on the
            # same path (pins are the operator's override)
            table.update({k: int(v) for k, v in vals.items()})
        except RadosError as err:
            _swallow("subtrees", err)
        self._subtree_cache = table
        self._subtree_cache_at = now
        return table

    def _explicit_pins(self) -> dict[str, int]:
        try:
            vals, _ = self.meta.get_omap_vals(SUBTREE_OBJ)
            return {k: int(v) for k, v in vals.items()}
        except RadosError:
            return {}

    def _subtree_notify(self, notify_id=None, notifier=None,
                        payload=None):
        """Watch callback: a peer's set_pin changed the table."""
        self._subtree_cache = None
        return {"rank": self.rank}

    def _authority(self, path: str) -> int:
        """Owning rank by longest-prefix match (ref: the subtree map;
        everything defaults to rank 0)."""
        path = self._norm(path)
        best, rank = "", 0
        for prefix, r in self._subtrees().items():
            if (path == prefix or
                    path.startswith(prefix.rstrip("/") + "/")) and \
                    len(prefix) > len(best):
                best, rank = prefix, r
        return rank

    #: ops served by whichever rank receives them (no path to route)
    _LOCAL_OPS = frozenset({"statfs"})

    def _route(self, op: str, a: dict) -> None:
        """Forward requests outside our subtrees (ref: the reference
        MDS forwarding non-auth requests via the mdsmap)."""
        if op in self._LOCAL_OPS:
            return
        if op == "set_pin" and a.get("force"):
            # admin repair hatch: a subtree pinned to a dead or
            # nonexistent rank is otherwise unreachable — any live
            # rank may override the table
            return
        path = a.get("path") or a.get("src")
        if path is None:
            return
        auth = self._authority(path)
        dst = a.get("dst")
        if dst is not None and self._authority(dst) != auth:
            if op == "rename":
                # the SOURCE authority coordinates a two-phase
                # cross-rank rename (ref: Server::handle_client_rename
                # with remote witnesses); anyone else forwards there
                if auth != self.rank:
                    raise MDSForward(auth)
                raise _CrossRankRename(self._authority(dst))
            # cross-rank hardlink would additionally need remote-link
            # refcounting through the slave machinery
            raise MDSError("EXDEV", "paths belong to different ranks")
        if auth != self.rank:
            raise MDSForward(auth)

    def _op_reopen(self, a):
        """Re-register an open intent after a cap surrender (the
        client's half of a subtree migration: the NEW authority must
        know the handle exists or it would grant a later opener
        conflicting EXCL over live write-through traffic)."""
        _parent, _name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        rec = self._record_of(dent)
        self._opens.setdefault(rec["ino"], {})[a["__client"]] = \
            bool(a.get("wants_write"))
        return None

    def _op_reconnect(self, a):
        """Session reconnect after an MDS failover (ref: the client
        reconnect phase of MDSRank rejoin — clients re-state their
        open files and the new rank re-issues caps).  Best-effort:
        conflicting caps come back as 0 and the handle runs
        write-through until the conflict clears."""
        _parent, _name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        rec = self._record_of(dent)
        if rec["type"] != "f":
            raise MDSError("EISDIR", a["path"])
        ino = rec["ino"]
        wants_write = bool(a.get("wants_write"))
        try:
            caps = self._grant_caps(ino, a["__client"], wants_write)
        except MDSError:
            # revoke in flight: register the intent cap-less
            self._opens.setdefault(ino, {})[a["__client"]] = \
                wants_write
            caps = 0
        return {"caps": caps, "rec": rec}

    def _op_set_pin(self, a):
        """Migrate a subtree's authority (ref: Migrator export +
        `setfattr ceph.dir.pin`): journal the new pin, then evict our
        caps/open state under it — clients re-acquire through the new
        rank on their next forwarded op."""
        _p, _n, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent["type"] != "d" or dent.get("snapid") is not None:
            raise MDSError("ENOTDIR", a["path"])
        target = int(a["rank"])
        if target < 0:
            raise MDSError("EINVAL", f"rank {target}")
        path = self._norm(a["path"])
        self._do_pin(dent, path, target, SUBTREE_OBJ)
        return {"path": path, "rank": target}

    def _do_pin(self, dent: dict, path: str, target: int,
                table_obj: str) -> None:
        """Migrate a subtree's authority into `table_obj` (explicit
        pin table or the balancer's): journal the entry, persist, and
        evict our caps/open state under it — clients re-acquire
        through the new rank on their next forwarded op."""
        self._journal("set_pin", [
            ("mkobj", table_obj),
            ("set", table_obj, {path: str(target)})])
        # clean handoff: nothing of ours left unflushed for the new
        # authority to miss
        self._persist_applied()
        self._subtree_cache = None
        try:
            # synchronous invalidation: peers drop their cached table
            # before this reply releases the client to the new rank
            self.meta.notify(SUBTREE_OBJ, {"op": "repin"})
        except RadosError as err:
            _swallow("do_pin", err)
        if target != self.rank:
            self._evict_moved(dent)

    def _op_get_pins(self, a):
        return self._subtrees()

    # --------------------------------------------- load balancer
    def tick(self, now: float | None = None) -> None:
        """Periodic MDBalancer pass (ref: src/mds/MDBalancer.cc —
        ranks exchange loads, the overloaded one exports a hot
        subtree).  Loads ride a shared RADOS object instead of
        MHeartbeat; an export is an entry in the balancer's own
        subtree table, so explicit pins stay the operator's override
        and are never auto-migrated."""
        from ..common.options import global_config
        self.hbmap.reset_timeout(self._hb_handle)
        now = time.monotonic() if now is None else now
        cfg = global_config()
        interval = cfg["mds_bal_interval"]
        with self._lock:
            if now - self._last_bal < interval:
                return
            self._last_bal = now
            my_load = sum(self._heat.values())
            # half-life decay so load reflects the recent window
            for k in list(self._heat):
                self._heat[k] *= 0.5
                if self._heat[k] < 0.01:
                    del self._heat[k]
        try:
            self.meta.create(LOAD_OBJ)
        except RadosError as err:
            _swallow("tick", err)
        # stamps shared through RADOS need a SHARED clock: monotonic
        # bases are per-host, so freshness math across ranks on
        # different hosts would be garbage (ref: mds_load_t rides
        # wall-clock utime_t)
        wall = time.time()
        try:
            self.meta.operate(LOAD_OBJ, WriteOp().set_omap({
                str(self.rank): json.dumps(
                    {"load": my_load, "stamp": wall}).encode()}))
            vals, _ = self.meta.get_omap_vals(LOAD_OBJ)
        except RadosError:
            return
        loads: dict[int, float] = {}
        for r, blob in vals.items():
            try:
                rec = json.loads(blob)
                if wall - float(rec["stamp"]) <= 3 * interval:
                    loads[int(r)] = float(rec["load"])
            except (ValueError, KeyError):
                continue
        if len(loads) < 2:
            return                      # no live peer to export to
        coldest = min((r for r in loads if r != self.rank),
                      key=lambda r: loads[r])
        if my_load < cfg["mds_bal_min_load"] or \
                my_load < cfg["mds_bal_ratio"] * (loads[coldest] + 1):
            return
        with self._lock:
            pins = self._explicit_pins()
            best = None
            for d, h in sorted(self._heat.items(),
                               key=lambda kv: -kv[1]):
                if d in pins or self._authority(d) != self.rank:
                    continue
                # exporting our ONLY load would just ping-pong;
                # keep at least something resident
                if h >= my_load * 0.9 and len(self._heat) == 1 and \
                        loads[coldest] <= 0.0 and my_load < \
                        2 * cfg["mds_bal_min_load"]:
                    continue
                _p, _n, dent = self._resolve(d)
                if dent is None or dent.get("type") != "d":
                    continue
                best = (d, dent)
                break
            if best is None:
                return
            path, dent = best
            dout("mds", 1).write(
                "%s: balancer exporting %s (heat %.1f, load %.1f) "
                "-> mds.%d (load %.1f)", self.name, path,
                self._heat.get(path, 0.0), my_load, coldest,
                loads[coldest])
            self._do_pin(dent, path, coldest, AUTO_SUBTREE_OBJ)
            self._heat.pop(path, None)
            revokes, self._pending_revokes = self._pending_revokes, []
        # tick runs outside the dispatch loop: send the evictions
        # ourselves (dispatch would otherwise drain them on the next op)
        for client, cap_msg in revokes:
            self.ms.connect(client).send_message(cap_msg)

    # ------------------------------------------------------- operations
    #: ops allowed to traverse `.snap` paths — everything else on a
    #: snapshot path is EROFS (ref: the snapdir is read-only)
    _SNAP_RO_OPS = frozenset({"lookup", "open", "readdir", "statfs",
                              "lssnap", "release"})

    def handle_op(self, op: str, args: dict):
        """Returns the reply payload; raises MDSError/MDSForward.
        (ref: Server::dispatch_client_request op switch)."""
        with self._lock:
            self._route(op, args)
            # balancer heat: ops we actually serve, attributed to the
            # path's top-level subtree (ref: MDBalancer hit_dir)
            _p = args.get("path") or args.get("src")
            if _p and not str(args.get("__client", "")
                              ).startswith("mds."):
                parts = self._norm(_p).strip("/").split("/")
                if parts and parts[0]:
                    top = "/" + parts[0]
                    self._heat[top] = self._heat.get(top, 0.0) + 1.0
            if op not in self._SNAP_RO_OPS and any(
                    ".snap" in str(args.get(k, "")).split("/")
                    for k in ("path", "src", "dst")):
                raise MDSError("EROFS", "snapshots are read-only")
            client = args.get("__client")
            reqid = args.get("__reqid")
            if reqid and client and op in _MUTATING_OPS:
                hit = self._completed_get(client, reqid)
                if hit is not None:
                    # the op already ran on this rank (or the rank we
                    # replaced): answer from the table — success OR
                    # error — never re-execute (ref:
                    # completed_requests dedup)
                    stored = hit[0]
                    if isinstance(stored, dict) and \
                            "__mds_errno" in stored:
                        raise MDSError(stored["__mds_errno"],
                                       "(replayed)")
                    return stored
                try:
                    out = getattr(self, f"_op_{op}")(args)
                except MDSError as e:
                    if e.errno_name == "EAGAIN":
                        raise      # transient: client retries fresh
                    if args.get("__replay"):
                        out = self._replay_tolerate(op, args, e)
                    else:
                        # record the failure too: a replay after a
                        # lost error reply must re-fail identically,
                        # not be tolerance-mapped to success
                        self._completed_put(
                            client, reqid,
                            {"__mds_errno": e.errno_name})
                        raise
                self._completed_put(client, reqid, out)
                return out
            return getattr(self, f"_op_{op}")(args)

    def _with_snapc(self, rec: dict) -> dict:
        """Attach the write snap context for the just-resolved path's
        realm chain (consumed by the client's data ioctx)."""
        snapc = self._snapc_for_chain(self._chain)
        if snapc is None:
            return rec
        rec = dict(rec)
        rec["snapc"] = snapc
        return rec

    def _op_mkdir(self, a):
        parent, name, dent = self._resolve(a["path"])
        if not name:
            raise MDSError("EEXIST", "/")
        if dent is not None:
            raise MDSError("EEXIST", a["path"])
        ino = self._alloc_ino()
        rec = {"ino": ino, "type": "d",
               "mtime": time.time()}
        self._journal("mkdir", [
            ("mkobj", dir_obj(ino)),
            ("set", self._dent_obj(parent, name), {name: json.dumps(rec)})])
        self._maybe_refrag(parent, name)
        return rec

    def _op_create(self, a):
        parent, name, dent = self._resolve(a["path"])
        if not name:
            raise MDSError("EISDIR", "/")
        if dent is not None:
            if dent["type"] == "d":
                raise MDSError("EISDIR", a["path"])
            rec = self._record_of(dent)
            if not a.get("truncate"):
                # open-existing ('r+'/'a')
                return self._with_snapc(rec)
            # O_TRUNC semantics (ref: Server::handle_client_openc +
            # inode truncate): size -> 0; the client purges the old
            # data objects, mirroring how unlink purges client-side
            old_size = rec.get("size", 0)
            rec = dict(rec)
            rec["size"] = 0
            rec["mtime"] = time.time()
            self._update_record(parent, name, dent, rec, "truncate")
            out = self._with_snapc(dict(rec))
            out["purge_size"] = old_size
            return out
        ino = self._alloc_ino()
        rec = {"ino": ino, "type": "f", "size": 0,
               "mtime": time.time(),
               "layout": a.get("layout") or
               {"stripe_unit": 1 << 16, "stripe_count": 4,
                "object_size": 1 << 18},
               "pool": self.data_pool}
        self._journal("create", [
            ("set", self._dent_obj(parent, name), {name: json.dumps(rec)})])
        self._maybe_refrag(parent, name)
        return self._with_snapc(rec)

    def _op_lookup(self, a):
        _parent, _name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent.get("snapid") is not None:
            return dent        # frozen snap record, size at snap time
        return self._with_snapc(self._record_of(dent))

    def _op_open(self, a):
        """Open with a capability request (ref: Server::handle_client_
        open -> Locker issue).  EAGAIN while conflicting caps are being
        revoked; the client retries.  Snapshot paths open read-only
        with no caps — the record itself is frozen."""
        _parent, _name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent.get("snapid") is not None:
            if a.get("wants_write"):
                raise MDSError("EROFS", a["path"])
            if dent["type"] != "f":
                raise MDSError("EISDIR", a["path"])
            return {"rec": dent, "caps": 0}
        rec = self._record_of(dent)
        if rec["type"] != "f":
            raise MDSError("EISDIR", a["path"])
        caps = self._grant_caps(rec["ino"], a["__client"],
                                bool(a.get("wants_write")))
        return {"rec": self._with_snapc(rec), "caps": caps}

    def _op_release(self, a):
        """Close: drop the session's caps + open intent
        (ref: Locker::remove_client_cap)."""
        ino = a["ino"]
        for table in (self._caps, self._opens):
            ent = table.get(ino)
            if ent is not None:
                ent.pop(a["__client"], None)
                if not ent:
                    del table[ino]
        return None

    def _op_link(self, a):
        """Hardlink (ref: Server::handle_client_link): the first link
        migrates the embedded inode to the itable; both dentries become
        remote references."""
        sp, sname, sdent = self._resolve(a["src"])
        if sdent is None:
            raise MDSError("ENOENT", a["src"])
        if self._record_of(sdent)["type"] == "d":
            raise MDSError("EISDIR", a["src"])
        dp, dname, ddent = self._resolve(a["dst"])
        if not dname:
            raise MDSError("EINVAL", a["dst"])
        if ddent is not None:
            raise MDSError("EEXIST", a["dst"])
        if "remote" in sdent:
            rec = self._iget(sdent["remote"])
            rec["nlink"] = rec.get("nlink", 1) + 1
            self._journal("link", [
                ("set", ITABLE_OBJ, {str(rec["ino"]): json.dumps(rec)}),
                ("set", self._dent_obj(dp, dname),
                 {dname: json.dumps({"type": "f",
                                     "remote": rec["ino"]})})])
            return rec
        rec = dict(sdent)
        rec["nlink"] = 2
        remote = {"type": "f", "remote": rec["ino"]}
        self._journal("link", [
            ("set", ITABLE_OBJ, {str(rec["ino"]): json.dumps(rec)}),
            ("set", self._dent_obj(sp, sname), {sname: json.dumps(remote)}),
            ("set", self._dent_obj(dp, dname), {dname: json.dumps(remote)})])
        self._maybe_refrag(dp, dname)
        return rec

    def _op_readdir(self, a):
        _parent, _name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent["type"] == "snapdir":
            # `ls dir/.snap`: the realm's snapshots as directories
            return {n: {"ino": dent["ino"], "type": "d",
                        "snapid": s["id"]}
                    for n, s in self._snaps_of(dent["ino"]).items()}
        if dent["type"] != "d":
            raise MDSError("ENOTDIR", a["path"])
        return self._readdir_at(dent["ino"], dent.get("snapid"))

    def _op_unlink(self, a):
        parent, name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent["type"] == "d":
            raise MDSError("EISDIR", a["path"])
        if "remote" in dent:
            # hardlink: drop the reference; purge only at nlink 0
            rec = self._iget(dent["remote"])
            if rec is None:
                self._journal("unlink", [("rm", self._dent_obj(parent, name),
                                          [name])])
                raise MDSError("ENOENT", a["path"])
            rec["nlink"] = rec.get("nlink", 1) - 1
            if rec["nlink"] <= 0:
                self._journal("unlink", [
                    ("rm", self._dent_obj(parent, name), [name]),
                    ("rm", ITABLE_OBJ, [str(rec["ino"])])])
                out = self._with_snapc(dict(rec))
                out["purge"] = True
                return out
            self._journal("unlink", [
                ("rm", self._dent_obj(parent, name), [name]),
                ("set", ITABLE_OBJ, {str(rec["ino"]): json.dumps(rec)})])
            out = self._with_snapc(dict(rec))
            out["purge"] = False
            return out
        # the purge travels with the realm's snapc: under a snapped
        # realm the OSD-side delete COWs the head into a clone first,
        # so `.snap` reads keep serving the file's frozen state
        out = self._with_snapc(dict(dent))
        out["purge"] = True
        self._journal("unlink", [("rm", self._dent_obj(parent, name), [name])])
        self._maybe_refrag(parent, name, removed=True)
        return out                       # client purges the data objs

    def _op_rmdir(self, a):
        parent, name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        if dent["type"] != "d":
            raise MDSError("ENOTDIR", a["path"])
        if self._readdir(dent["ino"]):
            raise MDSError("ENOTEMPTY", a["path"])
        self._journal("rmdir", [
            ("rm", self._dent_obj(parent, name), [name])]
            + self._dir_rmobj_deltas(dent["ino"]))
        self._maybe_refrag(parent, name, removed=True)
        return None

    def _op_rename(self, a):
        """(ref: Server::handle_client_rename, single-rank so no
        subtree migration)."""
        src = "/" + "/".join(p for p in a["src"].split("/") if p)
        dst = "/" + "/".join(p for p in a["dst"].split("/") if p)
        sp, sname, sdent = self._resolve(a["src"])
        if sdent is None:
            raise MDSError("ENOENT", a["src"])
        if src == dst:
            return sdent                 # POSIX: rename to self is a no-op
        if dst.startswith(src + "/"):
            # a directory cannot move into its own subtree
            # (ref: the rename cycle check in Server::handle_client_rename)
            raise MDSError("EINVAL", f"{dst} is inside {src}")
        dp, dname, ddent = self._resolve(a["dst"])
        if not dname:
            raise MDSError("EINVAL", a["dst"])
        if ddent is not None:
            if ddent["type"] == "d":
                if self._readdir(ddent["ino"]):
                    raise MDSError("ENOTEMPTY", a["dst"])
            elif sdent["type"] == "d":
                raise MDSError("ENOTDIR", a["dst"])
        deltas = [("set", self._dent_obj(dp, dname),
                   {dname: json.dumps(sdent)}),
                  ("rm", self._dent_obj(sp, sname), [sname])]
        if ddent is not None and ddent["type"] == "d":
            deltas.extend(self._dir_rmobj_deltas(ddent["ino"]))
        self._journal("rename", deltas)
        self._maybe_refrag(dp, dname)
        self._maybe_refrag(sp, sname, removed=True)
        return sdent

    # ---------------------------------------- cross-rank rename (slave)
    def _peer_call(self, rank: int, op: str, args: dict,
                   timeout: float = 15.0):
        """Synchronous MDS-to-MDS request (the slave-request channel,
        ref: Migrator.h:51 / MMDSSlaveRequest).  MUST run off the
        dispatch thread — the reply rides it."""
        tid = next(self._peer_tids)
        ev, slot = threading.Event(), []
        self._peer_pending[tid] = (ev, slot)
        req = MClientRequest(tid=tid, op=op, args=args)
        if not self.ms.connect(f"mds.{rank}").send_message(req):
            self._peer_pending.pop(tid, None)
            raise MDSError("EAGAIN", f"mds.{rank} unreachable")
        if not ev.wait(timeout):
            self._peer_pending.pop(tid, None)
            raise MDSError("EAGAIN", f"mds.{rank} slave call timeout")
        rep = slot[0]
        if rep.forward is not None and rep.forward >= 0:
            # the subtree moved mid-protocol: the slave did NOT apply.
            # EAGAIN (not success!) — the caller re-resolves the
            # authority and retries; treating this as success would
            # commit a src removal whose dst insert never happened.
            raise MDSError("EAGAIN",
                           f"slave forwarded to mds.{rep.forward}")
        if rep.result < 0:
            raise MDSError(rep.errno_name or "EIO", op)
        return rep.out

    def _cross_rank_rename(self, msg, a: dict, dst_rank: int) -> None:
        """Two-phase rename into another rank's subtree (ref:
        Server::handle_client_rename:7310 coordinating witnesses
        through the Migrator):

        1. journal a durable INTENT (this rank, the src authority, is
           the transaction coordinator — replay finishes half-done
           renames, see _recover_xrenames);
        2. slave-insert the dentry at the destination authority
           (idempotent: same-ino insert acks success);
        3. journal the src removal + intent clear, evict our caps on
           the moved inode(s) so the new authority grants them fresh.

        The inode record itself (embedded or itable-backed) lives in
        the shared metadata pool, so identity and hardlinks survive
        the move untouched."""
        reply_err = None
        out = None
        try:
            out = self._xrename_run(a, dst_rank)
        except MDSError as e:
            reply_err = e.errno_name
        except Exception as e:      # noqa: BLE001 — reply, never hang
            dout("mds", 0).write("%s: cross-rank rename failed: %r",
                                 self.name, e)
            reply_err = "EIO"
        if reply_err is None:
            reply = MClientReply(tid=msg.tid, result=0, out=out)
        else:
            reply = MClientReply(tid=msg.tid,
                                 result=_ERRNO.get(reply_err, -22),
                                 errno_name=reply_err)
        with self._lock:
            revokes, self._pending_revokes = self._pending_revokes, []
        self.ms.connect(msg.src).send_message(reply)
        for client, cap_msg in revokes:
            self.ms.connect(client).send_message(cap_msg)

    def _xrename_run(self, a: dict, dst_rank: int):
        src = self._norm(a["src"])
        dst = self._norm(a["dst"])
        with self._lock:
            sp, sname, sdent = self._resolve(a["src"])
            if sdent is None:
                raise MDSError("ENOENT", a["src"])
            if dst.startswith(src + "/"):
                raise MDSError("EINVAL", f"{dst} is inside {src}")
            ino = self._dent_ino(sdent)
        # revoke-and-wait BEFORE touching the namespace: EXCL holders
        # flush buffered sizes against the still-existing src path
        # (the xlock-then-rename ordering Server::handle_client_rename
        # gets from the Locker) — evicting after the commit would
        # race their flushes against a vanished dentry
        self._revoke_and_wait(sdent)
        with self._lock:
            sp, sname, sdent = self._resolve(a["src"])
            if sdent is None:
                raise MDSError("ENOENT", a["src"])
            # deterministic per-(rank, ino) key: a client retry after
            # an ambiguous failure re-drives the SAME intent instead
            # of stacking duplicates
            intent_id = f"{self.rank}.{ino}"
            self._journal("xrename_prepare", [
                ("mkobj", XRENAME_OBJ),
                ("set", XRENAME_OBJ, {intent_id: json.dumps({
                    "src": src, "dst": dst, "dent": sdent,
                    "dst_rank": dst_rank})})])
        try:
            self._peer_call(dst_rank, "slave_rename_insert", {
                "dst": dst, "dent": sdent})
        except MDSError as e:
            if e.errno_name == "EAGAIN":
                # AMBIGUOUS: the slave may have applied the insert
                # (slow peer / lost reply).  The intent must survive
                # — aborting here could leave the file visible at
                # BOTH paths with no record to reconcile.  The client
                # retries (same intent key) and boot-time recovery
                # finishes orphans.
                raise
            # definitive refusal (EEXIST/ENOTEMPTY/ENOTDIR): the
            # insert did not happen, dropping the intent is safe
            with self._lock:
                self._journal("xrename_abort", [
                    ("rm", XRENAME_OBJ, [intent_id])])
            raise
        with self._lock:
            self._journal("xrename_commit", [
                ("rm", self._dent_obj(sp, sname), [sname]),
                ("rm", XRENAME_OBJ, [intent_id])])
            self._evict_moved(sdent)
        return sdent

    @staticmethod
    def _dent_ino(dent: dict):
        """A dentry's logical inode number — remote (hardlink)
        dentries carry it as the itable pointer."""
        return dent["remote"] if "remote" in dent else dent["ino"]

    def _inos_under(self, dent: dict) -> list[int]:
        """File inode numbers covered by a dentry (the dentry itself,
        or every file in the realm when it's a directory) — the one
        walk behind pin/rename eviction and revoke-and-wait."""
        if dent.get("type") == "d":
            return [self._dent_ino(d) for _i, ents, _ch in
                    self._walk_realm(dent["ino"])
                    for d in ents.values() if d.get("type") == "f"]
        return [self._dent_ino(dent)]

    def _revoke_and_wait(self, dent: dict,
                         timeout: float | None = None) -> None:
        """Queue revokes for every cap holder under `dent`, send them
        now (we run off the dispatch thread), and wait for the acks —
        unacked holders past the grace are force-dropped by
        _queue_revoke's own timeout machinery."""
        timeout = self.REVOKE_GRACE if timeout is None else timeout
        with self._lock:
            pending = {i for i in self._inos_under(dent)
                       if self._caps.get(i)}
            for i in pending:
                self._queue_revoke(i, list(self._caps.get(i, {})))
            revokes, self._pending_revokes = self._pending_revokes, []
        for client, cap_msg in revokes:
            self.ms.connect(client).send_message(cap_msg)
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._lock:
                if not any(self._caps.get(i) for i in pending):
                    return
            time.sleep(0.02)

    def _evict_moved(self, dent: dict) -> None:
        """Drop cap/open authority for inode(s) that just left our
        subtrees (the set_pin handoff, per-inode): clients re-acquire
        through the destination rank."""
        for ino in self._inos_under(dent):
            holders = list(self._caps.get(ino, {}))
            if holders:
                self._queue_revoke(ino, holders)
            self._caps.pop(ino, None)
            self._opens.pop(ino, None)

    def _op_slave_rename_insert(self, a):
        """Destination-side half of a cross-rank rename: validate and
        journal the dentry insert (ref: the slave request's
        PREPARE/COMMIT collapsed to one idempotent insert — the
        coordinator's durable intent provides the crash story)."""
        if not str(a.get("__client", "")).startswith("mds."):
            raise MDSError("EINVAL", "slave op from non-mds")
        auth = self._authority(a["dst"])
        if auth != self.rank:
            raise MDSForward(auth)   # table moved mid-flight
        dent = a["dent"]
        dp, dname, ddent = self._resolve(a["dst"])
        if not dname:
            raise MDSError("EINVAL", a["dst"])
        if ddent is not None:
            if self._dent_ino(ddent) == self._dent_ino(dent):
                return None          # replayed intent: already landed
            if ddent["type"] == "d":
                if self._readdir(ddent["ino"]):
                    raise MDSError("ENOTEMPTY", a["dst"])
            elif dent["type"] == "d":
                raise MDSError("ENOTDIR", a["dst"])
        deltas = [("set", self._dent_obj(dp, dname), {dname: json.dumps(dent)})]
        if ddent is not None and ddent["type"] == "d":
            deltas.extend(self._dir_rmobj_deltas(ddent["ino"]))
        self._journal("xrename_in", deltas)
        return None

    def _recover_xrenames(self) -> None:
        """Finish cross-rank renames whose coordinator crashed between
        intent and commit: re-drive the (idempotent) slave insert and
        the src removal.  Runs once per boot off-thread; intents that
        still can't complete stay durable for the next boot."""
        try:
            vals, _ = self.meta.get_omap_vals(XRENAME_OBJ)
        except RadosError:
            return
        for intent_id, blob in vals.items():
            try:
                rec = json.loads(blob)
                if not intent_id.startswith(f"{self.rank}."):
                    continue
                self._peer_call(rec["dst_rank"],
                                "slave_rename_insert",
                                {"dst": rec["dst"],
                                 "dent": rec["dent"]})
                with self._lock:
                    sp, sname, sdent = self._resolve(rec["src"])
                    deltas = [("rm", XRENAME_OBJ, [intent_id])]
                    if sdent is not None and self._dent_ino(sdent) \
                            == self._dent_ino(rec["dent"]):
                        deltas.append(("rm", self._dent_obj(sp, sname), [sname]))
                    self._journal("xrename_commit", deltas)
            except (MDSError, RadosError, KeyError, ValueError) as ex:
                dout("mds", 1).write(
                    "%s: xrename intent %s not recovered: %r",
                    self.name, intent_id, ex)

    def _op_setattr(self, a):
        parent, name, dent = self._resolve(a["path"])
        if dent is None:
            raise MDSError("ENOENT", a["path"])
        rec = self._record_of(dent)
        for k in ("size", "mtime"):
            if k in a:
                if k == "size" and a.get("grow_only"):
                    # cap-less writers flush sizes grow-only so a stale
                    # flush can't regress another writer's extension
                    # (ref: the size ordering Locker's xlock provides)
                    rec[k] = max(rec.get(k, 0), a[k])
                else:
                    rec[k] = a[k]
        self._update_record(parent, name, dent, rec, "setattr")
        return rec

    def _op_statfs(self, a):
        def count(ino):
            files = dirs = 0
            for d in self._readdir(ino).values():
                if d["type"] == "d":
                    dirs += 1
                    f2, d2 = count(d["ino"])
                    files, dirs = files + f2, dirs + d2
                else:
                    files += 1
            return files, dirs
        files, dirs = count(ROOT_INO)
        return {"files": files, "dirs": dirs,
                "next_ino": self._next_ino}

    # --------------------------------------------------------- dispatch
    def ms_dispatch(self, msg: Message) -> bool:
        # the liveness worker beats on every message AND every tick
        # (ref: MDSRank heartbeat_reset in _dispatch): a daemon is
        # unhealthy only when both loops stopped past the grace
        self.hbmap.reset_timeout(self._hb_handle)
        if isinstance(msg, MFSMap):
            self._handle_fsmap(msg)
            return True
        if isinstance(msg, MMonCommandAck):
            # only crash posts ride the command channel from an MDS;
            # a successful ack retires the spooled copy
            self.crash_reporter.on_ack(msg.tid, msg.result)
            return True
        if isinstance(msg, MClientCaps):
            self.handle_caps(msg)
            return True
        if isinstance(msg, MClientReply):
            # slave-call reply from a peer rank
            entry = self._peer_pending.pop(msg.tid, None)
            if entry is not None:
                ev, slot = entry
                slot.append(msg)
                ev.set()
            return True
        if not isinstance(msg, MClientRequest):
            return False
        from ..common.options import global_config
        from ..common.tracing import new_trace, trace_scope
        opkey = (msg.src, msg.tid)
        self.op_tracker.start(
            opkey, f"client_request({msg.src} tid={msg.tid} "
                   f"{msg.op})")
        # frontend trace root: a traced metadata op's journal/objecter
        # writes nest under this span via the ambient scope
        ctx = new_trace() if msg.trace is None and \
            global_config()["blkin_trace_all"] else msg.trace
        sp = self.tracer.start_span(ctx, f"mds_op:{msg.op}")
        try:
            with trace_scope(ctx):
                args = dict(msg.args)
                args["__client"] = msg.src
                out = self.handle_op(msg.op, args)
            reply = MClientReply(tid=msg.tid, result=0, out=out)
        except _CrossRankRename as x:
            # two-phase protocol runs off the dispatch thread (the
            # slave reply would otherwise deadlock this thread); the
            # worker sends the client reply itself
            self.op_tracker.finish(opkey, "cross_rank_deferred")
            self.tracer.finish(sp)
            threading.Thread(
                target=self._cross_rank_rename,
                args=(msg, dict(msg.args), x.dst_rank),
                daemon=True).start()
            return True
        except MDSForward as f:
            reply = MClientReply(tid=msg.tid, result=0,
                                 forward=f.rank)
        except MDSError as e:
            reply = MClientReply(tid=msg.tid,
                                 result=_ERRNO.get(e.errno_name, -22),
                                 errno_name=e.errno_name)
        except (KeyError, AttributeError, TypeError, ValueError) as e:
            reply = MClientReply(tid=msg.tid, result=-22,
                                 errno_name="EINVAL")
            dout("mds", 1).write("%s: bad request %s: %s", self.name,
                                 msg.op, e)
        self.op_tracker.finish(
            opkey, "replied" if reply.result == 0
            else f"error:{reply.errno_name}")
        if sp is not None:
            sp.event("replied" if reply.result == 0
                     else f"error:{reply.errno_name}")
            self.tracer.finish(sp)
        # drain cap revokes queued by the op AFTER the reply so the
        # EAGAIN lands first (ref: Locker issues revokes async)
        with self._lock:
            revokes, self._pending_revokes = self._pending_revokes, []
        self.ms.connect(msg.src).send_message(reply)
        for client, cap_msg in revokes:
            self.ms.connect(client).send_message(cap_msg)
        return True


class MDSStandby(Dispatcher):
    """A standby MDS daemon (ref: the standby/standby-replay daemon
    states in src/mds/MDSMap.h + MDSMonitor promotion):

    * registers with the monitor cluster via ``standby`` beacons and
      waits in the pool;
    * optionally warm-tails a target rank's journal
      (``mds_standby_replay``) so a takeover starts from a warm
      cursor;
    * when the monitor assigns its gid to a failed rank (fsmap state
      ``replay``), it boots a full :class:`MDSDaemon` for that rank —
      the daemon's constructor replays the dead holder's journal tail,
      then walks resolve -> active via beacons.

    The promoted daemon binds the rank's entity name (``mds.<rank>``),
    so clients keep addressing ranks the same way before and after a
    failover.
    """

    def __init__(self, network, rados, name: str = "a", mon=(),
                 metadata_pool: str = "cephfs_metadata",
                 data_pool: str = "cephfs_data",
                 standby_replay_rank: int | None = None,
                 keyring=None):
        self.network = network
        self.rados = rados
        self.name = f"mds.{name}"
        self.mons = [mon] if isinstance(mon, str) else list(mon or [])
        self.metadata_pool = metadata_pool
        self.data_pool = data_pool
        self.keyring = keyring
        self.gid = _alloc_gid()
        self.standby_replay_rank = -1 if standby_replay_rank is None \
            else int(standby_replay_rank)
        #: the rank daemon after promotion
        self.active: MDSDaemon | None = None
        self.rank: int | None = None
        #: journal entries warm-tailed while standby (observability)
        self.tailed = 0
        self._tail_pos = (0, 0)
        self._seq = itertools.count(1)
        self._stop = threading.Event()
        self._promoting = False
        self.inject_beacon_mute = False
        self.ms = Messenger.create(network, self.name, threaded=True)
        self.ms.add_dispatcher(self)

    def init(self) -> None:
        self.ms.start()
        threading.Thread(target=self._standby_loop,
                         daemon=True).start()

    def _standby_loop(self) -> None:
        from ..common.options import global_config
        self._send_beacon()
        while not self._stop.wait(
                global_config()["mds_beacon_interval"]):
            self._send_beacon()
            if self.standby_replay_rank >= 0 and \
                    global_config()["mds_standby_replay"]:
                self._tail_journal()

    def _send_beacon(self) -> None:
        if self.inject_beacon_mute or self._promoting:
            return
        msg = MMDSBeacon(gid=self.gid, name=self.name, rank=-1,
                         state="standby", seq=next(self._seq),
                         standby_replay_rank=self.standby_replay_rank)
        for m in self.mons:
            if self.ms.connect(m).send_message(msg):
                return

    def _tail_journal(self) -> None:
        """Warm-follow the target rank's WAL without registering as a
        journal client (a registered-but-lagging follower would pin
        the active's trim; ref: the standby-replay MDS replaying
        MDLog continuously)."""
        try:
            meta = self.rados.open_ioctx(self.metadata_pool)
            jr = Journaler(meta, journal_id(self.standby_replay_rank),
                           client_id=f"standby.{self.gid}")
            if not jr.exists():
                return
            n = [0]
            pos = jr.replay(lambda _t, _e: n.__setitem__(0, n[0] + 1),
                            from_pos=self._tail_pos)
            self._tail_pos = pos
            self.tailed += n[0]
        except Exception as ex:      # noqa: BLE001
            # tailing is an optimization, never fatal — but the skip
            # still leaves a trace (errcheck coverage points here)
            dout("mds", 10).write(
                "%s: standby-replay tail skipped: %s", self.name, ex)

    # ------------------------------------------------------- promotion
    def ms_dispatch(self, msg: Message) -> bool:
        if not isinstance(msg, MFSMap):
            return False
        m = msg.fsmap
        if m is None or self._promoting or self.active is not None:
            return True
        for rank, info in m.ranks.items():
            if info.gid == self.gid and info.state == "replay":
                self._promoting = True
                threading.Thread(target=self._promote, args=(rank,),
                                 daemon=True).start()
                break
        return True

    def _promote(self, rank: int) -> None:
        """Take over the failed rank: boot an MDSDaemon (journal
        replay happens in its constructor, before the rank's entity
        name starts serving)."""
        dout("mds", 1).write("%s: promoting to mds.%d (gid %d)",
                             self.name, rank, self.gid)
        deadline = time.monotonic() + 30.0
        wait = Backoff(base_s=0.1, cap_s=1.0)
        while True:
            d = None
            try:
                d = MDSDaemon(self.network, self.rados, rank=rank,
                              metadata_pool=self.metadata_pool,
                              data_pool=self.data_pool,
                              mon=self.mons, gid=self.gid,
                              keyring=self.keyring)
                d.init()
                break
            except (ValueError, OSError):
                # the dead holder's entity name/port is still
                # unbinding: back off and retry the whole boot
                if d is not None:
                    try:
                        d.kill()
                    except Exception as ex:   # noqa: BLE001
                        dout("mds", 5).write(
                            "promote: teardown of half-booted rank "
                            "daemon failed: %s", ex)
                if time.monotonic() >= deadline:
                    self._promoting = False
                    raise
                wait.sleep()
        self.active = d
        self.rank = rank
        self._stop.set()          # standby beacons end; the rank's own
        #                           beacon loop carries liveness now

    # -------------------------------------------------------- teardown
    def shutdown(self) -> None:
        self._stop.set()
        if self.active is not None:
            self.active.shutdown()
        self.ms.shutdown()

    def kill(self) -> None:
        """Hard stop (no flush) — thrasher model."""
        self._stop.set()
        if self.active is not None:
            self.active.kill()
        self.ms.shutdown()
