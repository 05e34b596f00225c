"""Typed wire messages — one dataclass per type (ref: src/messages/).

The port's copy of the messages of `ceph_tpu.msg.messages` that its
cluster exchanges: the EC sub-ops, the EC peering and backfill family,
the client op and its reply, the pg-stat report, the map publish, mon
commands and subscriptions, boot and failure reports, pg_temp requests,
the paxos commit pipeline, the cephx handshake (`MAuthRequest`,
`MAuthReply`) and the heartbeat pings.  Each is registered
as the reference registers it (the same wire names, versions and field
order), so a frame written by either package decodes in the other.
The scrub family (`ScrubReserve`, `ScrubMapRequest`, `ScrubMapReply`)
carries both pool types' scrub; the replicated sub-ops (`RepOpWrite`,
`RepOpReply`) and the replicated peering's `PGMissingReply` and `PGPull`
carry the replicated pools; `MMgrCommand` and `MMgrCommandReply` carry a
mgr-module command the mon proxies to the active mgr; `MMonElection`,
`MMonLease`, `MMonLeaseAck`, `MMonForward` and `MPaxosSyncReq` carry a
multi-mon quorum's election, leases, forwarded commands and catch-up;
`MConfig` carries the centralized config a mon pushes to a daemon, and
`MLog` and `MLogAck` a daemon's cluster-log batches and their acks;
`SnapTrim`, `SnapTrimReply` and `SnapTrimPurged` carry the snap
trimmer's clone trims, their acks and the purged-snaps cursor, and
`MWatchNotify` a notify to a watching client; `MClientRequest`,
`MClientReply` and `MClientCaps` carry the file system's metadata ops,
their replies and capability traffic, `MMDSBeacon` an MDS's liveness
and state, and `MFSMap` the mon's fsmap push.  That is every message
type of the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .messenger import Message

# ------------------------------------------------------------ osd/EC

@dataclass
class ECSubWrite(Message):
    """Per-shard EC write (ref: src/messages/MOSDECSubOpWrite.h,
    payload struct src/osd/ECMsgTypes.h ECSubWrite).

    v2 appends the ICI-fabric fields: when `fabric_key` is set the
    chunk bytes are NOT in `txn` — they sit staged on the shared
    device mesh and the receiving shard gathers its slice locally
    (dist/fabric.py; the message is control-plane only)."""
    pgid: Any = None
    tid: int = 0
    reqid: Any = None
    at_version: Any = None
    trim_to: Any = None
    txn: Any = None                 # store Transaction for this shard
    log_entries: list = field(default_factory=list)
    shard: int = -1
    # --- v2: device-mesh fabric fan-out ---
    oid: str = ""
    fabric_key: Any = None          # (pgid, tid) staging key
    chunk_off: int = 0              # chunk-space write offset
    hinfo_append: bool = False      # cumulative crc append is valid
    # --- v3: recovery-push version guard — the receiving shard skips
    # the txn (ack success) when its local copy of `oid` is already
    # STRICTLY newer: a backfill push planned before a client write
    # landed must not roll the chunk back (ref: the last_backfill
    # ordering guarantee this guard replaces)
    guard_version: Any = None       # (epoch, version) or None


@dataclass
class ECSubWriteReply(Message):
    """(ref: src/messages/MOSDECSubOpWriteReply.h, ECMsgTypes.h
    ECSubWriteReply)."""
    pgid: Any = None
    tid: int = 0
    shard: int = -1
    committed: bool = True


@dataclass
class ECSubRead(Message):
    """Per-shard chunk read request (ref: src/messages/MOSDECSubOpRead.h,
    ECMsgTypes.h ECSubRead: to_read offset/len lists + attrs_to_read).

    v2 appends the sub-chunk repair fields: `subchunks` maps oid ->
    [(rel_off, rel_len), ...] byte extents WITHIN each chunk_size-sized
    chunk of the shard's stream (ref: ECMsgTypes.h ECSubRead subchunks,
    the clay repair-plane reads of ErasureCodeClay.cc:364).  The shard
    expands the per-chunk extents across its local stream length and
    replies with the CONCATENATED repair planes — a single-shard
    regenerating-code rebuild ships ~(k+m-1)/m x less data than whole
    chunks.  Empty dict = whole-range semantics via `to_read`."""
    pgid: Any = None
    tid: int = 0
    shard: int = -1
    to_read: list = field(default_factory=list)   # [(oid, off, len)]
    attrs_to_read: list = field(default_factory=list)  # [oid]
    # --- v2: sub-chunk (repair-plane) extents ---
    subchunks: dict = field(default_factory=dict)  # oid -> [(off, len)]
    chunk_size: int = 0      # chunk stride the extents repeat at


@dataclass
class ECSubReadReply(Message):
    """(ref: src/messages/MOSDECSubOpReadReply.h)."""
    pgid: Any = None
    tid: int = 0
    shard: int = -1
    buffers_read: dict = field(default_factory=dict)  # oid -> bytes|None
    attrs_read: dict = field(default_factory=dict)    # oid -> attrs|None
    errors: dict = field(default_factory=dict)        # oid -> errno str


@dataclass
class RepOpWrite(Message):
    """Replica write fan-out for replicated pools
    (ref: src/messages/MOSDRepOp.h; ReplicatedBackend.cc
    issue_op/sub_op_modify).  Carries the client op's mutation vector
    (see osd/mutations.py) — the analogue of MOSDRepOp's serialized
    ObjectStore::Transaction payload."""
    pgid: Any = None
    tid: int = 0
    oid: str = ""
    mutations: list = field(default_factory=list)
    version: Any = None
    log_entries: list = field(default_factory=list)
    # snapshot COW decided at the primary (ref: the SnapContext the
    # primary folds into the repop transaction): clone the pre-write
    # head as oid@clone_snap covering `clone_covers` snapids
    clone_snap: Any = None
    clone_covers: list = field(default_factory=list)
    snap_seq: int = 0            # pool snap_seq at this write


@dataclass
class RepOpReply(Message):
    """(ref: src/messages/MOSDRepOpReply.h)."""
    pgid: Any = None
    tid: int = 0
    from_osd: int = -1
    committed: bool = True


@dataclass
class PGScan(Message):
    """Primary asks a peer for its object inventory after an acting
    change (the peering/backfill scan,
    ref: src/messages/MOSDPGScan.h / PG::scan_range).

    v2 appends the ranged-walk fields: with `ranged` set the peer
    returns only its objects in (begin, end] (PG::scan_range's
    interval window), so a backfill walk never materializes a big
    PG's whole inventory in one message."""
    pgid: Any = None
    ec: bool = False       # scanner's pool type: build only that view
    # --- v2: ranged backfill walk ---
    ranged: bool = False
    begin: str = ""        # exclusive lower bound ("" = start)
    end: str = ""          # inclusive upper bound ("" = unbounded)


@dataclass
class PGScanReply(Message):
    """v2 appends the ranged-walk echo fields so the primary can match
    a chunk reply to its cursor position."""
    pgid: Any = None
    from_osd: int = -1
    #: oid -> ((epoch, version), whiteout) — the recovery inventory
    objects: dict = field(default_factory=dict)
    #: EC pools: oid -> [shard indexes present in the peer's store]
    ec_shards: dict = field(default_factory=dict)
    # --- v2: ranged backfill walk ---
    ranged: bool = False
    begin: str = ""
    end: str = ""


# ----------------------------------------------------------- peering

@dataclass
class PGQuery(Message):
    """Primary asks a (possibly prior-interval) peer for its pg_info
    (GetInfo phase, ref: src/messages/MOSDPGQuery.h).

    v2 appends `ec`: the querying primary's pool type, so the peer
    answers from the matching store view (EC collections hold
    sharded ObjectIds the replicated view cannot read)."""
    pgid: Any = None
    epoch: int = 0
    # --- v2: EC-pool peering ---
    ec: bool = False


@dataclass
class PGNotify(Message):
    """pg_info, two roles (ref: src/messages/MOSDPGNotify.h carrying
    pg_info_t): the GetInfo reply, answered from the persisted shard
    log even when the peer has no live PG state; and — with `stray`
    set — the unsolicited stray self-notify (an OSD holding data for
    a PG it is no longer mapped to announces itself to the current
    primary, which answers PGRemove once clean, or re-peers if the
    stray holds newer history)."""
    pgid: Any = None
    from_osd: int = -1
    epoch: int = 0
    last_update: Any = None      # EVersion head of the shard's log
    log_tail: Any = None         # EVersion tail
    have_data: bool = False      # store collection is non-empty
    n_objects: int = 0
    stray: bool = False          # unsolicited self-notify leg
    # --- v2: EC-pool peering — shard indexes present in the peer's
    # store (a remapped holder may carry several; ref: pg_info_t's
    # shard-qualified pg identity, src/osd/osd_types.h spg_t)
    shards: list = field(default_factory=list)


@dataclass
class PGLogReq(Message):
    """GetLog: primary asks the authoritative peer for its log
    (ref: MOSDPGQuery with query_t::LOG)."""
    pgid: Any = None
    since: Any = None            # EVersion: send entries > since
    epoch: int = 0               # staleness guard
    full: bool = False           # wholesale adoption (primary backfill)
    # --- v2: EC-pool peering — answer from the EC shard log view
    ec: bool = False


@dataclass
class PGLogPush(Message):
    """A log segment + bounds, both directions (ref:
    src/messages/MOSDPGLog.h): auth peer -> primary as the GetLog
    reply, primary -> replica during GetMissing/activation (the
    replica merges it and answers PGMissingReply)."""
    pgid: Any = None
    from_osd: int = -1
    entries: list = field(default_factory=list)   # PGLogEntry, ascending
    head: Any = None             # sender's log head (EVersion)
    tail: Any = None             # sender's log tail
    to_primary: bool = False     # True = GetLog reply leg
    activate: bool = False       # primary->replica: compute missing
    full: bool = False           # wholesale adoption leg
    epoch: int = 0


@dataclass
class PGMissingReply(Message):
    """Replica's missing set after merging the primary's log
    (GetMissing phase; ref: pg_missing_t exchanged via MOSDPGLog)."""
    pgid: Any = None
    from_osd: int = -1
    #: oid -> (epoch, version) needed
    missing: dict = field(default_factory=dict)
    epoch: int = 0
    #: the replica could not merge (its log raced a trim): the primary
    #: reclassifies it as a backfill target
    no_overlap: bool = False


@dataclass
class BackfillReserve(Message):
    """Backfill reservation handshake (ref:
    src/messages/MBackfillReserve.h REQUEST/GRANT/REJECT_TOOFULL/
    RELEASE): a target only serves `osd_max_backfills` concurrent
    backfills; rejected primaries retry on the tick."""
    pgid: Any = None
    from_osd: int = -1
    op: str = "request"          # request|grant|reject|release


@dataclass
class ScrubReserve(Message):
    """Scrub reservation handshake (ref:
    src/messages/MOSDScrubReserve.h REQUEST/GRANT/REJECT/RELEASE):
    a replica serves at most `osd_max_scrubs` concurrent scrubs, so
    the cluster-wide scrub load is bounded no matter how many
    primaries come due at once."""
    pgid: Any = None
    from_osd: int = -1
    op: str = "request"          # request|grant|reject|release


@dataclass
class PGRemove(Message):
    """Primary tells a stray (an OSD holding this PG's data but no
    longer in the acting/up set) to delete its copy after the PG goes
    clean (ref: src/messages/MOSDPGRemove.h)."""
    pgid: Any = None
    epoch: int = 0


@dataclass
class MOSDPGTemp(Message):
    """OSD asks the mon for a pg_temp override (ref:
    src/messages/MOSDPGTemp.h): a freshly-mapped primary with no data
    keeps the old acting set serving while it backfills; empty `osds`
    clears the override when the backfill finishes."""
    pgid: Any = None
    from_osd: int = -1
    epoch: int = 0
    osds: list = field(default_factory=list)


@dataclass
class SnapTrim(Message):
    """Primary -> replica: apply one clone-trim decision for a removed
    snapshot (the repop the SnapTrimmer statechart issues, ref:
    PrimaryLogPG::trim_object building the trim transaction; statechart
    src/osd/PrimaryLogPG.h:1578).  The receiver drops `snap` from the
    clone's covers and physically deletes the clone once no covered
    snap remains — idempotent, so a promoted primary re-driving the
    tail of a dead primary's round converges instead of erroring."""
    pgid: Any = None
    tid: int = 0
    oid: str = ""
    snap: int = 0
    clone: int = 0
    from_osd: int = -1


@dataclass
class SnapTrimReply(Message):
    """Replica ack for one SnapTrim (the sub-op reply leg the trim
    statechart waits on before advancing its cursor)."""
    pgid: Any = None
    tid: int = 0
    from_osd: int = -1
    committed: bool = True


@dataclass
class SnapTrimPurged(Message):
    """Primary -> replicas: `snaps` are fully trimmed in this PG —
    reconcile any local leftovers, then record them in the durable
    purged_snaps interval set (ref: the purged_snaps update in
    PrimaryLogPG::snap_trimmer / pg_info_t).  Every shard carries the
    cursor so ANY of them can resume the subsystem as primary after a
    failover; the whole purged set travels as one message so the
    per-interval re-announce costs one send per peer, not one per
    snap."""
    pgid: Any = None
    snaps: list = field(default_factory=list)
    from_osd: int = -1


@dataclass
class PGPull(Message):
    """Primary requests objects it lacks from a holder
    (ref: src/messages/MOSDPGPull.h)."""
    pgid: Any = None
    oids: list = field(default_factory=list)


@dataclass
class ScrubMapRequest(Message):
    """Primary asks a peer for its scrub map
    (ref: src/messages/MOSDRepScrub.h; PG::replica_scrub)."""
    pgid: Any = None
    deep: bool = True


@dataclass
class ScrubMapReply(Message):
    """(ref: ScrubMap in src/osd/scrubber_common.h — per-object
    version/size/digest)."""
    pgid: Any = None
    from_osd: int = -1
    #: oid -> {"version": (e, v), "size": int, "crc": int | None,
    #:          "ok": bool}  (crc None on shallow scrub)
    objects: dict = field(default_factory=dict)
    #: the peer has no state for this PG yet (map lag) — the scrub
    #: must retry rather than treat every object as missing there
    absent: bool = False


@dataclass
class PGPush(Message):
    """Full-object push (recovery/backfill payload,
    ref: src/messages/MOSDPGPush.h — PushOp carries data, attrs and
    omap entries; ReplicatedBackend::build_push_op)."""
    pgid: Any = None
    oid: str = ""
    data: bytes = b""
    size: int = 0
    version: Any = None
    whiteout: bool = False     # delete tombstone push
    force: bool = False        # scrub repair: overwrite same-version
    attrs: dict = field(default_factory=dict)    # user xattrs
    omap: dict = field(default_factory=dict)
    omap_hdr: bytes = b""
    #: snapshot history rides along:
    #: {snap_seq, items: [{snap, covers, data, attrs, omap}]}
    clones: dict = field(default_factory=dict)
    # --- v2 ---
    #: backfill walk payload: the primary's interval is absolutely
    #: authoritative — apply regardless of the target's local version
    #: (a divergent survivor past trimmed history can carry a NEWER
    #: version that the force guard would wrongly keep)
    backfill: bool = False


# ------------------------------------------------------------ client

@dataclass
class OSDOp(Message):
    """Client op to the primary (ref: src/messages/MOSDOp.h).
    op names the sub-op (write/read/setxattr/omap_setkeys/...);
    `args` carries op-specific parameters the way MOSDOp's osd_op
    vector carries per-op payloads (src/include/rados.h
    CEPH_OSD_OP_*)."""
    pgid: Any = None
    oid: str = ""
    op: str = ""
    tid: int = 0
    epoch: int = 0
    offset: int = 0
    length: int = 0
    data: bytes = b""
    args: dict = field(default_factory=dict)


@dataclass
class OSDOpReply(Message):
    """(ref: src/messages/MOSDOpReply.h)."""
    tid: int = 0
    result: int = 0
    errno_name: str = ""
    data: bytes = b""
    attrs: dict = field(default_factory=dict)
    epoch: int = 0


@dataclass
class MPGStats(Message):
    """osd -> mon: periodic pg + usage stat report
    (ref: src/messages/MPGStats.h; osd_stat_t / pg_stat_t)."""
    osd: int = -1
    epoch: int = 0
    stamp: float = 0.0
    pg_stats: dict = field(default_factory=dict)
    kb_total: int = 0
    kb_used: int = 0
    kb_avail: int = 0
    #: daemon perf counters (the MMgrReport payload in the reference —
    #: piggybacked on the stat report here)
    perf: dict = field(default_factory=dict)
    # --- v2: slow-op summary {count, oldest_age} from the daemon's
    # OpTracker — the mon raises SLOW_OPS while any report carries a
    # non-zero count (ref: the health_checks slice DaemonServer
    # derives from per-daemon op trackers)
    slow_ops: dict = field(default_factory=dict)


# ---------------------------------------------------------- maps/mon

@dataclass
class MMap(Message):
    """Map publish (ref: src/messages/MOSDMap.h): full map or
    incrementals for a range of epochs."""
    full_map: Any = None
    incrementals: list = field(default_factory=list)
    first: int = 0
    last: int = 0


@dataclass
class MMonCommand(Message):
    """Mon command (ref: src/messages/MMonCommand.h); cmd is the parsed
    argv-style dict like the mon's cmdmap."""
    tid: int = 0
    cmd: dict = field(default_factory=dict)


@dataclass
class MMonCommandAck(Message):
    tid: int = 0
    result: int = 0
    outs: str = ""                  # human output
    outb: Any = None                # data payload


# outs prefix on every -11 the mon emits for mgr-module commands when
# no live mgr can serve them ("no active mgr" / "went away" /
# "unreachable").  Unlike election-churn EAGAINs there is no quorum
# event the client can wait out, so the objecter gives these only a
# short registration grace instead of its full command deadline.
MGR_UNAVAILABLE_EAGAIN = "EAGAIN(mgr): "


@dataclass
class MMgrCommand(Message):
    """Mon -> active mgr: a client command owned by a mgr module
    (telemetry/insights), proxied by the mon that received it (ref:
    src/messages/MCommand.h routed via the MgrMonitor's active mgr).
    The mgr answers the MON (MMgrCommandReply) which relays the ack to
    the client over its learned connection — the mgr may have no route
    of its own to an ad-hoc client entity."""
    tid: int = 0
    cmd: dict = field(default_factory=dict)


@dataclass
class MMgrCommandReply(Message):
    """Active mgr -> proxying mon: module command result
    (ref: src/messages/MCommandReply.h)."""
    tid: int = 0
    result: int = 0
    outs: str = ""
    outb: Any = None


@dataclass
class MMonSubscribe(Message):
    """Map subscription (ref: src/messages/MMonSubscribe.h): ask for
    osdmap updates starting at `start` epoch."""
    what: str = "osdmap"
    start: int = 0


@dataclass
class MConfig(Message):
    """mon -> daemon: your merged centralized-config view changed
    (ref: src/messages/MConfig.h)."""
    version: int = 0
    values: dict = field(default_factory=dict)


@dataclass
class MWatchNotify(Message):
    """OSD -> watching client: a notify fired on an object you watch
    (ref: src/messages/MWatchNotify.h)."""
    pool: int = -1
    oid: str = ""
    notify_id: int = 0
    cookie: str = ""
    notifier: str = ""
    payload: Any = None


@dataclass
class MLog(Message):
    """Daemon -> mon cluster-log batch (ref: src/messages/MLog.h
    carrying LogEntry vectors; src/common/LogClient.cc).  Entries are
    dicts {seq, stamp, name, level, text}; `seq` is the sender's
    monotonically increasing counter so the mon can dedup resends."""
    entries: list = field(default_factory=list)


@dataclass
class MLogAck(Message):
    """Mon -> daemon ack up to `last_seq` for `name` (ref:
    src/messages/MLogAck.h); the client trims its resend buffer."""
    name: str = ""
    last_seq: int = 0


@dataclass
class MOSDBoot(Message):
    """OSD announces itself to the mon (ref: src/messages/MOSDBoot.h)."""
    osd: int = -1


@dataclass
class MOSDFailure(Message):
    """Failure report (ref: src/messages/MOSDFailure.h)."""
    target_osd: int = -1
    reporter: int = -1
    failed_for: float = 0.0
    epoch: int = 0


# --------------------------------------------------------- mon paxos

@dataclass
class MMonElection(Message):
    """Leader election (ref: src/messages/MMonElection.h;
    Elector propose/ack/victory ops)."""
    op: str = "propose"            # propose | ack | victory
    epoch: int = 0
    rank: int = -1                 # sender's rank
    quorum: list = field(default_factory=list)   # victory: member ranks


@dataclass
class MPaxosBegin(Message):
    """Leader -> peon: accept value at version
    (ref: src/messages/MMonPaxos.h OP_BEGIN; epoch guards a deposed
    leader's traffic)."""
    version: int = 0
    tx: bytes = b""
    epoch: int = 0


@dataclass
class MPaxosAccept(Message):
    """(ref: MMonPaxos.h OP_ACCEPT)."""
    version: int = 0
    rank: int = -1
    epoch: int = 0


@dataclass
class MPaxosCommit(Message):
    """(ref: MMonPaxos.h OP_COMMIT)."""
    version: int = 0
    tx: bytes = b""
    epoch: int = 0


@dataclass
class MPaxosStoreSync(Message):
    """Full-store sync for a mon lagging past the trim window
    (ref: src/mon/Monitor.cc sync_* full-store sync)."""
    data: bytes = b""            # wire-encoded store contents
    first_committed: int = 0
    last_committed: int = 0


@dataclass
class MMonLease(Message):
    """Leader liveness lease to peons
    (ref: MMonPaxos.h OP_LEASE)."""
    epoch: int = 0
    stamp: float = 0.0
    last_committed: int = 0    # peons behind this request a sync
    #: the reigning quorum: a recipient NOT listed learns it was left
    #: out (its election ack never landed) and must re-propose — a
    #: lease alone is not membership
    quorum: tuple = ()


@dataclass
class MMonLeaseAck(Message):
    """Peon lease acknowledgement (ref: MMonPaxos.h OP_LEASE_ACK);
    carries the peon's paxos state so a freshly elected stale leader
    learns what it missed before proposing anything."""
    epoch: int = 0
    rank: int = -1
    last_committed: int = 0


@dataclass
class MPaxosSyncReq(Message):
    """Lagging peon asks the leader for missed commits
    (ref: Paxos share_state/store sync)."""
    version: int = 0           # requester's last_committed
    rank: int = -1


@dataclass
class MMonForward(Message):
    """Peon forwards a client command to the leader, which replies to
    the client directly (ref: src/messages/MForward.h)."""
    tid: int = 0
    client: str = ""
    cmd: dict = field(default_factory=dict)


# ------------------------------------------------------------- pings

@dataclass
class MAuthRequest(Message):
    """client/daemon -> mon: prove identity (ref: src/messages/MAuth.h
    + CephxAuthorizer)."""
    entity: str = ""
    nonce: str = ""
    sig: str = ""


@dataclass
class MAuthReply(Message):
    """(ref: src/messages/MAuthReply.h): session ticket or failure.
    `expires` is advertised in the clear so the client knows when to
    renew (the sealed ticket is opaque to it)."""
    result: int = 0
    errstr: str = ""
    challenge: str = ""
    ticket: Any = None
    expires: float = 0.0


@dataclass
class MClientRequest(Message):
    """client -> mds metadata op (ref: src/messages/MClientRequest.h;
    op codes CEPH_MDS_OP_* src/include/ceph_fs.h)."""
    tid: int = 0
    op: str = ""
    args: dict = field(default_factory=dict)


@dataclass
class MClientReply(Message):
    """(ref: src/messages/MClientReply.h)."""
    tid: int = 0
    result: int = 0
    errno_name: str = ""
    out: Any = None
    # --- v2 ---
    #: >= 0: the request belongs to another rank's subtree — retry
    #: there (ref: the MDS forward/mdsmap redirection)
    forward: int = -1


@dataclass
class MClientCaps(Message):
    """Capability traffic between MDS and fs clients
    (ref: src/messages/MClientCaps.h).  op: "revoke" (mds -> client:
    give the listed caps back after flushing dirty state) | "flush"
    (client -> mds: dirty size/mtime riding a cap return) | "ack"
    (client -> mds: revoke complete)."""
    op: str = ""
    ino: int = 0
    caps: int = 0                    # cap bits affected
    seq: int = 0
    size: int = -1                   # flushed size (-1 = clean)
    mtime: float = 0.0
    # --- v2 ---
    #: op="snapc": the realm's widened write snap context pushed to
    #: open handles after a mksnap (ref: SnapRealm update broadcast)
    snapc: Any = None


@dataclass
class MMDSBeacon(Message):
    """mds -> mon liveness + state beacon (ref:
    src/messages/MMDSBeacon.h; MDSMonitor::preprocess_beacon).
    `state` walks standby -> replay -> resolve -> active; the monitor
    answers every beacon with the current MFSMap so the daemon learns
    assignments and standdowns without a separate subscription."""
    gid: int = 0
    name: str = ""
    rank: int = -1
    state: str = "standby"
    seq: int = 0
    #: standby-replay target rank (-1 = plain standby; ref:
    #: mds_standby_replay / MDSMap::DAEMON_STATE standby-replay)
    standby_replay_rank: int = -1
    # --- v2: slow-op summary {count, oldest_age} riding the beacon —
    # the MDS half of the SLOW_OPS health feed (the OSD's rides
    # MPGStats)
    slow_ops: dict = field(default_factory=dict)


@dataclass
class MFSMap(Message):
    """mon -> subscriber/daemon FSMap publish (ref:
    src/messages/MFSMap.h; Monitor handle_subscribe "fsmap")."""
    epoch: int = 0
    fsmap: Any = None


@dataclass
class Ping(Message):
    """Heartbeat (ref: src/messages/MOSDPing.h PING)."""
    epoch: int = 0
    stamp: float = 0.0


@dataclass
class PingReply(Message):
    """(ref: MOSDPing.h PING_REPLY)."""
    epoch: int = 0
    stamp: float = 0.0


# ------------------------------------------------- wire registration
# Every message type is a versioned wire struct (ref: each
# src/messages/*.h declares HEAD_VERSION/COMPAT_VERSION); bump a
# type's version here when appending fields.
#: per-type (version, compat) overrides — bump when appending fields
_VERSIONS: dict[str, tuple[int, int]] = {
    "ECSubWrite": (3, 1),       # v2: ICI-fabric; v3: push version guard
    "ECSubRead": (2, 1),        # v2: sub-chunk repair extents
    "PGScan": (2, 1),           # v2: ranged backfill walk
    "PGScanReply": (2, 1),      # v2: ranged/begin/end echo fields
    "PGPush": (2, 1),           # v2: authoritative backfill flag
    "MClientCaps": (2, 1),      # v2: snapc broadcast leg
    "MClientReply": (2, 1),     # v2: cross-rank forward
    "PGQuery": (2, 1),          # v2: EC pool-type flag
    "PGNotify": (2, 1),         # v2: held EC shard indexes
    "PGLogReq": (2, 1),         # v2: EC shard-log view flag
    "MPGStats": (2, 1),         # v2: slow-op summary (SLOW_OPS feed)
    "MMDSBeacon": (2, 1),       # v2: slow-op summary (SLOW_OPS feed)
    "MMonLease": (2, 1),        # v2: reigning quorum rides the lease
}


def _register_all() -> None:
    import dataclasses as _dc

    from .encoding import register_struct
    for _obj in list(globals().values()):
        if isinstance(_obj, type) and issubclass(_obj, Message) and \
                _dc.is_dataclass(_obj):
            v, compat = _VERSIONS.get(_obj.__name__, (1, 1))
            register_struct(_obj, version=v, compat=compat)


_register_all()
