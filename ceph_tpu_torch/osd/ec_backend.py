"""ECBackend: the erasure-coded PG data plane.

The write/read/recovery engine of an EC placement group
(ref: src/osd/ECBackend.{h,cc}).  Two halves:

* `ECPGShard` — runs on every OSD in the acting set: applies per-shard
  write transactions (`handle_sub_write`, ref: ECBackend.cc:912),
  serves chunk reads with HashInfo crc verification
  (`handle_sub_read`, ref: ECBackend.cc:987), and keeps the shard's
  PGLog.
* `ECBackend` — runs on the primary: the three-queue RMW write
  pipeline (`submit_transaction` -> `start_rmw` -> waiting_state ->
  waiting_reads -> waiting_commit, ref: ECBackend.cc:1479,1832,2138),
  reconstructing reads (`objects_read_and_reconstruct` +
  `get_min_avail_to_read_shards`, ref: ECBackend.h:139,
  ECBackend.cc:1590), and shard recovery (`recover_object`,
  ref: ECBackend.cc:735).

All stripe math goes through the port's `osd/ecutil.py`, so every encode
and decode is ONE batched launch of K1 per op on the plugin's device
(cuda unless the plugin was built with `device="cpu"`, where K1's plain
version runs); the reference's per-stripe loop and per-shard buffer
assembly collapse into array reshapes around the kernel.  Recovery
rebuilds lost shards through the port's compiled repair (`ec/repairc`,
one K1 launch per object), and a write to co-located shards can ride the
port's fabric (`dist/fabric.py`).  This module is the host-side protocol
engine.

The port's copy of `ceph_tpu.osd.ec_backend`.  One rule differs: the
compiled repair falls back to the full rebuild only on a plan error
(`RepairPlanError`, `ErasureCodeError`); a fault of K1's wrapper, its
launch, its build or the device guard propagates out of
`recover_object` instead of hiding behind the slower path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..common.log import dout
from ..common.tracing import child_of
from ..ec.interface import ErasureCodeError
from ..ec.repairc import RepairPlanError
from ..msg.messages import (ECSubRead, ECSubReadReply, ECSubWrite,
                            ECSubWriteReply)
from ..store import ObjectId, StoreError, Transaction
from . import ecutil
from . import mutations as mut
from .ecutil import HashInfo, StripeInfo
from .pg_log import PGLog
from .pg_types import (DELETE, EVersion, MODIFY, PGLogEntry, PGMissing,
                       ZERO_VERSION)

OI_ATTR = "_"          # object info xattr key (ref: OI_ATTR "_")
HINFO_ATTR = "hinfo_key"   # (ref: ECUtil.h ECUtil::get_hinfo_key())


def pg_cid(pgid) -> str:
    return f"pg_{pgid}"


def ec_tombstone_txn(cid: str, oid: str, shard: int, ver: tuple,
                     n_chunks: int) -> Transaction:
    """The versioned-whiteout delete for one shard: data trimmed,
    delete version recorded, hinfo reset.  Single source of truth for
    the tombstone layout (delete commit, recovery spread, scrub repair
    all write this shape)."""
    soid = ObjectId(oid, shard=shard)
    return (Transaction()
            .touch(cid, soid)
            .truncate(cid, soid, 0)
            .setattrs(cid, soid, {
                OI_ATTR: {"size": 0, "version": tuple(ver),
                          "whiteout": True},
                HINFO_ATTR: HashInfo(n_chunks).to_dict()}))


def spread_tombstones(pgid, k_plus_m: int, local_shard, whoami: int,
                      send_osd, oid: str, ver: tuple,
                      targets: dict) -> None:
    """Spread a delete to shards that missed it — the EC analogue of
    pushing a replicated whiteout.  `targets` is {shard_index: osd};
    the version guard keeps a racing newer write authoritative.  The
    single implementation behind the daemon's scrub repair AND the
    peering statechart's reconcile/backfill."""
    cid = pg_cid(pgid)
    for s, osd in targets.items():
        txn = ec_tombstone_txn(cid, oid, s, ver, k_plus_m)
        msg = ECSubWrite(pgid=pgid, tid=0, shard=s, txn=txn,
                         log_entries=[], oid=oid,
                         guard_version=tuple(ver))
        if osd == whoami:
            local_shard.handle_sub_write(msg)
        else:
            send_osd(osd, msg)


def newest_oi_attrs(per_shard: dict):
    """Authoritative metadata selection for recovery: among the
    gathered per-shard attr dicts, the one whose OI version is newest
    wins (ties -> lowest shard index, so a half-applied attr update
    racing a failure resolves deterministically).  Returns
    (version_tuple, oi, hinfo_dict, user_xattrs) or None when no
    shard reported attrs.  Single implementation behind the full and
    sub-chunk recovery paths on both the backend and the peering
    statechart."""
    best = None
    for s in sorted(per_shard):
        a = per_shard[s]
        oi = a.get(OI_ATTR) or {}
        ver = tuple(oi.get("version", (0, 0)))
        if best is None or ver > best[0]:
            best = (ver, oi, a.get(HINFO_ATTR), mut.user_xattrs(a))
    return best


def ec_store_inventory(store, cid: str) -> dict:
    """oid -> {shard_index: ((epoch, ver), whiteout)} straight from a
    PG collection, independent of any live ECPGShard (a peer whose map
    lags can still answer a peering scan from its store; after a remap
    an OSD may hold chunks for indexes it no longer serves).  Version-
    carrying so stale chunks lose to newer writes/tombstones
    (ref: EC backfill presence/version decisions)."""
    out: dict[str, dict] = {}
    if not store.collection_exists(cid):
        return out
    for o in store.collection_list(cid):
        if o.name == "pgmeta":
            continue
        try:
            oi = store.getattr(cid, o, OI_ATTR)
        except StoreError:
            oi = {}
        v = oi.get("version", (0, 0))
        # replicated collections store EVersion objects; EC stores
        # (epoch, version) tuples — normalize either
        ver = (v.epoch, v.version) if hasattr(v, "epoch") else \
            tuple(v) if v else (0, 0)
        out.setdefault(o.name, {})[o.shard] = (
            ver, bool(oi.get("whiteout")))
    return out


# --------------------------------------------------------------------- shard


class ECPGShard:
    """Per-OSD shard service for one PG.

    The shard's pg_log is durable in the pgmeta omap (same key format
    as the replicated shard's — ref: PGLog::write_log_and_missing), so
    a restarted OSD re-peers from real log bounds and the EC peering
    statechart's GetInfo/GetLog phases have honest history to compare.
    Unlike the replicated shard the entries ride a trailing
    transaction rather than the data txn (the data txn arrives
    pre-encoded from the primary); the window where data landed
    without its log entry resolves through peering's version
    reconcile, which reads authoritative versions from OI attrs."""

    def __init__(self, pgid, shard: int, store, k: int, m: int,
                 fabric=None, create: bool = True):
        self.pgid = pgid
        self.shard = shard
        self.store = store
        self.k = k
        self.m = m
        self.cid = pg_cid(pgid)
        self.pg_log = PGLog()
        #: shared ICIFabric when this OSD is device-mesh resident
        #: (dist/fabric.py) — fabric sub-writes gather their chunk
        #: slice from the mesh instead of the message
        self.fabric = fabric
        if create and not store.collection_exists(self.cid):
            store.queue_transaction(
                Transaction().create_collection(self.cid))
        self._load_log()

    # -- durable log (shared format with ReplicatedPGShard) ------------
    def _load_log(self) -> None:
        from ..msg import encoding as wire
        from .pg_log import IndexedLog
        from .replicated_backend import _TAIL_KEY, PGMETA
        if not self.store.collection_exists(self.cid) or \
                not self.store.exists(self.cid, PGMETA):
            return
        omap = self.store.omap_get(self.cid, PGMETA)
        entries = [wire.decode(v) for k, v in sorted(omap.items())
                   if k.startswith("l.")]
        if not entries and _TAIL_KEY not in omap:
            return
        tail = wire.decode(omap[_TAIL_KEY]) if _TAIL_KEY in omap \
            else ZERO_VERSION
        head = entries[-1].version if entries else tail
        self.pg_log = PGLog(IndexedLog(entries, head=head, tail=tail))

    def persist_log(self) -> None:
        """Rewrite the whole durable log (shared transaction builder
        with ReplicatedPGShard — non-log pgmeta keys survive)."""
        from .replicated_backend import build_persist_log_txn
        self.store.queue_transaction(
            build_persist_log_txn(self.store, self.cid,
                                  self.pg_log.log))

    def log_info(self) -> tuple:
        """(last_update, log_tail) — the pg_info_t core GetInfo
        exchanges."""
        return self.pg_log.log.head, self.pg_log.log.tail

    def _append_log_durable(self, entries: list) -> None:
        from ..common.options import global_config
        from ..msg import encoding as wire
        from .replicated_backend import _TAIL_KEY, _log_key, PGMETA
        txn = Transaction()
        txn.touch(self.cid, PGMETA)
        txn.omap_setkeys(self.cid, PGMETA,
                         {_log_key(e.version): wire.encode(e)
                          for e in entries})
        cfg = global_config()
        if len(self.pg_log.log) > cfg["osd_max_pg_log_entries"]:
            keep = cfg["osd_min_pg_log_entries"]
            dropped = self.pg_log.log.entries[:-keep]
            if dropped:
                txn.omap_rmkeys(self.cid, PGMETA,
                                [_log_key(e.version) for e in dropped])
                self.pg_log.log.entries = \
                    self.pg_log.log.entries[-keep:]
                self.pg_log.log.tail = dropped[-1].version
                self.pg_log.log.index()
                txn.omap_setkeys(self.cid, PGMETA, {
                    _TAIL_KEY: wire.encode(self.pg_log.log.tail)})
        self.store.queue_transaction(txn)

    # -- write side (ref: ECBackend.cc:912 handle_sub_write) -----------
    def handle_sub_write(self, m: ECSubWrite) -> ECSubWriteReply:
        try:
            if m.guard_version is not None and m.oid and \
                    self._local_version(
                        m.oid,
                        shard=m.shard if m.shard >= 0
                        else self.shard) > tuple(m.guard_version):
                # recovery push planned before a newer client write
                # landed here: the local copy is already authoritative,
                # rolling it back would lose the write.  Ack success —
                # the pushing primary's goal (shard at >= guard) holds.
                return ECSubWriteReply(pgid=self.pgid, tid=m.tid,
                                       shard=self.shard, committed=True)
            if m.txn is not None and not m.txn.empty():
                self.store.queue_transaction(m.txn)
            if m.fabric_key is not None:
                self._apply_fabric_write(m)
            fresh = [e for e in m.log_entries
                     if e.version > self.pg_log.log.head]
            for e in fresh:
                self.pg_log.append(e)
            if fresh:
                self._append_log_durable(fresh)
            committed = True
        except (StoreError, KeyError, ValueError) as err:
            dout("osd", 0).write("%s shard %s sub_write failed: %s",
                                 self.pgid, self.shard, err)
            committed = False
        return ECSubWriteReply(pgid=self.pgid, tid=m.tid,
                               shard=self.shard, committed=committed)

    def _local_version(self, oid: str, shard: int | None = None) -> tuple:
        """Stored OI version of a chunk — `shard` defaults to this
        service's own index; guarded pushes check the INCOMING
        message's shard (a map-lagging receiver may serve a different
        index than the one being pushed)."""
        soid = ObjectId(oid, shard=self.shard if shard is None
                        else shard)
        try:
            v = self.store.getattr(self.cid, soid, OI_ATTR).get(
                "version", (0, 0))
        except StoreError:
            return (0, 0)
        return (v.epoch, v.version) if hasattr(v, "epoch") else \
            tuple(v) if v else (0, 0)

    def remove_shard_object(self, oid: str) -> None:
        """Drop the local chunk for `oid` (peering divergence: the
        authoritative interval does not know this entry — the chunk
        re-arrives through recovery at the authoritative version)."""
        soid = ObjectId(oid, shard=self.shard)
        if self.store.exists(self.cid, soid):
            self.store.queue_transaction(
                Transaction().remove(self.cid, soid))

    def _apply_fabric_write(self, m: ECSubWrite) -> None:
        """Device-mesh data path: gather this shard's chunk slice from
        the staged mesh arrays and apply it locally, maintaining the
        shard's own cumulative HashInfo (the control txn in `m.txn`
        carried everything else).  The mesh psum step replaced the
        chunk-byte fan-out (ref: ECBackend.cc:2037-2070)."""
        if self.fabric is None:
            raise StoreError("EIO", "fabric write but not resident")
        chunk = self.fabric.fetch_chunk(m.fabric_key, self.shard)
        soid = ObjectId(m.oid, shard=self.shard)
        hd = self._hinfo(soid)
        if m.hinfo_append:
            if m.chunk_off == 0:
                hd = HashInfo(self.k + self.m)    # fresh stream
            elif hd is None or not hd.has_chunk_hash() or \
                    hd.get_total_chunk_size() != m.chunk_off:
                hd = None                         # history broken
            if hd is not None:
                hd.append_shard(self.shard, m.chunk_off, chunk)
        else:
            hd = None
        if hd is None:
            # overwrite / inconsistent history: size tracked,
            # cumulative hashes invalidated (host path does the same)
            old_total = 0
            prev = self._hinfo(soid)
            if prev is not None:
                old_total = prev.get_total_chunk_size()
            hd = HashInfo(0)
            hd.total_chunk_size = max(old_total,
                                      m.chunk_off + len(chunk))
        self.store.queue_transaction(
            Transaction()
            .write(self.cid, soid, m.chunk_off, chunk)
            .setattrs(self.cid, soid, {HINFO_ATTR: hd.to_dict()}))

    # -- read side (ref: ECBackend.cc:987 handle_sub_read) -------------
    def handle_sub_read(self, m: ECSubRead) -> ECSubReadReply:
        reply = ECSubReadReply(pgid=self.pgid, tid=m.tid,
                               shard=self.shard)
        for oid, off, length in m.to_read:
            soid = ObjectId(oid, shard=self.shard)
            try:
                if self._is_whiteout(soid):
                    raise StoreError("ENOENT",
                                     f"{oid} deleted (whiteout)")
                buf = self.store.read(self.cid, soid, off, length)
                # integrity gate: full-stream reads verify the
                # cumulative shard crc (ref: ECBackend.cc:1059-1075)
                if off == 0 and length == 0:
                    hd = self._hinfo(soid)
                    if hd is not None and hd.has_chunk_hash() \
                            and hd.get_total_chunk_size() == len(buf):
                        from ..common.crc32c import crc32c
                        if crc32c(0xFFFFFFFF, buf) != \
                                hd.get_chunk_hash(self.shard):
                            raise StoreError(
                                "EIO", f"shard {self.shard} crc mismatch"
                                f" on {oid}")
                reply.buffers_read[oid] = buf
            except StoreError as err:
                reply.errors[oid] = err.errno_name
        # v2 sub-chunk repair reads: per-chunk extents expanded over
        # the local stream, replied as ONE concatenated repair-plane
        # buffer per oid (the clay helper read,
        # ref: ErasureCodeClay.cc:364 get_repair_subchunks; the crc
        # gate does not apply — partial ranges cannot re-hash the
        # cumulative stream, the rebuilt shard is crc-verified on its
        # next full read instead)
        for oid, extents in getattr(m, "subchunks", {}).items():
            soid = ObjectId(oid, shard=self.shard)
            try:
                if self._is_whiteout(soid):
                    raise StoreError("ENOENT",
                                     f"{oid} deleted (whiteout)")
                if m.chunk_size <= 0:
                    raise StoreError("EINVAL", "subchunks w/o chunk_size")
                stream_len = self.store.stat(self.cid, soid)["size"]
                abs_extents = ecutil.expand_stream_extents(
                    [tuple(e) for e in extents], m.chunk_size,
                    stream_len)
                reply.buffers_read[oid] = b"".join(
                    self.store.read(self.cid, soid, off, length)
                    for off, length in abs_extents)
            except (StoreError, ValueError) as err:
                reply.errors[oid] = getattr(err, "errno_name", "EIO")
        for oid in m.attrs_to_read:
            soid = ObjectId(oid, shard=self.shard)
            try:
                reply.attrs_read[oid] = self.store.getattrs(
                    self.cid, soid)
            except StoreError as err:
                reply.errors.setdefault(oid, err.errno_name)
        return reply

    def _hinfo(self, soid: ObjectId) -> Optional[HashInfo]:
        try:
            return HashInfo.from_dict(
                self.store.getattr(self.cid, soid, HINFO_ATTR))
        except StoreError:
            return None

    # -- metadata reads (user xattrs are replicated on every shard, so
    #    the primary's local shard serves them) ------------------------
    def getxattrs(self, oid: str) -> dict[str, bytes]:
        soid = ObjectId(oid, shard=self.shard)
        if not self.exists(oid):
            raise StoreError("ENOENT", oid)
        return mut.user_xattrs(self.store.getattrs(self.cid, soid))

    def getxattr(self, oid: str, name: str) -> bytes:
        xattrs = self.getxattrs(oid)
        if name not in xattrs:
            raise StoreError("ENODATA", f"{oid} xattr {name}")
        return xattrs[name]

    def object_size(self, oid: str) -> int:
        """Logical object size from the oi xattr."""
        soid = ObjectId(oid, shard=self.shard)
        try:
            return self.store.getattr(self.cid, soid, OI_ATTR)["size"]
        except StoreError:
            return 0

    def objects(self) -> list[str]:
        return sorted({o.name for o in self.store.collection_list(self.cid)
                       if o.name != "pgmeta"
                       and not self._is_whiteout(o)})

    def _is_whiteout(self, soid: ObjectId) -> bool:
        try:
            return bool(self.store.getattr(self.cid, soid,
                                           OI_ATTR).get("whiteout"))
        except StoreError:
            return False

    def shard_inventory(self) -> dict:
        return ec_store_inventory(self.store, self.cid)

    def collection_bytes(self) -> int:
        """Physical bytes this shard's collection stores (chunk
        streams) — the store-accounting feed for pg stats."""
        from .snap_mapper import collection_bytes
        return collection_bytes(self.store, self.cid)

    def stat_summary(self) -> tuple[int, int, int]:
        """(client_objects, logical_bytes, store_bytes) in ONE
        collection pass (same contract as the replicated shard's):
        an object counts while ANY local shard stream of it is
        non-whiteout; logical size reads this service's own shard OI
        like object_size does."""
        if not self.store.collection_exists(self.cid):
            return (0, 0, 0)
        store = 0
        live: set[str] = set()
        sizes: dict[str, int] = {}
        for o in self.store.collection_list(self.cid):
            try:
                store += self.store.stat(self.cid, o)["size"]
            except StoreError:
                continue
            if o.name == "pgmeta":
                continue
            try:
                oi = self.store.getattr(self.cid, o, OI_ATTR)
            except StoreError:
                oi = {}
            if not oi.get("whiteout"):
                live.add(o.name)
            if o.shard == self.shard:
                sizes[o.name] = oi.get("size", 0)
        return (len(live), sum(sizes.get(nm, 0) for nm in live),
                store)

    # -- fault injection: objectstore_debug_inject_read_err applied to
    #    EC chunk reads.  The store's marks are per-ObjectId and chunk
    #    streams are shard-qualified, so this is the hook that lets
    #    harnesses (thrasher EIO injection) target "this OSD's chunk
    #    of oid" without knowing the ghobject layout; the EIO then
    #    surfaces through handle_sub_read -> the primary's
    #    remaining-shard retry/decode, and through scrub_map ->
    #    shard rebuild.
    def inject_read_err(self, oid: str) -> None:
        self.store.inject_read_err(self.cid,
                                   ObjectId(oid, shard=self.shard))

    def clear_read_err(self, oid: str) -> None:
        self.store.clear_read_err(self.cid,
                                  ObjectId(oid, shard=self.shard))

    def exists(self, oid: str) -> bool:
        soid = ObjectId(oid, shard=self.shard)
        return self.store.exists(self.cid, soid) and \
            not self._is_whiteout(soid)

    def scrub_map(self, deep: bool = True) -> dict:
        """Per-object shard integrity for scrub: the stored chunk
        stream re-hashed against the HashInfo cumulative crc
        (ref: ECBackend.cc be_deep_scrub :2424).  Whiteout tombstones
        are reported (with their delete version) so a shard that missed
        a delete is flagged rather than 'repaired' by resurrection."""
        from ..common.crc32c import crc32c
        out: dict[str, dict] = {}
        for oid, shards in self.shard_inventory().items():
            entry_iv = shards.get(self.shard)
            if entry_iv is None:
                continue
            ver, whiteout = tuple(entry_iv[0]), bool(entry_iv[1])
            if whiteout:
                out[oid] = {"size": 0, "crc": None, "ok": True,
                            "version": ver, "whiteout": True}
                continue
            soid = ObjectId(oid, shard=self.shard)
            try:
                buf = self.store.read(self.cid, soid, 0, 0)
            except StoreError:
                out[oid] = {"size": -1, "crc": None, "ok": False,
                            "version": ver, "whiteout": False}
                continue
            entry = {"size": len(buf), "crc": None, "ok": True,
                     "version": ver, "whiteout": False}
            if deep:
                crc = int(crc32c(0xFFFFFFFF, buf))
                entry["crc"] = crc
                hd = self._hinfo(soid)
                if hd is not None and hd.has_chunk_hash():
                    # a truncated/extended stream is itself an
                    # inconsistency, not a reason to skip the check
                    entry["ok"] = (
                        hd.get_total_chunk_size() == len(buf) and
                        crc == hd.get_chunk_hash(self.shard))
                entry["attrs_crc"] = mut.meta_digest(mut.user_xattrs(
                    self.store.getattrs(self.cid, soid)))
            out[oid] = entry
        return out


# ------------------------------------------------------------------ primary


@dataclass
class _Write:
    """One RMW pipeline op (ref: ECBackend.h Op).

    The client's mutation vector is classified when the op leaves
    waiting_state (all earlier same-object ops committed, so sizes are
    stable): `effect` holds the single data effect as
    ("write", off, data) / ("truncate", size) / ("full", data) / None
    (metadata-only); meta mutations ride along into every shard txn."""
    tid: int
    oid: str
    mutations: list
    delete: bool
    version: EVersion
    on_all_commit: Callable
    # pipeline state
    effect: Optional[tuple] = None
    meta: list = field(default_factory=list)
    reads_needed: Optional[tuple[int, int]] = None   # logical (off,len)
    reads_ready: bool = False    # RMW reads landed (or none needed)
    read_error: bool = False
    old_segment: bytes = b""
    pending_shards: set = field(default_factory=set)
    failed_shards: set = field(default_factory=set)
    log_entry: Optional[PGLogEntry] = None
    phase: str = "state"      # state -> reads -> commit -> done
    trace: Optional[dict] = None      # blkin context for fan-out spans
    # ICI-fabric staging (set when the write rode the device mesh)
    fabric_key: Optional[tuple] = None
    chunk_off: int = 0
    hinfo_append: bool = False


@dataclass
class _Read:
    tid: int
    reads: dict                     # oid -> (off, len)
    on_complete: Callable
    for_recovery: bool = False
    want_attrs: bool = False
    pending_shards: set = field(default_factory=set)
    shard_bufs: dict = field(default_factory=dict)   # oid -> {shard: buf}
    shard_attrs: dict = field(default_factory=dict)  # oid -> {shard: attrs}
    shard_errs: dict = field(default_factory=dict)   # oid -> {shard: err}
    retried: bool = False
    #: oid -> (chunk_off, chunk_len, logical_base); (0,0,0)=full stream
    chunk_windows: dict = field(default_factory=dict)
    trace: Optional[dict] = None      # blkin context for decode spans


class ECBackend:
    """Primary-side engine for one EC PG.

    `send(shard_index, msg)` delivers a message to the acting OSD
    holding that shard (the harness/daemon wires this to the
    messenger); the local shard is invoked inline like the reference's
    self-dispatch (ref: ECBackend.cc:2060,2073).
    """

    def __init__(self, pgid, ec, whoami: int,
                 acting: list[int],
                 local_shard: ECPGShard,
                 send: Callable[[int, object], bool],
                 epoch: int = 1, tid_gen=None, fabric=None,
                 send_osd: Callable[[int, object], bool] | None = None):
        self.pgid = pgid
        self.ec = ec
        #: ICIFabric when the acting set can be device-mesh co-resident
        #: (dist/fabric.py); None or non-covering acting sets use the
        #: host encode + messenger chunk fan-out
        self.fabric = fabric
        self.k = ec.get_data_chunk_count()
        self.m = ec.get_coding_chunk_count()
        cs = ec.get_chunk_size(self.k * 4096)
        self.sinfo = StripeInfo(self.k, self.k * cs)
        self.whoami = whoami
        self.acting = list(acting)
        self.local_shard = local_shard
        self.send = send
        #: OSD-id addressed send for pushes outside the acting set
        #: (EC backfill targets); shard-index send covers everything
        #: else
        self.send_osd = send_osd or (lambda _osd, _msg: False)
        self.epoch = epoch
        self.last_version = ZERO_VERSION
        self.committed_to = ZERO_VERSION
        # missing per shard index (peering fills this; harness may too)
        self.peer_missing: dict[int, PGMissing] = {
            s: PGMissing() for s in range(len(acting))}
        self._tid = 0
        # optional shared generator: a daemon rebuilding backends after
        # a map change must not restart tids or a stale sub-reply could
        # alias a new op
        self._tid_gen = tid_gen
        from ..common.lockdep import make_lock
        # name carries the daemon identity: several OSDs share one
        # process in tests, and lockdep must see osd.0's and osd.1's
        # backends for one PG as DIFFERENT locks
        self._lock = make_lock(f"osd.{whoami}.ecbackend.{pgid}")
        # the three-queue pipeline (ref: ECBackend.h waiting_state/
        # waiting_reads/waiting_commit)
        self.waiting_state: list[_Write] = []
        self.waiting_reads: list[_Write] = []
        self.waiting_commit: list[_Write] = []
        self._checking = False      # _check_ops re-entrancy guard
        self._recheck = False
        self.tid_to_op: dict[int, _Write] = {}
        self.in_flight_reads: dict[int, _Read] = {}
        #: span sink for the encode/decode kernel regions —
        #: the owning daemon points this at its Tracer; None (library
        #: use, tracing off) costs nothing on the hot path
        self.tracer = None
        #: PerfCounters sink (the owning daemon's) for the recovery
        #: bandwidth pair: recovery_bytes_read (helper bytes pulled
        #: over the wire) / recovery_bytes_rebuilt (chunk bytes pushed
        #: to targets) — how the sub-chunk repair saving is proven
        self.perf = None
        #: in-flight sub-chunk repair state: tid -> dict
        self._sub_repairs: dict[int, dict] = {}

    def _perf_inc(self, key: str, n: int = 1) -> None:
        if self.perf is not None and n:
            self.perf.inc(key, n)

    # -- utilities ------------------------------------------------------
    def _next_tid(self) -> int:
        if self._tid_gen is not None:
            return next(self._tid_gen)
        self._tid += 1
        return self._tid

    def fail_in_flight(self) -> None:
        """Abort every queued/pending op with failure callbacks — used
        when the daemon tears a backend down on an acting-set change so
        no client op is silently dropped (the reference requeues
        through peering; see PG::on_change)."""
        with self._lock:
            writes = list(self.tid_to_op.values())
            reads = list(self.in_flight_reads.values())
            subs = list(self._sub_repairs.values())
            self.tid_to_op.clear()
            self.in_flight_reads.clear()
            self._sub_repairs.clear()
            self.waiting_state.clear()
            self.waiting_reads.clear()
            self.waiting_commit.clear()
        for op in writes:
            if op.fabric_key is not None and self.fabric is not None:
                self.fabric.release(op.fabric_key)
            op.on_all_commit(False)
        for rd in reads:
            rd.on_complete({}, {oid: "ESTALE" for oid in rd.reads})
        for job in subs:
            # sub-chunk repair jobs carry their completion separately
            # (their _Read's on_complete is a placeholder) — fail them
            # explicitly so recovery accounting never hangs
            job["on_done"](False)

    def _next_version(self) -> EVersion:
        self.last_version = EVersion(self.epoch,
                                     self.last_version.version + 1)
        return self.last_version

    def _alive_shards(self) -> list[int]:
        return [s for s in range(len(self.acting))
                if self.acting[s] >= 0]

    def _avail_shards(self, oid: str) -> list[int]:
        """Shards that exist and are not missing the object
        (ref: ECBackend.cc:1526 get_all_avail_shards)."""
        out = []
        for s in self._alive_shards():
            missing = self.peer_missing.get(s)
            if missing is not None and missing.is_missing(oid):
                continue
            out.append(s)
        return out

    def object_size(self, oid: str) -> int:
        return self.local_shard.object_size(oid)

    # ==================================================================
    # write path (ref: ECBackend.cc:1479 submit_transaction,
    #             :1832 start_rmw, :2138 check_ops)
    # ==================================================================
    def submit_transaction(self, oid: str, muts: list,
                           on_all_commit: Callable,
                           snapc: dict | None = None,
                           trace: dict | None = None) -> int:
        # snapc ignored: EC pools don't support snapshots here
        with self._lock:
            tid = self._next_tid()
            # a write against an object the primary shard is missing
            # would RMW against a phantom size-0 object and fan out
            # corrupted stripes; the reference blocks such ops until
            # recovery (PrimaryLogPG wait_for_unreadable_object) — here
            # the op is rejected and the caller must recover first
            pm = self.peer_missing.get(self.local_shard.shard)
            if pm is not None and pm.is_missing(oid):
                on_all_commit(False)
                return tid
            delete = mut.is_delete(muts)
            op = _Write(tid=tid, oid=oid, mutations=list(muts),
                        delete=delete, version=self._next_version(),
                        on_all_commit=on_all_commit)
            op.trace = trace
            op.log_entry = PGLogEntry(
                DELETE if delete else MODIFY, oid, op.version,
                prior_version=self._object_prior_version(oid))
            self.tid_to_op[tid] = op
            self.waiting_state.append(op)
            self._check_ops()
            return tid

    def _object_prior_version(self, oid: str) -> EVersion:
        e = self.local_shard.pg_log.log.objects.get(oid)
        return e.version if e is not None else ZERO_VERSION

    def _check_ops(self) -> None:
        """Drain the pipeline in order (ref: ECBackend.cc:2138
        check_ops: state->reads may pipeline, reads->commit is strictly
        FIFO so sub-writes hit every shard in version order).

        Re-entrancy-safe: inline replies during a fan-out loop recurse
        into this method; the nested call must NOT advance the pipeline
        (it would interleave a later op's sub-writes ahead of the
        current op's remaining sends) — it just flags the outer frame
        to loop again."""
        if self._checking:
            self._recheck = True
            return
        self._checking = True
        try:
            while True:
                self._recheck = False
                progress = self._try_state_to_reads()
                progress = self._try_reads_to_commit() or progress
                if not progress and not self._recheck:
                    break
        finally:
            self._checking = False
        self._try_finish_commits()

    def _try_state_to_reads(self) -> bool:
        """(ref: ECBackend.cc:1858 try_state_to_reads)"""
        if not self.waiting_state:
            return False
        op = self.waiting_state[0]
        # per-object ordering: an earlier in-flight op on the same
        # object must commit first so the RMW read sees its data (the
        # reference serializes via the ExtentCache)
        for other in self.waiting_reads + self.waiting_commit:
            if other.oid == op.oid:
                return False
        self.waiting_state.pop(0)
        op.phase = "reads"
        self.waiting_reads.append(op)
        if op.delete:
            op.reads_ready = True
            return True
        self._classify(op)
        plan = self._write_plan(op)
        if plan is None:
            op.reads_ready = True         # aligned append: no reads
            return True
        op.reads_needed = plan
        off, length = plan
        self.objects_read_and_reconstruct(
            {op.oid: (off, length)},
            lambda results, errors, op=op: self._rmw_reads_done(
                op, results, errors))
        return True

    def _classify(self, op: _Write) -> None:
        """Resolve the mutation vector against the now-stable object
        size into one data effect + the metadata tail
        (ref: ECTransaction::get_write_plan derives the same per-op
        extent plan)."""
        op.meta = mut.meta_mutations(op.mutations)
        op.effect = None
        size = self.object_size(op.oid)
        for m in mut.data_mutations(op.mutations):
            kind = m[0]
            if kind == mut.M_WRITE:
                op.effect = ("write", m[1], m[2])
            elif kind == mut.M_APPEND:
                op.effect = ("write", size, m[1])
            elif kind == mut.M_WRITEFULL:
                op.effect = ("full", m[1])
            elif kind == mut.M_ZERO:
                off, length = m[1], m[2]
                end = min(off + length, size)
                if end > off:       # zero never extends (librados)
                    op.effect = ("write", off, b"\0" * (end - off))
            elif kind == mut.M_TRUNCATE:
                t = m[1]
                if t == size:
                    op.effect = None
                elif t > size:
                    # extending truncate materializes the zero tail so
                    # reconstructing reads see real chunks
                    op.effect = ("write", size, b"\0" * (t - size))
                else:
                    op.effect = ("truncate", t)

    def _try_reads_to_commit(self) -> bool:
        """Commit ONLY the front of waiting_reads once its reads are in
        (ref: ECBackend.cc:1932 try_reads_to_commit operates on
        waiting_reads.front()) — later ops never overtake, so shards
        receive sub-writes in version order."""
        progressed = False
        while self.waiting_reads and \
                getattr(self.waiting_reads[0], "reads_ready", False):
            op = self.waiting_reads.pop(0)
            if getattr(op, "read_error", False):
                self._finish(op, ok=False)
            else:
                self._start_commit(op)
            progressed = True
        return progressed

    def _write_plan(self, op: _Write) -> Optional[tuple[int, int]]:
        """Which logical range must be read before this op can be
        encoded (ref: ECTransaction.h get_write_plan: the stripes the
        write only partially overwrites).  None = no RMW read."""
        if op.effect is None or op.effect[0] == "full":
            return None                  # metadata-only / full replace
        old_size = self.object_size(op.oid)
        if old_size == 0:
            return None
        if op.effect[0] == "truncate":
            # keep the partial tail stripe's surviving bytes
            t = op.effect[1]
            start = self.sinfo.logical_to_prev_stripe_offset(t)
            return None if t == start else (start, t - start)
        _, offset, data = op.effect
        start, length = self.sinfo.offset_len_to_stripe_bounds(
            (offset, max(len(data), 1)))
        old_aligned = self.sinfo.logical_to_next_stripe_offset(old_size)
        read_start = start
        read_end = min(start + length, old_aligned)
        if read_start >= read_end:
            return None                  # pure append past old data
        # full-stripe overwrite of existing stripes still merges with
        # nothing — skip the read when the write covers those stripes
        # entirely
        w_start, w_end = offset, offset + len(data)
        if w_start <= read_start and w_end >= read_end:
            return None
        return (read_start, read_end - read_start)

    def _rmw_reads_done(self, op: _Write, results: dict,
                        errors: dict) -> None:
        with self._lock:
            if errors.get(op.oid):
                op.read_error = True
            else:
                op.old_segment = results.get(op.oid, b"")
            op.reads_ready = True
            self._check_ops()

    def _start_commit(self, op: _Write) -> None:
        """Encode + fan out per-shard transactions."""
        op.phase = "commit"
        self.waiting_commit.append(op)
        if op.delete:
            # versioned whiteout tombstone per shard (like the
            # replicated path): a stale shard returning after the
            # delete loses to the tombstone in recovery instead of
            # resurrecting the object
            cid = pg_cid(self.pgid)
            ver = (op.version.epoch, op.version.version)
            shard_txns = {
                s: ec_tombstone_txn(cid, op.oid, s, ver,
                                    self.k + self.m)
                for s in self._alive_shards()}
            new_size = 0
            shards = {}
        elif op.effect is None:
            shard_txns = self._meta_txns(op)
        else:
            shards, shard_txns, new_size = self._encode_write(op)
        op.pending_shards = set(shard_txns)
        for s, txn in shard_txns.items():
            msg = ECSubWrite(pgid=self.pgid, tid=op.tid, shard=s,
                             txn=txn, log_entries=[op.log_entry],
                             trace=child_of(op.trace),
                             oid=op.oid, fabric_key=op.fabric_key,
                             chunk_off=op.chunk_off,
                             hinfo_append=op.hinfo_append)
            if self.acting[s] == self.whoami:
                reply = self.local_shard.handle_sub_write(msg)
                self._on_write_reply(op, reply)
            else:
                if not self.send(s, msg):
                    op.failed_shards.add(s)
                    op.pending_shards.discard(s)
        self._maybe_commit_done(op)

    def _apply_meta(self, txn: Transaction, cid: str, soid,
                    metas: list) -> None:
        """Apply the metadata tail of a mutation vector to one shard's
        txn.  User xattrs live on EVERY shard (the reference stores
        attrs with each shard object — ECTransaction::generate_
        transactions setattrs fan out identically)."""
        for m in metas:
            if m[0] == mut.M_SETXATTRS:
                txn.setattrs(cid, soid, {mut.uxattr_key(k): bytes(v)
                                         for k, v in m[1].items()})
            elif m[0] == mut.M_RMXATTR:
                txn.rmattr(cid, soid, mut.uxattr_key(m[1]))
            # M_CREATE: the leading touch creates the shard object

    def _meta_txns(self, op: _Write) -> dict[int, Transaction]:
        """Metadata-only transaction: no encode, per-shard attr
        updates + version bump."""
        cid = pg_cid(self.pgid)
        size = self.object_size(op.oid)
        existed = self.local_shard.exists(op.oid)
        txns = {}
        for s in self._alive_shards():
            soid = ObjectId(op.oid, shard=s)
            txn = Transaction().touch(cid, soid)
            self._apply_meta(txn, cid, soid, op.meta)
            attrs = {OI_ATTR: {"size": size,
                               "version": (op.version.epoch,
                                           op.version.version)}}
            if not existed:
                attrs[HINFO_ATTR] = HashInfo(self.k + self.m).to_dict()
            txn.setattrs(cid, soid, attrs)
            txns[s] = txn
        return txns

    def _encode_write(self, op: _Write):
        """Merge old+new logical bytes, batch-encode, build shard txns."""
        sinfo = self.sinfo
        old_size = self.object_size(op.oid)
        kind = op.effect[0]
        if kind == "full":
            data = op.effect[1]
            offset, start = 0, 0
            length = sinfo.logical_to_next_stripe_offset(len(data))
            new_size = len(data)
        elif kind == "truncate":
            t = op.effect[1]
            start = sinfo.logical_to_prev_stripe_offset(t)
            offset, data = start, b""
            length = sinfo.logical_to_next_stripe_offset(t) - start
            new_size = t
        else:
            _, offset, data = op.effect
            start, length = sinfo.offset_len_to_stripe_bounds(
                (offset, max(len(data), 1)))
            new_size = max(old_size, offset + len(data))
        seg = bytearray(length)
        if op.old_segment:
            seg[:len(op.old_segment)] = op.old_segment
        if kind == "truncate":
            # drop everything past the new end within the tail stripe
            seg = seg[:op.effect[1] - start]
            seg += b"\0" * (-len(seg) % sinfo.stripe_width)
        rel = offset - start
        seg[rel:rel + len(data)] = data
        chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(start)
        cid = pg_cid(self.pgid)

        # ICI-fabric path: encode + chunk fan-out as one mesh collective
        # step; messages become control-plane only (ref: the per-shard
        # fan-out this replaces, ECBackend.cc:2037-2070)
        if (self.fabric is not None and seg
                and kind in ("write", "full")
                and self.fabric.covers(
                    [self.acting[s] for s in self._alive_shards()])
                and self.fabric.supports(self.ec)):
            return self._encode_write_fabric(op, kind, bytes(seg),
                                             start, chunk_off,
                                             old_size, new_size)
        # kernel span, only when this op is traced: ecutil.encode
        # returns host bytes, so the device launch has finished by the
        # time the span closes —
        # the staged-encode cost shows up as its own span instead of
        # hiding inside the osd_op (ref: the ECBackend.cc:1508 trace
        # events around the encode)
        ksp = None if self.tracer is None else \
            self.tracer.start_span(child_of(op.trace),
                                   "ec_encode_kernel")
        shards = ecutil.encode(sinfo, self.ec, bytes(seg))
        if ksp is not None:
            ksp.event(f"bytes={len(seg)} k={self.k} m={self.m}")
            self.tracer.finish(ksp)

        # cumulative hinfo only survives pure stripe-aligned appends:
        # start is stripe-aligned, so start == old_size iff the old
        # object ended exactly on a stripe boundary and this write
        # begins there (ref: the reference maintains HashInfo for
        # appends; ec overwrites invalidate it)
        # a full replace re-encodes the whole stream, so its hinfo is
        # rebuilt fresh (cumulative from chunk 0) rather than invalidated
        is_append = (start == old_size and kind == "write") \
            or kind == "full"
        old_hinfo = None if kind == "full" else self.local_shard._hinfo(
            ObjectId(op.oid, shard=self.local_shard.shard))
        # one hinfo for all shards (it carries every shard's hash);
        # computed once — _next_hinfo advances the cumulative state
        if kind == "truncate":
            hi = HashInfo(0)
            hi.total_chunk_size = chunk_off + (
                len(next(iter(shards.values()))) if shards else 0)
            hi_dict = hi.to_dict()
        else:
            hi_dict = self._next_hinfo(
                old_hinfo, chunk_off, shards, is_append).to_dict()
        txns = {}
        for s in self._alive_shards():
            soid = ObjectId(op.oid, shard=s)
            txn = Transaction()
            txn.touch(cid, soid)
            if kind in ("full", "truncate"):
                # discard shard bytes past the new chunk extent
                txn.truncate(cid, soid, chunk_off)
            if shards.get(s, b"") or kind == "write":
                txn.write(cid, soid, chunk_off, shards.get(s, b""))
            txn.setattrs(cid, soid, {
                OI_ATTR: {"size": new_size,
                          "version": (op.version.epoch,
                                      op.version.version)},
                HINFO_ATTR: hi_dict,
            })
            self._apply_meta(txn, cid, soid, op.meta)
            txns[s] = txn
        return shards, txns, new_size

    def _encode_write_fabric(self, op: _Write, kind: str, seg: bytes,
                             start: int, chunk_off: int,
                             old_size: int, new_size: int):
        """Stage the encode on the device mesh; per-shard txns carry
        only control metadata (touch/truncate/oi/meta) — each shard
        gathers its chunk slice from the mesh and maintains its own
        HashInfo locally (ECPGShard._apply_fabric_write)."""
        key = (self.pgid, op.tid)
        self.fabric.stage_encode(key, self.ec, seg,
                                 self.sinfo.chunk_size)
        op.fabric_key = key
        op.chunk_off = chunk_off
        op.hinfo_append = (start == old_size and kind == "write") \
            or kind == "full"
        cid = pg_cid(self.pgid)
        txns = {}
        for s in self._alive_shards():
            soid = ObjectId(op.oid, shard=s)
            txn = Transaction()
            txn.touch(cid, soid)
            if kind == "full":
                txn.truncate(cid, soid, chunk_off)
            txn.setattrs(cid, soid, {
                OI_ATTR: {"size": new_size,
                          "version": (op.version.epoch,
                                      op.version.version)}})
            self._apply_meta(txn, cid, soid, op.meta)
            txns[s] = txn
        return {}, txns, new_size

    def _next_hinfo(self, old: Optional[HashInfo], chunk_off: int,
                    shards: dict, is_append: bool) -> HashInfo:
        if is_append:
            hi = old if old is not None else HashInfo(self.k + self.m)
            if not shards:                 # empty write (object create)
                return hi
            if hi.has_chunk_hash() \
                    and hi.get_total_chunk_size() == chunk_off:
                hi.append(chunk_off, shards)
                return hi
        # overwrite (or inconsistent history): size still tracked,
        # cumulative chunk hashes invalidated
        hi = HashInfo(0)
        sz = chunk_off + (len(next(iter(shards.values()))) if shards else 0)
        if old is not None:
            sz = max(sz, old.get_total_chunk_size())
        hi.total_chunk_size = sz
        return hi

    def handle_sub_write_reply(self, m: ECSubWriteReply) -> None:
        """(ref: ECBackend.cc:1122)"""
        with self._lock:
            op = self.tid_to_op.get(m.tid)
            if op is None:
                return
            self._on_write_reply(op, m)
            self._maybe_commit_done(op)
            self._check_ops()

    def _on_write_reply(self, op: _Write, m: ECSubWriteReply) -> None:
        op.pending_shards.discard(m.shard)
        if not m.committed:
            op.failed_shards.add(m.shard)

    def _maybe_commit_done(self, op: _Write) -> None:
        if op.phase == "commit" and not op.pending_shards:
            self._finish(op, ok=not op.failed_shards)

    def _finish(self, op: _Write, ok: bool) -> None:
        if op in self.waiting_commit:
            self.waiting_commit.remove(op)
        if op.fabric_key is not None and self.fabric is not None:
            self.fabric.release(op.fabric_key)
        op.phase = "done"
        op.ok = ok
        self._try_finish_commits()

    def _try_finish_commits(self) -> None:
        """Complete client callbacks strictly in tid order
        (ref: the reference completes via in-order check_ops)."""
        while self.tid_to_op:
            first_tid = min(self.tid_to_op)
            op = self.tid_to_op[first_tid]
            if op.phase != "done":
                break
            del self.tid_to_op[first_tid]
            if getattr(op, "ok", False):
                self.committed_to = max(self.committed_to, op.version)
            op.on_all_commit(getattr(op, "ok", False))

    # ==================================================================
    # read path (ref: ECBackend.h:139 objects_read_and_reconstruct,
    #            ECBackend.cc:1590 get_min_avail_to_read_shards)
    # ==================================================================
    def objects_read_and_reconstruct(
            self, reads: dict, on_complete: Callable,
            for_recovery: bool = False,
            want_attrs: bool = False,
            trace: dict | None = None) -> None:
        with self._lock:
            tid = self._next_tid()
            rd = _Read(tid=tid, reads=dict(reads),
                       on_complete=on_complete,
                       for_recovery=for_recovery,
                       want_attrs=want_attrs, trace=trace)
            # translate each logical window into a per-shard chunk
            # window so a small read never pulls whole shard streams
            # (ref: ECBackend.cc:1590 builds per-shard offset/len
            # lists the same way); (0, 0) = full stream (crc gate)
            rd.chunk_windows = {}
            for oid, window in rd.reads.items():
                if window is None or window[1] == 0:
                    rd.chunk_windows[oid] = (0, 0, 0)
                else:
                    s_off, s_len = self.sinfo.offset_len_to_stripe_bounds(
                        window)
                    rd.chunk_windows[oid] = (
                        self.sinfo.aligned_logical_offset_to_chunk_offset(
                            s_off),
                        self.sinfo.aligned_logical_offset_to_chunk_offset(
                            s_len),
                        s_off)
            # choose shards: minimum_to_decode over available shards
            want_chunks = set(range(self.k + self.m)) if for_recovery \
                else {self.ec.chunk_index(i) for i in range(self.k)}
            per_shard: dict[int, list] = {}
            errors: dict[str, str] = {}
            for oid in rd.reads:
                avail = set(self._avail_shards(oid))
                try:
                    need = self.ec.minimum_to_decode(
                        want_chunks & set(range(self.k + self.m)),
                        avail)
                except Exception:
                    errors[oid] = "EIO"
                    continue
                for s in need:
                    per_shard.setdefault(s, []).append(oid)
            if errors and len(errors) == len(rd.reads):
                on_complete({}, errors)
                return
            self.in_flight_reads[tid] = rd
            rd.pending_shards = set(per_shard)
            for s, oids in per_shard.items():
                self._dispatch_read(rd, s, self._sub_read_msg(rd, s, oids))
            self._maybe_read_done(rd)

    def _sub_read_msg(self, rd: _Read, s: int, oids) -> ECSubRead:
        return ECSubRead(
            pgid=self.pgid, tid=rd.tid, shard=s,
            to_read=[(oid,) + rd.chunk_windows[oid][:2] for oid in oids],
            attrs_to_read=list(oids) if rd.want_attrs else [],
            trace=child_of(rd.trace))

    def _dispatch_read(self, rd: _Read, s: int, msg: ECSubRead) -> None:
        if self.acting[s] == self.whoami:
            reply = self.local_shard.handle_sub_read(msg)
            self._on_read_reply(rd, reply)
        else:
            if not self.send(s, msg):
                rd.pending_shards.discard(s)
                for oid, _, _ in msg.to_read:
                    rd.shard_errs.setdefault(oid, {})[s] = "ECONNREFUSED"

    def handle_sub_read_reply(self, m: ECSubReadReply) -> None:
        """(ref: ECBackend.cc:1155)"""
        with self._lock:
            rd = self.in_flight_reads.get(m.tid)
            if rd is None:
                return
            self._on_read_reply(rd, m)
            self._maybe_read_done(rd)

    def _on_read_reply(self, rd: _Read, m: ECSubReadReply) -> None:
        rd.pending_shards.discard(m.shard)
        for oid, buf in m.buffers_read.items():
            rd.shard_bufs.setdefault(oid, {})[m.shard] = buf
        for oid, attrs in m.attrs_read.items():
            rd.shard_attrs.setdefault(oid, {})[m.shard] = attrs
        for oid, err in m.errors.items():
            rd.shard_errs.setdefault(oid, {})[m.shard] = err

    def _maybe_read_done(self, rd: _Read) -> None:
        # in_flight membership doubles as the completion guard: inline
        # (same-thread) replies can finish the read while the dispatch
        # loop is still running, and the loop's final check must not
        # complete it a second time
        if rd.pending_shards or rd.tid not in self.in_flight_reads:
            return
        sub_job = self._sub_repairs.pop(rd.tid, None)
        if sub_job is not None:
            # sub-chunk repair reads don't retry shard-by-shard: any
            # miss falls back to the full-chunk rebuild wholesale
            self.in_flight_reads.pop(rd.tid, None)
            self._complete_subchunk_repair(rd, sub_job)
            return
        # errors? try remaining shards once
        # (ref: ECBackend.cc:1628 get_remaining_shards retry)
        needs_retry = []
        for oid in rd.reads:
            errs = rd.shard_errs.get(oid, {})
            if not errs:
                continue
            got = set(rd.shard_bufs.get(oid, {}))
            remaining = [s for s in self._avail_shards(oid)
                         if s not in got and s not in errs]
            if len(got) < self.k and remaining and not rd.retried:
                needs_retry.extend(
                    (oid, s) for s in
                    remaining[:self.k - len(got)])
        if needs_retry:
            rd.retried = True
            per_shard: dict[int, list] = {}
            for oid, s in needs_retry:
                per_shard.setdefault(s, []).append(oid)
            rd.pending_shards |= set(per_shard)
            for s, oids in per_shard.items():
                self._dispatch_read(rd, s, self._sub_read_msg(rd, s, oids))
            # an inline retry reply may have recursed and completed the
            # read already — re-check both guards before falling through
            if rd.pending_shards or rd.tid not in self.in_flight_reads:
                return
        self.in_flight_reads.pop(rd.tid, None)
        self._complete_read(rd)

    def _complete_read(self, rd: _Read) -> None:
        results: dict[str, bytes] = {}
        errors: dict[str, str] = {}
        if rd.for_recovery:
            # recovery-bandwidth accounting: every helper byte this
            # rebuild pulled over the wire (the number sub-chunk
            # repair shrinks)
            self._perf_inc("recovery_bytes_read", sum(
                len(b) for per in rd.shard_bufs.values()
                for b in per.values()))
        for oid, window in rd.reads.items():
            bufs = {s: b for s, b in rd.shard_bufs.get(oid, {}).items()}
            if len(bufs) < self.k:
                errors[oid] = "EIO"
                continue
            base = rd.chunk_windows[oid][2]   # logical offset of bufs[0]
            # kernel span when the read is traced: decode_concat's
            # output is host bytes, so survivor staging (the host-side
            # gather/stack that dominates decode_incl_stage in
            # BENCH_r05) AND the device decode are both inside the
            # span when it closes — and the two regions land as
            # `stage` / `kernel` CHILD spans so the split is visible
            # per op in SLO reports
            ksp = None if self.tracer is None or rd.trace is None \
                else self.tracer.start_span(child_of(rd.trace),
                                            "ec_decode_kernel")
            timings: dict | None = {} if ksp is not None else None
            logical = ecutil.decode_concat(self.sinfo, self.ec, bufs,
                                           timings=timings)
            if ksp is not None:
                ksp.event(f"shards={len(bufs)} "
                          f"bytes={len(logical)}")
                self.tracer.finish(ksp)
                kctx = {"trace_id": ksp.trace_id, "span": ksp.span_id,
                        "parent": ksp.parent}
                for stage_name in ("stage", "kernel"):
                    iv = (timings or {}).get(stage_name)
                    if iv is not None:
                        self.tracer.record_span(
                            child_of(kctx), stage_name, iv[0], iv[1])
            size = self._oi_size(rd, oid)
            # highest valid logical byte we can serve from this read
            limit = base + len(logical) if size is None \
                else min(size, base + len(logical))
            if window is None:
                off, length = base, max(limit - base, 0)
            else:
                off, length = window
                if length == 0:
                    length = max(limit - off, 0)
            end = min(off + length, limit)
            results[oid] = logical[max(off - base, 0):max(end - base, 0)]
        if rd.want_attrs:
            rd.on_complete(results, errors, rd.shard_attrs)
        else:
            rd.on_complete(results, errors)

    def _oi_size(self, rd: _Read, oid: str) -> Optional[int]:
        attrs = rd.shard_attrs.get(oid, {})
        for a in attrs.values():
            oi = a.get(OI_ATTR)
            if oi:
                return oi["size"]
        # distinguish "size 0" from "unknown": only a missing oi attr
        # means unknown (a falsy-0 fallback would pad empty objects
        # with a stripe of zeros)
        try:
            return self.local_shard.store.getattr(
                pg_cid(self.pgid),
                ObjectId(oid, shard=self.local_shard.shard),
                OI_ATTR)["size"]
        except StoreError:
            return None

    # ==================================================================
    # recovery (ref: ECBackend.cc:735 recover_object,
    #           :567 continue_recovery_op)
    # ==================================================================
    def recover_object(self, oid: str, target_shards,
                       on_done: Callable, version=None,
                       target_osds: dict | None = None) -> None:
        """Reconstruct `oid`'s chunks on target shards and push them.

        `version`: the authoritative object version to stamp on the
        rebuilt shards.  Callers whose pg_log was rebuilt (daemon
        peering/scrub) MUST pass it — the local prior-version fallback
        is only correct while the primary's log is intact.

        `target_osds`: optional {shard_index: osd} override for
        pushes outside the acting set — the EC backfill case, where a
        temp primary rebuilds chunks for the UP set's shards while
        the old acting set still serves (ref: ECBackend recovery
        pushing to backfill targets).

        Plan-driven recovery: when the plugin publishes a repair
        schedule for the erasure signature (ec.repair_schedule —
        clay's d-helper sub-chunk planes, lrc's l-survivor local
        parity group, matrix codes' k-survivor direct decode), the
        helpers serve only the plan's extents and the lost chunks
        rebuild through the signature's COMPILED repair program
        (ec/repairc: one gather / K1 / scatter launch, cached per
        signature) — no logical decode + re-encode.  Codes without a
        plan, any repair-read failure, or a plan that does not fit the
        helpers' buffers fall back to the wholesale full-chunk rebuild
        below; a fault of the kernel or the device propagates."""
        targets = sorted(set(target_shards))
        if self._try_subchunk_recover(oid, targets, on_done, version,
                                      target_osds):
            return
        self._recover_object_full(oid, targets, on_done, version,
                                  target_osds)

    def _recover_object_full(self, oid: str, targets, on_done,
                             version=None, target_osds=None) -> None:
        # read enough shards (+ attrs) to rebuild the logical object
        self.objects_read_and_reconstruct(
            {oid: None}, lambda r, e, a=None: self._recovery_reads_done(
                oid, targets, r, e, on_done, version, a, target_osds),
            for_recovery=True, want_attrs=True)

    # -- plan-driven (repair-bandwidth-optimal) rebuild ---------------
    def _try_subchunk_recover(self, oid: str, targets, on_done,
                              version=None, target_osds=None) -> bool:
        """Plan a compiled-program rebuild; False -> caller takes the
        full-chunk path (no plan for this erasure signature, or the
        helper set can't cover the plan's repair degree)."""
        avail = {s for s in self._avail_shards(oid)
                 if s not in set(targets)}
        plan = ecutil.repair_plan(self.ec, targets, avail)
        if plan is None or set(plan.lost) != set(targets):
            return False
        cs = self.sinfo.chunk_size
        try:
            byte_extents = plan.byte_extents(cs)
        except ValueError:
            return False
        with self._lock:
            tid = self._next_tid()
            rd = _Read(tid=tid, reads={oid: None},
                       on_complete=lambda *_: None,
                       for_recovery=True, want_attrs=True)
            self.in_flight_reads[tid] = rd
            self._sub_repairs[tid] = {
                "oid": oid, "plan": plan,
                "helpers": set(plan.helper_ids()),
                "on_done": on_done,
                "version": version, "target_osds": target_osds,
            }
            rd.pending_shards = set(plan.helper_ids())
            for s, extents in byte_extents.items():
                msg = ECSubRead(
                    pgid=self.pgid, tid=tid, shard=s,
                    to_read=[], attrs_to_read=[oid],
                    subchunks={oid: list(extents)}, chunk_size=cs,
                    trace=child_of(rd.trace))
                self._dispatch_read(rd, s, msg)
            self._maybe_read_done(rd)
        return True

    def _complete_subchunk_repair(self, rd: _Read, job: dict) -> None:
        oid, plan = job["oid"], job["plan"]
        on_done = job["on_done"]
        targets = list(plan.lost)
        bufs = rd.shard_bufs.get(oid, {})
        got = {s: bufs[s] for s in job["helpers"] if s in bufs}
        if set(got) != job["helpers"] or rd.shard_errs.get(oid):
            # any helper failure: fall back to the full-chunk rebuild
            # (it tolerates arbitrary shard sets via minimum_to_decode)
            self._recover_object_full(oid, targets, on_done,
                                      job["version"],
                                      job["target_osds"])
            return
        self._perf_inc("recovery_bytes_read",
                       sum(len(b) for b in got.values()))
        # only a plan error falls back: K1's wrapper, its launch, its
        # build and the device guard raise ValueError or RuntimeError,
        # and a fault there must not hide behind a slower path that
        # still returns the right bytes
        try:
            streams = ecutil.compiled_repair_streams(
                self.ec, plan, self.sinfo.chunk_size, got)
        except (RepairPlanError, ErasureCodeError) as ex:
            dout("osd", 0).write("%s compiled repair of %s failed: %r",
                                 self.pgid, oid, ex)
            self._recover_object_full(oid, targets, on_done,
                                      job["version"],
                                      job["target_osds"])
            return
        # authoritative metadata from the newest-oi helper: object
        # size/version, the shared HashInfo (it carries EVERY shard's
        # cumulative crc — including the rebuilt ones), user xattrs
        best = newest_oi_attrs(rd.shard_attrs.get(oid, {}))
        if best is None:
            self._recover_object_full(oid, targets, on_done,
                                      job["version"],
                                      job["target_osds"])
            return
        _, oi, hinfo_dict, user_attrs = best
        version = job["version"]
        if version is None:
            version = EVersion(*oi.get("version", (0, 0))) \
                if oi.get("version") else self._object_prior_version(oid)
        # one push per rebuilt shard; on_done fires once with the
        # aggregate outcome (the push_rebuilt contract)
        pending = set(targets)
        state = {"ok": True, "done": False}

        def agg(shard):
            def cb(committed):
                state["ok"] = state["ok"] and bool(committed)
                pending.discard(shard)
                if not pending and not state["done"]:
                    state["done"] = True
                    on_done(state["ok"])
            return cb

        for lost in targets:
            self._push_repaired_shard(
                oid, lost, streams[lost], oi.get("size", 0), version,
                hinfo_dict, user_attrs, agg(lost), job["target_osds"])

    def _push_repaired_shard(self, oid: str, shard: int, stream: bytes,
                             size: int, version, hinfo_dict,
                             user_attrs: dict, on_done,
                             target_osds=None) -> None:
        """Push ONE rebuilt chunk stream (the sub-chunk repair result)
        — the single-shard analogue of push_rebuilt, no re-encode."""
        with self._lock:
            cid = pg_cid(self.pgid)
            soid = ObjectId(oid, shard=shard)
            attrs = {OI_ATTR: {"size": size,
                               "version": (version.epoch,
                                           version.version)},
                     **{mut.uxattr_key(k): v
                        for k, v in user_attrs.items()}}
            if hinfo_dict is not None:
                attrs[HINFO_ATTR] = hinfo_dict
            txn = (Transaction()
                   .touch(cid, soid)
                   .truncate(cid, soid, 0)
                   .write(cid, soid, 0, stream)
                   .setattrs(cid, soid, attrs))
            tid = self._next_tid()
            msg = ECSubWrite(pgid=self.pgid, tid=tid, shard=shard,
                             txn=txn, log_entries=[], oid=oid,
                             guard_version=(version.epoch,
                                            version.version))
            self._perf_inc("recovery_bytes_rebuilt", len(stream))

            def reply_cb(s, committed, oid=oid):
                if committed:
                    pm = self.peer_missing.get(s)
                    if pm is not None:
                        pm.rm(oid)
                on_done(committed)

            dest = (dict(target_osds).get(shard)
                    if target_osds else
                    (self.acting[shard] if shard < len(self.acting)
                     else -1))
            if dest == self.whoami and shard == self.local_shard.shard:
                rep = self.local_shard.handle_sub_write(msg)
                reply_cb(shard, rep.committed)
                return
            self._recovery_cbs = getattr(self, "_recovery_cbs", {})
            self._recovery_cbs[tid] = (shard, reply_cb)
            send = (lambda m: self.send_osd(dest, m)) if target_osds \
                else (lambda m: self.send(shard, m))
            if dest is None or dest < 0 or not send(msg):
                self._recovery_cbs.pop(tid, None)
                reply_cb(shard, False)

    def _recovery_reads_done(self, oid: str, targets, results, errors,
                             on_done, version=None,
                             shard_attrs=None,
                             target_osds=None) -> None:
        if errors.get(oid) or oid not in results:
            on_done(False)
            return
        # authoritative user xattrs from the newest-oi surviving shard
        user_attrs: dict = {}
        best = newest_oi_attrs((shard_attrs or {}).get(oid, {}))
        if best is not None:
            user_attrs = best[3]
        self.push_rebuilt(oid, results[oid], targets, on_done,
                          version=version, user_attrs=user_attrs,
                          target_osds=target_osds)

    def push_rebuilt(self, oid: str, logical: bytes, targets,
                     on_done: Callable, version=None,
                     user_attrs: dict | None = None,
                     target_osds: dict | None = None) -> None:
        """Encode a rebuilt logical object and push its chunks to
        `targets` (shard indexes).  `target_osds` optionally overrides
        the destination OSD per shard — the EC peering statechart's
        backfill path rebuilds from cross-set sources and pushes to
        up-set shards outside the current acting set."""
        user_attrs = user_attrs or {}
        with self._lock:
            # re-encode the full object: every shard's chunk stream
            width = self.sinfo.stripe_width
            padded = logical + b"\0" * (-len(logical) % width)
            shards = ecutil.encode(self.sinfo, self.ec, padded)
            hinfo = HashInfo(self.k + self.m)
            if shards:
                hinfo.append(0, shards)
            size = len(logical)
            if version is None:
                version = self._object_prior_version(oid)
            cid = pg_cid(self.pgid)
            # all targets pending up front: an inline (synchronous)
            # reply mid-loop must not see an empty set and complete
            # the whole recovery early
            pending = set(targets)
            state = {"ok": True, "done": False}

            def reply_cb(s, committed):
                pending.discard(s)
                if committed:
                    # only the acked shard's missing entry clears
                    pm = self.peer_missing.get(s)
                    if pm is not None:
                        pm.rm(oid)
                else:
                    state["ok"] = False
                if not pending and not state["done"]:
                    state["done"] = True
                    on_done(state["ok"])

            self._recovery_cbs = getattr(self, "_recovery_cbs", {})
            osd_map = dict(target_osds) if target_osds else None
            if not targets:
                on_done(True)
                return
            self._perf_inc("recovery_bytes_rebuilt",
                           sum(len(shards.get(s, b"")) for s in targets))
            for s in targets:
                soid = ObjectId(oid, shard=s)
                txn = (Transaction()
                       .touch(cid, soid)
                       .truncate(cid, soid, 0)
                       .write(cid, soid, 0, shards.get(s, b""))
                       .setattrs(cid, soid, {
                           OI_ATTR: {"size": size,
                                     "version": (version.epoch,
                                                 version.version)},
                           HINFO_ATTR: hinfo.to_dict(),
                           **{mut.uxattr_key(k): v
                              for k, v in user_attrs.items()}}))
                tid = self._next_tid()
                msg = ECSubWrite(pgid=self.pgid, tid=tid, shard=s,
                                 txn=txn, log_entries=[], oid=oid,
                                 guard_version=(version.epoch,
                                                version.version))
                dest = osd_map.get(s) if osd_map else (
                    self.acting[s] if s < len(self.acting) else -1)
                if dest == self.whoami and \
                        s == self.local_shard.shard:
                    rep = self.local_shard.handle_sub_write(msg)
                    reply_cb(s, rep.committed)
                elif osd_map is not None:
                    self._recovery_cbs[tid] = (s, reply_cb)
                    if dest is None or dest < 0 or not self.send_osd(
                            dest, msg):
                        self._recovery_cbs.pop(tid, None)
                        reply_cb(s, False)
                else:
                    self._recovery_cbs[tid] = (s, reply_cb)
                    if not self.send(s, msg):
                        self._recovery_cbs.pop(tid, None)
                        reply_cb(s, False)

    def handle_recovery_write_reply(self, m: ECSubWriteReply) -> bool:
        """Route recovery push acks (returns True if consumed)."""
        with self._lock:
            cbs = getattr(self, "_recovery_cbs", {})
            entry = cbs.pop(m.tid, None)
            if entry is None:
                return False
            s, cb = entry
            cb(s, m.committed)
            return True
