"""ReplicatedBackend: the replicated-pool PG data plane.

The primary applies each write locally and fans whole-object segments
out to the replicas, acking the client once every acting shard
committed (ref: src/osd/ReplicatedBackend.{h,cc}: submit_transaction
:1069 -> issue_op :999, replica side sub_op_modify/do_repop :1148;
reads are served from the primary's full local copy, unlike the EC
reconstruct path).  The durable PG log's layout in the pgmeta omap
(`build_persist_log_txn`, `_LOG_KEY`, `_TAIL_KEY`) is shared with
`ECPGShard`, so the pgmeta omap holds the same keys and bytes in both
pool types and both packages.

The port's copy of `ceph_tpu.osd.replicated_backend`: host code, as the
reference's is; a replicated pool launches no kernel.  Snapshot clones
(COW on a pool snap, clone pushes, `apply_snap_trim`) are carried as
the reference carries them; the daemon's snap trimmer drives
`apply_snap_trim` on the primary and, through `SnapTrim`, on each
replica.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..common.lockdep import make_lock
from ..common.log import dout
from ..msg.messages import RepOpReply, RepOpWrite
from ..store import ObjectId, StoreError, Transaction
from . import mutations as mut
from .ec_backend import OI_ATTR, pg_cid
from .pg_log import PGLog
from .pg_types import DELETE, EVersion, MODIFY, PGLogEntry, ZERO_VERSION


#: pgmeta omap key prefix for persisted log entries; the key embeds the
#: zero-padded (epoch, version) so lexicographic omap order IS log
#: order (ref: PGLog.cc write_log_and_missing — log entries are rocksdb
#: keys under the pgmeta object the same way)
_LOG_KEY = "l.{:010d}.{:012d}"
_TAIL_KEY = "t"           # persisted log tail marker (EVersion)

PGMETA = ObjectId("pgmeta")


def _log_key(v) -> str:
    return _LOG_KEY.format(v.epoch, v.version)


def build_persist_log_txn(store, cid: str, log) -> Transaction:
    """The full durable-log rewrite transaction (after a peering
    merge, where entries were rewound/replaced, not appended) —
    shared by the replicated and EC shards.  Non-log pgmeta keys —
    the snap-mapper index and the purged_snaps cursor — survive the
    rewrite: wiping them with the stale log keys would silently leak
    every clone awaiting trim."""
    from ..msg import encoding as wire
    txn = Transaction()
    preserved = {}
    if not store.collection_exists(cid):
        txn.create_collection(cid)
    elif store.exists(cid, PGMETA):
        preserved = {k: v for k, v in
                     store.omap_get(cid, PGMETA).items()
                     if not k.startswith("l.") and k != _TAIL_KEY}
    txn.touch(cid, PGMETA)
    txn.omap_clear(cid, PGMETA)
    txn.omap_setkeys(cid, PGMETA, dict(
        {_log_key(e.version): wire.encode(e) for e in log.entries},
        **{_TAIL_KEY: wire.encode(log.tail)},
        **preserved))
    return txn


class ReplicatedPGShard:
    """Per-OSD service for one replicated PG (primary or replica).

    The shard's pg_log is durable: every apply writes its entries into
    the pgmeta object's omap in the SAME store transaction as the data
    (ref: PGLog::write_log_and_missing riding the op's txn), so a
    restarted OSD re-peers from real log bounds instead of an empty
    log that would force a full backfill."""

    def __init__(self, pgid, store, create: bool = True):
        from .snap_mapper import SnapMapper
        self.pgid = pgid
        self.store = store
        self.cid = pg_cid(pgid)
        self.pg_log = PGLog()
        #: persistent snap->clone index + purged_snaps cursor, stored
        #: in the pgmeta omap next to the log (osd/snap_mapper.py)
        self.snap_mapper = SnapMapper(store, self.cid)
        if create and not store.collection_exists(self.cid):
            store.queue_transaction(
                Transaction().create_collection(self.cid))
        self._load_log()

    # -- durable log ---------------------------------------------------
    def _load_log(self) -> None:
        from ..msg import encoding as wire
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
        from .pg_log import IndexedLog
        head = entries[-1].version if entries else tail
        self.pg_log = PGLog(IndexedLog(entries, head=head, tail=tail))

    def _log_txn_ops(self, txn: Transaction, new_entries: list) -> list:
        """Append `new_entries` to the durable log inside `txn`, and
        trim when past osd_max_pg_log_entries (down to
        osd_min_pg_log_entries, ref: PG::calc_trim_to).  Returns the
        entries to drop from the in-memory log AFTER the txn commits
        (a failed txn must not trim memory ahead of disk)."""
        from ..common.options import global_config
        from ..msg import encoding as wire
        txn.touch(self.cid, PGMETA)
        txn.omap_setkeys(self.cid, PGMETA,
                         {_log_key(e.version): wire.encode(e)
                          for e in new_entries})
        cfg = global_config()
        total = len(self.pg_log.log) + len(new_entries)
        dropped: list = []
        if total > cfg["osd_max_pg_log_entries"]:
            drop = total - cfg["osd_min_pg_log_entries"]
            dropped = self.pg_log.log.entries[:drop]
            if dropped:
                txn.omap_rmkeys(self.cid, PGMETA,
                                [_log_key(e.version) for e in dropped])
                txn.omap_setkeys(self.cid, PGMETA, {
                    _TAIL_KEY: wire.encode(dropped[-1].version)})
        return dropped

    def persist_log(self) -> None:
        """Rewrite the whole durable log (see build_persist_log_txn —
        non-log pgmeta keys survive)."""
        self.store.queue_transaction(
            build_persist_log_txn(self.store, self.cid,
                                  self.pg_log.log))

    def log_info(self) -> tuple:
        """(last_update, log_tail) — the pg_info_t core the peering
        GetInfo phase exchanges."""
        return self.pg_log.log.head, self.pg_log.log.tail

    # -- local apply (both roles; ref: ReplicatedBackend.cc:1148) ------
    # Deletes leave a zero-length *whiteout* carrying the delete's
    # version (ref: the cache-tier whiteout concept, object_info flag
    # FLAG_WHITEOUT): recovery compares versions, so a delete must be
    # a versioned event or a stale replica would resurrect the object.
    def apply_mutations(self, oid: str, muts: list, version,
                        log_entries, clone_snap=None,
                        clone_covers=None, snap_seq: int = 0) -> bool:
        """Apply a mutation vector as one atomic store transaction
        (the replica-side analogue of the reference's per-repop
        ObjectStore::Transaction built by PrimaryLogPG::do_osd_ops).

        `clone_snap`/`clone_covers`: the primary's COW decision (ref:
        PrimaryLogPG::make_writeable): before the mutation, the current
        head is preserved as `oid@clone_snap`, serving reads for the
        snapids in clone_covers.  Head object-info tracks `snap_seq`
        (pool seq at last write) and the `clones` map."""
        soid = ObjectId(oid)
        txn = Transaction()
        old_oi = self.head_oi(oid)
        clones = dict(old_oi.get("clones", {}))
        head_live = bool(old_oi) and not old_oi.get("whiteout")
        try:
            if clone_snap is not None and head_live:
                # COW: preserve the pre-write head (data+attrs+omap),
                # and index the clone in the SAME txn so the snap
                # trimmer can never miss it (ref: SnapMapper::add_oid
                # riding the repop transaction)
                txn.clone(self.cid, soid,
                          ObjectId(oid, snap=clone_snap))
                clones[clone_snap] = list(clone_covers or [])
                self.snap_mapper.add_clone(txn, oid, clone_snap,
                                           list(clone_covers or []))
            new_seq = max(old_oi.get("snap_seq", 0), snap_seq)
            if mut.is_delete(muts):
                if self.store.exists(self.cid, soid):
                    txn.remove(self.cid, soid)
                txn.touch(self.cid, soid)
                txn.setattr(self.cid, soid, OI_ATTR,
                            {"size": 0, "version": version,
                             "whiteout": True, "snap_seq": new_seq,
                             "clones": clones})
            else:
                if old_oi.get("whiteout"):
                    txn.remove(self.cid, soid)
                    txn.touch(self.cid, soid)
                    size = 0
                else:
                    size = self.object_size(oid)
                    txn.touch(self.cid, soid)
                size = self._build_mutation_txn(txn, soid, muts, size)
                txn.setattr(self.cid, soid, OI_ATTR,
                            {"size": size, "version": version,
                             "snap_seq": new_seq, "clones": clones})
            new_entries = [e for e in log_entries
                           if e.version > self.pg_log.log.head]
            dropped = self._log_txn_ops(txn, new_entries) \
                if new_entries else []
            if not txn.empty():
                self.store.queue_transaction(txn)
            if dropped:
                self.pg_log.log.trim_to(dropped[-1].version)
            for e in new_entries:
                self.pg_log.append(e)
            return True
        except StoreError as err:
            dout("osd", 0).write("%s replicated apply failed: %s",
                                 self.pgid, err)
            return False

    def head_oi(self, oid: str) -> dict:
        """The head's object-info attr ({} when absent)."""
        try:
            return dict(self.store.getattr(self.cid, ObjectId(oid),
                                           OI_ATTR))
        except StoreError:
            return {}

    # -- snapshots (ref: SnapSet resolution in PrimaryLogPG::find_object_context)
    def resolve_snap(self, oid: str, snapid: int):
        """What serves a read at `snapid`: a clone tag, "head", or
        None (the object did not exist at that snap)."""
        oi = self.head_oi(oid)
        covering = sorted(
            int(tag) for tag, covers in oi.get("clones", {}).items()
            if snapid in covers)
        if covering:
            return covering[0]
        if oi and not oi.get("whiteout") and \
                snapid > oi.get("snap_seq", 0):
            return "head"
        return None

    def read_clone(self, oid: str, tag: int, offset: int = 0,
                   length: int = 0) -> bytes:
        csoid = ObjectId(oid, snap=tag)
        try:
            size = self.store.getattr(self.cid, csoid,
                                      OI_ATTR)["size"]
        except StoreError:
            raise StoreError("ENOENT", f"{oid}@{tag}")
        return bytes(self.store.read(
            self.cid, csoid, offset, length or max(0, size - offset)))

    def clone_tags(self, oid: str) -> dict[int, list[int]]:
        return {int(t): list(c) for t, c in
                self.head_oi(oid).get("clones", {}).items()}

    def _build_mutation_txn(self, txn: Transaction, soid: ObjectId,
                            muts: list, size: int) -> int:
        """Append store ops for each mutation; returns the new logical
        size (tracked in the oi xattr like the reference's object_info_t
        size field)."""
        for m in muts:
            kind = m[0]
            if kind == mut.M_WRITE:
                _, off, data = m
                txn.write(self.cid, soid, off, data)
                size = max(size, off + len(data))
            elif kind == mut.M_WRITEFULL:
                data = m[1]
                txn.truncate(self.cid, soid, 0)
                txn.write(self.cid, soid, 0, data)
                size = len(data)
            elif kind == mut.M_APPEND:
                data = m[1]
                txn.write(self.cid, soid, size, data)
                size += len(data)
            elif kind == mut.M_TRUNCATE:
                newsz = m[1]
                txn.truncate(self.cid, soid, newsz)
                size = newsz
            elif kind == mut.M_ZERO:
                _, off, length = m
                # librados zero never extends the object
                # (ref: PrimaryLogPG CEPH_OSD_OP_ZERO: trims the range
                # to the object size)
                end = min(off + length, size)
                if end > off:
                    txn.zero(self.cid, soid, off, end - off)
            elif kind == mut.M_CREATE:
                pass                      # the leading touch created it
            elif kind == mut.M_ROLLBACK:
                # restore head wholesale from the clone: data, xattrs
                # and omap all revert (ref: PrimaryLogPG _rollback_to)
                tag = m[1]
                csoid = ObjectId(soid.name, snap=tag)
                if not self.store.exists(self.cid, csoid):
                    raise StoreError("ENOENT",
                                     f"{soid.name}@{tag} clone")
                txn.clone(self.cid, csoid, soid)
                size = self.store.getattr(self.cid, csoid,
                                          OI_ATTR)["size"]
            elif kind == mut.M_SETXATTRS:
                txn.setattrs(self.cid, soid,
                             {mut.uxattr_key(k): bytes(v)
                              for k, v in m[1].items()})
            elif kind == mut.M_RMXATTR:
                txn.rmattr(self.cid, soid, mut.uxattr_key(m[1]))
            elif kind == mut.M_OMAP_SETKEYS:
                txn.omap_setkeys(self.cid, soid, m[1])
            elif kind == mut.M_OMAP_RMKEYS:
                txn.omap_rmkeys(self.cid, soid, m[1])
            elif kind == mut.M_OMAP_CLEAR:
                txn.omap_clear(self.cid, soid)
                txn.rmattr(self.cid, soid, mut.OMAP_HEADER_ATTR)
            elif kind == mut.M_OMAP_SETHEADER:
                txn.setattr(self.cid, soid, mut.OMAP_HEADER_ATTR,
                            bytes(m[1]))
            else:
                raise StoreError("EINVAL", f"bad mutation {kind}")
        return size

    def apply_write(self, oid: str, offset: int, data: bytes,
                    delete: bool, version, log_entries) -> bool:
        """Whole-object convenience used by recovery pushes."""
        muts = [(mut.M_DELETE,)] if delete \
            else [(mut.M_WRITE, offset, data)]
        return self.apply_mutations(oid, muts, version, log_entries)

    def push_payload(self, oid: str) -> tuple:
        """(data, user_attrs, omap, omap_hdr) for a recovery/repair
        push (ref: ReplicatedBackend::build_push_op gathers data,
        attrs and omap into the PushOp)."""
        soid = ObjectId(oid)
        return (self.read(oid),
                mut.user_xattrs(self.store.getattrs(self.cid, soid)),
                dict(self.store.omap_get(self.cid, soid)),
                self.omap_get_header(oid))

    def _clones_digest(self, oid: str) -> int:
        from ..common.crc32c import crc32c
        clone_digest = {}
        for tag in sorted(self.clone_tags(oid)):
            csoid = ObjectId(oid, snap=tag)
            try:
                cdata = self.store.read(self.cid, csoid, 0, 0)
                # rollback restores attrs/omap too, so scrub must
                # cover them, not just the clone's bytes
                meta = (mut.meta_digest(self.store.getattrs(
                            self.cid, csoid))
                        ^ mut.meta_digest(self.store.omap_get(
                            self.cid, csoid)))
            except StoreError:
                cdata, meta = b"\0MISSING", 0
            clone_digest[str(tag)] = (
                int(crc32c(0xFFFFFFFF, cdata)) ^ meta
            ).to_bytes(8, "big", signed=False)
        return mut.meta_digest(clone_digest)

    def clone_payloads(self, oid: str) -> dict:
        """Snapshot state accompanying a push: the rebuilt copy must
        serve snap reads too (ref: recovery pushes every clone of an
        object, PGBackend::objects_list_range + per-clone PushOps).
        {} when the object has no snapshot history."""
        oi = self.head_oi(oid)
        tags = self.clone_tags(oid)
        if not tags and not oi.get("snap_seq"):
            return {}
        items = []
        for tag, covers in sorted(tags.items()):
            csoid = ObjectId(oid, snap=tag)
            if not self.store.exists(self.cid, csoid):
                continue
            items.append({"snap": tag, "covers": covers,
                          "data": bytes(self.store.read(
                              self.cid, csoid, 0, 0)),
                          "attrs": dict(self.store.getattrs(
                              self.cid, csoid)),
                          "omap": dict(self.store.omap_get(
                              self.cid, csoid))})
        return {"snap_seq": oi.get("snap_seq", 0), "items": items}

    def apply_clone_payloads(self, oid: str, payload: dict) -> None:
        """One atomic transaction for every clone AND the head-oi
        graft: a crash between them would leave clones the head no
        longer references (snap reads ENOENT, COW skipped).

        The pushed history is AUTHORITATIVE: local clones absent from
        it (divergent-write leftovers) are removed and the clones map
        replaced, or scrub repair could never converge."""
        if not payload and not self.clone_tags(oid):
            return
        payload = payload or {}
        txn = Transaction()
        clones_map = {}
        for c in payload.get("items", []):
            clones_map[c["snap"]] = list(c["covers"])
            csoid = ObjectId(oid, snap=c["snap"])
            txn.touch(self.cid, csoid)
            txn.truncate(self.cid, csoid, 0)
            txn.write(self.cid, csoid, 0, c["data"])
            txn.setattrs(self.cid, csoid, c["attrs"])
            if c.get("omap"):
                txn.omap_clear(self.cid, csoid)
                txn.omap_setkeys(self.cid, csoid, c["omap"])
        for tag in self.clone_tags(oid):
            if tag not in clones_map and self.store.exists(
                    self.cid, ObjectId(oid, snap=tag)):
                txn.remove(self.cid, ObjectId(oid, snap=tag))
        # graft the snap history back onto the freshly-pushed head oi
        oi = self.head_oi(oid)
        oi["clones"] = clones_map
        oi["snap_seq"] = max(oi.get("snap_seq", 0),
                             payload.get("snap_seq", 0))
        txn.setattr(self.cid, ObjectId(oid), OI_ATTR, oi)
        # re-index atomically with the adopted clone set: the rebuilt
        # copy must be trimmable exactly like the source was
        self.snap_mapper.replace_object(txn, oid, clones_map)
        self.store.queue_transaction(txn)

    # -- snaptrim (ref: PrimaryLogPG::trim_object — the per-clone trim
    #    transaction both the primary and its replicas apply) ---------
    def apply_snap_trim(self, oid: str, snap: int, clone: int) -> bool:
        """Drop `snap` from `oid`'s clone `clone`: remove it from the
        clone's covers, delete the clone object outright once no
        covered snap remains, and unindex — all one transaction, so
        the snap index stays an exact cursor of remaining work.
        Idempotent: re-applying after a primary failover finds the
        index entry gone and succeeds without touching the store."""
        if not self.store.collection_exists(self.cid):
            return True          # nothing here to trim (map lag view)
        txn = Transaction()
        oi = self.head_oi(oid)
        clones = {int(t): list(c)
                  for t, c in oi.get("clones", {}).items()}
        try:
            if clone in clones:
                covers = [c for c in clones[clone] if c != snap]
                csoid = ObjectId(oid, snap=clone)
                if covers:
                    clones[clone] = covers
                    self.snap_mapper.rm(txn, snap, oid, clone)
                else:
                    old_covers = clones.pop(clone)
                    if self.store.exists(self.cid, csoid):
                        txn.remove(self.cid, csoid)
                    self.snap_mapper.rm_clone(txn, oid, clone,
                                              old_covers)
                if self.store.exists(self.cid, ObjectId(oid)):
                    if not clones and oi.get("whiteout"):
                        # a deleted head kept alive only by its snap
                        # history: the last trimmed clone takes the
                        # whiteout with it (ref: trim_object removing
                        # the head when the SnapSet empties) — a
                        # lagging stray still converges via the
                        # backfill walk's stray-whiteout leg
                        txn.remove(self.cid, ObjectId(oid))
                    else:
                        oi["clones"] = clones
                        txn.setattr(self.cid, ObjectId(oid), OI_ATTR,
                                    oi)
            else:
                # already trimmed (resumed round / duplicate op):
                # clear any stale index key and report success
                self.snap_mapper.rm(txn, snap, oid, clone)
            if not txn.empty():
                self.store.queue_transaction(txn)
            return True
        except StoreError as err:
            dout("osd", 0).write("%s snap trim %s@%s failed: %s",
                                 self.pgid, oid, clone, err)
            return False

    def purged_snaps(self):
        return self.snap_mapper.purged_snaps()

    def mark_purged(self, snap: int) -> None:
        self.snap_mapper.mark_purged(snap)

    def collection_bytes(self) -> int:
        """Physical bytes this PG stores (heads + snap clones) — the
        store-accounting feed for pg stats."""
        from .snap_mapper import collection_bytes
        return collection_bytes(self.store, self.cid)

    def stat_summary(self) -> tuple[int, int, int]:
        """(client_objects, logical_bytes, store_bytes) in ONE
        collection pass — the periodic pg-stat feed (a separate
        objects() + collection_bytes() pair would walk the
        collection twice per report)."""
        if not self.store.collection_exists(self.cid):
            return (0, 0, 0)
        n = logical = store = 0
        for o in self.store.collection_list(self.cid):
            try:
                store += self.store.stat(self.cid, o)["size"]
            except StoreError:
                continue
            if o.name == "pgmeta" or o.snap != -2:
                continue
            try:
                oi = self.store.getattr(self.cid, o, OI_ATTR)
            except StoreError:
                continue
            if oi.get("whiteout"):
                continue
            n += 1
            logical += oi.get("size", 0)
        return (n, logical, store)

    def _is_whiteout(self, soid: ObjectId) -> bool:
        try:
            return bool(self.store.getattr(self.cid, soid,
                                           OI_ATTR).get("whiteout"))
        except StoreError:
            return False

    def handle_rep_write(self, m: RepOpWrite, whoami: int) -> RepOpReply:
        ok = self.apply_mutations(m.oid, m.mutations, m.version,
                                  m.log_entries,
                                  clone_snap=m.clone_snap,
                                  clone_covers=m.clone_covers,
                                  snap_seq=m.snap_seq)
        return RepOpReply(pgid=m.pgid, tid=m.tid, from_osd=whoami,
                          committed=ok)

    def read(self, oid: str, offset: int = 0, length: int = 0) -> bytes:
        size = self.object_size(oid)
        if not self.exists(oid):
            raise StoreError("ENOENT", f"{oid} does not exist")
        buf = self.store.read(self.cid, ObjectId(oid), offset,
                              length or max(0, size - offset))
        return bytes(buf)

    def object_size(self, oid: str) -> int:
        try:
            return self.store.getattr(self.cid, ObjectId(oid),
                                      OI_ATTR)["size"]
        except StoreError:
            return 0

    # -- metadata reads (primary-local; ref: PrimaryLogPG getattr/omap
    #    op handling reads the local object like any replicated read) --
    def getxattrs(self, oid: str) -> dict[str, bytes]:
        if not self.exists(oid):
            raise StoreError("ENOENT", oid)
        return mut.user_xattrs(self.store.getattrs(self.cid,
                                                   ObjectId(oid)))

    def getxattr(self, oid: str, name: str) -> bytes:
        xattrs = self.getxattrs(oid)
        if name not in xattrs:
            raise StoreError("ENODATA", f"{oid} xattr {name}")
        return xattrs[name]

    def omap_get(self, oid: str) -> dict[str, bytes]:
        if not self.exists(oid):
            raise StoreError("ENOENT", oid)
        return dict(self.store.omap_get(self.cid, ObjectId(oid)))

    def omap_get_header(self, oid: str) -> bytes:
        if not self.exists(oid):
            raise StoreError("ENOENT", oid)
        try:
            return bytes(self.store.getattr(self.cid, ObjectId(oid),
                                            mut.OMAP_HEADER_ATTR))
        except StoreError:
            return b""

    def object_version(self, oid: str) -> tuple[int, int]:
        """(epoch, version) from the oi xattr; (0,0) when unknown —
        the recovery inventory's ordering key."""
        try:
            v = self.store.getattr(self.cid, ObjectId(oid),
                                   OI_ATTR).get("version")
        except StoreError:
            return (0, 0)
        if isinstance(v, EVersion):
            return (v.epoch, v.version)
        return tuple(v) if v else (0, 0)

    def objects(self) -> list[str]:
        """Client-visible objects (whiteouts + snap clones excluded)."""
        if not self.store.collection_exists(self.cid):
            return []
        return sorted({o.name for o in self.store.collection_list(self.cid)
                       if o.name != "pgmeta" and o.snap == -2
                       and not self._is_whiteout(o)})

    def inventory(self) -> dict[str, tuple]:
        """Recovery inventory incl. whiteouts (head objects only —
        clones travel with their head's pushes):
        oid -> ((epoch, version), whiteout)."""
        if not self.store.collection_exists(self.cid):
            return {}
        out = {}
        for o in self.store.collection_list(self.cid):
            if o.name == "pgmeta" or o.snap != -2:
                continue
            out[o.name] = (self.object_version(o.name),
                           self._is_whiteout(o))
        return out

    def exists(self, oid: str) -> bool:
        soid = ObjectId(oid)
        return self.store.collection_exists(self.cid) and \
            self.store.exists(self.cid, soid) and \
            not self._is_whiteout(soid)

    def scrub_map(self, deep: bool = True) -> dict:
        """Per-object (version, size, digest) inventory for scrub
        (ref: src/osd/scrubber_common.h ScrubMap;
        PrimaryLogPG::build_scrub_map_chunk)."""
        from ..common.crc32c import crc32c
        out: dict[str, dict] = {}
        for oid, (ver, whiteout) in self.inventory().items():
            if whiteout:
                entry = {"version": ver, "size": 0, "crc": None,
                         "whiteout": True, "ok": True}
                if deep:
                    # a deleted head can still carry live snapshot
                    # clones — they must scrub like any replicated state
                    entry["clones_crc"] = self._clones_digest(oid)
                out[oid] = entry
                continue
            try:
                data = self.read(oid)
            except StoreError:
                out[oid] = {"version": ver, "size": -1, "crc": None,
                            "whiteout": False, "ok": False}
                continue
            entry = {"version": ver, "size": len(data),
                     "crc": int(crc32c(0xFFFFFFFF, data))
                     if deep else None,
                     "whiteout": False, "ok": True}
            if deep:
                # metadata digests: divergent xattrs/omap are an
                # inconsistency too (ref: ScrubMap::object attrs +
                # omap_digest)
                soid = ObjectId(oid)
                entry["attrs_crc"] = mut.meta_digest(
                    mut.user_xattrs(self.store.getattrs(self.cid,
                                                        soid)))
                entry["omap_crc"] = mut.meta_digest(
                    self.store.omap_get(self.cid, soid),
                    self.omap_get_header(oid))
                # snapshot clones are replicated state too: a copy
                # missing (or corrupting) a clone must scrub unequal
                entry["clones_crc"] = self._clones_digest(oid)
            out[oid] = entry
        return out


@dataclass
class _RepWrite:
    tid: int
    on_all_commit: Callable
    pending: set = field(default_factory=set)
    failed: set = field(default_factory=set)


class ReplicatedBackend:
    """Primary-side engine for one replicated PG."""

    def __init__(self, pgid, whoami: int, acting: list[int],
                 local_shard: ReplicatedPGShard,
                 send: Callable[[int, object], bool], epoch: int = 1,
                 tid_gen=None):
        self.pgid = pgid
        self.whoami = whoami
        self.acting = list(acting)
        self.local_shard = local_shard
        self.send = send                 # send(osd_id, msg) -> bool
        self.epoch = epoch
        # version continuity across primary changes: resume AFTER the
        # durable log head, or a rebuilt primary in the same epoch
        # would re-issue versions its log already holds
        self.last_version = local_shard.pg_log.log.head
        #: backfill targets' write-gating cursors (osd -> last_backfill
        #: oid; the entry is REMOVED once the walk completes — ref: the
        #: last_backfill gating in PrimaryLogPG::issue_repop): ops fan
        #: out to a target only for objects the walk already copied
        self.backfill_peers: dict[int, str] = {}
        self._tid = 0
        self._tid_gen = tid_gen    # see ECBackend: no tid reuse across
        self._lock = make_lock(              # backend rebuilds
            f"osd.{whoami}.repbackend.{pgid}")
        self.in_flight: dict[int, _RepWrite] = {}
        # pool snapshot state (daemon refreshes on every map;
        # ref: pg_pool_t snap_seq/snaps/removed_snaps feeding the
        # SnapContext)
        self.pool_snap_seq = 0
        self.pool_snaps: dict[int, str] = {}
        self.pool_removed_snaps: set[int] = set()

    def _next_tid(self) -> int:
        if self._tid_gen is not None:
            return next(self._tid_gen)
        self._tid += 1
        return self._tid

    def fail_in_flight(self) -> None:
        with self._lock:
            ops = list(self.in_flight.values())
            self.in_flight.clear()
        for op in ops:
            op.on_all_commit(False)

    def _next_version(self) -> EVersion:
        self.last_version = EVersion(
            max(self.epoch, self.last_version.epoch),
            self.last_version.version + 1)
        return self.last_version

    def _resolve_muts(self, oid: str, muts: list) -> list:
        """Normalize size-relative mutations (append, zero-clamp)
        against the primary's authoritative object size BEFORE the
        replica fan-out.  A replica whose local state lags (e.g. a
        recovery push racing this write) would otherwise resolve
        `append` against a different size and diverge at the same
        version — the reference avoids this the same way: the primary
        serializes the concrete extent into the repop transaction."""
        out = []
        size = self.local_shard.object_size(oid)
        for m in muts:
            kind = m[0]
            if kind == mut.M_ROLLBACK:
                try:
                    size = self.local_shard.store.getattr(
                        self.local_shard.cid,
                        ObjectId(oid, snap=m[1]), OI_ATTR)["size"]
                except StoreError:
                    size = 0
                out.append(m)
                continue
            if kind == mut.M_APPEND:
                m = (mut.M_WRITE, size, m[1])
            elif kind == mut.M_ZERO:
                end = min(m[1] + m[2], size)
                if end <= m[1]:
                    continue                   # nothing within bounds
                m = (mut.M_ZERO, m[1], end - m[1])
            if m[0] == mut.M_WRITE:
                size = max(size, m[1] + len(m[2]))
            elif m[0] == mut.M_WRITEFULL:
                size = len(m[1])
            elif m[0] == mut.M_TRUNCATE:
                size = m[1]
            out.append(m)
        return out

    def _snap_context(self, snapc) -> tuple[int, list[int]]:
        """Effective snapshot context: the union of the client's snapc
        and this primary's own pool state, newest seq wins — a lagging
        OSD map must not lose a snapshot the client already saw, a
        lagging client must not roll one back, and SELF-MANAGED snapids
        (allocated at the mon but absent from pool.snaps — the librbd
        model) exist only in the client's snapc (ref: the snapc the
        MOSDOp carries vs pool snapc resolution in PrimaryLogPG)."""
        seq = max(self.pool_snap_seq,
                  (snapc or {}).get("seq", 0))
        snaps = sorted((set(self.pool_snaps)
                        | set((snapc or {}).get("snaps", [])))
                       - self.pool_removed_snaps)
        return seq, snaps

    def _cow_decision(self, oid: str, seq: int, snaps: list[int]):
        """Does this write need to preserve the head as a clone first
        (ref: PrimaryLogPG::make_writeable — head snapped since its
        last write -> clone before mutating)?"""
        if not seq:
            return None, []
        oi = self.local_shard.head_oi(oid)
        if not oi or oi.get("whiteout"):
            return None, []
        prev = oi.get("snap_seq", 0)
        if prev >= seq:
            return None, []
        covers = [s for s in snaps if prev < s <= seq]
        if not covers:
            return None, []        # the intervening snaps were deleted
        return seq, covers

    # -- writes (ref: ReplicatedBackend.cc:1069 submit_transaction) ----
    def submit_transaction(self, oid: str, muts: list,
                           on_all_commit: Callable,
                           snapc: dict | None = None,
                           trace: dict | None = None) -> int:
        """Apply a mutation vector locally then fan it out to every
        acting replica; `on_all_commit(ok)` once all committed."""
        with self._lock:
            tid = self._next_tid()
            version = self._next_version()
            muts = self._resolve_muts(oid, muts)
            seq, snaps = self._snap_context(snapc)
            clone_snap, covers = self._cow_decision(oid, seq, snaps)
            prior = EVersion(*self.local_shard.object_version(oid))
            entry = PGLogEntry(DELETE if mut.is_delete(muts) else MODIFY,
                               oid, version, prior_version=prior)
            ok = self.local_shard.apply_mutations(
                oid, muts, version, [entry], clone_snap=clone_snap,
                clone_covers=covers, snap_seq=seq)
            if not ok:
                on_all_commit(False)
                return tid
            replicas = [o for o in self.acting
                        if o >= 0 and o != self.whoami]
            for o in self.backfill_peers:
                if o not in replicas and o != self.whoami:
                    replicas.append(o)
            targets = []
            for o in replicas:
                cursor = self.backfill_peers.get(o)
                if cursor is not None and oid > cursor:
                    # past the target's last_backfill: the walk copies
                    # this object later, already carrying this write
                    # (ref: last_backfill gating in issue_repop)
                    continue
                targets.append(o)
            if not targets:
                on_all_commit(True)
                return tid
            op = _RepWrite(tid=tid, on_all_commit=on_all_commit,
                           pending=set(targets))
            self.in_flight[tid] = op
            from ..common.tracing import child_of
            msg = RepOpWrite(pgid=self.pgid, tid=tid, oid=oid,
                             mutations=list(muts), version=version,
                             log_entries=[entry],
                             clone_snap=clone_snap,
                             clone_covers=covers or [],
                             snap_seq=seq, trace=child_of(trace))
            for o in targets:
                if not self.send(o, msg):
                    op.failed.add(o)
                    op.pending.discard(o)
            self._maybe_done(op)
            return tid

    def handle_rep_reply(self, m: RepOpReply) -> None:
        with self._lock:
            op = self.in_flight.get(m.tid)
            if op is None:
                return
            if m.from_osd in op.pending:
                op.pending.discard(m.from_osd)
                if not m.committed:
                    op.failed.add(m.from_osd)
            self._maybe_done(op)

    def _maybe_done(self, op: _RepWrite) -> None:
        if op.pending:
            return
        self.in_flight.pop(op.tid, None)
        op.on_all_commit(not op.failed)

    # -- reads: primary local copy (ref: ReplicatedBackend::objects_read_sync)
    def read(self, oid: str, offset: int = 0, length: int = 0) -> bytes:
        return self.local_shard.read(oid, offset, length)

    def object_size(self, oid: str) -> int:
        return self.local_shard.object_size(oid)
