"""CephFS client: libcephfs-like API over MDS metadata + striped data.

(ref: src/client/Client.cc — path ops go to the MDS, file data goes
straight to the data pool through the file layout's striping; size
updates flow back to the MDS the way cap flushes carry size/mtime).

Capability model (round 3, ref: Client.cc caps handling +
src/mds/Locker.cc): open() requests caps from the MDS; CAP_EXCL lets
the handle buffer its size (flushed on fsync/close/revoke), CAP_CACHE
lets it cache read extents.  A revoke arriving over the session
triggers flush + invalidate + ack off-thread; cap-less handles run
write-through with grow-only size flushes so concurrent writers can't
regress each other's extensions.

The port's copy of `ceph_tpu.fs.client`; a data-object removal that
fails with other than ENOENT or EEXIST is counted in `fs.SWALLOWED`.
"""
from __future__ import annotations

import itertools
import threading

from ..common.lockdep import make_lock
import time as _time

from ..client import RadosError
from ..msg.messages import (MClientCaps, MClientReply, MClientRequest,
                            MFSMap, MMonSubscribe)
from ..msg.messenger import Dispatcher, Message
from .mds import CAP_CACHE, CAP_EXCL, _swallow
from ..osdc.striper import StripeLayout, Striper

_SESSION_NONCE = itertools.count(1)


class _SendTimeout(TimeoutError):
    """The request was never delivered (endpoint unreachable) — a
    retry is NOT a replay: the op cannot have executed anywhere."""


class CephFSError(Exception):
    def __init__(self, errno_name: str, msg: str = ""):
        self.errno_name = errno_name
        super().__init__(f"{errno_name}: {msg}" if msg else errno_name)


def fs_data_obj(ino: int, objectno: int) -> str:
    """(ref: file object naming {ino:x}.{objno:08x},
    src/osdc/Striper.cc format_oid)."""
    return f"{ino:x}.{objectno:08x}"


class _MDSSession(Dispatcher):
    """Request/reply channel to the MDS riding the Rados client's
    messenger (ref: Client::send_request / MetaSession).  Also receives
    MClientCaps revokes and routes them to the owning CephFS."""

    def __init__(self, rados, mds: str):
        self.ms = rados.objecter.ms
        self.mds = mds
        self._tids = itertools.count(1)
        self._pending: dict[int, tuple[threading.Event, list]] = {}
        self._rados = rados
        self.fs: "CephFS | None" = None
        # fsmap awareness (ref: Client subscribing to "mdsmap" and
        # resending unsafe requests after an MDS failover): reqids are
        # session-unique so the new rank's completed-request table can
        # dedup a replayed op
        self.fsmap = None
        self.fsmap_epoch = 0
        # process-unique nonce: the completed-request table persists
        # in RADOS across client restarts, and a restarted process
        # reusing entity name + counter would be served a PREVIOUS
        # incarnation's recorded replies
        import os as _os
        import secrets as _secrets
        self._nonce = (f"{_os.getpid():x}-{_secrets.token_hex(3)}-"
                       f"{next(_SESSION_NONCE)}")
        self._reqids = itertools.count(1)
        try:
            self.ms.connect(rados.objecter.mon).send_message(
                MMonSubscribe(what="fsmap"))
        except Exception as ex:    # noqa: BLE001 — monless harness
            dout("client", 10).write("fsmap subscribe skipped "
                                     "(monless harness?): %s", ex)
        # cap messages (revoke/snapc) run sync RADOS IO whose replies
        # ride the dispatch thread, so they must be offloaded — but
        # ordered PER INO, not a thread per message: two snapc
        # broadcasts applied out of order would install a stale snap
        # context permanently.  Per-ino queues keep that invariant
        # without letting one wedged revoke (30s MDS call timeout)
        # head-of-line-block every other file's snapc delivery.
        self._capqs: dict[int, list] = {}
        self._capq_lock = make_lock("fs.client.capq")
        self.ms.add_dispatcher(self)

    def _cap_drain(self, ino: int) -> None:
        from ..common.log import dout
        while True:
            with self._capq_lock:
                q = self._capqs.get(ino)
                if not q:
                    self._capqs.pop(ino, None)
                    return
                msg = q.pop(0)
            try:
                if msg.op == "revoke":
                    self.fs._handle_revoke(msg)
                else:
                    self.fs._handle_snapc(msg)
            except Exception as ex:      # never kill the drain thread,
                # but never hide the failure either: an unacked revoke
                # wedges the MDS with zero diagnostics otherwise
                dout("client", 0).write(
                    "cap %s handler failed for ino %x: %r",
                    msg.op, ino, ex)

    def _enqueue_cap(self, msg) -> None:
        with self._capq_lock:
            q = self._capqs.get(msg.ino)
            if q is not None:
                q.append(msg)        # a drain thread is already live
                return
            self._capqs[msg.ino] = [msg]
        threading.Thread(target=self._cap_drain, args=(msg.ino,),
                         daemon=True).start()

    def ms_dispatch(self, msg: Message) -> bool:
        if isinstance(msg, MFSMap):
            if msg.epoch > self.fsmap_epoch:
                self.fsmap = msg.fsmap
                self.fsmap_epoch = msg.epoch
                if self.fs is not None:
                    # cap recovery runs sync MDS calls whose replies
                    # ride this dispatch thread: offload
                    threading.Thread(target=self.fs._on_fsmap,
                                     args=(msg.fsmap,),
                                     daemon=True).start()
            return True
        if isinstance(msg, MClientCaps):
            if self.fs is not None and msg.op in ("revoke", "snapc"):
                self._enqueue_cap(msg)
            return True
        if not isinstance(msg, MClientReply):
            return False
        entry = self._pending.pop(msg.tid, None)
        if entry is None:
            return True
        ev, slot = entry
        slot.append(msg)
        ev.set()
        return True

    #: hop bound for cross-rank forwards (a pin cycle cannot form, but
    #: a racing migration could bounce once or twice)
    MAX_FORWARDS = 4

    #: per-attempt reply-wait slice once an fsmap is known — a dead
    #: rank's unreplied op is replayed to its successor instead of
    #: burning the whole timeout on one silent attempt
    ATTEMPT_SLICE = 5.0

    def call(self, op: str, args: dict, timeout: float = 30.0):
        import time
        deadline = time.monotonic() + timeout
        args = dict(args)
        # session-unique reqid: the MDS completed-request table dedups
        # a replay of an op whose reply the dead rank never sent
        args["__reqid"] = f"{self._nonce}.{next(self._reqids)}"
        while True:
            try:
                return self._call_forwarding(op, args, deadline)
            except _SendTimeout:
                # never delivered: a plain retry, NOT a replay (the
                # op cannot have half-executed anywhere)
                if self.fsmap is None or \
                        time.monotonic() >= deadline:
                    raise
            except TimeoutError:
                if self.fsmap is None or \
                        time.monotonic() >= deadline:
                    raise
                # delivered but unanswered — MDS failover in
                # progress: replay the op; the completed table makes
                # mutating replays exactly-once (ref:
                # Client::kick_requests resend after reconnect)
                args["__replay"] = True

    def _call_forwarding(self, op: str, args: dict, deadline: float):
        import time
        target = self.mds
        for _hop in range(self.MAX_FORWARDS):
            att = deadline
            if self.fsmap is not None:
                att = min(deadline,
                          time.monotonic() + self.ATTEMPT_SLICE)
            rep = self._call_one(target, op, args, att)
            if rep.forward is not None and rep.forward >= 0:
                # another rank owns this subtree (ref: MDS forward)
                target = f"mds.{rep.forward}"
                continue
            if rep.result < 0:
                raise CephFSError(rep.errno_name or "EIO", op)
            return rep.out
        raise CephFSError("EMLINK", f"mds forward loop for {op}")

    def _call_one(self, target: str, op: str, args: dict,
                  deadline: float):
        import time
        tid = next(self._tids)
        ev, slot = threading.Event(), []
        self._pending[tid] = (ev, slot)
        # retry the SEND until the MDS endpoint exists (a client can
        # race the rank's bind at boot); once a send succeeded the
        # request is never re-sent — a lost reply must not replay a
        # non-idempotent op (ref: Client request resend is gated on
        # session state the same way)
        msg = MClientRequest(tid=tid, op=op, args=args)
        # send-retry pacing: shared capped-exponential with jitter —
        # a fixed interval can phase-lock against a failover that
        # heals right after every probe (chaos-exposed livelock shape)
        from ..common.backoff import Backoff
        backoff = Backoff(base_s=0.05, cap_s=1.0)
        while not self.ms.connect(target).send_message(msg):
            if time.monotonic() >= deadline:
                self._pending.pop(tid, None)
                raise _SendTimeout(f"mds {target} unreachable")
            backoff.sleep()
        if not self._rados.objecter.wait_sync(
                ev.is_set, max(0.1, deadline - time.monotonic()),
                ev=ev):
            self._pending.pop(tid, None)
            raise TimeoutError(f"mds op {op} timed out")
        return slot[0]


class FileHandle:
    """Open file (ref: src/client/Fh.h) with capability-driven caching
    (ref: Client.cc caps: CAP_EXCL buffers size, CAP_CACHE caches read
    extents; both surrendered on revoke)."""

    def __init__(self, fs: "CephFS", path: str, rec: dict,
                 caps: int = 0, wants_write: bool = False):
        self.fs = fs
        self.path = path
        self.wants_write = wants_write
        self.ino = rec["ino"]
        self.layout = StripeLayout(**rec["layout"])
        self.size = rec.get("size", 0)
        self.caps = caps
        #: non-None = a `.snap` path handle: reads at that snapid,
        #: writes EROFS (ref: the snapdir is read-only)
        self.snapid = rec.get("snapid")
        self._dirty_size = False
        self._rcache: dict[tuple[int, int], bytes] = {}
        self._snapc_seq = -1
        self._snapc_lock = make_lock("fs.fh.snapc")
        self._io = fs.rados.open_ioctx(rec["pool"])
        # write-back object cache (ref: ObjectCacher mounted by
        # Client.cc; the caps ARE its coherence protocol: CAP_EXCL
        # buffers writes, CAP_CACHE serves cached reads, revocation
        # flushes + invalidates).  Shared PER INODE across this
        # client's handles — per-handle caches would lose each
        # other's page updates at flush time.
        self._oc = None
        self._oc_io = None
        from ..common.options import global_config
        if global_config()["client_oc"] and self.snapid is None:
            self._oc, self._oc_io = fs._get_cache(
                self.ino, rec["pool"],
                page=min(self.layout.stripe_unit, 1 << 16))
        # writes under a snapped realm carry its snap context so the
        # OSD COWs pre-snap state (ref: SnapRealm::get_snap_context
        # feeding every data op).  Register FIRST, then merge+apply:
        # a broadcast landing in the gap then reaches this handle too,
        # and the monotone guards make the two applications commute —
        # the reverse order would let a stale open reply overwrite a
        # broadcast the sibling handles already applied.
        fs._register_handle(self)
        self.set_snapc(fs._merge_snapc(self.ino, rec.get("snapc")))

    def set_snapc(self, snapc: dict | None) -> None:
        if not snapc:
            return
        # snap contexts only widen: a late-arriving older broadcast
        # (delivery reordering, or a sibling open whose MDS reply
        # predates a mksnap) must not roll the handle back to a stale
        # seq — writes would then skip COW for the newer snapshot
        # (ref: SnapContext seq monotonicity, src/osdc/Objecter).
        # The lock makes check+apply atomic against the per-ino cap
        # drain thread racing a constructor-time apply.
        with self._snapc_lock:
            if snapc["seq"] <= self._snapc_seq:
                return
            if self._oc is not None:
                # buffered writes predate the new snap context: they
                # must flush under the OLD one or the OSD won't COW
                # them into the snapshot they logically belong to
                self._oc.flush()
            self._io.set_write_snapc(snapc["seq"], snapc["snaps"])
            if self._oc_io is not None:
                self.fs._apply_snapc_shared(self.ino)
            # advance only after every apply succeeded: an exception
            # above (flush hitting a transient RADOS error) must leave
            # a re-delivery of this seq acceptable
            self._snapc_seq = snapc["seq"]

    # -- data path (ref: Client::_write -> Striper + Objecter) ---------
    def write(self, offset: int, data: bytes) -> int:
        if self.snapid is not None:
            raise CephFSError("EROFS", self.path)
        if self._oc is not None and self.caps & CAP_EXCL:
            # EXCL grants write buffering: data lands in the cache and
            # reaches RADOS on fsync/close/revoke (ref: Fw-cap
            # buffered writes through ObjectCacher)
            for ext in Striper.file_to_extents(self.layout, offset,
                                               len(data)):
                buf = data[ext.logical_offset - offset:
                           ext.logical_offset - offset + ext.length]
                self._oc.write(fs_data_obj(self.ino, ext.objectno),
                               ext.offset, buf)
            if offset + len(data) > self.size:
                self.size = offset + len(data)
                self._dirty_size = True
            return len(data)
        futs = []
        for ext in Striper.file_to_extents(self.layout, offset,
                                           len(data)):
            buf = data[ext.logical_offset - offset:
                       ext.logical_offset - offset + ext.length]
            futs.append(self._io.aio_write(
                fs_data_obj(self.ino, ext.objectno), buf,
                offset=ext.offset))
        for f in futs:
            self._io._wait(f)
        self._rcache.clear()
        if self._oc is not None:
            # a CACHE-only handle may have cached reads: the direct
            # write just went around them (read-your-own-write)
            self._oc.invalidate()
        if offset + len(data) > self.size:
            self.size = offset + len(data)
            if self.caps & CAP_EXCL:
                self._dirty_size = True      # flushed on fsync/revoke
            else:
                # write-through, grow-only: a stale size must never
                # clip another writer's extension
                self.fs._session.call("setattr", {
                    "path": self.path, "size": self.size,
                    "grow_only": True})
        return len(data)

    def append(self, data: bytes) -> int:
        """Append at the authoritative end: without CAP_EXCL the size
        is re-fetched first (another writer may have extended)."""
        if not self.caps & CAP_EXCL:
            self.size = max(self.size,
                            self.fs.stat(self.path).get("size", 0))
        return self.write(self.size, data)

    def read(self, offset: int, length: int = 0) -> bytes:
        if self.snapid is None and \
                not self.caps & (CAP_EXCL | CAP_CACHE):
            # no caps: another client may have extended the file
            # (snap handles never refresh: the record is frozen)
            self.size = max(self.size,
                            self.fs.stat(self.path).get("size", 0))
        if length == 0 or offset + length > self.size:
            length = max(0, self.size - offset)
        if length == 0:
            return b""
        if self._oc is not None and \
                self.caps & (CAP_CACHE | CAP_EXCL):
            # cached read path (ref: CAP_CACHE through ObjectCacher)
            out = bytearray(length)
            for ext in Striper.file_to_extents(self.layout, offset,
                                               length):
                buf = self._oc.read(
                    fs_data_obj(self.ino, ext.objectno),
                    ext.offset, ext.length)
                dst = ext.logical_offset - offset
                out[dst:dst + len(buf)] = buf
            return bytes(out[:length])
        key = (offset, length)
        if self.caps & (CAP_CACHE | CAP_EXCL):
            hit = self._rcache.get(key)
            if hit is not None:
                return hit
        out = bytearray(length)
        pend = []
        for ext in Striper.file_to_extents(self.layout, offset,
                                           length):
            pend.append((ext, self._io.aio_read(
                fs_data_obj(self.ino, ext.objectno),
                length=ext.length, offset=ext.offset,
                snapid=self.snapid)))
        for ext, fut in pend:
            try:
                buf = self._io._wait(fut).data
            except RadosError as ex:
                if ex.errno_name != "ENOENT":
                    raise
                buf = b""                        # sparse hole
            dst = ext.logical_offset - offset
            out[dst:dst + len(buf)] = buf
        result = bytes(out)
        if self.caps & (CAP_CACHE | CAP_EXCL):
            self._rcache[key] = result
        return result

    def _surrender_caps(self) -> None:
        """Revoke: flush dirty DATA first, then the dirty size, drop
        caches, run cap-less (ref: the flush ordering cap revocation
        imposes on ObjectCacher — data must land before the metadata
        that advertises it)."""
        if self._oc is not None:
            self._oc.flush()
        if self._dirty_size:
            self.fs._session.call("setattr", {
                "path": self.path, "size": self.size,
                "grow_only": True})
            self._dirty_size = False
        if self._oc is not None:
            self._oc.invalidate()
        self._rcache.clear()
        self.caps = 0

    def fsync(self) -> None:
        if self.snapid is not None:
            return
        if self._oc is not None:
            self._oc.flush()
        try:
            self.fs._session.call("setattr", {"path": self.path,
                                              "size": self.size,
                                              "grow_only": True})
        except CephFSError as e:
            # the path was renamed/unlinked under this open handle
            # (POSIX-legal): the data is flushed; the size record
            # moved with the dentry and was captured by the rename's
            # revoke-and-wait, so there is nothing left to update
            if e.errno_name != "ENOENT":
                raise
        self._dirty_size = False

    def close(self) -> None:
        self.fsync()
        if self._oc is not None:
            self.fs._put_cache(self.ino)
            self._oc = None
        if self.fs._unregister_handle(self):
            try:
                # path included so the release routes to the rank
                # that actually tracks this handle's caps
                self.fs._session.call("release", {
                    "ino": self.ino, "path": self.path})
            except (CephFSError, TimeoutError):
                pass


class CephFS:
    """(ref: libcephfs.h surface, pythonized)."""

    def __init__(self, rados, mds: str = "mds.0"):
        self.rados = rados
        self._session = _MDSSession(rados, mds)
        self._session.fs = self
        self._handles: dict[int, list] = {}      # ino -> [FileHandle]
        #: per-inode shared ObjectCacher: ino -> (cacher, io, refs)
        #: (ref: Client.cc mounts ONE ObjectCacher per inode)
        self._caches: dict[int, tuple] = {}
        #: per-inode authoritative (highest-seq) snap context
        self._ino_snapc: dict[int, dict] = {}
        self._hlock = make_lock("fs.client.handles")
        #: last gid seen ACTIVE per rank — a gid change on an active
        #: rank means a failover happened and our caps died with the
        #: old daemon's session state
        self._rank_gids: dict[int, int] = {}

    def _get_cache(self, ino: int, pool: str, page: int):
        from ..common.options import global_config
        from ..osdc.object_cacher import ObjectCacher
        with self._hlock:
            ent = self._caches.get(ino)
            if ent is not None:
                oc, io, refs = ent
                self._caches[ino] = (oc, io, refs + 1)
                return oc, io
            io = self.rados.open_ioctx(pool)

            def _read(oid, off, length, _io=io):
                try:
                    return _io.read(oid, length=length, offset=off)
                except RadosError as ex:
                    if ex.errno_name != "ENOENT":
                        raise
                    return b""              # sparse hole

            def _write(oid, off, data, _io=io):
                _io._wait(_io.aio_write(oid, data, offset=off))

            cfg = global_config()
            oc = ObjectCacher(_read, _write,
                              max_dirty=cfg["client_oc_max_dirty"],
                              max_size=cfg["client_oc_size"],
                              page=page)
            self._caches[ino] = (oc, io, 1)
            return oc, io

    def _put_cache(self, ino: int) -> None:
        with self._hlock:
            ent = self._caches.get(ino)
            if ent is None:
                return
            oc, io, refs = ent
            if refs > 1:
                self._caches[ino] = (oc, io, refs - 1)
                return
            del self._caches[ino]
        oc.flush()
        oc.invalidate()

    def _merge_snapc(self, ino: int, snapc: dict | None) -> dict | None:
        """Per-ino monotone snap context: merge `snapc` in, return the
        authoritative (highest-seq) one.  EVERY path that applies a
        context to the shared per-ino cache io must route through
        here — a stale MDS open reply racing a broadcast would
        otherwise roll the shared seq back and later flushes would
        skip COW for the newest snapshot."""
        with self._hlock:
            cur = self._ino_snapc.get(ino)
            if snapc and (cur is None or snapc["seq"] > cur["seq"]):
                self._ino_snapc[ino] = cur = dict(snapc)
            return cur

    def _apply_snapc_shared(self, ino: int) -> None:
        """Install the per-ino AUTHORITATIVE context on the shared
        cache io.  Always applying the current _ino_snapc max (never a
        caller-supplied context) makes the applied seq monotone by
        construction — two handles racing, one with a stale merge
        result, both land on the max.  set_write_snapc is pure state
        (no IO), so holding _hlock is safe."""
        with self._hlock:
            ent = self._caches.get(ino)
            cur = self._ino_snapc.get(ino)
            if ent is None or cur is None:
                return
            ent[1].set_write_snapc(cur["seq"], cur["snaps"])

    # -- failover -------------------------------------------------------
    def _on_fsmap(self, fsmap) -> None:
        """A new fsmap epoch arrived (runs off the dispatch thread):
        when an active rank's gid changed, the old daemon died and a
        standby took over — re-state our open files and recover caps
        through the new rank (ref: the client reconnect phase of MDS
        rejoin; Client::resend_unsafe_requests)."""
        if fsmap is None:
            return
        failed_over = False
        with self._hlock:
            for rank, info in fsmap.ranks.items():
                if info.state != "active" or not info.gid:
                    continue
                old = self._rank_gids.get(rank)
                self._rank_gids[rank] = info.gid
                if old is not None and old != info.gid:
                    failed_over = True
        if not failed_over:
            return
        with self._hlock:
            handles = [fh for lst in self._handles.values()
                       for fh in lst if fh.snapid is None]
        for fh in handles:
            try:
                out = self._session.call("reconnect", {
                    "path": fh.path,
                    "wants_write": fh.wants_write}, timeout=15.0)
                fh.caps = out.get("caps", 0)
                rec = out.get("rec") or {}
                fh.size = max(fh.size, rec.get("size", 0))
                if fh._dirty_size and not fh.caps & CAP_EXCL:
                    fh.fsync()     # lost EXCL: flush the buffered size
            except (CephFSError, TimeoutError):
                pass       # handle runs cap-less; ops still work

    def wait_rank_active(self, rank: int = 0,
                         timeout: float = 30.0) -> bool:
        """Block until the fsmap shows `rank` active (failover tests/
        tools; returns False on timeout)."""
        end = _time.monotonic() + timeout
        while _time.monotonic() < end:
            m = self._session.fsmap
            if m is not None:
                info = m.ranks.get(rank)
                if info is not None and info.state == "active":
                    return True
            _time.sleep(0.05)
        return False

    # -- capability plumbing -------------------------------------------
    def _register_handle(self, fh) -> None:
        with self._hlock:
            self._handles.setdefault(fh.ino, []).append(fh)

    def _unregister_handle(self, fh) -> bool:
        """Returns True when this was the client's LAST handle on the
        ino — only then may the session's caps be released (an earlier
        release would strand a sibling handle with client-side caps
        the MDS no longer tracks)."""
        with self._hlock:
            lst = self._handles.get(fh.ino, [])
            if fh in lst:
                lst.remove(fh)
            if not lst:
                self._handles.pop(fh.ino, None)
                # last handle gone: no broadcasts can target this ino
                # anymore (the MDS only notifies cap holders), so the
                # next open's MDS reply is authoritative — prune the
                # merged record rather than leak one entry per ino
                self._ino_snapc.pop(fh.ino, None)
                return True
            return False

    def _handle_revoke(self, msg) -> None:
        """MDS revoked our caps on an ino: flush + invalidate + ack
        (runs off the dispatch thread)."""
        with self._hlock:
            handles = list(self._handles.get(msg.ino, []))
        for fh in handles:
            try:
                fh._surrender_caps()
            except (CephFSError, TimeoutError):
                pass
        # ack the RANK THAT REVOKED (after a subtree migration that
        # is not necessarily our default session rank)
        self._session.ms.connect(msg.src or self._session.mds) \
            .send_message(MClientCaps(op="ack", ino=msg.ino))
        # re-register surviving handles' open intents with whichever
        # rank now owns the path — without this a subtree migration
        # would let the new authority grant conflicting EXCL over our
        # live write-through handles
        for fh in handles:
            if fh.snapid is not None:
                continue             # snap handles hold no caps
            try:
                self._session.call("reopen", {
                    "path": fh.path,
                    "wants_write": fh.wants_write})
            except (CephFSError, TimeoutError):
                pass

    def _handle_snapc(self, msg) -> None:
        """mksnap widened the realm's snap context: every open handle
        on the ino switches its write snapc so the OSD COWs pre-snap
        state (ref: the SnapRealm update broadcast)."""
        from ..common.log import dout
        snapc = self._merge_snapc(msg.ino, msg.snapc)
        with self._hlock:
            handles = list(self._handles.get(msg.ino, []))
        for fh in handles:
            try:
                fh.set_snapc(snapc)
            except Exception as ex:
                # one handle's transient flush failure must not strand
                # its SIBLINGS on the old context; the failed handle's
                # _snapc_seq was not advanced (set_snapc applies before
                # it records), so the next broadcast retries it
                dout("client", 0).write(
                    "snapc apply failed on ino %x handle: %r",
                    msg.ino, ex)

    # -- namespace ------------------------------------------------------
    def mkdir(self, path: str) -> None:
        self._session.call("mkdir", {"path": path})

    def mkdirs(self, path: str) -> None:
        parts = [p for p in path.strip("/").split("/") if p]
        for i in range(1, len(parts) + 1):
            try:
                self.mkdir("/" + "/".join(parts[:i]))
            except CephFSError as e:
                if e.errno_name != "EEXIST":
                    raise

    def listdir(self, path: str = "/") -> list[str]:
        return sorted(self._session.call("readdir", {"path": path}))

    def stat(self, path: str) -> dict:
        return self._session.call("lookup", {"path": path})

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except CephFSError:
            return False

    def rename(self, src: str, dst: str) -> None:
        self._session.call("rename", {"src": src, "dst": dst})

    def rmdir(self, path: str) -> None:
        self._session.call("rmdir", {"path": path})

    def unlink(self, path: str) -> None:
        rec = self._session.call("unlink", {"path": path})
        # purge data objects only when the last link died (ref: the
        # reference defers this to the MDS PurgeQueue; nlink>0 keeps
        # the inode's data alive for the remaining hardlinks)
        size = rec.get("size", 0)
        if size and rec.get("purge", True):
            self._purge_data(rec, size)

    # -- files ----------------------------------------------------------
    def open(self, path: str, mode: str = "r",
             layout: dict | None = None,
             timeout: float = 10.0) -> FileHandle:
        wants_write = "w" in mode or "a" in mode or "+" in mode
        if wants_write:
            # 'w' carries O_TRUNC (POSIX); 'a'/'r+' keep existing bytes
            rec = self._session.call("create", {
                "path": path, "layout": layout,
                "truncate": "w" in mode})
            purge = rec.pop("purge_size", 0)
            if purge:
                self._purge_data(rec, purge)
        # capability request loop: EAGAIN while the MDS revokes
        # conflicting caps (ref: Client waits out cap revocation)
        out = self._retry_eagain(
            lambda: self._session.call("open", {
                "path": path, "wants_write": wants_write}), timeout)
        rec, caps = out["rec"], out["caps"]
        if rec["type"] != "f":
            raise CephFSError("EISDIR", path)
        return FileHandle(self, path, rec, caps=caps,
                          wants_write=wants_write)

    def link(self, src: str, dst: str) -> None:
        """Hardlink (ref: libcephfs ceph_link)."""
        self._session.call("link", {"src": src, "dst": dst})

    def _retry_eagain(self, fn, timeout: float):
        """EAGAIN retry loop: the MDS answers EAGAIN while revoking
        caps out from under the op; the client waits it out (ref:
        Client's cap-wait)."""
        from ..common.backoff import Backoff
        deadline = _time.monotonic() + timeout
        backoff = Backoff(base_s=0.01, cap_s=0.25)
        while True:
            try:
                return fn()
            except CephFSError as e:
                if e.errno_name != "EAGAIN" or \
                        _time.monotonic() >= deadline:
                    raise
                backoff.sleep()

    # -- multi-MDS subtree pinning (ref: setfattr ceph.dir.pin) ---------
    def set_pin(self, path: str, rank: int) -> None:
        """Pin a directory subtree to an MDS rank; its current
        authority migrates serving + cap ownership over."""
        self._session.call("set_pin", {"path": path, "rank": rank})

    def get_pins(self) -> dict[str, int]:
        return {k: int(v) for k, v in
                self._session.call("get_pins", {}).items()}

    # -- snapshots (ref: libcephfs ceph_mksnap/ceph_rmsnap) -------------
    def mksnap(self, path: str, name: str,
               timeout: float = 10.0) -> int:
        """Snapshot a directory realm; `<path>/.snap/<name>` serves
        the frozen namespace + data.  Retries while the MDS flushes
        EXCL holders under the realm (their buffered sizes must land
        before the dirfrags freeze)."""
        return self._retry_eagain(
            lambda: self._session.call("mksnap", {"path": path,
                                                  "name": name}),
            timeout)["id"]

    def rmsnap(self, path: str, name: str) -> None:
        self._session.call("rmsnap", {"path": path, "name": name})

    def lssnap(self, path: str) -> dict[str, dict]:
        return self._session.call("lssnap", {"path": path})

    def _purge_data(self, rec: dict, size: int) -> None:
        layout = StripeLayout(**rec["layout"])
        io = self.rados.open_ioctx(rec["pool"])
        if rec.get("snapc"):
            # deleting under a snapped realm: the OSD must COW the
            # head into a clone so `.snap` reads survive the unlink
            io.set_write_snapc(rec["snapc"]["seq"],
                               rec["snapc"]["snaps"])
        objnos = {e.objectno for e in
                  Striper.file_to_extents(layout, 0, size)}
        for objno in sorted(objnos):
            try:
                io.remove(fs_data_obj(rec["ino"], objno))
            except RadosError as err:
                _swallow("purge_data", err)

    def write_file(self, path: str, data: bytes) -> None:
        fh = self.open(path, "w")
        fh.write(0, data)
        fh.close()

    def read_file(self, path: str) -> bytes:
        fh = self.open(path)
        return fh.read(0)

    def statfs(self) -> dict:
        return self._session.call("statfs", {})
