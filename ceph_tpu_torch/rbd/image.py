"""RBD-lite: block-device images striped over RADOS objects.

The librbd data-path model (ref: src/librbd/: image metadata in a
header object, data in `rbd_data.<id>.<objectno>` objects of size
2^order, io/ImageRequest.cc mapping block extents through the Striper;
naming scheme util::data_object_name): an image is a sparse array of
equal-size objects — absent objects read as zeros, partial writes touch
only the covered objects.

The librbd depth features:

* **exclusive lock** — writers arbitrate through the cls `lock` class
  on the header object with cooperative hand-off over watch/notify
  (ref: src/librbd/exclusive_lock/, ManagedLock; RBD_LOCK_NAME
  "rbd_lock"); dead holders are detected by live-watcher comparison
  and broken (ref: break_lock on blocklisted owners);
* **object map + fast-diff** — 2-bit per-object existence states
  persisted per image and per snapshot (ref: src/librbd/object_map/,
  OBJECT_{NONEXISTENT,EXISTS,PENDING,EXISTS_CLEAN}), driving du and
  snapshot diffs without scanning data objects;
* **snapshot-backed COW clones** — children record (pool, image, snap,
  overlap); reads fall through to the protected parent snapshot,
  partial writes copy-up the covered object first, `flatten` detaches
  (ref: src/librbd/ parent/child linkage, cls_rbd children,
  io/CopyupRequest.cc).

API mirrors librbd's Python binding surface: RBD().create/remove/
list/clone, Image open -> read/write/discard/resize/stat/snap_*/
diff/du/flatten/close.

The port's copy of `ceph_tpu.rbd.image`: the same header JSON, data
objects, object maps and lock calls, byte for byte.  Two things are
added, neither changes what the image does:

* where the reference swallows a `RadosError` (a best-effort removal,
  a lock break or unlock that fails, a read taken as absent), the port
  does the same and also counts each such error whose errno is not
  ENOENT in `SWALLOWED`, by site;
* `LOCKS` counts the exclusive-lock events: `broken` (a holder that
  did not answer the header notify had its lock broken) and
  `released_on_request` (a holder handed its lock over).

Two things are done faster, with the same bytes: a write-back flush
sends its writes as aio and waits for them (up to `AIO_MAX_PENDING` in
flight) before the object map is flushed, the lock released or the
image closed, where the reference waits for each in turn; and a copyup
tests the parent's bytes for zeros with one comparison.

The lock rides the port's watch rule: a new interval under the same
primary keeps the header's watchers (ROADMAP Queue 3), so a live holder
answers the notify and hands the lock over, where the reference's
holder, its watch lost, has its lock broken.
"""
from __future__ import annotations

import json
import threading
import time
from collections import Counter

from ..client.rados import IoCtx, RadosError
from ..common.lockdep import make_lock
from ..osdc import StripeLayout, Striper

RBD_DEFAULT_ORDER = 22          # 4 MiB objects (rbd_default_order)
#: header lock name (ref: src/librbd/utils: RBD_LOCK_NAME)
RBD_LOCK_NAME = "rbd_lock"
#: write-back writes in flight per image before the cache waits for them
AIO_MAX_PENDING = 64


#: swallowed RadosErrors other than ENOENT, by site
SWALLOWED: Counter = Counter()
#: exclusive-lock events: "broken", "released_on_request"
LOCKS: Counter = Counter()


class RBDError(OSError):
    pass


def _swallow(site: str, err: RadosError) -> None:
    if err.errno_name != "ENOENT":
        SWALLOWED[site] += 1


def header_name(name: str) -> str:
    return f"rbd_header.{name}"


def data_name(name: str, objectno: int) -> str:
    """(ref: librbd util::data_object_name '%s.%016llx')."""
    return f"rbd_data.{name}.{objectno:016x}"


def object_map_name(name: str, snap_id: int | None = None) -> str:
    """(ref: librbd object_map::util RBD_OBJECT_MAP_PREFIX)."""
    base = f"rbd_object_map.{name}"
    return base if snap_id is None else f"{base}.{snap_id}"


class ObjectMap:
    """2-bit-per-object existence map (ref: src/librbd/object_map/,
    states src/include/rbd/object_map_types.h)."""

    NONEXISTENT = 0
    EXISTS = 1              # exists, dirty since the last snapshot
    PENDING = 2
    EXISTS_CLEAN = 3        # exists, unchanged since the last snapshot

    def __init__(self, ioctx: IoCtx, image_name: str, span: int,
                 snap_id: int | None = None):
        self.ioctx = ioctx
        self.image_name = image_name
        self.oid = object_map_name(image_name, snap_id)
        self.span = span
        try:
            raw = ioctx.read(self.oid)
        except RadosError as err:
            _swallow("object_map_read", err)
            raw = b""
        self._bits = bytearray(raw)
        need = (span + 3) // 4
        if len(self._bits) < need:
            self._bits += b"\0" * (need - len(self._bits))
        #: dirty byte range awaiting flush (librbd updates the map
        #: in place — a full-map rewrite per IO would be span/4 bytes
        #: of write amplification on the data path)
        self._dirty: tuple[int, int] | None = None
        self._full_rewrite = False

    def get(self, objno: int) -> int:
        if objno >= self.span:
            return self.NONEXISTENT
        return (self._bits[objno // 4] >> (2 * (objno % 4))) & 3

    def set(self, objno: int, state: int, flush: bool = True) -> None:
        byte = objno // 4
        shift = 2 * (objno % 4)
        cur = self._bits[byte]
        new = (cur & ~(3 << shift)) | (state << shift)
        if new == cur:
            return
        self._bits[byte] = new
        if self._dirty is None:
            self._dirty = (byte, byte + 1)
        else:
            lo, hi = self._dirty
            self._dirty = (min(lo, byte), max(hi, byte + 1))
        if flush:
            self.flush()

    def resize(self, span: int) -> None:
        need = (span + 3) // 4
        if len(self._bits) < need:
            self._bits += b"\0" * (need - len(self._bits))
        else:
            del self._bits[need:]
            # clear trailing sub-byte states past the new span
            for objno in range(span, need * 4):
                self.set(objno, self.NONEXISTENT, flush=False)
        self.span = span
        self._full_rewrite = True      # length changed
        self.flush()

    def mark_clean(self) -> None:
        """EXISTS -> EXISTS_CLEAN after a snapshot (fast-diff epoch)."""
        for objno in range(self.span):
            if self.get(objno) == self.EXISTS:
                self.set(objno, self.EXISTS_CLEAN, flush=False)
        self.flush()

    def save_copy(self, snap_id: int) -> None:
        """Freeze the current map beside the snapshot
        (ref: object map snapshots, object_map_name(image, snap))."""
        self.ioctx.write_full(object_map_name(self.image_name, snap_id),
                              bytes(self._bits))

    def flush(self) -> None:
        if self._full_rewrite:
            self.ioctx.write_full(self.oid, bytes(self._bits))
        elif self._dirty is not None:
            lo, hi = self._dirty
            self.ioctx.write(self.oid, bytes(self._bits[lo:hi]),
                             offset=lo)
        self._dirty = None
        self._full_rewrite = False

    def remove(self) -> None:
        try:
            self.ioctx.remove(self.oid)
        except RadosError as err:
            _swallow("object_map_remove", err)

    def existing(self) -> list[int]:
        return [o for o in range(self.span)
                if self.get(o) != self.NONEXISTENT]


class RBD:
    """Pool-level image operations (ref: librbd::RBD)."""

    def create(self, ioctx: IoCtx, name: str, size: int,
               order: int = RBD_DEFAULT_ORDER, stripe_unit: int = 0,
               stripe_count: int = 1,
               journaling: bool = False) -> None:
        if self._exists(ioctx, name):
            raise RBDError(17, f"image {name!r} exists")
        obj_size = 1 << order
        su = stripe_unit or obj_size
        layout = StripeLayout(stripe_unit=su, stripe_count=stripe_count,
                              object_size=obj_size)
        layout.validate()
        meta = {"size": size, "order": order, "stripe_unit": su,
                "stripe_count": stripe_count}
        if journaling:
            # write-ahead mutation journal (ref: librbd journaling
            # feature; consumed by ceph_tpu_torch.rbd.mirror)
            meta["journaling"] = True
            from ..journal import Journaler
            Journaler(ioctx, f"rbd.{name}", "master").create()
        ioctx.write_full(header_name(name), json.dumps(meta).encode())

    def remove(self, ioctx: IoCtx, name: str) -> None:
        img = Image(ioctx, name)
        try:
            if img.snaps:
                raise RBDError(39, f"image {name!r} has snapshots "
                                   "(purge them first)")
            img._detach_from_parent()
            for objno in range(img._object_span()):
                try:
                    ioctx.remove(data_name(name, objno))
                except RadosError as err:
                    _swallow("remove", err)
            img.object_map.remove()
            if img._journal is not None:
                img._journal.remove()
        finally:
            img.close()
        ioctx.remove(header_name(name))

    def clone(self, p_ioctx: IoCtx, p_name: str, p_snap: str,
              c_ioctx: IoCtx, c_name: str,
              order: int | None = None) -> None:
        """Snapshot-backed COW clone (ref: librbd::clone; parent must
        be protected — librbd/internal.cc clone preconditions; child
        records the parent link, parent records the child —
        cls_rbd children)."""
        parent = Image(p_ioctx, p_name)
        try:
            if p_snap not in parent.snaps:
                raise RBDError(2, f"snapshot {p_snap!r} not found")
            snap = parent.snaps[p_snap]
            if not snap.get("protected"):
                raise RBDError(22, f"snapshot {p_snap!r} is not "
                                   "protected")
            if self._exists(c_ioctx, c_name):
                raise RBDError(17, f"image {c_name!r} exists")
            if parent.layout.stripe_count != 1:
                raise RBDError(22, "clone requires stripe_count=1 "
                                   "parents")
            order = order if order is not None else parent.order
            overlap = int(snap["size"])
            meta = {"size": overlap, "order": order,
                    "stripe_unit": 1 << order, "stripe_count": 1,
                    "parent": {"pool": p_ioctx._pool_name(),
                               "image": p_name, "snap_name": p_snap,
                               "snap_id": snap["id"],
                               "overlap": overlap}}
            c_ioctx.write_full(header_name(c_name),
                               json.dumps(meta).encode())
            parent.meta_children.append(
                [c_ioctx._pool_name(), c_name, p_snap])
            parent._save_meta()
        finally:
            parent.close()

    def list(self, ioctx: IoCtx) -> list[str]:
        """(ref: librbd::RBD::list — header-object scan)."""
        return sorted(oid[len("rbd_header."):]
                      for oid in ioctx.list_objects()
                      if oid.startswith("rbd_header."))

    # -- live migration (ref: librbd::RBD migration_* API surface) -----
    def migration_prepare(self, src_ioctx: IoCtx, src_name: str,
                          dst_ioctx: IoCtx, dst_name: str) -> None:
        from .migration import migration_prepare
        migration_prepare(src_ioctx, src_name, dst_ioctx, dst_name)

    def migration_execute(self, dst_ioctx: IoCtx,
                          dst_name: str) -> None:
        from .migration import migration_execute
        migration_execute(dst_ioctx, dst_name)

    def migration_commit(self, dst_ioctx: IoCtx,
                         dst_name: str) -> None:
        from .migration import migration_commit
        migration_commit(dst_ioctx, dst_name)

    def migration_abort(self, dst_ioctx: IoCtx,
                        dst_name: str) -> None:
        from .migration import migration_abort
        migration_abort(dst_ioctx, dst_name)

    @staticmethod
    def _exists(ioctx: IoCtx, name: str) -> bool:
        try:
            ioctx.stat(header_name(name))
            return True
        except RadosError as err:
            _swallow("exists", err)
            return False


class Image:
    """(ref: librbd::Image / ImageCtx).

    Snapshots are librbd-style SELF-MANAGED rados snaps (ref:
    librbd::Operations::snap_create -> selfmanaged_snap_create +
    per-image SnapContext on every data-object write): snapids live in
    the image header, the write snapc rides on a private IoCtx, and
    opening at a snapshot reads each data object at that snapid."""

    def __init__(self, ioctx: IoCtx, name: str,
                 snapshot: str | None = None,
                 _migration_internal: bool = False):
        self.ioctx = ioctx
        self.name = name
        try:
            raw = ioctx.read(header_name(name))
        except RadosError as ex:
            raise RBDError(2, f"image {name!r} does not exist") from ex
        meta = json.loads(raw.decode())
        if meta.get("migration") and not _migration_internal:
            # a migration source only serves the destination's
            # fall-through reads; clients must open the destination
            # (ref: Migration.cc's migrating state gating opens)
            raise RBDError(30, f"image {name!r} is migrating to "
                           f"{meta['migration']['dst_image']!r}")
        self._migrating_source = bool(meta.get("migration"))
        self.size = int(meta["size"])
        self.order = int(meta["order"])
        self.layout = StripeLayout(
            stripe_unit=int(meta["stripe_unit"]),
            stripe_count=int(meta["stripe_count"]),
            object_size=1 << self.order)
        self.snaps: dict[str, dict] = meta.get("snaps", {})
        self.parent: dict | None = meta.get("parent")
        self.meta_children: list = meta.get("children", [])
        #: mirror state (ref: librbd mirror image info): None = not
        #: mirrored; else {"primary": bool, "epochs": [promotion ids]}
        self.mirror: dict | None = meta.get("mirror")
        #: write-ahead mutation journal (ref: librbd journaling)
        self.journaling = bool(meta.get("journaling"))
        self._journal = None
        if self.journaling:
            from ..journal import Journaler
            self._journal = Journaler(ioctx, f"rbd.{name}", "master")
        self._parent_image: "Image | None" = None
        self._snap_id: int | None = None
        if snapshot is not None:
            if snapshot not in self.snaps:
                raise RBDError(2, f"snapshot {snapshot!r} not found")
            self._snap_id = self.snaps[snapshot]["id"]
            self.size = int(self.snaps[snapshot]["size"])
        # writes go through a private IoCtx carrying the image snapc
        # (the caller's IoCtx must not inherit it)
        self._wio = IoCtx(ioctx.rados, ioctx.pool_id)
        self._refresh_snapc()
        self._open = True
        # exclusive-lock state (ref: librbd/exclusive_lock/ManagedLock)
        self._iolock = make_lock(f"rbd.image.{name}")
        self._lock_owned = False
        self._lock_cookie = f"{ioctx.rados.objecter.name}." \
                            f"{id(self):x}"
        self._watch_cookie: str | None = None
        # per-image object map (head only; snapshot maps are loaded on
        # demand for diffs)
        self.object_map = ObjectMap(self._wio, name,
                                    self._object_span())
        # write-back object cache (ref: librbd's ObjectCacher mount,
        # rbd_cache*): head IO only — snapshot opens read frozen state
        # and bypass it.  The exclusive lock is the coherence protocol:
        # release flushes + invalidates.
        self._oc = None
        # write-back writes in flight (see _oc_write)
        self._aio_lock = make_lock(f"rbd.image.{name}.aio")
        self._aio_pending: list = []
        from ..common.options import global_config
        if global_config()["rbd_cache"] and self._snap_id is None:
            from ..osdc.object_cacher import ObjectCacher
            cfg = global_config()
            self._oc = ObjectCacher(
                self._oc_read, self._oc_write,
                max_dirty=cfg["rbd_cache_max_dirty"],
                max_size=cfg["rbd_cache_size"],
                page=min(1 << self.order, 1 << 16))

    # -- object cache backing (oid = str(objectno)) ---------------------
    def _oc_read(self, oid: str, off: int, length: int) -> bytes:
        """Head object read with clone parent fall-through (the same
        resolution Image.read performs per extent)."""
        objno = int(oid)
        try:
            return self.ioctx.read(data_name(self.name, objno),
                                   length=length, offset=off)
        except RadosError as ex:
            if ex.errno_name != "ENOENT":
                raise
        parent = self._parent()
        if parent is not None and self.parent is not None:
            p_off = objno * (1 << self.order) + off
            p_len = min(length, self.parent["overlap"] - p_off)
            if p_len > 0:
                return parent.read(p_off, p_len)
        return b""

    def _oc_write(self, oid: str, off: int, data: bytes) -> None:
        """Backing write at flush time: copyup for parent-backed
        partial overwrites + object-map existence, exactly like the
        uncached write path."""
        objno = int(oid)
        partial = not (off == 0 and len(data) == 1 << self.order)
        if partial and objno < self._overlap_span() and \
                self.object_map.get(objno) == ObjectMap.NONEXISTENT:
            self._copyup(objno)
        fut = self._wio.aio_write(data_name(self.name, objno), data,
                                  offset=off)
        self.object_map.set(objno, ObjectMap.EXISTS, flush=False)
        with self._aio_lock:
            self._aio_pending.append(fut)
            full = len(self._aio_pending) >= AIO_MAX_PENDING
        if full:
            self._aio_drain()

    def _aio_drain(self) -> None:
        """Wait for every write-back write in flight, in submission
        order; the first that failed raises."""
        with self._aio_lock:
            pending, self._aio_pending = self._aio_pending, []
        for fut in pending:
            self._wio._wait(fut)

    def flush(self) -> None:
        """Flush the write-back cache (ref: rbd_flush): dirty data
        reaches RADOS and the object map is persisted."""
        if self._oc is not None:
            with self._iolock:
                self._oc.flush()
                self._aio_drain()
                self.object_map.flush()

    # -- exclusive lock (ref: src/librbd/exclusive_lock/) --------------
    @property
    def lock_owner(self) -> bool:
        return self._lock_owned

    def _header_notify(self, notify_id, notifier, payload):
        """Watch callback on the header object: peers ask the holder to
        release (ref: librbd watch_notify REQUEST_LOCK)."""
        op = (payload or {}).get("op")
        if op == "request_lock" and self._lock_owned:
            LOCKS["released_on_request"] += 1
            # release must not run sync IO on the dispatch thread
            threading.Thread(target=self.release_lock,
                             daemon=True).start()
        return {"owner": self._lock_owned}

    def _ensure_watch(self) -> None:
        if self._watch_cookie is None:
            self._watch_cookie = self.ioctx.watch(
                header_name(self.name), self._header_notify)

    def acquire_lock(self, timeout: float = 30.0) -> None:
        """Take the exclusive write lock, cooperatively requesting it
        from a live holder and breaking a dead one
        (ref: ManagedLock acquire + break_lock for gone clients)."""
        self._check_open()
        if self._lock_owned:
            return
        self._ensure_watch()
        me = self.ioctx.rados.objecter.name
        hdr = header_name(self.name)
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.ioctx.exec(hdr, "lock", "lock", {
                    "name": RBD_LOCK_NAME, "type": "exclusive",
                    "client": me, "cookie": self._lock_cookie,
                    "desc": "rbd exclusive lock"})
                self._lock_owned = True
                return
            except RadosError as ex:
                if ex.errno_name != "EBUSY":
                    raise
            info = self.ioctx.exec(hdr, "lock", "get_info",
                                   {"name": RBD_LOCK_NAME}) or {}
            lockers = info.get("lockers", [])
            # ask the holder to release; a holder that no longer
            # watches the header is dead -> break its lock
            replies, _timeouts = self.ioctx.notify(
                hdr, {"op": "request_lock"})
            live = {k.split("/", 1)[0] for k in replies}
            for lk in lockers:
                if lk["client"] not in live:
                    try:
                        self.ioctx.exec(hdr, "lock", "break_lock", {
                            "name": RBD_LOCK_NAME,
                            "locker": lk["client"],
                            "cookie": lk.get("cookie", "")})
                        LOCKS["broken"] += 1
                    except RadosError as err:
                        _swallow("break_lock", err)
            if time.monotonic() > deadline:
                raise RBDError(16, f"exclusive lock on {self.name!r} "
                                   "held")
            time.sleep(0.05)

    def release_lock(self) -> None:
        with self._iolock:
            if not self._lock_owned:
                return
            # the lock is the cache-coherence protocol: dirty data
            # must land and cached state drop BEFORE another client
            # can take the lock (ref: pre-release flush in
            # librbd's exclusive_lock PreReleaseRequest)
            if self._oc is not None:
                self._oc.flush()
                self._aio_drain()
                self.object_map.flush()
                self._oc.invalidate()
            try:
                self.ioctx.exec(header_name(self.name), "lock",
                                "unlock", {
                                    "name": RBD_LOCK_NAME,
                                    "client":
                                        self.ioctx.rados.objecter.name,
                                    "cookie": self._lock_cookie})
            except RadosError as err:
                _swallow("unlock", err)
            self._lock_owned = False

    def _ensure_lock(self) -> None:
        with self._iolock:
            if not self._lock_owned:
                self.acquire_lock()

    # -- clone parent plumbing ------------------------------------------
    def _parent(self) -> "Image | None":
        if self.parent is None:
            return None
        if self._parent_image is None:
            pio = self.ioctx.rados.open_ioctx(self.parent["pool"])
            self._parent_image = Image(
                pio, self.parent["image"],
                snapshot=self.parent["snap_name"],
                _migration_internal=bool(
                    self.parent.get("migration")))
        return self._parent_image

    def _detach_from_parent(self) -> None:
        """Drop the parent link + deregister from its children."""
        if self.parent is None:
            return
        try:
            pio = self.ioctx.rados.open_ioctx(self.parent["pool"])
            p = Image(pio, self.parent["image"])
            me = [self.ioctx._pool_name(), self.name,
                  self.parent["snap_name"]]
            p.meta_children = [c for c in p.meta_children
                               if list(c) != me]
            p._save_meta()
            p.close()
        except RadosError as err:
            _swallow("detach_from_parent", err)
        if self._parent_image is not None:
            self._parent_image.close()
            self._parent_image = None
        self.parent = None

    def _refresh_snapc(self) -> None:
        ids = sorted(s["id"] for s in self.snaps.values())
        if ids:
            self._wio.set_write_snapc(max(ids), ids)
        else:
            self._wio.write_snapc = None

    # -- metadata ------------------------------------------------------
    def stat(self) -> dict:
        """(ref: librbd image_info_t)."""
        return {"size": self.size, "order": self.order,
                "obj_size": 1 << self.order,
                "num_objs": self._object_span(),
                "stripe_unit": self.layout.stripe_unit,
                "stripe_count": self.layout.stripe_count}

    def _object_span(self) -> int:
        return self._span_for(self.size)

    def resize(self, size: int) -> None:
        """Grow or shrink; shrink removes whole objects past the end
        (ref: librbd Operations::resize / object trimming)."""
        self._check_open()
        self._check_writable()
        self._ensure_lock()
        if self._oc is not None:
            # flush, then drop: shrink removes backing objects the
            # cache may still shadow
            self.flush()
            self._oc.invalidate()
        if self._journal is not None:
            self._journal.append("resize", {"size": size})
        old_span = self._object_span()
        self.size = size
        new_span = self._object_span()
        for objno in range(new_span, old_span):
            try:
                self._wio.remove(data_name(self.name, objno))
            except RadosError as err:
                _swallow("resize", err)
        # shrinking a clone trims the parent overlap — regrowing must
        # read zeros, not resurrect parent snapshot bytes
        # (ref: librbd Operations::resize overlap trim)
        if self.parent is not None and \
                size < self.parent.get("overlap", 0):
            self.parent["overlap"] = size
        self.object_map.resize(new_span)
        self._save_meta()

    def _save_meta(self) -> None:
        meta = {"size": self.size, "order": self.order,
                "stripe_unit": self.layout.stripe_unit,
                "stripe_count": self.layout.stripe_count,
                "snaps": self.snaps}
        if self.parent is not None:
            meta["parent"] = self.parent
        if self.meta_children:
            meta["children"] = self.meta_children
        if self.journaling:
            meta["journaling"] = True
        if self.mirror is not None:
            meta["mirror"] = self.mirror
        self.ioctx.write_full(header_name(self.name),
                              json.dumps(meta).encode())

    # -- snapshots (ref: librbd::Operations snap_create/remove/rollback)
    def snap_create(self, snap_name: str) -> None:
        self._check_open()
        self._check_writable()
        self._ensure_lock()
        if snap_name in self.snaps:
            raise RBDError(17, f"snapshot {snap_name!r} exists")
        # dirty cached data belongs BEFORE the snapshot point
        # (ref: librbd flushes the ObjectCacher ahead of snap_create)
        self.flush()
        if self._journal is not None:
            self._journal.append("snap_create", {"name": snap_name})
        sid = self._wio.selfmanaged_snap_create()
        self.snaps[snap_name] = {"id": sid, "size": self.size}
        # fast-diff epoch: freeze the object map beside the snapshot,
        # then EXISTS -> EXISTS_CLEAN on the head map
        # (ref: librbd object map snapshots)
        self.object_map.save_copy(sid)
        self.object_map.mark_clean()
        self._refresh_snapc()
        self._save_meta()

    def snap_remove(self, snap_name: str) -> None:
        self._check_open()
        self._check_writable()
        self._refresh_header()
        if snap_name not in self.snaps:
            raise RBDError(2, f"snapshot {snap_name!r} not found")
        if self.snaps[snap_name].get("protected"):
            raise RBDError(16, f"snapshot {snap_name!r} is protected")
        self._ensure_lock()
        if self._journal is not None:
            self._journal.append("snap_remove", {"name": snap_name})
        sid = self.snaps.pop(snap_name)["id"]
        self._wio.selfmanaged_snap_remove(sid)
        try:
            self._wio.remove(object_map_name(self.name, sid))
        except RadosError as err:
            _swallow("snap_remove", err)
        self._refresh_snapc()
        self._save_meta()

    def _refresh_header(self) -> None:
        """Re-read shared header state (snaps, children, parent) —
        another client's clone/protect may have advanced it
        (ref: librbd ImageCtx::refresh on header notify)."""
        try:
            raw = self.ioctx.read(header_name(self.name))
        except RadosError as err:
            _swallow("refresh_header", err)
            return
        meta = json.loads(raw.decode())
        self.snaps = meta.get("snaps", {})
        self.meta_children = meta.get("children", [])
        self.parent = meta.get("parent")
        self._refresh_snapc()

    def snap_protect(self, snap_name: str) -> None:
        """Clones only hang off protected snapshots
        (ref: librbd Operations::snap_protect)."""
        self._check_open()
        self._check_writable()
        self._refresh_header()
        if snap_name not in self.snaps:
            raise RBDError(2, f"snapshot {snap_name!r} not found")
        if self._journal is not None:
            self._journal.append("snap_protect", {"name": snap_name})
        self.snaps[snap_name]["protected"] = True
        self._save_meta()

    def snap_unprotect(self, snap_name: str) -> None:
        """Refused while children exist
        (ref: Operations::snap_unprotect child scan)."""
        self._check_open()
        self._check_writable()
        self._refresh_header()
        if snap_name not in self.snaps:
            raise RBDError(2, f"snapshot {snap_name!r} not found")
        if any(c[2] == snap_name for c in self.meta_children):
            raise RBDError(16, f"snapshot {snap_name!r} has clones")
        if self._journal is not None:
            self._journal.append("snap_unprotect", {"name": snap_name})
        self.snaps[snap_name].pop("protected", None)
        self._save_meta()

    def snap_is_protected(self, snap_name: str) -> bool:
        if snap_name not in self.snaps:
            raise RBDError(2, f"snapshot {snap_name!r} not found")
        return bool(self.snaps[snap_name].get("protected"))

    def children(self) -> list[tuple[str, str]]:
        """(pool, image) of clones (ref: librbd::Image::list_children)."""
        self._refresh_header()
        return [(c[0], c[1]) for c in self.meta_children]

    def snap_list(self) -> list[dict]:
        return [{"name": n, "id": s["id"], "size": s["size"]}
                for n, s in sorted(self.snaps.items(),
                                   key=lambda kv: kv[1]["id"])]

    def snap_rollback(self, snap_name: str) -> None:
        """Restore every data object to its state at the snapshot
        (ref: librbd snap_rollback iterates the objects)."""
        self._check_open()
        self._check_writable()
        self._ensure_lock()
        if snap_name not in self.snaps:
            raise RBDError(2, f"snapshot {snap_name!r} not found")
        if self._oc is not None:
            # post-snap dirty data is exactly what rollback discards
            self._oc.invalidate(discard_dirty=True)
            self._aio_drain()
        if self._journal is not None:
            self._journal.append("snap_rollback", {"name": snap_name})
        snap = self.snaps[snap_name]
        span = max(self._object_span(), self._span_for(snap["size"]))
        # fan the per-object rollbacks out like the write path: one
        # round of aio futures, not span sequential round trips
        futs = [self._wio.rados.objecter.submit(
                    self._wio.pool_id, data_name(self.name, objno),
                    "rollback",
                    args=self._wio._margs({"snapid": snap["id"]}))
                for objno in range(span)]
        for f in futs:
            self._wio._wait(f)
        self.size = int(snap["size"])
        # the head object map reverts to the snapshot's frozen map
        try:
            frozen = self._wio.read(object_map_name(self.name,
                                                    snap["id"]))
            self._wio.write_full(object_map_name(self.name), frozen)
            self.object_map = ObjectMap(self._wio, self.name,
                                        self._object_span())
        except RadosError as err:
            _swallow("snap_rollback", err)
        self._save_meta()

    def _span_for(self, size: int) -> int:
        if size == 0:
            return 0
        last = Striper.file_to_extents(self.layout, size - 1, 1)
        return max(e.objectno for e in last) + 1

    def _check_writable(self) -> None:
        if self._snap_id is not None:
            raise RBDError(30, "image is open read-only at a snapshot")
        if self._migrating_source:
            raise RBDError(30, "image is a migration source")
        if self.mirror is not None and \
                not self.mirror.get("primary", True) and \
                not getattr(self, "_replaying", False):
            # a demoted mirror image refuses local writes — only the
            # primary's journal replayer may mutate it (ref: librbd's
            # non-primary write gate; the replayer sets _replaying)
            raise RBDError(30, "image is non-primary (demoted)")

    # -- IO ------------------------------------------------------------
    def _check_open(self) -> None:
        if not self._open:
            raise RBDError(9, "image is closed")

    def _clip(self, offset: int, length: int) -> int:
        if offset > self.size:
            raise RBDError(22, "offset beyond end of image")
        return min(length, self.size - offset)

    def _overlap_span(self) -> int:
        """Objects of this image backed by the parent snapshot."""
        if self.parent is None:
            return 0
        return self._span_for(min(self.parent["overlap"], self.size))

    def _copyup(self, objno: int) -> None:
        """Materialize a parent-backed object in the child before a
        partial write/zero (ref: librbd io/CopyupRequest.cc)."""
        parent = self._parent()
        if parent is None:
            return
        obj_size = 1 << self.order
        off = objno * obj_size
        length = min(obj_size, self.parent["overlap"] - off)
        if length <= 0:
            return
        data = parent.read(off, length)
        # any non-zero byte (the reference's `data.strip(b"\0")`, which
        # walks a zero object byte by byte)
        if data != bytes(len(data)):
            self._wio.write_full(data_name(self.name, objno), data)
        self.object_map.set(objno, ObjectMap.EXISTS)

    def write(self, offset: int, data: bytes) -> int:
        """(ref: librbd io/ImageRequest.cc write path: extents through
        the striper, one object op per extent).  Takes the exclusive
        lock, copies parent-backed objects up on partial overwrite,
        and tracks existence in the object map."""
        self._check_open()
        self._check_writable()
        with self._iolock:
            self._ensure_lock()
            length = self._clip(offset, len(data))
            if self._journal is not None and length:
                # write-ahead: the event lands in the journal before
                # the data objects (ref: librbd journaling ordering)
                self._journal.append("write", {
                    "off": offset, "data": bytes(data[:length])})
            if self._oc is not None:
                # write-back: pages buffer in the cache; copyup +
                # object-map existence happen at flush in _oc_write
                for ext in Striper.file_to_extents(self.layout,
                                                   offset, length):
                    buf = data[ext.logical_offset - offset:
                               ext.logical_offset - offset
                               + ext.length]
                    self._oc.write(str(ext.objectno), ext.offset, buf)
                return length
            obj_size = 1 << self.order
            over = self._overlap_span()
            futs = []
            for ext in Striper.file_to_extents(self.layout, offset,
                                               length):
                partial = not (ext.offset == 0
                               and ext.length == obj_size)
                if partial and ext.objectno < over and \
                        self.object_map.get(ext.objectno) == \
                        ObjectMap.NONEXISTENT:
                    self._copyup(ext.objectno)
                buf = data[ext.logical_offset - offset:
                           ext.logical_offset - offset + ext.length]
                futs.append((ext.objectno, self._wio.aio_write(
                    data_name(self.name, ext.objectno), buf,
                    offset=ext.offset)))
            for objno, f in futs:
                self._wio._wait(f)
                self.object_map.set(objno, ObjectMap.EXISTS,
                                    flush=False)
            self.object_map.flush()
            return length

    def read(self, offset: int, length: int) -> bytes:
        """Sparse-aware: missing objects/ranges read as zeros; clone
        reads fall through to the parent snapshot within the overlap
        (ref: io/ImageReadRequest parent read-from)."""
        self._check_open()
        length = self._clip(offset, length)
        if self._oc is not None and self._snap_id is None:
            out = bytearray(length)
            for ext in Striper.file_to_extents(self.layout, offset,
                                               length):
                buf = self._oc.read(str(ext.objectno), ext.offset,
                                    ext.length)
                base = ext.logical_offset - offset
                out[base:base + len(buf)] = buf
            return bytes(out)
        out = bytearray(length)
        pend = []
        for ext in Striper.file_to_extents(self.layout, offset, length):
            fut = self.ioctx.aio_read(
                data_name(self.name, ext.objectno),
                length=ext.length, offset=ext.offset,
                snapid=self._snap_id)
            pend.append((ext, fut))
        obj_size = 1 << self.order
        for ext, fut in pend:
            try:
                buf = self.ioctx._wait(fut).data
            except RadosError as ex:
                if ex.errno_name != "ENOENT":
                    raise
                buf = b""
                # whole-object miss on a clone: serve from the parent
                parent = self._parent()
                if parent is not None and self.parent is not None:
                    p_off = ext.objectno * obj_size + ext.offset
                    p_len = min(ext.length,
                                self.parent["overlap"] - p_off)
                    if p_len > 0:
                        buf = parent.read(p_off, p_len)
            base = ext.logical_offset - offset
            out[base:base + len(buf)] = buf
        return bytes(out)

    def discard(self, offset: int, length: int) -> None:
        """Zero a range (whole-object removes when covered,
        ref: io/ImageRequest.cc discard).  Parent-backed objects are
        zeroed, never removed — a remove would resurrect the parent's
        bytes through the fall-through read."""
        self._check_open()
        self._check_writable()
        with self._iolock:
            self._ensure_lock()
            length = self._clip(offset, length)
            if self._oc is not None:
                # flush dirty state, then drop exactly the discarded
                # extents — the backing removes/zeros below must not
                # be shadowed by cached pages, and the rest of the
                # cache stays warm
                self._oc.flush()
                self._aio_drain()
                for ext in Striper.file_to_extents(self.layout,
                                                   offset, length):
                    self._oc.discard(str(ext.objectno), ext.offset,
                                     ext.length)
            if self._journal is not None and length:
                self._journal.append("discard", {"off": offset,
                                                 "len": length})
            obj_size = 1 << self.order
            over = self._overlap_span()
            for ext in Striper.file_to_extents(self.layout, offset,
                                               length):
                oid = data_name(self.name, ext.objectno)
                whole = ext.offset == 0 and ext.length == obj_size
                backed = ext.objectno < over
                if whole and not backed:
                    try:
                        self._wio.remove(oid)
                    except RadosError as err:
                        _swallow("discard", err)
                    self.object_map.set(ext.objectno,
                                        ObjectMap.NONEXISTENT,
                                        flush=False)
                    continue
                if backed and not whole and \
                        self.object_map.get(ext.objectno) == \
                        ObjectMap.NONEXISTENT:
                    self._copyup(ext.objectno)
                self._wio.write(oid, b"\0" * ext.length,
                                offset=ext.offset)
                self.object_map.set(ext.objectno, ObjectMap.EXISTS,
                                    flush=False)
            self.object_map.flush()

    # -- object-map-driven queries (ref: librbd object_map fast-diff) --
    def du(self) -> int:
        """Provisioned bytes from the object map — no data-object scan
        (ref: rbd du fast-diff path)."""
        self._check_open()
        self.flush()        # cached writes count once they exist
        obj_size = 1 << self.order
        used = 0
        for objno in self.object_map.existing():
            used += min(obj_size, self.size - objno * obj_size)
        return used

    def diff_since(self, snap_name: str | None) -> list[dict]:
        """Changed objects since a snapshot (None = since creation),
        straight from the object maps (ref: diff_iterate with
        whole_object=true + fast-diff)."""
        self._check_open()
        if self._snap_id is None:
            self.flush()    # cached writes must reach the object map
        obj_size = 1 << self.order
        if snap_name is None:
            base = None
        else:
            if snap_name not in self.snaps:
                raise RBDError(2, f"snapshot {snap_name!r} not found")
            base = ObjectMap(self._wio, self.name,
                             self._span_for(
                                 int(self.snaps[snap_name]["size"])),
                             snap_id=self.snaps[snap_name]["id"])
        out = []
        for objno in range(self._object_span()):
            cur = self.object_map.get(objno)
            old = base.get(objno) if base is not None \
                else ObjectMap.NONEXISTENT
            exists_now = cur != ObjectMap.NONEXISTENT
            existed = old != ObjectMap.NONEXISTENT
            dirty = cur == ObjectMap.EXISTS
            if (exists_now != existed) or (exists_now and dirty):
                out.append({"objectno": objno,
                            "offset": objno * obj_size,
                            "length": min(obj_size,
                                          self.size - objno * obj_size),
                            "exists": exists_now})
        return out

    def flatten(self) -> None:
        """Copy every parent-backed block into the child and detach
        (ref: librbd Operations::flatten)."""
        self._check_open()
        self._check_writable()
        with self._iolock:
            self._ensure_lock()
            for objno in range(self._overlap_span()):
                if self.object_map.get(objno) == ObjectMap.NONEXISTENT:
                    self._copyup(objno)
            self.object_map.flush()
            self._detach_from_parent()
            self._save_meta()

    def close(self) -> None:
        if not self._open:
            return
        self.flush()
        self.release_lock()
        if self._watch_cookie is not None:
            try:
                self.ioctx.unwatch(header_name(self.name),
                                   self._watch_cookie)
            except RadosError as err:     # best-effort: peer may be gone
                _swallow("unwatch", err)
            self._watch_cookie = None
        if self._parent_image is not None:
            self._parent_image.close()
            self._parent_image = None
        self._open = False
