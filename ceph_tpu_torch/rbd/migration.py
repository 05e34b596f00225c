"""rbd live migration: prepare / execute / commit / abort (VERDICT r4
#7; ref: src/librbd/api/Migration.cc).

Model (the reference's flow, collapsed onto the clone/copyup
machinery that already exists in rbd/image.py):

* **prepare** — the destination image is created with a *migration
  parent* link to the source's HEAD (a clone link with no snapshot
  and full-size overlap).  The source header is marked migrating:
  direct opens now refuse with EROFS-style errors, so clients switch
  to the destination, whose reads fall through to the source for
  blocks not yet copied and whose writes copy-up first — IO continues
  throughout (ref: Migration.cc prepare creating the dst with the
  migration parent + the src's migrating state).
* **execute** — background deep-copy: every destination object still
  marked NONEXISTENT copies up from the source.  Client IO to the
  destination proceeds concurrently; copyup and writes serialize on
  the image lock per object (ref: Migration.cc execute ->
  DeepCopyRequest).
* **commit** — requires execute to have completed: the migration link
  detaches and the source image is deleted (ref: Migration.cc
  commit).
* **abort** — the destination is destroyed and the source unmarked;
  the source is untouched bit-for-bit because nothing ever wrote to
  it (ref: Migration.cc abort).

Scope note (documented divergence): a source with snapshots refuses
prepare — snapshot history migration (DeepCopy's SnapshotCopyRequest)
is not implemented; the reference migrates snaps too.

The port's copy of `ceph_tpu.rbd.migration`, with the same headers,
refusals and errnos.  Where the reference swallows a `RadosError`, the
port also counts it in `ceph_tpu_torch.rbd.image.SWALLOWED` unless its
errno is ENOENT.
"""
from __future__ import annotations

import json

from ..client import IoCtx, RadosError
from .image import (Image, ObjectMap, RBD_LOCK_NAME, RBDError,
                    _swallow, header_name)


def _read_meta(ioctx: IoCtx, name: str) -> dict:
    try:
        return json.loads(ioctx.read(header_name(name)).decode())
    except RadosError as ex:
        raise RBDError(2, f"image {name!r} does not exist") from ex


def _write_meta(ioctx: IoCtx, name: str, meta: dict) -> None:
    ioctx.write_full(header_name(name), json.dumps(meta).encode())


def migration_prepare(src_ioctx: IoCtx, src_name: str,
                      dst_ioctx: IoCtx, dst_name: str) -> None:
    """(ref: Migration.cc prepare)."""
    meta = _read_meta(src_ioctx, src_name)
    if meta.get("migration"):
        raise RBDError(16, f"{src_name!r} is already migrating")
    if meta.get("snaps"):
        raise RBDError(95, "migration of images with snapshots is "
                           "not supported")
    if meta.get("mirror") or meta.get("journaling"):
        raise RBDError(95, "migration of mirrored/journaled images "
                           "is not supported")
    # an active writer holds the exclusive lock: refuse, the operator
    # must quiesce first (the reference requires the source closed)
    try:
        info = src_ioctx.exec(header_name(src_name), "lock",
                              "get_info", {"name": RBD_LOCK_NAME}) \
            or {}
        if info.get("lockers"):
            raise RBDError(16, f"{src_name!r} has an active writer")
    except RadosError as err:
        _swallow("migration_prepare", err)
    try:
        dst_ioctx.stat(header_name(dst_name))
        raise RBDError(17, f"image {dst_name!r} exists")
    except RadosError as err:
        _swallow("migration_prepare_dst", err)
    dst_meta = {
        "size": int(meta["size"]), "order": int(meta["order"]),
        "stripe_unit": int(meta["stripe_unit"]),
        "stripe_count": int(meta["stripe_count"]),
        "parent": {"pool": src_ioctx._pool_name(), "image": src_name,
                   "snap_name": None, "snap_id": None,
                   "overlap": int(meta["size"]), "migration": True},
        "migration_source": {"pool": src_ioctx._pool_name(),
                             "image": src_name},
    }
    _write_meta(dst_ioctx, dst_name, dst_meta)
    meta["migration"] = {"state": "prepared",
                         "dst_pool": dst_ioctx._pool_name(),
                         "dst_image": dst_name}
    _write_meta(src_ioctx, src_name, meta)


def migration_execute(dst_ioctx: IoCtx, dst_name: str) -> None:
    """Deep-copy every not-yet-copied block; safe to run while
    clients write to the destination (ref: Migration.cc execute)."""
    img = Image(dst_ioctx, dst_name)
    try:
        if img.parent is None or not img.parent.get("migration"):
            raise RBDError(22, f"{dst_name!r} is not a migration "
                               "destination")
        src = img.parent
        for objno in range(img._overlap_span()):
            with img._iolock:
                img._ensure_lock()
                # the exclusive lock is the coherence point: a client
                # writer we just took it from flushed its cache AND
                # its object-map bits on release — reload the map so
                # a stale NONEXISTENT can't copy the parent's block
                # over a client write (and so our later map flushes
                # never write stale bits back)
                img.object_map = ObjectMap(img._wio, dst_name,
                                           img._object_span())
                if img.object_map.get(objno) == ObjectMap.NONEXISTENT:
                    img._copyup(objno)
        smeta = _read_meta(dst_ioctx.rados.open_ioctx(src["pool"]),
                           src["image"])
        smeta["migration"]["state"] = "executed"
        _write_meta(dst_ioctx.rados.open_ioctx(src["pool"]),
                    src["image"], smeta)
    finally:
        img.close()


def migration_commit(dst_ioctx: IoCtx, dst_name: str) -> None:
    """Detach + delete the source (ref: Migration.cc commit)."""
    dmeta = _read_meta(dst_ioctx, dst_name)
    srcref = dmeta.get("migration_source")
    if srcref is None:
        raise RBDError(22, f"{dst_name!r} is not a migration "
                           "destination")
    sio = dst_ioctx.rados.open_ioctx(srcref["pool"])
    smeta = _read_meta(sio, srcref["image"])
    if (smeta.get("migration") or {}).get("state") != "executed":
        raise RBDError(22, "migration not executed yet")
    # detach: the destination stands alone from here
    dmeta.pop("parent", None)
    dmeta.pop("migration_source", None)
    _write_meta(dst_ioctx, dst_name, dmeta)
    # delete the source bypassing the migrating-open gate
    from .image import data_name
    span = (int(smeta["size"]) + (1 << int(smeta["order"])) - 1) \
        >> int(smeta["order"])
    for objno in range(span):
        try:
            sio.remove(data_name(srcref["image"], objno))
        except RadosError as err:
            _swallow("migration_commit", err)
    for suffix in ("", *(f".{s['id']}" for s in
                         (smeta.get("snaps") or {}).values())):
        try:
            sio.remove(f"rbd_object_map.{srcref['image']}{suffix}")
        except RadosError as err:
            _swallow("migration_commit", err)
    sio.remove(header_name(srcref["image"]))


def migration_abort(dst_ioctx: IoCtx, dst_name: str) -> None:
    """Destroy the destination, unmark the source (ref: Migration.cc
    abort).  The source was never written, so unmarking IS the
    restore."""
    dmeta = _read_meta(dst_ioctx, dst_name)
    srcref = dmeta.get("migration_source")
    if srcref is None:
        raise RBDError(22, f"{dst_name!r} is not a migration "
                           "destination")
    from .image import data_name
    span = (int(dmeta["size"]) + (1 << int(dmeta["order"])) - 1) \
        >> int(dmeta["order"])
    for objno in range(span):
        try:
            dst_ioctx.remove(data_name(dst_name, objno))
        except RadosError as err:
            _swallow("migration_abort", err)
    try:
        dst_ioctx.remove(f"rbd_object_map.{dst_name}")
    except RadosError as err:
        _swallow("migration_abort", err)
    dst_ioctx.remove(header_name(dst_name))
    sio = dst_ioctx.rados.open_ioctx(srcref["pool"])
    smeta = _read_meta(sio, srcref["image"])
    smeta.pop("migration", None)
    _write_meta(sio, srcref["image"], smeta)
