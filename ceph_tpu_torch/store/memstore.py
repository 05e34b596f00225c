"""MemStore: in-memory ObjectStore (model: src/os/memstore/MemStore.cc).

Objects are bytearrays + attr/omap dicts, collections are dicts.  A
transaction is validated against a shadow view first, then applied, so
`queue_transaction` is atomic: a failing op leaves the store untouched
(the reference instead asserts mid-apply — MemStore.cc
_do_transaction's unhandled-op abort; a Python framework can do
better).

Supports the `objectstore_debug_inject_read_err` config: objects
marked via `inject_read_err` fail reads with EIO until cleared
(ref: filestore_debug_inject_read_err option and
FileStore::debug_obj_on_delete semantics, src/common/options.cc:4851).

The port's copy of `ceph_tpu.store.memstore`, with the same lockdep name
(`memstore.<path>`); `MemStore.from_reference` carries a store of
another package across by attribute.
"""
from __future__ import annotations

import copy

from ..common.lockdep import make_lock
from ..common.options import global_config
from .objectstore import (ObjectId, ObjectStore, StoreError, Transaction,
                          OP_TOUCH, OP_WRITE, OP_ZERO, OP_TRUNCATE,
                          OP_REMOVE, OP_SETATTRS, OP_RMATTR, OP_RMATTRS,
                          OP_CLONE, OP_CLONE_RANGE, OP_MKCOLL, OP_RMCOLL,
                          OP_COLL_MOVE_RENAME, OP_OMAP_CLEAR,
                          OP_OMAP_SETKEYS, OP_OMAP_RMKEYS)


class _Object:
    __slots__ = ("data", "xattr", "omap")

    def __init__(self):
        self.data = bytearray()
        self.xattr: dict = {}
        self.omap: dict[str, bytes] = {}

    def clone(self) -> "_Object":
        o = _Object()
        o.data = bytearray(self.data)
        o.xattr = copy.deepcopy(self.xattr)
        o.omap = dict(self.omap)
        return o


# wire registration under the reference's name: a journaled store's
# snapshot serializes whole collections through the typed codec
from ..msg.encoding import register_struct as _reg  # noqa: E402

_reg(_Object, version=1, compat=1, fields=("data", "xattr", "omap"))


class MemStore(ObjectStore):
    def __init__(self, path: str = "mem"):
        self.path = path
        self.colls: dict[str, dict[ObjectId, _Object]] = {}
        self.mounted = False
        self._lock = make_lock(f"memstore.{path}")
        self._read_err_objs: set[tuple[str, ObjectId]] = set()

    @classmethod
    def from_reference(cls, store) -> "MemStore":
        """A MemStore holding what `store` (another package's MemStore,
        the JAX reference's in the tests) holds: its collections, each
        object's data, xattrs and omap, and its injected read errors,
        copied by attribute.  Omap values are wire bytes (a PG log
        entry, the log tail), which `msg.encoding.decode` reads as
        they are."""
        out = cls(store.path)
        out.mounted = store.mounted
        for cid, objs in store.colls.items():
            coll = out.colls[cid] = {}
            for oid, obj in objs.items():
                o = _Object()
                o.data = bytearray(obj.data)
                o.xattr = copy.deepcopy(obj.xattr)
                o.omap = dict(obj.omap)
                coll[ObjectId(oid.name, oid.snap, oid.shard)] = o
        out._read_err_objs = {(cid, ObjectId(o.name, o.snap, o.shard))
                              for cid, o in store._read_err_objs}
        return out

    # -- lifecycle ------------------------------------------------------
    def mkfs(self) -> None:
        self.colls = {}

    def mount(self) -> None:
        self.mounted = True

    def umount(self) -> None:
        self.mounted = False

    # -- fault injection ------------------------------------------------
    def inject_read_err(self, cid: str, oid: ObjectId) -> None:
        self._read_err_objs.add((cid, oid))

    def clear_read_err(self, cid: str, oid: ObjectId) -> None:
        self._read_err_objs.discard((cid, oid))

    # -- txn apply ------------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:
            # validate+apply on a copy-on-write shadow of the touched
            # collections (populated lazily by _get_coll), then swap
            # in — atomicity without deep-copying the whole store
            shadow: dict[str, dict] = {}
            created: set[str] = set()
            removed: set[str] = set()
            # copy-on-write object identity: clone an object before its
            # first mutation inside this txn
            dirtied: set[int] = set()
            for op in txn.ops:
                self._apply(op, shadow, created, removed, dirtied)
            for cid in removed:
                self.colls.pop(cid, None)
            for cid, objs in shadow.items():
                self.colls[cid] = objs

    def _get_coll(self, shadow, cid: str, created, removed):
        if cid in removed:
            raise StoreError("ENOENT", f"collection {cid} removed in txn")
        c = shadow.get(cid)
        if c is None:
            if cid in self.colls and cid not in created:
                c = shadow[cid] = dict(self.colls[cid])
            else:
                raise StoreError("ENOENT", f"no collection {cid}")
        return c

    def _mutable(self, coll: dict, oid: ObjectId, dirtied: set,
                 create: bool = False) -> _Object:
        o = coll.get(oid)
        if o is None:
            if not create:
                raise StoreError("ENOENT", f"no object {oid}")
            o = coll[oid] = _Object()
            dirtied.add(id(o))
            return o
        if id(o) not in dirtied:
            o = o.clone()
            coll[oid] = o
            dirtied.add(id(o))
        return o

    def _apply(self, op, shadow, created, removed, dirtied) -> None:
        code = op[0]
        if code == OP_MKCOLL:
            _, cid, _bits = op
            if cid in self.colls and cid not in removed or cid in shadow:
                raise StoreError("EEXIST", f"collection {cid}")
            removed.discard(cid)
            created.add(cid)
            shadow[cid] = {}
            return
        if code == OP_RMCOLL:
            _, cid = op
            c = self._get_coll(shadow, cid, created, removed)
            if c:
                raise StoreError("ENOTEMPTY", f"collection {cid}")
            shadow.pop(cid, None)
            created.discard(cid)
            removed.add(cid)
            return
        if code == OP_COLL_MOVE_RENAME:
            _, oldcid, oldoid, cid, oid = op
            src = self._get_coll(shadow, oldcid, created, removed)
            dst = self._get_coll(shadow, cid, created, removed)
            if oldoid not in src:
                raise StoreError("ENOENT", f"{oldcid}/{oldoid}")
            if oid in dst and not (cid == oldcid and oid == oldoid):
                raise StoreError("EEXIST", f"{cid}/{oid}")
            dst[oid] = src.pop(oldoid)
            return

        cid, oid = op[1], op[2]
        coll = self._get_coll(shadow, cid, created, removed)
        if code == OP_TOUCH:
            self._mutable(coll, oid, dirtied, create=True)
        elif code == OP_WRITE:
            _, _, _, off, data = op
            o = self._mutable(coll, oid, dirtied, create=True)
            end = off + len(data)
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[off:end] = data
        elif code == OP_ZERO:
            _, _, _, off, length = op
            o = self._mutable(coll, oid, dirtied, create=True)
            end = off + length
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[off:end] = b"\0" * length
        elif code == OP_TRUNCATE:
            _, _, _, size = op
            o = self._mutable(coll, oid, dirtied)
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
        elif code == OP_REMOVE:
            if oid not in coll:
                raise StoreError("ENOENT", f"{cid}/{oid}")
            del coll[oid]
        elif code == OP_SETATTRS:
            _, _, _, attrs = op
            o = self._mutable(coll, oid, dirtied, create=True)
            o.xattr.update(attrs)
        elif code == OP_RMATTR:
            _, _, _, name = op
            o = self._mutable(coll, oid, dirtied)
            o.xattr.pop(name, None)
        elif code == OP_RMATTRS:
            o = self._mutable(coll, oid, dirtied)
            o.xattr.clear()
        elif code == OP_CLONE:
            _, _, _, noid = op
            if oid not in coll:
                raise StoreError("ENOENT", f"{cid}/{oid}")
            coll[noid] = coll[oid].clone()
            dirtied.add(id(coll[noid]))
        elif code == OP_CLONE_RANGE:
            _, _, _, noid, srcoff, length, dstoff = op
            if oid not in coll:
                raise StoreError("ENOENT", f"{cid}/{oid}")
            src = coll[oid].data[srcoff:srcoff + length]
            o = self._mutable(coll, noid, dirtied, create=True)
            end = dstoff + len(src)
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[dstoff:end] = src
        elif code == OP_OMAP_CLEAR:
            o = self._mutable(coll, oid, dirtied)
            o.omap.clear()
        elif code == OP_OMAP_SETKEYS:
            _, _, _, keys = op
            o = self._mutable(coll, oid, dirtied, create=True)
            o.omap.update(keys)
        elif code == OP_OMAP_RMKEYS:
            _, _, _, keys = op
            o = self._mutable(coll, oid, dirtied)
            for key in keys:
                o.omap.pop(key, None)
        else:
            raise StoreError("EOPNOTSUPP", f"unknown op {code}")

    # -- read side ------------------------------------------------------
    def _obj(self, cid: str, oid: ObjectId) -> _Object:
        c = self.colls.get(cid)
        if c is None:
            raise StoreError("ENOENT", f"no collection {cid}")
        o = c.get(oid)
        if o is None:
            raise StoreError("ENOENT", f"{cid}/{oid}")
        return o

    def read(self, cid: str, oid: ObjectId, off: int = 0,
             length: int = 0) -> bytes:
        with self._lock:
            if ((cid, oid) in self._read_err_objs
                    and global_config()["objectstore_debug_inject_read_err"]):
                raise StoreError("EIO", f"injected read error {cid}/{oid}")
            o = self._obj(cid, oid)
            if length == 0:
                length = len(o.data) - off
            return bytes(o.data[off:off + length])

    def stat(self, cid: str, oid: ObjectId) -> dict:
        with self._lock:
            o = self._obj(cid, oid)
            return {"size": len(o.data)}

    def exists(self, cid: str, oid: ObjectId) -> bool:
        with self._lock:
            c = self.colls.get(cid)
            return c is not None and oid in c

    def getattr(self, cid: str, oid: ObjectId, name: str):
        with self._lock:
            o = self._obj(cid, oid)
            if name not in o.xattr:
                raise StoreError("ENODATA", f"{oid} xattr {name}")
            return o.xattr[name]

    def getattrs(self, cid: str, oid: ObjectId) -> dict:
        with self._lock:
            return dict(self._obj(cid, oid).xattr)

    def omap_get(self, cid: str, oid: ObjectId) -> dict[str, bytes]:
        with self._lock:
            return dict(self._obj(cid, oid).omap)

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self.colls)

    def collection_exists(self, cid: str) -> bool:
        with self._lock:
            return cid in self.colls

    def collection_list(self, cid: str) -> list[ObjectId]:
        with self._lock:
            c = self.colls.get(cid)
            if c is None:
                raise StoreError("ENOENT", f"no collection {cid}")
            return sorted(c)

    def statfs(self) -> dict:
        with self._lock:
            used = sum(len(o.data) for c in self.colls.values()
                       for o in c.values())
            total = global_config()["memstore_device_bytes"]
            return {"total": total, "used": used,
                    "available": max(0, total - used)}
