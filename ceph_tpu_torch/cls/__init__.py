"""Object classes: server-side procedures executed inside the OSD.

The reference loads `libcls_*.so` plugins via ClassHandler
(ref: src/osd/ClassHandler.cc; plugin API src/objclass/objclass.h) and
executes their methods inside the op context with direct access to the
target object (cls_cxx_read/write/getxattr/map_*).  Clients invoke them
with CEPH_OSD_OP_CALL (`IoCtx::exec`).

Here a class is a Python module registering named methods on the
singleton registry; a method runs on the PG primary with a
`MethodContext` exposing synchronous reads of the local object and a
mutation collector — queued mutations commit atomically WITH the
method's success through the normal backend pipeline, mirroring how the
reference folds cls writes into the op's ObjectStore transaction.

Built-in classes mirror the reference's most-used plugins:
`lock` (src/cls/lock), `refcount` (src/cls/refcount),
`version` (src/cls/version), `log` (src/cls/log),
`numops` (src/cls/numops — atomic omap counter arithmetic).

Exec is limited to replicated pools (the data reads a method may issue
are synchronous primary-local reads; EC pools would need a
reconstructing read — the reference's cls users, rbd/rgw metadata,
likewise live on replicated pools).

The port's copy of `ceph_tpu.cls`: the registry, `MethodContext` and
the classes `lock`, `refcount`, `version`, `rgw`, `queue`, `log` and
`numops`.
"""
from __future__ import annotations

from typing import Callable

from ..store import StoreError

# method flags (ref: objclass.h CLS_METHOD_RD/WR/PROMOTE)
CLS_METHOD_RD = 1
CLS_METHOD_WR = 2


class ClsError(Exception):
    """Method failure carrying an errno name (maps to the negative rc
    the reference's cls methods return)."""

    def __init__(self, errno_name: str, msg: str = ""):
        self.errno_name = errno_name
        super().__init__(f"{errno_name}: {msg}" if msg else errno_name)


class MethodContext:
    """Per-call handle onto the target object (ref: objclass.h
    cls_method_context_t + the cls_cxx_* accessors).

    Reads are served synchronously from the primary's local shard;
    writes queue mutations that the daemon commits atomically after
    the method returns successfully.
    """

    def __init__(self, shard, oid: str):
        self._shard = shard
        self.oid = oid
        self.mutations: list[tuple] = []

    # -- reads (cls_cxx_read/stat/getxattr/map_get_*) -------------------
    def exists(self) -> bool:
        return self._shard.exists(self.oid)

    def stat(self) -> dict:
        if not self.exists():
            raise ClsError("ENOENT", self.oid)
        return {"size": self._shard.object_size(self.oid)}

    def read(self, off: int = 0, length: int = 0) -> bytes:
        try:
            return self._shard.read(self.oid, off, length)
        except StoreError as e:
            raise ClsError(e.errno_name) from e

    def getxattr(self, name: str) -> bytes:
        try:
            return self._shard.getxattr(self.oid, name)
        except StoreError as e:
            raise ClsError(e.errno_name) from e

    def getxattrs(self) -> dict:
        try:
            return self._shard.getxattrs(self.oid)
        except StoreError as e:
            raise ClsError(e.errno_name) from e

    def omap_get(self) -> dict:
        try:
            return self._shard.omap_get(self.oid)
        except StoreError as e:
            raise ClsError(e.errno_name) from e

    def omap_get_header(self) -> bytes:
        try:
            return self._shard.omap_get_header(self.oid)
        except StoreError as e:
            raise ClsError(e.errno_name) from e

    # -- queued writes (cls_cxx_write/setxattr/map_set_*) ---------------
    def create(self, exclusive: bool = False) -> None:
        if exclusive and self.exists():
            raise ClsError("EEXIST", self.oid)
        self.mutations.append(("create",))

    def write(self, off: int, data: bytes) -> None:
        self.mutations.append(("write", off, bytes(data)))

    def write_full(self, data: bytes) -> None:
        self.mutations.append(("writefull", bytes(data)))

    def truncate(self, size: int) -> None:
        self.mutations.append(("truncate", int(size)))

    def remove(self) -> None:
        self.mutations.append(("delete",))

    def setxattr(self, name: str, value: bytes) -> None:
        self.mutations.append(("setxattrs", {name: bytes(value)}))

    def rmxattr(self, name: str) -> None:
        self.mutations.append(("rmxattr", name))

    def omap_set(self, kv: dict) -> None:
        self.mutations.append(("omap_setkeys",
                               {k: bytes(v) for k, v in kv.items()}))

    def omap_rmkeys(self, keys) -> None:
        self.mutations.append(("omap_rmkeys", list(keys)))

    def omap_clear(self) -> None:
        self.mutations.append(("omap_clear",))

    def omap_set_header(self, data: bytes) -> None:
        self.mutations.append(("omap_setheader", bytes(data)))


class ClassHandler:
    """Singleton method registry (ref: src/osd/ClassHandler.cc —
    open_class/dlopen replaced by lazy import of built-in modules)."""

    _BUILTIN = ("lock", "refcount", "version", "rgw", "queue", "log",
                "numops")

    def __init__(self):
        self._methods: dict[tuple[str, str], tuple[int, Callable]] = {}
        self._loaded: set[str] = set()

    def register(self, cls: str, method: str, flags: int,
                 fn: Callable) -> None:
        self._methods[(cls, method)] = (flags, fn)

    def _load(self, cls: str) -> None:
        if cls in self._loaded:
            return
        if cls in self._BUILTIN:
            import importlib
            importlib.import_module(f".{cls}", __package__)
        self._loaded.add(cls)

    def resolve(self, cls: str, method: str) -> tuple[int, Callable]:
        """-> (flags, fn); raises ClsError(EOPNOTSUPP) like the
        reference's -EOPNOTSUPP for an unknown class/method
        (PrimaryLogPG CEPH_OSD_OP_CALL)."""
        self._load(cls)
        entry = self._methods.get((cls, method))
        if entry is None:
            raise ClsError("EOPNOTSUPP", f"{cls}.{method}")
        return entry


class_handler = ClassHandler()


def cls_method(cls: str, method: str, flags: int = CLS_METHOD_RD):
    """Decorator used by class modules to register a method
    (ref: cls_register_cxx_method)."""
    def wrap(fn):
        class_handler.register(cls, method, flags, fn)
        return fn
    return wrap
