"""ObjectStore: the transactional storage API the OSD data path sits on.

Abstract surface modeled on the reference's `ObjectStore` class
(ref: src/os/ObjectStore.h:66): collections order transactions; a
`Transaction` is an ordered op list applied atomically by
`queue_transaction`; reads (`read`/`stat`/`getattr`/`omap_get`) are
synchronous.  Op coverage follows Transaction's builder surface
(ObjectStore.h:998-1306: touch/write/zero/truncate/remove/setattr(s)/
rmattr(s)/clone/clone_range/create_collection/remove_collection/
collection_move_rename/omap_*).

This layer stays on the host: chunk payloads are bytes handed straight
to and from the EC path, never copied through an intermediate
"bufferlist" abstraction.

The port's copy of `ceph_tpu.store.objectstore`; `ObjectId` and
`Transaction` are wire structs under the reference's names.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping


@dataclass(frozen=True, order=True)
class ObjectId:
    """ghobject_t-lite: object name + shard id for EC per-shard clones
    (ref: src/common/hobject.h ghobject_t; shard_id marks which EC
    shard's chunk stream this object holds)."""
    name: str
    snap: int = -2            # CEPH_NOSNAP analogue: head object
    shard: int = -1           # NO_SHARD analogue

    def __str__(self) -> str:
        s = self.name
        if self.snap != -2:
            s += f"@{self.snap}"
        if self.shard != -1:
            s += f"(s{self.shard})"
        return s


class StoreError(Exception):
    def __init__(self, errno_name: str, msg: str = ""):
        self.errno_name = errno_name
        super().__init__(f"{errno_name}: {msg}" if msg else errno_name)


# Transaction op codes (ref: ObjectStore.h Transaction::Op enum)
OP_TOUCH = "touch"
OP_WRITE = "write"
OP_ZERO = "zero"
OP_TRUNCATE = "truncate"
OP_REMOVE = "remove"
OP_SETATTRS = "setattrs"
OP_RMATTR = "rmattr"
OP_RMATTRS = "rmattrs"
OP_CLONE = "clone"
OP_CLONE_RANGE = "clone_range"
OP_MKCOLL = "create_collection"
OP_RMCOLL = "remove_collection"
OP_COLL_MOVE_RENAME = "collection_move_rename"
OP_OMAP_CLEAR = "omap_clear"
OP_OMAP_SETKEYS = "omap_setkeys"
OP_OMAP_RMKEYS = "omap_rmkeys"


@dataclass
class Transaction:
    """Ordered op list applied atomically (ref: ObjectStore.h:850
    "Transactions are apply sequentially; a collection orders them")."""
    ops: list[tuple] = field(default_factory=list)

    # -- builder surface ------------------------------------------------
    def touch(self, cid: str, oid: ObjectId) -> "Transaction":
        self.ops.append((OP_TOUCH, cid, oid))
        return self

    def write(self, cid: str, oid: ObjectId, off: int,
              data: bytes) -> "Transaction":
        self.ops.append((OP_WRITE, cid, oid, off, bytes(data)))
        return self

    def zero(self, cid: str, oid: ObjectId, off: int,
             length: int) -> "Transaction":
        self.ops.append((OP_ZERO, cid, oid, off, length))
        return self

    def truncate(self, cid: str, oid: ObjectId, size: int) -> "Transaction":
        self.ops.append((OP_TRUNCATE, cid, oid, size))
        return self

    def remove(self, cid: str, oid: ObjectId) -> "Transaction":
        self.ops.append((OP_REMOVE, cid, oid))
        return self

    def setattr(self, cid: str, oid: ObjectId, name: str,
                value) -> "Transaction":
        return self.setattrs(cid, oid, {name: value})

    def setattrs(self, cid: str, oid: ObjectId,
                 attrs: Mapping[str, Any]) -> "Transaction":
        self.ops.append((OP_SETATTRS, cid, oid, dict(attrs)))
        return self

    def rmattr(self, cid: str, oid: ObjectId, name: str) -> "Transaction":
        self.ops.append((OP_RMATTR, cid, oid, name))
        return self

    def rmattrs(self, cid: str, oid: ObjectId) -> "Transaction":
        self.ops.append((OP_RMATTRS, cid, oid))
        return self

    def clone(self, cid: str, oid: ObjectId,
              noid: ObjectId) -> "Transaction":
        self.ops.append((OP_CLONE, cid, oid, noid))
        return self

    def clone_range(self, cid: str, oid: ObjectId, noid: ObjectId,
                    srcoff: int, length: int, dstoff: int) -> "Transaction":
        self.ops.append(
            (OP_CLONE_RANGE, cid, oid, noid, srcoff, length, dstoff))
        return self

    def create_collection(self, cid: str, bits: int = 0) -> "Transaction":
        self.ops.append((OP_MKCOLL, cid, bits))
        return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append((OP_RMCOLL, cid))
        return self

    def collection_move_rename(self, oldcid: str, oldoid: ObjectId,
                               cid: str, oid: ObjectId) -> "Transaction":
        self.ops.append((OP_COLL_MOVE_RENAME, oldcid, oldoid, cid, oid))
        return self

    def omap_clear(self, cid: str, oid: ObjectId) -> "Transaction":
        self.ops.append((OP_OMAP_CLEAR, cid, oid))
        return self

    def omap_setkeys(self, cid: str, oid: ObjectId,
                     keys: Mapping[str, bytes]) -> "Transaction":
        self.ops.append((OP_OMAP_SETKEYS, cid, oid, dict(keys)))
        return self

    def omap_rmkeys(self, cid: str, oid: ObjectId,
                    keys: Iterable[str]) -> "Transaction":
        self.ops.append((OP_OMAP_RMKEYS, cid, oid, list(keys)))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    def empty(self) -> bool:
        return not self.ops

    def __len__(self) -> int:
        return len(self.ops)


class ObjectStore(abc.ABC):
    """Abstract store (ref: ObjectStore.h:66).  Writes go through
    transactions; reads are direct."""

    @abc.abstractmethod
    def mount(self) -> None: ...

    @abc.abstractmethod
    def umount(self) -> None: ...

    @abc.abstractmethod
    def mkfs(self) -> None: ...

    @abc.abstractmethod
    def queue_transaction(self, txn: Transaction) -> None:
        """Apply atomically; raises StoreError and leaves no partial
        effects on failure."""

    # -- read side ------------------------------------------------------
    @abc.abstractmethod
    def read(self, cid: str, oid: ObjectId, off: int = 0,
             length: int = 0) -> bytes:
        """length=0 means to the end of the object."""

    @abc.abstractmethod
    def stat(self, cid: str, oid: ObjectId) -> dict: ...

    @abc.abstractmethod
    def exists(self, cid: str, oid: ObjectId) -> bool: ...

    @abc.abstractmethod
    def getattr(self, cid: str, oid: ObjectId, name: str): ...

    @abc.abstractmethod
    def getattrs(self, cid: str, oid: ObjectId) -> dict: ...

    @abc.abstractmethod
    def omap_get(self, cid: str, oid: ObjectId) -> dict[str, bytes]: ...

    @abc.abstractmethod
    def list_collections(self) -> list[str]: ...

    @abc.abstractmethod
    def collection_exists(self, cid: str) -> bool: ...

    @abc.abstractmethod
    def collection_list(self, cid: str) -> list[ObjectId]: ...

    @abc.abstractmethod
    def statfs(self) -> dict: ...


# wire registration: transactions ride ECSubWrite frames between
# shards (ref: ObjectStore::Transaction::encode, MOSDECSubOpWrite)
from ..msg.encoding import register_struct as _reg  # noqa: E402

_reg(ObjectId, version=1, compat=1)
_reg(Transaction, version=1, compat=1)
