"""Object storage engine layer (ref: src/os/).

`ObjectStore` is the abstract transactional API (ObjectStore.h:66);
`MemStore` is the in-memory implementation the EC shards and the tests
run on (model: src/os/memstore/MemStore.cc); `BlueStore` is the
block-file engine with KV metadata, at-rest checksums, deferred writes
and compress-on-write (model: src/os/bluestore/) — the durable default
for one-process-per-daemon deployments; `JournaledStore` is the legacy
FileStore-shaped WAL+snapshot engine it retires.  The port's copy of
`ceph_tpu.store`, whole.
"""
from .objectstore import ObjectId, ObjectStore, StoreError, Transaction
from .memstore import MemStore
from .journaled import JournaledStore
from .bluestore import BlueStore

__all__ = ["ObjectStore", "Transaction", "ObjectId", "StoreError",
           "MemStore", "JournaledStore", "BlueStore"]
