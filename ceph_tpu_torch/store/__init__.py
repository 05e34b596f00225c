"""Object storage engine layer (ref: src/os/).

`ObjectStore` is the abstract transactional API (ObjectStore.h:66);
`MemStore` is the in-memory implementation the EC shards and the tests
run on (model: src/os/memstore/MemStore.cc).  The port's copy of
`ceph_tpu.store`, so far without the block-file and journaled engines.
"""
from .objectstore import ObjectStore, Transaction, ObjectId, StoreError
from .memstore import MemStore

__all__ = ["ObjectStore", "Transaction", "ObjectId", "StoreError",
           "MemStore"]
