"""Store accounting of a PG collection.

The port's copy of `collection_bytes` from `ceph_tpu.osd.snap_mapper`,
the one piece of it the EC shard's stats read; the snap mapper itself
is not ported yet.
"""
from __future__ import annotations

from ..store import StoreError


def collection_bytes(store, cid: str) -> int:
    """Physical bytes stored in one PG collection — heads, snap clones
    and EC shard streams alike (the store-accounting feed behind the
    leak-vs-reclaim gauges)."""
    if not store.collection_exists(cid):
        return 0
    total = 0
    for o in store.collection_list(cid):
        try:
            total += store.stat(cid, o)["size"]
        except StoreError:
            pass
    return total
