"""The durable PG log's layout in the pgmeta omap, shared by the
replicated and EC shards (ref: src/osd/PGLog.cc write_log_and_missing).

The port's copy of the helpers of `ceph_tpu.osd.replicated_backend` that
`ECPGShard` uses, so the pgmeta omap holds the same keys and bytes in
both packages.  The replicated backend itself is not ported yet.
"""
from __future__ import annotations

from ..store import ObjectId, Transaction

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
