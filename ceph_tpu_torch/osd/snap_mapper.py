"""SnapMapper: the persistent snap -> clone index + purged_snaps cursor.

The snaptrim subsystem's durable state (ref: src/osd/SnapMapper.h —
the MAPPING_PREFIX snap->object keys the trimmer walks, written in the
SAME transaction as the clone it indexes; src/osd/osd_types.h
pg_info_t::purged_snaps).  Both live in the pgmeta object's omap next
to the durable pg log, so:

* creating a clone and indexing it is ONE store transaction — a crash
  can never leave an unindexed clone (space leak) or an index entry
  with no clone (phantom trim work);
* trimming a clone and unindexing it is ONE transaction — the index
  IS the fine-grained resume cursor: a primary killed mid-trim leaves
  exactly the untrimmed entries behind, and the promoted primary's
  walk resumes from them with no re-deletes;
* `purged_snaps` records fully-trimmed snapids as a durable interval
  set on EVERY acting shard, so `removed_snaps - purged_snaps` is the
  outstanding trim work no matter which shard becomes primary.

Key layout (fixed-width prefixes make parsing unambiguous even for
object names containing the separator):

    sm.{snap:012d}.{clone:012d}.{oid}  -> wire-encoded covers list
    ps                                 -> wire-encoded [[lo, hi], ...]

The port's copy of `ceph_tpu.osd.snap_mapper`.  `ReplicatedPGShard`
builds one per PG and writes through it when a clone is made or pushed;
the snap trimmer that walks it waits for the slice that ports
snapshots.  One rule differs: a `ps` cursor that fails to decode still
reads as empty, as in the reference, and is also counted in
`PURGED_DECODE_ERRORS["count"]`.
"""
from __future__ import annotations

from ..store import ObjectId, StoreError, Transaction

PGMETA = ObjectId("pgmeta")

_SNAP_PREFIX = "sm."
_PURGED_KEY = "ps"

#: purged cursors that failed to decode and were read as empty
PURGED_DECODE_ERRORS = {"count": 0}


def _key(snap: int, clone: int, oid: str) -> str:
    return f"{_SNAP_PREFIX}{snap:012d}.{clone:012d}.{oid}"


def _parse_key(key: str):
    """(snap, clone, oid) from an index key, or None."""
    if not key.startswith(_SNAP_PREFIX):
        return None
    body = key[len(_SNAP_PREFIX):]
    try:
        snap = int(body[:12])
        clone = int(body[13:25])
    except ValueError:
        return None
    return snap, clone, body[26:]


class IntervalSet:
    """Sorted, coalesced closed intervals over snapids (ref:
    src/include/interval_set.h — purged_snaps' representation)."""

    def __init__(self, intervals=None):
        self._iv: list[list[int]] = [list(p) for p in (intervals or [])]

    def contains(self, snap: int) -> bool:
        return any(lo <= snap <= hi for lo, hi in self._iv)

    __contains__ = contains

    def add(self, snap: int) -> None:
        if self.contains(snap):
            return
        self._iv.append([snap, snap])
        self._iv.sort()
        merged: list[list[int]] = []
        for lo, hi in self._iv:
            if merged and lo <= merged[-1][1] + 1:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        self._iv = merged

    def to_list(self) -> list:
        return [list(p) for p in self._iv]

    def __repr__(self) -> str:
        return "IntervalSet(%s)" % (
            ",".join(f"[{lo},{hi}]" for lo, hi in self._iv) or "empty")


class SnapMapper:
    """Stateless view over one PG collection's snap index — every read
    goes to the store, every write rides a caller-supplied transaction,
    so transient shard views, restarted daemons and promoted primaries
    all see the same truth with no cache to invalidate."""

    def __init__(self, store, cid: str):
        self.store = store
        self.cid = cid

    # ------------------------------------------------------- raw omap
    def _omap(self) -> dict:
        if not self.store.collection_exists(self.cid) or \
                not self.store.exists(self.cid, PGMETA):
            return {}
        return self.store.omap_get(self.cid, PGMETA)

    # -------------------------------------------------------- index IO
    def add_clone(self, txn: Transaction, oid: str, clone: int,
                  covers: list[int]) -> None:
        """Index a freshly-made clone under every snapid it serves —
        called inside the COW transaction (ref: SnapMapper::add_oid
        riding the repop txn)."""
        from ..msg import encoding as wire
        if not covers:
            return
        txn.touch(self.cid, PGMETA)
        txn.omap_setkeys(self.cid, PGMETA,
                         {_key(s, clone, oid): wire.encode(list(covers))
                          for s in covers})

    def rm(self, txn: Transaction, snap: int, oid: str,
           clone: int) -> None:
        """Drop one (snap, clone) index entry inside `txn`."""
        txn.touch(self.cid, PGMETA)
        txn.omap_rmkeys(self.cid, PGMETA, [_key(snap, clone, oid)])

    def rm_clone(self, txn: Transaction, oid: str, clone: int,
                 covers: list[int]) -> None:
        """Drop every index entry of a clone being deleted (its
        covered snapids are known from the head's clones map)."""
        txn.touch(self.cid, PGMETA)
        txn.omap_rmkeys(self.cid, PGMETA,
                        [_key(s, clone, oid) for s in covers])

    def replace_object(self, txn: Transaction, oid: str,
                       clones: dict[int, list[int]]) -> None:
        """Wholesale re-index of one object (recovery push adopted an
        authoritative clone set): stale entries out, pushed set in."""
        from ..msg import encoding as wire
        stale = [k for k in self._omap()
                 if (p := _parse_key(k)) is not None and p[2] == oid]
        txn.touch(self.cid, PGMETA)
        if stale:
            txn.omap_rmkeys(self.cid, PGMETA, stale)
        sets = {}
        for clone, covers in clones.items():
            for s in covers:
                sets[_key(int(s), int(clone), oid)] = \
                    wire.encode([int(c) for c in covers])
        if sets:
            txn.omap_setkeys(self.cid, PGMETA, sets)

    # ------------------------------------------------------- index read
    def objects_for_snap(self, snap: int) -> list[tuple[str, int]]:
        """[(oid, clone)] still indexed under `snap` — the trim
        work-list AND the resume cursor (trimmed entries are gone)."""
        out = []
        prefix = f"{_SNAP_PREFIX}{snap:012d}."
        for k in sorted(self._omap()):
            if k.startswith(prefix):
                p = _parse_key(k)
                if p is not None:
                    out.append((p[2], p[1]))
        return out

    def dump(self) -> list[dict]:
        """Whole index for offline debugging (objectstore_tool
        dump-snap-index)."""
        from ..msg import encoding as wire
        out = []
        for k, v in sorted(self._omap().items()):
            p = _parse_key(k)
            if p is None:
                continue
            try:
                covers = wire.decode(v)
            except (wire.WireError, IndexError):
                covers = None   # undecodable entry shows as unknown;
                # anything else (a programming error) propagates
            out.append({"snap": p[0], "clone": p[1], "oid": p[2],
                        "covers": covers})
        return out

    def split_keys(self, txn: Transaction,
                   moved_to: dict[str, str]) -> None:
        """PG split: move index entries (and copy the purged cursor)
        along with the objects that re-homed to child collections —
        the snap-index leg of PG::split_into."""
        omap = self._omap()
        by_child: dict[str, dict] = {}
        gone: list[str] = []
        for k, v in omap.items():
            p = _parse_key(k)
            if p is None or p[2] not in moved_to:
                continue
            gone.append(k)
            by_child.setdefault(moved_to[p[2]], {})[k] = v
        if gone:
            txn.omap_rmkeys(self.cid, PGMETA, gone)
        purged = omap.get(_PURGED_KEY)
        targets = set(by_child) | (set(moved_to.values())
                                   if purged is not None else set())
        for ccid in targets:
            txn.touch(ccid, PGMETA)
            sets = dict(by_child.get(ccid, {}))
            if purged is not None:
                sets[_PURGED_KEY] = purged
            txn.omap_setkeys(ccid, PGMETA, sets)

    # ---------------------------------------------------- purged cursor
    def purged_snaps(self) -> IntervalSet:
        from ..msg import encoding as wire
        raw = self._omap().get(_PURGED_KEY)
        if raw is None:
            return IntervalSet()
        try:
            return IntervalSet(wire.decode(raw))
        except Exception:
            PURGED_DECODE_ERRORS["count"] += 1
            return IntervalSet()

    def mark_purged(self, snap: int) -> None:
        self.mark_purged_many([snap])

    def mark_purged_many(self, snaps) -> None:
        """Record fully-trimmed snapids durably — one read + one
        write for the whole batch, skipped when nothing is new (by
        the time this runs every clone of these snaps is already
        gone, so the mark only ever says something true)."""
        from ..msg import encoding as wire
        if not snaps or not self.store.collection_exists(self.cid):
            return
        ps = self.purged_snaps()
        changed = False
        for snap in snaps:
            if int(snap) not in ps:
                ps.add(int(snap))
                changed = True
        if not changed:
            return
        txn = Transaction()
        txn.touch(self.cid, PGMETA)
        txn.omap_setkeys(self.cid, PGMETA,
                         {_PURGED_KEY: wire.encode(ps.to_list())})
        self.store.queue_transaction(txn)


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
