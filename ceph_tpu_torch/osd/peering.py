"""PG peering: the phase names and helpers both statecharts share.

The reference's peering phase machine (ref: src/osd/PG.h:2085-2195 —
the boost::statechart with GetInfo / GetLog / GetMissing / Activating
/ Active{Recovering, Backfilling, Clean}; driven from
src/osd/PeeringState.cc) runs as an explicit phase object owned by the
primary's PG state.  EC pools run it in `ec_peering.py` (ECPGPeering).

The port's copy of `ceph_tpu.osd.peering` in part: the phase names,
`_RETRY_TICKS`, `_ev` and `StoreRollbacker`, which `ec_peering.py` and
the daemon import.  `PGPeering`, the replicated pools' statechart, waits
for the slice that ports replicated pools.
"""
from __future__ import annotations

from .pg_log import LogEntryHandler
from .pg_types import EVersion, ZERO_VERSION

# phases (ref: the statechart's state names)
GETINFO = "getinfo"
GETLOG = "getlog"
GETMISSING = "getmissing"
RECOVERING = "recovering"
WAIT_BACKFILL = "wait_backfill"
BACKFILLING = "backfilling"
CLEAN = "clean"

#: heartbeat ticks a phase may sit without progress before its
#: outstanding messages are re-driven (lost-message recovery)
_RETRY_TICKS = 3


def _ev(v) -> EVersion:
    if v is None:
        return ZERO_VERSION
    if isinstance(v, EVersion):
        return v
    return EVersion(*v)


class StoreRollbacker(LogEntryHandler):
    """Divergence side-effects on the local store: an entry that can't
    roll back removes the object (it re-arrives through recovery at
    the authoritative version; ref: PGLog::LogEntryHandler ->
    PrimaryLogPG::remove_missing_object)."""

    def __init__(self, shard):
        self.shard = shard

    def remove(self, soid: str) -> None:
        from ..store import StoreError
        try:
            self.shard.apply_write(soid, 0, b"", True, None, [])
        except StoreError:
            pass

    def rollback(self, entry) -> None:
        # rollback blobs are not recorded (entries carry
        # rollbackable=False), so statechart case 4 never fires;
        # remove-and-repull is the conservative resolution
        self.remove(entry.soid)
