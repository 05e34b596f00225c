"""PG-level value types: versions, log entries, missing set, shards.

Modeled on the reference's osd_types (ref: src/osd/osd_types.h —
eversion_t, pg_log_entry_t, pg_missing_t, pg_shard_t), trimmed to what
the data path consumes.

The port's copy of `ceph_tpu.osd.pg_types`; the four structs register
under the reference's wire names, versions and field order.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True, order=True)
class EVersion:
    """(epoch, version) — totally ordered (ref: osd_types.h eversion_t)."""
    epoch: int = 0
    version: int = 0

    def __bool__(self) -> bool:
        return self != ZERO_VERSION

    def __str__(self) -> str:
        return f"{self.epoch}'{self.version}"


ZERO_VERSION = EVersion(0, 0)


@dataclass(frozen=True, order=True)
class PGShard:
    """Which OSD holds which EC shard (ref: osd_types.h pg_shard_t)."""
    osd: int
    shard: int = -1     # NO_SHARD for replicated

    def __str__(self) -> str:
        return f"osd.{self.osd}" + \
            (f"(s{self.shard})" if self.shard != -1 else "")


# log entry op kinds (ref: osd_types.h pg_log_entry_t::{MODIFY,...})
MODIFY = "modify"
DELETE = "delete"
CLONE = "clone"
ERROR = "error"
LOST_REVERT = "lost_revert"


@dataclass
class PGLogEntry:
    """One log record (ref: osd_types.h pg_log_entry_t)."""
    op: str
    soid: str
    version: EVersion
    prior_version: EVersion = ZERO_VERSION
    reqid: str = ""
    #: rollback info present (the reference attaches per-op rollback
    #: blobs via can_rollback(); here a flag + optional payload)
    rollbackable: bool = False

    def is_update(self) -> bool:
        return self.op in (MODIFY, CLONE, LOST_REVERT)

    def is_delete(self) -> bool:
        return self.op == DELETE

    def is_error(self) -> bool:
        return self.op == ERROR

    def is_clone(self) -> bool:
        return self.op == CLONE

    def can_rollback(self) -> bool:
        return self.rollbackable

    def __str__(self) -> str:
        return f"{self.version}({self.prior_version}) {self.op} {self.soid}"


@dataclass
class MissingItem:
    """(ref: osd_types.h pg_missing_item)."""
    need: EVersion
    have: EVersion = ZERO_VERSION
    is_delete: bool = False


class PGMissing:
    """Objects a shard lacks, by version (ref: src/osd/osd_types.h
    pg_missing_t / pg_missing_set; add_next_event semantics from
    osd_types.h pg_missing_set::add_next_event)."""

    def __init__(self, may_include_deletes: bool = True):
        self.items: dict[str, MissingItem] = {}
        self.may_include_deletes = may_include_deletes

    def is_missing(self, soid: str,
                   need: Optional[EVersion] = None) -> bool:
        item = self.items.get(soid)
        if item is None:
            return False
        return need is None or item.need == need

    def num_missing(self) -> int:
        return len(self.items)

    def add(self, soid: str, need: EVersion,
            have: EVersion = ZERO_VERSION,
            is_delete: bool = False) -> None:
        self.items[soid] = MissingItem(need, have, is_delete)

    def rm(self, soid: str) -> None:
        self.items.pop(soid, None)

    def revise_need(self, soid: str, need: EVersion,
                    is_delete: bool = False) -> None:
        item = self.items.get(soid)
        if item is None:
            self.items[soid] = MissingItem(need, ZERO_VERSION, is_delete)
        else:
            self.items[soid] = replace(item, need=need,
                                       is_delete=is_delete)

    def revise_have(self, soid: str, have: EVersion) -> None:
        item = self.items.get(soid)
        if item is not None:
            self.items[soid] = replace(item, have=have)

    def add_next_event(self, e: PGLogEntry) -> None:
        """Track a newly-learned log event (ref: osd_types.h
        pg_missing_set::add_next_event)."""
        if e.is_error():
            return
        existing = self.items.get(e.soid)
        if e.is_delete() and not self.may_include_deletes:
            self.rm(e.soid)
            return
        if existing is not None:
            # already missing an older version; still need the newest
            self.items[e.soid] = replace(
                existing, need=e.version, is_delete=e.is_delete())
        else:
            self.items[e.soid] = MissingItem(
                need=e.version, have=e.prior_version,
                is_delete=e.is_delete())

    def got(self, soid: str, version: EVersion) -> None:
        item = self.items.get(soid)
        if item is not None and item.need <= version:
            self.rm(soid)

    def __repr__(self) -> str:
        return f"PGMissing({self.items})"


# wire registration (ref: osd_types.h eversion_t/pg_log_entry_t/
# pg_missing_item each carry ENCODE_START versions)
from ..msg.encoding import register_struct as _reg  # noqa: E402

for _cls in (EVersion, PGShard, PGLogEntry, MissingItem):
    _reg(_cls, version=1, compat=1)
