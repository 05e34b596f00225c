"""PGLog: per-shard write-ahead log + divergence merge.

The log-based consistency core of recovery (ref: src/osd/PGLog.{h,cc}):
an ordered entry list with an object index, a missing set derived from
it, `merge_log` to adopt an authoritative log, and the five-case
divergent-entry resolution of `_merge_object_divergent_entries`
(PGLog.h:864-1087).  The TestPGLog corner cases are the spec
(src/test/osd/TestPGLog.cc); tests/test_pg_log.py ports them, and
tests/test_torch_pg_log.py holds this copy to the reference's on each.

The port's copy of `ceph_tpu.osd.pg_log`.
"""
from __future__ import annotations

from typing import Iterable, Optional

from ..common.log import dout
from .pg_types import EVersion, PGLogEntry, PGMissing, ZERO_VERSION


class LogEntryHandler:
    """Side-effect hooks for divergence resolution
    (ref: PGLog.h LogEntryHandler: remove/rollback/trim)."""

    def remove(self, soid: str) -> None:
        pass

    def rollback(self, entry: PGLogEntry) -> None:
        pass

    def trim(self, entry: PGLogEntry) -> None:
        pass


class IndexedLog:
    """Entry list + per-object last-entry index
    (ref: PGLog.h IndexedLog)."""

    def __init__(self, entries: Iterable[PGLogEntry] = (),
                 head: EVersion = ZERO_VERSION,
                 tail: EVersion = ZERO_VERSION,
                 can_rollback_to: EVersion = ZERO_VERSION):
        self.entries: list[PGLogEntry] = list(entries)
        self.head = head if head != ZERO_VERSION or not self.entries \
            else self.entries[-1].version
        self.tail = tail
        self.can_rollback_to = can_rollback_to
        self.objects: dict[str, PGLogEntry] = {}
        self.index()

    def index(self) -> None:
        self.objects = {}
        for e in self.entries:
            if not e.is_error():
                self.objects[e.soid] = e

    def add(self, e: PGLogEntry) -> None:
        assert e.version > self.head, (e.version, self.head)
        self.entries.append(e)
        self.head = e.version
        if not e.is_error():
            self.objects[e.soid] = e

    def trim_to(self, v: EVersion) -> list[PGLogEntry]:
        """Drop entries with version <= v (ref: PGLog.cc trim)."""
        kept, dropped = [], []
        for e in self.entries:
            (dropped if e.version <= v else kept).append(e)
        self.entries = kept
        if v > self.tail:
            self.tail = v
        self.index()
        return dropped

    def entries_for(self, soid: str) -> list[PGLogEntry]:
        return [e for e in self.entries if e.soid == soid]

    def __len__(self) -> int:
        return len(self.entries)


class PGLog:
    """The merge/rewind engine around an IndexedLog + PGMissing."""

    def __init__(self, log: Optional[IndexedLog] = None,
                 missing: Optional[PGMissing] = None):
        self.log = log if log is not None else IndexedLog()
        self.missing = missing if missing is not None else PGMissing()

    # -- local append (the write path) ---------------------------------
    def append(self, e: PGLogEntry) -> None:
        self.log.add(e)

    # -- divergence core (ref: PGLog.h:864) ----------------------------
    @staticmethod
    def _merge_object_divergent_entries(
            log: IndexedLog, soid: str,
            orig_entries: list[PGLogEntry],
            original_can_rollback_to: EVersion,
            missing: PGMissing,
            rollbacker: Optional[LogEntryHandler] = None) -> None:
        # strip ERROR entries (they are never authoritative)
        entries = [e for e in orig_entries if not e.is_error()]
        if not entries:
            return
        prior_version = entries[0].prior_version
        first_divergent_update = entries[0].version
        last_divergent_update = entries[-1].version
        object_not_in_store = (not missing.is_missing(soid)
                               and entries[-1].is_delete())

        objiter = log.objects.get(soid)
        if objiter is not None and objiter.version >= first_divergent_update:
            # Case 1: a more recent entry in the authoritative log
            # already covers this object — the merge of that entry
            # handled missing; just forget any stale 'have'
            assert objiter.version > last_divergent_update
            missing.revise_have(soid, ZERO_VERSION)
            if rollbacker:
                if not object_not_in_store:
                    rollbacker.remove(soid)
                for e in entries:
                    rollbacker.trim(e)
            return

        if prior_version == ZERO_VERSION or entries[0].is_clone():
            # Case 2: the divergent entries created the object —
            # it should not exist
            if missing.is_missing(soid):
                missing.rm(soid)
            if rollbacker:
                if not object_not_in_store:
                    rollbacker.remove(soid)
                for e in entries:
                    rollbacker.trim(e)
            return

        if missing.is_missing(soid):
            # Case 3: already missing — adjust need to prior_version
            item = missing.items[soid]
            if item.have == prior_version:
                missing.rm(soid)
            else:
                missing.revise_need(soid, prior_version)
            if rollbacker:
                for e in entries:
                    rollbacker.trim(e)
            return

        # distinguish 4 (rollbackable) from 5
        can_rollback = all(
            e.can_rollback() and e.version > original_can_rollback_to
            for e in entries)
        if can_rollback:
            # Case 4: undo in reverse order
            if rollbacker:
                for e in reversed(entries):
                    rollbacker.rollback(e)
            return
        # Case 5: cannot roll back — remove and mark missing at
        # prior_version
        if rollbacker:
            if not object_not_in_store:
                rollbacker.remove(soid)
            for e in entries:
                rollbacker.trim(e)
        missing.add(soid, prior_version, ZERO_VERSION, False)

    @classmethod
    def _merge_divergent_entries(
            cls, log: IndexedLog, entries: list[PGLogEntry],
            original_can_rollback_to: EVersion,
            missing: PGMissing,
            rollbacker: Optional[LogEntryHandler] = None) -> None:
        by_object: dict[str, list[PGLogEntry]] = {}
        for e in entries:
            by_object.setdefault(e.soid, []).append(e)
        for soid, lst in by_object.items():
            cls._merge_object_divergent_entries(
                log, soid, lst, original_can_rollback_to, missing,
                rollbacker)

    # -- rewind (ref: PGLog.cc rewind_divergent_log) -------------------
    def rewind_divergent_log(
            self, newhead: EVersion,
            rollbacker: Optional[LogEntryHandler] = None) -> None:
        assert newhead >= self.log.tail
        divergent = [e for e in self.log.entries if e.version > newhead]
        self.log.entries = [e for e in self.log.entries
                            if e.version <= newhead]
        self.log.head = newhead
        original_crt = self.log.can_rollback_to
        if self.log.can_rollback_to > newhead:
            self.log.can_rollback_to = newhead
        self.log.index()
        self._merge_divergent_entries(
            self.log, divergent, original_crt, self.missing, rollbacker)

    # -- merge (ref: PGLog.cc:358 merge_log) ---------------------------
    def merge_log(self, olog: IndexedLog,
                  rollbacker: Optional[LogEntryHandler] = None) -> bool:
        """Adopt the authoritative log `olog`.  Returns True if our log
        changed.  Requires overlap: log.head >= olog.tail and
        olog.head >= log.tail (else backfill, not log recovery)."""
        if not (self.log.head >= olog.tail
                and olog.head >= self.log.tail):
            raise ValueError(
                f"no log overlap: ours [{self.log.tail},{self.log.head}]"
                f" theirs [{olog.tail},{olog.head}] (needs backfill)")
        changed = False
        orig_tail = self.log.tail

        # extend tail backwards — pure history, missing unaffected
        if olog.tail < self.log.tail:
            older = [e for e in olog.entries if e.version <= self.log.tail]
            self.log.entries = older + self.log.entries
            self.log.tail = olog.tail
            self.log.index()
            changed = True

        if olog.head < self.log.head:
            # authoritative log is shorter: everything past its head
            # is divergent
            self.rewind_divergent_log(olog.head, rollbacker)
            changed = True
        elif olog.head > self.log.head:
            # find the cut point: the last entry the two logs share
            # (ref: PGLog.cc "merge_log cut point (usually last
            # shared)").  Entries of ours past it are divergent even
            # though olog.head is ahead of ours.
            lower_bound = max(olog.tail, orig_tail)
            for e in olog.entries:
                if e.version <= self.log.head:
                    lower_bound = max(lower_bound, e.version)
            original_crt = self.log.can_rollback_to
            divergent = [e for e in self.log.entries
                         if e.version > lower_bound]
            self.log.entries = [e for e in self.log.entries
                                if e.version <= lower_bound]
            self.log.head = lower_bound
            self.log.index()
            # adopt the authoritative entries first (so Case 1 of the
            # divergent merge sees them), updating missing
            new_entries = [e for e in olog.entries
                           if e.version > lower_bound]
            for e in new_entries:
                self.log.add(e)
                self.missing.add_next_event(e)
                if rollbacker and e.is_delete():
                    rollbacker.remove(e.soid)
            self._merge_divergent_entries(
                self.log, divergent, original_crt, self.missing,
                rollbacker)
            self.log.head = olog.head
            # cannot roll back into freshly adopted entries
            self.log.can_rollback_to = self.log.head
            dout("pg", 10).write(
                "merge_log: cut %s, +%d new, %d divergent",
                lower_bound, len(new_entries), len(divergent))
            changed = True
        return changed

    # -- recovery bookkeeping ------------------------------------------
    def recover_got(self, soid: str, version: EVersion) -> None:
        self.missing.got(soid, version)
