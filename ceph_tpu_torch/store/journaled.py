"""JournaledStore: MemStore + an on-disk write-ahead journal.

The FileStore+FileJournal shape (ref: src/os/filestore/FileJournal.cc —
every transaction appended to a journal before ack; src/os/filestore/
FileStore.cc mount replay): the working set lives in memory like
MemStore, every committed transaction is framed (length + crc32c + the typed
wire codec) and fsync'd to `<dir>/journal.wal`, and mount() restores the
last snapshot then replays the journal.  umount() (or `compact()`)
rewrites a snapshot and truncates the journal, bounding replay time.

This is what makes one-process-per-daemon deployments durable: an OSD
process can be killed -9 and restarted on the same --data-dir with its
PG collections intact.

The port's copy of `ceph_tpu.store.journaled`, whole: the snapshot and
the journal frames are the reference's byte for byte, and a store
either package wrote mounts in the other
(`daemon_main osd --data-dir DIR --objectstore journaled`).
"""
from __future__ import annotations

import os
import struct

from ..common.crc32c import crc32c
from ..common.log import dout
from ..msg import encoding as wire
from .memstore import MemStore
from .objectstore import Transaction

_HDR = struct.Struct("<II")      # length, crc32c


class JournaledStore(MemStore):
    SNAPSHOT = "snapshot.bin"
    JOURNAL = "journal.wal"

    def __init__(self, path: str):
        super().__init__(path)
        self._wal = None
        self._seq = 0          # txns applied since mkfs (replay skip)

    # -- paths -----------------------------------------------------------
    @property
    def _snap_path(self) -> str:
        return os.path.join(self.path, self.SNAPSHOT)

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.path, self.JOURNAL)

    # -- lifecycle -------------------------------------------------------
    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        super().mkfs()
        self._seq = 0
        with open(self._snap_path, "wb") as f:
            f.write(wire.encode((self.colls, self._seq)))
        open(self._wal_path, "wb").close()

    def mount(self) -> None:
        """Restore snapshot + replay the journal
        (ref: FileStore::mount -> journal replay)."""
        legacy = os.path.join(self.path, "snapshot.pkl")
        if not os.path.exists(self._snap_path) and \
                os.path.exists(legacy):
            # a pre-typed-codec store: refuse rather than silently
            # mkfs-wipe it (and deliberately never load pickle)
            from .objectstore import StoreError
            raise StoreError(
                "EINVAL",
                f"{self.path}: legacy pickle-format JournaledStore — "
                "migrate by re-importing its PGs (objectstore-tool) "
                "or recover from replicas")
        if not os.path.exists(self._snap_path):
            self.mkfs()
        with open(self._snap_path, "rb") as f:
            self.colls, self._seq = wire.decode(f.read())
        # the codec returns immutable bytes; object data must stay a
        # mutable bytearray for in-place writes
        for objs in self.colls.values():
            for o in objs.values():
                if not isinstance(o.data, bytearray):
                    o.data = bytearray(o.data)
        replayed = 0
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    n, crc = _HDR.unpack(hdr)
                    blob = f.read(n)
                    if len(blob) < n or \
                            (crc32c(0xFFFFFFFF, blob) & 0xFFFFFFFF) != crc:
                        dout("store", 0).write(
                            "%s: journal tail torn after %d txns",
                            self.path, replayed)
                        break     # torn tail from a crash: stop here
                    seq, ops = wire.decode(blob)
                    if seq <= self._seq:
                        continue  # already in the snapshot (a crash
                                  # between snapshot publish and WAL
                                  # truncation leaves applied frames)
                    txn = Transaction()
                    txn.ops = ops
                    super().queue_transaction(txn)
                    self._seq = seq
                    replayed += 1
        self.mounted = True
        if replayed:
            dout("store", 1).write("%s: replayed %d journaled txns",
                                   self.path, replayed)
            self.compact()

    def umount(self) -> None:
        self.compact()
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        self.mounted = False

    def compact(self) -> None:
        """Snapshot the working set and truncate the journal
        (ref: journal trim after filestore sync)."""
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(wire.encode((self.colls, self._seq)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        open(self._wal_path, "wb").close()

    # -- txn apply -------------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        # memory first (validation/atomicity), then the journal frame —
        # both under the store lock so concurrent dispatch threads
        # cannot journal in a different order than they applied; a
        # crash between the two loses only this unacked txn
        with self._lock:
            # encode BEFORE the in-memory apply: an unencodable
            # payload must fail the whole txn, not leave applied-but-
            # unjournaled state that a remount silently rolls back
            blob = wire.encode((self._seq + 1, txn.ops))
            super().queue_transaction(txn)
            self._seq += 1
            frame = _HDR.pack(
                len(blob),
                crc32c(0xFFFFFFFF, blob) & 0xFFFFFFFF) + blob
            if self._wal is None:
                self._wal = open(self._wal_path, "ab")
            self._wal.write(frame)
            self._wal.flush()
            os.fsync(self._wal.fileno())
