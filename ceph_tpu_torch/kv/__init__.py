"""KeyValueDB: the metadata store abstraction under BlueStore/mon.

The reference's `src/kv/KeyValueDB.h` boundary — prefixed keys,
atomic transaction batches, ordered iteration — with two backends:

* `MemDB` — dict-backed (the reference's MemDB, src/kv/MemDB.cc);
* `LogDB` — persistent log-structured store standing in for RocksDB
  (src/kv/RocksDBStore.cc): an fsync'd write-ahead log of typed-codec
  batches over an in-memory table, compacted into a snapshot file when
  the log grows — replay cost is O(log tail), never O(dataset).

Values go through the typed wire codec (msg/encoding.py), so a
LogDB file never feeds pickle and arbitrary Python payloads
(dicts/tuples/registered structs) round-trip.

The port's copy of `ceph_tpu.kv`, whole: the same record framing,
snapshot and compaction, and values through the port's own codec, so
a `kv.wal` or `kv.snap` written by either package is the other's byte
for byte and opens in it.
"""
from __future__ import annotations

import abc
import os
import struct
from typing import Any, Iterator

from ..common.crc32c import crc32c
from ..common.lockdep import make_lock
from ..msg import encoding as wire


class KVTransaction:
    """Atomic batch (ref: KeyValueDB::Transaction)."""

    def __init__(self):
        self.ops: list[tuple] = []

    def set(self, prefix: str, key: str, value: Any) -> "KVTransaction":
        self.ops.append(("set", prefix, key, value))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rm", prefix, key))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rmprefix", prefix))
        return self

    @property
    def empty(self) -> bool:
        return not self.ops


class KeyValueDB(abc.ABC):
    """(ref: src/kv/KeyValueDB.h)."""

    def transaction(self) -> KVTransaction:
        return KVTransaction()

    @abc.abstractmethod
    def submit_transaction(self, txn: KVTransaction) -> None:
        """Apply atomically and durably (sync commit)."""

    @abc.abstractmethod
    def get(self, prefix: str, key: str, default: Any = None) -> Any:
        ...

    @abc.abstractmethod
    def get_by_prefix(self, prefix: str) -> dict[str, Any]:
        ...

    def exists(self, prefix: str, key: str) -> bool:
        return self.get(prefix, key, _MISSING) is not _MISSING

    @abc.abstractmethod
    def iterator(self, prefix: str) -> Iterator[tuple[str, Any]]:
        """Sorted (key, value) pairs under a prefix."""

    @abc.abstractmethod
    def all_items(self) -> Iterator[tuple[tuple[str, str], Any]]:
        """Every ((prefix, key), value) pair (whole-store loads)."""

    def close(self) -> None:
        pass


_MISSING = object()


class MemDB(KeyValueDB):
    """(ref: src/kv/MemDB.cc)."""

    def __init__(self):
        self._data: dict[tuple[str, str], Any] = {}
        self._lock = make_lock("kv.memdb")

    def submit_transaction(self, txn: KVTransaction) -> None:
        with self._lock:
            _apply(self._data, txn.ops)

    def get(self, prefix: str, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._data.get((prefix, key), default)

    def get_by_prefix(self, prefix: str) -> dict[str, Any]:
        with self._lock:
            return {k[1]: v for k, v in self._data.items()
                    if k[0] == prefix}

    def iterator(self, prefix: str):
        return iter(sorted(self.get_by_prefix(prefix).items()))

    def all_items(self):
        with self._lock:
            return list(self._data.items())


def _apply(data: dict, ops) -> None:
    for op in ops:
        if op[0] == "set":
            data[(op[1], op[2])] = op[3]
        elif op[0] == "rm":
            data.pop((op[1], op[2]), None)
        elif op[0] == "rmprefix":
            for k in [k for k in data if k[0] == op[1]]:
                del data[k]


_REC = struct.Struct("!II")        # length, crc32c


class LogDB(KeyValueDB):
    """Log-structured persistent KV (the RocksDB stand-in).

    Layout in `dir/`: `kv.snap` (typed-codec snapshot of the table at
    sequence S) + `kv.wal` (records applied after S).  Every commit
    appends one crc-framed record and fsyncs; when the WAL passes
    `compact_bytes` the table is re-snapshotted and the WAL truncated —
    mount replays only the tail (O(journal), the BlueStore/RocksDB
    recovery contract).  Torn tails (crash mid-append) are detected by
    the crc and dropped.
    """

    def __init__(self, path: str, compact_bytes: int = 8 << 20):
        self.path = path
        self.compact_bytes = compact_bytes
        self._lock = make_lock(f"kv.logdb.{path}")
        self._data: dict[tuple[str, str], Any] = {}
        # persisted values may contain any registered wire struct; the
        # replay must not depend on the caller's import order
        wire.ensure_registered()
        os.makedirs(path, exist_ok=True)
        self._snap = os.path.join(path, "kv.snap")
        self._walp = os.path.join(path, "kv.wal")
        self._replay()
        self._wal = open(self._walp, "ab")

    # -- recovery ------------------------------------------------------
    def _replay(self) -> None:
        if os.path.exists(self._snap):
            with open(self._snap, "rb") as f:
                blob = f.read()
            if blob:
                self._data = wire.decode(blob)
        if not os.path.exists(self._walp):
            return
        with open(self._walp, "rb") as f:
            raw = f.read()
        pos = 0
        while pos + _REC.size <= len(raw):
            n, crc = _REC.unpack_from(raw, pos)
            body = raw[pos + _REC.size: pos + _REC.size + n]
            if len(body) < n or crc32c(0, body) != crc:
                break                      # torn tail: ignore the rest
            _apply(self._data, wire.decode(body))
            pos += _REC.size + n

    # -- commit --------------------------------------------------------
    def submit_transaction(self, txn: KVTransaction) -> None:
        if txn.empty:
            return
        body = wire.encode(txn.ops)
        rec = _REC.pack(len(body), crc32c(0, body)) + body
        with self._lock:
            self._wal.write(rec)
            self._wal.flush()
            os.fsync(self._wal.fileno())
            _apply(self._data, txn.ops)
            if self._wal.tell() >= self.compact_bytes:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Snapshot + truncate the WAL (ref: memtable flush/compaction;
        keeps mount replay O(wal), not O(history))."""
        tmp = self._snap + ".tmp"
        with open(tmp, "wb") as f:
            f.write(wire.encode(self._data))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap)       # atomic cutover
        self._wal.close()
        self._wal = open(self._walp, "wb")
        self._wal.flush()
        os.fsync(self._wal.fileno())

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    # -- reads ---------------------------------------------------------
    def get(self, prefix: str, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._data.get((prefix, key), default)

    def get_by_prefix(self, prefix: str) -> dict[str, Any]:
        with self._lock:
            return {k[1]: v for k, v in self._data.items()
                    if k[0] == prefix}

    def iterator(self, prefix: str):
        return iter(sorted(self.get_by_prefix(prefix).items()))

    def all_items(self):
        with self._lock:
            return list(self._data.items())

    def wal_size(self) -> int:
        with self._lock:
            return self._wal.tell()

    def close(self) -> None:
        with self._lock:
            try:
                self._wal.close()
            except OSError:
                pass
