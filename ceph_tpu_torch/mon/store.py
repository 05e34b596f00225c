"""MonitorStore: the mon's versioned key/value backing store.

Shape of src/mon/MonitorDBStore.h: values live under (prefix, key),
mutations batch into transactions applied atomically, and services
keep versioned entries ("%d" keys) plus first/last_committed markers.
In-memory here (the reference sits on RocksDB); the transaction journal
makes replay/replication possible later.

The port's copy of `ceph_tpu.mon.store`, without the `KeyValueDB`
backing (`kv/` is not ported): the store lives in memory only, and a
killed mon's store survives only as the object the harness keeps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator

from ..common.lockdep import make_lock
from ..msg import encoding as wire


@dataclass
class StoreTransaction:
    """Atomic batch of puts/erases
    (ref: MonitorDBStore.h:51 Transaction)."""
    ops: list[tuple[str, str, str, Any]] = field(default_factory=list)

    def put(self, prefix: str, key: str | int, value: Any) -> None:
        self.ops.append(("put", prefix, str(key), value))

    def erase(self, prefix: str, key: str | int) -> None:
        self.ops.append(("erase", prefix, str(key), None))

    def erase_range(self, prefix: str, first: str | int,
                    last: str | int) -> None:
        """erase [first, last) like compact_prefix trimming."""
        self.ops.append(("erase_range", prefix, str(first), str(last)))

    @property
    def empty(self) -> bool:
        return not self.ops

    def encode(self) -> bytes:
        """Typed wire encoding — paxos BEGIN/COMMIT carry these blobs
        between mons (ref: MonitorDBStore.h Transaction::encode)."""
        return wire.encode(self.ops)

    @classmethod
    def decode(cls, data: bytes) -> "StoreTransaction":
        ops = wire.decode(data)
        if not isinstance(ops, list):
            raise wire.WireError("store transaction must be a list")
        return cls(ops=ops)


class MonitorStore:
    """(prefix, key) -> value with atomic transactions
    (ref: MonitorDBStore.h:161 apply_transaction)."""

    def __init__(self) -> None:
        self._data: dict[tuple[str, str], Any] = {}
        self._lock = make_lock("mon.store")

    @property
    def empty(self) -> bool:
        with self._lock:
            return not self._data

    def apply_transaction(self, tx: StoreTransaction) -> None:
        with self._lock:
            for op, prefix, key, value in tx.ops:
                if op == "put":
                    self._data[(prefix, key)] = value
                elif op == "erase":
                    self._data.pop((prefix, key), None)
                elif op == "erase_range":
                    lo, hi = int(key), int(value)
                    # versioned keys are decimal ints
                    for k in [k for k in self._data
                              if k[0] == prefix and k[1].isdigit()
                              and lo <= int(k[1]) < hi]:
                        del self._data[k]

    def get(self, prefix: str, key: str | int, default: Any = None) -> Any:
        with self._lock:
            return self._data.get((prefix, str(key)), default)

    def exists(self, prefix: str, key: str | int) -> bool:
        with self._lock:
            return (prefix, str(key)) in self._data

    def get_int(self, prefix: str, key: str | int, default: int = 0) -> int:
        v = self.get(prefix, key)
        return default if v is None else int(v)

    def keys(self, prefix: str) -> Iterator[str]:
        with self._lock:
            return iter(sorted(k[1] for k in self._data if k[0] == prefix))

    def export_data(self) -> bytes:
        """Full snapshot for mon full-sync (ref: Monitor.cc sync_*).
        Typed encoding: the blob crosses the wire in MPaxosStoreSync."""
        with self._lock:
            return wire.encode(self._data)

    def import_data(self, blob: bytes) -> None:
        data = wire.decode(blob)
        if not isinstance(data, dict):
            raise wire.WireError("store snapshot must be a dict")
        with self._lock:
            self._data = data
