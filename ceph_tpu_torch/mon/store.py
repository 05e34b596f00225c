"""MonitorStore: the mon's versioned key/value backing store.

Shape of src/mon/MonitorDBStore.h: values live under (prefix, key),
mutations batch into transactions applied atomically, and services
keep versioned entries ("%d" keys) plus first/last_committed markers.
In memory, optionally written through to a `KeyValueDB` (kv/, the
RocksDB slot the reference's MonitorDBStore sits on).

The port's copy of `ceph_tpu.mon.store`, whole: with a `LogDB` under
it every transaction is durable before `apply_transaction` returns,
and a mon started on that store again resumes from its committed
paxos state (`python -m ceph_tpu_torch.tools.daemon_main mon
--data-dir DIR`).
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
    (ref: MonitorDBStore.h:161 apply_transaction).

    With a `KeyValueDB` backing (kv/ — the RocksDB slot the
    reference's MonitorDBStore sits on), every transaction writes
    through durably and a restarted mon resumes from its committed
    paxos state instead of bootstrap."""

    def __init__(self, db=None) -> None:
        self._data: dict[tuple[str, str], Any] = {}
        self._lock = make_lock("mon.store")
        self.db = db
        if db is not None:
            self._data = dict(db.all_items())

    @property
    def empty(self) -> bool:
        with self._lock:
            return not self._data

    def apply_transaction(self, tx: StoreTransaction) -> None:
        with self._lock:
            kvt = self.db.transaction() if self.db is not None else None
            for op, prefix, key, value in tx.ops:
                if op == "put":
                    self._data[(prefix, key)] = value
                    if kvt is not None:
                        kvt.set(prefix, key, value)
                elif op == "erase":
                    self._data.pop((prefix, key), None)
                    if kvt is not None:
                        kvt.rmkey(prefix, key)
                elif op == "erase_range":
                    lo, hi = int(key), int(value)
                    # versioned keys are decimal ints
                    for k in [k for k in self._data
                              if k[0] == prefix and k[1].isdigit()
                              and lo <= int(k[1]) < hi]:
                        del self._data[k]
                        if kvt is not None:
                            kvt.rmkey(k[0], k[1])
            if kvt is not None:
                self.db.submit_transaction(kvt)

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
            if self.db is not None:
                # full-sync REPLACES the store: stale keys absent from
                # the snapshot must die in the same transaction, or a
                # restart resurrects diverged paxos/osdmap versions
                kvt = self.db.transaction()
                for prefix in {k[0] for k, _v in self.db.all_items()}:
                    kvt.rmkeys_by_prefix(prefix)
                for (prefix, key), value in data.items():
                    kvt.set(prefix, key, value)
                self.db.submit_transaction(kvt)
