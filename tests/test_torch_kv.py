"""The port's KeyValueDB (`ceph_tpu_torch.kv`) held to the reference's
(`ceph_tpu.kv`) at tolerance 0.

The same seeded transaction sequences (sets of typed values, removals,
prefix removals) go through `MemDB` and `LogDB` of both packages: every
`get`, `get_by_prefix`, `iterator` and `all_items` result is equal (the
values compared as their wire bytes, since a registered struct decodes
into its own package's class), and the `kv.wal` and `kv.snap` files
have equal sha256.  A LogDB either package wrote opens in the other.
Torn tails are ignored and compaction bounds replay, as in the
reference's tests/test_bluestore.py.
"""
import hashlib

import numpy as np
import pytest

from ceph_tpu import kv as ref_kv
from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu.store import ObjectId as RefOid
from ceph_tpu_torch import kv as port_kv
from ceph_tpu_torch.msg import encoding as port_wire
from ceph_tpu_torch.store import ObjectId as PortOid

KV = {"ref": ref_kv, "port": port_kv}
WIRE = {"ref": ref_wire, "port": port_wire}
OID = {"ref": RefOid, "port": PortOid}
PREFIXES = ["S", "C", "O", "B", "M|pg_1.0"]


def value(kind: str, rng):
    """A typed value the codec carries: scalars, bytes, containers and a
    registered struct, chosen by the seeded generator."""
    pick = int(rng.integers(0, 7))
    if pick == 0:
        return int(rng.integers(-1 << 40, 1 << 40))
    if pick == 1:
        return rng.bytes(int(rng.integers(0, 300)))
    if pick == 2:
        return f"s{int(rng.integers(0, 1000))}"
    if pick == 3:
        return [int(x) for x in rng.integers(0, 99, int(rng.integers(0, 5)))]
    if pick == 4:
        return {"units": (int(rng.integers(0, 64)), 1), "csum": 7,
                "comp": None, "refs": int(rng.integers(1, 3))}
    if pick == 5:
        return OID[kind](f"obj{int(rng.integers(0, 50))}", -2,
                         int(rng.integers(-1, 12)))
    return None


def drive(kind: str, db, seed: int, n_txn: int = 60) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(n_txn):
        t = db.transaction()
        for _ in range(int(rng.integers(1, 6))):
            op = int(rng.integers(0, 10))
            prefix = PREFIXES[int(rng.integers(0, len(PREFIXES)))]
            key = f"k{int(rng.integers(0, 40)):03d}"
            if op < 7:
                t.set(prefix, key, value(kind, rng))
            elif op < 9:
                t.rmkey(prefix, key)
            else:
                t.rmkeys_by_prefix(prefix)
        db.submit_transaction(t)


def view(kind: str, db) -> dict:
    """Every read the KeyValueDB offers, values as wire bytes."""
    enc = WIRE[kind].encode
    out = {"items": sorted((k, enc(v)) for k, v in db.all_items())}
    for p in PREFIXES:
        out[f"by_prefix {p}"] = {k: enc(v)
                                 for k, v in db.get_by_prefix(p).items()}
        out[f"iterator {p}"] = [(k, enc(v)) for k, v in db.iterator(p)]
        out[f"get {p}"] = [enc(db.get(p, f"k{i:03d}", "absent"))
                           for i in range(40)]
        out[f"exists {p}"] = [db.exists(p, f"k{i:03d}") for i in range(40)]
    return out


def sha(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_memdb_equals_reference(seed):
    dbs = {kind: KV[kind].MemDB() for kind in KV}
    for kind, db in dbs.items():
        drive(kind, db, seed)
    assert view("port", dbs["port"]) == view("ref", dbs["ref"])


@pytest.mark.parametrize("compact_bytes", [8 << 20, 4096],
                         ids=["wal-only", "compacted"])
@pytest.mark.parametrize("seed", [1, 2])
def test_logdb_equals_reference_and_its_files(tmp_path, seed,
                                              compact_bytes):
    """Equal reads after the same transactions, equal kv.wal and kv.snap
    bytes, and equal reads again after each reopens its directory."""
    dbs = {kind: KV[kind].LogDB(str(tmp_path / kind),
                                compact_bytes=compact_bytes)
           for kind in KV}
    for kind, db in dbs.items():
        drive(kind, db, seed)
    assert view("port", dbs["port"]) == view("ref", dbs["ref"])
    assert dbs["port"].wal_size() == dbs["ref"].wal_size()
    for db in dbs.values():
        db.close()
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert ("kv.snap" in names) == (compact_bytes == 4096)
    for name in names:
        assert sha(tmp_path / "port" / name) == sha(tmp_path / "ref" / name)
    reopened = {kind: KV[kind].LogDB(str(tmp_path / kind)) for kind in KV}
    assert view("port", reopened["port"]) == view("ref", reopened["ref"])
    for db in reopened.values():
        db.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_logdb_opens_in_the_other_package(tmp_path, writer, reader):
    db = KV[writer].LogDB(str(tmp_path / "kv"), compact_bytes=2048)
    drive(writer, db, seed=5)
    want = view(writer, db)
    db.close()
    other = KV[reader].LogDB(str(tmp_path / "kv"))
    assert view(reader, other) == want
    # and it goes on writing where the other left off
    t = other.transaction()
    t.set("S", "after", {"by": reader})
    other.submit_transaction(t)
    other.close()
    back = KV[writer].LogDB(str(tmp_path / "kv"))
    assert back.get("S", "after") == {"by": reader}
    back.close()


@pytest.mark.parametrize("kind", ["port"])
def test_logdb_roundtrip_and_replay(tmp_path, kind):
    """(the reference's tests/test_bluestore.py::test_logdb_roundtrip_
    and_replay on the port)"""
    db = KV[kind].LogDB(str(tmp_path / "kv"))
    t = db.transaction()
    t.set("P", "a", {"x": 1})
    t.set("P", "b", b"bytes")
    t.set("Q", "c", [1, 2, 3])
    db.submit_transaction(t)
    t = db.transaction()
    t.rmkey("P", "a")
    db.submit_transaction(t)
    db.close()
    db2 = KV[kind].LogDB(str(tmp_path / "kv"))
    assert db2.get("P", "a") is None
    assert db2.get("P", "b") == b"bytes"
    assert db2.get_by_prefix("Q") == {"c": [1, 2, 3]}
    db2.close()


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_logdb_compaction_bounds_replay(tmp_path, kind):
    db = KV[kind].LogDB(str(tmp_path / "kv"), compact_bytes=4096)
    for i in range(200):
        t = db.transaction()
        t.set("P", f"k{i}", b"v" * 100)
        db.submit_transaction(t)
    # the WAL stayed bounded by compaction: replay is O(tail)
    assert db.wal_size() < 4096 + 4096
    db.close()
    db2 = KV[kind].LogDB(str(tmp_path / "kv"))
    assert len(db2.get_by_prefix("P")) == 200
    db2.close()


@pytest.mark.parametrize("tail", [b"\x00\x00\x01\x00garbage-torn-tail",
                                  b"\x00\x00", b""],
                         ids=["bad-crc", "short-header", "clean"])
def test_logdb_torn_tail_ignored(tmp_path, tail):
    """A torn tail (a crash mid-append) is dropped by both packages,
    which then read the same table."""
    for kind in KV:
        db = KV[kind].LogDB(str(tmp_path / kind))
        drive(kind, db, seed=9, n_txn=10)
        db.close()
        with open(tmp_path / kind / "kv.wal", "ab") as f:
            f.write(tail)
    dbs = {kind: KV[kind].LogDB(str(tmp_path / kind)) for kind in KV}
    assert view("port", dbs["port"]) == view("ref", dbs["ref"])
    assert dbs["port"].all_items()
    for db in dbs.values():
        db.close()


def test_empty_transaction_writes_nothing(tmp_path):
    db = port_kv.LogDB(str(tmp_path / "kv"))
    db.submit_transaction(db.transaction())
    assert db.wal_size() == 0 and db.transaction().empty
    db.close()
