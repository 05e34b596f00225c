"""The port's ObjectStore and MemStore held to the reference's.

tests/test_memstore.py's thirteen cases, each run on a fresh store of
each package: the same transactions, the same assertions, and then the
two stores' whole contents (collections, objects' bytes, xattrs and
omap) compared at tolerance 0.  `MemStore.from_reference` carries a
reference store across by attribute.
"""
from types import SimpleNamespace

import pytest

from ceph_tpu.common import options as ref_options
from ceph_tpu import store as ref_store
from ceph_tpu_torch.common import options as port_options
from ceph_tpu_torch import store as port_store

REF = SimpleNamespace(name="ref", store=ref_store,
                      config=ref_options.global_config)
PORT = SimpleNamespace(name="port", store=port_store,
                       config=port_options.global_config)


def fresh(ns):
    s = ns.store.MemStore()
    s.mkfs()
    s.mount()
    s.queue_transaction(ns.store.Transaction().create_collection("cid"))
    return s


def dump(st) -> dict:
    return {(cid, o.name, o.snap, o.shard): (st.read(cid, o),
                                             st.getattrs(cid, o),
                                             st.omap_get(cid, o))
            for cid in st.list_collections()
            for o in st.collection_list(cid)} | {
        ("collections",): tuple(st.list_collections())}


# --------------------------------------------------------------- cases
# Each takes (ns, store, OID) and makes tests/test_memstore.py's
# assertions on that package.

def c_write_read_extend(ns, store, oid):
    T = ns.store.Transaction
    store.queue_transaction(T().write("cid", oid, 0, b"hello"))
    assert store.read("cid", oid) == b"hello"
    store.queue_transaction(T().write("cid", oid, 8, b"world"))
    assert store.read("cid", oid) == b"hello\0\0\0world"
    assert store.stat("cid", oid)["size"] == 13
    assert store.read("cid", oid, 8, 5) == b"world"
    assert store.read("cid", oid, 8) == b"world"


def c_zero_truncate(ns, store, oid):
    T = ns.store.Transaction
    store.queue_transaction(T().write("cid", oid, 0, b"x" * 16))
    store.queue_transaction(T().zero("cid", oid, 4, 8))
    assert store.read("cid", oid) == b"x" * 4 + b"\0" * 8 + b"x" * 4
    store.queue_transaction(T().truncate("cid", oid, 6))
    assert store.read("cid", oid) == b"x" * 4 + b"\0" * 2
    store.queue_transaction(T().truncate("cid", oid, 10))
    assert store.stat("cid", oid)["size"] == 10


def c_touch_remove_exists(ns, store, oid):
    T = ns.store.Transaction
    assert not store.exists("cid", oid)
    store.queue_transaction(T().touch("cid", oid))
    assert store.exists("cid", oid)
    assert store.read("cid", oid) == b""
    store.queue_transaction(T().remove("cid", oid))
    assert not store.exists("cid", oid)
    with pytest.raises(ns.store.StoreError):
        store.queue_transaction(T().remove("cid", oid))


def c_attrs(ns, store, oid):
    T = ns.store.Transaction
    store.queue_transaction(
        T().touch("cid", oid)
        .setattr("cid", oid, "hinfo", {"a": 1})
        .setattrs("cid", oid, {"x": b"1", "y": b"2"}))
    assert store.getattr("cid", oid, "hinfo") == {"a": 1}
    assert store.getattrs("cid", oid) == {"hinfo": {"a": 1},
                                          "x": b"1", "y": b"2"}
    store.queue_transaction(T().rmattr("cid", oid, "x"))
    assert "x" not in store.getattrs("cid", oid)
    with pytest.raises(ns.store.StoreError):
        store.getattr("cid", oid, "x")
    store.queue_transaction(T().rmattrs("cid", oid))
    assert store.getattrs("cid", oid) == {}


def c_omap(ns, store, oid):
    T = ns.store.Transaction
    store.queue_transaction(
        T().omap_setkeys("cid", oid, {"k1": b"v1", "k2": b"v2"}))
    assert store.omap_get("cid", oid) == {"k1": b"v1", "k2": b"v2"}
    store.queue_transaction(T().omap_rmkeys("cid", oid, ["k1"]))
    assert store.omap_get("cid", oid) == {"k2": b"v2"}
    store.queue_transaction(T().omap_setkeys("cid", oid, {"k3": b"v3"}))
    keep = store.omap_get("cid", oid)
    store.queue_transaction(T().omap_clear("cid", oid))
    assert store.omap_get("cid", oid) == {}
    store.queue_transaction(T().omap_setkeys("cid", oid, keep))


def c_clone_full_and_range(ns, store, oid):
    T, O = ns.store.Transaction, ns.store.ObjectId
    c2 = O("clone")
    store.queue_transaction(
        T().write("cid", oid, 0, b"abcdefgh")
        .setattr("cid", oid, "tag", b"t")
        .omap_setkeys("cid", oid, {"k": b"v"})
        .clone("cid", oid, c2))
    assert store.read("cid", c2) == b"abcdefgh"
    assert store.getattr("cid", c2, "tag") == b"t"
    assert store.omap_get("cid", c2) == {"k": b"v"}
    store.queue_transaction(T().write("cid", oid, 0, b"XXXX"))
    assert store.read("cid", c2) == b"abcdefgh"
    c3 = O("range")
    store.queue_transaction(T().clone_range("cid", oid, c3, 2, 4, 1))
    assert store.read("cid", c3) == b"\0XXef"


def c_collection_lifecycle(ns, store, oid):
    T, E = ns.store.Transaction, ns.store.StoreError
    store.queue_transaction(T().create_collection("cid2"))
    assert store.collection_exists("cid2")
    assert set(store.list_collections()) == {"cid", "cid2"}
    with pytest.raises(E):
        store.queue_transaction(T().create_collection("cid2"))
    store.queue_transaction(T().touch("cid2", oid))
    with pytest.raises(E):
        store.queue_transaction(T().remove_collection("cid2"))
    store.queue_transaction(
        T().remove("cid2", oid).remove_collection("cid2"))
    assert not store.collection_exists("cid2")
    with pytest.raises(E):
        store.collection_list("cid2")


def c_collection_move_rename(ns, store, oid):
    T, O = ns.store.Transaction, ns.store.ObjectId
    store.queue_transaction(T().create_collection("dst"))
    store.queue_transaction(T().write("cid", oid, 0, b"data"))
    new_oid = O("renamed")
    store.queue_transaction(
        T().collection_move_rename("cid", oid, "dst", new_oid))
    assert not store.exists("cid", oid)
    assert store.read("dst", new_oid) == b"data"


def c_txn_atomicity_on_failure(ns, store, oid):
    T, O = ns.store.Transaction, ns.store.ObjectId
    store.queue_transaction(T().write("cid", oid, 0, b"orig"))
    bad = (T().write("cid", oid, 0, b"new!")
           .touch("cid", O("side-effect"))
           .remove("cid", O("missing")))
    with pytest.raises(ns.store.StoreError) as ei:
        store.queue_transaction(bad)
    assert ei.value.errno_name == "ENOENT"
    assert store.read("cid", oid) == b"orig"
    assert not store.exists("cid", O("side-effect"))


def c_txn_order_within_txn(ns, store, oid):
    store.queue_transaction(
        ns.store.Transaction()
        .write("cid", oid, 0, b"aaaa")
        .zero("cid", oid, 1, 2)
        .write("cid", oid, 2, b"Z"))
    assert store.read("cid", oid) == b"a\0Za"


def c_collection_list_sorted(ns, store, oid):
    t = ns.store.Transaction()
    for n in ["b", "a", "c"]:
        t.touch("cid", ns.store.ObjectId(n))
    store.queue_transaction(t)
    assert [o.name for o in store.collection_list("cid")] == ["a", "b", "c"]


def c_inject_read_err(ns, store, oid):
    store.queue_transaction(ns.store.Transaction().write("cid", oid, 0,
                                                         b"data"))
    store.inject_read_err("cid", oid)
    cfg = ns.config()
    old = cfg["objectstore_debug_inject_read_err"]
    try:
        assert store.read("cid", oid) == b"data"     # gated by config
        cfg.set("objectstore_debug_inject_read_err", True)
        with pytest.raises(ns.store.StoreError) as ei:
            store.read("cid", oid)
        assert ei.value.errno_name == "EIO"
        store.clear_read_err("cid", oid)
        assert store.read("cid", oid) == b"data"
    finally:
        cfg.set("objectstore_debug_inject_read_err", old)


def c_statfs(ns, store, oid):
    store.queue_transaction(ns.store.Transaction().write("cid", oid, 0,
                                                         b"x" * 100))
    fs = store.statfs()
    assert fs["used"] == 100
    assert fs["total"] == 1 << 30
    assert fs["available"] == fs["total"] - 100


CASES = {f.__name__[2:]: f for f in (
    c_write_read_extend, c_zero_truncate, c_touch_remove_exists, c_attrs,
    c_omap, c_clone_full_and_range, c_collection_lifecycle,
    c_collection_move_rename, c_txn_atomicity_on_failure,
    c_txn_order_within_txn, c_collection_list_sorted, c_inject_read_err,
    c_statfs)}


@pytest.mark.parametrize("name", list(CASES))
def test_memstore_case_equals_reference(name):
    dumps = {}
    for ns in (REF, PORT):
        st = fresh(ns)
        CASES[name](ns, st, ns.store.ObjectId("obj1"))
        dumps[ns.name] = dump(st)
    assert dumps["port"] == dumps["ref"]


def test_from_reference_carries_every_object():
    """A reference store with data, xattrs (plain values), omap, several
    collections and sharded object ids, carried across: the same
    contents, and independent of the source afterwards."""
    src = fresh(REF)
    T, O = ref_store.Transaction, ref_store.ObjectId
    src.queue_transaction(T().create_collection("pg_1.0"))
    src.queue_transaction(
        T().write("pg_1.0", O("a", shard=3), 5, b"chunk")
        .setattrs("pg_1.0", O("a", shard=3),
                  {"_": {"size": 5, "version": (1, 2)}, "u:x": b"1"})
        .omap_setkeys("pg_1.0", O("pgmeta"), {"l.1": b"\x0d\x01"})
        .touch("cid", O("b", snap=4)))
    got = port_store.MemStore.from_reference(src)
    assert dump(got) == dump(src)
    assert all(type(o) is port_store.ObjectId
               for o in got.collection_list("pg_1.0"))
    got.queue_transaction(port_store.Transaction().write(
        "pg_1.0", port_store.ObjectId("a", shard=3), 0, b"XX"))
    assert src.read("pg_1.0", O("a", shard=3)) == b"\0" * 5 + b"chunk"
