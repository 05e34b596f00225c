"""The port's BlueStore and JournaledStore (`ceph_tpu_torch.store`) held
to the reference's (`ceph_tpu.store`) at tolerance 0.

A seeded generator builds transactions of every kind the stores take:
collection create and move-rename, write (small overwrites that take
the deferred path, large writes that compress), zero, truncate, clone,
clone_range, setattrs, rmattr, omap set, remove and clear, touch and
remove, with a failing transaction now and then.  The same sequence
runs on both packages' stores, with compression on and off: each
failing transaction fails with the same errno in both, and afterwards
the `block` file and every file under `kv/` (or the journal and the
snapshot) have equal sha256, and every read, xattr, omap, `statfs` and
`fsck` is equal.  A store either package made mounts in the other,
which goes on writing it.  Bitrot gives EIO in both.  Each case of the
reference's tests/test_bluestore.py and tests/test_journaled_store.py
has a counterpart here (parametrised over the package or the engine
where cases repeat), except the LogDB cases, which are in
tests/test_torch_kv.py, and those that drive a cluster: the
multi-process kill -9 is in tests/test_torch_daemon_main.py, and the
bitrot that scrub repairs in the reference (scrub is not ported) is the
bitrot the EC read decodes around in tests/test_torch_durable_cluster.py.
"""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

import ceph_tpu.store as ref_store
import ceph_tpu_torch.store as port_store
from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu_torch.msg import encoding as port_wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = {"ref": ref_store, "port": port_store}
WIRE = {"ref": ref_wire, "port": port_wire}
NAMES = [f"o{i}" for i in range(8)]


def mk(kind: str, path, **kw):
    st = STORE[kind].BlueStore(str(path), min_alloc=512, **kw)
    st.mkfs()
    st.mount()
    return st


def tree(path) -> dict:
    """sha256 of every file under `path`, by relative name."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def gen_txns(seed: int, n: int = 40) -> list[list[tuple]]:
    """Seeded abstract transactions over collections c and d."""
    rng = np.random.default_rng(seed)
    txns = [[("mkcoll", "c")], [("mkcoll", "d")]]
    for _ in range(n):
        ops = []
        for _ in range(int(rng.integers(1, 5))):
            name = NAMES[int(rng.integers(0, len(NAMES)))]
            other = NAMES[int(rng.integers(0, len(NAMES)))]
            pick = int(rng.integers(0, 16))
            off = int(rng.integers(0, 6000))
            if pick < 4:
                size = int(rng.integers(1, 600)) if rng.random() < 0.5 \
                    else int(rng.integers(4096, 40000))
                data = bytes([int(rng.integers(0, 256))]) * size \
                    if rng.random() < 0.4 else rng.bytes(size)
                ops.append(("write", name, off, data))
            elif pick == 4:
                ops.append(("zero", name, off, int(rng.integers(1, 3000))))
            elif pick == 5:
                ops.append(("truncate", name, int(rng.integers(0, 9000))))
            elif pick == 6:
                ops.append(("clone", name, other))
            elif pick == 7:
                ops.append(("clone_range", name, other,
                            int(rng.integers(0, 3000)),
                            int(rng.integers(1, 3000)), off))
            elif pick == 8:
                ops.append(("setattrs", name,
                            {f"a{int(rng.integers(0, 4))}":
                             rng.bytes(int(rng.integers(0, 40))),
                             "oi": {"v": (1, int(rng.integers(0, 99)))}}))
            elif pick == 9:
                ops.append(("rmattr", name, f"a{int(rng.integers(0, 4))}"))
            elif pick == 10:
                ops.append(("omap_set", name,
                            {f"k{int(rng.integers(0, 9))}":
                             rng.bytes(int(rng.integers(0, 30)))}))
            elif pick == 11:
                ops.append(("omap_rm", name,
                            [f"k{int(rng.integers(0, 9))}"]))
            elif pick == 12:
                ops.append(("remove", name))
            elif pick == 13:
                ops.append(("move", name, other,
                            "d" if rng.random() < 0.3 else "c"))
            elif pick == 14:
                ops.append(("omap_clear", name))
            else:
                ops.append(("touch", name))
        txns.append(ops)
    return txns


def build(kind: str, ops: list[tuple]):
    mod = STORE[kind]
    O, t = mod.ObjectId, mod.Transaction()
    for op in ops:
        code = op[0]
        if code == "mkcoll":
            t.create_collection(op[1])
        elif code == "write":
            t.write("c", O(op[1]), op[2], op[3])
        elif code == "zero":
            t.zero("c", O(op[1]), op[2], op[3])
        elif code == "truncate":
            t.truncate("c", O(op[1]), op[2])
        elif code == "clone":
            t.clone("c", O(op[1]), O(op[2]))
        elif code == "clone_range":
            t.clone_range("c", O(op[1]), O(op[2]), op[3], op[4], op[5])
        elif code == "setattrs":
            t.setattrs("c", O(op[1]), op[2])
        elif code == "rmattr":
            t.rmattr("c", O(op[1]), op[2])
        elif code == "omap_set":
            t.omap_setkeys("c", O(op[1]), op[2])
        elif code == "omap_rm":
            t.omap_rmkeys("c", O(op[1]), op[2])
        elif code == "remove":
            t.remove("c", O(op[1]))
        elif code == "move":
            t.collection_move_rename("c", O(op[1]), op[3], O(op[2]))
        elif code == "omap_clear":
            t.omap_clear("c", O(op[1]))
        else:
            t.touch("c", O(op[1]))
    return t


def run(kind: str, st, txns) -> list:
    """Apply `txns`; the errno of each one that failed (None if not)."""
    out = []
    for ops in txns:
        try:
            st.queue_transaction(build(kind, ops))
            out.append(None)
        except STORE[kind].StoreError as ex:
            out.append(ex.errno_name)
    return out


def observe(kind: str, st) -> dict:
    enc = WIRE[kind].encode
    out = {"colls": st.list_collections(), "statfs": st.statfs()}
    if hasattr(st, "fsck"):
        out["fsck"] = st.fsck()
    for cid in out["colls"]:
        for oid in st.collection_list(cid):
            out[(cid, str(oid))] = (
                st.read(cid, oid, 0, 0), st.stat(cid, oid)["size"],
                enc(sorted(st.getattrs(cid, oid).items())),
                sorted(st.omap_get(cid, oid).items()))
    return out


# ----------------------------------------- the seeded sequence, both ways

@pytest.mark.parametrize("compression", ["none", "zlib"])
@pytest.mark.parametrize("seed", [12, 16])
def test_seeded_transactions_equal_reference(tmp_path, seed, compression):
    txns = gen_txns(seed)
    res, views = {}, {}
    for kind in STORE:
        st = mk(kind, tmp_path / kind, compression=compression,
                comp_min_len=4096)
        res[kind] = run(kind, st, txns)
        views[kind] = observe(kind, st)
        st.umount()
    assert res["port"] == res["ref"]
    assert any(res["port"]) and not all(res["port"])
    assert views["port"] == views["ref"]
    files = tree(tmp_path / "port")
    assert set(files) >= {"block", os.path.join("kv", "kv.wal")}
    assert files == tree(tmp_path / "ref")


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_store_mounts_in_the_other_package(tmp_path, writer, reader):
    txns = gen_txns(13)
    st = mk(writer, tmp_path / "bs", compression="zlib", comp_min_len=4096)
    run(writer, st, txns[:30])
    want = observe(writer, st)
    st.umount()
    other = STORE[reader].BlueStore(str(tmp_path / "bs"), min_alloc=512,
                                    compression="zlib", comp_min_len=4096)
    other.mount()
    assert observe(reader, other) == want
    run(reader, other, txns[30:])
    want = observe(reader, other)
    other.umount()
    back = STORE[writer].BlueStore(str(tmp_path / "bs"), min_alloc=512)
    back.mount()
    assert observe(writer, back) == want
    back.umount()


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_journaled_store_equal_and_mounts_in_the_other(tmp_path, writer,
                                                       reader):
    txns = gen_txns(14, n=25)
    for kind in STORE:
        st = STORE[kind].JournaledStore(str(tmp_path / kind))
        st.mkfs()
        st.mount()
        run(kind, st, txns)
        st._wal.close()                  # a crash: no compaction
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    a = STORE[writer].JournaledStore(str(tmp_path / writer))
    a.mount()
    b = STORE[reader].JournaledStore(str(tmp_path / writer))
    b.mount()
    assert observe(reader, b) == observe(writer, a)


# ---------------------------- counterparts of tests/test_bluestore.py

def drive_mix(kind: str, st) -> list:
    """The reference's test_semantics_match_memstore op mix."""
    O, T = STORE[kind].ObjectId, STORE[kind].Transaction
    st.queue_transaction(T().create_collection("c"))
    st.queue_transaction(
        T().write("c", O("a"), 0, b"hello world")
        .write("c", O("a"), 6, b"WORLD")
        .setattrs("c", O("a"), {"k1": b"v1", "oi": {"size": 11}})
        .omap_setkeys("c", O("a"), {"m1": b"x", "m2": b"y"}))
    st.queue_transaction(
        T().write("c", O("b"), 4096, b"sparse-tail")
        .zero("c", O("b"), 4090, 8)
        .truncate("c", O("b"), 4100)
        .clone("c", O("a"), O("a2"))
        .omap_rmkeys("c", O("a"), ["m2"]))
    st.queue_transaction(
        T().write("c", O("a2"), 0, b"DIVERGED")
        .rmattr("c", O("a2"), "k1")
        .collection_move_rename("c", O("b"), "c", O("b2")))
    out = []
    for oid in st.collection_list("c"):
        out.append((str(oid), st.read("c", oid, 0, 0),
                    sorted(st.getattrs("c", oid).items(),
                           key=lambda kv: kv[0]),
                    sorted(st.omap_get("c", oid).items())))
    out.append(st.stat("c", O("a"))["size"])
    return out


def test_semantics_match_memstore(tmp_path):
    ms = port_store.MemStore()
    ms.mkfs()
    ms.mount()
    bs = mk("port", tmp_path)
    assert drive_mix("port", bs) == drive_mix("port", ms)
    ref = mk("ref", tmp_path / "ref")
    assert drive_mix("ref", ref) == drive_mix("port", mk("port",
                                                        tmp_path / "p2"))


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_failed_txn_leaves_store_untouched(tmp_path, kind):
    O, T = STORE[kind].ObjectId, STORE[kind].Transaction
    bs = mk(kind, tmp_path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", O("x"), 0, b"keep"))
    bad = T().write("c", O("x"), 0, b"clobber").remove("c", O("ghost"))
    with pytest.raises(STORE[kind].StoreError):
        bs.queue_transaction(bad)
    assert bs.read("c", O("x")) == b"keep"
    bs.umount()


@pytest.mark.parametrize("engine", ["bluestore", "journaled"])
def test_umount_remount_persists(tmp_path, engine):
    """(test_bluestore.py and test_journaled_store.py's
    test_umount_remount_persists)"""
    O, T = port_store.ObjectId, port_store.Transaction

    def make():
        if engine == "bluestore":
            return port_store.BlueStore(str(tmp_path / "s"), min_alloc=512)
        return port_store.JournaledStore(str(tmp_path / "s"))
    st = make()
    st.mkfs()
    st.mount()
    payload = np.random.default_rng(5).integers(
        0, 256, 20000, dtype=np.uint8).tobytes()
    st.queue_transaction(T().create_collection("c"))
    st.queue_transaction(
        T().write("c", O("big"), 0, payload)
        .setattrs("c", O("big"), {"oi": {"v": (1, 2)}})
        .omap_setkeys("c", O("big"), {"k": b"v"}))
    st.umount()
    st2 = make()
    st2.mount()
    assert bytes(st2.read("c", O("big"))) == payload
    assert st2.getattr("c", O("big"), "oi") == {"v": (1, 2)}
    assert st2.omap_get("c", O("big")) == {"k": b"v"}
    st2.umount()


KILL9 = """
import os, sys
sys.path.insert(0, {root!r})
from {pkg}.store import BlueStore, ObjectId, Transaction
st = BlueStore({path!r}, min_alloc=512)
st.mkfs(); st.mount()
st.queue_transaction(Transaction().create_collection("c"))
for i in range(20):
    st.queue_transaction(
        Transaction().write("c", ObjectId(f"o{{i}}"), 0,
                            f"payload-{{i}}".encode() * 50))
st.queue_transaction(
    Transaction().write("c", ObjectId("o3"), 0, b"OVERWRITE"))
st.queue_transaction(
    Transaction().write("c", ObjectId("o5"), 7, b"deferred"))
os._exit(9)          # kill -9: no umount, no atexit
"""


def test_kill9_replay_bounded(tmp_path):
    """Writes of a process that dies by os._exit (no umount) survive in
    both packages' stores, whose files are equal; the port's store
    replays from its KV wal tail."""
    for pkg, kind in (("ceph_tpu", "ref"), ("ceph_tpu_torch", "port")):
        proc = subprocess.run(
            [sys.executable, "-c", KILL9.format(
                root=ROOT, pkg=pkg, path=str(tmp_path / kind))],
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 9, proc.stderr
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    O = port_store.ObjectId
    bs = port_store.BlueStore(str(tmp_path / "port"), min_alloc=512)
    bs.mount()
    assert bs.read("c", O("o3"), 0, 9) == b"OVERWRITE"
    assert bs.read("c", O("o5"), 0, 15) == b"payload-deferre"[:7] + \
        b"deferred"
    for i in range(20):
        if i in (3, 5):
            continue
        assert bs.read("c", O(f"o{i}"), 0, 0) == \
            f"payload-{i}".encode() * 50
    assert bs.fsck() == []
    bs.umount()


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_bitrot_detected_on_read_and_fsck(tmp_path, kind):
    O, T = STORE[kind].ObjectId, STORE[kind].Transaction
    bs = mk(kind, tmp_path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", O("v"), 0, b"precious" * 100))
    assert bs.read("c", O("v"), 0, 8) == b"precious"
    bs.corrupt_blob_bytes("c", O("v"))
    with pytest.raises(STORE[kind].StoreError, match="checksum") as ei:
        bs.read("c", O("v"), 0, 8)
    assert ei.value.errno_name == "EIO"
    assert bs.media_errors == {"csum_errors": 1, "read_errors": 0}
    errs = bs.fsck()
    assert len(errs) == 1 and "csum mismatch" in errs[0]
    bs.umount()
    # the rot is on disk: a remount (by the other package too) finds it
    other = STORE["ref" if kind == "port" else "port"]
    again = other.BlueStore(str(tmp_path), min_alloc=512)
    again.mount()
    assert again.fsck() == errs
    again.umount()


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_injected_read_error(tmp_path, kind):
    from ceph_tpu.common.options import global_config as ref_cfg
    from ceph_tpu_torch.common.options import global_config as port_cfg
    cfg = {"ref": ref_cfg, "port": port_cfg}[kind]()
    O, T = STORE[kind].ObjectId, STORE[kind].Transaction
    bs = mk(kind, tmp_path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", O("v"), 0, b"data"))
    bs.inject_read_err("c", O("v"))
    assert bs.read("c", O("v")) == b"data"      # the option is off
    cfg.set("objectstore_debug_inject_read_err", True)
    try:
        with pytest.raises(STORE[kind].StoreError, match="injected"):
            bs.read("c", O("v"))
        bs.clear_read_err("c", O("v"))
        assert bs.read("c", O("v")) == b"data"
    finally:
        cfg.set("objectstore_debug_inject_read_err", False)
    assert bs.media_errors["read_errors"] == 1
    bs.umount()


def test_deferred_small_overwrite(tmp_path):
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path, deferred_max=512)
    bs.queue_transaction(T().create_collection("c"))
    base = bytes(range(256)) * 16       # 4 KiB blob
    bs.queue_transaction(T().write("c", O("d"), 0, base))
    blobs_before = len(bs._blobs)
    bs.queue_transaction(T().write("c", O("d"), 100, b"PATCH"))
    # in-place deferred write: no new blob allocated
    assert len(bs._blobs) == blobs_before
    want = base[:100] + b"PATCH" + base[105:]
    assert bs.read("c", O("d")) == want
    assert bs.fsck() == []              # csum updated with the patch
    bs.umount()
    bs2 = port_store.BlueStore(str(tmp_path), min_alloc=512,
                               deferred_max=512)
    bs2.mount()
    assert bs2.read("c", O("d")) == want
    bs2.umount()


def test_deferred_entry_replayed_at_mount(tmp_path):
    """A deferred entry still in the KV (a crash between the KV commit
    and the in-place write) is applied at mount and cleared, in both
    packages alike."""
    for kind in STORE:
        O, T = STORE[kind].ObjectId, STORE[kind].Transaction
        bs = mk(kind, tmp_path / kind, deferred_max=512)
        bs.queue_transaction(T().create_collection("c"))
        bs.queue_transaction(T().write("c", O("d"), 0, b"\0" * 4096))
        bs.queue_transaction(T().write("c", O("d"), 10, b"LATE"))
        # undo the in-place apply and put the entry back: the state a
        # crash right after the KV commit leaves
        start = bs._blobs[1]["units"][0] * bs.min_alloc
        bs._block.seek(start + 10)
        bs._block.write(b"\0" * 4)
        bs._block.flush()
        t = bs.db.transaction()
        t.set("D", f"{start + 10}.0", {"off": start + 10, "data": b"LATE"})
        bs.db.submit_transaction(t)
        with pytest.raises(STORE[kind].StoreError, match="checksum"):
            bs.read("c", O("d"))
        bs.umount()
        bs = STORE[kind].BlueStore(str(tmp_path / kind), min_alloc=512)
        bs.mount()
        assert bs.db.get_by_prefix("D") == {}
        assert bs.read("c", O("d"), 10, 4) == b"LATE"
        bs.umount()
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")


def test_compress_on_write(tmp_path):
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path, compression="zlib", comp_min_len=1024)
    bs.queue_transaction(T().create_collection("c"))
    data = b"A" * 65536                 # highly compressible
    bs.queue_transaction(T().write("c", O("z"), 0, data))
    assert bs.read("c", O("z")) == data
    blob = next(iter(bs._blobs.values()))
    assert blob["comp"] == "zlib"
    assert blob["stored"] < len(data) // 10
    # incompressible data stays raw
    noise = np.random.default_rng(1).integers(
        0, 256, 65536, dtype=np.uint8).tobytes()
    bs.queue_transaction(T().write("c", O("n"), 0, noise))
    assert bs.read("c", O("n")) == noise
    used = (bs._units - len(bs._free)) * bs.min_alloc
    assert used < len(data) + 2 * len(noise)
    bs.umount()


def test_blob_sharing_and_free(tmp_path):
    """Clones share blobs; rewriting/removing drops references and
    frees units back to the allocator."""
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", O("s"), 0, b"shared" * 200))
    bs.queue_transaction(T().clone("c", O("s"), O("t")))
    assert bs.read("c", O("t")) == b"shared" * 200
    used_before = bs._units - len(bs._free)
    bs.queue_transaction(T().remove("c", O("s")))
    assert bs.read("c", O("t")) == b"shared" * 200   # blob survives
    assert bs._units - len(bs._free) == used_before
    bs.queue_transaction(T().remove("c", O("t")))
    assert bs._units - len(bs._free) < used_before   # units freed
    bs.umount()


def test_blob_split_keeps_tail_alive(tmp_path):
    """Punching the middle of a blob splits its lextent in two; a later
    overwrite of the head must not free the blob while the tail still
    references it."""
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path, deferred_max=0)       # COW only
    bs.queue_transaction(T().create_collection("c"))
    base = bytes(range(256)) * 64           # 16 KiB -> blob A
    bs.queue_transaction(T().write("c", O("s"), 0, base))
    bs.queue_transaction(T().write("c", O("s"), 4096, b"M" * 4096))
    bs.queue_transaction(T().write("c", O("s"), 0, b"H" * 4096))
    want = b"H" * 4096 + b"M" * 4096 + base[8192:]
    assert bs.read("c", O("s")) == want
    assert bs.fsck() == []
    bs.umount()
    bs2 = port_store.BlueStore(str(tmp_path), min_alloc=512,
                               deferred_max=0)
    bs2.mount()
    assert bs2.read("c", O("s")) == want
    bs2.umount()


def test_two_deferred_writes_one_txn(tmp_path):
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path, deferred_max=512)
    bs.queue_transaction(T().create_collection("c"))
    base = bytes(range(256)) * 16           # 4 KiB blob
    bs.queue_transaction(T().write("c", O("d"), 0, base))
    bs.queue_transaction(T().write("c", O("d"), 0, b"AA")
                         .write("c", O("d"), 500, b"BB"))
    want = bytearray(base)
    want[0:2] = b"AA"
    want[500:502] = b"BB"
    assert bs.read("c", O("d")) == bytes(want)
    assert bs.fsck() == []


def test_failed_txn_returns_units(tmp_path):
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path)
    bs.queue_transaction(T().create_collection("c"))
    used_before = bs._units - len(bs._free)
    for _ in range(5):
        bad = T().write("c", O("x"), 0, b"data" * 1000) \
            .remove("c", O("ghost"))
        with pytest.raises(port_store.StoreError):
            bs.queue_transaction(bad)
    assert bs._units - len(bs._free) == used_before, \
        "failed transactions leaked allocator units"
    bs.umount()


@pytest.mark.parametrize("then_remove", [False, True],
                         ids=["clone-kept", "clone-removed"])
def test_clone_then_deferred_write_same_txn(tmp_path, then_remove):
    """A clone earlier in the same transaction shares the blob, so a
    small write must not patch it in place; with the clone removed in
    that transaction the blob is single-ref again and the deferred
    patch is legal (test_bluestore.py's two cases)."""
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path, deferred_max=4096)
    bs.queue_transaction(T().create_collection("c"))
    base = bytes(range(256)) * 16
    bs.queue_transaction(T().write("c", O("h"), 0, base))
    t = T().clone("c", O("h"), O("h.snap"))
    if then_remove:
        t.remove("c", O("h.snap"))
    bs.queue_transaction(t.write("c", O("h"), 0, b"X" * 512))
    if not then_remove:
        assert bs.read("c", O("h.snap")) == base
    assert bs.read("c", O("h")) == b"X" * 512 + base[512:]
    assert bs.fsck() == []
    bs.umount()
    bs2 = port_store.BlueStore(str(tmp_path), min_alloc=512)
    bs2.mount()
    assert bs2.exists("c", O("h.snap")) != then_remove
    assert bs2.read("c", O("h")) == b"X" * 512 + base[512:]
    bs2.umount()


def test_statfs_disk_backed_capacity(tmp_path):
    from ceph_tpu_torch.common.options import global_config
    O, T = port_store.ObjectId, port_store.Transaction
    bs = mk("port", tmp_path)
    bs.queue_transaction(T().create_collection("c"))
    bs.queue_transaction(T().write("c", O("big"), 0, b"z" * (1 << 16)))
    st = bs.statfs()
    assert st["used"] <= st["total"]
    assert st["available"] == st["total"] - st["used"]
    global_config().set("bluestore_device_bytes", 1 << 20)
    try:
        st = bs.statfs()
        assert st["total"] == 1 << 20
        assert st["used"] <= st["total"]
    finally:
        global_config().set("bluestore_device_bytes", 0)
    bs.umount()


# ------------------------ counterparts of tests/test_journaled_store.py

def make_journaled(path):
    st = port_store.JournaledStore(str(path))
    st.mkfs()
    st.mount()
    return st


def test_crash_replay_from_journal(tmp_path):
    O, T = port_store.ObjectId, port_store.Transaction
    st = make_journaled(tmp_path / "s")
    st.queue_transaction(T().create_collection("c"))
    for i in range(10):
        st.queue_transaction(T().write("c", O(f"o{i}"), 0,
                                       bytes([i]) * 100))
    st._wal.close()                      # a crash: no compaction
    st2 = port_store.JournaledStore(str(tmp_path / "s"))
    st2.mount()
    for i in range(10):
        assert bytes(st2.read("c", O(f"o{i}"), 0, 0)) == bytes([i]) * 100
    # mount compacted: the journal is empty, the snapshot holds it all
    assert os.path.getsize(st2._wal_path) == 0
    st3 = port_store.JournaledStore(str(tmp_path / "s"))
    st3.mount()
    assert bytes(st3.read("c", O("o3"), 0, 0)) == b"\x03" * 100


def test_torn_journal_tail_ignored(tmp_path):
    O, T = port_store.ObjectId, port_store.Transaction
    st = make_journaled(tmp_path / "s")
    st.queue_transaction(T().create_collection("c"))
    st.queue_transaction(T().write("c", O("good"), 0, b"ok"))
    st._wal.close()
    with open(st._wal_path, "ab") as f:
        f.write(b"\x40\x00\x00\x00TORN")
    st2 = port_store.JournaledStore(str(tmp_path / "s"))
    st2.mount()
    assert bytes(st2.read("c", O("good"), 0, 0)) == b"ok"
    assert not st2.exists("c", O("torn"))


def test_failed_txn_not_journaled(tmp_path):
    O, T = port_store.ObjectId, port_store.Transaction
    st = make_journaled(tmp_path / "s")
    st.queue_transaction(T().create_collection("c"))
    size = os.path.getsize(st._wal_path)
    with pytest.raises(port_store.StoreError):
        st.queue_transaction(T().remove("c", O("nope")))
    assert os.path.getsize(st._wal_path) == size


def test_legacy_pickle_store_refused(tmp_path):
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "snapshot.pkl").write_bytes(b"not loaded")
    with pytest.raises(port_store.StoreError, match="legacy"):
        port_store.JournaledStore(str(tmp_path / "s")).mount()


@pytest.mark.parametrize("engine", ["bluestore", "journaled"])
def test_osd_restart_with_durable_store(tmp_path, engine):
    """An OSD killed (no umount) and revived on a store freshly mounted
    on the same directory serves its shards: with one other OSD of the
    k=2 m=1 pool down, every read needs them (the reference's
    test_osd_restart_with_durable_store, on an EC pool)."""
    from ceph_tpu_torch.testing import MiniCluster

    def open_store():
        if engine == "bluestore":
            st = port_store.BlueStore(str(tmp_path / "osd1"))
            st.mkfs()
        else:
            st = port_store.JournaledStore(str(tmp_path / "osd1"))
        st.mount()
        return st
    c = MiniCluster(n_osd=3, threaded=False, device="cpu")
    try:
        c.pump()
        c.kill_osd(1)
        c._stores[1] = open_store()
        c.start_osd(1)
        c.pump()
        c.wait_all_up()
        r = c.rados()
        r.pool_create("p", pg_num=8, pool_type="erasure")
        io = r.open_ioctx("p")
        for i in range(8):
            io.write_full(f"obj{i}", bytes([i]) * 500)
        c.pump()
        c.kill_osd(1)
        c._stores[1] = open_store()
        c.start_osd(1)
        c.pump()
        for _ in range(10):
            c.pump()
            if all(d.pgs_recovering() == 0 for d in c.osds.values()):
                break
        c.kill_osd(2)
        assert r.mon_command({"prefix": "osd down", "ids": [2]})[0] == 0
        c.pump()
        for i in range(8):
            assert io.read(f"obj{i}") == bytes([i]) * 500
    finally:
        c.shutdown()
