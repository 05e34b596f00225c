"""The port's durable mon store (`ceph_tpu_torch.mon.store.MonitorStore`
over `ceph_tpu_torch.kv.LogDB`) held to the reference's.

* The same store transactions (puts, erases, erase_range trims) on both
  packages' KV-backed stores give equal contents, equal `kv.wal` bytes,
  and each package reopens the other's directory.
* A mon made on a LogDB, given commands, shut down and made again on
  that directory resumes at the same epoch with the same pools and EC
  profiles, as the reference's does (tests/test_mon_durable.py).
* A pump-mode cluster (`MiniCluster(threaded=False)`, 7 OSDs, a `tpu`
  k=2 m=2 pool) whose mon runs on a LogDB, is killed and revived on it,
  equals the reference's cluster step by step: after the writes, after
  the mon's death, after its revival, after an OSD marked down and a
  second pool made through the revived mon: the mon's epoch, its
  committed osdmap keys and full maps (as wire bytes), the pools, the
  profiles and, before the change, the reads.  Only the port's client
  then catches up with the revived mon (the reference's mon never
  hears of the subscriptions it lost; mon/monitor.py has the port's
  rule), and it reads on.  The reference's revived mon is made without
  the keyring, so cephx after a revival is checked on the port alone:
  a cephx cluster's mon is killed and revived, and a new client
  authenticates against it, writes and reads, with no signature
  rejected.
The multi-process SIGKILL of a mon on its --data-dir (the reference's
slow test_multiprocess_mon_kill9_restart) is in
tests/test_torch_daemon_main.py.
"""
import hashlib

import numpy as np
import pytest

import ceph_tpu.mon.monitor as ref_monitor_mod
from ceph_tpu.kv import LogDB as RefLogDB
from ceph_tpu.mon.store import MonitorStore as RefStore
from ceph_tpu.mon.store import StoreTransaction as RefTx
from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.kv import LogDB as PortLogDB
from ceph_tpu_torch.mon.store import MonitorStore as PortStore
from ceph_tpu_torch.mon.store import StoreTransaction as PortTx
from ceph_tpu_torch.msg import encoding as port_wire
from ceph_tpu_torch.testing import MiniCluster as PortCluster

LOGDB = {"ref": RefLogDB, "port": PortLogDB}
STORE = {"ref": RefStore, "port": PortStore}
TX = {"ref": RefTx, "port": PortTx}
WIRE = {"ref": ref_wire, "port": port_wire}
PROFILE = {"plugin": "tpu", "k": "2", "m": "2",
           "crush-failure-domain": "host"}


def txns(kind: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for v in range(1, 40):
        tx = TX[kind]()
        tx.put("osdmap", v, rng.bytes(int(rng.integers(10, 200))))
        tx.put("osdmap", "last_committed", v)
        tx.put("paxos", v, rng.bytes(int(rng.integers(10, 100))))
        if v % 7 == 0:
            tx.erase_range("paxos", 0, v - 5)
            tx.put("paxos", "first_committed", v - 5)
        if v % 11 == 0:
            tx.erase("osdmap", v - 3)
        out.append(tx)
    return out


def test_kv_backed_store_persists(tmp_path):
    """(tests/test_mon_durable.py::test_kv_backed_store_persists)"""
    st = PortStore(PortLogDB(str(tmp_path / "mon")))
    tx = PortTx()
    tx.put("osdmap", "last_committed", 7)
    tx.put("osdmap", "full_7", b"blob")
    tx.put("paxos", "3", b"v3")
    st.apply_transaction(tx)
    tx = PortTx()
    tx.erase_range("paxos", 0, 3)
    st.apply_transaction(tx)
    st.db.close()
    st2 = PortStore(PortLogDB(str(tmp_path / "mon")))
    assert not st2.empty
    assert st2.get("osdmap", "last_committed") == 7
    assert st2.get("osdmap", "full_7") == b"blob"
    assert st2.get("paxos", "3") == b"v3"
    st2.db.close()


@pytest.mark.parametrize("seed", [1, 2])
def test_store_equals_reference_and_cross_opens(tmp_path, seed):
    stores = {}
    for kind in STORE:
        st = STORE[kind](LOGDB[kind](str(tmp_path / kind)))
        for tx in txns(kind, seed):
            st.apply_transaction(tx)
        stores[kind] = st
    assert stores["port"]._data == stores["ref"]._data
    assert list(stores["port"].keys("paxos")) == \
        list(stores["ref"].keys("paxos"))
    assert stores["port"].export_data() == stores["ref"].export_data()
    for st in stores.values():
        st.db.close()
    wal = {kind: hashlib.sha256((tmp_path / kind / "kv.wal").read_bytes())
           .hexdigest() for kind in STORE}
    assert wal["port"] == wal["ref"]
    for writer, reader in (("ref", "port"), ("port", "ref")):
        st = STORE[reader](LOGDB[reader](str(tmp_path / writer)))
        assert st._data == stores[writer]._data
        st.db.close()


def test_import_data_replaces_the_durable_store(tmp_path):
    """A full sync replaces the whole store, on disk too: stale keys do
    not come back after a restart (both packages alike)."""
    for kind in STORE:
        st = STORE[kind](LOGDB[kind](str(tmp_path / kind)))
        for tx in txns(kind, 3):
            st.apply_transaction(tx)
        src = STORE[kind]()
        tx = TX[kind]()
        tx.put("osdmap", "last_committed", 99)
        src.apply_transaction(tx)
        st.import_data(src.export_data())
        st.db.close()
        again = STORE[kind](LOGDB[kind](str(tmp_path / kind)))
        assert again._data == {("osdmap", "last_committed"): 99}
        again.db.close()


def test_mon_resumes_from_kv_store(tmp_path):
    """(tests/test_mon_durable.py::test_mon_resumes_from_kv_store, with
    an EC profile): pools, profiles and the epoch survive the restart,
    and the restarted mon bootstraps nothing."""
    from ceph_tpu_torch.mon.monitor import Monitor, build_initial
    from ceph_tpu_torch.msg.messenger import LocalNetwork
    m, w = build_initial(3, osds_per_host=1)
    store = PortStore(PortLogDB(str(tmp_path / "mon")))
    mon = Monitor(LocalNetwork(), rank=0, initial_map=m, initial_wrapper=w,
                  store=store, threaded=False, device="cpu")
    mon.init()
    replies = []
    for cmd in ({"prefix": "osd erasure-code-profile set", "name": "p",
                 "profile": {"plugin": "tpu", "k": "2", "m": "1"}},
                {"prefix": "osd pool create", "pool": "persist",
                 "pg_num": 8, "pool_type": "erasure",
                 "erasure_code_profile": "p"}):
        mon._dispatch_command(cmd, lambda r, outs, outb: replies.append(r))
    assert replies == [0, 0]
    epoch, want = mon.osdmap.epoch, port_wire.encode(mon.osdmap)
    mon.shutdown()
    store.db.close()
    store2 = PortStore(PortLogDB(str(tmp_path / "mon")))
    mon2 = Monitor(LocalNetwork(), rank=0, store=store2, threaded=False,
                   device="cpu")
    mon2.init()
    assert mon2.osdmap.epoch == epoch
    assert port_wire.encode(mon2.osdmap) == want
    assert "persist" in mon2.osdmap.pool_names.values()
    assert "p" in mon2.osdmap.erasure_code_profiles
    mon2.shutdown()
    store2.db.close()


# ------------------------------------------- the cluster, step by step

def mon_view(kind: str, c, r, objs: dict) -> dict:
    mon = c.mons[0]
    m = mon.osdmap
    io = r.open_ioctx("ec")
    osdmap_keys = {k: WIRE[kind].encode(mon.store.get("osdmap", k))
                   for k in mon.store.keys("osdmap")}
    return {"epoch": m.epoch, "map": WIRE[kind].encode(m),
            "osdmap_keys": osdmap_keys,
            "pools": sorted(m.pool_names.values()),
            "profiles": {k: dict(v) for k, v in
                         m.erasure_code_profiles.items()},
            "up": [o for o in range(m.max_osd) if m.is_up(o)],
            "reads": {oid: io.read(oid) for oid in objs}}


def scenario(kind: str, root, monkeypatch) -> list:
    path = str(root / kind)
    if kind == "ref":
        # the reference's MiniCluster takes no mon store: its mon makes
        # one, and this makes that one durable
        monkeypatch.setattr(ref_monitor_mod, "MonitorStore",
                            lambda: RefStore(RefLogDB(path)))
        c = RefCluster(n_osd=7, threaded=False)
        monkeypatch.undo()
    else:
        c = PortCluster(n_osd=7, threaded=False, device="cpu",
                        mon_store=PortStore(PortLogDB(path)))
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        assert r.mon_command({"prefix": "osd erasure-code-profile set",
                              "name": "ecp",
                              "profile": dict(PROFILE)})[0] == 0
        r.pool_create("ec", pg_num=8, pool_type="erasure",
                      erasure_code_profile="ecp")
        c.pump()
        rng = np.random.default_rng(4)
        objs = {f"o{i}": rng.bytes(1000 + 77 * i) for i in range(6)}
        io = r.open_ioctx("ec")
        for oid, data in objs.items():
            io.write_full(oid, data)
        c.pump()
        steps = [("written", mon_view(kind, c, r, objs))]
        c.kill_mon(0)
        # a fresh store object on the directory: what a restarted
        # process opens
        c._mon_stores[0] = STORE[kind](LOGDB[kind](path))
        mon = c.revive_mon(0)
        if kind == "ref":
            c.mon = mon
        c.pump()
        steps.append(("revived", mon_view(kind, c, r, objs)))
        c.kill_osd(3)
        # commands straight to the mon: the reference's revived mon
        # never hears of the subscriptions its predecessor held, so its
        # client would wait for maps in vain (the port's mon adopts the
        # client on its command; see mon/monitor.py)
        assert r.mon_command({"prefix": "osd down", "ids": [3]})[0] == 0
        assert r.mon_command({"prefix": "osd pool create", "pool": "ec2",
                              "pg_num": 4, "pool_type": "erasure",
                              "erasure_code_profile": "ecp"})[0] == 0
        c.pump()
        steps.append(("changed", mon_view(kind, c, r, {})))
        if kind == "port":
            steps.append(("client", (r.objecter.osdmap.epoch, [
                io.read(oid) == data for oid, data in objs.items()])))
        return steps
    finally:
        c.shutdown()


def test_mon_killed_and_revived_equals_reference(tmp_path, monkeypatch):
    ref = scenario("ref", tmp_path, monkeypatch)
    port = scenario("port", tmp_path, monkeypatch)
    assert [s for s, _ in port] == [s for s, _ in ref] + ["client"]
    for (step, want), (_, got) in zip(ref, port):
        for key in want:
            assert got[key] == want[key], (step, key)
    views = dict(port)
    assert views["revived"]["epoch"] == views["written"]["epoch"]
    assert views["changed"]["epoch"] == views["revived"]["epoch"] + 2
    assert 3 not in views["changed"]["up"]
    assert views["changed"]["pools"] == ["ec", "ec2"]
    # the port's client caught up with the revived mon and reads on
    assert views["client"] == (views["changed"]["epoch"],
                               [True] * len(views["written"]["reads"]))


def test_cephx_after_mon_revival(tmp_path):
    """Port only (see the module docstring): a cephx cluster's mon on a
    LogDB is killed and revived; the daemons' and a new client's
    signatures verify against it and IO goes on."""
    path = str(tmp_path / "mon")
    c = PortCluster(n_osd=4, threaded=False, device="cpu", auth="cephx",
                    mon_store=PortStore(PortLogDB(path)))
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        assert r.mon_command({"prefix": "osd erasure-code-profile set",
                              "name": "p", "profile": {
                                  "plugin": "tpu", "k": "2", "m": "1",
                                  "crush-failure-domain": "host"}})[0] == 0
        r.pool_create("ec", pg_num=4, pool_type="erasure",
                      erasure_code_profile="p")
        r.open_ioctx("ec").write_full("before", b"b" * 3000)
        epoch = c.mon.osdmap.epoch
        c.kill_mon(0)
        c._mon_stores[0] = PortStore(PortLogDB(path))
        mon = c.revive_mon(0)
        assert mon.osdmap.epoch == epoch and mon.cephx is not None
        r2 = c.rados()
        io2 = r2.open_ioctx("ec")
        assert io2.read("before") == b"b" * 3000
        io2.write_full("after", b"a" * 2000)
        assert r.open_ioctx("ec").read("after") == b"a" * 2000
        assert mon.ms.auth_verifier.verified > 0
        assert mon.ms.auth_verifier.rejected == 0
    finally:
        c.shutdown()
