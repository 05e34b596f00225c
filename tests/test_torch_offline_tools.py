"""The port's offline tools (`ceph_tpu_torch.tools.objectstore_tool`,
`ceph_tpu_torch.tools.monstore_tool`) held to the reference's CLIs.

A pump-mode port cluster with BlueStore OSDs and a mon on a LogDB writes
an EC pool and stops.  On the same directories, each verb of both
packages' tools prints the same text and returns the same code:
`--op list` (PGs, and the objects of one), `info`, `fsck` (clean, then
with one bitrotted blob), `export` (whose blobs are equal byte for
byte) and, on copies of the directory, `import` and `remove` (after
which the copies' files are equal); and the mon tool's `dump`,
`show-versions`, `get`, `get-osdmap` and `rebuild` (whose output
directories are equal).  The snap verbs the port does not carry yet are
refused in one line.  Then the reference's PG-rescue flow
(tests/test_offline_tools.py::test_pg_export_import_rescues_killed_osd)
runs on an EC pool: every PG of a killed OSD is exported from its store
into a fresh one, the OSD is revived on it and peers from the imported
history, and every object reads back with that OSD's shards needed.
"""
import hashlib
import os
import shutil

import numpy as np
import pytest

from ceph_tpu.tools import monstore_tool as ref_mon_tool
from ceph_tpu.tools import objectstore_tool as ref_os_tool
from ceph_tpu_torch.kv import LogDB
from ceph_tpu_torch.mon.store import MonitorStore
from ceph_tpu_torch.osd.types import PG
from ceph_tpu_torch.store import BlueStore, ObjectId
from ceph_tpu_torch.testing import MiniCluster
from ceph_tpu_torch.tools import monstore_tool as port_mon_tool
from ceph_tpu_torch.tools import objectstore_tool as port_os_tool

OS_TOOL = {"ref": ref_os_tool, "port": port_os_tool}
MON_TOOL = {"ref": ref_mon_tool, "port": port_mon_tool}
PROFILE = {"plugin": "tpu", "k": "2", "m": "1",
           "crush-failure-domain": "host"}


def tree(path) -> dict:
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def mount(path) -> BlueStore:
    st = BlueStore(str(path))
    st.mkfs()
    st.mount()
    return st


def cluster(root, n_osd: int = 4) -> MiniCluster:
    c = MiniCluster(n_osd=n_osd, threaded=False, device="cpu",
                    mon_store=MonitorStore(LogDB(str(root / "mon"))))
    c.pump()
    for osd in range(n_osd):
        c.kill_osd(osd)
        c._stores[osd] = mount(root / f"osd{osd}")
        c.start_osd(osd)
    c.pump()
    c.wait_all_up()
    return c


def ec_pool(c, objects: int, seed: int):
    r = c.rados()
    assert r.mon_command({"prefix": "osd erasure-code-profile set",
                          "name": "ecp", "profile": dict(PROFILE)})[0] == 0
    r.pool_create("ec", pg_num=4, pool_type="erasure",
                  erasure_code_profile="ecp")
    io = r.open_ioctx("ec")
    rng = np.random.default_rng(seed)
    objs = {f"s{i}": rng.bytes(1024 + 61 * i) for i in range(objects)}
    for k, v in objs.items():
        io.write_full(k, v)
    c.pump()
    return r, io, objs


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A stopped cluster's data dirs: osd0..osd3 and mon."""
    root = tmp_path_factory.mktemp("offline")
    c = cluster(root)
    try:
        ec_pool(c, 12, seed=3)
    finally:
        c.shutdown()
    for st in c._stores.values():
        st.umount()
    c.mons[0].store.db.close()
    return root


def cli(capsys, kind: str, tool: str, argv: list[str]):
    mod = (OS_TOOL if tool == "os" else MON_TOOL)[kind]
    try:
        rc = mod.main(argv)
    except SystemExit as ex:
        rc = ex.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def both(capsys, tool: str, argv: list[str]):
    got = {kind: cli(capsys, kind, tool, argv) for kind in ("ref", "port")}
    assert got["port"] == got["ref"], argv
    return got["port"]


def first_pg(dirs) -> str:
    st = BlueStore(str(dirs / "osd0"))
    st.mount()
    try:
        return port_os_tool.list_pgs(st)[0]
    finally:
        st.umount()


def test_objectstore_tool_text_equals_reference(dirs, capsys):
    data = ["--data-path", str(dirs / "osd0")]
    before = tree(dirs / "osd0")
    rc, out, _ = both(capsys, "os", data + ["--op", "list"])
    assert rc == 0 and out.split()
    pgid = out.split()[0]
    rc, out, _ = both(capsys, "os", data + ["--op", "list", "--pgid", pgid])
    assert rc == 0 and "pgmeta" in out
    rc, out, _ = both(capsys, "os", data + ["--op", "info", "--pgid", pgid])
    assert rc == 0 and '"log_entries"' in out
    rc, out, _ = both(capsys, "os", data + ["--op", "fsck"])
    assert (rc, out) == (0, "fsck: 0 error(s)\n")
    rc, _, err = both(capsys, "os", data + ["--op", "info", "--pgid",
                                            "9.ff"])
    assert rc == 1 and "ENOENT" in err
    assert tree(dirs / "osd0") == before     # reading wrote nothing


def test_export_blobs_equal_and_import_remove_equal(dirs, tmp_path, capsys):
    pgid = first_pg(dirs)
    blobs = {}
    for kind in ("ref", "port"):
        f = tmp_path / f"{kind}.export"
        rc, out, _ = cli(capsys, kind, "os", [
            "--data-path", str(dirs / "osd0"), "--op", "export", "--pgid",
            pgid, "--file", str(f)])
        assert rc == 0 and out == f"exported {pgid}: {f.stat().st_size} " \
            "bytes\n"
        blobs[kind] = f.read_bytes()
    assert blobs["port"] == blobs["ref"]
    # import into, then remove from, a copy of another OSD's store
    for kind in ("ref", "port"):
        shutil.copytree(dirs / "osd1", tmp_path / f"{kind}-osd1")
        data = ["--data-path", str(tmp_path / f"{kind}-osd1")]
        rc, out, err = cli(capsys, kind, "os", data + [
            "--op", "import", "--file", str(tmp_path / "port.export")])
        if rc == 1:                  # the PG is there already: force it
            assert "EEXIST" in err
            rc, out, err = cli(capsys, kind, "os", data + [
                "--op", "import", "--force", "--file",
                str(tmp_path / "port.export")])
        assert (rc, out) == (0, f"imported {pgid}\n"), err
        rc, out, _ = cli(capsys, kind, "os", data + [
            "--op", "remove", "--pgid", pgid])
        assert rc == 0 and out.startswith(f"removed {pgid}: ")
    assert tree(tmp_path / "port-osd1") == tree(tmp_path / "ref-osd1")


def test_fsck_reports_the_bitrotted_blob(dirs, tmp_path, capsys):
    shutil.copytree(dirs / "osd2", tmp_path / "osd2")
    st = BlueStore(str(tmp_path / "osd2"))
    st.mount()
    pgid = port_os_tool.list_pgs(st)[0]
    cid = f"pg_{pgid}"
    victim = next(o for o in st.collection_list(cid) if o.name != "pgmeta")
    st.corrupt_blob_bytes(cid, victim)
    st.umount()
    rc, out, _ = both(capsys, "os", ["--data-path", str(tmp_path / "osd2"),
                                     "--op", "fsck"])
    lines = out.splitlines()
    assert rc == 1 and len(lines) == 2 and lines[-1] == "fsck: 1 error(s)"
    assert lines[0].startswith(f"{cid}/{victim}: csum mismatch in blob ")


@pytest.mark.parametrize("op", ["list-snaps", "dump-snap-index"])
def test_snap_verbs_refused_in_one_line(dirs, op):
    with pytest.raises(SystemExit) as ei:
        port_os_tool.main(["--data-path", str(dirs / "osd0"), "--op", op,
                           "--pgid", "1.0"])
    msg = str(ei.value.code)
    assert f"--op {op}" in msg and "not ported yet" in msg and \
        "\n" not in msg


def test_monstore_tool_text_equals_reference(dirs, tmp_path, capsys):
    mon = str(dirs / "mon")
    before = tree(mon)
    for argv in ([mon, "dump"], [mon, "show-versions"],
                 [mon, "get", "--prefix", "osdmap", "--key",
                  "last_committed"],
                 [mon, "get", "--prefix", "osdmap", "--key", "nothing"],
                 [mon, "get-osdmap"], [mon, "get-osdmap", "--epoch", "2"]):
        rc, out, err = both(capsys, "mon", argv)
        assert rc == (1 if "nothing" in argv else 0), (argv, err)
    assert tree(mon) == before
    store = port_mon_tool._load(mon)
    summary = port_mon_tool.get_osdmap(store)
    store.db.close()
    assert summary["pools"] and summary["up"] == [0, 1, 2, 3]
    for kind in ("ref", "port"):
        rc, out, _ = cli(capsys, kind, "mon", [
            mon, "rebuild", "--out", str(tmp_path / kind)])
        assert rc == 0 and out.startswith("rebuilt ")
    assert tree(tmp_path / "port") == tree(tmp_path / "ref")
    # a rebuilt store boots a mon at the same epoch
    rebuilt = port_mon_tool._load(str(tmp_path / "port"))
    assert rebuilt.get_int("osdmap", "last_committed") == summary["epoch"]
    rebuilt.db.close()


def test_pg_export_import_rescues_killed_osd_on_ec(tmp_path):
    c = cluster(tmp_path, n_osd=4)
    try:
        r, io, objs = ec_pool(c, 16, seed=5)
        victim = 1
        c.kill_osd(victim)
        assert r.mon_command({"prefix": "osd down", "ids": [victim]})[0] \
            == 0
        c.pump()
        # offline surgery: every PG the dead OSD held moves to a
        # brand-new store (the disk-swap flow)
        old = c._stores[victim]
        fresh = mount(tmp_path / "osd-fresh")
        moved = 0
        for pgs in port_os_tool.list_pgs(old):
            pool_s, ps_s = pgs.split(".")
            blob = port_os_tool.export_pg(old, PG(int(pool_s),
                                                 int(ps_s, 16)))
            port_os_tool.import_pg(fresh, blob)
            moved += 1
        assert moved >= 1
        want = {(cid, o): old.read(cid, o)
                for cid in old.list_collections()
                for o in old.collection_list(cid)}
        old.umount()
        assert {(cid, o): fresh.read(cid, o)
                for cid in fresh.list_collections()
                for o in fresh.collection_list(cid)} == want
        c._stores[victim] = fresh
        c.revive_osd(victim)
        for _ in range(80):
            c.pump()
            if c.mon.osdmap.is_up(victim) and all(
                    d.pgs_recovering() == 0 for d in c.osds.values()):
                break
        assert all(d.pgs_recovering() == 0 for d in c.osds.values())
        assert sum(d.perf.get("recovery_full_rebuild")
                   for d in c.osds.values()) == 0
        # with another OSD down, reads need the imported shards
        c.kill_osd(2)
        assert r.mon_command({"prefix": "osd down", "ids": [2]})[0] == 0
        c.pump()
        for k, v in objs.items():
            assert io.read(k) == v, k
        assert any(cid.startswith("pg_")
                   for cid in c.osds[victim].store.list_collections())
        assert c.osds[victim].store.exists(
            next(cid for cid in fresh.list_collections()),
            ObjectId("pgmeta"))
    finally:
        c.shutdown()
