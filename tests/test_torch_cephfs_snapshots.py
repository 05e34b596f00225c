"""The port's snapshots held to the reference's at tolerance 0: every case
of tests/test_cephfs_snapshots.py runs on each package (the harness of
tests/test_torch_cephfs.py) on a replicated data pool, as the
reference's do, with the reference's assertions; the replies, both
pools (the snap table, the snapped dirfrags, every data object and its
clones) must be equal.  `test_concurrent_writers_and_snap` races two
writer threads against the snapshot: it runs on a cluster of its own
and the sides must agree on what the race keeps (the snapshot's names,
each file's frozen size equal to its bytes, each a 5-digit count or
empty).
"""
import threading
import time

import pytest

from test_torch_cephfs import (bare_sides, close_sides, fs_state,  # noqa: F401
                               run_both, sides_with)


@pytest.fixture(scope="module")
def sides():
    out, mp = sides_with()
    yield out
    close_sides(out, mp)


def c_snap_freezes_data_and_size(s):
    fs = s.new_fs()
    fs.mkdirs("/s1d")
    fs.write_file("/s1d/f", b"before the snapshot")
    fs.mksnap("/s1d", "epoch1")
    fs.write_file("/s1d/f", b"AFTER")
    assert fs.read_file("/s1d/f") == b"AFTER"
    assert fs.read_file("/s1d/.snap/epoch1/f") == b"before the snapshot"
    assert fs.stat("/s1d/.snap/epoch1/f")["size"] == \
        len(b"before the snapshot")


def test_snap_freezes_data_and_size(sides):
    run_both(sides, c_snap_freezes_data_and_size)


def c_snap_namespace_frozen(s):
    fs = s.new_fs()
    fs.mkdirs("/s2d/sub")
    fs.write_file("/s2d/keep", b"kept bytes")
    fs.write_file("/s2d/gone", b"doomed bytes")
    fs.write_file("/s2d/sub/deep", b"deep bytes")
    fs.mksnap("/s2d", "frozen")
    fs.write_file("/s2d/newfile", b"post-snap")
    fs.unlink("/s2d/gone")
    fs.rename("/s2d/keep", "/s2d/renamed")
    names = set(fs.listdir("/s2d/.snap/frozen"))
    assert names == {"keep", "gone", "sub"}
    assert fs.read_file("/s2d/.snap/frozen/gone") == b"doomed bytes"
    assert fs.read_file("/s2d/.snap/frozen/keep") == b"kept bytes"
    assert fs.read_file("/s2d/.snap/frozen/sub/deep") == b"deep bytes"
    assert not fs.exists("/s2d/.snap/frozen/newfile")
    assert fs.exists("/s2d/renamed")
    return sorted(names)


def test_snap_namespace_frozen(sides):
    run_both(sides, c_snap_namespace_frozen)


def c_snapdir_listing_and_lssnap(s):
    fs = s.new_fs()
    fs.mkdirs("/s3d")
    fs.write_file("/s3d/x", b"x")
    fs.mksnap("/s3d", "a")
    fs.mksnap("/s3d", "b")
    assert set(fs.listdir("/s3d/.snap")) == {"a", "b"}
    assert set(fs.lssnap("/s3d")) == {"a", "b"}
    with pytest.raises(s.p.CephFSError):
        fs.mksnap("/s3d", "a")
    fs.rmsnap("/s3d", "a")
    assert set(fs.listdir("/s3d/.snap")) == {"b"}
    with pytest.raises(s.p.CephFSError):
        fs.read_file("/s3d/.snap/a/x")
    return fs.lssnap("/s3d")


def test_snapdir_listing_and_lssnap(sides):
    run_both(sides, c_snapdir_listing_and_lssnap)


def c_snapshots_read_only(s):
    fs = s.new_fs()
    fs.mkdirs("/s4d")
    fs.write_file("/s4d/f", b"data")
    fs.mksnap("/s4d", "ro")
    errs = []
    for fn in (lambda: fs.write_file("/s4d/.snap/ro/f", b"no"),
               lambda: fs.unlink("/s4d/.snap/ro/f"),
               lambda: fs.mkdir("/s4d/.snap/ro/d"),
               lambda: fs.rename("/s4d/.snap/ro/f", "/s4d/z")):
        with pytest.raises(s.p.CephFSError) as ei:
            fn()
        assert ei.value.errno_name in ("EROFS",)
        errs.append(ei.value.errno_name)
    fh = fs.open("/s4d/.snap/ro/f", "r")
    assert fh.read(0) == b"data"
    with pytest.raises(s.p.CephFSError):
        fh.write(0, b"nope")
    fh.close()
    return errs


def test_snapshots_read_only(sides):
    run_both(sides, c_snapshots_read_only)


def c_open_handle_cows_after_snap(s):
    fs = s.new_fs()
    fs.mkdirs("/s5d")
    fh = fs.open("/s5d/live", "w")
    fh.write(0, b"v1-original-bytes")
    fs.mksnap("/s5d", "mid")
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and fh._io.write_snapc is None:
        time.sleep(0.02)
    assert fh._io.write_snapc is not None
    fh.write(0, b"V2-OVERWRITTEN!!!")
    fh.close()
    assert fs.read_file("/s5d/live") == b"V2-OVERWRITTEN!!!"
    assert fs.read_file("/s5d/.snap/mid/live") == b"v1-original-bytes"
    return fh._io.write_snapc


def test_open_handle_cows_after_snap(sides):
    run_both(sides, c_open_handle_cows_after_snap)


def c_nested_realms_union_snapc(s):
    fs = s.new_fs()
    fs.mkdirs("/s6d/inner")
    fs.write_file("/s6d/inner/f", b"gen0")
    fs.mksnap("/s6d", "outer0")
    fs.write_file("/s6d/inner/f", b"gen1")
    fs.mksnap("/s6d/inner", "inner1")
    fs.write_file("/s6d/inner/f", b"gen2")
    assert fs.read_file("/s6d/inner/f") == b"gen2"
    assert fs.read_file("/s6d/.snap/outer0/inner/f") == b"gen0"
    assert fs.read_file("/s6d/inner/.snap/inner1/f") == b"gen1"


def test_nested_realms_union_snapc(sides):
    run_both(sides, c_nested_realms_union_snapc)


def c_unlink_after_snap_preserves_snap_data(s):
    fs = s.new_fs()
    fs.mkdirs("/s7d")
    fs.write_file("/s7d/victim", b"survives in the snap")
    fs.mksnap("/s7d", "pre")
    fs.unlink("/s7d/victim")
    assert not fs.exists("/s7d/victim")
    assert fs.read_file("/s7d/.snap/pre/victim") == \
        b"survives in the snap"


def test_unlink_after_snap_preserves_snap_data(sides):
    run_both(sides, c_unlink_after_snap_preserves_snap_data)


def c_concurrent_writers_and_snap(s):
    c = s.cluster(n_osd=4)
    mds = s.p.MDSDaemon(c.network, c.rados())
    mds.init()
    fs = s.new_fs(c)
    fs.mkdirs("/s8d")
    stop = threading.Event()
    started = [threading.Event(), threading.Event()]

    def writer(idx):
        wfs = s.new_fs(c)
        i = 0
        while not stop.is_set():
            try:
                wfs.write_file(f"/s8d/w{idx}", b"%05d" % i)
            except s.p.CephFSError:
                pass
            started[idx].set()
            i += 1

    threads = [threading.Thread(target=writer, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    try:
        # the reference sleeps 0.3 s; here both writers have written
        for ev in started:
            assert ev.wait(30)
        fs.mksnap("/s8d", "undertow", timeout=30.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    names = sorted(fs.listdir("/s8d/.snap/undertow"))
    for name in names:
        data = fs.read_file(f"/s8d/.snap/undertow/{name}")
        size = fs.stat(f"/s8d/.snap/undertow/{name}")["size"]
        assert len(data) == size
        assert data == b"" or (len(data) == 5 and data.isdigit())
    mds.shutdown()
    return names


def test_concurrent_writers_and_snap(bare_sides):
    got = {kind: c_concurrent_writers_and_snap(s)
           for kind, s in bare_sides.items()}
    assert got["port"] == got["ref"] == ["w0", "w1"]


def c_snapshots_survive_mds_crash_replay(s):
    c = s.cluster(n_osd=2)
    mds = s.p.MDSDaemon(c.network, c.rados())
    mds.init()
    fs = s.new_fs(c)
    fs.mkdirs("/crash")
    fs.write_file("/crash/f", b"pre-crash state")
    fs.mksnap("/crash", "s")
    fs.write_file("/crash/f", b"NEWER")
    mds.ms.shutdown()
    mds2 = s.p.MDSDaemon(c.network, c.rados())
    mds2.init()
    fs2 = s.new_fs(c)
    assert set(fs2.lssnap("/crash")) == {"s"}
    assert fs2.read_file("/crash/.snap/s/f") == b"pre-crash state"
    assert fs2.read_file("/crash/f") == b"NEWER"
    state = fs_state(s, fs2.rados)
    mds2.shutdown()
    return state


def test_snapshots_survive_mds_crash_replay(bare_sides):
    run_both(bare_sides, c_snapshots_survive_mds_crash_replay, state=False)


def c_dotsnap_substring_names_unaffected(s):
    fs = s.new_fs()
    fs.mkdirs("/subst.snapdir")
    fs.write_file("/subst.snapdir/report.snapshot", b"writable")
    fs.write_file("/subst.snapdir/report.snapshot", b"rewritable")
    assert fs.read_file("/subst.snapdir/report.snapshot") == b"rewritable"
    fs.rename("/subst.snapdir/report.snapshot", "/subst.snapdir/r2")
    fs.unlink("/subst.snapdir/r2")


def test_dotsnap_substring_names_unaffected(sides):
    run_both(sides, c_dotsnap_substring_names_unaffected)


def c_snapc_monotone_against_reordered_delivery(s):
    fs = s.new_fs()
    fs.mkdirs("/mono")
    fh = fs.open("/mono/f", "w")
    fh.write(0, b"A" * 16)
    fh.fsync()
    fs.mksnap("/mono", "m1")
    fs.mksnap("/mono", "m2")
    # the reference sleeps 0.3 s to drain the broadcasts; here the
    # handle has applied both (one lssnap, so the replies recorded do
    # not depend on how long the broadcasts take)
    newest = max(fs.lssnap("/mono")[n]["id"] for n in ("m1", "m2"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and fh._snapc_seq < newest:
        time.sleep(0.02)
    seq = fh._snapc_seq
    assert seq >= 2
    fh.set_snapc({"seq": seq - 1, "snaps": []})
    assert fh._snapc_seq == seq
    fh2 = fs.open("/mono/f", "r+")
    assert fh2._snapc_seq >= seq
    assert fs._merge_snapc(fh.ino, None)["seq"] >= seq
    fh.close()
    fh2.close()
    return seq


def test_snapc_monotone_against_reordered_delivery(sides):
    run_both(sides, c_snapc_monotone_against_reordered_delivery)
