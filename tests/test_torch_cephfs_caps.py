"""The port's capabilities, hardlinks and crash replay held to the
reference's at tolerance 0: every case of tests/test_cephfs_caps.py runs
on each package (the harness of tests/test_torch_cephfs.py), with the
reference's assertions, and the replies and both pools must be equal.
"""
import time

import pytest

from test_torch_cephfs import (bare_sides, close_sides, fs_state,  # noqa: F401
                               run_both, sides_with)


@pytest.fixture(scope="module")
def sides():
    out, mp = sides_with()
    yield out
    close_sides(out, mp)


def c_single_client_gets_excl(s):
    fs = s.new_fs()
    fs.mkdirs("/caps")
    fh = fs.open("/caps/solo", "w")
    assert fh.caps & s.p.mds.CAP_EXCL and fh.caps & s.p.mds.CAP_CACHE
    fh.write(0, b"solo")
    fh.close()
    return fh.caps


def test_single_client_gets_excl(sides):
    run_both(sides, c_single_client_gets_excl)


def c_reader_revokes_writer_excl(s):
    fs_w, fs_r = s.new_fs(), s.new_fs()
    fs_w.mkdirs("/caps")
    w = fs_w.open("/caps/shared", "w")
    assert w.caps & s.p.mds.CAP_EXCL
    w.write(0, b"E" * 5000)
    r = fs_r.open("/caps/shared", "r")
    assert r.size == 5000
    assert r.read(0) == b"E" * 5000
    assert not (w.caps & s.p.mds.CAP_EXCL)
    w.close()
    r.close()
    return r.size


def test_reader_revokes_writer_excl(sides):
    run_both(sides, c_reader_revokes_writer_excl)


def c_concurrent_writers_no_lost_update(s):
    fs_a, fs_b = s.new_fs(), s.new_fs()
    fs_a.mkdirs("/caps")
    a = fs_a.open("/caps/both", "w")
    a.write(0, b"A" * 1000)
    b = fs_b.open("/caps/both", "a")
    assert b.size == 1000
    b.append(b"B" * 1000)
    a.append(b"C" * 1000)
    final = s.new_fs().read_file("/caps/both")
    assert final == b"A" * 1000 + b"B" * 1000 + b"C" * 1000
    a.close()
    b.close()
    return len(final)


def test_concurrent_writers_no_lost_update(sides):
    run_both(sides, c_concurrent_writers_no_lost_update)


def c_cache_invalidated_on_revoke(s):
    fs_1, fs_2 = s.new_fs(), s.new_fs()
    fs_1.mkdirs("/caps")
    fs_1.write_file("/caps/cached", b"v1-data")
    h1 = fs_1.open("/caps/cached", "r")
    assert h1.caps & s.p.mds.CAP_CACHE
    assert h1.read(0) == b"v1-data"
    assert (h1._oc is not None and h1._oc.cached_bytes() > 0) or \
        h1._rcache
    h2 = fs_2.open("/caps/cached", "r+")
    h2.write(0, b"v2-DATA")
    h2.fsync()
    deadline = time.monotonic() + 5
    while h1.caps and time.monotonic() < deadline:
        time.sleep(0.02)
    assert h1.caps == 0 and not h1._rcache
    assert h1._oc is None or h1._oc.cached_bytes() == 0
    assert h1.read(0) == b"v2-DATA"
    h1.close()
    h2.close()


def test_cache_invalidated_on_revoke(sides):
    run_both(sides, c_cache_invalidated_on_revoke)


def c_hardlink_shares_data_until_last_unlink(s):
    fs = s.new_fs()
    fs.mkdirs("/hl")
    fs.write_file("/hl/one", b"linked-bytes")
    fs.link("/hl/one", "/hl/two")
    assert fs.read_file("/hl/two") == b"linked-bytes"
    st1, st2 = fs.stat("/hl/one"), fs.stat("/hl/two")
    assert st1["ino"] == st2["ino"]
    assert st1.get("nlink") == 2
    fh = fs.open("/hl/two", "r+")
    fh.write(0, b"LINKED")
    fh.close()
    assert fs.read_file("/hl/one")[:6] == b"LINKED"
    fs.unlink("/hl/one")
    assert not fs.exists("/hl/one")
    assert fs.read_file("/hl/two")[:6] == b"LINKED"
    ino = st1["ino"]
    fs.unlink("/hl/two")
    io = fs.rados.open_ioctx("cephfs_data")
    assert not [o for o in io.list_objects()
                if o.startswith(f"{ino:x}.")]
    fs.write_file("/hl/base", b"renamed-link")
    fs.link("/hl/base", "/hl/alias")
    fs.rename("/hl/alias", "/hl/alias2")
    assert fs.read_file("/hl/alias2") == b"renamed-link"
    with pytest.raises(s.p.CephFSError, match="EEXIST"):
        fs.link("/hl/base", "/hl/alias2")
    return st1, st2


def test_hardlink_shares_data_until_last_unlink(sides):
    run_both(sides, c_hardlink_shares_data_until_last_unlink)


def c_crash_replay_window_with_concurrent_clients(s):
    c = s.cluster(n_osd=2)
    mds = s.p.MDSDaemon(c.network, c.rados())
    mds.init()
    fs_a, fs_b = s.new_fs(c), s.new_fs(c)
    fs_a.mkdirs("/w")
    fs_a.write_file("/w/a", b"from-a")
    fs_b.write_file("/w/b", b"from-b")
    fs_b.link("/w/b", "/w/b2")
    mds.ms.shutdown()                # hard stop inside the window
    mds2 = s.p.MDSDaemon(c.network, c.rados())
    mds2.init()
    fs2 = s.new_fs(c)
    assert sorted(fs2.listdir("/w")) == ["a", "b", "b2"]
    assert fs2.read_file("/w/a") == b"from-a"
    assert fs2.read_file("/w/b2") == b"from-b"
    assert fs2.stat("/w/b")["nlink"] == 2
    fs_a2, fs_b2 = s.new_fs(c), s.new_fs(c)
    ha = fs_a2.open("/w/a", "a")
    ha.append(b"+more")
    ha.close()
    assert fs_b2.read_file("/w/a") == b"from-a+more"
    state = fs_state(s, fs2.rados)
    mds2.shutdown()
    return state


def test_crash_replay_window_with_concurrent_clients(bare_sides):
    run_both(bare_sides, c_crash_replay_window_with_concurrent_clients,
             state=False)
