"""The port's multi-rank MDS (subtree pins and forwarding, per-rank ino
spaces and journals, migration, the cross-rank rename and the balancer)
held to the reference's at tolerance 0: every case of
tests/test_multimds.py runs on each package (the harness of
tests/test_torch_cephfs.py) with two ranks, with the reference's
assertions; the replies and both pools (the subtree tables, both ranks'
journals, every dirfrag and data object) must be equal.

Where the reference's schedule races, the port's case waits on state.
After a migration, a handle's revoke ends with a `reopen` from its cap
thread that re-registers the handle's intent with the new rank; the
reference's case goes on without waiting for it, so the intent may land
after the handle's release and change the caps a later open is granted.
Here the case waits for the new rank to hold the intent first, and
where the reference sleeps 0.3 s for a revoke, the case waits for the
handle's caps to drop (ROADMAP.md Queue 3).  The concurrent-writer
case races four writer threads for inos: it runs on a cluster of its
own and the sides must agree on what the race keeps (every file's
bytes and each directory's listing).
"""
import threading
import time

import pytest

from test_torch_cephfs import (bare_sides, close_sides, fs_state,  # noqa: F401
                               run_both, sides_with)


@pytest.fixture(scope="module")
def sides():
    out, mp = sides_with(mds_kw={"rank": 0})
    for s in out.values():
        s.mds1 = s.p.MDSDaemon(s.c.network, s.c.rados(), rank=1)
        s.mds1.init()
    yield out
    for s in out.values():
        s.mds1.shutdown()
    close_sides(out, mp)


def _wait(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end and not pred():
        time.sleep(0.02)
    return pred()


def c_pinned_subtree_served_by_other_rank(s):
    mds0, mds1 = s.mds, s.mds1
    fs = s.new_fs()
    fs.mkdirs("/tenant-a")
    fs.mkdirs("/tenant-b")
    fs.set_pin("/tenant-b", 1)
    assert fs.get_pins().get("/tenant-b") == 1
    fs.write_file("/tenant-b/file", b"served by rank one")
    assert fs.read_file("/tenant-b/file") == b"served by rank one"
    ino = fs.stat("/tenant-b/file")["ino"]
    fh = fs.open("/tenant-b/file", "w")
    assert ino in mds1._caps or ino in mds1._opens
    assert ino not in mds0._caps
    fh.close()
    fs.write_file("/tenant-a/file", b"served by rank zero")
    ino0 = fs.stat("/tenant-a/file")["ino"]
    fh0 = fs.open("/tenant-a/file", "r")
    assert ino0 in mds0._opens
    assert ino0 not in mds1._opens
    fh0.close()
    return fs.get_pins()


def test_pinned_subtree_served_by_other_rank(sides):
    run_both(sides, c_pinned_subtree_served_by_other_rank)


def c_ino_spaces_disjoint(s):
    fs = s.new_fs()
    fs.mkdirs("/inos-r0")
    fs.mkdirs("/inos-r1")
    fs.set_pin("/inos-r1", 1)
    inos = set()
    for i in range(8):
        fs.write_file(f"/inos-r0/f{i}", b"x")
        fs.write_file(f"/inos-r1/f{i}", b"y")
        inos.add(fs.stat(f"/inos-r0/f{i}")["ino"])
        inos.add(fs.stat(f"/inos-r1/f{i}")["ino"])
    assert len(inos) == 16
    r1_inos = {fs.stat(f"/inos-r1/f{i}")["ino"] for i in range(8)}
    assert all(ino >> s.p.mds.INO_RANK_SHIFT == 1 for ino in r1_inos)
    return sorted(inos)


def test_ino_spaces_disjoint(sides):
    run_both(sides, c_ino_spaces_disjoint)


def c_migration_revokes_live_handles(s):
    mds0, mds1 = s.mds, s.mds1
    fs = s.new_fs()
    fs.mkdirs("/moving")
    fh = fs.open("/moving/live", "w")
    fh.write(0, b"A" * 3000)
    fs.set_pin("/moving", 1)
    assert _wait(lambda: not fh.caps), "migration never revoked the handle"
    assert _wait(lambda: fh.ino in mds1._opens), "reopen never landed"
    st = fs.stat("/moving/live")
    assert st["size"] == 3000
    fh.write(3000, b"B" * 100)
    fh.close()
    assert fs.read_file("/moving/live") == b"A" * 3000 + b"B" * 100
    ino = st["ino"]
    assert ino not in mds0._caps and ino not in mds0._opens
    fs.set_pin("/moving", 0)
    assert fs.read_file("/moving/live")[:4] == b"AAAA"
    return st


def test_migration_revokes_live_handles(sides):
    run_both(sides, c_migration_revokes_live_handles)


def c_cross_rank_rename_works_and_link_refused(s):
    fs = s.new_fs()
    fs.mkdirs("/xr-a")
    fs.mkdirs("/xr-b")
    fs.set_pin("/xr-b", 1)
    fs.write_file("/xr-a/f", b"data")
    fs.rename("/xr-a/f", "/xr-b/f")
    assert fs.read_file("/xr-b/f") == b"data"
    with pytest.raises(s.p.CephFSError) as ei:
        fs.link("/xr-b/f", "/xr-a/alias")
    assert ei.value.errno_name == "EXDEV"
    fs.write_file("/xr-a/g0", b"ga")
    fs.rename("/xr-a/g0", "/xr-a/g")
    fs.write_file("/xr-b/h", b"hb")
    fs.rename("/xr-b/h", "/xr-b/h2")
    assert fs.read_file("/xr-b/h2") == b"hb"
    return ei.value.errno_name


def test_cross_rank_rename_works_and_link_refused(sides):
    run_both(sides, c_cross_rank_rename_works_and_link_refused)


def c_concurrent_clients_across_ranks(s):
    c = s.cluster(n_osd=4)
    mds0 = s.p.MDSDaemon(c.network, c.rados(), rank=0)
    mds0.init()
    mds1 = s.p.MDSDaemon(c.network, c.rados(), rank=1)
    mds1.init()
    fs = s.new_fs(c)
    fs.mkdirs("/par-r0")
    fs.mkdirs("/par-r1")
    fs.set_pin("/par-r1", 1)
    errors: list = []

    def worker(base, idx, wfs):
        try:
            for i in range(10):
                wfs.write_file(f"{base}/w{idx}-{i}",
                               (f"{base}:{idx}:{i}").encode())
        except Exception as ex:       # noqa: BLE001
            errors.append(ex)

    threads = [threading.Thread(target=worker, args=(b, i, s.new_fs(c)),
                                daemon=True)
               for b in ("/par-r0", "/par-r1") for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    out = {}
    for b in ("/par-r0", "/par-r1"):
        for idx in range(2):
            for i in range(10):
                data = fs.read_file(f"{b}/w{idx}-{i}")
                assert data == (f"{b}:{idx}:{i}").encode()
                out[f"{b}/w{idx}-{i}"] = data.decode()
        out[b] = fs.listdir(b)
    mds1.shutdown()
    mds0.shutdown()
    return out


def test_concurrent_clients_across_ranks(bare_sides):
    got = {kind: c_concurrent_clients_across_ranks(s)
           for kind, s in bare_sides.items()}
    assert got["port"] == got["ref"]


def c_rank_crash_replay_isolated(s):
    c = s.cluster(n_osd=2)
    mds0 = s.p.MDSDaemon(c.network, c.rados(), rank=0)
    mds0.init()
    mds1 = s.p.MDSDaemon(c.network, c.rados(), rank=1)
    mds1.init()
    fs = s.new_fs(c)
    fs.mkdirs("/keep")
    fs.mkdirs("/crashy")
    fs.set_pin("/crashy", 1)
    fs.write_file("/keep/a", b"rank0 data")
    fs.write_file("/crashy/b", b"rank1 data")
    mds1.ms.shutdown()
    mds1b = s.p.MDSDaemon(c.network, c.rados(), rank=1)
    mds1b.init()
    fs2 = s.new_fs(c)
    assert fs2.read_file("/crashy/b") == b"rank1 data"
    assert fs2.read_file("/keep/a") == b"rank0 data"
    fs2.write_file("/crashy/c", b"post-replay")
    assert fs2.read_file("/crashy/c") == b"post-replay"
    state = fs_state(s, fs2.rados)
    mds1b.shutdown()
    mds0.shutdown()
    return state


def test_rank_crash_replay_isolated(bare_sides):
    run_both(bare_sides, c_rank_crash_replay_isolated, state=False)


def c_migration_preserves_open_intents(s):
    CAP_EXCL = s.p.mds.CAP_EXCL
    mds1 = s.mds1
    fs_w, fs_r = s.new_fs(), s.new_fs()
    fs_w.mkdirs("/intent")
    w = fs_w.open("/intent/f", "w")
    w.write(0, b"writer data")
    fs_w.set_pin("/intent", 1)
    assert _wait(lambda: not w.caps)
    ino = fs_w.stat("/intent/f")["ino"]
    assert _wait(lambda: ino in mds1._opens), \
        "open intent never re-registered"
    r = fs_r.open("/intent/f", "r")
    assert not (r.caps & CAP_EXCL)
    w.write(100, b"still-writing")
    assert fs_r.read_file("/intent/f")[:11] == b"writer data"
    w.close()
    r.close()
    fs_w.set_pin("/intent", 0)
    return r.caps


def test_migration_preserves_open_intents(sides):
    run_both(sides, c_migration_preserves_open_intents)


def c_release_routes_to_owning_rank(s):
    CAP_EXCL = s.p.mds.CAP_EXCL
    mds1 = s.mds1
    fs = s.new_fs()
    fs.mkdirs("/rel")
    fs.set_pin("/rel", 1)
    fh = fs.open("/rel/f", "w")
    ino = fh.ino
    assert ino in mds1._opens
    fh.write(0, b"x")
    fh.close()
    assert ino not in mds1._opens, "release never reached rank 1"
    fh2 = fs.open("/rel/f", "w")
    assert fh2.caps & CAP_EXCL
    fh2.close()
    fs.set_pin("/rel", 0)
    return fh2.caps


def test_release_routes_to_owning_rank(sides):
    run_both(sides, c_release_routes_to_owning_rank)


def c_force_repin_rescues_bad_pin(s):
    fs = s.new_fs()
    fs.mkdirs("/bricked")
    fs.write_file("/bricked/f", b"data")
    fs.set_pin("/bricked", 7)
    with pytest.raises((s.p.CephFSError, TimeoutError)) as ei:
        fs._session.call("lookup", {"path": "/bricked/f"}, timeout=2.0)
    fs._session.call("set_pin", {"path": "/bricked", "rank": 0,
                                 "force": True})
    assert fs.read_file("/bricked/f") == b"data"
    return type(ei.value).__name__


def test_force_repin_rescues_bad_pin(sides):
    run_both(sides, c_force_repin_rescues_bad_pin)


def c_cross_rank_rename_file(s):
    mds0, mds1 = s.mds, s.mds1
    fs = s.new_fs()
    fs.mkdirs("/xr-src")
    fs.mkdirs("/xr-dst")
    fs.set_pin("/xr-dst", 1)
    fs.write_file("/xr-src/mover", b"identity survives")
    ino = fs.stat("/xr-src/mover")["ino"]
    fs.rename("/xr-src/mover", "/xr-dst/mover")
    with pytest.raises(s.p.CephFSError, match="ENOENT"):
        fs.stat("/xr-src/mover")
    assert fs.stat("/xr-dst/mover")["ino"] == ino
    assert fs.read_file("/xr-dst/mover") == b"identity survives"
    fh = fs.open("/xr-dst/mover", "w")
    assert ino in mds1._caps or ino in mds1._opens
    assert ino not in mds0._caps
    fh.close()
    return ino


def test_cross_rank_rename_file(sides):
    run_both(sides, c_cross_rank_rename_file)


def c_cross_rank_rename_preserves_hardlinks(s):
    fs = s.new_fs()
    fs.mkdirs("/xh-src")
    fs.mkdirs("/xh-dst")
    fs.set_pin("/xh-dst", 1)
    fs.write_file("/xh-src/orig", b"two names")
    fs.link("/xh-src/orig", "/xh-src/alias")
    ino = fs.stat("/xh-src/orig")["ino"]
    fs.rename("/xh-src/orig", "/xh-dst/orig")
    assert fs.stat("/xh-dst/orig")["ino"] == ino
    assert fs.stat("/xh-src/alias")["ino"] == ino
    fs.write_file("/xh-src/alias", b"updated via alias")
    assert fs.read_file("/xh-dst/orig") == b"updated via alias"
    return ino


def test_cross_rank_rename_preserves_hardlinks(sides):
    run_both(sides, c_cross_rank_rename_preserves_hardlinks)


def c_cross_rank_rename_directory_under_io(s):
    fs = s.new_fs()
    fs.mkdirs("/xd-src/deep")
    fs.mkdirs("/xd-dst")
    fs.set_pin("/xd-dst", 1)
    fs.write_file("/xd-src/deep/a", b"aaa")
    fs.write_file("/xd-src/deep/b", b"bbb")
    fh = fs.open("/xd-src/deep/a", "r+")
    fh.write(0, b"AAA")
    fs.rename("/xd-src/deep", "/xd-dst/deep")
    # the reference sleeps 0.3 s: here the revoke has flushed (the
    # handle's reopen names its old path and finds nothing)
    assert _wait(lambda: not fh.caps)
    assert fs.read_file("/xd-dst/deep/a")[:3] == b"AAA"
    assert fs.read_file("/xd-dst/deep/b") == b"bbb"
    fh.close()


def test_cross_rank_rename_directory_under_io(sides):
    run_both(sides, c_cross_rank_rename_directory_under_io)


def c_balancer_migrates_hot_subtree(s):
    g = s.p.options.global_config()
    saved = {k: g[k] for k in ("mds_bal_interval", "mds_bal_min_load",
                               "mds_bal_ratio")}
    g.set("mds_bal_interval", 1.0)
    g.set("mds_bal_min_load", 10.0)
    g.set("mds_bal_ratio", 1.5)
    mds0, mds1 = s.mds, s.mds1
    fs = s.new_fs()
    try:
        fs.mkdirs("/hot")
        fs.mkdirs("/pinned-hot")
        fs.set_pin("/pinned-hot", 0)
        for _ in range(40):
            fs.write_file("/hot/f", b"x" * 64)
            fs.read_file("/hot/f")
            fs.write_file("/pinned-hot/f", b"y" * 64)
        t = 10_000.0
        mds1.tick(t)
        mds0.tick(t)
        t += 2.0
        mds1.tick(t)
        mds0.tick(t)
        for _ in range(6):
            t += 2.0
            mds0.tick(t)
            mds1.tick(t)
            if fs.get_pins().get("/hot") == 1:
                break
        pins = fs.get_pins()
        assert pins.get("/hot") == 1, pins
        assert pins.get("/pinned-hot") == 0, \
            "explicit pin was auto-migrated"
        fs.write_file("/hot/after", b"post-migration")
        ino = fs.stat("/hot/after")["ino"]
        fh = fs.open("/hot/after", "r")
        assert ino in mds1._opens
        assert ino not in mds0._opens
        fh.close()
        return pins
    finally:
        for k, v in saved.items():
            g.set(k, v)


def test_balancer_migrates_hot_subtree(sides):
    run_both(sides, c_balancer_migrates_hot_subtree)
