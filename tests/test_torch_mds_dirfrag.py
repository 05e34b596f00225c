"""The port's directory fragmentation held to the reference's at tolerance
0: every case of tests/test_mds_dirfrag.py runs on each package (the
harness of tests/test_torch_cephfs.py) with `mds_bal_split_size` 40 and
`mds_bal_merge_size` 10 in the package's own config, with the
reference's assertions; the replies and both pools (every fragment
object's dentries and the base object's bits header) must be equal, and
each MDS must report the same bits for the same directory.
"""
import json

import pytest

from test_torch_cephfs import close_sides, run_both, sides_with

SIZES = {"mds_bal_split_size": 40, "mds_bal_merge_size": 10}


@pytest.fixture(scope="module")
def sides():
    saved = {}

    def setup(s):
        cfg = s.p.options.global_config()
        saved[s.kind] = {k: cfg[k] for k in SIZES}
        for k, v in SIZES.items():
            cfg.set(k, v)

    out, mp = sides_with(setup=setup)
    yield out
    close_sides(out, mp)
    for s in out.values():
        cfg = s.p.options.global_config()
        for k, v in saved[s.kind].items():
            cfg.set(k, v)


def _ino(mds, path):
    _, _, dent = mds._resolve(path)
    return dent["ino"]


def c_split_on_growth_and_lookup_correctness(s):
    mds, fs = s.mds, s.fs
    fs.mkdir("/big")
    names = [f"file-{i:04d}" for i in range(120)]
    for n in names:
        fs.open(f"/big/{n}", "w").close()
    ino = _ino(mds, "/big")
    bits = mds._frag_bits(ino)
    assert bits >= 1, "directory never split"
    per_frag = {}
    for f in range(1 << bits):
        try:
            vals, _ = mds.meta.get_omap_vals(s.p.mds.dir_frag_obj(ino, f))
        except Exception:
            vals = {}
        per_frag[f] = set(vals)
    assert set().union(*per_frag.values()) == set(names)
    for n in names:
        assert n in per_frag[s.p.mds.name_frag(n, bits)]
    assert sorted(fs.listdir("/big")) == names
    assert fs.stat("/big/file-0077")["type"] == "f"
    return bits, {f: sorted(v) for f, v in per_frag.items()}


def test_split_on_growth_and_lookup_correctness(sides):
    run_both(sides, c_split_on_growth_and_lookup_correctness)


def c_ops_on_fragmented_dir(s):
    mds, fs = s.mds, s.fs
    ino = _ino(mds, "/big")
    assert mds._frag_bits(ino) >= 1
    fs.write_file("/big/file-0007", b"fresh")
    assert fs.read_file("/big/file-0007") == b"fresh"
    fs.rename("/big/file-0008", "/big/renamed")
    assert fs.stat("/big/renamed")["type"] == "f"
    fs.unlink("/big/file-0009")
    names = fs.listdir("/big")
    assert "file-0009" not in names and "renamed" in names
    return mds._frag_bits(ino)


def test_ops_on_fragmented_dir(sides):
    run_both(sides, c_ops_on_fragmented_dir)


def c_snapshot_of_fragmented_dir_captures_all_fragments(s):
    fs = s.fs
    before = sorted(fs.listdir("/big"))
    fs.mksnap("/big", "s1")
    fs.unlink("/big/file-0012")
    snap = sorted(fs.listdir("/big/.snap/s1"))
    assert snap == before
    assert "file-0012" not in fs.listdir("/big")
    fs.rmsnap("/big", "s1")
    return len(snap)


def test_snapshot_of_fragmented_dir_captures_all_fragments(sides):
    run_both(sides, c_snapshot_of_fragmented_dir_captures_all_fragments)


def c_merge_when_shrunk(s):
    mds, fs = s.mds, s.fs
    fs.mkdir("/shrink")
    for i in range(120):
        fs.open(f"/shrink/f{i:03d}", "w").close()
    ino = _ino(mds, "/shrink")
    bits = mds._frag_bits(ino)
    assert bits >= 1
    for i in range(120):
        fs.unlink(f"/shrink/f{i:03d}")
    assert mds._frag_bits(ino) == 0, "directory never merged back"
    assert fs.listdir("/shrink") == []
    hdr = mds.meta.get_omap_header(s.p.mds.dir_obj(ino))
    assert json.loads(hdr)["bits"] == 0
    fs.open("/shrink/again", "w").close()
    assert fs.listdir("/shrink") == ["again"]
    return bits


def test_merge_when_shrunk(sides):
    run_both(sides, c_merge_when_shrunk)


def c_journal_replay_preserves_fragmentation(s):
    c, mds, fs = s.c, s.mds, s.fs
    ino = _ino(mds, "/big")
    bits = mds._frag_bits(ino)
    listing = sorted(fs.listdir("/big"))
    mds.shutdown()
    mds2 = s.p.MDSDaemon(c.network, c.rados())
    mds2.init()
    # the module's MDS is now the restarted one (the fixture's teardown
    # shuts it down)
    s.mds = mds2
    assert mds2._frag_bits(ino) == bits
    fs2 = s.new_fs()
    assert sorted(fs2.listdir("/big")) == listing
    assert fs2.stat("/big/file-0077")["type"] == "f"
    return bits


def test_journal_replay_preserves_fragmentation(sides):
    run_both(sides, c_journal_replay_preserves_fragmentation)
