"""The port's block images (`ceph_tpu_torch.rbd`) held to the reference's
(`ceph_tpu.rbd`) at tolerance 0.

Every case of tests/test_rbd_advanced.py, tests/test_rbd_snapshots.py and
tests/test_rbd_striper.py, and the rbd case of tests/test_object_cacher.py,
runs the reference test's operations once on each package's threaded
`MiniCluster` (the port's on `device="cpu"`), as the reference tests run
them, and the reference's own assertions hold on both.  What each side
saw must then be equal: every read (sha256 where it is long), each
`RBDError`'s errno and text, stats, snapshot lists, children, diffs and
`du`, and the CLI's stdout, stderr and return codes.  After each case
the whole pool is compared too: the listed RADOS objects, each one's
bytes (sha256), xattrs and omap, and each data object's clones; so the
header JSON, the object maps of the head and of every snapshot and the
exclusive lock's state (with the lock cookie, which holds `id()`, and
the client ids, which come from a process-wide counter, masked) are
equal byte for byte.

Two cases are the port's own: the swallowed-error counters stay 0, and
the exclusive lock across a new interval under the same primary (ROADMAP
Queue 3): the reference's holder loses its header watch, so the next
writer breaks its live lock; the port's keeps it and hands the lock over.

The helpers here (`Side`, `run_both`, `pool_state`) serve
tests/test_torch_rbd_migration.py and tests/test_torch_journal_mirror.py
too.
"""
import hashlib
import io as _io_mod
import json
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ceph_tpu.common.options as ref_options
import ceph_tpu.journal as ref_journal
import ceph_tpu.osdc as ref_osdc
import ceph_tpu.rbd.image as ref_image
import ceph_tpu.rbd.migration as ref_migration
import ceph_tpu.rbd.mirror as ref_mirror
import ceph_tpu.tools.rbd_cli as ref_cli
import ceph_tpu_torch.common.options as port_options
import ceph_tpu_torch.journal as port_journal
import ceph_tpu_torch.osdc as port_osdc
import ceph_tpu_torch.rbd.image as port_image
import ceph_tpu_torch.rbd.migration as port_migration
import ceph_tpu_torch.rbd.mirror as port_mirror
import ceph_tpu_torch.tools.rbd_cli as port_cli
from ceph_tpu.client import RadosError as RefRadosError
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.client import RadosError as PortRadosError
from ceph_tpu_torch.testing import MiniCluster as PortCluster

KINDS = ("ref", "port")
PKG = {
    "ref": SimpleNamespace(
        image=ref_image, RBD=ref_image.RBD, Image=ref_image.Image,
        RBDError=ref_image.RBDError, ObjectMap=ref_image.ObjectMap,
        journal=ref_journal, mirror=ref_mirror, migration=ref_migration,
        cli=ref_cli, osdc=ref_osdc, config=ref_options.global_config,
        RadosError=RefRadosError, Cluster=RefCluster),
    "port": SimpleNamespace(
        image=port_image, RBD=port_image.RBD, Image=port_image.Image,
        RBDError=port_image.RBDError, ObjectMap=port_image.ObjectMap,
        journal=port_journal, mirror=port_mirror, migration=port_migration,
        cli=port_cli, osdc=port_osdc, config=port_options.global_config,
        RadosError=PortRadosError, Cluster=PortCluster)}


class Side:
    """One package's threaded cluster, a client and its pools."""

    def __init__(self, kind: str, n_osd: int, pools: dict):
        self.kind, self.p = kind, PKG[kind]
        self.c = self.p.Cluster(n_osd=n_osd, threaded=True) \
            if kind == "ref" else \
            self.p.Cluster(n_osd=n_osd, threaded=True, device="cpu")
        self.c.wait_all_up()
        self.r = self.c.rados()
        for name, pg_num in pools.items():
            self.r.pool_create(name, pg_num=pg_num)
        self.pools = list(pools)

    def io(self, pool: str):
        """A new client's IoCtx, as the reference tests' `_io(c)`."""
        return self.c.rados().open_ioctx(pool)

    def shutdown(self) -> None:
        self.c.shutdown()


def make_sides(n_osd: int, pools: dict) -> dict:
    return {kind: Side(kind, n_osd, pools) for kind in KINDS}


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def attempt(side, fn, *a, **kw):
    """("ok", value) or ("err", errno, text) of an RBDError; a RadosError
    as ("rados", errno name)."""
    try:
        return ("ok", fn(*a, **kw))
    except side.p.RBDError as e:
        return ("err", e.errno, e.strerror)
    except side.p.RadosError as e:
        return ("rados", e.errno_name)


_COOKIE = re.compile(r"(client\.\d+)\.[0-9a-f]+")
_CLIENT = re.compile(r"client\.\d+")


def masked(obj):
    """`obj` as JSON text with each lock cookie's `id()` part masked and
    the client ids numbered by first appearance."""
    text = _COOKIE.sub(r"\1.<cookie>", json.dumps(obj, sort_keys=True,
                                                   default=repr))
    names: dict = {}
    return _CLIENT.sub(lambda m: names.setdefault(
        m.group(0), f"client#{len(names)}"), text)


def pool_state(side, pool: str) -> dict:
    """Every object of `pool`: sha256 of its bytes, its xattrs and omap,
    and a data object's clones."""
    io = side.r.open_ioctx(pool)
    out = {}
    for oid in io.list_objects():
        data = io.read(oid)
        ent = {"sha": sha(data), "size": len(data),
               "xattrs": {k: bytes(v).decode("latin-1")
                          for k, v in sorted(io.get_xattrs(oid).items())},
               "omap": {k: bytes(v).hex() for k, v in
                        sorted(io.get_omap_vals(oid)[0].items())}}
        if oid.startswith(("rbd_header.", "journal.")) or \
                oid.startswith("rbd_object_map."):
            ent["data"] = data.decode("latin-1")
        if oid.startswith("rbd_data."):
            ent["clones"] = io.list_snaps(oid)["clones"]
        out[oid] = ent
    return out


def run_both(sides: dict, case, *args, pools=None):
    """Run `case(side, *args)` on each side; what each saw, and then each
    pool's objects, must be equal (masked).  Returns the port's."""
    got = {kind: case(side, *args) for kind, side in sides.items()}
    assert masked(got["port"]) == masked(got["ref"])
    for pool in pools if pools is not None else sides["ref"].pools:
        st = {kind: pool_state(side, pool) for kind, side in sides.items()}
        assert list(st["port"]) == list(st["ref"]), pool
        assert masked(st["port"]) == masked(st["ref"]), pool
    return got["port"]


@pytest.fixture(scope="module")
def sides():
    out = make_sides(4, {"rbd": 8})
    yield out
    for s in out.values():
        s.shutdown()


ORDER = 16      # 64 KiB objects, as tests/test_rbd_advanced.py


# -------------------------------------------- tests/test_rbd_advanced.py

def c_lock_contend(side):
    p = side.p
    io_a, io_b = side.io("rbd"), side.io("rbd")
    p.RBD().create(io_a, "locky", size=1 << 20, order=ORDER)
    a = p.Image(io_a, "locky")
    b = p.Image(io_b, "locky")
    a.write(0, b"A" * 1000)
    owners = [(a.lock_owner, b.lock_owner)]
    b.write(1000, b"B" * 1000)
    owners.append((a.lock_owner, b.lock_owner))
    a.write(2000, b"C" * 1000)
    owners.append((a.lock_owner, b.lock_owner))
    got = a.read(0, 3000)
    assert got == b"A" * 1000 + b"B" * 1000 + b"C" * 1000
    a.close()
    b.close()
    assert owners == [(True, False), (False, True), (True, False)]
    return owners, got


def test_exclusive_lock_two_clients_contend(sides):
    run_both(sides, c_lock_contend)


def c_dead_holder(side):
    p = side.p
    r_dead = side.c.rados()
    io_dead = r_dead.open_ioctx("rbd")
    io_live = side.io("rbd")
    p.RBD().create(io_live, "orphan", size=1 << 20, order=ORDER)
    d = p.Image(io_dead, "orphan")
    d.write(0, b"x" * 100)
    held = d.lock_owner
    r_dead.shutdown()
    survivor = p.Image(io_live, "orphan")
    survivor.write(0, b"y" * 100)
    out = (held, survivor.lock_owner, survivor.read(0, 100))
    survivor.close()
    assert out == (True, True, b"y" * 100)
    return out


def test_exclusive_lock_dead_holder_broken(sides):
    before = port_image.LOCKS["broken"]
    run_both(sides, c_dead_holder)
    assert port_image.LOCKS["broken"] == before + 1


def c_object_map(side):
    p = side.p
    io = side.io("rbd")
    OM = p.ObjectMap
    p.RBD().create(io, "mapped", size=1 << 20, order=ORDER)
    img = p.Image(io, "mapped")
    img.write(0, b"z" * 100)
    img.write(3 << ORDER, b"z" * (1 << ORDER))
    img.flush()
    states = [img.object_map.get(o) for o in range(16)]
    assert states[0] == OM.EXISTS and states[1] == OM.NONEXISTENT and \
        states[3] == OM.EXISTS
    du = [img.du()]
    img.discard(3 << ORDER, 1 << ORDER)
    states.append(img.object_map.get(3))
    du.append(img.du())
    img.close()
    img2 = p.Image(io, "mapped")
    reopened = [img2.object_map.get(0), img2.object_map.get(3)]
    img2.close()
    assert du == [2 * (1 << ORDER), 1 << ORDER]
    assert states[-1] == OM.NONEXISTENT
    assert reopened == [OM.EXISTS, OM.NONEXISTENT]
    return states, du, reopened


def test_object_map_tracks_existence_and_du(sides):
    run_both(sides, c_object_map)


def c_fast_diff(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "differ", size=1 << 20, order=ORDER)
    img = p.Image(io, "differ")
    img.write(0, b"a" * 100)
    img.write(5 << ORDER, b"a" * 100)
    img.snap_create("base")
    first = img.diff_since("base")
    img.write(5 << ORDER, b"b" * 50)
    img.write(9 << ORDER, b"c" * 10)
    diff = img.diff_since("base")
    since_none = img.diff_since(None)
    snaps = img.snap_list()
    img.snap_remove("base")
    img.close()
    assert first == []
    assert [d["objectno"] for d in diff] == [5, 9]
    assert all(d["exists"] for d in diff)
    assert [d["objectno"] for d in since_none] == [0, 5, 9]
    return first, diff, since_none, snaps


def test_fast_diff_since_snapshot(sides):
    run_both(sides, c_fast_diff)


def c_clone(side):
    p = side.p
    io = side.io("rbd")
    rbd = p.RBD()
    rbd.create(io, "parent", size=1 << 19, order=ORDER)
    pi = p.Image(io, "parent")
    pi.write(0, b"P" * (1 << ORDER))
    pi.write(2 << ORDER, b"Q" * 4096)
    pi.snap_create("gold")
    out = {"unprotected_clone": attempt(side, rbd.clone, io, "parent",
                                        "gold", io, "child")}
    pi.snap_protect("gold")
    rbd.clone(io, "parent", "gold", io, "child")
    out["children"] = pi.children()
    pi.write(0, b"Z" * 100)
    c = p.Image(io, "child")
    out["reads"] = [c.read(0, 100), c.read(2 << ORDER, 4096),
                    c.read(5 << ORDER, 10)]
    c.write((2 << ORDER) + 100, b"new")
    out["after_copyup"] = c.read(2 << ORDER, 4096)
    out["parent_after"] = pi.read(2 << ORDER, 100)
    out["guards"] = [attempt(side, pi.snap_unprotect, "gold"),
                     attempt(side, pi.snap_remove, "gold")]
    c.flatten()
    out["flattened"] = (c.parent, c.read(0, 100), c.read(2 << ORDER, 100))
    p2 = p.Image(io, "parent")
    out["children_after"] = p2.children()
    p2.snap_unprotect("gold")
    p2.snap_remove("gold")
    p2.close()
    c.close()
    pi.close()
    assert out["unprotected_clone"][:2] == ("err", 22)
    assert ("rbd", "child") in out["children"]
    assert out["reads"] == [b"P" * 100, b"Q" * 4096, b"\0" * 10]
    got = out["after_copyup"]
    assert got[:100] == b"Q" * 100 and got[100:103] == b"new" and \
        got[103:] == b"Q" * (4096 - 103)
    assert out["parent_after"] == b"Q" * 100
    assert [g[0] for g in out["guards"]] == ["err", "err"]
    assert out["flattened"] == (None, b"P" * 100, b"Q" * 100)
    assert ("rbd", "child") not in out["children_after"]
    return out


def test_clone_cow_read_write_flatten(sides):
    run_both(sides, c_clone)


def c_clone_discard(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "pdisc", size=1 << 18, order=ORDER)
    pi = p.Image(io, "pdisc")
    pi.write(0, b"S" * (1 << ORDER))
    pi.snap_create("s")
    pi.snap_protect("s")
    p.RBD().clone(io, "pdisc", "s", io, "cdisc")
    c = p.Image(io, "cdisc")
    c.discard(0, 1 << ORDER)
    got = c.read(0, 100)
    c.close()
    pi.close()
    assert got == b"\0" * 100
    return got


def test_clone_discard_does_not_expose_parent(sides):
    run_both(sides, c_clone_discard)


def c_remove_guards(side):
    p = side.p
    io = side.io("rbd")
    rbd = p.RBD()
    rbd.create(io, "guarded", size=1 << 18, order=ORDER)
    img = p.Image(io, "guarded")
    img.write(0, b"g")
    img.snap_create("s1")
    img.close()
    refused = attempt(side, rbd.remove, io, "guarded")
    img = p.Image(io, "guarded")
    img.snap_remove("s1")
    img.close()
    rbd.remove(io, "guarded")
    listed = rbd.list(io)
    assert refused[:2] == ("err", 39) and "snapshots" in refused[2]
    assert "guarded" not in listed
    return refused, listed


def test_remove_guards(sides):
    run_both(sides, c_remove_guards)


CLI_STEPS = [
    ("create", "cli_img", "--size", "1M", "--order", "16"),
    ("ls",), ("info", "cli_img"), ("snap", "create", "cli_img@s1"),
    ("snap", "protect", "cli_img@s1"), ("snap", "ls", "cli_img"),
    ("clone", "cli_img@s1", "cli_child"), ("children", "cli_img"),
    ("info", "cli_child"), ("du", "cli_img"),
    ("diff", "cli_child"), ("diff", "cli_img", "--from-snap", "s1"),
    ("resize", "cli_child", "--size", "2M"), ("info", "cli_child"),
    ("flatten", "cli_child"), ("children", "cli_img"),
    ("snap", "unprotect", "cli_img@s1"), ("snap", "rm", "cli_img@s1"),
    ("rm", "cli_child"), ("rm", "ghost"), ("info", "ghost"),
    ("snap", "rollback", "cli_img@nosnap")]


def c_cli(side, capsys):
    r = side.c.rados()
    out = []
    for step in CLI_STEPS:
        argv = ["-p", "rbd", *step]
        buf = _io_mod.StringIO()
        capsys.readouterr()
        rc = side.p.cli.main(argv, rados=r, out=buf)
        out.append((step, rc, buf.getvalue(), capsys.readouterr().err))
    r.shutdown()
    return out


def test_rbd_cli_verbs(sides, capsys):
    """The reference test's verbs, and `diff`, `resize` and three that
    fail: every stdout, stderr and return code equal."""
    got = run_both(sides, c_cli, capsys)
    text = {" ".join(s): (rc, o, e) for s, rc, o, e in got}
    assert all(rc == 0 for s, rc, o, e in got[:-3])
    assert "cli_img" in text["ls"][1].splitlines()
    assert "1 MiB" in text["info cli_img"][1]
    assert "s1" in text["snap ls cli_img"][1] and \
        "protected" in text["snap ls cli_img"][1]
    assert "parent: rbd/cli_img@s1" in got[8][2]
    assert [rc for s, rc, o, e in got[-3:]] == [1, 1, 1]
    assert got[-3][3].startswith("rbd: ")


# ------------------------------------------- tests/test_rbd_snapshots.py

def c_snap_read_back(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "disk", size=1 << 22, order=16)
    img = p.Image(io, "disk")
    rng = np.random.default_rng(9)
    v1 = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    img.write(0, v1)
    img.snap_create("s1")
    v2 = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    img.write(0, v2)
    img.snap_create("s2")
    img.write(50_000, b"\xff" * 1000)
    live = img.read(0, 200_000)
    s1 = p.Image(io, "disk", snapshot="s1")
    s2 = p.Image(io, "disk", snapshot="s2")
    out = {"live": sha(live), "s1": sha(s1.read(0, 200_000)),
           "s2": sha(s2.read(0, 200_000)), "snaps": img.snap_list(),
           "refused": [attempt(side, s1.write, 0, b"nope"),
                       attempt(side, s1.snap_create, "inner")]}
    img.close()
    assert live[50_000:51_000] == b"\xff" * 1000
    assert out["s1"] == sha(v1) and out["s2"] == sha(v2)
    assert [s["name"] for s in out["snaps"]] == ["s1", "s2"]
    assert [g[:2] for g in out["refused"]] == [("err", 30), ("err", 30)]
    return out


def c_snap_rollback(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "rbk", size=1 << 20, order=16)
    img = p.Image(io, "rbk")
    img.write(0, b"stable state " * 1000)
    img.snap_create("good")
    img.write(0, b"BROKEN!!" * 2000)
    img.snap_rollback("good")
    out = (img.read(0, 13_000), img.size)
    img.close()
    assert out == (b"stable state " * 1000, 1 << 20)
    return out


def c_snap_remove_missing(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "rmv", size=1 << 20, order=16)
    img = p.Image(io, "rmv")
    img.write(0, b"x" * 100)
    img.snap_create("tmp")
    img.snap_remove("tmp")
    out = (img.snap_list(), attempt(side, img.snap_remove, "tmp"),
           attempt(side, p.Image, io, "rmv", snapshot="tmp"))
    img.close()
    assert out[0] == [] and out[1][:2] == ("err", 2) and \
        out[2][:2] == ("err", 2)
    return out


def c_snap_grown(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "grow", size=1 << 20, order=16)
    img = p.Image(io, "grow")
    img.write(0, b"A" * 10)
    img.snap_create("small")
    img.resize(1 << 21)
    img.write((1 << 20) + 5, b"beyond old end")
    snap = p.Image(io, "grow", snapshot="small")
    out = (snap.size, snap.read(0, 10), snap.read((1 << 20) - 10, 10 ** 3),
           attempt(side, snap.read, (1 << 20) + 1, 10),
           img.read((1 << 20) + 5, 14))
    img.close()
    assert out[:3] == (1 << 20, b"A" * 10, b"\0" * 10)
    assert out[3][:2] == ("err", 22) and out[4] == b"beyond old end"
    return out


SNAP_CASES = [c_snap_read_back, c_snap_rollback, c_snap_remove_missing,
              c_snap_grown]


@pytest.mark.parametrize("case", SNAP_CASES, ids=lambda f: f.__name__)
def test_snapshots_equal_reference(sides, case):
    """tests/test_rbd_snapshots.py, case by case."""
    run_both(sides, case)


# --------------------------------------------- tests/test_rbd_striper.py

def s_trivial(osdc):
    lo = osdc.StripeLayout(stripe_unit=1 << 20, stripe_count=1,
                           object_size=1 << 20)
    exts = osdc.Striper.file_to_extents(lo, 0, 3 << 20)
    got = [(e.objectno, e.offset, e.length) for e in exts]
    assert got == [(0, 0, 1 << 20), (1, 0, 1 << 20), (2, 0, 1 << 20)]
    return got


def s_round_robin(osdc):
    lo = osdc.StripeLayout(stripe_unit=4096, stripe_count=3,
                           object_size=8192)
    exts = osdc.Striper.file_to_extents(lo, 0, 6 * 4096)
    got = [(e.objectno, e.offset) for e in exts]
    assert got == [(0, 0), (1, 0), (2, 0), (0, 4096), (1, 4096), (2, 4096)]
    exts2 = osdc.Striper.file_to_extents(lo, 6 * 4096, 4096)
    assert (exts2[0].objectno, exts2[0].offset) == (3, 0)
    return got, [tuple(vars(e).values()) for e in exts2]


def s_unaligned(osdc):
    lo = osdc.StripeLayout(stripe_unit=4096, stripe_count=2,
                           object_size=8192)
    exts = osdc.Striper.file_to_extents(lo, 1000, 5000)
    assert sum(e.length for e in exts) == 5000
    assert exts[0] == osdc.ObjectExtent(0, 1000, 3096, 1000)
    assert exts[1].objectno == 1 and exts[1].offset == 0
    pos = 1000
    for lo_, hi in sorted((e.logical_offset, e.logical_offset + e.length)
                          for e in exts):
        assert lo_ == pos
        pos = hi
    assert pos == 6000
    return [tuple(vars(e).values()) for e in exts]


def s_inverse(osdc):
    lo = osdc.StripeLayout(stripe_unit=4096, stripe_count=3,
                           object_size=16384)
    rng = np.random.default_rng(0)
    seen = []
    for _ in range(50):
        off = int(rng.integers(0, 200000))
        ln = int(rng.integers(1, 30000))
        for e in osdc.Striper.file_to_extents(lo, off, ln):
            back = osdc.Striper.extent_to_file(lo, e.objectno, e.offset,
                                               e.length)
            assert back[0][0] == e.logical_offset
            assert sum(n for _, n in back) == e.length
            seen.append([tuple(b) for b in back])
    return seen


def s_validation(osdc):
    got = []
    for kw in ({"stripe_unit": 3000, "stripe_count": 1,
                "object_size": 8192}, {"stripe_unit": 0}):
        with pytest.raises(ValueError) as ei:
            osdc.StripeLayout(**kw).validate()
        got.append(str(ei.value))
    return got


@pytest.mark.parametrize("case", [s_trivial, s_round_robin, s_unaligned,
                                  s_inverse, s_validation],
                         ids=lambda f: f.__name__)
def test_striper_cases_equal_reference(case):
    """tests/test_rbd_striper.py's five striper cases on both packages'
    `osdc`: the same extents, inverse maps and refusals."""
    assert case(port_osdc) == case(ref_osdc)


def r_create_open_stat_list(side):
    p = side.p
    io = side.io("rbd")
    rbd = p.RBD()
    rbd.create(io, "img", size=1 << 20, order=16)
    listed = "img" in rbd.list(io)
    img = p.Image(io, "img")
    st = img.stat()
    dup = attempt(side, rbd.create, io, "img", size=1)
    img.close()
    closed = attempt(side, img.read, 0, 1)
    assert listed and st["size"] == 1 << 20 and st["obj_size"] == 1 << 16
    assert st["num_objs"] == 16
    assert dup[:2] == ("err", 17) and closed[:2] == ("err", 9)
    return st, dup, closed


def r_spanning(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "span", size=1 << 20, order=16)
    img = p.Image(io, "span")
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    off = 60_000
    n = img.write(off, data)
    got = [img.read(off, len(data)) == data, img.read(0, 100),
           img.read(off + len(data), 50)]
    img.write(off + 1000, b"X" * 70000)
    expect = bytearray(data)
    expect[1000:71000] = b"X" * 70000
    after = img.read(off, len(data))
    img.close()
    assert n == len(data) and got == [True, b"\0" * 100, b"\0" * 50]
    assert after == bytes(expect)
    return n, got, sha(after)


def r_striped(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "striped", size=1 << 20, order=16,
                   stripe_unit=4096, stripe_count=4)
    img = p.Image(io, "striped")
    data = bytes(range(256)) * 64
    img.write(0, data)
    got = img.read(0, len(data))
    objs = {e.objectno for e in side.p.osdc.Striper.file_to_extents(
        img.layout, 0, len(data))}
    img.close()
    assert got == data and objs == {0, 1, 2, 3}
    return sha(got), sorted(objs)


def r_resize_clip(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "rsz", size=1 << 18, order=16)
    img = p.Image(io, "rsz")
    n = img.write((1 << 18) - 100, b"y" * 500)
    tail = img.read((1 << 18) - 100, 100)
    img.resize(1 << 19)
    grown = p.Image(io, "rsz").size
    img.resize(1 << 16)
    img2 = p.Image(io, "rsz")
    out = (n, tail, grown, img2.size, attempt(side, img2.read, 1 << 17, 10))
    assert out[1:4] == (b"y" * 100, 1 << 19, 1 << 16)
    assert out[4][:2] == ("err", 22)
    return out


def r_discard_remove(side):
    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "disc", size=1 << 18, order=16)
    img = p.Image(io, "disc")
    img.write(0, b"z" * (1 << 17))
    img.discard(0, 1 << 16)
    got = [img.read(0, 1 << 16), img.read(1 << 16, 1 << 16)]
    p.RBD().remove(io, "disc")
    out = (got, "disc" in p.RBD().list(io),
           attempt(side, p.Image, io, "disc"))
    assert got == [b"\0" * (1 << 16), b"z" * (1 << 16)]
    assert out[1] is False and out[2][:2] == ("err", 2)
    return out


def r_perf_counters(side):
    io = side.io("rbd")
    io.write_full("pobj", b"q" * 4096)
    io.read("pobj")
    dump = side.c.perf_collection.perf_dump()
    osd_dumps = [v for k, v in dump.items() if k.startswith("osd.")]
    out = [bool(osd_dumps)] + [
        sum(d[key] for d in osd_dumps) >= least
        for key, least in (("op", 1), ("op_w_bytes", 4096),
                           ("op_r_bytes", 4096), ("subop_w", 1),
                           ("map_epochs", 1))]
    assert all(out)
    # the port's daemons count more (push_in, queued_op_failures, ...):
    # every key of the reference's dump is in the port's too
    return out, [key in osd_dumps[0] for key in (
        "map_epochs", "op", "op_lat_client", "op_r", "op_r_bytes", "op_w",
        "op_w_bytes", "recovery_bytes_read", "recovery_bytes_rebuilt",
        "recovery_pull", "recovery_push", "subop_w")]


RBD_STRIPER_CASES = [r_create_open_stat_list, r_spanning, r_striped,
                     r_resize_clip, r_discard_remove, r_perf_counters]


@pytest.mark.parametrize("case", RBD_STRIPER_CASES, ids=lambda f: f.__name__)
def test_rbd_image_io_equal_reference(sides, case):
    """tests/test_rbd_striper.py's image and perf-counter cases."""
    run_both(sides, case)


# ---------------------- tests/test_object_cacher.py's rbd user of the cacher

def c_ops_reduction(side):
    p = side.p
    cfg = p.config()
    io = side.io("rbd")
    n, chunk = 128, 4096
    counts = {}
    try:
        for cached in (False, True):
            cfg.set("rbd_cache", cached)
            name = f"img-{cached}"
            p.RBD().create(io, name, size=1 << 22, order=20)
            img = p.Image(io, name)
            w0 = sum(d.perf.get("op_w") for d in side.c.osds.values())
            for i in range(n):
                img.write(i * chunk, bytes([i % 256]) * chunk)
            if cached:
                img.flush()
            counts[cached] = sum(d.perf.get("op_w")
                                 for d in side.c.osds.values()) - w0
            got = img.read(0, n * chunk)
            assert got == b"".join(bytes([i % 256]) * chunk
                                   for i in range(n))
            img.close()
    finally:
        cfg.set("rbd_cache", True)
    assert counts[True] * 4 <= counts[False], counts
    return counts


def test_rbd_sequential_write_ops_reduction(sides):
    """Cached sequential writes reach RADOS as far fewer ops than the
    uncached path sends, and the same number in both packages."""
    counts = run_both(sides, c_ops_reduction)
    assert counts[False] == 128 + 1


# -------------------------------------------- the port's own two cases

def test_no_error_was_swallowed():
    """Every case above left the port's swallowed-error counters at 0
    for errnos other than ENOENT (journal and rbd)."""
    assert sum(port_image.SWALLOWED.values()) == 0, port_image.SWALLOWED
    assert sum(port_journal.SWALLOWED.values()) == 0, port_journal.SWALLOWED


def lock_across_interval(side) -> dict:
    """Client A holds `vm`'s exclusive lock; a replica of the header's PG
    goes out (a new interval, the primary stays); client B writes."""
    p = side.p
    r_a, r_b = side.c.rados(), side.c.rados()
    io_a, io_b = r_a.open_ioctx("rbd"), r_b.open_ioctx("rbd")
    p.RBD().create(io_a, "vm", size=1 << 20, order=ORDER)
    a = p.Image(io_a, "vm")
    a.write(0, b"A" * 100)
    hdr = p.image.header_name("vm")
    pid = side.r.pool_lookup("rbd")
    m = side.r.objecter.osdmap
    raw = m.object_locator_to_pg(hdr, pid)
    _, _, acting, primary = m.pg_to_up_acting_osds(raw)
    replica = acting[-1]
    e0 = m.epoch
    side.r.mon_command({"prefix": "osd out", "ids": [replica]})
    for cl in (side.r, r_a, r_b):
        cl.objecter.wait_for_map(e0 + 1)
    m = side.r.objecter.osdmap
    _, _, acting2, primary2 = m.pg_to_up_acting_osds(raw)
    assert primary2 == primary and replica not in acting2
    # the header's PG peered again in its new interval
    deadline = time.monotonic() + 30.0
    while True:
        try:
            io_b.stat(hdr)
            break
        except side.p.RadosError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    b = p.Image(io_b, "vm")
    b.write(100, b"B" * 100)
    lockers = io_b.exec(hdr, "lock", "get_info",
                        {"name": p.image.RBD_LOCK_NAME})["lockers"]
    out = {"a_believes_it_holds": a.lock_owner, "b_holds": b.lock_owner,
           "lockers": [lk["client"] == r_b.objecter.name
                       for lk in lockers],
           "read": b.read(0, 200)}
    b.close()
    return out


def test_exclusive_lock_across_a_new_interval_under_the_same_primary():
    """The same schedule on both packages.  The reference's primary
    rebuilds the header PG's state without its watchers, so B's
    request_lock notify finds nobody and B breaks A's live lock: A still
    believes it holds it, and A's cached write is lost.  The port's
    primary keeps the watchers across the interval, so A answers,
    flushes, hands the lock over, and nothing is broken."""
    sides = make_sides(4, {"rbd": 8})
    try:
        broken0 = port_image.LOCKS["broken"]
        handed0 = port_image.LOCKS["released_on_request"]
        got = {kind: lock_across_interval(side)
               for kind, side in sides.items()}
    finally:
        for s in sides.values():
            s.shutdown()
    # A's write sat in its write-back cache; its lock was broken, not
    # released, so the write never landed
    assert got["ref"] == {"a_believes_it_holds": True, "b_holds": True,
                          "lockers": [True],
                          "read": b"\0" * 100 + b"B" * 100}
    assert got["port"] == {"a_believes_it_holds": False, "b_holds": True,
                           "lockers": [True],
                           "read": b"A" * 100 + b"B" * 100}
    assert port_image.LOCKS["broken"] == broken0
    assert port_image.LOCKS["released_on_request"] == handed0 + 1


def test_smoke_rbd_cli_text_equals_reference(sides, capsys):
    """chip_smoke.py's phase 20 (c) `rbd` verbs, with the text the smoke
    holds their processes to: both packages' CLIs print exactly that."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_steps", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def case(side):
        side.r.pool_create("reppool", pg_num=8)
        r = side.c.rados()
        got = []
        for argv, _want in smoke.RBD_CLI_STEPS:
            buf = _io_mod.StringIO()
            capsys.readouterr()
            rc = side.p.cli.main(["-p", "reppool", *argv], rados=r, out=buf)
            got.append((rc, buf.getvalue(), capsys.readouterr().err))
        r.shutdown()
        return got
    got = run_both(sides, case, pools=["reppool"])
    assert got == [(0, want, "") for _argv, want in smoke.RBD_CLI_STEPS]


def c_concurrent_writers(side):
    """16 threads share one cached image: each writes 8 seeded 4 KiB
    blocks of its own while a reader thread reads the image (its cache
    misses can flush and evict), with a short switch interval."""
    import sys
    import threading

    p = side.p
    io = side.io("rbd")
    p.RBD().create(io, "shared", size=1 << 22, order=ORDER)
    img = p.Image(io, "shared")
    rng = np.random.default_rng(31)
    slots = rng.permutation(1 << 10)[:16 * 8].reshape(16, 8)
    blocks = {int(b) * 4096: rng.bytes(4096) for b in slots.ravel()}
    errors: list = []
    stop = threading.Event()

    def writer(row):
        try:
            for b in row:
                img.write(int(b) * 4096, blocks[int(b) * 4096])
        except Exception as e:          # reported below
            errors.append(repr(e))

    def reader():
        try:
            while not stop.is_set():
                img.read(0, 1 << 22)
        except Exception as e:          # reported below
            errors.append(repr(e))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        rd = threading.Thread(target=reader)
        rd.start()
        ws = [threading.Thread(target=writer, args=(row,)) for row in slots]
        for t in ws:
            t.start()
        for t in ws:
            t.join(timeout=60.0)
        stop.set()
        rd.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not rd.is_alive() and not any(t.is_alive() for t in ws)
    assert errors == []
    img.close()
    model = bytearray(1 << 22)
    for off, data in blocks.items():
        model[off:off + 4096] = data
    fresh = p.Image(io, "shared")
    got = fresh.read(0, 1 << 22)
    fresh.close()
    assert got == bytes(model)
    return sha(got)


def test_concurrent_writers_on_one_cached_image(sides):
    """Concurrent writers and a reader on one image (the port sends its
    write-back flushes as aio): the same bytes and objects as the
    reference."""
    run_both(sides, c_concurrent_writers)
