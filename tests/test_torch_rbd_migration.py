"""The port's live migration (`ceph_tpu_torch.rbd.migration`) held to the
reference's at tolerance 0.

Every case of tests/test_rbd_migration.py runs once on each package's
threaded `MiniCluster` (4 OSDs, pools `rbd-a` and `rbd-b` of pg_num 8,
the port's on `device="cpu"`), and the reference's assertions hold on
both: each read, each refusal's errno and text, and afterwards both
pools' objects (names, bytes, xattrs, omap, clones; the helpers of
tests/test_torch_rbd.py) are equal.  One more case writes from a second
client while `migration_execute` runs, as the smoke's leg does.
"""
import threading

import numpy as np
import pytest

from test_torch_rbd import attempt, make_sides, run_both, sha


@pytest.fixture(scope="module")
def sides():
    out = make_sides(4, {"rbd-a": 8, "rbd-b": 8})
    yield out
    for s in out.values():
        s.shutdown()


def mk_image(side, pool, name, mib=4, seed=1):
    p = side.p
    io = side.r.open_ioctx(pool)
    p.RBD().create(io, name, mib << 20, order=20)
    img = p.Image(io, name)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, mib << 20, dtype=np.uint8).tobytes()
    img.write(0, data)
    img.flush()
    img.release_lock()
    img.close()
    return io, data


def c_full_cycle(side):
    p = side.p
    src_io, data = mk_image(side, "rbd-a", "mover", seed=7)
    dst_io = side.r.open_ioctx("rbd-b")
    rbd = p.RBD()
    rbd.migration_prepare(src_io, "mover", dst_io, "mover")
    out = {"src_open": attempt(side, p.Image, src_io, "mover")}
    img = p.Image(dst_io, "mover")
    expected = bytearray(data)
    img.write(123456, b"during-migration-1")
    expected[123456:123456 + 18] = b"during-migration-1"
    out["first"] = img.read(0, 1 << 20) == bytes(expected[:1 << 20])
    rbd.migration_execute(dst_io, "mover")
    img.write((3 << 20) + 5, b"during-migration-2")
    expected[(3 << 20) + 5:(3 << 20) + 23] = b"during-migration-2"
    img.flush()
    rbd.migration_commit(dst_io, "mover")
    out["after_commit"] = sha(img.read(0, len(expected)))
    img.close()
    out["src_gone"] = attempt(side, p.Image, src_io, "mover")
    img2 = p.Image(dst_io, "mover")
    out["standalone"] = (img2.parent, sha(img2.read(0, len(expected))))
    img2.close()
    assert out["src_open"][:2] == ("err", 30) and out["first"]
    assert out["after_commit"] == sha(bytes(expected))
    assert out["src_gone"][:2] == ("err", 2)
    assert out["standalone"] == (None, sha(bytes(expected)))
    return out


def c_abort(side):
    p = side.p
    src_io, data = mk_image(side, "rbd-a", "undo", seed=13)
    dst_io = side.r.open_ioctx("rbd-b")
    rbd = p.RBD()
    rbd.migration_prepare(src_io, "undo", dst_io, "undo")
    img = p.Image(dst_io, "undo")
    img.write(0, b"scribble on the destination")
    img.flush()
    img.close()
    rbd.migration_abort(dst_io, "undo")
    gone = attempt(side, p.Image, dst_io, "undo")
    img = p.Image(src_io, "undo")
    back = img.read(0, len(data))
    img.close()
    assert gone[:2] == ("err", 2) and back == data
    return gone, sha(back)


def c_guards(side):
    p = side.p
    rbd = p.RBD()
    src_io, _ = mk_image(side, "rbd-a", "guarded", mib=1, seed=3)
    dst_io = side.r.open_ioctx("rbd-b")
    img = p.Image(src_io, "guarded")
    img.snap_create("s1")
    img.close()
    out = {"snapshots": attempt(side, rbd.migration_prepare, src_io,
                                "guarded", dst_io, "g2")}
    img = p.Image(src_io, "guarded")
    img.snap_remove("s1")
    img.close()
    img = p.Image(src_io, "guarded")
    img.write(0, b"live")
    out["writer"] = attempt(side, rbd.migration_prepare, src_io, "guarded",
                            dst_io, "g2")
    img.release_lock()
    img.close()
    rbd.migration_prepare(src_io, "guarded", dst_io, "g2")
    out["early_commit"] = attempt(side, rbd.migration_commit, dst_io, "g2")
    out["again"] = attempt(side, rbd.migration_prepare, src_io, "guarded",
                           dst_io, "g3")
    out["not_a_destination"] = attempt(side, rbd.migration_execute,
                                       src_io, "nobody")
    rbd.migration_abort(dst_io, "g2")
    out["read"] = p.Image(src_io, "guarded").read(0, 4)
    assert out["snapshots"][:2] == ("err", 95)
    assert out["writer"][:2] == ("err", 16)
    assert out["early_commit"][:2] == ("err", 22)
    assert out["again"][:2] == ("err", 16)
    assert out["read"] == b"live"
    return out


def c_journaled_refused(side):
    """Journaled and mirrored sources refuse with EOPNOTSUPP."""
    p = side.p
    io = side.r.open_ioctx("rbd-a")
    p.RBD().create(io, "jsrc", 1 << 20, order=20, journaling=True)
    dst = side.r.open_ioctx("rbd-b")
    got = attempt(side, p.RBD().migration_prepare, io, "jsrc", dst, "jdst")
    assert got[:2] == ("err", 95)
    return got


@pytest.mark.parametrize("case", [c_full_cycle, c_abort, c_guards,
                                  c_journaled_refused],
                         ids=lambda f: f.__name__)
def test_migration_equals_reference(sides, case):
    """tests/test_rbd_migration.py, case by case, and the journaled
    source's refusal."""
    run_both(sides, case)


def c_concurrent(side):
    """Two clients on the destination: one writes 4 KiB blocks while the
    other runs `migration_execute`; the image reads back as the model."""
    p = side.p
    src_io, data = mk_image(side, "rbd-a", "busy", mib=4, seed=21)
    dst_io = side.r.open_ioctx("rbd-b")
    p.RBD().migration_prepare(src_io, "busy", dst_io, "busy")
    rng = np.random.default_rng(22)
    offs = sorted(int(o) * 4096 for o in
                  rng.choice(1024, size=32, replace=False))
    blocks = [rng.bytes(4096) for _ in offs]
    writer = p.Image(side.c.rados().open_ioctx("rbd-b"), "busy")
    errors = []

    def write_all():
        try:
            for off, blk in zip(offs, blocks):
                writer.write(off, blk)
            writer.flush()
        except Exception as e:        # noqa: BLE001 - reported below
            errors.append(repr(e))
    t = threading.Thread(target=write_all)
    t.start()
    p.RBD().migration_execute(dst_io, "busy")
    t.join()
    writer.close()
    p.RBD().migration_commit(dst_io, "busy")
    expected = bytearray(data)
    for off, blk in zip(offs, blocks):
        expected[off:off + 4096] = blk
    img = p.Image(dst_io, "busy")
    got = img.read(0, len(expected))
    img.close()
    assert errors == [] and got == bytes(expected)
    return sha(got)


def test_writes_during_execute_equal_reference(sides):
    run_both(sides, c_concurrent)
