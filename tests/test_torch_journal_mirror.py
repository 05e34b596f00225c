"""The port's journal (`ceph_tpu_torch.journal`) and rbd-mirror
(`ceph_tpu_torch.rbd.mirror`) held to the reference's at tolerance 0.

Every case of tests/test_journal_mirror.py runs once on each package's
threaded `MiniCluster` (4 OSDs, pools `primary` and `backup` of pg_num 8,
the port's on `device="cpu"`), and the reference's assertions hold on
both.  Equal on both sides: every entry replayed, every position and
commit position, trim counts, registered clients, image reads, each
mirror state (promotion epochs, `src_demoted`, `force_promoted`), each
refusal's errno and text (`SplitBrainError` included), and afterwards
both pools' objects: the journal headers' omap (clients, commit
positions, `first`/`active`) and every `journal_data.*` object's bytes,
with the image headers and object maps (the helpers of
tests/test_torch_rbd.py).  Promotion epochs are `uuid.uuid4()` ids: both
packages' `mirror.uuid` draw from one seeded sequence per side.  One
more case appends a seeded mix of entries at three object sizes and
holds the data objects' bytes and the roll-over to the reference's.
"""
import random
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_rbd import attempt, make_sides, run_both, sha


@pytest.fixture(scope="module")
def sides():
    out = make_sides(4, {"primary": 8, "backup": 8})
    yield out
    for s in out.values():
        s.shutdown()


def seed_uuids(side, monkeypatch, seed: int = 17) -> None:
    """`side`'s mirror module draws its promotion epochs from a seeded
    sequence (the same on both sides)."""
    rng = random.Random(seed)
    monkeypatch.setattr(side.p.mirror, "uuid", SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=rng.getrandbits(128), version=4)))


def run_mirror(sides, case, monkeypatch):
    def seeded(side):
        seed_uuids(side, monkeypatch)
        return case(side)
    return run_both(sides, seeded)


# ----------------------------------------------------------- the journal

def c_append_replay_commit_trim(side):
    J = side.p.journal.Journaler
    io = side.r.open_ioctx("primary")
    j = J(io, "t1", "master", object_size=256)
    j.create()
    j.register_client()
    positions = [j.append("ev", {"n": i, "blob": b"x" * 50})
                 for i in range(20)]
    got = []
    pos = j.replay(lambda tag, d: got.append((tag, d["n"])))
    j.commit(pos)
    j2 = J(io, "t1", "peer", object_size=256)
    j2.register_client()
    got2 = []
    pos2 = j2.replay(lambda tag, d: got2.append(d["n"]))
    j2.commit(pos2)
    removed = j.trim()
    positions.append(j.append("ev", {"n": 99, "blob": b""}))
    more = []
    j.replay(lambda tag, d: more.append(d["n"]), from_pos=pos)
    clients = j.clients()
    assert [n for _t, n in got] == list(range(20)) and got2 == list(range(20))
    assert removed > 0 and more == [99]
    assert set(clients) == {"master", "peer"}
    return positions, pos, pos2, removed, more, clients, \
        j.commit_position(), j2.commit_position(), j._range()


def c_torn_tail(side):
    jm = side.p.journal
    io = side.r.open_ioctx("primary")
    j = jm.Journaler(io, "torn", "master")
    j.create()
    j.register_client()
    end = j.append("ok", {"v": 1})
    io.append(jm.data_obj("torn", 0), b"\x00\x01\x02torn!")
    got = []
    pos = j.replay(lambda t, d: got.append(d["v"]))
    assert got == [1] and pos == end
    return got, pos


def c_head_pos(side, monkeypatch):
    p = side.p
    io = side.r.open_ioctx("primary")
    j = p.journal.Journaler(io, "headpos", "master")
    j.create()
    j.register_client()
    j.append("ev", {"v": 1})
    active, size = p.mirror._head_pos(j)
    out = {"head": (active, size)}

    def eio_stat(oid):
        raise p.RadosError("EIO", f"injected for {oid}")
    monkeypatch.setattr(j.io, "stat", eio_stat)
    out["eio"] = attempt(side, p.mirror._head_pos, j)

    def enoent_stat(oid):
        raise p.RadosError("ENOENT", oid)
    monkeypatch.setattr(j.io, "stat", enoent_stat)
    out["enoent"] = p.mirror._head_pos(j)
    assert size > 0 and out["eio"] == ("rados", "EIO")
    assert out["enoent"] == (active, 0)
    return out


def test_journal_append_replay_commit_trim(sides):
    run_both(sides, c_append_replay_commit_trim)


def test_journal_torn_tail(sides):
    run_both(sides, c_torn_tail)


def test_head_pos_propagates_non_enoent(sides, monkeypatch):
    run_both(sides, c_head_pos, monkeypatch)


@pytest.mark.parametrize("object_size", [256, 4096, 1 << 22])
def test_journal_objects_equal_reference(sides, object_size):
    """A seeded mix of 64 entries (writes of 0-3000 B, discards, snap
    events) through two clients: the data objects, their roll-over and
    every position equal the reference's."""
    def case(side):
        J = side.p.journal.Journaler
        io = side.r.open_ioctx("primary")
        jid = f"mix{object_size}"
        j = J(io, jid, "master", object_size=object_size)
        j.create()
        j.register_client()
        rng = np.random.default_rng(object_size)
        ends = []
        for i in range(64):
            kind = int(rng.integers(0, 3))
            if kind == 0:
                ends.append(j.append("write", {
                    "off": int(rng.integers(0, 1 << 30)),
                    "data": rng.bytes(int(rng.integers(0, 3000)))}))
            elif kind == 1:
                ends.append(j.append("discard", {
                    "off": int(rng.integers(0, 1 << 30)), "len": 4096}))
            else:
                ends.append(j.append("snap_create", {"name": f"s{i}"}))
        seen = []
        mirror = J(io, jid, "mirror", object_size=object_size)
        mirror.register_client()
        half = mirror.replay(lambda t, d: seen.append(t), from_pos=(0, 0))
        mirror.commit(ends[31])
        j.commit(half)
        trimmed = j.trim()
        tail = []
        mirror.replay(lambda t, d: tail.append(t))
        assert len(seen) == 64 and tail == seen[32:]
        return ends, half, trimmed, j._range(), sha(repr(seen).encode())
    run_both(sides, case, pools=["primary"])


# --------------------------------------------------------- rbd-mirror

def c_mirror_replicates(side):
    p = side.p
    r = side.c.rados()
    src, dst = r.open_ioctx("primary"), r.open_ioctx("backup")
    p.RBD().create(src, "vm", size=1 << 20, order=16, journaling=True)
    img = p.Image(src, "vm")
    rng = np.random.default_rng(6)
    b1 = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    img.write(0, b1)
    img.write(3 << 16, b"tail-block" * 100)
    m = p.mirror.ImageMirror(src, dst, "vm")
    out = {"applied": [m.sync()]}
    rep = p.Image(dst, "vm")
    out["first"] = (rep.read(0, 70_000) == b1,
                    rep.read(3 << 16, 1000))
    rep.close()
    img.write(100, b"UPDATED")
    img.discard(3 << 16, 1 << 16)
    img.snap_create("s1")
    out["applied"].append(m.sync())
    rep = p.Image(dst, "vm")
    out["second"] = (rep.read(100, 7), rep.read(3 << 16, 100),
                     rep.snap_list())
    rep.close()
    out["applied"].append(m.sync())
    img.snap_remove("s1")
    out["applied"].append(m.sync())
    img.close()
    out["clients"] = p.journal.Journaler(src, "rbd.vm", "x").clients()
    assert out["applied"][0] >= 2 and out["applied"][1] >= 3
    assert out["applied"][2:] == [0, 1]
    assert out["first"] == (True, (b"tail-block" * 100)[:1000])
    assert out["second"][:2] == (b"UPDATED", b"\0" * 100)
    assert [s["name"] for s in out["second"][2]] == ["s1"]
    return out


def test_rbd_mirror_replicates_image(sides, monkeypatch):
    run_mirror(sides, c_mirror_replicates, monkeypatch)


def c_failover(side):
    p = side.p
    mm = p.mirror
    r = side.c.rados()
    ioa, iob = r.open_ioctx("primary"), r.open_ioctx("backup")
    name = "failover-vm"
    p.RBD().create(ioa, name, size=1 << 20, order=16, journaling=True)
    mm.mirror_enable(ioa, name)
    a = p.Image(ioa, name)
    a.write(0, b"replicated-base " * 1000)
    m = mm.ImageMirror(ioa, iob, name)
    out = {"first_sync": m.sync()}
    a.write(1 << 17, b"DOOMED-UNREPLICATED" * 10)
    a.close()
    out["forced"] = mm.promote(iob, name, force=True)
    b = p.Image(iob, name)
    b.write(1 << 18, b"written-on-new-primary" * 10)
    out["b_read"] = b.read(0, 16)
    b.close()
    mm.demote(ioa, name)
    a = p.Image(ioa, name)
    out["demoted_write"] = attempt(side, a.write, 0, b"nope")
    a.close()
    m2 = mm.ImageMirror(iob, ioa, name)
    out["split_brain"] = attempt(side, m2.sync)
    out["copied"] = m2.resync()
    a = p.Image(ioa, name)
    out["after_resync"] = (a.read(1 << 18, 22), a.read(0, 16),
                           a.read(1 << 17, 6))
    a.close()
    b = p.Image(iob, name)
    b.write(0, b"post-resync-write")
    b.close()
    out["resumed"] = m2.sync()
    a = p.Image(ioa, name)
    out["final"] = a.read(0, 17)
    a.close()
    out["states"] = (mm.mirror_state(ioa, name), mm.mirror_state(iob, name))
    assert out["b_read"] == b"replicated-base "
    assert out["demoted_write"][:2] == ("err", 30)
    assert out["split_brain"][:2] == ("err", 11) and \
        "split-brain" in out["split_brain"][2]
    assert out["copied"] > 0
    assert out["after_resync"][:2] == (b"written-on-new-primary",
                                       b"replicated-base ")
    assert out["after_resync"][2] != b"DOOMED"
    assert out["resumed"] >= 1 and out["final"] == b"post-resync-write"
    assert not out["states"][0]["primary"] and out["states"][1]["primary"]
    return out


def test_mirror_failover_promote_demote_resync(sides, monkeypatch):
    run_mirror(sides, c_failover, monkeypatch)


def c_orderly_failback(side):
    p = side.p
    mm = p.mirror
    r = side.c.rados()
    ioa, iob = r.open_ioctx("primary"), r.open_ioctx("backup")
    name = "orderly-vm"
    p.RBD().create(ioa, name, size=1 << 19, order=16, journaling=True)
    mm.mirror_enable(ioa, name)
    a = p.Image(ioa, name)
    a.write(0, b"generation-one")
    a.close()
    m = mm.ImageMirror(ioa, iob, name)
    out = {"syncs": [m.sync()]}
    mm.demote(ioa, name)
    out["syncs"].append(m.sync())
    out["promoted"] = mm.promote(iob, name, force=False)
    b = p.Image(iob, name)
    b.write(0, b"generation-two!")
    b.close()
    m2 = mm.ImageMirror(iob, ioa, name)
    out["reverse"] = m2.sync()
    a = p.Image(ioa, name)
    out["read"] = a.read(0, 15)
    a.close()
    out["states"] = (mm.mirror_state(ioa, name), mm.mirror_state(iob, name))
    assert out["reverse"] >= 1 and out["read"] == b"generation-two!"
    assert not out["states"][0]["primary"] and out["states"][1]["primary"]
    return out


def test_mirror_orderly_failback(sides, monkeypatch):
    run_mirror(sides, c_orderly_failback, monkeypatch)


def c_drained_demotion(side):
    p = side.p
    mm = p.mirror
    r = side.c.rados()
    ioa, iob = r.open_ioctx("primary"), r.open_ioctx("backup")
    name = "drain-vm"
    p.RBD().create(ioa, name, size=1 << 19, order=16, journaling=True)
    mm.mirror_enable(ioa, name)
    a = p.Image(ioa, name)
    a.write(0, b"synced")
    a.close()
    m = mm.ImageMirror(ioa, iob, name)
    m.sync()
    a = p.Image(ioa, name)
    a.write(100, b"undrained")
    a.close()
    mm.demote(ioa, name)
    out = {"refused": attempt(side, mm.promote, iob, name, force=False)}
    out["drained"] = m.sync()
    out["promoted"] = mm.promote(iob, name, force=False)
    b = p.Image(iob, name)
    out["read"] = b.read(100, 9)
    b.close()
    assert out["refused"][:2] == ("err", 16) and \
        "demoted/drained" in out["refused"][2]
    assert out["read"] == b"undrained"
    return out


def test_clean_promote_requires_drained_demotion(sides, monkeypatch):
    run_mirror(sides, c_drained_demotion, monkeypatch)


def c_failover_abort(side):
    p = side.p
    mm = p.mirror
    r = side.c.rados()
    ioa, iob = r.open_ioctx("primary"), r.open_ioctx("backup")
    name = "abort-vm"
    p.RBD().create(ioa, name, size=1 << 19, order=16, journaling=True)
    mm.mirror_enable(ioa, name)
    a = p.Image(ioa, name)
    a.write(0, b"payload")
    a.close()
    m = mm.ImageMirror(ioa, iob, name)
    out = {"sync": m.sync()}
    mm.demote(ioa, name)
    out["repromoted"] = mm.promote(ioa, name, force=False)
    a = p.Image(ioa, name)
    a.write(32, b"more")
    a.close()
    mm.demote(ioa, name)
    out["refused"] = attempt(side, mm.promote, ioa, name, force=False)
    out["drained"] = m.sync()
    out["final"] = mm.promote(ioa, name, force=False)
    out["state"] = mm.mirror_state(ioa, name)
    assert out["refused"][:2] == ("err", 16)
    assert out["state"]["primary"]
    return out


def test_failover_abort_repromotes_drained_old_primary(sides, monkeypatch):
    run_mirror(sides, c_failover_abort, monkeypatch)


def c_corrupt_header(side):
    p = side.p
    io = side.r.open_ioctx("primary")
    p.RBD().create(io, "hdr-vm", size=1 << 18, order=16, journaling=True)
    out = {"size": p.mirror._load_meta(io, "hdr-vm")["size"]}
    io.write_full(p.image.header_name("hdr-vm"), b"\x00not json\xff")
    out["corrupt"] = attempt(side, p.mirror._load_meta, io, "hdr-vm")
    out["missing"] = attempt(side, p.mirror._load_meta, io, "no-such-vm")
    assert out["size"] == 1 << 18
    assert out["corrupt"][:2] == ("err", 5) and \
        "undecodable" in out["corrupt"][2]
    assert out["missing"][:2] == ("err", 2)
    return out


def test_load_meta_corrupt_header_is_eio_not_enoent(sides):
    run_both(sides, c_corrupt_header)


def c_refusals(side):
    """The mirror's refusals: no journal, resync of a primary."""
    p = side.p
    mm = p.mirror
    r = side.c.rados()
    ioa, iob = r.open_ioctx("primary"), r.open_ioctx("backup")
    p.RBD().create(ioa, "plain-vm", size=1 << 18, order=16)
    out = {"enable": attempt(side, mm.mirror_enable, ioa, "plain-vm"),
           "sync": attempt(side, mm.ImageMirror(ioa, iob, "plain-vm").sync)}
    p.RBD().create(ioa, "prim-vm", size=1 << 18, order=16, journaling=True)
    mm.mirror_enable(ioa, "prim-vm")
    p.RBD().create(iob, "prim-vm", size=1 << 18, order=16, journaling=True)
    mm.mirror_enable(iob, "prim-vm")
    out["resync_primary"] = attempt(
        side, mm.ImageMirror(ioa, iob, "prim-vm").resync)
    assert out["enable"][:2] == ("err", 22) and out["sync"][:2] == ("err", 22)
    assert out["resync_primary"][:2] == ("err", 16)
    return out


def test_mirror_refusals_equal_reference(sides, monkeypatch):
    run_mirror(sides, c_refusals, monkeypatch)
