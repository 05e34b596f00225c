"""The port's file system (`ceph_tpu_torch.fs`) held to the reference's
(`ceph_tpu.fs`) at tolerance 0.

Every case of tests/test_cephfs.py runs once on each package: an MDS and
clients over the reference's threaded `MiniCluster` and over the port's
(`device="cpu"`), and the reference's own assertions hold on both.  Then
the two sides must agree on:

* the replies: every metadata call a client made from the test's thread
  (op, arguments, and the reply or its errno) and every file read
  (sha256 of the bytes); an EAGAIN is not recorded, since the MDS
  answers it while it revokes caps and how often the client retries
  depends on the revoke's timing;
* the metadata pool, object by object: its bytes (the journal's frames),
  its omap (every dirfrag's dentries, the itable, the snap table, the
  subtree tables, the journal header) and its omap header (the dirfrag
  bits); the completed-request tables are compared as each client's
  replies in order, since a request id counts every call the client
  made, EAGAIN retries included; the balancer's `mds.load` is compared by
  rank and stamp, since a rank's load counts the ops it served before
  its tick, and a revoked handle's `reopen` from its cap thread may land
  before or after that tick;
* the data pool: every object's bytes (sha256), and on a replicated pool
  its clones (`list_snaps`).

What cannot be seeded is seeded alike on both sides by patching the
stdlib name the MDS uses, never its code: `time` in `fs.mds` is a clock
that starts at one instant for both sides and moves one millisecond per
`time()` call (every mtime and snap stamp).  Masked, because they differ
by process and by what else ran in it: client entity names (each side
names its clients in the order `MiniCluster.rados()` made them), client
session nonces (in the order the sessions were made) and MDS gids (an
fsmap is compared by rank, daemon name and state).

Where the reference's schedule races (writer threads against one
another), a case runs on a cluster of its own and each side's record is
what the race must keep; both must agree on it.

The port's own pins, in this file: a file schedule on a `tpu` k=2 m=1
erasure-coded data pool leaves every data object's shards equal in both
packages; `mksnap` on such a file system is answered EOPNOTSUPP by the
port, where the reference's MDS raises on its dispatch thread and its
client times out; and no case swallows a RadosError (`fs.SWALLOWED`
stays as it was).

The helpers here (`Side`, `sides`, `run_both`, `fs_state`) serve the
other `tests/test_torch_{cephfs_*,mds_*,multimds}.py` files too.
"""
import hashlib
import json
import re
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ceph_tpu.common.options as ref_options
import ceph_tpu.fs as ref_fs
import ceph_tpu.fs.client as ref_client
import ceph_tpu.fs.mds as ref_mds
import ceph_tpu.msg.messages as ref_messages
import ceph_tpu.msg.messenger as ref_messenger
import ceph_tpu.testing.thrasher as ref_thrasher
import ceph_tpu_torch.common.options as port_options
import ceph_tpu_torch.fs as port_fs
import ceph_tpu_torch.fs.client as port_client
import ceph_tpu_torch.fs.mds as port_mds
import ceph_tpu_torch.msg.messages as port_messages
import ceph_tpu_torch.msg.messenger as port_messenger
import ceph_tpu_torch.testing.thrasher as port_thrasher
from ceph_tpu.common.lockdep import make_lock
from ceph_tpu.osd.ec_backend import pg_cid as ref_pg_cid
from ceph_tpu.store import ObjectId as RefObjectId
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.osd.ec_backend import pg_cid as port_pg_cid
from ceph_tpu_torch.store import ObjectId as PortObjectId
from ceph_tpu_torch.testing import MiniCluster as PortCluster

KINDS = ("ref", "port")
PKG = {
    "ref": SimpleNamespace(
        fs=ref_fs, mds=ref_mds, client=ref_client, messages=ref_messages,
        messenger=ref_messenger,
        thrasher=ref_thrasher, options=ref_options,
        CephFS=ref_fs.CephFS, MDSDaemon=ref_fs.MDSDaemon,
        MDSStandby=ref_fs.MDSStandby, CephFSError=ref_client.CephFSError,
        MDSThrasher=ref_thrasher.MDSThrasher, Cluster=RefCluster,
        pg_cid=ref_pg_cid, ObjectId=RefObjectId, kw={}),
    "port": SimpleNamespace(
        fs=port_fs, mds=port_mds, client=port_client,
        messages=port_messages, messenger=port_messenger,
        thrasher=port_thrasher,
        options=port_options, CephFS=port_fs.CephFS,
        MDSDaemon=port_fs.MDSDaemon, MDSStandby=port_fs.MDSStandby,
        CephFSError=port_client.CephFSError,
        MDSThrasher=port_thrasher.MDSThrasher, Cluster=PortCluster,
        pg_cid=port_pg_cid, ObjectId=PortObjectId,
        kw={"device": "cpu"})}
#: one instant for both sides' clocks, in ms
BASE_MS = int(time.time()) * 1000
META, DATA = "cephfs_metadata", "cephfs_data"
_CLIENT = re.compile(r"client\.[\w]+")
_NONCE = re.compile(r"[0-9a-f]+-[0-9a-f]{6}-\d+")


class Clock:
    """Stands in for the `time` module in `fs.mds`: `time()` moves one
    millisecond per call from BASE_MS; the rest is the real module."""

    def __init__(self):
        self._ms = BASE_MS
        self._lock = make_lock("test.fs.clock")

    def time(self) -> float:
        with self._lock:
            self._ms += 1
            return self._ms / 1000.0

    def __getattr__(self, name):
        return getattr(time, name)


def sha(data: bytes) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()


def _main() -> bool:
    return threading.current_thread() is threading.main_thread()


class Side:
    """One package's harness: its seeded clock, the aliases of its client
    names and session nonces, and the record of what its clients were
    answered.  `c`, `mds` and `fs` are a module's shared cluster, MDS and
    client when the module has one."""

    def __init__(self, kind: str, mp: pytest.MonkeyPatch):
        self.kind, self.p = kind, PKG[kind]
        self.log: list = []
        self.names: dict[str, str] = {}
        self.nonces: dict[str, str] = {}
        self.clusters: list = []
        self.c = self.mds = self.fs = None
        mp.setattr(self.p.mds, "time", Clock())
        self._patch(mp)

    def _patch(self, mp) -> None:
        side, p = self, self.p
        rados0 = p.Cluster.rados

        def rados(c, *a, **kw):
            r = rados0(c, *a, **kw)
            side.names.setdefault(r.objecter.name,
                                  f"client.<{len(side.names) + 1}>")
            return r

        mp.setattr(p.Cluster, "rados", rados)
        sess = p.client._MDSSession
        init0, call0 = sess.__init__, sess.call

        def init(s, *a, **kw):
            init0(s, *a, **kw)
            side.nonces.setdefault(s._nonce, f"<s{len(side.nonces) + 1}>")

        def call(s, op, args, timeout=30.0):
            try:
                out = call0(s, op, args, timeout)
            except p.CephFSError as e:
                # an EAGAIN is the MDS revoking caps: the client retries,
                # and how often depends on the revoke's timing
                if _main() and e.errno_name != "EAGAIN":
                    side.log.append([op, args, "error", e.errno_name])
                raise
            except TimeoutError:
                if _main():
                    side.log.append([op, args, "timeout"])
                raise
            if _main():
                side.log.append([op, args, out])
            return out

        mp.setattr(sess, "__init__", init)
        mp.setattr(sess, "call", call)
        read0 = p.client.FileHandle.read

        def read(fh, offset, length=0):
            data = read0(fh, offset, length)
            if _main():
                side.log.append(["read", fh.path, offset, length,
                                 sha(data)])
            return data

        mp.setattr(p.client.FileHandle, "read", read)

    # ------------------------------------------------------ clusters
    def cluster(self, n_osd: int = 4, **kw):
        c = self.p.Cluster(n_osd=n_osd, threaded=True, **self.p.kw, **kw)
        self.clusters.append(c)
        c.wait_all_up()
        return c

    def new_fs(self, c=None):
        return self.p.CephFS((c or self.c).rados())

    def shutdown(self) -> None:
        for c in self.clusters:
            c.shutdown()

    # ------------------------------------------------------- masking
    def mask(self, text: str) -> str:
        text = _CLIENT.sub(lambda m: self.names.get(m.group(0),
                                                    m.group(0)), text)
        return _NONCE.sub(lambda m: self.nonces.get(m.group(0),
                                                    m.group(0)), text)

    def norm(self, value):
        """A JSON-able value with names and nonces masked."""
        return json.loads(self.mask(json.dumps(value, sort_keys=True,
                                               default=repr)))


def omap_all(io, oid) -> dict:
    vals, _more = io.get_omap_vals(oid)
    return {k: bytes(v) for k, v in vals.items()}


def fs_state(s, r, data_pool: str = DATA, meta_pool: str = META) -> dict:
    """Every object of the metadata and data pools, names masked."""
    out = {"meta": {}, "data": {}}
    meta = r.open_ioctx(meta_pool)
    for oid in meta.list_objects():
        omap = omap_all(meta, oid)
        if oid.startswith("mds.completed."):
            # client -> its replies, in the order they were recorded
            shown = {s.mask(k): [s.norm(v) for v in
                                 json.loads(raw).values()]
                     for k, raw in omap.items()}
        elif oid == "mds.load":
            # rank -> its stamp; the load itself counts the ops the rank
            # served before its tick, the cap threads' reopens included
            shown = {k: json.loads(v)["stamp"] for k, v in omap.items()}
        else:
            shown = {s.mask(k): s.mask(v.decode("latin-1"))
                     for k, v in omap.items()}
        out["meta"][oid] = {
            "sha": sha(meta.read(oid)), "omap": shown,
            "hdr": bytes(meta.get_omap_header(oid)).decode("latin-1")}
    data = r.open_ioctx(data_pool)
    ec = r.objecter.osdmap.pools[data.pool_id].type != 1
    for oid in data.list_objects():
        ent = {"sha": sha(data.read(oid))}
        if not ec:
            ent["snaps"] = s.norm(data.list_snaps(oid))
        out["data"][oid] = ent
    return out


def fsmap_view(m) -> dict:
    """An fsmap without gids: rank -> (daemon name, state), and the
    standbys' names."""
    return {"ranks": {r: [i.name, i.state] for r, i in sorted(m.ranks.items())},
            "standbys": sorted(i.name for i in m.standbys.values())}


def run_both(sides, case, state: bool = True):
    """`case(side)` on each side: its record, the replies its clients
    got and (with `state`) both pools of the side's shared cluster must
    be equal, and the port must swallow no RadosError.  A case on a
    cluster of its own returns its state in its record."""
    before = sum(port_mds.SWALLOWED.values())
    got = {}
    for kind, s in sides.items():
        start = len(s.log)
        rec = case(s)
        got[kind] = {"rec": s.norm(rec), "replies": s.norm(s.log[start:])}
        if state:
            got[kind]["state"] = fs_state(s, s.fs.rados)
    for key in got["ref"]:
        assert got["port"][key] == got["ref"][key], key
    assert sum(port_mds.SWALLOWED.values()) == before, port_mds.SWALLOWED
    return got["port"]


def sides_with(mds_kw=None, n_osd: int = 4, setup=None):
    """Both sides for one module: a threaded cluster, an MDS and a
    client each (the reference file's module fixture)."""
    mp = pytest.MonkeyPatch()
    out = {}
    for kind in KINDS:
        s = Side(kind, mp)
        if setup is not None:
            setup(s)
        s.c = s.cluster(n_osd=n_osd)
        s.mds = s.p.MDSDaemon(s.c.network, s.c.rados(), **(mds_kw or {}))
        s.mds.init()
        s.fs = s.new_fs()
        out[kind] = s
    return out, mp


def close_sides(out, mp) -> None:
    for s in out.values():
        if s.mds is not None:
            s.mds.shutdown()
        s.shutdown()
    mp.undo()


@pytest.fixture(scope="module")
def sides():
    out, mp = sides_with()
    yield out
    close_sides(out, mp)


@pytest.fixture()
def bare_sides():
    """Both sides' harnesses with no cluster (cases that make their own)."""
    mp = pytest.MonkeyPatch()
    out = {kind: Side(kind, mp) for kind in KINDS}
    yield out
    for s in out.values():
        s.shutdown()
    mp.undo()


def data_objs(s, fs, ino, pool=DATA) -> list:
    io = fs.rados.open_ioctx(pool)
    return [o for o in io.list_objects() if o.startswith(f"{ino:x}.")]


# ------------------------------------------------------- test_cephfs

def c_namespace_crud(s):
    fs = s.fs
    fs.mkdir("/a")
    fs.mkdirs("/a/b/c")
    assert fs.listdir("/a") == ["b"]
    assert fs.listdir("/a/b") == ["c"]
    with pytest.raises(s.p.CephFSError, match="EEXIST"):
        fs.mkdir("/a")
    with pytest.raises(s.p.CephFSError, match="ENOENT"):
        fs.listdir("/nope")
    st = fs.stat("/a/b")
    assert st["type"] == "d"
    fs.rmdir("/a/b/c")
    assert fs.listdir("/a/b") == []
    with pytest.raises(s.p.CephFSError, match="ENOTEMPTY"):
        fs.rmdir("/a")
    return st


def test_namespace_crud(sides):
    run_both(sides, c_namespace_crud)


def c_file_io_striped(s):
    fs = s.fs
    fs.mkdirs("/data")
    payload = np.random.default_rng(5).integers(
        0, 256, 300_000, dtype=np.uint8).tobytes()
    fs.write_file("/data/blob.bin", payload)
    assert fs.read_file("/data/blob.bin") == payload
    st = fs.stat("/data/blob.bin")
    assert st["type"] == "f" and st["size"] == len(payload)
    fh = fs.open("/data/blob.bin")
    assert fh.read(1000, 500) == payload[1000:1500]
    fh = fs.open("/data/blob.bin", "r+")
    fh.write(100, b"PATCH")
    fh.close()
    patched = fs.read_file("/data/blob.bin")
    assert patched[100:105] == b"PATCH"
    assert patched[:100] == payload[:100]
    assert patched[105:] == payload[105:]
    objs = data_objs(s, fs, st["ino"])
    assert len(objs) > 1
    return objs


def test_file_io_striped(sides):
    run_both(sides, c_file_io_striped)


def c_open_w_truncates(s):
    fs = s.fs
    fs.mkdirs("/t")
    fs.write_file("/t/f", b"A" * 200_000)
    fs.write_file("/t/f", b"short")
    assert fs.read_file("/t/f") == b"short"
    assert fs.stat("/t/f")["size"] == 5
    objs = data_objs(s, fs, fs.stat("/t/f")["ino"])
    assert len(objs) == 1
    fh = fs.open("/t/f", "a")
    assert fh.size == 5
    return objs


def test_open_w_truncates(sides):
    run_both(sides, c_open_w_truncates)


def c_rename_and_unlink(s):
    fs = s.fs
    fs.mkdirs("/r")
    fs.write_file("/r/one", b"1st")
    fs.rename("/r/one", "/r/two")
    assert not fs.exists("/r/one")
    assert fs.read_file("/r/two") == b"1st"
    fs.write_file("/r/three", b"3rd")
    fs.rename("/r/two", "/r/three")
    assert fs.read_file("/r/three") == b"1st"
    st = fs.stat("/r/three")
    fs.unlink("/r/three")
    assert not fs.exists("/r/three")
    assert not data_objs(s, fs, st["ino"])
    with pytest.raises(s.p.CephFSError, match="ENOENT"):
        fs.unlink("/r/three")
    return st


def test_rename_and_unlink(sides):
    run_both(sides, c_rename_and_unlink)


def c_rename_self_and_subtree_guards(s):
    fs = s.fs
    fs.mkdirs("/g/sub")
    fs.write_file("/g/f", b"x")
    fs.rename("/g/f", "/g/f")
    assert fs.read_file("/g/f") == b"x"
    with pytest.raises(s.p.CephFSError, match="EINVAL"):
        fs.rename("/g", "/g/sub/g2")


def test_rename_self_and_subtree_guards(sides):
    run_both(sides, c_rename_self_and_subtree_guards)


def c_statfs(s):
    st = s.fs.statfs()
    assert st["files"] >= 0 and st["dirs"] >= 2
    return st


def test_statfs(sides):
    run_both(sides, c_statfs)


def c_mds_journal_replay(s):
    c = s.cluster(n_osd=2)
    mds = s.p.MDSDaemon(c.network, c.rados())
    mds.init()
    fs = s.new_fs(c)
    fs.mkdirs("/j/deep")
    fs.write_file("/j/deep/f", b"journaled")
    mds.ms.shutdown()               # hard stop: no flush
    mds2 = s.p.MDSDaemon(c.network, c.rados())
    mds2.init()
    fs2 = s.new_fs(c)
    assert fs2.listdir("/j/deep") == ["f"]
    assert fs2.read_file("/j/deep/f") == b"journaled"
    st_old = fs2.stat("/j/deep/f")
    fs2.write_file("/j/new", b"post-replay")
    assert fs2.stat("/j/new")["ino"] > st_old["ino"]
    state = fs_state(s, fs2.rados)
    mds2.shutdown()
    return state


def test_mds_journal_replay(bare_sides):
    run_both(bare_sides, c_mds_journal_replay, state=False)


# ------------------------------------------- the port's own pins

EC_PROFILE = {"prefix": "osd erasure-code-profile set", "name": "fsec",
              "profile": {"plugin": "tpu", "k": "2", "m": "1",
                          "technique": "reed_sol_van",
                          "crush-failure-domain": "osd"}}


def ec_fs_cluster(s):
    """A 4-OSD cluster whose `cephfs_data` is a `tpu` k=2 m=1 pool made
    before the MDS starts (the CephFS-on-EC layout), and its MDS."""
    c = s.cluster(n_osd=4)
    r = c.rados()
    rc, outs, _ = r.mon_command(EC_PROFILE)
    assert rc == 0, outs
    r.pool_create(DATA, pg_num=8, pool_type="erasure",
                  erasure_code_profile="fsec")
    mds = s.p.MDSDaemon(c.network, c.rados())
    mds.init()
    return c, r, mds


def ec_shards(s, c, r, pool, oid) -> dict:
    pid = r.pool_lookup(pool)
    m = c.mon.osdmap
    pg = m.pools[pid].raw_pg_to_pg(m.object_locator_to_pg(oid, pid))
    acting = m.pg_to_up_acting_osds(pg)[2]
    return {sh: sha(c.osds[o].store.read(s.p.pg_cid(pg),
                                         s.p.ObjectId(oid, shard=sh), 0, 0))
            for sh, o in enumerate(acting) if o >= 0}


def c_file_schedule_on_ec_data_pool(s):
    c, r, mds = ec_fs_cluster(s)
    fs = s.new_fs(c)
    payload = np.random.default_rng(20).integers(
        0, 256, 300_000, dtype=np.uint8).tobytes()
    fs.mkdirs("/ec/dir")
    fs.write_file("/ec/dir/big", payload)
    fh = fs.open("/ec/dir/big", "r+")
    fh.write(100, b"PATCH")             # a read-modify-write on the pool
    fh.close()
    want = payload[:100] + b"PATCH" + payload[105:]
    assert fs.read_file("/ec/dir/big") == want
    for i in range(4):
        fs.write_file(f"/ec/small{i}", bytes([65 + i]) * (4096 + 17 * i))
    fs.link("/ec/small0", "/ec/dir/hard")
    fs.rename("/ec/small1", "/ec/dir/moved")
    fs.unlink("/ec/small2")
    assert fs.read_file("/ec/dir/hard") == b"A" * 4096
    assert fs.read_file("/ec/dir/moved") == b"B" * 4113
    assert sorted(fs.listdir("/ec")) == ["dir", "small0", "small3"]
    state = fs_state(s, r)
    shards = {oid: ec_shards(s, c, r, DATA, oid)
              for oid in r.open_ioctx(DATA).list_objects()}
    assert shards and all(len(v) == 3 for v in shards.values())
    mds.shutdown()
    return {"state": state, "shards": shards}


def test_file_schedule_on_ec_data_pool(bare_sides):
    """The CephFS-on-EC layout: the same file schedule in both packages
    leaves every data object's three shards equal byte for byte."""
    run_both(bare_sides, c_file_schedule_on_ec_data_pool, state=False)


def c_mksnap_on_ec_data_pool(s):
    c, r, mds = ec_fs_cluster(s)
    fs = s.new_fs(c)
    fs.mkdirs("/snapdir")
    fs.write_file("/snapdir/f", b"data")
    t0 = time.monotonic()
    try:
        fs._session.call("mksnap", {"path": "/snapdir", "name": "s"},
                         timeout=2.0)
        outcome = "answered"
    except s.p.CephFSError as e:
        outcome = e.errno_name
    except TimeoutError:
        outcome = "timeout"
    waited = time.monotonic() - t0
    # nothing of the snap landed: no realm entry, no snapped dirfrag
    meta = r.open_ioctx(META)
    assert "mds.snaptable" not in meta.list_objects() or \
        not omap_all(meta, "mds.snaptable")
    assert not [o for o in meta.list_objects()
                if o.startswith("mds.snapdir.")]
    assert fs.read_file("/snapdir/f") == b"data"
    mds.shutdown()
    return outcome, waited


def test_mksnap_on_ec_data_pool_is_refused(bare_sides):
    """The EC data pool refuses self-managed snaps in both packages.
    The reference's MDS raises the mon's EOPNOTSUPP on its dispatch
    thread and answers nothing, so its client times out; the port's MDS
    answers EOPNOTSUPP at once.  Nothing of the snap lands in either."""
    got = {kind: c_mksnap_on_ec_data_pool(s)
           for kind, s in bare_sides.items()}
    assert got["ref"][0] == "timeout" and got["ref"][1] >= 2.0
    assert got["port"][0] == "EOPNOTSUPP" and got["port"][1] < 2.0
