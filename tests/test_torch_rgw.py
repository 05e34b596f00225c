"""The port's S3 gateway (`ceph_tpu_torch.rgw`) held to the reference's
(`ceph_tpu.rgw`) at tolerance 0.

Every case of tests/test_rgw.py, tests/test_rgw_auth_shards.py and
tests/test_rgw_concurrency.py runs the reference test's requests once
on each package: a gateway over the reference's threaded
`MiniCluster(n_osd=4)` and one over the port's (`device="cpu"`), and the
reference's own assertions hold on both.  What each client saw must
then be equal: every reply's status, headers and body.  After each case
the gateway's whole pool is compared too, once each gateway's deferred
GC has been drained: every RADOS object's bytes (sha256), xattrs and
omap, so the bucket registry and every index shard's entries are equal
byte for byte.

What cannot be seeded is seeded alike on both sides by patching the
stdlib names the modules use, never the modules' code: `uuid.uuid4`
(object generations, version and upload ids, the pusher's id, Swift
tokens) draws from one seeded stream per side; `time.time` in
`cls.rgw` (every index mtime), `rgw.sts` and `rgw.swift` is a clock
that starts at one instant for both sides and moves one millisecond
per call (a wait of the reference's test moves it instead); `time_ns`
in `rgw.notify` (the event sequencer) counts; `secrets` in `rgw.sts`
draws from a seeded stream.  Masked, because they cannot be seeded:
the `Date` header of every reply, the gateway's and a receiver's HTTP
port where a header, a body or an omap value holds it, and the
pusher's `lock.*` xattr on a notification queue (its stamp is the
wall clock).

Two gateways racing on one pool are not deterministic: there each
side's record is what the race must keep (every version id, every key),
and the sides must agree on it.

The port's own pins: `zone=` builds a zone member whose datalog is the
reference's (tests/test_torch_rgw_multisite.py holds the rest), the gateway's
admin socket serves the five obs commands and tracks a request as the
reference's does (tests/test_slow_ops.py's rgw case), and the radosgw
process (`python -m ceph_tpu_torch.rgw.gateway`) joins a cephx cluster
over TCP, serves a PUT, GET and listing, and exits 0 on SIGTERM.  No
case swallows a RadosError (`rgw.SWALLOWED` stays as it was).

The helpers here (the `sides` fixture, `run_both`, `req`) serve
tests/test_torch_rgw_versioning.py, tests/test_torch_rgw_notify.py and
tests/test_torch_rgw_sts_swift.py too.
"""
import base64
import hashlib
import http.client
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from types import SimpleNamespace
from xml.etree import ElementTree as ET

import pytest

import ceph_tpu.cls.rgw as ref_cls_rgw
import ceph_tpu.rgw.auth as ref_auth
import ceph_tpu.rgw.gateway as ref_gateway
import ceph_tpu.rgw.notify as ref_notify
import ceph_tpu.rgw.sts as ref_sts
import ceph_tpu.rgw.swift as ref_swift
import ceph_tpu_torch.cls.rgw as port_cls_rgw
import ceph_tpu_torch.rgw as port_rgw
import ceph_tpu_torch.rgw.auth as port_auth
import ceph_tpu_torch.rgw.gateway as port_gateway
import ceph_tpu_torch.rgw.notify as port_notify
import ceph_tpu_torch.rgw.sts as port_sts
import ceph_tpu_torch.rgw.swift as port_swift
from ceph_tpu.auth import KeyRing as RefKeyRing
from ceph_tpu.common.lockdep import make_lock
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.auth import KeyRing as PortKeyRing
from ceph_tpu_torch.testing import MiniCluster as PortCluster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("ref", "port")
PKG = {
    "ref": SimpleNamespace(
        cls_rgw=ref_cls_rgw, auth=ref_auth, gateway=ref_gateway,
        notify=ref_notify, sts=ref_sts, swift=ref_swift,
        RGWGateway=ref_gateway.RGWGateway, KeyRing=RefKeyRing,
        Cluster=RefCluster),
    "port": SimpleNamespace(
        cls_rgw=port_cls_rgw, auth=port_auth, gateway=port_gateway,
        notify=port_notify, sts=port_sts, swift=port_swift,
        RGWGateway=port_gateway.RGWGateway, KeyRing=PortKeyRing,
        Cluster=PortCluster)}
#: one instant for both sides' clocks, in ms
BASE_MS = int(time.time()) * 1000
#: keyring secrets, equal on both sides
SECRETS = {e: hashlib.sha256(e.encode()).hexdigest()[:32]
           for e in ("client.s3user", "client.s3", "client.ops",
                     "client.outsider", "client.swift")}


class Clock:
    """Stands in for the `time` module: `time()` moves one millisecond
    per call from BASE_MS, `advance(s)` moves it on; the rest is the
    real module."""

    def __init__(self):
        self._ms = BASE_MS
        self._lock = make_lock("test.rgw.clock")

    def time(self) -> float:
        with self._lock:
            self._ms += 1
            return self._ms / 1000.0

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._ms += int(seconds * 1000)

    def __getattr__(self, name):
        return getattr(time, name)


class NsClock:
    """`time` with a counting `time_ns` (the event sequencer)."""

    def __init__(self):
        self._ns = BASE_MS * 1_000_000
        self._lock = make_lock("test.rgw.ns_clock")

    def time_ns(self) -> int:
        with self._lock:
            self._ns += 1
            return self._ns

    def __getattr__(self, name):
        return getattr(time, name)


class SeededUUID:
    """`uuid` with a seeded `uuid4`."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self._lock = make_lock("test.rgw.uuid")

    def uuid4(self) -> uuid.UUID:
        with self._lock:
            return uuid.UUID(int=self._rng.getrandbits(128), version=4)

    def __getattr__(self, name):
        return getattr(uuid, name)


class SeededSecrets:
    """`secrets` with seeded `token_hex` / `token_urlsafe`."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def token_hex(self, n: int) -> str:
        return self._rng.randbytes(n).hex()

    def token_urlsafe(self, n: int) -> str:
        return base64.urlsafe_b64encode(
            self._rng.randbytes(n)).rstrip(b"=").decode()


class Side:
    """One package's threaded cluster, a client, its seeded stand-ins
    and the gateways a module's cases made."""

    def __init__(self, kind: str, mp: pytest.MonkeyPatch, seed: int = 18):
        self.kind, self.p = kind, PKG[kind]
        self.c = self.p.Cluster(n_osd=4, threaded=True) if kind == "ref" \
            else self.p.Cluster(n_osd=4, threaded=True, device="cpu")
        self.c.wait_all_up()
        self.r = self.c.rados()
        self.clock = Clock()
        self.uuid = SeededUUID(seed)
        mp.setattr(self.p.cls_rgw, "time", self.clock)
        mp.setattr(self.p.sts, "time", self.clock)
        mp.setattr(self.p.swift, "time", self.clock)
        mp.setattr(self.p.sts, "secrets", SeededSecrets(seed))
        mp.setattr(self.p.notify, "time", NsClock())
        for mod in (self.p.gateway, self.p.swift, self.p.notify):
            mp.setattr(mod, "uuid", self.uuid)
        self.gws: list = []
        self.masks: dict = {}

    def keyring(self, *entities):
        return self.p.KeyRing({e: SECRETS[e] for e in entities})

    def gw(self, pool: str, **kw):
        """The side's first gateway on `pool`, made on first use."""
        for gw in self.gws:
            if gw.pool == pool:
                return gw
        return self.gateway(pool, **kw)

    def gateway(self, pool: str, **kw):
        """A new started gateway on `pool`; its deferred GC waits for the
        case's end (`drain`), so what a case leaves is not raced by the
        GC thread."""
        gw = self.p.RGWGateway(self.c.rados(), pool=pool, **kw)
        gw.GC_GRACE_S = 3600.0
        gw.start()
        self.gws.append(gw)
        self.masks[str(gw.port)] = "<port>"
        return gw

    def drain(self) -> None:
        for gw in self.gws:
            gw._gc_tick(everything=True)

    def mask(self, text: str) -> str:
        for port, name in self.masks.items():
            text = text.replace(f":{port}", f":{name}")
        return text

    def shutdown(self) -> None:
        for gw in self.gws:
            gw.shutdown()
        self.c.shutdown()


@pytest.fixture(scope="module")
def sides():
    """Both sides for one test module (the other rgw files import it)."""
    mp = pytest.MonkeyPatch()
    out = {kind: Side(kind, mp) for kind in KINDS}
    yield out
    for s in out.values():
        s.shutdown()
    mp.undo()


def _reply(side, status, headers, body):
    """(status, headers but Date, body) with the ports masked."""
    hdrs = {k: side.mask(v) for k, v in sorted(headers.items())
            if k != "Date"}
    return status, hdrs, side.mask(body.decode("latin-1")).encode("latin-1")


def req(side, gw, method, path, data=None, headers=None):
    """One request as the reference tests send it (urllib); an HTTP
    error is a reply too."""
    r = urllib.request.Request(f"http://127.0.0.1:{gw.port}{path}",
                               data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return _reply(side, resp.status, dict(resp.headers), resp.read())
    except urllib.error.HTTPError as e:
        return _reply(side, e.code, dict(e.headers), e.read())


def sreq(side, gw, method, path, body=b"", sign=True, headers=None,
         access="client.s3user", secret=None):
    """One request as tests/test_rgw_auth_shards.py sends it
    (http.client, SigV4-signed with the side's auth module)."""
    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
    hdrs = dict(headers or {})
    hdrs["host"] = f"127.0.0.1:{gw.port}"
    if sign:
        hdrs = side.p.auth.sign_request(method, path, hdrs, body, access,
                                        secret or SECRETS[access])
    conn.request(method, path, body, hdrs)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return _reply(side, resp.status, dict(resp.getheaders()), data)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pool_state(side, pool: str) -> dict:
    """Every object of `pool`: sha256 of its bytes, its xattrs but a
    queue's pusher lock, and its omap, with the ports masked."""
    side.drain()
    io = side.r.open_ioctx(pool)
    out = {}
    for oid in io.list_objects():
        out[oid] = {
            "sha": sha(io.read(oid)),
            "xattrs": {k: bytes(v).hex() for k, v in
                       sorted(io.get_xattrs(oid).items())
                       if not (oid.startswith(".rgw.queue.")
                               and k.startswith("lock."))},
            "omap": {k: side.mask(bytes(v).decode("latin-1")) for k, v in
                     sorted(io.get_omap_vals(oid)[0].items())}}
    return out


def run_both(sides, case, pools=()):
    """`case(side)` on each side; the records and the pools' states must
    be equal, and the port must swallow no RadosError."""
    before = sum(port_rgw.SWALLOWED.values())
    got = {kind: case(side) for kind, side in sides.items()}
    assert got["port"] == got["ref"]
    for pool in pools:
        assert pool_state(sides["port"], pool) == \
            pool_state(sides["ref"], pool), pool
    assert sum(port_rgw.SWALLOWED.values()) == before, port_rgw.SWALLOWED
    return got["port"]


def keys_of(body: bytes) -> list:
    return [e.text for e in ET.fromstring(body).iter("Key")]


# ------------------------------------------------------------ test_rgw

def c_bucket_lifecycle(s):
    gw = s.gw("rgw")
    out = [req(s, gw, "PUT", "/b1"), req(s, gw, "PUT", "/b2")]
    out.append(req(s, gw, "GET", "/"))
    assert {"b1", "b2"} <= {e.text for e in
                            ET.fromstring(out[-1][2]).iter("Name")}
    out += [req(s, gw, "HEAD", "/b1"), req(s, gw, "DELETE", "/b2"),
            req(s, gw, "HEAD", "/b2")]
    assert [o[0] for o in out] == [200, 200, 200, 200, 204, 404]
    return out


def test_bucket_lifecycle(sides):
    run_both(sides, c_bucket_lifecycle, ["rgw"])


def c_object_crud_and_etag(s):
    gw = s.gw("rgw")
    payload = b"hello s3 world" * 100
    out = [req(s, gw, "PUT", "/crud"),
           req(s, gw, "PUT", "/crud/dir/obj.bin", payload)]
    assert out[-1][1]["ETag"] == f'"{hashlib.md5(payload).hexdigest()}"'
    out += [req(s, gw, "GET", "/crud/dir/obj.bin"),
            req(s, gw, "HEAD", "/crud/dir/obj.bin"),
            req(s, gw, "DELETE", "/crud"),
            req(s, gw, "DELETE", "/crud/dir/obj.bin"),
            req(s, gw, "GET", "/crud/dir/obj.bin")]
    assert out[2][2] == payload
    assert [o[0] for o in out] == [200, 200, 200, 200, 409, 204, 404]
    return out


def test_object_crud_and_etag(sides):
    run_both(sides, c_object_crud_and_etag, ["rgw"])


def c_list_objects_v2_pagination(s):
    gw = s.gw("rgw")
    out = [req(s, gw, "PUT", "/lst")]
    out += [req(s, gw, "PUT", f"/lst/k{i:02d}", b"v") for i in range(12)]
    out.append(req(s, gw, "PUT", "/lst/other", b"v"))
    out.append(req(s, gw, "GET", "/lst?list-type=2&prefix=k&max-keys=5"))
    root = ET.fromstring(out[-1][2])
    assert keys_of(out[-1][2]) == [f"k{i:02d}" for i in range(5)]
    assert root.find("IsTruncated").text == "true"
    token = root.find("NextContinuationToken").text
    out.append(req(s, gw, "GET", f"/lst?list-type=2&prefix=k&"
                   f"continuation-token={token}&max-keys=50"))
    assert keys_of(out[-1][2]) == [f"k{i:02d}" for i in range(5, 12)]
    assert ET.fromstring(out[-1][2]).find("IsTruncated").text == "false"
    return out


def test_list_objects_v2_pagination(sides):
    run_both(sides, c_list_objects_v2_pagination, ["rgw"])


def c_multipart_upload(s):
    gw = s.gw("rgw")
    out = [req(s, gw, "PUT", "/mp"),
           req(s, gw, "POST", "/mp/big.bin?uploads")]
    upload_id = ET.fromstring(out[-1][2]).find("UploadId").text
    parts = [b"A" * 70_000, b"B" * 50_000, b"C" * 10]
    for i, p in enumerate(parts, start=1):
        out.append(req(s, gw, "PUT", f"/mp/big.bin?partNumber={i}&"
                       f"uploadId={upload_id}", p))
    out.append(req(s, gw, "POST", f"/mp/big.bin?uploadId={upload_id}",
                   b"<CompleteMultipartUpload>"
                   b"<Part><PartNumber>1</PartNumber></Part>"
                   b"<Part><PartNumber>2</PartNumber></Part>"
                   b"<Part><PartNumber>3</PartNumber></Part>"
                   b"</CompleteMultipartUpload>"))
    assert ET.fromstring(out[-1][2]).find("ETag").text.endswith('-3"')
    out.append(req(s, gw, "GET", "/mp/big.bin"))
    assert out[-1][2] == b"".join(parts)
    out.append(req(s, gw, "GET", "/mp?list-type=2"))
    assert keys_of(out[-1][2]) == ["big.bin"]
    assert all(o[0] == 200 for o in out)
    return out


def test_multipart_upload(sides):
    run_both(sides, c_multipart_upload, ["rgw"])


def c_multipart_abort(s):
    gw = s.gw("rgw")
    out = [req(s, gw, "PUT", "/ab"), req(s, gw, "POST", "/ab/x?uploads")]
    uid = ET.fromstring(out[-1][2]).find("UploadId").text
    out += [req(s, gw, "PUT", f"/ab/x?partNumber=1&uploadId={uid}", b"zzz"),
            req(s, gw, "DELETE", f"/ab/x?uploadId={uid}"),
            req(s, gw, "POST", f"/ab/x?uploadId={uid}", b""),
            req(s, gw, "GET", "/ab?list-type=2")]
    assert [o[0] for o in out] == [200, 200, 200, 204, 404, 200]
    assert keys_of(out[-1][2]) == []
    return out


def test_multipart_abort(sides):
    run_both(sides, c_multipart_abort, ["rgw"])


# ------------------------------------------------- test_rgw_auth_shards

def _auth_gw(s):
    return s.gw("rgwauth", keyring=s.keyring("client.s3user"),
                index_shards=4)


def c_unauthenticated_rejected(s):
    gw = _auth_gw(s)
    out = [sreq(s, gw, "PUT", "/b0", sign=False),
           sreq(s, gw, "GET", "/", sign=False)]
    assert [o[0] for o in out] == [403, 403]
    assert b"AccessDenied" in out[0][2]
    return out


def test_unauthenticated_rejected(sides):
    run_both(sides, c_unauthenticated_rejected, ["rgwauth"])


def c_bad_signature_and_unknown_key_rejected(s):
    gw = _auth_gw(s)
    out = [sreq(s, gw, "PUT", "/b0", secret="0" * 32),
           sreq(s, gw, "PUT", "/b0", access="client.ghost",
                secret="0" * 32)]
    assert out[0][0] == 403 and b"SignatureDoesNotMatch" in out[0][2]
    assert out[1][0] == 403 and b"InvalidAccessKeyId" in out[1][2]
    return out


def test_bad_signature_and_unknown_key_rejected(sides):
    run_both(sides, c_bad_signature_and_unknown_key_rejected, ["rgwauth"])


def c_signed_crud_roundtrip(s):
    gw = _auth_gw(s)
    out = [sreq(s, gw, "PUT", "/auth-b"),
           sreq(s, gw, "PUT", "/auth-b/k1", b"payload-1"),
           sreq(s, gw, "GET", "/auth-b/k1"),
           sreq(s, gw, "HEAD", "/auth-b/k1"),
           sreq(s, gw, "DELETE", "/auth-b/k1")]
    assert [o[0] for o in out] == [200, 200, 200, 200, 204]
    assert out[2][2] == b"payload-1"
    assert out[3][1]["Content-Length"] == "9"
    return out


def test_signed_crud_roundtrip(sides):
    run_both(sides, c_signed_crud_roundtrip, ["rgwauth"])


def c_copy_object(s):
    gw = _auth_gw(s)
    out = [sreq(s, gw, "PUT", "/src-b"), sreq(s, gw, "PUT", "/dst-b"),
           sreq(s, gw, "PUT", "/src-b/orig", b"copy me"),
           sreq(s, gw, "PUT", "/dst-b/dup",
                headers={"x-amz-copy-source": "/src-b/orig"}),
           sreq(s, gw, "GET", "/dst-b/dup")]
    assert out[3][0] == 200 and b"CopyObjectResult" in out[3][2]
    assert out[4][2] == b"copy me"
    return out


def test_copy_object(sides):
    run_both(sides, c_copy_object, ["rgwauth"])


def c_sharded_index_lists_across_shards(s):
    gw = _auth_gw(s)
    g = s.p.gateway
    out = [sreq(s, gw, "PUT", "/wide")]
    n = 200
    for i in range(n):
        out.append(sreq(s, gw, "PUT", f"/wide/obj{i:04d}", f"d{i}".encode()))
        assert out[-1][0] == 200
    shards_used = {g._shard_of(f"obj{i:04d}", 4) for i in range(n)}
    assert shards_used == {0, 1, 2, 3}
    out.append([len(gw.io.get_omap_vals(g._index_obj("wide", sh))[0])
                for sh in range(4)])
    assert all(out[-1])
    got, token = [], ""
    while True:
        path = "/wide?list-type=2&max-keys=37"
        if token:
            path += f"&continuation-token={token}"
        out.append(sreq(s, gw, "GET", path))
        assert out[-1][0] == 200
        got.extend(re.findall(r"<Key>([^<]+)</Key>", out[-1][2].decode()))
        m = re.search(r"<NextContinuationToken>([^<]+)<",
                      out[-1][2].decode())
        if not m:
            break
        token = m.group(1)
    assert got == [f"obj{i:04d}" for i in range(n)]
    out.append(sreq(s, gw, "GET", "/wide/obj0123"))
    assert out[-1][2] == b"d123"
    return out


def test_sharded_index_lists_across_shards(sides):
    run_both(sides, c_sharded_index_lists_across_shards, ["rgwauth"])


def test_shard_placement_equals_the_reference():
    """`_index_obj` and `_shard_of` place 1,000 keys on the reference's
    shards at every shard count the gateway takes."""
    for n in (1, 2, 4, 8, 11):
        for i in range(1000):
            key = f"k/{i}"
            assert port_gateway._shard_of(key, n) == \
                ref_gateway._shard_of(key, n)
            assert port_gateway._index_obj("b", i % n) == \
                ref_gateway._index_obj("b", i % n)


# ------------------------------------------------ test_rgw_concurrency

VERS_ON = (b"<VersioningConfiguration>"
           b"<Status>Enabled</Status></VersioningConfiguration>")


def _two(s):
    """Two gateways on pool `rgwrace`, each with its own client."""
    gws = [gw for gw in s.gws if gw.pool == "rgwrace"]
    while len(gws) < 2:
        gws.append(s.gateway("rgwrace"))
    return gws


def _threads(fns) -> list:
    errs = []

    def run(fn):
        try:
            fn()
        except Exception as e:          # reported below: the case fails
            errs.append(repr(e))
    ts = [threading.Thread(target=run, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return errs


def _listed_vids(s, gw, bucket) -> set:
    body = req(s, gw, "GET", f"/{bucket}?versions")[2]
    return {e.text for e in ET.fromstring(body).iter()
            if e.tag == "VersionId"}


def c_racing_versioned_puts_lose_nothing(s):
    g1, g2 = _two(s)
    req(s, g1, "PUT", "/race")
    req(s, g1, "PUT", "/race?versioning", VERS_ON)
    n_threads, per_thread = 8, 6
    vids = []
    lock = make_lock("test.rgw.race_vids")

    def worker(i):
        gw = (g1, g2)[i % 2]
        for j in range(per_thread):
            st, hdrs, _ = req(s, gw, "PUT", "/race/hot",
                              f"w{i}.{j}".encode())
            assert st == 200
            with lock:
                vids.append(hdrs["x-amz-version-id"])
    assert _threads([lambda i=i: worker(i) for i in range(n_threads)]) == []
    listed = _listed_vids(s, g1, "race")
    assert len(set(vids)) == n_threads * per_thread
    assert set(vids) <= listed and len(listed) == n_threads * per_thread
    return sorted(listed)


def test_racing_versioned_puts_lose_nothing(sides):
    run_both(sides, c_racing_versioned_puts_lose_nothing)


def c_racing_plain_puts_different_keys_one_shard(s):
    g1, g2 = _two(s)
    req(s, g1, "PUT", "/race2")
    keys = [f"k{i}" for i in range(24)]
    assert _threads([lambda i=i: req(s, (g1, g2)[i % 2], "PUT",
                                     f"/race2/{keys[i]}", b"x" * 10)
                     for i in range(len(keys))]) == []
    listed = set(keys_of(req(s, g2, "GET", "/race2")[2]))
    assert listed == set(keys)
    return sorted(listed)


def test_racing_plain_puts_different_keys_one_shard(sides):
    run_both(sides, c_racing_plain_puts_different_keys_one_shard)


def c_delete_vs_put_race_stays_consistent(s):
    g1, g2 = _two(s)
    req(s, g1, "PUT", "/race3")
    req(s, g1, "PUT", "/race3?versioning", VERS_ON)
    req(s, g1, "PUT", "/race3/obj", b"seed")
    put_vids, dm_vids = [], []

    def putter():
        for j in range(5):
            put_vids.append(req(s, g1, "PUT", "/race3/obj",
                                b"p%d" % j)[1]["x-amz-version-id"])

    def deleter():
        for _ in range(5):
            dm_vids.append(req(s, g2, "DELETE",
                               "/race3/obj")[1]["x-amz-version-id"])
    assert _threads([putter, deleter]) == []
    listed = _listed_vids(s, g1, "race3")
    assert set(put_vids) <= listed and set(dm_vids) <= listed
    assert len(listed) == 1 + len(put_vids) + len(dm_vids)
    return sorted(listed)


def test_delete_vs_put_race_stays_consistent(sides):
    run_both(sides, c_delete_vs_put_race_stays_consistent)


# ------------------------------------------------- the port's own pins

def c_zone_member_datalog(s):
    gw = s.gateway("rgwzone", zone="z1")
    out = [req(s, gw, "PUT", "/zb")]
    out += [req(s, gw, "PUT", f"/zb/k{i}", b"z%d" % i) for i in range(3)]
    out.append(req(s, gw, "DELETE", "/zb/k1"))
    dl = s.p.gateway.DataLog(gw.io)
    ents = [e for sh in range(gw._nshards("zb"))
            for e in dl.list("zb", sh, 0, 100)[0]]
    assert [e["op"] for e in ents if e["key"] == "k1"] == ["put", "del"]
    assert all(e["trace"] == ["z1"] for e in ents)
    assert gw.multisite.peers() == [] and gw.sync is not None
    out.append(ents)
    return out


def test_zone_member_writes_its_datalog_like_the_reference(sides):
    """`RGWGateway(..., zone=)` builds a zone member in both packages:
    each index mutation appends its datalog record in the same `exec`
    on the index shard, and the records, the replies and the whole pool
    are equal to the reference's."""
    run_both(sides, c_zone_member_datalog, ["rgwzone"])


def c_admin_socket_obs(s, tmp):
    from importlib import import_module
    admin_command = import_module(
        "ceph_tpu.common.admin_socket" if s.kind == "ref"
        else "ceph_tpu_torch.common.admin_socket").admin_command
    gw = s.gateway("rgw-obs")
    path = str(tmp / f"{s.kind}.asok")
    gw.start_admin_socket(path)
    out = {}
    for cmd in ("dump_ops_in_flight", "dump_historic_ops",
                "dump_historic_slow_ops"):
        rc, got = admin_command(path, cmd)
        out[cmd] = (rc, "num_ops" in got)
    for cmd in ("dump_blocked_ops", "dump_traces"):
        rc, got = admin_command(path, cmd)
        out[cmd] = (rc, type(got).__name__)
    req(s, gw, "PUT", "/b1")
    end = time.monotonic() + 10.0
    while time.monotonic() < end:
        rc, hist = admin_command(path, "dump_historic_ops")
        if hist["num_ops"] > 0:
            break
        time.sleep(0.05)
    out["historic"] = [op["description"] for op in hist["ops"]]
    rc, st = admin_command(path, "status")
    out["status"] = (rc, st["zone"], st["pool"], st["hbmap_unhealthy"])
    assert out["dump_ops_in_flight"] == (0, True)
    assert out["dump_traces"] == (0, "list")
    assert any("PUT /b1" in d for d in out["historic"])
    return out


def test_admin_socket_serves_the_obs_commands(sides, tmp_path):
    """tests/test_slow_ops.py's rgw case: the gateway's admin socket
    answers the five obs commands and tracks an HTTP request."""
    run_both(sides, lambda s: c_admin_socket_obs(s, tmp_path), ["rgw-obs"])


def test_radosgw_process_serves_and_stops_on_sigterm(tmp_path):
    """`python -m ceph_tpu_torch.rgw.gateway` over a cephx cluster on TCP
    (a mon and 3 OSDs in this process, `device="cpu"`): it
    authenticates as `--name`, makes its pool, serves a bucket, a PUT,
    a GET and a listing, and exits 0 on SIGTERM."""
    from ceph_tpu_torch.auth import generate_key
    from ceph_tpu_torch.dryrun import TcpCluster

    tc = TcpCluster(n_osd=3, device="cpu", auth="cephx")
    proc = None
    try:
        tc.wait_all_up()
        tc.keyring.keys["client.rgw"] = generate_key()
        tc.keyring.save(str(tmp_path / "kr.json"))
        (tmp_path / "mm.json").write_text(json.dumps(
            {"addrs": {k: list(v) for k, v in tc.network.addr_map.items()
                       if not k.startswith("client.")},
             "mon_ranks": [0], "n_osd": 3, "osds_per_host": 1}))
        proc = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.rgw.gateway", "--monmap",
             str(tmp_path / "mm.json"), "--keyring", str(tmp_path / "kr.json"),
             "--port", "0", "--pool", "rgwproc", "--name", "client.rgw"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=subprocess.PIPE, stderr=open(tmp_path / "rgw.err", "w"),
            text=True)
        line = proc.stdout.readline()
        m = re.match(r"rgw: serving S3 on :(\d+) pool=rgwproc", line)
        assert m, (line, (tmp_path / "rgw.err").read_text()[-3000:])
        gw = SimpleNamespace(port=int(m.group(1)))
        s = SimpleNamespace(mask=lambda t: t)
        assert req(s, gw, "PUT", "/pb")[0] == 200
        st, hdrs, _ = req(s, gw, "PUT", "/pb/obj", b"from the process")
        assert st == 200 and hdrs["ETag"] == \
            f'"{hashlib.md5(b"from the process").hexdigest()}"'
        assert req(s, gw, "GET", "/pb/obj")[2] == b"from the process"
        assert keys_of(req(s, gw, "GET", "/pb?list-type=2")[2]) == ["obj"]
        assert "rgwproc" in tc.rados.list_pools()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(10)
        tc.shutdown()


def c_keep_alive(s):
    """Three PUTs on one keep-alive connection, then each object read
    back on fresh connections."""
    gw = s.gw("rgw")
    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
    out = []
    try:
        for path, body in (("/ka", b""), ("/ka/k1", b"one"),
                           ("/ka/k2", b"two-two")):
            conn.request("PUT", path, body)
            resp = conn.getresponse()
            out.append((resp.status, resp.getheader("ETag")))
            resp.read()
    except (http.client.HTTPException, OSError) as e:
        out.append(type(e).__name__)
    finally:
        conn.close()
    return out + [req(s, gw, "GET", key)[:3:2] for key in ("/ka/k1",
                                                           "/ka/k2")]


def test_keep_alive_request_reads_its_own_body(sides):
    """A deliberate difference (ROADMAP Queue 3): one handler serves every
    request of an HTTP/1.1 keep-alive connection, and the reference's
    keeps the first request's body for the later ones, so its second PUT
    stores the bucket PUT's empty body and leaves its own bytes unread
    on the connection.  The port's reads each request's own body: both
    objects hold their bytes, with their md5 ETags."""
    got = {kind: c_keep_alive(side) for kind, side in sides.items()}
    md5 = {b: f'"{hashlib.md5(b).hexdigest()}"' for b in (b"one",
                                                        b"two-two")}
    assert got["port"] == [(200, None), (200, md5[b"one"]),
                           (200, md5[b"two-two"]), (200, b"one"),
                           (200, b"two-two")]
    assert got["ref"][1] == (200, f'"{hashlib.md5(b"").hexdigest()}"')
    assert got["ref"][-2] == (200, b"")


def test_reply_leaves_without_waiting_for_a_delayed_ack(sides):
    """A deliberate difference (ROADMAP Queue 3): a reply's headers and
    body are two writes, and without TCP_NODELAY the body waits for the
    client's delayed ACK.  The port's handler sets TCP_NODELAY; the
    reference's leaves Nagle's algorithm on.  The bytes are the same."""
    got = {kind: side.gw("rgw").httpd.RequestHandlerClass
           .disable_nagle_algorithm for kind, side in sides.items()}
    assert got == {"port": True, "ref": False}


def test_smoke_s3_client_fails_on_a_dropped_connection():
    """chip_smoke.py's S3 client resends nothing: a gateway whose handler
    dies closes the connection, and that must fail the smoke's rgw leg.
    A server that reads one request and closes the connection without a
    reply sees one connection and one request, and the client raises."""
    import importlib.util
    import socket
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_s3", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(30)
    accepted = []

    def serve():
        # two connections at most: a resend shows in `accepted`, and a
        # client that kept resending is refused, not served forever
        try:
            for _ in range(2):
                conn, _ = srv.accept()
                accepted.append(conn.recv(65536).split(b"\r\n")[0])
                conn.close()
        except OSError:
            pass
        srv.close()
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client = smoke.S3Client(srv.getsockname()[1], "", "")
    try:
        with pytest.raises((http.client.RemoteDisconnected,
                            ConnectionResetError)):
            client("PUT", "/bk/k", b"x" * 4096)
    finally:
        client.close()
        try:
            srv.shutdown(socket.SHUT_RDWR)    # wakes the accept
        except OSError:
            pass
        t.join(30)
    assert accepted == [b"PUT /bk/k HTTP/1.1"]
