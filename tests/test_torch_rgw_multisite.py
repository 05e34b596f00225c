"""The port's RGW multisite (`ceph_tpu_torch.rgw.multisite` and the
gateway's zone member) held to the reference's (`ceph_tpu.rgw`) at
tolerance 0.

Every case of tests/test_rgw_multisite.py but the `rados rgw` verbs
(tests/test_torch_rados_cli.py) runs the reference test's steps once on
each package: zones over the reference's threaded `MiniCluster(n_osd=4)`
and over the port's (`device="cpu"`), the long-lived two-zone site
`m1`/`m2` shared by the cases as in the reference, and the reference's
own assertions hold on both.  What each case saw must then be equal:
every status and body the reference test checks, and, once every agent
has run two more rounds and reports caught up, the converged state of
the buckets the case wrote on every zone: the registry entry, every
index shard's omap but the datalog records, and the sha256 of the data
object behind every entry and version.  The datalog itself is compared
where the reference test reads it (the records of the origin zone, the
cursor and trim cases, the log after an auto-trim); a replica's re-logged
records depend on whether an entry arrived by full sync or by the log,
which races in the reference itself.  For the same reason the agents'
apply and skip counters are compared only where the schedule fixes them
(the kill and restart case's `full_syncs`).

What cannot be seeded is seeded alike on both sides by patching the
stdlib names the modules use, never the modules' code: `uuid.uuid4` in
the gateway, Swift and notify draws from one seeded stream per side;
`random` in `common.backoff` (the jitter) is one seeded stream per side;
`time` in `cls.rgw` (every mtime, created and deleted stamp) is the wall
clock made strictly increasing by a millisecond per call, so no two
stamps of a side are equal.  Masked, because threads draw them in an
order the reference does not fix: each stamp becomes its rank among the
stamps of the case's record, each id drawn from `uuid4` (version ids,
data object names, upload ids) its order of first appearance in the
record, and each gateway's, receiver's and keystone stub's HTTP port its
name.  A wait in a case waits on state (caught up, a cursor past a head,
an agent's round count), never on a sleep, each with a stated timeout;
the reference's waits for "several sync rounds" become waits for three
more rounds of each agent, and the age checks of the trim and the
keystone cache move the module's clock instead of sleeping.

No case swallows an error: `rgw.SWALLOWED`, `rgw.multisite.SWALLOWED`
and `rgw.multisite.SYNC_TICK_ERRORS` stay as they were, but in the cases
that inject a fault on purpose (the poisoned entry; the port's own pin
of a torn marker record, which counts it at `load_state_record`).
"""
import io as _io
import json
import random
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from xml.etree import ElementTree as ET

import pytest

import ceph_tpu.cls.rgw as ref_cls_rgw
import ceph_tpu.common.backoff as ref_backoff
import ceph_tpu.rgw.auth as ref_auth
import ceph_tpu.rgw.datalog as ref_datalog
import ceph_tpu.rgw.gateway as ref_gateway
import ceph_tpu.rgw.multisite as ref_multisite
import ceph_tpu.rgw.notify as ref_notify
import ceph_tpu.rgw.swift as ref_swift
import ceph_tpu_torch.cls.rgw as port_cls_rgw
import ceph_tpu_torch.common.backoff as port_backoff
import ceph_tpu_torch.rgw as port_rgw
import ceph_tpu_torch.rgw.auth as port_auth
import ceph_tpu_torch.rgw.datalog as port_datalog
import ceph_tpu_torch.rgw.gateway as port_gateway
import ceph_tpu_torch.rgw.multisite as port_multisite
import ceph_tpu_torch.rgw.notify as port_notify
import ceph_tpu_torch.rgw.swift as port_swift
from ceph_tpu.client.rados import RadosError as RefRadosError
from ceph_tpu.common.lockdep import make_lock
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu.tools import rados_cli as ref_cli
from ceph_tpu_torch.client.rados import RadosError as PortRadosError
from ceph_tpu_torch.testing import MiniCluster as PortCluster
from ceph_tpu_torch.tools import rados_cli as port_cli
from test_torch_rgw import SeededUUID

KINDS = ("ref", "port")
PKG = {
    kind: SimpleNamespace(
        cls_rgw=cls_rgw, backoff=backoff, auth=auth, datalog=datalog,
        gateway=gateway, multisite=multisite, notify=notify, swift=swift,
        RGWGateway=gateway.RGWGateway, RadosError=err, cli=cli,
        Cluster=cluster, kw=kw)
    for kind, cls_rgw, backoff, auth, datalog, gateway, multisite, notify,
    swift, err, cli, cluster, kw in (
        ("ref", ref_cls_rgw, ref_backoff, ref_auth, ref_datalog,
         ref_gateway, ref_multisite, ref_notify, ref_swift, RefRadosError,
         ref_cli, RefCluster, {}),
        ("port", port_cls_rgw, port_backoff, port_auth, port_datalog,
         port_gateway, port_multisite, port_notify, port_swift,
         PortRadosError, port_cli, PortCluster, {"device": "cpu"}))}

VERS_ON = (b"<VersioningConfiguration>"
           b"<Status>Enabled</Status></VersioningConfiguration>")
#: the longest a case waits for one state (the reference's waits are
#: 30-40 s; a loaded machine may need more)
WAIT_S = 90.0


class MonoClock:
    """Stands in for `cls.rgw`'s `time`: the wall clock in whole
    milliseconds, one more than the last stamp when the wall clock has
    not moved past it; the rest is the real module."""

    def __init__(self):
        self._ms = 0
        self._lock = make_lock("test.rgw_multisite.clock")

    def time(self) -> float:
        with self._lock:
            self._ms = max(int(time.time() * 1000), self._ms + 1)
            # mid-millisecond: now_str truncates the fraction
            return self._ms / 1000.0 + 0.0004

    def __getattr__(self, name):
        return getattr(time, name)


class OffsetClock:
    """`time` whose `time()` runs `offset` seconds ahead of the wall
    clock; a case moves it instead of sleeping."""

    def __init__(self):
        self.offset = 0.0

    def time(self) -> float:
        return time.time() + self.offset

    def __getattr__(self, name):
        return getattr(time, name)


class Side:
    """One package's threaded cluster, a client, its seeded stand-ins
    and the masks of its HTTP ports."""

    def __init__(self, kind: str, mp: pytest.MonkeyPatch, seed: int = 19):
        self.kind, self.p = kind, PKG[kind]
        self.mp = mp
        self.c = self.p.Cluster(n_osd=4, threaded=True, **self.p.kw)
        self.c.wait_all_up()
        self.r = self.c.rados()
        mp.setattr(self.p.cls_rgw, "time", MonoClock())
        self.uuid = SeededUUID(seed)
        for mod in (self.p.gateway, self.p.swift, self.p.notify):
            mp.setattr(mod, "uuid", self.uuid)
        mp.setattr(self.p.backoff, "random", random.Random(seed))
        self.masks: dict = {}
        self._ms = None
        #: set while this side's case runs: the other side's agents
        #: wait at the top of their next round meanwhile
        self.running = threading.Event()

    @property
    def ms(self):
        """The long-lived two-zone site: m1 master, m2 secondary."""
        if self._ms is None:
            self._ms = self.zones(("m1", "m2"))
        return self._ms

    def zones(self, zones, **kw):
        gws = self.c.rgw_multisite(zones=zones, **kw)
        for gw in gws:
            self.mask_port(gw.port, gw.zone)
            self._gate(gw)
        return gws

    def restart(self, gw):
        g2 = self.c.restart_rgw_zone(gw)
        self.mask_port(g2.port, g2.zone)
        self._gate(g2)
        return g2

    def _gate(self, gw) -> None:
        """Hold `gw`'s agent at the top of each round while the other
        side's case runs (two sites polling at once only slow both)."""
        real = gw.sync.tick

        def tick():
            self.running.wait()
            return real()
        gw.sync.tick = tick

    def close(self, gws) -> None:
        """Shut a case's own zones down once the case has read them."""
        for gw in gws:
            gw.shutdown()
            if gw in self.c.rgws:
                self.c.rgws.remove(gw)

    def gateway(self, pool: str, **kw):
        gw = self.p.RGWGateway(self.c.rados(), pool=pool, **kw)
        self.mask_port(gw.port, pool)
        return gw

    def mask_port(self, port: int, name: str) -> None:
        self.masks[f":{port}"] = f":<{name}>"

    def shutdown(self) -> None:
        self.running.set()
        self.c.shutdown()


@pytest.fixture(scope="module")
def sides():
    mp = pytest.MonkeyPatch()
    out = {kind: Side(kind, mp) for kind in KINDS}
    yield out
    for s in out.values():
        s.shutdown()
    mp.undo()


# --------------------------------------------------------------- masks

_STAMP = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(?:\.\d{3})?Z?")
_HEX = re.compile(r"(?<![0-9a-f])[0-9a-f]{32}(?![0-9a-f])")


def _etags(x, out: set) -> set:
    """Every 32-hex run under an etag field (md5s are content, not ids)."""
    if isinstance(x, dict):
        for k, v in x.items():
            if k.lower() == "etag" and isinstance(v, str):
                out.update(_HEX.findall(v))
            else:
                _etags(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _etags(v, out)
    elif isinstance(x, str):
        out.update(re.findall(r'<ETag>(?:&quot;|")?([0-9a-f]{32})', x))
    return out


def canon(x, masks: dict):
    """`x` with ports named, ids numbered by first appearance and
    stamps ranked (see the module docstring)."""
    text = json.dumps(x, sort_keys=True, default=repr)
    for port, name in masks.items():
        text = text.replace(port, name)
    keep = _etags(json.loads(text), set())
    ids: dict = {}

    def idn(m):
        h = m.group(0)
        return h if h in keep else ids.setdefault(h, f"<id{len(ids)}>")
    text = _HEX.sub(idn, text)
    rank = {t: f"<t{i}>" for i, t in
            enumerate(sorted(set(_STAMP.findall(text))))}
    text = _STAMP.sub(lambda m: rank[m.group(0)], text)
    return json.loads(text)


def counts() -> tuple:
    return (sum(port_rgw.SWALLOWED.values()),
            sum(port_multisite.SWALLOWED.values()),
            sum(port_multisite.SYNC_TICK_ERRORS.values()))


def diff(a, b, path="") -> list:
    """The paths where `a` and `b` differ (at most eight)."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            out += diff(a.get(k, "<absent>"), b.get(k, "<absent>"),
                        f"{path}/{k}")
        return out[:8]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out += diff(x, y, f"{path}[{i}]")
        return out[:8]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def run_both(sides, case, faults: bool = False):
    """`case(side)` on each side; the canonical records must be equal,
    and unless the case injects a fault the port swallows nothing."""
    before = counts()
    got = {}
    for kind, s in sides.items():
        s.running.set()
        try:
            got[kind] = canon(case(s), s.masks)
        finally:
            s.running.clear()
    assert got["port"] == got["ref"], diff(got["port"], got["ref"])
    if not faults:
        assert counts() == before, (port_rgw.SWALLOWED,
                                    port_multisite.SWALLOWED,
                                    port_multisite.SYNC_TICK_ERRORS)
    return got["port"]


# ------------------------------------------------------------- helpers

def req(gw, method, path, data=None, headers=None):
    r = urllib.request.Request(f"http://127.0.0.1:{gw.port}{path}",
                               data=data, method=method,
                               headers=headers or {})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, dict(resp.headers), resp.read()


def code(fn, *a, **kw) -> int:
    """The HTTP status `fn` raised (or 200 when it did not)."""
    try:
        fn(*a, **kw)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _wait(cond, timeout: float = WAIT_S, interval: float = 0.02) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def rounds(*gws, n: int = 3) -> None:
    """Wait until every gateway's agent has run `n` more rounds."""
    start = {id(g): g.sync._rounds for g in gws}
    assert _wait(lambda: all(g.sync._rounds >= start[id(g)] + n
                             for g in gws)), "agents stopped running"


def settle(*gws) -> None:
    """Two more rounds of every agent, then all caught up."""
    rounds(*gws, n=2)
    assert _wait(lambda: all(g.sync.caught_up() for g in gws)), \
        [g.sync.status() for g in gws]


def _get_bytes(gw, bucket, key, vid=""):
    path = f"/{bucket}/{key}"
    if vid:
        path += f"?versionId={vid}"
    try:
        return req(gw, "GET", path)[2]
    except urllib.error.HTTPError:
        return None


def _dl_entries(s, gw, bucket):
    """Every datalog entry of every shard, in (shard, seq) order."""
    dl = s.p.datalog.DataLog(gw.io)
    out = []
    for sh in range(gw._nshards(bucket)):
        ents, _ = dl.list(bucket, sh, 0, 10_000)
        out.extend(ents)
    return out


def _obj_sha(io, name):
    import hashlib
    try:
        return hashlib.sha256(io.read(name)).hexdigest()
    except Exception as e:  # noqa: BLE001 — an absent object is state too
        return type(e).__name__


def state(s, gws, buckets, datalog: bool = False) -> dict:
    """Each zone's registry entry of each bucket, its index shards'
    omap (the datalog records only with `datalog`; in-flight uploads
    apart, as their shard follows the upload id), and the sha256 of the
    data object behind every entry and version."""
    out = {}
    for gw in gws:
        reg = gw._buckets_raw()
        for b in buckets:
            rec = {"registry": reg.get(b)}
            if b in reg and "deleted" not in reg[b]:
                shards, uploads = {}, []
                for sh in range(gw._nshards(b)):
                    try:
                        vals = gw.io.get_omap_vals(
                            s.p.gateway._index_obj(b, sh))[0]
                    except s.p.RadosError as e:
                        shards[sh] = e.errno_name
                        continue
                    ent = {}
                    for k, v in sorted(vals.items()):
                        if not datalog and (
                                s.p.datalog.is_dl_key(k) or
                                k == s.p.cls_rgw.DL_META):
                            continue
                        v = json.loads(v)
                        if k.startswith(".upload."):
                            # its shard follows the upload id, a draw
                            uploads.append(v)
                            continue
                        if isinstance(v, dict):
                            for ver in [v] + list(v.get("versions") or ()):
                                if ver.get("obj"):
                                    ver["sha"] = _obj_sha(gw.io, ver["obj"])
                        ent[k] = v
                    shards[sh] = ent
                rec["shards"] = shards
                rec["uploads"] = sorted(uploads, key=json.dumps)
            out[f"{gw.zone}/{b}"] = rec
    return out


def status_view(st: dict) -> dict:
    """`SyncAgent.status()` but the apply latencies (times) and the
    apply/skip counters (see the module docstring)."""
    return {k: v for k, v in st.items()
            if k not in ("apply_lat", "entries_applied", "entries_skipped",
                         "full_syncs")}


# ------------------------------------------------------- period model

def c_period_model(s):
    p = s.p.multisite
    s.r.pool_create("msadm", pg_num=8)
    io = s.r.open_ioctx("msadm")
    adm = p.MultisiteAdmin(io)
    out = [adm.period_get()["epoch"]]
    with pytest.raises(p.MultisiteError):
        adm.zonegroup_create("zg")      # realm first
    adm.realm_create("gold")
    adm.zonegroup_create("zg")
    with pytest.raises(p.MultisiteError):
        adm.zone_create("z1", "nope")
    adm.zone_create("z1", "zg", endpoint="http://a", master=True)
    adm.zone_create("z2", "zg", endpoint="http://b")
    out.append(adm.period_get()["epoch"])
    out.append(adm.period_commit())
    pd = adm.period_get()
    assert pd["realm"] == "gold"
    assert pd["zonegroups"]["zg"]["zones"]["z1"]["master"]
    out.append(pd)
    out.append(adm.period_commit())
    adm.zone_modify("z2", "zg", master=True)
    out.append(adm.period_commit())
    out.append(adm.period_get())
    newer = dict(adm.period_get(), epoch=9)
    out.append(adm.period_adopt(newer))
    out.append(adm.period_adopt(dict(newer, epoch=3)))
    out.append(adm.period_get()["epoch"])
    out.append({k: json.loads(v) for k, v in
                io.get_omap_vals(p.PERIOD_OBJ)[0].items()})
    assert out[:3] == [0, 0, 1] and out[4:6] == [1, 2]
    assert out[7:10] == [True, False, 9]
    return out


def test_period_model_staging_commit_adopt(sides):
    run_both(sides, c_period_model)


def c_period_epoch_propagates(s):
    m1, m2 = s.ms
    adm = m1.multisite.admin
    zg = m1.multisite.my_zonegroup()[0]
    adm.zone_create("m3", zg, endpoint="")
    epoch = adm.period_commit()
    assert epoch > 1
    assert _wait(lambda: (m2.multisite.refresh(force=True) or
                          m2.multisite.epoch == epoch))
    assert "m3" in m2.multisite.period["zonegroups"][zg]["zones"]

    def stored():
        return {k: json.loads(v) for k, v in m2.io.get_omap_vals(
            s.p.multisite.PERIOD_OBJ)[0].items()}
    # the adopt writes the current period, then the staging one
    assert _wait(lambda: stored()["staging"]["epoch"] == epoch)
    return {"epoch": epoch, "m2": m2.multisite.period, "obj": stored()}


def test_period_epoch_propagates_between_zones(sides):
    run_both(sides, c_period_epoch_propagates)


# ----------------------------------------------------------- datalog

def c_datalog_rides(s):
    m1, _ = s.ms
    req(m1, "PUT", "/dlb")
    for i in range(3):
        req(m1, "PUT", f"/dlb/k{i}", b"x%d" % i)
    ents = _dl_entries(s, m1, "dlb")
    puts = [e for e in ents if e["op"] == "put"]
    assert len(puts) == 3 and all(e["trace"] == ["m1"] for e in puts)
    for e in puts:
        raw = m1.io.get_omap_vals(
            s.p.datalog.shard_obj("dlb", m1.shard_of("dlb", e["key"])))[0]
        assert e["key"] in raw
        assert any(s.p.datalog.is_dl_key(k) and
                   json.loads(raw[k])["seq"] == e["seq"] for k in raw)
    _, _, body = req(m1, "GET", "/dlb?list-type=2")
    keys = [el.text for el in ET.fromstring(body).iter("Key")]
    assert keys == ["k0", "k1", "k2"]
    assert not any(s.p.datalog.is_dl_key(k) for k in m1._index("dlb"))
    return {"entries": ents, "keys": keys,
            "state": state(s, [m1], ["dlb"], datalog=True)}


def test_datalog_rides_the_index_transaction(sides):
    run_both(sides, c_datalog_rides)


def c_datalog_cursor_and_trim(s):
    m1, _ = s.ms
    req(m1, "PUT", "/dlc")
    for i in range(6):
        req(m1, "PUT", "/dlc/same", b"v%d" % i)
    sh = m1.shard_of("dlc", "same")
    dl = s.p.datalog.DataLog(m1.io)
    out = [dl.list("dlc", sh, 0, 100), dl.list("dlc", sh, 4, 100),
           dl.list("dlc", sh, 0, 2), dl.list("nope", 0),
           dl.trim("dlc", sh, 4), dl.list("dlc", sh, 0, 100)]
    assert out[0][1] == 6 and [e["seq"] for e in out[0][0]] == \
        list(range(1, 7))
    assert [e["seq"] for e in out[1][0]] == [5, 6]
    assert [e["seq"] for e in out[2][0]] == [1, 2]
    assert out[3] == ([], 0) and out[4] == 4
    assert out[5][1] == 6 and [e["seq"] for e in out[5][0]] == [5, 6]
    return out


def test_datalog_cursor_and_trim(sides):
    run_both(sides, c_datalog_cursor_and_trim)


# ------------------------------------------------- replication (E2E)

def c_e2e_convergence(s):
    m1, m2 = s.ms
    req(m1, "PUT", "/convp")
    req(m1, "PUT", "/convp/a", b"A-bytes")
    req(m1, "PUT", "/convp/b", b"B-bytes")
    req(m1, "DELETE", "/convp/b")
    req(m1, "PUT", "/convv")
    req(m1, "PUT", "/convv?versioning", VERS_ON)
    _, h1, _ = req(m1, "PUT", "/convv/v", b"V-one")
    _, h2, _ = req(m1, "PUT", "/convv/v", b"V-two")
    vid1, vid2 = h1["x-amz-version-id"], h2["x-amz-version-id"]
    _, hd, _ = req(m1, "DELETE", "/convv/v")
    dm_vid = hd["x-amz-version-id"]
    assert _wait(lambda: _get_bytes(m2, "convp", "a") == b"A-bytes")
    assert _wait(lambda: _get_bytes(m2, "convp", "b") is None)
    assert _wait(lambda: _get_bytes(m2, "convv", "v", vid2) == b"V-two")
    assert _get_bytes(m2, "convv", "v", vid1) == b"V-one"
    assert _get_bytes(m2, "convv", "v") is None
    assert _wait(lambda: m2._index_entry("convv", "v") is not None)

    def stack(gw):
        return [(v["vid"], bool(v.get("dm")), v["mtime"], v["etag"])
                for v in gw._index_entry("convv", "v")["versions"]]
    assert _wait(lambda: stack(m2) == stack(m1))
    assert [v[0] for v in stack(m2)] == [dm_vid, vid2, vid1]
    settle(m1, m2)
    st = m2.sync.status()["sources"][0]
    assert st["behind_shards"] == 0 and st["lag_entries"] == 0
    _, _, body = req(m2, "GET", "/admin/sync-status")
    rest = json.loads(body)
    assert rest["sources"][0]["caught_up"]
    return {"vids": [vid1, vid2, dm_vid], "stack": stack(m2),
            "rest": status_view(rest),
            "state": state(s, [m1, m2], ["convp", "convv"])}


def test_e2e_convergence_plain_and_versioned(sides):
    run_both(sides, c_e2e_convergence)


def c_inflight_multipart(s):
    m1, m2 = s.ms
    req(m1, "PUT", "/mpb")
    _, _, body = req(m1, "POST", "/mpb/big.bin?uploads")
    uid = ET.fromstring(body).find("UploadId").text
    req(m1, "PUT", f"/mpb/big.bin?partNumber=1&uploadId={uid}",
        b"P" * 1024)
    req(m1, "PUT", "/mpb/done", b"done-bytes")
    _, _, dump = req(m1, "GET", "/admin/bucket?name=mpb")
    keys = sorted(json.loads(dump))
    assert "done" in keys
    assert not [k for k in keys if k.startswith(".upload.")]
    assert _wait(lambda: _get_bytes(m2, "mpb", "done") == b"done-bytes")
    settle(m1, m2)
    errs = [e for e in m2.sync.error_list() if e["bucket"] == "mpb"]
    assert not errs
    return {"uid": uid, "dump": keys,
            "state": state(s, [m1, m2], ["mpb"])}


def test_inflight_multipart_does_not_wedge_sync(sides):
    run_both(sides, c_inflight_multipart)


def c_delete_marker_removal(s):
    """Both zones settle before the marker's removal: a full sync that
    dumped the marker re-logs it on m2 with a trace without m1, and m1,
    pulling that record after the removal, would put the marker back (a
    race of the reference's own schedule)."""
    m1, m2 = s.ms
    req(m1, "PUT", "/dmr")
    req(m1, "PUT", "/dmr?versioning", VERS_ON)
    req(m1, "PUT", "/dmr/k", b"alive")
    _, hd, _ = req(m1, "DELETE", "/dmr/k")
    dm_vid = hd["x-amz-version-id"]
    assert _wait(lambda: _get_bytes(m2, "dmr", "k") is None and
                 m2._index_entry("dmr", "k") is not None)
    settle(m1, m2)
    req(m1, "DELETE", f"/dmr/k?versionId={dm_vid}")
    assert _get_bytes(m1, "dmr", "k") == b"alive"
    assert _wait(lambda: _get_bytes(m2, "dmr", "k") == b"alive")
    vids = [v["vid"] for v in m2._index_entry("dmr", "k")["versions"]]
    assert dm_vid not in vids
    settle(m1, m2)
    return {"dm": dm_vid, "vids": vids,
            "state": state(s, [m1, m2], ["dmr"])}


def test_delete_marker_removal_replicates(sides):
    run_both(sides, c_delete_marker_removal)


def c_overwrite_race(s):
    """Which write wins is decided by the two writes' stamps, which race
    in the reference itself: the record holds that the zones agree and
    that the survivor is one of the two writes."""
    import hashlib
    m1, m2 = s.ms
    req(m1, "PUT", "/race")
    assert _wait(lambda: "race" in m2._buckets())
    req(m1, "PUT", "/race/k", b"AAAA")
    req(m2, "PUT", "/race/k", b"BBBB")

    def settled():
        if not (m1.sync.caught_up() and m2.sync.caught_up()):
            return False
        e1 = m1._index_entry("race", "k")
        e2 = m2._index_entry("race", "k")
        return (e1 and e2 and
                (e1["mtime"], e1["etag"]) == (e2["mtime"], e2["etag"]))
    assert _wait(settled)
    b1, b2 = _get_bytes(m1, "race", "k"), _get_bytes(m2, "race", "k")
    assert b1 == b2 and b1 in (b"AAAA", b"BBBB")
    e1 = m1._index_entry("race", "k")
    etags = {hashlib.md5(b).hexdigest(): b for b in (b"AAAA", b"BBBB")}
    assert etags[e1["etag"]] == b1
    return {"equal": b1 == b2, "one_of_two": b1 in (b"AAAA", b"BBBB"),
            "winner_by_etag": etags[e1["etag"]] == b1}


def test_overwrite_race_converges_deterministically(sides):
    run_both(sides, c_overwrite_race)


def c_suspended_overwrite(s):
    m1, m2 = s.ms
    vers_off = (b"<VersioningConfiguration>"
                b"<Status>Suspended</Status></VersioningConfiguration>")
    req(m1, "PUT", "/susp")
    req(m1, "PUT", "/susp?versioning", VERS_ON)
    req(m1, "PUT", "/susp?versioning", vers_off)
    req(m1, "PUT", "/susp/k", b"first")
    assert _wait(lambda: _get_bytes(m2, "susp", "k") == b"first")
    req(m1, "PUT", "/susp/k", b"second")
    assert _wait(lambda: _get_bytes(m2, "susp", "k") == b"second")

    def vids(gw):
        ent = gw._index_entry("susp", "k")
        return [v["vid"] for v in ent["versions"]] if ent else None
    out = [vids(m1), vids(m2)]
    assert out == [["null"], ["null"]]
    req(m1, "DELETE", "/susp/k")
    assert _wait(lambda: _get_bytes(m2, "susp", "k") is None and
                 m2._index_entry("susp", "k") is not None)
    assert m2._index_entry("susp", "k")["versions"][0]["dm"]
    settle(m1, m2)
    return {"vids": out, "state": state(s, [m1, m2], ["susp"])}


def test_suspended_overwrite_replicates(sides):
    run_both(sides, c_suspended_overwrite)


def c_delete_after_bumped_put(s):
    m1, m2 = s.ms
    req(m1, "PUT", "/dbump")
    future = time.strftime("%Y-%m-%dT%H:%M:%S",
                           time.gmtime(time.time() + 5)) + ".000Z"
    m1._now_str = lambda: future
    try:
        req(m1, "PUT", "/dbump/k", b"doomed")
    finally:
        del m1._now_str
    assert _wait(lambda: _get_bytes(m2, "dbump", "k") == b"doomed")
    req(m1, "DELETE", "/dbump/k")
    assert _get_bytes(m1, "dbump", "k") is None
    assert _wait(lambda: _get_bytes(m2, "dbump", "k") is None)
    settle(m1, m2)
    return state(s, [m1, m2], ["dbump"])


def test_delete_after_bumped_put_replicates(sides):
    run_both(sides, c_delete_after_bumped_put)


def _pool_omap(io) -> dict:
    return {oid: {k: v.decode("latin-1") for k, v in
                  sorted(io.get_omap_vals(oid)[0].items())}
            for oid in sorted(io.list_objects())}


def c_plain_put_replay(s):
    gw = s.gateway("rgw-tomb")
    gw._create_bucket("tb")
    put = {"key": "k", "op": "put", "mode": "plain", "size": 3,
           "etag": "e1", "mtime": "2026-08-03T12:00:00.000Z",
           "trace": ["zx"]}
    out = [gw.sync_apply("tb", put, b"v1!", "zx")]
    shard = s.p.datalog.shard_obj("tb", gw.shard_of("tb", "k"))
    gw.io.exec(shard, "rgw", "obj_delete_plain", {"key": "k"})
    out += [gw._index_entry("tb", "k"), "k" in gw._index("tb"),
            gw.sync_apply("tb", put, b"v1!", "zy"),
            gw._index_entry("tb", "k")]
    older = dict(put, etag="e2", mtime="2026-08-03T12:00:00.500Z")
    out += [gw.sync_apply("tb", older, b"v2!", "zy"),
            gw._index_entry("tb", "k"),
            gw.io.exec(shard, "rgw", "obj_delete_plain", {"key": "k"})]
    out.append(gw.io.exec(shard, "rgw", "obj_store",
                          {"key": "k", "mode": "plain", "size": 3,
                           "etag": "e3",
                           "mtime": "2026-08-03T12:00:01.000Z",
                           "obj": ".kv3"}))
    ent = gw._index_entry("tb", "k")
    raw = gw.io.get_omap_vals_by_keys(shard, ["k"])
    assert out[:5] == [True, None, False, False, None]
    assert out[5:7] == [False, None] and out[7]["removed"] == []
    assert out[8]["removed"] == [] and ent["etag"] == "e3"
    assert json.loads(raw["k"])["mtime"] > "2026-08-07"
    gw.httpd.server_close()     # never started
    return {"out": out, "ent": ent, "pool": _pool_omap(gw.io)}


def test_plain_put_replay_after_delete_does_not_resurrect(sides):
    run_both(sides, c_plain_put_replay)


def c_sync_del_on_absent_key(s):
    gw = s.gateway("rgw-tomb3")
    gw._create_bucket("tc")
    dele = {"key": "k", "op": "del",
            "mtime": "2026-08-03T12:00:01.000Z", "trace": ["zx"]}
    out = [gw.sync_apply("tc", dele, None, "zx"),
           gw._index_entry("tc", "k"),
           gw.sync_apply("tc", dele, None, "zy")]
    late = {"key": "k", "op": "put", "mode": "plain", "size": 3,
            "etag": "eo", "mtime": "2026-08-03T12:00:00.900Z",
            "trace": ["zy"]}
    out += [gw.sync_apply("tc", late, b"old", "zy"),
            gw._index_entry("tc", "k")]
    tied = dict(late, etag="et", mtime=dele["mtime"])
    out += [gw.sync_apply("tc", tied, b"tie", "zy"),
            gw._index_entry("tc", "k")]
    fresh = dict(late, etag="ef", mtime="2026-08-03T12:00:01.100Z")
    out += [gw.sync_apply("tc", fresh, b"new", "zy"),
            gw._index_entry("tc", "k")["etag"]]
    assert out == [True, None, False, False, None, False, None, True, "ef"]
    gw.httpd.server_close()     # never started
    return {"out": out, "pool": _pool_omap(gw.io)}


def test_sync_del_on_absent_key_leaves_tombstone(sides):
    run_both(sides, c_sync_del_on_absent_key)


def _synced_past(dst, src, bucket, key) -> bool:
    """`dst`'s cursor for `src`'s log of `key`'s shard has reached the
    head `src` holds now (so `dst` has pulled every record of it)."""
    sh = src.shard_of(bucket, key)
    head = src.datalog.head(bucket, sh)
    with dst.sync._lock:
        have = dst.sync._markers.get((src.zone, bucket, sh), -1)
    return have >= head


def c_cross_zone_delete_beats_racing_put(s):
    """The reference's wait for m2 to be caught up after the racing put
    may return before m2 has pulled it (caught up reads the heads of the
    round before); here m2's cursor must reach m1's head for the key's
    shard, so the racing put has been pulled and refused."""
    m1, m2 = s.ms
    req(m1, "PUT", "/tdrace")
    req(m1, "PUT", "/tdrace/k", b"v1")
    assert _wait(lambda: _get_bytes(m2, "tdrace", "k") == b"v1")
    req(m1, "PUT", "/tdrace/warm", b"w")
    assert _wait(lambda: _get_bytes(m2, "tdrace", "warm") == b"w")
    req(m2, "DELETE", "/tdrace/warm")
    assert _wait(lambda: _get_bytes(m1, "tdrace", "warm") is None)
    real = m1.peer_request

    def stall(endpoint, method, path, *a, **k):
        if path == "/admin/log":
            raise urllib.error.URLError("stalled")
        return real(endpoint, method, path, *a, **k)
    m1.peer_request = stall
    try:
        req(m2, "DELETE", "/tdrace/k")
        m1._now_str = lambda: "2000-01-01T00:00:00.000Z"
        try:
            req(m1, "PUT", "/tdrace/k", b"v2-racer")
        finally:
            del m1._now_str
        assert _get_bytes(m1, "tdrace", "k") == b"v2-racer"
        assert _wait(lambda: _synced_past(m2, m1, "tdrace", "k"))
        assert _wait(lambda: m2.sync.caught_up())
        assert _get_bytes(m2, "tdrace", "k") is None
    finally:
        m1.peer_request = real
    assert _wait(lambda: _get_bytes(m1, "tdrace", "k") is None)
    assert _get_bytes(m2, "tdrace", "k") is None
    settle(m1, m2)
    return state(s, [m1, m2], ["tdrace"])


def test_cross_zone_delete_beats_racing_put(sides):
    run_both(sides, c_cross_zone_delete_beats_racing_put)


def c_forwarded_master_refusal(s):
    m1, m2 = s.ms
    req(m1, "PUT", "/fwderr")
    assert _wait(lambda: "fwderr" in m2._buckets())
    xml = (b'<?xml version="1.0"?><Error><Code>BucketNotEmpty</Code>'
           b"<Message>fwderr</Message></Error>")
    real = m2.peer_request

    def refuse(endpoint, method, path, *a, **k):
        if method == "DELETE" and path == "/fwderr":
            raise urllib.error.HTTPError(endpoint + path, 409, "Conflict",
                                         {}, _io.BytesIO(xml))
        return real(endpoint, method, path, *a, **k)
    m2.peer_request = refuse
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            req(m2, "DELETE", "/fwderr")
    finally:
        m2.peer_request = real
    assert ei.value.code == 409
    body = ei.value.read()
    assert ET.fromstring(body).findtext("Code") == "BucketNotEmpty"
    return [ei.value.code, body.decode()]


def test_forwarded_master_refusal_passes_through(sides):
    run_both(sides, c_forwarded_master_refusal)


def c_bucket_404_mid_round(s):
    m1, m2 = s.ms
    req(m1, "PUT", "/gone")
    req(m1, "PUT", "/gone/k", b"g")
    req(m1, "PUT", "/alive")
    assert _wait(lambda: _get_bytes(m2, "gone", "k") == b"g")
    real = m2.peer_request

    def vanish(endpoint, method, path, *a, **k):
        body = a[0] if a else k.get("body")
        if path == "/admin/log" and body and b'"gone"' in body:
            raise urllib.error.HTTPError(endpoint + path, 404, "Not Found",
                                         {}, _io.BytesIO(b"{}"))
        return real(endpoint, method, path, *a, **k)
    m2.peer_request = vanish
    try:
        req(m1, "PUT", "/alive/k", b"still-flowing")
        assert _wait(lambda:
                     _get_bytes(m2, "alive", "k") == b"still-flowing")
        assert _wait(lambda: m2.sync.status()["sources"][0]["state"]
                     != "backoff" and m2.sync.caught_up())
        failures = m2.sync._backoff["m1"].failures
    finally:
        m2.peer_request = real
    settle(m1, m2)
    return {"failures": failures,
            "state": state(s, [m1, m2], ["gone", "alive"])}


def test_bucket_404_mid_round_skips_not_backoff(sides):
    run_both(sides, c_bucket_404_mid_round)


def c_versioned_same_mtime(s):
    gw = s.gateway("rgw-tie")
    mt = "2026-08-03T12:00:00.000Z"
    a = {"key": "k", "op": "put", "mode": "enabled", "vid": "va",
         "size": 4, "etag": "ea", "mtime": mt, "trace": ["zx"]}
    b = dict(a, vid="vb", etag="eb")
    for bucket, order in (("cva", (a, b)), ("cvb", (b, a))):
        gw._create_bucket(bucket)
        for ent in order:
            assert gw.sync_apply(bucket, ent,
                                 b"dat-" + ent["vid"].encode(), "zx")
    sa = [v["vid"] for v in gw._index_entry("cva", "k")["versions"]]
    sb = [v["vid"] for v in gw._index_entry("cvb", "k")["versions"]]
    assert sa == sb == ["vb", "va"]
    gw._create_bucket("cvl")
    o1 = {"key": "k", "mode": "enabled", "vid": "va", "size": 4,
          "etag": "ea", "mtime": mt, "obj": ".x1"}
    o2 = dict(o1, vid="vb", etag="eb", obj=".x2")
    sh = gw.shard_of("cvl", "k")
    for ent in (o2, o1):
        gw.io.exec(s.p.datalog.shard_obj("cvl", sh), "rgw", "obj_store",
                   ent)
    vers = gw._index_entry("cvl", "k")["versions"]
    assert [v["vid"] for v in vers] == ["va", "vb"]
    assert vers[0]["mtime"] > vers[1]["mtime"]
    gw.httpd.server_close()     # never started
    return {"sa": sa, "sb": sb, "vers": vers, "pool": _pool_omap(gw.io)}


def test_versioned_same_mtime_insert_converges(sides):
    run_both(sides, c_versioned_same_mtime)


def c_master_bucket_delete(s):
    m1, m2 = s.ms
    req(m1, "PUT", "/bdel")
    assert _wait(lambda: "bdel" in m2._buckets())
    req(m1, "DELETE", "/bdel")
    assert "bdel" not in m1._buckets()
    assert _wait(lambda: "bdel" not in m2._buckets())
    rounds(m1, m2)
    assert "bdel" not in m1._buckets()
    assert "bdel" not in m2._buckets()
    req(m1, "PUT", "/bdel")
    req(m1, "PUT", "/bdel/k2", b"second-life")
    assert _wait(lambda: _get_bytes(m2, "bdel", "k2") == b"second-life")
    settle(m1, m2)
    return state(s, [m1, m2], ["bdel"])


def test_master_bucket_delete_propagates(sides):
    run_both(sides, c_master_bucket_delete)


def c_datalog_auto_trim(s):
    t1, t2 = s.zones(("t1", "t2"), sync_interval=0.02)
    req(t1, "PUT", "/tb")
    for i in range(6):
        req(t1, "PUT", f"/tb/k{i}", b"v%d" % i)
    assert _wait(lambda: t2.sync.caught_up())
    out = {"before": _dl_entries(s, t1, "tb")}
    assert len(out["before"]) == 6
    assert _wait(lambda: sum(
        int(m) for m in t2.sync.markers_for("t1")
        .get("tb", {"cursors": {}})["cursors"].values()) >= 6)
    out["markers"] = t2.sync.markers_for("t1")

    def _trim_converged():
        t1.sync.datalog_trim_round()
        return _dl_entries(s, t1, "tb") == []
    assert _wait(_trim_converged)
    assert t1.sync.datalog_trimmed >= 6
    t2.sync.stop()
    for i in range(4):
        req(t1, "PUT", f"/tb/l{i}", b"w%d" % i)
    out["lagging"] = _dl_entries(s, t1, "tb")
    assert len(out["lagging"]) == 4
    out["blocked"] = t1.sync.datalog_trim_round()
    assert out["blocked"] == 0
    assert len(_dl_entries(s, t1, "tb")) == 4
    assert min(e["seq"] for e in _dl_entries(s, t1, "tb")) > 0
    for key in [f"k{i}" for i in range(6)] + [f"l{i}" for i in range(4)]:
        req(t1, "DELETE", f"/tb/{key}")
    req(t1, "DELETE", "/tb")
    req(t1, "PUT", "/tb")
    req(t1, "PUT", "/tb/fresh", b"new-life")
    entries = _dl_entries(s, t1, "tb")
    stale = t2.sync.markers_for("t1")["tb"]
    assert sum(int(m) for m in stale["cursors"].values()) >= 6
    assert min(e["seq"] for e in entries) <= max(
        int(m) for m in stale["cursors"].values())
    out["incarnation"] = t1.sync.datalog_trim_round()
    assert out["incarnation"] == 0
    assert len(_dl_entries(s, t1, "tb")) == len(entries)
    out.update(fresh=entries, stale=stale,
               durable={k: json.loads(v) for k, v in t2.io.get_omap_vals(
                   s.p.multisite.sync_status_obj("t1"))[0].items()})
    s.close([t1, t2])
    return out


def test_datalog_auto_trim_and_lagging_peer_blocks(sides):
    run_both(sides, c_datalog_auto_trim)


def c_registry_tombstones_pruned(s):
    """The reference holds m2's pull for 0.3 s and waits 0.4 s of m1's
    rounds; here both are waits for three more rounds of the agent."""
    m1, m2 = s.ms
    req(m1, "PUT", "/btomb")
    assert _wait(lambda: "btomb" in m2._buckets())
    held = m2.sync._sync_peer
    m2.sync._sync_peer = lambda peer, views=None: 0
    try:
        rounds(m2)
        req(m1, "DELETE", "/btomb")
        assert "deleted" in m1._buckets_raw()["btomb"]
        rounds(m1)
        assert "btomb" in m2._buckets(), "hold failed: peer applied it"
        assert "btomb" in m1._buckets_raw(), \
            "tombstone pruned while the peer still held a live copy"
    finally:
        m2.sync._sync_peer = held
    live_view = {"m2": (s.p.cls_rgw.now_str(),
                        {"btomb": {"created": "1970-01-01T00:00:00"}})}
    stale_view = {"m2": ("1970-01-01T00:00:00.000Z", {})}
    out = [m1.prune_registry_tombstones(live_view),
           m1.prune_registry_tombstones(stale_view)]
    assert out == [0, 0]
    assert _wait(lambda: "btomb" not in m1._buckets_raw() and
                 "btomb" not in m2._buckets_raw())
    rounds(m1, m2)
    assert "btomb" not in m1._buckets()
    assert "btomb" not in m2._buckets()
    req(m1, "PUT", "/btomb")
    req(m1, "PUT", "/btomb/k", b"reborn")
    assert _wait(lambda: _get_bytes(m2, "btomb", "k") == b"reborn")
    settle(m1, m2)
    return {"out": out, "state": state(s, [m1, m2], ["btomb"])}


def test_registry_tombstones_pruned_after_peers_pass(sides):
    run_both(sides, c_registry_tombstones_pruned)


def c_reserved_object_keys(s):
    m1, _ = s.ms
    req(m1, "PUT", "/rsv")
    return [code(req, m1, "PUT", f"/rsv/{key}", b"x")
            for key in (".dlmeta", ".dl.00000001", ".upload.deadbeef")]


def test_reserved_object_keys_rejected(sides):
    assert run_both(sides, c_reserved_object_keys) == [400, 400, 400]


def c_secondary_config_ops(s):
    m1, m2 = s.ms
    req(m2, "PUT", "/cfgf")
    assert _wait(lambda: "cfgf" in m1._buckets())
    req(m2, "PUT", "/cfgf?versioning", VERS_ON)
    out = [m1._buckets()["cfgf"].get("versioning")]
    rounds(m1, m2)
    out.append(m2._buckets()["cfgf"].get("versioning"))
    req(m2, "DELETE", "/cfgf")
    out.append("cfgf" in m1._buckets())
    rounds(m1, m2)
    out.append("cfgf" in m2._buckets())
    assert out == ["Enabled", "Enabled", False, False]
    return out


def test_secondary_config_ops_forward_and_survive(sides):
    run_both(sides, c_secondary_config_ops)


def c_secondary_metadata_forward(s):
    m1, m2 = s.ms
    req(m2, "PUT", "/fwd")
    out = ["fwd" in m1._buckets(), "fwd" in m2._buckets()]
    assert out == [True, True]
    return out


def test_secondary_metadata_ops_forward_to_master(sides):
    run_both(sides, c_secondary_metadata_forward)


# ------------------------------------- kill / restart, notifications

class _Receiver:
    def __init__(self):
        self.events = []
        rec = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                rec.events.append(json.loads(body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def keys(self):
        return [e["Records"][0]["s3"]["object"]["key"]
                for e in self.events]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _queue_len(s, gw, topic: str) -> int:
    try:
        return len(gw.io.get_omap_vals(s.p.notify._queue_obj(topic))[0])
    except s.p.RadosError:
        return 0


def c_kill_mid_sync_restart(s):
    """The reference's 0.5 s grace for straggling notifications is a
    wait for both zones' queues of the topic to be empty here: the
    origin's drained, the replica's never filled."""
    k1, k2 = s.zones(("k1", "k2"), sync_interval=0.02)
    rec = _Receiver()
    s.mask_port(rec.port, "receiver")
    try:
        for gw in (k1, k2):
            req(gw, "POST",
                f"/?Action=CreateTopic&Name=kt&push-endpoint="
                f"http%3A%2F%2F127.0.0.1%3A{rec.port}%2F")
        req(k1, "PUT", "/kb")
        req(k1, "PUT", "/kb?notification",
            b'<NotificationConfiguration><TopicConfiguration>'
            b'<Id>n</Id><Topic>arn:aws:sns:::kt</Topic>'
            b'<Event>s3:ObjectCreated:*</Event>'
            b'</TopicConfiguration></NotificationConfiguration>')
        n = 40
        payload = {f"o{i:02d}": b"payload-%02d" % i for i in range(n)}
        for k, v in payload.items():
            req(k1, "PUT", f"/kb/{k}", v)
        _wait(lambda: len(k2._index("kb")) >= 5, timeout=20)
        s.c.kill_rgw_zone(k2)
        k2b = s.restart(k2)
        assert _wait(lambda: len(k2b._index("kb")) == n)
        for k, v in payload.items():
            assert _get_bytes(k2b, "kb", k) == v
        assert _wait(lambda: k2b.sync.caught_up())
        assert k2b.sync.full_syncs == 0
        puts = [e for e in _dl_entries(s, k2b, "kb") if e["op"] == "put"]
        assert sorted(e["key"] for e in puts) == sorted(payload)
        assert _wait(lambda: len(rec.events) >= n and
                     _queue_len(s, k1, "kt") == 0 and
                     _queue_len(s, k2b, "kt") == 0)
        assert sorted(rec.keys()) == sorted(payload)
        vals, _ = k2b.io.get_omap_vals(s.p.multisite.sync_status_obj("k1"))
        assert any(k.startswith("m.kb.") for k in vals)
        settle(k1, k2b)
        out = {"full_syncs": k2b.sync.full_syncs,
               "puts": sorted(e["key"] for e in puts),
               "events": sorted(rec.keys()),
               "markers": {k: json.loads(v) for k, v in vals.items()
                           if k.startswith("m.kb.")},
               "state": state(s, [k1, k2b], ["kb"])}
        s.close([k1, k2b])
        return out
    finally:
        rec.close()


def test_kill_mid_sync_restart_resumes_from_markers(sides):
    run_both(sides, c_kill_mid_sync_restart)


def c_recreate_while_replica_down(s):
    r1, r2 = s.zones(("r1", "r2"), sync_interval=0.02)
    req(r1, "PUT", "/rb")
    req(r1, "PUT", "/rb/old1", b"old-1")
    req(r1, "PUT", "/rb/old2", b"old-2")
    assert _wait(lambda: _get_bytes(r2, "rb", "old1") == b"old-1" and
                 _get_bytes(r2, "rb", "old2") == b"old-2")
    assert _wait(lambda: r2.sync.caught_up())
    s.c.kill_rgw_zone(r2)
    req(r1, "DELETE", "/rb/old1")
    req(r1, "DELETE", "/rb/old2")
    req(r1, "DELETE", "/rb")
    req(r1, "PUT", "/rb")
    req(r1, "PUT", "/rb/new1", b"new-1")
    r2b = s.restart(r2)
    assert _wait(lambda: _get_bytes(r2b, "rb", "new1") == b"new-1")
    assert _wait(lambda: _get_bytes(r2b, "rb", "old1") is None and
                 _get_bytes(r2b, "rb", "old2") is None)
    assert set(r2b._index("rb")) == {"new1"}
    settle(r1, r2b)
    assert r2b._buckets_raw()["rb"]["created"] == \
        r1._buckets_raw()["rb"]["created"]
    out = state(s, [r1, r2b], ["rb"])
    s.close([r1, r2b])
    return out


def test_recreate_while_replica_down_discards_stale_content(sides):
    run_both(sides, c_recreate_while_replica_down)


def _entry_view(ent: dict) -> dict:
    """A quarantined entry but its datalog fields: whether it arrived by
    full sync (no `seq`, an empty trace) or by the datalog races in the
    reference itself."""
    return {k: v for k, v in ent.items() if k not in ("seq", "trace")}


def c_poisoned_entry(s):
    p1, p2 = s.zones(("p1", "p2"), sync_interval=0.02)
    orig = p2.sync_apply
    poisoned = threading.Event()
    poisoned.set()

    def wrapper(bucket, ent, data, src, **kw):
        if poisoned.is_set() and ent["key"] == "poison":
            raise RuntimeError("injected apply failure")
        return orig(bucket, ent, data, src, **kw)
    p2.sync_apply = wrapper
    req(p1, "PUT", "/pz")
    req(p1, "PUT", "/pz/ok1", b"one")
    req(p1, "PUT", "/pz/poison", b"toxic")
    req(p1, "PUT", "/pz/ok2", b"two")
    assert _wait(lambda: _get_bytes(p2, "pz", "ok1") == b"one" and
                 _get_bytes(p2, "pz", "ok2") == b"two")
    assert _get_bytes(p2, "pz", "poison") is None
    assert _wait(lambda: len(p2.sync.error_list()) == 1)
    rec = p2.sync.error_list()[0]
    assert rec["entry"]["key"] == "poison" and rec["bucket"] == "pz"
    assert "injected apply failure" in rec["err"]
    assert _wait(lambda: p2.sync.error_list()[0]["retries"] >= 2)
    st = [x for x in p2.sync.status()["sources"] if x["source"] == "p1"][0]
    assert st["errors"] == 1 and not st["caught_up"]
    assert _wait(lambda: any(
        k.startswith("e.pz.") and json.loads(v)
        for k, v in p2.io.get_omap_vals(
            s.p.multisite.sync_status_obj("p1"))[0].items()))
    durable = {k: [{"entry": _entry_view(e["entry"]), "err": e["err"]}
                   for e in json.loads(v)]
               for k, v in p2.io.get_omap_vals(
                   s.p.multisite.sync_status_obj("p1"))[0].items()
               if k.startswith("e.pz.") and json.loads(v)}
    poisoned.clear()
    assert _wait(lambda: _get_bytes(p2, "pz", "poison") == b"toxic")
    assert _wait(lambda: not p2.sync.error_list())
    settle(p1, p2)
    out = {"rec": {"entry": _entry_view(rec["entry"]),
                   **{f: rec[f] for f in ("bucket", "shard", "err",
                                          "source")}},
           "status": st, "durable": durable,
           "state": state(s, [p1, p2], ["pz"])}
    s.close([p1, p2])
    return out


def test_poisoned_entry_quarantined_and_retried(sides):
    run_both(sides, c_poisoned_entry, faults=True)


# ------------------------------------------------- keystone satellite

class _KeystoneStub:
    def __init__(self, tokens):
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                tok = self.headers.get("X-Subject-Token", "")
                if self.path != "/v3/auth/tokens" or \
                        tok not in stub.tokens:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps({"token": stub.tokens[tok]}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.tokens = tokens
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _keystone():
    return _KeystoneStub({
        "tok-good": {"user": {"name": "alice"}},
        "tok-expired": {"user": {"name": "bob"},
                        "expires_at": time.time() - 5},
        "tok-iso": {"user": {"name": "carol"},
                    "expires_at": "2099-01-01T00:00:00Z"}})


def _ks_status(fn, *a):
    """What a validation raised: (status, code), or its value."""
    try:
        return fn(*a)
    except (ref_auth.KeystoneError, port_auth.KeystoneError) as e:
        return [e.status, e.code]


def test_amz_date_parses_utc_under_dst_tz():
    """x-amz-date is UTC, whatever the host's DST offset: both packages
    parse it to the same instant."""
    import calendar
    import os
    old = os.environ.get("TZ")
    os.environ["TZ"] = "America/New_York"
    time.tzset()
    try:
        got = {k: PKG[k].auth._parse_amz_date("20260715T120000Z")
               for k in KINDS}
    finally:
        if old is None:
            os.environ.pop("TZ", None)
        else:
            os.environ["TZ"] = old
        time.tzset()
    assert got["port"] == got["ref"] == \
        calendar.timegm((2026, 7, 15, 12, 0, 0, 0, 0, 0))


def c_keystone_engine_validation(s):
    ks = _keystone()
    s.mask_port(ks.port, "keystone")
    eng = s.p.auth.KeystoneEngine(ks.url)
    out = [_ks_status(eng.validate, t) for t in
           ("tok-good", "tok-iso", "tok-unknown", "", "tok-expired")]
    ks.close()
    out.append(_ks_status(eng.validate, "tok-never-seen"))
    assert out == ["alice", "carol", [401, out[2][1]], [401, out[3][1]],
                   [403, "AccessDenied"], [503, out[5][1]]]
    return out


def test_keystone_engine_validation(sides):
    run_both(sides, c_keystone_engine_validation)


def c_keystone_cache_expiry(s):
    """The reference sleeps 0.8 s past the token's expiry; here the
    auth module's clock moves 0.8 s instead."""
    ks = _keystone()
    s.mask_port(ks.port, "keystone")
    clock = OffsetClock()
    s.mp.setattr(s.p.auth, "_time", clock)
    try:
        ks.tokens["tok-brief"] = {"user": {"name": "dave"},
                                  "expires_at": time.time() + 0.6}
        eng = s.p.auth.KeystoneEngine(ks.url)
        out = [_ks_status(eng.validate, "tok-brief")]
        clock.offset = 0.8
        out.append(_ks_status(eng.validate, "tok-brief"))
    finally:
        s.mp.setattr(s.p.auth, "_time", time)
        ks.close()
    assert out == ["dave", [403, "AccessDenied"]]
    return out


def test_keystone_cache_still_enforces_expiry(sides):
    run_both(sides, c_keystone_cache_expiry)


def c_keystone_gateway_config_gated(s):
    ks = _keystone()
    s.mask_port(ks.port, "keystone")
    g = s.gateway("ksgw", keystone_url=ks.url)
    g.start()
    out = []
    try:
        out.append(req(g, "PUT", "/ksb",
                       headers={"X-Auth-Token": "tok-good"})[0])
        for tok in ("tok-expired", "tok-bogus"):
            try:
                req(g, "PUT", "/ksb2", headers={"X-Auth-Token": tok})
            except urllib.error.HTTPError as e:
                out.append([e.code, e.read().decode()])
        out.append(code(req, g, "PUT", "/ksb3"))
    finally:
        g.shutdown()
    g2 = s.gateway("ksgw2")
    g2.start()
    try:
        out.append(req(g2, "PUT", "/anon",
                       headers={"X-Auth-Token": "tok-bogus"})[0])
    finally:
        g2.shutdown()
        ks.close()
    assert [out[0], out[1][0], out[2][0], out[3], out[4]] == \
        [200, 403, 401, 401, 200]
    assert "AccessDenied" in out[1][1]
    return out


def test_keystone_gateway_config_gated(sides):
    run_both(sides, c_keystone_gateway_config_gated)


def c_keystone_only_multisite(s, capsys):
    ks = _keystone()
    s.mask_port(ks.port, "keystone")
    k1, k2 = s.zones(("ks1", "ks2"), zonegroup="kszg", realm="ksr",
                     keystone_url=ks.url, system_key=("sys-ak", "sys-sk"))
    tok = {"X-Auth-Token": "tok-good"}
    cli = s.p.cli

    def get(gw, path):
        try:
            return req(gw, "GET", path, headers=dict(tok))[2]
        except urllib.error.HTTPError:
            return None
    out = {}
    try:
        out["put"] = req(k1, "PUT", "/ksms", headers=dict(tok))[0]
        req(k1, "PUT", "/ksms/k", b"ks-bytes", headers=dict(tok))
        assert _wait(lambda: get(k2, "/ksms/k") == b"ks-bytes")
        settle(k1, k2)
        bad = s.p.auth.sign_request("GET", "/",
                                    {"host": f"127.0.0.1:{k1.port}"},
                                    b"", "sys-ak", "wrong-sk")
        out["bad"] = code(req, k1, "GET", "/", headers=bad)
        ep = f"http://127.0.0.1:{k2.port}"
        capsys.readouterr()
        out["unsigned"] = cli.main(["rgw", "sync-status", "--endpoint", ep],
                                   rados=s.c.rados(), out=_io.StringIO())
        out["unsigned_err"] = capsys.readouterr().err
        buf = _io.StringIO()
        out["signed"] = cli.main(
            ["rgw", "sync-status", "--endpoint", ep,
             "--access", "sys-ak", "--secret", "sys-sk"],
            rados=s.c.rados(), out=buf)
        out["signed_out"] = buf.getvalue()
        s.c.kill_rgw_zone(k2)
        k2 = s.restart(k2)
        out["restarted"] = [list(k2.system_key), k2.keystone is not None]
        req(k1, "PUT", "/ksms/k2", b"after-restart", headers=dict(tok))
        assert _wait(lambda: get(k2, "/ksms/k2") == b"after-restart")
        settle(k1, k2)
        out["state"] = state(s, [k1, k2], ["ksms"])
    finally:
        s.close([k1, k2])
        ks.close()
    assert out["put"] == 200 and out["bad"] == 403
    assert out["unsigned"] == 1 and "gateway refused" in out["unsigned_err"]
    assert out["signed"] == 0 and "ks1" in out["signed_out"]
    assert out["restarted"] == [["sys-ak", "sys-sk"], True]
    return out


def test_keystone_only_multisite_replicates(sides, capsys):
    run_both(sides, lambda s: c_keystone_only_multisite(s, capsys))


def c_forwarded_create_adopts_master_stamp(s):
    m1, m2 = s.ms
    req(m2, "PUT", "/fwdstamp")
    assert _wait(lambda: "fwdstamp" in m1._buckets() and
                 "fwdstamp" in m2._buckets())
    stamps = [m1._buckets_raw()["fwdstamp"]["created"],
              m2._buckets_raw()["fwdstamp"]["created"]]
    assert stamps[0] == stamps[1]
    req(m1, "PUT", "/fwdstamp/ok", b"ok")
    copy = code(req, m1, "PUT", "/fwdstamp/copy", headers={
        "x-amz-copy-source": "/fwdstamp/.dlmeta"})
    assert copy == 404
    settle(m1, m2)
    return {"stamps": stamps, "copy": copy,
            "state": state(s, [m1, m2], ["fwdstamp"])}


def test_forwarded_create_adopts_master_stamp(sides):
    run_both(sides, c_forwarded_create_adopts_master_stamp)


def c_reserved_key_reads(s):
    m1, _ = s.ms
    req(m1, "PUT", "/resk")
    req(m1, "PUT", "/resk/x", b"x")
    out = [code(req, m1, method, f"/resk/{key}")
           for key in (".dlmeta", ".dl.0000000000000001", ".upload.dead")
           for method in ("GET", "HEAD")]
    out.append(code(req, m1, "PUT", "/resk/.dlmeta", b"z"))
    assert out == [404] * 6 + [400]
    return out


def test_reserved_key_reads_are_clean_404(sides):
    run_both(sides, c_reserved_key_reads)


def c_synth_retry(s):
    m1, m2 = s.ms
    req(m1, "PUT", "/synthb")
    req(m1, "PUT", "/synthb/k", b"real-bytes")
    assert _wait(lambda: _get_bytes(m2, "synthb", "k") == b"real-bytes")
    settle(m1, m2)
    ep = f"http://127.0.0.1:{m1.port}"
    ghost = {"key": "ghost", "op": "synth", "vid": None, "trace": []}
    out = [m2.sync._apply("m1", ep, "synthb", ghost)]
    for sh in range(m2._nshards("synthb")):
        try:
            m2.io.remove_omap_keys(s.p.gateway._index_obj("synthb", sh),
                                   ["k"])
        except s.p.RadosError:
            pass
    out.append(_get_bytes(m2, "synthb", "k"))
    ent = {"key": "k", "op": "synth", "vid": None, "trace": []}
    out.append(m2.sync._apply("m1", ep, "synthb", ent))
    restored = m2._index_entry("synthb", "k")
    assert restored["etag"] and restored["mtime"]
    assert restored["etag"] == m1._index_entry("synthb", "k")["etag"]
    out += [_get_bytes(m2, "synthb", "k").decode(),
            m2.sync._apply("m1", ep, "synthb", ent)]
    assert out == [0, None, 1, "real-bytes", 0]
    settle(m1, m2)
    return {"out": out, "state": state(s, [m1, m2], ["synthb"])}


def test_synth_retry_applies_real_source_state(sides):
    run_both(sides, c_synth_retry)


def c_datalog_head_probe(s):
    m1, _ = s.ms
    req(m1, "PUT", "/dlh")
    req(m1, "PUT", "/dlh/k", b"x")
    dl = s.p.datalog.DataLog(m1.io)
    out = [dl.list("dlh", sh, 0, 0) for sh in range(m1._nshards("dlh"))]
    assert all(ents == [] for ents, _ in out)
    assert sum(head for _, head in out) >= 1
    return out


def test_datalog_head_probe_returns_no_entries(sides):
    run_both(sides, c_datalog_head_probe)


def c_zero_peer_trims_by_age(s):
    """The reference sleeps 0.15 s so the records pass a 0.1 s age;
    here the multisite module's clock moves 0.15 s instead."""
    solo, = s.zones(("solo",), zonegroup="zgsolo", realm="lone",
                    sync_interval=0.5)
    clock = OffsetClock()
    s.mp.setattr(s.p.multisite, "time", clock)
    try:
        assert solo.multisite.peers() == []
        req(solo, "PUT", "/ab")
        for i in range(6):
            req(solo, "PUT", f"/ab/k{i}", b"v%d" % i)
        out = {"first": _dl_entries(s, solo, "ab")}
        assert len(out["first"]) == 6
        out["young"] = solo.sync.datalog_trim_round()
        assert out["young"] == 0
        assert json.loads(req(solo, "GET", "/admin/bucket?name=ab")[2])
        floors = solo.fullsync_floor("ab")
        assert floors and sum(floors.values()) >= 6
        out["floors"] = floors
        for i in range(3):
            req(solo, "PUT", f"/ab/post{i}", b"p%d" % i)
        clock.offset = 0.15
        solo.sync.NOPEER_MAX_AGE_S = 0.1
        assert _wait(lambda: (solo.sync.datalog_trim_round() or True) and
                     len(_dl_entries(s, solo, "ab")) == 3)
        out["left"] = sorted(e["key"] for e in _dl_entries(s, solo, "ab"))
        assert out["left"] == [f"post{i}" for i in range(3)]
        solo.FULLSYNC_GRACE_S = 0.0
        assert solo.fullsync_floor("ab") is None
        solo.sync.NOPEER_TRIM_MAX = 1
        clock.offset = 0.3
        assert _wait(lambda: (solo.sync.datalog_trim_round() or True) and
                     _dl_entries(s, solo, "ab") == [])
        assert solo.sync.datalog_trimmed >= 9
        out["trimmed"] = solo.sync.datalog_trimmed
    finally:
        s.mp.setattr(s.p.multisite, "time", time)
        s.close([solo])
    return out


def test_zero_peer_datalog_trims_by_age_respecting_fullsync(sides):
    run_both(sides, c_zero_peer_trims_by_age)


# ------------------------------------------------- the port's own pins

def test_torn_marker_record_is_dropped_and_counted(sides):
    """A durable marker record that does not decode is dropped on load
    (the shard full-syncs again) in both packages; the port counts it at
    `load_state_record`."""
    def case(s):
        m1, m2 = s.ms
        req(m1, "PUT", "/torn")
        req(m1, "PUT", "/torn/k", b"t")
        assert _wait(lambda: _get_bytes(m2, "torn", "k") == b"t")
        settle(m1, m2)
        sobj = s.p.multisite.sync_status_obj("m1")
        m2.io.set_omap(sobj, {"m.torn.0": b"{not json"})
        agent = s.p.multisite.SyncAgent(m2, interval=0.05)
        agent._load_state("m1")
        out = {"loaded": sorted(k for k in agent._markers
                                if k[1] == "torn"),
               "dropped": ("m1", "torn", 0) not in agent._markers}
        agent.stop()
        m2.io.remove_omap_keys(sobj, ["m.torn.0"])
        return out
    before = port_multisite.SWALLOWED["load_state_record"]
    got = run_both(sides, case, faults=True)
    assert got["dropped"]
    assert port_multisite.SWALLOWED["load_state_record"] == before + 1


def test_zone_member_status_and_gauge_rows_equal_the_reference(sides):
    """`SyncAgent.status()` (but its times and apply counters) and the
    rows `sync_status_all` gives the prometheus gauges, on the shared
    site after it settles."""
    def case(s):
        m1, m2 = s.ms
        settle(m1, m2)
        rows = [r for r in s.p.multisite.sync_status_all()
                if r["zone"] in ("m1", "m2")]
        return {"status": [status_view(g.sync.status()) for g in (m1, m2)],
                "rows": sorted(rows, key=lambda r: r["zone"]),
                "render": s.p.multisite.render_sync_status(m2.sync.status())}
    got = run_both(sides, case)
    assert all(r["lag_entries"] == 0 for r in got["rows"])
