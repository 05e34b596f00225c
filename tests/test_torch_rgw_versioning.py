"""The port's versioned buckets, lifecycle and presigned URLs held to the
reference's at tolerance 0: every case of tests/test_rgw_versioning.py,
run as tests/test_torch_rgw.py runs the gateway cases (its `Side`,
`run_both` and masks; the docstring there lists what is seeded and what
is masked).

Where the reference test ages an index entry from the wall clock, the
case ages it from the instant both sides' clocks start at, and
`lc_tick` takes the side's clock as `now`: the same ages on both sides.
A presigned URL is stamped by the wall clock, as in the reference test;
its stamp is in the request, not in what is compared.
"""
import json
import time
from xml.etree import ElementTree as ET

from test_torch_rgw import BASE_MS, SECRETS, req, run_both
from test_torch_rgw import sides  # noqa: F401  (the fixture)

VERS_ON = (b'<VersioningConfiguration>'
           b'<Status>Enabled</Status></VersioningConfiguration>')
VERS_OFF = (b'<VersioningConfiguration>'
            b'<Status>Suspended</Status></VersioningConfiguration>')


def tags(body: bytes, tag: str) -> list:
    return [e for e in ET.fromstring(body).iter() if e.tag == tag]


def c_versioned_put_get_delete_roundtrip(s):
    gw = s.gw("rgwv")
    out = [req(s, gw, "PUT", "/vb"), req(s, gw, "PUT", "/vb?versioning",
                                         VERS_ON),
           req(s, gw, "GET", "/vb?versioning")]
    assert b"<Status>Enabled</Status>" in out[-1][2]
    vids = []
    for gen in (b"gen-one", b"gen-two", b"gen-three"):
        out.append(req(s, gw, "PUT", "/vb/doc", gen))
        assert out[-1][0] == 200
        vids.append(out[-1][1]["x-amz-version-id"])
    assert len(set(vids)) == 3
    out += [req(s, gw, "GET", "/vb/doc"),
            req(s, gw, "GET", f"/vb/doc?versionId={vids[0]}"),
            req(s, gw, "GET", f"/vb/doc?versionId={vids[1]}")]
    assert [o[2] for o in out[-3:]] == [b"gen-three", b"gen-one", b"gen-two"]
    out.append(req(s, gw, "DELETE", "/vb/doc"))
    assert out[-1][0] == 204 and \
        out[-1][1].get("x-amz-delete-marker") == "true"
    marker_vid = out[-1][1]["x-amz-version-id"]
    out += [req(s, gw, "GET", "/vb/doc"), req(s, gw, "GET", "/vb")]
    assert out[-2][0] == 404 and b"<Key>doc</Key>" not in out[-1][2]
    out.append(req(s, gw, "GET", f"/vb/doc?versionId={vids[2]}"))
    assert out[-1][2] == b"gen-three"
    out.append(req(s, gw, "GET", "/vb?versions"))
    assert len(tags(out[-1][2], "Version")) == 3
    assert len(tags(out[-1][2], "DeleteMarker")) == 1
    out += [req(s, gw, "DELETE", f"/vb/doc?versionId={marker_vid}"),
            req(s, gw, "GET", "/vb/doc")]
    assert out[-2][0] == 204 and out[-1][2] == b"gen-three"
    out += [req(s, gw, "DELETE", f"/vb/doc?versionId={vids[2]}"),
            req(s, gw, "GET", "/vb/doc")]
    assert out[-2][0] == 204 and out[-1][2] == b"gen-two"
    return out


def test_versioned_put_get_delete_roundtrip(sides):
    run_both(sides, c_versioned_put_get_delete_roundtrip, ["rgwv"])


def c_suspended_versioning_null_version(s):
    gw = s.gw("rgwv")
    out = [req(s, gw, "PUT", "/sb"), req(s, gw, "PUT", "/sb?versioning",
                                         VERS_ON),
           req(s, gw, "PUT", "/sb/k", b"versioned-era"),
           req(s, gw, "PUT", "/sb?versioning", VERS_OFF),
           req(s, gw, "PUT", "/sb/k", b"null-era")]
    assert out[-1][1]["x-amz-version-id"] == "null"
    out += [req(s, gw, "PUT", "/sb/k", b"null-era-2"),
            req(s, gw, "GET", "/sb?versions")]
    vids = [e.text for e in tags(out[-1][2], "VersionId")]
    assert vids.count("null") == 1
    out.append(req(s, gw, "GET", "/sb/k"))
    assert out[-1][2] == b"null-era-2"
    old = [v for v in vids if v != "null"]
    assert len(old) == 1
    out.append(req(s, gw, "GET", f"/sb/k?versionId={old[0]}"))
    assert out[-1][2] == b"versioned-era"
    return out


def test_suspended_versioning_null_version(sides):
    run_both(sides, c_suspended_versioning_null_version, ["rgwv"])


def stamp(days_back: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                         time.gmtime(BASE_MS / 1000 - days_back * 86400))


def c_lifecycle_config_and_expiration(s):
    gw, g = s.gw("rgwv"), s.p.gateway
    lc = (b'<LifecycleConfiguration><Rule><ID>exp</ID>'
          b'<Prefix>logs/</Prefix><Status>Enabled</Status>'
          b'<Expiration><Days>7</Days></Expiration>'
          b'</Rule></LifecycleConfiguration>')
    out = [req(s, gw, "PUT", "/lcb"), req(s, gw, "PUT", "/lcb?lifecycle", lc),
           req(s, gw, "GET", "/lcb?lifecycle")]
    assert out[1][0] == 200
    assert b"<Days>7</Days>" in out[-1][2] and b"logs/" in out[-1][2]
    out += [req(s, gw, "PUT", "/lcb/logs/old.log", b"ancient"),
            req(s, gw, "PUT", "/lcb/logs/new.log", b"fresh"),
            req(s, gw, "PUT", "/lcb/data/keep.bin", b"outside prefix")]
    ent = gw._index_entry("lcb", "logs/old.log")
    ent["mtime"] = stamp(8)
    gw.io.set_omap(g._index_obj("lcb", g._shard_of(
        "logs/old.log", gw._nshards("lcb"))),
        {"logs/old.log": json.dumps(ent).encode()})
    out.append(gw.lc_tick(s.clock.time()))
    assert out[-1] == 1
    out += [req(s, gw, "GET", "/lcb/logs/old.log"),
            req(s, gw, "GET", "/lcb/logs/new.log"),
            req(s, gw, "GET", "/lcb/data/keep.bin")]
    assert out[-3][0] == 404 and out[-2][2] == b"fresh" and \
        out[-1][2] == b"outside prefix"
    out += [req(s, gw, "DELETE", "/lcb?lifecycle"),
            req(s, gw, "GET", "/lcb?lifecycle")]
    assert out[-2][0] == 204 and out[-1][0] == 404
    return out


def test_lifecycle_config_and_expiration(sides):
    run_both(sides, c_lifecycle_config_and_expiration, ["rgwv"])


def c_lifecycle_versioned_and_noncurrent(s):
    gw = s.gw("rgwv")
    lc = (b'<LifecycleConfiguration><Rule><ID>nc</ID>'
          b'<Prefix></Prefix><Status>Enabled</Status>'
          b'<Expiration><Days>10</Days></Expiration>'
          b'<NoncurrentVersionExpiration><NoncurrentDays>3'
          b'</NoncurrentDays></NoncurrentVersionExpiration>'
          b'</Rule></LifecycleConfiguration>')
    out = [req(s, gw, "PUT", "/lcv"),
           req(s, gw, "PUT", "/lcv?versioning", VERS_ON),
           req(s, gw, "PUT", "/lcv?lifecycle", lc),
           req(s, gw, "PUT", "/lcv/f", b"v1"), req(s, gw, "PUT", "/lcv/f",
                                                   b"v2")]
    ent = gw._index_entry("lcv", "f")
    for v in ent["versions"]:
        v["mtime"] = stamp(5)
    gw._store_versions("lcv", "f", ent["versions"])
    out.append(gw.lc_tick(s.clock.time()))
    assert out[-1] == 1
    out.append(req(s, gw, "GET", "/lcv?versions"))
    assert len(tags(out[-1][2], "Version")) == 1
    out.append(req(s, gw, "GET", "/lcv/f"))
    assert out[-1][2] == b"v2"
    ent = gw._index_entry("lcv", "f")
    for v in ent["versions"]:
        v["mtime"] = stamp(11)
    gw._store_versions("lcv", "f", ent["versions"])
    out.append(gw.lc_tick(s.clock.time()))
    assert out[-1] >= 1
    out += [req(s, gw, "GET", "/lcv/f"), req(s, gw, "GET", "/lcv?versions")]
    assert out[-2][0] == 404 and b"<DeleteMarker>" in out[-1][2]
    return out


def test_lifecycle_versioned_and_noncurrent(sides):
    run_both(sides, c_lifecycle_versioned_and_noncurrent, ["rgwv"])


def _signed(s, gw, method, path, data=b""):
    host = f"127.0.0.1:{gw.port}"
    hdrs = s.p.auth.sign_request(method, path, {"host": host}, data or b"",
                                 "client.s3", SECRETS["client.s3"])
    return req(s, gw, method, path, data, hdrs)


def c_presigned_url_get(s):
    gw = s.gateway("rgwsig", keyring=s.keyring("client.s3"))
    host, key = f"127.0.0.1:{gw.port}", SECRETS["client.s3"]
    presign = s.p.auth.presign
    out = [_signed(s, gw, "PUT", "/pre"),
           _signed(s, gw, "PUT", "/pre/obj", b"presigned payload"),
           req(s, gw, "GET", "/pre/obj")]
    assert [o[0] for o in out] == [200, 200, 403]
    url = presign("GET", "/pre/obj", host, "client.s3", key, expires=120)
    out.append(req(s, gw, "GET", url))
    assert out[-1][0] == 200 and out[-1][2] == b"presigned payload"
    out.append(req(s, gw, "GET", url[:-4] + "beef"))
    assert out[-1][0] == 403
    old = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() - 3600))
    out.append(req(s, gw, "GET", presign("GET", "/pre/obj", host,
                                         "client.s3", key, expires=60,
                                         amz_date=old)))
    assert out[-1][0] == 403
    out.append(req(s, gw, "PUT", presign("PUT", "/pre/up", host,
                                         "client.s3", key),
                   b"uploaded via presign"))
    assert out[-1][0] == 200
    out.append(req(s, gw, "GET", presign("GET", "/pre/up", host,
                                         "client.s3", key)))
    assert out[-1][2] == b"uploaded via presign"
    return out


def test_presigned_url_get(sides):
    run_both(sides, c_presigned_url_get, ["rgwsig"])
