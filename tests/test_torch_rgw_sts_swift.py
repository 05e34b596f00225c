"""The port's STS and Swift frontends held to the reference's at
tolerance 0: every case of tests/test_rgw_sts.py and
tests/test_rgw_swift.py, run as tests/test_torch_rgw.py runs the gateway
cases (its `Side`, `run_both` and masks; the docstring there lists what
is seeded and what is masked).

STS credentials come from `secrets`, which each side draws from the
same seeded stream, so the minted access keys, secrets and session
tokens are compared byte for byte with everything else.  Where the
reference test sleeps past a credential's expiry, the case moves the
side's clock instead.  The Swift storage URL holds the gateway's port,
which is masked.
"""
import json
import re

from test_torch_rgw import SECRETS, req, run_both
from test_torch_rgw import sides  # noqa: F401  (the fixture)


# ------------------------------------------------------------ STS engine

def engine(s):
    try:
        s.r.pool_lookup("stseng")
    except Exception:
        s.r.pool_create("stseng", pg_num=8)
    return s.p.sts.STSEngine(s.r.open_ioctx("stseng"))


def attempt(s, fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except s.p.sts.STSError as e:
        return ("err", e.status, e.code, e.msg)


def c_role_crud_and_trust(s):
    e = engine(s)
    out = [e.create_role("reader", ["client.alice"]), e.get_role("reader"),
           sorted(e.list_roles())]
    assert out[1]["trust"] == ["client.alice"] and "reader" in out[2]
    out.append(attempt(s, e.assume_role, "client.alice", "reader"))
    assert out[-1][1]["access_key_id"].startswith("STS")
    assert out[-1][1]["expiration"] > s.clock.time()
    out += [attempt(s, e.assume_role, "client.mallory", "reader"),
            attempt(s, e.assume_role, "client.alice", "nope")]
    assert out[-2][2] == "AccessDenied" and out[-1][0] == "err"
    e.delete_role("reader")
    out.append(e.get_role("reader"))
    assert out[-1] is None
    return out


def test_role_crud_and_trust(sides):
    run_both(sides, c_role_crud_and_trust, ["stseng"])


def c_temp_cred_validation(s):
    e = engine(s)
    out = [e.create_role("any", ["*"], max_duration=7200),
           e.assume_role("client.bob", "any", duration_s=60)]
    akid = out[-1]["access_key_id"]
    out.append(e.resolve_secret(akid, out[1]["session_token"]))
    assert out[-1] == out[1]["secret_access_key"]
    out += [attempt(s, e.resolve_secret, akid, "wrong-token"),
            attempt(s, e.resolve_secret, "STSDEADBEEF",
                    out[1]["session_token"]),
            e.identity_of(akid),
            attempt(s, e.assume_role, "client.bob", "any", duration_s=8000)]
    assert out[3][2] == "InvalidToken" and out[4][0] == "err"
    assert "assumed-role/any/client.bob" in out[5] and out[6][0] == "err"
    return out


def test_temp_cred_validation(sides):
    run_both(sides, c_temp_cred_validation, ["stseng"])


def c_expiry_reaps(s):
    e = engine(s)
    out = [e.create_role("gone", ["*"]),
           e.assume_role("client.c", "gone", duration_s=1)]
    akid = out[-1]["access_key_id"]
    s.clock.advance(1.2)
    out.append(attempt(s, e.resolve_secret, akid, out[1]["session_token"]))
    assert out[-1][2] in ("ExpiredToken", "InvalidClientTokenId")
    out.append(e.assume_role("client.c", "gone"))
    vals, _ = e.io.get_omap_vals(".rgw.sts.creds")
    assert akid not in vals
    out.append(sorted(vals))
    return out


def test_expiry_reaps(sides):
    run_both(sides, c_expiry_reaps, ["stseng"])


# ------------------------------------------------------------ STS gateway

def _auth_gw(s, pool, entities):
    return s.gw(pool, keyring=s.keyring(*entities))


def _signed(s, gw, method, path, data=b"", entity="client.ops",
            secret=None, extra=None):
    host = f"127.0.0.1:{gw.port}"
    hdrs = dict(extra or {})
    hdrs.update(s.p.auth.sign_request(
        method, path, dict({"host": host}, **(extra or {})), data, entity,
        secret if secret is not None else SECRETS[entity]))
    return req(s, gw, method, path, data, hdrs)


def c_assume_role_and_use_temp_creds(s):
    gw = _auth_gw(s, "stsgw", ("client.ops", "client.outsider"))
    gw.sts.create_role("writer", ["client.ops"])
    out = [_signed(s, gw, "POST", "/?Action=AssumeRole&RoleArn=arn%3Aaws"
                   "%3Aiam%3A%3A%3Arole%2Fwriter&DurationSeconds=600")]
    assert out[-1][0] == 200
    body = out[-1][2]
    akid = re.search(rb"<AccessKeyId>([^<]+)", body).group(1).decode()
    secret = re.search(rb"<SecretAccessKey>([^<]+)", body).group(1).decode()
    token = re.search(rb"<SessionToken>([^<]+)", body).group(1).decode()
    assert akid.startswith("STS")
    tok = {"x-amz-security-token": token}
    out += [_signed(s, gw, "PUT", "/stsb", entity=akid, secret=secret,
                    extra=tok),
            _signed(s, gw, "PUT", "/stsb/obj", b"payload", entity=akid,
                    secret=secret, extra=tok),
            _signed(s, gw, "GET", "/stsb/obj", entity=akid, secret=secret,
                    extra=tok),
            _signed(s, gw, "GET", "/stsb/obj", entity=akid, secret=secret),
            _signed(s, gw, "GET", "/stsb/obj", entity=akid, secret=secret,
                    extra={"x-amz-security-token": "forged"})]
    assert [o[0] for o in out[1:]] == [200, 200, 200, 403, 403]
    assert out[3][2] == b"payload"
    return out


def test_assume_role_and_use_temp_creds(sides):
    run_both(sides, c_assume_role_and_use_temp_creds, ["stsgw"])


def c_untrusted_caller_cannot_assume(s):
    gw = _auth_gw(s, "stsgw", ("client.ops", "client.outsider"))
    gw.sts.create_role("locked", ["client.someoneelse"])
    out = [_signed(s, gw, "POST", "/?Action=AssumeRole&RoleArn=arn%3Aaws%3A"
                   "iam%3A%3A%3Arole%2Flocked", entity="client.outsider"),
           _signed(s, gw, "GET", "/?Action=ListRoles")]
    assert out[0][0] == 403 and out[1][0] == 200
    return out


def test_untrusted_caller_cannot_assume(sides):
    run_both(sides, c_untrusted_caller_cannot_assume, ["stsgw"])


# ------------------------------------------------------------ Swift

def _swift(s):
    return s.gw("swift")


def c_container_crud_and_listing(s):
    gw = _swift(s)
    out = [req(s, gw, "PUT", "/swift/v1/c1"),
           req(s, gw, "PUT", "/swift/v1/c1"),
           req(s, gw, "HEAD", "/swift/v1/c1"), req(s, gw, "GET", "/swift/v1"),
           req(s, gw, "GET", "/swift/v1?format=json"),
           req(s, gw, "DELETE", "/swift/v1/c1"),
           req(s, gw, "HEAD", "/swift/v1/c1")]
    assert [o[0] for o in out] == [201, 202, 204, 200, 200, 204, 404]
    assert out[2][1]["X-Container-Object-Count"] == "0"
    assert b"c1\n" in out[3][2]
    assert "c1" in [r["name"] for r in json.loads(out[4][2])]
    return out


def test_container_crud_and_listing(sides):
    run_both(sides, c_container_crud_and_listing, ["swift"])


def c_object_crud_headers_and_listing(s):
    gw = _swift(s)
    out = [req(s, gw, "PUT", "/swift/v1/c2"),
           req(s, gw, "PUT", "/swift/v1/c2/a/b.txt", b"hello"),
           req(s, gw, "GET", "/swift/v1/c2/a/b.txt"),
           req(s, gw, "HEAD", "/swift/v1/c2/a/b.txt")]
    assert out[1][0] == 201 and '"' not in out[1][1]["ETag"]
    assert out[2][2] == b"hello"
    assert out[2][1]["ETag"] == "5d41402abc4b2a76b9719d911017c592"
    assert out[3][0] == 200 and out[3][1]["Content-Length"] == "5" and \
        out[3][2] == b""
    out += [req(s, gw, "PUT", "/swift/v1/c2/a/c.txt", b"xx"),
            req(s, gw, "PUT", "/swift/v1/c2/z.txt", b"yy"),
            req(s, gw, "GET", "/swift/v1/c2?prefix=a/&format=json")]
    rows = json.loads(out[-1][2])
    assert [r["name"] for r in rows] == ["a/b.txt", "a/c.txt"]
    assert rows[0]["bytes"] == 5 and rows[0]["hash"]
    out.append(req(s, gw, "HEAD", "/swift/v1/c2"))
    assert out[-1][1]["X-Container-Object-Count"] == "3"
    assert out[-1][1]["X-Container-Bytes-Used"] == "9"
    out += [req(s, gw, "DELETE", "/swift/v1/c2"),
            req(s, gw, "DELETE", "/swift/v1/c2/a/b.txt"),
            req(s, gw, "GET", "/swift/v1/c2/a/b.txt")]
    assert [o[0] for o in out[-3:]] == [409, 204, 404]
    return out


def test_object_crud_headers_and_listing(sides):
    run_both(sides, c_object_crud_headers_and_listing, ["swift"])


def c_copy_from(s):
    gw = _swift(s)
    out = [req(s, gw, "PUT", "/swift/v1/c3"),
           req(s, gw, "PUT", "/swift/v1/c3/src", b"payload"),
           req(s, gw, "PUT", "/swift/v1/c3/dst", b"",
               {"X-Copy-From": "/c3/src"}),
           req(s, gw, "GET", "/swift/v1/c3/dst")]
    assert out[2][0] == 201 and out[3][2] == b"payload"
    return out


def test_copy_from(sides):
    run_both(sides, c_copy_from, ["swift"])


def c_s3_and_swift_share_namespace(s):
    gw = _swift(s)
    out = [req(s, gw, "PUT", "/xproto"),
           req(s, gw, "PUT", "/xproto/via-s3", b"one"),
           req(s, gw, "GET", "/swift/v1/xproto?format=json")]
    assert [r["name"] for r in json.loads(out[-1][2])] == ["via-s3"]
    out += [req(s, gw, "GET", "/swift/v1/xproto/via-s3"),
            req(s, gw, "PUT", "/swift/v1/xproto/via-swift", b"two"),
            req(s, gw, "GET", "/xproto"),
            req(s, gw, "GET", "/xproto/via-swift")]
    assert out[3][2] == b"one" and b"via-swift" in out[5][2] and \
        out[6][2] == b"two"
    return out


def test_s3_and_swift_share_namespace(sides):
    run_both(sides, c_s3_and_swift_share_namespace, ["swift"])


def c_tempauth_token_flow(s):
    gw = _auth_gw(s, "swiftauth", ("client.swift",))
    key = SECRETS["client.swift"]
    out = [req(s, gw, "GET", "/auth/v1.0",
               headers={"X-Auth-User": "client.swift",
                        "X-Auth-Key": "bogus"}),
           req(s, gw, "GET", "/auth/v1.0",
               headers={"X-Auth-User": "client.swift", "X-Auth-Key": key})]
    assert out[0][0] == 401 and out[1][0] == 204
    token = out[1][1]["X-Auth-Token"]
    assert out[1][1]["X-Storage-Url"].endswith("/swift/v1")
    tk = {"X-Auth-Token": token}
    out += [req(s, gw, "PUT", "/swift/v1/ac"),
            req(s, gw, "PUT", "/swift/v1/ac", headers=tk),
            req(s, gw, "PUT", "/swift/v1/ac/o", b"d", headers=tk),
            req(s, gw, "GET", "/swift/v1/ac/o", headers=tk)]
    assert [o[0] for o in out[2:]] == [401, 201, 201, 200]
    assert out[-1][2] == b"d"
    return out


def test_tempauth_token_flow(sides):
    run_both(sides, c_tempauth_token_flow, ["swiftauth"])


def c_token_valid_across_gateways(s):
    gw = _auth_gw(s, "swiftauth", ("client.swift",))
    out = [req(s, gw, "GET", "/auth/v1.0",
               headers={"X-Auth-User": "client.swift",
                        "X-Auth-Key": SECRETS["client.swift"]})]
    token = out[0][1]["X-Auth-Token"]
    g2 = s.gateway("swiftauth", keyring=s.keyring("client.swift"))
    try:
        out.append(req(s, g2, "PUT", "/swift/v1/xgw",
                       headers={"X-Auth-Token": token}))
        assert out[-1][0] == 201
    finally:
        g2.shutdown()
        s.gws.remove(g2)
    return out


def test_token_valid_across_gateways(sides):
    run_both(sides, c_token_valid_across_gateways, ["swiftauth"])


def c_reserved_key_namespace_guarded(s):
    gw = _swift(s)
    out = [req(s, gw, "PUT", "/swift/v1/resv")]
    for key in (".dlmeta", ".dl.0000000000000001", ".upload.x"):
        out += [req(s, gw, "PUT", f"/swift/v1/resv/{key}", b"z"),
                req(s, gw, "GET", f"/swift/v1/resv/{key}"),
                req(s, gw, "DELETE", f"/swift/v1/resv/{key}")]
        assert [o[0] for o in out[-3:]] == [400, 404, 400], key
    return out


def test_reserved_key_namespace_guarded(sides):
    run_both(sides, c_reserved_key_namespace_guarded, ["swift"])
