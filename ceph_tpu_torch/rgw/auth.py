"""AWS Signature Version 4 verification against the cephx keyring.

The reference authenticates S3 requests by recomputing the SigV4
signature from the stored secret key (ref: src/rgw/rgw_auth_s3.cc
AWSv4ComplMulti / rgw_auth_s3.h; algorithm per the public AWS SigV4
spec).  Here S3 access keys ARE cephx entities: access_key_id is the
entity name (e.g. "client.s3user"), the secret key is its keyring
secret — one credential store for the whole cluster, the way radosgw
users live in the cluster's auth database.

`KeystoneEngine` is the second, config-gated engine: OpenStack-token
validation against an external keystone endpoint (ref:
src/rgw/rgw_auth_keystone.cc TokenEngine) — a gateway constructed
with `keystone_url` accepts `X-Auth-Token` requests, everyone else
never takes the branch.

The port's copy of `ceph_tpu.rgw.auth`.
"""
from __future__ import annotations

import calendar as _calendar
import hashlib
import hmac
import json as _json
import time as _time
import urllib.error
import urllib.request
from urllib.parse import urlparse

from ..common.lockdep import make_lock

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED = "UNSIGNED-PAYLOAD"
#: accepted clock skew for x-amz-date (AWS uses 15 minutes); bounds
#: how long a captured signed request stays replayable
MAX_SKEW = 15 * 60.0


class SigV4Error(Exception):
    def __init__(self, code: str, msg: str = ""):
        self.code = code
        super().__init__(msg or code)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str,
                service: str = "s3") -> bytes:
    """AWS4 key derivation chain."""
    k = _hmac(f"AWS4{secret}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _parse_amz_date(s: str) -> float:
    """X-Amz-Date/x-amz-date -> epoch seconds; SigV4Error on junk."""
    try:
        # timegm, not mktime-timezone: the stamp is UTC, and mktime
        # applies DST — every signed request (including all peer sync
        # traffic) would be RequestTimeTooSkewed by 3600s for half
        # the year on a DST-observing host
        return float(_calendar.timegm(
            _time.strptime(s, "%Y%m%dT%H%M%SZ")))
    except ValueError:
        raise SigV4Error("AccessDenied", "malformed amz date")


def canonical_query(query: str) -> str:
    """Sort the wire query pairs.  The wire form is already
    percent-encoded by the client (and that exact form was signed), so
    pairs are sorted as-received — re-quoting would double-encode and
    break spec-compliant clients."""
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        if not part:
            continue
        if "=" not in part:
            part += "="
        pairs.append(tuple(part.split("=", 1)))
    return "&".join(f"{k}={v}" for k, v in sorted(pairs))


def parse_auth_header(value: str) -> dict:
    """'AWS4-HMAC-SHA256 Credential=..., SignedHeaders=..., Signature=...'"""
    if not value.startswith(ALGORITHM):
        raise SigV4Error("InvalidArgument", "unsupported auth scheme")
    out = {}
    for field in value[len(ALGORITHM):].split(","):
        field = field.strip()
        if "=" not in field:
            continue
        k, v = field.split("=", 1)
        out[k] = v
    for need in ("Credential", "SignedHeaders", "Signature"):
        if need not in out:
            raise SigV4Error("InvalidArgument", f"missing {need}")
    cred = out["Credential"].split("/")
    if len(cred) != 5 or cred[4] != "aws4_request":
        raise SigV4Error("InvalidArgument", "malformed credential")
    return {"access_key": cred[0], "date": cred[1], "region": cred[2],
            "service": cred[3],
            "signed_headers": out["SignedHeaders"].split(";"),
            "signature": out["Signature"]}


def verify(method: str, path: str, headers, body: bytes,
           lookup_secret) -> str:
    """Verify a SigV4-signed request; returns the authenticated entity
    or raises SigV4Error (ref: rgw_auth_s3.cc the same recompute-and-
    compare flow)."""
    auth_header = headers.get("Authorization")
    if not auth_header:
        raise SigV4Error("AccessDenied", "anonymous access disabled")
    a = parse_auth_header(auth_header)
    secret = lookup_secret(a["access_key"])
    if secret is None:
        raise SigV4Error("InvalidAccessKeyId", a["access_key"])
    # freshness: x-amz-date within the skew window and matching the
    # credential scope date — without this, one captured request is a
    # permanent bearer token (AWS enforces the same 15-minute window)
    amz_date_hdr = headers.get("x-amz-date", "")
    if not amz_date_hdr or amz_date_hdr[:8] != a["date"]:
        raise SigV4Error("AccessDenied", "x-amz-date/scope mismatch")
    when = _parse_amz_date(amz_date_hdr)
    if abs(_time.time() - when) > MAX_SKEW:
        raise SigV4Error("RequestTimeTooSkewed", amz_date_hdr)
    u = urlparse(path)
    canon_headers = ""
    for name in a["signed_headers"]:
        v = headers.get(name, "")
        canon_headers += f"{name}:{' '.join(v.split())}\n"
    payload_hash = headers.get("x-amz-content-sha256",
                               hashlib.sha256(body).hexdigest())
    if payload_hash == UNSIGNED:
        payload_part = UNSIGNED
    else:
        payload_part = hashlib.sha256(body).hexdigest()
        if payload_hash != payload_part:
            raise SigV4Error("XAmzContentSHA256Mismatch")
    canonical = "\n".join([
        method,
        u.path or "/",       # wire path is already percent-encoded;
        canonical_query(u.query),   # re-quoting would double-encode
        canon_headers,
        ";".join(a["signed_headers"]),
        payload_part,
    ])
    amz_date = headers.get("x-amz-date", "")
    scope = f"{a['date']}/{a['region']}/{a['service']}/aws4_request"
    sts = "\n".join([
        ALGORITHM, amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    key = signing_key(secret, a["date"], a["region"], a["service"])
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, a["signature"]):
        raise SigV4Error("SignatureDoesNotMatch")
    return a["access_key"]


def verify_presigned(method: str, path: str, headers,
                     lookup_secret) -> str:
    """Query-string SigV4 (presigned URL) verification (ref:
    src/rgw/rgw_auth_s3.h's query-string path; the AWS
    `X-Amz-Signature` scheme): the signature, credential scope and
    expiry all ride the query, the payload is UNSIGNED-PAYLOAD, and
    only the listed headers (normally just `host`) are signed."""
    u = urlparse(path)
    q: dict[str, str] = {}
    for part in u.query.split("&"):
        if "=" in part:
            k, v = part.split("=", 1)
            q[k] = v
    from urllib.parse import unquote
    if unquote(q.get("X-Amz-Algorithm", "")) != ALGORITHM:
        raise SigV4Error("InvalidArgument", "unsupported algorithm")
    cred = unquote(q.get("X-Amz-Credential", "")).split("/")
    if len(cred) != 5 or cred[4] != "aws4_request":
        raise SigV4Error("InvalidArgument", "malformed credential")
    access_key, date, region, service = cred[:4]
    secret = lookup_secret(access_key)
    if secret is None:
        raise SigV4Error("InvalidAccessKeyId", access_key)
    amz_date = unquote(q.get("X-Amz-Date", ""))
    if amz_date[:8] != date:
        raise SigV4Error("AccessDenied", "date/scope mismatch")
    when = _parse_amz_date(amz_date)
    try:
        expires = min(int(q.get("X-Amz-Expires", "300")), 7 * 86400)
    except ValueError:
        raise SigV4Error("AccessDenied", "malformed X-Amz-Expires")
    now = _time.time()
    if now > when + expires:
        raise SigV4Error("AccessDenied", "request has expired")
    if when > now + MAX_SKEW:
        raise SigV4Error("RequestTimeTooSkewed", amz_date)
    signed = unquote(q.get("X-Amz-SignedHeaders", "host")).split(";")
    canon_headers = ""
    for name in signed:
        v = headers.get(name, "")
        canon_headers += f"{name}:{' '.join(str(v).split())}\n"
    # canonical query: every pair as received EXCEPT the signature
    cq = canonical_query("&".join(
        part for part in u.query.split("&")
        if not part.startswith("X-Amz-Signature=")))
    canonical = "\n".join([method, u.path or "/", cq, canon_headers,
                           ";".join(signed), UNSIGNED])
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join([ALGORITHM, amz_date, scope,
                     hashlib.sha256(canonical.encode()).hexdigest()])
    key = signing_key(secret, date, region, service)
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, q.get("X-Amz-Signature", "")):
        raise SigV4Error("SignatureDoesNotMatch")
    return access_key


def presign(method: str, path: str, host: str, access_key: str,
            secret: str, expires: int = 300, region: str = "default",
            amz_date: str | None = None) -> str:
    """Generate a presigned URL path+query (the boto3
    generate_presigned_url analogue for tests and in-tree clients)."""
    from urllib.parse import quote
    amz_date = amz_date or _time.strftime("%Y%m%dT%H%M%SZ",
                                          _time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    params = {
        "X-Amz-Algorithm": ALGORITHM,
        "X-Amz-Credential": quote(f"{access_key}/{scope}", safe=""),
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    }
    pairs = sorted(params.items())
    cq = "&".join(f"{k}={v}" for k, v in pairs)
    canonical = "\n".join([method, path, cq, f"host:{host}\n", "host",
                           UNSIGNED])
    sts = "\n".join([ALGORITHM, amz_date, scope,
                     hashlib.sha256(canonical.encode()).hexdigest()])
    key = signing_key(secret, date, region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return f"{path}?{cq}&X-Amz-Signature={sig}"


def sign_request(method: str, path: str, headers: dict, body: bytes,
                 access_key: str, secret: str, region: str = "default",
                 amz_date: str | None = None) -> dict:
    """Client-side signer (tests + any in-tree S3 client): returns the
    headers to add (Authorization, x-amz-date, x-amz-content-sha256)."""
    import time as _time
    amz_date = amz_date or _time.strftime("%Y%m%dT%H%M%SZ",
                                          _time.gmtime())
    date = amz_date[:8]
    payload_hash = hashlib.sha256(body).hexdigest()
    headers = {k.lower(): v for k, v in headers.items()}
    headers.setdefault("x-amz-date", amz_date)
    headers["x-amz-content-sha256"] = payload_hash
    signed = sorted(set(headers) | {"x-amz-date",
                                    "x-amz-content-sha256"})
    u = urlparse(path)
    canon_headers = "".join(
        f"{n}:{' '.join(str(headers.get(n, '')).split())}\n"
        for n in signed)
    canonical = "\n".join([
        method, u.path or "/",     # caller passes the wire-encoded
        canonical_query(u.query),  # path; sign exactly what is sent
        canon_headers, ";".join(signed),
        payload_hash])
    scope = f"{date}/{region}/s3/aws4_request"
    sts = "\n".join([ALGORITHM, amz_date, scope,
                     hashlib.sha256(canonical.encode()).hexdigest()])
    key = signing_key(secret, date, region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    out = dict(headers)
    out["Authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return out


# -- keystone (ref: src/rgw/rgw_auth_keystone.cc TokenEngine) ----------

class KeystoneError(Exception):
    """Token rejection carrying the HTTP status + S3 error code the
    gateway should surface (401 InvalidToken for bad tokens, 403
    AccessDenied — the EACCES analogue — for expired ones, 503 when
    keystone itself is unreachable)."""

    def __init__(self, status: int, code: str, msg: str = ""):
        self.status = status
        self.code = code
        self.msg = msg or code
        super().__init__(self.msg)


def _keystone_expiry(raw) -> float | None:
    """expires_at -> epoch seconds.  The stub keystone in tests speaks
    epoch floats; real keystone speaks ISO8601 Z — accept both."""
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        pass
    try:
        iso = str(raw).rstrip("Z").split(".")[0]
        return float(_calendar.timegm(_time.strptime(
            iso, "%Y-%m-%dT%H:%M:%S")))
    except ValueError:
        raise KeystoneError(503, "ServiceUnavailable",
                            f"keystone sent unparsable expiry {raw!r}")


class KeystoneEngine:
    """Validate OpenStack tokens against a keystone endpoint.

    The reference asks keystone `GET /v3/auth/tokens` with the
    candidate in `X-Subject-Token` and caches accepted tokens
    (rgw_keystone_token_cache_size) so every S3 request does not pay a
    round trip; expiry is enforced locally on each use — a cached
    token that has since expired is EACCES, not a free pass.
    """

    #: accepted tokens are revalidated against keystone after this —
    #: the cache bounds latency, the expires_at bound stays exact
    CACHE_TTL_S = 10.0
    #: distinct tokens cached (ref: rgw_keystone_token_cache_size);
    #: short-lived per-session tokens would otherwise grow the dict
    #: for the gateway's lifetime
    CACHE_MAX = 1024

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        #: token -> (revalidate_after_monotonic, user, expires_epoch)
        self._cache: dict[str, tuple[float, str, float | None]] = {}
        self._lock = make_lock("rgw.keystone")

    def _check_expiry(self, expires: float | None,
                      token: str | None = None) -> None:
        if expires is not None and _time.time() >= expires:
            if token is not None:
                with self._lock:
                    self._cache.pop(token, None)    # dead weight: an
                    # expired token can never validate again
            raise KeystoneError(403, "AccessDenied",
                                "token expired (EACCES)")

    def validate(self, token: str) -> str:
        """-> the token's user name, or KeystoneError."""
        if not token:
            raise KeystoneError(401, "InvalidToken",
                                "missing X-Auth-Token")
        now = _time.monotonic()
        with self._lock:
            hit = self._cache.get(token)
        if hit and now < hit[0]:
            self._check_expiry(hit[2], token)
            return hit[1]
        req = urllib.request.Request(
            f"{self.url}/v3/auth/tokens", method="GET",
            headers={"X-Subject-Token": token})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout) as resp:
                body = _json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            if e.code in (401, 404):
                raise KeystoneError(401, "InvalidToken",
                                    "keystone rejected the token")
            raise KeystoneError(503, "ServiceUnavailable",
                                f"keystone answered {e.code}")
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise KeystoneError(503, "ServiceUnavailable",
                                f"keystone unreachable: {e}")
        except ValueError:
            raise KeystoneError(503, "ServiceUnavailable",
                                "keystone sent bad JSON")
        tok = body.get("token") or {}
        user = (tok.get("user") or {}).get("name") or ""
        if not user:
            raise KeystoneError(401, "InvalidToken",
                                "token has no user")
        expires = _keystone_expiry(tok.get("expires_at"))
        self._check_expiry(expires)
        wall = _time.time()
        with self._lock:
            if len(self._cache) >= self.CACHE_MAX:
                # reap expired + revalidation-stale entries first;
                # fall back to dropping the oldest insertion
                self._cache = {
                    t: v for t, v in self._cache.items()
                    if now < v[0] and
                    (v[2] is None or wall < v[2])}
                while len(self._cache) >= self.CACHE_MAX:
                    self._cache.pop(next(iter(self._cache)))
            self._cache[token] = (now + self.CACHE_TTL_S, user,
                                  expires)
        return user
