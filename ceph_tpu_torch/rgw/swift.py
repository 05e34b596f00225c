"""Swift REST frontend over the same buckets as S3.

The reference serves the Swift API from the same radosgw process and
bucket namespace as S3 (ref: src/rgw/rgw_rest_swift.cc;
src/rgw/rgw_swift_auth.cc TempAuth) — a container IS a bucket, an
object IS an S3 object, and both protocols read each other's writes.
Same here:

* **TempAuth**: `GET /auth/v1.0` with `X-Auth-User` (a cephx entity,
  e.g. `client.s3`) + `X-Auth-Key` (its base64 secret) returns
  `X-Auth-Token` + `X-Storage-Url`.  Tokens live in a RADOS omap
  object, so ANY gateway on the pool validates a token issued by
  another (the reference keeps tokens cluster-visible the same way).
  Anonymous gateways (no keyring) skip auth entirely — test mode,
  matching the S3 side.
* **Account**: `GET /swift/v1` lists containers (text or
  `?format=json` with count/bytes), `HEAD` returns
  `X-Account-Container-Count`.
* **Container**: PUT=201 create (idempotent 202), DELETE=204 (409
  when non-empty), HEAD=204 with `X-Container-Object-Count` /
  `X-Container-Bytes-Used`, GET lists objects (prefix/marker/limit;
  text or JSON with name/bytes/hash/last_modified).
* **Object**: PUT=201 (ETag unquoted — Swift style), GET/HEAD with
  ETag/Content-Length/Last-Modified, DELETE=204, and server-side
  copy via `X-Copy-From` on PUT.  Writes run through the gateway's
  `_store_object`, so cls index transactions, versioning state, and
  bucket notifications all apply to Swift traffic too.

The port's copy of `ceph_tpu.rgw.swift`; swallowed RadosErrors are
counted in `rgw.SWALLOWED`.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import uuid

from ..client import RadosError
from . import swallow

#: cluster-visible token table (token -> {user, expires})
TOKENS_OBJ = ".rgw.swift.tokens"
TOKEN_TTL_S = 3600.0


class SwiftError(Exception):
    def __init__(self, status: int, msg: str = ""):
        self.status = status
        self.msg = msg
        super().__init__(msg or str(status))


def _json_or_text(q, rows, text_key):
    """Swift listings: newline-separated names by default, full
    records with ?format=json.  -> (body, content-type, status):
    json is ALWAYS 200 (an empty list has the body '[]' — a 204 with
    a body corrupts HTTP/1.1 keep-alive); only the empty TEXT listing
    is Swift's bodyless 204."""
    if q.get("format") == "json":
        return (json.dumps(rows).encode(), "application/json", 200)
    body = ("".join(r[text_key] + "\n" for r in rows)).encode()
    return (body, "text/plain", 200 if rows else 204)


class SwiftFrontend:
    """Routes /auth/v1.0 and /swift/v1/** against an RGWGateway."""

    def __init__(self, gw):
        self.gw = gw

    # -- TempAuth ------------------------------------------------------
    def _issue_token(self, user: str) -> str:
        token = "AUTH_tk" + uuid.uuid4().hex
        rec = json.dumps({"user": user,
                          "expires": time.time() + TOKEN_TTL_S})
        try:
            self.gw.io.create(TOKENS_OBJ)
        except RadosError as e:
            swallow("swift_tokens_create", e)
        self._sweep_expired()
        self.gw.io.set_omap(TOKENS_OBJ, {token: rec.encode()})
        return token

    def _sweep_expired(self) -> None:
        """Reap every expired token at issue time — without this the
        table grows one row per auth call forever (a client that
        re-auths per request never presents its old tokens again)."""
        now = time.time()
        try:
            vals, _ = self.gw.io.get_omap_vals(TOKENS_OBJ)
            dead = [t for t, rec in vals.items()
                    if json.loads(rec).get("expires", 0) < now]
            if dead:
                self.gw.io.remove_omap_keys(TOKENS_OBJ, dead)
        except (RadosError, ValueError):
            pass

    def _check_token(self, h) -> str:
        """-> authenticated entity name; raises 401.  No keyring =
        anonymous gateway (same contract as the S3 side)."""
        if self.gw.keyring is None:
            return "anonymous"
        token = h.headers.get("X-Auth-Token", "")
        if not token:
            raise SwiftError(401, "missing X-Auth-Token")
        try:
            vals = self.gw.io.get_omap_vals_by_keys(TOKENS_OBJ,
                                                    [token])
        except RadosError:
            raise SwiftError(401, "bad token")
        if token not in vals:
            raise SwiftError(401, "bad token")
        rec = json.loads(vals[token])
        if rec["expires"] < time.time():
            try:
                self.gw.io.remove_omap_keys(TOKENS_OBJ, [token])
            except RadosError as e:
                swallow("swift_expired_remove", e)
            raise SwiftError(401, "token expired")
        return rec["user"]

    def handle_auth(self, h) -> None:
        """GET /auth/v1.0 (ref: rgw_swift_auth.cc RGW_SWIFT_Auth_Get).
        X-Auth-User carries the cephx entity; X-Auth-Key its base64
        secret, compared constant-time."""
        user = h.headers.get("X-Auth-User", "")
        key = h.headers.get("X-Auth-Key", "")
        if self.gw.keyring is not None:
            secret = self.gw.keyring.get(user)
            if secret is None:
                raise SwiftError(401, "no such user")
            want = secret if isinstance(secret, str) \
                else base64.b64encode(secret).decode()
            if not hmac.compare_digest(want, key):
                raise SwiftError(401, "bad key")
        token = self._issue_token(user or "anonymous")
        self.gw._respond(h, 204, b"", "text/plain", {
            "X-Auth-Token": token,
            "X-Storage-Token": token,
            "X-Storage-Url":
                f"http://127.0.0.1:{self.gw.port}/swift/v1"})

    # -- routing -------------------------------------------------------
    def route(self, h, method: str, path: str, q: dict) -> None:
        """Dispatch /swift/v1[/container[/object]]."""
        self._check_token(h)
        rest = path[len("/swift/v1"):].lstrip("/")
        if not rest:
            return self._account_op(h, method, q)
        parts = rest.split("/", 1)
        container = parts[0]
        obj = parts[1] if len(parts) > 1 else ""
        if not obj:
            return self._container_op(h, method, container, q)
        return self._object_op(h, method, container, obj, q)

    # -- account -------------------------------------------------------
    def _account_op(self, h, method: str, q: dict) -> None:
        buckets = self.gw._buckets()
        if method == "HEAD":
            return self.gw._respond(h, 204, b"", "text/plain", {
                "X-Account-Container-Count": str(len(buckets))})
        if method != "GET":
            raise SwiftError(405)
        rows = []
        for name in sorted(buckets):
            # same visibility filter as the container stats: live
            # heads only (no upload bookkeeping, no dm-headed keys)
            idx = {k: v for k, v in self.gw._index(name).items()
                   if not k.startswith(".upload.")
                   and not v.get("dm")}
            rows.append({"name": name, "count": len(idx),
                         "bytes": sum(e.get("size", 0)
                                      for e in idx.values())})
        body, ctype, status = _json_or_text(q, rows, "name")
        self.gw._respond(h, status, body, ctype)

    # -- container -----------------------------------------------------
    def _container_op(self, h, method: str, container: str,
                      q: dict) -> None:
        gw = self.gw
        buckets = gw._buckets()
        if method == "PUT":
            # 201 created / 202 already-there (Swift semantics)
            created = gw._create_bucket(container)
            return gw._respond(h, 201 if created else 202, b"",
                               "text/plain")
        if container not in buckets:
            raise SwiftError(404, container)
        idx = {k: v for k, v in gw._index(container).items()
               if not k.startswith(".upload.") and not v.get("dm")}
        if method == "HEAD":
            return gw._respond(h, 204, b"", "text/plain", {
                "X-Container-Object-Count": str(len(idx)),
                "X-Container-Bytes-Used":
                    str(sum(e.get("size", 0) for e in idx.values()))})
        if method == "DELETE":
            # emptiness judged on the UNFILTERED index (exactly the
            # S3 check): dm-headed version stacks and in-flight
            # multipart uploads still own data objects — dropping the
            # shards would orphan them
            if gw._index(container):
                raise SwiftError(409, "container not empty")
            gw._delete_bucket(container)
            return gw._respond(h, 204, b"", "text/plain")
        if method != "GET":
            raise SwiftError(405)
        prefix = q.get("prefix", "")
        marker = q.get("marker", "")
        try:
            limit = int(q.get("limit", 10000))
        except ValueError:
            raise SwiftError(412, "bad limit")
        keys = sorted(k for k in idx
                      if k.startswith(prefix) and k > marker)[:limit]
        rows = [{"name": k, "bytes": idx[k].get("size", 0),
                 "hash": idx[k].get("etag", ""),
                 "last_modified": idx[k].get("mtime", "")}
                for k in keys]
        body, ctype, status = _json_or_text(q, rows, "name")
        gw._respond(h, status, body, ctype)

    # -- object --------------------------------------------------------
    def _object_op(self, h, method: str, container: str, obj: str,
                   q: dict) -> None:
        gw = self.gw
        from .gateway import S3Error
        if obj.startswith(gw.RESERVED_KEY_PREFIXES):
            # same guard as the S3 path: these names are index
            # bookkeeping, not objects (a PUT named .dlmeta wedges
            # the shard's datalog head; reads crash on the record's
            # missing etag/size)
            raise SwiftError(400 if method in ("PUT", "POST", "DELETE")
                             else 404, obj)
        bmeta = gw._buckets().get(container)
        if bmeta is None:
            raise SwiftError(404, container)
        if method == "PUT":
            src = h.headers.get("X-Copy-From", "")
            if src:
                s_cont, _, s_obj = src.lstrip("/").partition("/")
                data = self._read_object(s_cont, s_obj)
            else:
                data = gw._read_body(h)
            etag = hashlib.md5(data).hexdigest()
            vid = gw._store_object(container, obj, data, etag, bmeta)
            gw._notify_event(container, obj, "s3:ObjectCreated:Put",
                             len(data), etag, vid, bmeta)
            return gw._respond(h, 201, b"", "text/plain",
                               {"ETag": etag})
        ent = gw._index_entry(container, obj,
                              int(bmeta.get("shards", 1)))
        if ent is None:
            raise SwiftError(404, obj)
        if method in ("GET", "HEAD"):
            try:
                if method == "HEAD":
                    v, data = gw._select_version(ent, "", obj), None
                else:
                    v, data = gw._read_version_data(container, obj,
                                                    ent, "")
            except S3Error:
                raise SwiftError(404, obj)
            hdrs = {"ETag": v.get("etag", ""),
                    "X-Timestamp":
                        str(gw._parse_mtime(v.get("mtime", ""))),
                    "Last-Modified": v.get("mtime", "")}
            if method == "HEAD":
                hdrs["Content-Length"] = str(v.get("size", 0))
                return gw._respond(h, 200, b"",
                                   "application/octet-stream", hdrs)
            return gw._respond(h, 200, data,
                               "application/octet-stream", hdrs)
        if method == "DELETE":
            try:
                gw._select_version(ent, "", obj)
            except S3Error:
                # already deleted (dm head): Swift answers 404,
                # never stacks a second marker
                raise SwiftError(404, obj)
            # route through the S3 delete path: versioning semantics,
            # cls transaction, notification — then Swift's 204
            gw._delete_object(_NullResponder(), container, obj,
                              bmeta, ent, "")
            return gw._respond(h, 204, b"", "text/plain")
        raise SwiftError(405)

    def _read_object(self, container: str, obj: str) -> bytes:
        from .gateway import S3Error
        gw = self.gw
        if obj.startswith(gw.RESERVED_KEY_PREFIXES):
            raise SwiftError(404, f"{container}/{obj}")
        if container not in gw._buckets():
            raise SwiftError(404, container)
        ent = gw._index_entry(container, obj)
        if ent is None:
            raise SwiftError(404, f"{container}/{obj}")
        try:
            return gw._read_version_data(container, obj, ent, "")[1]
        except S3Error:
            raise SwiftError(404, obj)


class _NullResponder:
    """Absorbs the S3-shaped response of a reused handler so the
    Swift layer can send its own status/headers."""

    command = "NULL"

    class _Sink:
        @staticmethod
        def write(_data):
            pass

    wfile = _Sink()

    def send_response(self, *a):
        pass

    def send_header(self, *a):
        pass

    def end_headers(self):
        pass
