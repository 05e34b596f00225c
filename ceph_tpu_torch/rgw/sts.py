"""STS: temporary credentials via role assumption.

The reference's Secure Token Service (ref: src/rgw/rgw_sts.cc
STSService::assumeRole; REST surface src/rgw/rgw_rest_sts.cc) in the
same shape:

* **Roles** are cluster-wide objects (omap of `.rgw.roles`): name +
  trust policy (which principals may assume) + max session duration
  (ref: src/rgw/rgw_role.cc RGWRole — the reference persists roles in
  RADOS the same way).  Admin API: `POST /?Action=CreateRole` /
  `DeleteRole` / `ListRoles`.
* **AssumeRole** (authenticated caller, `POST /?Action=AssumeRole
  &RoleArn=...&DurationSeconds=N`): the caller's identity is matched
  against the role's trust policy; on success a temporary credential
  triple is minted — AccessKeyId (STS-prefixed), SecretAccessKey,
  SessionToken — stored in RADOS (`.rgw.sts.creds`) with its expiry,
  so ANY gateway on the pool can validate it (the reference encrypts
  the session token with a cluster key for the same property).
* **Authentication**: SigV4 requests whose access key carries the STS
  prefix resolve their signing secret from the temp-cred table
  instead of the cephx keyring, require the matching
  `X-Amz-Security-Token` header, and die at expiry
  (ref: rgw_auth_s3.cc STSAuthStrategy).

The port's copy of `ceph_tpu.rgw.sts`; swallowed RadosErrors are
counted in `rgw.SWALLOWED`.
"""
from __future__ import annotations

import json
import secrets
import time

from ..client import RadosError
from . import swallow

ROLES_OBJ = ".rgw.roles"
CREDS_OBJ = ".rgw.sts.creds"
#: STS access keys are recognizable by prefix (the reference uses the
#: same trick to route auth to the STS engine)
AKID_PREFIX = "STS"
DEFAULT_DURATION_S = 3600
MAX_DURATION_S = 12 * 3600


class STSError(Exception):
    def __init__(self, status: int, code: str, msg: str = ""):
        self.status = status
        self.code = code
        self.msg = msg or code
        super().__init__(code)


class STSEngine:
    """Role store + temp-credential mint/validate on one pool."""

    def __init__(self, io):
        self.io = io

    # -- roles ---------------------------------------------------------
    def _ensure(self, obj: str) -> None:
        try:
            self.io.create(obj)
        except RadosError as e:
            swallow("sts_create", e)

    def create_role(self, name: str, trust_principals: list[str],
                    max_duration: int = MAX_DURATION_S) -> dict:
        if not name:
            raise STSError(400, "ValidationError", "RoleName")
        self._ensure(ROLES_OBJ)
        role = {"name": name, "trust": list(trust_principals),
                "max_duration": int(max_duration),
                "created": time.time()}
        self.io.set_omap(ROLES_OBJ, {name: json.dumps(role).encode()})
        return role

    def get_role(self, name: str) -> dict | None:
        try:
            vals = self.io.get_omap_vals_by_keys(ROLES_OBJ, [name])
        except RadosError:
            return None
        return json.loads(vals[name]) if name in vals else None

    def list_roles(self) -> dict[str, dict]:
        try:
            vals, _ = self.io.get_omap_vals(ROLES_OBJ)
        except RadosError:
            return {}
        return {k: json.loads(v) for k, v in vals.items()}

    def delete_role(self, name: str) -> None:
        try:
            self.io.remove_omap_keys(ROLES_OBJ, [name])
        except RadosError as e:
            swallow("role_delete", e)

    # -- assume / validate ---------------------------------------------
    def assume_role(self, caller: str, role_name: str,
                    duration_s: int | None = None) -> dict:
        """-> {access_key_id, secret_access_key, session_token,
        expiration}.  The caller must appear in the role's trust list
        ('*' = any authenticated principal), mirroring
        sts::AssumeRole's trust-policy evaluation."""
        role = self.get_role(role_name)
        if role is None:
            raise STSError(404, "NoSuchEntity", role_name)
        trust = role.get("trust", [])
        if "*" not in trust and caller not in trust:
            raise STSError(403, "AccessDenied",
                           f"{caller} not trusted by {role_name}")
        duration = int(duration_s or DEFAULT_DURATION_S)
        if duration <= 0 or duration > role.get("max_duration",
                                                MAX_DURATION_S):
            raise STSError(400, "ValidationError",
                           f"DurationSeconds {duration}")
        akid = AKID_PREFIX + secrets.token_hex(10).upper()
        secret = secrets.token_urlsafe(30)
        token = secrets.token_urlsafe(44)
        expires = time.time() + duration
        rec = {"secret": secret, "token": token, "expires": expires,
               "role": role_name, "caller": caller}
        self._ensure(CREDS_OBJ)
        self._sweep_expired()
        self.io.set_omap(CREDS_OBJ, {akid: json.dumps(rec).encode()})
        return {"access_key_id": akid, "secret_access_key": secret,
                "session_token": token,
                "expiration": expires, "role": role_name}

    def _sweep_expired(self) -> None:
        """Reap expired temp creds at mint time — the table must not
        grow one row per AssumeRole forever."""
        now = time.time()
        try:
            vals, _ = self.io.get_omap_vals(CREDS_OBJ)
            dead = [k for k, v in vals.items()
                    if json.loads(v).get("expires", 0) < now]
            if dead:
                self.io.remove_omap_keys(CREDS_OBJ, dead)
        except (RadosError, ValueError):
            pass

    def resolve_secret(self, akid: str, session_token: str) -> str:
        """SigV4 signing secret for an STS access key; raises on
        unknown/expired/token-mismatch (the reference's
        STSAuthStrategy token validation)."""
        try:
            vals = self.io.get_omap_vals_by_keys(CREDS_OBJ, [akid])
        except RadosError:
            raise STSError(403, "InvalidClientTokenId", akid)
        if akid not in vals:
            raise STSError(403, "InvalidClientTokenId", akid)
        rec = json.loads(vals[akid])
        if rec["expires"] < time.time():
            try:
                self.io.remove_omap_keys(CREDS_OBJ, [akid])
            except RadosError as e:
                swallow("sts_expired_remove", e)
            raise STSError(403, "ExpiredToken", akid)
        if rec["token"] != session_token:
            raise STSError(403, "InvalidToken", akid)
        return rec["secret"]

    def identity_of(self, akid: str) -> str | None:
        """The assumed-role identity string for an STS key (shows up
        as the request's acting principal)."""
        try:
            vals = self.io.get_omap_vals_by_keys(CREDS_OBJ, [akid])
        except RadosError:
            return None
        if akid not in vals:
            return None
        rec = json.loads(vals[akid])
        return f"arn:aws:sts:::assumed-role/{rec['role']}/" \
               f"{rec['caller']}"
