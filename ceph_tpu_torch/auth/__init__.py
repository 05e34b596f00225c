"""cephx-lite: shared-secret authentication with session tickets.

The reference's cephx (ref: src/auth/cephx/CephxProtocol.{h,cc}) in
reduced form, keeping the protocol shape:

* a **KeyRing** holds per-entity secrets; the mon holds everyone's
  (ref: src/auth/KeyRing.cc, mon AuthMonitor's key server);
* a client proves identity with an HMAC over a fresh nonce + server
  challenge (ref: CephxAuthorizer's challenge round-trip), and both
  sides DERIVE the session key from (entity secret, nonce, challenge)
  — it never crosses the wire, mirroring how cephx wraps the session
  key under the entity secret;
* the mon answers with a **ticket**: the session key + entity +
  expiry, sealed under the *service secret* every daemon shares
  (ref: service ticket encrypted with the service's rotating key) —
  daemons can open it; clients cannot forge it;
* afterwards every message carries `auth = (ticket, sig)` where sig
  is an HMAC under the session key over the message header AND
  payload fields, the msgr-v2 message-signing analogue
  (ref: CEPHX_REQUIRE_SIGNATURES / ProtocolV2 auth signatures): a
  captured ticket cannot be replayed onto a forged op.

Sealing is authenticate-only (HMAC tag, no confidentiality): the
threat model this layer exists to test is impersonation and
unauthorized cluster access, not wire snooping; swap `_seal/_open`
for AES-GCM to get the rest.

Modes (ref: auth_cluster_required option): "none" (default) or
"cephx".

The port's copy of `ceph_tpu.auth`, whole: a keyring file, a ticket, a
signature and a handshake made by either package verify in the other.
The port's `CephxVerifier` also counts the signatures it checked
(`verified`, `rejected`).
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import json
import os
import time

from ..common.log import dout
from ..common.lockdep import make_lock
from ..msg.messages import MAuthReply, MAuthRequest

SERVICE_ENTITY = "service"           # the shared service-secret slot

#: daemon-class entity prefixes (everything else is a client).  The
#: class rides inside the sealed ticket, so a client cannot upgrade
#: itself (ref: cephx caps — "allow *" for daemons vs client caps).
DAEMON_PREFIXES = frozenset({"osd", "mon", "mds", "mgr", SERVICE_ENTITY})

#: message types a *client*-class ticket may send to daemons
#: (ref: the effect of default client caps: client ops + mon
#: subscriptions/commands + mds requests + cap-release acks, which
#: travel client->mds as MClientCaps; daemon-internal traffic like
#: RepOpWrite/ECSubWrite/MMap/MOSDFailure is daemon-only)
CLIENT_ALLOWED = frozenset({
    "OSDOp", "MMonSubscribe", "MMonCommand", "MClientRequest",
    "MClientCaps"})

#: replay-window size: how far behind the highest-seen signing seq a
#: message may arrive before it is considered stale (tolerates
#: multi-connection reordering; ref: cephx challenge freshness)
REPLAY_WINDOW = 1024

#: renew this long before ticket expiry (ref: MonClient's
#: _check_auth_rotating renews before ttl runs out)
RENEW_MARGIN = 60.0


def entity_class(entity: str) -> str:
    return ("daemon" if entity.split(".", 1)[0] in DAEMON_PREFIXES
            else "client")


def generate_key() -> str:
    return os.urandom(16).hex()


def _mac(secret: str, blob: bytes) -> str:
    return _hmac.new(secret.encode(), blob,
                     hashlib.sha256).hexdigest()


class KeyRing:
    """entity -> secret (ref: src/auth/KeyRing.h).  JSON file format:
    {"osd.0": "<hex>", ...}."""

    def __init__(self, keys: dict[str, str] | None = None):
        self.keys: dict[str, str] = dict(keys or {})

    @classmethod
    def generate(cls, entities) -> "KeyRing":
        kr = cls({SERVICE_ENTITY: generate_key()})
        for e in entities:
            kr.keys[e] = generate_key()
        return kr

    @classmethod
    def load(cls, path: str) -> "KeyRing":
        with open(path) as f:
            return cls(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.keys, f, indent=1)

    def get(self, entity: str) -> str | None:
        return self.keys.get(entity)

    def subset(self, *entities: str) -> "KeyRing":
        """A daemon's keyring: its own key + the service secret."""
        return KeyRing({e: self.keys[e] for e in
                        (*entities, SERVICE_ENTITY) if e in self.keys})


def attach_cephx(ms, entity: str, keyring: "KeyRing",
                 verifier: bool = True) -> None:
    """Wire a messenger for cephx: self-minted signer (daemons hold
    the service secret — the reference's rotating service keys) plus,
    for daemon endpoints, an inbound verifier.  `verifier=False` is
    for a daemon's embedded *client* messenger (e.g. the MDS's RADOS
    client), which signs as the daemon but must not gate inbound
    replies.  One place for the gate so mon/OSD/MDS cannot drift, and
    a keyring missing the service secret fails loud here instead of
    deep inside _mac."""
    svc = keyring.get(SERVICE_ENTITY)
    if svc is None:
        raise ValueError(
            f"cephx for {entity}: keyring has no service secret")
    ms.auth_signer = CephxClient.self_mint(entity, svc)
    if verifier:
        ms.auth_verifier = CephxVerifier(svc)


def _derive_session_key(secret: str, nonce: str, challenge: str) -> str:
    return _mac(secret, f"session|{nonce}|{challenge}".encode())


def _seal(secret: str, payload: dict) -> dict:
    blob = json.dumps(payload, sort_keys=True)
    return {"blob": blob, "tag": _mac(secret, blob.encode())}


def _open(secret: str, sealed: dict) -> dict | None:
    if not isinstance(sealed, dict) or "blob" not in sealed:
        return None
    if not _hmac.compare_digest(
            _mac(secret, sealed["blob"].encode()),
            sealed.get("tag", "")):
        return None
    return json.loads(sealed["blob"])


def _canon(msg) -> bytes:
    """Byte-stable digest input covering header AND payload: a
    captured ticket must not be reattachable to a forged op (the TCP
    transport is reachable by unauthenticated processes).  Uses the
    typed wire codec — deterministic for our payload domain, and dict
    insertion order survives the decode, so receiver-side
    re-canonicalization matches what was signed."""
    import dataclasses

    from ..msg import encoding as wire
    fields = tuple((f.name, getattr(msg, f.name))
                   for f in dataclasses.fields(msg)
                   if f.name != "auth")
    return wire.encode((msg.type_name, fields))


class CephxServer:
    """Mon-side authenticator (ref: CephxServiceHandler +
    AuthMonitor's key server)."""

    def __init__(self, keyring: KeyRing,
                 ticket_ttl: float = 3600.0):
        self.keyring = keyring
        self.ttl = ticket_ttl

    def handle_request(self, msg: MAuthRequest) -> MAuthReply:
        secret = self.keyring.get(msg.entity)
        challenge = os.urandom(8).hex()
        if secret is None:
            return MAuthReply(result=-1, errstr="unknown entity")
        want = _mac(secret, f"auth|{msg.entity}|{msg.nonce}".encode())
        if not _hmac.compare_digest(want, msg.sig):
            dout("auth", 1).write("cephx: bad signature from %s",
                                  msg.entity)
            return MAuthReply(result=-13, errstr="bad signature")
        # fresh challenge binds the session key to this exchange
        session_key = _derive_session_key(secret, msg.nonce, challenge)
        expires = time.time() + self.ttl
        ticket = _seal(self.keyring.get(SERVICE_ENTITY), {
            "entity": msg.entity, "session_key": session_key,
            "cls": entity_class(msg.entity), "expires": expires})
        return MAuthReply(result=0, challenge=challenge,
                          ticket=ticket, expires=expires)


class CephxClient:
    """Per-daemon/client signer (ref: CephxClientHandler)."""

    def __init__(self, entity: str, secret: str):
        import itertools
        self.entity = entity
        self.secret = secret
        self.nonce = os.urandom(8).hex()
        self.session_key: str | None = None
        self.ticket: dict | None = None
        self.expires: float = 0.0
        #: guards the (session_key, ticket) pair: renewal replies land
        #: while other threads sign, and a MAC under the new key paired
        #: with the old ticket would be dropped by every verifier
        self._lock = make_lock(f"auth.cephx.{entity}")
        #: monotonic signing sequence — receivers use it for replay
        #: freshness (itertools.count is atomic under the GIL)
        self._seq = itertools.count(1)
        #: self_mint daemons keep the service secret to re-mint locally
        self._mint_secret: str | None = None
        self._mint_ttl: float = 0.0
        self._renew_sent: float = 0.0
        #: wire-handshake renewal: the channel owner (Objecter) sets
        #: this to a callable that re-sends the MAuthRequest; sign()
        #: fires it (throttled, off-thread) so EVERY traffic pattern —
        #: data ops, mds sessions, mon commands — renews, not just
        #: Objecter.operate()
        self.renew_hook = None

    def build_request(self) -> MAuthRequest:
        self.nonce = os.urandom(8).hex()
        return MAuthRequest(
            entity=self.entity, nonce=self.nonce,
            sig=_mac(self.secret,
                     f"auth|{self.entity}|{self.nonce}".encode()))

    def ingest_reply(self, msg: MAuthReply) -> bool:
        if msg.result != 0:
            return False
        key = _derive_session_key(self.secret, self.nonce,
                                  msg.challenge)
        with self._lock:          # atomic (key, ticket, expiry) swap
            self.session_key = key
            self.ticket = msg.ticket
            self.expires = msg.expires
        return True

    @property
    def authenticated(self) -> bool:
        return self.session_key is not None

    @property
    def needs_renewal(self) -> bool:
        """True inside the renewal margin.  Callers owning a wire
        channel re-run the MAuthRequest handshake; self-minted daemons
        renew transparently in sign()."""
        return (self.session_key is not None and self.expires > 0 and
                time.time() > self.expires - RENEW_MARGIN)

    def should_send_renewal(self, throttle: float = 5.0) -> bool:
        """Rate-limited renewal trigger for wire-handshake clients."""
        if self._mint_secret is not None or not self.needs_renewal:
            return False
        with self._lock:
            now = time.time()
            if now - self._renew_sent < throttle:
                return False
            self._renew_sent = now
        return True

    @classmethod
    def self_mint(cls, entity: str,
                  service_secret: str,
                  ttl: float = 365 * 86400.0) -> "CephxClient":
        """Daemon-side shortcut: an entity that HOLDS the service
        secret (mon/osd/mds — the reference distributes rotating
        service keys to daemons) mints its own ticket locally instead
        of doing the wire handshake."""
        c = cls(entity, service_secret)
        c._mint_secret = service_secret
        c._mint_ttl = ttl
        c._remint()
        return c

    def _remint(self) -> None:
        key = generate_key()
        expires = time.time() + self._mint_ttl
        ticket = _seal(self._mint_secret, {
            "entity": self.entity, "session_key": key,
            "cls": entity_class(self.entity), "expires": expires})
        with self._lock:
            self.session_key = key
            self.expires = expires
            self.ticket = ticket

    def sign(self, msg):
        """Attach (ticket, seq, sig) to an outgoing message copy.  The
        seq is covered by the MAC, so a captured message cannot be
        replayed past the verifier's freshness window."""
        if self.session_key is None:
            return msg
        if self._mint_secret is not None and self.needs_renewal:
            self._remint()       # local renewal: we hold the secret
        elif self.renew_hook is not None and self.should_send_renewal():
            # off-thread: sign() runs under transport locks, and the
            # hook re-enters the messenger to send the MAuthRequest
            import threading
            threading.Thread(target=self.renew_hook,
                             daemon=True).start()
        seq = next(self._seq)
        with self._lock:          # key+ticket must be the same session
            key, ticket = self.session_key, self.ticket
        msg.auth = {"ticket": ticket, "seq": seq,
                    "sig": _mac(key, _canon(msg) + b"|seq=%d" % seq)}
        return msg


class CephxVerifier:
    """Service-side message gate (ref: the require-signatures check in
    Protocol/ms_verify_authorizer)."""

    #: always-allowed types: the auth handshake itself, plus replies
    #: going TO clients (verified by them only if they hold keys)
    EXEMPT = {"MAuthRequest", "MAuthReply"}

    def __init__(self, service_secret: str):
        self.service_secret = service_secret
        self._lock = make_lock("auth.cephx_verifier")
        #: (entity, ticket_tag) -> (max_seq, seen-set) replay state;
        #: keyed per session so a restarted entity gets a fresh window
        self._sessions: "dict[tuple, tuple[int, set]]" = {}
        #: messages this verifier passed and refused (exempt types are
        #: neither)
        self.verified = 0
        self.rejected = 0

    def verify(self, msg) -> bool:
        if msg.type_name in self.EXEMPT:
            return True
        ok = self._verify(msg)
        with self._lock:
            if ok:
                self.verified += 1
            else:
                self.rejected += 1
        return ok

    def _verify(self, msg) -> bool:
        auth = getattr(msg, "auth", None)
        if not auth:
            return False
        ticket = _open(self.service_secret, auth.get("ticket"))
        if ticket is None or ticket["expires"] < time.time():
            return False
        # entity-class gate: a client-class ticket cannot send
        # daemon-internal traffic (RepOpWrite/ECSubWrite/MMap/
        # MOSDFailure/paxos...) even with a valid signature
        if ticket.get("cls", "client") == "client":
            if msg.type_name not in CLIENT_ALLOWED:
                dout("auth", 1).write(
                    "cephx: client-class %s may not send %s",
                    ticket.get("entity"), msg.type_name)
                return False
            # identity binding: a client ticket speaks only for its own
            # entity — services authorize state changes (cap releases,
            # ops) by msg.src, and src is MAC-covered, so without this
            # check any authenticated client could stamp another
            # client's name and e.g. forge its MClientCaps release.
            # Daemon-class is exempt: every service-secret holder can
            # mint any daemon ticket anyway (and the MDS's embedded
            # RADOS client legitimately signs as its daemon identity).
            if ticket.get("entity") != getattr(msg, "src", None):
                dout("auth", 1).write(
                    "cephx: ticket for %s on message from %s",
                    ticket.get("entity"), getattr(msg, "src", None))
                return False
        seq = auth.get("seq", 0)
        want = _mac(ticket["session_key"],
                    _canon(msg) + b"|seq=%d" % seq)
        if not _hmac.compare_digest(want, auth.get("sig", "")):
            return False
        return self._check_fresh(ticket, auth.get("ticket"), seq)

    def _check_fresh(self, ticket: dict, sealed: dict, seq: int) -> bool:
        """Per-(entity, session) replay window: each signing seq is
        accepted once; anything at or below max_seen - REPLAY_WINDOW is
        stale.  Tolerates reordering inside the window."""
        key = (ticket.get("entity"), (sealed or {}).get("tag"))
        with self._lock:
            entry = self._sessions.pop(key, None)  # re-insert = LRU
            max_seq, seen = entry if entry is not None else (0, set())
            floor = max(0, max(max_seq, seq) - REPLAY_WINDOW)
            if seq <= floor or seq in seen:
                self._sessions[key] = (max_seq, seen)
                dout("auth", 1).write("cephx: replayed/stale seq %d "
                                      "from %s", seq, key[0])
                return False
            seen.add(seq)
            if len(seen) > 2 * REPLAY_WINDOW:   # prune below the floor
                seen = {s for s in seen if s > floor}
            if len(self._sessions) >= 4096:
                # evict least-recently-used sessions (dict order is
                # re-insertion order, so the front IS the LRU end);
                # active daemon sessions stay hot and keep their
                # replay windows — only dead/stale peers age out
                for k in list(self._sessions)[:256]:
                    del self._sessions[k]
            self._sessions[key] = (max(max_seq, seq), seen)
        return True
