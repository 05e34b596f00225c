"""Secure wire mode: authenticated encryption for TCP frames.

The msgr-v2 secure-mode analogue (ref: src/msg/async/crypto_onwire.cc
— AES-GCM over the frame payload once the cephx handshake yields a
session key; frames_v2.h SECURE mode).  The environment has no AES
primitive (no `cryptography` package; hashlib/hmac only), so the
cipher is built from the standard primitives instead:

* **keystream**: HMAC-SHA256 as a PRF in counter mode —
  KS_i = HMAC(k_enc, nonce || i); ciphertext = plaintext XOR KS.
  A PRF in CTR mode is a standard stream-cipher construction (the
  same shape as AES-CTR with the PRF swapped).
* **integrity**: encrypt-then-MAC with an independent key —
  tag = HMAC(k_mac, nonce || ciphertext), truncated to 16 bytes
  (the AES-GCM tag length).  Verified before any decode touches the
  bytes.

Two layers:

* `SecureSession` — the raw sealer over a given key + role label (the
  keystream/MAC primitive).
* `SecureConn` — the per-CONNECTION protocol (ref: the per-session
  keys crypto_onwire derives from the auth handshake):
  a two-message KEX carrying fresh nonces AND finite-field
  Diffie-Hellman shares (RFC 3526 group 14, plain `pow` — no external
  primitive needed), MAC'd under the cluster secret so an outsider
  cannot MITM.  Session keys mix the DH shared secret, so a PASSIVE
  holder of the cluster secret (any client, a compromised daemon)
  cannot decrypt other sessions; active
  MITM still requires the cluster secret, matching the reference's
  shared-service-key trust model.  Each direction gets its own
  enc/mac keys (role "i2r"/"r2i"), frames carry a strictly-increasing
  counter bound into the MAC (no replay, no reflection, no
  cross-session splicing — another session's keys never verify), and
  connections REKEY by reconnecting after `REKEY_FRAMES` frames.

The port's copy of `ceph_tpu.msg.secure`, whole: a frame the port seals
opens in the reference and the reverse.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import struct

TAG_LEN = 16
NONCE_LEN = 12
_BLOCK = hashlib.sha256().digest_size

#: frames per connection before the transport forces a reconnect
#: (fresh KEX = key rotation)
REKEY_FRAMES = 1 << 20

# RFC 3526 group 14: 2048-bit MODP (public standard constants)
_DH_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16)
_DH_G = 2
_PUB_LEN = 256                    # 2048-bit share


class SecureSession:
    """Per-connection-direction frame sealer/opener."""

    def __init__(self, secret: str | bytes, role: str):
        if isinstance(secret, str):
            secret = secret.encode()
        self.k_enc = hmac.new(secret, b"ms-secure-enc|" + role.encode(),
                              hashlib.sha256).digest()
        self.k_mac = hmac.new(secret, b"ms-secure-mac|" + role.encode(),
                              hashlib.sha256).digest()

    # -- keystream ------------------------------------------------------
    def _keystream(self, nonce: bytes, n: int) -> bytes:
        out = bytearray()
        for i in range((n + _BLOCK - 1) // _BLOCK):
            out += hmac.new(self.k_enc,
                            nonce + struct.pack("!Q", i),
                            hashlib.sha256).digest()
        return bytes(out[:n])

    def _xor(self, data: bytes, nonce: bytes) -> bytes:
        ks = self._keystream(nonce, len(data))
        return bytes(a ^ b for a, b in zip(data, ks)) \
            if len(data) < 4096 else _xor_np(data, ks)

    # -- frame seal/open ------------------------------------------------
    def seal(self, plaintext: bytes) -> bytes:
        """nonce || ciphertext || tag (the SECURE frame body)."""
        nonce = os.urandom(NONCE_LEN)
        ct = self._xor(plaintext, nonce)
        tag = hmac.new(self.k_mac, nonce + ct,
                       hashlib.sha256).digest()[:TAG_LEN]
        return nonce + ct + tag

    def open(self, blob: bytes) -> bytes | None:
        """Verify + decrypt; None on any mismatch (the caller treats it
        like a corrupt frame and drops the connection)."""
        if len(blob) < NONCE_LEN + TAG_LEN:
            return None
        nonce = blob[:NONCE_LEN]
        ct = blob[NONCE_LEN:-TAG_LEN]
        tag = blob[-TAG_LEN:]
        want = hmac.new(self.k_mac, nonce + ct,
                        hashlib.sha256).digest()[:TAG_LEN]
        if not hmac.compare_digest(want, tag):
            return None
        return self._xor(ct, nonce)


def _xor_np(data: bytes, ks: bytes) -> bytes:
    import numpy as np
    a = np.frombuffer(data, dtype=np.uint8)
    b = np.frombuffer(ks, dtype=np.uint8)
    return (a ^ b).tobytes()


class SecureConn:
    """Per-connection secure channel: DH-agreed, direction-separated
    session keys with counter-bound frames (see module docstring).

    Wire protocol: the connection INITIATOR sends `kex_frame()` as its
    first frame; the responder ingests it, replies with its own
    `kex_frame()`, and both ends derive the session keys.  Every
    subsequent frame is `seal()`ed: ctr(8) || ciphertext || tag."""

    def __init__(self, secret: str | bytes, initiator: bool):
        if isinstance(secret, str):
            secret = secret.encode()
        self._secret = secret
        self.initiator = initiator
        self.established = False
        self._x = int.from_bytes(os.urandom(32), "big") | 1
        self._pub = pow(_DH_G, self._x, _DH_P)
        self.nonce = os.urandom(16)
        self.send_ctr = 0
        self._recv_ctr = 0
        self._send: SecureSession | None = None
        self._recv: SecureSession | None = None
        import threading
        self.ready = threading.Event()

    # -- handshake ------------------------------------------------------
    def kex_frame(self) -> bytes:
        body = b"KEX1" + self.nonce + \
            self._pub.to_bytes(_PUB_LEN, "big")
        mac = hmac.new(self._secret, b"ms-kex|" + body,
                       hashlib.sha256).digest()[:TAG_LEN]
        return body + mac

    def ingest_kex(self, frame: bytes) -> bool:
        """Peer's KEX: verify its cluster-secret MAC (outsider MITM
        gate), compute the DH shared secret, derive both directions'
        keys."""
        if len(frame) != 4 + 16 + _PUB_LEN + TAG_LEN or \
                frame[:4] != b"KEX1":
            return False
        body, mac = frame[:-TAG_LEN], frame[-TAG_LEN:]
        want = hmac.new(self._secret, b"ms-kex|" + body,
                        hashlib.sha256).digest()[:TAG_LEN]
        if not hmac.compare_digest(want, mac):
            return False
        peer_nonce = body[4:20]
        peer_pub = int.from_bytes(body[20:], "big")
        if not 1 < peer_pub < _DH_P - 1:
            return False               # degenerate share
        shared = pow(peer_pub, self._x, _DH_P).to_bytes(_PUB_LEN,
                                                        "big")
        ni, nr = ((self.nonce, peer_nonce) if self.initiator
                  else (peer_nonce, self.nonce))
        base = hmac.new(self._secret, b"ms-sess|" + shared + ni + nr,
                        hashlib.sha256).hexdigest()
        send_role, recv_role = (("i2r", "r2i") if self.initiator
                                else ("r2i", "i2r"))
        self._send = SecureSession(base, send_role)
        self._recv = SecureSession(base, recv_role)
        self.established = True
        self.ready.set()
        return True

    # -- data frames ----------------------------------------------------
    def seal(self, plaintext: bytes) -> bytes:
        ctr8 = struct.pack("!Q", self.send_ctr)
        self.send_ctr += 1
        ct = self._send._xor(plaintext, b"fr|" + ctr8)
        tag = hmac.new(self._send.k_mac, ctr8 + ct,
                       hashlib.sha256).digest()[:TAG_LEN]
        return ctr8 + ct + tag

    def open(self, blob: bytes) -> bytes | None:
        """Strict-order verify + decrypt: the counter must be exactly
        the next expected one (TCP preserves order, so anything else
        is replay/splice/loss) and the tag must verify under THIS
        session's receive key — a frame sealed for any other session
        can never open."""
        if not self.established or len(blob) < 8 + TAG_LEN:
            return None
        ctr8, ct, tag = blob[:8], blob[8:-TAG_LEN], blob[-TAG_LEN:]
        if struct.unpack("!Q", ctr8)[0] != self._recv_ctr:
            return None
        want = hmac.new(self._recv.k_mac, ctr8 + ct,
                        hashlib.sha256).digest()[:TAG_LEN]
        if not hmac.compare_digest(want, tag):
            return None
        self._recv_ctr += 1
        return self._recv._xor(ct, b"fr|" + ctr8)
