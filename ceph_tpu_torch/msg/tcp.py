"""TCP messenger backend: the framework over real sockets.

The AsyncMessenger/posix analogue (ref: src/msg/async/AsyncMessenger.cc,
PosixStack: event-driven sockets with per-peer Connections).  Frames
carry the versioned typed encoding from `msg/encoding.py` (preamble +
struct payload + crc32c epilogue, the frames_v2 model; ref:
src/msg/async/frames_v2.h:58-151); decoding constructs only registered
wire structs and TLV primitives, never code.  Same dispatcher surface
as the in-process transport, so every daemon (mon, OSD, client) runs
unmodified over localhost or a LAN, one process per daemon.

Addressing: a static name -> (host, port) map (the monmap analogue,
ref: src/mon/MonMap.h + per-daemon bind addrs from the config).

Delivery semantics match LocalNetwork: per-peer FIFO, best-effort; a
failed or refused connection reports ms_handle_reset to the sender.

The port's copy of `ceph_tpu.msg.tcp`: `send_frame`, `recv_frame`,
`TcpNet`, `TcpMessenger` and `pick_free_ports`, with learned-connection
replies, reconnect-and-resend, secure mode (`msg/secure.py`) and on-wire
compression layered as the reference layers them (compress, then seal).
Its frames are the reference's byte for byte, so a port endpoint and a
reference endpoint talk to each other.  One rule differs: a handler
error a reader thread logs and serves past is also counted on the net,
in `dispatch_errors` and `last_dispatch_error` (the names
`LocalNetwork` uses), and the net counts the frames and bytes its
endpoints send.  `TcpNet(faults=)` shares a `FaultPlane` with every
endpoint on the net, which decides each send before the socket write
(drop with an optional reset, partition, delay slept out, dup), and a
handler error on a reader thread goes to the endpoint's `crash_hook`.
"""
from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time
import traceback

from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.racecheck import shared_state
from .encoding import WireError, decode_message, encode_message
from .messenger import Connection, Dispatcher, Message

_HDR = struct.Struct("!I")
MAX_FRAME = 1 << 30


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes | None:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return bytes(buf)


class TcpNet:
    """The monmap analogue: name -> (host, port) for every entity.
    Passing one of these as the `network` to Messenger.create selects
    the TCP backend (ref: MonMap + per-daemon bind addrs).

    `secure_secret` switches every endpoint created on this net into
    secure wire mode (ref: msgr v2 SECURE mode, crypto_onwire.cc):
    frames are sealed with authenticated encryption derived from the
    cluster secret (see msg/secure.py).  `compress` names a compressor
    (compressor/) for frames of at least `compress_min` bytes.

    The net also carries what its endpoints count: handler errors their
    reader threads logged and served past (`dispatch_errors`, the
    traceback of the last in `last_dispatch_error`), and the frames and
    bytes they sent (`frames_sent`, `bytes_sent`, headers included).
    `faults` is an optional shared `FaultPlane` (msg/faults.py)."""

    def __init__(self, addr_map: dict[str, tuple[str, int]],
                 secure_secret: str | bytes | None = None,
                 compress: str | None = None,
                 compress_min: int = 4096,
                 faults=None):
        self.addr_map = dict(addr_map)
        self.secure_secret = secure_secret
        self.compress = compress
        self.compress_min = compress_min
        #: optional shared FaultPlane — every endpoint created on this
        #: net intercepts its sends through it (drop/partition/delay/
        #: dup; reorder needs a queue transport and is a no-op here)
        self.faults = faults
        self._lock = make_lock("msgr.tcp_net")
        self.dispatch_errors = 0
        self.last_dispatch_error = ""
        self.frames_sent = 0
        self.bytes_sent = 0

    def messenger(self, name: str) -> "TcpMessenger":
        """One endpoint of this net (bound on start() when `name` has
        an address)."""
        return TcpMessenger(self, name)

    def note_dispatch_error(self, name: str, tb: str) -> None:
        with self._lock:
            self.dispatch_errors += 1
            self.last_dispatch_error = f"{name}: {tb}"

    def note_sent(self, nbytes: int) -> None:
        with self._lock:
            self.frames_sent += 1
            self.bytes_sent += nbytes


# the connection maps are shared between the send path (any caller
# thread), the accept loop, and every per-socket reader thread —
# racecheck asserts each access holds self._lock
@shared_state(only=("_out", "_learned", "_accepted", "_sessions"),
              mutating=("_out", "_learned", "_accepted", "_sessions"))
class TcpMessenger:
    """One endpoint bound to addr_map[name]
    (ref: Messenger::bind + AsyncMessenger accept loop)."""

    def __init__(self, net: TcpNet, name: str):
        self.net = net
        self.name = name
        self.addr_map = dict(net.addr_map)
        #: send-side fault intercept (msg/faults.py FaultPlane):
        #: consulted before every socket write, so a partitioned or
        #: lossy link fails here exactly like the in-process backend
        self.faults = net.faults
        # secure wire mode (ref: frames_v2 SECURE): every CONNECTION
        # runs its own KEX and seals under per-session, per-direction
        # keys (msg/secure.py SecureConn)
        self._secure_secret = net.secure_secret
        #: socket -> SecureConn session state
        self._sessions: dict = {}
        # on-wire compression (ref: msgr v2 compression).  Layering
        # matches the reference: compress, THEN seal (ciphertext does
        # not compress).  Both endpoints must share the setting (it
        # travels in the monmap as "ms_compress"): the flag byte is
        # only present when it is on.
        self._compress = net.compress
        self._compress_min = net.compress_min
        if self._compress is not None:
            from ..compressor import registry as _creg
            _creg.create(self._compress)     # fail fast on unknown algs
        self.dispatchers: list[Dispatcher] = []
        self._lock = make_lock(f"msgr.tcp.{name}")
        self._out: dict[str, socket.socket] = {}   # peer -> conn
        # connections learned from inbound traffic: lets us answer
        # peers with no monmap address (clients are not in the monmap;
        # the reference learns entity addrs from the connection banner
        # and replies over the accepted socket)
        self._learned: dict[str, socket.socket] = {}
        self._running = False
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        #: sockets accepted from peers, closed on shutdown so their
        #: reader threads exit and the kernel releases the port
        self._accepted: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._seq = 0
        # cephx hooks (same surface as the in-process messenger)
        self.auth_signer = None
        self.auth_verifier = None
        # crash capture (same surface as the in-process messenger)
        self.crash_hook = None

    # -- messenger surface ----------------------------------------------
    def add_dispatcher(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    def connect(self, peer: str) -> Connection:
        return Connection(self, peer)

    def start(self) -> None:
        self._running = True
        addr = self.addr_map.get(self.name)
        if addr is None:
            # client-only endpoint: no listener; replies arrive over
            # the connections we initiate
            return
        host, port = addr
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind((host, port))
            self._listener.listen(64)
        except OSError:
            self._listener.close()
            self._listener = None
            raise
        t = threading.Thread(target=self._accept_loop,
                             name=f"tcp-accept-{self.name}", daemon=True)
        t.start()
        self._accept_thread = t
        self._threads.append(t)

    def poll(self, max_msgs: int = 0) -> int:
        """Socket reads deliver on their own threads; nothing to pump
        (API compat with the in-process transport)."""
        return 0

    def shutdown(self) -> None:
        self._running = False
        with self._lock:
            socks = list(self._out.values()) + self._accepted
            self._out.clear()
            self._learned.clear()
            self._accepted = []
            self._sessions.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self._listener is not None:
            # wake the thread blocked in accept() FIRST: a close alone
            # leaves the in-syscall reference holding the socket open
            # (the port stays in LISTEN and a revived daemon on the
            # same addr gets EADDRINUSE)
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            if self._accept_thread is not None and \
                    self._accept_thread is not threading.current_thread():
                self._accept_thread.join(timeout=5.0)

    # -- send ------------------------------------------------------------
    def _secure_handshake(self, sock) -> object | None:
        """Initiator side of the per-connection KEX: send our share,
        the reader thread ingests the responder's and signals ready."""
        from .secure import SecureConn
        sc = SecureConn(self._secure_secret, initiator=True)
        self._sessions[sock] = sc
        try:
            self._frame_out(sock, sc.kex_frame())
        except OSError:
            return None
        return sc

    def _wait_session(self, sock) -> bool:
        """Wait for the socket's KEX to complete with the messenger lock
        RELEASED: a hung peer's handshake must not stall sends to every
        other peer.  Caller holds self._lock."""
        sc = self._sessions.get(sock)
        if sc is None:
            return False
        if sc.established:
            return True
        self._lock.release()
        try:
            return sc.ready.wait(5.0)
        finally:
            self._lock.acquire()

    def _seal_for(self, sock, payload: bytes) -> bytes | None:
        """Seal under the socket's established session; None = no
        session, or an INITIATOR-side connection due for rekey
        (rotation is initiator-driven: a responder forcing it on a
        learned socket would drop the in-flight reply with no way to
        reconnect to a listener-less client)."""
        sc = self._sessions.get(sock)
        if sc is None or not sc.established:
            return None
        from . import secure
        if sc.initiator and sc.send_ctr >= secure.REKEY_FRAMES:
            return None          # rotate: reconnect runs a fresh KEX
        return sc.seal(payload)

    def _frame_out(self, sock, payload: bytes) -> None:
        send_frame(sock, payload)
        self.net.note_sent(_HDR.size + len(payload))

    def _send_sealed(self, sock, payload: bytes) -> None:
        """One framing contract for every send path: seal when secure
        (waiting out a pending KEX first), raise OSError on failure."""
        if self._secure_secret is not None:
            if not self._wait_session(sock):
                raise OSError("secure session unavailable")
            sealed = self._seal_for(sock, payload)
            if sealed is None:
                raise OSError("secure session unavailable")
            self._frame_out(sock, sealed)
        else:
            self._frame_out(sock, payload)

    def _close(self, sock) -> None:
        self._sessions.pop(sock, None)
        try:
            sock.close()
        except OSError:
            pass

    def _open_out(self, peer: str):
        """A fresh outgoing connection to `peer` with its reader (and
        its KEX when secure), recorded in _out; None when it cannot
        connect.  Caller holds self._lock."""
        sock = self._connect_peer(peer)
        if sock is None:
            return None
        self._out[peer] = sock
        if self._secure_secret is not None:
            self._secure_handshake(sock)
        self._spawn_reader(sock)
        return sock

    def _send(self, peer: str, msg: Message) -> bool:
        eff = None
        if self.faults is not None:
            # decide (and sleep out an injected delay) BEFORE taking
            # the lock: a delayed link must not stall unrelated peers
            eff = self.faults.decide(self.name, peer, msg.type_name)
            if eff.dropped:
                if eff.reset:
                    self.handle_reset(peer)
                return False
            if eff.delay > 0.0:
                time.sleep(min(eff.delay, 1.0))
        with self._lock:
            self._seq += 1
            msg = dataclasses.replace(msg, src=self.name, seq=self._seq)
            try:
                # sign() canonicalizes through the wire codec too, so
                # it sits inside the WireError net with the encode
                if self.auth_signer is not None:
                    msg = self.auth_signer.sign(msg)
                payload = encode_message(msg)
                if self._compress is not None:
                    if len(payload) >= self._compress_min:
                        from .. import compressor
                        payload = b"\x01" + compressor.compress(
                            payload, self._compress)
                    else:
                        payload = b"\x00" + payload
            except WireError as ex:
                dout("ms", 0).write("%s: unencodable %s: %s", self.name,
                                    msg.type_name, ex)
                return False
            learned = False
            sock = self._out.get(peer)
            if sock is None and peer not in self.addr_map:
                sock = self._learned.get(peer)
                learned = sock is not None
            fresh = False
            if sock is None:
                sock = self._open_out(peer)
                if sock is None:
                    self.handle_reset(peer)
                    return False
                fresh = True
            try:
                self._send_sealed(sock, payload)
                if eff is not None and eff.dup:
                    # injected duplication: same frame, same seq — the
                    # receiver sees a TCP-retransmit-style replay
                    self._send_sealed(sock, payload)
                return True
            except OSError:
                (self._learned if learned else self._out).pop(peer, None)
                self._close(sock)
                # a cached socket may be stale (the peer restarted on
                # the same addr, or its secure session is due for
                # rotation): reconnect once and resend before declaring
                # the peer reset, or a mon's map push to a rebooted
                # daemon is silently lost (ref: AsyncConnection
                # reconnect)
                if not fresh and peer in self.addr_map:
                    sock = self._open_out(peer)
                    if sock is not None:
                        try:
                            self._send_sealed(sock, payload)
                            return True
                        except OSError:
                            self._out.pop(peer, None)
                            self._close(sock)
        self.handle_reset(peer)
        return False

    def _connect_peer(self, peer: str) -> socket.socket | None:
        addr = self.addr_map.get(peer)
        if addr is None:
            return None
        try:
            s = socket.create_connection(tuple(addr), timeout=5.0)
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s
        except OSError:
            return None

    # -- receive ---------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._accepted.append(conn)
                if self._secure_secret is not None:
                    # inside the lock: the send path reads _sessions
                    # under it concurrently (racecheck-audited)
                    from .secure import SecureConn
                    self._sessions[conn] = SecureConn(
                        self._secure_secret, initiator=False)
            self._spawn_reader(conn, learn=True)

    def _spawn_reader(self, conn: socket.socket,
                      learn: bool = False) -> None:
        """Every socket gets a reader, outbound ones too, so a peer
        that answers over OUR connection (it has no address for us) is
        heard."""
        t = threading.Thread(target=self._read_loop, args=(conn, learn),
                             name=f"tcp-read-{self.name}", daemon=True)
        t.start()
        self._threads.append(t)

    def _unframe(self, frame: bytes, sc, conn) -> bytes | None:
        """The message bytes of one received frame (None: drop the
        connection); b"" for a handshake frame that carried no
        message."""
        if self._secure_secret is not None:
            if sc is None:
                return None
            if not sc.established:
                # handshake leg: ingest the peer's KEX; the responder
                # answers with its own share
                if not sc.ingest_kex(frame):
                    dout("ms", 1).write("%s: bad KEX frame — dropping "
                                        "connection", self.name)
                    return None
                if not sc.initiator:
                    self._frame_out(conn, sc.kex_frame())
                return b""
            frame = sc.open(frame)
            if frame is None:
                dout("ms", 1).write("%s: secure frame failed "
                                    "authentication — dropping "
                                    "connection", self.name)
                return None
        if self._compress is not None:
            if not frame:
                return None
            if frame[0] != 1:
                return frame[1:]
            from .. import compressor
            try:
                # cap post-decompression size: a small frame must not
                # inflate into an OOM bomb
                return compressor.decompress(frame[1:], max_len=MAX_FRAME)
            except Exception as ex:
                dout("ms", 1).write("%s: bad compressed frame: %s — "
                                    "dropping connection", self.name, ex)
                return None
        return frame

    def _read_loop(self, conn: socket.socket, learn: bool) -> None:
        peer = None
        with self._lock:
            sc = self._sessions.get(conn)
        try:
            while self._running:
                frame = recv_frame(conn)
                if frame is None:
                    break
                frame = self._unframe(frame, sc, conn)
                if frame is None:
                    break
                if not frame:
                    continue
                msg = decode_message(frame)
                # authenticate BEFORE learning: otherwise a forged
                # frame could hijack the learned reply route for the
                # entity it spoofs
                if self.auth_verifier is not None and \
                        not self.auth_verifier.verify(msg):
                    dout("ms", 1).write(
                        "%s: dropping unauthenticated %s from %s",
                        self.name, msg.type_name, msg.src)
                    continue
                if learn:
                    # every verified frame refreshes the route (a
                    # reset elsewhere may have dropped the mapping)
                    with self._lock:
                        self._learned[msg.src] = conn
                peer = msg.src
                self._deliver_verified(msg)
        except (OSError, ValueError) as ex:
            if self._running:      # shutdown closes sockets under us
                dout("ms", 1).write("%s: read error from %s: %s",
                                    self.name, peer, ex)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                self._sessions.pop(conn, None)
                # prune dead accepted sockets: a long-lived endpoint
                # must not keep one entry per past connection
                try:
                    self._accepted.remove(conn)
                except ValueError:
                    pass
            if peer is not None:
                with self._lock:
                    if self._learned.get(peer) is conn:
                        del self._learned[peer]
                if self._running:
                    self.handle_reset(peer)

    def _deliver_verified(self, msg: Message) -> None:
        for d in self.dispatchers:
            try:
                if d.ms_dispatch(msg):
                    return
            except Exception as ex:
                # log and keep serving, as the reference does, but
                # count it: a kernel or device fault raised by a
                # handler must show, not stall the cluster silently
                tb = traceback.format_exc()
                self.net.note_dispatch_error(self.name, tb)
                dout("ms", 0).write("dispatch error on %s: %s",
                                    self.name, tb)
                if self.crash_hook is not None:
                    try:
                        self.crash_hook(ex)
                    except Exception as hex_:
                        # capture must never re-crash the reader
                        dout("ms", 0).write(
                            "%s: crash hook failed: %s", self.name,
                            hex_)
                return
        dout("ms", 1).write("%s: unhandled message %s from %s",
                            self.name, msg.type_name, msg.src)

    def handle_reset(self, peer: str) -> None:
        for d in self.dispatchers:
            d.ms_handle_reset(peer)


def pick_free_ports(n: int, host: str = "127.0.0.1") -> list[int]:
    """Ephemeral ports for a test or launcher monmap."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind((host, 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports
