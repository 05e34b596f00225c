"""Messenger core: entity addressing, typed messages, dispatch.

Shapes mirrored from the reference (ref: src/msg/Messenger.h —
`Messenger::create` factory :21 in Messenger.cc, `add_dispatcher_head`,
`Connection::send_message`; src/msg/Dispatcher.h ms_dispatch/
ms_handle_reset).  The local backend replaces the AsyncMessenger epoll
machinery with per-entity queues: a "connection" is a handle onto the
peer's dispatch queue, delivery order per (src, dst) pair is FIFO like
a TCP stream, and `ms_inject_socket_failures` drops messages the same
way the reference's injected socket resets lose in-flight traffic
(ref: src/common/options.cc:987).

The port's copy of `ceph_tpu.msg.messenger`: the in-process transport
over the seeded fault plane (`LocalNetwork(fault_seed=)`, the
`ms_inject_socket_failures` shim rule), the dispatch thread's crash
hook, the cephx signer and verifier hooks, and `Messenger.create` over a
`TcpNet`, which selects the socket backend (`msg/tcp.py`).
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.options import global_config
from ..common.racecheck import shared_state

EntityName = str      # "osd.3", "mon.0", "client.4121"


_seq = itertools.count(1)


@dataclass
class Message:
    """Base wire message.  Subclasses add payload fields
    (ref: src/msg/Message.h; one subclass per type like src/messages/)."""
    # filled in by the transport on send:
    src: EntityName = field(default="", compare=False)
    seq: int = field(default=0, compare=False)
    # cephx message signature (ticket + hmac), attached by the
    # sender's auth handler when auth is enabled
    # (ref: Message signing under session keys, msgr v2)
    auth: Optional[dict] = field(default=None, compare=False)
    # blkin-style trace context riding the message
    # (ref: Message.h:263 ZTracer::Trace trace)
    trace: Optional[dict] = field(default=None, compare=False)

    @property
    def type_name(self) -> str:
        return type(self).__name__


class Dispatcher:
    """Receiver interface (ref: src/msg/Dispatcher.h)."""

    def ms_dispatch(self, msg: Message) -> bool:
        raise NotImplementedError

    def ms_handle_reset(self, peer: EntityName) -> None:
        """Peer endpoint went away with messages possibly lost."""


class Connection:
    """Send handle to one peer (ref: Connection::send_message)."""

    def __init__(self, messenger: "Messenger", peer: EntityName):
        self.messenger = messenger
        self.peer = peer

    def send_message(self, msg: Message) -> bool:
        return self.messenger._send(self.peer, msg)


class Messenger:
    """One endpoint on a network (ref: src/msg/Messenger.h).

    Create via `Messenger.create(network, name)`; register a Dispatcher
    with `add_dispatcher`; get peers with `connect`.
    """

    def __init__(self, network: "LocalNetwork", name: EntityName,
                 threaded: bool = True):
        self.network = network
        self.name = name
        self.dispatchers: list[Dispatcher] = []
        self.threaded = threaded
        self._queue: "queue.Queue[Optional[Message]]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._running = False
        # cephx hooks: the signer stamps outgoing copies, the verifier
        # gates incoming ones (None = auth off; ref: ms_verify_authorizer)
        self.auth_signer = None
        self.auth_verifier = None
        # crash capture: called with the exception when a dispatcher
        # blows up on the dispatch thread (the daemon's CrashReporter;
        # ref: the global handle_fatal_signal crash dump path)
        self.crash_hook = None

    # -- factory (ref: Messenger.cc:21 Messenger::create) ---------------
    @staticmethod
    def create(network, name: EntityName, ms_type: str | None = None,
               threaded: bool = True):
        # a TcpNet (monmap) network selects the socket backend: the
        # same dispatcher surface, one OS process per daemon
        from .tcp import TcpNet
        if isinstance(network, TcpNet):
            return network.messenger(name)
        # ici carries bulk arrays on the device mesh; its control
        # endpoint is identical to local
        if ms_type not in (None, "local", "ici"):
            raise ValueError(f"unsupported ms_type {ms_type!r}")
        return network.register(Messenger(network, name, threaded))

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._running = True
        if self.threaded:
            self._thread = threading.Thread(
                target=self._dispatch_loop, name=f"ms-{self.name}",
                daemon=True)
            self._thread.start()

    def shutdown(self) -> None:
        self._running = False
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=10)
            self._thread = None
        self.network.unregister(self.name)

    def add_dispatcher(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    def connect(self, peer: EntityName) -> Connection:
        return Connection(self, peer)

    # -- send / deliver -------------------------------------------------
    def _send(self, peer: EntityName, msg: Message) -> bool:
        # stamp a copy: the caller may reuse its message object (e.g. a
        # broadcast loop) while earlier sends are still in flight
        msg = dataclasses.replace(msg, src=self.name, seq=next(_seq))
        if self.auth_signer is not None:
            try:
                msg = self.auth_signer.sign(msg)
            except ValueError as ex:     # WireError from the canon
                dout("ms", 0).write("%s: unsignable %s: %s", self.name,
                                    msg.type_name, ex)
                return False
        return self.network.route(self.name, peer, msg)

    def enqueue(self, msg: Message) -> None:
        """Queued for the dispatch thread (threaded) or until poll()."""
        self._queue.put(msg)

    def poll(self, max_msgs: int = 0) -> int:
        """Deterministic pump for non-threaded mode: deliver queued
        messages inline; returns the number delivered."""
        n = 0
        while max_msgs == 0 or n < max_msgs:
            try:
                msg = self._queue.get_nowait()
            except queue.Empty:
                break
            if msg is not None:
                self._deliver(msg)
                n += 1
        return n

    def _dispatch_loop(self) -> None:
        while self._running:
            msg = self._queue.get()
            if msg is None:
                break
            try:
                self._deliver(msg)
            except Exception as ex:
                # log and keep serving, as the reference does, but
                # count it: a kernel or device fault raised by a
                # handler must show, not stall the cluster silently
                tb = traceback.format_exc()
                self.network.note_dispatch_error(self.name, tb)
                dout("ms", 0).write("dispatch error on %s: %s",
                                    self.name, tb)
                if self.crash_hook is not None:
                    try:
                        self.crash_hook(ex)
                    except Exception as hex_:
                        # capture must never re-crash the loop
                        dout("ms", 0).write(
                            "%s: crash hook failed: %s", self.name,
                            hex_)

    def _deliver(self, msg: Message) -> None:
        if self.auth_verifier is not None and \
                not self.auth_verifier.verify(msg):
            dout("ms", 1).write(
                "%s: dropping unauthenticated %s from %s", self.name,
                msg.type_name, msg.src)
            return
        for d in self.dispatchers:
            if d.ms_dispatch(msg):
                return
        dout("ms", 1).write("%s: unhandled message %s from %s",
                            self.name, msg.type_name, msg.src)

    def handle_reset(self, peer: EntityName) -> None:
        for d in self.dispatchers:
            d.ms_handle_reset(peer)


#: drop-ring depth: enough context to debug a fault burst without an
#: unbounded list outliving a long run (drops_total keeps the exact
#: count)
DROP_RING = 512


@shared_state(only=("_endpoints",), mutating=("_endpoints",))
class LocalNetwork:
    """In-process "wire": entity registry + routing + fault injection.

    One instance per simulated cluster.  Fault injection is delegated
    to the attached FaultPlane (`faults.py`): per-link drop
    probability, partitions, delay, reorder, duplication — all from
    one seeded RNG.  `ms_inject_socket_failures` survives as a
    compatibility shim that installs an equivalent all-links drop rule
    with probability 1/N (ref: src/common/options.cc:987; the
    reference resets the socket, losing in-flight messages — shim
    drops likewise give both sides ms_handle_reset, while partition
    drops stay silent so detection is timeout-driven like a real
    netsplit).  The `filter` hook drops a message and resets both
    sides too.  `dispatch_errors` counts the exceptions that threaded
    dispatch loops logged and survived."""

    def __init__(self, fault_seed: int = 0):
        from .faults import FaultPlane
        self._endpoints: dict[EntityName, Messenger] = {}
        self._lock = make_lock("msgr.local_network")
        self._routed = 0
        #: last DROP_RING dropped messages (debugging ring; the full
        #: count lives in drops_total)
        self.dropped: "deque[tuple[EntityName, EntityName, Message]]" \
            = deque(maxlen=DROP_RING)
        #: monotonically-increasing drop counter, exported through the
        #: daemon perf-dump path (osd msgr_drops_total)
        self.drops_total = 0
        #: optional test hook: (src, dst, msg) -> False to drop
        self.filter: Callable[[EntityName, EntityName, Message], bool] \
            | None = None
        #: handler exceptions caught by threaded dispatch loops, and
        #: the traceback of the last one
        self.dispatch_errors = 0
        self.last_dispatch_error = ""
        self.faults = FaultPlane(seed=fault_seed)
        self.faults.deliver_cb = self._fault_deliver
        #: ms_inject_socket_failures value the shim rule reflects
        self._shim_inject = 0
        self._shim_rule: int | None = None

    @property
    def routed(self) -> int:
        """Messages routed so far (dead destinations included; the
        filter's drops excluded)."""
        return self._routed

    def note_dispatch_error(self, name: EntityName, tb: str) -> None:
        with self._lock:
            self.dispatch_errors += 1
            self.last_dispatch_error = f"{name}: {tb}"

    def register(self, ms: Messenger) -> Messenger:
        with self._lock:
            if ms.name in self._endpoints:
                raise ValueError(f"entity {ms.name} already bound")
            self._endpoints[ms.name] = ms
        return ms

    def unregister(self, name: EntityName) -> None:
        with self._lock:
            self._endpoints.pop(name, None)

    def lookup(self, name: EntityName) -> Messenger | None:
        with self._lock:
            return self._endpoints.get(name)

    def _sync_inject_shim(self) -> None:
        """Mirror ms_inject_socket_failures into an equivalent
        FaultPlane rule: drop 1-in-N becomes probability 1/N on every
        link (seeded, so bursts are now possible — the modulus never
        dropped two consecutive messages)."""
        inject = global_config()["ms_inject_socket_failures"]
        if inject == self._shim_inject:
            return
        self._shim_inject = inject
        if self._shim_rule is not None:
            self.faults.remove_rule(self._shim_rule)
            self._shim_rule = None
        if inject:
            self._shim_rule = self.faults.add_rule(
                "*", "*", drop=1.0 / inject, reset=True)

    def _fault_deliver(self, src: EntityName, dst: EntityName,
                       msg: Message) -> None:
        """Terminal delivery for the fault plane (also used for held
        messages released later by flush)."""
        with self._lock:
            dst_ms = self._endpoints.get(dst)
            src_ms = self._endpoints.get(src)
        if dst_ms is None:
            if src_ms:
                src_ms.handle_reset(dst)
            return
        dst_ms.enqueue(msg)

    def _drop(self, src: EntityName, dst: EntityName, msg: Message,
              reset: bool) -> None:
        self.dropped.append((src, dst, msg))
        self.drops_total += 1
        if not reset:
            return
        with self._lock:
            src_ms = self._endpoints.get(src)
            dst_ms = self._endpoints.get(dst)
        if src_ms:
            src_ms.handle_reset(dst)
        if dst_ms:
            dst_ms.handle_reset(src)

    def route(self, src: EntityName, dst: EntityName,
              msg: Message) -> bool:
        self._sync_inject_shim()
        if self.filter is not None and \
                not self.filter(src, dst, msg):
            self._drop(src, dst, msg, reset=True)
            return False
        with self._lock:
            self._routed += 1
            dst_ms = self._endpoints.get(dst)
            src_ms = self._endpoints.get(src)
        if dst_ms is None:
            self.faults.flush(self._fault_deliver)
            if src_ms:
                src_ms.handle_reset(dst)
            return False
        eff = self.faults.intercept(src, dst, msg,
                                    self._fault_deliver)
        if eff.dropped:
            self._drop(src, dst, msg, reset=eff.reset)
            return False
        return True
