"""Objecter: object op submission with target calculation and resend.

The client-side engine (ref: src/osdc/Objecter.{h,cc}): each op's
target PG and primary OSD are computed from the client's osdmap
(_calc_target :1095), ops are tagged with tids and sent to the primary
(_op_submit :2378, _send_op), and every map epoch or connection reset
triggers a rescan — ops whose target changed (or that were parked
homeless for lack of a primary) are resent (_scan_requests,
handle_osd_map :1182).  The mon subscription keeps the map fresh.

The port's copy of `ceph_tpu.client.objecter` in part: op targeting,
per-object ordering, resend on a map change or a reset, the rescan of
parked ops, op timeouts, mon commands and cephx (the MAuthRequest
handshake, message signing and ticket renewal).  Left out: the linger
ops of watch/notify, whose OSD side the port's daemon does not carry
yet.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from ..common.backoff import Backoff, full_jitter
from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.options import global_config
from ..common.tracing import Tracer, child_of, current_trace, new_trace
from ..msg.messages import (MAuthReply, MMap, MMonCommand,
                            MMonCommandAck, MMonSubscribe, OSDOp,
                            OSDOpReply)
from ..msg.mon_client import MonHunter
from ..msg.messenger import Dispatcher, LocalNetwork, Message, Messenger
from ..osd.osdmap import OSDMap
from ..osd.types import PG

_client_ids = itertools.count(4100)


class OpFuture:
    """Completion handle for one op."""

    def __init__(self):
        self._ev = threading.Event()
        self.result: int = 0
        self.errno_name: str = ""
        self.data: bytes = b""
        self.attrs: dict = {}

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float = 30.0) -> "OpFuture":
        if not self._ev.wait(timeout):
            raise TimeoutError("op timed out")
        return self

    def _complete(self, reply: OSDOpReply) -> None:
        self.result = reply.result
        self.errno_name = reply.errno_name
        self.data = reply.data
        self.attrs = reply.attrs
        self._ev.set()


class _Op:
    def __init__(self, tid: int, pool: int, oid: str, op: str,
                 offset: int, length: int, data: bytes,
                 future: OpFuture, pg_ps: Optional[int] = None,
                 args: Optional[dict] = None,
                 unordered: bool = False):
        self.tid = tid
        self.pool = pool
        self.oid = oid
        self.op = op
        self.offset = offset
        self.length = length
        self.data = data
        self.args = args or {}
        self.future = future
        self.unordered = unordered
        self.pg_ps = pg_ps        # PG-addressed op (pgls)
        self.pg: Optional[PG] = None
        self.target_osd = -1
        self.attempts = 0
        self.trace: Optional[dict] = None
        self.span = None          # the client-side span (trace root
        # unless a frontend scoped an ambient parent)
        self.parent_ctx: Optional[dict] = None


class Objecter(Dispatcher, MonHunter):
    """(ref: src/osdc/Objecter.h:1204)."""

    def __init__(self, network: LocalNetwork, name: str | None = None,
                 mon="mon.0", threaded: bool = True,
                 auth_secret: str | None = None):
        self.name = name or f"client.{next(_client_ids)}"
        # cephx: clients do the wire handshake (they hold only their
        # own secret); until the mon's ticket arrives nothing but the
        # MAuthRequest goes out (ref: MonClient::authenticate)
        self._cephx = None
        self.auth_error: str | None = None
        if auth_secret is not None:
            from ..auth import CephxClient
            self._cephx = CephxClient(self.name, auth_secret)
        self._init_mons(mon)
        self.osdmap = OSDMap()
        self._map_ev = threading.Event()
        self._lock = make_lock(f"objecter.{self.name}")
        self._tid = itertools.count(1)
        self.in_flight: dict[int, _Op] = {}
        self.homeless: list[_Op] = []
        # per-object op ordering (librados semantics: one client's ops
        # on one object complete in submission order — without this a
        # parked-then-retried older write can land AFTER a newer acked
        # write and silently win)
        self._obj_active: dict[tuple, int] = {}   # (pool, oid) -> tid
        self._obj_wait: dict[tuple, list] = {}
        self._rescan_timer = None
        self._pending_cmds: dict = {}
        #: non-threaded harnesses set this to a network pump callable;
        #: synchronous waits then drive the cluster instead of blocking
        self.pump_hook = None
        # client-side span sink: the objecter roots (or, under an
        # ambient frontend scope, parents) one span per traced op, so
        # an assembled trace shows the submit->reply client leg too
        # (ref: the Objecter's op trace in src/osdc/Objecter.cc)
        self.tracer = Tracer(self.name)
        self.ms = Messenger.create(network, self.name, threaded=threaded)
        self.ms.add_dispatcher(self)

    # ------------------------------------------------------------ setup
    def start(self) -> None:
        self.ms.start()
        if self._cephx is not None and not self._cephx.authenticated:
            self.ms.connect(self.mon).send_message(
                self._cephx.build_request())
            return        # subscription follows the MAuthReply
        self.ms.connect(self.mon).send_message(
            MMonSubscribe(what="osdmap", start=1))

    def shutdown(self) -> None:
        self.ms.shutdown()

    def wait_sync(self, done, timeout: float, ev=None) -> bool:
        """Wait for `done()` — blocking on `ev` (default: the map
        event) in threaded mode, pumping the harness network
        otherwise.  Call sites need no threaded-vs-pump branching."""
        ev = ev or self._map_ev
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if done():
                return True
            if self.pump_hook is not None:
                self.pump_hook()
                if not done():
                    time.sleep(0.001)   # idle round: don't spin hot
            else:
                ev.wait(min(0.5, max(0.0, end - time.monotonic())))
                if ev is self._map_ev:
                    ev.clear()
        return done()

    def wait_for_map(self, epoch: int = 1, timeout: float = 30.0) -> None:
        if not self.wait_sync(lambda: self.osdmap.epoch >= epoch or
                              self.auth_error is not None, timeout):
            raise TimeoutError(
                f"no osdmap >= e{epoch} (have e{self.osdmap.epoch})")
        if self.auth_error is not None and self.osdmap.epoch < epoch:
            raise PermissionError(f"cephx: {self.auth_error}")

    # --------------------------------------------------------- dispatch
    def ms_dispatch(self, msg: Message) -> bool:
        if isinstance(msg, MAuthReply):
            if self._cephx is None:
                return True
            if self._cephx.ingest_reply(msg):
                self.ms.auth_signer = self._cephx
                # ticket renewal before expiry, fired from sign() so
                # every traffic pattern renews (ref:
                # MonClient::_check_auth_rotating)
                self._cephx.renew_hook = self._send_auth_renewal
                # initial auth subscribes from scratch; a ticket
                # renewal reply only needs maps we don't have yet
                self.ms.connect(self.mon).send_message(
                    MMonSubscribe(what="osdmap",
                                  start=self.osdmap.epoch + 1))
            else:
                self.auth_error = msg.errstr or "authentication failed"
                self._map_ev.set()       # unblock connect() waiters
            return True
        if isinstance(msg, MMap):
            self._handle_map(msg)
            return True
        if isinstance(msg, OSDOpReply):
            self._handle_reply(msg)
            return True
        if isinstance(msg, MMonCommandAck):
            return self._handle_command_ack(msg)
        return False

    def _send_auth_renewal(self) -> None:
        """Re-run the MAuthRequest handshake (called off-thread by the
        signer's renewal hook)."""
        if self._cephx is not None:
            self.ms.connect(self.mon).send_message(
                self._cephx.build_request())

    def _hunt_greeting(self) -> list:
        if self._cephx is not None and not self._cephx.authenticated:
            # a mon failover mid-handshake: re-authenticate at the new
            # mon first (an unsigned subscription would be dropped)
            return [self._cephx.build_request()]
        return [MMonSubscribe(what="osdmap",
                              start=self.osdmap.epoch + 1)]

    def ms_handle_reset(self, peer: str) -> None:
        """Retarget ops aimed at a gone peer (ref:
        Objecter::ms_handle_reset :4487).  Never blindly resend to the
        same peer — route() reports the reset synchronously, so a
        resend to a dead endpoint would recurse; ops whose recalculated
        target is unchanged park homeless until a newer map (or the
        rescan timer) moves them.  A gone mon triggers the shared
        MonHunter walk."""
        if self._maybe_hunt(peer):
            return
        if not peer.startswith("osd."):
            return
        osd = int(peer[4:])
        with self._lock:
            for op in list(self.in_flight.values()):
                if op.target_osd != osd:
                    continue
                self._calc_target(op)
                if op.target_osd == osd or op.target_osd < 0:
                    del self.in_flight[op.tid]
                    self.homeless.append(op)
                else:
                    self._send_op(op)
            if self.homeless:
                self._schedule_rescan()

    # --------------------------------------------------------- map flow
    def _handle_map(self, msg: MMap) -> None:
        with self._lock:
            self.osdmap = self.osdmap.ingest(msg.full_map,
                                             msg.incrementals)
            dout("client", 10).write("%s: osdmap e%d", self.name,
                                     self.osdmap.epoch)
            self._scan_requests()
        self._map_ev.set()

    def _scan_requests(self) -> None:
        """Recompute targets; resend what moved; adopt the homeless
        (ref: Objecter.cc:1182 handle_osd_map -> _scan_requests).

        The homeless list is swapped out BEFORE the drain: a resend
        whose target is gone fails synchronously through
        ms_handle_reset, which re-parks the op onto self.homeless — if
        the drain iterated self.homeless directly it would pick the op
        straight back up and spin forever (resend -> reset -> re-park
        -> resend ...) while holding the lock, livelocking every other
        thread.  Parked ops wait for the rescan timer instead."""
        for op in list(self.in_flight.values()):
            old = op.target_osd
            self._calc_target(op)
            if op.target_osd != old:
                if op.target_osd < 0:
                    del self.in_flight[op.tid]
                    self.homeless.append(op)
                else:
                    self._send_op(op)
        pending, self.homeless = self.homeless, []
        for op in pending:
            if op.pool not in self.osdmap.pools:
                # pool deleted while the op was parked
                self._complete_op(op, OSDOpReply(
                    tid=op.tid, result=-2, errno_name="ENOENT"))
                continue
            self._calc_target(op)
            if op.target_osd >= 0:
                self.in_flight[op.tid] = op
                self._send_op(op)
            else:
                self.homeless.append(op)

    # ------------------------------------------------------ target calc
    def _calc_target(self, op: _Op) -> None:
        """(ref: Objecter.cc:1095 _calc_target)."""
        try:
            if op.pg_ps is not None:
                raw = PG(op.pool, op.pg_ps)
                if op.pool not in self.osdmap.pools:
                    raise KeyError(op.pool)
            else:
                raw = self.osdmap.object_locator_to_pg(op.oid, op.pool)
        except KeyError:
            op.pg, op.target_osd = None, -1
            return
        pool = self.osdmap.pools[op.pool]
        op.pg = pool.raw_pg_to_pg(raw)
        _, _, _, acting_primary = self.osdmap.pg_to_up_acting_osds(raw)
        op.target_osd = acting_primary if acting_primary >= 0 and \
            self.osdmap.is_up(acting_primary) else -1

    # -------------------------------------------------------- op submit
    def submit(self, pool: int, oid: str, op: str, offset: int = 0,
               length: int = 0, data: bytes = b"",
               pg_ps: Optional[int] = None,
               args: Optional[dict] = None,
               unordered: bool = False) -> OpFuture:
        """(ref: Objecter.cc:2378 _op_submit).

        `unordered=True` opts the op out of per-object ordering (the
        librados semantics preserved by _obj_key): N such ops on one
        object all go to the wire at once instead of serializing
        behind each other.  Only safe for reads of objects the caller
        knows are immutable while the ops are in flight — the serve
        page-fetch wave (epoch-versioned artifact objects) is the
        intended user."""
        fut = OpFuture()
        o = _Op(next(self._tid), pool, oid, op, offset, length, data,
                fut, pg_ps=pg_ps, args=args, unordered=unordered)
        # capture the frontend's ambient trace NOW: a queued op may
        # launch later from the dispatch thread, where the submitting
        # handler's scope is gone
        o.parent_ctx = current_trace()
        with self._lock:
            if self.osdmap.epoch > 0 and pool not in self.osdmap.pools:
                # pool does not exist in the current map: fail fast
                # instead of parking forever (ref: Objecter
                # _check_op_pool_dne)
                fut._complete(OSDOpReply(tid=o.tid, result=-2,
                                         errno_name="ENOENT"))
                return fut
            key = self._obj_key(o)
            if key is not None and key in self._obj_active:
                # an earlier op on this object is still outstanding:
                # hold ours back so completions stay in order
                self._obj_wait.setdefault(key, []).append(o)
                return fut
            if key is not None:
                self._obj_active[key] = o.tid
            self._launch(o)
        return fut

    @classmethod
    def _obj_key(cls, op: _Op):
        if op.unordered:
            return None
        return (op.pool, op.oid) if op.oid else None

    def _launch(self, o: _Op) -> None:
        self._calc_target(o)
        if o.target_osd < 0:
            self.homeless.append(o)
        else:
            self.in_flight[o.tid] = o
            self._send_op(o)

    def _complete_op(self, op: _Op, reply: OSDOpReply) -> None:
        """Complete + release the object's next queued op (lock held).
        Drains with a loop: a recursive single step strands waiters
        behind an op that completes without ever becoming active
        (e.g. ENOENT on a deleted pool)."""
        if op.span is not None:
            op.span.event("reply" if reply.result == 0
                          else f"error:{reply.errno_name}")
            self.tracer.finish(op.span)
            op.span = None
        op.future._complete(reply)
        key = self._obj_key(op)
        if key is None or self._obj_active.get(key) != op.tid:
            return
        del self._obj_active[key]
        q = self._obj_wait.get(key, [])
        while q:
            nxt = q.pop(0)
            if self.osdmap.epoch > 0 and \
                    nxt.pool not in self.osdmap.pools:
                nxt.future._complete(OSDOpReply(
                    tid=nxt.tid, result=-2, errno_name="ENOENT"))
                continue
            self._obj_active[key] = nxt.tid
            self._launch(nxt)
            break
        if not q:
            self._obj_wait.pop(key, None)

    def _send_op(self, op: _Op) -> None:
        op.attempts += 1
        args = op.args
        pool = self.osdmap.pools.get(op.pool)
        if pool is not None and getattr(pool, "snap_seq", 0) \
                and "snapc" not in args:
            # every op carries the client's SnapContext so the primary
            # COWs against the snapshot the CLIENT saw, even when the
            # OSD's map lags (ref: MOSDOp carries snapc; Objecter
            # fills it from the pool in _op_submit).  An explicit
            # snapc (self-managed snaps: the IoCtx's write context)
            # always wins — the pool map knows nothing about
            # self-managed snapids.
            args = dict(args)
            args["snapc"] = {"seq": pool.snap_seq,
                             "snaps": sorted(pool.snaps)}
        if op.trace is None and global_config()["blkin_trace_all"]:
            parent = op.parent_ctx
            # root a fresh trace, or continue the frontend's (RGW/MDS
            # request handlers scope theirs ambient) — either way the
            # objecter leg gets its OWN span and the wire carries a
            # child context, so resend attempts each show up as
            # distinct OSD spans under this one
            op.trace = child_of(parent) if parent else new_trace()
            op.span = self.tracer.start_span(
                op.trace, f"objecter_op:{op.op}")
            op.span.event(f"oid={op.oid}")
        if op.span is not None:
            op.span.event(
                f"send attempt={op.attempts} osd.{op.target_osd}")
        self.ms.connect(f"osd.{op.target_osd}").send_message(OSDOp(
            pgid=op.pg, oid=op.oid, op=op.op, tid=op.tid,
            epoch=self.osdmap.epoch, offset=op.offset,
            length=op.length, data=op.data, args=args,
            trace=child_of(op.trace)))

    def _handle_reply(self, msg: OSDOpReply) -> None:
        with self._lock:
            op = self.in_flight.get(msg.tid)
            if op is None:
                return
            if msg.errno_name == "ESTALE":
                # target wasn't primary (it may simply be behind on
                # maps): park + schedule a rescan so the op retries
                # even if no newer map reaches this client (ref: the
                # RETRY path in Objecter::handle_osd_op_reply :3547)
                del self.in_flight[op.tid]
                self.homeless.append(op)
                self._schedule_rescan()
                return
            del self.in_flight[op.tid]
            self._complete_op(op, msg)

    def _schedule_rescan(self, delay: float = 0.05) -> None:
        """Periodic retry for parked ops (the reference's tick_event).
        The interval doubles up to a cap and is jittered: many clients
        parked by the same outage must not re-probe the recovering
        primary in lockstep at fixed phases (the chaos harness's
        heal-at-the-wrong-phase schedules livelock exactly that)."""
        if getattr(self, "_rescan_timer", None) is not None:
            return

        def fire():
            with self._lock:
                self._rescan_timer = None
                # adopts + resends any homeless op whose map target
                # resolves (incl. the ESTALE case where the target is
                # unchanged but the OSD was behind on maps)
                self._scan_requests()
                if self.homeless:
                    self._schedule_rescan(min(delay * 2, 1.0))

        self._rescan_timer = threading.Timer(full_jitter(delay), fire)
        self._rescan_timer.daemon = True
        self._rescan_timer.start()

    # ---------------------------------------------------- mon commands
    def mon_command(self, cmd: dict, timeout: float = 30.0
                    ) -> tuple[int, str, object]:
        """Synchronous mon command round-trip.  EAGAIN (-11) answers
        are retried until the deadline: the reference MonClient
        resends commands after an election rather than surfacing the
        churn to every caller."""
        deadline = time.monotonic() + timeout
        # EAGAIN pacing: an election storm answers every resend with
        # -11; a fixed 0.1s retry re-probed in lockstep with the
        # churn (shared capped-exponential helper instead)
        backoff = Backoff(base_s=0.05, cap_s=1.0)
        while True:
            tid = next(self._tid)
            ev = threading.Event()
            slot: dict = {}
            with self._lock:
                self._pending_cmds[tid] = (ev, slot)
            self.ms.connect(self.mon).send_message(
                MMonCommand(tid=tid, cmd=cmd))
            if not self.wait_sync(
                    ev.is_set, max(0.1, deadline - time.monotonic()),
                    ev=ev):
                raise TimeoutError(
                    f"mon command {cmd.get('prefix')} timed out")
            if slot["r"] == -11:
                if time.monotonic() < deadline:
                    if self.pump_hook is not None:
                        self.pump_hook()   # pump-mode: drive the
                        # election forward instead of sleeping blind
                        time.sleep(min(0.01, backoff.next_delay()))
                    else:
                        backoff.sleep()
                    continue
            return slot["r"], slot["outs"], slot["outb"]

    def _handle_command_ack(self, msg: MMonCommandAck) -> bool:
        entry = self._pending_cmds.pop(msg.tid, None)
        if entry is None:
            return False
        ev, slot = entry
        slot["r"], slot["outs"], slot["outb"] = \
            msg.result, msg.outs, msg.outb
        ev.set()
        return True
