"""Paxos commit pipeline + PaxosService base.

The reference mon serializes every state change through Paxos
(ref: src/mon/Paxos.h:174 — begin/accept/commit over the quorum, each
committed value a MonitorDBStore transaction at version n), and every
map service is a PaxosService that accumulates a *pending* delta,
encodes it into a proposal, and refreshes its in-memory state from the
store after commit (ref: src/mon/PaxosService.h:30).

Mon-lite runs a quorum of one: the proposal path keeps the exact
begin -> commit -> refresh shape (values land in the store under the
"paxos" prefix at monotonically increasing versions, first/last
committed markers maintained) so a replicated accept phase can slot
between begin and commit without touching the services.

The port's copy of `ceph_tpu.mon.paxos`.
"""
from __future__ import annotations

from ..common.log import dout
from ..common.racecheck import shared_state
from .store import MonitorStore, StoreTransaction

PAXOS_PREFIX = "paxos"


# Paxos has no lock of its own: every entry runs under the owning
# Monitor's lock (dispatch and tick take it).  The sanitizer
# checks that contract — a bare-threaded caller mutating the commit
# pipeline is exactly the fork bug class this guards against.
@shared_state(only=("first_committed", "last_committed",
                    "_inflight", "_pending"),
              mutating=("_pending",))
class Paxos:
    """Commit log with optional quorum replication
    (ref: src/mon/Paxos.h:174).

    Standalone (quorum of one): `propose` commits synchronously, as
    round-1.  In a quorum, the LEADER drives
    begin -> majority accept -> commit: `propose_async` queues the
    value, MPaxosBegin fans to peons, peon accepts count toward the
    majority, the leader commits + broadcasts MPaxosCommit, and the
    completion callback fires after local commit.  One proposal is in
    flight at a time (the reference's is_updating plug).  Values accept
    only after commit reaches a peon, so an unacked client command can
    be lost on leader death but an acked one never is.
    """

    def __init__(self, store: MonitorStore, keep_versions: int = 500):
        self.store = store
        self.keep_versions = keep_versions
        self.first_committed = store.get_int(PAXOS_PREFIX,
                                             "first_committed", 0)
        self.last_committed = store.get_int(PAXOS_PREFIX,
                                            "last_committed", 0)
        # quorum wiring (set by the Monitor after election)
        self.rank = 0
        self.epoch = 0                    # election epoch guard
        self.quorum: list[int] = [0]      # voting members
        self.all_ranks: list[int] = [0]   # commit audience (everyone)
        self.send = None          # (peer_rank, msg) -> None
        self.on_peon_commit = None   # peon hook: refresh services
        self._pending: list = []     # [(tx_bytes, on_commit)]
        self._inflight = None        # [version, tx_bytes, acks:set, cb]

    @property
    def _is_solo(self) -> bool:
        return len(self.quorum) <= 1 or self.send is None

    def _commit_value(self, v: int, tx_bytes: bytes) -> None:
        tx = StoreTransaction.decode(tx_bytes)
        meta = StoreTransaction()
        meta.put(PAXOS_PREFIX, v, tx_bytes)      # the decided value
        meta.put(PAXOS_PREFIX, "last_committed", v)
        if self.first_committed == 0:
            self.first_committed = 1
            meta.put(PAXOS_PREFIX, "first_committed", 1)
        # apply the value itself atomically with the commit record
        meta.ops.extend(tx.ops)
        self.store.apply_transaction(meta)
        self.last_committed = v
        self._maybe_trim()

    def propose(self, tx: StoreTransaction) -> int:
        """Synchronous commit — standalone mode only
        (ref: Paxos.cc begin/commit_start collapsed)."""
        assert self._is_solo, "sync propose needs a quorum of one"
        v = self.last_committed + 1
        self._commit_value(v, tx.encode())
        return v

    # ----------------------------------------------------- leader side
    def propose_async(self, tx: StoreTransaction, on_commit) -> None:
        """Queue a value; on_commit(version) fires after local commit
        (immediately in standalone mode)."""
        self._pending.append((tx.encode(), on_commit))
        self._maybe_begin()

    def _maybe_begin(self) -> None:
        if self._inflight is not None or not self._pending:
            return
        tx_bytes, cb = self._pending.pop(0)
        v = self.last_committed + 1
        if self._is_solo:
            self._commit_value(v, tx_bytes)
            cb(v)
            self._maybe_begin()
            return
        from ..msg.messages import MPaxosBegin
        self._inflight = [v, tx_bytes, {self.rank}, cb]
        dout("mon", 10).write("paxos %d: begin v%d -> %s", self.rank,
                              v, self.quorum)
        for r in self.quorum:
            if r != self.rank:
                self.send(r, MPaxosBegin(version=v, tx=tx_bytes,
                                         epoch=self.epoch))

    def handle_accept(self, msg) -> None:
        """(leader) count a peon accept (ref: Paxos.cc handle_accept).
        Epoch-guarded: accepts from a previous reign never count toward
        this one's majority."""
        fl = self._inflight
        if fl is None or msg.version != fl[0] or \
                msg.epoch != self.epoch:
            return
        fl[2].add(msg.rank)
        # majority of ALL mons, not just the (possibly sub-full)
        # election quorum: an acked commit must survive any later
        # majority (the reference waits for the full quorum)
        if len(fl[2]) < len(self.all_ranks) // 2 + 1:
            return
        from ..msg.messages import MPaxosCommit
        v, tx_bytes, _acks, cb = fl
        self._inflight = None
        self._commit_value(v, tx_bytes)
        # commits go to EVERY mon (late quorum ackers included); only
        # the accept votes are quorum-scoped
        for r in self.all_ranks:
            if r != self.rank:
                self.send(r, MPaxosCommit(version=v, tx=tx_bytes,
                                          epoch=self.epoch))
        cb(v)
        self._maybe_begin()

    def abort_inflight(self) -> None:
        """Election/quorum change: drop queued + in-flight proposals
        (their commands never acked; clients retry)."""
        self._inflight = None
        self._pending = []

    # ------------------------------------------------------- peon side
    def handle_begin(self, msg, from_rank: int) -> None:
        """(peon) accept the value (ref: Paxos.cc handle_begin).
        Values are durable only at commit in this simplified pipeline;
        a deposed leader's begins (stale epoch) are never acked, so it
        cannot assemble a majority after the election.  (The residual
        window — accepts already in flight when the election fires —
        is closed in the reference by the full collect/lease phases.)"""
        from ..msg.messages import MPaxosAccept
        if msg.epoch != self.epoch:
            return
        self.send(from_rank, MPaxosAccept(version=msg.version,
                                          rank=self.rank,
                                          epoch=self.epoch))

    def handle_commit(self, msg) -> None:
        """(peon) apply a committed value in order
        (ref: Paxos.cc handle_commit)."""
        if msg.epoch < self.epoch:
            return               # deposed leader's commit
        if msg.version != self.last_committed + 1:
            if msg.version <= self.last_committed:
                return           # duplicate
            # gap: the sync path refills us
            return
        self._commit_value(msg.version, msg.tx)
        if self.on_peon_commit is not None:
            self.on_peon_commit()

    # ------------------------------------------------------- catch-up
    def sync_reply(self, from_version: int) -> list:
        """Leader: committed values a lagging peer needs — or a full
        store snapshot when the gap predates the trim window
        (ref: Paxos.cc share_state; Monitor.cc full sync)."""
        from ..msg.messages import MPaxosCommit, MPaxosStoreSync
        if from_version + 1 < self.first_committed:
            return [MPaxosStoreSync(
                data=self.store.export_data(),
                first_committed=self.first_committed,
                last_committed=self.last_committed)]
        out = []
        for v in range(max(from_version + 1, self.first_committed),
                       self.last_committed + 1):
            blob = self.store.get(PAXOS_PREFIX, v)
            if blob is not None:
                out.append(MPaxosCommit(version=v, tx=blob,
                                        epoch=self.epoch))
        return out

    def apply_store_sync(self, msg) -> None:
        """Peon: adopt a full store snapshot."""
        self.store.import_data(msg.data)
        self.first_committed = msg.first_committed
        self.last_committed = msg.last_committed
        if self.on_peon_commit is not None:
            self.on_peon_commit()

    def _maybe_trim(self) -> None:
        """(ref: Paxos.cc trim)."""
        if self.last_committed - self.first_committed <= self.keep_versions:
            return
        new_first = self.last_committed - self.keep_versions
        tx = StoreTransaction()
        tx.erase_range(PAXOS_PREFIX, self.first_committed, new_first)
        tx.put(PAXOS_PREFIX, "first_committed", new_first)
        self.store.apply_transaction(tx)
        self.first_committed = new_first


class PaxosService:
    """A map service over Paxos (ref: src/mon/PaxosService.h:30).

    Subclasses implement create_initial / update_from_paxos /
    create_pending / encode_pending and call propose_pending when a
    prepare_* handler mutated the pending state.
    """

    def __init__(self, name: str, paxos: Paxos):
        self.service_name = name
        self.paxos = paxos
        self.store = paxos.store
        self.have_pending = False

    # -- versioned store helpers (PaxosService.h:690 get/put_version) ----
    def get_last_committed(self) -> int:
        return self.store.get_int(self.service_name, "last_committed", 0)

    def get_first_committed(self) -> int:
        return self.store.get_int(self.service_name, "first_committed", 0)

    def get_version(self, key: str | int):
        return self.store.get(self.service_name, key)

    def put_version(self, tx: StoreTransaction, key: str | int,
                    value) -> None:
        tx.put(self.service_name, key, value)

    # -- subclass interface ---------------------------------------------
    def create_initial(self) -> None:
        raise NotImplementedError

    def update_from_paxos(self) -> None:
        raise NotImplementedError

    def create_pending(self) -> None:
        raise NotImplementedError

    def encode_pending(self, tx: StoreTransaction) -> None:
        raise NotImplementedError

    # -- lifecycle -------------------------------------------------------
    def init(self) -> None:
        """Bootstrap or catch up, then open a pending period
        (ref: PaxosService::_active)."""
        if self.get_last_committed() == 0:
            self.create_initial()
            tx = StoreTransaction()
            self.encode_pending(tx)
            self.paxos.propose(tx)
        self.update_from_paxos()
        self.create_pending()
        self.have_pending = True

    def propose_pending(self, on_done=None) -> None:
        """Commit the pending delta and refresh; `on_done()` fires
        after the commit lands (synchronously in standalone mode)
        (ref: PaxosService::propose_pending)."""
        assert self.have_pending
        tx = StoreTransaction()
        self.encode_pending(tx)
        if tx.empty:
            if on_done is not None:
                on_done()
            return

        def committed(v):
            dout("mon", 10).write("%s committed v%d",
                                  self.service_name, v)
            self.update_from_paxos()
            self.create_pending()
            if on_done is not None:
                on_done()

        self.paxos.propose_async(tx, committed)
