"""MDSMonitor: the fsmap PaxosService — beacons, failover, promotion.

Port of the reference's MDS cluster management (ref:
src/mon/MDSMonitor.cc): daemons announce themselves with MMDSBeacon,
the monitor tracks per-gid beacon stamps (volatile, like
``last_beacon``), commits FSMap epochs through Paxos, and on a beacon
lapse past ``mds_beacon_grace`` marks the rank failed and promotes a
standby into ``replay`` (ref: MDSMonitor::tick + maybe_promote_standby
/ FSMap::find_replacement_for).  The promoted daemon replays the dead
rank's journal and walks replay -> resolve -> active via beacons, each
hop a committed epoch the subscribers see.

The port's copy of `ceph_tpu.mon.mds_monitor`.
"""
from __future__ import annotations

import copy

from ..common.log import dout
from ..msg import encoding as wire
from .fsmap import (FSMap, MDSInfo, STATE_ACTIVE, STATE_FAILED,
                    STATE_REPLAY, STATE_STANDBY)
from .paxos import Paxos, PaxosService
from .store import StoreTransaction

#: fsmap history kept in the store (the reference trims via
#: PaxosService::maybe_trim; fsmaps are tiny so a short tail is fine)
KEEP_EPOCHS = 100


class MDSMonitor(PaxosService):
    """(ref: src/mon/MDSMonitor.h)."""

    def __init__(self, paxos: Paxos):
        super().__init__("fsmap", paxos)
        self.fsmap = FSMap()
        self.pending: FSMap | None = None
        self._bootstrap = False
        #: gid -> last beacon stamp (mon clock; volatile like the
        #: reference's last_beacon map — a failed-over mon repopulates
        #: it within one beacon interval)
        self._beacon: dict[int, float] = {}

    # ------------------------------------------------------- paxos hooks
    def create_initial(self) -> None:
        self.pending = FSMap(epoch=1)
        # the initial (empty) map MUST land in the store: an empty
        # encode would leave last_committed at 0 and every reboot
        # would re-propose, forking paxos history on revived mons
        self._bootstrap = True

    def encode_pending(self, tx: StoreTransaction) -> None:
        if self._is_pending_empty() and not self._bootstrap:
            return
        self._bootstrap = False
        e = self.pending.epoch
        self.put_version(tx, f"fsmap_{e}", wire.encode(self.pending))
        self.put_version(tx, "last_committed", e)
        if not self.get_first_committed():
            self.put_version(tx, "first_committed", e)
        first = self.get_first_committed() or 1
        if e - first > KEEP_EPOCHS:
            new_first = e - KEEP_EPOCHS
            for v in range(first, new_first):
                tx.erase(self.service_name, f"fsmap_{v}")
            self.put_version(tx, "first_committed", new_first)

    def update_from_paxos(self) -> None:
        e = self.get_last_committed()
        if e and e != self.fsmap.epoch:
            blob = self.get_version(f"fsmap_{e}")
            if blob is not None:
                self.fsmap = wire.decode(blob)

    def create_pending(self) -> None:
        self.pending = copy.deepcopy(self.fsmap)
        self.pending.epoch = self.fsmap.epoch + 1

    def _is_pending_empty(self) -> bool:
        if self.pending is None:
            return True
        return (self.pending.ranks == self.fsmap.ranks and
                self.pending.standbys == self.fsmap.standbys)

    # ---------------------------------------------------------- beacons
    def note_beacon(self, gid: int, now: float) -> None:
        self._beacon[gid] = now

    def beacon_stale(self, gid: int, now: float, grace: float) -> bool:
        last = self._beacon.get(gid)
        if last is None:
            # first sighting since this monitor took over (restart or
            # fresh leader): unknown must not read as fresh-forever —
            # start the gid's grace window NOW, so a genuinely dead
            # holder still fails one grace later (ref: MDSMonitor
            # seeding last_beacon for known gids on election win)
            self._beacon[gid] = now
            return False
        return now - last > grace

    def stage_beacon(self, msg, now: float):
        """Stage the fsmap consequences of one beacon (runs inside the
        monitor's serialized change queue against ``pending``).
        Returns (r, outs, outb): r=1 means nothing changed — no
        proposal (ref: MDSMonitor::preprocess_beacon fast path vs
        prepare_beacon)."""
        p = self.pending
        info = MDSInfo(gid=msg.gid, name=msg.name or msg.src,
                       rank=msg.rank, state=msg.state,
                       standby_replay_rank=msg.standby_replay_rank)
        if msg.state == STATE_STANDBY:
            if any(i.gid == msg.gid and i.state != STATE_FAILED
                   for i in p.ranks.values()):
                # in-flight standby beacon from a gid we JUST assigned
                # a rank (it has not seen the map yet): must not
                # demote its own assignment — the fsmap reply tells
                # it to promote.  (A genuinely restarted daemon comes
                # back with a fresh gid, so this is never a restart.)
                return (1, "", None)
            if p.standbys.get(msg.gid) == info:
                return (1, "", None)
            p.standbys[msg.gid] = info
            return (0, "", None)
        # rank-holding states (replay/resolve/active)
        if msg.rank < 0:
            return (1, "", None)
        cur = p.ranks.get(msg.rank)
        if cur is not None and cur.gid and cur.gid != msg.gid and \
                cur.state != STATE_FAILED and \
                not self.beacon_stale(cur.gid, now, self._grace()):
            # the rank is live-held by someone else: refuse — the
            # sender stands down when it sees the map (split-brain
            # fence, ref: MDSMonitor rejecting a boot beacon for a
            # rank with a live daemon)
            return (1, "", None)
        if cur == info:
            return (1, "", None)
        p.standbys.pop(msg.gid, None)
        p.ranks[msg.rank] = info
        dout("mon", 1).write("mdsmon: mds.%d (gid %d) -> %s",
                             msg.rank, msg.gid, msg.state)
        return (0, "", None)

    def _grace(self) -> float:
        from ..common.options import global_config
        return global_config()["mds_beacon_grace"]

    def stage_failures(self, now: float):
        """Tick half: fail ranks whose beacon lapsed, drop dead
        standbys, promote standbys into failed ranks (ref:
        MDSMonitor::tick).  Returns (r, outs, outb); r=1 = no change."""
        p = self.pending
        grace = self._grace()
        changed = False
        for rank, info in sorted(p.ranks.items()):
            if info.state == STATE_FAILED or not info.gid:
                continue
            if self.beacon_stale(info.gid, now, grace):
                dout("mon", 1).write(
                    "mdsmon: mds.%d (gid %d) beacon lapsed, marking "
                    "rank failed", rank, info.gid)
                p.ranks[rank] = MDSInfo(rank=rank, state=STATE_FAILED)
                self._beacon.pop(info.gid, None)
                changed = True
        for gid in list(p.standbys):
            if self.beacon_stale(gid, now, grace):
                del p.standbys[gid]
                self._beacon.pop(gid, None)
                changed = True
        changed |= self._promote(p, now)
        return (0, "", None) if changed else (1, "", None)

    def _promote(self, p: FSMap, now: float | None = None) -> bool:
        """Assign standbys to failed ranks in state ``replay``; the
        daemon sees the assignment on its next beacon reply / fsmap
        push and starts journal replay."""
        changed = False
        for rank, info in sorted(p.ranks.items()):
            if info.state != STATE_FAILED:
                continue
            sb = p.pick_standby(rank)
            if sb is None:
                continue
            del p.standbys[sb.gid]
            p.ranks[rank] = MDSInfo(gid=sb.gid, name=sb.name,
                                    rank=rank, state=STATE_REPLAY)
            if now is not None:
                # fresh grace window: the promotee has a journal
                # replay to run before its first rank beacon
                self._beacon[sb.gid] = now
            dout("mon", 1).write(
                "mdsmon: promoting standby %s (gid %d) -> mds.%d "
                "replay", sb.name, sb.gid, rank)
            changed = True
        return changed

    # --------------------------------------------------------- commands
    def _dump(self) -> dict:
        m = self.fsmap
        return {
            "epoch": m.epoch,
            "ranks": {r: {"gid": i.gid, "name": i.name,
                          "state": i.state}
                      for r, i in sorted(m.ranks.items())},
            "standbys": [{"gid": g, "name": i.name,
                          "standby_replay_rank": i.standby_replay_rank}
                         for g, i in sorted(m.standbys.items())],
        }

    def preprocess_command(self, cmdmap: dict):
        prefix = cmdmap.get("prefix", "")
        if prefix in ("fs status", "mds stat", "fs dump"):
            m = self.fsmap
            n_active = sum(1 for i in m.ranks.values()
                           if i.state == STATE_ACTIVE)
            outs = (f"e{m.epoch}: {n_active}/{len(m.ranks)} up, "
                    f"{len(m.standbys)} standby")
            return 0, outs, self._dump()
        return None

    def prepare_command(self, cmdmap: dict):
        prefix = cmdmap.get("prefix", "")
        if prefix == "mds fail":
            rank = int(cmdmap.get("rank", -1))
            info = self.pending.ranks.get(rank)
            if info is None:
                return -2, f"rank {rank} does not exist", None
            if info.state == STATE_FAILED:
                return 1, f"rank {rank} already failed", None
            self.pending.ranks[rank] = MDSInfo(rank=rank,
                                               state=STATE_FAILED)
            self._beacon.pop(info.gid, None)
            self._promote(self.pending)
            return 0, f"failed mds.{rank}", None
        return -2, f"unknown command {prefix!r}", None
