"""FSMap: the filesystem's MDS cluster map.

The src/mds/FSMap.h analogue, reduced to one filesystem: which daemon
(gid) holds each rank and in what state, plus the standby pool the
monitor promotes from.  Rank states walk the takeover ladder

    standby -> replay -> resolve -> active

(ref: MDSMap::DAEMON_STATE STATE_STANDBY/STATE_REPLAY/STATE_RESOLVE/
STATE_ACTIVE); a rank whose daemon's beacon lapsed past
``mds_beacon_grace`` is marked ``failed`` until a standby takes it
over.  The map is a Paxos-committed value (see mon/mds_monitor.py)
published to subscribers as MFSMap incref epochs, exactly the osdmap
subscription shape.

The port's copy of `ceph_tpu.mon.fsmap`: the same wire structs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..msg.encoding import register_struct

#: rank/daemon states (ref: src/mds/MDSMap.h DAEMON_STATE)
STATE_STANDBY = "standby"
STATE_REPLAY = "replay"
STATE_RESOLVE = "resolve"
STATE_ACTIVE = "active"
STATE_FAILED = "failed"


@dataclass
class MDSInfo:
    """One daemon's slot in the map (ref: MDSMap::mds_info_t)."""
    gid: int = 0
    name: str = ""           # messenger entity ("mds.0", "mds.sb1")
    rank: int = -1
    state: str = STATE_STANDBY
    #: standby-replay target (-1 = plain standby)
    standby_replay_rank: int = -1


@dataclass
class FSMap:
    """(ref: src/mds/FSMap.h, one-filesystem reduction)."""
    epoch: int = 0
    #: rank -> holder; a ``failed`` entry keeps the rank visible with
    #: gid 0 until a standby is assigned
    ranks: dict = field(default_factory=dict)
    #: gid -> MDSInfo waiting for promotion
    standbys: dict = field(default_factory=dict)

    # ------------------------------------------------------- queries
    def rank_state(self, rank: int) -> str | None:
        info = self.ranks.get(rank)
        return info.state if info is not None else None

    def rank_gid(self, rank: int) -> int:
        info = self.ranks.get(rank)
        return info.gid if info is not None else 0

    def is_active(self, rank: int) -> bool:
        return self.rank_state(rank) == STATE_ACTIVE

    def gid_info(self, gid: int) -> MDSInfo | None:
        for info in self.ranks.values():
            if info.gid == gid:
                return info
        return self.standbys.get(gid)

    def live_gids(self) -> set[int]:
        """gids the monitor expects beacons from."""
        out = {i.gid for i in self.ranks.values()
               if i.state != STATE_FAILED and i.gid}
        out.update(self.standbys)
        return out

    def pick_standby(self, rank: int) -> MDSInfo | None:
        """Promotion choice: a standby-replay follower of this rank
        wins (warm journal cursor), else any standby — lowest gid for
        determinism (ref: FSMap::find_replacement_for)."""
        best = None
        for gid in sorted(self.standbys):
            info = self.standbys[gid]
            if info.standby_replay_rank == rank:
                return info
            if best is None and info.standby_replay_rank < 0:
                best = info
        if best is None and self.standbys:
            best = self.standbys[min(self.standbys)]
        return best


register_struct(MDSInfo)
register_struct(FSMap)
