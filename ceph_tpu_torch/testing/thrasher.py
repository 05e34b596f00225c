"""Thrashers: randomized fault injection against a MiniCluster.

Port of the qa thrasher loop (ref: qa/tasks/ceph_manager.py:98
OSDThrasher: choose_action kill/revive/out/in with min-in guards,
interleaved with client IO, then heal and verify).  Deterministic: a
seeded RNG picks actions, the harness pumps the network and drives
heartbeat/mon ticks on simulated time.

The port's copy of `ceph_tpu.testing.thrasher`: `OSDThrasher` with its
shard-EIO leg, and `MDSThrasher` (kill a rank, drive the mon's sim clock
past the beacon grace until a standby has taken over).
"""
from __future__ import annotations

import random
import time as _time

from ..common.options import global_config
from .cluster import MiniCluster


class OSDThrasher:
    """`ec_pools` + `rados` arm the erasure-coded legs: chunk EIO
    injection (`objectstore_debug_inject_read_err` applied to EC
    shard reads — exercises the primary's remaining-shard retry and
    scrub's shard rebuild) joins the action mix, and min-guards should
    be sized so >= k shards of every stripe stay live (the caller
    knows its k+m)."""

    def __init__(self, cluster: MiniCluster, seed: int = 0,
                 min_in: int = 3, min_live: int = 3,
                 ec_pools=(), rados=None):
        self.c = cluster
        self.rng = random.Random(seed)
        self.min_in = min_in
        self.min_live = min_live
        self.all_osds = sorted(cluster.osds)
        self.dead: set[int] = set()
        self.out: set[int] = set()
        self.now = 10_000.0
        self.log: list[str] = []
        #: EC pool names eligible for shard-EIO injection
        self.ec_pools = list(ec_pools)
        self.r = rados
        #: live injections: (osd, cid, shard ObjectId)
        self.injected: list[tuple] = []
        #: objectstore_debug_inject_read_err value to restore after
        #: the EIO leg (None = we never flipped it)
        self._eio_flag_was: bool | None = None

    # ------------------------------------------------------------ state
    def _live(self) -> list[int]:
        return [o for o in self.all_osds if o not in self.dead]

    def _in(self) -> list[int]:
        return [o for o in self.all_osds if o not in self.out]

    def _tick_rounds(self, n: int = 3) -> None:
        """Advance simulated time in sub-grace steps so failure
        detection works the way production cadence does."""
        grace = global_config()["osd_heartbeat_grace"]
        for _ in range(n):
            self.now += grace / 2 + 1
            self.c.tick(self.now)

    # ---------------------------------------------------------- actions
    def kill_osd(self, osd: int | None = None) -> None:
        live = [o for o in self._live()]
        if len(live) <= self.min_live:
            return
        osd = osd if osd is not None else self.rng.choice(live)
        if osd in self.dead:
            return
        self.log.append(f"kill osd.{osd}")
        self.c.kill_osd(osd)
        self.dead.add(osd)
        self._tick_rounds()      # peers detect + mon marks down

    def revive_osd(self, osd: int | None = None) -> None:
        if not self.dead:
            return
        osd = osd if osd is not None else self.rng.choice(
            sorted(self.dead))
        self.log.append(f"revive osd.{osd}")
        self.c.revive_osd(osd)
        self.dead.discard(osd)
        if not self.c.threaded:
            self.c.pump()
        self._tick_rounds(1)

    def out_osd(self, osd: int | None = None) -> None:
        candidates = [o for o in self._in()]
        if len(candidates) <= self.min_in:
            return
        osd = osd if osd is not None else self.rng.choice(candidates)
        self.log.append(f"out osd.{osd}")
        self.c.mon.handle_command({"prefix": "osd out", "ids": [osd]})
        self.out.add(osd)
        if not self.c.threaded:
            self.c.pump()

    def in_osd(self, osd: int | None = None) -> None:
        candidates = sorted(o for o in self.out if o not in self.dead)
        if not candidates:
            return
        osd = osd if osd is not None else self.rng.choice(candidates)
        self.log.append(f"in osd.{osd}")
        self.c.mon.handle_command({"prefix": "osd in", "ids": [osd]})
        self.out.discard(osd)
        if not self.c.threaded:
            self.c.pump()

    def inject_shard_eio(self) -> None:
        """Mark one random EC chunk on a live OSD to fail reads with
        EIO (the ceph_manager inject_* analogue for shard read
        errors).  The victim shard's chunk read then errors through
        ECPGShard.handle_sub_read and the reading primary must
        reconstruct from the remaining shards."""
        if not self.ec_pools or self.r is None:
            return
        # the store only honors EIO marks while the dev flag is set —
        # an injection without it would be a silent no-op and the
        # thrash run would claim EIO coverage it never exercised
        cfg = global_config()
        if not cfg["objectstore_debug_inject_read_err"]:
            if self._eio_flag_was is None:
                self._eio_flag_was = False
            cfg.set("objectstore_debug_inject_read_err", True)
        from ..osd.ec_backend import ECPGShard, pg_cid
        from ..store import ObjectId
        pid = self.r.pool_lookup(self.rng.choice(self.ec_pools))
        live = list(self._live())
        self.rng.shuffle(live)
        for osd in live:
            d = self.c.osds.get(osd)
            if d is None:
                continue
            cands = [(pg, st) for pg, st in sorted(d.pgs.items())
                     if pg.pool == pid and
                     isinstance(st.shard, ECPGShard)]
            self.rng.shuffle(cands)
            for pg, st in cands:
                oids = st.shard.objects()
                if not oids:
                    continue
                oid = self.rng.choice(sorted(oids))
                st.shard.inject_read_err(oid)
                self.injected.append(
                    (osd, pg_cid(pg),
                     ObjectId(oid, shard=st.shard.shard)))
                self.log.append(f"eio osd.{osd} {pg} {oid}")
                return

    def clear_shard_eio(self) -> None:
        """Lift every live injection (stores survive kill/revive, so
        the exact marked ObjectIds clear even after remaps), and
        restore the dev flag if the thrasher flipped it."""
        while self.injected:
            osd, cid, soid = self.injected.pop()
            d = self.c.osds.get(osd)
            store = d.store if d is not None \
                else self.c._stores.get(osd)
            if store is not None:
                store.clear_read_err(cid, soid)
        if self._eio_flag_was is not None:
            global_config().set("objectstore_debug_inject_read_err",
                                self._eio_flag_was)
            self._eio_flag_was = None

    ACTIONS = ("kill_osd", "revive_osd", "out_osd", "in_osd",
               "inject_shard_eio", "clear_shard_eio")

    def choose_action(self) -> str:
        """(ref: ceph_manager.py choose_action weights)."""
        weights = {"kill_osd": 3, "revive_osd": 3,
                   "out_osd": 2, "in_osd": 2}
        if self.ec_pools:
            weights["inject_shard_eio"] = 1
            weights["clear_shard_eio"] = 1
        names = list(weights)
        return self.rng.choices(names,
                                weights=[weights[n] for n in names])[0]

    def do_thrash(self, rounds: int, between=None) -> None:
        """`between(i)` runs client IO between actions."""
        for i in range(rounds):
            getattr(self, self.choose_action())()
            if between is not None:
                between(i)

    # ------------------------------------------------------------- heal
    def heal(self, timeout_rounds: int = 50) -> None:
        """Revive + mark in everything, lift EIO injections, wait
        until no PG is recovering (ref: thrasher's final
        do_join/wait_for_clean)."""
        self.clear_shard_eio()
        for osd in sorted(self.dead):
            self.revive_osd(osd)
        for osd in sorted(self.out):
            self.in_osd(osd)
        for _ in range(timeout_rounds):
            if self.c.threaded:
                _time.sleep(0.02)   # let messenger threads drain
            else:
                self.c.pump()
            if all(d.pgs_recovering() == 0
                   for d in self.c.osds.values()):
                return
            self._tick_rounds(1)   # unwedge map-waiting recoveries
        raise TimeoutError(
            f"cluster never went clean; log: {self.log}")


class MDSThrasher:
    """Kill/revive MDS ranks under live metadata load (ref:
    qa/tasks/mds_thrash.py MDSThrasher): each round hard-kills an
    active rank, backfills the standby pool, drives mon ticks past
    ``mds_beacon_grace`` on simulated time until the monitor promotes
    a standby through replay to active, and verifies clients keep
    serving.  Requires a threaded MiniCluster with beaconing MDS
    daemons (cluster.start_mds / start_mds_standby)."""

    def __init__(self, cluster: MiniCluster, seed: int = 0,
                 now: float = 50_000.0):
        self.c = cluster
        self.rng = random.Random(seed)
        # beacons sent BEFORE the first simulated tick are stamped
        # with the mon's real clock (_time.monotonic() = host uptime);
        # a sim seed behind that runs mon time backward, so a dead
        # gid's last stamp stays "fresh" forever and failover never
        # fires (bit at host uptime > 50000s).  Only forward jumps
        # are safe: seed at whichever clock is further along.
        self.now = max(now, _time.monotonic() + 1.0)
        self.log: list[str] = []

    def _active_ranks(self) -> list[int]:
        return [r for r, i in self.c.fsmap().ranks.items()
                if i.state == "active"]

    def tick_grace(self, rounds: int = 3) -> None:
        """Advance simulated time past the beacon grace in sub-grace
        steps with real sleeps between jumps: live daemons' beacons
        (stamped with the mon's sim clock) land inside every window,
        so only genuinely dead gids fall past the grace — the OSD
        thrasher's grace/2 cadence applied to beacons."""
        grace = global_config()["mds_beacon_grace"]
        interval = global_config()["mds_beacon_interval"]
        for _ in range(rounds):
            self.now += grace / 2 + 0.1
            self.c.tick(self.now)
            _time.sleep(max(0.05, 2 * interval))
            self.c.tick(self.now)

    def kill_rank(self, rank: int | None = None) -> int:
        active = self._active_ranks()
        if not active:
            raise RuntimeError("no active rank to kill")
        rank = rank if rank is not None else self.rng.choice(active)
        self.log.append(f"kill mds.{rank}")
        self._killed_gid = self.c.fsmap().ranks[rank].gid
        self.c.adopt_promoted()
        self.c.kill_mds(rank)
        return rank

    def backfill_standby(self) -> None:
        self.log.append("add standby")
        self.c.start_mds_standby()

    def wait_takeover(self, rank: int, timeout_rounds: int = 40,
                      old_gid: int | None = None) -> None:
        """Drive ticks until the rank is active under a NEW gid (the
        dead holder's entry stays `active` until its beacon lapses,
        so plain active-ness is not takeover)."""
        if old_gid is None:
            old_gid = getattr(self, "_killed_gid", None)
        interval = global_config()["mds_beacon_interval"]
        for _ in range(timeout_rounds):
            info = self.c.fsmap().ranks.get(rank)
            if info is not None and info.state == "active" and \
                    (old_gid is None or info.gid != old_gid):
                self.c.adopt_promoted()
                return
            self.tick_grace(1)
            _time.sleep(max(0.05, interval))
        raise TimeoutError(
            f"mds.{rank} takeover never completed; log: {self.log}")

    def do_thrash(self, rounds: int, between=None) -> None:
        """`between(i)` runs client metadata IO between kills."""
        for i in range(rounds):
            if not self.c.standbys:
                self.backfill_standby()
                _time.sleep(2 * global_config()
                            ["mds_beacon_interval"])
            rank = self.kill_rank()
            self.wait_takeover(rank)
            if between is not None:
                between(i)
