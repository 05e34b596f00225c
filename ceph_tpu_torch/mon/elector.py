"""Elector: rank-based monitor leader election.

Simplified port of src/mon/Elector.{h,cc}: the mon with the lowest
rank among responsive peers wins.  A mon starts (or restarts) an
election by bumping the election epoch and proposing itself; every mon
acks the lowest-ranked proposer it has seen in the current epoch; a
proposer holding acks from a majority (counting itself) declares
victory and broadcasts the quorum.  Re-election triggers when the
leader's lease goes stale (Monitor.tick) or a peer proposes with a
newer epoch.

The port's copy of `ceph_tpu.mon.elector`, whole: the lowest-rank win,
the epoch bump, the majority victory, the counter-candidacy to every
rank, the abdication of an outranked winner and the late-ack expansion.
"""
from __future__ import annotations

from typing import Callable

from ..common.log import dout
from ..msg.messages import MMonElection


class Elector:
    def __init__(self, rank: int, ranks: list[int],
                 send: Callable[[int, object], None],
                 on_win: Callable[[int, list[int]], None],
                 on_lose: Callable[[int, int, list[int]], None]):
        self.rank = rank
        self.ranks = sorted(ranks)         # all mon ranks incl. self
        self.send = send                   # (peer_rank, msg)
        self.on_win = on_win               # (epoch, quorum)
        self.on_lose = on_lose             # (epoch, leader, quorum)
        self.epoch = 0
        self.electing = False
        self.acked_me: set[int] = set()
        self.leader: int | None = None
        self.quorum: list[int] = []

    @property
    def majority(self) -> int:
        return len(self.ranks) // 2 + 1

    # ------------------------------------------------------------ start
    def start(self) -> None:
        """Propose ourselves (ref: Elector::start)."""
        self.epoch += 1
        self.electing = True
        self.leader = None
        self.acked_me = {self.rank}
        dout("mon", 5).write("elector %d: starting election e%d",
                             self.rank, self.epoch)
        for r in self.ranks:
            if r != self.rank:
                self.send(r, MMonElection(op="propose",
                                          epoch=self.epoch,
                                          rank=self.rank))
        self._check_win()

    # ---------------------------------------------------------- handlers
    def handle(self, msg: MMonElection) -> None:
        if msg.op == "propose":
            self._handle_propose(msg)
        elif msg.op == "ack":
            self._handle_ack(msg)
        elif msg.op == "victory":
            self._handle_victory(msg)

    def _handle_propose(self, msg: MMonElection) -> None:
        """(ref: Elector::handle_propose — defer to lower rank,
        counter-propose otherwise).  Async delivery can let two
        proposers each collect a majority in one epoch (a winner's
        victory racing a late ack); conflicts are resolved by epoch
        bumps — a standing leader outranked by a proposal abdicates
        into a fresh epoch, whose single victory supersedes both."""
        if msg.epoch > self.epoch:
            self.epoch = msg.epoch
            self.electing = True
            self.leader = None
            self.acked_me = {self.rank}
        elif msg.epoch < self.epoch:
            # stale proposer: provoke it to catch up
            self.send(msg.rank, MMonElection(op="propose",
                                             epoch=self.epoch,
                                             rank=self.rank))
            return
        if msg.rank < self.rank:
            if not self.electing and self.leader == self.rank:
                # we won this epoch but a lower rank is proposing:
                # abdicate by DEFERRING in a fresh epoch (re-proposing
                # ourselves here livelocks: our broadcast reaches the
                # other voters first and we just win again)
                self.epoch += 1
                self.electing = True
                self.leader = None
                self.acked_me = set()
                self.send(msg.rank, MMonElection(op="ack",
                                                 epoch=self.epoch,
                                                 rank=self.rank))
                return
            # defer
            self.send(msg.rank, MMonElection(op="ack", epoch=self.epoch,
                                             rank=self.rank))
        else:
            # we outrank the proposer: push our own candidacy — to
            # EVERY rank, not just the proposer.  Under an asymmetric
            # partition the proposer may be unreachable from us; if
            # our counter-candidacy went only to it, every reachable
            # voter would sit in the bumped epoch never hearing a
            # proposal, and the quorum would stall until the lease
            # timeout restarted the whole election (found by the
            # chaos harness's asymmetric mon-partition schedule).
            for r in self.ranks:
                if r != self.rank:
                    self.send(r, MMonElection(op="propose",
                                              epoch=self.epoch,
                                              rank=self.rank))
            self._check_win()

    def _handle_ack(self, msg: MMonElection) -> None:
        if msg.epoch > self.epoch:
            # an abdicating leader deferred to us in a fresh epoch:
            # adopt it and keep collecting there
            self.epoch = msg.epoch
            self.electing = True
            self.leader = None
            self.acked_me = {self.rank}
        elif msg.epoch < self.epoch:
            return
        elif not self.electing:
            # late ack for an epoch we already won: the voter was one
            # delivery behind the majority when victory fired, and
            # dropping its ack would leave it a lease-fed peon OUTSIDE
            # the quorum forever (MON_DOWN that never clears — found
            # by the chaos harness's mon-partition heal).  Expand the
            # quorum and re-announce (ref: real Ceph avoids the race
            # by waiting out the full election timeout).
            if self.leader == self.rank and msg.rank in self.ranks \
                    and msg.rank not in self.quorum:
                self.acked_me.add(msg.rank)
                self.quorum = sorted(set(self.quorum) | {msg.rank})
                dout("mon", 1).write(
                    "elector %d: late ack from %d, quorum now %s",
                    self.rank, msg.rank, self.quorum)
                for r in self.ranks:
                    if r != self.rank:
                        self.send(r, MMonElection(op="victory",
                                                  epoch=self.epoch,
                                                  rank=self.rank,
                                                  quorum=self.quorum))
                self.on_win(self.epoch, self.quorum)
            return
        self.acked_me.add(msg.rank)
        self._check_win()

    def _check_win(self) -> None:
        if self.electing and len(self.acked_me) >= self.majority:
            self.electing = False
            self.leader = self.rank
            self.quorum = sorted(self.acked_me)
            dout("mon", 1).write("elector %d: WON e%d quorum %s",
                                 self.rank, self.epoch, self.quorum)
            # victory goes to EVERY rank, not just the quorum: a
            # conflicting same-epoch winner must learn of us so the
            # epoch-bump conflict resolution can run
            for r in self.ranks:
                if r != self.rank:
                    self.send(r, MMonElection(op="victory",
                                              epoch=self.epoch,
                                              rank=self.rank,
                                              quorum=self.quorum))
            self.on_win(self.epoch, self.quorum)

    def _handle_victory(self, msg: MMonElection) -> None:
        if msg.epoch < self.epoch:
            return
        if msg.epoch == self.epoch and not self.electing and \
                self.leader == self.rank and msg.rank > self.rank:
            # double win in one epoch (their late acks): we outrank
            # them — force a fresh epoch to supersede both victories
            self.start()
            return
        self.epoch = msg.epoch
        self.electing = False
        self.leader = msg.rank
        self.quorum = list(msg.quorum)
        dout("mon", 1).write("elector %d: leader is %d (e%d)",
                             self.rank, msg.rank, self.epoch)
        self.on_lose(self.epoch, msg.rank, self.quorum)
