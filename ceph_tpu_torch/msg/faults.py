"""FaultPlane: deterministic link-level network fault injection.

The chaos layer under the messenger (ref: the reference's
ms_inject_socket_failures / ms_inject_delay_* options in
src/common/options.cc, and the qa netem/iptables partition helpers in
qa/tasks/ceph_manager.py) collapsed into one seeded, per-link rule
table:

* **drop** — per-message drop probability, so burst loss is
  expressible (the old global 1-in-N modulus could never drop two
  consecutive messages);
* **partition** — black-hole a direction entirely.  Rules are
  directional, so A->B blocked while B->A flows (the asymmetric case
  that breaks naive quorum logic) is one rule, not a special mode;
* **delay / jitter** — hold delivery for a fixed + uniformly-jittered
  interval in the plane's clock domain (simulated time under a
  MiniCluster tick harness, wall-clock otherwise);
* **reorder** — buffer a window of N messages per link and release
  them shuffled;
* **dup** — deliver a message twice (same seq: receivers must
  tolerate the replay like a TCP retransmit).

Effect precedence per message: partition > drop > reorder > delay >
dup.

Determinism: every random draw comes from a per-link stream seeded
from (master seed, src, dst), and every decision is folded into a
per-link hash chain.  ``digest()`` combines the chains sorted by link
name, so the digest is reproducible from the seed whenever each
link's own message sequence is reproducible — concurrent traffic on
*other* links cannot perturb it.  A failing schedule therefore
replays byte-identically from its seed in a pump-mode harness.

The rule table is shared between injector threads (tests, the
ChaosRunner) and every routing thread, so it is racecheck-
instrumented: all access holds ``self._lock``.

The port's copy of `ceph_tpu.msg.faults`, whole: the same rules, RNG
streams, decisions, log and digest, so one seed and one message
sequence give the reference's verdicts and digest.
"""
from __future__ import annotations

import hashlib
import itertools
import random
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..common.lockdep import make_lock
from ..common.racecheck import shared_state

#: reorder buffers older than this (in the plane's clock domain) are
#: released even if the window never filled — a partial window must
#: not strand messages forever
REORDER_LATCH_S = 0.25

#: fault-log ring size (debugging aid; the digest is unbounded-exact)
LOG_RING = 4096


def _pat_match(pat: str, name: str) -> bool:
    """Entity pattern: exact name, "osd.*" prefix wildcard, or "*"."""
    if pat == "*" or pat == name:
        return True
    if pat.endswith("*"):
        return name.startswith(pat[:-1])
    return False


@dataclass
class LinkRule:
    """One directional fault rule (src pattern -> dst pattern)."""
    src: str
    dst: str
    drop: float = 0.0          # drop probability in [0, 1]
    partition: bool = False    # black-hole this direction
    delay: float = 0.0         # fixed delivery delay (seconds)
    jitter: float = 0.0        # extra uniform delay in [0, jitter)
    dup: float = 0.0           # duplication probability
    reorder: int = 0           # window size (0 = off)
    #: drops signal a socket reset to both sides (the legacy
    #: ms_inject_socket_failures behavior); partitions default to
    #: silence — detection must come from timeouts, like real netsplits
    reset: bool = False
    #: restrict to these Message type_names ("" tuple = all traffic)
    types: tuple = ()
    rule_id: int = 0

    def matches(self, src: str, dst: str, type_name: str) -> bool:
        if self.types and type_name not in self.types:
            return False
        return _pat_match(self.src, src) and _pat_match(self.dst, dst)


class Effects:
    """The decided fate of one message."""
    __slots__ = ("verdict", "dropped", "reset", "delay", "dup",
                 "reorder_key")

    def __init__(self, verdict: str, dropped: bool = False,
                 reset: bool = False, delay: float = 0.0,
                 dup: bool = False, reorder_key=None):
        self.verdict = verdict
        self.dropped = dropped
        self.reset = reset
        self.delay = delay
        self.dup = dup
        self.reorder_key = reorder_key


@shared_state(only=("_rules",), mutating=("_rules",))
class FaultPlane:
    """Seeded per-link fault rule table + held-message buffers."""

    def __init__(self, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.seed = seed
        self.clock = clock
        self._lock = make_lock("msg.faultplane")
        self._rules: dict[int, LinkRule] = {}
        self._ids = itertools.count(1)
        self._hold_seq = itertools.count(1)
        #: delayed messages: [release_time, seq, src, dst, msg]
        self._held: list[list] = []
        #: reorder buffers: (rule_id, src, dst) ->
        #: {"deadline": t, "msgs": [(src, dst, msg), ...]}
        self._reorder: dict[tuple, dict] = {}
        #: per-link RNG streams + decision indexes + digest chains
        self._rngs: dict[tuple[str, str], random.Random] = {}
        self._chain: dict[tuple[str, str], "hashlib._Hash"] = {}
        self._chain_idx: dict[tuple[str, str], int] = {}
        self.counts: Counter = Counter()
        self.log: deque = deque(maxlen=LOG_RING)
        #: endpoint-string -> entity aliases for non-messenger
        #: transports (RGW peer HTTP) consulting the same rule table
        self._aliases: dict[str, str] = {}
        #: default delivery callback for flush() callers that have
        #: none (set by LocalNetwork.attach_faults)
        self.deliver_cb: Optional[Callable] = None

    # ------------------------------------------------------- rule admin
    def add_rule(self, src: str, dst: str, **kw) -> int:
        """Install one directional rule; returns its id."""
        rid = next(self._ids)
        rule = LinkRule(src=src, dst=dst, rule_id=rid, **kw)
        if not 0.0 <= rule.drop <= 1.0 or not 0.0 <= rule.dup <= 1.0:
            raise ValueError(f"probability out of [0,1]: {rule}")
        with self._lock:
            self._rules[rid] = rule
        return rid

    def remove_rule(self, rid: int) -> None:
        with self._lock:
            self._rules.pop(rid, None)
            # orphaned reorder buffers release on the next flush
            for key, buf in self._reorder.items():
                if key[0] == rid:
                    buf["deadline"] = 0.0

    def heal(self, ids=None) -> None:
        """Remove the given rules (default: all) and mark every held
        buffer for release on the next flush."""
        with self._lock:
            if ids is None:
                self._rules.clear()
            else:
                for rid in ids:
                    self._rules.pop(rid, None)
            for h in self._held:
                h[0] = 0.0
            for buf in self._reorder.values():
                buf["deadline"] = 0.0
        self.flush()

    def clear(self) -> None:
        self.heal()

    def partition(self, a, b, symmetric: bool = True, **kw) -> list[int]:
        """Block a->b (and b->a when symmetric) for every pattern
        pair; returns the installed rule ids for a targeted heal."""
        a = [a] if isinstance(a, str) else list(a)
        b = [b] if isinstance(b, str) else list(b)
        ids = []
        for s in a:
            for d in b:
                ids.append(self.add_rule(s, d, partition=True, **kw))
                if symmetric:
                    ids.append(self.add_rule(d, s, partition=True, **kw))
        return ids

    def isolate(self, entity: str, **kw) -> list[int]:
        """Cut an entity off from everyone, both directions."""
        return self.partition([entity], ["*"], **kw)

    def rules(self) -> list[LinkRule]:
        with self._lock:
            return [self._rules[k] for k in sorted(self._rules)]

    # ------------------------------------------------------ determinism
    def _link_rng(self, src: str, dst: str) -> random.Random:
        rng = self._rngs.get((src, dst))
        if rng is None:
            # seeding from a string is stable across processes
            # (random.seed version 2), unlike hash() which is salted
            rng = random.Random(f"{self.seed}|{src}|{dst}")
            self._rngs[(src, dst)] = rng
        return rng

    def _record(self, src: str, dst: str, verdict: str,
                type_name: str, extra: str = "") -> None:
        link = (src, dst)
        h = self._chain.get(link)
        if h is None:
            h = self._chain[link] = hashlib.sha256()
        i = self._chain_idx.get(link, 0)
        self._chain_idx[link] = i + 1
        h.update(f"{i}|{verdict}|{type_name}|{extra}\n".encode())
        self.counts[verdict] += 1
        self.log.append((src, dst, verdict, type_name, extra))

    def digest(self) -> str:
        """Order-insensitive across links, exact within each link:
        the reproducibility fingerprint of this run's fault sequence."""
        with self._lock:
            agg = hashlib.sha256()
            for (s, d), h in sorted(self._chain.items()):
                agg.update(f"{s}>{d}:{h.hexdigest()}\n".encode())
            return agg.hexdigest()

    # --------------------------------------------------------- deciding
    def decide(self, src: str, dst: str, type_name: str) -> Effects:
        """Roll this message's fate.  Pure decision — the caller
        applies the effects (LocalNetwork via intercept(), the TCP
        messenger inline)."""
        with self._lock:
            matched = [self._rules[k] for k in sorted(self._rules)
                       if self._rules[k].matches(src, dst, type_name)]
            if not matched:
                return Effects("deliver")
            rng = self._link_rng(src, dst)
            for r in matched:
                if r.partition:
                    self._record(src, dst, "partition", type_name)
                    return Effects("partition", dropped=True,
                                   reset=r.reset)
            for r in matched:
                if r.drop > 0.0 and rng.random() < r.drop:
                    self._record(src, dst, "drop", type_name)
                    return Effects("drop", dropped=True, reset=r.reset)
            for r in matched:
                if r.reorder > 0:
                    self._record(src, dst, "reorder", type_name)
                    return Effects("reorder",
                                   reorder_key=(r.rule_id, src, dst))
            delay = 0.0
            for r in matched:
                if r.delay > 0.0 or r.jitter > 0.0:
                    delay += r.delay
                    if r.jitter > 0.0:
                        delay += rng.random() * r.jitter
            if delay > 0.0:
                self._record(src, dst, "delay", type_name,
                             f"{delay:.6f}")
                return Effects("delay", delay=delay)
            for r in matched:
                if r.dup > 0.0 and rng.random() < r.dup:
                    self._record(src, dst, "dup", type_name)
                    return Effects("dup", dup=True)
            self._record(src, dst, "pass", type_name)
            return Effects("deliver")

    # ------------------------------------------------------ intercepting
    def intercept(self, src: str, dst: str, msg,
                  deliver: Callable[[str, str, object], None]) -> Effects:
        """Full-service path for queue transports: flush due held
        traffic, decide this message's fate, and apply it through
        `deliver(src, dst, msg)`.  Returns the Effects so the caller
        can do its drop bookkeeping (ring, counters, resets)."""
        self.flush(deliver)
        eff = self.decide(src, dst, msg.type_name)
        if eff.dropped:
            return eff
        if eff.reorder_key is not None:
            release = self._reorder_put(eff.reorder_key, src, dst, msg)
            for s, d, m in release:
                deliver(s, d, m)
            return eff
        if eff.delay > 0.0:
            with self._lock:
                self._held.append([self.clock() + eff.delay,
                                   next(self._hold_seq), src, dst, msg])
            return eff
        deliver(src, dst, msg)
        if eff.dup:
            deliver(src, dst, msg)
        return eff

    def _reorder_put(self, key, src, dst, msg) -> list[tuple]:
        """Buffer into the rule's window; a full window releases
        shuffled (the shuffle order rides the digest)."""
        with self._lock:
            buf = self._reorder.get(key)
            if buf is None:
                buf = self._reorder[key] = {
                    "deadline": self.clock() + REORDER_LATCH_S,
                    "msgs": []}
            buf["msgs"].append((src, dst, msg))
            rule = self._rules.get(key[0])
            window = rule.reorder if rule is not None else 1
            if len(buf["msgs"]) < window:
                return []
            del self._reorder[key]
            rng = self._link_rng(key[1], key[2])
            order = list(range(len(buf["msgs"])))
            rng.shuffle(order)
            self._record(key[1], key[2], "shuffle", "-",
                         ",".join(map(str, order)))
            return [buf["msgs"][i] for i in order]

    def flush(self, deliver: Callable | None = None,
              force: bool = False) -> int:
        """Release held traffic whose time has come (or all of it,
        with force=True); returns the number of messages released."""
        deliver = deliver or self.deliver_cb
        now = self.clock()
        out: list[tuple] = []
        with self._lock:
            due, keep = [], []
            for h in self._held:
                (due if force or h[0] <= now else keep).append(h)
            if due:
                self._held = keep
                due.sort(key=lambda h: (h[0], h[1]))
                out.extend((h[2], h[3], h[4]) for h in due)
            for key in list(self._reorder):
                buf = self._reorder[key]
                if force or buf["deadline"] <= now:
                    del self._reorder[key]
                    rng = self._link_rng(key[1], key[2])
                    order = list(range(len(buf["msgs"])))
                    rng.shuffle(order)
                    self._record(key[1], key[2], "shuffle", "-",
                                 ",".join(map(str, order)))
                    out.extend(buf["msgs"][i] for i in order)
        if deliver is not None:
            for s, d, m in out:
                deliver(s, d, m)
        return len(out)

    def pending(self) -> int:
        """Messages currently held for delay/reorder."""
        with self._lock:
            return len(self._held) + sum(
                len(b["msgs"]) for b in self._reorder.values())

    # --------------------------------------- non-messenger transports
    def bind_alias(self, key: str, entity: str) -> None:
        """Map an endpoint string (an RGW peer URL) to an entity name
        so HTTP-side checks hit the same rule table."""
        with self._lock:
            self._aliases[key] = entity

    def check_http(self, src: str, endpoint: str) -> None:
        """Send-side gate for HTTP transports: raises ConnectionError
        when the (aliased) link is partitioned or the drop roll says
        lose it.  Delay/reorder do not apply to request/response
        transports."""
        with self._lock:
            dst = self._aliases.get(endpoint, endpoint)
        eff = self.decide(src, dst, "http")
        if eff.dropped:
            raise ConnectionError(
                f"faultplane: {src} -> {dst} {eff.verdict}")
