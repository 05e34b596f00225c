"""ChaosRunner: schedule-driven chaos against a MiniCluster.

Where the thrashers (thrasher.py) draw random action sequences, a
chaos schedule is *declarative*: a list of timed events — partitions,
link-loss, delay, daemon kills — applied at simulated-time offsets
while client IO runs, with cluster invariants checked at heal points
and at the end (ref: the qa netem/iptables tasks + ceph_manager's
wait_for_clean/wait_for_health verification loops, collapsed into one
harness over the FaultPlane).

A schedule is a list of dicts::

    [{"at": 10.0, "action": "partition", "a": ["mon.2"],
      "b": ["mon.0", "mon.1"], "label": "minority"},
     {"at": 40.0, "action": "heal", "target": "minority"},
     {"at": 55.0, "action": "check"}]

``at`` is seconds after the runner's sim-time start.  Every fault
event's installed rule ids are remembered under its ``label`` (or its
schedule index) so a later ``heal`` can lift exactly that fault.

Invariants (checked by ``check_invariants``): a majority quorum with
a leader re-forms; every PG settles active+clean with nothing
recovering; every *acked* write reads back byte-identical; SLOW_OPS
and health degradation clear; the crash table stays empty; RGW
multisite sync lag drains (when gateways exist).  Violations raise
``InvariantViolation`` carrying the fault log tail for replay — the
run is reproducible from (cluster fault_seed, schedule).

The port's copy of `ceph_tpu.testing.chaos`, whole, over the port's
MiniCluster (build it with `device="cpu"` on a machine without a card):
the same actions, invariants, phases and report, so one seed and one
schedule give the reference's fault digest and counts.  The port's
cluster runs no RGW gateway, so the multisite invariant finds none.
"""
from __future__ import annotations

import random
import time as _time

from ..common.options import global_config
from .cluster import MiniCluster


class InvariantViolation(AssertionError):
    """A cluster invariant failed after (or during) a chaos run."""


def percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 on an empty sample set."""
    if not samples:
        return 0.0
    s = sorted(samples)
    i = min(len(s) - 1, max(0, int(round(q / 100.0 * len(s))) - 1))
    return s[i]


class ChaosRunner:
    """Execute one declarative chaos schedule under live client IO."""

    #: actions that install FaultPlane rules (tracked for heal)
    FAULT_ACTIONS = ("partition", "isolate", "isolate_primary",
                     "drop", "delay", "dup", "reorder")

    def __init__(self, cluster: MiniCluster, schedule: list[dict],
                 rados=None, pool: str = "chaos", seed: int = 0,
                 start: float = 50_000.0, io_per_step: int = 2,
                 strict_health: bool = True):
        self.c = cluster
        self.plane = cluster.network.faults
        self.schedule = sorted(
            [dict(e) for e in schedule], key=lambda e: e["at"])
        self.rng = random.Random(f"chaos|{seed}")
        self.start = start
        self.now = start
        self.io_per_step = io_per_step
        self.strict_health = strict_health
        self.r = rados if rados is not None else cluster.rados()
        from ..client import RadosError
        try:
            self.r.pool_lookup(pool)
        except RadosError:
            self.r.pool_create(pool, pg_num=16)
            if not cluster.threaded:
                cluster.pump()
        self.io = self.r.open_ioctx(pool)
        #: every write ever issued: oid -> (data, fut, t0, phase)
        self._writes: dict[str, tuple] = {}
        self._oid_seq = 0
        #: phase label -> completed-op latency samples (seconds)
        self.phase_lats: dict[str, list[float]] = {}
        self._phase = "pre"
        #: label -> FaultPlane rule ids (for targeted heals)
        self._installed: dict[str, list[int]] = {}
        #: OSDs the schedule killed and has not revived
        self._downed: set[int] = set()
        self.log: list[str] = []

    # ------------------------------------------------------------ time
    def _tick_to(self, offset: float) -> None:
        """Advance sim time to `start + offset` (schedule times are
        offsets from the run start) in sub-grace steps — the thrasher
        cadence: failure detection sees production-like intervals —
        interleaving client IO and completion harvesting."""
        grace = global_config()["osd_heartbeat_grace"]
        step = grace / 2 + 1
        target = max(self.start + offset, self.now)
        while self.now < target:
            self.now = min(target, self.now + step)
            self.c.tick(self.now)
            self._issue_io()
            self._harvest()

    def _settle(self, rounds: int = 4) -> None:
        """Post-event propagation: ticks with drains, no new IO."""
        for _ in range(rounds):
            self.now += global_config()["osd_heartbeat_grace"] / 2 + 1
            self.c.tick(self.now)
            self._harvest()

    # -------------------------------------------------------------- io
    def _issue_io(self) -> None:
        for _ in range(self.io_per_step):
            self._oid_seq += 1
            oid = f"chaos_{self._oid_seq:05d}"
            data = bytes([self.rng.randrange(256)]) \
                * self.rng.randrange(1, 800)
            fut = self.io.aio_write_full(oid, data)
            self._writes[oid] = (data, fut, _time.monotonic(),
                                 self._phase)
        if not self.c.threaded:
            self.c.pump()

    def _harvest(self) -> None:
        """Record first-observed completion latencies per phase."""
        for oid, (data, fut, t0, phase) in self._writes.items():
            if t0 is None or not fut.done():
                continue
            self.phase_lats.setdefault(phase, []).append(
                _time.monotonic() - t0)
            self._writes[oid] = (data, fut, None, phase)

    def acked_writes(self) -> dict[str, bytes]:
        """oid -> data for every write the cluster acknowledged OK.
        These are the durability contract: they MUST read back."""
        return {oid: data
                for oid, (data, fut, _t0, _ph) in self._writes.items()
                if fut.done() and fut.result == 0}

    def _drain_io(self, timeout: float = 30.0) -> None:
        """Wait for every in-flight write to complete (parked ops
        resend via the rescan timer, which is real-time)."""
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if not self.c.threaded:
                self.c.pump()
            else:
                self.plane.flush()
            self._harvest()
            if all(f.done()
                   for _d, f, _t, _p in self._writes.values()):
                return
            _time.sleep(0.02)
        undone = [o for o, (_d, f, _t, _p) in self._writes.items()
                  if not f.done()]
        raise InvariantViolation(
            f"writes never completed after heal: {undone[:8]} "
            f"(+{max(0, len(undone) - 8)} more); log: {self.log}")

    # ---------------------------------------------------------- events
    def _apply(self, ev: dict, idx: int) -> None:
        act = ev["action"]
        label = ev.get("label", f"ev{idx}")
        self._phase = label if act in self.FAULT_ACTIONS else self._phase
        self.log.append(f"t={ev['at']:.1f} {act} [{label}]")
        if act == "partition":
            ids = self.plane.partition(
                ev["a"], ev["b"],
                symmetric=ev.get("symmetric", True))
            self._installed.setdefault(label, []).extend(ids)
        elif act == "isolate":
            ids = self.plane.isolate(ev["entity"])
            self._installed.setdefault(label, []).extend(ids)
        elif act == "isolate_primary":
            osd = self._primary_of(ev["oid"], ev.get("pool"))
            self.log.append(f"  -> primary is osd.{osd}")
            ids = self.plane.isolate(f"osd.{osd}")
            self._installed.setdefault(label, []).extend(ids)
        elif act in ("drop", "delay", "dup", "reorder"):
            kw = {k: ev[k] for k in ("drop", "delay", "jitter", "dup",
                                     "reorder", "reset", "types")
                  if k in ev}
            if act == "drop" and "drop" not in kw:
                kw["drop"] = ev["p"]
            rid = self.plane.add_rule(ev["src"], ev["dst"], **kw)
            self._installed.setdefault(label, []).append(rid)
        elif act == "kill_osd":
            self.c.kill_osd(ev["osd"])
            self._downed.add(ev["osd"])
        elif act == "revive_osd":
            self.c.revive_osd(ev["osd"])
            self._downed.discard(ev["osd"])
            if not self.c.threaded:
                self.c.pump()
        elif act == "heal":
            target = ev.get("target")
            if target is None:
                self.plane.heal()
                self._installed.clear()
            else:
                self.plane.heal(self._installed.pop(target, []))
            self._phase = f"healed:{target or 'all'}"
        elif act == "check":
            self._settle()
            self.check_invariants(
                final=False, strict_health=ev.get("strict", False))
        else:
            raise ValueError(f"unknown chaos action {act!r}")

    def _primary_of(self, oid: str, pool: str | None) -> int:
        pid = self.r.pool_lookup(pool) if pool else self.io.pool_id
        m = self.c.mon.osdmap
        raw = m.object_locator_to_pg(oid, pid)
        _up, _upp, _acting, primary = m.pg_to_up_acting_osds(raw)
        return primary

    # -------------------------------------------------------------- run
    def run(self) -> dict:
        """Execute the schedule, heal anything still broken, drain IO,
        check every invariant, and return the report."""
        self._issue_io()
        for i, ev in enumerate(self.schedule):
            self._tick_to(ev["at"])
            self._apply(ev, i)
        # terminal heal: whatever the schedule left broken comes back
        self._phase = "final"
        if self.plane.rules():
            self.plane.heal()
            self._installed.clear()
            self.log.append("final heal (leftover rules)")
        for osd in sorted(self._downed):
            self.c.revive_osd(osd)
            self.log.append(f"final revive osd.{osd}")
        self._downed.clear()
        if not self.c.threaded:
            self.c.pump()
        self._settle()
        self._drain_io()
        self.check_invariants(final=True,
                              strict_health=self.strict_health)
        return self.report()

    # ------------------------------------------------------ invariants
    def _leader(self):
        for _ in range(40):
            ldr = self.c.leader()
            if ldr is not None:
                return ldr
            self._settle(1)
        raise InvariantViolation(
            f"no mon leader re-elected; log: {self.log}")

    def check_invariants(self, final: bool = True,
                         strict_health: bool | None = None) -> None:
        if strict_health is None:
            strict_health = self.strict_health
        ldr = self._leader()
        rc, _, q = ldr.handle_command({"prefix": "quorum_status"})
        assert rc == 0
        if len(q["quorum"]) * 2 <= len(q["mons"]) or \
                q["leader"] not in q["quorum"]:
            raise InvariantViolation(
                f"quorum never re-formed: {q}; log: {self.log}")
        # PGs settle active+clean (recovery may still be running —
        # keep ticking within a bounded budget)
        for attempt in range(60):
            if not self.c.threaded:
                self.c.pump()
            recovering = sum(d.pgs_recovering()
                             for d in self.c.osds.values())
            rc, _, pg = ldr.handle_command({"prefix": "pg stat"})
            states = pg["states"]
            dirty = {s: n for s, n in states.items()
                     if "clean" not in s or "active" not in s}
            if not recovering and not dirty:
                break
            self._settle(1)
            if self.c.threaded:
                _time.sleep(0.02)
        else:
            raise InvariantViolation(
                f"PGs never went active+clean: recovering="
                f"{recovering} states={states}; log: {self.log}")
        # acked writes are durable, byte-identical
        if final:
            self._drain_io()
        bad = []
        for oid, data in sorted(self.acked_writes().items()):
            got = self.io.read(oid)
            if got != data:
                bad.append((oid, len(data), len(got)))
        if bad:
            raise InvariantViolation(
                f"acked writes corrupted: {bad[:5]}; log: {self.log}")
        # health clears: SLOW_OPS always; full HEALTH_OK when strict
        for attempt in range(40):
            rc, status, h = ldr.handle_command({"prefix": "health"})
            checks = h["checks"]
            if "SLOW_OPS" not in checks and \
                    (not strict_health or status == "HEALTH_OK"):
                break
            self._settle(1)
            if self.c.threaded:
                _time.sleep(0.02)
        else:
            raise InvariantViolation(
                f"health never cleared: {status} {checks}; "
                f"log: {self.log}")
        # crash table: chaos must not have crashed any daemon
        rc, _, crashes = ldr.handle_command({"prefix": "crash ls"})
        if crashes:
            raise InvariantViolation(
                f"crash table not empty: "
                f"{[c.get('crash_id') for c in crashes]}; "
                f"log: {self.log}")
        # RGW multisite: sync lag drains after heal
        for gw in getattr(self.c, "rgws", []):
            deadline = _time.monotonic() + 30.0
            while not gw.sync.caught_up():
                if _time.monotonic() > deadline:
                    raise InvariantViolation(
                        f"rgw zone {gw.zone} sync lag never drained: "
                        f"{gw.sync.status()}; log: {self.log}")
                _time.sleep(0.05)

    # ----------------------------------------------------------- report
    def report(self) -> dict:
        """Per-phase op latency percentiles + the fault fingerprint."""
        phases = []
        for label, lats in self.phase_lats.items():
            phases.append({
                "phase": label, "ops": len(lats),
                "p50_ms": round(percentile(lats, 50) * 1e3, 3),
                "p99_ms": round(percentile(lats, 99) * 1e3, 3)})
        return {
            "phases": phases,
            "ops_total": sum(len(v) for v in self.phase_lats.values()),
            "acked": len(self.acked_writes()),
            "fault_digest": self.plane.digest(),
            "fault_counts": dict(self.plane.counts),
            "events": list(self.log),
        }
