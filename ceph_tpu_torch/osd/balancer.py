"""Upmap balancer: calc_pg_upmaps + the mgr-style optimization driver.

Port of the reference's PG-distribution optimizer
(ref: src/osd/OSDMap.cc:4360 calc_pg_upmaps, :4301 try_pg_upmap;
driver: src/pybind/mgr/balancer/module.py:897 do_upmap).  The greedy
loop emits/retracts ``pg_upmap_items`` pairs into an Incremental until
every OSD's PG count is within ``max_deviation_ratio`` of its
weight-proportional target.

The expensive part of the reference loop — mapping every PG of every
pool to build ``pgs_by_osd`` — collapses into the full-cluster tables of
ceph_tpu_torch.osd.mapping (one K3 launch and one copy back per pool on
the card, instead of pg_num scalar walks).  The per-iteration
bookkeeping after a candidate change is O(changed pairs), exactly like
the reference's ``temp_pgs_by_osd`` shuffling, so iteration cost is
independent of cluster size.

Determinism: the reference's *aggressive* mode shuffles candidate PGs
with a random_device; we take an explicit seeded generator so balancer
runs are reproducible (pass ``rng=None`` steps in pg order, which the
reference does in non-aggressive mode).

The port's copy of `ceph_tpu.osd.balancer`: the same map and seed give
the same Incremental in both packages.  Every entry point takes the
device of its mapping tables (None -> cuda).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np

from .. import device as _device
from ..common.log import dout
from ..crush.remap import (build_parent_map, get_rule_weight_osd_map,
                           try_remap_rule)
from ..crush.types import CRUSH_ITEM_NONE
from .mapping import OSDMapMapping
from .osdmap import Incremental, OSDMap
from .types import PG

# conf defaults (ref: src/common/options.cc osd_calc_pg_upmaps_*)
MAX_STDDEV = 1.0                   # osd_calc_pg_upmaps_max_stddev
LOCAL_FALLBACK_RETRIES = 100       # osd_calc_pg_upmaps_local_fallback_retries


def _build_pgs_by_osd(tmp: OSDMap, pool_ids: list[int],
                      mapping: OSDMapMapping | None = None, device=None
                      ) -> tuple[dict[int, set[PG]], int]:
    """pgs_by_osd over the up sets of the given pools, via the batched
    mapping tables (replaces the per-PG pg_to_up_acting_osds loop at
    OSDMap.cc:4377-4387); tables not given are computed on `device`."""
    if mapping is None or mapping.epoch != tmp.epoch or \
            any(p not in mapping.pools for p in pool_ids):
        mapping = OSDMapMapping(device)
        mapping.update(tmp, pool_ids=pool_ids)
    pgs_by_osd: dict[int, set[PG]] = {}
    total_pgs = 0
    for pool_id in pool_ids:
        pool = tmp.pools[pool_id]
        total_pgs += pool.size * pool.pg_num
        pm = mapping.pools[pool_id]
        valid = (pm.up != CRUSH_ITEM_NONE) & (pm.up >= 0)
        rows, cols = np.nonzero(valid)
        osds_flat = pm.up[rows, cols]
        # group rows by osd with one stable sort instead of 3M
        # setdefault/add calls (this build was ~90% of a 1M-PG
        # balancer invocation); one PG object per ps, shared across
        # every set that references it
        if len(osds_flat) == 0:
            continue
        order = np.argsort(osds_flat, kind="stable")
        so = osds_flat[order]
        sp = rows[order]
        pg_of = [PG(pool_id, ps) for ps in range(pool.pg_num)]
        cuts = np.nonzero(np.diff(so))[0] + 1
        starts = np.concatenate(([0], cuts))
        ends = np.concatenate((cuts, [len(so)]))
        for s, e in zip(starts.tolist(), ends.tolist()):
            osd = int(so[s])
            seg = {pg_of[ps] for ps in sp[s:e].tolist()}
            ex = pgs_by_osd.get(osd)
            if ex is None:
                pgs_by_osd[osd] = seg
            else:
                ex |= seg
    return pgs_by_osd, total_pgs


def _try_pg_upmap(tmp: OSDMap, pg: PG, overfull: set[int],
                  underfull: list[int], parent: dict[int, int]
                  ) -> tuple[list[int], list[int]] | None:
    """(orig, out) when the rule admits a remap moving pg off an
    overfull osd; None otherwise (ref: OSDMap.cc:4301 try_pg_upmap)."""
    pool = tmp.pools.get(pg.pool)
    if pool is None:
        return None
    ruleno = tmp.crush.find_rule(pool.crush_rule, pool.type, pool.size)
    if ruleno < 0:
        return None
    orig = tmp.pg_to_raw_upmap(pg)
    if not any(o in overfull for o in orig):
        return None
    out = try_remap_rule(tmp.crush, ruleno, pool.size, overfull,
                         underfull, orig, parent)
    if out == orig:
        return None
    return orig, out


@dataclass
class _Change:
    """One candidate balancer step (the reference's to_unmap/to_upmap
    pair).  `temp_pgs_by_osd` is a copy-on-write OVERLAY holding only
    the OSDs this change touches — a full copy of pgs_by_osd per
    candidate is O(total PG replicas) and was the 10s/iteration wall
    at 1M PGs; a change moves a handful of PGs
    between a handful of OSDs, so scoring only needs those."""
    to_unmap: set[PG] = field(default_factory=set)
    to_upmap: dict[PG, list[tuple[int, int]]] = field(default_factory=dict)
    temp_pgs_by_osd: dict[int, set[PG]] = field(default_factory=dict)

    def found(self) -> bool:
        return bool(self.to_unmap or self.to_upmap)


def calc_pg_upmaps(osdmap: OSDMap, max_deviation_ratio: float,
                   max_iterations: int, only_pools: set[int] | None,
                   pending_inc: Incremental, *,
                   aggressive: bool = True,
                   local_fallback_retries: int = LOCAL_FALLBACK_RETRIES,
                   max_stddev: float = MAX_STDDEV,
                   rng: random.Random | None = None,
                   mapping: OSDMapMapping | None = None,
                   device=None, timings: dict | None = None) -> int:
    """Emit pg_upmap_items changes into pending_inc until the PG
    distribution is balanced; returns the number of changes
    (ref: src/osd/OSDMap.cc:4360 calc_pg_upmaps).  The PG tables come
    from `mapping` when it is current, else from an update() on
    `device` (None -> cuda).  `timings` (optional dict) receives the
    host-clock intervals (t0, t1) of this call's pieces: "clone",
    "build_pgs_by_osd" (with the update() when it makes one) and
    "search" (the targets and the greedy loop)."""
    laps = {} if timings is None else timings
    try:
        return _calc_pg_upmaps(osdmap, max_deviation_ratio, max_iterations,
                               only_pools, pending_inc, aggressive,
                               local_fallback_retries, max_stddev, rng,
                               mapping, device, laps)
    finally:
        if "build_pgs_by_osd" in laps:
            laps["search"] = (laps["build_pgs_by_osd"][1], time.monotonic())


def _calc_pg_upmaps(osdmap, max_deviation_ratio, max_iterations, only_pools,
                    pending_inc, aggressive, local_fallback_retries,
                    max_stddev, rng, mapping, device, laps) -> int:
    t0 = time.monotonic()
    tmp = osdmap.clone()
    laps["clone"] = (t0, time.monotonic())
    num_changed = 0
    pool_ids = sorted(p for p in tmp.pools
                      if not only_pools or p in only_pools)
    if not pool_ids or max_iterations <= 0:
        return 0

    t1 = time.monotonic()
    pgs_by_osd, total_pgs = _build_pgs_by_osd(tmp, pool_ids, mapping,
                                              device)
    laps["build_pgs_by_osd"] = (t1, time.monotonic())

    # weight-proportional targets (OSDMap.cc:4390-4407)
    osd_weight: dict[int, float] = {}
    for pool_id in pool_ids:
        pool = tmp.pools[pool_id]
        ruleno = tmp.crush.find_rule(pool.crush_rule, pool.type, pool.size)
        if ruleno < 0:
            continue
        for osd, frac in get_rule_weight_osd_map(tmp.crush, ruleno).items():
            adjusted = (tmp.osd_weight[osd] / 0x10000) * frac \
                if 0 <= osd < tmp.max_osd else 0.0
            if adjusted == 0:
                continue
            osd_weight[osd] = osd_weight.get(osd, 0.0) + adjusted
    osd_weight_total = sum(osd_weight.values())
    if osd_weight_total == 0:
        return 0
    for osd in osd_weight:
        pgs_by_osd.setdefault(osd, set())
    # osds outside the rule tree carry no target; drop them from the
    # scoring universe (reference asserts they never appear)
    pgs_by_osd = {o: s for o, s in pgs_by_osd.items() if o in osd_weight}
    pgs_per_weight = total_pgs / osd_weight_total

    decay_factor = 1.0 / max_iterations

    def deviations(counts: dict[int, set[PG]]
                   ) -> tuple[dict[int, float], float]:
        dev = {}
        stddev = 0.0
        for osd, pgs in counts.items():
            # retracting stale upmap pairs can (re)introduce osds with
            # no crush weight (marked-out targets); they carry no
            # target, so they don't participate in scoring
            w = osd_weight.get(osd)
            if w is None:
                continue
            target = w * pgs_per_weight
            d = len(pgs) - target
            dev[osd] = d
            stddev += d * d
        return dev, stddev

    osd_deviation, stddev = deviations(pgs_by_osd)
    if stddev <= max_stddev:
        dout("osd", 10).write("calc_pg_upmaps: distribution is almost perfect")
        return 0

    def sorted_by_dev(dev: dict[int, float]) -> list[tuple[int, float]]:
        return sorted(dev.items(), key=lambda kv: (kv[1], kv[0]))

    parent = build_parent_map(tmp.crush)  # crush is immutable in-run

    skip_overfull = False
    it = max_iterations
    while it > 0:
        it -= 1
        by_dev = sorted_by_dev(osd_deviation)
        # overfull/underfull with decaying thresholds (OSDMap.cc:4462)
        overfull: set[int] = set()
        decay_count = 0
        while not overfull:
            decay = decay_factor * decay_count
            overfull = {o for o, d in by_dev if d >= 1.0 - decay}
            if overfull:
                break
            decay_count += 1
            if decay_factor * decay_count >= 1.0:
                break
        if not overfull:
            break
        underfull: list[int] = []
        decay_count = 0
        while not underfull:
            decay = decay_factor * decay_count
            underfull = [o for o, d in by_dev if d < -.999 + decay]
            if underfull:
                break
            decay_count += 1
            if decay_factor * decay_count >= 0.999:
                break
        if not underfull:
            break
        dout("osd", 10).write("calc_pg_upmaps overfull %s underfull %s",
                               sorted(overfull), underfull)

        to_skip: set[PG] = set()
        local_fallback_retried = 0
        outer_continue = False
        while True:  # the reference's `retry:` label
            change = _find_change(
                tmp, pgs_by_osd, osd_deviation, osd_weight, pgs_per_weight,
                by_dev, overfull, underfull, to_skip, skip_overfull,
                max_deviation_ratio, only_pools, aggressive, rng, parent)
            if not change.found():
                if not aggressive:
                    return _finish(num_changed)
                if not skip_overfull:
                    return _finish(num_changed)
                skip_overfull = False
                outer_continue = True
                break
            # test_change: (OSDMap.cc:4763) — incremental rescoring
            # over the overlay's touched OSDs only: stddev' = stddev
            # - Σ d_old² + Σ d_new² (the full-universe recompute is
            # what made each iteration O(cluster size))
            new_stddev = stddev
            temp_dev: dict[int, float] = {}
            for osd, s in change.temp_pgs_by_osd.items():
                w = osd_weight.get(osd)
                if w is None:
                    continue        # weightless: outside scoring
                target = w * pgs_per_weight
                # every weighted OSD is in osd_deviation by
                # construction — fail loudly on a desync rather than
                # silently drifting the incremental stddev
                d_old = osd_deviation[osd]
                d_new = len(s) - target
                new_stddev += d_new * d_new - d_old * d_old
                temp_dev[osd] = d_new
            dout("osd", 10).write("calc_pg_upmaps stddev %s -> %s",
                                      stddev, new_stddev)
            if new_stddev >= stddev:
                if not aggressive:
                    return _finish(num_changed)
                local_fallback_retried += 1
                if local_fallback_retried >= local_fallback_retries:
                    skip_overfull = not skip_overfull
                    outer_continue = True
                    break
                to_skip |= change.to_unmap
                to_skip |= set(change.to_upmap)
                continue  # retry
            # apply: merge the overlay
            stddev = new_stddev
            for osd, s in change.temp_pgs_by_osd.items():
                pgs_by_osd[osd] = s
            osd_deviation.update(temp_dev)
            for pg in change.to_unmap:
                del tmp.pg_upmap_items[pg]
                # a pg can be re-upmapped after an earlier retraction
                # (and vice versa) within one run; the pending inc must
                # hold it in only one of the two collections
                pending_inc.new_pg_upmap_items.pop(pg, None)
                if pg not in pending_inc.old_pg_upmap_items:
                    pending_inc.old_pg_upmap_items.append(pg)
                num_changed += 1
            for pg, items in change.to_upmap.items():
                tmp.pg_upmap_items[pg] = items
                if pg in pending_inc.old_pg_upmap_items:
                    pending_inc.old_pg_upmap_items.remove(pg)
                pending_inc.new_pg_upmap_items[pg] = items
                num_changed += 1
            break
        if outer_continue:
            continue
    return _finish(num_changed)


def _finish(num_changed: int) -> int:
    dout("osd", 10).write("calc_pg_upmaps num_changed = %d", num_changed)
    return num_changed


def _find_change(tmp: OSDMap, pgs_by_osd, osd_deviation, osd_weight,
                 pgs_per_weight, by_dev, overfull, underfull, to_skip,
                 skip_overfull, max_deviation_ratio, only_pools,
                 aggressive, rng, parent) -> _Change:
    """One pass over overfull (descending deviation) then underfull
    osds looking for a single change; mirrors the body between the
    reference's `retry:` and `test_change:` labels (OSDMap.cc:4517)."""
    c = _Change()

    def tset(osd: int) -> set:
        """Copy-on-write: an OSD's PG set enters the overlay the first
        time the change touches it."""
        s = c.temp_pgs_by_osd.get(osd)
        if s is None:
            s = c.temp_pgs_by_osd[osd] = set(pgs_by_osd.get(osd, ()))
        return s

    if not skip_overfull:
        # always start with fullest (OSDMap.cc:4521)
        for osd, deviation in reversed(by_dev):
            target = osd_weight[osd] * pgs_per_weight
            if deviation / target < max_deviation_ratio:
                break
            pgs = [pg for pg in sorted(pgs_by_osd[osd])
                   if pg not in to_skip]
            if aggressive and rng is not None:
                rng.shuffle(pgs)
            # drop existing remappings into this overfull osd first
            for pg in pgs:
                items = tmp.pg_upmap_items.get(pg)
                if items is None:
                    continue
                new_items = []
                for frm, to in items:
                    if to == osd:
                        tset(to).discard(pg)
                        tset(frm).add(pg)
                    else:
                        new_items.append((frm, to))
                if not new_items:
                    c.to_unmap.add(pg)
                    return c
                elif len(new_items) != len(items):
                    c.to_upmap[pg] = new_items
                    return c
            # then try new upmap pairs
            for pg in pgs:
                if pg in tmp.pg_upmap:
                    continue  # admin-specified, leave alone
                pool_size = tmp.pools[pg.pool].size
                new_items = []
                existing: set[int] = set()
                items = tmp.pg_upmap_items.get(pg)
                if items is not None:
                    if len(items) >= pool_size:
                        continue
                    new_items = list(items)
                    for frm, to in items:
                        existing.add(frm)
                        existing.add(to)
                res = _try_pg_upmap(tmp, pg, overfull, underfull, parent)
                if res is None:
                    continue
                orig, out = res
                if len(orig) != len(out):
                    continue
                for i in range(len(out)):
                    if orig[i] == out[i]:
                        continue
                    if orig[i] in existing or out[i] in existing:
                        continue  # new remappings only
                    existing.add(orig[i])
                    existing.add(out[i])
                    tset(orig[i]).discard(pg)
                    tset(out[i]).add(pg)
                    new_items.append((orig[i], out[i]))
                    c.to_upmap[pg] = new_items
                    return c  # append pairs slowly (OSDMap.cc:4654)

    # underfull pass: retract remappings out of underfull osds
    # (OSDMap.cc:4678)
    underfull_set = set(underfull)
    for osd, deviation in by_dev:
        if osd not in underfull_set:
            break
        target = osd_weight[osd] * pgs_per_weight
        if abs(deviation / target) < max_deviation_ratio:
            break
        candidates = [(pg, items)
                      for pg, items in sorted(tmp.pg_upmap_items.items())
                      if pg not in to_skip and
                      (not only_pools or pg.pool in only_pools)]
        if aggressive and rng is not None:
            rng.shuffle(candidates)
        for pg, items in candidates:
            new_items = []
            for frm, to in items:
                if frm == osd:
                    tset(to).discard(pg)
                    tset(frm).add(pg)
                else:
                    new_items.append((frm, to))
            if not new_items:
                c.to_unmap.add(pg)
                return c
            elif len(new_items) != len(items):
                c.to_upmap[pg] = new_items
                return c
    return _Change()  # nothing found


# ---------------------------------------------------------------- driver
class Balancer:
    """mgr balancer (upmap mode) — groups pools by crush rule and
    spends the optimization budget across the groups
    (ref: src/pybind/mgr/balancer/module.py:897 do_upmap); its
    mapping tables are computed on `device` (None -> cuda)."""

    def __init__(self, max_deviation: int = 5, max_iterations: int = 10,
                 aggressive: bool = True, seed: int | None = 0,
                 device=None) -> None:
        self.max_deviation = max_deviation
        self.max_iterations = max_iterations
        self.aggressive = aggressive
        self.seed = seed
        self.device = _device.resolve(device)

    def optimize(self, osdmap: OSDMap,
                 pools: list[int] | None = None) -> Incremental:
        """Build the pending Incremental for one balancer round."""
        inc = Incremental(epoch=osdmap.epoch + 1)
        pool_ids = sorted(pools if pools is not None else osdmap.pools)
        by_rule: dict[int, list[int]] = {}
        for pid in pool_ids:
            pool = osdmap.pools.get(pid)
            if pool is None:
                continue
            by_rule.setdefault(pool.crush_rule, []).append(pid)
        left = self.max_iterations
        rng = random.Random(self.seed) if self.seed is not None else None
        for group in by_rule.values():
            # reference uses a flat per-osd PG-count deviation knob;
            # convert to the ratio calc_pg_upmaps takes, per group
            total_pgs = sum(osdmap.pools[p].size * osdmap.pools[p].pg_num
                            for p in group)
            n_osd = max(1, sum(1 for o in range(osdmap.max_osd)
                               if osdmap.is_in(o)))
            avg = max(1.0, total_pgs / n_osd)
            ratio = self.max_deviation / avg
            did = calc_pg_upmaps(osdmap, ratio, left, set(group), inc,
                                 aggressive=self.aggressive, rng=rng,
                                 device=self.device)
            left -= did
            if left <= 0:
                break
        return inc

    def score(self, osdmap: OSDMap,
              mapping: OSDMapMapping | None = None) -> dict:
        """Distribution stats: per-osd PG counts vs targets
        (ref: balancer module.py calc_eval)."""
        pool_ids = sorted(osdmap.pools)
        pgs_by_osd, total_pgs = _build_pgs_by_osd(osdmap, pool_ids, mapping,
                                                  self.device)
        osd_weight: dict[int, float] = {}
        for pid in pool_ids:
            pool = osdmap.pools[pid]
            ruleno = osdmap.crush.find_rule(pool.crush_rule, pool.type,
                                            pool.size)
            if ruleno < 0:
                continue
            for osd, frac in get_rule_weight_osd_map(
                    osdmap.crush, ruleno).items():
                adjusted = (osdmap.osd_weight[osd] / 0x10000) * frac
                if adjusted:
                    osd_weight[osd] = osd_weight.get(osd, 0.0) + adjusted
        wtotal = sum(osd_weight.values())
        if not wtotal:
            return {"stddev": 0.0, "max_deviation": 0.0, "osds": {}}
        ppw = total_pgs / wtotal
        stats = {}
        stddev = 0.0
        max_dev = 0.0
        for osd, w in sorted(osd_weight.items()):
            n = len(pgs_by_osd.get(osd, ()))
            target = w * ppw
            d = n - target
            stats[osd] = {"pgs": n, "target": round(target, 2),
                          "deviation": round(d, 2)}
            stddev += d * d
            max_dev = max(max_dev, abs(d))
        return {"stddev": round(stddev, 2),
                "max_deviation": round(max_dev, 2), "osds": stats}
