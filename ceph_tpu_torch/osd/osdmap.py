"""OSDMap: the cluster map and the object→PG→OSD mapping pipeline.

Faithful re-implementation of the reference OSDMap placement path
(ref: src/osd/OSDMap.{h,cc}):

  object_locator_to_pg (OSDMap.cc:2183) → pg_to_up_acting_osds
  (OSDMap.cc:2462 _pg_to_up_acting_osds):
    _pg_to_raw_osds   (:2232 — pps seed + crush do_rule)
    _apply_upmap      (:2262 — pg_upmap / pg_upmap_items overrides)
    _raw_to_up_osds   (:2309 — drop or NONE down/dne osds)
    _pick_primary     (:2252)
    _apply_primary_affinity (:2334 — probabilistic primary rejection)
    pg_temp / primary_temp overrides (_get_temp_osds :2389)

State mutation is epoch-driven via Incremental deltas
(OSDMap::Incremental, src/osd/OSDMap.h:396), applied by
`apply_incremental`.  The batched full-cluster mapping (the
OSDMapMapping/ParallelPGMapper replacement) lives in `mapping.py` and uses
the batch CRUSH engine (K3 on the card).

`OSDMap.from_reference` copies a map of another package (the JAX
reference's, in the tests) by attribute.  `Incremental` and `OSDMap` are
registered on the wire as the reference registers them, so the mon's
store and map publishes carry the same bytes in both packages.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..crush import mapper as crush_mapper
from ..crush.hashes import hash32_2
from ..crush.types import (CRUSH_ITEM_NONE, CrushMap,
                           crush_map_from_reference)
from .types import PG, PGPool, pg_from_reference, pool_from_reference

# osd_state bits (src/include/rados.h:115-118)
CEPH_OSD_EXISTS = 1 << 0
CEPH_OSD_UP = 1 << 1
CEPH_OSD_AUTOOUT = 1 << 2
CEPH_OSD_NEW = 1 << 3

CEPH_OSD_IN = 0x10000
CEPH_OSD_OUT = 0
CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000


@dataclass
class Incremental:
    """OSDMap delta (ref: src/osd/OSDMap.h:396-550, subset)."""
    epoch: int = 0
    new_max_osd: int | None = None
    new_pools: dict[int, PGPool] = field(default_factory=dict)
    old_pools: list[int] = field(default_factory=list)
    new_pool_names: dict[int, str] = field(default_factory=dict)
    new_up_osds: list[int] = field(default_factory=list)
    new_down_osds: list[int] = field(default_factory=list)
    new_weight: dict[int, int] = field(default_factory=dict)
    new_state: dict[int, int] = field(default_factory=dict)  # xor bits
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    new_pg_temp: dict[PG, list[int]] = field(default_factory=dict)
    new_primary_temp: dict[PG, int] = field(default_factory=dict)
    new_pg_upmap: dict[PG, list[int]] = field(default_factory=dict)
    old_pg_upmap: list[PG] = field(default_factory=list)
    new_pg_upmap_items: dict[PG, list[tuple[int, int]]] = \
        field(default_factory=dict)
    old_pg_upmap_items: list[PG] = field(default_factory=list)
    new_crush: CrushMap | None = None
    new_erasure_code_profiles: dict[str, dict] = field(default_factory=dict)
    old_erasure_code_profiles: list[str] = field(default_factory=list)


class OSDMap:
    """The cluster map (ref: src/osd/OSDMap.h:180)."""

    def __init__(self) -> None:
        self.epoch = 0
        self.fsid = ""
        self.max_osd = 0
        self.osd_state: list[int] = []
        self.osd_weight: list[int] = []          # 16.16; 0x10000 = in
        self.osd_primary_affinity: list[int] | None = None
        self.pools: dict[int, PGPool] = {}
        self.pool_names: dict[int, str] = {}
        self.pool_max = -1
        self.crush = CrushMap()
        self.pg_upmap: dict[PG, list[int]] = {}
        self.pg_upmap_items: dict[PG, list[tuple[int, int]]] = {}
        self.pg_temp: dict[PG, list[int]] = {}
        self.primary_temp: dict[PG, int] = {}
        self.erasure_code_profiles: dict[str, dict] = {}
        self.flags = 0

    # ------------------------------------------------------------------
    # osd state queries (OSDMap.h:710-760)
    def set_max_osd(self, n: int) -> None:
        while len(self.osd_state) < n:
            self.osd_state.append(0)
            self.osd_weight.append(CEPH_OSD_OUT)
            if self.osd_primary_affinity is not None:
                self.osd_primary_affinity.append(
                    CEPH_OSD_DEFAULT_PRIMARY_AFFINITY)
        del self.osd_state[n:]
        del self.osd_weight[n:]
        if self.osd_primary_affinity is not None:
            del self.osd_primary_affinity[n:]
        self.max_osd = n

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and \
            bool(self.osd_state[osd] & CEPH_OSD_EXISTS)

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_state[osd] & CEPH_OSD_UP)

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_out(self, osd: int) -> bool:
        return not self.exists(osd) or self.osd_weight[osd] == CEPH_OSD_OUT

    def is_in(self, osd: int) -> bool:
        return not self.is_out(osd)

    def get_primary_affinity(self, osd: int) -> int:
        if self.osd_primary_affinity is None:
            return CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
        return self.osd_primary_affinity[osd]

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = \
                [CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * self.max_osd
        self.osd_primary_affinity[osd] = aff

    def get_pg_pool(self, pool_id: int) -> PGPool | None:
        return self.pools.get(pool_id)

    # ------------------------------------------------------------------
    # object → pg
    def object_locator_to_pg(self, name: str, pool_id: int,
                             key: str = "", nspace: str = "") -> PG:
        """OSDMap.cc:2163-2194 (map_to_pg)."""
        pool = self.pools.get(pool_id)
        if pool is None:
            raise KeyError(f"no pool {pool_id}")
        ps = pool.hash_key(key or name, nspace)
        return PG(pool_id, ps)

    # ------------------------------------------------------------------
    # pg → osds pipeline
    def _pg_to_raw_osds(self, pool: PGPool, pg: PG) -> tuple[list[int], int]:
        """OSDMap.cc:2232-2250: pps seed, rule mask resolution, crush,
        drop nonexistent.  choose_args are looked up by pool id with the
        default fallback (CrushWrapper::do_rule →
        choose_args_get_with_fallback, CrushWrapper.h:1574)."""
        pps = pool.raw_pg_to_pps(pg)
        ruleno = self.crush.find_rule(pool.crush_rule, pool.type, pool.size)
        osds: list[int] = []
        if ruleno >= 0:
            osds = crush_mapper.do_rule(
                self.crush, ruleno, pps, pool.size, self.osd_weight,
                choose_args=self.crush.choose_args_get_with_fallback(
                    pg.pool))
        self._remove_nonexistent_osds(pool, osds)
        return osds, pps

    def _remove_nonexistent_osds(self, pool: PGPool,
                                 osds: list[int]) -> None:
        """OSDMap.cc:2208-2230."""
        if pool.can_shift_osds():
            osds[:] = [o for o in osds if self.exists(o)]
        else:
            for i, o in enumerate(osds):
                if o != CRUSH_ITEM_NONE and not self.exists(o):
                    osds[i] = CRUSH_ITEM_NONE

    def _apply_upmap(self, pool: PGPool, raw_pg: PG,
                     raw: list[int]) -> None:
        """OSDMap.cc:2262-2307."""
        pg = pool.raw_pg_to_pg(raw_pg)
        explicit = self.pg_upmap.get(pg)
        if explicit is not None:
            for osd in explicit:
                if osd != CRUSH_ITEM_NONE and 0 <= osd < self.max_osd and \
                        self.osd_weight[osd] == 0:
                    # target marked out: reject the whole upmap,
                    # including any pg_upmap_items (OSDMap.cc:2271 return)
                    return
            raw[:] = list(explicit)
        items = self.pg_upmap_items.get(pg)
        if items is not None:
            for frm, to in items:
                exists = False
                pos = -1
                for i, osd in enumerate(raw):
                    if osd == to:
                        exists = True
                        break
                    if osd == frm and pos < 0 and not (
                            to != CRUSH_ITEM_NONE and 0 <= to < self.max_osd
                            and self.osd_weight[to] == 0):
                        pos = i
                if not exists and pos >= 0:
                    raw[pos] = to

    def _raw_to_up_osds(self, pool: PGPool, raw: list[int]) -> list[int]:
        """OSDMap.cc:2309-2332."""
        if pool.can_shift_osds():
            return [o for o in raw if self.exists(o) and self.is_up(o)]
        return [o if (o != CRUSH_ITEM_NONE and self.exists(o)
                      and self.is_up(o)) else CRUSH_ITEM_NONE
                for o in raw]

    @staticmethod
    def _pick_primary(osds: list[int]) -> int:
        """OSDMap.cc:2252-2260."""
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, seed: int, pool: PGPool,
                                osds: list[int], primary: int) -> int:
        """OSDMap.cc:2334-2387; returns the (possibly new) primary."""
        if self.osd_primary_affinity is None:
            return primary
        if not any(o != CRUSH_ITEM_NONE and
                   self.osd_primary_affinity[o] !=
                   CEPH_OSD_DEFAULT_PRIMARY_AFFINITY for o in osds):
            return primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = self.osd_primary_affinity[o]
            if a < CEPH_OSD_MAX_PRIMARY_AFFINITY and \
                    (int(hash32_2(seed, o)) >> 16) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            # move the new primary to the front
            for i in range(pos, 0, -1):
                osds[i] = osds[i - 1]
            osds[0] = primary
        return primary

    def _get_temp_osds(self, pool: PGPool, pg: PG) -> tuple[list[int], int]:
        """OSDMap.cc:2389-2420."""
        pg = pool.raw_pg_to_pg(pg)
        temp_pg: list[int] = []
        for o in self.pg_temp.get(pg, []):
            if not self.exists(o) or self.is_down(o):
                if pool.can_shift_osds():
                    continue
                temp_pg.append(CRUSH_ITEM_NONE)
            else:
                temp_pg.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp_pg:
            for o in temp_pg:
                if o != CRUSH_ITEM_NONE:
                    temp_primary = o
                    break
        return temp_pg, temp_primary

    def pg_to_raw_osds(self, pg: PG) -> tuple[list[int], int]:
        """OSDMap.cc:2422-2432; returns (raw, primary)."""
        pool = self.pools.get(pg.pool)
        if pool is None:
            return [], -1
        raw, _ = self._pg_to_raw_osds(pool, pg)
        return raw, self._pick_primary(raw)

    def pg_to_raw_upmap(self, pg: PG) -> list[int]:
        """Raw crush placement with pg_upmap/pg_upmap_items applied but
        no up-filtering (OSDMap.cc:2434) — the balancer's view of what
        the current overrides produce."""
        pool = self.pools.get(pg.pool)
        if pool is None:
            return []
        raw, _ = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        return raw

    def pg_to_up_acting_osds(self, pg: PG, raw_pg_to_pg: bool = True) \
            -> tuple[list[int], int, list[int], int]:
        """OSDMap.cc:2462-2510 _pg_to_up_acting_osds; returns
        (up, up_primary, acting, acting_primary).  With raw_pg_to_pg
        (the default, like the reference) the ps may be a raw hash —
        every stage folds it; with False the ps must already be folded
        into [0, pg_num)."""
        pg = PG(pg.pool, pg.ps & 0xFFFFFFFF)  # ps_t is u32
        pool = self.pools.get(pg.pool)
        if pool is None or (not raw_pg_to_pg and pg.ps >= pool.pg_num):
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, pg)
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up_primary = self._apply_primary_affinity(pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    # ------------------------------------------------------------------
    # mutation
    def apply_incremental(self, inc: Incremental) -> None:
        """OSDMap.cc apply_incremental (subset, same semantics)."""
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != {self.epoch}+1")
        self.epoch = inc.epoch
        if inc.new_crush is not None:
            self.crush = inc.new_crush
        if inc.new_max_osd is not None:
            self.set_max_osd(inc.new_max_osd)
        for pid, pool in inc.new_pools.items():
            self.pools[pid] = pool
            self.pool_max = max(self.pool_max, pid)
        for pid, name in inc.new_pool_names.items():
            self.pool_names[pid] = name
        for pid in inc.old_pools:
            self.pools.pop(pid, None)
            self.pool_names.pop(pid, None)
        for osd in inc.new_up_osds:
            self.osd_state[osd] |= CEPH_OSD_EXISTS | CEPH_OSD_UP
        for osd in inc.new_down_osds:
            self.osd_state[osd] &= ~CEPH_OSD_UP
        for osd, st in inc.new_state.items():
            self.osd_state[osd] ^= st
        for osd, w in inc.new_weight.items():
            self.osd_weight[osd] = w
            self.osd_state[osd] |= CEPH_OSD_EXISTS
        for osd, aff in inc.new_primary_affinity.items():
            self.set_primary_affinity(osd, aff)
        for pg, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pg] = list(osds)
            else:
                self.pg_temp.pop(pg, None)
        for pg, p in inc.new_primary_temp.items():
            if p >= 0:
                self.primary_temp[pg] = p
            else:
                self.primary_temp.pop(pg, None)
        for pg, osds in inc.new_pg_upmap.items():
            self.pg_upmap[pg] = list(osds)
        for pg in inc.old_pg_upmap:
            self.pg_upmap.pop(pg, None)
        for pg, items in inc.new_pg_upmap_items.items():
            self.pg_upmap_items[pg] = list(items)
        for pg in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pg, None)
        for name, profile in inc.new_erasure_code_profiles.items():
            self.erasure_code_profiles[name] = dict(profile)
        for name in inc.old_erasure_code_profiles:
            self.erasure_code_profiles.pop(name, None)

    @classmethod
    def from_reference(cls, obj) -> "OSDMap":
        """An OSDMap equal field for field to `obj`, an OSDMap of another
        package with the same attributes: OSD state, weights and
        affinity, pools, the CRUSH map, upmaps and temps."""
        m = cls()
        m.epoch = int(obj.epoch)
        m.fsid = obj.fsid
        m.max_osd = int(obj.max_osd)
        m.osd_state = [int(s) for s in obj.osd_state]
        m.osd_weight = [int(w) for w in obj.osd_weight]
        m.osd_primary_affinity = None if obj.osd_primary_affinity is None \
            else [int(a) for a in obj.osd_primary_affinity]
        m.pools = {int(pid): pool_from_reference(p)
                   for pid, p in obj.pools.items()}
        m.pool_names = dict(obj.pool_names)
        m.pool_max = int(obj.pool_max)
        m.crush = crush_map_from_reference(obj.crush)
        m.pg_upmap = {pg_from_reference(pg): [int(o) for o in v]
                      for pg, v in obj.pg_upmap.items()}
        m.pg_upmap_items = {
            pg_from_reference(pg): [(int(a), int(b)) for a, b in v]
            for pg, v in obj.pg_upmap_items.items()}
        m.pg_temp = {pg_from_reference(pg): [int(o) for o in v]
                     for pg, v in obj.pg_temp.items()}
        m.primary_temp = {pg_from_reference(pg): int(p)
                          for pg, p in obj.primary_temp.items()}
        m.erasure_code_profiles = {name: dict(p) for name, p in
                                   obj.erasure_code_profiles.items()}
        m.flags = int(obj.flags)
        return m

    def clone(self) -> "OSDMap":
        return copy.deepcopy(self)

    def ingest(self, full_map: "OSDMap | None",
               incrementals: list) -> "OSDMap":
        """Apply a map publish (full and/or incrementals) and return
        the resulting map — newer full maps replace, stale ones are
        ignored, incs apply in epoch order.  Shared by the OSD daemon
        and the Objecter (ref: OSD.cc handle_osd_map :8010,
        Objecter.cc handle_osd_map :1182)."""
        m = self
        if full_map is not None and full_map.epoch > m.epoch:
            m = full_map
        for inc in incrementals:
            if inc.epoch == m.epoch + 1:
                m.apply_incremental(inc)
        return m

    # ------------------------------------------------------------------
    # convenience builders (vstart-style, for tests/tools)
    def build_simple(self, n_osd: int, pg_pool: PGPool | None = None,
                     osds_per_host: int = 4) -> None:
        """osdmaptool --createsimple equivalent: flat host/osd straw2
        tree + one replicated pool (ref: src/osd/OSDMap.cc
        build_simple/build_simple_crush_map)."""
        from ..crush.types import (CRUSH_BUCKET_STRAW2, CrushBucket,
                                   CrushRule, CrushRuleStep,
                                   CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                   CRUSH_RULE_EMIT, CRUSH_RULE_TAKE)
        self.set_max_osd(n_osd)
        m = CrushMap()
        m.set_tunables_profile("jewel")
        host_ids = []
        for base in range(0, n_osd, osds_per_host):
            items = list(range(base, min(base + osds_per_host, n_osd)))
            w = [0x10000] * len(items)
            host_ids.append(m.add_bucket(CrushBucket(
                id=0, type=1, alg=CRUSH_BUCKET_STRAW2, items=items,
                item_weights=w, weight=sum(w))))
        hw = [m.bucket(h).weight for h in host_ids]
        root = m.add_bucket(CrushBucket(
            id=0, type=10, alg=CRUSH_BUCKET_STRAW2, items=host_ids,
            item_weights=hw, weight=sum(hw)))
        m.max_devices = n_osd
        m.rules.append(CrushRule(steps=[
            CrushRuleStep(CRUSH_RULE_TAKE, root),
            CrushRuleStep(CRUSH_RULE_CHOOSELEAF_FIRSTN, 0, 1),
            CrushRuleStep(CRUSH_RULE_EMIT),
        ]))
        self.crush = m
        for osd in range(n_osd):
            self.osd_state[osd] = CEPH_OSD_EXISTS | CEPH_OSD_UP
            self.osd_weight[osd] = CEPH_OSD_IN
        if pg_pool is None:
            pg_pool = PGPool(pg_num=max(64, n_osd * 4),
                             pgp_num=max(64, n_osd * 4))
        self.pools[0] = pg_pool
        self.pool_names[0] = "rbd"
        self.pool_max = 0
        self.epoch = 1


# ------------------------------------------------- wire registration
# OSDMap encodes as a versioned wire struct like the reference's
# OSDMap::encode (ref: src/osd/OSDMap.cc encode w/ ENCODE_START).
def _register_wire() -> None:
    from ..msg.encoding import register_struct
    register_struct(Incremental, version=1, compat=1)
    register_struct(OSDMap, version=1, compat=1, fields=(
        "epoch", "fsid", "max_osd", "osd_state", "osd_weight",
        "osd_primary_affinity", "pools", "pool_names", "pool_max",
        "crush", "pg_upmap", "pg_upmap_items", "pg_temp",
        "primary_temp", "erasure_code_profiles", "flags"))


_register_wire()
