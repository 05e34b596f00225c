"""Full-cluster PG->OSD mapping tables: the batch placement path.

Replacement for OSDMapMapping/ParallelPGMapper (ref:
src/osd/OSDMapMapping.{h,cc}): where the reference shards the PGs of all
pools across a ThreadPool and runs crush per PG, this module maps each
pool's PGs in one call of the batch CRUSH engine (`crush.batch`, K3 on
the card: one launch and one copy back per pool) and applies the cheap
per-PG epilogue (upmap overrides, up filtering, primary affinity, temp
overrides) as vectorised numpy passes on the host with sparse per-row
fixups.

`OSDMapMapping(device=None)` runs on the card; `device="cpu"` runs the
batch engine's plain version.  A crush map that the batch engine refuses
(legacy bucket algorithms etc.: BatchUnsupported, raised before any device
work) goes through the scalar OSDMap pipeline for that pool, and
`FALLBACKS["batch_unsupported"]` counts each such pool.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import device as _device
from ..crush.batch import BatchUnsupported, compile_map
from ..crush.hashes import hash32_2
from ..crush.types import CRUSH_ITEM_NONE
from .osdmap import CEPH_OSD_DEFAULT_PRIMARY_AFFINITY, OSDMap
from .types import PG

#: pools mapped through the scalar engine because the batch engine
#: refused the map, counted where it happens
FALLBACKS = {"batch_unsupported": 0}


def reset_fallbacks() -> None:
    for name in FALLBACKS:
        FALLBACKS[name] = 0


@dataclass
class PoolMapping:
    """Placement table for one pool: row = pg.ps.

    acting rows may be wider than pool.size (a backfill pg_temp can
    name more osds than the pool size) or logically shorter (a partial
    pg_temp on an EC pool); acting_len holds each row's true length."""
    pool_id: int
    up: np.ndarray               # (pg_num, size) int32, NONE holes
    up_primary: np.ndarray       # (pg_num,) int32 (-1 none)
    acting: np.ndarray           # (pg_num, acting_width) int32
    acting_primary: np.ndarray   # (pg_num,) int32
    acting_len: np.ndarray       # (pg_num,) int32 — true row lengths
    up_len: np.ndarray           # (pg_num,) int32


class OSDMapMapping:
    """Precomputed pg->osd tables + reverse osd->pg map
    (ref: src/osd/OSDMapMapping.h:170), computed on `device`."""

    def __init__(self, device=None) -> None:
        self.device = _device.resolve(device)
        self.epoch = -1
        self.pools: dict[int, PoolMapping] = {}
        self._shift_flags: dict[int, bool] = {}
        # compiled crush cache shared across pools of one update
        self._cc_cache: dict = {}

    # ------------------------------------------------------------------
    def update(self, osdmap: OSDMap, pool_ids=None) -> None:
        """Recompute tables for the map's current epoch.  With pool_ids
        given, only those pools are recomputed in place and other pools'
        tables are kept (ref: OSDMapMapping.cc:45 update(map) /
        update(map, pool))."""
        self._cc_cache = {}
        if pool_ids is None:
            self.pools = {}
            pool_ids = set(osdmap.pools)
        for pool_id in sorted(pool_ids):
            if pool_id in osdmap.pools:
                self.pools[pool_id] = self._map_pool(osdmap, pool_id)
            else:
                self.pools.pop(pool_id, None)
        self.epoch = osdmap.epoch

    def get(self, pg: PG) -> tuple[list[int], int, list[int], int]:
        """(up, up_primary, acting, acting_primary) for one pg; empty
        results for unknown pools / out-of-range ps.

        The tables are indexed by *actual* pg ids (ps already in
        [0, pg_num)); a raw/out-of-range ps is the caller's bug, so it
        is rejected rather than folded (ref: OSDMapMapping.h:294
        ceph_assert(pgid.ps() < p->second.pg_num), which never folds)."""
        pm = self.pools.get(pg.pool)
        if pm is None:
            return [], -1, [], -1
        if not (0 <= pg.ps < len(pm.up)):
            return [], -1, [], -1
        shift = self._shift_flags[pg.pool]
        up_row = pm.up[pg.ps][:pm.up_len[pg.ps]]
        acting_row = pm.acting[pg.ps][:pm.acting_len[pg.ps]]
        up = [int(o) for o in up_row
              if not (shift and o == CRUSH_ITEM_NONE)]
        acting = [int(o) for o in acting_row
                  if not (shift and o == CRUSH_ITEM_NONE)]
        return (up, int(pm.up_primary[pg.ps]),
                acting, int(pm.acting_primary[pg.ps]))

    def get_osd_acting_pgs(self, osd: int) -> list[PG]:
        """Reverse map (ref: OSDMapMapping.cc:60 _build_rmap)."""
        out: list[PG] = []
        for pool_id, pm in self.pools.items():
            rows = np.nonzero((pm.acting == osd).any(axis=1))[0]
            out.extend(PG(pool_id, int(ps)) for ps in rows)
        return out

    def osd_pg_counts(self, n_osd: int, acting: bool = True) -> np.ndarray:
        """PGs per OSD across all pools (balancer/score input)."""
        counts = np.zeros(n_osd, dtype=np.int64)
        for pm in self.pools.values():
            t = pm.acting if acting else pm.up
            vals = t[(t != CRUSH_ITEM_NONE) & (t >= 0)]
            counts += np.bincount(vals, minlength=n_osd)[:n_osd]
        return counts

    # ------------------------------------------------------------------
    def _compiled(self, osdmap: OSDMap, pool_id: int):
        """CompiledCrushMap shared across pools with identical
        (crush, resolved choose_args): the tables are staged on the
        device once per update."""
        args = osdmap.crush.choose_args_get_with_fallback(pool_id)
        key = (id(osdmap.crush), id(args) if args is not None else None)
        cc = self._cc_cache.get(key)
        if cc is None:
            cc = compile_map(osdmap.crush, choose_args=args,
                             device=self.device)
            self._cc_cache[key] = cc
        return cc

    def _raw_batch(self, osdmap: OSDMap, pool_id: int, pps: np.ndarray,
                   ruleno: int, size: int):
        """Raw crush rows and counts of every PG of the pool: the whole
        pool in one map_batch call, copied to the host once."""
        cc = self._compiled(osdmap, pool_id)
        weights = np.asarray(osdmap.osd_weight, dtype=np.int64)
        res, cnt = cc.map_batch(pps, weights, ruleno=ruleno,
                                result_max=size, return_counts=True)
        return res.cpu().numpy(), cnt.cpu().numpy()

    def _map_pool(self, osdmap: OSDMap, pool_id: int) -> PoolMapping:
        pool = osdmap.pools[pool_id]
        self._shift_flags[pool_id] = pool.can_shift_osds()
        npg = pool.pg_num
        size = pool.size
        pss = np.arange(npg, dtype=np.int64)
        pps = pool.raw_pg_to_pps_batch(pss, pool_id)
        ruleno = osdmap.crush.find_rule(pool.crush_rule, pool.type, size)

        raw = np.full((npg, size), CRUSH_ITEM_NONE, dtype=np.int32)
        counts = np.zeros(npg, dtype=np.int32)
        if ruleno >= 0:
            try:
                raw, counts = self._raw_batch(osdmap, pool_id, pps, ruleno,
                                              size)
            except BatchUnsupported:
                FALLBACKS["batch_unsupported"] += 1
                from ..crush import mapper as crush_mapper
                ca = osdmap.crush.choose_args_get_with_fallback(pool_id)
                for ps in range(npg):
                    r = crush_mapper.do_rule(
                        osdmap.crush, ruleno, int(pps[ps]), size,
                        osdmap.osd_weight, choose_args=ca)
                    raw[ps, :len(r)] = r
                    counts[ps] = len(r)

        # mask out positions beyond each row's result count
        col = np.arange(size)
        raw = np.where(col[None, :] < counts[:, None], raw,
                       CRUSH_ITEM_NONE)

        state = np.zeros(max(osdmap.max_osd, 1), dtype=np.int64)
        state[:osdmap.max_osd] = osdmap.osd_state
        exists = (state & 1) != 0          # CEPH_OSD_EXISTS
        up_mask = exists & ((state & 2) != 0)  # CEPH_OSD_UP

        def lookup(table: np.ndarray, t: np.ndarray) -> np.ndarray:
            idx = np.clip(t, 0, len(table) - 1)
            ok = (t >= 0) & (t < osdmap.max_osd)
            return np.where(ok, table[idx], False)

        # _remove_nonexistent_osds (OSDMap.cc:2208)
        valid = raw != CRUSH_ITEM_NONE
        keep = valid & lookup(exists, raw)
        raw, counts = self._filter(pool, raw, keep, counts)

        # _raw_to_up_osds (OSDMap.cc:2309)
        valid = raw != CRUSH_ITEM_NONE
        keep = valid & lookup(up_mask, raw)
        up, up_len = self._filter(pool, raw, keep, counts)

        # primary = first non-NONE (OSDMap.cc:2252)
        up_primary = self._first_valid(up)

        # _apply_primary_affinity (OSDMap.cc:2334) — skip entirely when
        # all affinities are default, like the reference
        if osdmap.osd_primary_affinity is not None:
            aff = np.asarray(osdmap.osd_primary_affinity, dtype=np.int64)
            if (aff != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY).any():
                up, up_primary = self._apply_affinity(
                    pool, pps, up, up_primary, aff)

        acting = up.copy()
        acting_primary = up_primary.copy()
        acting_len = up_len.copy()

        # sparse overrides (upmap / pg_temp / primary_temp): recompute
        # those rows through the scalar pipeline wholesale — exactness
        # guaranteed, and rows may be wider than pool.size (backfill
        # pg_temp) or shorter (partial temp on an EC pool)
        special = {
            pg.ps for src in (osdmap.pg_upmap, osdmap.pg_upmap_items,
                              osdmap.pg_temp, osdmap.primary_temp)
            for pg in src if pg.pool == pool_id and pg.ps < npg}
        if special:
            rows = {ps: osdmap.pg_to_up_acting_osds(PG(pool_id, ps))
                    for ps in sorted(special)}
            width = max([size] + [max(len(r[0]), len(r[2]))
                                  for r in rows.values()])
            if width > size:
                pad = np.full((npg, width - size), CRUSH_ITEM_NONE,
                              dtype=np.int32)
                up = np.concatenate([up, pad], axis=1)
                acting = np.concatenate([acting, pad], axis=1)
            for ps, (u, upp, a, actp) in rows.items():
                up[ps] = CRUSH_ITEM_NONE
                up[ps, :len(u)] = u
                up_len[ps] = len(u)
                up_primary[ps] = upp
                acting[ps] = CRUSH_ITEM_NONE
                acting[ps, :len(a)] = a
                acting_len[ps] = len(a)
                acting_primary[ps] = actp

        return PoolMapping(pool_id, up, up_primary, acting,
                           acting_primary, acting_len, up_len)

    @staticmethod
    def _filter(pool, table: np.ndarray, keep: np.ndarray,
                lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Drop filtered entries: EC pools keep position (NONE holes,
        length unchanged); replicated pools compact left and shrink
        (OSDMap.cc:2211-2231,2311-2331).  Returns (table, lengths)."""
        out = np.where(keep, table, CRUSH_ITEM_NONE)
        if not pool.can_shift_osds():
            return out, lengths.copy()
        new_len = keep.sum(axis=1).astype(np.int32)
        # vectorized stable left-compaction: NONE entries sort last
        order = np.argsort(out == CRUSH_ITEM_NONE, axis=1, kind="stable")
        out = np.take_along_axis(out, order, axis=1)
        return out, new_len

    @staticmethod
    def _first_valid(table: np.ndarray) -> np.ndarray:
        valid = table != CRUSH_ITEM_NONE
        has = valid.any(axis=1)
        first = np.argmax(valid, axis=1)
        prim = table[np.arange(len(table)), first]
        return np.where(has, prim, -1).astype(np.int32)

    @staticmethod
    def _apply_affinity(pool, pps, up, up_primary, aff):
        """Vectorized _apply_primary_affinity (OSDMap.cc:2334-2387)."""
        valid = up != CRUSH_ITEM_NONE
        idx = np.clip(up, 0, len(aff) - 1)
        a = np.where(valid, aff[idx], CEPH_OSD_DEFAULT_PRIMARY_AFFINITY)
        any_custom = (a != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY).any(axis=1)
        # rejection draw per entry
        draws = hash32_2(np.broadcast_to(pps[:, None], up.shape).ravel(),
                         up.ravel()).reshape(up.shape).astype(np.int64)
        reject = valid & (a < 0x10000) & ((draws >> 16) >= a)
        accept = valid & ~reject
        has_accept = accept.any(axis=1)
        first_accept = np.argmax(accept, axis=1)
        has_valid = valid.any(axis=1)
        first_valid = np.argmax(valid, axis=1)
        pos = np.where(has_accept, first_accept,
                       np.where(has_valid, first_valid, -1))
        rows = np.nonzero(any_custom & (pos >= 0))[0]
        up = up.copy()
        up_primary = up_primary.copy()
        for r in rows:
            p = int(pos[r])
            up_primary[r] = up[r, p]
            if pool.can_shift_osds() and p > 0:
                up[r, 1:p + 1] = up[r, 0:p]
                up[r, 0] = up_primary[r]
        return up, up_primary
