"""pg_autoscaler: grow pool pg_num toward the per-OSD PG target.

The mgr module (ref: src/pybind/mgr/pg_autoscaler/module.py —
`_get_pool_status` computes a per-pool target from the capacity share
and `mon_target_pg_per_osd`, `_maybe_adjust` applies it when the
current pg_num is off by the threshold factor 3).  Reduced faithfully:

* target_pg(pool) = next_pow2(share * n_osd_in * mon_target_pg_per_osd
  / replication_factor), share = the pool's byte share of stored data
  (equal split while nothing is stored yet — the `bulk` flag analogue);
* applied only when target >= threshold * pg_num (default 3.0, the
  reference's hysteresis) — and only upward: the framework supports
  splitting (OSD-side collection split, daemon._split_pgs) but not
  merging, matching pg_num reduction being refused by the mon;
* `osd pool set pg_num` first (cheap local collection split keeping
  children on the parent's placement seed), then the NEXT tick grows
  pgp_num to match — the placement reseed whose data movement the
  peering statechart chases via prior-interval queries + reservation-
  throttled backfill (osd/peering.py; the reference likewise splits
  with pg_num first and walks pgp_num up afterwards).

The port's copy of `ceph_tpu.mgr.pg_autoscaler`, whole.
"""
from __future__ import annotations

from ..common.log import dout
from ..common.options import global_config


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class PGAutoscaler:
    """Runs inside MgrDaemon ticks (ref: pg_autoscaler serve loop)."""

    def __init__(self, mgr, threshold: float = 3.0,
                 max_pg_num: int = 1 << 14):
        self.mgr = mgr
        self.threshold = threshold
        self.max_pg_num = max_pg_num
        self.last_plan: list[dict] = []

    # ------------------------------------------------------------ plan
    def plan(self, osdmap, pool_bytes: dict[int, int] | None = None
             ) -> list[dict]:
        """Per-pool targets (ref: _get_pool_status)."""
        n_in = sum(1 for o in range(osdmap.max_osd) if osdmap.is_in(o))
        if not n_in or not osdmap.pools:
            return []
        target_per_osd = global_config()["mon_target_pg_per_osd"]
        pool_bytes = pool_bytes or {}
        total = sum(pool_bytes.get(p, 0) for p in osdmap.pools)
        out = []
        for pid, pool in osdmap.pools.items():
            if total > 0:
                share = pool_bytes.get(pid, 0) / total
                # floor: even an empty pool keeps a minimum footprint
                share = max(share, 0.1 / len(osdmap.pools))
            else:
                share = 1.0 / len(osdmap.pools)
            repl = max(1, pool.size)
            raw = share * n_in * target_per_osd / repl
            target = min(self.max_pg_num, next_pow2(max(4, int(raw))))
            out.append({
                "pool_id": pid,
                "pool_name": osdmap.pool_names.get(pid, str(pid)),
                "pg_num": pool.pg_num,
                "target": target,
                "would_adjust": target >= self.threshold * pool.pg_num,
            })
        return out

    # ----------------------------------------------------------- apply
    def tick(self, pool_bytes: dict[int, int] | None = None) -> int:
        """Plan + apply (ref: _maybe_adjust).  Returns commands sent.

        pgp_num follows pg_num one step behind (ref: the reference's
        gradual pgp_num increase honoring the misplaced-ratio target):
        the tick after a split, placement reseeds and the peering
        statechart's prior-interval backfill migrates the split data;
        the step-behind cadence keeps split (cheap, local) and reseed
        (data movement, reservation-throttled) in separate epochs."""
        osdmap = self.mgr.osdmap
        if osdmap.epoch == 0:
            return 0
        self.last_plan = self.plan(osdmap, pool_bytes)
        sent = 0
        for p in self.last_plan:
            pool = osdmap.pools.get(p["pool_id"])
            if pool is not None and pool.pgp_num < pool.pg_num:
                # both pool types: the peering statecharts chase a
                # reseed through prior-interval queries + backfill
                # (replicated osd/peering.py; EC osd/ec_peering.py)
                dout("mgr", 1).write(
                    "pg_autoscaler: pool %s pgp_num %d -> %d (reseed)",
                    p["pool_name"], pool.pgp_num, pool.pg_num)
                self.mgr._command({"prefix": "osd pool set",
                                   "pool": p["pool_name"],
                                   "var": "pgp_num",
                                   "val": str(pool.pg_num)})
                sent += 1
                continue
            if not p["would_adjust"]:
                continue
            dout("mgr", 1).write(
                "pg_autoscaler: pool %s pg_num %d -> %d",
                p["pool_name"], p["pg_num"], p["target"])
            self.mgr._command({"prefix": "osd pool set",
                               "pool": p["pool_name"],
                               "var": "pg_num",
                               "val": str(p["target"])})
            sent += 1
        return sent

    def status(self) -> list[dict]:
        return list(self.last_plan)
