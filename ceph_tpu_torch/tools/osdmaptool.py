"""osdmaptool equivalent: build simple maps and bulk-map all PGs.

CLI port of the reference's test/inspection tool
(ref: src/tools/osdmaptool.cc: --createsimple :31, --test-map-pgs
:38,:198, stats block :491-615) with the bulk mapping computed by the
batch CRUSH engine (ceph_tpu_torch.osd.mapping.OSDMapMapping: K3 on the
card by default, its plain version with `--device cpu`) instead of a
per-PG loop, and --upmap through the balancer on the same tables.

The port's copy of `ceph_tpu.tools.osdmaptool`; map files and output are
interchangeable with the reference tool's.

Usage:
  python -m ceph_tpu_torch.tools.osdmaptool --createsimple 100 om.json
  python -m ceph_tpu_torch.tools.osdmaptool om.json --test-map-pgs [--pg-num N]
  python -m ceph_tpu_torch.tools.osdmaptool om.json --upmap out.txt \
      [--upmap-max 10 --upmap-deviation 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from ..crush.codec import crush_from_json, crush_to_json
from ..crush.types import CRUSH_ITEM_NONE
from ..osd.balancer import Balancer
from ..osd.mapping import OSDMapMapping
from ..osd.osdmap import OSDMap
from ..osd.types import PG, PGPool


def save_map(m: OSDMap, path: str) -> None:
    """Serialize the placement-relevant state as JSON."""
    data = {
        "epoch": m.epoch,
        "max_osd": m.max_osd,
        "osd_state": m.osd_state,
        "osd_weight": m.osd_weight,
        "osd_primary_affinity": m.osd_primary_affinity,
        "pools": {str(k): vars(p).copy() for k, p in m.pools.items()},
        "pool_names": {str(k): v for k, v in m.pool_names.items()},
        "pool_max": m.pool_max,
        "pg_upmap": [[pg.pool, pg.ps, osds]
                     for pg, osds in m.pg_upmap.items()],
        "pg_upmap_items": [[pg.pool, pg.ps, [list(p) for p in items]]
                           for pg, items in m.pg_upmap_items.items()],
        "pg_temp": [[pg.pool, pg.ps, osds]
                    for pg, osds in m.pg_temp.items()],
        "primary_temp": [[pg.pool, pg.ps, p]
                         for pg, p in m.primary_temp.items()],
        "erasure_code_profiles": m.erasure_code_profiles,
        # shared codec (crush/codec.py) — same crush encoding as
        # crushtool map files, choose_args included
        "crush": crush_to_json(m.crush),
    }
    with open(path, "w") as f:
        json.dump(data, f)


def load_map(path: str) -> OSDMap:
    with open(path) as f:
        data = json.load(f)
    m = OSDMap()
    m.epoch = data["epoch"]
    m.max_osd = data["max_osd"]
    m.osd_state = list(data["osd_state"])
    m.osd_weight = list(data["osd_weight"])
    m.osd_primary_affinity = data.get("osd_primary_affinity")
    for k, pd in data["pools"].items():
        pool = PGPool()
        for attr, v in pd.items():
            setattr(pool, attr, v)
        m.pools[int(k)] = pool
    m.pool_names = {int(k): v for k, v in data["pool_names"].items()}
    m.pool_max = data.get("pool_max", max(m.pools, default=-1))
    for pool, ps, osds in data.get("pg_upmap", []):
        m.pg_upmap[PG(pool, ps)] = list(osds)
    for pool, ps, items in data.get("pg_upmap_items", []):
        m.pg_upmap_items[PG(pool, ps)] = [tuple(p) for p in items]
    for pool, ps, osds in data.get("pg_temp", []):
        m.pg_temp[PG(pool, ps)] = list(osds)
    for pool, ps, p in data.get("primary_temp", []):
        m.primary_temp[PG(pool, ps)] = p
    m.erasure_code_profiles = data.get("erasure_code_profiles", {})
    m.crush = crush_from_json(data["crush"])
    return m


def test_map_pgs(m: OSDMap, pool_filter: int, pg_num: int,
                 dump: bool, device=None) -> None:
    """Stats block of osdmaptool.cc:491-615 (same output shape), from an
    OSDMapMapping.update() on `device` (None -> cuda).
    --pg-num is a test-only override: operates on a clone so the stored
    map is never mutated (matching the reference tool)."""
    if pool_filter != -1 and pool_filter not in m.pools:
        print(f"There is no pool {pool_filter}", file=sys.stderr)
        raise SystemExit(1)
    if pg_num > 0:
        m = m.clone()
        for pid, pool in m.pools.items():
            if pool_filter != -1 and pid != pool_filter:
                continue
            pool.pg_num = pool.pgp_num = pg_num
            pool.calc_pg_masks()
    n = m.max_osd
    count = np.zeros(n, dtype=np.int64)
    first_count = np.zeros(n, dtype=np.int64)
    primary_count = np.zeros(n, dtype=np.int64)
    size_hist: dict[int, int] = {}

    t0 = time.time()
    mapping = OSDMapMapping(device)
    mapping.update(m, pool_ids=None if pool_filter == -1
                   else {pool_filter})
    elapsed = time.time() - t0

    total_pgs = 0
    for pid, pool in m.pools.items():
        if pool_filter != -1 and pid != pool_filter:
            continue
        print(f"pool {pid} pg_num {pool.pg_num}")
        pm = mapping.pools[pid]
        total_pgs += pool.pg_num
        acting = pm.acting
        col = np.arange(acting.shape[1])
        valid = (acting != CRUSH_ITEM_NONE) & (acting >= 0) & \
            (col[None, :] < pm.acting_len[:, None])
        vals = acting[valid]
        count += np.bincount(vals, minlength=n)[:n]
        # reference counts the acting vector length incl. NONE holes
        # (osdmaptool.cc:534 size[osds.size()]++)
        sizes = pm.acting_len
        for s, c in zip(*np.unique(sizes, return_counts=True)):
            size_hist[int(s)] = size_hist.get(int(s), 0) + int(c)
        has = valid.any(axis=1)
        firsts = acting[np.arange(len(acting)),
                        np.argmax(valid, axis=1)][has]
        first_count += np.bincount(firsts, minlength=n)[:n]
        prims = pm.acting_primary[pm.acting_primary >= 0]
        primary_count += np.bincount(prims, minlength=n)[:n]
        if dump:
            for ps in range(pool.pg_num):
                osds = [int(o) for o in acting[ps][valid[ps]]]
                print(f"{pid}.{ps:x}\t{osds}\t{pm.acting_primary[ps]}")

    print("#osd\tcount\tfirst\tprimary\tc wt\twt")
    in_osds = [i for i in range(n)
               if m.is_in(i) and m.osd_weight[i] > 0]
    for i in in_osds:
        print(f"osd.{i}\t{count[i]}\t{first_count[i]}\t"
              f"{primary_count[i]}\t1.0\t{m.osd_weight[i] / 0x10000:g}")
    n_in = len(in_osds)
    total = int(count[in_osds].sum()) if in_osds else 0
    avg = total // n_in if n_in else 0
    dev = math.sqrt(sum((avg - int(count[i])) ** 2
                        for i in in_osds) / n_in) if n_in else 0.0
    edev = math.sqrt(total / n_in * (1.0 - 1.0 / n_in)) if n_in else 0.0
    print(f" in {n_in}")
    if avg:
        print(f" avg {avg} stddev {dev:g} ({dev / avg:g}x) "
              f"(expected {edev:g} {edev / avg:g}x))")
    nz = count[in_osds]
    if n_in and nz.any():
        min_i = in_osds[int(np.argmin(np.where(nz > 0, nz, nz.max() + 1)))]
        max_i = in_osds[int(np.argmax(nz))]
        print(f" min osd.{min_i} {count[min_i]}")
        print(f" max osd.{max_i} {count[max_i]}")
    for s in sorted(size_hist):
        print(f"size {s}\t{size_hist[s]}")
    rate = total_pgs / elapsed if elapsed > 0 else float("inf")
    print(f"mapped {total_pgs} pgs in {elapsed:.3f}s "
          f"({rate:,.0f} pg/s)", file=sys.stderr)


def do_upmap(m: OSDMap, out_path: str, deviation: int, max_changes: int,
             pools: list[int], device=None) -> bool:
    """--upmap: run the balancer and write the resulting commands
    (ref: src/tools/osdmaptool.cc:48 usage, :331-404 upmap block).
    Applies the upmaps to the in-memory map (so a --test-map-pgs in the
    same invocation sees the balanced layout) and returns True when
    changes were prepared; the mapfile itself is only rewritten under
    --upmap-save, like the reference tool.  The balancer's tables are
    computed on `device` (None -> cuda)."""
    b = Balancer(max_deviation=deviation, max_iterations=max_changes,
                 device=device)
    inc = b.optimize(m, pools=pools or None)
    lines = []
    for pg in sorted(inc.old_pg_upmap_items):
        lines.append(f"ceph osd rm-pg-upmap-items {pg}")
    for pg, items in sorted(inc.new_pg_upmap_items.items()):
        pairs = " ".join(f"{frm} {to}" for frm, to in items)
        lines.append(f"ceph osd pg-upmap-items {pg} {pairs}")
    out = open(out_path, "w") if out_path != "-" else sys.stdout
    try:
        for ln in lines:
            print(ln, file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    n = len(lines)
    print(f"osdmaptool: upmap, max-count {max_changes}, "
          f"max deviation {deviation}", file=sys.stderr)
    print(f"prepared {n}/{max_changes} changes", file=sys.stderr)
    if n:
        inc.epoch = m.epoch + 1
        m.apply_incremental(inc)
    return bool(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="osdmaptool")
    ap.add_argument("mapfile")
    ap.add_argument("--createsimple", type=int, metavar="N")
    ap.add_argument("--osds-per-host", type=int, default=4)
    ap.add_argument("--pg-num", type=int, default=0)
    ap.add_argument("--pool", type=int, default=-1)
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--test-map-pgs-dump", action="store_true")
    ap.add_argument("--mark-down", type=int, action="append", default=[],
                    metavar="OSD")
    ap.add_argument("--mark-out", type=int, action="append", default=[],
                    metavar="OSD")
    ap.add_argument("--upmap", metavar="FILE",
                    help="calculate pg upmap entries to balance pg layout"
                         " and write the commands to FILE ('-' = stdout)")
    ap.add_argument("--upmap-max", type=int, default=10,
                    help="max upmap entries to calculate")
    ap.add_argument("--upmap-deviation", type=int, default=5,
                    help="max deviation from target pgs per osd")
    ap.add_argument("--upmap-pool", type=int, action="append", default=[],
                    metavar="POOL", help="restrict upmap balancing to pool")
    ap.add_argument("--upmap-save", action="store_true",
                    help="write the upmap results back to the mapfile")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where PGs are mapped: the card (K3) or the CPU "
                         "(its plain version)")
    args = ap.parse_args(argv)

    if args.createsimple:
        m = OSDMap()
        pool = PGPool(pg_num=args.pg_num or max(64, args.createsimple * 4),
                      pgp_num=args.pg_num or max(64, args.createsimple * 4))
        m.build_simple(args.createsimple, pool,
                       osds_per_host=args.osds_per_host)
        save_map(m, args.mapfile)
        print(f"osdmaptool: writing epoch {m.epoch} to {args.mapfile}")
        return 0

    try:
        m = load_map(args.mapfile)
    except FileNotFoundError:
        print(f"osdmaptool: error opening {args.mapfile}: "
              "no such file or directory", file=sys.stderr)
        return 1
    changed = False
    for osd in args.mark_down:
        m.osd_state[osd] &= ~2
        changed = True
    for osd in args.mark_out:
        m.osd_weight[osd] = 0
        changed = True
    if args.upmap:
        did = do_upmap(m, args.upmap, args.upmap_deviation,
                       args.upmap_max, args.upmap_pool, args.device)
        changed |= did and args.upmap_save
    if args.test_map_pgs or args.test_map_pgs_dump:
        test_map_pgs(m, args.pool, args.pg_num, args.test_map_pgs_dump,
                     args.device)
    if changed:
        save_map(m, args.mapfile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
