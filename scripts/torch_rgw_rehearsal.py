"""CPU rehearsal of chip_smoke.py's S3 gateway leg (phase 19 (f) `RgwLeg`).

    python scripts/torch_rgw_rehearsal.py [--scale 4] [--osds 7]

Runs on the CPU (the port's cluster with `device="cpu"`), no card needed:
`RgwLeg` with its object counts divided by `--scale` (4 MiB objects
kept, 2 listing pages): `before_kill`, an OSD killed and marked down,
`degraded`, `osd out` to clean, `after_clean`; its lines are printed as
the smoke prints them.

Times are host-clock times of this machine's CPU, not the card's.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def leg(osds: int, scale: int) -> None:
    from ceph_tpu_torch.testing import MiniCluster

    large, small = cs.RGW_LARGE // scale, cs.RGW_SMALL // scale
    c = MiniCluster(n_osd=osds, threaded=True, device="cpu")
    c.wait_all_up()
    r = c.rados()
    rgw = cs.RgwLeg(c, r, large=large, small=small,
                    parts=max(2, cs.RGW_PARTS // scale),
                    degraded_small=cs.RGW_DEGRADED_SMALL // scale,
                    max_keys=(large + small) * 3 // 4)  # 2 pages
    try:
        rgw.before_kill()
        victim = 0
        c.kill_osd(victim)
        r.mon_command({"prefix": "osd down", "ids": [victim]})
        cs._wait(c, lambda: r.objecter.osdmap.is_down(victim) and
                 cs._all_clean(c, r), "peering after osd down")
        rgw.degraded()
        r.mon_command({"prefix": "osd out", "ids": [victim]})
        cs._wait(c, lambda: c.mon.osdmap.is_out(victim) and
                 cs._all_clean(c, r), "recovery to clean")
        rgw.after_clean()
        cs.print_rgw(rgw.out, "the CPU (device='cpu')")
    finally:
        rgw.close()
        c.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=4,
                    help="divide the leg's object counts by this")
    ap.add_argument("--osds", type=int, default=7)
    a = ap.parse_args(argv)
    leg(a.osds, a.scale)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
