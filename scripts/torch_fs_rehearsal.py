"""CPU rehearsal of chip_smoke.py's file-system leg (phase 19 (f) `FsLeg`).

    python scripts/torch_fs_rehearsal.py [--scale 1] [--osds 16] [--k 8 --m 4]

Runs on the CPU (the port's cluster with `device="cpu"`), no card needed:
`FsLeg` with its file counts divided by `--scale` (4 MiB files kept) on a
threaded `--osds` cluster whose data pool is `tpu` k=`--k` m=`--m` over
hosts (one OSD each), pg_num 32: `before_kill`, the OSD in the most
acting sets of the data pool killed and marked down, `degraded`, `osd
out` to clean, `after_clean`; its lines are printed as the smoke prints
them.  K1's CUDA wrapper is stood in by its plain version, counting a
launch as the wrapper does.

Times are host-clock times of this machine's CPU, not the card's.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def leg(osds: int, scale: int, k: int, m: int) -> None:
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd.types import PG
    from ceph_tpu_torch.testing import MiniCluster

    def k1_stand_in(tables, data, r, _mat=None):
        bm.LAUNCHES["gf_matmul"] += 1
        return bm.gf_matmul_plain(_mat, data)

    bm.gf_matmul_cuda = k1_stand_in
    bm.gf_matmul = lambda tables, mat, data: bm.gf_matmul_cuda(
        tables, data, mat.shape[0], _mat=mat)
    cs.K, cs.M = k, m
    c = MiniCluster(n_osd=osds, osds_per_host=1, threaded=True,
                    device="cpu")
    c.wait_all_up()
    r = c.rados()
    rc, outs, _ = r.mon_command({
        "prefix": "osd erasure-code-profile set", "name": "fsr",
        "profile": {"plugin": "tpu", "k": str(k), "m": str(m),
                    "technique": "reed_sol_van",
                    "crush-failure-domain": "host"}})
    if rc != 0:
        raise SystemExit(outs)
    fsl = cs.FsLeg(c, r, large=cs.FS_LARGE // scale,
                   small=cs.FS_SMALL // scale, profile="fsr")
    try:
        fsl.before_kill()
        pid = r.pool_lookup(cs.FS_DATA)
        victim = cs._victim(cs.acting_sets(c.mon.osdmap, pid,
                                           cs.CLUSTER_PG_NUM, PG)[1])
        c.kill_osd(victim)
        r.mon_command({"prefix": "osd down", "ids": [victim]})
        cs._wait(c, lambda: r.objecter.osdmap.is_down(victim) and
                 cs._all_clean(c, r), "peering after osd down")
        fsl.degraded()
        t0 = time.monotonic()
        r.mon_command({"prefix": "osd out", "ids": [victim]})
        cs._wait(c, lambda: c.mon.osdmap.is_out(victim) and
                 cs._all_clean(c, r), "recovery to clean")
        fsl.after_clean({cs.FS_DATA: time.monotonic() - t0})
        cs.print_fs(fsl.out, "the CPU (device='cpu')")
    finally:
        fsl.close()
        c.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the leg's file counts by this")
    ap.add_argument("--osds", type=int, default=16)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--m", type=int, default=4)
    a = ap.parse_args(argv)
    leg(a.osds, a.scale, a.k, a.m)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
