"""The CPU rehearsal of chip_smoke.py's phase 19 (g4), `MultisiteLeg`.

The leg runs as the smoke runs it, every check kept, on a threaded
7-OSD `MiniCluster(device="cpu")` at reduced counts (2 x 4 MiB and 32 x
4 KiB objects on z1, 8 on z2, 4 versions and a delete marker, 4
DELETEs, 8 PUTs while z2 is killed): two zones converge after the
writes, the kill and restart (no full sync) and the partition and heal,
with every index shard and object equal across the zones and to the
leg's model; the mgr's /metrics and restful API and `rados rgw
sync-status` equal what they read; swallowed errors, failed sync
rounds, error lists and K1 launches 0; both zone pools removed.
"""
import importlib.util
from pathlib import Path

from ceph_tpu_torch.osd import snap_mapper
from ceph_tpu_torch.testing import MiniCluster


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ms", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_multisite_leg_rehearsal(capsys, monkeypatch):
    cs = _smoke()
    # the smoke holds this process-wide count to 0 in a fresh process;
    # another test's pin may have counted one here
    monkeypatch.setitem(snap_mapper.PURGED_DECODE_ERRORS, "count", 0)
    c = MiniCluster(n_osd=7, threaded=True, device="cpu")
    try:
        c.wait_all_up()
        r = c.rados()
        out = cs.MultisiteLeg(c, r, large=2, small=32, z2_small=8,
                              deletes=4, kill_small=8).run(
            cs.SimClock(c, 1000.0))
        cs.print_multisite(out, "the CPU (device='cpu')")
        pools = set(c.mon.osdmap.pool_names.values())
    finally:
        c.shutdown()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(ln.startswith("phase 19 (g4): ")
                                   for ln in lines)
    assert out["faults"] == {"swallowed": 0, "tick_errors": 0,
                             "error_lists": 0, "k1": 0}
    assert out["k1"] == 0 and out["restart_full_syncs"] == 0
    assert out["quarantined"] == 0 and out["backoff_failures"] >= 2
    # 32 - 4 small + 2 large on z1, 8 more while z2 was down, 1 while
    # partitioned; 8 on z2; the versioned key's stack
    assert out["index_heal"]["entries"] == 2 + 28 + 8 + 1 + 4 + 8 + 1
    assert out["index_heal"]["objects"] == 2 + 28 + 8 + 1 + 8
    assert out["index"]["gets"] == 2 + 28 + 8
    assert not {"rgw-z1", "rgw-z2"} & pools
