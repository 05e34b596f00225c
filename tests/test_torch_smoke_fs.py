"""The CPU rehearsal of chip_smoke.py's phase 19 (f) file-system leg,
`FsLeg`.

The leg runs as the smoke runs it, every check kept, on a threaded
4-OSD `MiniCluster(device="cpu")` with a `tpu` k=2 m=1 data pool (host
failure domain, pg_num 8) at reduced counts (2 x 4 MiB and 16 x 4 KiB
files): K1's wrapper is stood in by its plain version, counting a launch
as the CUDA wrapper does, so the leg's split by kind is exercised.  One
OSD is killed and marked down between `before_kill` and `degraded`, and
`osd out` recovers to clean before `after_clean`, as phase 19 drives
them.  Every file reads back equal to the model healthy, degraded and
after clean; the standby takes over under the in-flight create, which
lands once; every data shard equals the plain encode; K1 launched for
the data pool's encodes, decodes and repairs; the file system's pools
are gone and the beacon settings back at the end.
"""
import importlib.util
import time
from pathlib import Path

from ceph_tpu_torch.common.options import global_config
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.osd import snap_mapper
from ceph_tpu_torch.testing import MiniCluster


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_fs", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_fs_leg_rehearsal(monkeypatch, capsys):
    cs = _smoke()

    def k1_stand_in(tables, data, r, _mat=None):
        bm.LAUNCHES["gf_matmul"] += 1
        return bm.gf_matmul_plain(_mat, data)

    def routed(tables, mat, data):
        return bm.gf_matmul_cuda(tables, data, mat.shape[0], _mat=mat)

    monkeypatch.setattr(bm, "gf_matmul_cuda", k1_stand_in)
    monkeypatch.setattr(bm, "gf_matmul", routed)
    monkeypatch.setattr(cs, "K", 2)
    monkeypatch.setattr(cs, "M", 1)
    # the smoke holds this process-wide count to 0 in a fresh process;
    # another test's pin may have counted one here
    monkeypatch.setitem(snap_mapper.PURGED_DECODE_ERRORS, "count", 0)
    beacons = {k: global_config()[k] for k in cs.FS_BEACON}
    c = MiniCluster(n_osd=4, threaded=True, device="cpu")
    try:
        c.wait_all_up()
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "fsr",
            "profile": {"plugin": "tpu", "k": "2", "m": "1",
                        "technique": "reed_sol_van",
                        "crush-failure-domain": "host"}})
        assert rc == 0, outs
        fsl = cs.FsLeg(c, r, large=2, small=16, profile="fsr", pg_num=8)
        try:
            fsl.before_kill()
            victim = 1
            c.kill_osd(victim)
            assert r.mon_command({"prefix": "osd down",
                                  "ids": [victim]})[0] == 0
            cs._wait(c, lambda: r.objecter.osdmap.is_down(victim) and
                     cs._all_clean(c, r), "peering after osd down")
            fsl.degraded()
            t0 = time.monotonic()
            assert r.mon_command({"prefix": "osd out",
                                  "ids": [victim]})[0] == 0
            cs._wait(c, lambda: c.mon.osdmap.is_out(victim) and
                     cs._all_clean(c, r), "recovery to clean")
            fsl.after_clean({cs.FS_DATA: time.monotonic() - t0})
        finally:
            fsl.close()
        cs.print_fs(fsl.out, "the CPU (device='cpu')")
        pools = set(c.mon.osdmap.pool_names.values())
    finally:
        c.shutdown()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7 and all(ln.startswith("phase 19 (f) fs: ")
                                   for ln in lines)
    out = fsl.out
    assert out["faults"] == {"swallowed": 0, "dispatch_errors": 0}
    k1 = out["k1"]
    assert k1["encode"] > 0 and k1["decode"] > 0 and k1["repair"] > 0
    assert out["degraded_decodes"] > 0
    # 2 large + 16 small + the revoked file, one shard per chunk (k+m=3)
    assert out["shards_checked"] == (2 + 16 + 1) * 3
    assert out["epoch_up"] < out["epoch_takeover"] <= out["epoch_after"]
    assert not {cs.FS_DATA, cs.FS_META} & pools
    assert {k: global_config()[k] for k in cs.FS_BEACON} == beacons
