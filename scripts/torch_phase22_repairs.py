"""Phase 22's chaos schedule at full width on the CPU, in one package,
counting the compiled repairs.

    JAX_PLATFORMS=cpu python scripts/torch_phase22_repairs.py ref [--reboot]
    python scripts/torch_phase22_repairs.py port

Runs chip_smoke.py phase 22's cluster (three mons, 16 OSDs, `tpu` k=8
m=4, pg_num 32, 16 seeded 4 MiB objects) and its `ChaosRunner` schedule
(tests/test_chaos.py:84-92 and the primary cut :120-137, fault_seed 7,
runner seed 1) on the CPU with either package, and prints one JSON line:
the compiled repairs (`ecutil.compiled_repair_streams` calls), the
repair programs compiled and their compile probes (`interpret_plan`
calls), the acked writes, the fault digest and counts; for the port
also K1's launches (its plain version, counted).  `--reboot` applies to
the reference the port's one documented rule difference, for this
comparison only: a live OSD that a new map shows down boots again.
Without it the reference's run stops on an InvariantViolation (its
falsely downed OSDs stay down and every PG stays degraded).  The
reference run takes about 4 minutes on 8 cores, the port's 30 s.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    kind = argv[0]
    if kind == "ref":
        from ceph_tpu.ec.repairc import cache, compiler
        from ceph_tpu.msg.messages import MOSDBoot
        from ceph_tpu.osd import daemon, ecutil
        from ceph_tpu.testing import ChaosRunner, MiniCluster
        kw = {}
        if "--reboot" in argv:
            handle_map = daemon.OSDDaemon._handle_map

            def reboot(self, msg):
                me = self.whoami
                was_up = me < self.osdmap.max_osd and self.osdmap.is_up(me)
                handle_map(self, msg)
                if was_up and self.osdmap.exists(me) and \
                        not self.osdmap.is_up(me):
                    self.ms.connect(self.mon).send_message(MOSDBoot(osd=me))
            daemon.OSDDaemon._handle_map = reboot
    else:
        from ceph_tpu_torch.ec.kernels import bitmatmul as bm
        from ceph_tpu_torch.ec.repairc import cache, compiler
        from ceph_tpu_torch.osd import ecutil
        from ceph_tpu_torch.testing import ChaosRunner, MiniCluster
        kw = {"device": "cpu"}
        plain = bm.gf_matmul

        def counted(tables, mat, data):
            bm.LAUNCHES["gf_matmul"] += 1
            return plain(tables, mat, data)
        bm.gf_matmul = counted
    counts = {"runs": 0, "compiles": 0, "probes": 0}
    for mod, name, key in ((ecutil, "compiled_repair_streams", "runs"),
                           (cache, "compile_program", "compiles"),
                           (compiler, "interpret_plan", "probes")):
        def call(*a, _fn=getattr(mod, name), _key=key, **k):
            counts[_key] += 1
            return _fn(*a, **k)
        setattr(mod, name, call)
    t0 = time.monotonic()
    c = MiniCluster(n_osd=cs.CLUSTER_OSDS, osds_per_host=1, n_mon=3,
                    threaded=False, fault_seed=cs.CHAOS_FAULT_SEED, **kw)
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados(timeout=cs.CLUSTER_TIMEOUT_S)
        rc, outs, _ = r.mon_command(cs.PROFILE_CMD)
        if rc != 0:
            raise SystemExit(f"profile set: {outs}")
        r.pool_create("ecpool", pg_num=cs.CLUSTER_PG_NUM,
                      pool_type="erasure", erasure_code_profile="tpu_k8m4")
        c.pump()
        io = r.open_ioctx("ecpool")
        rng = np.random.default_rng(cs.SEED + 22)
        objs = {f"pre{i:02d}": rng.bytes(cs.REPAIR_OBJECT)
                for i in range(cs.CHAOS_OBJECTS)}
        for oid, data in objs.items():
            io.write_full(oid, data)
        runner = ChaosRunner(c, cs.CHAOS_SCHEDULE, rados=r, pool="ecpool",
                             seed=cs.CHAOS_RUNNER_SEED)
        try:
            report = runner.run()
        except Exception as e:
            print(json.dumps({"kind": kind, "counts": counts,
                              "failed": str(e)[:300]}))
            return 1
        out = {"kind": kind, "counts": counts,
               "repairs_with_probes": counts["runs"] + counts["probes"],
               "acked": report["acked"], "ops_total": report["ops_total"],
               "fault_digest": report["fault_digest"],
               "fault_counts": report["fault_counts"],
               "reads_ok": all(io.read(o) == d for o, d in objs.items()),
               "wall_s": time.monotonic() - t0}
        if kind == "port":
            out["k1_launches"] = bm.LAUNCHES["gf_matmul"]
    finally:
        c.shutdown()
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
