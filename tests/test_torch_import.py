"""The port imports with JAX blocked and loads nothing of `ceph_tpu`."""
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import ceph_tpu_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        ceph_tpu_torch.__path__, "ceph_tpu_torch."))
    for name in names:
        importlib.import_module(name)
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu."))
    print(json.dumps({"modules": names, "leaked": leaked}))
""")


def test_port_imports_without_jax_or_reference():
    import json
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    for name in ("ceph_tpu_torch.ec.gf", "ceph_tpu_torch.ec.interface",
                 "ceph_tpu_torch.ec.registry",
                 "ceph_tpu_torch.ec.matrix_code",
                 "ceph_tpu_torch.ec.kernels.bitmatmul",
                 "ceph_tpu_torch.ec.kernels._build",
                 "ceph_tpu_torch.ec.plugins.tpu",
                 "ceph_tpu_torch.osd.ecutil", "ceph_tpu_torch.device",
                 "ceph_tpu_torch.crush._ln_tables",
                 "ceph_tpu_torch.crush.types", "ceph_tpu_torch.crush.hashes",
                 "ceph_tpu_torch.crush.mapper",
                 "ceph_tpu_torch.crush.testing",
                 "ceph_tpu_torch.crush.batch", "ceph_tpu_torch.osd.types",
                 "ceph_tpu_torch.osd.osdmap", "ceph_tpu_torch.osd.mapping",
                 "ceph_tpu_torch.ec.gfw", "ceph_tpu_torch.ec.bitmatrix",
                 "ceph_tpu_torch.ec.plugins.jerasure",
                 "ceph_tpu_torch.ec.plugins.isa",
                 "ceph_tpu_torch.ec.plugins.shec",
                 "ceph_tpu_torch.ec.plugins.lrc",
                 "ceph_tpu_torch.ec.plugins.clay",
                 "ceph_tpu_torch.ec.repairc",
                 "ceph_tpu_torch.ec.repairc.plan",
                 "ceph_tpu_torch.ec.repairc.compiler",
                 "ceph_tpu_torch.ec.repairc.cache",
                 "ceph_tpu_torch.common.crc32c",
                 "ceph_tpu_torch.crush.wrapper", "ceph_tpu_torch.crush.codec",
                 "ceph_tpu_torch.crush.compiler",
                 "ceph_tpu_torch.crush.tester",
                 "ceph_tpu_torch.tools.crushtool",
                 "ceph_tpu_torch.crush.remap", "ceph_tpu_torch.common.log",
                 "ceph_tpu_torch.osd.balancer",
                 "ceph_tpu_torch.tools.osdmaptool",
                 "ceph_tpu_torch.common.devguard",
                 "ceph_tpu_torch.common.options",
                 "ceph_tpu_torch.common.lockdep",
                 "ceph_tpu_torch.common.racecheck",
                 "ceph_tpu_torch.dist", "ceph_tpu_torch.dist.mesh_ec",
                 "ceph_tpu_torch.dist.fabric",
                 "ceph_tpu_torch.tools.ec_bench",
                 "ceph_tpu_torch.msg", "ceph_tpu_torch.msg.encoding",
                 "ceph_tpu_torch.msg.messenger",
                 "ceph_tpu_torch.msg.messages",
                 "ceph_tpu_torch.common.tracing",
                 "ceph_tpu_torch.common.perf_counters",
                 "ceph_tpu_torch.store", "ceph_tpu_torch.store.objectstore",
                 "ceph_tpu_torch.store.memstore",
                 "ceph_tpu_torch.osd.pg_types", "ceph_tpu_torch.osd.pg_log",
                 "ceph_tpu_torch.osd.mutations",
                 "ceph_tpu_torch.osd.replicated_backend",
                 "ceph_tpu_torch.osd.snap_mapper",
                 "ceph_tpu_torch.osd.ec_backend",
                 # the cluster: messenger, mon, OSD daemon, client
                 "ceph_tpu_torch.msg.faults",
                 "ceph_tpu_torch.msg.mon_client",
                 "ceph_tpu_torch.common.backoff",
                 "ceph_tpu_torch.common.heartbeat_map",
                 "ceph_tpu_torch.common.tracked_op",
                 "ceph_tpu_torch.mon", "ceph_tpu_torch.mon.store",
                 "ceph_tpu_torch.mon.paxos",
                 "ceph_tpu_torch.mon.osd_monitor",
                 "ceph_tpu_torch.mon.pg_map",
                 "ceph_tpu_torch.mon.monitor",
                 "ceph_tpu_torch.osd.op_queue",
                 "ceph_tpu_torch.osd.peering",
                 "ceph_tpu_torch.osd.ec_peering",
                 "ceph_tpu_torch.osd.daemon",
                 "ceph_tpu_torch.client",
                 "ceph_tpu_torch.client.objecter",
                 "ceph_tpu_torch.client.rados",
                 "ceph_tpu_torch.testing",
                 "ceph_tpu_torch.testing.cluster",
                 # the transport, auth, processes and the dry run
                 "ceph_tpu_torch.analysis",
                 "ceph_tpu_torch.analysis.engine",
                 "ceph_tpu_torch.analysis.project",
                 "ceph_tpu_torch.analysis.rules",
                 "ceph_tpu_torch.compressor",
                 "ceph_tpu_torch.msg.secure", "ceph_tpu_torch.msg.tcp",
                 "ceph_tpu_torch.auth",
                 "ceph_tpu_torch.common.admin_socket",
                 "ceph_tpu_torch.tools.daemon_main",
                 "ceph_tpu_torch.tools.rados_cli",
                 "ceph_tpu_torch.dryrun",
                 # the durable stores and the offline tools
                 "ceph_tpu_torch.kv", "ceph_tpu_torch.store.bluestore",
                 "ceph_tpu_torch.store.journaled",
                 "ceph_tpu_torch.tools.objectstore_tool",
                 "ceph_tpu_torch.tools.monstore_tool",
                 # the paged artifact store and what it stands on
                 "ceph_tpu_torch.osdc", "ceph_tpu_torch.osdc.striper",
                 "ceph_tpu_torch.osdc.object_cacher",
                 "ceph_tpu_torch.osdc.rados_striper",
                 "ceph_tpu_torch.serve", "ceph_tpu_torch.serve.manifest",
                 "ceph_tpu_torch.serve.store",
                 # the mgr and the thrasher
                 "ceph_tpu_torch.common.obs",
                 "ceph_tpu_torch.mgr", "ceph_tpu_torch.mgr.daemon",
                 "ceph_tpu_torch.mgr.pg_autoscaler",
                 "ceph_tpu_torch.mgr.progress",
                 "ceph_tpu_torch.testing.thrasher"):
        assert name in out["modules"], name


def test_port_sources_name_no_jax_import():
    """Static half: no module of the port, and not chip_smoke.py, has an
    import statement for jax or the reference package."""
    import ast
    files = sorted((ROOT / "ceph_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "ceph_tpu"), (path, mod)


FAULT_PLANE_MODULES = ("ceph_tpu_torch.msg.faults",
                       "ceph_tpu_torch.mon.elector",
                       "ceph_tpu_torch.mon.crash_service",
                       "ceph_tpu_torch.common.crash",
                       "ceph_tpu_torch.mgr.crash",
                       "ceph_tpu_torch.testing.chaos")

CHAOS_PROBE = textwrap.dedent("""
    import importlib, json, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    names = json.loads(sys.argv[1])
    for name in names:
        importlib.import_module(name)
    from ceph_tpu_torch.testing import ChaosRunner, MiniCluster
    c = MiniCluster(n_osd=3, threaded=False, n_mon=3, fault_seed=7,
                    device="cpu")
    c.pump()
    quorum = c.leader().quorum()
    c.shutdown()
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu.")
                    or n == "jaxlib" or n.startswith("jaxlib."))
    print(json.dumps({"leaked": leaked, "quorum": quorum}))
""")


def test_fault_plane_quorum_and_crash_modules_import_without_jax():
    """The fault plane, the elector, crash capture and ChaosRunner import
    with jax blocked, and a three-mon cluster elects on them, loading
    nothing of the reference."""
    import json
    proc = subprocess.run(
        [sys.executable, "-c", CHAOS_PROBE, json.dumps(FAULT_PLANE_MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"leaked": [], "quorum": [0, 1, 2]}
