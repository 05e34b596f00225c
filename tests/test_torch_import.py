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
                 "ceph_tpu_torch.osd.ec_backend"):
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
