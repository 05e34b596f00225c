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
                 "ceph_tpu_torch.testing.thrasher",
                 # object classes
                 "ceph_tpu_torch.cls", "ceph_tpu_torch.cls.lock",
                 "ceph_tpu_torch.cls.refcount", "ceph_tpu_torch.cls.version",
                 "ceph_tpu_torch.cls.log", "ceph_tpu_torch.cls.numops",
                 "ceph_tpu_torch.cls.queue",
                 # block images and the journal
                 "ceph_tpu_torch.journal", "ceph_tpu_torch.rbd",
                 "ceph_tpu_torch.rbd.image", "ceph_tpu_torch.rbd.migration",
                 "ceph_tpu_torch.rbd.mirror",
                 "ceph_tpu_torch.tools.rbd_cli",
                 # the file system, the MDSMonitor and the dencoder
                 "ceph_tpu_torch.fs", "ceph_tpu_torch.fs.mds",
                 "ceph_tpu_torch.fs.client", "ceph_tpu_torch.mon.fsmap",
                 "ceph_tpu_torch.mon.mds_monitor",
                 "ceph_tpu_torch.tools.dencoder",
                 # the last modules: vstart and the common face
                 "ceph_tpu_torch.tools.vstart", "ceph_tpu_torch.common"):
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


CLS_PROBE = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    from ceph_tpu_torch.cls import ClsError, class_handler
    methods = {}
    for name in ("lock", "refcount", "version", "log", "numops", "queue",
                 "rgw"):
        class_handler._load(name)
    for cls, method in sorted(class_handler._methods):
        methods.setdefault(cls, []).append(method)
    try:
        class_handler.resolve("rgw", "obj_store")
        rgw = "resolved"
    except ClsError as e:
        rgw = e.errno_name
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu."))
    print(json.dumps({"methods": methods, "rgw": rgw, "leaked": leaked}))
""")


def test_cls_classes_load_without_jax_or_reference():
    """Every object class the port carries, `rgw` with them, loads with
    jax blocked and registers the reference's methods; `rgw` resolves."""
    import json

    from ceph_tpu import cls as ref_cls
    proc = subprocess.run([sys.executable, "-c", CLS_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == [] and out["rgw"] == "resolved"
    assert "rgw" in out["methods"]
    for name in out["methods"]:
        ref_cls.class_handler._load(name)
    want = {}
    for cls, method in sorted(ref_cls.class_handler._methods):
        want.setdefault(cls, []).append(method)
    assert out["methods"] == want


RBD_PROBE = textwrap.dedent("""
    import io, json, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    from ceph_tpu_torch.journal import Journaler
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.rbd.mirror import ImageMirror, mirror_enable
    from ceph_tpu_torch.rbd.migration import migration_prepare
    from ceph_tpu_torch.testing import MiniCluster
    from ceph_tpu_torch.tools import rbd_cli
    c = MiniCluster(n_osd=3, threaded=False, device="cpu")
    c.pump()
    c.wait_all_up()
    r = c.rados()
    r.pool_create("rbd", pg_num=8)
    ioctx = r.open_ioctx("rbd")
    RBD().create(ioctx, "img", 1 << 20, order=16, journaling=True)
    img = Image(ioctx, "img")
    img.write(4096, b"block")
    got = img.read(4096, 5).decode()
    img.close()
    entries = []
    Journaler(ioctx, "rbd.img", "probe").replay(
        lambda tag, data: entries.append(tag), from_pos=(0, 0))
    out = io.StringIO()
    rc = rbd_cli.main(["-p", "rbd", "du", "img"], rados=r, out=out)
    c.shutdown()
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu.")
                    or n == "jaxlib" or n.startswith("jaxlib."))
    print(json.dumps({"leaked": leaked, "read": got, "journal": entries,
                      "du": [rc, out.getvalue()]}))
""")


def test_rbd_and_journal_import_without_jax_or_reference():
    """The journal, rbd (image, mirror, migration) and the rbd CLI import
    with jax blocked, and a journaled image on the port's cluster writes,
    reads, journals and answers `rbd du`, loading nothing of the
    reference."""
    import json
    proc = subprocess.run([sys.executable, "-c", RBD_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"leaked": [], "read": "block", "journal": ["write"],
                   "du": [0, "img provisioned 1 MiB used 64 KiB\n"]}


RGW_PROBE = textwrap.dedent("""
    import json, sys, urllib.request
    sys.modules["jax"] = None          # any `import jax` now raises
    import ceph_tpu_torch.cls.rgw
    from ceph_tpu_torch.rgw import RGWGateway, SWALLOWED
    from ceph_tpu_torch.rgw import auth, datalog, notify, sts, swift
    from ceph_tpu_torch.testing import MiniCluster
    c = MiniCluster(n_osd=3, threaded=True, device="cpu")
    c.wait_all_up()
    gw = RGWGateway(c.rados(), pool="rgw")
    gw.start()
    def req(method, path, data=None):
        r = urllib.request.Request(f"http://127.0.0.1:{gw.port}{path}",
                                   data=data, method=method)
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, resp.read().decode()
    got = [req("PUT", "/b"), req("PUT", "/b/k", b"object"),
           req("GET", "/b/k")]
    gw.shutdown()
    c.shutdown()
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu.")
                    or n == "jaxlib" or n.startswith("jaxlib."))
    print(json.dumps({"leaked": leaked, "got": got,
                      "swallowed": sum(SWALLOWED.values())}))
""")


def test_rgw_imports_without_jax_or_reference():
    """The gateway, its auth, STS, Swift, notification and datalog
    modules and the `rgw` object class import with jax blocked, and a
    gateway on the port's cluster serves a bucket, a PUT and a GET,
    loading nothing of the reference."""
    import json
    proc = subprocess.run([sys.executable, "-c", RGW_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"leaked": [], "swallowed": 0,
                   "got": [[200, ""], [200, ""], [200, "object"]]}


MULTISITE_PROBE = textwrap.dedent("""
    import json, sys, time, urllib.error, urllib.request
    sys.modules["jax"] = None          # any `import jax` now raises
    from ceph_tpu_torch.mgr import prometheus, restful
    from ceph_tpu_torch.rgw import multisite
    from ceph_tpu_torch.testing import MiniCluster
    c = MiniCluster(n_osd=3, threaded=True, device="cpu")
    c.wait_all_up()
    g1, g2 = c.rgw_multisite(zones=("z1", "z2"))
    for path, data in (("/b", None), ("/b/k", b"object")):
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{g1.port}{path}", data=data, method="PUT"),
            timeout=30).read()
    def synced_past(dst, src):
        # dst's cursor for src's log of /b/k's shard has reached the
        # head src holds now: dst has pulled every record of it
        sh = src.shard_of("b", "k")
        head = src.datalog.head("b", sh)
        with dst.sync._lock:
            have = dst.sync._markers.get((src.zone, "b", sh), -1)
        return have >= head
    def z2_serves():
        try:
            return urllib.request.urlopen(
                f"http://127.0.0.1:{g2.port}/b/k",
                timeout=30).read().decode()
        except urllib.error.HTTPError:
            return None
    end = time.monotonic() + 60
    got = z2_serves()
    while not (got is not None and synced_past(g2, g1) and
               synced_past(g1, g2)):
        if time.monotonic() > end:
            raise TimeoutError("zones never synced past each other")
        time.sleep(0.02)
        got = z2_serves()
    mgr = c.start_mgr()
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{mgr.start_prometheus().port}/metrics",
        timeout=30).read().decode()
    srv = mgr.start_restful()
    key = srv.create_key()
    health = json.loads(urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/health",
        headers={"Authorization": f"Bearer {key}"}), timeout=30).read())
    c.shutdown()
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu.")
                    or n == "jaxlib" or n.startswith("jaxlib."))
    print(json.dumps({"leaked": leaked, "got": got,
                      "lag": sorted(ln for ln in text.splitlines()
                                    if ln.startswith("ceph_rgw_sync_lag")),
                      "health": "status" in health,
                      "swallowed": sum(multisite.SWALLOWED.values()) +
                      sum(multisite.SYNC_TICK_ERRORS.values())}))
""")


def test_multisite_prometheus_restful_import_without_jax_or_reference():
    """`rgw.multisite`, `mgr.prometheus` and `mgr.restful` import with
    jax blocked; two zones on the port's cluster replicate an object,
    the mgr's scrape carries both zones' lag gauges at 0 and the restful
    API answers a keyed request, loading nothing of the reference.  The
    scrape waits on state with a deadline: z2 serves the object and each
    zone's cursor has reached the other's datalog head for its shard
    (`caught_up()` reads the heads of the agent's last round, so it may
    answer before a round has pulled the write)."""
    import json
    proc = subprocess.run([sys.executable, "-c", MULTISITE_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"leaked": [], "got": "object", "health": True,
                   "swallowed": 0,
                   "lag": ['ceph_rgw_sync_lag_entries{source="z1",zone="z2"} 0',
                           'ceph_rgw_sync_lag_entries{source="z2",zone="z1"} 0']}


FS_PROBE = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import ceph_tpu_torch.fs, ceph_tpu_torch.mon.fsmap
    import ceph_tpu_torch.mon.mds_monitor, ceph_tpu_torch.tools.dencoder
    from ceph_tpu_torch.fs import SWALLOWED, CephFS
    from ceph_tpu_torch.testing import MiniCluster
    c = MiniCluster(n_osd=3, threaded=True, device="cpu")
    c.wait_all_up()
    mds = c.start_mds(0)
    c.wait_mds_active(0)
    fs = CephFS(c.rados())
    fs.mkdirs("/d")
    fs.write_file("/d/f", b"file bytes")
    got = [fs.read_file("/d/f").decode(), fs.listdir("/d"),
           c.fsmap().ranks[0].state]
    c.shutdown()
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu.")
                    or n == "jaxlib" or n.startswith("jaxlib."))
    print(json.dumps({"leaked": leaked, "got": got,
                      "swallowed": sum(SWALLOWED.values())}))
""")


def test_fs_imports_without_jax_or_reference():
    """`fs`, `mon.fsmap`, `mon.mds_monitor` and `tools.dencoder` import
    with jax blocked; an MDS on the port's cluster goes active in the
    fsmap and a client creates, writes and reads a file through it,
    loading nothing of the reference or of jaxlib."""
    import json
    proc = subprocess.run([sys.executable, "-c", FS_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"leaked": [], "swallowed": 0,
                   "got": ["file bytes", ["f"], "active"]}


#: top-level and class-level public names of the reference that the port
#: has no counterpart of, by module: the JAX device routes whose place
#: K1, K2, K3 and their plain versions take, and the JAX-tracing checks
#: whose counterparts are the cuda-timing rule and devguard's recompile
#: count (ROADMAP, Queue 1)
JAX_ONLY = {
    "common/jaxguard.py": "the module: common/devguard.py",
    "analysis/engine.py": {"FileContext.imports_jax",
                           "FileContext.inline_ignored"},
    "analysis/project.py": {"ProjectContext.jit_statics_of",
                            "jit_statics"},
    "analysis/rules.py": {"JaxTimingRule", "JaxTimingRule.check",
                          "JitRetraceChurnRule", "JitRetraceChurnRule.check",
                          "JitStaticRule", "JitStaticRule.check",
                          "TracerLeakRule", "TracerLeakRule.check"},
    "crush/batch.py": {"_CmView.max_buckets", "_CmView.max_depth",
                       "_CmView.max_devices", "_CmView.n_class_max",
                       "_CmView.n_positions", "_CmView.use_classes",
                       "crush_ln16", "crush_ln_vec"},
    "ec/kernels/bitmatmul.py": {
        "PALLAS_MIN_TILE", "PALLAS_TILE", "expand_bits",
        "gf_decode_pallas_grouped_full", "gf_decode_xla_full",
        "gf_matmul_pallas", "gf_matmul_pallas_grouped", "gf_matmul_xla",
        "gf_matmul_xla_grouped", "grouped_bitmatrix",
        "grouped_planar_bitmatrix", "pack_bits", "pack_matrix"},
    "ec/matrix_code.py": {"MatmulFn"},
    "osd/mapping.py": {"BATCH_CHUNK"},
}


def public_names(path: Path) -> set:
    """Module-level defs, classes, assignments and methods of classes,
    without private names and without imported names."""
    import ast
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def test_every_reference_module_and_name_has_a_counterpart():
    """The module walk: each module of the reference has a module of the
    same path in the port, holding each of its public names, but for
    the JAX-only names above."""
    ref_root = ROOT / "ceph_tpu"
    missing = {}
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root).as_posix()
        mine = ROOT / "ceph_tpu_torch" / rel
        if not mine.exists():
            missing[rel] = "the module"
            continue
        gap = public_names(path) - public_names(mine)
        if gap:
            missing[rel] = gap
    assert set(missing) == set(JAX_ONLY)
    assert missing.pop("common/jaxguard.py") == "the module"
    for rel, gap in missing.items():
        assert gap == JAX_ONLY[rel], rel


VSTART_PROBE = textwrap.dedent("""
    import io, json, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    from ceph_tpu_torch.tools import vstart
    from ceph_tpu_torch.analysis import main
    out = io.StringIO()
    sh = vstart.VstartShell(n_osd=3, out=out, device="cpu")
    try:
        sh.run_line("osd pool create p 4")
        sh.run_line("status")
    finally:
        sh.close()
    rc = main(["--list-rules"])
    leaked = sorted(n for n in sys.modules
                    if n == "ceph_tpu" or n.startswith("ceph_tpu."))
    print(json.dumps({"leaked": leaked, "rc": rc,
                      "created": "pool 'p' created" in out.getvalue()}))
""")


def test_vstart_and_analysis_run_without_jax():
    """The vstart shell boots a cluster and cephck lists its rules with
    jax blocked, loading nothing of the reference."""
    import json
    proc = subprocess.run([sys.executable, "-c", VSTART_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"leaked": [], "rc": 0, "created": True}
