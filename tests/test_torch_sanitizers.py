"""The port's options, lockdep and racecheck (ceph_tpu_torch.common).

The option schema against the reference's (the sanitizers' two, the PG
log trim bounds, MemStore's capacity and its injected read errors); lockdep's cycle detection
as tests/test_common.py checks the reference's; tests/test_racecheck.py's
cases on the port's racecheck; and the port's locks and shared
structures wired under the reference's names.  The repository conftest
exports CEPH_TPU_LOCKDEP=1 and CEPH_TPU_RACECHECK=1, which arm the
port's sanitizers through the same env layer.
"""
import _thread
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from ceph_tpu.common import options as ref_options
from ceph_tpu_torch.common import devguard, lockdep, options, racecheck
from ceph_tpu_torch.common.lockdep import DebugLock, LockOrderError, \
    make_lock
from ceph_tpu_torch.common.racecheck import (RaceError, RaceTracked,
                                             shared_state,
                                             transfer_ownership)
from ceph_tpu_torch.dist import ICIFabric
from ceph_tpu_torch.ec import matrix_code
from ceph_tpu_torch.ec import registry as ec_registry
from ceph_tpu_torch.common.perf_counters import (PerfCounters,
                                                 PerfCountersCollection)
from ceph_tpu_torch.common.tracing import Tracer
from ceph_tpu_torch.ec.repairc import cache as repairc_cache
from ceph_tpu_torch.osd.ec_backend import ECBackend
from ceph_tpu_torch.store import MemStore

ROOT = Path(__file__).resolve().parents[1]


def probe(code: str, **env: str | None) -> subprocess.CompletedProcess:
    """Run `code` in a fresh interpreter with jax blocked and the env
    changes applied (None removes a variable)."""
    import os
    full = dict(os.environ)
    for k, v in env.items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    return subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['jax'] = None\n"
         + code], cwd=ROOT, env=full, capture_output=True, text=True,
        timeout=120)


# ------------------------------------------------------------- options

PORT_OPTIONS = {"lockdep", "racecheck", "memstore_device_bytes",
                "osd_min_pg_log_entries", "osd_max_pg_log_entries",
                "objectstore_debug_inject_read_err"}


def test_options_schema_equals_reference_but_backend():
    """The port reads six options; each is the reference's entry: the
    same type, level, default, text, bounds, see-also and runtime
    flag."""
    assert set(options.OPTIONS) == PORT_OPTIONS
    for name, opt in options.OPTIONS.items():
        ref = ref_options.OPTIONS[name]
        assert (opt.type.value, opt.level.value) == \
            (ref.type.value, ref.level.value)
        assert (opt.name, opt.default, opt.description, opt.see_also,
                opt.min, opt.max, opt.enum_values, opt.runtime) == \
            (ref.name, ref.default, ref.description, ref.see_also,
             ref.min, ref.max, ref.enum_values, ref.runtime)


@pytest.mark.parametrize("name,value", [
    ("memstore_device_bytes", "4K"), ("memstore_device_bytes", "2GiB"),
    ("memstore_device_bytes", " 1.5m "), ("memstore_device_bytes", 12345),
    ("memstore_device_bytes", "lots"),
    ("osd_min_pg_log_entries", "100"), ("osd_min_pg_log_entries", -1),
    ("osd_max_pg_log_entries", "7"), ("osd_max_pg_log_entries", "1e3"),
    ("objectstore_debug_inject_read_err", "yes"),
    ("objectstore_debug_inject_read_err", "2")])
def test_typed_options_parse_like_the_reference(name, value):
    ref = ref_options.OPTIONS[name]
    try:
        want = ref.parse(value)
    except ValueError:
        with pytest.raises(ValueError):
            options.OPTIONS[name].parse(value)
    else:
        got = options.OPTIONS[name].parse(value)
        assert (got, type(got)) == (want, type(want))


def test_typed_options_env_layer(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_OSD_MAX_PG_LOG_ENTRIES", "64")
    monkeypatch.setenv("CEPH_TPU_MEMSTORE_DEVICE_BYTES", "1M")
    cfg, ref = options.Config(), ref_options.Config()
    for name in ("osd_max_pg_log_entries", "memstore_device_bytes",
                 "osd_min_pg_log_entries"):
        assert cfg[name] == ref[name]
    assert (cfg["osd_max_pg_log_entries"], cfg["memstore_device_bytes"]) == \
        (64, 1 << 20)
    cfg.set("osd_min_pg_log_entries", "3")
    assert cfg["osd_min_pg_log_entries"] == 3


@pytest.mark.parametrize("value", ["1", "0", "true", "False", " yes ", "off",
                                   "ON", "no", True, False, "2", "maybe"])
def test_options_parse_like_the_reference(value):
    ref = ref_options.OPTIONS["lockdep"]
    try:
        want = ref.parse(value)
    except ValueError:
        with pytest.raises(ValueError):
            options.OPTIONS["lockdep"].parse(value)
    else:
        assert options.OPTIONS["lockdep"].parse(value) is want


def test_options_env_layer_arms_the_port(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_LOCKDEP", "off")
    assert options.Config()["lockdep"] is False
    g = options.global_config()
    assert g["lockdep"] is True and g["racecheck"] is True
    with pytest.raises(KeyError):
        g.set("ec_tpu_backend", "xla")


def test_options_the_port_does_not_read_cannot_stop_its_import():
    """A malformed value for a reference option the port never reads
    leaves the port's imports alone."""
    proc = probe(
        "from ceph_tpu_torch.ec import registry\n"
        "from ceph_tpu_torch.common import lockdep\n"
        "assert isinstance(registry.ErasureCodePluginRegistry"
        "._instance_lock, lockdep.DebugLock)\n",
        CEPH_TPU_OSD_POOL_DEFAULT_SIZE="bogus", CEPH_TPU_LOG_LEVEL="-1")
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------- lockdep

def test_lockdep_detects_order_cycle():
    """(ref: src/common/lockdep.cc:154 — a new edge closing a cycle in
    the follows-graph raises on the FIRST interleaving that could
    deadlock, no actual deadlock required)."""
    lockdep.reset()
    a, b = DebugLock("A"), DebugLock("B")
    with a:
        with b:               # records A -> B
            pass
    err = []

    def reversed_order():
        try:
            with b:
                with a:       # A -> B -> A: cycle
                    pass
        except LockOrderError as ex:
            err.append(ex)

    t = threading.Thread(target=reversed_order)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert err and "cycle" in str(err[0])
    # reentrancy is not a cycle
    lockdep.reset()
    r = DebugLock("R")
    with r:
        with r:
            assert lockdep.held_lock_names() == ("R",)
    assert lockdep.held_lock_names() == ()
    # consistent ordering never raises
    x, y, z = DebugLock("X"), DebugLock("Y"), DebugLock("Z")
    for _ in range(3):
        with x, y, z:
            pass
    # factory is config-gated: plain RLock with the option OFF,
    # DebugLock with it ON
    g = options.global_config()
    prev = g["lockdep"]
    try:
        g.set("lockdep", False)
        assert isinstance(make_lock("n"), _thread.RLock)
        g.set("lockdep", True)
        assert isinstance(make_lock("n"), DebugLock)
    finally:
        g.set("lockdep", prev)
    lockdep.reset()


def test_lockdep_graph_is_the_ports_own():
    """The two packages keep separate follows-graphs: an order recorded
    by one never trips the other."""
    from ceph_tpu.common import lockdep as ref_lockdep
    p, q = "torch-sanitizers.P", "torch-sanitizers.Q"
    with ref_lockdep.DebugLock(p), ref_lockdep.DebugLock(q):
        pass
    with DebugLock(q), DebugLock(p):   # a cycle only in the reference's
        pass


WIRED = {
    "ec.decode_table_cache": lambda: matrix_code.DecodeTableCache()._lock,
    "ec.registry.instance":
        lambda: ec_registry.ErasureCodePluginRegistry._instance_lock,
    "ec.registry": lambda: ec_registry.ErasureCodePluginRegistry()._lock,
    "ec.repairc.attach": lambda: repairc_cache._attach_lock,
    "ec.repairc.stats": lambda: repairc_cache.RepairProgramCache()._lock,
    "devguard.sites": lambda: devguard._lock,
    "dist.fabric": lambda: ICIFabric(devices=["cpu"])._lock,
    "dist.fabric.dispatch": lambda: ICIFabric(devices=["cpu"])._dispatch,
    "memstore.mem": lambda: MemStore()._lock,
    "tracer": lambda: Tracer("osd.0")._lock,
    "perf.osd.0": lambda: PerfCounters("osd.0")._lock,
    "perf.collection": lambda: PerfCountersCollection()._lock,
    "osd.3.ecbackend.1.0": lambda: ECBackend(
        "1.0", ec_registry.factory("tpu", {"k": "2", "m": "1"}, "cpu"), 3,
        [3, 4, 5], None, lambda s, m: False)._lock,
}


@pytest.mark.parametrize("name", list(WIRED))
def test_wired_locks_are_debuglocks_under_tier1(name):
    lock = WIRED[name]()
    assert isinstance(lock, DebugLock)
    assert lock.name == name


def test_wired_locks_are_plain_rlocks_without_lockdep():
    proc = probe(
        "from ceph_tpu_torch.common import devguard, racecheck\n"
        "from ceph_tpu_torch.ec import registry, matrix_code\n"
        "from ceph_tpu_torch.ec.repairc import cache\n"
        "import _thread\n"
        "for lk in (devguard._lock, cache._attach_lock,\n"
        "           registry.ErasureCodePluginRegistry._instance_lock,\n"
        "           matrix_code.DecodeTableCache()._lock):\n"
        "    assert isinstance(lk, _thread.RLock), lk\n"
        "assert not racecheck.enabled()\n",
        CEPH_TPU_LOCKDEP=None, CEPH_TPU_RACECHECK=None)
    assert proc.returncode == 0, proc.stderr


# ----------------------------------------------------------- racecheck

@pytest.fixture
def clean_reports():
    racecheck.reset()
    yield
    racecheck.reset()


def _in_thread(fn):
    """Run fn on a fresh thread, returning what it raised (if)."""
    box = []

    def run():
        try:
            fn()
        except BaseException as e:          # noqa: BLE001 — relayed
            box.append(e)
    t = threading.Thread(target=run, name="racer")
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return box[0] if box else None


def test_racecheck_on_under_tier1():
    """The conftest's CEPH_TPU_RACECHECK=1 arms the port's racecheck when
    it is imported."""
    assert options.global_config()["racecheck"] is True
    assert racecheck.enabled()


def test_unlocked_cross_thread_write_trips_with_both_stacks(clean_reports):
    @shared_state(only=("val",))
    class S:
        def __init__(self):
            self.val = 0

    s = S()
    s.val = 1                      # exclusive phase: silent

    def racer():
        s.val = 2
    err = _in_thread(racer)
    assert isinstance(err, RaceError)
    assert "S.val" in str(err)
    assert err.cur[0] == "racer"
    assert any(__file__ in fn for fn, _l, _n in err.cur[2])
    assert racecheck.races(), "evidence survives the raise"


def test_common_lock_discipline_stays_green(clean_reports):
    @shared_state(only=("n",))
    class G:
        def __init__(self):
            self.lock = make_lock("racecheck-test.g")
            self.n = 0

        def bump(self):
            with self.lock:
                self.n += 1

    g = G()
    g.bump()
    assert _in_thread(g.bump) is None
    g.bump()
    assert not racecheck.races()


def test_lockset_intersection_trips_on_disjoint_locks(clean_reports):
    @shared_state(only=("n",))
    class S:
        def __init__(self):
            self.a = make_lock("racecheck-test.a")
            self.b = make_lock("racecheck-test.b")
            self.n = 0

    s = S()
    with s.a:
        s.n = 1

    def racer():
        with s.b:
            s.n = 2
    assert _in_thread(racer) is None
    with pytest.raises(RaceError):
        with s.a:
            s.n = 3


def test_init_before_publish_is_exclusive_and_silent(clean_reports):
    @shared_state(only=("table",), mutating=("table",))
    class S:
        def __init__(self):
            self.table = {}
            for i in range(32):
                self.table[i] = i

        def reader(self):
            return len(self.table)

    s = S()
    assert s.reader() == 32
    assert not racecheck.races()


def test_transfer_ownership_documents_handoff(clean_reports):
    @shared_state(only=("payload",))
    class Op:
        def __init__(self):
            self.payload = "built"

    op = Op()
    transfer_ownership(op)

    def consumer():
        op.payload = "consumed"
    assert _in_thread(consumer) is None
    assert not racecheck.races()


def test_mutating_reads_count_as_writes_from_own_methods(clean_reports):
    @shared_state(only=("m",), mutating=("m",))
    class S:
        def __init__(self):
            self.lock = make_lock("racecheck-test.m")
            self.m = {}

        def put(self, k, v):
            with self.lock:
                self.m[k] = v

        def put_unlocked(self, k, v):
            self.m[k] = v

    s = S()
    s.put("a", 1)
    assert _in_thread(lambda: s.put("b", 2)) is None
    err = _in_thread(lambda: s.put_unlocked("c", 3))
    assert isinstance(err, RaceError)


def test_external_reads_are_stale_tolerant(clean_reports):
    @shared_state(only=("m",), mutating=("m",))
    class S:
        def __init__(self):
            self.lock = make_lock("racecheck-test.ext")
            self.m = {"a": 1}

        def put(self, k, v):
            with self.lock:
                self.m[k] = v

    s = S()
    s.put("b", 2)
    assert _in_thread(lambda: s.put("c", 3)) is None
    assert _in_thread(lambda: s.m.get("a")) is None
    assert _in_thread(lambda: s.put("d", 4)) is None
    assert not racecheck.races()


def test_race_tracked_mixin_registers(clean_reports):
    class H(RaceTracked):
        RACE_TRACK = ("state",)

        def __init__(self):
            self.state = "boot"

    h = H()
    h.state = "up"

    def racer():
        h.state = "down"
    err = _in_thread(racer)
    assert isinstance(err, RaceError)
    assert "H.state" in str(err)


def test_arming_requires_lockdep():
    """Armed without lockdep, every guarded access would look unguarded
    (make_lock hands out invisible RLocks): left off with a warning at
    the import that reads the option, so the EC path still imports, and
    refused at an explicit enable()."""
    proc = probe(
        "import warnings\n"
        "with warnings.catch_warnings(record=True) as seen:\n"
        "    warnings.simplefilter('always')\n"
        "    from ceph_tpu_torch.common import racecheck\n"
        "    from ceph_tpu_torch.ec import matrix_code\n"
        "assert not racecheck.enabled()\n"
        "assert any('lockdep' in str(w.message) for w in seen), seen\n",
        CEPH_TPU_LOCKDEP=None, CEPH_TPU_RACECHECK="1")
    assert proc.returncode == 0, proc.stderr
    proc = probe(
        "from ceph_tpu_torch.common import racecheck\n"
        "try:\n"
        "    racecheck.enable()\n"
        "except RuntimeError as e:\n"
        "    assert 'lockdep' in str(e)\n"
        "else:\n"
        "    raise SystemExit('enable() without lockdep must refuse')\n",
        CEPH_TPU_LOCKDEP=None, CEPH_TPU_RACECHECK=None)
    assert proc.returncode == 0, proc.stderr


def test_retro_enable_adopts_pre_arming_instances():
    proc = probe(
        "from ceph_tpu_torch.common import racecheck\n"
        "@racecheck.shared_state(only=('t',), mutating=('t',))\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self.t = {'a': 1}\n"
        "s = S()\n"
        "racecheck.enable()\n"
        "assert s.t == {'a': 1}\n"
        "s.t = {'b': 2}\n"
        "assert s.t == {'b': 2}\n"
        "del s.t\n"
        "try:\n"
        "    s.t\n"
        "except AttributeError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('del did not remove the value')\n",
        CEPH_TPU_LOCKDEP="1", CEPH_TPU_RACECHECK=None)
    assert proc.returncode == 0, proc.stderr


def test_zero_overhead_when_env_unset():
    """Unarmed, shared_state() only registers: the port's
    DecodeTableCache keeps plain attributes."""
    proc = probe(
        "from ceph_tpu_torch.common import racecheck\n"
        "assert not racecheck.enable_if_configured()\n"
        "@racecheck.shared_state(only=('x',))\n"
        "class S:\n"
        "    pass\n"
        "assert S.__setattr__ is object.__setattr__\n"
        "assert 'x' not in vars(S)\n"
        "from ceph_tpu_torch.ec.matrix_code import DecodeTableCache\n"
        "assert '_lru' not in vars(DecodeTableCache)\n"
        "assert racecheck.stats()['instrumented'] == 0\n"
        "assert racecheck.stats()['registered'] >= 2\n",
        CEPH_TPU_RACECHECK=None)
    assert proc.returncode == 0, proc.stderr


def test_decode_table_cache_instrumented_and_locked(clean_reports):
    """Under tier-1 the port's decode-table LRU is instrumented, and
    concurrent get/put through its lock stays quiet."""
    cls = matrix_code.DecodeTableCache
    assert isinstance(vars(cls).get("_lru"), property)
    assert isinstance(vars(cls).get("_cost"), property)
    c = cls(capacity=8)
    c.put("+0+1-2", object(), cost=2)

    def churn():
        for i in range(50):
            c.put(f"+0-{i % 4}", object(), cost=1)
            c.get("+0+1-2")
    threads = [threading.Thread(target=churn) for _ in range(3)]
    for t in threads:
        t.start()
    churn()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not racecheck.races()
    assert c.total_cost() <= 8


def test_decode_table_cache_unlocked_access_trips(clean_reports):
    """The instrumentation is live: a method that touches the LRU
    without the lock from a second thread is a race."""
    class Leaky(matrix_code.DecodeTableCache):
        def drop(self):
            self._lru.clear()          # the bug, on purpose: no lock

    c = Leaky(capacity=8)
    c.put("a", object())
    assert isinstance(_in_thread(c.drop), RaceError)
