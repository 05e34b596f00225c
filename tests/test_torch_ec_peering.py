"""EC-pool peering on the port's cluster, held to the reference's outcome.

tests/test_ec_peering.py's cases that this slice covers, run on
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` and,
where the reference's own case has an outcome to match, on the
reference's MiniCluster with the same inputs: the durable EC shard log,
the statechart running to CLEAN after an acting change, and backfill
reservations throttled at `osd_max_backfills` (exercised here by an
`osd out`, whose replacement shard is a backfill target; the reference
case grows pgp_num, and the pgp_num growth cases are in
tests/test_torch_split.py).

Beside them, the fault pins of the port's narrowed catches: a fault of
K1's wrapper or its launch during a compiled repair, or during the full
rebuild's decode, makes recovery fail loudly instead of finishing by
the full rebuild; a plan error still takes the full rebuild and counts
it; a queued item that raises bumps `queued_op_failures`.  Objects are
2-3 KB and clusters have 4-7 OSDs, to keep the file well inside a
minute on a CPU.
"""
import numpy as np
import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.osd import ec_backend as ref_ecb
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.ec.repairc import RepairPlanError
from ceph_tpu_torch.osd import ec_backend as port_ecb
from ceph_tpu_torch.osd import ecutil as port_ecutil
from ceph_tpu_torch.osd.ec_peering import ECPGPeering
from ceph_tpu_torch.osd.peering import CLEAN
from ceph_tpu_torch.store import ObjectId
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NONE = 0x7FFFFFFF


def make_cluster(kind="port", n=7, pg_num=8):
    if kind == "port":
        c = PortCluster(n_osd=n, threaded=False, device="cpu")
    else:
        c = RefCluster(n_osd=n, threaded=False)
    c.pump()
    c.wait_all_up()
    r = c.rados()
    r.mon_command({"prefix": "osd erasure-code-profile set",
                   "name": "k2m2",
                   "profile": {"plugin": "tpu", "k": "2", "m": "2",
                               "crush-failure-domain": "host"}})
    r.pool_create("ec", pg_num=pg_num, pool_type="erasure",
                  erasure_code_profile="k2m2")
    c.pump()
    return c, r


def wait_clean(c, rounds=60):
    for _ in range(rounds):
        c.pump()
        if all(d.pgs_recovering() == 0 for d in c.osds.values()):
            return
    raise TimeoutError("EC peering never went clean")


def write_corpus(io, n=24, seed=5):
    rng = np.random.default_rng(seed)
    objs = {f"p{i:03d}": rng.integers(0, 256, 2000 + 37 * i,
                                      dtype=np.uint8).tobytes()
            for i in range(n)}
    for oid, data in objs.items():
        io.write_full(oid, data)
    return objs


def counters(c, key):
    return sum(d.perf.get(key) for d in c.osds.values())


def _shard_log(kind):
    ecb = port_ecb if kind == "port" else ref_ecb
    c, r = make_cluster(kind, n=4)
    try:
        io = r.open_ioctx("ec")
        io.write_full("durable", b"x" * 5000)
        io.write_full("durable2", b"y" * 3000)
        c.pump()
        pid = r.pool_lookup("ec")
        m = c.mon.osdmap
        raw = m.object_locator_to_pg("durable", pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        _, _, acting, _ = m.pg_to_up_acting_osds(raw)
        osd = next(o for o in acting if 0 <= o < NONE)
        live = c.osds[osd].pgs[pg].shard
        head, tail = live.log_info()
        assert head.version > 0
        reloaded = ecb.ECPGShard(pg, live.shard, c.osds[osd].store, 2, 2,
                                 create=False)
        assert reloaded.log_info() == (head, tail)
        assert len(reloaded.pg_log.log.entries) == \
            len(live.pg_log.log.entries)
        entries = [str(e) for e in live.pg_log.log.entries]
    finally:
        c.shutdown()
    return entries


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_ec_shard_log_durable(kind):
    """EC sub-writes land in the pgmeta omap; a reconstructed shard
    object reloads real log bounds, in the port as in the reference."""
    assert _shard_log(kind)


def test_ec_shard_log_equals_the_reference():
    assert _shard_log("port") == _shard_log("ref")


def _phases_run(kind):
    c, r = make_cluster(kind)
    try:
        io = r.open_ioctx("ec")
        objs = write_corpus(io, n=8)
        c.pump()
        r.mon_command({"prefix": "osd out", "ids": [0]})
        wait_clean(c)
        phases = {}
        for osd, d in sorted(c.osds.items()):
            for pg, st in d.pgs.items():
                if st.backend is not None:
                    phases[str(pg)] = (osd, type(st.peering).__name__,
                                       st.peering.phase)
        reads = {oid: io.read(oid) for oid in objs}
        assert reads == objs
        stats = {k: counters(c, k) for k in (
            "recovery_bytes_read", "recovery_bytes_rebuilt")}
        full = counters(c, "recovery_full_rebuild") \
            if kind == "port" else 0
        return phases, stats, full
    finally:
        c.shutdown()


def test_ec_peering_phases_run():
    """An acting change drives every primary's ECPGPeering to CLEAN;
    the phases, primaries and recovery bytes equal the reference's and
    the port took no full rebuild."""
    phases, stats, full = _phases_run("port")
    ref_phases, ref_stats, _ = _phases_run("ref")
    assert phases and all(ph == CLEAN and cls == "ECPGPeering"
                          for _, cls, ph in phases.values())
    assert phases == ref_phases
    assert stats == ref_stats
    assert stats["recovery_bytes_rebuilt"] > 0
    assert stats["recovery_bytes_read"] == 2 * stats[
        "recovery_bytes_rebuilt"]
    assert full == 0


def _backfill(kind):
    cfg = port_config() if kind == "port" else ref_config()
    old = cfg["osd_max_backfills"]
    cfg.set("osd_max_backfills", 1)
    try:
        c, r = make_cluster(kind, pg_num=8)
        try:
            io = r.open_ioctx("ec")
            objs = write_corpus(io, n=24, seed=29)
            c.pump()
            r.mon_command({"prefix": "osd out", "ids": [1, 2]})
            wait_clean(c, rounds=240)
            peaks = {o: (d.bf_peak_local, d.bf_peak_remote)
                     for o, d in sorted(c.osds.items())}
            for oid, data in objs.items():
                assert io.read(oid) == data, oid
            return peaks
        finally:
            c.shutdown()
    finally:
        cfg.set("osd_max_backfills", old)


def test_ec_backfill_reservations_exercised():
    """EC backfill of the replacement shards rides the reservation
    pools: throttled at osd_max_backfills on both ends, actually taken,
    with the reference's peaks."""
    peaks = _backfill("port")
    assert all(lo <= 1 and re <= 1 for lo, re in peaks.values())
    assert any(lo >= 1 for lo, _ in peaks.values()), \
        "no EC backfill took a local reservation"
    assert any(re >= 1 for _, re in peaks.values())
    assert peaks == _backfill("ref")


def test_rebuilt_shards_equal_the_plain_encode():
    """After clean, every acting shard of every object holds the chunk
    the plain version's encode gives for its index."""
    c, r = make_cluster()
    try:
        io = r.open_ioctx("ec")
        objs = write_corpus(io, n=8, seed=11)
        c.pump()
        r.mon_command({"prefix": "osd out", "ids": [3]})
        wait_clean(c)
        pid = r.pool_lookup("ec")
        m = c.mon.osdmap
        checked = 0
        for oid, data in objs.items():
            raw = m.object_locator_to_pg(oid, pid)
            pg = m.pools[pid].raw_pg_to_pg(raw)
            _, _, acting, ap = m.pg_to_up_acting_osds(raw)
            b = c.osds[ap].pgs[pg].backend
            w = b.sinfo.stripe_width
            padded = data + b"\0" * (-len(data) % w)
            want = port_ecutil.encode(b.sinfo, b.ec, padded)
            for s, osd in enumerate(acting):
                st = c.osds[osd].store
                got = st.read(port_ecb.pg_cid(pg), ObjectId(oid, shard=s))
                assert got == want[s], (oid, s, osd)
                checked += 1
        assert checked == 4 * len(objs)
        assert 3 not in {o for oid in objs for o in
                         m.pg_to_up_acting_osds(
                             m.object_locator_to_pg(oid, pid))[2]}
    finally:
        c.shutdown()


def _wrapper_on_cpu(tables, mat, data):
    # K1's real wrapper: on a cpu tensor it refuses with ValueError
    return bm.gf_matmul_cuda(tables, data, mat.shape[0])


def _raiser(exc):
    def launch(tables, mat, data):
        raise exc
    return launch


def _k1_fault(fault, detail):
    """K1 refusing a cpu tensor (its wrapper) or failing to launch."""
    if fault == "wrapper":
        return _wrapper_on_cpu
    return _raiser(RuntimeError(f"gf_matmul_k1 launch failed: {detail}"))


def _written(seed):
    c, r = make_cluster()
    io = r.open_ioctx("ec")
    objs = write_corpus(io, n=6, seed=seed)
    c.pump()
    return c, r, objs


def _lose_one_shard(c, r):
    """osd.4 killed, marked down and out: its shards rebuild on their
    new OSDs from the survivors.  The pump-mode client drives the whole
    recovery from inside the command."""
    c.kill_osd(4)
    r.mon_command({"prefix": "osd down", "ids": [4]})
    r.mon_command({"prefix": "osd out", "ids": [4]})
    wait_clean(c)


@pytest.mark.parametrize("fault,exc_type", [
    ("wrapper", ValueError),
    ("launch", RuntimeError),
])
def test_kernel_fault_in_compiled_repair_fails_loudly(monkeypatch, fault,
                                                      exc_type):
    """A fault of K1's wrapper or its launch during the compiled repair
    propagates out of the recovery (here out of the pump that delivers
    the helpers' replies) and the full rebuild, which would return the
    right bytes on the CPU, is never entered.  The reference's catch
    (ValueError among others) would hide the wrapper's fault."""
    c, r, _ = _written(seed=13)
    try:
        monkeypatch.setattr(bm, "gf_matmul",
                            _k1_fault(fault, "illegal memory access (700)"))
        with pytest.raises(exc_type):
            _lose_one_shard(c, r)
        assert counters(c, "recovery_full_rebuild") == 0
        assert counters(c, "recovery_bytes_rebuilt") == 0
    finally:
        c.shutdown()


@pytest.mark.parametrize("fault", ["wrapper", "launch"])
def test_kernel_fault_in_compiled_repair_is_counted_threaded(monkeypatch,
                                                             fault):
    """Threaded, as deployed daemons and phase 19 of chip_smoke.py run:
    a fault of K1's wrapper or its launch during a compiled repair
    propagates to the dispatch thread that delivered the helper's
    reply, which logs it and goes on serving.  It is counted in the
    network's dispatch_errors (phase 19 fails on it at once), the full
    rebuild is never entered and the shard is not rebuilt."""
    import time

    c = PortCluster(n_osd=7, threaded=True, device="cpu")
    try:
        c.wait_all_up()
        r = c.rados()
        r.mon_command({"prefix": "osd erasure-code-profile set",
                       "name": "k2m2",
                       "profile": {"plugin": "tpu", "k": "2", "m": "2",
                                   "crush-failure-domain": "host"}})
        r.pool_create("ec", pg_num=8, pool_type="erasure",
                      erasure_code_profile="k2m2")
        write_corpus(r.open_ioctx("ec"), n=6, seed=13)
        monkeypatch.setattr(bm, "gf_matmul",
                            _k1_fault(fault, "illegal memory access (700)"))
        c.kill_osd(4)
        r.mon_command({"prefix": "osd down", "ids": [4]})
        r.mon_command({"prefix": "osd out", "ids": [4]})
        end = time.monotonic() + 20
        while time.monotonic() < end and not c.network.dispatch_errors:
            time.sleep(0.01)
        assert c.network.dispatch_errors >= 1
        want = {"wrapper": "ValueError", "launch": "RuntimeError"}[fault]
        assert want in c.network.last_dispatch_error
        assert counters(c, "recovery_full_rebuild") == 0
        assert counters(c, "recovery_bytes_rebuilt") == 0
    finally:
        c.shutdown()


@pytest.mark.parametrize("fault,exc_type", [
    ("wrapper", ValueError),
    ("launch", RuntimeError),
])
def test_kernel_fault_in_full_rebuild_decode_fails_loudly(monkeypatch,
                                                          fault, exc_type):
    """The full rebuild's decode_concat follows the same rule: a fault
    of K1's wrapper or its launch propagates instead of turning into a
    failed job (the reference catches ValueError there)."""
    c, r, _ = _written(seed=17)
    try:
        # a plan error sends every repair to the full rebuild ...
        def plan_error(*a, **kw):
            raise RepairPlanError("chunk size not sub-chunk aligned")
        monkeypatch.setattr(port_ecutil, "compiled_repair_streams",
                            plan_error)
        # ... whose staged decode then meets the K1 fault (the push's
        # re-encode is stubbed out, so only the decode launches K1)
        monkeypatch.setattr(
            port_ecb.ECBackend, "push_rebuilt",
            lambda self, oid, logical, targets, on_done, **kw:
                on_done(True))
        monkeypatch.setattr(bm, "gf_matmul",
                            _k1_fault(fault, "unspecified launch failure"))
        with pytest.raises(exc_type):
            _lose_one_shard(c, r)
        assert counters(c, "recovery_full_rebuild") >= 1
    finally:
        c.shutdown()


def test_plan_error_takes_the_full_rebuild_and_counts_it(monkeypatch):
    """A plan error is the one fault that may take the full rebuild: the
    recovery finishes with the right bytes, and the counter phase 19
    of chip_smoke.py holds to 0 records it."""
    c, r, objs = _written(seed=19)
    try:
        def plan_error(*a, **kw):
            raise RepairPlanError("helper buffers disagree on stripes")
        monkeypatch.setattr(port_ecutil, "compiled_repair_streams",
                            plan_error)
        _lose_one_shard(c, r)
        assert counters(c, "recovery_full_rebuild") >= 1
        io = r.open_ioctx("ec")
        for oid, data in objs.items():
            assert io.read(oid) == data, oid
    finally:
        c.shutdown()


def test_failed_queued_item_bumps_queued_op_failures(monkeypatch):
    """A queued recovery item that raises is logged as in the reference
    and counted in queued_op_failures; the daemon keeps draining the
    rest of its queue."""
    c, r, _ = _written(seed=23)
    try:
        def broken(self, oid, targets, ver, on_done=None):
            raise RuntimeError(f"injected fault rebuilding {oid}")
        monkeypatch.setattr(ECPGPeering, "_rebuild", broken)
        c.kill_osd(4)
        r.mon_command({"prefix": "osd down", "ids": [4]})
        r.mon_command({"prefix": "osd out", "ids": [4]})
        for _ in range(10):
            c.pump()
        failed = counters(c, "queued_op_failures")
        assert failed >= 1
        assert counters(c, "recovery_full_rebuild") == 0
        assert counters(c, "recovery_bytes_rebuilt") == 0
    finally:
        c.shutdown()


def test_kernel_fault_from_a_ticked_retry_is_reaped_and_recorded(
        monkeypatch):
    """A K1 fault raised from a peering retry that `MiniCluster.tick`
    drives is reaped like an aborted daemon, as the reference does, and
    recorded in `reaped` (osd, exception type, traceback), which phase
    19 of chip_smoke.py fails on.  The retry: a full-rebuild gather
    whose one surplus read reply was lost stalls, and the tick resolves
    it with the k chunks that did arrive, through K1's staged decode."""
    c, r, _ = _written(seed=23)
    try:
        # no repair plan: every rebuild gathers every surviving shard
        monkeypatch.setattr(port_ecutil, "repair_plan",
                            lambda *a, **kw: None)
        lost = []

        def lose_one_reply(src, dst, msg):
            if msg.type_name == "ECSubReadReply" and not lost:
                lost.append((src, dst))
                return False
            return True
        c.network.filter = lose_one_reply
        c.kill_osd(4)
        r.mon_command({"prefix": "osd down", "ids": [4]})
        r.mon_command({"prefix": "osd out", "ids": [4]})
        for _ in range(5):
            c.pump()
        assert lost and c.osds[int(lost[0][1][4:])].pgs_recovering() > 0
        monkeypatch.setattr(bm, "gf_matmul", _k1_fault(
            "launch", "an illegal memory access was encountered"))
        now = 1000.0
        for _ in range(8):
            now += 1.0
            c.tick(now)
            if c.reaped:
                break
        assert [osd for osd, _exc, _tb in c.reaped] == [int(lost[0][1][4:])]
        osd, exc, tb = c.reaped[0]
        assert exc == "RuntimeError" and "gf_matmul_k1" in tb
        assert osd not in c.osds
    finally:
        c.shutdown()
