"""The port's mgr held to the reference's: the pg_autoscaler, the
balancer round, progress, the mon's command proxy and the module-health
merge.

Each case runs the same seeded script on `ceph_tpu.testing.MiniCluster`
and on `ceph_tpu_torch.testing.MiniCluster(device="cpu")` (pump mode,
one simulated clock, except where the mgr's synchronous `mon_command`
needs a dispatch thread) and compares at tolerance 0: each autoscaler
plan and the commands it sends, the pool's growth through the mgr with
every object read back, the `osd upmap-batch` a balancer round submits
(the port's mapping tables through K3's plain version; the reference's
through its own scalar CRUSH, which its batch engine equals, because a
JAX compile per shape costs seconds here), progress events, the proxied
command's answers with and without a mgr, and the health the mon
reports within and past `mon_mgr_health_grace`.
"""
import numpy as np
import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.mgr import pg_autoscaler as ref_autoscaler
from ceph_tpu.mgr.progress import ProgressModule as RefProgress
from ceph_tpu.osd import balancer as ref_balancer
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.common.admin_socket import admin_command
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.mgr import MgrDaemon
from ceph_tpu_torch.mgr import pg_autoscaler as port_autoscaler
from ceph_tpu_torch.mgr.progress import ProgressModule as PortProgress
from ceph_tpu_torch.testing import MiniCluster as PortCluster

from test_torch_balancer import ScalarTables

NS = {
    "ref": dict(cluster=lambda n, threaded=False, **kw: RefCluster(
                    n_osd=n, threaded=threaded, **kw),
                config=ref_config, autoscaler=ref_autoscaler,
                progress=RefProgress),
    "port": dict(cluster=lambda n, threaded=False, **kw: PortCluster(
                     n_osd=n, threaded=threaded, device="cpu", **kw),
                 config=port_config, autoscaler=port_autoscaler,
                 progress=PortProgress),
}
PROFILE = {"plugin": "tpu", "k": "2", "m": "2",
           "crush-failure-domain": "host"}
T0 = 1000.0


def make(kind, n=6, threaded=False, ec_pg=4, rep_pg=4, **kw):
    c = NS[kind]["cluster"](n, threaded, **kw)
    if not threaded:
        c.pump()
    c.wait_all_up()
    r = c.rados()
    rc = r.mon_command({"prefix": "osd erasure-code-profile set",
                        "name": "k2m2", "profile": dict(PROFILE)})
    assert rc[0] == 0, rc
    r.pool_create("ec", pg_num=ec_pg, pool_type="erasure",
                  erasure_code_profile="k2m2")
    r.pool_create("rep", pg_num=rep_pg)
    if not threaded:
        c.pump()
    return c, r


def both(case, *args):
    return case("ref", *args), case("port", *args)


def wait_clean(c, rounds=160):
    for _ in range(rounds):
        c.pump()
        if all(d.pgs_recovering() == 0 for d in c.osds.values()):
            return
    raise TimeoutError("peering never went clean")


class StubMgr:
    """What the autoscaler reads of its mgr: the map and `_command`."""

    def __init__(self, osdmap):
        self.osdmap = osdmap
        self.sent = []

    def _command(self, cmd):
        self.sent.append(cmd)


# ------------------------------------------------------------ autoscaler

PLANS = {
    "empty": (None, [], {}),
    "ec_heavy": ("ec", [], {}),
    "rep_light": ("rep", [3], {"threshold": 2.0}),
    "cap": ("ec", [], {"max_pg_num": 8}),
}


def plan(kind, name):
    heavy, out, kw = PLANS[name]
    c, r = make(kind)
    try:
        for o in out:
            r.mon_command({"prefix": "osd out", "ids": [o]})
        c.pump()
        m = c.mon.osdmap
        pool_bytes = None if heavy is None else {
            pid: (1 << 30 if m.pool_names[pid] == heavy else 1 << 20)
            for pid in m.pools}
        mgr = StubMgr(m)
        auto = NS[kind]["autoscaler"].PGAutoscaler(mgr, **kw)
        first = auto.plan(m, pool_bytes)
        sent = auto.tick(pool_bytes)
        return {"plan": first, "status": auto.status(), "sent": sent,
                "commands": mgr.sent}
    finally:
        c.shutdown()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_autoscaler_plan_and_commands_equal_the_reference(name):
    ref, port = both(plan, name)
    assert port == ref
    assert port["plan"] and port["sent"] == len(port["commands"])


def test_next_pow2_equals_the_reference():
    for n in range(0, 300):
        assert port_autoscaler.next_pow2(n) == ref_autoscaler.next_pow2(n)


def grow(kind):
    """The mgr grows the EC pool: pg_num first, pgp_num on the next
    tick, the cluster clean after each, every object read back."""
    c, r = make(kind, n=7, rep_pg=8)
    try:
        io = r.open_ioctx("ec")
        rng = np.random.default_rng(17)
        objs = {f"p{i:03d}": rng.integers(0, 256, 2000 + 37 * i,
                                          dtype=np.uint8).tobytes()
                for i in range(12)}
        for k, v in objs.items():
            io.write_full(k, v)
        mgr = c.start_mgr()
        mgr.start_pg_autoscaler(max_pg_num=16)
        pid = r.pool_lookup("ec")
        steps = []
        for _ in range(3):
            sent = mgr.autoscale_tick({pid: 1 << 30})
            c.pump()
            wait_clean(c)
            pool = c.mon.osdmap.pools[pid]
            steps.append((sent, pool.pg_num, pool.pgp_num))
        return {"steps": steps, "plan": mgr.pg_autoscaler.status(),
                "reads": {k: io.read(k) for k in objs} == objs,
                "failed": mgr.failed_commands,
                "epoch": (mgr.osdmap.epoch, c.mon.osdmap.epoch)}
    finally:
        c.shutdown()


def test_mgr_grows_the_ec_pool_like_the_reference():
    ref, port = both(grow)
    assert port == ref
    (s1, pg1, pgp1), (s2, pg2, pgp2) = port["steps"][:2]
    assert (s1, pg1, pgp1) == (1, 16, 4)
    assert (s2, pg2, pgp2) == (1, pg1, pg1)
    assert port["reads"] and port["failed"] == 0
    assert port["epoch"][0] == port["epoch"][1]


# -------------------------------------------------------------- balancer

def balance(kind):
    c = NS[kind]["cluster"](8, False, osds_per_host=2) if kind == "ref" \
        else PortCluster(n_osd=8, threaded=False, device="cpu",
                         osds_per_host=2)
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        r.pool_create("p", pg_num=64)
        c.pump()
        mgr = c.start_mgr(max_deviation=1, max_iterations=60)
        sent_cmds = []
        orig = mgr._command

        def record(cmd):
            sent_cmds.append(cmd)
            orig(cmd)
        mgr._command = record
        before = mgr.balancer.score(c.mon.osdmap)
        out = []
        for _ in range(2):
            sent = mgr.tick()
            c.pump()
            out.append(sent)
        e = c.mon.osdmap.epoch
        io = r.open_ioctx("p")
        io.write_full("post-balance", b"ok" * 200)
        return {"sent": out, "commands": sent_cmds,
                "upmaps": {str(pg): [tuple(p) for p in items] for pg, items
                           in sorted(c.mon.osdmap.pg_upmap_items.items())},
                "daemons_at": sorted({d.osdmap.epoch
                                      for d in c.osds.values()}) == [e],
                "score": (before, mgr.balancer.score(c.mon.osdmap)),
                "status": {k: v for k, v in mgr.status().items()
                           if k != "score"},
                "read": io.read("post-balance")}
    finally:
        c.shutdown()


def test_balancer_round_equals_the_reference(monkeypatch):
    monkeypatch.setattr(ref_balancer, "OSDMapMapping", ScalarTables)
    ref, port = both(balance)
    assert port == ref
    assert port["sent"][0] > 0 and port["upmaps"]
    assert port["commands"][0]["prefix"] == "osd upmap-batch"
    (b, a) = port["score"]
    assert a["stddev"] < b["stddev"] and a["max_deviation"] <= 2.0
    assert port["daemons_at"] and port["read"] == b"ok" * 200
    assert port["status"]["active"] and port["status"]["mode"] == "upmap"


def inactive(kind):
    c, r = make(kind, n=4)
    try:
        mgr = c.start_mgr()
        mgr.active = False
        return (mgr.tick(), dict(c.mon.osdmap.pg_upmap_items),
                mgr.last_optimize)
    finally:
        c.shutdown()


def test_inactive_mgr_submits_nothing():
    ref, port = both(inactive)
    assert port == ref == (0, {}, {})


def test_the_mgr_balancer_lives_on_the_mgr_device():
    from ceph_tpu_torch.msg.messenger import LocalNetwork
    mgr = MgrDaemon(LocalNetwork(), device="cpu")
    assert str(mgr.balancer.device) == "cpu"


# -------------------------------------------------------------- progress

SAMPLES = [
    {("1", "recovering"): {"1.0", "1.1", "1.2"}},
    {("1", "recovering"): {"1.1"}, ("2", "backfilling"): {"2.3", "2.4"}},
    {("2", "backfilling"): {"2.4"}},
    {},
]


def progress_run(kind):
    prog = NS[kind]["progress"](mgr=None)
    seen = []
    for i, s in enumerate(SAMPLES):
        live = prog._apply_sample({k: set(v) for k, v in s.items()},
                                  100.0 + i)
        seen.append((live, prog.ls()))
    prog.update("ext-1", "rebalance", 0.25)
    prog.update("ext-1", "rebalance", 1.5)
    ext = [{k: v for k, v in e.items() if k != "started"}
           for e in prog.ls()]
    prog.complete("ext-1")
    hist = [{k: v for k, v in e.items() if k not in ("started", "finished")
             or e["id"].startswith("pg-")} for e in prog.history()]
    return {"seen": seen, "ext": ext, "history": hist}


def test_progress_events_equal_the_reference():
    ref, port = both(progress_run)
    assert port == ref
    assert [e["progress"] for e in port["history"][:2]] == [1.0, 1.0]
    assert port["ext"][0]["progress"] == 1.0


def progress_on_cluster(kind):
    """progress.tick reads `pg dump` through the mgr's synchronous
    command channel; here the mon answers it inline.  Backfill is held
    at `osd_max_backfills` 0 for four report rounds after an `osd out`,
    so the reports carry a backfilling PG, then let go."""
    cfg = NS[kind]["config"]()
    old = cfg["osd_max_backfills"]
    c, r = make(kind, n=7)
    try:
        io = r.open_ioctx("rep")
        for i in range(16):
            io.write_full(f"o{i}", bytes([i]) * 3000)
        c.tick(T0)

        class Mgr:
            def mon_command(self, cmd):
                return c.mon.handle_command(cmd)
        prog = NS[kind]["progress"](Mgr())
        cfg.set("osd_max_backfills", 0)
        r.mon_command({"prefix": "osd out", "ids": [0]})
        lives, now = [], T0
        for i in range(10):
            if i == 4:
                cfg.set("osd_max_backfills", old)
            now += 6.0          # past osd_mon_report_interval
            c.tick(now)
            lives.append(prog.tick())
        return {"lives": lives,
                "done": [(e["id"], e["message"], e["peak"], e["progress"],
                          e["remaining"]) for e in prog.history()]}
    finally:
        cfg.set("osd_max_backfills", old)
        c.shutdown()


def test_progress_on_a_recovering_cluster_equals_the_reference():
    ref, port = both(progress_on_cluster)
    assert port == ref
    assert port["lives"][0] == 1 and port["lives"][-1] == 0
    assert port["done"] and all(p == 1.0 and rem == 0
                                for *_x, p, rem in port["done"])


# ------------------------------------------------- proxy and health merge

def proxy(kind):
    c, r = make(kind, n=3)
    try:
        out = [r.mon_command({"prefix": "telemetry show"})]
        mgr = c.start_mgr()
        for cmd in ("telemetry show", "insights", "telemetry on"):
            out.append(r.mon_command({"prefix": cmd}))
        ops = len(mgr.op_tracker.dump_historic()["ops"])
        mgr.shutdown()
        c.mgr = None
        out.append(r.mon_command({"prefix": "insights"}))
        out.append(r.mon_command({"prefix": "telemetry show"}))
        return {"answers": out, "ops": ops}
    finally:
        c.shutdown()


def test_mgr_command_proxy_equals_the_reference():
    ref, port = both(proxy)
    assert port == ref
    a = port["answers"]
    assert a[0] == (-11, "EAGAIN(mgr): no active mgr", None)
    assert a[1] == (-2, "telemetry module not enabled", None)
    assert a[2] == (-2, "insights module not enabled", None)
    assert a[4][0] == a[5][0] == -11
    assert a[4][1].startswith("EAGAIN(mgr): ")
    assert port["ops"] == 3


def health_grace(kind, grace):
    cfg = NS[kind]["config"]()
    old = cfg["mon_mgr_health_grace"]
    cfg.set("mon_mgr_health_grace", grace)
    c, r = make(kind, n=3)
    try:
        c.tick(T0)
        checks = {"MGR_TEST": {"severity": "HEALTH_WARN",
                               "summary": "a module warns",
                               "detail": ["one", "two"]}}
        rc = c.mon.handle_command({"prefix": "mgr health report",
                                   "checks": checks})
        out = [rc]
        for dt in (30.0, 59.0, 61.0, 600.0):
            c.tick(T0 + dt)
            _r, status, h = c.mon.handle_command(
                {"prefix": "health detail"})
            out.append((dt, h["checks"].get("MGR_TEST")))
        c.mon.handle_command({"prefix": "mgr health report",
                              "checks": {}})
        out.append(c.mon.handle_command({"prefix": "health"})[2]
                   ["checks"].get("MGR_TEST"))
        return out
    finally:
        c.shutdown()
        cfg.set("mon_mgr_health_grace", old)


@pytest.mark.parametrize("grace", [60.0, 0.0])
def test_module_health_merge_and_grace_equal_the_reference(grace):
    ref, port = both(health_grace, grace)
    assert port == ref
    seen = [h is not None for _dt, h in port[1:5]]
    assert seen == ([True, True, False, False] if grace else [True] * 4)
    assert port[-1] is None


def health_slices(kind):
    """set_health_checks keeps one slice per module and pushes the
    merge (a threaded cluster: the mgr's command channel waits on its
    dispatch thread)."""
    c, r = make(kind, n=3, threaded=True)
    try:
        mgr = c.start_mgr()
        a = {"A_WARN": {"severity": "HEALTH_WARN", "summary": "a",
                        "detail": []}}
        b = {"B_ERR": {"severity": "HEALTH_ERR", "summary": "b",
                       "detail": ["x"]}}
        seen = []
        for module, checks in (("a", a), ("b", b), ("a", {})):
            mgr.set_health_checks(module, checks)
            h = r.mon_command({"prefix": "health"})[2]
            seen.append(sorted(k for k in h["checks"]
                               if k in ("A_WARN", "B_ERR")))
        mgr.observability_tick()
        h = r.mon_command({"prefix": "health"})[2]
        seen.append(sorted(k for k in h["checks"]
                           if k in ("A_WARN", "B_ERR", "HEARTBEAT_STALE")))
        return {"seen": seen, "failed": mgr.failed_commands,
                "unhealthy": mgr.hbmap.get_unhealthy_workers()}
    finally:
        c.shutdown()


def test_health_slices_merge_like_the_reference():
    ref, port = both(health_slices)
    assert port == ref
    assert port["seen"] == [["A_WARN"], ["A_WARN", "B_ERR"], ["B_ERR"],
                            ["B_ERR"]]
    assert port["failed"] == 0 and port["unhealthy"] == []


def test_mgr_admin_socket(tmp_path):
    c, r = make("port", n=3)
    try:
        mgr = c.start_mgr()
        path = str(tmp_path / "mgr.asok")
        mgr.start_admin_socket(path)
        rc, st = admin_command(path, "status")
        assert rc == 0 and st["mode"] == "upmap" and st["active"]
        assert st["epoch"] == c.mon.osdmap.epoch
        r.mon_command({"prefix": "telemetry show"})
        rc, hist = admin_command(path, "dump_historic_ops")
        assert rc == 0 and len(hist["ops"]) == 1
        rc, traces = admin_command(path, "dump_traces")
        assert rc == 0 and traces == []
    finally:
        c.shutdown()
