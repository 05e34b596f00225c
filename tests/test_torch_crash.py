"""The port's crash capture held to the reference's.

The capture, service and spool cases of tests/test_crash_telemetry.py
(`crash_meta`, `sanitize_backtrace`, the reporter's spool and drain
lifecycle and its repeat throttle, the mon's crash table with dedup,
archive and prune, the table across a mon restart, a quorum's spool
drain) run on `ceph_tpu` and on `ceph_tpu_torch` (clusters on
`device="cpu"`) and compare at tolerance 0; stamps that come from the
wall clock (a crash's own time, an archive's time) are the only fields
masked.  The crash half of the end-to-end case (an OSD crashed under
IO, one report from the live post and the spool, RECENT_CRASH through
the mgr's crash module, archived away) runs on both threaded clusters;
telemetry's report carries the crash summary, and the mgr's prometheus
scrape the archive-state gauge.  The
`rados crash` verbs print the reference's text and return its codes,
and `daemon_main` picks the reference's spool directory.  The MDS case
(a crash captured by an MDS rank, posted with a real tid, its spool
copy retired by the mon's ack) runs on both packages' threaded
clusters (the harness of tests/test_torch_cephfs.py).
"""
import io as iomod
import time

import pytest

from ceph_tpu.common import crash as ref_crash
from ceph_tpu.mgr import crash as ref_mgr_crash
from ceph_tpu.mon.monitor import Monitor as RefMonitor
from ceph_tpu.mon.monitor import build_initial as ref_build
from ceph_tpu.msg.messenger import LocalNetwork as RefNet
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu.tools import daemon_main as ref_daemon_main
from ceph_tpu.tools import rados_cli as ref_cli
from ceph_tpu_torch.common import crash as port_crash
from ceph_tpu_torch.mgr import crash as port_mgr_crash
from ceph_tpu_torch.mon.monitor import Monitor as PortMonitor
from ceph_tpu_torch.mon.monitor import build_initial as port_build
from ceph_tpu_torch.msg.messenger import LocalNetwork as PortNet
from ceph_tpu_torch.testing import MiniCluster as PortCluster
from ceph_tpu_torch.tools import daemon_main as port_daemon_main
from ceph_tpu_torch.tools import rados_cli as port_cli
from test_torch_cephfs import bare_sides  # noqa: F401

NS = {
    "ref": dict(crash=ref_crash, mgr_crash=ref_mgr_crash, mon=RefMonitor,
                build=ref_build, net=RefNet, cluster=RefCluster,
                daemon_main=ref_daemon_main, cli=ref_cli, kw={}),
    "port": dict(crash=port_crash, mgr_crash=port_mgr_crash,
                 mon=PortMonitor, build=port_build, net=PortNet,
                 cluster=PortCluster, daemon_main=port_daemon_main,
                 cli=port_cli, kw={"device": "cpu"}),
}
STAMP = 1_700_000_000.25


def _boom():
    raise ValueError("synthetic fault for crash capture")


def _exc():
    try:
        _boom()
    except ValueError as ex:
        return ex


def both(scenario):
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


def wait_for(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# ------------------------------------------------------ capture library
def test_crash_meta_fields():
    ex = _exc()
    meta = both(lambda ns: ns["crash"].crash_meta("osd.7", ex, stamp=STAMP))
    assert meta["crash_id"].endswith("_osd.7")
    assert meta["crash_id"].startswith(meta["timestamp"])
    assert (meta["entity_name"], meta["entity_type"], meta["exc_type"]) \
        == ("osd.7", "osd", "ValueError")
    assert any("_boom" in ln for ln in meta["backtrace"])
    assert meta["archived"] is None and meta["stamp"] == STAMP
    assert port_crash.CRASH_META_VERSION == ref_crash.CRASH_META_VERSION


@pytest.mark.parametrize("stamp", [0.0, 1_699_999_999.9999996, STAMP])
def test_utc_iso_equals_reference(stamp):
    assert port_crash.utc_iso(stamp) == ref_crash.utc_iso(stamp)


def test_sanitize_backtrace_strips_paths():
    try:
        open("/var/lib/ceph-tpu-nope/osd.3/store")
    except OSError as ex:
        leaky = ex
    ex = _exc()

    def s(ns):
        c = ns["crash"]
        return (c.sanitize_backtrace(c.crash_meta("osd.1", ex,
                                                  stamp=STAMP)["backtrace"]),
                c.sanitize_backtrace(c.crash_meta("osd.3", leaky,
                                                  stamp=STAMP)["backtrace"]))
    clean, clean_leaky = both(s)
    assert any("test_torch_crash.py" in ln for ln in clean)
    assert not any("/" in ln for ln in clean if 'File "' in ln)
    assert not any("/var/lib" in ln for ln in clean_leaky)
    assert any("'store'" in ln for ln in clean_leaky)


def test_reporter_spool_drain_lifecycle(tmp_path):
    ex = _exc()

    def s(ns):
        root = tmp_path / ns["crash"].__name__.split(".")[0] / "crash"
        posted = []
        rep = ns["crash"].CrashReporter("osd.3", crash_dir=str(root),
                                        post=posted.append,
                                        clock=lambda: STAMP)
        meta = rep.capture(ex)
        files = sorted(str(p.relative_to(root))
                       for p in root.rglob("meta.json"))
        spooled = rep.spooled()
        drained = rep.drain()
        rep.mark_delivered(meta["crash_id"])
        return (meta, posted, files, spooled, drained, rep.spooled(),
                rep.drain(), rep.captured)
    meta, posted, files, spooled, drained, after, again, captured = both(s)
    assert posted == [meta, meta] and spooled == [meta]
    assert len(files) == 1 and drained == 1 and after == [] and again == 0
    assert captured == [meta["crash_id"]]


def test_reporter_throttles_repeat_signature():
    ex = _exc()

    def s(ns):
        t = [STAMP]
        posted = []
        rep = ns["crash"].CrashReporter("osd.0", post=posted.append,
                                        clock=lambda: t[0])
        out = [bool(rep.capture(ex)), rep.capture(ex),
               bool(rep.capture(RuntimeError("other fault")))]
        t[0] += rep.REPEAT_WINDOW + 1        # past the window
        out.append(bool(rep.capture(RuntimeError("other fault"))))
        return out, len(posted)
    out, n = both(s)
    assert out == [True, {}, True, True] and n == 3


def test_ack_tracking_retires_only_successful_posts(tmp_path):
    ex = _exc()

    def s(ns):
        root = tmp_path / ns["crash"].__name__.split(".")[0]
        rep = ns["crash"].CrashReporter("mon.1", crash_dir=str(root),
                                        clock=lambda: STAMP)
        meta = rep.capture(ex)
        t1 = rep.alloc_tid(meta["crash_id"])
        t2 = rep.alloc_tid(meta["crash_id"])
        out = [rep.on_ack(t1, -11), len(rep.spooled()), rep.on_ack(99, 0),
               rep.on_ack(t2, 0), len(rep.spooled())]
        t3 = rep.alloc_tid("x")
        rep.forget_tid(t3)
        out.append(rep.on_ack(t3, 0))
        return out
    assert both(s) == [True, 1, False, True, 0, False]


# ----------------------------------------------------- mon crash table
def _mask(v):
    """Archive stamps come from the wall clock: keep only whether a
    report is archived."""
    if isinstance(v, (list, tuple)):
        return type(v)(_mask(m) for m in v)
    if isinstance(v, dict) and "crash_id" in v:
        return {**v, "archived": bool(v.get("archived"))}
    return v


def test_crash_service_dedup_archive_prune():
    meta = ref_crash.crash_meta("osd.2", _exc(), stamp=time.time())

    def s(ns):
        m, w = ns["build"](4)
        mon = ns["mon"](ns["net"](), initial_map=m, initial_wrapper=w,
                        threaded=False, **ns["kw"])
        mon.init()
        cid = meta["crash_id"]
        script = [{"prefix": "crash post", "meta": meta},
                  {"prefix": "crash post", "meta": meta},
                  {"prefix": "crash ls"}, {"prefix": "crash stat"},
                  {"prefix": "crash info", "id": cid},
                  {"prefix": "crash info", "id": "nope"},
                  {"prefix": "crash archive", "id": cid},
                  {"prefix": "crash archive", "id": cid},
                  {"prefix": "crash ls-new"}, {"prefix": "crash ls"},
                  {"prefix": "crash prune", "keep": -1},
                  {"prefix": "crash prune", "keep": 0},
                  {"prefix": "crash ls"},
                  {"prefix": "crash post", "meta": {"crash_id": "x"}},
                  {"prefix": "crash post", "meta": "x"},
                  {"prefix": "crash archive-all"},
                  {"prefix": "crash frobnicate"}]
        try:
            return [_mask(mon.handle_command(c)) for c in script]
        finally:
            mon.shutdown()
    out = both(s)
    assert [r for r, _, _ in out[:2]] == [0, 0] and len(out[2][2]) == 1
    assert out[3][2] == {"total": 1, "new": 1}
    assert out[4][2]["backtrace"] == meta["backtrace"] and out[5][0] == -2
    assert out[8][2] == [] and out[9][2][0]["archived"]
    assert out[10][0] == -22 and out[12][2] == []
    assert out[13][0] == -22 and "missing" in out[13][1]


def test_crash_table_encodes_to_the_references_bytes():
    """The committed table is the reference's: the same posts give the
    same wire bytes in each package's crash store."""
    metas = [ref_crash.crash_meta(f"osd.{i}", _exc(), stamp=STAMP + i)
             for i in range(3)]

    def s(ns):
        m, w = ns["build"](2)
        mon = ns["mon"](ns["net"](), initial_map=m, initial_wrapper=w,
                        threaded=False, **ns["kw"])
        mon.init()
        try:
            for meta in metas:
                assert mon.handle_command(
                    {"prefix": "crash post", "meta": meta})[0] == 0
            svc = mon.crashmon
            v = svc.get_last_committed()
            return v - 1, bytes(svc.get_version(f"v_{v}"))
        finally:
            mon.shutdown()
    n, _blob = both(s)
    assert n == 3


def _crash_ls_after_restart(ns):
    c = ns["cluster"](n_osd=2, threaded=True, **ns["kw"])
    try:
        c.wait_all_up()
        c.crash_osd(1)
        r = c.rados()
        assert wait_for(lambda: r.mon_command({"prefix": "crash ls"})[2])
        store = c.mon.store
        meta = r.mon_command({"prefix": "crash ls"})[2][0]
        mon2 = ns["mon"](ns["net"](), store=store, threaded=False,
                         **ns["kw"])
        mon2.init()
        rc, _, crashes = mon2.handle_command({"prefix": "crash ls"})
        mon2.shutdown()
        return (rc, [m["crash_id"] for m in crashes] == [meta["crash_id"]],
                meta["entity_name"], meta["exc_msg"], 1 in c.osds,
                [(o, t) for o, t, _tb in getattr(c, "reaped", [])])
    finally:
        c.shutdown()


def test_crash_table_survives_mon_restart():
    out = _crash_ls_after_restart(NS["port"])
    ref = _crash_ls_after_restart(NS["ref"])
    assert out[:5] == ref[:5]
    assert out[:5] == (0, True, "osd.1",
                       "injected crash (osd_debug_inject_crash_tick)", False)
    # the port's harness also records the reap (the reference's only logs)
    assert out[5] == [(1, "RuntimeError")]


def test_quorum_mons_drain_crash_spool(tmp_path):
    """A quorum member's spool drains once the election settles: the
    leader commits its own reports, a peon forwards them and retires
    each spool file on the leader's ack."""
    def s(ns):
        root = tmp_path / ns["crash"].__name__.split(".")[0]
        dirs = {r: str(root / f"mon{r}-crash") for r in (0, 2)}
        for r in (0, 2):
            rep = ns["crash"].CrashReporter(f"mon.{r}", crash_dir=dirs[r])
            rep.spool(ns["crash"].crash_meta(f"mon.{r}", _exc(),
                                             stamp=STAMP + r))
        c = ns["cluster"](n_osd=2, n_mon=3, threaded=False,
                          mon_crash_dirs=dirs, **ns["kw"])
        try:
            for _ in range(10):
                c.pump()
            rc, _, crashes = c.mon.handle_command({"prefix": "crash ls"})
            return (c.mon.is_leader, rc, _mask(crashes),
                    sorted(str(p.relative_to(root))
                           for p in root.rglob("meta.json")))
        finally:
            c.shutdown()
    leader, rc, crashes, left = both(s)
    assert leader and rc == 0 and left == []
    assert [m["entity_name"] for m in crashes] == ["mon.0", "mon.2"]


def _osd_crash_e2e(ns, crash_dir):
    c = ns["cluster"](n_osd=3, threaded=True, **ns["kw"])
    out = {}
    try:
        c.wait_all_up()
        c.kill_osd(1)
        c.start_osd(1, crash_dir=crash_dir)
        c.wait_all_up()
        r = c.rados()
        r.pool_create("cp", pg_num=8)
        io = r.open_ioctx("cp")
        for i in range(8):
            io.write_full(f"o{i}", b"x" * 64)
        mgr = c.start_mgr()
        mgr.start_crash()
        mgr.start_telemetry()
        mgr.observability_tick()
        out["before"] = "RECENT_CRASH" in r.mon_command(
            {"prefix": "health"})[2]["checks"]
        c.crash_osd(1)
        out["reaped"] = 1 not in c.osds
        assert wait_for(lambda: r.mon_command({"prefix": "crash ls"})[2])
        crashes = r.mon_command({"prefix": "crash ls"})[2]
        meta = crashes[0]
        out["crash"] = (len(crashes), meta["entity_name"], meta["exc_msg"],
                        any("heartbeat_tick" in ln
                            for ln in meta["backtrace"]))
        mgr.observability_tick()
        rc, status, health = r.mon_command({"prefix": "health"})
        _, _, detail = r.mon_command({"prefix": "health detail"})
        out["recent"] = (status, "RECENT_CRASH" in health["checks"],
                         health["checks"].get("RECENT_CRASH"),
                         [d.split(" crashed at ")[0] for d in
                          detail["checks"]["RECENT_CRASH"]["detail"]])
        c.start_osd(1, crash_dir=crash_dir)
        c.wait_all_up()
        out["spool_retired"] = wait_for(
            lambda: not list(__import__("pathlib").Path(
                crash_dir).rglob("meta.json")))
        out["count"] = len(r.mon_command({"prefix": "crash ls"})[2])
        out["summary"] = (mgr.observability_tick(),
                          mgr.crash.summary())[1]
        rc, outs, rep = r.mon_command({"prefix": "telemetry show"})
        out["telemetry"] = (rc, rep["crash"]["summary"],
                            [x["entity_type"] for x in
                             rep["crash"]["reports"]])
        out["archive"] = r.mon_command({"prefix": "crash archive-all"})[0]
        mgr.observability_tick()
        out["after"] = "RECENT_CRASH" in r.mon_command(
            {"prefix": "health"})[2]["checks"]
        out["summary_after"] = mgr.crash.summary()
        text = mgr.start_prometheus(port=0).collect()
        mgr.prometheus.shutdown()
        out["gauge"] = [ln for ln in text.splitlines()
                        if "ceph_crash_reports" in ln]
        return out
    finally:
        c.shutdown()


def test_osd_crash_e2e_recent_crash_and_dedup(tmp_path):
    """The crash half of the reference's acceptance path: an OSD under
    IO takes an injected fault; exactly one report lands (live post plus
    the spool drained on revive), RECENT_CRASH rises through the mgr's
    crash module, telemetry carries the summary, the alert clears when
    archived, and prometheus exports the archive-state gauge."""
    ref = _osd_crash_e2e(NS["ref"], str(tmp_path / "ref-osd1-crash"))
    port = _osd_crash_e2e(NS["port"], str(tmp_path / "port-osd1-crash"))
    assert port == ref
    assert port["before"] is False and port["reaped"]
    assert port["crash"] == (1, "osd.1",
                             "injected crash (osd_debug_inject_crash_tick)",
                             True)
    assert port["recent"][:2] == ("HEALTH_WARN", True)
    assert port["recent"][3] == ["osd.1"]
    assert port["spool_retired"] and port["count"] == 1
    assert port["summary"] == {"total": 1, "new": 1,
                               "by_entity_type": {"osd": 1}}
    assert port["archive"] == 0 and port["after"] is False
    assert port["summary_after"]["new"] == 0
    assert port["telemetry"][0] == 0 and \
        port["telemetry"][1]["total"] == 1 and port["telemetry"][2] == ["osd"]
    assert 'ceph_crash_reports{status="archived"} 1' in port["gauge"]
    assert 'ceph_crash_reports{status="new"} 0' in port["gauge"]


class _StubMgr:
    def __init__(self, crashes):
        self.crashes = crashes
        self.reports = []

    def mon_command(self, cmd):
        if cmd["prefix"] == "crash ls":
            return 0, "", [dict(c) for c in self.crashes]
        return 0, "", None

    def set_health_checks(self, module, checks):
        self.reports.append((module, checks))


def test_mgr_crash_module_equals_reference():
    metas = [ref_crash.crash_meta(f"{kind}.{i}", _exc(), stamp=STAMP + i)
             for i, kind in enumerate(("osd", "osd", "mon"))]
    metas[1]["archived"] = STAMP + 10

    def s(ns):
        out = []
        for now in (STAMP + 100, STAMP + 30 * 86400):
            mgr = _StubMgr(metas)
            mod = ns["mgr_crash"].CrashModule(mgr)
            mod.tick(now)
            out.append((mgr.reports, mod.summary(), len(mod.ls()),
                        len(mod.ls(new_only=True))))
        return out
    (recent, _), (stale, _) = [(o[0], o[1]) for o in both(s)]
    assert recent[0][1]["RECENT_CRASH"]["summary"].startswith("2 daemon")
    assert stale == [("crash", {})]


# --------------------------------------------------------- CLI, daemon
def _cli_script(ns):
    c = ns["cluster"](n_osd=2, threaded=False, **ns["kw"])
    try:
        c.pump()
        r = c.rados()
        meta = ref_crash.crash_meta("osd.1", _exc(), stamp=STAMP)
        assert r.mon_command({"prefix": "crash post", "meta": meta})[0] == 0
        out = []
        for argv in (["crash", "ls"], ["crash", "ls-new"],
                     ["crash", "stat"], ["crash", "info", meta["crash_id"]],
                     ["crash", "info"], ["crash", "info", "nope"],
                     ["crash", "prune"], ["crash", "prune", "x"],
                     ["crash", "archive"], ["crash", "archive-all"],
                     ["crash", "stat"], ["crash", "prune", "0"],
                     ["crash", "stat"]):
            buf = iomod.StringIO()
            rc = ns["cli"].main(argv, rados=r, out=buf)
            out.append((argv, rc, buf.getvalue()))
        return out
    finally:
        c.shutdown()


def test_crash_verbs_print_the_references_text():
    out = both(_cli_script)
    assert [rc for _a, rc, _o in out] == [0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0,
                                          0, 0]
    assert '"total": 0' in out[-1][2]


@pytest.mark.parametrize("argv", [
    ["osd", "--id", "0", "--monmap", "m.json"],
    ["osd", "--id", "0", "--monmap", "m.json", "--crash-dir", "c"],
    ["mon", "--monmap", "m.json", "--data-dir", "d"],
    ["mon", "--monmap", "m.json", "--data-dir", "d", "--crash-dir", "c"]])
def test_daemon_crash_dir_equals_reference(argv):
    """--crash-dir is accepted, and both packages pick the same spool:
    the flag, else <data-dir>/crash, else none."""
    args = port_daemon_main.parser().parse_args(argv)
    assert port_daemon_main._crash_dir(args) == \
        ref_daemon_main._crash_dir(args)


def c_mds_crash_spool_retired_on_ack(s, tmp_path):
    """tests/test_crash_telemetry.py's MDS case on one package."""
    c = s.cluster(n_osd=2)
    spool = tmp_path / s.kind / "mds-crash"
    mds = c.start_mds(0, crash_dir=str(spool))
    mds.crash_reporter.capture(RuntimeError("mds fault"))
    r = c.rados()
    end = time.monotonic() + 10
    while time.monotonic() < end and list(spool.rglob("meta.json")):
        time.sleep(0.05)
    assert not list(spool.rglob("meta.json")), \
        "MDS spool copy never retired by the ack"
    _, _, crashes = r.mon_command({"prefix": "crash ls"})
    assert [m["entity_name"] for m in crashes] == ["mds.0"]
    return [[m["entity_name"], m.get("backtrace", [])[-1:]]
            for m in crashes]


def test_mds_crash_spool_retired_on_ack(bare_sides, tmp_path):  # noqa: F811
    """An MDS crash post carries a real tid and the mon's ack retires the
    spool copy; the crash table lists the same entity and fault in both
    packages."""
    got = {kind: s.norm(c_mds_crash_spool_retired_on_ack(s, tmp_path))
           for kind, s in bare_sides.items()}
    assert got["port"] == got["ref"]
