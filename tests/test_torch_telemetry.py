"""The port's telemetry and insights modules held to the reference's.

Four cases of tests/test_crash_telemetry.py run on
`ceph_tpu.testing.MiniCluster` and on
`ceph_tpu_torch.testing.MiniCluster(device="cpu")` (threaded, as the
reference's: the modules' synchronous `mon_command` waits on the mgr's
dispatch thread) and compare at tolerance 0:

* the anonymized report (`telemetry show` through the mon): the same
  keys, cluster id, `basic` section, crash summary and channel switches,
  and no hostname, path, entity or pool name in it;
* the insights window: samples, transitions, osdmap epochs and crashes
  inside and outside the window, and `prune-health`;
* the `rados` verbs `telemetry [status|show]` and `insights` with their
  return codes;
* the upload target (`mgr_telemetry_url`): a `file://` sink gets one
  JSON line per tick, a loopback `http://` sink gets the POSTed report
  and `telemetry send` posts again, an unreachable sink is recorded as a
  failed send, and no sink records nothing.

Masked: what comes from the wall clock or from each package's own
source (report and crash timestamps, a crash's backtrace, whose file
names and lines are each package's, and the perf counters' values).
"""
import io as iomod
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu.tools import rados_cli as ref_cli
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.testing import MiniCluster as PortCluster
from ceph_tpu_torch.tools import rados_cli as port_cli

NS = {
    "ref": dict(cluster=RefCluster, config=ref_config, cli=ref_cli, kw={}),
    "port": dict(cluster=PortCluster, config=port_config, cli=port_cli,
                 kw={"device": "cpu"}),
}


def both(scenario):
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


def wait_for(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end and not pred():
        time.sleep(0.05)
    return pred()


def threaded(ns, n_osd):
    c = ns["cluster"](n_osd=n_osd, threaded=True, **ns["kw"])
    c.wait_all_up()
    return c, c.rados()


def comparable(rep: dict) -> dict:
    """A report without its wall-clock stamps, the crash backtraces and
    the perf counters' values."""
    out = {k: v for k, v in rep.items() if k != "report_timestamp"}
    if "crash" in out:
        out["crash"] = {
            "summary": out["crash"]["summary"],
            "reports": [{k: v for k, v in c.items()
                         if k not in ("timestamp", "backtrace")}
                        for c in out["crash"]["reports"]]}
    if "perf" in out:
        out["perf"] = sorted(out["perf"])
    return out


def anonymous(rep: dict) -> tuple:
    """The anonymization contract: no hostname, no path, no entity
    name, no pool name."""
    js = json.dumps(rep)
    return (socket.gethostname() not in js,
            "/" not in js.replace("\\/", ""), "osd.2" not in js,
            "tp" not in json.dumps(rep["basic"]))


def crash_and_wait(c, r, osd):
    c.crash_osd(osd)
    assert wait_for(lambda: r.mon_command({"prefix": "crash ls"})[2])


def test_telemetry_anonymized_and_schema_stable():
    def s(ns):
        c, r = threaded(ns, 4)
        try:
            r.pool_create("tp", pg_num=8)
            mgr = c.start_mgr()
            mgr.start_crash()
            tm = mgr.start_telemetry()
            crash_and_wait(c, r, 2)
            mgr.observability_tick()
            rc, _, rep = r.mon_command({"prefix": "telemetry show"})
            again = tm.compile_report()
            out = {"show": (rc, comparable(rep)),
                   "stable": (sorted(rep) == sorted(again),
                              sorted(rep["basic"]) ==
                              sorted(again["basic"])),
                   "anonymous": anonymous(rep),
                   "status": r.mon_command(
                       {"prefix": "telemetry status"})[2]["channels"]}
            r.mon_command({"prefix": "telemetry channel",
                           "name": "ident", "enabled": True})
            mgr.observability_tick()
            out["ident"] = r.mon_command(
                {"prefix": "telemetry show"})[2]["ident"]
            r.mon_command({"prefix": "telemetry channel",
                           "name": "crash", "enabled": False})
            mgr.observability_tick()
            out["no_crash"] = "crash" in r.mon_command(
                {"prefix": "telemetry show"})[2]
            r.mon_command({"prefix": "telemetry off"})
            out["off"] = r.mon_command({"prefix": "telemetry show"})[:2]
            r.mon_command({"prefix": "telemetry on"})
            mgr.observability_tick()
            out["on"] = r.mon_command({"prefix": "telemetry show"})[0]
            return out
        finally:
            c.shutdown()
    out = both(s)
    rc, rep = out["show"]
    assert rc == 0 and out["stable"] == (True, True)
    assert out["anonymous"] == (True, True, True, True)
    assert len(rep["cluster_id"]) == 32
    assert rep["basic"]["osds"]["total"] == 4
    assert rep["basic"]["pools"]["count"] == 1
    assert rep["crash"]["reports"][0]["entity_type"] == "osd"
    assert out["status"]["ident"] is False
    assert out["ident"]["mons"] == ["mon.0"]
    assert out["no_crash"] is False
    assert out["off"] == (-1, "telemetry is off — enable with "
                              "`telemetry on`")
    assert out["on"] == 0


def test_insights_window_math():
    def s(ns):
        c, r = threaded(ns, 2)
        try:
            mgr = c.start_mgr()
            mgr.start_crash()
            ins = mgr.start_insights(window=100.0)
            ins.tick(now=1000.0)
            r.pool_create("ip", pg_num=8)
            ins.tick(now=1050.0)
            ins.tick(now=1200.0)
            out = [ins.report(now=1200.0), ins.report(now=1050.0),
                   ins.prune_health(1100.0),
                   ins.report(now=1050.0)["health"]["samples"]]
            crash_and_wait(c, r, 1)
            mgr.observability_tick()
            now = time.time()
            out.append([cr["entity_name"]
                        for cr in ins.report(now=now)["crashes"]])
            out.append(ins.report(now=now + 1000.0)["crashes"])
            out.append(r.mon_command({"prefix": "insights prune-health",
                                      "hours": -1})[:2])
            return out
        finally:
            c.shutdown()
    late, full, pruned, left, crashes, none, bad = both(s)
    assert late["health"]["samples"] == 1 and late["window_seconds"] == 100
    assert full["health"]["samples"] == 2
    assert full["osdmap"]["epoch_delta"] >= 1
    assert full["osdmap"]["last_epoch"] > full["osdmap"]["first_epoch"]
    assert pruned == 2 and left == 0
    assert crashes == ["osd.1"] and none == []
    assert bad == (-22, "hours must be >= 0")


def test_observability_cli_verbs():
    def s(ns):
        c, r = threaded(ns, 3)
        try:
            mgr = c.start_mgr()
            mgr.start_crash()
            mgr.start_telemetry()
            mgr.start_insights()
            crash_and_wait(c, r, 1)
            mgr.observability_tick()

            def run(*argv):
                out = iomod.StringIO()
                rc = ns["cli"].main(list(argv), rados=r, out=out)
                return rc, out.getvalue()
            status = run("telemetry", "status")
            show = run("telemetry")
            insights = run("insights")
            channel = run("telemetry", "channel")
            return (status[0], json.loads(status[1])["enabled"],
                    json.loads(status[1])["channels"], show[0],
                    comparable(json.loads(show[1])), insights[0],
                    sorted(json.loads(insights[1])), channel)
        finally:
            c.shutdown()
    out = both(s)
    assert out[:3] == (0, True, {"basic": True, "crash": True,
                                 "perf": True, "ident": False})
    assert out[3] == 0 and out[4]["cluster_id"]
    assert out[5] == 0 and "window_seconds" in out[6]
    assert out[7] == (1, "")


def test_telemetry_upload_target(tmp_path):
    def s(ns):
        cfg = ns["config"]()
        old_url = cfg["mgr_telemetry_url"]
        c, r = threaded(ns, 3)
        out = {}
        try:
            mgr = c.start_mgr()
            tm = mgr.start_telemetry()
            sink = tmp_path / f"{ns['cli'].__name__}.jsonl"
            cfg.set("mgr_telemetry_url", f"file://{sink}")
            mgr.observability_tick()
            mgr.observability_tick()
            lines = sink.read_text().strip().splitlines()
            st = r.mon_command({"prefix": "telemetry status"})[2]
            out["file"] = (len(lines),
                           json.loads(lines[-1])["cluster_id"] ==
                           tm.cluster_id(),
                           st["last_send"]["ok"],
                           st["last_send"]["url"] == f"file://{sink}",
                           st["url"] == f"file://{sink}")
            got = []

            class Sink(BaseHTTPRequestHandler):
                def log_message(self, *a):
                    pass

                def do_POST(self):
                    n = int(self.headers.get("Content-Length", 0))
                    got.append(json.loads(self.rfile.read(n)))
                    self.send_response(200)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            httpd = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}/"
            try:
                cfg.set("mgr_telemetry_url", url)
                mgr.observability_tick()
                first = len(got), got[0]["cluster_id"] == tm.cluster_id()
                rc, outs, _ = r.mon_command({"prefix": "telemetry send"})
                out["http"] = (first, rc, outs, len(got))
            finally:
                httpd.shutdown()
                httpd.server_close()
            mgr.observability_tick()
            st = r.mon_command({"prefix": "telemetry status"})[2]
            out["down"] = (st["last_send"]["ok"],
                           bool(st["last_send"]["error"]))
            cfg.set("mgr_telemetry_url", "")
            tm.last_send = None
            mgr.observability_tick()
            st = r.mon_command({"prefix": "telemetry status"})[2]
            out["none"] = (st["last_send"], st["url"],
                           r.mon_command({"prefix": "telemetry send"})[:2])
            return out
        finally:
            cfg.set("mgr_telemetry_url", old_url)
            c.shutdown()
    out = both(s)
    assert out["file"] == (2, True, True, True, True)
    assert out["http"] == ((1, True), 0, "report sent", 2)
    assert out["down"] == (False, True)
    assert out["none"] == (None, None,
                           (-22, "no mgr_telemetry_url configured"))
