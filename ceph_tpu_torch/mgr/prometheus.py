"""Prometheus exporter: cluster + per-daemon metrics over HTTP.

The mgr prometheus module analogue (ref: src/pybind/mgr/prometheus/
module.py — health/osd/pool/pg metrics in the Prometheus exposition
text format, scraped at /metrics).  Each scrape pulls fresh state
through the mon command path (`status`, `df`, `osd perf dump`), so the
exporter itself is stateless.

The port's copy of `ceph_tpu.mgr.prometheus`, whole: its rgw sync
gauges read the port's agents (`ceph_tpu_torch.rgw.multisite`).
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_HEALTH_VALUE = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


class _Builder:
    def __init__(self):
        self.lines: list[str] = []

    def metric(self, name: str, help_text: str, kind: str = "gauge"):
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {kind}")

    def sample(self, name: str, value, labels: dict | None = None):
        lbl = ""
        if labels:
            lbl = "{" + ",".join(f'{k}="{_esc(v)}"'
                                 for k, v in sorted(labels.items())) \
                + "}"
        self.lines.append(f"{name}{lbl} {float(value):g}")

    def histogram(self, name: str, hist: dict,
                  labels: dict | None = None):
        """One labeled series of a histogram family: cumulative
        _bucket samples over the explicit bounds plus +Inf, then _sum
        and _count (the prometheus exposition histogram contract).
        Declare the family once with metric(name, ..., "histogram")
        before the first series."""
        labels = dict(labels or {})
        cum = 0
        for bound, n in zip(hist["bounds"], hist["buckets"]):
            cum += n
            self.sample(f"{name}_bucket", cum,
                        {**labels, "le": f"{bound:g}"})
        cum += hist["buckets"][-1]          # overflow bucket
        self.sample(f"{name}_bucket", cum, {**labels, "le": "+Inf"})
        self.sample(f"{name}_sum", hist["sum"], labels)
        self.sample(f"{name}_count", hist["count"], labels)

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


class PrometheusExporter:
    """Serve /metrics off a command channel (`mon_command(cmd) ->
    (rc, outs, outb)`): a Rados handle or a Monitor both qualify."""

    def __init__(self, mon_command, host: str = "127.0.0.1",
                 port: int = 0, progress_ls=None, device_ls=None):
        self._cmd = mon_command
        #: optional callable returning the mgr progress module's
        #: event list (ref: the progress metrics the reference's
        #: prometheus module exports)
        self._progress_ls = progress_ls
        #: optional callable returning devicehealth records
        self._device_ls = device_ls
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                try:
                    body = exporter.collect().encode()
                    status = 200
                except Exception as ex:
                    body = f"# collect failed: {ex}\n".encode()
                    status = 500
                self.send_response(status)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="prometheus",
            daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- collection (ref: prometheus/module.py Module.collect) ---------
    def collect(self) -> str:
        b = _Builder()
        rc, _, status = self._cmd({"prefix": "status"})
        if rc != 0:
            raise RuntimeError("status unavailable")
        b.metric("ceph_health_status",
                 "cluster health (0=OK 1=WARN 2=ERR)")
        b.sample("ceph_health_status",
                 _HEALTH_VALUE.get(status["health"]["status"], 2))
        om = status["osdmap"]
        b.metric("ceph_osd_up", "osd up state")
        b.metric("ceph_osd_in", "osd in state")
        b.sample("ceph_osd_up", om["num_up_osds"])
        b.sample("ceph_osd_in", om["num_in_osds"])
        b.metric("ceph_osdmap_epoch", "current osdmap epoch",
                 "counter")
        b.sample("ceph_osdmap_epoch", om["epoch"])
        pm = status["pgmap"]
        b.metric("ceph_pg_total", "total placement groups")
        b.sample("ceph_pg_total", pm["num_pgs"])
        b.metric("ceph_pg_state", "pg count by state")
        for state, n in sorted(pm.get("pgs_by_state", {}).items()):
            b.sample("ceph_pg_state", n, {"state": state})
        b.metric("ceph_cluster_total_bytes", "raw capacity")
        b.sample("ceph_cluster_total_bytes", pm.get("total_kb", 0) * 1024)
        b.metric("ceph_cluster_total_used_bytes", "raw used")
        b.sample("ceph_cluster_total_used_bytes",
                 pm.get("used_kb", 0) * 1024)
        b.metric("ceph_objects", "total objects")
        b.sample("ceph_objects", pm.get("num_objects", 0))

        rc, _, df = self._cmd({"prefix": "df"})
        if rc == 0:
            b.metric("ceph_pool_objects", "objects per pool")
            b.metric("ceph_pool_bytes", "logical bytes per pool")
            # snaptrim observability: physical store bytes (heads +
            # snap clones) vs the pool's logical bytes exposes the
            # deleted-snapshot space leak, and snaptrim_pgs shows the
            # reclaim actually running (ref: the pg-state and
            # pool-stat gauges of mgr/prometheus)
            b.metric("ceph_pool_store_bytes",
                     "physical store bytes per pool incl. snap clones")
            b.metric("ceph_pool_snaptrim_pgs",
                     "pgs per pool in snaptrim/snaptrim_wait/"
                     "snaptrim_error")
            for pool, st in sorted(df.get("pools", {}).items()):
                b.sample("ceph_pool_objects", st["objects"],
                         {"pool": pool})
                b.sample("ceph_pool_bytes", st["bytes"],
                         {"pool": pool})
                b.sample("ceph_pool_store_bytes",
                         st.get("store_bytes", st["bytes"]),
                         {"pool": pool})
                b.sample("ceph_pool_snaptrim_pgs",
                         st.get("snaptrim_pgs", 0), {"pool": pool})

        rc, _, crashes = self._cmd({"prefix": "crash ls"})
        if rc == 0 and isinstance(crashes, list):
            new = sum(1 for c in crashes if not c.get("archived"))
            b.metric("ceph_crash_reports",
                     "daemon crash reports by archive state")
            b.sample("ceph_crash_reports", new, {"status": "new"})
            b.sample("ceph_crash_reports", len(crashes) - new,
                     {"status": "archived"})

        # rgw multisite sync lag: every in-process sync agent
        # self-registers (rgw.multisite._AGENTS) so the
        # scrape sees zone replication state without a daemon-graph
        # dependency — lag_entries returning to 0 IS "caught up"
        from ..rgw.multisite import sync_status_all
        rows = sync_status_all()
        if rows:
            b.metric("ceph_rgw_sync_lag_entries",
                     "datalog entries the zone has not yet applied "
                     "from its source zone")
            b.metric("ceph_rgw_sync_behind_shards",
                     "datalog shards with unapplied entries per "
                     "(zone, source)")
            for row in rows:
                lbl = {"zone": row["zone"], "source": row["source"]}
                b.sample("ceph_rgw_sync_lag_entries",
                         row["lag_entries"], lbl)
                b.sample("ceph_rgw_sync_behind_shards",
                         row["behind_shards"], lbl)
        from ..rgw.multisite import sync_apply_hists
        hists = sync_apply_hists()
        if hists:
            b.metric("ceph_rgw_sync_apply_latency_seconds",
                     "cross-zone fetch + apply latency per "
                     "replicated entry (the sync op class)",
                     "histogram")
            for zone, hist in sorted(hists.items()):
                b.histogram("ceph_rgw_sync_apply_latency_seconds",
                            hist, {"zone": zone})

        rc, _, counts = self._cmd({"prefix": "log counts"})
        if rc == 0:
            b.metric("ceph_cluster_log_messages",
                     "cluster log entries by severity", "counter")
            for level, n in sorted((counts or {}).items()):
                b.sample("ceph_cluster_log_messages", n,
                         {"level": level})

        rc, _, perf = self._cmd({"prefix": "osd perf dump"})
        if rc == 0:
            emitted: set[str] = set()
            totals: dict[str, float] = {}
            for daemon, counters in sorted(perf.items()):
                for key, val in sorted(counters.items()):
                    if isinstance(val, dict) and "buckets" in val:
                        # per-op-class latency histograms export as
                        # REAL prometheus histogram families
                        # (_bucket/_sum/_count with cumulative le
                        # labels), one series per daemon
                        name = f"ceph_daemon_{key}_seconds"
                        if name not in emitted:
                            emitted.add(name)
                            b.metric(name,
                                     f"per-daemon latency {key}",
                                     "histogram")
                        b.histogram(name, val, {"daemon": daemon})
                        continue
                    is_avg = isinstance(val, dict)
                    if is_avg:                  # long-run averages
                        val = val.get("avg", 0.0)
                    elif isinstance(val, list):  # histograms
                        continue
                    name = f"ceph_daemon_{key}"
                    if name not in emitted:
                        emitted.add(name)
                        b.metric(name, f"per-daemon counter {key}",
                                 "counter")
                    b.sample(name, val, {"daemon": daemon})
                    if not is_avg:
                        # averages don't sum: a cluster-wide
                        # "sum of averages" is meaningless
                        totals[key] = totals.get(key, 0.0) \
                            + float(val)
            # cluster-wide aggregation across every reporting daemon
            # (ref: the DaemonServer-side counter aggregation)
            for key, val in sorted(totals.items()):
                name = f"ceph_cluster_{key}"
                b.metric(name, f"cluster-wide sum of {key}", "counter")
                b.sample(name, val)

        if self._device_ls is not None:
            b.metric("ceph_device_health",
                     "device health (0=GOOD 1=WARNING 2=FAILING)")
            b.metric("ceph_device_media_errors",
                     "media error count per device", "counter")
            sev = {"GOOD": 0, "WARNING": 1, "FAILING": 2}
            for d in self._device_ls():
                lbl = {"device": d["device"], "daemon": d["daemon"]}
                b.sample("ceph_device_health",
                         sev.get(d["health"], 2), lbl)
                b.sample("ceph_device_media_errors",
                         d["csum_errors"] + d["read_errors"], lbl)
        if self._progress_ls is not None:
            b.metric("ceph_progress_event",
                     "long-running event completion ratio")
            for ev in self._progress_ls():
                b.sample("ceph_progress_event", ev["progress"],
                         {"id": ev["id"], "message": ev["message"]})
        return b.render()
