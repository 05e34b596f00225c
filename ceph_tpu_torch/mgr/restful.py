"""restful: the programmatic REST admin API served by the mgr.

The restful module analogue (ref: src/pybind/mgr/restful/module.py +
api/*.py — a JSON HTTP surface over the same mon-command plumbing the
CLI uses, authenticated by API keys).  Endpoints mirror the
reference's resource map:

    GET  /                      endpoint index
    GET  /status                cluster status (mon `status`)
    GET  /health                health checks (mon `health detail`)
    GET  /df                    usage (mon `df`)
    GET  /osd                   osds with up/in/weight (mon `osd dump`)
    GET  /osd/<id>              one osd
    POST /osd/<id>/command      {"command": "down"|"out"|"in"}
    GET  /pool                  pools (mon `osd pool ls` + `get`)
    POST /pool                  {"name": .., "pg_num": ..,
                                 "type": "replicated"|"erasure", ...}
    DELETE /pool/<name>
    GET  /pg                    pg summary (mon `pg stat`)

Auth (ref: restful's api-key store): requests must carry
`Authorization: Bearer <key>`; keys are minted by `create_key()` and
held by the server (the reference persists them in the mon config-key
store; here the mgr process owns the listener, so process-local is
the same trust domain).  A server started with no keys is open —
test/dev mode, like the reference's self-signed bootstrap.

The port's copy of `ceph_tpu.mgr.restful`, whole.
"""
from __future__ import annotations

import json
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Html(str):
    """Marker type: a route returning _Html is served as text/html.
    An explicit declaration, not content sniffing — a plain string
    payload that happens to start with '<' must still go out as
    JSON."""


class RestfulServer:
    """One HTTP listener bound to a mgr (anything with mon_command)."""

    def __init__(self, mgr, host: str = "127.0.0.1", port: int = 0):
        self.mgr = mgr
        self.keys: dict[str, str] = {}      # key -> name
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _html(self, status: int, markup: str) -> None:
                body = markup.encode()
                self.send_response(status)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _run(self, method: str) -> None:
                try:
                    if not srv._authorized(self.headers):
                        return self._json(401, {"error": "unauthorized"})
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n)) if n else {}
                    status, payload = srv._route(method,
                                                 self.path, body)
                    if isinstance(payload, _Html):
                        self._html(status, str(payload))
                        return
                    self._json(status, payload)
                except Exception as e:      # noqa: BLE001 — admin API:
                    # every failure must come back as JSON, not a
                    # dropped connection
                    self._json(500, {"error": str(e)})

            def do_GET(self):
                self._run("GET")

            def do_POST(self):
                self._run("POST")

            def do_DELETE(self):
                self._run("DELETE")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="mgr-restful",
            daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- auth ------------------------------------------------------------
    def create_key(self, name: str = "admin") -> str:
        key = secrets.token_urlsafe(24)
        self.keys[key] = name
        return key

    def delete_key(self, key: str) -> None:
        self.keys.pop(key, None)

    def _authorized(self, headers) -> bool:
        if not self.keys:
            return True                     # open/dev mode
        auth = headers.get("Authorization", "")
        return auth.startswith("Bearer ") and \
            auth[len("Bearer "):] in self.keys

    # -- plumbing --------------------------------------------------------
    def _mon(self, cmd: dict):
        """mon command -> parsed payload; non-zero rc raises (surfaces
        as the handler's JSON 500, carrying the mon's outs text)."""
        rc, outs, outb = self.mgr.mon_command(cmd)
        if rc != 0:
            raise RuntimeError(outs or f"rc={rc}")
        return outb if outb is not None else outs

    def _route(self, method: str, path: str, body: dict):
        parts = [p for p in path.split("?")[0].split("/") if p]
        if not parts:
            return 200, {"endpoints": [
                "/status", "/health", "/df", "/osd", "/osd/<id>",
                "/osd/<id>/command", "/pool", "/pool/<name>", "/pg",
                "/dashboard", "/dashboard?format=html"]}
        head = parts[0]
        if method == "GET":
            if head == "dashboard":
                return self._dashboard(path)
            if head == "status":
                return 200, self._mon({"prefix": "status"})
            if head == "health":
                return 200, self._mon({"prefix": "health detail"})
            if head == "df":
                return 200, self._mon({"prefix": "df"})
            if head == "pg":
                return 200, self._mon({"prefix": "pg stat"})
            if head == "osd":
                dump = self._mon({"prefix": "osd dump"})
                osds = dump.get("osds", dump)
                if len(parts) == 1:
                    return 200, osds
                try:
                    want = int(parts[1])
                except ValueError:
                    # client error, not a 500 from the blanket except
                    return 400, {"error": "bad osd id"}
                for o in osds:
                    if int(o.get("osd", -1)) == want:
                        return 200, o
                return 404, {"error": f"osd.{want} not found"}
            if head == "pool":
                names = self._mon({"prefix": "osd pool ls"})
                out = []
                for nm in names:
                    info = {"pool_name": nm}
                    for var in ("size", "min_size", "pg_num",
                                "erasure_code_profile"):
                        try:
                            got = self._mon({"prefix": "osd pool get",
                                             "pool": nm, "var": var})
                            if isinstance(got, dict):
                                info.update(got)
                            else:
                                info[var] = got
                        except RuntimeError:
                            pass
                    out.append(info)
                if len(parts) == 1:
                    return 200, out
                for p in out:
                    if p["pool_name"] == parts[1]:
                        return 200, p
                return 404, {"error": f"pool {parts[1]} not found"}
        if method == "POST" and head == "osd" and len(parts) == 3 \
                and parts[2] == "command":
            command = body.get("command", "")
            if command not in ("down", "out", "in"):
                return 400, {"error": f"bad command {command!r}"}
            self._mon({"prefix": f"osd {command}",
                       "ids": [parts[1]]})
            return 200, {"ok": True}
        if method == "POST" and head == "pool":
            name = body.get("name", "")
            if not name:
                return 400, {"error": "name required"}
            cmd = {"prefix": "osd pool create", "pool": name,
                   "pg_num": int(body.get("pg_num", 8))}
            if body.get("type"):
                cmd["pool_type"] = body["type"]
            if body.get("erasure_code_profile"):
                cmd["erasure_code_profile"] = \
                    body["erasure_code_profile"]
            self._mon(cmd)
            return 200, {"ok": True, "pool": name}
        if method == "DELETE" and head == "pool" and len(parts) == 2:
            self._mon({"prefix": "osd pool delete",
                       "pool": parts[1],
                       "pool2": parts[1],
                       "yes_i_really_really_mean_it": True})
            return 200, {"ok": True}
        return 404, {"error": f"no route {method} {path}"}

    # -- dashboard (read-only status view; ref: the mgr dashboard
    # module's landing page, src/pybind/mgr/dashboard — collapsed to
    # one JSON document with an HTML rendering over the same data) --
    def _dashboard(self, path: str):
        from urllib.parse import parse_qs, urlparse
        q = {k: v[0] for k, v in
             parse_qs(urlparse(path).query).items()}
        data = self.dashboard_data()
        if q.get("format") == "html":
            return 200, _Html(self._dashboard_html(data))
        return 200, data

    def dashboard_data(self) -> dict:
        """One read-only cluster summary: health, usage, pg states,
        multisite sync lag, recent crashes, slow ops."""
        status = self._mon({"prefix": "status"})
        health = self._mon({"prefix": "health detail"})
        df = self._mon({"prefix": "df"})
        try:
            crashes = self._mon({"prefix": "crash ls-new"}) or []
        except RuntimeError:
            crashes = []
        from ..rgw.multisite import sync_status_all
        slow = health.get("checks", {}).get("SLOW_OPS", {})
        return {
            "health": {"status": health.get("status"),
                       "checks": health.get("checks", {})},
            "osdmap": status.get("osdmap", {}),
            "pg_states": status.get("pgmap", {})
            .get("pgs_by_state", {}),
            "usage": {"total_kb": df.get("total_kb", 0),
                      "used_kb": df.get("used_kb", 0),
                      "avail_kb": df.get("avail_kb", 0),
                      "pools": df.get("pools", {})},
            "sync": sync_status_all(),
            "recent_crashes": [
                {"crash_id": c.get("crash_id"),
                 "entity": c.get("entity"),
                 "timestamp": c.get("timestamp")}
                for c in crashes],
            "slow_ops": {"summary": slow.get("summary", ""),
                         "detail": slow.get("detail", [])},
        }

    @staticmethod
    def _dashboard_html(data: dict) -> str:
        """Server-rendered read-only view — no scripts, one page."""
        from html import escape

        def rows(pairs):
            return "".join(
                f"<tr><th>{escape(str(k))}</th>"
                f"<td>{escape(str(v))}</td></tr>" for k, v in pairs)

        checks = data["health"]["checks"]
        h = ["<!DOCTYPE html><html><head><title>ceph-tpu dashboard"
             "</title><style>body{font-family:monospace}"
             "table{border-collapse:collapse;margin:8px 0}"
             "th,td{border:1px solid #999;padding:2px 8px;"
             "text-align:left}</style></head><body>",
             f"<h1>cluster: {escape(str(data['health']['status']))}"
             "</h1>"]
        if checks:
            h.append("<h2>health checks</h2><table>" + rows(
                (k, v.get("summary", "") if isinstance(v, dict)
                 else v) for k, v in sorted(checks.items()))
                + "</table>")
        h.append("<h2>osds</h2><table>"
                 + rows(sorted(data["osdmap"].items())) + "</table>")
        h.append("<h2>pg states</h2><table>"
                 + rows(sorted(data["pg_states"].items()))
                 + "</table>")
        u = data["usage"]
        h.append("<h2>usage</h2><table>" + rows(
            [("total_kb", u["total_kb"]), ("used_kb", u["used_kb"]),
             ("avail_kb", u["avail_kb"])] +
            [(f"pool {p}", f"{st.get('objects', 0)} objects, "
              f"{st.get('bytes', 0)} bytes")
             for p, st in sorted(u["pools"].items())]) + "</table>")
        if data["sync"]:
            h.append("<h2>multisite sync</h2><table>" + rows(
                (f"{r['zone']} <- {r['source']}",
                 f"lag {r['lag_entries']} entries, "
                 f"{r['behind_shards']} shards behind")
                for r in data["sync"]) + "</table>")
        if data["recent_crashes"]:
            h.append("<h2>recent crashes</h2><table>" + rows(
                (c.get("crash_id", "?"), c.get("entity", "?"))
                for c in data["recent_crashes"]) + "</table>")
        if data["slow_ops"]["summary"]:
            h.append("<h2>slow ops</h2><p>"
                     + escape(data["slow_ops"]["summary"]) + "</p>"
                     "<ul>" + "".join(
                         f"<li>{escape(str(d))}</li>"
                         for d in data["slow_ops"]["detail"])
                     + "</ul>")
        h.append("</body></html>")
        return "".join(h)
