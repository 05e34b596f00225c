"""The port's restful API (`ceph_tpu_torch.mgr.restful`) held to the
reference's (`ceph_tpu.mgr.restful`) at tolerance 0.

Every case of tests/test_mgr_restful.py runs the reference test's
requests once on each package: a `RestfulServer` on a threaded
`MiniCluster(n_osd=4)`'s mgr (the port's on `device="cpu"`), and the
reference's own assertions hold on both.  Every reply's status and JSON
(or HTML) body must then be equal.  `secrets` in each package's
`restful` draws from one seeded stream per side, so the API keys are
equal too.  Masked: `df`'s byte and kB counts and, of `status`, all but its
health and osdmap sections, which follow when each OSD's last stat
report left; a case that reads `df` through the dashboard ticks the
cluster first, as the reference's does.
"""
import json
import urllib.error
import urllib.request

import pytest

import ceph_tpu.mgr.restful as ref_restful
import ceph_tpu_torch.mgr.restful as port_restful
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.testing import MiniCluster as PortCluster
from test_torch_rgw import SeededSecrets

KINDS = ("ref", "port")
PKG = {"ref": (ref_restful, lambda: RefCluster(n_osd=4, threaded=True)),
       "port": (port_restful,
                lambda: PortCluster(n_osd=4, threaded=True, device="cpu"))}


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    out = {}
    for kind in KINDS:
        mod, make = PKG[kind]
        mp.setattr(mod, "secrets", SeededSecrets(19))
        c = make()
        c.wait_all_up()
        mgr = c.start_mgr()
        srv = mod.RestfulServer(mgr)
        srv.start()
        out[kind] = (c, mgr, srv)
    yield out
    for c, _mgr, srv in out.values():
        srv.shutdown()
        c.shutdown()
    mp.undo()


def req(srv, method, path, payload=None, key=None):
    headers = {}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    data = json.dumps(payload).encode() if payload is not None else None
    r = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                               data=data, method=method, headers=headers)
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def err(fn, *a, **kw):
    """(status, body) of a request that may be refused."""
    try:
        return list(fn(*a, **kw))
    except urllib.error.HTTPError as e:
        return [e.code, json.loads(e.read())]


def both(setup, case):
    got = {kind: case(*setup[kind]) for kind in KINDS}
    assert got["port"] == got["ref"]
    return got["port"]


def _usage_free(df: dict) -> dict:
    """`df` but its byte and kB counts (stat-report timing)."""
    return {"pools": sorted(df.get("pools", {})),
            "keys": sorted(df)}


def c_status_health_df(c, _mgr, srv):
    st, idx = req(srv, "GET", "/")
    assert "/status" in idx["endpoints"]
    st_s, status = req(srv, "GET", "/status")
    assert st_s == 200 and "health" in status
    st_h, health = req(srv, "GET", "/health")
    assert st_h == 200
    st_d, df = req(srv, "GET", "/df")
    assert st_d == 200
    return [idx, st_s, status["health"], status["osdmap"], st_h, health,
            st_d, _usage_free(df)]


def test_status_health_df(setup):
    both(setup, c_status_health_df)


def c_dashboard(c, _mgr, srv):
    for _ in range(2):
        c.tick()
    st, idx = req(srv, "GET", "/")
    assert "/dashboard" in idx["endpoints"]
    st, dash = req(srv, "GET", "/dashboard")
    assert st == 200
    for k in ("health", "osdmap", "pg_states", "usage", "sync",
              "recent_crashes", "slow_ops"):
        assert k in dash, k
    assert dash["health"]["status"].startswith("HEALTH_")
    assert dash["osdmap"]["num_up_osds"] == 4
    assert dash["usage"]["total_kb"] > 0
    assert isinstance(dash["sync"], list)
    r = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/dashboard?format=html")
    with urllib.request.urlopen(r, timeout=30) as resp:
        assert resp.status == 200
        ctype = resp.headers["Content-Type"]
        body = resp.read().decode()
    assert ctype.startswith("text/html")
    assert "<!DOCTYPE html>" in body
    assert dash["health"]["status"] in body
    assert "pg states" in body
    view = {k: v for k, v in dash.items() if k != "usage"}
    view["usage"] = _usage_free(dash["usage"])
    html = body.split("<h2>usage</h2>")[0]
    return [idx, view, ctype, html]


def test_dashboard_json_and_html(setup):
    both(setup, c_dashboard)


def c_osd_listing_and_command(_c, _mgr, srv):
    out = [req(srv, "GET", "/osd")]
    assert out[0][0] == 200 and len(out[0][1]) == 4
    assert all(o["up"] == 1 for o in out[0][1])
    out.append(req(srv, "GET", "/osd/2"))
    assert out[-1][1]["osd"] == 2
    out.append(err(req, srv, "GET", "/osd/99"))
    assert out[-1][0] == 404
    out.append(req(srv, "POST", "/osd/1/command", {"command": "out"}))
    out.append(req(srv, "GET", "/osd/1"))
    assert out[-1][1]["in"] == 0
    out.append(req(srv, "POST", "/osd/1/command", {"command": "in"}))
    out.append(req(srv, "GET", "/osd/1"))
    assert out[-1][1]["in"] == 1
    out.append(err(req, srv, "POST", "/osd/1/command",
                   {"command": "explode"}))
    assert out[-1][0] == 400
    return out


def test_osd_listing_and_command(setup):
    both(setup, c_osd_listing_and_command)


def c_pool_lifecycle(_c, _mgr, srv):
    out = [req(srv, "POST", "/pool", {"name": "viarest", "pg_num": 8})]
    assert out[0][0] == 200
    out.append(req(srv, "GET", "/pool"))
    assert "viarest" in [p["pool_name"] for p in out[-1][1]]
    out.append(req(srv, "GET", "/pool/viarest"))
    assert out[-1][1]["pg_num"] == 8
    out.append(req(srv, "DELETE", "/pool/viarest"))
    assert out[-1][0] == 200
    out.append(req(srv, "GET", "/pool"))
    assert "viarest" not in [p["pool_name"] for p in out[-1][1]]
    return out


def test_pool_lifecycle(setup):
    both(setup, c_pool_lifecycle)


def c_api_key_auth(_c, _mgr, srv):
    key = srv.create_key("admin")
    out = [key]
    try:
        out.append(err(req, srv, "GET", "/status"))
        assert out[-1][0] == 401
        out.append(err(req, srv, "GET", "/status", key="wrong"))
        assert out[-1][0] == 401
        st, _ = req(srv, "GET", "/status", key=key)
        out.append(st)
        assert st == 200
    finally:
        srv.delete_key(key)
    st, _ = req(srv, "GET", "/status")
    out.append(st)
    assert st == 200
    return out


def test_api_key_auth(setup):
    both(setup, c_api_key_auth)


def c_bad_osd_id(_c, _mgr, srv):
    out = err(req, srv, "GET", "/osd/abc")
    assert out[0] == 400 and out[1]["error"] == "bad osd id"
    return out


def test_bad_osd_id_is_400_not_500(setup):
    both(setup, c_bad_osd_id)
