"""The port's bucket notifications held to the reference's at tolerance
0: every case of tests/test_rgw_notify.py, run as tests/test_torch_rgw.py
runs the gateway cases (its `Side`, `run_both` and masks; the docstring
there lists what is seeded and what is masked).

Each case makes, on each side, a gateway on pool `rgwnote` and an HTTP
receiver, as the reference test's function-scoped fixtures do.  Besides
the replies, the events each receiver got (the whole S3 event JSON:
names, keys, sizes, ETags, version ids, the eventTime and the
sequencer) must be equal, and, once the topic's queue has drained, so
must the pool.  The receiver's port is masked where the topic's
endpoint holds it.  The count of failed pushes while the endpoint is
down depends on the pusher's timing and is not compared.
"""
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from test_torch_rgw import req, run_both
from test_torch_rgw import sides  # noqa: F401  (the fixture)

VERS_ON = (b"<VersioningConfiguration>"
           b"<Status>Enabled</Status></VersioningConfiguration>")
NOTIF = (b'<NotificationConfiguration><TopicConfiguration>'
         b'<Id>n1</Id><Topic>arn:aws:sns:::t1</Topic>'
         b'<Event>s3:ObjectCreated:*</Event>'
         b'<Event>s3:ObjectRemoved:*</Event>'
         b'</TopicConfiguration></NotificationConfiguration>')


class Receiver:
    """An endpoint that records events; `fail` makes it answer 503."""

    def __init__(self):
        self.events = []
        self.fail = False
        rec = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                if rec.fail:
                    self.send_response(503)
                    self.end_headers()
                    return
                rec.events.append(json.loads(body))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def keys(self):
        return [e["Records"][0]["s3"]["object"]["key"] for e in self.events]

    def names(self):
        return [e["Records"][0]["eventName"] for e in self.events]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _wait(cond, timeout=10.0):
    end = time.time() + timeout
    while time.time() < end:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def case(body):
    """Run `body(s, gw, rcv, out)` with a fresh gateway and receiver;
    returns the replies, the events, and waits for the queue to drain
    before the gateway stops."""
    def run(s):
        gw = s.gateway("rgwnote")
        rcv = Receiver()
        s.masks[str(rcv.port)] = "<rport>"
        out = []
        try:
            body(s, gw, rcv, out)
            assert _wait(lambda: not gw.io.exec(
                ".rgw.queue.t1", "queue", "list", {})["entries"])
            return out, rcv.events
        finally:
            gw.shutdown()
            s.gws.remove(gw)
            rcv.close()
    return run


def _setup(s, gw, rcv, bucket, out):
    out += [req(s, gw, "POST", f"/?Action=CreateTopic&Name=t1&push-endpoint="
                f"http%3A%2F%2F127.0.0.1%3A{rcv.port}%2F"),
            req(s, gw, "PUT", f"/{bucket}"),
            req(s, gw, "PUT", f"/{bucket}?notification", NOTIF)]


def b_topic_admin_and_config_roundtrip(s, gw, rcv, out):
    _setup(s, gw, rcv, "nb0", out)
    out.append(req(s, gw, "GET", "/?Action=ListTopics"))
    assert b"arn:aws:sns:::t1" in out[-1][2]
    out.append(req(s, gw, "GET", "/nb0?notification"))
    assert b"s3:ObjectCreated:*" in out[-1][2] and b"t1" in out[-1][2]
    out.append(req(s, gw, "PUT", "/nb0?notification",
                   NOTIF.replace(b":::t1", b":::nope")))
    assert out[-1][0] == 400


def test_topic_admin_and_config_roundtrip(sides):
    run_both(sides, case(b_topic_admin_and_config_roundtrip), ["rgwnote"])


def b_events_delivered_in_order(s, gw, rcv, out):
    _setup(s, gw, rcv, "nb1", out)
    out += [req(s, gw, "PUT", f"/nb1/k{i}", b"data%d" % i) for i in range(6)]
    out.append(req(s, gw, "DELETE", "/nb1/k0"))
    assert _wait(lambda: len(rcv.events) >= 7)
    assert rcv.keys() == [f"k{i}" for i in range(6)] + ["k0"]
    assert rcv.names()[:6] == ["s3:ObjectCreated:Put"] * 6
    assert rcv.names()[6] == "s3:ObjectRemoved:Delete"
    rec = rcv.events[0]["Records"][0]
    assert rec["s3"]["bucket"]["name"] == "nb1"
    assert rec["s3"]["object"]["size"] == 5


def test_events_delivered_in_order(sides):
    run_both(sides, case(b_events_delivered_in_order), ["rgwnote"])


def b_prefix_filter_and_event_match(s, gw, rcv, out):
    out.append(req(s, gw, "POST", f"/?Action=CreateTopic&Name=t1&"
                   f"push-endpoint=http%3A%2F%2F127.0.0.1%3A{rcv.port}%2F"))
    out.append(req(s, gw, "PUT", "/nb2"))
    cfg = (b'<NotificationConfiguration><TopicConfiguration>'
           b'<Id>p</Id><Topic>arn:aws:sns:::t1</Topic>'
           b'<Event>s3:ObjectCreated:Put</Event>'
           b'<Filter><S3Key><FilterRule><Name>prefix</Name>'
           b'<Value>logs/</Value></FilterRule></S3Key></Filter>'
           b'</TopicConfiguration></NotificationConfiguration>')
    out += [req(s, gw, "PUT", "/nb2?notification", cfg),
            req(s, gw, "PUT", "/nb2/logs/a", b"x"),
            req(s, gw, "PUT", "/nb2/other/b", b"x"),
            req(s, gw, "DELETE", "/nb2/logs/a"),
            req(s, gw, "GET", "/nb2?notification")]
    assert _wait(lambda: len(rcv.events) >= 1)
    time.sleep(0.3)
    assert rcv.keys() == ["logs/a"]


def test_prefix_filter_and_event_match(sides):
    run_both(sides, case(b_prefix_filter_and_event_match), ["rgwnote"])


def b_endpoint_outage_redelivers_in_order(s, gw, rcv, out):
    _setup(s, gw, rcv, "nb3", out)
    rcv.fail = True
    out += [req(s, gw, "PUT", f"/nb3/q{i}", b"y") for i in range(4)]
    time.sleep(0.3)
    assert rcv.events == []
    rcv.fail = False
    assert _wait(lambda: len(rcv.events) >= 4)
    assert rcv.keys() == [f"q{i}" for i in range(4)]


def test_endpoint_outage_redelivers_in_order(sides):
    run_both(sides, case(b_endpoint_outage_redelivers_in_order), ["rgwnote"])


def b_versioned_events_carry_version_id(s, gw, rcv, out):
    _setup(s, gw, rcv, "nb4", out)
    out += [req(s, gw, "PUT", "/nb4?versioning", VERS_ON),
            req(s, gw, "PUT", "/nb4/v", b"z")]
    vid = out[-1][1]["x-amz-version-id"]
    assert _wait(lambda: len(rcv.events) >= 1)
    assert rcv.events[0]["Records"][0]["s3"]["object"]["versionId"] == vid


def test_versioned_events_carry_version_id(sides):
    run_both(sides, case(b_versioned_events_carry_version_id), ["rgwnote"])


def b_zone_trace_suppresses_notifications(s, gw, rcv, out):
    n = s.p.notify
    assert n.parse_zone_trace("z1,z2") == ["z1", "z2"]
    assert n.parse_zone_trace("") == []
    assert n.format_zone_trace(["a", "b"]) == "a,b"
    assert n.suppress_for_trace(["z1"]) and not n.suppress_for_trace([])
    _setup(s, gw, rcv, "nbz", out)
    trace = {n.ZONE_TRACE_HEADER: "other-zone"}
    out += [req(s, gw, "PUT", "/nbz/replicated", b"from-peer", trace),
            req(s, gw, "DELETE", "/nbz/replicated", headers=trace),
            req(s, gw, "PUT", "/nbz/origin", b"local")]
    assert _wait(lambda: len(rcv.events) >= 1)
    time.sleep(0.3)
    assert rcv.keys() == ["origin"]


def test_zone_trace_suppresses_notifications(sides):
    run_both(sides, case(b_zone_trace_suppresses_notifications), ["rgwnote"])


def test_notification_helpers_equal_the_reference(sides):
    """`make_event` with a sequencer hint, the XML both ways and the
    event matching, called directly on equal inputs."""
    import ceph_tpu.rgw.notify as ref_n
    import ceph_tpu_torch.rgw.notify as port_n
    cfgs = [{"id": "a", "topic": "t", "events": ["s3:ObjectCreated:*"],
             "prefix": "p/", "suffix": ".x"},
            {"id": "b", "topic": "u", "events": ["s3:ObjectRemoved:Delete"],
             "prefix": "", "suffix": ""}]
    for mod in (ref_n, port_n):
        assert mod.parse_notification_xml(mod.notification_xml(cfgs)) == cfgs
    assert port_n.notification_xml(cfgs) == ref_n.notification_xml(cfgs)
    for bad in (b"<x", b"<N><TopicConfiguration/></N>",
                b"<N><TopicConfiguration><Topic>t</Topic><FilterRule>"
                b"<Name>nope</Name></FilterRule></TopicConfiguration></N>"):
        errs = []
        for mod in (ref_n, port_n):
            try:
                mod.parse_notification_xml(bad)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1] and errs[0] is not None
    for ev, key in (("s3:ObjectCreated:Put", "p/a.x"),
                    ("s3:ObjectCreated:Copy", "p/a.y"),
                    ("s3:ObjectRemoved:Delete", "q")):
        for cfg in cfgs:
            assert port_n.event_matches(cfg, ev, key) == \
                ref_n.event_matches(cfg, ev, key)
    assert json.loads(port_n.make_event("b", "k", "e", 3, "t", "v", 7))[
        "Records"][0]["s3"] == json.loads(ref_n.make_event(
            "b", "k", "e", 3, "t", "v", 7))["Records"][0]["s3"]
