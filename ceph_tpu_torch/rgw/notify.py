"""Bucket notifications: topics, event publication, push delivery.

The reference's pubsub stack (ref: src/rgw/rgw_pubsub.cc topics +
notification configs; src/rgw/rgw_pubsub_push.cc HTTP push;
src/rgw/rgw_notify.cc persistent queues over cls_2pc_queue) in the
same shape:

* **Topics** are cluster-wide objects (omap of `.rgw.topics`): name +
  push endpoint (`http://...`).  Created via the SNS-ish admin API
  the reference exposes (`POST /?Action=CreateTopic`).
* **Notification configs** hang off the bucket
  (S3 PutBucketNotificationConfiguration: TopicConfiguration with
  Event list + prefix Filter), stored in the bucket meta.
* **Events are persistent**: publication appends the S3 event record
  to the topic's RADOS-backed queue via cls queue.enqueue — the
  sequence is allocated inside the OSD, so concurrent gateways
  publishing to one topic preserve a single total order and survive
  gateway crashes (the reference's motivation for persistent
  notifications).
* **A pusher thread** drains each queue in sequence order, POSTs the
  event JSON to the endpoint, and acks (queue.remove) only after a
  2xx — at-least-once delivery, in order, with redelivery on endpoint
  failure.

The port's copy of `ceph_tpu.rgw.notify`; swallowed RadosErrors are
counted in `rgw.SWALLOWED`.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

from ..client import RadosError
from ..cls.rgw import now_str
from ..common.log import dout
from . import swallow

TOPICS_OBJ = ".rgw.topics"


def _queue_obj(topic: str) -> str:
    return f".rgw.queue.{topic}"


#: writes replicated between zones carry the zones they already
#: applied at (comma-separated) in this header / datalog field —
#: both the loop guard and the notification guard key off it
#: (ref: rgw's RGW_SYS_PARAM_PREFIX zone trace; rgw_notify.cc skips
#: publishing for system/replication requests)
ZONE_TRACE_HEADER = "x-rgw-zone-trace"


def parse_zone_trace(value: str) -> list[str]:
    """Header value -> zone list ('' -> [])."""
    return [z for z in (value or "").split(",") if z.strip()]


def format_zone_trace(trace) -> str:
    return ",".join(trace or ())


def suppress_for_trace(trace) -> bool:
    """True when the mutation was applied by sync / forwarded from
    another zone: the ORIGIN zone already fired the bucket
    notification — re-firing on every replica would hand consumers
    one event per zone per write."""
    return bool(trace)


def event_matches(cfg: dict, event: str, key: str) -> bool:
    """S3 event-name matching incl. trailing-* wildcard + prefix and
    suffix filters (ref: rgw_pubsub.cc match(); S3 supports
    s3:ObjectCreated:* style patterns)."""
    if cfg.get("prefix") and not key.startswith(cfg["prefix"]):
        return False
    if cfg.get("suffix") and not key.endswith(cfg["suffix"]):
        return False
    for pat in cfg.get("events", ()):
        if pat == event:
            return True
        if pat.endswith(":*") and event.startswith(pat[:-1]):
            return True
    return False


class TopicStore:
    """Cluster-wide topic registry on RADOS."""

    def __init__(self, io):
        self.io = io

    def _ensure(self) -> None:
        try:
            self.io.create(TOPICS_OBJ)
        except RadosError as e:
            swallow("topics_create", e)

    def create(self, name: str, endpoint: str = "") -> None:
        self._ensure()
        self.io.set_omap(TOPICS_OBJ, {name: json.dumps(
            {"endpoint": endpoint}).encode()})
        try:
            self.io.create(_queue_obj(name))
        except RadosError as e:
            swallow("queue_create", e)

    def get(self, name: str) -> dict | None:
        try:
            vals = self.io.get_omap_vals_by_keys(TOPICS_OBJ, [name])
        except RadosError:
            return None
        return json.loads(vals[name]) if name in vals else None

    def list(self) -> dict[str, dict]:
        try:
            vals, _ = self.io.get_omap_vals(TOPICS_OBJ)
        except RadosError:
            return {}
        return {k: json.loads(v) for k, v in vals.items()}

    def delete(self, name: str) -> None:
        try:
            self.io.remove_omap_keys(TOPICS_OBJ, [name])
            self.io.remove(_queue_obj(name))
        except RadosError as e:
            swallow("topic_delete", e)


class EventPusher:
    """Drains topic queues and POSTs events to their endpoints
    (ref: rgw_notify.cc Manager::process_queue).  Every gateway runs a
    pusher, but only ONE drains a given queue at a time: a cls lock on
    the queue object elects the owner per pass, exactly the
    reference's scheme (rgw_notify takes a cls_lock lease per queue so
    multiple RGWs don't double-deliver).  A pusher that dies holding
    the lock is evicted once its lock timestamp goes stale.  Delivery
    is at-least-once (an ack lost after a successful POST redelivers),
    order preserved per topic."""

    #: a lock older than this is a dead pusher's — break it
    LOCK_STALE_S = 30.0

    def __init__(self, io, topics: TopicStore, interval: float = 0.05):
        self.io = io
        self.topics = topics
        self.interval = interval
        self.client_id = f"pusher.{uuid.uuid4().hex[:12]}"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: delivery failures since start (prometheus fodder)
        self.push_errors = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="rgw-pusher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)

    #: idle backoff cap — an idle cluster must not pay 20 Hz of lock
    #: and list execs per topic per gateway (the reference's Manager
    #: sleeps on idle queues too)
    MAX_IDLE_INTERVAL = 1.0

    def _run(self) -> None:
        wait = self.interval
        while not self._stop.is_set():
            sent = 0
            try:
                sent = self.tick()
            except Exception as ex:  # noqa: BLE001 — the pusher is a
                # daemon-lifetime loop; one bad topic/endpoint must
                # not silently end delivery for every other topic —
                # but a drain pass dying MUST leave a trace (cephck
                # silent-thread: an unlogged swallow here hid real
                # delivery stalls behind "idle backoff")
                dout("rgw", 1).write("notify pusher tick failed: "
                                     "%s: %s", type(ex).__name__, ex)
            wait = self.interval if sent else \
                min(wait * 2, self.MAX_IDLE_INTERVAL)
            self._stop.wait(wait)

    def tick(self) -> int:
        """One drain pass over every topic with an endpoint; returns
        events delivered."""
        sent = 0
        for name, t in self.topics.list().items():
            if t.get("endpoint"):
                sent += self._drain(name, t["endpoint"])
        return sent

    def _renew(self, qobj: str) -> None:
        """Refresh the lock timestamp mid-drain (re-lock by the same
        client/cookie renews) so a slow endpoint doesn't get a LIVE
        holder evicted as stale — the reference renews its cls_lock
        lease per delivered batch (rgw_notify.cc)."""
        try:
            self.io.exec(qobj, "lock", "lock", {
                "name": "pusher", "type": "exclusive",
                "client": self.client_id, "cookie": "q",
                "desc": json.dumps({"ts": time.time()})})
        except RadosError as e:
            swallow("pusher_renew", e)

    def _acquire(self, qobj: str) -> bool:
        """Exclusive pusher lock on the queue object; breaks a stale
        holder (dead gateway) before one retry."""
        ind = {"name": "pusher", "type": "exclusive",
               "client": self.client_id, "cookie": "q",
               "desc": json.dumps({"ts": time.time()})}
        for attempt in (0, 1):
            try:
                self.io.exec(qobj, "lock", "lock", ind)
                return True
            except RadosError as e:
                if e.errno_name != "EBUSY" or attempt:
                    return False
                try:
                    info = self.io.exec(qobj, "lock", "get_info",
                                        {"name": "pusher"}) or {}
                    lk = (info.get("lockers") or [{}])[0]
                    ts = json.loads(lk.get("desc") or "{}").get("ts", 0)
                    if time.time() - ts < self.LOCK_STALE_S:
                        return False
                    self.io.exec(qobj, "lock", "break_lock",
                                 {"name": "pusher",
                                  "locker": lk.get("client", ""),
                                  "cookie": lk.get("cookie", "")})
                except RadosError:
                    return False
        return False

    def _release(self, qobj: str) -> None:
        try:
            self.io.exec(qobj, "lock", "unlock",
                         {"name": "pusher", "client": self.client_id,
                          "cookie": "q"})
        except RadosError as e:
            swallow("pusher_release", e)

    def _drain(self, topic: str, endpoint: str) -> int:
        qobj = _queue_obj(topic)
        if not self._acquire(qobj):
            return 0            # another gateway owns this queue now
        try:
            try:
                out = self.io.exec(qobj, "queue", "list",
                                   {"start": 0, "max": 64}) or {}
            except RadosError:
                return 0
            sent = 0
            acked_upto = None
            last_renew = time.time()
            try:
                for ent in out.get("entries", ()):
                    if time.time() - last_renew > \
                            self.LOCK_STALE_S / 3:
                        self._renew(qobj)
                        last_renew = time.time()
                    if not self._push(endpoint, ent["data"]):
                        break   # keep order: stop at first failure
                    acked_upto = ent["seq"] + 1
                    sent += 1
            finally:
                # one batched ack per pass — per-event removes made a
                # deep-backlog drain O(backlog^2).  A crash between
                # POST and this ack redelivers the batch:
                # at-least-once, same as the reference.
                if acked_upto is not None:
                    self.io.exec(qobj, "queue", "remove",
                                 {"upto": acked_upto})
            return sent
        finally:
            self._release(qobj)

    def _push(self, endpoint: str, data: bytes) -> bool:
        try:
            req = urllib.request.Request(
                endpoint, data=data,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                return 200 <= resp.status < 300
        except Exception:           # noqa: BLE001 — a malformed
            # endpoint raises ValueError/InvalidURL, not OSError; any
            # delivery failure must count as retryable, never kill
            # the pusher thread
            self.push_errors += 1
            return False


def make_event(bucket: str, key: str, event: str, size: int,
               etag: str, vid: str | None = None,
               seq_hint: int | None = None) -> bytes:
    """S3 event record JSON (ref: rgw_pubsub.cc rgw_pubsub_s3_event
    dump — the shape Lambda/SQS consumers parse).  The sequencer is a
    monotonic nanosecond stamp: consumers compare it to order racing
    events on one key (S3 only promises sequencer comparability
    per-key; clock skew across gateways bounds it the same way the
    reference's per-zone stamps do)."""
    if seq_hint is None:
        seq_hint = time.time_ns()
    rec = {
        "eventVersion": "2.2",
        "eventSource": "ceph:s3",
        "eventTime": now_str(),
        "eventName": event,
        "s3": {
            "bucket": {"name": bucket,
                       "arn": f"arn:aws:s3:::{bucket}"},
            "object": {"key": key, "size": size, "eTag": etag,
                       "sequencer": f"{seq_hint:016x}",
                       **({"versionId": vid} if vid else {})},
        },
    }
    return json.dumps({"Records": [rec]}).encode()


# -- S3 NotificationConfiguration XML ---------------------------------
def parse_notification_xml(body: bytes) -> list[dict]:
    """PutBucketNotificationConfiguration body -> configs
    (ref: rgw_rest_pubsub.cc RGWPSCreateNotifOp)."""
    try:
        root = ET.fromstring(body) if body else None
    except ET.ParseError:
        raise ValueError("MalformedXML")
    cfgs = []
    if root is None:
        return cfgs
    for tc in root.iter():
        if not tc.tag.endswith("TopicConfiguration"):
            continue
        cfg = {"id": "", "topic": "", "events": [],
               "prefix": "", "suffix": ""}
        for el in tc.iter():
            tag = el.tag.rsplit("}", 1)[-1]
            if tag == "Id":
                cfg["id"] = el.text or ""
            elif tag == "Topic":
                # arn:aws:sns:::<topic> or a bare topic name
                cfg["topic"] = (el.text or "").rsplit(":", 1)[-1]
            elif tag == "Event":
                cfg["events"].append(el.text or "")
            elif tag == "FilterRule":
                name = value = ""
                for sub in el.iter():
                    st = sub.tag.rsplit("}", 1)[-1]
                    if st == "Name":
                        name = (sub.text or "").lower()
                    elif st == "Value":
                        value = sub.text or ""
                if name not in ("prefix", "suffix"):
                    raise ValueError(f"bad FilterRule Name {name!r}")
                cfg[name] = value
        if not cfg["topic"]:
            raise ValueError("missing Topic")
        cfgs.append(cfg)
    return cfgs


def notification_xml(cfgs: list[dict]) -> bytes:
    ents = []
    for c in cfgs:
        evs = "".join(f"<Event>{escape(e)}</Event>"
                      for e in c.get("events", ()))
        rules = "".join(
            f"<FilterRule><Name>{n}</Name>"
            f"<Value>{escape(c[n])}</Value></FilterRule>"
            for n in ("prefix", "suffix") if c.get(n))
        filt = (f"<Filter><S3Key>{rules}</S3Key></Filter>"
                if rules else "")
        ents.append(
            f"<TopicConfiguration><Id>{escape(c.get('id', ''))}</Id>"
            f"<Topic>arn:aws:sns:::{escape(c['topic'])}</Topic>"
            f"{evs}{filt}</TopicConfiguration>")
    return ('<?xml version="1.0"?><NotificationConfiguration>'
            f"{''.join(ents)}</NotificationConfiguration>").encode()
