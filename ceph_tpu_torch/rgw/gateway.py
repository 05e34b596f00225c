"""S3-flavored HTTP gateway over RADOS.

The radosgw analogue (ref: src/rgw/rgw_main.cc REST frontend;
src/rgw/rgw_rados.cc data layout).  Faithful structure, reduced
surface:

* **Bucket index is omap** on a per-bucket index object — exactly the
  reference's layout (ref: src/cls/rgw bucket index objects; here the
  index is maintained with plain omap ops instead of the cls_rgw
  transaction dance).
* **Object data** lives in RADOS objects named `<bucket>/<key>`;
  multipart parts are separate RADOS objects assembled on complete
  (ref: rgw multipart: RGWCompleteMultipart assembles the manifest —
  here parts are concatenated since striping policy is the Striper's
  job).
* **Bucket index is SHARDED**: keys hash across N index shard objects
  (ref: rgw bucket index shards, rgw_rados bucket_index_max_shards /
  rgw_shard_id — the single-object index was the exact bottleneck the
  reference's sharding removes); listings merge the shards.
* REST: ListBuckets / Create/Delete/HeadBucket, Put/Get/Head/Delete
  Object, CopyObject (x-amz-copy-source), ListObjectsV2 (prefix +
  max-keys + continuation), multipart initiate/upload-part/complete/
  abort.  XML shapes follow S3 close enough for scripted clients.
* **Object versioning** (ref: rgw versioned buckets): per-bucket
  Enabled/Suspended state; versioned PUTs stack version records on
  the index entry with data at `<bucket>/<key>@<vid>`; DELETE inserts
  a delete marker; GET/HEAD honor `versionId`; GET `?versions` lists
  the stack; the pre-versioning object becomes the S3 "null" version.
* **Bucket lifecycle** (ref: src/rgw/rgw_lc.cc): Put/Get/Delete
  lifecycle configuration (Expiration.Days +
  NoncurrentVersionExpiration.NoncurrentDays per prefix rule);
  `lc_tick()` applies expirations — delete markers for current
  versions, outright removal for noncurrent ones.

**Auth**: with a keyring, every request must carry a valid AWS SigV4
signature whose access key is a cephx entity (ref: src/rgw/
rgw_auth_s3.cc) — either the Authorization header or the query-string
presigned-URL form (X-Amz-Signature, ref: rgw_auth_s3.h); without a
keyring the gateway is anonymous (test mode).  With `keystone_url`
set, S3 requests may instead carry an OpenStack token in
`X-Auth-Token`, validated against the keystone endpoint (ref:
rgw_auth_keystone.cc; config-gated the same way).

**Multisite** (ref: src/rgw/rgw_data_sync.cc; model in
rgw/multisite.py): a gateway constructed with `zone=` becomes a zone
member — every index mutation also appends a datalog record in the
same OSD transaction, a `SyncAgent` thread pulls peer zones' datalogs
and applies them idempotently, `/admin/*` REST ops expose the period,
bucket index dumps, datalog cursors and sync status, and replicated
writes carry an `x-rgw-zone-trace` so they neither loop nor re-fire
bucket notifications.

The port's copy of `ceph_tpu.rgw.gateway`: the same REST surface,
index entries, object names, XML and headers.  Swallowed RadosErrors
are counted in `SWALLOWED` (see the package docstring).  Three
differences:

* a request on a keep-alive connection reads its own body: the
  reference's handler keeps the first request's body (and user) for
  every later request on the connection;
* the handler sets TCP_NODELAY, so a reply's body does not wait for
  the client's delayed ACK (the same bytes, sooner);
* `main` takes `--name` and authenticates that entity when the keyring
  holds it, so the radosgw process joins a cephx cluster; the
  reference's connects without a key.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import threading

from ..common.lockdep import make_lock
from ..common.log import dout
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, quote, unquote, urlparse
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

from ..client import RadosError, WriteOp
from . import SWALLOWED, swallow  # noqa: F401  (SWALLOWED re-exported)
from .auth import (KeystoneEngine, KeystoneError, SigV4Error,
                   sign_request,
                   verify as sigv4_verify,
                   verify_presigned as presigned_verify)
from ..cls.rgw import (DL_META, DL_PREFIX, is_tomb, now_str,
                       parse_mtime)
from .datalog import DataLog, is_dl_key, shard_obj, shard_of_key
from .notify import (EventPusher, TopicStore, ZONE_TRACE_HEADER,
                     _queue_obj, event_matches, format_zone_trace,
                     make_event, notification_xml,
                     parse_notification_xml, parse_zone_trace,
                     suppress_for_trace)
from .sts import AKID_PREFIX, STSEngine, STSError

#: omap object holding the bucket registry (name -> creation meta)
BUCKETS_OBJ = ".rgw.buckets.list"
#: index shards per bucket (ref: rgw_override_bucket_index_max_shards)
DEFAULT_INDEX_SHARDS = 8


_shard_of = shard_of_key


def _index_obj(bucket: str, shard: int = 0) -> str:
    return shard_obj(bucket, shard)


def _data_obj(bucket: str, key: str) -> str:
    return f"{bucket}/{key}"


class S3Error(Exception):
    def __init__(self, status: int, code: str, msg: str = ""):
        self.status = status
        self.code = code
        self.msg = msg or code
        super().__init__(code)


class RGWGateway:
    """One gateway instance bound to an HTTP port, backed by a pool."""

    def __init__(self, rados, pool: str = "rgw",
                 host: str = "127.0.0.1", port: int = 0,
                 keyring=None, index_shards: int = DEFAULT_INDEX_SHARDS,
                 zone: str | None = None, sync_interval: float = 0.1,
                 system_key: tuple[str, str] | None = None,
                 keystone_url: str | None = None):
        self.rados = rados
        self.pool = pool
        #: cephx keyring doubling as the S3 credential store
        #: (ref: radosgw users in the cluster auth database); None =
        #: anonymous gateway
        self.keyring = keyring
        self.index_shards = index_shards
        #: per-request zone trace (the parsed x-rgw-zone-trace header,
        #: one slot per handler thread): which zones this mutation has
        #: already applied at — drives datalog trace extension, the
        #: notification guard, and forward-loop suppression
        self._reqctx = threading.local()
        #: multisite identity: the zone this gateway serves (None =
        #: standalone gateway, no datalog, no sync agent)
        self.zone = zone
        #: optional FaultPlane; peer_request consults it so partition
        #: rules cover the HTTP sync path as well as the messenger
        self.faults = None
        #: (access_key, secret) this gateway signs sync/forwarded
        #: requests to peers with (ref: the multisite system user)
        self.system_key = system_key
        #: config-gated keystone token validation (satellite of the
        #: multisite PR; ref: rgw_auth_keystone.cc)
        self.keystone = KeystoneEngine(keystone_url) \
            if keystone_url else None
        try:
            rados.pool_lookup(pool)
        except RadosError:
            rados.pool_create(pool, pg_num=32)
        self.io = rados.open_ioctx(pool)
        try:
            self.io.create(BUCKETS_OBJ)
        except RadosError as e:
            if e.errno_name != "EEXIST":
                swallow("registry_create", e)
        # op tracking + span ring (ref: rgw's req tracking behind
        # `radosgw-admin ... ops` + the rgw blkin trace roots): every
        # HTTP request is tracked; traced ones root a span the
        # objecter legs nest under (gateway -> objecter -> OSD ->
        # shards in one assembled tree)
        from ..common.options import global_config as _gc
        from ..common.tracked_op import OpTracker
        from ..common.tracing import Tracer
        self.op_tracker = OpTracker(
            history_size=_gc()["osd_op_history_size"])
        self.tracer = Tracer(f"rgw.{zone or pool}")
        self.asok = None
        self._req_ids = itertools.count(1)
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # a reply's headers and body go out as two writes: without
            # TCP_NODELAY the body waits for the client's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, *a):      # quiet
                pass

            def _run(self, method):
                from ..common.tracing import new_trace, trace_scope
                # one handler serves every request of a keep-alive
                # connection: drop the previous request's body and user
                self.__dict__.pop("_body", None)
                self.__dict__.pop("s3_user", None)
                opkey = (threading.get_ident(), next(gw._req_ids))
                gw.op_tracker.start(
                    opkey, f"http_req({method} {self.path})")
                ctx = new_trace() \
                    if _gc()["blkin_trace_all"] else None
                sp = gw.tracer.start_span(
                    ctx, f"rgw_op:{method} {self.path.split('?')[0]}")
                try:
                    with trace_scope(ctx):
                        self._run_inner(method)
                finally:
                    gw.op_tracker.finish(opkey)
                    gw.tracer.finish(sp)

            def _run_inner(self, method):
                try:
                    body = gw._read_body(self)
                    self._body = body
                    u = urlparse(self.path)
                    if u.path == "/auth/v1.0" or \
                            u.path == "/swift/v1" or \
                            u.path.startswith("/swift/v1/"):
                        # Swift speaks TempAuth tokens, not SigV4.
                        # The boundary matters: bucket "swift" with
                        # key "v1.txt" is an S3 path, not Swift.
                        return gw._run_swift(self, method, u)
                    ks_token = self.headers.get("x-auth-token")
                    authz = self.headers.get("Authorization") or ""
                    if gw.keystone is not None and \
                            gw.keyring is None and not ks_token and \
                            gw.system_key is not None and \
                            f"Credential={gw.system_key[0]}/" in authz:
                        # peer sync/forward traffic signs SigV4 as the
                        # multisite system user and has no token to
                        # offer: a keystone-only zone member must
                        # verify that signature, not fail it closed —
                        # or the zone never receives sync traffic
                        try:
                            self.s3_user = sigv4_verify(
                                method, self.path, self.headers, body,
                                lambda n, _k=gw.system_key:
                                    _k[1] if n == _k[0] else None)
                        except SigV4Error as e:
                            raise S3Error(403, e.code, str(e))
                    elif gw.keystone is not None and \
                            (ks_token or gw.keyring is None):
                        # keystone path: token present, or tokens are
                        # the ONLY configured auth — a missing token
                        # then fails closed (config-gated: gateways
                        # without keystone_url never take this branch)
                        try:
                            self.s3_user = gw.keystone.validate(
                                ks_token or "")
                        except KeystoneError as e:
                            raise S3Error(e.status, e.code, e.msg)
                    elif gw.keyring is not None:
                        def lookup(name, _h=self.headers):
                            # STS-prefixed access keys resolve their
                            # signing secret from the temp-credential
                            # table (session token required), not the
                            # cephx keyring (ref: rgw_auth_s3.cc
                            # STSAuthStrategy)
                            if name.startswith(AKID_PREFIX):
                                return gw.sts.resolve_secret(
                                    name, _h.get(
                                        "x-amz-security-token", ""))
                            return gw.keyring.get(name)
                        try:
                            presigned = "X-Amz-Signature" in parse_qs(
                                urlparse(self.path).query)
                            if presigned:
                                # query-string auth: presigned URL
                                self.s3_user = presigned_verify(
                                    method, self.path, self.headers,
                                    lookup)
                            else:
                                self.s3_user = sigv4_verify(
                                    method, self.path, self.headers,
                                    body, lookup)
                        except SigV4Error as e:
                            raise S3Error(403, e.code, str(e))
                        except STSError as e:
                            raise S3Error(e.status, e.code, e.msg)
                    raw_trace = self.headers.get(ZONE_TRACE_HEADER, "")
                    if raw_trace and (gw.keyring is not None or
                                      gw.keystone is not None) and \
                            (gw.system_key is None or
                             getattr(self, "s3_user", None) !=
                             gw.system_key[0]):
                        # only the multisite system user speaks for
                        # other zones on a secured gateway: a client
                        # spoofing the trace would suppress its own
                        # write's replication + notifications
                        raw_trace = ""
                    gw._reqctx.trace = parse_zone_trace(raw_trace)
                    try:
                        gw._route(self, method)
                    finally:
                        gw._reqctx.trace = []
                except S3Error as e:
                    body = (f'<?xml version="1.0"?><Error><Code>'
                            f"{e.code}</Code><Message>{escape(e.msg)}"
                            f"</Message></Error>").encode()
                    self.send_response(e.status)
                    self.send_header("Content-Type", "application/xml")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (RadosError, OSError) as e:
                    body = str(e).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def do_GET(self):
                self._run("GET")

            def do_PUT(self):
                self._run("PUT")

            def do_POST(self):
                self._run("POST")

            def do_DELETE(self):
                self._run("DELETE")

            def do_HEAD(self):
                self._run("HEAD")

        class Server(ThreadingHTTPServer):
            # join handler threads on close (ThreadingHTTPServer
            # defaults daemon_threads=True): the final GC sweep in
            # shutdown() must observe every in-flight request's
            # deferred deletions
            daemon_threads = False

        self.httpd = Server((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self.topics = TopicStore(self.io)
        self.pusher = EventPusher(self.io, self.topics)
        self.sts = STSEngine(self.io)
        self.datalog = DataLog(self.io)
        #: period view + sync agent, only for zone members
        self.multisite = None
        self.sync = None
        if zone is not None:
            from .multisite import MultisiteState, SyncAgent
            self.multisite = MultisiteState(self.io, zone)
            self.sync = SyncAgent(self, interval=sync_interval)
        from .swift import SwiftFrontend
        self.swift = SwiftFrontend(self)
        #: deferred GC of data objects orphaned by index commits —
        #: a reader that resolved the OLD index entry gets a grace
        #: window to finish its data read (the reference defers the
        #: same way via rgw gc; immediate deletion 500'd racing GETs)
        self._gc_queue: list[tuple[float, str]] = []
        self._gc_lock = make_lock("rgw.gc")
        self._gc_stop = threading.Event()
        #: serializes in-process registry mutations: a tombstone
        #: prune's read-then-remove racing a handler thread's bucket
        #: recreate must not remove the fresh live entry
        self._registry_lock = make_lock("rgw.registry")
        #: bucket -> (monotonic stamp, {shard: datalog head}) at the
        #: most recent index dump served to a peer: an in-flight
        #: full sync's incremental cursor starts AT that head, so
        #: age-based trim (zero-peer zones) must not cross it while
        #: the grace window is open
        self._fullsync_floors: dict[str, tuple[float, dict]] = {}
        self._fullsync_lock = make_lock("rgw.fullsync_floors")

    #: seconds an orphaned object outlives its index unlink
    GC_GRACE_S = 2.0
    #: how long a served index dump pins the datalog against
    #: age-based trim (a full sync slower than this restarts from a
    #: fresh dump anyway)
    FULLSYNC_GRACE_S = 600.0

    def note_fullsync_dump(self, bucket: str) -> None:
        """Record the per-shard datalog heads at the moment a bucket
        index dump leaves for a peer (the full-sync entry point)."""
        heads = self.datalog.heads(bucket, self._nshards(bucket))
        import time as _time
        with self._fullsync_lock:
            self._fullsync_floors[bucket] = (_time.monotonic(), heads)

    def fullsync_floor(self, bucket: str) -> dict | None:
        """{shard: head-at-dump} for an in-flight (non-expired) full
        sync of `bucket`, else None."""
        import time as _time
        with self._fullsync_lock:
            rec = self._fullsync_floors.get(bucket)
            if rec is None:
                return None
            stamp, heads = rec
            if _time.monotonic() - stamp > self.FULLSYNC_GRACE_S:
                del self._fullsync_floors[bucket]
                return None
            return dict(heads)

    def _gc_loop(self) -> None:
        while not self._gc_stop.is_set():
            self._gc_tick()
            self._gc_stop.wait(0.25)

    def _gc_tick(self, everything: bool = False) -> int:
        now = time.time()
        with self._gc_lock:
            due = [o for t, o in self._gc_queue
                   if everything or t <= now]
            self._gc_queue = [(t, o) for t, o in self._gc_queue
                              if not everything and t > now]
        for obj in due:
            try:
                self.io.remove(obj)
            except RadosError as e:
                swallow("gc_remove", e)
        return len(due)

    def _run_swift(self, h, method: str, u) -> None:
        """Swift protocol branch (ref: rgw_rest_swift.cc — one
        radosgw process serves both APIs over one bucket namespace)."""
        from .swift import SwiftError
        q = {k: v[0] for k, v in parse_qs(
            u.query, keep_blank_values=True).items()}
        try:
            if u.path == "/auth/v1.0":
                return self.swift.handle_auth(h)
            return self.swift.route(h, method, unquote(u.path), q)
        except SwiftError as e:
            body = (e.msg or "").encode()
            h.send_response(e.status)
            h.send_header("Content-Type", "text/plain")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            if h.command != "HEAD":
                h.wfile.write(body)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="rgw", daemon=True)
        self._thread.start()
        self.pusher.start()
        threading.Thread(target=self._gc_loop, name="rgw-gc",
                         daemon=True).start()
        if self.sync is not None:
            self.sync.start()

    def shutdown(self) -> None:
        if self.sync is not None:
            # agent first: its in-flight batch is abandoned before the
            # marker persists — the restart replays it (idempotent)
            self.sync.stop()
        if self.asok is not None:
            self.asok.shutdown()
            self.asok = None
        self.pusher.stop()
        self._gc_stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        # no requests can race us anymore: collect everything pending
        self._gc_tick(everything=True)

    def start_admin_socket(self, path: str) -> None:
        """`ceph daemon rgw.<zone> <cmd>` endpoint — the same
        op-tracker/trace surface every other daemon serves."""
        from ..common.admin_socket import AdminSocket
        from ..common.obs import register_obs_commands
        a = AdminSocket(path)
        register_obs_commands(a, self.op_tracker, self.tracer)
        a.register("status", "gateway status",
                   lambda c: (0, {"zone": self.zone, "pool": self.pool,
                                  "port": self.port,
                                  "hbmap_unhealthy":
                                      (self.sync.hbmap
                                       .get_unhealthy_workers()
                                       if getattr(self, "sync", None)
                                       is not None else [])}))
        a.start()
        self.asok = a

    def prune_registry_tombstones(self, peer_views: dict) -> int:
        """Drop bucket-deletion tombstones every peer has confirmed
        past (ref: the reference trims metadata logs by the minimum
        peer marker).  `peer_views` maps source zone -> (fetch stamp,
        that zone's raw registry dump) from THIS round.  A tombstone
        may go once, for every peer, the view POSTDATES the deletion
        (a snapshot taken before it proves nothing — a bucket deleted
        mid-round would be pruned off stale absence evidence) and the
        peer either (a) carries the same deletion (its sync applied
        it), (b) has no entry at all (never replicated the bucket, or
        already pruned its own tombstone), or (c) recreated the
        bucket after the deletion — a peer still holding a LIVE
        pre-deletion copy keeps the tombstone, since our next listing
        pull would resurrect the bucket without it.  Returns the
        number pruned; bounded registry growth is the point."""
        candidates: dict[str, str] = {}
        for bucket, meta in self._buckets_raw().items():
            if "deleted" not in meta:
                continue
            dt = meta["deleted"]
            ok = True
            for stamp, view in peer_views.values():
                if stamp <= dt:
                    ok = False      # evidence predates the deletion
                    break
                ent = view.get(bucket)
                if ent is None:
                    continue                       # (b)
                if "deleted" in ent and ent["deleted"] >= dt:
                    continue                       # (a)
                if ent.get("created", "") > dt:
                    continue                       # (c)
                ok = False
                break
            if ok:
                candidates[bucket] = dt
        if not candidates:
            return 0
        with self._registry_lock:
            # ONE locked re-read covering every candidate: a handler
            # thread may have recreated a bucket since the snapshot —
            # removing its key then would delete the LIVE entry
            cur = self._buckets_raw()
            drop = [b for b, dt in candidates.items()
                    if cur.get(b, {}).get("deleted") == dt]
            if drop:
                self.io.remove_omap_keys(BUCKETS_OBJ, drop)
        for b in drop:
            dout("rgw", 4).write(
                "%s: pruned tombstone for bucket %r (deleted %s, "
                "all %d peers past it)", self.zone, b, candidates[b],
                len(peer_views))
        return len(drop)

    # -- notifications (ref: src/rgw/rgw_pubsub.cc) ----------------------
    def _notify_event(self, bucket: str, key: str, event: str,
                      size: int, etag: str, vid: str | None = None,
                      bmeta: dict | None = None,
                      trace: list | None = None) -> None:
        """Publish an event to every topic whose bucket config
        matches.  The append goes through cls queue.enqueue so the
        OSD assigns the sequence — concurrent gateways publishing to
        one topic keep a single total order (ref: rgw_notify.cc
        persistent notifications over cls_2pc_queue).

        A write carrying a zone trace was replicated here (sync apply
        or a forwarded metadata op): the origin zone already notified,
        so the replica must NOT re-fire (ref: rgw_notify.cc skipping
        system requests) — the x-rgw-zone-trace-aware guard."""
        if trace is None:
            trace = self._request_trace()
        if suppress_for_trace(trace):
            return
        if bmeta is None:
            bmeta = self._buckets().get(bucket) or {}
        cfgs = bmeta.get("notifications") or []
        for cfg in cfgs:
            if not event_matches(cfg, event, key):
                continue
            t = self.topics.get(cfg["topic"])
            if not t or not t.get("endpoint"):
                # nothing will ever drain an endpointless topic's
                # queue — don't grow it without bound
                continue
            data = make_event(bucket, key, event, size, etag, vid)
            try:
                self.io.exec(_queue_obj(cfg["topic"]), "queue",
                             "enqueue", {"entries": [data]})
            except RadosError as e:
                swallow("notify_enqueue", e)
                # lost event beats failed client op

    # -- helpers ---------------------------------------------------------
    def _request_trace(self) -> list[str]:
        """Zones the current request's mutation has already applied at
        ([] outside a handler thread / on a direct client write)."""
        return list(getattr(self._reqctx, "trace", ()) or ())

    def _buckets_raw(self) -> dict[str, dict]:
        """Registry incl. deletion tombstones ({"deleted": mtime}) —
        the sync surface.  Client-facing paths use _buckets()."""
        vals, _ = self.io.get_omap_vals(BUCKETS_OBJ)
        return {k: json.loads(v) for k, v in vals.items()}

    def _buckets(self) -> dict[str, dict]:
        return {k: v for k, v in self._buckets_raw().items()
                if "deleted" not in v}

    def _require_bucket(self, bucket: str) -> dict:
        b = self._buckets().get(bucket)
        if b is None:
            raise S3Error(404, "NoSuchBucket", bucket)
        return b

    def _nshards(self, bucket: str) -> int:
        b = self._buckets().get(bucket) or {}
        return int(b.get("shards", 1))

    def _index(self, bucket: str) -> dict[str, dict]:
        """Merged view across every index shard (listings; ref: the
        reference's sharded bucket listing merge, CLSRGWIssueBucketList
        over shards)."""
        out: dict[str, dict] = {}
        for shard in range(self._nshards(bucket)):
            try:
                vals, _ = self.io.get_omap_vals(
                    _index_obj(bucket, shard))
            except RadosError:
                continue
            for k, v in vals.items():
                if is_dl_key(k):
                    continue    # datalog records share the omap but
                    # are not index entries (multisite change feed)
                ent = json.loads(v)
                if is_tomb(ent):
                    continue    # per-key delete tombstone: the key is
                    # gone as far as reads/listings are concerned
                out[k] = ent
        return out

    def _index_entry(self, bucket: str, key: str,
                     nshards: int | None = None) -> dict | None:
        if nshards is None:
            nshards = self._nshards(bucket)
        shard = _shard_of(key, nshards)
        try:
            vals = self.io.get_omap_vals_by_keys(
                _index_obj(bucket, shard), [key])
        except RadosError as e:
            if e.errno_name == "ENOENT":
                return None     # shard object never written: the key
                # cannot have an entry (same contract as _index)
            raise
        ent = json.loads(vals[key]) if key in vals else None
        return None if is_tomb(ent) else ent

    @staticmethod
    def _respond(h, status: int, body: bytes = b"",
                 ctype: str = "application/xml",
                 headers: dict | None = None) -> None:
        h.send_response(status)
        h.send_header("Content-Type", ctype)
        hdrs = dict(headers or {})
        # HEAD replies advertise the real object size with no body
        # (RFC 9110 §8.6 allows Content-Length without payload)
        h.send_header("Content-Length",
                      hdrs.pop("Content-Length", str(len(body))))
        for k, v in hdrs.items():
            h.send_header(k, v)
        h.end_headers()
        if h.command != "HEAD":
            h.wfile.write(body)

    @staticmethod
    def _read_body(h) -> bytes:
        if hasattr(h, "_body"):      # cached by the auth gate
            return h._body
        n = int(h.headers.get("Content-Length", 0))
        return h.rfile.read(n) if n else b""

    # -- routing ---------------------------------------------------------
    def _route(self, h, method: str) -> None:
        u = urlparse(h.path)
        q = {k: v[0] for k, v in parse_qs(u.query,
                                          keep_blank_values=True).items()}
        parts = unquote(u.path).lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        if bucket == "admin":
            # reserved admin/sync surface (ref: rgw's /admin REST
            # resources — the bucket namespace likewise loses the
            # name to the control plane)
            return self._admin_op(h, method, key, q)
        if not bucket:
            if q.get("Action") in ("AssumeRole", "CreateRole",
                                   "DeleteRole", "ListRoles"):
                return self._sts_op(h, method, q)
            if "Action" in q:
                return self._topic_op(h, method, q)
            if method != "GET":
                raise S3Error(405, "MethodNotAllowed")
            return self._list_buckets(h)
        if not key:
            return self._bucket_op(h, method, bucket, q)
        return self._object_op(h, method, bucket, key, q)

    # -- service level ---------------------------------------------------
    def _list_buckets(self, h) -> None:
        ents = "".join(
            f"<Bucket><Name>{escape(b)}</Name><CreationDate>"
            f"{m['created']}</CreationDate></Bucket>"
            for b, m in sorted(self._buckets().items()))
        self._respond(h, 200, (
            '<?xml version="1.0"?><ListAllMyBucketsResult>'
            f"<Buckets>{ents}</Buckets>"
            "</ListAllMyBucketsResult>").encode())

    def _update_bucket_meta(self, bucket: str, meta: dict) -> None:
        self.io.operate(BUCKETS_OBJ, WriteOp().set_omap(
            {bucket: json.dumps(meta).encode()}))

    # -- bucket level ----------------------------------------------------
    def _bucket_op(self, h, method: str, bucket: str, q: dict) -> None:
        if "versioning" in q:
            return self._versioning_op(h, method, bucket)
        if "lifecycle" in q:
            return self._lifecycle_op(h, method, bucket)
        if "notification" in q:
            return self._notification_op(h, method, bucket)
        if method == "PUT":
            fwd = self._forward_to_master(h, "PUT", f"/{quote(bucket)}")
            # adopt the master's created stamp: per-zone stamps would
            # make the generation guards (sync_reset_bucket) unable to
            # recognize the SAME incarnation across zones
            self._create_bucket(
                bucket,
                created=fwd[1].get("x-rgw-created") if fwd else None)
            return self._respond(h, 200, headers={
                "Location": f"/{bucket}",
                "x-rgw-created":
                    self._buckets_raw().get(bucket, {})
                        .get("created", "")})
        self._require_bucket(bucket)
        if method in ("GET", "HEAD"):
            if method == "HEAD":
                return self._respond(h, 200)
            if "versions" in q:
                return self._list_versions(h, bucket, q)
            return self._list_objects(h, bucket, q)
        if method == "DELETE":
            if self._index(bucket):
                raise S3Error(409, "BucketNotEmpty", bucket)
            # master first: once it drops the bucket from its
            # registry, sync stops resurrecting it here (zones beyond
            # the two involved keep theirs — deletion propagation to
            # third zones is an open follow-up)
            self._forward_to_master(h, "DELETE", f"/{quote(bucket)}")
            self._delete_bucket(bucket)
            return self._respond(h, 204)
        raise S3Error(405, "MethodNotAllowed", method)

    def _create_bucket(self, bucket: str,
                       created: str | None = None) -> bool:
        """Shared by the S3 and Swift frontends — ONE place defines
        bucket meta and index layout.  Returns False when the bucket
        already existed (idempotent re-create must NOT rebuild the
        meta: that would silently wipe versioning/lifecycle state).
        `created` adopts the metadata master's stamp on a forwarded
        create — every zone must agree on the incarnation stamp."""
        with self._registry_lock:
            if bucket in self._buckets():
                return False
            meta = json.dumps({"created": created or self._now_str(),
                               "shards": self.index_shards}).encode()
            self.io.operate(BUCKETS_OBJ,
                            WriteOp().set_omap({bucket: meta}))
        for shard in range(self.index_shards):
            self.io.create(_index_obj(bucket, shard))
        return True

    def _delete_bucket(self, bucket: str,
                       deleted_at: str | None = None,
                       tombstone: bool = True) -> None:
        """Emptiness is the caller's check (protocols differ on the
        error shape).  Zone members leave a registry tombstone (the
        origin's deletion time, so created-vs-deleted comparisons
        propagate) — removing the key outright made any peer's next
        listing resurrect the bucket.  tombstone=False drops the key
        anyway (sync_reset_bucket: the new incarnation's created
        stamp predates any deletion time we could write)."""
        nshards = self._nshards(bucket)
        if self.zone is not None and tombstone:
            self.io.operate(BUCKETS_OBJ, WriteOp().set_omap(
                {bucket: json.dumps(
                    {"deleted": deleted_at or self._now_str()}
                ).encode()}))
        else:
            self.io.remove_omap_keys(BUCKETS_OBJ, [bucket])
        for shard in range(nshards):
            try:
                self.io.remove(_index_obj(bucket, shard))
            except RadosError as e:
                swallow("index_remove", e)

    # -- versioning (ref: rgw versioned buckets; S3 PutBucketVersioning)
    def _versioning_op(self, h, method: str, bucket: str) -> None:
        meta = self._require_bucket(bucket)
        if method == "GET":
            status = meta.get("versioning", "")
            inner = f"<Status>{status}</Status>" if status else ""
            return self._respond(h, 200, (
                '<?xml version="1.0"?><VersioningConfiguration>'
                f"{inner}</VersioningConfiguration>").encode())
        if method != "PUT":
            raise S3Error(405, "MethodNotAllowed", method)
        try:
            root = ET.fromstring(self._read_body(h))
            status = next((el.text for el in root.iter()
                           if el.tag.endswith("Status")), None)
        except ET.ParseError:
            raise S3Error(400, "MalformedXML")
        if status not in ("Enabled", "Suspended"):
            raise S3Error(400, "IllegalVersioningConfigurationException",
                          str(status))
        # bucket config is master-owned metadata: relay so the change
        # radiates to every zone instead of being reverted by the next
        # sync round's master-copy adoption
        self._forward_to_master(h, "PUT",
                                f"/{quote(bucket)}?versioning",
                                self._read_body(h))
        meta["versioning"] = status
        self._update_bucket_meta(bucket, meta)
        self._respond(h, 200)

    def _versioning_of(self, bmeta: dict) -> str:
        return bmeta.get("versioning", "")

    def _list_versions(self, h, bucket: str, q: dict) -> None:
        """GET ?versions (ref: RGWListBucketVersions)."""
        prefix = q.get("prefix", "")
        idx = self._index(bucket)
        ents = []
        for key in sorted(k for k in idx if k.startswith(prefix)
                          and not k.startswith(".upload.")):
            versions = idx[key].get("versions")
            if versions is None:
                versions = [{"vid": "null",
                             "size": idx[key]["size"],
                             "etag": idx[key]["etag"],
                             "mtime": idx[key]["mtime"], "dm": False}]
            for i, v in enumerate(versions):
                latest = str(i == 0).lower()
                if v.get("dm"):
                    ents.append(
                        f"<DeleteMarker><Key>{escape(key)}</Key>"
                        f"<VersionId>{v['vid']}</VersionId>"
                        f"<IsLatest>{latest}</IsLatest>"
                        f"<LastModified>{v['mtime']}</LastModified>"
                        "</DeleteMarker>")
                else:
                    ents.append(
                        f"<Version><Key>{escape(key)}</Key>"
                        f"<VersionId>{v['vid']}</VersionId>"
                        f"<IsLatest>{latest}</IsLatest>"
                        f"<Size>{v['size']}</Size>"
                        f"<ETag>&quot;{v['etag']}&quot;</ETag>"
                        f"<LastModified>{v['mtime']}</LastModified>"
                        "</Version>")
        self._respond(h, 200, (
            '<?xml version="1.0"?><ListVersionsResult>'
            f"<Name>{escape(bucket)}</Name>"
            f"{''.join(ents)}</ListVersionsResult>").encode())

    # -- lifecycle (ref: src/rgw/rgw_lc.cc; S3 PutBucketLifecycle) ------
    def _lifecycle_op(self, h, method: str, bucket: str) -> None:
        meta = self._require_bucket(bucket)
        if method == "GET":
            rules = meta.get("lifecycle")
            if not rules:
                raise S3Error(404, "NoSuchLifecycleConfiguration")
            ents = []
            for r in rules:
                exp = (f"<Expiration><Days>{r['days']}</Days>"
                       "</Expiration>") if r.get("days") else ""
                nce = (f"<NoncurrentVersionExpiration><NoncurrentDays>"
                       f"{r['noncurrent_days']}</NoncurrentDays>"
                       "</NoncurrentVersionExpiration>") \
                    if r.get("noncurrent_days") else ""
                ents.append(
                    f"<Rule><ID>{escape(r['id'])}</ID>"
                    f"<Prefix>{escape(r['prefix'])}</Prefix>"
                    f"<Status>{r['status']}</Status>{exp}{nce}</Rule>")
            return self._respond(h, 200, (
                '<?xml version="1.0"?><LifecycleConfiguration>'
                f"{''.join(ents)}</LifecycleConfiguration>").encode())
        if method == "DELETE":
            self._forward_to_master(h, "DELETE",
                                    f"/{quote(bucket)}?lifecycle")
            meta.pop("lifecycle", None)
            self._update_bucket_meta(bucket, meta)
            return self._respond(h, 204)
        if method != "PUT":
            raise S3Error(405, "MethodNotAllowed", method)
        try:
            root = ET.fromstring(self._read_body(h))
        except ET.ParseError:
            raise S3Error(400, "MalformedXML")
        rules = []
        for rule in root.iter():
            if not rule.tag.endswith("Rule"):
                continue
            r = {"id": "", "prefix": "", "status": "Enabled",
                 "days": 0, "noncurrent_days": 0}
            for el in rule.iter():
                tag = el.tag.rsplit("}", 1)[-1]
                if tag == "ID":
                    r["id"] = el.text or ""
                elif tag == "Prefix":
                    r["prefix"] = el.text or ""
                elif tag == "Status":
                    r["status"] = el.text or "Enabled"
                elif tag in ("Days", "NoncurrentDays"):
                    try:
                        n = int(el.text or 0)
                    except ValueError:
                        raise S3Error(400, "MalformedXML",
                                      f"bad {tag}: {el.text}")
                    r["days" if tag == "Days"
                      else "noncurrent_days"] = n
            if not r["days"] and not r["noncurrent_days"]:
                raise S3Error(400, "MalformedXML",
                              "rule needs an expiration")
            rules.append(r)
        self._forward_to_master(h, "PUT",
                                f"/{quote(bucket)}?lifecycle",
                                self._read_body(h))
        meta["lifecycle"] = rules
        self._update_bucket_meta(bucket, meta)
        self._respond(h, 200)

    # -- STS Actions (ref: rgw_rest_sts.cc RGWREST_STS dispatch) --------
    def _sts_op(self, h, method: str, q: dict) -> None:
        """Action-style STS surface on the service endpoint:
        AssumeRole mints temp credentials for the authenticated
        caller; CreateRole/DeleteRole/ListRoles administer the role
        store (ref: rgw_rest_sts.cc RGWSTSAssumeRole + the role REST
        ops in rgw_rest_role.cc)."""
        action = q.get("Action", "")
        if method != "POST" and action != "ListRoles":
            raise S3Error(405, "MethodNotAllowed", method)
        # the acting principal: SigV4-authenticated user when the
        # gateway runs a keyring, anonymous otherwise
        caller = getattr(h, "s3_user", None) or "anonymous"
        try:
            if action == "AssumeRole":
                role = q.get("RoleArn", "").rsplit("/", 1)[-1] or \
                    q.get("RoleName", "")
                dur = q.get("DurationSeconds")
                creds = self.sts.assume_role(
                    caller, role,
                    duration_s=int(dur) if dur else None)
                return self._respond(h, 200, (
                    '<?xml version="1.0"?><AssumeRoleResponse>'
                    "<AssumeRoleResult><Credentials>"
                    f"<AccessKeyId>{escape(creds['access_key_id'])}"
                    "</AccessKeyId>"
                    "<SecretAccessKey>"
                    f"{escape(creds['secret_access_key'])}"
                    "</SecretAccessKey>"
                    f"<SessionToken>{escape(creds['session_token'])}"
                    "</SessionToken>"
                    f"<Expiration>{creds['expiration']:.3f}"
                    "</Expiration></Credentials><AssumedRoleUser>"
                    "<Arn>arn:aws:sts:::assumed-role/"
                    f"{escape(creds['role'])}/{escape(caller)}</Arn>"
                    "</AssumedRoleUser></AssumeRoleResult>"
                    "</AssumeRoleResponse>").encode())
            if action == "CreateRole":
                name = q.get("RoleName", "")
                trust = [p for p in q.get("Trust", "*").split(",")
                         if p]
                kw = {}
                if q.get("MaxSessionDuration"):
                    kw["max_duration"] = int(q["MaxSessionDuration"])
                self.sts.create_role(name, trust, **kw)
                return self._respond(h, 200, (
                    '<?xml version="1.0"?><CreateRoleResponse>'
                    "<CreateRoleResult><Role><RoleName>"
                    f"{escape(name)}</RoleName>"
                    f"<Arn>arn:aws:iam:::role/{escape(name)}</Arn>"
                    "</Role></CreateRoleResult>"
                    "</CreateRoleResponse>").encode())
            if action == "DeleteRole":
                name = q.get("RoleArn", "").rsplit("/", 1)[-1] or \
                    q.get("RoleName", "")
                self.sts.delete_role(name)
                return self._respond(h, 200, b"<DeleteRoleResponse/>")
            # ListRoles
            ents = "".join(
                f"<member><RoleName>{escape(n)}</RoleName>"
                f"<Arn>arn:aws:iam:::role/{escape(n)}</Arn></member>"
                for n in sorted(self.sts.list_roles()))
            return self._respond(h, 200, (
                '<?xml version="1.0"?><ListRolesResponse>'
                f"<ListRolesResult><Roles>{ents}</Roles>"
                "</ListRolesResult></ListRolesResponse>").encode())
        except STSError as e:
            raise S3Error(e.status, e.code, e.msg)
        except ValueError as e:
            raise S3Error(400, "ValidationError", str(e))

    # -- topics + notification configs (ref: rgw_rest_pubsub.cc) --------
    def _topic_op(self, h, method: str, q: dict) -> None:
        """SNS-flavored topic admin: POST /?Action=CreateTopic&Name=x
        &push-endpoint=http://... (ref: RGWPSCreateTopicOp and
        friends — the reference exposes topics through the same
        Action-style API)."""
        action = q.get("Action", "")
        if method != "POST" and action != "ListTopics":
            # mutating Actions are POST-only (GET must stay safe)
            raise S3Error(405, "MethodNotAllowed", method)
        if action == "CreateTopic":
            name = q.get("Name", "")
            if not name:
                raise S3Error(400, "InvalidArgument", "Name")
            endpoint = q.get("push-endpoint", "")
            if endpoint and not endpoint.startswith(
                    ("http://", "https://")):
                raise S3Error(400, "InvalidArgument",
                              f"push-endpoint {endpoint}")
            self.topics.create(name, endpoint)
            return self._respond(h, 200, (
                '<?xml version="1.0"?><CreateTopicResponse>'
                f"<TopicArn>arn:aws:sns:::{escape(name)}</TopicArn>"
                "</CreateTopicResponse>").encode())
        if action == "DeleteTopic":
            self.topics.delete(q.get("TopicArn", "").rsplit(":", 1)[-1])
            return self._respond(h, 200,
                                 b"<DeleteTopicResponse/>")
        if action == "ListTopics":
            ents = "".join(
                f"<member><TopicArn>arn:aws:sns:::{escape(n)}"
                f"</TopicArn></member>"
                for n in sorted(self.topics.list()))
            return self._respond(h, 200, (
                '<?xml version="1.0"?><ListTopicsResponse>'
                f"<Topics>{ents}</Topics>"
                "</ListTopicsResponse>").encode())
        raise S3Error(400, "InvalidAction", action)

    def _notification_op(self, h, method: str, bucket: str) -> None:
        """Get/Put/DeleteBucketNotificationConfiguration."""
        meta = self._require_bucket(bucket)
        if method == "GET":
            return self._respond(h, 200, notification_xml(
                meta.get("notifications") or []))
        if method == "DELETE":
            self._forward_to_master(h, "DELETE",
                                    f"/{quote(bucket)}?notification")
            meta.pop("notifications", None)
            self._update_bucket_meta(bucket, meta)
            return self._respond(h, 204)
        if method != "PUT":
            raise S3Error(405, "MethodNotAllowed", method)
        try:
            cfgs = parse_notification_xml(self._read_body(h))
        except ValueError as e:
            raise S3Error(400, "MalformedXML", str(e))
        for cfg in cfgs:
            if self.topics.get(cfg["topic"]) is None:
                raise S3Error(400, "InvalidArgument",
                              f"no such topic {cfg['topic']}")
        self._forward_to_master(h, "PUT",
                                f"/{quote(bucket)}?notification",
                                self._read_body(h))
        meta["notifications"] = cfgs
        self._update_bucket_meta(bucket, meta)
        self._respond(h, 200)

    # -- multisite (ref: rgw_data_sync.cc; model in multisite.py) -------
    def shard_of(self, bucket: str, key: str) -> int:
        return _shard_of(key, self._nshards(bucket))

    def peer_request(self, endpoint: str, method: str, path: str,
                     body: bytes | None = None,
                     headers: dict | None = None,
                     timeout: float = 10.0):
        """HTTP to a peer zone's gateway -> (status, headers, body).
        Signed with the multisite system user's key when one is
        configured (ref: the system user's SigV4 on every sync/forward
        request) so secured peers accept it through the normal auth
        gate."""
        if self.faults is not None:
            # raises ConnectionError (an OSError — callers already
            # translate that into PeerError) when a rule severs us
            self.faults.check_http(f"rgw.{self.zone}", endpoint)
        url = endpoint.rstrip("/") + path
        hdrs = dict(headers or {})
        if self.system_key is not None:
            u = urlparse(url)
            hdrs.setdefault("host", u.netloc)
            signed_path = u.path + (f"?{u.query}" if u.query else "")
            hdrs = sign_request(method, signed_path, hdrs, body or b"",
                                *self.system_key)
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=hdrs)
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()

    def _forward_to_master(self, h, method: str, path: str,
                           body: bytes = b""):
        """Metadata ops are master-owned (ref: rgw's forward_request_
        to_master): a secondary relays the op to the master zone with
        its zone in the trace — the master will not forward it back
        (trace non-empty) and will not re-fire notifications.  Returns
        the master's (status, headers, body) reply, or None when no
        forward applies (standalone gateway / already the master /
        replicated request)."""
        if self.multisite is None or self.multisite.is_master():
            return None
        if self._request_trace():
            return None         # forwarded/replicated op: terminal hop
        endpoint = self.multisite.master_endpoint()
        if not endpoint:
            return None
        try:
            return self.peer_request(
                endpoint, method, path, body or None,
                headers={ZONE_TRACE_HEADER:
                         format_zone_trace([self.zone])})
        except urllib.error.HTTPError as e:
            # the master answered and refused: relay its real verdict —
            # a 409 BucketNotEmpty on a forwarded bucket DELETE is a
            # permanent S3 error, not a retryable "master unreachable"
            code, msg = "InternalError", f"metadata master: HTTP {e.code}"
            try:
                root = ET.fromstring(e.read())
                code = root.findtext("Code") or code
                msg = root.findtext("Message") or msg
            except ET.ParseError:
                pass
            raise S3Error(e.code, code, msg)
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise S3Error(503, "ServiceUnavailable",
                          f"metadata master unreachable: {e}")

    def _admin_op(self, h, method: str, op: str, q: dict) -> None:
        """The /admin/* control surface the sync agent and the CLI
        speak: period (GET/adopt), bucket registry + index dumps,
        datalog cursor reads, sync status (ref: rgw's RESTful admin
        resources + the data-log REST ops in rgw_rest_log.cc).  On a
        secured gateway only the multisite system user may speak it —
        any tenant could otherwise forge a period adopt or dump
        another tenant's bucket index (same gate as the zone-trace
        header)."""
        if (self.keyring is not None or self.keystone is not None) \
                and (self.system_key is None or
                     getattr(h, "s3_user", None) != self.system_key[0]):
            raise S3Error(403, "AccessDenied",
                          "admin surface is system-user only")
        def respond_json(obj, status: int = 200):
            self._respond(h, status, json.dumps(obj).encode(),
                          "application/json")

        if op == "period":
            if self.multisite is None:
                raise S3Error(404, "NoSuchKey", "not a zone member")
            if method == "GET":
                return respond_json(self.multisite.admin.period_get())
            if method == "POST":
                # period push (ref: RGWPeriod push to peers /
                # `radosgw-admin period pull`): adopt if newer
                try:
                    period = json.loads(self._read_body(h))
                except ValueError:
                    raise S3Error(400, "InvalidArgument", "bad JSON")
                adopted = self.multisite.admin.period_adopt(period)
                if adopted:
                    self.multisite.refresh(force=True)
                return respond_json(
                    {"adopted": adopted,
                     "epoch": self.multisite.epoch})
            raise S3Error(405, "MethodNotAllowed", method)
        if op == "buckets" and method == "GET":
            # raw: peers need the deletion tombstones too
            return respond_json(self._buckets_raw())
        if op == "bucket" and method == "GET":
            name = q.get("name", "")
            if name not in self._buckets():
                raise S3Error(404, "NoSuchBucket", name)
            # in-flight multipart bookkeeping (.upload.*) shares the
            # index omap but is not object state — a peer's full sync
            # must see objects only.  The dump marks a full-sync
            # floor: the puller's incremental cursors start at the
            # CURRENT datalog heads, so age-trim must spare newer
            # records until the grace passes.
            self.note_fullsync_dump(name)
            return respond_json(
                {k: v for k, v in self._index(name).items()
                 if not k.startswith(".upload.")})
        if op == "log" and method == "POST":
            try:
                d = json.loads(self._read_body(h))
                markers = {int(s): int(m)
                           for s, m in d.get("markers", {}).items()}
            except (ValueError, AttributeError):
                raise S3Error(400, "InvalidArgument", "bad JSON")
            bucket = d.get("bucket", "")
            if bucket not in self._buckets():
                raise S3Error(404, "NoSuchBucket", bucket)
            batch = int(d.get("max", 64))
            shards = {}
            for s, marker in markers.items():
                entries, head = self.datalog.list(bucket, s, marker,
                                                  batch)
                shards[str(s)] = {"entries": entries, "head": head}
            return respond_json({"shards": shards})
        if op == "sync-status" and method == "GET":
            if self.sync is None:
                raise S3Error(404, "NoSuchKey", "not a zone member")
            return respond_json(self.sync.status())
        if op == "sync-markers" and method == "GET":
            # a source zone asks: how far have YOU durably applied my
            # datalog?  Feeds the source's auto-trim (datalog records
            # behind every registered peer's durable cursor may go)
            if self.sync is None:
                raise S3Error(404, "NoSuchKey", "not a zone member")
            return respond_json(
                self.sync.markers_for(q.get("source", "")))
        raise S3Error(404, "NoSuchKey", f"admin/{op}")

    def sync_ensure_bucket(self, bucket: str, meta: dict,
                           from_master: bool = False,
                           registry: dict | None = None) -> None:
        """Make the peer's bucket exist here with the peer's shard
        layout; config fields (versioning/lifecycle/notifications)
        follow the metadata master's copy — metadata ops are
        master-owned, so only the master's view overwrites ours.
        `registry` is the caller's one-read-per-round snapshot of
        _buckets_raw() (the sync agent calls this for every peer
        bucket every tick — N fresh registry fetches per round
        otherwise)."""
        cur = (registry if registry is not None
               else self._buckets_raw()).get(bucket)
        if cur is not None and "deleted" in cur:
            if meta.get("created", "") > cur["deleted"]:
                cur = None      # recreated since our tombstone
            else:
                return          # we know it was deleted; the peer's
                # live copy is the stale side
        if cur is None:
            rec = {"created": meta.get("created", self._now_str()),
                   "shards": int(meta.get("shards",
                                          self.index_shards))}
            for fld in ("versioning", "lifecycle", "notifications"):
                if fld in meta:
                    rec[fld] = meta[fld]
            self._update_bucket_meta(bucket, rec)
            for shard in range(rec["shards"]):
                try:
                    self.io.create(_index_obj(bucket, shard))
                except RadosError as e:
                    swallow("sync_index_create", e)
            return
        if not from_master:
            return
        changed = False
        for fld in ("versioning", "lifecycle", "notifications"):
            if meta.get(fld) != cur.get(fld):
                if fld in meta:
                    cur[fld] = meta[fld]
                else:
                    cur.pop(fld, None)
                changed = True
        if changed:
            self._update_bucket_meta(bucket, cur)

    def sync_drop_bucket(self, bucket: str, meta: dict,
                         registry: dict | None = None) -> bool:
        """Apply a peer's bucket-deletion tombstone: drop the local
        bucket — including any objects our copy still holds.  The
        origin could only delete an EMPTY bucket, and deleting it
        destroyed its index shards and their datalogs, so the final
        object deletes can never replicate: waiting for them would
        wedge a lagging replica forever while reporting caught up.
        The converged state IS empty — discard and gc.  Returns True
        when the local registry reflects the deletion."""
        cur = (registry if registry is not None
               else self._buckets_raw()).get(bucket)
        if cur is None or "deleted" in cur:
            return True
        if cur.get("created", "") > meta.get("deleted", ""):
            return False        # recreated since: the tombstone is
            # the stale side
        objs = self._bucket_data_objs(bucket)
        self._delete_bucket(bucket, deleted_at=meta.get("deleted"))
        if objs:
            self._remove_objs(objs, defer=True)
        return True

    def _bucket_data_objs(self, bucket: str) -> list[str]:
        """Every live data object the bucket's index references — the
        gc list when a whole local copy is discarded (tombstone drop,
        incarnation reset)."""
        objs = []
        for ent in self._index(bucket).values():
            if ent.get("versions") is not None:
                objs += [v["obj"] for v in ent["versions"]
                         if v.get("obj") and not v.get("dm")]
            elif ent.get("obj"):
                objs.append(ent["obj"])
        return objs

    def sync_reset_bucket(self, bucket: str, meta: dict,
                          registry: dict | None = None) -> None:
        """The peer's bucket is a NEW incarnation (its created stamp
        changed while we held the old copy: a delete + recreate we
        slept through).  The old incarnation's datalog died with its
        bucket, so its object deletes can never replicate — our stale
        objects would be served and listed here forever while deleted
        cluster-wide.  Same resolution as sync_drop_bucket: discard
        the old copy, the caller's full sync rebuilds from the new
        incarnation's listing.  No-op when our copy already IS the
        new incarnation (its creation propagated here normally)."""
        reg = registry if registry is not None else self._buckets_raw()
        cur = reg.get(bucket)
        if cur is None or "deleted" in cur or \
                cur.get("created", "") == meta.get("created", ""):
            return
        objs = self._bucket_data_objs(bucket)
        self._delete_bucket(bucket, tombstone=False)
        reg.pop(bucket, None)
        if objs:
            self._remove_objs(objs, defer=True)

    def sync_apply(self, bucket: str, ent: dict, data: bytes | None,
                   src: str, nshards: int | None = None) -> bool:
        """Apply one replicated datalog entry: stage the bytes (puts),
        then run the idempotent obj_sync_apply index transaction with
        the trace extended by the source + this zone — the re-logged
        entry lets further zones pull the change without looping.
        Returns whether local state changed.  `nshards` (the local
        layout) saves a per-entry registry fetch on catch-up."""
        key = ent["key"]
        trace = list(ent.get("trace") or ())
        for z in (src, self.zone):
            if z and z not in trace:
                trace.append(z)
        mode = ent.get("mode", "plain")
        obj = None
        obj_unique = False
        if ent["op"] == "put":
            # same staging discipline as _store_object: fresh object,
            # linked (or dropped) by the index transaction's verdict
            gen = uuid.uuid4().hex
            if not ent.get("vid"):
                obj, obj_unique = f"{bucket}/{key}#{gen}", True
            elif ent["vid"] == "null":
                obj, obj_unique = f"{bucket}/{key}@null.{gen}", True
            else:
                # deterministic name: a replay restages the SAME
                # object an earlier apply linked — never gc it on skip
                obj = f"{bucket}/{key}@{ent['vid']}"
            self.io.write_full(obj, data or b"")
        out = self._index_exec(bucket, key, "obj_sync_apply", {
            "op": ent["op"], "vid": ent.get("vid"),
            "size": ent.get("size", 0), "etag": ent.get("etag", ""),
            "mtime": ent.get("mtime", ""), "mode": mode, "obj": obj,
            "log": {"trace": trace}}, nshards=nshards)
        if not out.get("applied") and obj_unique:
            # never linked, no reader can hold it: collect now
            self._remove_objs([obj], defer=False)
        return bool(out.get("applied"))

    @staticmethod
    def _parse_mtime(s: str) -> float:
        # one parser for writer and OSD-side trimmer (cls/rgw.py)
        return parse_mtime(s)

    def lc_tick(self, now: float | None = None) -> int:
        """One lifecycle pass (ref: RGWLC::process — the reference
        runs it from a worker; here the gateway's maintenance tick or
        the caller drives it).  Returns expirations performed.
        Expiring the CURRENT version of a versioned object inserts a
        delete marker (S3 semantics); noncurrent expiration removes
        old versions outright."""
        now = time.time() if now is None else now
        acted = 0
        for bucket, meta in self._buckets().items():
            rules = [r for r in meta.get("lifecycle", [])
                     if r.get("status") == "Enabled"]
            if not rules:
                continue
            versioned = bool(self._versioning_of(meta))
            idx = self._index(bucket)
            for key, ent in idx.items():
                if key.startswith(".upload."):
                    continue
                acted_on_key = False
                for r in rules:
                    if acted_on_key:
                        # one action per key per tick: a second
                        # matching rule would act on a stale
                        # snapshot (stacked delete markers)
                        break
                    if not key.startswith(r["prefix"]):
                        continue
                    if r.get("days"):
                        age = now - self._parse_mtime(
                            ent.get("mtime", ""))
                        latest_dm = bool((ent.get("versions") or
                                          [{}])[0].get("dm"))
                        if age > r["days"] * 86400 and not latest_dm:
                            # expiry decided on this tick's snapshot;
                            # the cls guard cancels it if the head
                            # moved meanwhile (fresh PUT wins)
                            try:
                                if versioned or ent.get("versions"):
                                    hv = (ent.get("versions")
                                          or [{"vid": "null"}])[0]
                                    self._insert_delete_marker(
                                        bucket, key,
                                        guard={"if_head_vid":
                                               hv["vid"],
                                               "if_mtime":
                                               hv.get("mtime",
                                                      ent.get(
                                                          "mtime",
                                                          ""))})
                                else:
                                    self._index_exec(
                                        bucket, key,
                                        "obj_delete_plain",
                                        {"plain_obj":
                                         _data_obj(bucket, key),
                                         "if_mtime":
                                         ent.get("mtime", "")})
                                acted += 1
                                self._notify_event(
                                    bucket, key,
                                    "s3:LifecycleExpiration:"
                                    "DeleteMarkerCreated"
                                    if versioned or
                                    ent.get("versions") else
                                    "s3:LifecycleExpiration:Delete",
                                    0, "", bmeta=meta)
                            except RadosError as e:
                                if e.errno_name != "ECANCELED":
                                    raise
                            acted_on_key = True
                            continue
                    if r.get("noncurrent_days") and \
                            ent.get("versions"):
                        out = self._index_exec(
                            bucket, key, "obj_trim_noncurrent",
                            {"now": now,
                             "max_age_s":
                             r["noncurrent_days"] * 86400})
                        if out.get("dropped"):
                            acted += out["dropped"]
                            acted_on_key = True
        return acted

    def _list_objects(self, h, bucket: str, q: dict) -> None:
        """ListObjectsV2 (ref: RGWListBucket)."""
        prefix = q.get("prefix", "")
        max_keys = int(q.get("max-keys", 1000))
        token = q.get("continuation-token", "")
        idx = self._index(bucket)
        keys = sorted(k for k in idx
                      if k.startswith(prefix) and k > token
                      and not k.startswith(".upload.")
                      and not idx[k].get("dm"))   # delete markers hide
        page, truncated = keys[:max_keys], len(keys) > max_keys
        ents = "".join(
            f"<Contents><Key>{escape(k)}</Key>"
            f"<Size>{idx[k]['size']}</Size>"
            f"<ETag>&quot;{idx[k]['etag']}&quot;</ETag>"
            f"<LastModified>{idx[k]['mtime']}</LastModified>"
            "</Contents>" for k in page)
        nxt = (f"<NextContinuationToken>{escape(page[-1])}"
               "</NextContinuationToken>") if truncated else ""
        self._respond(h, 200, (
            '<?xml version="1.0"?><ListBucketResult>'
            f"<Name>{escape(bucket)}</Name>"
            f"<Prefix>{escape(prefix)}</Prefix>"
            f"<KeyCount>{len(page)}</KeyCount>"
            f"<IsTruncated>{str(truncated).lower()}</IsTruncated>"
            f"{nxt}{ents}</ListBucketResult>").encode())

    #: index-omap namespaces the gateway owns — a client object with
    #: one of these names would be parsed as bookkeeping (a PUT named
    #: `.dlmeta` wedges the shard's datalog head)
    RESERVED_KEY_PREFIXES = (DL_PREFIX, DL_META, ".upload.", ".part.")

    # -- object level ----------------------------------------------------
    def _object_op(self, h, method: str, bucket: str, key: str,
                   q: dict) -> None:
        if key.startswith(self.RESERVED_KEY_PREFIXES):
            if method in ("PUT", "POST", "DELETE"):
                raise S3Error(400, "InvalidArgument",
                              f"reserved key namespace: {key}")
            # reads: the bookkeeping record is not an object — serving
            # it would crash on the missing etag/size fields (500/
            # connection reset instead of a clean miss)
            raise S3Error(404, "NoSuchKey", key)
        bmeta = self._require_bucket(bucket)
        nshards = int(bmeta.get("shards", 1))
        if method == "POST" and "uploads" in q:
            return self._initiate_multipart(h, bucket, key)
        if method == "POST" and "uploadId" in q:
            return self._complete_multipart(h, bucket, key,
                                            q["uploadId"], bmeta)
        if method == "PUT" and "uploadId" in q:
            return self._upload_part(h, bucket, key, q)
        if method == "DELETE" and "uploadId" in q:
            return self._abort_multipart(h, bucket, key, q["uploadId"])
        if method == "PUT" and "x-amz-copy-source" in h.headers:
            return self._copy_object(h, bucket, key, bmeta)
        if method == "PUT":
            return self._put_object(h, bucket, key, bmeta)
        meta = self._index_entry(bucket, key, nshards)
        if meta is None:
            raise S3Error(404, "NoSuchKey", key)
        want_vid = q.get("versionId", "")
        if method in ("HEAD", "GET"):
            if method == "HEAD":
                v = self._select_version(meta, want_vid, key)
                return self._respond(
                    h, 200, b"", "application/octet-stream",
                    {"ETag": f'"{v["etag"]}"',
                     "Content-Length": str(v["size"]),
                     "x-amz-version-id": v.get("vid", "null")})
            v, data = self._read_version_data(bucket, key, meta,
                                              want_vid)
            return self._respond(h, 200, data,
                                 "application/octet-stream",
                                 {"ETag": f'"{v["etag"]}"',
                                  "x-amz-version-id":
                                      v.get("vid", "null")})
        if method == "DELETE":
            return self._delete_object(h, bucket, key, bmeta, meta,
                                       want_vid)
        raise S3Error(405, "MethodNotAllowed", method)

    def _read_version_data(self, bucket: str, key: str, meta: dict,
                           want_vid: str) -> tuple[dict, bytes]:
        """Resolve + read the served version's bytes.  If a racing
        overwrite garbage-collected our object between the index read
        and the data read (the GC grace window lost the race), the
        index is re-resolved ONCE — the fresh entry names the new
        object, so the reader gets consistent (headers, bytes) instead
        of a 500."""
        v = self._select_version(meta, want_vid, key)
        try:
            return v, self.io.read(v.get("obj")
                                   or _data_obj(bucket, key))
        except RadosError as e:
            if e.errno_name != "ENOENT":
                raise
            meta2 = self._index_entry(bucket, key)
            if meta2 is None:
                raise S3Error(404, "NoSuchKey", key)
            v2 = self._select_version(meta2, want_vid, key)
            return v2, self.io.read(v2.get("obj")
                                    or _data_obj(bucket, key))

    def _select_version(self, meta: dict, vid: str, key: str) -> dict:
        """The version a read serves: the newest live one, or the
        explicitly requested versionId (ref: rgw versioned read
        resolution)."""
        versions = meta.get("versions")
        if versions is None:
            if vid and vid != "null":
                raise S3Error(404, "NoSuchVersion", vid)
            return meta
        if vid:
            for v in versions:
                if v["vid"] == vid:
                    if v.get("dm"):
                        raise S3Error(405, "MethodNotAllowed",
                                      "delete marker")
                    return v
            raise S3Error(404, "NoSuchVersion", vid)
        if versions[0].get("dm"):
            raise S3Error(404, "NoSuchKey", key)
        return versions[0]

    def _now_str(self) -> str:
        return now_str()

    def _store_versions(self, bucket: str, key: str,
                        versions: list) -> None:
        """Administrative stack rewrite (tests back-dating mtimes,
        offline surgery).  NOT the client data path — that runs
        through the cls_rgw index transactions above."""
        shard = _shard_of(key, self._nshards(bucket))
        if not versions:
            self.io.remove_omap_keys(_index_obj(bucket, shard), [key])
            return
        head = versions[0]
        meta = {"versions": versions, "size": head.get("size", 0),
                "etag": head.get("etag", ""), "mtime": head["mtime"],
                "dm": bool(head.get("dm"))}
        self.io.set_omap(_index_obj(bucket, shard),
                         {key: json.dumps(meta).encode()})

    def _insert_delete_marker(self, bucket: str, key: str,
                              vid: str | None = None,
                              replace_null: bool = False,
                              guard: dict | None = None) -> str:
        out = self._index_exec(bucket, key, "obj_delete_marker", dict(
            guard or {}, vid=vid or uuid.uuid4().hex,
            mtime=self._now_str(), replace_null=replace_null,
            plain_obj=_data_obj(bucket, key)))
        return out["vid"]

    def _delete_object(self, h, bucket: str, key: str, bmeta: dict,
                       meta: dict, want_vid: str) -> None:
        """Versioned deletes (ref: rgw delete marker flow): no
        versionId = insert a delete marker (Enabled) or replace the
        null version with one (Suspended); an explicit versionId
        removes that version outright.  Every index RMW runs on the
        OSD (cls/rgw.py) — concurrent gateways stay consistent."""
        versioning = self._versioning_of(bmeta)
        plain_obj = _data_obj(bucket, key)
        if want_vid:
            try:
                self._index_exec(bucket, key, "obj_delete_version",
                                 {"vid": want_vid,
                                  "plain_obj": plain_obj})
            except RadosError as e:
                if e.errno_name == "ENOENT":
                    raise S3Error(404, "NoSuchVersion", want_vid)
                raise
            self._notify_event(bucket, key, "s3:ObjectRemoved:Delete",
                               0, "", want_vid, bmeta)
            return self._respond(h, 204, headers={
                "x-amz-version-id": want_vid})
        if not versioning and meta.get("versions") is None:
            try:
                self._index_exec(bucket, key, "obj_delete_plain",
                                 {"plain_obj": plain_obj})
                self._notify_event(bucket, key,
                                   "s3:ObjectRemoved:Delete", 0, "",
                                   bmeta=bmeta)
                return self._respond(h, 204)
            except RadosError as e:
                if e.errno_name != "ECANCELED":
                    raise
                # a concurrent versioned PUT grew a stack under us:
                # fall through to the delete-marker path
        vid = self._insert_delete_marker(
            bucket, key, vid="null" if versioning == "Suspended"
            else None, replace_null=versioning == "Suspended")
        self._notify_event(bucket, key,
                           "s3:ObjectRemoved:DeleteMarkerCreated",
                           0, "", vid, bmeta)
        self._respond(h, 204, headers={"x-amz-delete-marker": "true",
                                       "x-amz-version-id": vid})

    def _index_exec(self, bucket: str, key: str, method: str,
                    indata: dict, nshards: int | None = None) -> dict:
        """Run a cls_rgw index transaction on the key's index shard.
        The RMW executes inside the OSD (cls/rgw.py) so concurrent
        gateways serialize on the PG — the reference's cls_rgw
        contract (ref: src/cls/rgw/cls_rgw.cc), replacing the old
        gateway-local _vlock which could not protect two processes."""
        if nshards is None:
            nshards = self._nshards(bucket)
        if self.zone is not None and "log" not in indata:
            # zone member: every index mutation also appends its
            # datalog record — in the SAME cls transaction.  The trace
            # is the request's (forwarded/replicated writes carry one)
            # extended with this zone.
            indata = dict(indata, log={
                "trace": self._request_trace() + [self.zone]})
        iobj = _index_obj(bucket, _shard_of(key, nshards))
        out = self.io.exec(iobj, "rgw", method,
                           dict(indata, key=key)) or {}
        self._remove_objs(out.get("removed", ()))
        return out

    def _remove_objs(self, objs, defer: bool = True) -> None:
        """Delete data objects AFTER their index commit orphaned them
        (index-first ordering: a crash leaves garbage, never a
        dangling index entry — the reference's gc does the same).
        Deletion is deferred GC_GRACE_S so a reader holding the old
        index entry can still finish; defer=False is for objects no
        reader can have seen (never-linked staging writes)."""
        if defer:
            expire = time.time() + self.GC_GRACE_S
            with self._gc_lock:
                self._gc_queue.extend((expire, o) for o in objs)
            return
        for obj in objs:
            try:
                self.io.remove(obj)
            except RadosError as e:
                swallow("staging_remove", e)

    def _store_object(self, bucket: str, key: str, data: bytes,
                      etag: str, bmeta: dict | None = None) -> str | None:
        """Write object data, then commit the index transaction on the
        OSD; returns the new version id (None = unversioned bucket)."""
        bmeta = bmeta if bmeta is not None \
            else self._require_bucket(bucket)
        versioning = self._versioning_of(bmeta)
        nshards = int(bmeta.get("shards", 1))
        # every write lands in a FRESH object; the index transaction
        # links it and reports what it orphaned (the reference's
        # instance-object model) — an overwrite never clobbers bytes
        # a concurrent reader or a surprise version stack still needs
        gen = uuid.uuid4().hex
        if versioning == "Enabled":
            vid, mode = gen, "enabled"
            obj = f"{bucket}/{key}@{vid}"
        elif versioning == "Suspended":
            vid, mode = "null", "suspended"
            obj = f"{bucket}/{key}@null.{gen}"
        else:
            vid, mode = "", "plain"
            obj = f"{bucket}/{key}#{gen}"
        self.io.write_full(obj, data)
        try:
            out = self._index_exec(bucket, key, "obj_store", {
                "mode": mode, "vid": vid, "size": len(data),
                "etag": etag, "mtime": self._now_str(), "obj": obj,
                "plain_obj": _data_obj(bucket, key)}, nshards)
        except RadosError as e:
            if e.errno_name != "ECANCELED" or mode != "plain":
                raise
            # the entry grew a version stack under us (versioning
            # enabled concurrently): drop the unlinked staging object
            # and retry with fresh bucket meta
            self._remove_objs([obj], defer=False)
            return self._store_object(bucket, key, data, etag)
        return out.get("vid")

    def _put_object(self, h, bucket: str, key: str,
                    bmeta: dict | None = None) -> None:
        data = self._read_body(h)
        etag = hashlib.md5(data).hexdigest()
        vid = self._store_object(bucket, key, data, etag, bmeta)
        self._notify_event(bucket, key, "s3:ObjectCreated:Put",
                           len(data), etag, vid, bmeta)
        hdrs = {"ETag": f'"{etag}"'}
        if vid is not None:
            hdrs["x-amz-version-id"] = vid
        self._respond(h, 200, headers=hdrs)

    def _copy_object(self, h, bucket: str, key: str,
                     bmeta: dict | None = None) -> None:
        """Server-side copy (ref: RGWCopyObj; x-amz-copy-source)."""
        src = unquote(h.headers["x-amz-copy-source"]).lstrip("/")
        if "/" not in src:
            raise S3Error(400, "InvalidArgument", src)
        s_bucket, s_key = src.split("/", 1)
        if s_key.startswith(self.RESERVED_KEY_PREFIXES):
            # bookkeeping records are not copyable objects (serving
            # one would crash on its missing etag/size fields)
            raise S3Error(404, "NoSuchKey", s_key)
        self._require_bucket(s_bucket)
        s_meta = self._index_entry(s_bucket, s_key)
        if s_meta is None:
            raise S3Error(404, "NoSuchKey", s_key)
        _, data = self._read_version_data(s_bucket, s_key, s_meta, "")
        etag = hashlib.md5(data).hexdigest()
        vid = self._store_object(bucket, key, data, etag, bmeta)
        self._notify_event(bucket, key, "s3:ObjectCreated:Copy",
                           len(data), etag, vid, bmeta)
        self._respond(h, 200, (
            '<?xml version="1.0"?><CopyObjectResult>'
            f"<ETag>&quot;{etag}&quot;</ETag>"
            f"<LastModified>{s_meta['mtime']}</LastModified>"
            "</CopyObjectResult>").encode())

    # -- multipart (ref: rgw RGWInitMultipart/CompleteMultipart) ---------
    def _initiate_multipart(self, h, bucket: str, key: str) -> None:
        upload_id = uuid.uuid4().hex
        self.io.set_omap(self._upload_shard(bucket, upload_id), {
            f".upload.{upload_id}": json.dumps(
                {"key": key, "parts": {}}).encode()})
        self._respond(h, 200, (
            '<?xml version="1.0"?><InitiateMultipartUploadResult>'
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
            "</InitiateMultipartUploadResult>").encode())

    def _upload_shard(self, bucket: str, upload_id: str) -> str:
        return _index_obj(bucket, _shard_of(f".upload.{upload_id}",
                                            self._nshards(bucket)))

    def _upload_meta(self, bucket: str, upload_id: str) -> dict:
        vals = self.io.get_omap_vals_by_keys(
            self._upload_shard(bucket, upload_id),
            [f".upload.{upload_id}"])
        if not vals:
            raise S3Error(404, "NoSuchUpload", upload_id)
        return json.loads(vals[f".upload.{upload_id}"])

    def _upload_part(self, h, bucket: str, key: str, q: dict) -> None:
        upload_id = q["uploadId"]
        n = int(q.get("partNumber", 1))
        meta = self._upload_meta(bucket, upload_id)
        data = self._read_body(h)
        etag = hashlib.md5(data).hexdigest()
        part_obj = f".part.{upload_id}.{n}"
        self.io.write_full(part_obj, data)
        meta["parts"][str(n)] = {"size": len(data), "etag": etag}
        self.io.set_omap(self._upload_shard(bucket, upload_id), {
            f".upload.{upload_id}": json.dumps(meta).encode()})
        self._respond(h, 200, headers={"ETag": f'"{etag}"'})

    def _complete_multipart(self, h, bucket: str, key: str,
                            upload_id: str,
                            bmeta: dict | None = None) -> None:
        meta = self._upload_meta(bucket, upload_id)
        body = self._read_body(h)
        wanted = []
        if body:
            root = ET.fromstring(body)
            for p in root.iter():
                if p.tag.endswith("PartNumber"):
                    wanted.append(int(p.text))
        if not wanted:
            wanted = sorted(int(n) for n in meta["parts"])
        blob = bytearray()
        etags = []
        for n in wanted:
            if str(n) not in meta["parts"]:
                raise S3Error(400, "InvalidPart", str(n))
            blob += self.io.read(f".part.{upload_id}.{n}")
            etags.append(meta["parts"][str(n)]["etag"])
        etag = hashlib.md5(
            b"".join(bytes.fromhex(e) for e in etags)).hexdigest() \
            + f"-{len(wanted)}"
        vid = self._store_object(bucket, key, bytes(blob), etag,
                                 bmeta)
        self._notify_event(bucket, key,
                           "s3:ObjectCreated:CompleteMultipartUpload",
                           len(blob), etag, vid, bmeta)
        self._cleanup_upload(bucket, upload_id, meta)
        self._respond(h, 200, (
            '<?xml version="1.0"?><CompleteMultipartUploadResult>'
            f"<Key>{escape(key)}</Key><ETag>&quot;{etag}&quot;</ETag>"
            "</CompleteMultipartUploadResult>").encode())

    def _abort_multipart(self, h, bucket: str, key: str,
                         upload_id: str) -> None:
        meta = self._upload_meta(bucket, upload_id)
        self._cleanup_upload(bucket, upload_id, meta)
        self._respond(h, 204)

    def _cleanup_upload(self, bucket: str, upload_id: str,
                        meta: dict) -> None:
        for n in meta["parts"]:
            try:
                self.io.remove(f".part.{upload_id}.{n}")
            except RadosError as e:
                swallow("part_remove", e)
        self.io.remove_omap_keys(self._upload_shard(bucket, upload_id),
                                 [f".upload.{upload_id}"])


def main(argv=None) -> int:
    """radosgw entrypoint: serve S3 over a TCP cluster."""
    import argparse
    ap = argparse.ArgumentParser(prog="ceph-tpu-rgw")
    ap.add_argument("--monmap", required=True)
    ap.add_argument("--keyring", default="",
                    help="keyring JSON (secure clusters / SigV4 auth)")
    ap.add_argument("--port", type=int, default=7480)
    ap.add_argument("--pool", default="rgw")
    ap.add_argument("--name", default="",
                    help="client entity (default client.rgw<pid>); with "
                         "a keyring that holds it, it authenticates")
    a = ap.parse_args(argv)
    import os
    from ..client import Rados
    from ..tools.rados_cli import _keyring, _net_from_monmap
    keyring = _keyring(a.keyring)
    name = a.name or f"client.rgw{os.getpid() % 10000}"
    net = _net_from_monmap(a.monmap, keyring)
    r = Rados(net, name=name,
              auth_secret=keyring.get(name) if keyring is not None
              else None).connect()
    gw = RGWGateway(r, pool=a.pool, port=a.port)
    gw.start()
    print(f"rgw: serving S3 on :{gw.port} pool={a.pool}", flush=True)
    import signal
    ev = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: ev.set())
    try:
        ev.wait()
    except KeyboardInterrupt:
        pass
    gw.shutdown()
    r.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
