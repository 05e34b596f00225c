"""RGW multisite: realm/zonegroup/zone period model + async
site-to-site replication.

The reference's multisite stack (ref: src/rgw/rgw_sync.cc metadata
sync, rgw_data_sync.cc data sync, rgw_period.cc the period system,
rgw_admin.cc realm/zonegroup/zone verbs) in the same shape:

* **Realm → zonegroup → zone** topology lives in a *period*.  Admin
  edits accumulate in a staging period; `period commit` bumps the
  epoch and publishes it.  Exactly one zone per zonegroup is the
  metadata **master** — bucket creation on a secondary is forwarded
  to it, and secondaries adopt the master's newer periods (epoch
  propagation), so topology changes radiate outward.
* **Data sync is pull**: each zone's gateway runs a `SyncAgent`
  thread that, per peer zone in its zonegroup, first runs **full
  sync** (bucket listing diff: dump the peer's index, apply every
  version) and then **incremental sync** (tail the peer's sharded
  datalog with a durable cursor per shard).  Markers persist in RADOS
  (`.rgw.sync.<peer>`) *after* their batch applies — a crash replays
  at most one batch, and `obj_sync_apply`'s idempotence makes the
  replay a no-op.
* **Failures stay local**: an entry that will not apply lands in a
  per-shard error list (retried every round — the reference's
  error_repo) instead of wedging the shard; the cursor keeps moving.
  An unreachable peer gets capped-exponential backoff with jitter so
  a dead site costs a poll, not a hot loop (paced off the client hot
  path — cf. the EC-array paper's point that replication traffic
  must not ride the foreground).
* **Loops cannot form**: every replicated mutation carries a zone
  trace (the zones it has applied at); agents skip entries whose
  trace already contains their zone, and re-log applied entries with
  the trace extended — the reference's `x-rgw-zone-trace` guard.

Observability: `SyncAgent.status()` feeds the gateway's
`/admin/sync-status` REST op, the `rados rgw sync-status` CLI verb and
the mgr prometheus gauges (`ceph_rgw_sync_lag_entries`,
`ceph_rgw_sync_behind_shards`).

The port's copy of `ceph_tpu.rgw.multisite`, whole.  Where the
reference swallows a `RadosError` (a period or marker read, a
best-effort create, a datalog trim, a retired bucket's markers) the
port does the same and also counts each such error in `SWALLOWED`, by
site: ENOENT is not counted, nor EEXIST on a create.  A durable marker
record that does not decode is dropped as in the reference and counted
at `load_state_record`.  A sync round that raises is logged as in the
reference and counted in `SYNC_TICK_ERRORS`.  A `PeerError` goes to the
peer's backoff, not to either count.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
import weakref
from urllib.parse import quote

from collections import Counter

from ..client import RadosError
from ..common.backoff import Backoff
from ..common.lockdep import make_lock
from ..common.log import dout
from ..common.racecheck import shared_state
from .datalog import DataLog, shard_of_key

#: omap object holding the period (current + staging) in the rgw pool
PERIOD_OBJ = ".rgw.period"

#: swallowed errors by site (RadosErrors other than ENOENT, and EEXIST
#: on a create; undecodable durable marker records)
SWALLOWED: Counter = Counter()
#: sync rounds that raised (logged and survived by `SyncAgent._run`)
SYNC_TICK_ERRORS: Counter = Counter()


def _swallow(site: str, err: RadosError, create: bool = False) -> None:
    """Count a swallowed RadosError at `site` unless it is ENOENT (or
    EEXIST on a create)."""
    if err.errno_name == "ENOENT" or \
            (create and err.errno_name == "EEXIST"):
        return
    SWALLOWED[site] += 1


def sync_status_obj(source_zone: str) -> str:
    """Durable sync markers for one source zone (ref: the per-source
    rgw sync-status objects in the log pool)."""
    return f".rgw.sync.{source_zone}"


class MultisiteError(Exception):
    pass


def _empty_period() -> dict:
    return {"epoch": 0, "realm": "", "zonegroups": {}}


class MultisiteAdmin:
    """radosgw-admin's realm/zonegroup/zone/period surface against one
    zone's rgw pool (ref: rgw_admin.cc + RGWPeriod::commit)."""

    def __init__(self, io):
        self.io = io

    # -- persistence ---------------------------------------------------
    def _read(self, key: str) -> dict | None:
        try:
            vals = self.io.get_omap_vals_by_keys(PERIOD_OBJ, [key])
        except RadosError as e:
            _swallow("period_read", e)
            return None
        return json.loads(vals[key]) if key in vals else None

    def _write(self, key: str, obj: dict) -> None:
        try:
            self.io.create(PERIOD_OBJ)
        except RadosError as e:
            _swallow("period_create", e, create=True)
        self.io.set_omap(PERIOD_OBJ, {key: json.dumps(obj).encode()})

    def period_get(self) -> dict:
        return self._read("current") or _empty_period()

    def _staging(self) -> dict:
        return self._read("staging") or self.period_get()

    # -- topology edits (staged until period commit) -------------------
    def realm_create(self, name: str) -> None:
        p = self._staging()
        p["realm"] = name
        self._write("staging", p)

    def zonegroup_create(self, name: str) -> None:
        p = self._staging()
        if not p["realm"]:
            raise MultisiteError("create a realm first")
        p["zonegroups"].setdefault(name, {"zones": {}})
        self._write("staging", p)

    def zone_create(self, name: str, zonegroup: str,
                    endpoint: str = "", master: bool = False) -> None:
        p = self._staging()
        zg = p["zonegroups"].get(zonegroup)
        if zg is None:
            raise MultisiteError(f"no zonegroup {zonegroup}")
        if master:
            for z in zg["zones"].values():
                z["master"] = False         # exactly one master
        zg["zones"][name] = {"endpoint": endpoint,
                             "master": bool(master)}
        self._write("staging", p)

    def zone_modify(self, name: str, zonegroup: str,
                    endpoint: str | None = None,
                    master: bool | None = None) -> None:
        p = self._staging()
        zg = p["zonegroups"].get(zonegroup) or {}
        z = zg.get("zones", {}).get(name)
        if z is None:
            raise MultisiteError(f"no zone {name} in {zonegroup}")
        if endpoint is not None:
            z["endpoint"] = endpoint
        if master is not None:
            if master:
                for other in zg["zones"].values():
                    other["master"] = False
            z["master"] = bool(master)
        self._write("staging", p)

    def period_commit(self) -> int:
        """Publish the staged topology; the epoch bumps only when it
        actually changed (ref: RGWPeriod::commit — a no-op commit must
        not invalidate every zone's cached period)."""
        cur = self.period_get()
        staged = self._staging()
        if {k: staged[k] for k in ("realm", "zonegroups")} == \
                {k: cur[k] for k in ("realm", "zonegroups")}:
            return cur["epoch"]
        staged["epoch"] = cur["epoch"] + 1
        self._write("current", staged)
        return staged["epoch"]

    def period_adopt(self, period: dict) -> bool:
        """Install a peer's period if it is newer (epoch propagation:
        secondaries pull the master's period instead of being
        configured by hand)."""
        if period.get("epoch", 0) <= self.period_get()["epoch"]:
            return False
        self._write("current", dict(period))
        self._write("staging", dict(period))
        return True


class MultisiteState:
    """A gateway's cached view of the committed period."""

    #: seconds between period re-reads (topology changes are rare;
    #: every request must not pay an omap fetch)
    REFRESH_S = 1.0

    def __init__(self, io, zone: str):
        self.io = io
        self.zone = zone
        self.admin = MultisiteAdmin(io)
        self._period = _empty_period()
        self._loaded = 0.0
        self.refresh(force=True)

    def refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._loaded < self.REFRESH_S:
            return
        self._period = self.admin.period_get()
        self._loaded = now

    @property
    def period(self) -> dict:
        return self._period

    @property
    def epoch(self) -> int:
        return self._period["epoch"]

    def my_zonegroup(self) -> tuple[str, dict] | None:
        for name, zg in self._period["zonegroups"].items():
            if self.zone in zg["zones"]:
                return name, zg
        return None

    def is_master(self) -> bool:
        found = self.my_zonegroup()
        return bool(found and
                    found[1]["zones"][self.zone].get("master"))

    def master_endpoint(self) -> str:
        found = self.my_zonegroup()
        if not found:
            return ""
        for z in found[1]["zones"].values():
            if z.get("master"):
                return z.get("endpoint", "")
        return ""

    def peers(self) -> list[dict]:
        """Other zones in my zonegroup, endpoint included."""
        found = self.my_zonegroup()
        if not found:
            return []
        _, zg = found
        return [{"zone": name, "endpoint": cfg.get("endpoint", ""),
                 "master": bool(cfg.get("master"))}
                for name, cfg in sorted(zg["zones"].items())
                if name != self.zone and cfg.get("endpoint")]


class PeerError(Exception):
    """The peer gateway is unreachable / answered 5xx — back off."""


class PeerGone(PeerError):
    """The peer answered 404 for a bucket-scoped resource: the bucket
    vanished between the round's registry snapshot and this fetch.
    Skip the bucket, never back off the (healthy) peer."""


#: agents register here so the mgr prometheus exporter can find every
#: in-process gateway's sync state without a daemon-graph dependency
_AGENTS: "weakref.WeakSet[SyncAgent]" = weakref.WeakSet()


def render_sync_status(st: dict) -> list[str]:
    """One text rendering of SyncAgent.status() for every operator
    surface (rados_cli + the vstart shell — two templates would
    silently drift apart)."""
    lines = [f"zone {st['zone']} (period epoch {st['period_epoch']})"]
    for s in st["sources"]:
        state = "caught up" if s["caught_up"] else s["state"]
        lines.append(f"  source {s['source']}: {state}, "
                     f"{s['behind_shards']} behind shards, "
                     f"lag {s['lag_entries']} entries, "
                     f"{s['errors']} errors")
    return lines


def sync_status_all() -> list[dict]:
    """Flat per-(zone, source) lag rows for the prometheus gauges."""
    rows = []
    for agent in list(_AGENTS):
        if agent._stop.is_set():
            continue    # killed/stopped gateway: its replacement (same
            # zone, same sources) owns the labels now — two rows with
            # one label set is invalid prometheus exposition
        try:
            st = agent.status()
        except Exception as ex:  # noqa: BLE001 — one dying gateway
            # must not take the whole scrape down, but leave a trace
            dout("rgw", 1).write("sync_status_all: %s: %s",
                                 type(ex).__name__, ex)
            continue
        for src in st["sources"]:
            rows.append({"zone": st["zone"], "source": src["source"],
                         "lag_entries": src["lag_entries"],
                         "behind_shards": src["behind_shards"]})
    return rows


def sync_apply_hists() -> dict[str, dict]:
    """zone -> sync-apply latency histogram dump (the "sync" op class
    of the cluster SLO histograms; scraped by mgr/prometheus)."""
    out: dict[str, dict] = {}
    for agent in list(_AGENTS):
        if agent._stop.is_set():
            continue
        out[agent.zone] = agent.perf.get("op_lat_sync")
    return out


@shared_state(only=("_markers", "_durable", "_heads", "_errors",
                    "_gens"),
              mutating=("_markers", "_durable", "_heads", "_errors",
                        "_gens"))
class SyncAgent:
    """Per-zone replication worker: one thread, pull-based, durable
    cursors (ref: RGWDataSyncProcessorThread + RGWRemoteDataLog).

    The cursor/quarantine maps are shared between the agent thread
    and status/trim readers (sync_status, the gateway's asok scrape),
    so they are racecheck-instrumented: every access must hold
    self._lock."""

    #: datalog entries pulled per shard per round — small on purpose:
    #: the cursor persists per batch, so batch size bounds the replay
    #: window after a kill
    BATCH = 8
    #: backoff on peer HTTP failure: capped exponential with jitter
    BACKOFF_BASE_S = 0.1
    BACKOFF_CAP_S = 5.0
    #: error-list entries kept per shard (oldest dropped, logged)
    MAX_SHARD_ERRORS = 64
    #: sync rounds between datalog auto-trim passes (the trim needs
    #: one HTTP round-trip per peer, so it must not ride every tick)
    TRIM_EVERY = 50
    #: zero-peer zones have no cursors to trim behind; entries older
    #: than this are trimmed by AGE instead (ref: the reference's
    #: rgw_data_log_window expiry) — bounded per shard per round
    NOPEER_MAX_AGE_S = 3600.0
    NOPEER_TRIM_MAX = 256

    def __init__(self, gw, interval: float = 0.1):
        self.gw = gw
        self.io = gw.io
        self.zone = gw.zone
        self.interval = interval
        self.datalog = DataLog(self.io)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # per-instance name: racecheck locksets (and lockdep edges)
        # key by lock NAME, so two zones' agents sharing "rgw.sync"
        # would alias each other's guard
        self._lock = make_lock(f"rgw.sync.{gw.zone}")
        #: (source, bucket, shard) -> applied-up-to sequence
        self._markers: dict[tuple[str, str, int], int] = {}
        #: (source, bucket, shard) -> marker KNOWN PERSISTED in RADOS;
        #: the datalog auto-trim on the source must see only durable
        #: cursors — an in-memory marker dies with a crash and the
        #: replayed batch would read an already-trimmed log
        self._durable: dict[tuple[str, str, int], int] = {}
        #: (source, bucket, shard) -> last observed peer head
        self._heads: dict[tuple[str, str, int], int] = {}
        #: (source, bucket, shard) -> [error records]
        self._errors: dict[tuple[str, str, int], list[dict]] = {}
        #: source -> shared capped-exponential backoff (the canonical
        #: policy now lives in common/backoff.py; this agent is where
        #: the shape was extracted from)
        self._backoff: dict[str, "Backoff"] = {}
        #: (source, bucket) -> the bucket's "created" stamp the
        #: cursors belong to — a recreate under the same name restarts
        #: the datalog sequences, so stale cursors must be retired
        self._gens: dict[tuple[str, str], str] = {}
        #: source zones with at least one bucket awaiting full sync
        self._pending_full: dict[str, int] = {}
        self._peer_ok: dict[str, bool] = {}
        self.entries_applied = 0
        self.entries_skipped = 0
        self.full_syncs = 0
        self.datalog_trimmed = 0
        self._rounds = 0
        self._loaded_sources: set[str] = set()
        # sync-class apply latency (fetch + local apply per replicated
        # entry) — the fourth op-class SLO histogram next to the OSD's
        # client/recovery/snaptrim
        from ..common.perf_counters import PerfCounters
        self.perf = PerfCounters(f"rgw.sync.{self.zone}")
        self.perf.add_latency_histogram("op_lat_sync")
        # internal thread-liveness watchdog: the sync round registers
        # as a worker (arms on the first round) so a wedged agent —
        # stuck HTTP pull, a quarantine loop gone hot — surfaces
        # through sync status / the gateway asok instead of silently
        # stalling replication
        from ..common.heartbeat_map import HeartbeatMap
        self.hbmap = HeartbeatMap()
        self._hb_handle = self.hbmap.add_worker(
            f"rgw.sync.{self.zone}.round", grace=60.0, arm=False)
        _AGENTS.add(self)

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="rgw-sync", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        _AGENTS.discard(self)
        if self._thread:
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as ex:  # noqa: BLE001 — the agent is a
                # daemon-lifetime loop: one bad round must not end
                # replication, but it MUST leave a trace (cephck
                # silent-thread)
                SYNC_TICK_ERRORS[self.zone] += 1
                dout("rgw", 1).write("sync tick failed: %s: %s",
                                     type(ex).__name__, ex)
            self._stop.wait(self.interval)

    # -- the round ----------------------------------------------------
    def tick(self) -> int:
        """One pass over every peer; returns entries applied."""
        self.hbmap.reset_timeout(self._hb_handle)
        self.gw.multisite.refresh()
        applied = 0
        now = time.monotonic()
        peers = self.gw.multisite.peers()
        #: this round's per-peer registry dumps — the tombstone-prune
        #: evidence (only a round that reached EVERY peer may prune)
        views: dict[str, dict] = {}
        for peer in peers:
            src = peer["zone"]
            bo = self._backoff.get(src)
            if bo is None:
                bo = self._backoff[src] = Backoff(
                    base_s=self.BACKOFF_BASE_S,
                    cap_s=self.BACKOFF_CAP_S)
            if not bo.ready(now):
                continue
            try:
                applied += self._sync_peer(peer, views)
                bo.reset()
                self._peer_ok[src] = True
            except PeerError as ex:
                # jitter rides the shared helper: peers recovering
                # together must not re-stampede in lockstep
                delay = bo.fail(time.monotonic())
                self._peer_ok[src] = False
                dout("rgw", 4).write(
                    "sync %s<-%s unreachable (%s), backoff %.2fs "
                    "(%d consecutive)",
                    self.zone, src, ex, delay, bo.failures)
        if peers and len(views) == len(peers) and \
                not self._stop.is_set():
            # every peer answered this round: registry delete-
            # tombstones every peer's sync has demonstrably passed
            # (their registries carry the deletion, or dropped it)
            # can go — bounded tombstone growth.  `peers` non-empty is
            # load-bearing: a transient no-peer window (period refresh
            # mid-adopt) must not approve every tombstone with zero
            # evidence
            self.gw.prune_registry_tombstones(views)
        # periodic datalog auto-trim: drop replication records every
        # registered peer's durable cursor has passed (bounded log
        # growth without an operator in the loop)
        self._rounds += 1
        if self._rounds % self.TRIM_EVERY == 0:
            # zero-peer zones trim by age inside the round (the
            # peer-cursor path needs peers; the age path needs none)
            self.datalog_trim_round()
        return applied

    def _sync_peer(self, peer: dict,
                   views: dict[str, dict] | None = None) -> int:
        src, endpoint = peer["zone"], peer["endpoint"]
        if src not in self._loaded_sources:
            self._load_state(src)
            self._loaded_sources.add(src)
        # epoch propagation: adopt the peer's newer period
        period = self._fetch_json(endpoint, "GET", "/admin/period")
        if period.get("epoch", 0) > self.gw.multisite.epoch:
            self.gw.multisite.admin.period_adopt(period)
            self.gw.multisite.refresh(force=True)
        from ..cls.rgw import now_str
        fetch_stamp = now_str()
        buckets = self._fetch_json(endpoint, "GET", "/admin/buckets")
        if views is not None:
            views[src] = (fetch_stamp, buckets)
        local = self.gw._buckets_raw()  # one registry read per round
        applied = 0
        pending_full = 0
        for bucket, meta in sorted(buckets.items()):
            if self._stop.is_set():
                break
            if "deleted" in meta:
                # the peer's registry carries a deletion tombstone:
                # drop our copy (once empty) and retire its cursors —
                # a recreate under the same name must full-sync from
                # scratch, not resume stale markers against a fresh
                # datalog
                if self.gw.sync_drop_bucket(bucket, meta,
                                            registry=local):
                    self._forget_bucket(src, bucket)
                continue
            gen = meta.get("created", "")
            # under the lock: _load_state/markers_for touch _gens
            # from the gateway's admin threads (racecheck-audited)
            with self._lock:
                known = self._gens.get((src, bucket))
            if known is not None and known != gen:
                # recreated under the same name while we held cursors
                # for the old incarnation: the fresh datalog restarts
                # at seq 1, stale high markers would skip everything —
                # and any old-incarnation content we still hold can
                # never see its deletes (that datalog died with the
                # bucket), so it is discarded before the full sync
                self._forget_bucket(src, bucket)
                self.gw.sync_reset_bucket(bucket, meta, registry=local)
            with self._lock:
                self._gens[(src, bucket)] = gen
            self.gw.sync_ensure_bucket(
                bucket, meta, from_master=peer.get("master", False),
                registry=local)
            nshards = int(meta.get("shards", 1))
            # under the lock: sync_status() reads _markers from other
            # threads while this round mutates it
            with self._lock:
                have = [s for s in range(nshards)
                        if (src, bucket, s) in self._markers]
            try:
                if len(have) < nshards:
                    pending_full += 1
                    applied += self._full_bucket(src, endpoint, bucket,
                                                 nshards)
                else:
                    applied += self._incremental(src, endpoint, bucket,
                                                 nshards)
            except PeerGone:
                continue        # deleted on the peer mid-round; the
                # next round's registry snapshot carries its tombstone
        self._pending_full[src] = pending_full
        return applied

    # -- full sync (bucket listing diff) ------------------------------
    def _full_bucket(self, src: str, endpoint: str, bucket: str,
                     nshards: int) -> int:
        """Dump-and-apply one bucket, then start the incremental
        cursors at the heads captured BEFORE the dump — entries
        racing the dump get replayed and squashed by idempotence
        (ref: rgw full sync -> incremental handoff markers)."""
        heads = self._log_list(endpoint, bucket,
                               {s: 0 for s in range(nshards)}, 0)
        index = self._fetch_json(
            endpoint, "GET", f"/admin/bucket?name={quote(bucket)}")
        ln = self.gw._nshards(bucket)   # ONE local-layout read per
        # round, not one registry fetch per entry applied
        applied = 0
        for key, ent in sorted(index.items()):
            if self._stop.is_set():
                return applied      # no markers yet: full sync redoes
            try:
                ops = self._ops_of_entry(key, ent)
            except Exception as ex:  # noqa: BLE001 — an entry the
                # synthesizer cannot shape (foreign bookkeeping key,
                # missing field) must quarantine like an apply
                # failure, not abort the whole peer's round.  Op
                # "synth": the retry re-reads the key's CURRENT state
                # at the source — a fabricated put here would apply
                # empty mtime/etag or silently drain without syncing
                self._quarantine(src, bucket,
                                 shard_of_key(key, nshards),
                                 {"key": key, "op": "synth",
                                  "vid": None, "trace": []}, ex)
                continue
            for op in ops:
                try:
                    applied += self._apply(src, endpoint, bucket, op,
                                           ln)
                except PeerError:
                    raise
                except Exception as ex:  # noqa: BLE001 — a poisoned
                    # entry must not wedge full sync forever (the
                    # bucket would never reach incremental): it goes
                    # to the error list like an incremental failure
                    # and is retried every round from there.  Keyed by
                    # the PEER's shard count — the retry/persist loops
                    # walk range(peer nshards), a local-layout shard
                    # index could fall outside them
                    self._quarantine(src, bucket,
                                     shard_of_key(key, nshards),
                                     op, ex)
        if self._stop.is_set():
            return applied
        with self._lock:
            for s in range(nshards):
                self._markers[(src, bucket, s)] = \
                    heads.get(s, {}).get("head", 0)
                self._heads[(src, bucket, s)] = \
                    heads.get(s, {}).get("head", 0)
        self._persist(src, bucket, nshards)
        self.full_syncs += 1
        return applied

    @staticmethod
    def _ops_of_entry(key: str, ent: dict) -> list[dict]:
        """Synthesize datalog-shaped ops from an index dump entry,
        oldest first so stacks rebuild in arrival order."""
        versions = ent.get("versions")
        if versions is None:
            return [{"key": key, "op": "put", "mode": "plain",
                     "vid": None, "size": ent["size"],
                     "etag": ent["etag"], "mtime": ent["mtime"],
                     "trace": ent.get("trace") or []}]
        ops = []
        for v in reversed(versions):
            if v.get("dm"):
                ops.append({"key": key, "op": "dm", "vid": v["vid"],
                            "mtime": v["mtime"], "trace": []})
            else:
                ops.append({"key": key, "op": "put",
                            "mode": "enabled", "vid": v["vid"],
                            "size": v["size"], "etag": v["etag"],
                            "mtime": v["mtime"], "trace": []})
        return ops

    # -- incremental sync (datalog cursors) ---------------------------
    def _incremental(self, src: str, endpoint: str, bucket: str,
                     nshards: int) -> int:
        # under the lock: status/persist readers walk _markers from
        # the gateway's threads concurrently (racecheck-audited)
        with self._lock:
            markers = {s: self._markers.get((src, bucket, s), 0)
                       for s in range(nshards)}
        out = self._log_list(endpoint, bucket, markers, self.BATCH)
        ln = self.gw._nshards(bucket)
        applied = 0
        dirty = False
        for s in range(nshards):
            shard = out.get(s, {})
            with self._lock:
                self._heads[(src, bucket, s)] = shard.get("head", 0)
            # retry the shard's error list first: a poisoned entry
            # gets another chance every round, never thread death
            with self._lock:
                errs = self._errors.get((src, bucket, s), [])
            still = []
            for rec in errs:
                if self._stop.is_set():
                    return applied
                try:
                    applied += self._apply(src, endpoint, bucket,
                                           rec["entry"], ln)
                    dirty = True
                except PeerError:
                    raise
                except Exception as ex:  # noqa: BLE001 — quarantine
                    rec = dict(rec, retries=rec["retries"] + 1,
                               err=f"{type(ex).__name__}: {ex}")
                    still.append(rec)
            if len(still) != len(errs):
                dirty = True
            with self._lock:
                self._errors[(src, bucket, s)] = still
            for ent in shard.get("entries", ()):
                if self._stop.is_set():
                    # killed mid-batch: the marker for already-applied
                    # entries is NOT persisted — restart replays them
                    # and obj_sync_apply squashes the replay
                    return applied
                seq = ent["seq"]
                try:
                    applied += self._apply(src, endpoint, bucket, ent,
                                           ln)
                except PeerError:
                    raise
                except Exception as ex:  # noqa: BLE001 — a poisoned
                    # entry lands in the error list; the cursor keeps
                    # moving (the reference's error_repo)
                    self._quarantine(src, bucket, s, ent, ex)
                with self._lock:
                    self._markers[(src, bucket, s)] = seq
                dirty = True
        if dirty:
            self._persist(src, bucket, nshards)
        return applied

    # -- datalog auto-trim ---------------------------------------------
    def markers_for(self, source: str) -> dict[str, dict]:
        """This zone's DURABLE cursors for entries pulled from
        `source`: {bucket: {"gen": incarnation, "cursors": {shard:
        marker}}} — what the source's auto-trim consumes over
        /admin/sync-markers.  Only markers that survived a persist are
        reported (trimming against an in-memory cursor would strand a
        crash-replayed batch on an already-trimmed log), and each set
        carries the bucket INCARNATION its cursors belong to: a high
        cursor against a dead datalog must not approve trimming a
        recreated bucket's fresh records."""
        with self._lock:
            out: dict[str, dict] = {}
            for (src, bucket, shard), m in self._durable.items():
                if src == source:
                    rec = out.setdefault(
                        bucket,
                        {"gen": self._gens.get((src, bucket), ""),
                         "cursors": {}})
                    rec["cursors"][str(shard)] = m
            return out

    def datalog_trim_round(self) -> int:
        """Trim every local bucket shard's datalog up to the MINIMUM
        durable cursor across ALL registered peers (the reference's
        datalog trim driven by peer sync markers).  A peer that is
        lagging, unreachable, or has never synced a bucket reports a
        lower (or no) marker and blocks the trim for exactly the
        records it still needs — the trim can only destroy records
        every peer has durably passed.  Returns records trimmed."""
        self.gw.multisite.refresh()
        peers = self.gw.multisite.peers()
        if not peers:
            # no peers registered: no cursors, so no cursor-driven
            # trim — but an unconsumed log must not grow forever
            # either.  Age out old records (bounded), sparing
            # anything past an in-flight full-sync floor.
            return self._trim_by_age()
        views: list[dict] = []
        for peer in peers:
            try:
                views.append(self._fetch_json(
                    peer["endpoint"], "GET",
                    f"/admin/sync-markers?source={quote(self.zone)}"))
            except PeerError as ex:
                dout("rgw", 4).write(
                    "datalog trim skipped: peer %s unreachable (%s)",
                    peer["zone"], ex)
                return 0    # an unreachable registered peer blocks
                # every trim: we cannot know what it still needs
        trimmed = 0
        local = self.gw._buckets_raw()
        for bucket, meta in local.items():
            if "deleted" in meta:
                continue
            lgen = meta.get("created", "")
            recs = [v.get(bucket) for v in views]
            if any(r is None or r.get("gen", "") != lgen
                   for r in recs):
                # a peer with no cursors for this bucket — or cursors
                # from a DEAD incarnation (delete+recreate it hasn't
                # resynced yet) — blocks the whole bucket: its stale
                # high markers say nothing about the fresh datalog
                continue
            for s in range(self.gw._nshards(bucket)):
                upto = min(int(r["cursors"].get(str(s), 0))
                           for r in recs)
                if upto <= 0:
                    continue
                try:
                    n = self.datalog.trim(bucket, s, upto)
                except RadosError as e:
                    _swallow("trim", e)
                    continue        # shard object gone/unreadable:
                    # nothing to trim there this round
                trimmed += n
        self.datalog_trimmed += trimmed
        if trimmed:
            dout("rgw", 4).write(
                "datalog auto-trim: %d record(s) behind all %d "
                "peers' durable cursors", trimmed, len(peers))
        return trimmed

    def _trim_by_age(self) -> int:
        """Datalog trim for a zone with ZERO registered peers: every
        record older than NOPEER_MAX_AGE_S goes, at most
        NOPEER_TRIM_MAX inspected per shard per round (the trim must
        not turn into an unbounded scan on a hot shard).  One guard:
        a peer mid-full-sync (it just pulled the bucket index dump —
        e.g. a zone about to register) starts its incremental cursor
        at the dump-time head, so records PAST the recorded floor
        survive until the gateway's grace window expires."""
        from ..cls.rgw import parse_mtime
        now = time.time()
        trimmed = 0
        local = self.gw._buckets_raw()
        for bucket, meta in local.items():
            if "deleted" in meta:
                continue
            floors = self.gw.fullsync_floor(bucket)
            for s in range(self.gw._nshards(bucket)):
                try:
                    entries, _head = self.datalog.list(
                        bucket, s, 0, self.NOPEER_TRIM_MAX)
                except RadosError as e:
                    _swallow("age_trim_list", e)
                    continue    # shard object gone/unreadable
                upto = 0
                for ent in entries:
                    stamp = parse_mtime(ent.get("mtime", ""))
                    if stamp <= 0 or now - stamp < \
                            self.NOPEER_MAX_AGE_S:
                        break   # entries list in seq order: the
                        # first young (or unstamped) record ends the
                        # trimmable prefix
                    upto = ent["seq"]
                if floors is not None:
                    upto = min(upto, floors.get(s, 0))
                if upto <= 0:
                    continue
                try:
                    n = self.datalog.trim(bucket, s, upto)
                except RadosError as e:
                    _swallow("age_trim", e)
                    continue
                trimmed += n
        self.datalog_trimmed += trimmed
        if trimmed:
            dout("rgw", 4).write(
                "datalog age-trim (no peers): %d record(s) older "
                "than %.0fs", trimmed, self.NOPEER_MAX_AGE_S)
        return trimmed

    def _forget_bucket(self, src: str, bucket: str) -> None:
        """Retire a dropped bucket's cursor state, memory + durable —
        stale markers against a recreated bucket's fresh datalog
        (sequences restart) would skip every new entry."""
        with self._lock:
            keys = [k for k in self._markers
                    if k[0] == src and k[1] == bucket]
            ekeys = [k for k in self._errors
                     if k[0] == src and k[1] == bucket]
            hkeys = [k for k in self._heads
                     if k[0] == src and k[1] == bucket]
            if not keys and not ekeys and not hkeys:
                return
            shards = sorted({k[2] for k in keys} | {k[2] for k in ekeys})
            for k in keys:
                del self._markers[k]
            for k in ekeys:
                del self._errors[k]
            for k in hkeys:
                del self._heads[k]
            for k in [k for k in self._durable
                      if k[0] == src and k[1] == bucket]:
                del self._durable[k]
            self._gens.pop((src, bucket), None)
        try:
            self.io.remove_omap_keys(
                sync_status_obj(src),
                [f"{kind}.{bucket}.{s}" for s in shards
                 for kind in ("m", "e")])
        except RadosError as e:
            _swallow("forget_bucket", e)

    def _quarantine(self, src: str, bucket: str, shard: int,
                    ent: dict, ex: Exception) -> None:
        key = (src, bucket, shard)
        rec = {"entry": ent, "retries": 0,
               "err": f"{type(ex).__name__}: {ex}"}
        ident = (ent.get("key"), ent.get("op"), ent.get("vid"))
        with self._lock:
            lst = self._errors.setdefault(key, [])
            for i, old in enumerate(lst):
                e = old["entry"]
                same = (e.get("key"), e.get("op"),
                        e.get("vid")) == ident
                synth_pair = e.get("key") == ent.get("key") and \
                    "synth" in (e.get("op"), ent.get("op"))
                if same or synth_pair:
                    # the same logical mutation, seen again — a
                    # full-sync failure and its datalog twin from the
                    # pre-dump replay window collapse into ONE record
                    # (the reference error_repo keys by bucket:obj for
                    # the same reason).  A synth record supersedes (its
                    # retry re-applies the key's whole current state);
                    # otherwise prefer the datalog entry (it carries
                    # the seq).  Retry count survives the merge.
                    if ent.get("op") == "synth" or \
                            e.get("op") == "synth":
                        keep = ent if ent.get("op") == "synth" else e
                    else:
                        keep = ent if ent.get("seq") is not None else e
                    lst[i] = dict(rec, retries=old["retries"],
                                  entry=keep)
                    return
            lst.append(rec)
            if len(lst) > self.MAX_SHARD_ERRORS:
                dropped = lst.pop(0)
                dout("rgw", 1).write(
                    "sync %s<-%s error list full on %s.%d, dropping "
                    "seq %s", self.zone, src, bucket, shard,
                    dropped["entry"].get("seq"))
        dout("rgw", 2).write("sync %s<-%s quarantined %s/%s seq %s: %s",
                             self.zone, src, bucket, ent.get("key"),
                             ent.get("seq"), rec["err"])

    # -- applying one entry -------------------------------------------
    def _apply(self, src: str, endpoint: str, bucket: str,
               ent: dict, ln: int | None = None) -> int:
        """Returns 1 when the entry mutated local state, 0 when it was
        skipped (trace loop, stale data, already applied).  `ln` is
        the caller's once-per-round read of the LOCAL shard layout."""
        if self.zone in (ent.get("trace") or ()):
            self.entries_skipped += 1
            return 0            # it has been here: do not loop
        if ent["op"] == "synth":
            # quarantined synthesizer failure: apply from the key's
            # CURRENT index state at the source.  Gone there = the
            # record drains legitimately; still unshapeable = the
            # exception keeps it quarantined for the next round.
            index = self._fetch_json(
                endpoint, "GET",
                f"/admin/bucket?name={quote(bucket)}")
            cur = index.get(ent["key"])
            if cur is None:
                self.entries_skipped += 1
                return 0
            n = 0
            for op in self._ops_of_entry(ent["key"], cur):
                n += self._apply(src, endpoint, bucket, op, ln)
            return n
        t0 = time.perf_counter()
        data = None
        if ent["op"] == "put":
            fetched = self._fetch_object(endpoint, bucket, ent)
            if fetched is None:
                self.entries_skipped += 1
                return 0        # moved on at the source; a later
                # entry carries the newer state
            data = fetched
        applied = self.gw.sync_apply(bucket, ent, data, src,
                                     nshards=ln)
        if applied:
            # sync-class latency: cross-zone fetch + local apply of
            # one replicated entry (skips are free, not latency)
            self.perf.hobs("op_lat_sync",
                           time.perf_counter() - t0)
            self.entries_applied += 1
            return 1
        self.entries_skipped += 1
        return 0

    def _fetch_object(self, endpoint: str, bucket: str,
                      ent: dict) -> bytes | None:
        """GET the entry's bytes from the source zone; None when the
        exact state is gone (overwritten/deleted since — skip, the
        follow-up entry supersedes this one)."""
        path = f"/{quote(bucket)}/{quote(ent['key'])}"
        if ent.get("vid"):
            path += f"?versionId={quote(ent['vid'])}"
        try:
            status, headers, body = self.gw.peer_request(
                endpoint, "GET", path)
        except urllib.error.HTTPError as e:
            if e.code in (404, 405):
                return None     # gone / now a delete marker
            raise PeerError(f"GET {path} -> {e.code}")
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise PeerError(f"GET {path}: {e}")
        etag = (headers.get("ETag") or "").strip('"')
        if ent.get("etag") and etag != ent["etag"]:
            return None         # plain-put raced an overwrite: the
            # head moved, a newer datalog entry must exist
        return body

    # -- peer HTTP -----------------------------------------------------
    def _fetch_json(self, endpoint: str, method: str, path: str,
                    body: dict | None = None) -> dict:
        try:
            status, _, raw = self.gw.peer_request(
                endpoint, method, path,
                json.dumps(body).encode() if body is not None
                else None)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise PeerGone(f"{method} {path} -> 404")
            raise PeerError(f"{method} {path} -> {e.code}")
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise PeerError(f"{method} {path}: {e}")
        try:
            return json.loads(raw)
        except ValueError:
            raise PeerError(f"{method} {path}: bad JSON")

    def _log_list(self, endpoint: str, bucket: str,
                  markers: dict[int, int], batch: int) -> dict:
        out = self._fetch_json(endpoint, "POST", "/admin/log", {
            "bucket": bucket,
            "markers": {str(s): m for s, m in markers.items()},
            "max": batch})
        return {int(s): v for s, v in out.get("shards", {}).items()}

    # -- durable state -------------------------------------------------
    def _persist(self, src: str, bucket: str, nshards: int) -> None:
        """One omap batch per bucket round: markers + error lists.
        Written AFTER the applies they describe — a crash between
        apply and persist replays the batch, never skips it."""
        kv = {}
        persisted: dict[tuple[str, str, int], int] = {}
        with self._lock:
            for s in range(nshards):
                m = self._markers.get((src, bucket, s))
                if m is None:
                    continue
                kv[f"m.{bucket}.{s}"] = json.dumps(
                    {"marker": m,
                     "gen": self._gens.get((src, bucket), "")}).encode()
                errs = self._errors.get((src, bucket, s), [])
                kv[f"e.{bucket}.{s}"] = json.dumps(errs).encode()
                persisted[(src, bucket, s)] = m
        try:
            self.io.create(sync_status_obj(src))
        except RadosError as e:
            _swallow("markers_create", e, create=True)
        self.io.set_omap(sync_status_obj(src), kv)
        # only now (write durable) may the source's auto-trim see them
        with self._lock:
            self._durable.update(persisted)

    def _load_state(self, src: str) -> None:
        """Resume point: markers + error lists from the durable
        status object (what a restarted gateway continues from)."""
        try:
            vals, _ = self.io.get_omap_vals(sync_status_obj(src))
        except RadosError as e:
            _swallow("load_state", e)
            return
        with self._lock:
            for k, raw in vals.items():
                try:
                    kind, rest = k.split(".", 1)
                    bucket, shard_s = rest.rsplit(".", 1)
                    key = (src, bucket, int(shard_s))
                    if kind == "m":
                        rec = json.loads(raw)
                        self._markers[key] = rec["marker"]
                        self._durable[key] = rec["marker"]
                        self._gens[(src, bucket)] = rec.get("gen", "")
                    elif kind == "e":
                        self._errors[key] = json.loads(raw)
                except (ValueError, KeyError, TypeError):
                    # one torn/corrupt record must not wedge every
                    # tick forever (the exception would escape past
                    # tick()'s PeerError handling); worst case the
                    # shard full-syncs again, which is idempotent
                    SWALLOWED["load_state_record"] += 1
                    dout("rgw", 1).write(
                        "sync %s<-%s: dropping undecodable durable "
                        "record %r", self.zone, src, k)

    # -- observability -------------------------------------------------
    def status(self) -> dict:
        """`radosgw-admin sync status` analogue, one row per source."""
        self.gw.multisite.refresh()
        sources = []
        with self._lock:
            markers = dict(self._markers)
            heads = dict(self._heads)
            errors = {k: len(v) for k, v in self._errors.items() if v}
        for peer in self.gw.multisite.peers():
            src = peer["zone"]
            lag = 0
            behind = 0
            for key, head in heads.items():
                if key[0] != src:
                    continue
                d = head - markers.get(key, 0)
                if d > 0:
                    behind += 1
                    lag += d
            nerr = sum(n for k, n in errors.items() if k[0] == src)
            pending = self._pending_full.get(src, 1 if not any(
                k[0] == src for k in markers) else 0)
            state = "incremental"
            if pending:
                state = "full"
            if not self._peer_ok.get(src, False):
                state = "connecting" if src not in self._peer_ok \
                    else "backoff"
            sources.append({
                "source": src, "state": state,
                "behind_shards": behind, "lag_entries": lag,
                "errors": nerr, "buckets_pending_full": pending,
                "caught_up": (state == "incremental" and behind == 0
                              and nerr == 0)})
        return {"zone": self.zone, "period_epoch": self.gw.multisite.epoch,
                "hbmap_unhealthy": self.hbmap.get_unhealthy_workers(),
                "entries_applied": self.entries_applied,
                "entries_skipped": self.entries_skipped,
                "full_syncs": self.full_syncs,
                "apply_lat": self.perf.get("op_lat_sync"),
                "sources": sources}

    def caught_up(self) -> bool:
        st = self.status()
        return bool(st["sources"]) and \
            all(s["caught_up"] for s in st["sources"])

    def error_list(self) -> list[dict]:
        with self._lock:
            return [dict(rec, source=k[0], bucket=k[1], shard=k[2])
                    for k, lst in self._errors.items() for rec in lst]
