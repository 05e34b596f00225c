"""cls_rgw: bucket-index transactions executed inside the OSD.

The reference maintains its bucket index with cls methods running on
the index object's primary OSD (ref: src/cls/rgw/cls_rgw.cc,
cls_rgw_ops.h), so every gateway's read-modify-write of an index entry
serializes on the PG — not on any gateway-local lock.  Same contract
here: each method below reads the current entry, computes the new
version stack, and queues the omap update; the daemon runs the method
under its dispatch lock and commits the mutation atomically with the
reply (osd/daemon.py _do_exec).  Two radosgw processes over one pool
therefore cannot lose a concurrent PUT's version record.

Entry format (JSON, one omap value per key; shared with
rgw/gateway.py):
  plain:     {"size", "etag", "mtime"}
  versioned: {"versions": [head..tail], "size", "etag", "mtime", "dm"}
  tombstone: {"tomb": true, "mtime"} — a plain delete leaves this in
             place of the entry (invisible to reads/listings) so a
             peer zone's put record that raced the delete compares
             against the delete's mtime instead of landing on an
             absent key and resurrecting the object.  A newer put
             (local or replicated) overwrites it.
Each version: {"vid", "size", "etag", "mtime", "dm", "obj"} where
"obj" names the RADOS data object backing that version (None for
delete markers).

Methods return the data objects orphaned by the operation in
"removed" — the gateway deletes those AFTER the index commit, the
same order the reference uses (index transaction first, data gc
second) so a crash leaves garbage, never a dangling index entry.

**Datalog (multisite)**: when the caller passes `log={"trace": [...]}`
every mutating method also appends a change record to the shard's
datalog — omap keys `.dl.<seq>` on the SAME index object, queued in
the SAME mutation batch as the index write, so the log entry and the
index entry commit as one transaction (ref: cls_rgw's bilog —
bucket_complete_op writes the bi log entry inside the index op; the
separate-object data log of rgw_datalog.cc would lose that
atomicity on a crash).  `trace` lists the
zones the mutation has already been applied at — sync agents skip
entries whose trace contains their own zone, which is what stops
replication loops.

The port's copy of `ceph_tpu.cls.rgw`: the same methods, entry JSON,
datalog keys and timestamp format, byte for byte.
"""
from __future__ import annotations

import calendar
import json
import time

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, cls_method

#: the one timestamp format for index entries — shared with the
#: gateway (rgw/gateway.py imports these; a format drift between
#: writer and OSD-side trimmer would misage every version).  now_str
#: appends real milliseconds (fixed width, so the string comparisons
#: the conflict rules use stay lexicographic): at 1s resolution every
#: same-second pair of writes was a cross-zone ordering tie.
MTIME_FMT = "%Y-%m-%dT%H:%M:%S"


def now_str() -> str:
    t = time.time()
    return time.strftime(MTIME_FMT, time.gmtime(t)) + \
        ".%03dZ" % int(t % 1 * 1000)


def parse_mtime(s: str) -> float:
    try:
        base, _, frac = s.partition(".")
        # timegm, not mktime: the stamp is UTC — local interpretation
        # shifted every parse by the DST hour
        return calendar.timegm(time.strptime(base, MTIME_FMT)) + \
            int(frac.rstrip("Z") or 0) / 1000.0
    except ValueError:
        return 0.0


#: datalog key namespace inside the index shard omap.  Listings and
#: emptiness checks filter these the way they filter `.upload.` keys.
DL_PREFIX = ".dl."
#: omap key holding the shard's datalog head sequence
DL_META = ".dlmeta"


def dl_key(seq: int) -> str:
    """Zero-padded so lexicographic omap order == sequence order."""
    return f"{DL_PREFIX}{seq:016d}"


def is_dl_key(key: str) -> bool:
    return key.startswith(DL_PREFIX) or key == DL_META


def _dl_head(raw: dict) -> int:
    meta = raw.get(DL_META)
    return json.loads(meta)["seq"] if meta else 0


def _dl_append(ctx, d: dict, op: str, key: str,
               raw: dict | None = None, **fields) -> None:
    """Queue a datalog record in the SAME mutation batch as the index
    write (the whole point: a crash commits both or neither).  No-op
    unless the caller opted in with d["log"].  `raw` reuses the
    caller's omap snapshot — queued mutations never touch it, and a
    second full-shard fetch per write is the hot path's biggest
    cost."""
    log = d.get("log")
    if not log:
        return
    seq = _dl_head(ctx.omap_get() if raw is None else raw) + 1
    ent = {"seq": seq, "key": key, "op": op,
           "trace": list(log.get("trace") or ()), **fields}
    ctx.omap_set({DL_META: json.dumps({"seq": seq}).encode(),
                  dl_key(seq): json.dumps(ent).encode()})


def _load(ctx, key: str, raw: dict | None = None) -> dict | None:
    v = (ctx.omap_get() if raw is None else raw).get(key)
    return json.loads(v) if v else None


def is_tomb(ent: dict | None) -> bool:
    """Per-key delete tombstone (see module docstring).  Shared with
    the gateway so its reads/listings drop tombstones the same way
    they drop datalog keys."""
    return bool(ent) and bool(ent.get("tomb"))


def _set_tomb(ctx, key: str, mtime: str) -> None:
    ctx.omap_set({key: json.dumps(
        {"tomb": True, "mtime": mtime}).encode()})


def _fold(ent: dict | None, plain_obj: str | None) -> list:
    """Existing version stack; a pre-versioning plain entry becomes
    the S3 'null' version backed by the plain data object
    (ref: rgw null-version semantics)."""
    if ent is None or is_tomb(ent):
        return []
    if ent.get("versions") is not None:
        return ent["versions"]
    return [{"vid": "null", "size": ent["size"], "etag": ent["etag"],
             "mtime": ent["mtime"], "dm": False,
             "obj": ent.get("obj") or plain_obj}]


def _store(ctx, key: str, versions: list) -> None:
    if not versions:
        ctx.omap_rmkeys([key])
        return
    head = versions[0]
    meta = {"versions": versions, "size": head.get("size", 0),
            "etag": head.get("etag", ""), "mtime": head["mtime"],
            "dm": bool(head.get("dm"))}
    ctx.omap_set({key: json.dumps(meta).encode()})


@cls_method("rgw", "obj_store", CLS_METHOD_WR)
def obj_store(ctx, d):
    """Record a completed PUT in the index
    (ref: cls_rgw bucket_complete_op CLS_RGW_OP_ADD).

    mode "plain": unversioned entry, last writer wins per key.
    mode "enabled": push a new version onto the stack.
    mode "suspended": replace the 'null' version in place.

    Every mode writes its data to a FRESH object first and links it
    here (the reference's instance-object model); the entry this
    commit orphans comes back in "removed" so the caller can gc it —
    a plain overwrite therefore never clobbers bytes a concurrent
    reader (or a version stack that appeared meanwhile) still needs.
    """
    key, mode = d["key"], d.get("mode", "plain")
    raw = ctx.omap_get()
    ent = _load(ctx, key, raw)
    if mode == "plain":
        if ent is not None and ent.get("versions") is not None:
            # versioning got enabled (and a version committed) after
            # the caller read the bucket meta — a plain overwrite
            # would erase that stack.  Caller retries as versioned.
            raise ClsError("ECANCELED", key)
        d = dict(d, mtime=_bump_mtime(
            ent["mtime"] if ent is not None else None, d["mtime"]))
        removed = []
        # a tombstone backs no data object (its delete already gc'd
        # it) — only a live entry orphans anything
        old = (ent.get("obj") or d.get("plain_obj")) \
            if ent is not None and not is_tomb(ent) else None
        if old and old != d["obj"]:
            removed.append(old)
        ctx.omap_set({key: json.dumps(
            {"size": d["size"], "etag": d["etag"],
             "mtime": d["mtime"], "obj": d["obj"]}).encode()})
        _dl_append(ctx, d, "put", key, raw=raw, mode="plain",
                   vid=None, size=d["size"], etag=d["etag"],
                   mtime=d["mtime"])
        return {"vid": None, "removed": removed}
    versions = _fold(ent, d.get("plain_obj"))
    d = dict(d, mtime=_bump_mtime(
        versions[0]["mtime"] if versions else None, d["mtime"]))
    rec = {"vid": d["vid"], "size": d["size"], "etag": d["etag"],
           "mtime": d["mtime"], "dm": False, "obj": d["obj"]}
    removed = []
    if mode == "suspended":
        for v in versions:
            if v["vid"] == "null" and not v.get("dm") and v.get("obj") \
                    and v["obj"] != d["obj"]:
                removed.append(v["obj"])
        versions = [v for v in versions if v["vid"] != "null"]
        rec["vid"] = "null"
    elif mode != "enabled":
        raise ClsError("EINVAL", f"mode {mode}")
    _insert_version(versions, rec)
    _store(ctx, key, versions)
    _dl_append(ctx, d, "put", key, raw=raw, mode=mode,
               vid=rec["vid"], size=d["size"], etag=d["etag"],
               mtime=d["mtime"])
    return {"vid": rec["vid"], "removed": removed}


@cls_method("rgw", "obj_delete_marker", CLS_METHOD_WR)
def obj_delete_marker(ctx, d):
    """Insert a delete marker at the head of the stack (ref: rgw
    delete-marker flow, cls_rgw CLS_RGW_OP_LINK_OLH_DM).

    replace_null: drop the existing 'null' version first (Suspended
    buckets replace the null version with a null marker); its data
    object comes back in "removed".
    if_head_vid / if_mtime: optional guards — ECANCELED when the head
    changed since the caller's read (lifecycle uses them so an expiry
    decided on a stale snapshot never clobbers a fresh PUT).  BOTH are
    needed: a Suspended-bucket overwrite keeps vid "null", so only the
    mtime moves.
    """
    key = d["key"]
    raw = ctx.omap_get()
    versions = _fold(_load(ctx, key, raw), d.get("plain_obj"))
    if "if_head_vid" in d:
        head = versions[0]["vid"] if versions else None
        if head != d["if_head_vid"]:
            raise ClsError("ECANCELED", key)
    if "if_mtime" in d:
        head_mtime = versions[0]["mtime"] if versions else None
        if head_mtime != d["if_mtime"]:
            raise ClsError("ECANCELED", key)
    d = dict(d, mtime=_bump_mtime(
        versions[0]["mtime"] if versions else None, d["mtime"]))
    removed = []
    if d.get("replace_null"):
        for v in versions:
            if v["vid"] == "null" and not v.get("dm") and v.get("obj"):
                removed.append(v["obj"])
        versions = [v for v in versions if v["vid"] != "null"]
    _insert_version(versions, {"vid": d["vid"], "size": 0, "etag": "",
                               "mtime": d["mtime"], "dm": True,
                               "obj": None})
    _store(ctx, key, versions)
    _dl_append(ctx, d, "dm", key, raw=raw, vid=d["vid"],
               mtime=d["mtime"],
               replace_null=bool(d.get("replace_null")))
    return {"vid": d["vid"], "removed": removed}


@cls_method("rgw", "obj_delete_version", CLS_METHOD_WR)
def obj_delete_version(ctx, d):
    """Remove one explicit version (ref: cls_rgw
    CLS_RGW_OP_UNLINK_INSTANCE).  ENOENT when the vid isn't in the
    stack; an emptied stack removes the index entry."""
    key = d["key"]
    raw = ctx.omap_get()
    ent = _load(ctx, key, raw)
    if ent is None or is_tomb(ent):
        raise ClsError("ENOENT", key)
    versions = _fold(ent, d.get("plain_obj"))
    keep = [v for v in versions if v["vid"] != d["vid"]]
    if len(keep) == len(versions):
        raise ClsError("ENOENT", d["vid"])
    removed = [v["obj"] for v in versions
               if v["vid"] == d["vid"] and v.get("obj")
               and not v.get("dm")]
    _store(ctx, key, keep)
    _dl_append(ctx, d, "rmver", key, raw=raw, vid=d["vid"])
    return {"removed": removed}


@cls_method("rgw", "obj_delete_plain", CLS_METHOD_WR)
def obj_delete_plain(ctx, d):
    """Unversioned delete: drop the index entry (ref: cls_rgw
    CLS_RGW_OP_DEL).  ECANCELED if the entry meanwhile grew a version
    stack — the caller re-runs the versioned delete path.
    if_mtime: optional guard for lifecycle (see obj_delete_marker)."""
    key = d["key"]
    raw = ctx.omap_get()
    ent = _load(ctx, key, raw)
    if ent is None or is_tomb(ent):
        return {"removed": []}   # nothing live to delete; an existing
        # tombstone keeps its (newer-or-equal) delete stamp
    if ent.get("versions") is not None:
        raise ClsError("ECANCELED", key)
    if "if_mtime" in d and ent.get("mtime") != d["if_mtime"]:
        raise ClsError("ECANCELED", key)
    dead = ent.get("obj") or d.get("plain_obj")
    # bump past the entry's (possibly future-bumped) mtime like the
    # write paths: a wall-clock stamp could be OLDER than the head a
    # same-millisecond put left behind, and the replica's newer-wins
    # rule would then keep an object the origin dropped
    mtime = _bump_mtime(ent.get("mtime"), d.get("mtime") or now_str())
    # leave a tombstone, not an absent key: a peer's put record that
    # raced this delete must compare against the delete's mtime when
    # it arrives, or the sync apply resurrects the object
    _set_tomb(ctx, key, mtime)
    _dl_append(ctx, d, "del", key, raw=raw, mtime=mtime)
    return {"removed": [dead] if dead else []}


def _bump_mtime(existing: str | None, mtime: str) -> str:
    """Strictly-after the key's current head: sequential same-key
    writes must order by mtime even inside one millisecond, or the
    tie falls to the vid/etag break and read-your-writes fails on the
    origin.  Only LOCAL write paths bump — sync applies preserve the
    origin's stamps."""
    if existing is None or mtime > existing:
        return mtime
    base, _, frac = existing.partition(".")
    ms = int(frac.rstrip("Z") or 0) + 1
    if ms < 1000:
        return f"{base}.{ms:03d}Z"
    t = calendar.timegm(time.strptime(base, MTIME_FMT)) + 1
    return time.strftime(MTIME_FMT, time.gmtime(t)) + ".000Z"


def _insert_version(versions: list, rec: dict) -> None:
    """Place rec by (mtime, vid), newest first — ONE ordering rule
    for local writes AND sync applies.  If the origin inserted by
    arrival while replicas ordered by (mtime, vid), two writes in the
    same millisecond would stack differently per zone; sequential
    writes carry distinct millisecond mtimes, so the vid tie-break
    only ever decides genuinely concurrent pairs."""
    at = len(versions)
    for i, v in enumerate(versions):
        if (v["mtime"], v.get("vid") or "") <= \
                (rec["mtime"], rec.get("vid") or ""):
            at = i              # before the first not-newer version
            break
    versions.insert(at, rec)


def _newer(a_mtime: str, a_etag: str, b_mtime: str, b_etag: str) -> bool:
    """Deterministic cross-zone ordering: later mtime wins; equal
    mtimes (1s format resolution) tie-break on etag so BOTH zones pick
    the same winner regardless of arrival order."""
    return (a_mtime, a_etag) > (b_mtime, b_etag)


@cls_method("rgw", "obj_sync_apply", CLS_METHOD_WR)
def obj_sync_apply(ctx, d):
    """Apply one replicated mutation from a peer zone's datalog —
    idempotently and deterministically (ref: rgw_data_sync.cc's
    RGWObjFetchCR + the squash map; versioned-epoch conflict rules of
    rgw multisite).

    d: {key, op, vid, size, etag, mtime, mode, obj, log:{trace}}
    where "obj" names the LOCAL staged data object for puts (written
    by the caller before this call; unlinked staging is the caller's
    to gc when not applied).

    Rules (the convergence contract tests/test_rgw_multisite.py
    thrashes):
      * put/plain: newest (mtime, etag) wins; identical pair = the
        entry was already applied -> skip.
      * put/versioned + dm: dedupe by vid (a replay after a marker
        rewind must not duplicate a version); insert before the first
        version that is not newer, so same-second replays keep datalog
        order and stacks converge.
      * del: wins ties (on the origin the delete happened after the
        put it removed); absent entry = already applied.
      * rmver: remove if present; absent = already applied.

    Applied mutations re-log to the LOCAL datalog with the caller's
    extended trace so further zones can pull them; skipped ones do not
    (nothing changed).  Returns {"applied", "vid", "removed"}.
    """
    key, op = d["key"], d["op"]
    raw = ctx.omap_get()
    ent = _load(ctx, key, raw)
    removed: list[str] = []

    def skip():
        return {"applied": False, "vid": d.get("vid"),
                "removed": removed}

    if op == "put" and d.get("mode", "plain") == "plain":
        if ent is not None and ent.get("versions") is not None:
            return skip()       # local entry grew a version stack
        if is_tomb(ent):
            # the key was deleted here; only a put STRICTLY newer than
            # the delete may land (ties go to the delete, same rule as
            # the 'del' branch below) — this is the put-racing-
            # cross-zone-delete window the tombstone exists to close
            if not d["mtime"] > ent["mtime"]:
                return skip()
        elif ent is not None and not _newer(d["mtime"], d["etag"],
                                            ent["mtime"], ent["etag"]):
            return skip()       # local state is newer (or identical)
        if ent is not None and ent.get("obj"):
            removed.append(ent["obj"])
        ctx.omap_set({key: json.dumps(
            {"size": d["size"], "etag": d["etag"],
             "mtime": d["mtime"], "obj": d["obj"]}).encode()})
        _dl_append(ctx, d, "put", key, raw=raw, mode="plain",
                   vid=None, size=d["size"], etag=d["etag"],
                   mtime=d["mtime"])
        return {"applied": True, "vid": None, "removed": removed}

    if op == "del":
        if ent is not None and ent.get("versions") is not None:
            return skip()
        if is_tomb(ent) and not d["mtime"] > ent["mtime"]:
            return skip()       # replay, or an older delete
        if ent is not None and not is_tomb(ent) \
                and ent["mtime"] > d["mtime"]:
            return skip()       # a local write outran the delete.
            # Ties go to the delete: a same-second put-then-delete on
            # the origin replays in datalog order, and the delete must
            # win or the replica keeps an object the origin dropped.
        if ent is not None and ent.get("obj"):
            removed.append(ent["obj"])
        # write the tombstone even when the key is absent here: the
        # put this delete removed may still be in flight from a third
        # zone (or this one), and must find the delete's stamp waiting.
        # A replayed delete hit the equal-mtime tombstone skip above,
        # so every path reaching here changed state — re-log it.
        _set_tomb(ctx, key, d["mtime"])
        _dl_append(ctx, d, "del", key, raw=raw, mtime=d["mtime"])
        return {"applied": True, "vid": None, "removed": removed}

    versions = _fold(ent, None)

    if op == "rmver":
        keep = [v for v in versions if v["vid"] != d["vid"]]
        if len(keep) == len(versions):
            return skip()
        removed.extend(v["obj"] for v in versions
                       if v["vid"] == d["vid"] and v.get("obj")
                       and not v.get("dm"))
        _store(ctx, key, keep)
        _dl_append(ctx, d, "rmver", key, raw=raw, vid=d["vid"])
        return {"applied": True, "vid": d["vid"], "removed": removed}

    if op not in ("put", "dm"):
        raise ClsError("EINVAL", f"sync op {op}")

    is_dm = op == "dm"
    for v in versions:
        if v["vid"] == d["vid"] and bool(v.get("dm")) == is_dm \
                and d["vid"] != "null":
            # replayed entry: version already here.  "null" is exempt —
            # every suspended-mode overwrite reuses vid "null", so
            # presence alone cannot tell a replay from a genuinely
            # newer overwrite; the rank rule below decides those.
            return skip()
    if d["vid"] == "null" or (not is_dm and
                              d.get("mode") == "suspended"):
        # null-version semantics: at most one 'null' in the stack.
        # Winner by (mtime, dm, etag): at equal mtimes the marker
        # outranks the put (same tie rule as plain 'del' — on the
        # origin the delete happened after the put), so both zones
        # settle identically regardless of arrival order, and an
        # identical replay compares equal and skips.
        olds = [v for v in versions if v["vid"] == "null"]
        rank = (d["mtime"], is_dm, "" if is_dm else d.get("etag", ""))
        if olds and (olds[0]["mtime"], bool(olds[0].get("dm")),
                     olds[0].get("etag", "")) >= rank:
            return skip()       # local null is newer (or identical)
        removed.extend(v["obj"] for v in olds
                       if v.get("obj") and not v.get("dm"))
        versions = [v for v in versions if v["vid"] != "null"]
    rec = {"vid": d["vid"], "size": 0 if is_dm else d["size"],
           "etag": "" if is_dm else d["etag"], "mtime": d["mtime"],
           "dm": is_dm, "obj": None if is_dm else d["obj"]}
    _insert_version(versions, rec)
    _store(ctx, key, versions)
    if is_dm:
        _dl_append(ctx, d, "dm", key, raw=raw, vid=d["vid"],
                   mtime=d["mtime"])
    else:
        _dl_append(ctx, d, "put", key, raw=raw,
                   mode=d.get("mode", "enabled"), vid=d["vid"],
                   size=d["size"], etag=d["etag"], mtime=d["mtime"])
    return {"applied": True, "vid": d["vid"], "removed": removed}


@cls_method("rgw", "dl_list", CLS_METHOD_RD)
def dl_list(ctx, d):
    """List datalog entries with seq > marker (cursor-based incremental
    read; ref: rgw datalog list_entries + its marker).  Returns the
    shard head too so callers can measure lag with one call."""
    raw = ctx.omap_get()
    lo = dl_key(int(d.get("marker", 0)))
    limit = int(d.get("max", 64))
    ents = []
    # filter to datalog keys BEFORE sorting and stop at the limit:
    # this runs per shard per peer on every sync poll, and the shard's
    # omap is dominated by index entries, not log records
    for k in sorted(k for k in raw if k.startswith(DL_PREFIX)):
        if k <= lo:
            continue
        if len(ents) >= limit:
            break               # max=0 head probes return NO entries
        ents.append(json.loads(raw[k]))
    return {"entries": ents, "head": _dl_head(raw)}


@cls_method("rgw", "dl_trim", CLS_METHOD_WR)
def dl_trim(ctx, d):
    """Drop datalog entries with seq <= upto (ref: rgw datalog trim —
    driven by an admin once every peer's marker has passed them; the
    head counter survives so sequences never regress)."""
    raw = ctx.omap_get()
    upto = dl_key(int(d["upto"]))
    dead = [k for k in raw
            if k.startswith(DL_PREFIX) and k <= upto]
    if dead:
        ctx.omap_rmkeys(dead)
    return {"trimmed": len(dead)}


@cls_method("rgw", "obj_trim_noncurrent", CLS_METHOD_WR)
def obj_trim_noncurrent(ctx, d):
    """Drop noncurrent versions older than max_age_s (lifecycle
    NoncurrentVersionExpiration; ref: src/rgw/rgw_lc.cc noncurrent
    expiry).  The age test runs HERE against the committed stack, so
    two gateways' lifecycle ticks can race without double-freeing."""
    key = d["key"]
    ent = _load(ctx, key)
    if ent is None or ent.get("versions") is None:
        return {"removed": [], "dropped": 0}
    versions = ent["versions"]
    keep, removed = versions[:1], []
    for v in versions[1:]:
        if d["now"] - parse_mtime(v["mtime"]) > d["max_age_s"]:
            if v.get("obj") and not v.get("dm"):
                removed.append(v["obj"])
        else:
            keep.append(v)
    if len(keep) != len(versions):
        _store(ctx, key, keep)
    return {"removed": removed, "dropped": len(versions) - len(keep)}
