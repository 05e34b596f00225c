"""cls log: omap-backed time-indexed log object class
(ref: src/cls/log/cls_log.cc).

The reference's rgw metadata/data logs and the mon's timecheck
history all ride this class: entries land in an object's omap keyed
``1_<sec>.<usec>_<counter>`` so lexicographic omap order IS time
order; ``add`` appends (a per-call counter disambiguates same-stamp
entries exactly like cls_log.cc's ``index_time_prefix`` + unique
suffix), ``list`` pages forward from a time bound or an opaque
marker, ``trim`` drops a time range or everything up to a marker.
The max_entries page cap mirrors MAX_TRIM_ENTRIES/list bounds so one
call can neither return nor delete an unbounded batch.

The port's copy of `ceph_tpu.cls.log`, method for method.
"""
from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, cls_method

#: omap key prefix for log entries (ref: cls_log.cc LOG_INDEX_PREFIX
#: "1_")
_PREFIX = "1_"
#: header key carrying the allocation counter (kept out of the entry
#: namespace — "0" sorts before every "1_" key)
_HEADER = "0_header"

#: page/trim bound per call (ref: cls_log.cc MAX_TRIM_ENTRIES; list
#: clamps to 1000 in the reference's callers)
MAX_ENTRIES = 1000


def _key(ts: float, counter: int) -> str:
    """Zero-padded so lexicographic omap order is (time, counter)
    order (ref: cls_log.cc get_index_time_prefix's %010ld.%06ld)."""
    sec = int(ts)
    usec = int(round((ts - sec) * 1_000_000))
    if usec >= 1_000_000:
        # a stamp within 0.5us below a whole second rounds UP: carry
        # into sec, or the 7-digit usec field would sort BEFORE every
        # 6-digit one and break the time-order invariant
        sec += 1
        usec = 0
    return f"{_PREFIX}{sec:010d}.{usec:06d}_{counter:010d}"


def _load_header(ctx) -> dict:
    try:
        raw = ctx.omap_get_header()
    except ClsError:
        raw = b""
    if not raw:
        return {"counter": 0}
    return json.loads(raw)


def _entries(ctx) -> dict:
    try:
        omap = ctx.omap_get()
    except ClsError:
        return {}
    return {k: v for k, v in omap.items() if k.startswith(_PREFIX)}


@cls_method("log", "add", CLS_METHOD_RD | CLS_METHOD_WR)
def add(ctx, ind):
    """Append entries (ref: cls_log.cc cls_log_add).  ``entries`` is
    a list of {timestamp, section, name, data}; each gets a unique
    monotonic key even when timestamps collide."""
    entries = ind.get("entries")
    if entries is None and "entry" in ind:
        entries = [ind["entry"]]
    if not isinstance(entries, list) or not entries:
        raise ClsError("EINVAL", "log add needs 'entries'")
    hdr = _load_header(ctx)
    kv: dict[str, bytes] = {}
    for e in entries:
        try:
            ts = float(e["timestamp"])
        except (KeyError, TypeError, ValueError):
            raise ClsError("EINVAL", "entry needs a numeric timestamp")
        hdr["counter"] += 1
        rec = {"timestamp": ts,
               "section": str(e.get("section", "")),
               "name": str(e.get("name", "")),
               "data": str(e.get("data", ""))}
        kv[_key(ts, hdr["counter"])] = json.dumps(rec).encode()
    if not ctx.exists():
        ctx.create()
    ctx.omap_set(kv)
    ctx.omap_set_header(json.dumps(hdr).encode())
    return None


@cls_method("log", "list", CLS_METHOD_RD)
def list_(ctx, ind):
    """Page entries in time order (ref: cls_log.cc cls_log_list).

    ``from_time``/``to_time`` bound the window (to_time exclusive,
    like the reference's to_index upper bound); ``marker`` resumes a
    paged listing after that opaque key; ``max_entries`` caps the
    page.  Returns {entries, marker, truncated}: ``marker`` is the
    resume cursor when ``truncated`` is set."""
    maxe = min(int(ind.get("max_entries", MAX_ENTRIES)), MAX_ENTRIES)
    if maxe <= 0:
        raise ClsError("EINVAL", "max_entries must be positive")
    lo = _key(float(ind["from_time"]), 0) \
        if "from_time" in ind else _PREFIX
    hi = _key(float(ind["to_time"]), 0) \
        if "to_time" in ind else None
    marker = str(ind.get("marker", ""))
    if marker:
        lo = None           # marker supersedes the time lower bound
    out = []
    truncated = False
    last = ""
    entries = _entries(ctx)
    for k in sorted(entries):
        if marker and k <= marker:
            continue
        if lo is not None and k < lo:
            continue
        if hi is not None and k >= hi:
            break
        if len(out) == maxe:
            truncated = True
            break
        rec = json.loads(entries[k])
        rec["id"] = k
        out.append(rec)
        last = k
    return {"entries": out, "marker": last if truncated else "",
            "truncated": truncated}


@cls_method("log", "trim", CLS_METHOD_RD | CLS_METHOD_WR)
def trim(ctx, ind):
    """Drop entries by time range or up to a marker (ref: cls_log.cc
    cls_log_trim).  At most MAX_ENTRIES go per call — the caller
    repeats until it stops returning trimmed > 0, exactly how the
    reference re-enters until -ENODATA."""
    to_marker = str(ind.get("to_marker", ""))
    from_time = float(ind.get("from_time", 0.0))
    has_window = "to_time" in ind or to_marker
    if not has_window:
        raise ClsError("EINVAL", "log trim needs to_time or to_marker")
    hi = _key(float(ind["to_time"]), 0) if "to_time" in ind else None
    lo = _key(from_time, 0)
    doomed = []
    for k in sorted(_entries(ctx)):
        if k < lo:
            continue
        if to_marker:
            if k > to_marker:
                break
        elif hi is not None and k >= hi:
            break
        doomed.append(k)
        if len(doomed) == MAX_ENTRIES:
            break
    if doomed:
        ctx.omap_rmkeys(doomed)
    return {"trimmed": len(doomed)}


@cls_method("log", "info", CLS_METHOD_RD)
def info(ctx, ind):
    """Head summary (ref: cls_log.cc cls_log_info): the allocation
    counter plus first/last entry keys — the cheap "how far along is
    this log" probe trim loops use."""
    hdr = _load_header(ctx)
    keys = sorted(_entries(ctx))
    return {"counter": hdr.get("counter", 0),
            "entries": len(keys),
            "first": keys[0] if keys else "",
            "last": keys[-1] if keys else ""}
