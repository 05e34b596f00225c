"""cls queue: an ordered, persistent FIFO on one RADOS object.

The reference's persistent bucket notifications ride a rados-backed
queue maintained by cls methods (ref: src/cls/queue/cls_queue.cc,
src/cls/2pc_queue — rgw_pubsub's persistent topics enqueue there and
a pusher drains it).  Here the queue is the object's omap: the header
carries [head, next) — the live contiguous sequence range — entries
live under zero-padded sequence keys, and enqueue allocates the
sequence inside the OSD, so concurrent producers (two gateways
publishing to one topic) can never collide or reorder.

Because the live range is contiguous, list and remove address entries
by GENERATED keys instead of scanning/sorting the whole backlog.
Honest limit: MethodContext exposes only a full omap_get, so the read
side still materializes the backlog dict once per list call (an
in-memory copy, no per-key decode/sort); remove is O(acked range).
A ranged omap read in the object store would finish the job.

The port's copy of `ceph_tpu.cls.queue`, method for method.
"""
from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, cls_method

_SEQ_W = 16      # zero-pad width; omap lexical order == numeric order


def _seq_key(seq: int) -> str:
    return f"{seq:0{_SEQ_W}d}"


def _header(ctx) -> dict:
    raw = ctx.omap_get_header()
    hdr = json.loads(raw) if raw else {}
    hdr.setdefault("next", 0)
    hdr.setdefault("head", 0)
    return hdr


@cls_method("queue", "enqueue", CLS_METHOD_WR)
def enqueue(ctx, d):
    """Append entries; returns the first sequence assigned
    (ref: cls_queue_enqueue)."""
    hdr = _header(ctx)
    first = hdr["next"]
    kv = {}
    for i, data in enumerate(d["entries"]):
        kv[_seq_key(first + i)] = (data if isinstance(data, bytes)
                                   else str(data).encode())
    hdr["next"] = first + len(d["entries"])
    ctx.omap_set(kv)
    ctx.omap_set_header(json.dumps(hdr).encode())
    return {"first": first}


@cls_method("queue", "list", CLS_METHOD_RD)
def list_entries(ctx, d):
    """Entries from sequence max(`start`, head), up to `max` of them,
    in order (ref: cls_queue_list_entries)."""
    hdr = _header(ctx)
    start = max(int(d.get("start", 0)), hdr["head"])
    limit = int(d.get("max", 128))
    om = ctx.omap_get()
    out = []
    for seq in range(start, min(hdr["next"], start + limit)):
        data = om.get(_seq_key(seq))
        if data is not None:
            out.append({"seq": seq, "data": data})
    return {"entries": out, "next": hdr["next"], "head": hdr["head"]}


@cls_method("queue", "remove", CLS_METHOD_WR)
def remove(ctx, d):
    """Ack entries with sequence < `upto` (ref:
    cls_queue_remove_entries — the consumer trims what it delivered).
    Keys are generated from the contiguous [head, upto) range, never
    scanned."""
    hdr = _header(ctx)
    upto = min(int(d["upto"]), hdr["next"])
    dead = [_seq_key(s) for s in range(hdr["head"], upto)]
    if dead:
        ctx.omap_rmkeys(dead)
        hdr["head"] = upto
        ctx.omap_set_header(json.dumps(hdr).encode())
    return {"removed": len(dead)}
