"""cls refcount: tag-set reference counting used by rgw object dedup
(ref: src/cls/refcount/cls_refcount.cc).  The ref set lives in a
`refcount` xattr; a `put` that empties the set removes the object —
exactly the reference's behavior (cls_rc_refcount_put ->
cls_cxx_remove when refs drain).

The port's copy of `ceph_tpu.cls.refcount`, method for method.
"""
from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, cls_method

_ATTR = "refcount"


def _load(ctx) -> list[str]:
    try:
        return json.loads(ctx.getxattr(_ATTR))
    except ClsError:
        return []


@cls_method("refcount", "get", CLS_METHOD_RD | CLS_METHOD_WR)
def get(ctx, ind):
    """Add a tag ref (ref: cls_rc_refcount_get).  Idempotent unless
    the reference allows duplicates — it does not for implicit refs."""
    refs = _load(ctx)
    tag = ind["tag"]
    if tag not in refs:
        refs.append(tag)
    ctx.setxattr(_ATTR, json.dumps(refs).encode())
    return None


@cls_method("refcount", "put", CLS_METHOD_RD | CLS_METHOD_WR)
def put(ctx, ind):
    """Drop a tag ref; removing the last ref removes the object
    (ref: cls_rc_refcount_put)."""
    refs = _load(ctx)
    tag = ind["tag"]
    if tag not in refs:
        # unknown tag: treated as already-dropped (the reference
        # tolerates this unless implicit_ref accounting says otherwise)
        return None
    refs.remove(tag)
    if refs:
        ctx.setxattr(_ATTR, json.dumps(refs).encode())
    else:
        ctx.remove()
    return None


@cls_method("refcount", "set", CLS_METHOD_WR)
def set_(ctx, ind):
    """(ref: cls_rc_refcount_set)."""
    ctx.setxattr(_ATTR, json.dumps(list(ind["refs"])).encode())
    return None


@cls_method("refcount", "read", CLS_METHOD_RD)
def read(ctx, ind):
    """(ref: cls_rc_refcount_read)."""
    return {"refs": _load(ctx)}
