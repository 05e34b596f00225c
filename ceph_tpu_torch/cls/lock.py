"""cls lock: cooperative object locks (ref: src/cls/lock/cls_lock.cc;
types src/cls/lock/cls_lock_types.h).

Lock state lives in a `lock.<name>` xattr as JSON:
{"type": "exclusive"|"shared", "lockers": {"client/cookie": {...}}} —
the reference stores the same map in an object attr keyed
`lock.<name>` (cls_lock.cc lock_obj / ATTR_PREFIX).

The port's copy of `ceph_tpu.cls.lock`, method for method.
"""
from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, cls_method

LOCK_EXCLUSIVE = "exclusive"
LOCK_SHARED = "shared"

_ATTR_PREFIX = "lock."


def _key(client: str, cookie: str) -> str:
    return f"{client}/{cookie}"


def _load(ctx, name: str) -> dict:
    try:
        return json.loads(ctx.getxattr(_ATTR_PREFIX + name))
    except ClsError:
        return {"type": "", "lockers": {}}


def _store(ctx, name: str, st: dict) -> None:
    ctx.setxattr(_ATTR_PREFIX + name, json.dumps(st).encode())


@cls_method("lock", "lock", CLS_METHOD_RD | CLS_METHOD_WR)
def lock(ctx, ind):
    """(ref: cls_lock.cc lock_op/lock_obj).  ind: {name, type, cookie,
    client, desc?}.  Exclusive excludes everyone else; shared excludes
    exclusive.  Re-lock by the same (client, cookie) renews."""
    name, typ = ind["name"], ind.get("type", LOCK_EXCLUSIVE)
    if typ not in (LOCK_EXCLUSIVE, LOCK_SHARED):
        raise ClsError("EINVAL", f"lock type {typ}")
    st = _load(ctx, name)
    me = _key(ind["client"], ind.get("cookie", ""))
    others = [k for k in st["lockers"] if k != me]
    if others and (typ == LOCK_EXCLUSIVE or
                   st["type"] == LOCK_EXCLUSIVE):
        raise ClsError("EBUSY", f"lock {name} held")
    if not ctx.exists():
        ctx.create()
    st["type"] = typ
    st["lockers"][me] = {"desc": ind.get("desc", ""),
                         "client": ind["client"],
                         "cookie": ind.get("cookie", "")}
    _store(ctx, name, st)
    return None


@cls_method("lock", "unlock", CLS_METHOD_RD | CLS_METHOD_WR)
def unlock(ctx, ind):
    """(ref: cls_lock.cc unlock_op)."""
    name = ind["name"]
    st = _load(ctx, name)
    me = _key(ind["client"], ind.get("cookie", ""))
    if me not in st["lockers"]:
        raise ClsError("ENOENT", f"not locker of {name}")
    del st["lockers"][me]
    if not st["lockers"]:
        st["type"] = ""
    _store(ctx, name, st)
    return None


@cls_method("lock", "break_lock", CLS_METHOD_RD | CLS_METHOD_WR)
def break_lock(ctx, ind):
    """Forcibly evict another client's locker
    (ref: cls_lock.cc break_lock)."""
    name = ind["name"]
    st = _load(ctx, name)
    victim = _key(ind["locker"], ind.get("cookie", ""))
    if victim not in st["lockers"]:
        raise ClsError("ENOENT", f"{victim} does not hold {name}")
    del st["lockers"][victim]
    if not st["lockers"]:
        st["type"] = ""
    _store(ctx, name, st)
    return None


@cls_method("lock", "get_info", CLS_METHOD_RD)
def get_info(ctx, ind):
    """(ref: cls_lock.cc get_info)."""
    st = _load(ctx, ind["name"])
    return {"type": st["type"] or None,
            "lockers": list(st["lockers"].values())}


@cls_method("lock", "list_locks", CLS_METHOD_RD)
def list_locks(ctx, ind):
    """All lock names on the object (ref: cls_lock.cc list_locks)."""
    return sorted(k[len(_ATTR_PREFIX):] for k in ctx.getxattrs()
                  if k.startswith(_ATTR_PREFIX))
