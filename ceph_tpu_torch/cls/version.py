"""cls version: object version gating used by rgw metadata
(ref: src/cls/version/cls_version.cc).  Version in a `cls_version`
xattr; conditional ops fail ECANCELED on mismatch like the
reference's VER_COND checks.

The port's copy of `ceph_tpu.cls.version`, method for method.
"""
from __future__ import annotations

import json

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, cls_method

_ATTR = "cls_version"


def _load(ctx) -> dict:
    try:
        return json.loads(ctx.getxattr(_ATTR))
    except ClsError:
        return {"ver": 0, "tag": ""}


def _store(ctx, v: dict) -> None:
    ctx.setxattr(_ATTR, json.dumps(v).encode())


@cls_method("version", "set", CLS_METHOD_WR)
def set_(ctx, ind):
    """(ref: cls_version.cc cls_version_set)."""
    _store(ctx, {"ver": int(ind["ver"]), "tag": ind.get("tag", "")})
    return None


@cls_method("version", "inc", CLS_METHOD_RD | CLS_METHOD_WR)
def inc(ctx, ind):
    """Bump; with `cond`+`ver` given, gate first
    (ref: cls_version_inc_conds)."""
    v = _load(ctx)
    if "cond" in ind:
        _check(v, ind)
    v["ver"] += 1
    _store(ctx, v)
    return None


@cls_method("version", "read", CLS_METHOD_RD)
def read(ctx, ind):
    """(ref: cls_version_read)."""
    return _load(ctx)


@cls_method("version", "check", CLS_METHOD_RD)
def check(ctx, ind):
    """Fail ECANCELED unless the stored version satisfies the
    condition (ref: cls_version.cc cls_version_check)."""
    _check(_load(ctx), ind)
    return None


def _check(v: dict, ind) -> None:
    ver, cond = int(ind["ver"]), ind.get("cond", "eq")
    ok = {"eq": v["ver"] == ver, "gt": v["ver"] > ver,
          "ge": v["ver"] >= ver}.get(cond)
    if ok is None:
        raise ClsError("EINVAL", f"cond {cond}")
    if not ok:
        raise ClsError("ECANCELED",
                       f"version {v['ver']} fails {cond} {ver}")
