"""cls numops: atomic arithmetic on omap-stored numeric values
(ref: src/cls/numops/cls_numops.cc).

The reference class backs counters that many clients bump
concurrently (its consumer is rados striper locks / user quota
accounting): the read-modify-write happens INSIDE the OSD under the
PG lock, so two racing ``add``s both land instead of one clobbering
the other — the whole reason this is a cls method and not a client
GET/PUT.  Values live in the object's omap as decimal strings, which
keeps them readable by plain omap listings and pins the
wire-compatible representation (cls_numops.cc stores with
snprintf %lf and re-parses with strtod).

Methods (all take ``{"key": <omap key>, "value": <number>}``):

* ``add`` / ``sub`` — add or subtract; a missing key counts as 0, so
  the first add creates the counter.
* ``mul`` / ``div`` — multiply or divide; a missing key counts as 0
  (and 0 div anything stays 0); dividing BY zero is EINVAL.

A non-numeric input value is EINVAL; a stored value that does not
parse back as a number is EINVAL too (someone wrote a non-counter
into the key — clobbering it silently would destroy their data).

The port's copy of `ceph_tpu.cls.numops`, method for method.
"""
from __future__ import annotations

from . import CLS_METHOD_RD, CLS_METHOD_WR, ClsError, cls_method


def _parse_num(raw, what: str) -> float:
    """Decimal string/number -> float, EINVAL on garbage (bool is
    NOT a number here: json true/false in a counter is a caller bug,
    and int(True) silently becoming 1 would mask it)."""
    if isinstance(raw, bool):
        raise ClsError("EINVAL", f"{what} is not numeric: {raw!r}")
    if isinstance(raw, bytes):
        raw = raw.decode(errors="replace")
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise ClsError("EINVAL", f"{what} is not numeric: {raw!r}")


def _format_num(v: float) -> bytes:
    """Store integral results without a trailing '.0' so external
    omap readers (and re-parsing) see clean integers."""
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v)).encode()
    return repr(float(v)).encode()


def _apply(ctx, ind, op: str) -> dict:
    key = ind.get("key") if isinstance(ind, dict) else None
    if not key or not isinstance(key, str):
        raise ClsError("EINVAL", "numops needs a string 'key'")
    if "value" not in ind:
        raise ClsError("EINVAL", "numops needs a 'value'")
    rhs = _parse_num(ind["value"], "input value")
    try:
        omap = ctx.omap_get()
    except ClsError:
        omap = {}
    stored = omap.get(key)
    cur = 0.0 if stored is None else _parse_num(stored, "stored value")
    if op == "add":
        out = cur + rhs
    elif op == "sub":
        out = cur - rhs
    elif op == "mul":
        out = cur * rhs
    else:
        if rhs == 0:
            raise ClsError("EINVAL", "division by zero")
        out = cur / rhs
    if not ctx.exists():
        ctx.create()
    ctx.omap_set({key: _format_num(out)})
    return {"key": key, "value": out}


@cls_method("numops", "add", CLS_METHOD_RD | CLS_METHOD_WR)
def add(ctx, ind):
    """value += input (ref: cls_numops.cc add — its sub is add of
    the negation; ours is explicit)."""
    return _apply(ctx, ind, "add")


@cls_method("numops", "sub", CLS_METHOD_RD | CLS_METHOD_WR)
def sub(ctx, ind):
    return _apply(ctx, ind, "sub")


@cls_method("numops", "mul", CLS_METHOD_RD | CLS_METHOD_WR)
def mul(ctx, ind):
    """value *= input (ref: cls_numops.cc mul — its div is mul by
    the reciprocal; ours divides directly and EINVALs on zero)."""
    return _apply(ctx, ind, "mul")


@cls_method("numops", "div", CLS_METHOD_RD | CLS_METHOD_WR)
def div(ctx, ind):
    return _apply(ctx, ind, "div")
