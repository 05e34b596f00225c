"""Object mutation vectors: the op bytecode of a client write.

A client write is a short ordered list of mutations applied atomically
to one object — the analogue of the reference's vector of `OSDOp`s
executed by `PrimaryLogPG::do_osd_ops` (ref: src/osd/PrimaryLogPG.cc:5770;
osd ops enumerated in src/include/rados.h CEPH_OSD_OP_*).  The backends
consume these vectors: the replicated backend turns them into one store
transaction per acting shard, the EC backend classifies them into a
data effect (at most one contiguous encode) plus metadata updates.

User-visible xattrs are stored under a `u:` key prefix so they can
never collide with the internal object-info / hash-info attrs
(the reference likewise namespaces: OI_ATTR "_", SS_ATTR "snapset",
user attrs "_<name>" — src/osd/osd_types.h OI_ATTR).

The port's copy of `ceph_tpu.osd.mutations`.
"""
from __future__ import annotations

from typing import Iterable, Mapping

# mutation op names (first tuple element)
M_WRITE = "write"              # (M_WRITE, off, data)
M_WRITEFULL = "writefull"      # (M_WRITEFULL, data)
M_APPEND = "append"            # (M_APPEND, data)
M_TRUNCATE = "truncate"        # (M_TRUNCATE, size)
M_ZERO = "zero"                # (M_ZERO, off, len)
M_DELETE = "delete"            # (M_DELETE,)
M_CREATE = "create"            # (M_CREATE,)  (existence enforced above)
M_ROLLBACK = "rollback"        # (M_ROLLBACK, clone_tag) — restore head
#                                from a snapshot clone (replicated only)
M_SETXATTRS = "setxattrs"      # (M_SETXATTRS, {name: bytes})
M_RMXATTR = "rmxattr"          # (M_RMXATTR, name)
M_OMAP_SETKEYS = "omap_setkeys"    # (M_OMAP_SETKEYS, {key: bytes})
M_OMAP_RMKEYS = "omap_rmkeys"      # (M_OMAP_RMKEYS, [key])
M_OMAP_CLEAR = "omap_clear"        # (M_OMAP_CLEAR,)
M_OMAP_SETHEADER = "omap_setheader"  # (M_OMAP_SETHEADER, bytes)

DATA_MUTATIONS = {M_WRITE, M_WRITEFULL, M_APPEND, M_TRUNCATE, M_ZERO,
                  M_ROLLBACK}
OMAP_MUTATIONS = {M_OMAP_SETKEYS, M_OMAP_RMKEYS, M_OMAP_CLEAR,
                  M_OMAP_SETHEADER}
META_MUTATIONS = {M_SETXATTRS, M_RMXATTR, M_CREATE} | OMAP_MUTATIONS

#: store-attr key prefix for user xattrs
UXATTR_PREFIX = "u:"
#: store-attr key holding the omap header blob (replicated pools only)
OMAP_HEADER_ATTR = "_oh_"


def uxattr_key(name: str) -> str:
    return UXATTR_PREFIX + name


def user_xattrs(store_attrs: Mapping[str, object]) -> dict[str, bytes]:
    """Extract the user-visible xattrs from a store attr dict."""
    n = len(UXATTR_PREFIX)
    return {k[n:]: v for k, v in store_attrs.items()
            if k.startswith(UXATTR_PREFIX)}


class MutationError(ValueError):
    def __init__(self, errno_name: str, msg: str = ""):
        self.errno_name = errno_name
        super().__init__(f"{errno_name}: {msg}" if msg else errno_name)


def _chk_off(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 0


def _chk_bytes(v) -> bool:
    return isinstance(v, (bytes, bytearray))


def _chk_kv(v) -> bool:
    return isinstance(v, Mapping) and all(
        isinstance(k, str) and _chk_bytes(x) for k, x in v.items())


#: op -> operand validators (arity enforced by length).  Wire input
#: reaches this (writev vectors come straight off the client), so a
#: malformed tuple must fail EINVAL here rather than crash the op
#: handler or write a negative size into the object info.
_MUT_SPEC = {
    M_WRITE: (_chk_off, _chk_bytes),
    M_WRITEFULL: (_chk_bytes,),
    M_APPEND: (_chk_bytes,),
    M_TRUNCATE: (_chk_off,),
    M_ZERO: (_chk_off, _chk_off),
    M_DELETE: (),
    M_CREATE: (),
    M_ROLLBACK: (_chk_off,),
    M_SETXATTRS: (_chk_kv,),
    M_RMXATTR: (lambda v: isinstance(v, str),),
    M_OMAP_SETKEYS: (_chk_kv,),
    M_OMAP_RMKEYS: (lambda v: isinstance(v, (list, tuple)) and all(
        isinstance(k, str) for k in v),),
    M_OMAP_CLEAR: (),
    M_OMAP_SETHEADER: (_chk_bytes,),
}


def validate(mutations: Iterable[tuple], ec_pool: bool) -> list[tuple]:
    """Normalize + validate a mutation vector.

    EC pools reject omap mutations (the reference's
    `pg_pool_t::supports_omap()` is false for EC pools — omap lives in
    the object store's KV backend and cannot be erasure-coded; see
    PrimaryLogPG's -EOPNOTSUPP checks on omap ops) and allow at most
    one data mutation per transaction (the RMW pipeline encodes one
    contiguous effect; the reference similarly restricts EC overwrite
    plans — ECTransaction::get_write_plan handles a single op's
    extent set).
    """
    ms = [tuple(m) for m in mutations]
    out = []
    n_data = 0
    for m in ms:
        spec = _MUT_SPEC.get(m[0]) if m else None
        if spec is None or len(m) != len(spec) + 1 or not all(
                chk(v) for chk, v in zip(spec, m[1:])):
            raise MutationError("EINVAL", f"bad mutation {m!r}")
        if m[0] in DATA_MUTATIONS:
            n_data += 1
        if ec_pool and m[0] in OMAP_MUTATIONS:
            raise MutationError(
                "EOPNOTSUPP", "erasure-coded pools do not support omap")
        if ec_pool and m[0] == M_ROLLBACK:
            raise MutationError(
                "EOPNOTSUPP",
                "snapshots are not supported on erasure-coded pools")
        if m[0] == M_DELETE and len(ms) > 1:
            raise MutationError("EINVAL", "delete must be sole mutation")
        out.append(m)
    if ec_pool and n_data > 1:
        raise MutationError(
            "EINVAL", "EC pools: one data mutation per transaction")
    return out


def is_delete(mutations: Iterable[tuple]) -> bool:
    return any(m[0] == M_DELETE for m in mutations)


def data_mutations(mutations: Iterable[tuple]) -> list[tuple]:
    return [m for m in mutations if m[0] in DATA_MUTATIONS]


def meta_mutations(mutations: Iterable[tuple]) -> list[tuple]:
    return [m for m in mutations if m[0] in META_MUTATIONS]


def meta_digest(kv: Mapping[str, bytes], hdr: bytes = b"") -> int:
    """Order-independent-input, deterministic digest of an attr/omap
    dict for scrub comparison (ref: ScrubMap::object's omap_digest /
    attr maps, src/osd/scrubber_common.h)."""
    from ..common.crc32c import crc32c
    crc = crc32c(0xFFFFFFFF, hdr)
    for k in sorted(kv):
        v = kv[k]
        if not isinstance(v, (bytes, bytearray)):
            v = repr(v).encode()
        crc = crc32c(crc, k.encode())
        crc = crc32c(crc, bytes(v))
    return int(crc)


def mutation_bytes(mutations: Iterable[tuple]) -> int:
    """Payload bytes carried by the vector (perf accounting)."""
    total = 0
    for m in mutations:
        if m[0] in (M_WRITEFULL, M_APPEND):
            total += len(m[1])
        elif m[0] == M_WRITE:
            total += len(m[2])
    return total
