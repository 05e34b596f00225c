"""Typed wire messages of the EC data plane (ref: src/messages/).

The port's copy of the four EC sub-op messages of
`ceph_tpu.msg.messages`, registered as the reference registers them: the
same wire names, versions and field order, so a frame written by either
package decodes in the other.  The other message types are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .messenger import Message

# ---------------------------------------------------------------- osd/EC


@dataclass
class ECSubWrite(Message):
    """Per-shard EC write (ref: src/messages/MOSDECSubOpWrite.h,
    payload struct src/osd/ECMsgTypes.h ECSubWrite).

    v2 appends the ICI-fabric fields: when `fabric_key` is set the
    chunk bytes are NOT in `txn` — they sit staged on the shared
    device mesh and the receiving shard gathers its slice locally
    (ceph_tpu.dist.fabric; the message is control-plane only)."""
    pgid: Any = None
    tid: int = 0
    reqid: Any = None
    at_version: Any = None
    trim_to: Any = None
    txn: Any = None                 # store Transaction for this shard
    log_entries: list = field(default_factory=list)
    shard: int = -1
    # --- v2: device-mesh fabric fan-out ---
    oid: str = ""
    fabric_key: Any = None          # (pgid, tid) staging key
    chunk_off: int = 0              # chunk-space write offset
    hinfo_append: bool = False      # cumulative crc append is valid
    # --- v3: recovery-push version guard — the receiving shard skips
    # the txn (ack success) when its local copy of `oid` is already
    # STRICTLY newer: a backfill push planned before a client write
    # landed must not roll the chunk back (ref: the last_backfill
    # ordering guarantee this guard replaces)
    guard_version: Any = None       # (epoch, version) or None


@dataclass
class ECSubWriteReply(Message):
    """(ref: src/messages/MOSDECSubOpWriteReply.h, ECMsgTypes.h
    ECSubWriteReply)."""
    pgid: Any = None
    tid: int = 0
    shard: int = -1
    committed: bool = True


@dataclass
class ECSubRead(Message):
    """Per-shard chunk read request (ref: src/messages/MOSDECSubOpRead.h,
    ECMsgTypes.h ECSubRead: to_read offset/len lists + attrs_to_read).

    v2 appends the sub-chunk repair fields: `subchunks` maps oid ->
    [(rel_off, rel_len), ...] byte extents WITHIN each chunk_size-sized
    chunk of the shard's stream (ref: ECMsgTypes.h ECSubRead subchunks,
    the clay repair-plane reads of ErasureCodeClay.cc:364).  The shard
    expands the per-chunk extents across its local stream length and
    replies with the CONCATENATED repair planes — a single-shard
    regenerating-code rebuild ships ~(k+m-1)/m x less data than whole
    chunks.  Empty dict = whole-range semantics via `to_read`."""
    pgid: Any = None
    tid: int = 0
    shard: int = -1
    to_read: list = field(default_factory=list)   # [(oid, off, len)]
    attrs_to_read: list = field(default_factory=list)  # [oid]
    # --- v2: sub-chunk (repair-plane) extents ---
    subchunks: dict = field(default_factory=dict)  # oid -> [(off, len)]
    chunk_size: int = 0      # chunk stride the extents repeat at


@dataclass
class ECSubReadReply(Message):
    """(ref: src/messages/MOSDECSubOpReadReply.h)."""
    pgid: Any = None
    tid: int = 0
    shard: int = -1
    buffers_read: dict = field(default_factory=dict)  # oid -> bytes|None
    attrs_read: dict = field(default_factory=dict)    # oid -> attrs|None
    errors: dict = field(default_factory=dict)        # oid -> errno str


# ------------------------------------------------- wire registration
#: per-type (version, compat) — bump when appending fields (ref: each
#: src/messages/*.h declares HEAD_VERSION/COMPAT_VERSION)
_VERSIONS: dict[str, tuple[int, int]] = {
    "ECSubWrite": (3, 1),       # v2: ICI-fabric; v3: push version guard
    "ECSubRead": (2, 1),        # v2: sub-chunk repair extents
}


def _register_all() -> None:
    import dataclasses as _dc

    from .encoding import register_struct
    for _obj in list(globals().values()):
        if isinstance(_obj, type) and issubclass(_obj, Message) and \
                _dc.is_dataclass(_obj):
            v, compat = _VERSIONS.get(_obj.__name__, (1, 1))
            register_struct(_obj, version=v, compat=compat)


_register_all()
