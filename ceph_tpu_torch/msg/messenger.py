"""Messenger core, as far as the EC data plane needs it: the entity name
and the typed message base.

Shapes mirrored from the reference (ref: src/msg/Message.h).  The port's
copy of the `Message` base and the `EntityName` alias of
`ceph_tpu.msg.messenger`; the dispatcher and the transports are not
ported yet, so a caller wires shards to the backend directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

EntityName = str      # "osd.3", "mon.0", "client.4121"


@dataclass
class Message:
    """Base wire message.  Subclasses add payload fields
    (ref: src/msg/Message.h; one subclass per type like src/messages/)."""
    # filled in by the transport on send:
    src: EntityName = field(default="", compare=False)
    seq: int = field(default=0, compare=False)
    # cephx message signature (ticket + hmac), attached by the
    # sender's auth handler when auth is enabled
    # (ref: Message signing under session keys, msgr v2)
    auth: Optional[dict] = field(default=None, compare=False)
    # blkin-style trace context riding the message
    # (ref: Message.h:263 ZTracer::Trace trace)
    trace: Optional[dict] = field(default=None, compare=False)

    @property
    def type_name(self) -> str:
        return type(self).__name__
