"""Transport layer — the Messenger analogue (ref: src/msg/).

The port's copy of `ceph_tpu.msg` for the in-process cluster: the
versioned TLV codec and frame (`encoding`), the message base, dispatch
and the `LocalNetwork` transport (`messenger`), the rule-free fault
plane it delivers through (`faults`), the typed messages (`messages`)
and mon-session failover (`mon_client`).  The TCP transport is not
ported yet.
"""
from .messenger import (Connection, Dispatcher, EntityName, LocalNetwork,
                        Message, Messenger)

__all__ = ["Connection", "Dispatcher", "EntityName", "LocalNetwork",
           "Message", "Messenger"]
