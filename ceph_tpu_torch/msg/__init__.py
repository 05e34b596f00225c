"""Transport layer — the Messenger analogue (ref: src/msg/).

The port's copy of `ceph_tpu.msg`: the versioned TLV codec and frame
(`encoding`), the message base, dispatch and the `LocalNetwork`
transport (`messenger`), the seeded fault plane both transports deliver
through (`faults`), the typed messages (`messages`), mon-session
failover (`mon_client`), and the TCP transport with its secure mode
(`tcp`, `secure`).
"""
from .messenger import (Connection, Dispatcher, EntityName, LocalNetwork,
                        Message, Messenger)

__all__ = ["Connection", "Dispatcher", "EntityName", "LocalNetwork",
           "Message", "Messenger"]
