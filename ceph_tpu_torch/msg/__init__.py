"""Wire encoding and the messages of the EC data plane (ref: src/msg/).

The port's copy of the parts of `ceph_tpu.msg` that the EC placement
group uses: the versioned TLV codec and frame (`encoding`), the message
base (`messenger.Message`) and the four EC sub-op messages
(`messages`).
"""
from .messenger import EntityName, Message

__all__ = ["EntityName", "Message"]
