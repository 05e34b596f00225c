"""Multi-device EC coding: the mesh step and the OSD-side fabric.

The port of `ceph_tpu.dist`: when chunk shards are device-resident on a
grid of devices, the k+m shard traffic of a write becomes K1 per device
plus an XOR of the partials, instead of host messages
(ref: src/osd/ECBackend.cc:2037-2070).
"""
from .fabric import ICIFabric
from .mesh_ec import MeshECCoder, make_mesh

__all__ = ["ICIFabric", "MeshECCoder", "make_mesh"]
