"""ceph_tpu_torch.serve — paged artifact store for LLM serving.

Model checkpoints and KV-cache page pools as first-class RADOS
citizens: a fixed page grid striped over epoch-versioned objects
(manifest.py), a batched parallel page-fetch wave, and per-handle
readahead policies — `checkpoint` streaming vs `kvcache` random
page gets with pin/refcount residency (store.py).  The port's copy of
`ceph_tpu.serve`: on an erasure-coded pool a degraded page read decodes
on the port's K1 inside the primary's read path.
"""
from .manifest import ArtifactManifest, ShardInfo, data_oid, \
    manifest_oid
from .store import ArtifactHandle, ArtifactStore, DEFAULT_PAGE, \
    default_layout

__all__ = [
    "ArtifactHandle", "ArtifactManifest", "ArtifactStore",
    "DEFAULT_PAGE", "ShardInfo", "data_oid", "default_layout",
    "manifest_oid",
]
