"""Client-side object compute: striping, the striped-object API
(`rados_striper`) and the object cache (ref: src/osdc/).  The port's
copy of `ceph_tpu.osdc`."""
from .striper import ObjectExtent, StripeLayout, Striper

__all__ = ["Striper", "StripeLayout", "ObjectExtent"]
