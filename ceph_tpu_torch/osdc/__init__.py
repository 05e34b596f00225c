"""Client-side object compute: striping and the object cache (ref:
src/osdc/).  The port's copy of `ceph_tpu.osdc` without
`rados_striper` (it needs xattrs, which the port's librados lacks)."""
from .striper import ObjectExtent, StripeLayout, Striper

__all__ = ["Striper", "StripeLayout", "ObjectExtent"]
