"""rgw-lite: S3-flavored object gateway over the RADOS client
(ref: src/rgw — radosgw's REST frontend + bucket-index-on-omap
data layout, radically reduced).

The port's copy of `ceph_tpu.rgw`; `multisite` counts its own
swallowed errors (`rgw.multisite.SWALLOWED`, `SYNC_TICK_ERRORS`).

Where the reference swallows a `RadosError` (a best-effort create or
removal, a lost notification, a pusher lock that could not be renewed
or released, an expired STS credential or Swift token that could not
be removed), the port does the same and also counts each such error
whose errno is not ENOENT in `SWALLOWED`, by site
(`rgw.gateway.SWALLOWED` is the same counter).
"""
from collections import Counter

#: swallowed RadosErrors other than ENOENT, by site
SWALLOWED: Counter = Counter()


def swallow(site: str, err) -> None:
    """Count a swallowed RadosError at `site` unless it is ENOENT."""
    if err.errno_name != "ENOENT":
        SWALLOWED[site] += 1


from .gateway import RGWGateway  # noqa: E402  (gateway imports swallow)

__all__ = ["RGWGateway", "SWALLOWED"]
