"""OSD-layer core types: placement groups and pools.

Python rendering of the reference's osd_types (ref: src/osd/osd_types.h,
osd_types.cc) limited to the placement math the framework needs:
pg_t, pg_pool_t with pg/pgp masks, the stable-mod seed folding
(src/include/rados.h:86), the object-name string hashes
(src/common/ceph_hash.cc), and pps seed derivation
(pg_pool_t::raw_pg_to_pps, src/osd/osd_types.cc:1650).

`pg_from_reference` and `pool_from_reference` copy a PG or pool of another
package (the JAX reference's, in the tests) by attribute.  `PG` is a wire
struct under the reference's name and version; `PGPool` is not.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..crush.hashes import hash32_2

# pool types (osd_types.h pg_pool_t::TYPE_*)
POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3

# pg_pool_t flags (osd_types.h)
FLAG_HASHPSPOOL = 1 << 0

# object hash algorithms (src/include/rados.h CEPH_STR_HASH_*)
CEPH_STR_HASH_LINUX = 1
CEPH_STR_HASH_RJENKINS = 2

_U32 = 0xFFFFFFFF


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulo for non-power-of-2 pg counts (rados.h:86-92)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def cbits(v: int) -> int:
    """Number of significant bits (intarith.h cbits)."""
    return v.bit_length()


def _mix32(a: int, b: int, c: int) -> tuple[int, int, int]:
    # rjenkins mix on plain ints (ceph_hash.cc mix macro)
    a = (a - b - c) & _U32; a ^= c >> 13
    b = (b - c - a) & _U32; b ^= (a << 8) & _U32
    c = (c - a - b) & _U32; c ^= b >> 13
    a = (a - b - c) & _U32; a ^= c >> 12
    b = (b - c - a) & _U32; b ^= (a << 16) & _U32
    c = (c - a - b) & _U32; c ^= b >> 5
    a = (a - b - c) & _U32; a ^= c >> 3
    b = (b - c - a) & _U32; b ^= (a << 10) & _U32
    c = (c - a - b) & _U32; c ^= b >> 15
    return a, b, c


def ceph_str_hash_rjenkins(data: bytes) -> int:
    """Robert Jenkins string hash (ceph_hash.cc:22-78)."""
    length = len(data)
    a = 0x9E3779B9
    b = a
    c = 0
    k = 0
    ln = length
    while ln >= 12:
        a = (a + (data[k] | data[k + 1] << 8 | data[k + 2] << 16 |
                  data[k + 3] << 24)) & _U32
        b = (b + (data[k + 4] | data[k + 5] << 8 | data[k + 6] << 16 |
                  data[k + 7] << 24)) & _U32
        c = (c + (data[k + 8] | data[k + 9] << 8 | data[k + 10] << 16 |
                  data[k + 11] << 24)) & _U32
        a, b, c = _mix32(a, b, c)
        k += 12
        ln -= 12
    c = (c + length) & _U32
    # the last 11 bytes; all cases fall through
    if ln >= 11:
        c = (c + (data[k + 10] << 24)) & _U32
    if ln >= 10:
        c = (c + (data[k + 9] << 16)) & _U32
    if ln >= 9:
        c = (c + (data[k + 8] << 8)) & _U32
    if ln >= 8:
        b = (b + (data[k + 7] << 24)) & _U32
    if ln >= 7:
        b = (b + (data[k + 6] << 16)) & _U32
    if ln >= 6:
        b = (b + (data[k + 5] << 8)) & _U32
    if ln >= 5:
        b = (b + data[k + 4]) & _U32
    if ln >= 4:
        a = (a + (data[k + 3] << 24)) & _U32
    if ln >= 3:
        a = (a + (data[k + 2] << 16)) & _U32
    if ln >= 2:
        a = (a + (data[k + 1] << 8)) & _U32
    if ln >= 1:
        a = (a + data[k]) & _U32
    _, _, c = _mix32(a, b, c)
    return c


def ceph_str_hash_linux(data: bytes) -> int:
    """Linux dcache hash (ceph_hash.cc:82-92)."""
    h = 0
    for ch in data:
        h = ((h + (ch << 4) + (ch >> 4)) * 11) & _U32
    return h


def ceph_str_hash(hash_type: int, data: bytes) -> int:
    if hash_type == CEPH_STR_HASH_RJENKINS:
        return ceph_str_hash_rjenkins(data)
    if hash_type == CEPH_STR_HASH_LINUX:
        return ceph_str_hash_linux(data)
    raise ValueError(f"unknown str hash {hash_type}")


@dataclass(frozen=True, order=True)
class PG:
    """pg_t: (pool id, placement seed) (osd_types.h struct pg_t);
    ordered like the reference's operator< (pool, then seed)."""
    pool: int
    ps: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.ps:x}"


@dataclass
class PGPool:
    """pg_pool_t (osd_types.h:1261): the placement-relevant subset."""
    type: int = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    crush_rule: int = 0
    object_hash: int = CEPH_STR_HASH_RJENKINS
    pg_num: int = 64
    pgp_num: int = 64
    flags: int = FLAG_HASHPSPOOL
    erasure_code_profile: str = ""
    # pool snapshots (ref: pg_pool_t::snap_seq/snaps/removed_snaps,
    # osd_types.h:1331-1340): snap_seq is the newest snapid; snaps
    # maps live snapid -> name; removed_snaps keeps deleted ids out of
    # every future SnapContext (a lagging client must not resurrect a
    # deleted snapshot through the snapc union)
    snap_seq: int = 0
    snaps: dict = field(default_factory=dict)
    removed_snaps: list = field(default_factory=list)  # JSON-safe ids
    # derived
    pg_num_mask: int = field(default=0, repr=False)
    pgp_num_mask: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        self.calc_pg_masks()

    def calc_pg_masks(self) -> None:
        """osd_types.cc:1468-1472."""
        self.pg_num_mask = (1 << cbits(self.pg_num - 1)) - 1
        self.pgp_num_mask = (1 << cbits(self.pgp_num - 1)) - 1

    def can_shift_osds(self) -> bool:
        """Replicated pools compact holes; EC pools are positional
        (osd_types.h:1581-1590)."""
        return self.type == POOL_TYPE_REPLICATED

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def is_replicated(self) -> bool:
        return self.type == POOL_TYPE_REPLICATED

    def hash_key(self, key: str, nspace: str = "") -> int:
        """osd_types.cc:1618-1629 (ns + 0x1f separator + key)."""
        if not nspace:
            return ceph_str_hash(self.object_hash, key.encode())
        buf = nspace.encode() + b"\x1f" + key.encode()
        return ceph_str_hash(self.object_hash, buf)

    def raw_pg_to_pg(self, pg: PG) -> PG:
        """Fold full-precision ps into [0, pg_num)
        (osd_types.cc:1639-1643)."""
        return PG(pg.pool, ceph_stable_mod(pg.ps, self.pg_num,
                                           self.pg_num_mask))

    def raw_pg_to_pps(self, pg: PG) -> int:
        """Placement seed: mix pool id so pools don't overlap
        (osd_types.cc:1650-1666)."""
        if self.flags & FLAG_HASHPSPOOL:
            return int(hash32_2(
                ceph_stable_mod(pg.ps, self.pgp_num, self.pgp_num_mask),
                pg.pool))
        return ceph_stable_mod(pg.ps, self.pgp_num,
                               self.pgp_num_mask) + pg.pool

    def raw_pg_to_pps_batch(self, pss: np.ndarray, pool_id: int) -> np.ndarray:
        """Vectorized raw_pg_to_pps over many placement seeds."""
        pss = np.asarray(pss, dtype=np.int64)
        masked = pss & self.pgp_num_mask
        folded = np.where(masked < self.pgp_num, masked,
                          pss & (self.pgp_num_mask >> 1))
        if self.flags & FLAG_HASHPSPOOL:
            return hash32_2(folded, np.full_like(folded, pool_id)) \
                .astype(np.int64)
        return folded + pool_id


_POOL_FIELDS = ("type", "size", "min_size", "crush_rule", "object_hash",
                "pg_num", "pgp_num", "flags", "erasure_code_profile",
                "snap_seq")


def pg_from_reference(obj) -> PG:
    return PG(int(obj.pool), int(obj.ps))


def pool_from_reference(obj) -> PGPool:
    """A PGPool equal field for field to `obj` (masks recomputed)."""
    pool = PGPool(**{name: getattr(obj, name) for name in _POOL_FIELDS})
    pool.snaps = dict(obj.snaps)
    pool.removed_snaps = list(obj.removed_snaps)
    return pool


# wire registration (ref: pg_t / pg_pool_t encode in osd_types.cc)
from ..msg.encoding import register_struct as _reg  # noqa: E402

_reg(PG, version=1, compat=1)
_reg(PGPool, version=1, compat=1)
