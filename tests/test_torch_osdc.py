"""The port's striper and ObjectCacher (`ceph_tpu_torch.osdc`) held to the
reference's (`ceph_tpu.osdc`) at tolerance 0.

Striper: tests/test_compressor_striper.py's two striper cases, with the
same `random.Random(1234)` layouts and ranges on both sides; every
extent list and every inverse map is equal, and the reference's
round-trip properties hold on the port's.

RadosStriper: tests/test_compressor_striper.py's `test_rados_striper` on
a replicated pool of each package's pump-mode MiniCluster (4 OSDs,
pg_num 8, the port's on `device="cpu"`): every read, the stat, the
listed RADOS objects, each object's bytes and xattrs on its primary,
and the removal; and an EC pool of the port's holds the same striped
object's bytes (object 0's layout and size ride xattrs, which EC pools
keep too).

ObjectCacher: every case of tests/test_object_cacher.py except the two
that mount it under rbd and cephfs.  The rbd case has its counterpart
in tests/test_torch_rbd.py (`test_rbd_sequential_write_ops_reduction`);
the cephfs case runs here on both packages' threaded clusters (the
harness of tests/test_torch_cephfs.py, which compares the replies and
both file system pools).  Each
case runs against a recording in-memory backing, once over each
package's cacher: the test compares the bytes every call returned, the
backing's log of reads, writes and batched waves (in order, with their
arguments), the cacher's `stats` and accounting, and the backing's
bytes at the end; the reference's own assertions run on both.
"""
import random

import pytest

import ceph_tpu.osdc.object_cacher as ref_oc
import ceph_tpu.osdc.striper as ref_striper
import ceph_tpu_torch.osdc.object_cacher as port_oc
import ceph_tpu_torch.osdc.striper as port_striper
from test_torch_cephfs import bare_sides, fs_state, run_both  # noqa: F401

OC = {"ref": ref_oc, "port": port_oc}
STRIPER = {"ref": ref_striper, "port": port_striper}


# ------------------------------------------------------------- striper

def striper_roundtrip(kind: str) -> list:
    mod = STRIPER[kind]
    rng = random.Random(1234)
    seen = []
    for _ in range(200):
        su = rng.choice([1, 7, 512, 4096, 65536])
        spo = rng.randrange(1, 9)
        sc = rng.randrange(1, 7)
        layout = mod.StripeLayout(stripe_unit=su, stripe_count=sc,
                                  object_size=su * spo)
        span = su * spo * sc * 3
        off = rng.randrange(0, span)
        length = rng.randrange(0, span)
        exts = mod.Striper.file_to_extents(layout, off, length)
        assert sum(e.length for e in exts) == length
        pos = off
        covered = []
        for e in exts:
            assert e.logical_offset == pos
            assert 0 <= e.offset and \
                e.offset + e.length <= layout.object_size
            covered += mod.Striper.extent_to_file(
                layout, e.objectno, e.offset, e.length)
            pos += e.length
        covered.sort()
        assert sum(n for _, n in covered) == length
        if covered:
            assert covered[0][0] == off
            at = off
            for lo, n in covered:
                assert lo == at, (layout, off, length)
                at += n
            assert at == off + length
        seen.append(([(e.objectno, e.offset, e.length, e.logical_offset)
                      for e in exts], covered))
    return seen


def striper_ragged_tail(kind: str) -> list:
    mod = STRIPER[kind]
    layout = mod.StripeLayout(stripe_unit=4096, stripe_count=3,
                              object_size=16384)
    length = 2 * 16384 * 3 + 5 * 4096 + 123     # mid-block tail
    exts = mod.Striper.file_to_extents(layout, 0, length)
    assert sum(e.length for e in exts) == length
    tail = exts[-1]
    assert tail.length == 123
    back = mod.Striper.extent_to_file(layout, tail.objectno, tail.offset,
                                      tail.length)
    assert back == [(length - 123, 123)]
    assert mod.Striper.file_to_extents(layout, 500, 0) == []
    with pytest.raises(ValueError):
        mod.StripeLayout(stripe_unit=3, object_size=8).validate()
    return [(e.objectno, e.offset, e.length, e.logical_offset)
            for e in exts] + back


@pytest.mark.parametrize("case", [striper_roundtrip, striper_ragged_tail])
def test_striper_equals_reference(case):
    assert case("port") == case("ref")


# ------------------------------------------------------- ObjectCacher

class Backing:
    """In-memory backing store logging every call in order."""

    def __init__(self):
        self.objs: dict[str, bytearray] = {}
        self.log: list[tuple] = []
        self.reads = 0
        self.writes = 0

    def read(self, oid, off, length):
        self.reads += 1
        self.log.append(("read", oid, off, length))
        buf = self.objs.get(oid, bytearray())
        return bytes(buf[off:off + length])

    def write(self, oid, off, data):
        self.writes += 1
        self.log.append(("write", oid, off, len(data)))
        buf = self.objs.setdefault(oid, bytearray())
        if len(buf) < off + len(data):
            buf.extend(b"\0" * (off + len(data) - len(buf)))
        buf[off:off + len(data)] = data

    def read_many(self, fetches):
        self.log.append(("wave", tuple(fetches)))
        return [bytes(self.objs.get(oid, bytearray())[off:off + ln])
                for oid, off, ln in fetches]

    def seed(self, oid, data: bytes):
        self.objs[oid] = bytearray(data)


class Case:
    """One cacher over one backing, recording what every call gave."""

    def __init__(self, kind: str, batched: bool = False, **kw):
        self.mod = OC[kind]
        self.b = Backing()
        if batched:
            kw["read_many_fn"] = self.b.read_many
        self.oc = self.mod.ObjectCacher(self.b.read, self.b.write, **kw)
        self.out: list = []

    def __call__(self, method: str, *args, **kw):
        got = getattr(self.oc, method)(*args, **kw)
        self.out.append((method, args, got))
        return got

    def result(self) -> dict:
        return {"out": self.out, "log": self.b.log,
                "stats": dict(self.oc.stats),
                "dirty": self.oc.dirty_bytes(),
                "cached": self.oc.cached_bytes(),
                "objs": {k: bytes(v) for k, v in sorted(self.b.objs.items())}}


def writeback_and_flush_coalescing(kind):
    c = Case(kind, page=4096)
    for i in range(64):
        c("write", "obj", i * 1024, b"A" * 1024)
    assert c.b.writes == 0
    c("flush")
    assert c.b.writes == 1
    assert bytes(c.b.objs["obj"]) == b"A" * (64 * 1024)
    assert c("flush") == 0
    return c


def read_after_write_and_hit_tracking(kind):
    c = Case(kind, page=4096)
    c("write", "o", 100, b"hello")
    assert c("read", "o", 100, 5) == b"hello"
    assert c("read", "o", 102, 2) == b"ll"
    assert c.b.writes == 0
    c("flush")
    assert c("read", "o", 100, 5) == b"hello"
    assert c.oc.stats["hit"] >= 2
    return c


def partial_page_write_allocates(kind):
    c = Case(kind, page=4096)
    c.b.seed("o", b"X" * 4096)
    c("write", "o", 10, b"yy")
    c("flush")
    want = bytearray(b"X" * 4096)
    want[10:12] = b"yy"
    assert bytes(c.b.objs["o"]) == bytes(want)
    return c


def dirty_throttle_flushes_inline(kind):
    c = Case(kind, page=4096, max_dirty=8 * 4096)
    for i in range(32):
        c("write", "o", i * 4096, b"z" * 4096)
    assert c.b.writes > 0
    c("flush")
    assert bytes(c.b.objs["o"]) == b"z" * (32 * 4096)
    return c


def lru_eviction_bounds_memory(kind):
    c = Case(kind, page=4096, max_size=16 * 4096, max_dirty=1 << 20)
    for n in range(8):
        c("write", f"o{n}", 0, b"d" * 4096)
    c("flush")
    for n in range(8):
        c.b.seed(f"c{n}", b"c" * 4096 * 3)
        c("read", f"c{n}", 0, 4096 * 3)
    assert c.oc.cached_bytes() <= 16 * 4096
    assert c.oc.stats["evicted_pages"] > 0
    assert c("read", "o0", 0, 4096) == b"d" * 4096
    return c


def invalidate_flushes_unless_discarded(kind):
    c = Case(kind, page=4096)
    c("write", "o", 0, b"keep")
    c("invalidate")
    assert bytes(c.b.objs["o"])[:4] == b"keep"
    c("write", "o", 0, b"drop")
    c("invalidate", discard_dirty=True)
    assert bytes(c.b.objs["o"])[:4] == b"keep"
    assert c("read", "o", 0, 4) == b"keep"
    return c


def discard_zeroes_cache_view(kind):
    c = Case(kind, page=4096)
    c("write", "o", 0, b"M" * 8192)
    c("flush")
    c("discard", "o", 0, 4096)
    c.b.objs["o"][:4096] = b"\0" * 4096
    assert c("read", "o", 0, 4096) == b"\0" * 4096
    assert c("read", "o", 4096, 4096) == b"M" * 4096
    return c


def flush_does_not_zero_extend_short_objects(kind):
    c = Case(kind)
    c("write", "tiny", 0, b"0123456789")
    c("flush")
    assert len(c.b.objs["tiny"]) == 10
    c.b.seed("short", b"x" * 100)
    c("write", "short", 5, b"yy")
    c("flush")
    assert len(c.b.objs["short"]) == 100
    assert bytes(c.b.objs["short"][:10]) == b"xxxxxyyxxx"
    c("write", "short", 98, b"zzzz")
    c("flush")
    assert len(c.b.objs["short"]) == 102
    assert bytes(c.b.objs["short"][96:]) == b"xxzzzz"
    return c


def flush_run_tail_truncation_multipage(kind):
    c = Case(kind, page=64)
    data = bytes(range(256)) * 100
    c("write", "obj", 0, data[:130])
    c("flush")
    assert bytes(c.b.objs["obj"]) == data[:130]
    return c


def sequential_readahead_cuts_backing_reads(kind):
    c = Case(kind, page=4096, max_readahead=64 << 10)
    payload = bytes(range(256)) * 1024
    c.b.seed("o", payload)
    got = b"".join(c("read", "o", off, 4096)
                   for off in range(0, len(payload), 4096))
    assert got == payload
    assert c.b.reads < 64 // 3, c.b.reads
    assert c.oc.stats["readahead_pages"] > 0
    return c


def random_reads_do_not_amplify(kind):
    c = Case(kind, page=4096, max_readahead=64 << 10)
    c.b.seed("o", b"x" * (1 << 20))
    offs = [911 * 4096, 3 * 4096, 200 * 4096, 77 * 4096, 150 * 4096]
    for off in offs:
        c("read", "o", off, 4096)
    assert c.b.reads == len(offs)
    assert c.oc.stats["readahead_pages"] == 0
    return c


def readahead_keeps_bytes_and_dirty_state(kind):
    c = Case(kind, page=4096, max_readahead=32 << 10)
    data = bytes((i * 7) & 0xFF for i in range(80_000))
    c.b.seed("o", data)
    out = b"".join(c("read", "o", off, 1000)
                   for off in range(0, 80_000, 1000))
    assert out == data
    assert c.oc.dirty_bytes() == 0
    assert c("read", "o", 79_000, 4096) == \
        data[79_000:] + b"\0" * (4096 - 1000)
    return c


def readahead_disabled_with_zero_max(kind):
    c = Case(kind, page=4096, max_readahead=0)
    c.b.seed("o", b"y" * 65536)
    for off in range(0, 65536, 4096):
        c("read", "o", off, 4096)
    assert c.oc.stats["readahead_pages"] == 0
    assert c.b.reads == 16
    return c


def policy_selection_by_name_and_instance(kind):
    mod = OC[kind]
    c = Case(kind, policy="kvcache")
    assert isinstance(c.oc.policy, mod.KVCacheReadahead)
    c2 = Case(kind, policy=mod.CheckpointReadahead())
    assert c2.oc.policy.name == "checkpoint"
    with pytest.raises(KeyError):
        Case(kind, policy="not-a-policy")
    c.out.append(sorted(mod.READAHEAD_POLICIES))
    return c


def kvcache_policy_never_reads_ahead(kind):
    c = Case(kind, page=4096, max_readahead=64 << 10, policy="kvcache")
    c.b.seed("o", b"k" * (256 << 10))
    for off in range(0, 256 << 10, 4096):
        c("read", "o", off, 4096)
    assert c.oc.stats["readahead_pages"] == 0
    assert c.b.reads == 64
    return c


def pin_exempts_pages_from_eviction(kind):
    c = Case(kind, page=4096, max_size=8 * 4096, policy="kvcache")
    c.b.seed("hot", b"h" * (4 * 4096))
    c.b.seed("cold", b"c" * (64 * 4096))
    c("pin", "hot", 0, 4 * 4096)
    assert c("pinned_bytes") == 4 * 4096
    reads_after_pin = c.b.reads
    c("read", "cold", 0, 64 * 4096)
    assert c.oc.cached_bytes() <= 8 * 4096
    assert c("read", "hot", 0, 4 * 4096) == b"h" * (4 * 4096)
    assert c.b.reads == reads_after_pin + 1
    c("unpin", "hot", 0, 4 * 4096)
    assert c("pinned_bytes") == 0
    c("read", "cold", 0, 64 * 4096)
    assert c.oc.cached_bytes() <= 8 * 4096
    with pytest.raises(ValueError):
        c.oc.unpin("hot", 0, 4096)
    with pytest.raises(ValueError):
        c.oc.unpin("never-cached", 0, 4096)
    return c


def read_many_batches_backing_reads(kind):
    c = Case(kind, batched=True, page=4096, policy="kvcache")
    c.b.seed("o1", bytes(range(256)) * 256)
    c.b.seed("o2", b"Z" * (64 << 10))
    reqs = [("o1", 0, 4096), ("o1", 4096, 4096),
            ("o1", 3 * 4096, 100), ("o2", 8 * 4096, 8192),
            ("o2", 0, 1)]
    got = c("read_many", reqs)
    assert got == [bytes(c.b.objs[oid][off:off + ln])
                   for oid, off, ln in reqs]
    waves = [e for e in c.b.log if e[0] == "wave"]
    assert len(waves) == 1 and ("o1", 0, 8192) in waves[0][1]
    assert len(waves[0][1]) == 4
    assert c.oc.stats["miss"] == len(reqs)
    assert c("read_many", reqs) == got
    assert len([e for e in c.b.log if e[0] == "wave"]) == 1
    assert c.oc.stats["hit"] == len(reqs)
    return c


def read_many_shared_page_is_demand(kind):
    c = Case(kind, page=4096, policy="kvcache")
    c.b.seed("o", b"s" * (32 << 10))
    got = c("read_many", [("o", 0, 100), ("o", 200, 100)])
    assert got == [b"s" * 100, b"s" * 100]
    assert c.oc.stats["miss"] == 2
    assert c.b.reads == 1
    assert c.oc.stats["readahead_pages"] == 0
    c2 = Case(kind, page=4096, max_readahead=32 << 10)
    c2.b.seed("o", b"t" * (256 << 10))
    c2("read", "o", 0, 4096)
    c2("read_many", [("o", 4096, 4096)])
    assert c2.oc.stats["readahead_pages"] > 0
    c.out.append(c2.result())
    return c


def read_many_falls_back_and_handles_empty(kind):
    c = Case(kind, page=4096, policy="kvcache")
    c.b.seed("o", b"f" * 8192)
    assert c("read_many", []) == []
    got = c("read_many", [("o", 0, 8192), ("o", 100, 0),
                          ("missing", 0, 4096)])
    assert got == [b"f" * 8192, b"", b"\0" * 4096]
    assert c.b.reads == 2
    return c


def readahead_pages_counted_only_when_fetched(kind):
    c = Case(kind, page=4096, max_readahead=64 << 10)
    c.b.seed("o", b"y" * (1 << 20))
    for off in range(0, 256 << 10, 4096):
        c("read", "o", off, 4096)
    fetched = c.oc.stats["readahead_pages"]
    assert fetched > 0
    reads_before = c.b.reads
    for off in range(0, 256 << 10, 4096):
        c("read", "o", off, 4096)
    assert c.b.reads == reads_before
    assert c.oc.stats["readahead_pages"] == fetched
    return c


CACHER_CASES = [
    writeback_and_flush_coalescing, read_after_write_and_hit_tracking,
    partial_page_write_allocates, dirty_throttle_flushes_inline,
    lru_eviction_bounds_memory, invalidate_flushes_unless_discarded,
    discard_zeroes_cache_view, flush_does_not_zero_extend_short_objects,
    flush_run_tail_truncation_multipage,
    sequential_readahead_cuts_backing_reads, random_reads_do_not_amplify,
    readahead_keeps_bytes_and_dirty_state, readahead_disabled_with_zero_max,
    policy_selection_by_name_and_instance, kvcache_policy_never_reads_ahead,
    pin_exempts_pages_from_eviction, read_many_batches_backing_reads,
    read_many_shared_page_is_demand, read_many_falls_back_and_handles_empty,
    readahead_pages_counted_only_when_fetched,
]


@pytest.mark.parametrize("case", CACHER_CASES, ids=lambda f: f.__name__)
def test_object_cacher_equals_reference(case):
    ref = case("ref").result()
    port = case("port").result()
    assert port == ref


# -------------------------------------------------------- RadosStriper

def rados_striper(kind: str, pool_type: str = "replicated") -> dict:
    import numpy as np

    if kind == "ref":
        from ceph_tpu.osdc.rados_striper import RadosStriper
        from ceph_tpu.testing import MiniCluster
        c = MiniCluster(n_osd=4, threaded=False)
    else:
        from ceph_tpu_torch.osdc.rados_striper import RadosStriper
        from ceph_tpu_torch.testing import MiniCluster
        c = MiniCluster(n_osd=4, threaded=False, device="cpu")
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        if pool_type == "erasure":
            r.mon_command({"prefix": "osd erasure-code-profile set",
                           "name": "k2m1",
                           "profile": {"plugin": "tpu", "k": "2", "m": "1",
                                       "crush-failure-domain": "host"}})
            r.pool_create("stp", pg_num=8, pool_type="erasure",
                          erasure_code_profile="k2m1")
        else:
            r.pool_create("stp", pg_num=8)
        io = r.open_ioctx("stp")
        st = RadosStriper(io, STRIPER[kind].StripeLayout(
            stripe_unit=1 << 12, stripe_count=3, object_size=1 << 14))
        payload = np.random.default_rng(3).integers(
            0, 256, 150_000, dtype=np.uint8).tobytes()
        st.write("big", payload)
        out = {"read": st.read("big") == payload,
               "window": st.read("big", length=100, offset=70_000),
               "stat": st.stat("big"),
               "objects": [o for o in io.list_objects()
                           if o.startswith("big.")]}
        out["bytes"] = {o: io.read(o) for o in out["objects"]}
        out["xattrs"] = io.get_xattrs("big.0000000000000000")
        st.write("big", b"TAIL", offset=len(payload))
        out["tail"] = st.read("big")[-4:]
        out["size_after"] = st.stat("big")["size"]
        st.remove("big")
        out["left"] = [o for o in io.list_objects() if o.startswith("big.")]
        out["swallowed"] = getattr(st, "swallowed", 0)
        return out
    finally:
        c.shutdown()


def test_rados_striper_equals_reference():
    ref, port = rados_striper("ref"), rados_striper("port")
    assert port == ref
    # tests/test_compressor_striper.py's assertions
    assert port["read"] and port["stat"]["size"] == 150_000
    assert port["stat"]["stripe_count"] == 3
    assert len(port["objects"]) > 5
    assert port["tail"] == b"TAIL" and port["left"] == []
    assert port["swallowed"] == 0


def test_rados_striper_on_an_ec_pool():
    rep, ec = rados_striper("port"), rados_striper("port", "erasure")
    assert ec == rep


def test_rados_striper_counts_swallowed_errors():
    """Where the reference reads a failed metadata read as ENOENT and
    drops a failed removal, the port does the same and counts every such
    error that is not ENOENT or ENODATA."""
    from ceph_tpu_torch.client import RadosError
    from ceph_tpu_torch.osdc.rados_striper import RadosStriper

    class FailingIo:
        def get_xattr(self, oid, name):
            raise RadosError("EIO", oid)

    st = RadosStriper(FailingIo())
    with pytest.raises(RadosError) as ei:
        st.stat("obj")
    assert ei.value.errno_name == "ENOENT" and st.swallowed == 1

    class MissingIo(FailingIo):
        def get_xattr(self, oid, name):
            raise RadosError("ENODATA", oid)

    st = RadosStriper(MissingIo())
    with pytest.raises(RadosError):
        st.read("obj")
    assert st.swallowed == 0


def c_cephfs_cap_revoke_flushes_cached_writes(s):
    """tests/test_object_cacher.py's cephfs case on one package."""
    c = s.cluster(n_osd=3)
    mds = s.p.MDSDaemon(c.network, c.rados())
    mds.init()
    try:
        fs_w, fs_r = s.new_fs(c), s.new_fs(c)
        fs_w.mkdirs("/oc")
        w = fs_w.open("/oc/buffered", "w")
        w.write(0, b"write-back bytes " * 256)
        dirty = w._oc.dirty_bytes()
        assert w._oc is not None and dirty > 0
        rd = fs_r.open("/oc/buffered", "r")
        assert rd.read(0) == b"write-back bytes " * 256
        assert w._oc.dirty_bytes() == 0
        w.close()
        rd.close()
        return {"dirty": dirty, "state": fs_state(s, fs_w.rados)}
    finally:
        mds.shutdown()


def test_cephfs_cap_revoke_flushes_cached_writes(bare_sides):  # noqa: F811
    """The cephfs client's per-inode cacher under the MDS's caps: the
    writer's buffered data reaches RADOS on the revoke a reader's open
    triggers, and the reader sees it; the port equals the reference."""
    run_both(bare_sides, c_cephfs_cap_revoke_flushes_cached_writes,
             state=False)
