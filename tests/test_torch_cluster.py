"""The port's erasure-code plugins under the reference's OSD stack.

Each of the port's six plugins is registered with the reference's
ErasureCodePluginRegistry (as `torch_<name>`), and the reference's
MiniCluster runs EC pools on them beside pools on the reference's own
plugin of the same profile: writes read back, shards stored by the
port's pool equal the reference pool's byte for byte, and reads stay
whole after a shard holder is killed.  The reference's ECUtil reaches
the port's batched encode/decode (`encode_batch`, `decode_batch`) for
the matrix plugins; recovery in this stack still compiles through the
reference's repair compiler, so this covers writes and degraded reads,
not the port's repair.

The reference reads batched results with np.asarray, so on a card the
adapter copies them to the host.  The `cuda` case runs on a machine with
one (the reference's OSD stack imports no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cluster.py
"""
import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import ErasureCodePlugin as RefPlugin
from ceph_tpu.ec.registry import ErasureCodePluginRegistry as RefRegistry
from ceph_tpu.osd.ec_backend import pg_cid
from ceph_tpu.store import ObjectId
from ceph_tpu.testing import MiniCluster
from ceph_tpu_torch.ec import registry as port_registry

PROFILES = {
    "jerasure": {"k": "4", "m": "2", "technique": "reed_sol_van"},
    "isa": {"k": "4", "m": "2"},
    "tpu": {"k": "4", "m": "2"},
    "shec": {"k": "4", "m": "3", "c": "2"},
    "lrc": {"k": "4", "m": "2", "l": "3"},
    "clay": {"k": "4", "m": "2"},
}
N_OSD = 9                        # lrc k=4 m=2 l=3 places 8 chunks


class PortPlugin(RefPlugin):
    """A reference-registry plugin whose factory makes the port's plugin
    `name` on `device`, with batched results copied to the host.  Counts
    the batched calls the reference's ECUtil makes."""

    def __init__(self, name: str, device: str):
        super().__init__(f"torch_{name}", None)
        self.port_name = name
        self.device = device
        self.batched = {"encode_batch": 0, "decode_batch": 0,
                        "decode_batch_full": 0}

    def factory(self, profile):
        profile = dict(profile)
        profile["plugin"] = self.port_name
        ec = port_registry.factory(self.port_name, profile, self.device)
        if self.port_name == "lrc":
            # the port's lrc builds its rule from the port's crush types,
            # which the reference's map cannot carry on the wire: the
            # reference's lrc of the same profile builds the same rule
            ec.create_rule = RefRegistry.instance().factory(
                "lrc", profile).create_rule
        for name in self.batched:
            fn = getattr(ec, name, None)
            if fn is not None:
                setattr(ec, name, self._on_host(name, fn))
        return ec

    def _on_host(self, name, fn):
        def call(*args, **kwargs):
            self.batched[name] += 1
            return fn(*args, **kwargs).cpu()
        return call


def register(device: str) -> dict[str, PortPlugin]:
    """The port's plugins in the reference registry, once per device."""
    reg = RefRegistry.instance()
    out = {}
    for name in PROFILES:
        pname = f"torch_{name}" if device == "cpu" else \
            f"torch_{name}_{device}"
        plugin = reg.get(pname)
        if plugin is None:
            plugin = PortPlugin(name, device)
            plugin.name = pname
            reg.add(pname, plugin)
        out[name] = plugin
    return out


def make_pool(r, pool: str, plugin: str, profile: dict) -> None:
    r.mon_command({"prefix": "osd erasure-code-profile set",
                   "name": f"prof_{pool}",
                   "profile": {"plugin": plugin,
                               "crush-failure-domain": "host", **profile}})
    r.pool_create(pool, pg_num=4, pool_type="erasure",
                  erasure_code_profile=f"prof_{pool}")


@pytest.fixture(scope="module")
def cluster():
    plugins = register("cpu")
    c = MiniCluster(n_osd=N_OSD, threaded=False)
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        for name, profile in PROFILES.items():
            make_pool(r, f"port_{name}", plugins[name].name, profile)
            make_pool(r, f"ref_{name}", name, profile)
        c.pump()
        yield c, r, plugins
    finally:
        c.shutdown()


def locate(c, r, pool, oid):
    pid = r.pool_lookup(pool)
    m = c.mon.osdmap
    pg = m.pools[pid].raw_pg_to_pg(m.object_locator_to_pg(oid, pid))
    _up, _up_p, acting, acting_p = m.pg_to_up_acting_osds(pg)
    return pg, acting, acting_p


def shard_streams(c, r, pool, oid) -> dict[int, bytes]:
    pg, acting, _p = locate(c, r, pool, oid)
    return {s: c.osds[osd].store.read(pg_cid(pg), ObjectId(oid, shard=s),
                                      0, 0)
            for s, osd in enumerate(acting) if osd >= 0}


def data_holder(acting, primary) -> int:
    """An OSD other than the primary that holds one of shards 0..3 (the
    data chunks of the matrix codes), so a read of it must decode."""
    return next(o for s, o in enumerate(acting[:4])
                if o >= 0 and o != primary)


def objects(seed: int, count: int = 4) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    return {f"o{seed}_{i}": rng.integers(0, 256, 9000 + 131 * i,
                                         dtype=np.uint8).tobytes()
            for i in range(count)}


@pytest.mark.parametrize("plugin", list(PROFILES))
def test_port_pool_writes_and_reads(cluster, plugin):
    c, r, plugins = cluster
    io = r.open_ioctx(f"port_{plugin}")
    objs = objects(len(plugin))
    before = dict(plugins[plugin].batched)
    for oid, data in objs.items():
        io.write_full(oid, data)
    c.pump()
    for oid, data in objs.items():
        assert io.read(oid) == data, oid
    if plugin == "tpu":
        # the reference's ECUtil took the port's batched encode
        assert plugins[plugin].batched["encode_batch"] >= \
            before["encode_batch"] + len(objs)


@pytest.mark.parametrize("plugin", list(PROFILES))
def test_port_pool_shards_equal_reference_pool(cluster, plugin):
    """The same object in a pool on the port's plugin and in one on the
    reference's: every shard index stores the same bytes."""
    c, r, _plugins = cluster
    data = objects(100 + len(plugin), 1)
    oid, payload = next(iter(data.items()))
    for pool in (f"port_{plugin}", f"ref_{plugin}"):
        r.open_ioctx(pool).write_full(oid, payload)
    c.pump()
    got = shard_streams(c, r, f"port_{plugin}", oid)
    want = shard_streams(c, r, f"ref_{plugin}", oid)
    assert len(got) == len(want) == \
        port_registry.factory(plugin, dict(PROFILES[plugin]),
                              device="cpu").get_chunk_count()
    assert got == want


@pytest.mark.parametrize("plugin", list(PROFILES))
def test_port_pool_degraded_read_after_kill(cluster, plugin):
    c, r, plugins = cluster
    pool = f"port_{plugin}"
    io = r.open_ioctx(pool)
    oid, data = next(iter(objects(200 + len(plugin), 1).items()))
    io.write_full(oid, data)
    c.pump()
    _pg, acting, primary = locate(c, r, pool, oid)
    victim = data_holder(acting, primary)
    before = plugins[plugin].batched["decode_batch"]
    c.kill_osd(victim)
    try:
        assert io.read(oid) == data
        if plugin == "tpu":
            assert plugins[plugin].batched["decode_batch"] > before
    finally:
        c.revive_osd(victim)
        c.pump()
        c.wait_all_up()


@pytest.mark.cuda
def test_port_tpu_pool_on_card():
    """The port's `tpu` plugin on the card under the reference's OSD
    stack: writes, stored shards against the host encode, and a
    degraded read after a kill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceph_tpu_torch.osd import ecutil
    plugin = register("cuda")["tpu"]
    c = MiniCluster(n_osd=6, threaded=False)
    try:
        c.pump()
        c.wait_all_up()
        r = c.rados()
        make_pool(r, "card", plugin.name, PROFILES["tpu"])
        c.pump()
        io = r.open_ioctx("card")
        objs = objects(7)
        for oid, data in objs.items():
            io.write_full(oid, data)
        c.pump()
        assert plugin.batched["encode_batch"] >= len(objs)
        oid, data = next(iter(objs.items()))
        pg, acting, primary = locate(c, r, "card", oid)
        backend = c.osds[primary].pgs[pg].backend
        sinfo = ecutil.StripeInfo(4, backend.sinfo.stripe_width)
        padded = data + bytes(-len(data) % sinfo.stripe_width)
        host = port_registry.factory("tpu", dict(PROFILES["tpu"]),
                                     device="cpu")
        assert shard_streams(c, r, "card", oid) == \
            ecutil.encode(sinfo, host, padded)
        c.kill_osd(data_holder(acting, primary))
        assert io.read(oid) == data
        assert plugin.batched["decode_batch"] >= 1
    finally:
        c.shutdown()
