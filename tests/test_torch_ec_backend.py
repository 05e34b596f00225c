"""The port's ECBackend and ECPGShard held to the reference's.

tests/test_ec_backend.py's twenty scenarios, each run twice on the same
inputs: once through `ceph_tpu.osd.ec_backend` over the reference's
MemStore and plugin, once through `ceph_tpu_torch.osd.ec_backend` over
the port's MemStore and the port's plugin on `device="cpu"` (K1's plain
version, the port's ECUtil and compiled repair).  Each case compares, at
tolerance 0, what the scenario observed (reads, write and recovery
outcomes, errors), every shard store's objects with their bytes, xattrs
and omap bytes, every shard's `log_info()`, and the recovery read/rebuilt
counters.

All twenty run on `tpu` k=3 m=2 (the reference tests' own code) and k=8
m=4; the write, degraded-read, overwrite and recovery scenarios also run
on jerasure, isa, shec, clay and lrc.  Beside them: the repair fallback
rule (a plan error still takes the full rebuild; a fault of K1's wrapper,
its launch, its build or the device guard propagates), a cluster written
by the reference carried across with `MemStore.from_reference` and
recovered by the port, writes through the port's fabric against the host
path (chunk bytes), the `ec_decode_kernel` span's `stage`/`kernel`
children, and the sub-ops sent through the port's Messenger against the
direct wiring (the stores must come out the same).
"""
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu.common import perf_counters as ref_perf
from ceph_tpu.common import tracing as ref_tracing
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.osd import ec_backend as ref_ecb
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu.osd import pg_types as ref_pg_types
from ceph_tpu import store as ref_store
from ceph_tpu_torch.common import devguard
from ceph_tpu_torch.common import perf_counters as port_perf
from ceph_tpu_torch.common import tracing as port_tracing
from ceph_tpu_torch.ec import registry as port_registry
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.ec.repairc import RepairPlanError
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.osd import ec_backend as port_ecb
from ceph_tpu_torch.osd import ecutil as port_ecutil
from ceph_tpu_torch.osd import pg_types as port_pg_types
from ceph_tpu_torch import store as port_store

PGID = "1.0"

REF = SimpleNamespace(
    name="ref", ecb=ref_ecb, ecutil=ref_ecutil,
    store=ref_store, messages=ref_messages, pg_types=ref_pg_types,
    perf=ref_perf, tracing=ref_tracing,
    factory=lambda plugin, profile: ref_registry.factory(plugin, profile))
PORT = SimpleNamespace(
    name="port", ecb=port_ecb, ecutil=port_ecutil, store=port_store,
    messages=port_messages, pg_types=port_pg_types, perf=port_perf,
    tracing=port_tracing,
    factory=lambda plugin, profile: port_registry.factory(
        plugin, profile, device="cpu"))

CODES = {
    "tpu_k3m2": ("tpu", {"k": "3", "m": "2"}),
    "tpu_k8m4": ("tpu", {"k": "8", "m": "4", "technique": "reed_sol_van"}),
    "jerasure": ("jerasure", {"k": "4", "m": "2",
                              "technique": "reed_sol_van"}),
    "isa": ("isa", {"k": "4", "m": "2"}),
    "shec": ("shec", {"k": "4", "m": "3", "c": "2"}),
    "clay": ("clay", {"k": "4", "m": "2"}),
    "lrc": ("lrc", {"k": "4", "m": "2", "l": "3"}),
}


class Cluster:
    """N OSDs, one EC PG, direct message wiring (tests/test_ec_backend.py's
    harness over one package's modules)."""

    def __init__(self, ns, plugin: str, profile: dict):
        self.ns = ns
        self.ec = ns.factory(plugin, dict(profile))
        # layered codes (lrc) have more chunks than k+m: size the
        # cluster by the plugin's own count
        self.k = self.ec.get_data_chunk_count()
        self.n = self.ec.get_chunk_count()
        self.m = self.n - self.k
        self.stores = [self._store() for _ in range(self.n)]
        self.shards = [ns.ecb.ECPGShard(PGID, s, self.stores[s], self.k,
                                        self.m) for s in range(self.n)]
        self.alive = [True] * self.n
        self.deferred: dict[int, list] = {}
        self.perf = ns.perf.PerfCounters("osd.0")
        for key in ("recovery_bytes_read", "recovery_bytes_rebuilt"):
            self.perf.add_u64_counter(key)
        self.backend = self._backend()

    def _store(self):
        st = self.ns.store.MemStore()
        st.mkfs()
        st.mount()
        return st

    def _backend(self):
        be = self.ns.ecb.ECBackend(PGID, self.ec, whoami=0,
                                   acting=list(range(self.n)),
                                   local_shard=self.shards[0],
                                   send=self._send)
        be.perf = self.perf
        return be

    def _send(self, shard, msg):
        if not self.alive[shard]:
            return False
        if shard in self.deferred:
            self.deferred[shard].append(msg)
            return True
        self._deliver(shard, msg)
        return True

    def _deliver(self, shard, msg):
        svc = self.shards[shard]
        if isinstance(msg, self.ns.messages.ECSubWrite):
            reply = svc.handle_sub_write(msg)
            if not self.backend.handle_recovery_write_reply(reply):
                self.backend.handle_sub_write_reply(reply)
        elif isinstance(msg, self.ns.messages.ECSubRead):
            self.backend.handle_sub_read_reply(svc.handle_sub_read(msg))

    def defer(self, shard):
        self.deferred[shard] = []

    def flush(self, shard):
        for m in self.deferred.pop(shard, []):
            self._deliver(shard, m)

    def kill(self, shard):
        self.alive[shard] = False
        pm = self.backend.peer_missing[shard]
        for oid in self.shards[0].objects():
            pm.add(oid, self.ns.pg_types.EVersion(1, 1))

    def revive(self, shard):
        self.alive[shard] = True
        self.stores[shard] = self._store()
        self.shards[shard] = self.ns.ecb.ECPGShard(
            PGID, shard, self.stores[shard], self.k, self.m)

    def corrupt(self, shard, oid, byte, mask):
        st = self.stores[shard]
        soid = self.ns.store.ObjectId(oid, shard=shard)
        buf = bytearray(st.read(port_ecb.pg_cid(PGID), soid))
        buf[byte] ^= mask
        st.queue_transaction(self.ns.store.Transaction().write(
            port_ecb.pg_cid(PGID), soid, 0, bytes(buf)))

    # sync wrappers -----------------------------------------------------
    def write(self, oid, off, data):
        out = {}
        self.backend.submit_transaction(
            oid, [("write", off, data)], lambda ok: out.setdefault("ok", ok))
        return out.get("ok")

    def delete(self, oid):
        out = {}
        self.backend.submit_transaction(
            oid, [("delete",)], lambda ok: out.setdefault("ok", ok))
        return out.get("ok")

    def read(self, oid, off=0, length=0):
        """The object's bytes, or ("error", errors) as the reference test
        would see an IOError."""
        out = {}
        self.backend.objects_read_and_reconstruct(
            {oid: (off, length)},
            lambda r, e: out.update(results=r, errors=e))
        if out["errors"]:
            return ("error", out["errors"])
        return out["results"][oid]

    def recover(self, oid, targets):
        calls = []
        self.backend.recover_object(oid, targets, calls.append)
        return calls

    def chunk(self, shard, oid):
        return self.stores[shard].read(port_ecb.pg_cid(PGID),
                                       self.ns.store.ObjectId(oid,
                                                              shard=shard))

    def state(self) -> dict:
        """Every store's objects (data, xattrs, omap bytes), every shard's
        log bounds and entries, the counters and the backend's versions,
        in plain values both packages share."""
        stores = []
        for st in self.stores:
            objs = {}
            for cid in st.list_collections():
                for o in st.collection_list(cid):
                    objs[(cid, o.name, o.snap, o.shard)] = (
                        st.read(cid, o), st.getattrs(cid, o),
                        st.omap_get(cid, o))
            stores.append(objs)
        logs = [(str(s.log_info()[0]), str(s.log_info()[1]),
                 [str(e) for e in s.pg_log.log.entries])
                for s in self.shards]
        return {"stores": stores, "logs": logs, "perf": self.perf.dump(),
                "committed_to": str(self.backend.committed_to),
                "missing": [sorted(pm.items)
                            for _, pm in sorted(
                                self.backend.peer_missing.items())]}


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


# ------------------------------------------------------------- scenarios
# Each takes a Cluster and returns what it observed; the test runs it on
# both packages and compares that and the cluster's state.

def s_write_read_roundtrip(cl):
    w = cl.backend.sinfo.stripe_width
    data = payload(3 * w + 517)
    out = [cl.write("obj", 0, data), cl.read("obj") == data,
           cl.read("obj", 100, 64) == data[100:164]]
    out.append([len(cl.chunk(s, "obj")) for s in range(cl.n)])
    return out


def s_append_maintains_cumulative_hinfo(cl):
    w = cl.backend.sinfo.stripe_width
    a, b = payload(2 * w, 1), payload(w, 2)
    out = [cl.write("obj", 0, a), cl.write("obj", 2 * w, b)]
    for s in range(cl.n):
        hd = cl.ns.ecutil.HashInfo.from_dict(cl.stores[s].getattr(
            port_ecb.pg_cid(PGID), cl.ns.store.ObjectId("obj", shard=s),
            port_ecb.HINFO_ATTR))
        out.append((hd.has_chunk_hash(), hd.get_chunk_hash(s)))
    return out + [cl.read("obj") == a + b]


def s_partial_overwrite_rmw(cl):
    w = cl.backend.sinfo.stripe_width
    base = payload(2 * w, 3)
    patch = payload(100, 4)
    out = [cl.write("obj", 0, base), cl.write("obj", 50, patch)]
    return out + [cl.read("obj") == base[:50] + patch + base[150:]]


def s_unaligned_append_extends(cl):
    data, more = payload(700, 5), payload(900, 6)
    out = [cl.write("obj", 0, data), cl.write("obj", 700, more)]
    return out + [cl.read("obj") == data + more]


def s_write_gap_zero_fills(cl):
    w = cl.backend.sinfo.stripe_width
    out = [cl.write("obj", 0, b"head"), cl.write("obj", 3 * w + 10, b"tail")]
    return out + [cl.read("obj")]


def s_degraded_read_with_dead_shards(cl):
    data = payload(5 * cl.backend.sinfo.stripe_width, 7)
    out = [cl.write("obj", 0, data)]
    cl.kill(1)
    cl.kill(cl.n - 1)
    return out + [cl.read("obj") == data]


def s_read_fails_beyond_m_failures(cl):
    data = payload(cl.backend.sinfo.stripe_width, 8)
    out = [cl.write("obj", 0, data)]
    for s in range(1, cl.m + 2):
        cl.kill(s)
    return out + [cl.read("obj")]


def s_corrupt_shard_detected_and_rerouted(cl):
    data = payload(2 * cl.backend.sinfo.stripe_width, 9)
    out = [cl.write("obj", 0, data)]
    cl.corrupt(0, "obj", 7, 0xFF)
    return out + [cl.read("obj") == data]


def s_kill_and_recover_shard(cl):
    w = cl.backend.sinfo.stripe_width
    objs = {f"o{i}": payload(w * (i + 1), 10 + i) for i in range(3)}
    out = [cl.write(oid, 0, data) for oid, data in objs.items()]
    cl.kill(2)
    out += [cl.read(oid) == data for oid, data in objs.items()]
    cl.revive(2)
    out += [cl.recover(oid, [2]) for oid in objs]
    for oid, data in objs.items():
        padded = data + b"\0" * (-len(data) % w)
        expect = cl.ns.ecutil.encode(cl.backend.sinfo, cl.ec, padded)[2]
        out.append(cl.chunk(2, oid) == expect)
    return out + [cl.read(oid) == data for oid, data in objs.items()]


def s_delete_leaves_versioned_tombstones(cl):
    out = [cl.write("obj", 0, payload(1024, 20)), cl.delete("obj")]
    out += [(cl.shards[s].exists("obj"), cl.shards[s].objects())
            for s in range(cl.n)]
    out.append(cl.read("obj"))
    data2 = payload(512, 21)
    return out + [cl.write("obj", 0, data2), cl.read("obj") == data2]


def s_per_object_write_ordering(cl):
    w = cl.backend.sinfo.stripe_width
    order = []
    cl.backend.submit_transaction("obj", [("write", 0, b"A" * w)],
                                  lambda ok: order.append(("w1", ok)))
    cl.backend.submit_transaction("obj", [("write", 10, b"B" * 10)],
                                  lambda ok: order.append(("w2", ok)))
    return [order, cl.read("obj")]


def s_log_entries_on_all_shards(cl):
    return [cl.write("obj", 0, b"x" * 100), cl.write("obj", 100, b"y" * 100),
            cl.delete("obj")]


def s_write_with_dead_non_primary_fails(cl):
    cl.kill(3)
    return [cl.write("obj", 0, b"z" * 64)]


def s_write_rejected_when_primary_missing_object(cl):
    data = payload(2 * cl.backend.sinfo.stripe_width, 30)
    out = [cl.write("obj", 0, data)]
    cl.backend.peer_missing[0].add("obj", cl.ns.pg_types.EVersion(1, 1))
    out.append(cl.write("obj", 10, b"patch"))
    cl.backend.peer_missing[0].rm("obj")
    return out + [cl.read("obj") == data]


def s_recover_zero_size_object(cl):
    out = [cl.write("empty", 0, b"")]
    cl.kill(2)
    cl.revive(2)
    return out + [cl.recover("empty", [2])]


def s_async_delivery_preserves_shard_log_order(cl):
    w = cl.backend.sinfo.stripe_width
    out = [cl.write("a", 0, b"A" * w)]
    cl.defer(1)
    done = []
    cl.backend.submit_transaction("a", [("write", 5, b"patch")],
                                  lambda ok: done.append(("a", ok)))
    cl.backend.submit_transaction("b", [("write", 0, b"B" * w)],
                                  lambda ok: done.append(("b", ok)))
    out.append(list(done))
    cl.flush(1)
    while cl.deferred.get(1):
        cl.flush(1)
    cl.deferred.pop(1, None)
    return out + [done]


def s_read_of_empty_object_returns_empty(cl):
    return [cl.write("empty", 0, b""), cl.read("empty"),
            cl.read("empty", 0, 10)]


def s_corrupt_shard_retry_completes_once(cl):
    data = payload(2 * cl.backend.sinfo.stripe_width, 40)
    out = [cl.write("obj", 0, data)]
    cl.corrupt(0, "obj", 3, 0x55)
    calls = []
    cl.backend.objects_read_and_reconstruct(
        {"obj": (0, 0)}, lambda r, e: calls.append((r, e)))
    return out + [len(calls), calls[0][0]["obj"] == data]


def s_recover_multiple_targets_single_completion(cl):
    data = payload(3 * cl.backend.sinfo.stripe_width, 41)
    out = [cl.write("obj", 0, data)]
    cl.kill(1)
    cl.kill(3)
    cl.revive(1)
    cl.revive(3)
    out.append(cl.recover("obj", [1, 3]))
    return out + [cl.read("obj") == data]


def s_windowed_read_does_not_fetch_full_streams(cl):
    w = cl.backend.sinfo.stripe_width
    data = payload(10 * w, 31)
    out = [cl.write("obj", 0, data)]
    seen = []
    orig = cl.shards[1].handle_sub_read

    def spy(m):
        seen.extend(m.to_read)
        return orig(m)

    cl.shards[1].handle_sub_read = spy
    out.append(cl.read("obj", 4 * w + 5, 10) == data[4 * w + 5:4 * w + 15])
    return out + [[tuple(t) for t in seen]]


SCENARIOS = {f.__name__[2:]: f for f in (
    s_write_read_roundtrip, s_append_maintains_cumulative_hinfo,
    s_partial_overwrite_rmw, s_unaligned_append_extends,
    s_write_gap_zero_fills, s_degraded_read_with_dead_shards,
    s_read_fails_beyond_m_failures, s_corrupt_shard_detected_and_rerouted,
    s_kill_and_recover_shard, s_delete_leaves_versioned_tombstones,
    s_per_object_write_ordering, s_log_entries_on_all_shards,
    s_write_with_dead_non_primary_fails,
    s_write_rejected_when_primary_missing_object, s_recover_zero_size_object,
    s_async_delivery_preserves_shard_log_order,
    s_read_of_empty_object_returns_empty,
    s_corrupt_shard_retry_completes_once,
    s_recover_multiple_targets_single_completion,
    s_windowed_read_does_not_fetch_full_streams)}

#: the scenarios every plugin runs: writes, overwrites, degraded reads and
#: recovery (the others are protocol cases the code does not change)
PLUGIN_SCENARIOS = ("write_read_roundtrip", "partial_overwrite_rmw",
                    "degraded_read_with_dead_shards",
                    "kill_and_recover_shard",
                    "recover_multiple_targets_single_completion")

CASES = [(code, name) for code in ("tpu_k3m2", "tpu_k8m4")
         for name in SCENARIOS]
CASES += [(code, name) for code in ("jerasure", "isa", "shec", "clay", "lrc")
          for name in PLUGIN_SCENARIOS]


def both(code, scenario):
    """Run `scenario` on a fresh cluster of each package."""
    plugin, profile = CODES[code]
    out = {}
    for ns in (REF, PORT):
        cl = Cluster(ns, plugin, profile)
        seen = scenario(cl)
        out[ns.name] = (cl, seen, cl.state())
    return out


@pytest.mark.parametrize("code,name", CASES)
def test_scenario_equals_reference(code, name):
    out = both(code, SCENARIOS[name])
    ref_cl, ref_seen, ref_state = out["ref"]
    port_cl, port_seen, port_state = out["port"]
    assert port_seen == ref_seen
    assert port_state["stores"] == ref_state["stores"]
    assert port_state == ref_state
    # the port ran its own modules throughout
    assert type(port_cl.backend).__module__ == "ceph_tpu_torch.osd.ec_backend"
    assert type(port_cl.stores[0]).__module__ == \
        "ceph_tpu_torch.store.memstore"


class MessengerCluster(Cluster):
    """The port's Cluster with every sub-op on the wire: the primary and
    each shard are endpoints of the port's LocalNetwork (non-threaded),
    and a send is delivered and answered by pumping every endpoint until
    the network is quiet, as the direct wiring answers inline."""

    def __init__(self, plugin, profile):
        from ceph_tpu_torch.msg import messenger as ms
        self.net = ms.LocalNetwork()
        self.eps = {}
        super().__init__(PORT, plugin, profile)
        cluster = self

        class Primary(ms.Dispatcher):
            def ms_dispatch(self, msg):
                be = cluster.backend
                if isinstance(msg, port_messages.ECSubWriteReply):
                    if not be.handle_recovery_write_reply(msg):
                        be.handle_sub_write_reply(msg)
                elif isinstance(msg, port_messages.ECSubReadReply):
                    be.handle_sub_read_reply(msg)
                else:
                    return False        # a sub-op for the local shard
                return True

        class Shard(ms.Dispatcher):
            def __init__(self, s):
                self.s = s

            def ms_dispatch(self, msg):
                svc = cluster.shards[self.s]
                if isinstance(msg, port_messages.ECSubWrite):
                    reply = svc.handle_sub_write(msg)
                else:
                    reply = svc.handle_sub_read(msg)
                cluster.eps[self.s].connect(msg.src).send_message(reply)
                return True

        for s in range(self.n):
            ep = ms.Messenger.create(self.net, f"osd.{s}", threaded=False)
            ep.add_dispatcher(Primary() if s == 0 else Shard(s))
            self.eps[s] = ep
        # the primary's own shard is local: it still answers through
        # the messenger, from its own endpoint
        self.eps[0].add_dispatcher(Shard(0))

    def _deliver(self, shard, msg):
        self.eps[0].connect(f"osd.{shard}").send_message(msg)
        while sum(ep.poll() for ep in self.eps.values()):
            pass


@pytest.mark.parametrize("name", ["write_read_roundtrip",
                                  "partial_overwrite_rmw",
                                  "kill_and_recover_shard"])
def test_sub_ops_through_the_messenger_equal_direct_wiring(name):
    """ECSubWrite/ECSubRead and their replies sent through the port's
    Messenger leave every store, log and counter as the direct wiring
    does: the EC data plane and the daemon's routing agree."""
    plugin, profile = CODES["tpu_k8m4"]
    direct = Cluster(PORT, plugin, profile)
    wired = MessengerCluster(plugin, profile)
    assert SCENARIOS[name](wired) == SCENARIOS[name](direct)
    assert wired.state() == direct.state()
    assert wired.net._routed > 0


@pytest.mark.parametrize("code,ratio", [("tpu_k3m2", 3.0), ("jerasure", 4.0),
                                        ("clay", 2.5), ("lrc", 3.0)])
def test_recovery_read_rebuilt_ratio(code, ratio):
    """Recovery of one lost shard reads `ratio` helper bytes per byte
    rebuilt (REPAIR_r01.json's 4.0 / 2.5 / 3.0 for the three codes),
    through the compiled repair and never the full rebuild, in both
    packages alike."""
    plugin, profile = CODES[code]
    counts = {}
    for ns in (REF, PORT):
        cl = Cluster(ns, plugin, profile)
        w = cl.backend.sinfo.stripe_width
        full = []
        orig = cl.backend._recover_object_full
        cl.backend._recover_object_full = \
            lambda *a, **kw: (full.append(a), orig(*a, **kw))
        for i in range(3):
            assert cl.write(f"o{i}", 0, payload(4 * w, 50 + i))
        cl.kill(1)
        cl.revive(1)
        for i in range(3):
            assert cl.recover(f"o{i}", [1]) == [True]
        assert full == []
        p = cl.perf.dump()
        counts[ns.name] = p
        assert p["recovery_bytes_read"] == \
            ratio * p["recovery_bytes_rebuilt"]
    assert counts["port"] == counts["ref"]


# --------------------------------------------------------- fallback rule

def _cut_subchunk_reply(cl, shard):
    """Make `shard` answer sub-chunk repair reads one byte short: a
    helper buffer that is not a whole number of its repair blocks."""
    orig = cl.shards[shard].handle_sub_read

    def short(m):
        reply = orig(m)
        for oid in getattr(m, "subchunks", {}):
            if oid in reply.buffers_read:
                reply.buffers_read[oid] = reply.buffers_read[oid][:-1]
        return reply

    cl.shards[shard].handle_sub_read = short


def test_plan_error_falls_back_to_full_rebuild():
    """A helper buffer that does not fit the plan is a plan error: the
    compiled repair raises RepairPlanError (a ValueError, as the
    reference raises) and both packages take the full rebuild, with the
    same bytes everywhere."""
    plugin, profile = CODES["clay"]
    out = {}
    for ns in (REF, PORT):
        cl = Cluster(ns, plugin, profile)
        w = cl.backend.sinfo.stripe_width
        data = payload(4 * w, 60)
        assert cl.write("obj", 0, data)
        before = cl.chunk(1, "obj")
        cl.kill(1)
        cl.revive(1)
        _cut_subchunk_reply(cl, 2)
        full = []
        orig = cl.backend._recover_object_full
        cl.backend._recover_object_full = \
            lambda *a, **kw: (full.append(a[0]), orig(*a, **kw))
        assert cl.recover("obj", [1]) == [True]
        assert full == ["obj"]
        assert cl.chunk(1, "obj") == before
        out[ns.name] = cl.state()
    assert out["port"] == out["ref"]
    assert issubclass(RepairPlanError, ValueError)


def _wrapper_on_cpu(tables, mat, data):
    # K1's real wrapper: on a cpu tensor it refuses with ValueError
    return bm.gf_matmul_cuda(tables, data, mat.shape[0])


def _raiser(exc):
    def launch(tables, mat, data):
        raise exc
    return launch


@pytest.mark.parametrize("fault,exc_type", [
    ("wrapper", ValueError),
    ("launch", RuntimeError),
    ("build", RuntimeError),
    ("devguard", devguard.DevGuardError),
])
@pytest.mark.parametrize("code", ["tpu_k8m4", "clay"])
def test_kernel_fault_in_repair_propagates(monkeypatch, code, fault,
                                           exc_type):
    """A fault raised by K1's wrapper, its launch, its build or the
    device guard during the compiled repair propagates out of
    recover_object: the full rebuild (which would return the right
    bytes on the CPU) is never entered."""
    plugin, profile = CODES[code]
    cl = Cluster(PORT, plugin, profile)
    w = cl.backend.sinfo.stripe_width
    assert cl.write("obj", 0, payload(4 * w, 70))
    cl.kill(1)
    cl.revive(1)
    full = []
    cl.backend._recover_object_full = lambda *a, **kw: full.append(a)
    fake = {
        "wrapper": _wrapper_on_cpu,
        "launch": _raiser(RuntimeError(
            "gf_matmul_k1 launch failed: an illegal memory access (700)")),
        "build": _raiser(RuntimeError("nvcc failed for gf_matmul.cu")),
        "devguard": _raiser(devguard.DevGuardError(
            "devguard: gf_matmul was handed a tensor on cpu")),
    }[fault]
    monkeypatch.setattr(bm, "gf_matmul", fake)
    with pytest.raises(exc_type):
        cl.recover("obj", [1])
    assert full == []


# ---------------------------------------------------------------- fabric

@pytest.mark.parametrize("code", ["tpu_k3m2", "tpu_k8m4"])
def test_fabric_writes_store_the_host_paths_chunks(code):
    """Writes through the port's ICIFabric over ["cpu"] * 8 (the mesh step,
    each shard fetching its own chunk) store the chunk bytes the host path
    stores, and read back the same; the fabric keeps a HashInfo per shard
    where the host path writes one shared one, so only chunk bytes are
    compared.  Nothing stays staged."""
    from ceph_tpu_torch.dist import ICIFabric

    plugin, profile = CODES[code]
    host = Cluster(PORT, plugin, profile)
    fab = ICIFabric(devices=["cpu"] * 8)
    fabric = Cluster(PORT, plugin, profile)
    for osd in range(fabric.n):
        fab.register_resident(osd)
    fabric.shards = [port_ecb.ECPGShard(PGID, s, fabric.stores[s], fabric.k,
                                        fabric.m, fabric=fab)
                     for s in range(fabric.n)]
    fabric.backend = port_ecb.ECBackend(
        PGID, fabric.ec, whoami=0, acting=list(range(fabric.n)),
        local_shard=fabric.shards[0], send=fabric._send, fabric=fab)
    w = host.backend.sinfo.stripe_width
    objs = {f"o{i}": payload(w * (i + 1) + 7 * i, 100 + i) for i in range(3)}
    for cl in (host, fabric):
        for oid, data in objs.items():
            assert cl.write(oid, 0, data)
        assert cl.write("o2", 3 * w, payload(w, 110))     # aligned append
    assert fab.stats["staged"] == 4 and fab.staged_count() == 0
    for oid in objs:
        assert fabric.read(oid) == host.read(oid)
        for s in range(host.n):
            assert fabric.chunk(s, oid) == host.chunk(s, oid), (oid, s)


# ------------------------------------------------- carried across stores

def test_reference_cluster_carried_across_is_read_and_recovered():
    """A cluster written by the reference, each store carried across with
    MemStore.from_reference: the port's shards load the same log bounds
    from the pgmeta omap (the reference's wire bytes), read every object
    byte for byte, and recover a lost shard to the same store state as
    the reference's own recovery."""
    plugin, profile = CODES["tpu_k8m4"]
    ref = Cluster(REF, plugin, profile)
    w = ref.backend.sinfo.stripe_width
    objs = {f"o{i}": payload(w * (i + 2) + 33 * i, 80 + i) for i in range(4)}
    for oid, data in objs.items():
        assert ref.write(oid, 0, data)
    assert ref.write("o1", 17, payload(w, 90))
    objs["o1"] = objs["o1"][:17] + payload(w, 90) + objs["o1"][17 + w:]
    assert ref.delete("o3")
    del objs["o3"]

    port = Cluster(PORT, plugin, profile)
    port.stores = [port_store.MemStore.from_reference(st)
                   for st in ref.stores]
    port.shards = [port_ecb.ECPGShard(PGID, s, port.stores[s], port.k,
                                      port.m, create=False)
                   for s in range(port.n)]
    port.backend = port._backend()

    def stored(cl):
        # what the stores and the shards' logs hold; the new backend's
        # committed_to starts at 0'0 until peering, in either package
        return {k: v for k, v in cl.state().items() if k != "committed_to"}

    assert stored(port) == stored(ref)
    for s in range(port.n):
        assert [str(v) for v in port.shards[s].log_info()] == \
            [str(v) for v in ref.shards[s].log_info()]
        assert type(port.shards[s].pg_log.log.entries[0]).__module__ == \
            "ceph_tpu_torch.osd.pg_types"
    for oid, data in objs.items():
        assert port.read(oid) == data
    assert isinstance(port.read("o3"), tuple)
    for cl in (ref, port):
        cl.kill(1)
        cl.revive(1)
        for oid in objs:
            assert cl.recover(oid, [1]) == [True]
        assert all(cl.chunk(1, oid) for oid in objs)
    assert stored(port) == stored(ref)


def test_from_reference_copies_read_errors_and_trim_bounds():
    """The trimmed log's tail rides across too: with the log trimmed at
    osd_max_pg_log_entries, the carried shards report the reference's
    (head, tail) and the omap keeps the same kept keys."""
    from ceph_tpu.common.options import global_config as ref_config
    from ceph_tpu_torch.common.options import global_config as port_config
    saved = {}
    try:
        for cfg in (ref_config(), port_config()):
            saved[id(cfg)] = (cfg["osd_max_pg_log_entries"],
                              cfg["osd_min_pg_log_entries"])
            cfg.set("osd_max_pg_log_entries", 6)
            cfg.set("osd_min_pg_log_entries", 3)
        out = {}
        for ns in (REF, PORT):
            cl = Cluster(ns, *CODES["tpu_k3m2"])
            for i in range(9):
                assert cl.write(f"o{i % 4}", 0, payload(100 + i, i))
            out[ns.name] = cl
        ref, port = out["ref"], out["port"]
        assert port.state() == ref.state()
        assert str(port.shards[1].log_info()[1]) != "0'0"
        ref.stores[2].inject_read_err(port_ecb.pg_cid(PGID),
                                      ref_store.ObjectId("o0", shard=2))
        carried = [port_store.MemStore.from_reference(st)
                   for st in ref.stores]
        assert carried[2]._read_err_objs == {
            (port_ecb.pg_cid(PGID), port_store.ObjectId("o0", shard=2))}
        shards = [port_ecb.ECPGShard(PGID, s, carried[s], port.k, port.m,
                                     create=False)
                  for s in range(port.n)]
        assert [s.log_info() for s in shards] == \
            [s.log_info() for s in port.shards]
    finally:
        for cfg in (ref_config(), port_config()):
            mx, mn = saved[id(cfg)]
            cfg.set("osd_max_pg_log_entries", mx)
            cfg.set("osd_min_pg_log_entries", mn)


# --------------------------------------------------------------- tracing

@pytest.mark.parametrize("ns", [REF, PORT], ids=["ref", "port"])
def test_ec_decode_span_splits_into_stage_and_kernel_children(ns):
    """The degraded read's ec_decode_kernel span carries `stage` (host
    survivor gather) and `kernel` (decode) children, in both packages
    (tests/test_tracing.py's case)."""
    cl = Cluster(ns, *CODES["tpu_k3m2"])
    tracer = ns.tracing.Tracer("osd.0")
    cl.backend.tracer = tracer
    data = payload(2 * cl.backend.sinfo.stripe_width)
    assert cl.write("obj", 0, data)
    cl.kill(1)
    out = {}
    cl.backend.objects_read_and_reconstruct(
        {"obj": (0, 0)}, lambda r, e: out.update(results=r, errors=e),
        trace=ns.tracing.new_trace())
    assert out["results"]["obj"] == data
    spans = tracer.dump()
    parents = [s for s in spans if s["name"] == "ec_decode_kernel"]
    assert len(parents) == 1
    kids = [s for s in spans if s["parent"] == parents[0]["span_id"]]
    assert sorted(k["name"] for k in kids) == ["kernel", "stage"]
    for k in kids:
        assert 0 <= k["duration"] <= parents[0]["duration"] + 1e-6
    node = [n for n in ns.tracing.span_tree(spans)
            if n["name"] == "ec_decode_kernel"]
    assert node and len(node[0]["children"]) == 2


def test_ec_encode_span_on_traced_writes():
    """A traced write opens one ec_encode_kernel span per encode, in both
    packages, with the same event text."""
    events = {}
    for ns in (REF, PORT):
        cl = Cluster(ns, *CODES["tpu_k8m4"])
        tracer = ns.tracing.Tracer("osd.0")
        cl.backend.tracer = tracer
        w = cl.backend.sinfo.stripe_width
        done = []
        cl.backend.submit_transaction(
            "obj", [("write", 0, payload(3 * w, 5))], done.append,
            trace=ns.tracing.new_trace())
        assert done == [True]
        spans = [s for s in tracer.dump() if s["name"] == "ec_encode_kernel"]
        events[ns.name] = [[e["event"] for e in s["events"]] for s in spans]
    assert events["port"] == events["ref"] == [[f"bytes={3 * w} k=8 m=4"]]
