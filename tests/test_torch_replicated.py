"""The port's ReplicatedBackend, ReplicatedPGShard and SnapMapper held to
the reference's.

Each scenario runs twice on the same seeded inputs: once through
`ceph_tpu.osd.replicated_backend` over the reference's MemStore, once
through `ceph_tpu_torch.osd.replicated_backend` over the port's.  One PG
on three OSDs (a primary and two replicas), its RepOpWrite / RepOpReply
traffic wired directly between the backend and the replica shards.  Each
case compares, at tolerance 0, what the scenario observed (commit
outcomes, reads, xattrs, omap, scrub maps, inventories, push payloads,
stat summaries), every store's objects with their bytes, xattrs and omap
(the pgmeta object's log keys among them), every shard's log bounds and
entries, and each shard's SnapMapper index and purged cursor.  Values are
compared as plain data: a struct becomes its type name and fields, so a
reference EVersion and the port's compare by value.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu import store as ref_store
from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.osd import pg_types as ref_pg_types
from ceph_tpu.osd import replicated_backend as ref_rb
from ceph_tpu.osd import snap_mapper as ref_sm
from ceph_tpu.osd.types import PG as RefPG
from ceph_tpu_torch import store as port_store
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.osd import pg_types as port_pg_types
from ceph_tpu_torch.osd import replicated_backend as port_rb
from ceph_tpu_torch.osd import snap_mapper as port_sm
from ceph_tpu_torch.osd.types import PG as PortPG

REF = SimpleNamespace(name="ref", rb=ref_rb, sm=ref_sm, store=ref_store,
                      messages=ref_messages, pg_types=ref_pg_types,
                      PG=RefPG, config=ref_config)
PORT = SimpleNamespace(name="port", rb=port_rb, sm=port_sm,
                       store=port_store, messages=port_messages,
                       pg_types=port_pg_types, PG=PortPG,
                       config=port_config)


def plain(v):
    """A value both packages can compare: structs by type name and
    fields, containers element by element."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple(plain(getattr(v, f.name))
                      for f in dataclasses.fields(v)))
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(plain(x) for x in v)
    return v


def payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


class RepPG:
    """One replicated PG on OSDs 0 (primary), 1 and 2 of one package;
    `alive[o]` False makes sends to `o` fail, `held[o]` parks them."""

    def __init__(self, ns, pg=(1, 0)):
        self.ns = ns
        self.pgid = ns.PG(*pg)
        self.stores = [self._store() for _ in range(3)]
        self.shards = [ns.rb.ReplicatedPGShard(self.pgid, st)
                       for st in self.stores]
        self.alive = [True] * 3
        self.wire: list = []
        self.held: dict[int, list] = {}
        self.backend = ns.rb.ReplicatedBackend(
            self.pgid, 0, [0, 1, 2], self.shards[0], send=self._send,
            epoch=3)

    def _store(self):
        st = self.ns.store.MemStore()
        st.mkfs()
        st.mount()
        return st

    def _send(self, osd, msg) -> bool:
        if not self.alive[osd]:
            return False
        self.held.get(osd, self.wire).append((osd, msg))
        return True

    def _deliver(self, osd, msg):
        assert isinstance(msg, self.ns.messages.RepOpWrite)
        self.backend.handle_rep_reply(
            self.shards[osd].handle_rep_write(msg, osd))

    def pump(self):
        """Deliver what is on the wire, after the sender returned (as a
        messenger does)."""
        while self.wire:
            self._deliver(*self.wire.pop(0))

    def release(self, osd):
        for o, m in self.held.pop(osd, []):
            self._deliver(o, m)

    def submit(self, oid, muts, snapc=None):
        out = []
        self.backend.submit_transaction(oid, muts, out.append,
                                        snapc=snapc)
        self.pump()
        return out

    def state(self) -> dict:
        stores = []
        for st in self.stores:
            objs = {}
            for cid in st.list_collections():
                for o in st.collection_list(cid):
                    objs[(cid, o.name, o.snap, o.shard)] = (
                        bytes(st.read(cid, o)), plain(st.getattrs(cid, o)),
                        plain(st.omap_get(cid, o)))
            stores.append(objs)
        logs = [(str(s.log_info()[0]), str(s.log_info()[1]),
                 [str(e) for e in s.pg_log.log.entries])
                for s in self.shards]
        snaps = [(s.snap_mapper.dump(), s.purged_snaps().to_list())
                 for s in self.shards]
        return {"stores": stores, "logs": logs, "snaps": snaps,
                "last_version": str(self.backend.last_version),
                "in_flight": sorted(self.backend.in_flight)}


# ------------------------------------------------------------- scenarios
# Each takes a RepPG and returns what it observed, in plain values.

def s_data_ops(pg):
    """write, writefull, append (resolved at the primary), truncate up
    and down, zero within and past the size, create, delete and a
    recreate over the whiteout."""
    seen = []
    a, b = payload(1, 5000), payload(2, 700)
    seen.append(pg.submit("obj", [("writefull", a)]))
    seen.append(pg.submit("obj", [("append", b)]))
    seen.append(pg.submit("obj", [("write", 100, b"X" * 50)]))
    seen.append(pg.submit("obj", [("truncate", 1234)]))
    seen.append(pg.submit("obj", [("truncate", 2000)]))
    seen.append(pg.submit("obj", [("zero", 10, 20), ("zero", 1900, 500)]))
    seen.append([s.read("obj") for s in pg.shards])
    seen.append(pg.submit("empty", [("create",)]))
    seen.append(pg.submit("gone", [("writefull", b"short-lived")]))
    seen.append(pg.submit("gone", [("delete",)]))
    seen.append([(s.exists("gone"), s.objects(), plain(s.inventory()))
                 for s in pg.shards])
    seen.append(pg.submit("gone", [("write", 0, b"again")]))
    seen.append([s.read("gone") for s in pg.shards])
    seen.append([s.object_version("obj") for s in pg.shards])
    return seen


def s_metadata_ops(pg):
    """xattrs, omap keys, the omap header and a compound op of all of
    them; the reads a primary serves from its local copy."""
    seen = []
    seen.append(pg.submit("meta", [
        ("writefull", payload(3, 3000)),
        ("setxattrs", {"k1": b"v1", "k2": b"v2"}),
        ("omap_setkeys", {f"key{i:04d}": payload(10 + i, 64)
                          for i in range(40)}),
        ("omap_setheader", b"HEADER")]))
    seen.append(pg.submit("meta", [("rmxattr", "k1"),
                                   ("omap_rmkeys", ["key0003", "key0007"])]))
    seen.append(pg.submit("other", [("omap_setkeys", {"a": b"1"}),
                                    ("omap_setheader", b"H2")]))
    seen.append(pg.submit("other", [("omap_clear",)]))
    for s in pg.shards:
        seen.append((s.getxattrs("meta"), s.getxattr("meta", "k2"),
                     s.omap_get("meta"), s.omap_get_header("meta"),
                     s.omap_get("other"), s.omap_get_header("other")))
        seen.append(s.push_payload("meta"))
        seen.append(plain(s.scrub_map(deep=True)))
        seen.append(plain(s.scrub_map(deep=False)))
        seen.append(s.stat_summary())
    return seen


def s_snapshots(pg):
    """Pool snapshots drive COW clones indexed in the SnapMapper; snap
    reads resolve to clones; clone payloads graft onto a fresh shard;
    trims unindex and remove; the purged cursor records them."""
    b = pg.backend
    seen = [pg.submit("snap", [("writefull", payload(4, 4096)),
                               ("setxattrs", {"x": b"0"})])]
    b.pool_snap_seq, b.pool_snaps = 4, {4: "s4"}
    seen.append(pg.submit("snap", [("write", 0, b"AFTER-S4"),
                                   ("setxattrs", {"x": b"1"})]))
    b.pool_snap_seq, b.pool_snaps = 6, {4: "s4", 6: "s6"}
    seen.append(pg.submit("snap", [("append", b"AFTER-S6")]))
    # a self-managed snap carried only in the client's snapc
    seen.append(pg.submit("snap", [("truncate", 100)],
                          snapc={"seq": 9, "snaps": [8, 9]}))
    seen.append(pg.submit("snap", [("delete",)], snapc={"seq": 12,
                                                        "snaps": [12]}))
    s0 = pg.shards[0]
    seen.append(s0.clone_tags("snap"))
    for snapid in (3, 4, 5, 6, 8, 9, 12, 13):
        res = s0.resolve_snap("snap", snapid)
        seen.append((snapid, res, s0.read_clone("snap", res)
                     if isinstance(res, int) else None))
    clones = s0.clone_payloads("snap")
    seen.append(plain(clones))
    # graft onto a fresh shard of a fourth store: the pushed history is
    # authoritative
    st = pg._store()
    fresh = pg.ns.rb.ReplicatedPGShard(pg.pgid, st)
    fresh.apply_mutations("snap", [("delete",)],
                          s0.pg_log.log.head, [])
    fresh.apply_clone_payloads("snap", clones)
    seen.append((fresh.clone_tags("snap"), fresh.snap_mapper.dump(),
                 plain(fresh.scrub_map())))
    for s in pg.shards:
        seen.append((s.snap_mapper.objects_for_snap(4),
                     s.snap_mapper.objects_for_snap(8)))
        seen.append(s.apply_snap_trim("snap", 4, 4))     # last cover
        seen.append(s.apply_snap_trim("snap", 8, 9))     # one of two
        seen.append(s.apply_snap_trim("snap", 8, 9))     # idempotent
        seen.append(s.apply_snap_trim("snap", 6, 5))     # no such clone
        s.snap_mapper.mark_purged_many([4, 6, 5])
        seen.append((s.clone_tags("snap"), s.snap_mapper.dump(),
                     repr(s.purged_snaps())))
    return seen


def s_log_trim_and_rewrite(pg):
    """Past osd_max_pg_log_entries the durable log trims; a peering log
    rewrite (persist_log) keeps the snap index and purged cursor; a
    reload from the store sees the same bounds and entries."""
    b = pg.backend
    b.pool_snap_seq, b.pool_snaps = 2, {2: "s2"}
    seen = [pg.submit("c", [("writefull", b"pre")])]
    seen.append(pg.submit("c", [("writefull", b"post")]))
    for i in range(30):
        seen.append(pg.submit(f"t{i % 7}", [("writefull",
                                             payload(20 + i, 50 + i))]))
    for s in pg.shards:
        before = s.snap_mapper.dump()
        s.snap_mapper.mark_purged(1)
        s.persist_log()
        again = pg.ns.rb.ReplicatedPGShard(pg.pgid, s.store, create=False)
        seen.append((len(s.pg_log.log), str(s.pg_log.log.tail),
                     before == again.snap_mapper.dump(),
                     again.purged_snaps().to_list(),
                     again.log_info() == s.log_info(),
                     [str(e) for e in again.pg_log.log.entries]))
    return seen


def s_replica_failures(pg):
    """A replica that cannot be reached fails the commit; in-flight ops
    fail on an acting change; a backfill cursor gates the fan-out."""
    seen = [pg.submit("a", [("writefull", b"one")])]
    pg.alive[2] = False
    seen.append(pg.submit("a", [("writefull", b"two")]))
    pg.alive[2] = True
    pg.held[1] = []
    seen.append(pg.submit("b", [("writefull", b"parked")]))
    seen.append(sorted(pg.backend.in_flight))
    out = []
    pg.backend.submit_transaction("c", [("writefull", b"c")], out.append)
    pg.backend.fail_in_flight()
    seen.append(out)
    pg.release(1)                      # late replies find no op
    seen.append(sorted(pg.backend.in_flight))
    pg.backend.backfill_peers[2] = "b"
    seen.append(pg.submit("a", [("writefull", b"before-cursor")]))
    seen.append(pg.submit("z", [("writefull", b"past-cursor")]))
    seen.append([(s.exists("z"), s.exists("a") and s.read("a"))
                 for s in pg.shards])
    return seen


def s_push_roundtrip(pg):
    """A push payload applied to a blank shard through apply_mutations
    makes a copy whose scrub map equals the source's."""
    seen = [pg.submit("p", [("writefull", payload(7, 9000)),
                            ("setxattrs", {"u": b"1"}),
                            ("omap_setkeys", {"o": b"2"}),
                            ("omap_setheader", b"h")])]
    data, attrs, omap, hdr = pg.shards[0].push_payload("p")
    st = pg._store()
    blank = pg.ns.rb.ReplicatedPGShard(pg.pgid, st)
    ver = pg.ns.pg_types.EVersion(*pg.shards[0].object_version("p"))
    seen.append(blank.apply_mutations(
        "p", [("writefull", data), ("setxattrs", attrs),
              ("omap_setkeys", omap), ("omap_setheader", hdr)], ver, []))
    seen.append(plain(blank.scrub_map()) == plain(pg.shards[0].scrub_map()))
    seen.append(blank.apply_write("p", 0, b"", True, ver, []))
    seen.append((blank.exists("p"), plain(blank.inventory())))
    return seen


SCENARIOS = {f.__name__[2:]: f for f in (
    s_data_ops, s_metadata_ops, s_snapshots, s_log_trim_and_rewrite,
    s_replica_failures, s_push_roundtrip)}


@pytest.fixture()
def short_logs():
    """osd_max_pg_log_entries 20 / min 10 in both packages, restored."""
    saved = [(cfg, cfg()["osd_min_pg_log_entries"],
              cfg()["osd_max_pg_log_entries"])
             for cfg in (REF.config, PORT.config)]
    for cfg, _lo, _hi in saved:
        cfg().set("osd_min_pg_log_entries", 10)
        cfg().set("osd_max_pg_log_entries", 20)
    yield
    for cfg, lo, hi in saved:
        cfg().set("osd_min_pg_log_entries", lo)
        cfg().set("osd_max_pg_log_entries", hi)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name, short_logs):
    out = {}
    for ns in (REF, PORT):
        pg = RepPG(ns)
        seen = SCENARIOS[name](pg)
        out[ns.name] = (plain(seen), pg.state())
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1]["stores"] == out["ref"][1]["stores"]
    assert out["port"][1] == out["ref"][1]


def test_port_ran_its_own_modules():
    pg = RepPG(PORT)
    pg.submit("x", [("writefull", b"x")])
    assert type(pg.backend).__module__ == \
        "ceph_tpu_torch.osd.replicated_backend"
    assert type(pg.shards[1].snap_mapper).__module__ == \
        "ceph_tpu_torch.osd.snap_mapper"
    assert type(pg.stores[0]).__module__ == "ceph_tpu_torch.store.memstore"


def test_log_entries_omap_bytes_equal_the_references():
    """The pgmeta omap of every shard holds the reference's keys and
    wire bytes after the same writes (the durable log is shared with
    the EC shard, so either package reloads the other's)."""
    stores = {}
    for ns in (REF, PORT):
        pg = RepPG(ns)
        for i in range(12):
            pg.submit(f"o{i % 5}", [("writefull", payload(i, 100 + i))])
        stores[ns.name] = [
            st.omap_get(pg.shards[0].cid, ns.store.ObjectId("pgmeta"))
            for st in pg.stores]
    assert stores["port"] == stores["ref"]
    # the port reloads a log the reference wrote
    ref_pg = RepPG(REF)
    for i in range(6):
        ref_pg.submit(f"r{i}", [("writefull", b"r" * i)])
    carried = port_store.MemStore.from_reference(ref_pg.stores[1])
    shard = port_rb.ReplicatedPGShard(PortPG(1, 0), carried, create=False)
    assert [str(e) for e in shard.pg_log.log.entries] == \
        [str(e) for e in ref_pg.shards[1].pg_log.log.entries]
    assert str(shard.log_info()) == str(ref_pg.shards[1].log_info())


def test_undecodable_purged_cursor_is_counted():
    """The port reads a corrupt purged cursor as empty, as the reference
    does, and counts it."""
    st = port_store.MemStore()
    st.mkfs()
    st.mount()
    shard = port_rb.ReplicatedPGShard(PortPG(1, 0), st)
    st.queue_transaction(port_store.Transaction().touch(
        shard.cid, port_rb.PGMETA).omap_setkeys(
        shard.cid, port_rb.PGMETA, {"ps": b"\xffnot wire"}))
    n0 = port_sm.PURGED_DECODE_ERRORS["count"]
    assert shard.purged_snaps().to_list() == []
    assert port_sm.PURGED_DECODE_ERRORS["count"] == n0 + 1
