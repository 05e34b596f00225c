"""The port's cluster log held to the reference's.

The four cases of tests/test_cluster_log.py run on
`ceph_tpu.testing.MiniCluster` and on
`ceph_tpu_torch.testing.MiniCluster(device="cpu")` (pump mode, one
simulated clock) and compare at tolerance 0: an operator's `log` and
`log last` with its level filter and `log counts`; an OSD's `clog`
line flushed on the tick, acked (its buffer trimmed) and deduplicated
by seq on a resend; a failed OSD, a scrub inconsistency on a
replicated pool and its repair, all landing in `log last` without an
operator command; and `log last` answering the same from the surviving
quorum after the leader dies.  What is compared is each entry's name,
level, text and seq, and the mon's own entries' stamps, which come from
the simulated clock; a daemon's entry is stamped from the wall clock,
and that stamp alone is masked.
"""
import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.osd.ec_backend import pg_cid as ref_pg_cid
from ceph_tpu.store import ObjectId as RefObjectId
from ceph_tpu.store import Transaction as RefTransaction
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.common.log_client import LogClient
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.msg.messages import MLogAck
from ceph_tpu_torch.osd.ec_backend import pg_cid as port_pg_cid
from ceph_tpu_torch.store import ObjectId as PortObjectId
from ceph_tpu_torch.store import Transaction as PortTransaction
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NS = {
    "ref": dict(cluster=RefCluster, config=ref_config, pg_cid=ref_pg_cid,
                oid=RefObjectId, tx=RefTransaction, kw={}),
    "port": dict(cluster=PortCluster, config=port_config,
                 pg_cid=port_pg_cid, oid=PortObjectId, tx=PortTransaction,
                 kw={"device": "cpu"}),
}


def both(scenario):
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


def entries(r, n=50, level="debug"):
    rc, outs, out = r.mon_command({"prefix": "log last", "num": n,
                                   "level": level})
    assert rc == 0, outs
    return [{k: v for k, v in e.items()
             if k != "stamp" or e["name"].startswith("mon.")}
            for e in out]


def cluster(ns, timeout=30.0, **kw):
    c = ns["cluster"](threaded=False, **kw, **ns["kw"])
    c.pump()
    c.wait_all_up()
    return c, c.rados(timeout=timeout)


def locate(c, r, pool_name, oid):
    pid = r.pool_lookup(pool_name)
    m = c.mon.osdmap
    raw = m.object_locator_to_pg(oid, pid)
    pg = m.pools[pid].raw_pg_to_pg(raw)
    _, _, acting, primary = m.pg_to_up_acting_osds(raw)
    return pg, acting, primary


def test_operator_log_and_log_last():
    def s(ns):
        c, r = cluster(ns, n_osd=3)
        try:
            rc, outs, _ = r.mon_command({"prefix": "log",
                                         "logtext": "hello cluster"})
            assert rc == 0, outs
            c.pump()
            rc_usage = r.mon_command({"prefix": "log"})[:2]
            counts = r.mon_command({"prefix": "log counts"})
            return (rc, outs, entries(r), entries(r, level="error"),
                    entries(r, n=1), rc_usage, counts)
        finally:
            c.shutdown()
    _rc, _outs, every, errors, last, usage, counts = both(s)
    assert any(e["text"] == "hello cluster" and e["name"] ==
               "client.admin" and e["level"] == "info" for e in every)
    assert not any(e["text"] == "hello cluster" for e in errors)
    assert last == every[-1:]
    assert usage == (-22, "usage: log <text>")
    assert counts[0] == 0 and counts[2].get("info", 0) >= 1


def test_daemon_clog_flush_and_ack():
    """An OSD's clog entry reaches `log last` via the tick flush, the
    ack trims the client buffer, and a resend does not duplicate it."""
    def s(ns):
        c, r = cluster(ns, n_osd=3)
        try:
            d = c.osds[0]
            d.clog.warn("something odd happened")
            pending = [d.clog.pending()]
            for i in range(6):
                c.tick(100.0 + i)
            pending.append(d.clog.pending())
            first = entries(r)
            d.clog.flush()
            c.pump()
            again = entries(r)
            return pending, first, again
        finally:
            c.shutdown()
    pending, first, again = both(s)
    assert pending == [1, 0]
    mine = [e for e in first if e["text"] == "something odd happened"]
    assert mine == [{"seq": 0, "name": "osd.0", "level": "warn",
                     "text": "something odd happened"}]
    assert again == first


def test_log_client_resend_window_and_ack_filter():
    """The client alone: every flush resends the un-acked window, an
    ack for another name is ignored, an ack trims through its seq."""
    sent = []
    lc = LogClient("osd.7", sent.append)
    lc.flush()
    for i in range(3):
        lc.info(f"line {i}")
    lc.flush()
    lc.flush()
    assert [len(m.entries) for m in sent] == [3, 3]
    assert [e["seq"] for e in sent[0].entries] == [0, 1, 2]
    lc.handle_ack(MLogAck(name="osd.8", last_seq=2))
    assert lc.pending() == 3
    lc.handle_ack(MLogAck(name="osd.7", last_seq=1))
    assert lc.pending() == 1
    lc.flush()
    assert [e["text"] for e in sent[-1].entries] == ["line 2"]


def test_osd_failure_scrub_and_repair_in_log():
    """A failed OSD, a scrub inconsistency and its repair all land in
    the cluster log with no operator log command."""
    def s(ns):
        g = ns["config"]()
        saved = {k: g[k] for k in ("osd_scrub_min_interval",
                                   "osd_deep_scrub_interval")}
        g.set("osd_scrub_min_interval", 30.0)
        g.set("osd_deep_scrub_interval", 60.0)
        c, r = cluster(ns, n_osd=4)
        try:
            r.pool_create("p", pg_num=4)
            io = r.open_ioctx("p")
            payload = b"log-me" * 700
            io.write_full("victim", payload)
            c.pump()
            pg, acting, primary = locate(c, r, "p", "victim")
            replica = next(o for o in acting if o != primary)
            c.osds[replica].store.queue_transaction(
                ns["tx"]().write(ns["pg_cid"](pg), ns["oid"]("victim"), 0,
                                 b"ROTROTRO"))
            dead = next(o for o in range(4)
                        if o not in acting and o != primary)
            c.kill_osd(dead)
            t = 1000.0
            for _ in range(50):
                t += 5.0
                c.tick(t)
                if c.mon.osdmap.is_down(dead) and \
                        c.osds[replica].pgs[pg].shard.read("victim") == \
                        payload:
                    break
            for _ in range(6):
                t += 5.0
                c.tick(t)
            return str(pg), dead, t, entries(r, n=100)
        finally:
            for k, v in saved.items():
                g.set(k, v)
            c.shutdown()
    pg, dead, _t, got = both(s)
    texts = [e["text"] for e in got]
    assert f"osd.{dead} marked down after failure reports from its " \
        "peers" in texts
    assert f"pg {pg} scrub: 1 inconsistent, 1 repaired and re-verified" \
        in texts, texts


def test_log_survives_mon_failover():
    """Entries committed through paxos answer the same from the
    surviving quorum after the leader dies."""
    def s(ns):
        # a short op timeout: the first command after the kill waits
        # it out while the client hunts to a live mon
        c, r = cluster(ns, timeout=3.0, n_osd=3, n_mon=3)
        try:
            rc, outs, _ = r.mon_command({"prefix": "log",
                                         "logtext": "before failover"})
            assert rc == 0, outs
            c.pump()
            before = entries(r)
            leader = c.leader()
            c.kill_mon(leader.rank)
            t = 2000.0
            for _ in range(10):
                t += 3.0
                c.tick(t)
            after = None
            for _ in range(30):
                t += 3.0
                c.tick(t)
                try:
                    out = entries(r)
                except (TimeoutError, AssertionError):
                    continue
                if any(e["text"] == "before failover" for e in out):
                    after = [e for e in out
                             if e["text"] == "before failover"]
                    break
            live = {rank: [e["text"] for e in mn.logmon.summary[
                "entries"]] for rank, mn in c.mons.items()
                if rank != leader.rank}
            return leader.rank, before, after, live
        finally:
            c.shutdown()
    rank, before, after, live = both(s)
    assert rank == 0
    assert after == [e for e in before if e["text"] == "before failover"]
    assert len(set(map(tuple, live.values()))) == 1
