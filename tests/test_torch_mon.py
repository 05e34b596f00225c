"""The port's Monitor held to the reference's, command by command.

Each script runs on a one-rank `ceph_tpu.mon.Monitor` and on the port's
`ceph_tpu_torch.mon.Monitor(device="cpu")`, each over its own
LocalNetwork with the same `build_initial` map (8 OSDs, 2 per host), the
same simulated clock, a stub client subscribed to osdmaps and a stub OSD
endpoint.  Every step sends one wire message (a mon command, a boot, a
failure report, a pg_temp request, a subscription) or ticks the mon,
then pumps both ends.  After each step the test compares, at tolerance
0: the command reply (result, text and the wire bytes of its payload),
the mon's OSDMap as wire bytes, every MMap frame the subscriber
received (its send sequence number aside, which counts every message
the process sent), and the OSD monitor's first and last committed
epochs.  The scripts cover the erasure-code profile and pool commands,
`osd down`/`out`/`in`, pg_temp pins and clears, failure reports, the
down-out interval, boots, subscriptions, upmap items, error replies,
map-history trimming and the mon-level reads (`status`, `health`,
`pg stat`, `df`).
"""
import dataclasses

import pytest

from ceph_tpu.common.options import global_config as ref_config
from ceph_tpu.mon import monitor as ref_monitor
from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu.msg import messages as ref_messages
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.osd import types as ref_types
from ceph_tpu_torch.common.options import global_config as port_config
from ceph_tpu_torch.mon import monitor as port_monitor
from ceph_tpu_torch.msg import encoding as port_wire
from ceph_tpu_torch.msg import messages as port_messages
from ceph_tpu_torch.msg import messenger as port_messenger
from ceph_tpu_torch.osd import types as port_types

port_wire.ensure_registered()

PKGS = {
    "ref": dict(monitor=ref_monitor, wire=ref_wire, msgs=ref_messages,
                ms=ref_messenger, types=ref_types, config=ref_config,
                kw={}),
    "port": dict(monitor=port_monitor, wire=port_wire,
                 msgs=port_messages, ms=port_messenger, types=port_types,
                 config=port_config, kw={"device": "cpu"}),
}

K8M4 = {"plugin": "tpu", "k": "8", "m": "4", "technique": "reed_sol_van",
        "crush-failure-domain": "host"}
K2M2 = {"plugin": "tpu", "k": "2", "m": "2",
        "crush-failure-domain": "osd"}


class Harness:
    """One package's mon, a subscribed stub client and a stub OSD."""

    def __init__(self, kind: str):
        p = self.p = PKGS[kind]
        self.now = [1000.0]
        self.net = p["ms"].LocalNetwork()
        m, w = p["monitor"].build_initial(8, osds_per_host=2)
        self.mon = p["monitor"].Monitor(
            self.net, initial_map=m, initial_wrapper=w, threaded=False,
            clock=lambda: self.now[0], **p["kw"])
        self.mon.init()
        self.frames = []
        self.acks = []
        harness = self

        class Stub(p["ms"].Dispatcher):
            def ms_dispatch(self, msg):
                if msg.type_name == "MMap":
                    # seq comes from a process-wide send counter in
                    # each package: not part of what is compared
                    harness.frames.append(p["wire"].encode_message(
                        dataclasses.replace(msg, seq=0)))
                elif msg.type_name == "MMonCommandAck":
                    harness.acks.append(msg)
                return True
        self.client = p["ms"].Messenger.create(self.net, "client.1",
                                               threaded=False)
        self.client.add_dispatcher(Stub())
        self.osd = p["ms"].Messenger.create(self.net, "osd.9",
                                            threaded=False)
        self.osd.add_dispatcher(Stub())
        self.tid = 0
        self.send("client", "MMonSubscribe", what="osdmap", start=1)

    def pump(self):
        for _ in range(5):
            n = self.mon.ms.poll() + self.client.poll() + self.osd.poll()
            if not n:
                break

    def send(self, who, type_name, **fields):
        ms = self.client if who == "client" else self.osd
        msg = getattr(self.p["msgs"], type_name)(**fields)
        ms.connect("mon.0").send_message(msg)
        self.pump()

    def command(self, **cmd):
        self.tid += 1
        self.acks.clear()
        self.send("client", "MMonCommand", tid=self.tid, cmd=cmd)
        (ack,) = self.acks
        return ack

    def pg(self, pool, ps):
        return self.p["types"].PG(pool, ps)

    def _payload(self, outb):
        try:
            return self.p["wire"].encode(outb)
        except Exception:
            return repr(outb)

    def state(self, reply=None) -> tuple:
        om = self.mon.osdmon
        rep = None if reply is None else (
            reply.tid, reply.result, reply.outs, self._payload(reply.outb))
        out = (rep, self.p["wire"].encode(self.mon.osdmap),
               list(self.frames), om.get_first_committed(),
               om.get_last_committed())
        self.frames.clear()
        return out


def s_ec_pool(h):
    out = [h.state(h.command(prefix="osd erasure-code-profile set",
                             name="k8m4", profile=dict(K8M4)))]
    out.append(h.state(h.command(prefix="osd pool create", pool="ec",
                                 pg_num=32, pool_type="erasure",
                                 erasure_code_profile="k8m4")))
    for var in ("size", "min_size", "pg_num", "crush_rule",
                "erasure_code_profile"):
        out.append(h.state(h.command(prefix="osd pool get", pool="ec",
                                     var=var)))
    out.append(h.state(h.command(prefix="osd erasure-code-profile get",
                                 name="k8m4")))
    out.append(h.state(h.command(prefix="osd erasure-code-profile ls")))
    out.append(h.state(h.command(prefix="osd dump")))
    out.append(h.state(h.command(prefix="osd pool ls")))
    for ps in (0, 7, 31):
        out.append(h.state(h.command(prefix="pg map", pgid=f"1.{ps:x}")))
    return out


def s_default_profile_pool(h):
    return [h.state(h.command(prefix="osd pool create", pool="d",
                              pg_num=8, pool_type="erasure")),
            h.state(h.command(prefix="osd pool get", pool="d",
                              var="size")),
            h.state(h.command(prefix="osd pool create", pool="r",
                              pg_num=8))]


def s_osd_state(h):
    out = []
    for cmd in ("osd down", "osd down", "osd out", "osd out", "osd in",
                "osd in"):
        out.append(h.state(h.command(prefix=cmd, ids=[3])))
    out.append(h.state(h.command(prefix="osd down", ids=[1, 2])))
    out.append(h.state(h.command(prefix="osd stat")))
    out.append(h.state(h.command(prefix="osd ls")))
    out.append(h.state(h.command(prefix="osd tree")))
    return out


def s_pg_temp(h):
    out = [h.state(h.command(prefix="osd erasure-code-profile set",
                             name="k2m2", profile=dict(K2M2))),
           h.state(h.command(prefix="osd pool create", pool="ec",
                             pg_num=8, pool_type="erasure",
                             erasure_code_profile="k2m2"))]
    pin = [5, 6, 7, 0]
    for osds in (pin, pin, [], [], [1, 2, 3, 4]):
        h.send("osd", "MOSDPGTemp", pgid=h.pg(1, 3), from_osd=5,
               epoch=h.mon.osdmap.epoch, osds=list(osds))
        out.append(h.state())
    out.append(h.state(h.command(prefix="osd down", ids=[1, 2, 3, 4])))
    # a pin whose members are all down must not clear the override
    h.send("osd", "MOSDPGTemp", pgid=h.pg(1, 3), from_osd=5,
           epoch=h.mon.osdmap.epoch, osds=[1, 2, 3, 4])
    out.append(h.state())
    h.send("osd", "MOSDPGTemp", pgid=h.pg(1, 99), from_osd=5,
           epoch=h.mon.osdmap.epoch, osds=[5, 6])
    out.append(h.state())
    out.append(h.state(h.command(prefix="pg map", pgid="1.3")))
    return out


def s_failure_down_out_boot(h):
    out = []
    for reporter in (2, -1, 77, 0):
        h.send("osd", "MOSDFailure", target_osd=2, reporter=reporter)
        out.append(h.state())
    h.now[0] += 30.0        # past osd_heartbeat_grace: report expires
    h.send("osd", "MOSDFailure", target_osd=2, reporter=1)
    out.append(h.state())
    h.send("osd", "MOSDFailure", target_osd=2, reporter=0)
    out.append(h.state())
    h.mon.tick(h.now[0] + 10.0)         # inside the down-out interval
    h.pump()
    out.append(h.state())
    interval = h.p["config"]()["mon_osd_down_out_interval"]
    h.now[0] += interval + 1.0
    h.mon.tick()
    h.pump()
    out.append(h.state())
    h.send("osd", "MOSDBoot", osd=2)
    out.append(h.state())
    h.send("osd", "MOSDBoot", osd=2)
    out.append(h.state())
    h.send("osd", "MOSDBoot", osd=9)
    out.append(h.state())
    return out


def s_subscriptions(h):
    out = [h.state()]
    out.append(h.state(h.command(prefix="osd pool create", pool="x",
                                 pg_num=8)))
    h.send("client", "MMonSubscribe", what="osdmap",
           start=h.mon.osdmap.epoch + 1)
    out.append(h.state())
    h.send("client", "MMonSubscribe", what="osdmap", start=2)
    out.append(h.state())
    h.send("client", "MMonSubscribe", what="config")
    out.append(h.state())
    out.append(h.state(h.command(prefix="osd down", ids=[4])))
    return out


def s_upmap(h):
    h.command(prefix="osd pool create", pool="p", pg_num=8)
    return [h.state(h.command(prefix="osd pg-upmap-items", pgid="1.2",
                              id_pairs=[[0, 5]])),
            h.state(h.command(prefix="osd pg-upmap-items", pgid="1.9",
                              id_pairs=[[0, 5]])),
            h.state(h.command(prefix="pg map", pgid="1.2")),
            h.state(h.command(prefix="osd rm-pg-upmap-items",
                              pgid="1.2")),
            h.state(h.command(prefix="osd upmap-batch",
                              set=[["1.1", [[1, 6]]]], rm=[]))]


def s_errors(h):
    return [h.state(h.command(prefix="osd erasure-code-profile set",
                              name="p", profile=dict(K2M2))),
            h.state(h.command(prefix="osd erasure-code-profile set",
                              name="p", profile=dict(K8M4))),
            h.state(h.command(prefix="osd erasure-code-profile set",
                              name="bad", profile={"plugin": "tpu",
                                                   "k": "0"})),
            h.state(h.command(prefix="osd pool create", pool="e",
                              pool_type="erasure",
                              erasure_code_profile="nope")),
            h.state(h.command(prefix="osd pool create", pool="e2",
                              pool_type="bogus")),
            h.state(h.command(prefix="osd down", ids=[0, 999])),
            h.state(h.command(prefix="osd down", ids=["abc"])),
            h.state(h.command(prefix="osd setmaxosd")),
            h.state(h.command(prefix="pg map", pgid="garbage")),
            h.state(h.command(prefix="no such command")),
            h.state(h.command(prefix="osd pool get", pool="none",
                              var="size"))]


def s_history(h):
    cfg = h.p["config"]()
    old = cfg["mon_min_osdmap_epochs"]
    cfg.set("mon_min_osdmap_epochs", 5)
    try:
        out = []
        for i in range(12):
            out.append(h.state(h.command(prefix="osd pool create",
                                         pool=f"p{i}", pg_num=8)))
        e = h.mon.osdmap.epoch
        for epoch in (e, e - 5, e - 6, 1):
            out.append(h.state(h.command(prefix="osd getmap",
                                         epoch=epoch)))
        h.send("client", "MMonSubscribe", what="osdmap", start=2)
        out.append(h.state())
        return out
    finally:
        cfg.set("mon_min_osdmap_epochs", old)


def s_cluster_reads(h):
    h.command(prefix="osd erasure-code-profile set", name="k2m2",
              profile=dict(K2M2))
    h.command(prefix="osd pool create", pool="ec", pg_num=8,
              pool_type="erasure", erasure_code_profile="k2m2")
    h.send("osd", "MPGStats", osd=0, epoch=h.mon.osdmap.epoch,
           stamp=h.now[0], kb_total=1 << 20, kb_used=10, kb_avail=2,
           pg_stats={"1.0": {"state": "active+clean", "num_objects": 3,
                             "bytes": 300, "store_bytes": 600,
                             "acting": [0, 1, 2, 3], "primary": True}})
    h.command(prefix="osd down", ids=[5])
    return [h.state(h.command(prefix=p)) for p in
            ("status", "health", "health detail", "pg stat", "pg dump",
             "df")]


SCRIPTS = {f.__name__[2:]: f for f in (
    s_ec_pool, s_default_profile_pool, s_osd_state, s_pg_temp,
    s_failure_down_out_boot, s_subscriptions, s_upmap, s_errors,
    s_history, s_cluster_reads)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_monitor_equals_reference(name):
    got = {}
    for kind in ("ref", "port"):
        h = Harness(kind)
        try:
            got[kind] = [h.state()] + SCRIPTS[name](h)
        finally:
            h.mon.shutdown()
    assert len(got["port"]) == len(got["ref"])
    for i, (want, have) in enumerate(zip(got["ref"], got["port"])):
        assert have == want, (name, i)
