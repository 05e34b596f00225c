"""The port's vstart shell (ceph_tpu_torch.tools.vstart) beside the JAX
package's, on the CPU.

Each tour runs the same commands through both shells (the port's with
`device="cpu"`: K1 and K3 run their plain versions) and compares what
each command printed, line for line, after the masks below.  Each mask
names what it hides and why it differs between two runs:

* ``timestamp``, ``stamp``: wall-clock times (crash ids are a timestamp
  and the entity, so they go with it);
* ``uuid``: fsids, request and trace ids;
* ``gid``: an MDS daemon's gid (random per daemon);
* ``port``: the TCP ports the gateways bound;
* ``source``: a backtrace's file path and line numbers (the two
  packages' sources differ);
* ``score``: the balancer's score, which reads the mgr's map while the
  upmap epoch it just submitted is still on its way (a thread race);
* ``port counters``: the daemons' counters only the port keeps
  (PERF_ONLY below), dropped from `perf dump` and telemetry;
* ``perf values``: `perf dump`'s numbers (latencies, histograms, and
  op counts that follow the threads' timing): the keys are compared;
* ``reboot``: after `osd down` of a live OSD the port's OSD boots again
  (the port's documented rule, ROADMAP Queue 3) where the
  reference's stays down, so `status`'s health, OSD and PG lines after
  it differ; the test checks the port's instead.

The tours: tests/test_vstart_cli.py's, tests/test_crash_telemetry.py's
observability tour, an EC tour on a `tpu` k=2 m=1 pool of 4 OSDs whose
stored shards must equal the reference's, an MDS tour with a standby,
and an rgw multisite tour.  Then `main(["-c", ...])`, the messenger's
`ms_type`, the OSD admin socket's `config diff` and the OSD's op-queue
classes.
"""
import hashlib
import io
import json
import re
import time
import urllib.error
import urllib.request

import pytest

from ceph_tpu.common import options as ref_options
from ceph_tpu.msg import messenger as ref_messenger
from ceph_tpu.osd import balancer as ref_balancer
from ceph_tpu.tools import vstart as ref_vstart
from ceph_tpu_torch.common import options
from ceph_tpu_torch.common.admin_socket import admin_command
from ceph_tpu_torch.msg import messenger
from ceph_tpu_torch.tools import vstart
from test_torch_balancer import ScalarTables

#: counters only the port's daemons keep (fault and recovery counts the
#: port's smoke holds to 0)
PORT_ONLY = ("backfill_push_in", "push_in", "push_in_bytes",
             "push_in_clone_bytes", "queued_op_failures",
             "recovery_full_rebuild", "recovery_push_errors",
             "tick_errors")

MASKS = [
    ("timestamp", re.compile(
        r"\d{4}-\d\d-\d\d[T ]\d\d:\d\d:\d\d(\.\d+)?Z?"), "<timestamp>"),
    ("stamp", re.compile(r'("stamp": )[0-9.e+]+'), r"\1<stamp>"),
    ("uuid", re.compile(
        r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"),
     "<uuid>"),
    ("gid", re.compile(r'(gid[": ]+)\d+'), r"\1<gid>"),
    ("port", re.compile(r"(127\.0\.0\.1)?:\d{2,5}\b"), r"\1:<port>"),
    ("source", re.compile(
        r'File \\"[^"\\]*?([\w.]+\.py)\\", line \d+'),
     r'File \"\1\", line <n>'),
    ("score", re.compile(r"(score[=: ]+)\{[^}]*\}"), r"\1<score>"),
]


def mask(text: str) -> list[str]:
    for _name, pat, rep in MASKS:
        text = pat.sub(rep, text)
    out = []
    for line in text.splitlines():
        key = line.strip().split(":")[0].strip('"')
        if key in PORT_ONLY:           # port counters
            continue
        out.append(line)
    return out


def perf_keys(text: str) -> dict:
    """`perf dump` with the values masked: each daemon's counter names,
    the port's own dropped (perf values, port counters)."""
    return {d: sorted(k for k in v if k not in PORT_ONLY)
            for d, v in json.loads(text).items()}


@pytest.fixture
def ref_scalar(monkeypatch):
    """The reference balancer's tables from its scalar mapper: a JAX
    compile per map shape costs seconds (as tests/test_torch_balancer.py
    does)."""
    monkeypatch.setattr(ref_balancer, "OSDMapMapping", ScalarTables)


def tour(shell, lines, inspect=None, prepare=None, **kw):
    """[(command, printed text)] of one shell; `prepare(sh)` runs before
    the first command, `inspect(sh)` before the shell closes."""
    out = io.StringIO()
    sh = shell(out=out, **kw)
    got = []
    try:
        if prepare is not None:
            prepare(sh)
        for line in lines:
            start = len(out.getvalue())
            alive = sh.run_line(line)
            got.append((line, out.getvalue()[start:]))
            if not alive:
                break
        extra = inspect(sh) if inspect is not None else None
    finally:
        sh.close()
    return got, extra


def both(lines, inspect=None, prepare=None, **kw):
    ref, rx = tour(ref_vstart.VstartShell, lines, inspect, prepare, **kw)
    port, px = tour(vstart.VstartShell, lines, inspect, prepare,
                    device="cpu", **kw)
    assert [c for c, _ in port] == [c for c, _ in ref]
    return ref, port, rx, px


def assert_same(ref, port, skip=()):
    for (cmd, want), (_, got) in zip(ref, port):
        if cmd in skip:
            continue
        if cmd == "perf dump":
            assert perf_keys(got) == perf_keys(want)
            continue
        assert mask(got) == mask(want), cmd


def test_vstart_shell_tour(tmp_path, ref_scalar):
    """tests/test_vstart_cli.py's tour through both shells."""
    src = tmp_path / "payload"
    src.write_bytes(b"cli payload " * 10)
    lines = [
        "osd stat", "osd pool create p 8", f"put p obj {src}",
        f"get p obj {tmp_path / 'back'}", "ls p", "stat p obj",
        "pg map 0.1", "pg scrub 0.1", "balance",
        f"serve put p art {src}", f"serve get p art {tmp_path / 'art_back'}",
        "serve stat p art", "serve pages p art shard0 0",
        "osd down 1", "osd in 1", "status", "perf dump",
        "bogus command here", "quit"]
    ref, port, _, _ = both(lines, n_osd=4, osds_per_host=1)
    assert_same(ref, port, skip={"status"})
    # reboot: the reference's osd.1 stays down, the port's boots again
    st_ref, st_port = ref[-4][1], port[-4][1]
    assert mask(st_port)[1] == mask(st_ref)[1]          # mon
    assert mask(st_port)[4:] == mask(st_ref)[4:]        # pools, balancer
    assert "4 osds: 3 up, 4 in" in st_ref
    assert re.search(r"4 osds: [34] up, 4 in", st_port)
    text = "".join(t for _, t in port)
    assert "4 osds: 4 up" in text
    assert "pool 'p' created" in text
    assert (tmp_path / "back").read_bytes() == src.read_bytes()
    assert '"inconsistent": []' in text
    assert "marked down osd.1" in text
    assert '"op"' in text
    assert "published art epoch 1" in text
    assert (tmp_path / "art_back").read_bytes() == src.read_bytes()
    assert '"ragged_pages": 1' in text
    assert "page 0: 120 B sha256 " in text
    assert port[-2][1].startswith("Error:")
    assert port[-1] == ("quit", "")


def test_vstart_observability_verbs():
    """tests/test_crash_telemetry.py's vstart tour through both shells."""
    lines = ["crash ls", "crash-osd 2", "crash ls", "health",
             "crash archive-all", "health", "telemetry show", "insights",
             "crash prune 0", "crash ls"]
    ref, port, _, _ = both(lines, n_osd=3, osds_per_host=1)
    assert_same(ref, port)
    text = "".join(t for _, t in port)
    assert "osd.2 crashed" in text
    assert '"entity_name": "osd.2"' in text
    assert "RECENT_CRASH" in text
    assert "HEALTH_OK" in text
    assert '"cluster_id"' in text
    assert '"window_seconds"' in text


def stored_shards(sh, pid: int) -> dict:
    """sha256 of every stored shard of pool `pid`, by (osd, pg, object,
    shard)."""
    out = {}
    for osd, st in sorted(sh.cluster._stores.items()):
        for cid in st.list_collections():
            if not str(cid).startswith(f"pg_{pid}."):
                continue
            for o in st.collection_list(cid):
                if o.name.startswith("pgmeta") or not o.name:
                    continue
                out[(osd, str(cid), o.name, o.shard)] = \
                    hashlib.sha256(bytes(st.read(cid, o))).hexdigest()
    return out


def test_vstart_ec_tour(tmp_path, ref_scalar):
    """A `tpu` k=2 m=1 pool on 4 OSDs: put, get, a degraded get, a
    scrub and a balancer round; the stored shards equal the
    reference's."""
    data = bytes(range(256)) * 300 + b"tail"
    src = tmp_path / "obj"
    src.write_bytes(data)
    lines = ["osd erasure-code-profile set p21 plugin=tpu k=2 m=1 "
             "crush-failure-domain=host",
             "osd erasure-code-profile get p21",
             "osd pool create ecp 8 erasure p21", f"put ecp o1 {src}",
             f"put ecp o2 {src}", f"get ecp o1 {tmp_path / 'b1'}",
             "pg map 0.0", "pg scrub 0.0", "balance"]
    shards = {}

    def before_kill(sh):
        pid = sh.rados.pool_lookup("ecp")
        shards[sh.__class__.__module__] = stored_shards(sh, pid)
        m = sh.cluster.mon.osdmap
        acting = m.pg_to_up_acting_osds(m.object_locator_to_pg("o1", pid))[2]
        victim = acting[0]
        for line in (f"kill-osd {victim}", f"osd down {victim}",
                     f"get ecp o1 {tmp_path / 'b2'}"):
            sh.run_line(line)
        return victim

    ref, port, rv, pv = both(lines, before_kill, n_osd=4, osds_per_host=1)
    assert_same(ref, port)
    assert rv == pv
    assert (tmp_path / "b1").read_bytes() == data
    assert (tmp_path / "b2").read_bytes() == data
    want, got = shards["ceph_tpu.tools.vstart"], \
        shards["ceph_tpu_torch.tools.vstart"]
    assert got == want and len(got) == 2 * 3
    text = "".join(t for _, t in port)
    assert '"inconsistent": []' in text


def test_vstart_mds_tour():
    """`--mds 1 --standby-mds 1`: fs status, the rank killed, the
    standby joining."""
    lines = ["fs status", "kill-mds 0", "add-standby", "quit"]

    def standby_registered(sh):
        # the shell waits for the rank; the standby's first beacon may
        # land later
        end = time.monotonic() + 30
        while time.monotonic() < end and not sh.cluster.fsmap().standbys:
            time.sleep(0.02)

    ref, port, _, _ = both(lines, prepare=standby_registered, n_osd=3,
                           osds_per_host=1, n_mds=1, n_standby=1)
    assert_same(ref, port)
    text = "".join(t for _, t in port)
    assert "mds.0 killed" in text and "joined" in text


def test_vstart_rgw_tour():
    """`rgw start z1 z2`, a put on the master zone, the object read
    back there and `sync-status`."""
    lines = ["rgw start z1 z2", "rgw put z1 bk k1 hello", "rgw get z1 bk k1",
             "rgw period z1"]

    def sync(sh):
        z2 = sh.rgw_zones["z2"]
        url = f"http://127.0.0.1:{z2.port}/bk/k1"
        end = time.monotonic() + 30

        def served() -> bool:
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    return r.read() == b"hello"
            except urllib.error.HTTPError:
                return False
        # z2 serves the object, then a whole agent round runs after that
        # (caught_up() reads the heads of the agent's last round)
        while time.monotonic() < end and not served():
            time.sleep(0.05)
        rounds = z2.sync._rounds
        while time.monotonic() < end and (z2.sync._rounds < rounds + 2 or
                                          not z2.sync.caught_up()):
            time.sleep(0.05)
        out = io.StringIO()
        sh.out = out
        sh.run_line("rgw sync-status z2")
        sh.run_line("rgw get z2 bk k1")
        return out.getvalue()

    ref, port, rx, px = both(lines, sync, n_osd=3, osds_per_host=1)
    assert_same(ref, port)
    assert mask(px) == mask(rx)
    assert px.rstrip().endswith("hello")


def test_main_runs_commands(capsys):
    """`main(["-c", ...])` runs each command and exits 0."""
    assert vstart.main(["--device", "cpu", "--osds", "3",
                        "-c", "osd stat", "-c", "osd pool create p 4",
                        "-c", "quit"]) == 0
    out = capsys.readouterr().out
    assert "3 osds: 3 up" in out and "pool 'p' created" in out


def test_shell_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vstart.VstartShell(n_osd=1)


@pytest.mark.parametrize("ms_type,ok", [("grpc", False), ("ici", True),
                                        ("local", True)])
def test_messenger_create_reads_ms_type(ms_type, ok):
    """Messenger.create with no ms_type reads the option; an
    unsupported value raises in both packages."""
    got = []
    for mod, cfg in ((ref_messenger, ref_options.global_config()),
                     (messenger, options.global_config())):
        old = cfg["ms_type"]
        cfg.set("ms_type", ms_type)
        try:
            ms = mod.Messenger.create(mod.LocalNetwork(), "osd.7",
                                      threaded=False)
            got.append(type(ms).__name__)
        except ValueError as ex:
            got.append(str(ex))
        finally:
            cfg.set("ms_type", old)
    assert got[0] == got[1]
    assert (got[0] == "Messenger") is ok


def test_osd_admin_socket_config_diff(tmp_path):
    """`config diff` on an OSD's socket: the process's values changed
    from the schema's defaults; the option set through the socket reads
    as the reference's global_config().diff() gives it after the same
    `config set`."""
    from ceph_tpu_torch.testing import MiniCluster
    c = MiniCluster(n_osd=1, threaded=True, device="cpu")
    cfg, ref = options.global_config(), ref_options.global_config()
    try:
        c.wait_all_up()
        sock = str(tmp_path / "osd0.asok")
        c.osds[0].start_admin_socket(sock)
        rc, _ = admin_command(sock, {"prefix": "config set",
                                     "var": "osd_max_backfills", "val": "3"})
        assert rc == 0
        ref.set("osd_max_backfills", "3")
        rc, diff = admin_command(sock, "config diff")
        assert rc == 0 and diff["osd_max_backfills"] == 3
        assert diff == json.loads(json.dumps(cfg.diff()))
        assert diff["osd_max_backfills"] == ref.diff()["osd_max_backfills"]
    finally:
        cfg.set("osd_max_backfills", 1)
        ref.set("osd_max_backfills", 1)
        c.shutdown()


def test_osd_op_queue_classes_equal_the_reference():
    """The OSD's mClock classes: `scrub` set up from
    osd_mclock_scrub_wgt / _lim and never fed, as the reference's, and
    every other class's parameters unmoved."""
    from ceph_tpu.testing import MiniCluster as RefCluster
    from ceph_tpu_torch.testing import MiniCluster
    stats = []
    for make in (lambda: RefCluster(n_osd=1, threaded=False),
                 lambda: MiniCluster(n_osd=1, threaded=False, device="cpu")):
        c = make()
        try:
            c.pump()
            stats.append(c.osds[0].op_queue.stats())
        finally:
            c.shutdown()
    assert stats[1] == stats[0]
    cfg = options.global_config()
    assert stats[1]["scrub"] == {
        "queued": 0, "deferred": 0, "reservation": 0.0,
        "weight": cfg["osd_mclock_scrub_wgt"],
        "limit": cfg["osd_mclock_scrub_lim"]}
