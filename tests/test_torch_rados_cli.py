"""The port's `rados` CLI (ceph_tpu_torch.tools.rados_cli), mirroring the
reference's tests/test_rados_cli.py, plus the cross-package check that
the verbs print the reference's text and return its codes, and a run of
the CLI as its own process against a cephx cluster over TCP through
--monmap and --keyring.

Mirrored: `test_pool_and_object_lifecycle` (on a replicated pool, made
by `mkpool` as in the reference, with `ls` and the xattr and omap
verbs), `test_bench_write_then_seq` (on a replicated pool, and again on
an EC pool made through the client, k=2 m=1 on 4 OSDs; `seq` finds the
objects by listing) and `test_pool_delete` (`rmpool`).  Not mirrored:
`test_trace_verb_assembles_cross_daemon_tree` (`trace`, not ported), a
verb refused here as unknown, with `insights`, `telemetry` and `rgw`.
The `crash` verbs are held to the reference's text in
tests/test_torch_crash.py."""
import io as iomod
import json
import os
import subprocess
import sys

import pytest

from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu.tools import rados_cli as ref_cli
from ceph_tpu_torch.testing import MiniCluster
from ceph_tpu_torch.tools.rados_cli import main
from test_torch_tcp import deadline  # noqa: F401  (per-test timeout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    c = MiniCluster(n_osd=4, threaded=True, device="cpu")
    c.wait_all_up()
    r = c.rados()
    yield c, r
    c.shutdown()


def run(r, *argv, cli=main):
    out = iomod.StringIO()
    rc = cli(list(argv), rados=r, out=out)
    return rc, out.getvalue()


def test_pool_and_object_lifecycle(cluster, tmp_path):
    c, r = cluster
    rc, out = run(r, "mkpool", "clip", "16")
    assert rc == 0 and "successfully created" in out
    pid = r.pool_lookup("clip")
    assert c.mon.osdmap.pools[pid].type == 1          # replicated
    rc, out = run(r, "lspools")
    assert "clip" in out.split()
    src = tmp_path / "in.bin"
    src.write_bytes(b"cli payload " * 50)
    assert run(r, "put", "clip", "obj1", str(src))[0] == 0
    rc, out = run(r, "stat", "clip", "obj1")
    assert rc == 0 and f"size {len(b'cli payload ' * 50)}" in out
    rc, out = run(r, "ls", "clip")
    assert out.split() == ["obj1"]
    dst = tmp_path / "out.bin"
    assert run(r, "get", "clip", "obj1", str(dst))[0] == 0
    assert dst.read_bytes() == src.read_bytes()
    assert run(r, "setxattr", "clip", "obj1", "k", "v")[0] == 0
    rc, out = run(r, "getxattr", "clip", "obj1", "k")
    assert rc == 0 and out.strip() == "v"
    rc, out = run(r, "listxattr", "clip", "obj1")
    assert out.split() == ["k"]
    assert run(r, "setomapval", "clip", "obj1", "ok", "ov")[0] == 0
    rc, out = run(r, "listomapvals", "clip", "obj1")
    assert out == "ok\n value (2 bytes) :\nov\n"
    assert run(r, "rm", "clip", "obj1")[0] == 0
    assert run(r, "ls", "clip")[1].split() == []
    assert run(r, "stat", "clip", "gone")[0] == 1
    assert run(r, "stat", "clip", "obj1")[0] == 1


def make_ec_pool(r, name, pg_num=16):
    """An EC pool through the client (mkpool makes replicated ones)."""
    r.mon_command({"prefix": "osd erasure-code-profile set",
                   "name": "k2m1",
                   "profile": {"plugin": "tpu", "k": "2", "m": "1",
                               "crush-failure-domain": "host"}})
    r.pool_create(name, pg_num=pg_num, pool_type="erasure",
                  erasure_code_profile="k2m1")


def bench_write_then_seq(r, pool):
    rc, out = run(r, "bench", pool, "2", "write",
                  "-b", "65536", "-t", "8", "--no-cleanup")
    assert rc == 0
    assert "Bandwidth (MB/sec):" in out and "Average IOPS:" in out
    assert float(out.split("Bandwidth (MB/sec):")[1].split()[0]) > 0
    written = int(out.split("Total writes made:")[1].split()[0])
    listed = [o for o in r.open_ioctx(pool).list_objects()
              if o.startswith("benchmark_data_")]
    assert len(listed) == written
    rc, out = run(r, "bench", pool, "1", "seq", "-b", "65536",
                  "-t", "8")
    assert rc == 0 and "Average Latency(s):" in out
    assert int(out.split("Total seqs made:")[1].split()[0]) > 0


def test_bench_write_then_seq(cluster):
    _, r = cluster
    run(r, "mkpool", "benchp", "16")          # replicated
    bench_write_then_seq(r, "benchp")


def test_bench_write_then_seq_on_an_ec_pool(cluster):
    _, r = cluster
    make_ec_pool(r, "benchec")
    bench_write_then_seq(r, "benchec")


def test_seq_checks_every_read(cluster):
    """A listed benchmark object that does not hold the write bench's
    payload fails the seq run."""
    _, r = cluster
    run(r, "mkpool", "seqcheck", "8")
    assert run(r, "bench", "seqcheck", "1", "write", "-b", "4096",
               "-t", "4", "--no-cleanup")[0] == 0
    r.open_ioctx("seqcheck").write_full("benchmark_data_zzz", b"odd")
    rc, out = run(r, "bench", "seqcheck", "1", "seq", "-b", "4096",
                  "-t", "4")
    assert rc == 1 and "differs" in out


def test_pool_delete(cluster):
    _, r = cluster
    run(r, "mkpool", "doomed", "8")
    rc, out = run(r, "rmpool", "doomed")
    assert rc == 0 and out == "successfully deleted pool doomed\n"
    assert "doomed" not in run(r, "lspools")[1].split()


def test_seq_without_a_write_bench_says_so(cluster):
    _, r = cluster
    run(r, "mkpool", "emptyp", "8")
    rc, out = run(r, "bench", "emptyp", "1", "seq")
    assert rc == 1 and "no benchmark objects" in out


@pytest.mark.parametrize("argv", [["insights"], ["telemetry"],
                                  ["rgw", "realm", "create", "x"],
                                  ["trace", "deadbeef"]])
def test_verbs_left_out_are_refused(argv):
    with pytest.raises(SystemExit) as ei:
        main(argv, rados=object())
    assert ei.value.code == 2


def test_text_and_codes_equal_the_references(tmp_path):
    """The same verbs on a reference cluster through the reference CLI
    and on the port's through the port's print the same text and return
    the same codes."""
    src = tmp_path / "in.bin"
    src.write_bytes(b"x" * 1234)
    verbs = [["mkpool", "same", "8"], ["lspools"],
             ["put", "same", "o", str(src)], ["stat", "same", "o"],
             ["ls", "same"], ["get", "same", "o", "-"],
             ["setxattr", "same", "o", "k1", "v1"],
             ["setxattr", "same", "o", "k0", "value zero"],
             ["getxattr", "same", "o", "k0"], ["listxattr", "same", "o"],
             ["getxattr", "same", "o", "nokey"],
             ["setomapval", "same", "o", "b", "2"],
             ["setomapval", "same", "o", "a", "one"],
             ["listomapvals", "same", "o"], ["rm", "same", "o"],
             ["stat", "same", "o"], ["ls", "same"],
             ["mkpool", "gone", "4"], ["rmpool", "gone"],
             ["rmpool", "never"], ["lspools"]]
    got = {}
    for kind in ("ref", "port"):
        c = RefCluster(n_osd=4, threaded=True) if kind == "ref" else \
            MiniCluster(n_osd=4, threaded=True, device="cpu")
        try:
            c.wait_all_up()
            r = c.rados()
            cli = ref_cli.main if kind == "ref" else main
            got[kind] = [run(r, *v, cli=cli) for v in verbs]
        finally:
            c.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"][15][0] == 1          # stat of a removed object
    assert got["port"][13][1] == ("a\n value (3 bytes) :\none\n"
                                  "b\n value (1 bytes) :\n2\n")
    assert got["port"][19] == (0, "")       # rmpool of no such pool


def test_cli_process_against_a_cephx_cluster_over_tcp(tmp_path):
    from ceph_tpu_torch.auth import generate_key
    from ceph_tpu_torch.dryrun import TcpCluster

    c = TcpCluster(n_osd=4, device="cpu", auth="cephx")
    try:
        c.wait_all_up()
        c.keyring.keys["client.admin"] = generate_key()
        c.keyring.save(str(tmp_path / "kr.json"))
        (tmp_path / "mm.json").write_text(json.dumps(
            {"addrs": {k: list(v) for k, v in c.network.addr_map.items()
                       if not k.startswith("client.")}}))
        base = [sys.executable, "-m", "ceph_tpu_torch.tools.rados_cli",
                "--monmap", str(tmp_path / "mm.json"), "--keyring",
                str(tmp_path / "kr.json"), "--timeout", "30"]
        env = dict(os.environ, PYTHONPATH=ROOT)
        p = subprocess.run(base + ["mkpool", "tcpp", "8"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=60)
        assert p.returncode == 0, p.stderr
        assert p.stdout == "successfully created pool tcpp\n"
        p = subprocess.run(base + ["lspools"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=60)
        assert p.returncode == 0 and p.stdout.split() == ["tcpp"]
        assert c.network.dispatch_errors == 0
        assert sum(d.ms.auth_verifier.rejected
                   for d in [c.mon, *c.osds.values()]) == 0
    finally:
        c.shutdown()
