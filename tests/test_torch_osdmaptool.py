"""The port's osdmaptool against the JAX package's, on the CPU.

The two osdmaptool cases of tests/test_osdmap.py run through both tools,
and the map files cross over: a map written by either package's
`save_map` loads in the other's tool, and `--test-map-pgs` (and its dump)
prints the same stdout (the timing line goes to stderr and is not
compared).  The port maps with `--device cpu` (K3's plain version); the
reference tool runs unpatched on one map shape (16 OSDs, 32 PGs), so it
compiles once.  Everything is compared exactly.
"""
import json

import pytest
import torch

from ceph_tpu.crush.types import ChooseArg as RefChooseArg
from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
from ceph_tpu.osd.types import PG as RefPG
from ceph_tpu.osd.types import PGPool as RefPGPool
from ceph_tpu.tools import osdmaptool as ref_osdmaptool
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PG
from ceph_tpu_torch.tools import osdmaptool

# The plain version runs thousands of small tensor ops; with one
# intra-op thread pool per test worker on a shared CPU they thrash.
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
TEST = ["--test-map-pgs", "--pg-num", "32"]


def stdout_of(capsys, tool, argv):
    assert tool.main(argv) == 0
    return capsys.readouterr().out


def reference_map() -> RefOSDMap:
    """16 OSDs, 32 PGs, with an OSD down and one out, a reweight, primary
    affinity, pg_upmap(_items), pg_temp and primary_temp."""
    m = RefOSDMap()
    m.build_simple(16, RefPGPool(pg_num=32, pgp_num=32), osds_per_host=4)
    m.osd_state[3] &= ~2
    m.osd_weight[6] = 0
    m.osd_weight[9] = 0x8000
    m.set_primary_affinity(1, 0)
    m.set_primary_affinity(12, 0x4000)
    m.pg_upmap_items[RefPG(0, 5)] = [(m.pg_to_raw_osds(RefPG(0, 5))[0][0],
                                      15)]
    m.pg_upmap[RefPG(0, 7)] = [0, 4, 8]
    m.pg_temp[RefPG(0, 9)] = [1, 5, 10, 13]
    m.primary_temp[RefPG(0, 11)] = 2
    return m


def test_osdmaptool_cli(tmp_path, capsys):
    port_file, ref_file = str(tmp_path / "p.json"), str(tmp_path / "r.json")
    out = stdout_of(capsys, osdmaptool, ["--createsimple", "16", port_file])
    assert out == stdout_of(capsys, ref_osdmaptool,
                            ["--createsimple", "16", ref_file]) \
        .replace(ref_file, port_file)
    assert "writing epoch 1" in out
    with open(port_file) as f, open(ref_file) as g:
        assert json.load(f) == json.load(g)
    out = stdout_of(capsys, osdmaptool, [port_file, *TEST, *CPU])
    assert out == stdout_of(capsys, ref_osdmaptool, [ref_file, *TEST])
    assert "pool 0 pg_num 32" in out
    assert "#osd\tcount\tfirst\tprimary" in out
    assert " in 16" in out
    assert "size 3\t32" in out
    m = osdmaptool.load_map(port_file)
    up, upp, acting, actp = m.pg_to_up_acting_osds(PG(0, 0))
    assert len(up) == 3 and upp == up[0]


def test_osdmaptool_choose_args_roundtrip(tmp_path):
    ref = RefOSDMap()
    ref.build_simple(8, RefPGPool(pg_num=32, pgp_num=32), osds_per_host=4)
    bucket = next(b for b in ref.crush.buckets if b is not None)
    ws = [[0x8000 + 0x1000 * i for i in range(len(bucket.items))]]
    ref.crush.choose_args[ref.crush.DEFAULT_CHOOSE_ARGS] = {
        bucket.id: RefChooseArg(ids=None, weight_set=ws)}
    m = OSDMap.from_reference(ref)
    port_file, ref_file = str(tmp_path / "p.json"), str(tmp_path / "r.json")
    osdmaptool.save_map(m, port_file)
    ref_osdmaptool.save_map(ref, ref_file)
    with open(port_file) as f, open(ref_file) as g:
        assert json.load(f) == json.load(g)
    m2 = osdmaptool.load_map(ref_file)
    arg = m2.crush.choose_args[m.crush.DEFAULT_CHOOSE_ARGS][bucket.id]
    assert arg.weight_set == ws and arg.ids is None
    for ps in range(32):
        assert m2.pg_to_up_acting_osds(PG(0, ps)) == \
            m.pg_to_up_acting_osds(PG(0, ps)) == \
            tuple(ref.pg_to_up_acting_osds(RefPG(0, ps)))


@pytest.mark.parametrize("test", ["--test-map-pgs", "--test-map-pgs-dump"])
def test_reference_map_file_in_the_port(tmp_path, capsys, test):
    mapfile = str(tmp_path / "ref.json")
    ref_osdmaptool.save_map(reference_map(), mapfile)
    out = stdout_of(capsys, osdmaptool, [mapfile, test, *CPU])
    assert out == stdout_of(capsys, ref_osdmaptool, [mapfile, test])
    assert " in 15" in out


def test_port_map_file_in_the_reference(tmp_path, capsys):
    mapfile = str(tmp_path / "port.json")
    osdmaptool.save_map(OSDMap.from_reference(reference_map()), mapfile)
    with open(mapfile) as f:
        saved = json.load(f)
    assert ref_osdmaptool.load_map(mapfile).pg_upmap[RefPG(0, 7)] == [0, 4, 8]
    out = stdout_of(capsys, ref_osdmaptool, [mapfile, "--test-map-pgs"])
    assert out == stdout_of(capsys, osdmaptool, [mapfile, "--test-map-pgs",
                                                 *CPU])
    with open(mapfile) as f:
        assert json.load(f) == saved            # --test-map-pgs saves nothing


def test_mark_down_and_out(tmp_path, capsys):
    files = []
    for name, tool in (("p", osdmaptool), ("r", ref_osdmaptool)):
        mapfile = str(tmp_path / f"{name}.json")
        stdout_of(capsys, tool, ["--createsimple", "16", mapfile])
        stdout_of(capsys, tool, [mapfile, "--mark-down", "2", "--mark-out",
                                 "5", "--mark-out", "11"])
        with open(mapfile) as f:
            files.append(json.load(f))
    assert files[0] == files[1]
    assert files[0]["osd_weight"][5] == files[0]["osd_weight"][11] == 0
    assert not files[0]["osd_state"][2] & 2


def test_errors(tmp_path, capsys):
    missing = str(tmp_path / "missing.json")
    assert osdmaptool.main([missing, "--test-map-pgs", *CPU]) == \
        ref_osdmaptool.main([missing, "--test-map-pgs"]) == 1
    mapfile = str(tmp_path / "om.json")
    stdout_of(capsys, osdmaptool, ["--createsimple", "16", mapfile])
    for tool, dev in ((osdmaptool, CPU), (ref_osdmaptool, [])):
        with pytest.raises(SystemExit):
            tool.main([mapfile, "--test-map-pgs", "--pool", "3", *dev])
    err = capsys.readouterr().err
    assert err.count("There is no pool 3") == 2


def test_tools_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mapfile = str(tmp_path / "om.json")
    assert osdmaptool.main(["--createsimple", "16", mapfile]) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        osdmaptool.main([mapfile, "--test-map-pgs"])
