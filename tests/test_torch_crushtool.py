"""The port's crushtool against the JAX package's, on the CPU.

The cases of tests/test_crushtool.py, each run through both packages:
the same text map through both compilers (equal JSON), the decompile
fixed point, both CrushTesters at every --show-* flag, and both CLIs
(`main(argv)`, identical stdout).  The port maps on `device="cpu"` (K3's
plain version).

The reference tester takes its own scalar branch here (its batch engine
made to raise BatchUnsupported, as it does for a map it cannot batch),
so that each (rule, num_rep) does not cost a JAX compile; its batch
engine is held to the port's in tests/test_torch_crush.py, and
`test_cli_compile_decompile_test` runs the reference tool unpatched.
Text, JSON and placements are compared exactly.
"""
import json

import numpy as np
import pytest
import torch

from ceph_tpu.crush import codec as ref_codec
from ceph_tpu.crush import compiler as ref_compiler
from ceph_tpu.crush import mapper as ref_mapper
from ceph_tpu.crush import tester as ref_tester
from ceph_tpu.crush.batch import BatchUnsupported as RefBatchUnsupported
from ceph_tpu.crush.wrapper import CrushWrapper as RefCrushWrapper
from ceph_tpu.tools import crushtool as ref_crushtool
from ceph_tpu_torch.crush import codec, tester
from ceph_tpu_torch.crush.compiler import (CompileError, compile_crushmap,
                                           decompile)
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW
from ceph_tpu_torch.crush.wrapper import CrushWrapper
from ceph_tpu_torch.tools import crushtool

from test_crushtool import MAP_TXT

# The plain version runs thousands of small tensor ops; with one
# intra-op thread pool per test worker on a shared CPU they thrash.
torch.set_num_threads(1)

FLAGS = ("show_utilization", "show_statistics", "show_mappings",
         "show_bad_mappings")


def compiled():
    return compile_crushmap(MAP_TXT)


@pytest.fixture
def ref_scalar(monkeypatch):
    """The reference tester on its scalar branch."""
    def refuse(*args, **kwargs):
        raise RefBatchUnsupported("mapped by the scalar engine here")
    monkeypatch.setattr(ref_tester, "compile_map", refuse)


def both_cli(tmp_path, capsys, argv_of):
    """Run both tools with argv_of(prefix) (prefix names each tool's own
    files); returns (port stdout, reference stdout)."""
    outs = []
    for tool, prefix in ((crushtool, "port"), (ref_crushtool, "ref")):
        assert tool.main(argv_of(str(tmp_path / prefix))) == 0
        outs.append(capsys.readouterr().out)
    return outs


# ----------------------------------------------------------------- codec
def test_compile_structure():
    w = compiled()
    assert codec.wrapper_to_json(w) == ref_codec.wrapper_to_json(
        ref_compiler.compile_crushmap(MAP_TXT))
    assert w.crush.max_devices == 6
    assert w.get_item_id("default") == -1
    assert w.get_item_id("host2") == -4
    assert w.get_type_id("root") == 10
    b = w.crush.bucket(-4)
    assert b.items == [4, 5]
    assert b.item_weights == [0x10000, 0x20000]
    assert w.crush.choose_total_tries == 50
    assert w.crush.chooseleaf_stable == 1
    assert w.get_rule_id("ec_rule") == 1
    assert w.crush.rules[1].mask.type == 3
    assert w.crush.rules[1].steps[0].arg1 == 5  # set_chooseleaf_tries


def test_decompile_compile_fixed_point():
    t1 = decompile(compiled())
    assert t1 == ref_compiler.decompile(ref_compiler.compile_crushmap(MAP_TXT))
    assert decompile(compile_crushmap(t1)) == t1


def test_roundtrip_preserves_placements():
    w1 = compiled()
    w2 = compile_crushmap(decompile(w1))
    ref = ref_compiler.compile_crushmap(MAP_TXT)
    weights = [0x10000] * 6
    for ruleno in (0, 1):
        for x in range(32):
            a = w1.do_rule(ruleno, x, 4, weights)
            assert a == w2.do_rule(ruleno, x, 4, weights), (ruleno, x)
            assert a == ref_mapper.do_rule(ref.crush, ruleno, x, 4, weights)


@pytest.mark.parametrize("text", [
    "bogus line\n",
    "type 0 osd\nhost h { id -1\nitem osd.9 weight 1.0\n}\n",  # undefined
    "device 0 osd.0\n",                                         # no types
])
def test_compile_errors(text):
    with pytest.raises(ref_compiler.CompileError):
        ref_compiler.compile_crushmap(text)
    with pytest.raises(CompileError):
        compile_crushmap(text)


def test_decompile_matches_reference_shape():
    text = decompile(compiled())
    assert text.startswith("# begin crush map\n")
    assert text.endswith("# end crush map\n")
    assert "\titem osd.5 weight 2.000" in text
    assert "\tstep chooseleaf firstn 0 type host" in text
    assert "\tstep set_chooseleaf_tries 5" in text
    assert text == ref_compiler.decompile(
        ref_compiler.compile_crushmap(MAP_TXT))


def test_wrapper_from_reference():
    ref = ref_compiler.compile_crushmap(MAP_TXT)
    w = CrushWrapper.from_reference(ref)
    assert codec.wrapper_to_json(w) == ref_codec.wrapper_to_json(ref)
    assert decompile(w) == ref_compiler.decompile(ref)


def test_codec_files_interchange():
    ref = ref_compiler.compile_crushmap(MAP_TXT)
    data = json.loads(json.dumps(ref_codec.wrapper_to_json(ref)))
    w = codec.wrapper_from_json(data)
    assert json.loads(json.dumps(codec.wrapper_to_json(w))) == data
    back = ref_codec.wrapper_from_json(
        json.loads(json.dumps(codec.wrapper_to_json(w))))
    assert ref_compiler.decompile(back) == decompile(w)


# ---------------------------------------------------------------- tester
def test_tester_counts_match_scalar_engine(ref_scalar):
    w = compiled()
    out = CrushTester(w, min_x=0, max_x=255, rule=0, min_rep=3, max_rep=3,
                      device="cpu").test(show_utilization=True)
    assert out == ref_tester.CrushTester(
        ref_compiler.compile_crushmap(MAP_TXT), min_x=0, max_x=255, rule=0,
        min_rep=3, max_rep=3).test(show_utilization=True)
    per = np.zeros(6, dtype=np.int64)
    for x in range(256):
        for o in w.do_rule(0, x, 3):
            per[o] += 1
    assert "rule 0 (replicated_rule), x = 0..255, numrep = 3..3" in out
    assert "result size == 3:\t256/256" in out
    for dev in range(6):
        assert f"  device {dev}:\t\t stored : {per[dev]}\t " \
               f"expected : 128" in out
    assert per[5] == per.max()


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("rule,num_rep", [(0, 3), (1, 3)])
def test_tester_output_equals_reference(ref_scalar, flag, rule, num_rep):
    w = compiled()
    got = CrushTester(w, min_x=0, max_x=47, rule=rule, min_rep=num_rep,
                      max_rep=num_rep, device="cpu").test(**{flag: True})
    want = ref_tester.CrushTester(
        ref_compiler.compile_crushmap(MAP_TXT), min_x=0, max_x=47,
        rule=rule, min_rep=num_rep, max_rep=num_rep).test(**{flag: True})
    assert got == want


def test_tester_bad_mappings(ref_scalar):
    """More replicas than hosts: firstn gives short results."""
    w = compiled()
    got = CrushTester(w, min_x=0, max_x=31, rule=0, min_rep=5, max_rep=5,
                      device="cpu").test(show_bad_mappings=True)
    assert got == ref_tester.CrushTester(
        ref_compiler.compile_crushmap(MAP_TXT), min_x=0, max_x=31, rule=0,
        min_rep=5, max_rep=5).test(show_bad_mappings=True)
    assert "bad mapping rule 0 x" in got
    assert "num_rep 5 result [" in got


def test_tester_mappings_format(ref_scalar):
    w = compiled()
    out = CrushTester(w, min_x=0, max_x=3, rule=1, min_rep=3, max_rep=3,
                      device="cpu").test(show_mappings=True)
    assert out == ref_tester.CrushTester(
        ref_compiler.compile_crushmap(MAP_TXT), min_x=0, max_x=3, rule=1,
        min_rep=3, max_rep=3).test(show_mappings=True)
    lines = [ln for ln in out.splitlines() if ln.startswith("CRUSH rule 1 x ")]
    assert len(lines) == 4
    assert lines[0].startswith("CRUSH rule 1 x 0 [")


def test_tester_all_rules_and_mask_range(ref_scalar):
    """rule -1 walks every rule over its mask's num_rep range; a missing
    rule prints `dne`."""
    w = compiled()
    ref = ref_compiler.compile_crushmap(MAP_TXT)
    for rule, lo, hi in ((-1, 3, 4), (7, 0, 0)):
        got = CrushTester(w, min_x=0, max_x=7, rule=rule, min_rep=lo,
                          max_rep=hi, device="cpu").test(show_statistics=True)
        assert got == ref_tester.CrushTester(
            ref, min_x=0, max_x=7, rule=rule, min_rep=lo,
            max_rep=hi).test(show_statistics=True)
    assert got == "rule 7 dne\n"


def test_tester_scalar_fallback_is_counted():
    """A straw (v1) bucket is not batchable: both testers map it with the
    scalar engine, the port counts the fallback, the text is equal."""
    text = MAP_TXT.replace("\talg straw2\n\thash 0\n\titem osd.4",
                           "\talg straw\n\thash 0\n\titem osd.4")
    w = compile_crushmap(text)
    assert w.crush.bucket(-4).alg == CRUSH_BUCKET_STRAW
    tester.reset_fallbacks()
    got = CrushTester(w, min_x=0, max_x=31, rule=0, min_rep=3, max_rep=3,
                      device="cpu").test(show_mappings=True)
    assert tester.FALLBACKS["batch_unsupported"] == 1
    assert got == ref_tester.CrushTester(
        ref_compiler.compile_crushmap(text), min_x=0, max_x=31, rule=0,
        min_rep=3, max_rep=3).test(show_mappings=True)


def test_tester_timings_are_laps_of_the_same_run():
    """test(timings=...) gives the same text and the host seconds of
    each piece, summed over the (rule, num_rep) runs of that call."""
    w = compiled()
    t = CrushTester(w, min_x=0, max_x=63, rule=-1, min_rep=2, max_rep=3,
                    device="cpu")
    timings = {}
    assert t.test(show_utilization=True, timings=timings) == \
        t.test(show_utilization=True)
    assert set(timings) == {"compile_map", "map_batch", "copy_back",
                            "count_format"}
    assert all(v >= 0.0 for v in timings.values())
    one = {}
    CrushTester(w, min_x=0, max_x=63, rule=0, min_rep=3, max_rep=3,
                device="cpu").map_all(0, 3, one)
    assert set(one) == {"compile_map", "map_batch", "copy_back"}


def test_tester_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CrushTester(compiled())


# ------------------------------------------------------------------- CLI
def test_cli_compile_decompile_test(tmp_path, capsys):
    """Both tools end to end, the reference's on its batch engine."""
    src = tmp_path / "map.txt"
    src.write_text(MAP_TXT)
    dec = both_cli(tmp_path, capsys, lambda p: ["-c", str(src), "-o",
                                                p + ".json"])
    assert dec == ["", ""]
    dec = both_cli(tmp_path, capsys, lambda p: ["-d", p + ".json"])
    assert dec[0] == dec[1] and "rule ec_rule {" in dec[0]
    test_argv = ["--test", "--show-statistics", "--max-x", "127", "--rule",
                 "0", "--num-rep", "3"]
    assert ref_crushtool.main(["-i", str(tmp_path / "ref.json"),
                               *test_argv]) == 0
    want = capsys.readouterr().out
    assert "result size == 3:\t128/128" in want
    # the port on its own map file and on the reference's
    for mapfile in ("port.json", "ref.json"):
        assert crushtool.main(["-i", str(tmp_path / mapfile), *test_argv,
                               "--device", "cpu"]) == 0
        assert capsys.readouterr().out == want


def test_cli_tree(tmp_path, capsys):
    src = tmp_path / "map.txt"
    src.write_text(MAP_TXT)
    both_cli(tmp_path, capsys, lambda p: ["-c", str(src), "-o", p + ".json"])
    trees = both_cli(tmp_path, capsys, lambda p: ["-i", p + ".json",
                                                  "--tree"])
    assert trees[0] == trees[1]
    assert "root default" in trees[0] and "host host2" in trees[0]
    assert "osd.5" in trees[0]


def test_cli_build(tmp_path, capsys):
    argv = ["--build", "--num-osds", "8", "host", "straw2", "2",
            "root", "straw2", "0"]
    both_cli(tmp_path, capsys, lambda p: [*argv, "-o", p + ".json"])
    w = crushtool.load(str(tmp_path / "port.json"))
    ref = ref_crushtool.load(str(tmp_path / "ref.json"))
    assert codec.wrapper_to_json(w) == ref_codec.wrapper_to_json(ref)
    hosts = [b for b in w.crush.buckets
             if b is not None and w.type_map[b.type] == "host"]
    assert len(hosts) == 4 and all(len(h.items) == 2 for h in hosts)
    roots = [b for b in w.crush.buckets
             if b is not None and w.type_map[b.type] == "root"]
    assert len(roots) == 1 and len(roots[0].items) == 4
    text = decompile(w)
    assert decompile(compile_crushmap(text)) == text
    # without -o both print the decompiled map
    texts = both_cli(tmp_path, capsys, lambda p: argv)
    assert texts[0] == texts[1] == text


def test_cli_errors_and_usage(tmp_path, capsys):
    for argv in (["-i", str(tmp_path / "missing.json"), "--tree"],
                 ["--build", "--num-osds", "4", "host", "straw2"], []):
        assert crushtool.main(argv) == ref_crushtool.main(argv) == 1
    capsys.readouterr()


def test_build_flat_equals_reference():
    w = CrushWrapper.build_flat(12, osds_per_host=3)
    ref = RefCrushWrapper.build_flat(12, osds_per_host=3)
    assert codec.wrapper_to_json(w) == ref_codec.wrapper_to_json(ref)
    rid = w.add_simple_rule("r", "default", "host", max_size=12)
    assert rid == ref.add_simple_rule("r", "default", "host", max_size=12)
    for x in range(64):
        assert w.do_rule(rid, x, 3) == ref.do_rule(rid, x, 3)
    assert w.adjust_item_weight(4, 2.5) == ref.adjust_item_weight(4, 2.5) == 1
    w.insert_item(12, 0.5, "osd.12", "host3", device_class="ssd")
    ref.insert_item(12, 0.5, "osd.12", "host3", device_class="ssd")
    assert codec.wrapper_to_json(w) == ref_codec.wrapper_to_json(ref)
    assert w.get_item_name(12) == "osd.12" and w.get_rule_id("r") == rid
