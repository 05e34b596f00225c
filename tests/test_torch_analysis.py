"""The port's cephck (ceph_tpu_torch.analysis).

For each of the three device-contract rules (`cuda-timing`,
`host-sync-hot-path`, `implicit-transfer`, the torch counterparts of the
reference's `jax-timing`, `host-sync-hot-path` and `implicit-transfer`):
a red snippet the rule must catch and a green one it must pass, written
to tmp_path as a small project whose kernel wrapper counts its launch the
way the port's CUDA wrappers do.  Then the waiver (with its reason, and
without one).

For the reference's twelve other rules: the port's engine on the
reference's red and green fixtures (tests/fixtures/cephck/, read only)
gives the reference engine's (rule, line) findings.  Then the
suppression baseline (a reason is required, a stale entry fails the run,
--prune-baseline rewrites), the output formats (sarif against the
reference's for the same findings, hostile messages, github annotations,
json == --json), the CLI's exit codes, --list-rules and --explain, and
the scan of the port and chip_smoke.py, which must report no finding
that is not waived, every waiver carrying its reason, under the port's
own baseline.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from ceph_tpu.analysis import ALL_RULES as REF_RULES
from ceph_tpu.analysis import engine as ref_engine
from ceph_tpu_torch.analysis import ALL_RULES, Engine
from ceph_tpu_torch.analysis import engine as port_engine
from ceph_tpu_torch.analysis.engine import (BASELINE_NAME, BaselineError,
                                            FileContext, Finding,
                                            load_baseline, sarif_report)

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the kernel module of the snippet project: one wrapper that counts its
#: launch, as ec/kernels/bitmatmul.py's gf_matmul_cuda does
KERNELS = '''
import torch

LAUNCHES = {"k": 0}


def scale_cuda(x: torch.Tensor) -> torch.Tensor:
    LAUNCHES["k"] += 1
    return x * 2


def scale(x):
    return scale_cuda(x)
'''

SNIPPETS = {
    "cuda-timing": {
        "red": '''
import time
import torch
from ec.kernels import scale


def bench(x):
    t0 = time.perf_counter()
    y = scale(x)
    return time.perf_counter() - t0
''',
        "green": '''
import time
import torch
from ec.kernels import scale


def bench(x):
    t0 = time.perf_counter()
    y = scale(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0
''',
    },
    "host-sync-hot-path": {
        "red": '''
import torch


def per_stripe(stripes):
    out = []
    for s in stripes:
        out.append(s.sum().item())
    return out
''',
        "green": '''
import torch


def per_stripe(stripes):
    sums = torch.stack(stripes).sum(dim=1)
    return sums.tolist()
''',
    },
    "implicit-transfer": {
        "red": '''
import numpy as np
import torch
from ec.kernels import scale_cuda


def encode(n):
    buf = np.zeros(n, dtype=np.uint8)
    return scale_cuda(buf)
''',
        "green": '''
import numpy as np
import torch
from device import as_u8
from ec.kernels import scale_cuda


def encode(n, dev):
    buf = np.zeros(n, dtype=np.uint8)
    return scale_cuda(as_u8(buf, dev))
''',
    },
}


def scan(tmp_path: pathlib.Path, body: str, rule: str | None = None):
    """Engine over a snippet project: ec/kernels.py, device.py and the
    snippet as ec/user.py (the EC path, where all three rules apply)."""
    (tmp_path / "pyproject.toml").write_text("")
    (tmp_path / "ec").mkdir(exist_ok=True)
    (tmp_path / "ec" / "__init__.py").write_text("")
    (tmp_path / "ec" / "kernels.py").write_text(KERNELS)
    (tmp_path / "device.py").write_text(
        "def as_u8(x, dev):\n    return x\n")
    (tmp_path / "ec" / "user.py").write_text(textwrap.dedent(body))
    rules = [cls() for cls in ALL_RULES if rule is None or cls.id == rule]
    eng = Engine(rules, tmp_path)
    eng.run(["ec", "device.py"])
    return eng


@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_red_snippet_is_caught(tmp_path, rule):
    eng = scan(tmp_path, SNIPPETS[rule]["red"])
    got = [f for f in eng.findings if f.path == "ec/user.py"]
    assert [f.rule for f in got] == [rule], [f.render() for f in got]


@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_green_snippet_passes(tmp_path, rule):
    eng = scan(tmp_path, SNIPPETS[rule]["green"])
    assert not eng.findings, [f.render() for f in eng.findings]
    assert not eng.errors


@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_waiver_needs_its_reason(tmp_path, rule):
    red = textwrap.dedent(SNIPPETS[rule]["red"])
    line = next(f.line for f in scan(tmp_path, red).findings)
    lines = red.splitlines()
    indent = lines[line - 1][:len(lines[line - 1]) -
                             len(lines[line - 1].lstrip())]

    def waived(comment):
        body = "\n".join(lines[:line - 1] + [indent + comment] +
                         lines[line - 1:])
        return scan(tmp_path, body)

    eng = waived(f"# cephck: ignore[{rule}] one-shot host path, no card")
    assert not eng.findings and [f.rule for f in eng.waived] == [rule]
    eng = waived(f"# cephck: ignore[{rule}]")
    assert [f.rule for f in eng.findings] == [rule] and not eng.waived
    eng = waived("# cephck: ignore[some-other-rule] not this one")
    assert [f.rule for f in eng.findings] == [rule]


def test_cross_module_sync_in_a_loop_is_caught(tmp_path):
    """host-sync-hot-path follows the call graph: a loop calling a
    helper that reads a tensor back is flagged at the call."""
    eng = scan(tmp_path, '''
import torch


def readback(t):
    return t.cpu()


def per_batch(batches):
    return [readback(b) for b in batches] + [readback(b) for b in
                                              batches if b is not None]


def per_stripe(stripes):
    out = []
    for s in stripes:
        out.append(readback(s))
    return out
''', "host-sync-hot-path")
    got = [f for f in eng.findings]
    assert len(got) == 1 and "readback()" in got[0].message


def test_numpy_results_are_not_syncs(tmp_path):
    eng = scan(tmp_path, '''
import numpy as np
import torch


def histogram(counts):
    lines = []
    for size in np.flatnonzero(counts).tolist():
        lines.append(str(size))
    return lines
''', "host-sync-hot-path")
    assert not eng.findings


def test_port_and_smoke_scan_clean():
    """The port and chip_smoke.py under the port's baseline: no finding
    left unwaived or unsuppressed, no stale baseline entry, and every
    waiver in them names its reason."""
    eng = Engine([cls() for cls in ALL_RULES], ROOT,
                 suppressions=load_baseline(ROOT / BASELINE_NAME))
    rc = eng.run(["ceph_tpu_torch", "chip_smoke.py"])
    assert rc == 0, [f.render() for f in eng.findings] + eng.errors
    assert not eng.errors and not eng.stale_suppressions()
    assert {f.rule for f in eng.waived} <= {cls.id for cls in ALL_RULES}
    for path in [ROOT / "chip_smoke.py",
                 *sorted((ROOT / "ceph_tpu_torch").rglob("*.py"))]:
        src = path.read_text()
        ctx = FileContext(path, str(path), src, None)
        for line, rule, reason in ctx.waivers():
            assert rule in {cls.id for cls in ALL_RULES}, (path, line)
            assert reason, f"{path}:{line}: waiver without its reason"


def test_cli_exits_zero_on_the_port():
    p = subprocess.run([sys.executable, "-m", "ceph_tpu_torch.analysis",
                        "ceph_tpu_torch", "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 finding(s)" in p.stdout


# ------------------------------------- the reference's twelve other rules

FIXTURES = ROOT / "tests" / "fixtures" / "cephck"

#: the reference's fixture stem per rule (tests/test_cephck.py's
#: RULE_FIXTURES) for the rules the port carries as the reference's
PORTED_FIXTURES = {
    "raw-lock": "raw_lock", "wire-drift": "wire_drift",
    "unregistered-message": "unregistered_message",
    "txn-atomicity": "osd/txn_atomicity", "silent-thread": "silent_thread",
    "bare-except": "bare_except", "guarded-by": "guarded_by",
    "blocking-in-dispatch": "blocking_dispatch",
    "swallowed-error": "swallowed_error",
    "errno-conflation": "errno_conflation",
    "reply-on-all-paths": "reply_on_all_paths", "bare-retry": "bare_retry",
}


def fixture_findings(engine_mod, rules, path: pathlib.Path) -> list:
    eng = engine_mod.Engine([cls() for cls in rules], ROOT)
    return sorted((f.rule, f.line, f.symbol, f.message)
                  for f in eng.check_file(path))


def test_rule_ids_and_order():
    """The port's three, then the reference's twelve others in the
    reference's ALL_RULES order."""
    port = [cls.id for cls in ALL_RULES]
    assert port[:3] == ["cuda-timing", "host-sync-hot-path",
                        "implicit-transfer"]
    ref = [cls.id for cls in REF_RULES if cls.id in PORTED_FIXTURES]
    assert port[3:] == ref and set(ref) == set(PORTED_FIXTURES)


@pytest.mark.parametrize("color", ["red", "green"])
@pytest.mark.parametrize("rule", sorted(PORTED_FIXTURES))
def test_fixture_findings_equal_the_reference(rule, color):
    """The port's engine with every rule on the reference's fixture
    gives the reference engine's findings of the rules both carry:
    rule, line, symbol and message."""
    path = FIXTURES / f"{PORTED_FIXTURES[rule]}_{color}.py"
    port_ids = {cls.id for cls in ALL_RULES}
    want = [f for f in fixture_findings(ref_engine, REF_RULES, path)
            if f[0] in port_ids]
    got = fixture_findings(port_engine, ALL_RULES, path)
    assert got == want
    assert (rule in {f[0] for f in got}) == (color == "red")


def test_wire_drift_holds_the_port_messages_to_the_lockfile():
    """The port's 78 wire types are the reference's: its messages.py
    against the reference's lockfile gives no wire-drift and no
    unregistered-message finding."""
    eng = Engine([cls() for cls in ALL_RULES
                  if cls.id in ("wire-drift", "unregistered-message")], ROOT)
    assert eng.run(["ceph_tpu_torch/msg/messages.py"]) == 0, \
        [f.render() for f in eng.findings]
    lock = json.loads((ROOT / "tests/fixtures/wire_schema.json").read_text())
    assert len(lock["structs"]) >= 78


# --------------------------------------------------------------- baseline

def write_baseline(path: pathlib.Path, entries: list) -> pathlib.Path:
    path.write_text(json.dumps({"suppressions": entries}))
    return path


def test_baseline_requires_reasons(tmp_path):
    for entry in ({"rule": "raw-lock", "path": "x.py"},
                  {"rule": "raw-lock", "path": "x.py", "reason": "why\nnot"},
                  {"rule": "raw-lock", "reason": "no path"}):
        b = write_baseline(tmp_path / "b.json", [entry])
        with pytest.raises(BaselineError):
            load_baseline(b)
        with pytest.raises(ref_engine.BaselineError):
            ref_engine.load_baseline(b)
    (tmp_path / "b.json").write_text("{not json")
    with pytest.raises(BaselineError):
        load_baseline(tmp_path / "b.json")


def test_committed_port_baseline_is_valid():
    entries = load_baseline(ROOT / BASELINE_NAME)
    assert all(e.reason for e in entries)
    assert BASELINE_NAME != ref_engine.BASELINE_NAME


def test_baseline_suppresses_and_counts(tmp_path):
    red = FIXTURES / "bare_except_red.py"
    b = write_baseline(tmp_path / "b.json", [
        {"rule": "bare-except",
         "path": "tests/fixtures/cephck/bare_except_red.py",
         "reason": "fixture exercise"}])
    eng = Engine([cls() for cls in ALL_RULES], ROOT,
                 suppressions=load_baseline(b))
    assert not list(eng.check_file(red))
    assert len(eng.suppressed) == 1 and not eng.stale_suppressions()


def cli(*argv, cwd=ROOT, module="ceph_tpu_torch.analysis"):
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_stale_suppression_fails_and_prune_rewrites(tmp_path):
    """A baseline entry nothing matches fails the run (exit 1);
    --prune-baseline drops exactly the stale entries and passes."""
    green = FIXTURES / "bare_except_green.py"
    live = {"rule": "bare-except",
            "path": "tests/fixtures/cephck/bare_except_red.py",
            "reason": "fixture exercise"}
    stale = {"rule": "raw-lock",
             "path": "tests/fixtures/cephck/bare_except_green.py",
             "reason": "no longer true"}
    b = write_baseline(tmp_path / "baseline.json", [live, stale])
    proc = cli("--baseline", str(b), str(green))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "stale suppression" in proc.stderr
    assert "1 STALE suppression(s)" in proc.stdout
    proc = cli("--baseline", str(b), "--prune-baseline", str(green))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(b.read_text())["suppressions"] == [live]


# ---------------------------------------------------------------- formats

def test_sarif_equals_the_reference_for_the_same_findings():
    red = FIXTURES / "bare_except_red.py"
    docs = []
    for module in ("ceph_tpu.analysis", "ceph_tpu_torch.analysis"):
        proc = cli("--format", "sarif", str(red), module=module)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        docs.append(json.loads(proc.stdout))
    assert docs[1] == docs[0]
    run = docs[1]["runs"][0]
    assert docs[1]["version"] == "2.1.0"
    assert run["tool"]["driver"]["name"] == "cephck"
    ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    for res in run["results"]:
        assert ids[res["ruleIndex"]] == res["ruleId"]
    assert run["invocations"][0]["executionSuccessful"] is True


def test_sarif_report_escapes_hostile_messages():
    nasty = 'quote " backslash \\ newline \n percent %0A tab \t é'
    rules = [cls() for cls in ALL_RULES]
    f = Finding(rule="bare-except", path='a "b"/c.py', line=3,
                symbol="f", message=nasty)
    log = sarif_report(rules, [f], errors=["boom \n %25"], stale=[])
    ref_log = ref_engine.sarif_report(
        [cls() for cls in REF_RULES],
        [ref_engine.Finding(**dataclasses.asdict(f))],
        errors=["boom \n %25"], stale=[])
    back = json.loads(json.dumps(log))
    assert back == json.loads(json.dumps(ref_log))
    res = back["runs"][0]["results"][0]
    assert res["message"]["text"] == nasty
    assert res["locations"][0]["physicalLocation"][
        "artifactLocation"]["uri"] == 'a "b"/c.py'
    inv = back["runs"][0]["invocations"][0]
    assert inv["toolExecutionNotifications"][0]["message"]["text"] == \
        "boom \n %25"
    assert inv["executionSuccessful"] is False
    assert [r["id"] for r in back["runs"][0]["tool"]["driver"]["rules"]] \
        == ["bare-except"]


def test_format_github_emits_workflow_annotations():
    red = FIXTURES / "bare_except_red.py"
    out = {}
    for module in ("ceph_tpu.analysis", "ceph_tpu_torch.analysis"):
        proc = cli("--format", "github", str(red), module=module)
        assert proc.returncode == 1
        out[module] = [ln for ln in proc.stdout.splitlines()
                       if ln.startswith("::error ")]
    assert out["ceph_tpu_torch.analysis"] == out["ceph_tpu.analysis"]
    line = out["ceph_tpu_torch.analysis"][0]
    assert "file=tests/fixtures/cephck/bare_except_red.py" in line
    assert "title=cephck bare-except" in line


def test_format_json_matches_json_flag():
    red = FIXTURES / "bare_except_red.py"
    out = {}
    for flag in (["--json"], ["--format", "json"]):
        proc = cli(*flag, str(red))
        assert proc.returncode == 1
        out[tuple(flag)] = json.loads(proc.stdout)
    assert out[("--json",)] == out[("--format", "json")]
    assert out[("--json",)]["findings"][0]["rule"] == "bare-except"
    ref = json.loads(cli("--json", str(red),
                         module="ceph_tpu.analysis").stdout)
    assert out[("--json",)] == ref


# -------------------------------------------------------------------- CLI

def test_cli_exit_codes(tmp_path):
    """0 clean, 1 findings, 2 a bad path, baseline or rule."""
    red = FIXTURES / "bare_except_red.py"
    green = FIXTURES / "bare_except_green.py"
    proc = cli(str(red))
    assert proc.returncode == 1 and "bare-except" in proc.stdout
    assert cli(str(green)).returncode == 0
    assert cli("no/such/path.py").returncode == 2
    bad = write_baseline(tmp_path / "bad.json", [{"rule": "raw-lock",
                                                  "path": "x.py"}])
    proc = cli("--baseline", str(bad), str(green))
    assert proc.returncode == 2 and "reason" in proc.stderr
    assert cli("--baseline", str(tmp_path / "none.json"),
               str(green)).returncode == 2
    assert cli("--explain", "no-such-rule").returncode == 2
    assert cli("--no-baseline", str(red)).returncode == 1


def test_list_rules_and_explain():
    proc = cli("--list-rules")
    assert proc.returncode == 0
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == \
        [cls.id for cls in ALL_RULES]
    proc = cli("--explain", "guarded-by")
    assert proc.returncode == 0
    assert proc.stdout.startswith("guarded-by\n==========\n")
    ref = cli("--explain", "guarded-by", module="ceph_tpu.analysis")
    # the same header and summary line (the docs' history notes differ)
    assert proc.stdout.splitlines()[:3] == ref.stdout.splitlines()[:3]
