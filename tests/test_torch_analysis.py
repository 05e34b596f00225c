"""The port's device-contract rules (ceph_tpu_torch.analysis).

For each of the three rules (`cuda-timing`, `host-sync-hot-path`,
`implicit-transfer`, the torch counterparts of the reference's
`jax-timing`, `host-sync-hot-path` and `implicit-transfer`): a red
snippet the rule must catch and a green one it must pass, written to
tmp_path as a small project whose kernel wrapper counts its launch the
way the port's CUDA wrappers do.  Then the waiver (with its reason, and
without one), and the scan of the port and chip_smoke.py, which must
report no finding that is not waived, every waiver carrying its reason.
"""
import pathlib
import subprocess
import sys
import textwrap

import pytest

from ceph_tpu_torch.analysis import ALL_RULES, Engine
from ceph_tpu_torch.analysis.engine import FileContext

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
    """The port and chip_smoke.py: no finding left unwaived, and every
    waiver in them names its reason."""
    eng = Engine([cls() for cls in ALL_RULES], ROOT)
    rc = eng.run(["ceph_tpu_torch", "chip_smoke.py"])
    assert rc == 0, [f.render() for f in eng.findings] + eng.errors
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
