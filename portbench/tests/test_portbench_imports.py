"""The import rule: a run loads no module whose top-level name is jax,
jaxlib, flax or ceph_tpu, and the reference loads nothing of the port."""
import json
import subprocess
import sys

from portbench import spec

RUN_SMALL = """
import json, sys, torch
from portbench import run, spec
from portbench.tests.conftest import CPU, small
for name in [w["name"] for w in spec.load_benchmark()["workloads"]]:
    cell = spec.resolve(name)
    assert run.run_cell(cell, 3, 0.05, False, CPU, **small(cell))["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import json, sys
import portbench.reference, portbench.control
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    loaded = _top_level(RUN_SMALL)
    assert "ceph_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "ceph_tpu"}


def test_the_reference_and_control_load_nothing_of_the_port():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & {"jax", "jaxlib", "flax", "ceph_tpu",
                         "ceph_tpu_torch"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceph_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish.sub", sys)
    assert run_forbidden() == []
    monkeypatch.setitem(sys.modules, "ceph_tpu.ec", sys)
    assert run_forbidden() == ["ceph_tpu.ec"]


def run_forbidden():
    from portbench import run
    return [m for m in run.forbidden_modules()
            if m in ("ceph_tpu_torch_like", "jaxish.sub", "ceph_tpu.ec")]
