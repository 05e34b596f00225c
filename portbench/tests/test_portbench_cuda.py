"""On the card: one short run of each cell, untraced and traced, ends
correct with every metric the cell lists.  Run on the card with

    python3 -m pytest -p no:cacheprovider -m cuda portbench/tests/test_portbench_cuda.py
"""
import json
import subprocess
import sys

import pytest
import torch

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(card, name, traced):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", str(2**31 + 99), "--seconds", "1", "--trace",
         str(traced)], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    cell = spec.resolve(name)
    want = cell.per_layer if traced else cell.end_to_end
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in want}
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name_, m in res["metrics"].items():
            if name_.endswith("_roofline"):
                assert 0 < m["value"] <= 100
    assert proc.stderr.rstrip().splitlines()[-1].startswith("check ")
