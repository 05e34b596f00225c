"""The check fails what it must: the control on three seeds, and a run
whose timed path is broken underneath, once per fault a cell can have.

The control (portbench/control.py) is the reference in the program's
place over the wrong field.  The faults are planted in the port's kernel
dispatchers (`bitmatmul.gf_matmul`, K1's, and `gf_decode_select`, K2's),
below the plugin the harness calls, on the CPU where those dispatchers
run the plain versions; the harness's look for a card is skipped.  A
cell on one card has no exchange between chips, so that fault is not
among them.
"""
import pytest
import torch

from ceph_tpu_torch.ec.kernels import bitmatmul
from portbench import control, run
from portbench.tests.conftest import CPU, small

SEEDS = (2**31 + 11, 2**32 + 5, 9)


def _zeros(out, i):
    """a step that returns its state unchanged: the output never written"""
    return torch.zeros_like(out)


def _half(out, i):
    """half of the batch left out: the second half of the stripes"""
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _altered(out, i):
    """an answer altered where it is produced: one byte of one stripe"""
    out = out.clone()
    flat = out.view(-1)
    flat[(i * 7919) % flat.numel()] ^= 1
    return out


FAULTS = [_zeros, _half, _altered]


def _break(monkeypatch, fault):
    calls = {"n": 0}

    def wrap(real):
        def broken(*args):
            calls["n"] += 1
            return fault(real(*args), calls["n"])
        return broken

    monkeypatch.setattr(bitmatmul, "gf_matmul", wrap(bitmatmul.gf_matmul))
    monkeypatch.setattr(bitmatmul, "gf_decode_select",
                        wrap(bitmatmul.gf_decode_select))


def test_the_program_is_correct(cell):
    for seed in SEEDS:
        res = run.run_cell(cell, seed, 0.1, False, CPU, **small(cell))
        assert res["correct"], res["checks"]


def test_the_control_fails_on_every_seed(cell):
    for seed in SEEDS:
        res = run.run_cell(cell, seed, 0.1, False, CPU,
                           make_code=control.ControlCode,
                           **small(cell, sample=16))
        assert not res["correct"]
        assert res["checks"]["mismatched_bytes"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_fault_underneath_is_not_correct(cell, fault, monkeypatch):
    _break(monkeypatch, fault)
    res = run.run_cell(cell, SEEDS[0], 0.1, False, CPU, **small(cell))
    assert not res["correct"]
    assert res["failed"] > 0
