"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips without a CUDA device.  On a machine with
one (no JAX needed, so the repository conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs, compared exactly.
"""
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import gf, registry
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.ec.matrix_code import make_decode_matrix_full

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("r,k,s,n", [
    (4, 8, 4, 131072), (2, 8, 3, 4096), (3, 5, 7, 31), (4, 20, 1, 4113),
    (10, 6, 2, 1000), (1, 2, 5, 1),
])
def test_k1_matches_plain(dev, r, k, s, n):
    rng = np.random.default_rng(r * 1000 + k * 10 + s)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = torch.from_numpy(
        rng.integers(0, 256, (s, k, n), dtype=np.uint8)).to(dev)
    tables = torch.from_numpy(bm.nibble_tables(mat)).to(dev)
    before = bm.LAUNCHES["gf_matmul"]
    got = bm.gf_matmul_cuda(tables, data)
    assert bm.LAUNCHES["gf_matmul"] == before + 1
    want = bm.gf_matmul_plain(torch.from_numpy(mat).to(dev), data)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k2_matches_plain_all_double_erasures(dev):
    k, m = 8, 4
    n = k + m
    ec = registry.factory("tpu", {"k": str(k), "m": str(m)}, device=dev)
    rng = np.random.default_rng(3)
    for erasures in itertools.combinations(range(n), 2):
        erasures = list(erasures)
        decode_index = [i for i in range(n) if i not in erasures][:k]
        full = make_decode_matrix_full(ec.encode_matrix, k, n, decode_index,
                                       erasures)
        op = bm.GFDecodeFull(full, None, dev)
        data = rng.integers(0, 256, (2, k, 999), dtype=np.uint8)
        parity = np.stack([gf.gf_matmul_bytes(ec.encode_matrix[k:], d)
                           for d in data])
        arrival = np.concatenate([data, parity], axis=1)
        want = arrival[:, erasures].copy()
        arrival[:, erasures] = rng.integers(0, 256, (2, 2, 999),
                                            dtype=np.uint8)
        a = torch.from_numpy(arrival).to(dev)
        got = bm.gf_decode_select_cuda(op.tables, op.sel_t, a)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy(), want), erasures
        assert torch.equal(got, bm.gf_decode_select_plain(op.mat_t, op.runs, a))


def test_plugin_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (3, 8, 4096), dtype=np.uint8)
    card = registry.factory("tpu", {"k": "8", "m": "4"})
    cpu = registry.factory("tpu", {"k": "8", "m": "4"}, device="cpu")
    assert torch.equal(card.encode_batch(data).cpu(), cpu.encode_batch(data))
    full = np.concatenate([data, cpu.encode_batch(data).numpy()], axis=1)
    outs = list(card.decode_batches_full([1, 9], [full, full[::-1].copy()]))
    assert np.array_equal(outs[0].cpu().numpy(), full[:, [1, 9]])
    assert np.array_equal(outs[1].cpu().numpy(), full[::-1][:, [1, 9]])
