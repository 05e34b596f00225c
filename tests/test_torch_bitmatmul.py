"""The plain versions of the port's kernels against the reference kernels.

K1 (gf_matmul) is held to the reference's fused kernel run in interpret
mode, K2 (gf_decode_select) to the reference's full-width decode, on the
same inputs made with numpy; bytes must match exactly (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec.kernels import bitmatmul as ref_bm
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.ec.matrix_code import make_decode_matrix_full

CPU = torch.device("cpu")


@pytest.mark.parametrize("s,k,r,n", [
    (1, 8, 4, 2048 + 17),   # one stripe, ragged tail
    (2, 8, 2, 4096),        # staged-decode rows
    (3, 5, 3, 2048 + 1),    # odd batch, one-byte tail
    (4, 20, 4, 2048),       # wide k
    (6, 3, 2, 1000),        # below the reference's tile: its XLA path
])
def test_plain_k1_matches_reference_kernel(s, k, r, n):
    rng = np.random.default_rng(s * 1000 + k * 10 + r)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = rng.integers(0, 256, (s, k, n), dtype=np.uint8)
    want = np.asarray(ref_bm.gf_matmul_pallas(mat, jnp.asarray(data),
                                              interpret=True))
    got = bm.GFMatmul(mat, CPU)(data)
    assert got.device == CPU and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatcher on a cpu tensor is the plain version itself
    plain = bm.gf_matmul_plain(torch.from_numpy(mat), torch.from_numpy(data))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_plain_k1_keeps_leading_axes():
    rng = np.random.default_rng(2)
    mat = gf.isa_rs_matrix(4, 2)[4:]
    data = rng.integers(0, 256, (2, 3, 4, 64), dtype=np.uint8)
    got = bm.GFMatmul(mat, CPU)(torch.from_numpy(data))
    assert got.shape == (2, 3, 2, 64)
    for a in range(2):
        for b in range(3):
            np.testing.assert_array_equal(
                got[a, b].numpy(), gf.gf_matmul_bytes(mat, data[a, b]))
    with pytest.raises(ValueError, match="input rows"):
        bm.GFMatmul(mat, CPU)(data[:, :, :3])


@pytest.mark.parametrize("k,m,s,erasures", [
    (8, 4, 4, [1, 9]),
    (8, 4, 3, [0, 1, 2, 3]),
    (4, 2, 1, [5]),
    (4, 2, 2, [0, 4]),
])
def test_plain_k2_matches_reference_with_garbage(k, m, s, erasures):
    n = k + m
    nbytes = 2048 + 40
    em = gf.isa_rs_matrix(k, m)
    rng = np.random.default_rng(k * 100 + len(erasures))
    data = rng.integers(0, 256, (s, k, nbytes), dtype=np.uint8)
    parity = np.stack([gf.gf_matmul_bytes(em[k:], d) for d in data])
    arrival = np.concatenate([data, parity], axis=1)
    want = arrival[:, erasures].copy()
    arrival[:, erasures] = rng.integers(0, 256, (s, len(erasures), nbytes),
                                        dtype=np.uint8)
    decode_index = [i for i in range(n) if i not in erasures][:k]
    full = make_decode_matrix_full(em, k, n, decode_index, erasures)
    valid = np.ones(n, dtype=bool)
    valid[erasures] = False
    ref = ref_bm.GFDecodeFull(full, valid, use_pallas=True)
    ref_out = np.asarray(ref(jnp.asarray(arrival), interpret=True))
    op = bm.GFDecodeFull(full, valid, CPU)
    assert op.sel == ref.sel
    assert op.runs == ref_bm._survivor_runs(list(ref.sel))
    got = op(arrival).numpy()
    np.testing.assert_array_equal(got, ref_out)
    np.testing.assert_array_equal(got, want)
    plain = bm.gf_decode_select_plain(op.mat_t, op.runs,
                                      torch.from_numpy(arrival))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_survivor_runs_match_reference():
    for idx in ([0, 1, 2, 3], [0, 2, 3, 5, 6, 7], [4], [1, 3, 5, 7, 8, 9]):
        assert bm._survivor_runs(idx) == ref_bm._survivor_runs(idx)


def test_selection_validity_contract():
    """A nonzero column over a slot the validity mask marks erased
    would fold garbage into the rebuild: hard error, as in the
    reference."""
    mat = np.zeros((2, 6), dtype=np.uint8)
    mat[:, [0, 1, 2, 3]] = 1
    valid = np.array([1, 1, 1, 0, 1, 1], dtype=bool)
    with pytest.raises(ValueError, match="validity mask"):
        bm.selection_from_matrix(mat, valid)
    with pytest.raises(ValueError, match="validity mask"):
        bm.GFDecodeFull(mat, valid, CPU)
    valid[3] = True
    assert bm.selection_from_matrix(mat, valid) == [0, 1, 2, 3] == \
        ref_bm.selection_from_matrix(mat, valid)
    with pytest.raises(ValueError, match="no nonzero"):
        bm.GFDecodeFull(np.zeros((1, 6), dtype=np.uint8), None, CPU)
    with pytest.raises(ValueError, match="chunk slots"):
        bm.GFDecodeFull(mat, valid, CPU)(np.zeros((1, 5, 8), np.uint8))


def test_dispatch_takes_plain_version_only_for_cpu_tensors():
    mat = torch.from_numpy(gf.isa_rs_matrix(4, 2)[4:].copy())
    tables = torch.from_numpy(bm.packed_nibble_tables(mat.numpy()))
    meta = torch.empty((1, 4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bm.gf_matmul(tables, mat, meta)
    with pytest.raises(ValueError, match="cuda"):
        bm.gf_matmul_cuda(tables, torch.zeros((1, 4, 16), dtype=torch.uint8),
                          2)
    before = dict(bm.LAUNCHES)
    bm.gf_matmul(tables, mat, torch.zeros((1, 4, 16), dtype=torch.uint8))
    assert bm.LAUNCHES == before        # the plain version counts nothing


def test_operators_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mat = gf.isa_rs_matrix(4, 2)[4:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bm.GFMatmul(mat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bm.GFDecodeFull(np.ones((1, 6), dtype=np.uint8), device="cuda")
