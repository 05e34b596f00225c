"""The port's GF(2^8) tables and coding matrices equal the reference's."""
import numpy as np
import pytest

from ceph_tpu.ec import gf as ref_gf
from ceph_tpu.ec.plugins import tpu as ref_tpu
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.ec.plugins import tpu

TECHNIQUES = ["reed_sol_van", "cauchy", "jerasure_reed_sol_van",
              "reed_sol_r6_op", "cauchy_orig", "cauchy_good"]


def test_field_tables_equal():
    for a, b in zip(gf._tables(), ref_gf._tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gf.mul_table(), ref_gf.mul_table())
    np.testing.assert_array_equal(gf.inv_table(), ref_gf.inv_table())
    assert gf.gf_div(200, 7) == ref_gf.gf_div(200, 7)
    assert gf.gf_pow(3, 17) == ref_gf.gf_pow(3, 17)


@pytest.mark.parametrize("technique", TECHNIQUES)
@pytest.mark.parametrize("k,m", [(8, 4), (4, 2), (6, 3), (10, 2)])
def test_technique_matrices_equal(technique, k, m):
    if technique == "reed_sol_r6_op" and m != 2:
        with pytest.raises(Exception, match="m=2"):
            tpu._matrices(technique, k, m)
        return
    np.testing.assert_array_equal(tpu._matrices(technique, k, m),
                                  ref_tpu._matrices(technique, k, m))


def test_matrix_builders_equal():
    for k, m in [(3, 2), (8, 4), (12, 4)]:
        np.testing.assert_array_equal(gf.vandermonde_matrix(k + m, k),
                                      ref_gf.vandermonde_matrix(k + m, k))
        np.testing.assert_array_equal(gf.isa_rs_matrix(k, m),
                                      ref_gf.isa_rs_matrix(k, m))
        np.testing.assert_array_equal(
            gf.cauchy_good_coding_matrix(k, m),
            ref_gf.cauchy_good_coding_matrix(k, m))
    assert [gf.gf_bitmatrix_ones(e) for e in range(256)] == \
        [ref_gf.gf_bitmatrix_ones(e) for e in range(256)]


def test_inversion_and_products_equal():
    rng = np.random.default_rng(1)
    for n in (2, 4, 8, 12):
        for _ in range(10):
            a = rng.integers(0, 256, (n, n), dtype=np.uint8)
            inv, ref = gf.gf_invert_matrix(a), ref_gf.gf_invert_matrix(a)
            if ref is None:
                assert inv is None
                continue
            np.testing.assert_array_equal(inv, ref)
            np.testing.assert_array_equal(gf.gf_matmul(a, inv),
                                          np.eye(n, dtype=np.uint8))
    a = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    d = rng.integers(0, 256, (5, 77), dtype=np.uint8)
    np.testing.assert_array_equal(gf.gf_matmul_bytes(a, d),
                                  ref_gf.gf_matmul_bytes(a, d))
    np.testing.assert_array_equal(gf.expand_to_bitmatrix(a),
                                  ref_gf.expand_to_bitmatrix(a))


def test_companion_bitmatrix_equal():
    from ceph_tpu.ec.kernels.bitmatmul import companion_bitmatrix as ref
    mat = np.ascontiguousarray(gf.isa_rs_matrix(8, 4)[8:])
    np.testing.assert_array_equal(bm.companion_bitmatrix(mat.tobytes(), 4, 8),
                                  ref(mat.tobytes(), 4, 8))


def test_nibble_tables_recompose_every_product():
    """The kernels' split-nibble tables: t[b & 15] ^ t[16 + (b >> 4)]
    is c * b for every coefficient c and byte b."""
    c = np.arange(256, dtype=np.uint8).reshape(16, 16)
    t = bm.nibble_tables(c)
    assert t.shape == (16, 16, 32) and t.dtype == np.uint8
    b = np.arange(256)
    got = t[:, :, b & 15] ^ t[:, :, 16 + (b >> 4)]
    np.testing.assert_array_equal(
        got, gf.mul_table()[c[:, :, None], b[None, None, :]])
