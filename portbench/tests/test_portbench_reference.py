"""The reference's field, matrices and codes against hand-worked values."""
import itertools

import numpy as np
import pytest
import torch

from portbench import reference as ref


def test_field_products_worked_by_hand():
    mul = ref.mul_table()
    assert mul[3, 7] == 9            # (x+1)(x^2+x+1) = x^3+1, no reduction
    assert mul[2, 0x80] == 0x1D      # x^8 = x^4+x^3+x^2+1 under 0x11d
    assert mul[0x80, 0x80] == 0x13   # x^14 = x^10+x^9+x^8+x^6 -> 0x13
    assert (mul[0] == 0).all() and (mul[1] == np.arange(256)).all()
    assert (mul == mul.T).all()
    inv = ref.inv_table()
    assert inv[2] == 0x8E and inv[4] == 0x47 and inv[1] == 1 and inv[0] == 0
    assert all(mul[a, inv[a]] == 1 for a in range(1, 256))


def test_control_field_differs_where_reduction_starts():
    assert ref.mul_table(0x11B)[2, 0x80] == 0x1B
    assert (ref.mul_table(0x11B)[:16, :16] == ref.mul_table()[:16, :16]).all()


def test_rs_matrix_worked_by_hand():
    a = ref.rs_matrix(4, 2)
    assert (a[:4] == np.eye(4, dtype=np.uint8)).all()
    assert a[4].tolist() == [1, 1, 1, 1]
    assert a[5].tolist() == [1, 2, 4, 8]
    b = ref.rs_matrix(8, 4)
    assert b[10].tolist() == [1, 4, 0x10, 0x40, 0x1D, 0x74, 0xCD, 0x13]
    assert b[11][:3].tolist() == [1, 8, 0x40]


def test_cauchy_matrix_worked_by_hand():
    a = ref.cauchy1_matrix(4, 2)
    inv = ref.inv_table()
    assert a[4].tolist() == [inv[4], inv[5], inv[6], inv[7]]
    assert a[4, 0] == 0x47 and a[5, 1] == 0x47  # 1/(5^1) = 1/4


def test_invert_round_trip():
    rng = np.random.default_rng(5)
    g = ref.rs_matrix(8, 4)
    rows = sorted(rng.choice(12, size=8, replace=False))
    inv = ref.invert(g[rows])
    assert (ref.matmul_small(inv, g[rows]) == np.eye(8, dtype=np.uint8)).all()
    with pytest.raises(ValueError):
        ref.invert(np.zeros((3, 3), dtype=np.uint8))


def test_product_matches_the_small_matmul():
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    data = rng.integers(0, 256, (2, 5, 40), dtype=np.uint8)
    out = ref.product(mat, torch.from_numpy(data))
    for s in range(2):
        assert (out[s].numpy() == ref.matmul_small(mat, data[s])).all()


def test_first_rs_parity_is_the_xor():
    data = torch.randint(0, 256, (3, 4, 64), dtype=torch.uint8)
    parity = ref.encode(ref.rs_matrix(4, 2), data)
    xor = data[:, 0] ^ data[:, 1] ^ data[:, 2] ^ data[:, 3]
    assert torch.equal(parity[:, 0], xor)


@pytest.mark.parametrize("technique,k,m", [("reed_sol_van", 8, 4),
                                            ("cauchy", 4, 2)])
def test_every_pair_rebuilds_the_stripe(technique, k, m):
    gen = ref.generator(technique, k, m)
    data = torch.randint(0, 256, (2, k, 96), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(k))
    stripe = torch.cat([data, ref.encode(gen, data)], dim=1)
    for pair in itertools.combinations(range(k + m), 2):
        assert torch.equal(ref.rebuild(gen, data, list(pair)),
                           stripe[:, list(pair)])
