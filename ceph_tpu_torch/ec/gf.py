"""GF(2^8) arithmetic core (numpy, CPU reference oracle).

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d),
the field used by both ISA-L (`gf_mul` tables) and gf-complete's default
w=8 field — so all coding matrices and parity bytes here are in the same
field as the reference plugins (ref: src/erasure-code/isa/ErasureCodeIsa.cc,
src/erasure-code/jerasure/ErasureCodeJerasure.cc).

The port's own copy of `ceph_tpu.ec.gf`: plain numpy, the byte-exact
oracle the CUDA kernels and their plain PyTorch versions are held to.
The port imports nothing of `ceph_tpu`, so the tables and matrix
builders live here too; tests pin them equal to the reference.
"""
from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
GF_ORDER = 256


@functools.lru_cache(maxsize=None)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """(log, antilog) tables for generator 2 over poly 0x11d.

    antilog[i] = 2^i for i in [0, 255) (period 255); log[antilog[i]] = i.
    log[0] is invalid and set to 512 so table users can detect it.
    """
    antilog = np.zeros(512, dtype=np.int32)  # doubled to skip the % 255
    log = np.full(256, 512, dtype=np.int32)
    x = 1
    for i in range(255):
        antilog[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    antilog[255:510] = antilog[0:255]
    return log, antilog


@functools.lru_cache(maxsize=None)
def mul_table() -> np.ndarray:
    """Full 256x256 GF(2^8) multiplication table (uint8)."""
    log, antilog = _tables()
    a = np.arange(256)
    s = log[a][:, None] + log[a][None, :]
    out = antilog[np.minimum(s, 510)].astype(np.uint8)
    out[0, :] = 0
    out[:, 0] = 0
    return out


@functools.lru_cache(maxsize=None)
def inv_table() -> np.ndarray:
    """Multiplicative inverses; inv[0] = 0 (matching ISA-L gf_inv(0) wrap)."""
    log, antilog = _tables()
    inv = np.zeros(256, dtype=np.uint8)
    inv[1:] = antilog[255 - log[np.arange(1, 256)]].astype(np.uint8)
    return inv


def gf_mul(a: int, b: int) -> int:
    return int(mul_table()[a & 0xFF, b & 0xFF])


def gf_inv(a: int) -> int:
    return int(inv_table()[a & 0xFF])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, n: int) -> int:
    r = 1
    for _ in range(n):
        r = gf_mul(r, a)
    return r


# ---------------------------------------------------------------------------
# Vectorized block math (the CPU oracle for encode/decode)
# ---------------------------------------------------------------------------

def gf_matmul_bytes(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """(r x k) GF matrix times (k x n) byte block -> (r x n) bytes.

    out[i, :] = XOR_j mat[i, j] * data[j, :].  This is exactly ISA-L's
    ec_encode_data semantics (ref: src/erasure-code/isa/ErasureCodeIsa.cc:129)
    with mat = the coding submatrix.
    """
    mat = np.asarray(mat, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    r, k = mat.shape
    assert data.shape[0] == k, (mat.shape, data.shape)
    MUL = mul_table()
    out = np.zeros((r, data.shape[1]), dtype=np.uint8)
    for j in range(k):  # loop k (small); vector ops over n (large)
        out ^= MUL[mat[:, j][:, None], data[j][None, :]]
    return out


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Small dense GF matrix product (r x k) @ (k x c)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    MUL = mul_table()
    prod = MUL[a[:, :, None], b[None, :, :]]  # (r, k, c)
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_invert_matrix(m: np.ndarray) -> np.ndarray | None:
    """Gauss-Jordan inversion over GF(2^8); None if singular.

    Mirrors ISA-L gf_invert_matrix semantics (used by the isa plugin decode,
    ref: src/erasure-code/isa/ErasureCodeIsa.cc:275).
    """
    m = np.array(m, dtype=np.uint8, copy=True)
    n = m.shape[0]
    assert m.shape == (n, n)
    MUL = mul_table()
    INV = inv_table()
    out = np.eye(n, dtype=np.uint8)
    for i in range(n):
        # pivot: swap in a lower row if the diagonal is zero
        if m[i, i] == 0:
            rows = np.nonzero(m[i + 1:, i])[0]
            if rows.size == 0:
                return None
            j = i + 1 + rows[0]
            m[[i, j]] = m[[j, i]]
            out[[i, j]] = out[[j, i]]
        piv = INV[m[i, i]]
        m[i] = MUL[piv, m[i]]
        out[i] = MUL[piv, out[i]]
        mask = np.ones(n, dtype=bool)
        mask[i] = False
        factors = m[mask, i]
        m[mask] ^= MUL[factors[:, None], m[i][None, :]]
        out[mask] ^= MUL[factors[:, None], out[i][None, :]]
    return out


# ---------------------------------------------------------------------------
# Coding-matrix generation (matching the reference plugins' constructions)
# ---------------------------------------------------------------------------

def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix: (k+m) x k, identity on top, coding row
    i (i >= k) = [gen^0, gen^1, ..., gen^(k-1)] with gen = 2^(i-k).

    The first coding row is all-ones, which is why the isa plugin has an XOR
    fast path for single data/first-parity erasures
    (ref: src/erasure-code/isa/ErasureCodeIsa.cc:196-216,385).
    """
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = np.eye(k, dtype=np.uint8)
    MUL = mul_table()
    gen = 1
    for i in range(k, k + m):
        p = 1
        for j in range(k):
            a[i, j] = p
            p = int(MUL[p, gen])
        gen = int(MUL[gen, 2])
    return a


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix: identity on top; coding row i, col j =
    1 / (i ^ j) for i in [k, k+m) (ref: ErasureCodeIsa.cc:387)."""
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = np.eye(k, dtype=np.uint8)
    INV = inv_table()
    for i in range(k, k + m):
        for j in range(k):
            a[i, j] = INV[i ^ j]
    return a


def vandermonde_matrix(rows: int, cols: int) -> np.ndarray:
    """V[i][j] = i^j in GF(2^8) (0^0 = 1)."""
    MUL = mul_table()
    v = np.zeros((rows, cols), dtype=np.uint8)
    v[:, 0] = 1
    for i in range(rows):
        for j in range(1, cols):
            v[i, j] = MUL[v[i, j - 1], i]
    return v


def jerasure_vandermonde_coding_matrix(k: int, m: int) -> np.ndarray:
    """Systematic Vandermonde coding rows, jerasure reed_sol_van style.

    jerasure builds V[i][j] = i^j over k+m rows and systematizes the top
    k x k block to identity with column elementary operations
    (reed_sol_vandermonde_coding_matrix, used by the jerasure plugin at
    ref: src/erasure-code/jerasure/ErasureCodeJerasure.cc:205).  Column
    operations that reduce the top block to I amount to right-multiplying by
    inv(V[:k]), so the result is canonically W = V @ inv(V[:k]); the coding
    matrix is its bottom m rows.
    """
    v = vandermonde_matrix(k + m, k)
    top_inv = gf_invert_matrix(v[:k])
    assert top_inv is not None
    return gf_matmul(v[k:], top_inv)


def jerasure_r6_coding_matrix(k: int) -> np.ndarray:
    """RAID-6 rows: P = all ones, Q = [1, 2, 4, ... 2^(k-1)]
    (jerasure reed_sol_r6_coding_matrix; plugin technique reed_sol_r6_op,
    ref: src/erasure-code/jerasure/ErasureCodeJerasure.h:84)."""
    MUL = mul_table()
    mat = np.zeros((2, k), dtype=np.uint8)
    mat[0] = 1
    p = 1
    for j in range(k):
        mat[1, j] = p
        p = int(MUL[p, 2])
    return mat


def cauchy_original_coding_matrix(k: int, m: int) -> np.ndarray:
    """jerasure cauchy_original_coding_matrix: row i, col j = 1/(i ^ (m+j))
    (technique cauchy_orig, ref: ErasureCodeJerasure.cc:324)."""
    INV = inv_table()
    a = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            a[i, j] = INV[i ^ (m + j)]
    return a


def gf_bitmatrix_ones(e: int) -> int:
    """Number of 1 bits in the 8x8 GF(2)-companion matrix of 'multiply by e'
    (jerasure's cost metric for cauchy_good matrix improvement)."""
    MUL = mul_table()
    return sum(int(bin(int(MUL[e, 1 << c])).count("1")) for c in range(8))


def cauchy_good_coding_matrix(k: int, m: int) -> np.ndarray:
    """jerasure cauchy_good_general_coding_matrix: start from the original
    Cauchy matrix, then improve it (divide each column by its row-0 element
    so row 0 is all ones; then divide each later row by the element whose
    choice minimizes the total bitmatrix ones-count of the row)
    (technique cauchy_good, ref: ErasureCodeJerasure.cc:334)."""
    a = cauchy_original_coding_matrix(k, m)
    MUL = mul_table()
    INV = inv_table()
    # column normalize: row 0 -> all ones
    for j in range(k):
        d = INV[a[0, j]]
        a[:, j] = MUL[d, a[:, j]]
    # row improve
    for i in range(1, m):
        best_div, best_cost = 1, None
        for e in sorted(set(int(x) for x in a[i])):
            d = INV[e]
            cost = sum(gf_bitmatrix_ones(int(MUL[d, x])) for x in a[i])
            if best_cost is None or cost < best_cost:
                best_cost, best_div = cost, d
        a[i] = MUL[best_div, a[i]]
    return a


# ---------------------------------------------------------------------------
# GF(2) companion-bitmatrix expansion (jerasure-style bitmatrix form)
# ---------------------------------------------------------------------------

def expand_to_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """(r x k) byte matrix -> (8r x 8k) GF(2) bit matrix B such that
    byte-matmul over GF(2^8) == bit-matmul over GF(2) on bit-planes.

    B[8i+t, 8j+c] = bit t of (mat[i,j] * x^c).  This is also jerasure's
    jerasure_matrix_to_bitmatrix layout (transposed per-cell).
    """
    mat = np.asarray(mat, dtype=np.uint8)
    r, k = mat.shape
    MUL = mul_table()
    shifted = MUL[mat[:, :, None], (1 << np.arange(8))[None, None, :]]  # (r,k,8) bytes
    bits = (shifted[:, :, None, :] >> np.arange(8)[None, None, :, None]) & 1  # (r,k,8t,8c)
    return bits.transpose(0, 2, 1, 3).reshape(8 * r, 8 * k).astype(np.uint8)
