"""Plain GF(2^8) erasure code: the benchmark's reference.

Follows ISA-L's published construction (erasure_code/ec_base.c):
`gf_gen_rs_matrix` and `gf_gen_cauchy1_matrix` build the (k+m) x k
generator with the identity on top, `ec_encode_data` multiplies its
coding rows into the k data chunks, and a decode inverts the k x k
submatrix of the first k surviving chunks (ErasureCodeIsa.cc's
`decode_index`) and multiplies the rows it needs into those survivors.

The field is built here by schoolbook multiplication reduced by the
polynomial, not from log tables, so it shares no table with the program.
Products run as plain PyTorch lookups and XORs, on whatever device the
data is on, in blocks so that the int64 indexes stay small.  Imports
nothing but numpy and torch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, ISA-L's and gf-complete's field
#: elements of one lookup block (the int64 index it takes is 8x this)
BLOCK_ELEMS = 1 << 25


@functools.lru_cache(maxsize=None)
def mul_table(poly: int = GF_POLY) -> np.ndarray:
    """(256, 256) uint8: a * b, carry-less, reduced by `poly`."""
    a = np.arange(256, dtype=np.int32)[:, None]
    b = np.arange(256, dtype=np.int32)[None, :]
    prod = np.zeros((256, 256), dtype=np.int32)
    for bit in range(8):
        prod ^= np.where((b >> bit) & 1, a << bit, 0)
    for bit in range(14, 7, -1):
        prod = np.where((prod >> bit) & 1, prod ^ (poly << (bit - 8)), prod)
    return prod.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def inv_table(poly: int = GF_POLY) -> np.ndarray:
    """(256,) uint8 multiplicative inverses; inv[0] = 0 as in ISA-L."""
    mul = mul_table(poly)
    inv = np.zeros(256, dtype=np.uint8)
    for a in range(1, 256):
        inv[a] = int(np.flatnonzero(mul[a] == 1)[0])
    return inv


def rs_matrix(k: int, m: int, poly: int = GF_POLY) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix(a, k + m, k): coding row i, column j is
    gen^j with gen = 2^(i - k)."""
    mul = mul_table(poly)
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = np.eye(k, dtype=np.uint8)
    gen = 1
    for i in range(k, k + m):
        p = 1
        for j in range(k):
            a[i, j] = p
            p = int(mul[p, gen])
        gen = int(mul[gen, 2])
    return a


def cauchy1_matrix(k: int, m: int, poly: int = GF_POLY) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix(a, k + m, k): coding row i, column j
    is 1 / (i ^ j)."""
    inv = inv_table(poly)
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = np.eye(k, dtype=np.uint8)
    for i in range(k, k + m):
        for j in range(k):
            a[i, j] = inv[i ^ j]
    return a


GENERATORS = {"reed_sol_van": rs_matrix, "cauchy": cauchy1_matrix}


def generator(technique: str, k: int, m: int,
              poly: int = GF_POLY) -> np.ndarray:
    """The (k+m) x k generator of a `tpu` profile's technique."""
    try:
        return GENERATORS[technique](k, m, poly)
    except KeyError:
        raise ValueError(f"no reference for technique {technique!r}") from None


def matmul_small(a: np.ndarray, b: np.ndarray,
                 poly: int = GF_POLY) -> np.ndarray:
    """Dense (r x k) @ (k x c) over GF(2^8)."""
    mul = mul_table(poly)
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for j in range(a.shape[1]):
        out ^= mul[a[:, j][:, None], b[j][None, :]]
    return out


def invert(mat: np.ndarray, poly: int = GF_POLY) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8); raises if singular."""
    mul, inv = mul_table(poly), inv_table(poly)
    a = np.array(mat, dtype=np.uint8)
    n = a.shape[0]
    out = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivots = np.flatnonzero(a[col:, col])
        if pivots.size == 0:
            raise ValueError("singular matrix")
        p = col + int(pivots[0])
        a[[col, p]] = a[[p, col]]
        out[[col, p]] = out[[p, col]]
        f = inv[a[col, col]]
        a[col] = mul[f, a[col]]
        out[col] = mul[f, out[col]]
        for row in range(n):
            if row != col and a[row, col]:
                f = a[row, col]
                a[row] ^= mul[f, a[col]]
                out[row] ^= mul[f, out[col]]
    return out


def decode_rows(gen: np.ndarray, k: int, erasures: list[int],
                poly: int = GF_POLY) -> tuple[list[int], np.ndarray]:
    """(decode_index, rows): the first k surviving chunks in index order
    and the (len(erasures) x k) matrix that rebuilds `erasures` from
    them: row e of the survivors' inverse for a data chunk, the
    generator's row e times that inverse for a coding chunk."""
    n = gen.shape[0]
    decode_index = [i for i in range(n) if i not in set(erasures)][:k]
    if len(decode_index) < k:
        raise ValueError("fewer than k chunks survive")
    inv_b = invert(gen[decode_index], poly)
    rows = [inv_b[e] if e < k else matmul_small(gen[e][None, :], inv_b,
                                                 poly)[0]
            for e in erasures]
    return decode_index, np.stack(rows).astype(np.uint8)


def product(mat: np.ndarray, data: torch.Tensor,
            poly: int = GF_POLY) -> torch.Tensor:
    """(r x k) byte matrix times (S, k, N) uint8 chunks -> (S, r, N):
    out[:, i] = XOR_j mat[i, j] * data[:, j], by table lookup."""
    mat = np.asarray(mat, dtype=np.uint8)
    s, k, n = data.shape
    r = mat.shape[0]
    if mat.shape[1] != k:
        raise ValueError(f"matrix has {mat.shape[1]} columns, data {k} rows")
    mul = torch.from_numpy(mul_table(poly)).to(data.device)
    out = torch.zeros((s, r, n), dtype=torch.uint8, device=data.device)
    step = max(1, BLOCK_ELEMS // max(n, 1))
    for lo in range(0, s, step):
        hi = min(s, lo + step)
        for j in range(k):
            idx = data[lo:hi, j].long()
            for i in range(r):
                if mat[i, j]:
                    out[lo:hi, i] ^= mul[int(mat[i, j])][idx]
    return out


def encode(gen: np.ndarray, data: torch.Tensor,
           poly: int = GF_POLY) -> torch.Tensor:
    """(S, k, N) data chunks -> (S, m, N) coding chunks."""
    k = gen.shape[1]
    return product(gen[k:], data, poly)


def rebuild(gen: np.ndarray, data: torch.Tensor, erasures: list[int],
            poly: int = GF_POLY) -> torch.Tensor:
    """Chunks `erasures` of the stripes of (S, k, N) data, rebuilt from
    the survivors of the reference's own encode -> (S, len(erasures), N)."""
    k = gen.shape[1]
    stripe = torch.cat([data, encode(gen, data, poly)], dim=1)
    decode_index, rows = decode_rows(gen, k, list(erasures), poly)
    return product(rows, stripe[:, decode_index].contiguous(), poly)
