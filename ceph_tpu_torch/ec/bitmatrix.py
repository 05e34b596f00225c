"""GF(2) bitmatrix RAID-6 codes: liberation / blaum_roth / liber8tion.

The jerasure bit-matrix technique family (ref: src/erasure-code/
jerasure/ErasureCodeJerasure.h:152-252 — ErasureCodeJerasureLiberation
/ BlaumRoth / Liber8tion; schedule encode ErasureCodeJerasure.cc:266).
These are m=2 codes over GF(2): each chunk is w *packets*, and coding
is a (2w x kw) 0/1 matrix applied to the packet vector — XORs only, no
field multiplies.  Over GF(2^8), 1 * b = b and 0 * b = 0, so the same
product is a GF(2^8) byte-matrix product whose entries are 0 or 1: the
device form (`gf2_matmul_device`) runs it through the port's K1 kernel.

Constructions (all public algorithms):

* **blaum_roth** — the Blaum-Roth array code over the polynomial ring
  R = GF(2)[x] / M_p(x), M_p = 1 + x + ... + x^w with p = w+1 prime
  (Blaum & Roth, "On Lowest Density MDS Codes", IEEE-IT 1999; the
  construction is fully determined, so these matrices match any
  faithful implementation): Q's column j is the multiply-by-x^j
  matrix in R.
* **liberation** — Plank's RAID-6 Liberation codes (FAST'08) in the
  paper's closed form: w prime, X_0 = I, X_j = the j-step cyclic
  shift of I plus one bump bit at (j(w-1)/2 mod w, +j-1); minimum
  density, verified MDS for every k <= w at w in {3,5,7,11,13}.
* **liber8tion** — the w=8 slot: companion-matrix powers over GF(2^8)
  (structurally MDS) standing in for the paper's machine-searched
  minimal-density tables, which only exist in the unvendored jerasure
  sources — see liber8tion_bitmatrix for the honest trade.

Every constructed code is verified MDS at build time: all C(k+2, 2)
double-erasure patterns must leave an invertible kw x kw survivor
matrix over GF(2).

The port's own copy of `ceph_tpu.ec.bitmatrix`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .interface import ErasureCodeError
from .kernels.bitmatmul import GFMatmul


# ------------------------------------------------------ GF(2) algebra

def gf2_inv(mat: np.ndarray) -> np.ndarray | None:
    """Inverse over GF(2) via Gauss-Jordan; None if singular."""
    n = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            return None
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint8) @ b.astype(np.uint8)) % 2


def bitmatrix_apply(bm: np.ndarray, packets: np.ndarray) -> np.ndarray:
    """(R x C) 0/1 matrix applied to C byte-string packets (C, L):
    output packet r = XOR of selected input packets.  Bytes are 8
    independent GF(2) streams, so XOR-reduce IS the mod-2 matmul
    (the device form runs the same product through K1)."""
    out = np.zeros((bm.shape[0], packets.shape[1]), dtype=np.uint8)
    for r in range(bm.shape[0]):
        sel = np.nonzero(bm[r])[0]
        if len(sel):
            out[r] = np.bitwise_xor.reduce(packets[sel], axis=0)
    return out


def bitmatrix_schedule(bm: np.ndarray) -> list[tuple[int, int]]:
    """Flatten a bitmatrix into an XOR op list [(dst_row, src_row)]
    (ref: jerasure_schedule_encode — the schedule form the reference
    executes; here it doubles as documentation of the XOR count)."""
    ops = []
    for r in range(bm.shape[0]):
        for c in np.nonzero(bm[r])[0]:
            ops.append((int(r), int(c)))
    return ops


def gf2_matmul_device(bm, packets, device=None) -> torch.Tensor:
    """Device form: the (R x C) 0/1 matrix as a GF(2^8) byte matrix
    through K1 (its plain version on the CPU).  packets (C, L) uint8,
    numpy or tensor -> (R, L) uint8 tensor on `device` (None -> cuda)."""
    bm = np.asarray(bm, dtype=np.uint8)
    if bm.size and bm.max() > 1:
        raise ValueError("bitmatrix entries must be 0 or 1")
    return GFMatmul(bm, device)(packets)


# ----------------------------------------------------- constructions

def _shift_matrix(w: int, j: int) -> np.ndarray:
    """sigma^j: ones at (i, (i + j) mod w)."""
    m = np.zeros((w, w), dtype=np.uint8)
    for i in range(w):
        m[i, (i + j) % w] = 1
    return m


def _generator(k: int, w: int, xs: list[np.ndarray]) -> np.ndarray:
    """[(k+2)w x kw] generator: identity data rows, P = XOR of all
    columns, Q per-column X_j."""
    g = np.zeros(((k + 2) * w, k * w), dtype=np.uint8)
    g[:k * w, :k * w] = np.eye(k * w, dtype=np.uint8)
    for j in range(k):
        g[k * w:(k + 1) * w, j * w:(j + 1) * w] = np.eye(
            w, dtype=np.uint8)
        g[(k + 1) * w:, j * w:(j + 1) * w] = xs[j]
    return g


def is_mds(k: int, w: int, g: np.ndarray) -> bool:
    """Every double-erasure leaves an invertible survivor matrix."""
    n = k + 2
    for a in range(n):
        for b in range(a + 1, n):
            rows = [c for c in range(n) if c not in (a, b)][:k]
            sub = np.vstack([g[c * w:(c + 1) * w] for c in rows])
            if gf2_inv(sub) is None:
                return False
    return True


@functools.lru_cache(maxsize=64)
def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Q_j = multiply-by-x^j in GF(2)[x]/(1 + x + ... + x^w); p = w+1
    must be prime, k <= w (Blaum-Roth 1999)."""
    p = w + 1
    if any(p % d == 0 for d in range(2, p)) or p < 3:
        raise ErasureCodeError(f"blaum_roth requires w+1 prime, w={w}")
    if k > w:
        raise ErasureCodeError(f"blaum_roth requires k <= w ({k} > {w})")
    # multiply-by-x in the ring: x * x^i = x^{i+1}; x^w = 1 + x + ...
    # + x^{w-1} (since M_p(x) = 0).  Column i of X holds x * x^i.
    X = np.zeros((w, w), dtype=np.uint8)
    for i in range(w - 1):
        X[i + 1, i] = 1
    X[:, w - 1] = 1                 # x^w reduces to all-ones
    xs = [np.eye(w, dtype=np.uint8)]
    for _ in range(1, k):
        xs.append(gf2_matmul(X, xs[-1]))
    g = _generator(k, w, xs)
    if not is_mds(k, w, g):         # the construction guarantees this
        raise ErasureCodeError("blaum_roth construction not MDS "
                               f"(k={k}, w={w})")
    return g


@functools.lru_cache(maxsize=64)
def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Plank's Liberation construction (FAST'08, closed form): X_0 = I;
    X_j = sigma^j plus one bump bit at row r = j(w-1)/2 mod w, column
    (r + j - 1) mod w.  w prime, k <= w; verified MDS at build time
    (holds for every k <= w at w in {3,5,7,11,13})."""
    if w < 2 or any(w % d == 0 for d in range(2, w)):
        raise ErasureCodeError(f"liberation requires prime w, w={w}")
    if k > w:
        raise ErasureCodeError(f"liberation requires k <= w ({k} > {w})")
    xs = []
    for j in range(k):
        x = _shift_matrix(w, j)
        if j > 0:
            r = (j * (w - 1) // 2) % w
            x[r, (r + j - 1) % w] ^= 1
        xs.append(x)
    g = _generator(k, w, xs)
    if not is_mds(k, w, g):
        raise ErasureCodeError(
            f"liberation construction not MDS (k={k}, w={w})")
    return g


@functools.lru_cache(maxsize=8)
def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """w=8, m=2, k <= 8 bitmatrix RAID-6 (the liber8tion slot).

    The paper's minimal-density X_j tables were found by machine search
    and only exist in the jerasure sources (not vendored in the
    reference checkout), so this uses companion-matrix powers over
    GF(2^8) instead: X_j = C^j with C the multiply-by-x matrix of
    x^8 + x^4 + x^3 + x^2 + 1 (gf-complete's w=8 polynomial).  MDS is
    structural — X_i ^ X_j = C^i (I ^ C^(j-i)) is invertible for all
    i != j because C generates a field.  Same interface, same w=8
    packet layout, honestly higher XOR density than the paper's
    tables; layouts pinned by committed fixtures."""
    if k > 8:
        raise ErasureCodeError(f"liber8tion requires k <= 8, k={k}")
    C = np.zeros((8, 8), dtype=np.uint8)
    for i in range(7):
        C[i + 1, i] = 1
    for r in (0, 2, 3, 4):          # x^8 = x^4 + x^3 + x^2 + 1 (0x1D)
        C[r, 7] = 1
    xs = [np.eye(8, dtype=np.uint8)]
    for _ in range(1, k):
        xs.append(gf2_matmul(C, xs[-1]))
    g = _generator(k, 8, xs)
    if not is_mds(k, 8, g):
        raise ErasureCodeError(f"liber8tion bitmatrix not MDS (k={k})")
    return g
