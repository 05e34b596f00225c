"""GF(2^w) arithmetic for w in {8, 16, 32} — the wide-word fields of
jerasure's matrix techniques.

Polynomials are gf-complete's defaults (ref: jerasure/gf-complete
gf_w8/gf_w16/gf_w32 primitive polynomials, used by the reference plugin
via galois_*_region_multiply): w=8 0x11d, w=16 0x1100b, w=32 0x400007.
w<=16 runs on log/antilog tables; w=32 multiplies by folding the
constant's bit-shift products (tables would need 2^32 entries).

Matrix constructions (distilled Vandermonde, RAID-6, Cauchy) are the
same shapes as the GF(2^8) versions in gf.py, parameterized by field;
gf.py remains the byte-field fast path.  These fields are not
byte-linear, so nothing here reaches the GF(2^8) kernels: wide-w codes
stay host numpy, interpreted decode included.

The port's own copy of `ceph_tpu.ec.gfw`.
"""
from __future__ import annotations

import functools

import numpy as np

POLYS = {8: 0x11D, 16: 0x1100B, 32: 0x400007}
DTYPES = {8: np.uint8, 16: np.uint16, 32: np.uint32}


class GF2w:
    def __init__(self, w: int):
        if w not in POLYS:
            raise ValueError(f"unsupported field width w={w}")
        self.w = w
        self.poly = POLYS[w]
        self.order = 1 << w
        # full reduction constant incl. the x^w term (gf-complete omits
        # it from the w=32 constant since it doesn't fit 32 bits)
        self.reduct = self.poly if self.poly >> w else \
            self.poly | self.order
        self.dtype = DTYPES[w]
        self._log = None
        self._antilog = None
        if w <= 16:
            self._build_tables()

    def _build_tables(self) -> None:
        n = self.order
        antilog = np.zeros(2 * n, dtype=np.int64)
        log = np.full(n, 2 * n, dtype=np.int64)
        x = 1
        for i in range(n - 1):
            antilog[i] = x
            log[x] = i
            x <<= 1
            if x & n:
                x ^= self.poly
        antilog[n - 1:2 * (n - 1)] = antilog[0:n - 1]
        self._log, self._antilog = log, antilog

    # ---------------------------------------------------------- scalars
    def mul(self, a: int, b: int) -> int:
        """Peasant multiply mod poly (any w)."""
        a &= self.order - 1
        b &= self.order - 1
        p = 0
        while b:
            if b & 1:
                p ^= a
            b >>= 1
            a <<= 1
            if a & self.order:
                a ^= self.reduct
        return p

    def pow(self, a: int, n: int) -> int:
        r = 1
        while n:
            if n & 1:
                r = self.mul(r, a)
            a = self.mul(a, a)
            n >>= 1
        return r

    def inv(self, a: int) -> int:
        if a == 0:
            return 0
        return self.pow(a, self.order - 2)

    # ---------------------------------------------------------- vectors
    def mul_words(self, c: int, x: np.ndarray) -> np.ndarray:
        """Constant times word array (same dtype out)."""
        if c == 0:
            return np.zeros_like(x)
        if c == 1:
            return x.copy()
        if self.w <= 16:
            lc = self._log[c]
            xi = x.astype(np.int64)
            out = np.zeros_like(xi)
            nz = xi != 0
            out[nz] = self._antilog[lc + self._log[xi[nz]]]
            return out.astype(self.dtype)
        # w=32: fold c * 2^b shift products over x's bits
        shifts = []
        cb = c
        for _ in range(self.w):
            shifts.append(cb)
            cb <<= 1
            if cb & self.order:
                cb ^= self.reduct
        out = np.zeros_like(x)
        for b, cb in enumerate(shifts):
            mask = ((x >> np.uint32(b)) & np.uint32(1)).astype(bool)
            out[mask] ^= np.uint32(cb)
        return out

    def matmul_bytes(self, mat, data: np.ndarray) -> np.ndarray:
        """(r x k) int matrix times (k x nbytes) uint8 rows interpreted
        as little-endian w-bit words -> (r x nbytes) uint8.  This is
        jerasure's matrix_encode semantics for wide w
        (ref: jerasure.c jerasure_matrix_encode -> galois_w*_region_
        multiply over 16/32-bit regions)."""
        from .interface import ErasureCodeError
        mat = np.asarray(mat, dtype=np.int64)
        r, k = mat.shape
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.shape[0] != k or data.shape[1] % (self.w // 8):
            raise ErasureCodeError(
                f"EIO: region {data.shape} not a multiple of "
                f"w/8={self.w // 8} bytes")
        words = data.view(self.dtype)       # (k, n_words), little-endian
        out = np.zeros((r, words.shape[1]), dtype=self.dtype)
        for j in range(k):
            for i in range(r):
                out[i] ^= self.mul_words(int(mat[i, j]), words[j])
        return out.view(np.uint8)

    def invert_matrix(self, mat) -> list[list[int]] | None:
        """Gauss-Jordan over GF(2^w) on small python-int matrices."""
        n = len(mat)
        m = [list(int(x) for x in row) for row in mat]
        out = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
        for i in range(n):
            if m[i][i] == 0:
                rows = [r for r in range(i + 1, n) if m[r][i]]
                if not rows:
                    return None
                j = rows[0]
                m[i], m[j] = m[j], m[i]
                out[i], out[j] = out[j], out[i]
            piv = self.inv(m[i][i])
            m[i] = [self.mul(piv, x) for x in m[i]]
            out[i] = [self.mul(piv, x) for x in out[i]]
            for r in range(n):
                if r == i or m[r][i] == 0:
                    continue
                f = m[r][i]
                m[r] = [x ^ self.mul(f, y) for x, y in zip(m[r], m[i])]
                out[r] = [x ^ self.mul(f, y)
                          for x, y in zip(out[r], out[i])]
        return out

    def matmul_small(self, a, b) -> list[list[int]]:
        ra, ka = len(a), len(a[0])
        kb, cb = len(b), len(b[0])
        assert ka == kb
        out = [[0] * cb for _ in range(ra)]
        for i in range(ra):
            for j in range(cb):
                acc = 0
                for t in range(ka):
                    acc ^= self.mul(int(a[i][t]), int(b[t][j]))
                out[i][j] = acc
        return out

    # ------------------------------------------------- matrix builders
    def vandermonde_coding_matrix(self, k: int, m: int) -> np.ndarray:
        """jerasure reed_sol_van for this w: W = V @ inv(V[:k]) bottom m
        rows, V[i][j] = i^j (ref: reed_sol_vandermonde_coding_matrix)."""
        v = [[self.pow(i, j) for j in range(k)] for i in range(k + m)]
        top_inv = self.invert_matrix(v[:k])
        assert top_inv is not None
        return np.array(self.matmul_small(v[k:], top_inv),
                        dtype=np.int64)

    def r6_coding_matrix(self, k: int) -> np.ndarray:
        """RAID-6 P (all ones) + Q (2^j) rows."""
        return np.array([[1] * k, [self.pow(2, j) for j in range(k)]],
                        dtype=np.int64)

    def cauchy_original_coding_matrix(self, k: int, m: int) -> np.ndarray:
        """row i col j = 1/(i ^ (m+j))
        (ref: cauchy_original_coding_matrix)."""
        return np.array([[self.inv(i ^ (m + j)) for j in range(k)]
                         for i in range(m)], dtype=np.int64)

    def bitmatrix_ones(self, e: int) -> int:
        """Ones in the w x w companion of multiply-by-e (cauchy_good's
        cost metric, ref: cauchy_n_ones)."""
        return sum(bin(self.mul(e, 1 << c)).count("1")
                   for c in range(self.w))

    def cauchy_good_coding_matrix(self, k: int, m: int) -> np.ndarray:
        """(ref: cauchy_good_general_coding_matrix)."""
        a = self.cauchy_original_coding_matrix(k, m)
        for j in range(k):
            d = self.inv(int(a[0, j]))
            for i in range(m):
                a[i, j] = self.mul(d, int(a[i, j]))
        for i in range(1, m):
            best_div, best_cost = 1, None
            for e in sorted({int(x) for x in a[i]}):
                d = self.inv(e)
                cost = sum(self.bitmatrix_ones(self.mul(d, int(x)))
                           for x in a[i])
                if best_cost is None or cost < best_cost:
                    best_cost, best_div = cost, d
            for j in range(k):
                a[i, j] = self.mul(best_div, int(a[i, j]))
        return a


@functools.lru_cache(maxsize=8)
def field(w: int) -> GF2w:
    return GF2w(w)
