"""shec plugin: shingled erasure code (k, m, c).

Faithful re-implementation of the reference shec plugin
(ref: src/erasure-code/shec/ErasureCodeShec.{h,cc}): a Vandermonde
Reed-Solomon matrix with shingle-shaped zero runs so that a single lost
chunk can be repaired from fewer than k reads (trading extra parity for
recovery bandwidth).  The coding matrix, the (m1,c1,m2,c2) split search
for technique=multiple (shec_reedsolomon_coding_matrix,
ErasureCodeShec.cc:462-530), and the 2^m parity-subset decoding-matrix
search (shec_make_decoding_matrix, :531-737) follow the reference
exactly, so chunk bytes and minimum_to_decode sets match.

The port's copy of `ceph_tpu.ec.plugins.shec` (host numpy math).
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from .. import gf
from ..interface import (ErasureCode, ErasureCodeError, ErasureCodeProfile,
                         to_int)
from ..registry import ErasureCodePlugin

MULTIPLE = 0
SINGLE = 1

SIZEOF_INT = 4


def gf_determinant(mat: np.ndarray) -> int:
    """Determinant over GF(2^8) by Gauss elimination (replicates
    shec determinant.c calc_determinant; 0 means singular)."""
    m = np.array(mat, dtype=np.uint8, copy=True)
    n = m.shape[0]
    MUL = gf.mul_table()
    INV = gf.inv_table()
    det = 1
    for i in range(n):
        if m[i, i] == 0:
            rows = np.nonzero(m[i + 1:, i])[0]
            if rows.size == 0:
                return 0
            j = i + 1 + rows[0]
            m[[i, j]] = m[[j, i]]
            # row swap changes sign; in GF(2^x) -1 == 1, so no-op
        det = int(MUL[det, m[i, i]])
        piv = INV[m[i, i]]
        m[i] = MUL[piv, m[i]]
        factors = m[i + 1:, i]
        m[i + 1:] ^= MUL[factors[:, None], m[i][None, :]]
    return det


class ErasureCodeShec(ErasureCode):
    DEFAULT_K = 4
    DEFAULT_M = 3
    DEFAULT_C = 2
    DEFAULT_W = 8

    def __init__(self, technique: int = MULTIPLE, device=None) -> None:
        super().__init__(device)
        self.technique = technique
        self.k = self.DEFAULT_K
        self.m = self.DEFAULT_M
        self.c = self.DEFAULT_C
        self.w = self.DEFAULT_W
        self.matrix: np.ndarray | None = None  # (m, k) uint8

    # -- interface ----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        # ref: ErasureCodeShec.cc:271-274
        return self.k * self.w * SIZEOF_INT

    def get_chunk_size(self, object_size: int) -> int:
        # ref: ErasureCodeShec.cc:61-69
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # -- init ---------------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        """ref: ErasureCodeShec.cc:276-375."""
        super().parse(profile)
        has = [name in profile and profile[name] != ""
               for name in ("k", "m", "c")]
        if not any(has):
            self.k, self.m, self.c = \
                self.DEFAULT_K, self.DEFAULT_M, self.DEFAULT_C
        elif not all(has):
            raise ErasureCodeError("(k, m, c) must be chosen")
        else:
            self.k = to_int("k", profile, str(self.DEFAULT_K))
            self.m = to_int("m", profile, str(self.DEFAULT_M))
            self.c = to_int("c", profile, str(self.DEFAULT_C))
        k, m, c = self.k, self.m, self.c
        if k <= 0 or m <= 0 or c <= 0:
            raise ErasureCodeError(f"(k,m,c)=({k},{m},{c}) must be positive")
        if m < c:
            raise ErasureCodeError(f"c={c} must be <= m={m}")
        if k > 12:
            raise ErasureCodeError(f"k={k} must be <= 12")
        if k + m > 20:
            raise ErasureCodeError(f"k+m={k + m} must be <= 20")
        if k < m:
            raise ErasureCodeError(f"m={m} must be <= k={k}")
        w = profile.get("w")
        self.w = self.DEFAULT_W
        if w not in (None, ""):
            try:
                wi = int(w)
            except ValueError:
                wi = self.DEFAULT_W
            if wi in (8, 16, 32):
                self.w = wi
        if self.w != 8:
            raise ErasureCodeError(
                f"w={self.w} not supported (byte field w=8 only)")

    # -- matrix construction ------------------------------------------------
    def shec_calc_recovery_efficiency1(self, k, m1, m2, c1, c2) -> float:
        """ref: ErasureCodeShec.cc:420-460."""
        if m1 < c1 or m2 < c2:
            return -1
        if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
            return -1
        r_eff_k = [10 ** 8] * k
        r_e1 = 0.0
        for rr in range(m1):
            start = ((rr * k) // m1) % k
            end = (((rr + c1) * k) // m1) % k
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc],
                                  ((rr + c1) * k) // m1 - (rr * k) // m1)
                cc = (cc + 1) % k
            r_e1 += ((rr + c1) * k) // m1 - (rr * k) // m1
        for rr in range(m2):
            start = ((rr * k) // m2) % k
            end = (((rr + c2) * k) // m2) % k
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc],
                                  ((rr + c2) * k) // m2 - (rr * k) // m2)
                cc = (cc + 1) % k
            r_e1 += ((rr + c2) * k) // m2 - (rr * k) // m2
        r_e1 += sum(r_eff_k)
        return r_e1 / (k + m1 + m2)

    def shec_reedsolomon_coding_matrix(self, is_single: int) -> np.ndarray:
        """ref: ErasureCodeShec.cc:462-530."""
        k, m, c = self.k, self.m, self.c
        if not is_single:
            c1_best, m1_best = -1, -1
            min_r_e1 = 100.0
            for c1 in range(c // 2 + 1):
                for m1 in range(m + 1):
                    c2 = c - c1
                    m2 = m - m1
                    if m1 < c1 or m2 < c2:
                        continue
                    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                        continue
                    if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                        continue
                    r_e1 = self.shec_calc_recovery_efficiency1(
                        k, m1, m2, c1, c2)
                    if min_r_e1 - r_e1 > np.finfo(float).eps and \
                            r_e1 < min_r_e1:
                        min_r_e1 = r_e1
                        c1_best, m1_best = c1, m1
            m1, c1 = m1_best, c1_best
            m2, c2 = m - m1_best, c - c1_best
        else:
            m1, c1 = 0, 0
            m2, c2 = m, c
        matrix = gf.jerasure_vandermonde_coding_matrix(k, m).astype(np.uint8)
        for rr in range(m1):
            end = ((rr * k) // m1) % k
            start = (((rr + c1) * k) // m1) % k
            cc = start
            while cc != end:
                matrix[rr, cc] = 0
                cc = (cc + 1) % k
        for rr in range(m2):
            end = ((rr * k) // m2) % k
            start = (((rr + c2) * k) // m2) % k
            cc = start
            while cc != end:
                matrix[rr + m1, cc] = 0
                cc = (cc + 1) % k
        return matrix

    def prepare(self) -> None:
        self.matrix = self.shec_reedsolomon_coding_matrix(
            1 if self.technique == SINGLE else 0)

    # -- decoding-matrix search ---------------------------------------------
    def shec_make_decoding_matrix(self, prepare: bool, want_in, avails):
        """2^m parity-subset search (ref: ErasureCodeShec.cc:531-737).
        Returns (decoding_matrix|None, dm_row, dm_column, minimum) with
        dm_row/dm_column holding ORIGINAL chunk/column ids."""
        k, m = self.k, self.m
        mat = self.matrix
        want = list(want_in)
        for i in range(m):
            if want[i + k] and not avails[i + k]:
                for j in range(k):
                    if mat[i, j] > 0:
                        want[j] = 1
        mindup = k + 1
        minp = k + 1
        dm_row: list[int] = [-1] * k
        dm_column: list[int] = [-1] * k
        for pp in range(1 << m):
            p = [i for i in range(m) if pp & (1 << i)]
            ek = len(p)
            if ek > minp:
                continue
            if any(not avails[k + pi] for pi in p):
                continue
            tmprow = [0] * (k + m)
            tmpcolumn = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcolumn[i] = 1
            for pi in p:
                tmprow[k + pi] = 1
                for j in range(k):
                    element = int(mat[pi, j])
                    if element != 0:
                        tmpcolumn[j] = 1
                    if element != 0 and avails[j] == 1:
                        tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_column = sum(tmpcolumn)
            if dup_row != dup_column:
                continue
            dup = dup_row
            if dup == 0:
                mindup = dup
                dm_row = [-1] * k
                dm_column = [-1] * k
                break
            if dup < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcolumn[j]]
                tmpmat = np.zeros((dup, dup), dtype=np.uint8)
                for ri, i in enumerate(rows):
                    for ci, j in enumerate(cols):
                        if i < k:
                            tmpmat[ri, ci] = 1 if i == j else 0
                        else:
                            tmpmat[ri, ci] = mat[i - k, j]
                if gf_determinant(tmpmat) != 0:
                    mindup = dup
                    dm_row = rows + [-1] * (k - len(rows))
                    dm_column = cols + [-1] * (k - len(cols))
                    minp = ek
        if mindup == k + 1:
            raise ErasureCodeError(
                "EIO: shec_make_decoding_matrix(): can't find recover "
                "matrix")
        minimum = [0] * (k + m)
        for r in dm_row:
            if r == -1:
                break
            minimum[r] = 1
        for i in range(k):
            if want[i] and avails[i]:
                minimum[i] = 1
        for i in range(m):
            if want[k + i] and avails[k + i] and not minimum[k + i]:
                for j in range(k):
                    if mat[i, j] > 0 and not want[j]:
                        minimum[k + i] = 1
                        break
        if mindup == 0:
            return None, dm_row, dm_column, minimum
        rows = [r for r in dm_row if r != -1]
        cols = [cc for cc in dm_column if cc != -1]
        tmpmat = np.zeros((mindup, mindup), dtype=np.uint8)
        for ri, i in enumerate(rows):
            for ci, j in enumerate(cols):
                if i < k:
                    tmpmat[ri, ci] = 1 if i == j else 0
                else:
                    tmpmat[ri, ci] = mat[i - k, j]
        if prepare:
            return None, dm_row, dm_column, minimum
        inv = gf.gf_invert_matrix(tmpmat)
        if inv is None:
            raise ErasureCodeError("EIO: singular shec decoding matrix")
        return inv, dm_row, dm_column, minimum

    # -- minimum_to_decode --------------------------------------------------
    def _minimum_to_decode(self, want_to_read: set, available: set) -> set:
        """ref: ErasureCodeShec.cc:71-123."""
        k, m = self.k, self.m
        for i in want_to_read | available:
            if i < 0 or i >= k + m:
                raise ErasureCodeError(f"EINVAL: chunk id {i}")
        want = [1 if i in want_to_read else 0 for i in range(k + m)]
        avails = [1 if i in available else 0 for i in range(k + m)]
        _, _, _, minimum = self.shec_make_decoding_matrix(
            True, want, avails)
        return {i for i in range(k + m) if minimum[i] == 1}

    # -- encode / decode ----------------------------------------------------
    def encode_chunks(self, want_to_encode: Iterable[int],
                      encoded: dict[int, np.ndarray]) -> None:
        """jerasure_matrix_encode == coding = matrix @ data
        (ref: ErasureCodeShec.cc:255-260)."""
        k, m = self.k, self.m
        data = np.stack([encoded[i] for i in range(k)])
        coding = gf.gf_matmul_bytes(self.matrix, data)
        for i in range(m):
            encoded[k + i][...] = coding[i]

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        """ref: ErasureCodeShec.cc:216-253 + shec_matrix_decode
        (:761-811)."""
        k, m = self.k, self.m
        want = set(want_to_read)
        erased = [0] * (k + m)
        avails = [0] * (k + m)
        erased_count = 0
        for i in range(k + m):
            if i in chunks:
                avails[i] = 1
            elif i in want:
                erased[i] = 1
                erased_count += 1
        if erased_count == 0:
            return
        dmat, dm_row, dm_column, _ = self.shec_make_decoding_matrix(
            False, erased, avails)
        if dmat is not None:
            rows = [r for r in dm_row if r != -1]
            cols = [cc for cc in dm_column if cc != -1]
            srcs = np.stack([decoded[r] for r in rows])
            for i, col in enumerate(cols):
                if not avails[col]:
                    decoded[col][...] = gf.gf_matmul_bytes(
                        dmat[i][None, :], srcs)[0]
        # re-encode erased coding chunks from (recovered) data
        # (ref: ErasureCodeShec.cc:803-809)
        need_coding = [i for i in range(m)
                       if erased[k + i] and not avails[k + i]]
        if need_coding:
            data = np.stack([decoded[i] for i in range(k)])
            for i in need_coding:
                decoded[k + i][...] = gf.gf_matmul_bytes(
                    self.matrix[i][None, :], data)[0]


class ErasureCodeShecReedSolomonVandermonde(ErasureCodeShec):
    pass


class _ShecFactory:
    """technique=single|multiple dispatch
    (ref: src/erasure-code/shec/ErasureCodePluginShec.cc:45-56)."""

    def __call__(self, device=None) -> ErasureCodeShec:
        return _ShecDispatch(device=device)


class _ShecDispatch(ErasureCodeShec):
    def init(self, profile: ErasureCodeProfile) -> None:
        t = profile.setdefault("technique", "multiple")
        if t == "single":
            self.technique = SINGLE
        elif t == "multiple":
            self.technique = MULTIPLE
        else:
            raise ErasureCodeError(
                f"technique={t} is not a valid coding technique. "
                "Choose one of the following: single, multiple")
        super().init(profile)


PLUGIN = ErasureCodePlugin("shec", _ShecFactory())
