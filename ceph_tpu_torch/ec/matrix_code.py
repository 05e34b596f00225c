"""Shared machinery for matrix-based (MDS) erasure codes.

Models what ISA-L/jerasure matrix codes do around the GF matmul
(ref: src/erasure-code/isa/ErasureCodeIsa.cc isa_encode/isa_decode,
src/erasure-code/jerasure/ErasureCodeJerasure.cc jerasure_encode/decode):

* encode: coding chunks = (m x k coding submatrix) x (k data chunks);
* decode: pick the first k surviving chunks in index order
  ("decode_index", ref: ErasureCodeIsa.cc:231-247), invert the k x k
  survivor submatrix, build decode rows for erased data chunks directly
  from the inverse and for erased coding chunks by re-projecting through
  the encode matrix (ref: ErasureCodeIsa.cc:281-294), then one matmul;
* decode tables are cached per erasure signature, mirroring the ISA-L
  table cache (ref: src/erasure-code/isa/ErasureCodeIsaTableCache.cc).

The byte matmul itself is pluggable (`matmul`), so the same orchestration
drives the numpy oracle and the port's CUDA kernels.  GF(2^8) by default;
jerasure's w=16/32 techniques set a wide-word field (gfw.GF2w).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Mapping

import numpy as np

from . import gf
from ..common.lockdep import make_lock
from ..common.racecheck import shared_state
from .interface import ErasureCode, ErasureCodeError


# the racecheck sanitizer checks that every access goes through self._lock
@shared_state(only=("_lru", "_cost"), mutating=("_lru", "_cost"))
class DecodeTableCache:
    """Cost-weighted LRU of decode tables keyed by erasure signature
    (ref: ErasureCodeIsaTableCache.cc, decoding_tables_lru_length).

    `cost` weights an entry against the capacity: a full-width
    (nerrs x n) matrix, or the device-resident kernel object built from
    one, is ~(k+m)/k x the footprint of the dense (nerrs x k) table, so
    full-matrix signatures charge more and the bound stays a memory
    bound, not an entry count.  One plugin instance serves many callers,
    and an LRU get() reorders the dict, so every access takes the lock."""

    def __init__(self, capacity: int = 2516):
        self.capacity = capacity
        self._lru: OrderedDict[str, tuple[object, int]] = OrderedDict()
        self._cost = 0
        self._lock = make_lock("ec.decode_table_cache")

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def total_cost(self) -> int:
        with self._lock:
            return self._cost

    def get(self, sig: str):
        with self._lock:
            entry = self._lru.get(sig)
            if entry is None:
                return None
            self._lru.move_to_end(sig)
            return entry[0]

    def put(self, sig: str, mat, cost: int = 1) -> None:
        with self._lock:
            old = self._lru.pop(sig, None)
            if old is not None:
                self._cost -= old[1]
            self._lru[sig] = (mat, cost)
            self._cost += cost
            while self._cost > self.capacity and len(self._lru) > 1:
                _, (_, c) = self._lru.popitem(last=False)
                self._cost -= c


def erasure_signature(decode_index: list[int], erasures: list[int]) -> str:
    """"+r..-e.." signature string (ref: ErasureCodeIsa.cc:231-247)."""
    return "".join(f"+{r}" for r in decode_index) + \
           "".join(f"-{e}" for e in erasures)


def make_decode_matrix(encode_matrix: np.ndarray, k: int,
                       decode_index: list[int], erasures: list[int]
                       ) -> np.ndarray:
    """(nerrs x k) decode matrix applied to the k survivor chunks.

    encode_matrix is the full (k+m) x k matrix (identity top).  Mirrors the
    ISA-L construction: invert the survivor submatrix b; for an erased data
    chunk e the decode row is inv_b[e]; for an erased coding chunk c the row
    is encode_row(c) @ inv_b (ref: ErasureCodeIsa.cc:252-294).
    """
    b = encode_matrix[decode_index, :]  # (k x k) survivor rows
    inv_b = gf.gf_invert_matrix(b)
    if inv_b is None:
        raise ErasureCodeError("EIO: singular survivor matrix")
    rows = []
    for e in erasures:
        if e < k:
            rows.append(inv_b[e])
        else:
            rows.append(gf.gf_matmul(encode_matrix[e][None, :], inv_b)[0])
    return np.stack(rows).astype(np.uint8)


def make_decode_matrix_full(encode_matrix: np.ndarray, k: int, n: int,
                            decode_index: list[int],
                            erasures: list[int]) -> np.ndarray:
    """(nerrs x n) decode matrix over ALL n=k+m chunk slots.

    Columns outside `decode_index` are zero, so the product consumes the
    full chunk array in place: erased/unused slots contribute nothing
    whatever they hold, and the survivor gather disappears (the
    selection IS the matrix; the kernel reads the nonzero columns'
    rows straight from the arrival block)."""
    dmat = make_decode_matrix(encode_matrix, k, decode_index, erasures)
    full = np.zeros((len(erasures), n), dtype=np.uint8)
    full[:, decode_index] = dmat
    return full


class MatrixErasureCode(ErasureCode):
    """Systematic MDS matrix code with pluggable matmul.

    Default field is GF(2^8) (the byte fast path in gf.py); setting
    `self.field` to a gfw.GF2w switches the matmul and decode-matrix
    construction to that wide-word field (jerasure's w=16/32 matrix
    techniques)."""

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.k = 0
        self.m = 0
        self.encode_matrix: np.ndarray | None = None  # (k+m) x k, identity top
        self.field = None                             # None = GF(2^8)
        self.table_cache = DecodeTableCache()

    # subclasses set self.k/self.m and call _prepare with the full matrix
    def _prepare(self, encode_matrix: np.ndarray) -> None:
        assert encode_matrix.shape == (self.k + self.m, self.k)
        dtype = np.uint8 if self.field is None else np.int64
        self.encode_matrix = np.ascontiguousarray(encode_matrix,
                                                  dtype=dtype)

    # the matmul backend; the tpu plugin overrides it with the kernels
    def matmul(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        if self.field is not None:
            return self.field.matmul_bytes(mat, data)
        return gf.gf_matmul_bytes(mat, data)

    def _make_decode_matrix(self, decode_index: list[int],
                            erasures: list[int]) -> np.ndarray:
        if self.field is None:
            return make_decode_matrix(self.encode_matrix, self.k,
                                      decode_index, erasures)
        f = self.field
        b = [list(self.encode_matrix[i]) for i in decode_index]
        inv_b = f.invert_matrix(b)
        if inv_b is None:
            raise ErasureCodeError("EIO: singular survivor matrix")
        rows = []
        for e in erasures:
            if e < self.k:
                rows.append(inv_b[e])
            else:
                rows.append(f.matmul_small(
                    [list(self.encode_matrix[e])], inv_b)[0])
        return np.array(rows, dtype=np.int64)

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def repair_schedule(self, erasures: set, available: set):
        """MDS fallback plan: k full survivor chunks (the same
        first-k-in-index-order selection as decode_chunks, so the
        compiled matrix IS the cached decode matrix) rebuilding every
        lost shard directly, with no decode-to-logical + re-encode round
        trip.  Wide-word fields (gfw w=16/32) are not byte-linear, so
        they stay on the interpreted path."""
        if self.field is not None:
            return None
        erasures = set(erasures)
        avail = sorted(set(available) - erasures)
        if not erasures or len(erasures) > self.m or len(avail) < self.k:
            return None
        from .repairc import RepairPlan
        return RepairPlan.make(
            erasures, {h: [(0, 1)] for h in avail[:self.k]},
            sub_chunk_no=1)

    # -- math --------------------------------------------------------------
    def encode_chunks(self, want_to_encode: Iterable[int],
                      encoded: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        data = np.stack([encoded[self.chunk_index(i)] for i in range(k)])
        coding = self.matmul(self.encode_matrix[k:], data)
        for i in range(m):
            encoded[self.chunk_index(k + i)][...] = coding[i]

    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        avail = set(chunks)
        erasures = [i for i in range(k + m) if i not in avail]
        if len(erasures) > m:
            raise ErasureCodeError("EIO: too many erasures")
        # first k surviving chunks in index order (ErasureCodeIsa.cc:231)
        decode_index = [i for i in range(k + m) if i in avail][:k]
        if len(decode_index) < k:
            raise ErasureCodeError("EIO: fewer than k chunks available")
        sig = erasure_signature(decode_index, erasures)
        dmat = self.table_cache.get(sig)
        if dmat is None:
            dmat = self._make_decode_matrix(decode_index, erasures)
            self.table_cache.put(sig, dmat)
        survivors = np.stack([decoded[i] for i in decode_index])
        out = self.matmul(dmat, survivors)
        for row, e in enumerate(erasures):
            decoded[e][...] = out[row]
