"""isa-compatible plugin of the port (host numpy math).

Mirrors the ISA-L plugin semantics (ref: src/erasure-code/isa/ErasureCodeIsa.cc):

* technique reed_sol_van -> gf_gen_rs_matrix (identity + gen^j rows,
  ref: :385), technique cauchy -> gf_gen_cauchy1_matrix (1/(i^j), ref: :387);
* chunk size = ceil(object_size/k) rounded up to 32 bytes
  (EC_ISA_ADDRESS_ALIGNMENT, ref: :66-79, xor_op.h:28);
* m=1 encode/decode is a pure XOR (region_xor, ref: :126,:196);
* single-erasure decode of a data chunk or the first coding chunk under
  Vandermonde is a pure XOR of the k survivors (ref: :204-216);
* Vandermonde k/m are clamped to known-MDS ranges (ref: :330-360 parse);
* decode tables cached per erasure signature (MatrixErasureCode handles it,
  mirroring ErasureCodeIsaTableCache).

The port's copy of `ceph_tpu.ec.plugins.isa`; compiled repair runs on
the plugin's device through K1.
"""
from __future__ import annotations

import numpy as np

from .. import gf
from ..interface import ErasureCodeProfile, ErasureCodeError, to_int, \
    sanity_check_k_m
from ..matrix_code import MatrixErasureCode
from ..registry import ErasureCodePlugin

EC_ISA_ADDRESS_ALIGNMENT = 32  # ref: src/erasure-code/isa/xor_op.h:28


class ErasureCodeIsa(MatrixErasureCode):
    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.technique = "reed_sol_van"

    def init(self, profile: ErasureCodeProfile) -> None:
        profile.setdefault("plugin", "isa")
        self.technique = profile.setdefault("technique", "reed_sol_van")
        if self.technique not in ("reed_sol_van", "cauchy"):
            raise ErasureCodeError(
                f"ENOENT: isa technique={self.technique!r} not supported")
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, self.DEFAULT_M)
        sanity_check_k_m(self.k, self.m)
        if self.technique == "reed_sol_van":
            # verified-MDS clamps (ref: ErasureCodeIsa.cc:330-360)
            if self.k > 32:
                self.k = 32
            if self.m > 4:
                self.m = 4
            if self.m == 4 and self.k > 21:
                self.k = 21

    def get_chunk_size(self, object_size: int) -> int:
        # ref: ErasureCodeIsa.cc:66-79
        chunk_size = (object_size + self.k - 1) // self.k
        modulo = chunk_size % EC_ISA_ADDRESS_ALIGNMENT
        if modulo:
            chunk_size += EC_ISA_ADDRESS_ALIGNMENT - modulo
        return chunk_size

    def prepare(self) -> None:
        if self.technique == "cauchy":
            full = gf.isa_cauchy_matrix(self.k, self.m)
        else:
            full = gf.isa_rs_matrix(self.k, self.m)
        self._prepare(full)

    # -- fast paths (byte-identical to the generic matmul, but cheaper) ----
    def encode_chunks(self, want_to_encode, encoded) -> None:
        if self.m == 1:
            data = np.stack([encoded[self.chunk_index(i)] for i in range(self.k)])
            encoded[self.chunk_index(self.k)][...] = \
                np.bitwise_xor.reduce(data, axis=0)
            return
        super().encode_chunks(want_to_encode, encoded)

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        k, m = self.k, self.m
        erasures = [i for i in range(k + m) if i not in chunks]
        xor_ok = (m == 1) or (
            self.technique == "reed_sol_van"
            and len(erasures) == 1 and erasures[0] < k + 1)
        if xor_ok and len(erasures) == 1:
            # survivors = first k available in index order (ref: :173-192)
            decode_index = [i for i in range(k + m) if i in chunks][:k]
            if len(decode_index) == k:
                survivors = np.stack([decoded[i] for i in decode_index])
                decoded[erasures[0]][...] = np.bitwise_xor.reduce(survivors, axis=0)
                return
        super().decode_chunks(want_to_read, chunks, decoded)


PLUGIN = ErasureCodePlugin("isa", ErasureCodeIsa)
