"""jerasure-compatible plugin of the port (host numpy math).

Matches the technique set and chunk-size semantics of the jerasure plugin
(ref: src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}):

* techniques: reed_sol_van (Vandermonde systematized), reed_sol_r6_op
  (RAID-6 P+Q), cauchy_orig, cauchy_good (improved Cauchy), and the
  GF(2) bitmatrix family liberation / blaum_roth / liber8tion
  (ec/bitmatrix.py: published constructions, build-time MDS
  verification, fixture-pinned layouts);
* matrix codes at w=8 (the Ceph default, byte fast path) and w=16/32
  (wide-word fields over gf-complete's standard polynomials, via
  ec/gfw.py);
* chunk size: object padded to a multiple of k*w*sizeof(int) (w*16-aligned
  per-chunk when jerasure-per-chunk-alignment=true); cauchy variants align
  to k*w*packetsize*sizeof(int) with packetsize default 2048
  (ref: ErasureCodeJerasure.cc:80-102 get_chunk_size, :174-184,:300 get_alignment).

jerasure's bitmatrix/schedule encode (cauchy) computes the same GF(2^8)
linear map as the plain matrix product, so chunk bytes here are identical
to the reference for all four techniques.

The port's copy of `ceph_tpu.ec.plugins.jerasure`.  Encode and decode
stay host numpy; compiled repair (w=8 matrix techniques) runs on the
plugin's device through K1.
"""
from __future__ import annotations

import numpy as np

from .. import gf
from ..interface import ErasureCodeProfile, ErasureCodeError, to_int, to_bool, \
    sanity_check_k_m
from ..matrix_code import MatrixErasureCode
from ..registry import ErasureCodePlugin

LARGEST_VECTOR_WORDSIZE = 16  # ref: ErasureCodeJerasure.cc:30
SIZEOF_INT = 4


class ErasureCodeJerasure(MatrixErasureCode):
    DEFAULT_K = "2"
    DEFAULT_M = "1"
    DEFAULT_W = "8"
    technique = "reed_sol_van"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.w = 8
        self.per_chunk_alignment = False

    def init(self, profile: ErasureCodeProfile) -> None:
        profile.setdefault("plugin", "jerasure")
        profile.setdefault("technique", self.technique)
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, self.DEFAULT_M)
        self.w = to_int("w", profile, self.DEFAULT_W)
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            self.chunk_mapping = []
            raise ErasureCodeError("bad mapping size")
        sanity_check_k_m(self.k, self.m)
        if self.w not in (8, 16, 32):
            raise ErasureCodeError(
                f"w={self.w} not supported (matrix codes take 8/16/32)")
        self.per_chunk_alignment = to_bool(
            "jerasure-per-chunk-alignment", profile, "false")

    def _field(self):
        """GF(2^w) field for wide w; None selects the byte fast path."""
        if self.w == 8:
            return None
        from .. import gfw
        return gfw.field(self.w)

    def _prepare_coding(self, byte_builder, wide_builder) -> None:
        """Shared field dispatch for every matrix technique: pick the
        byte-path or wide-field coding-matrix builder and prepend the
        identity."""
        self.field = self._field()
        coding = byte_builder() if self.field is None \
            else wide_builder(self.field)
        self._prepare(np.vstack([np.eye(self.k, dtype=coding.dtype),
                                 coding]))

    def get_alignment(self) -> int:
        # ref: ErasureCodeJerasure.cc:174-184
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * SIZEOF_INT
        if (self.w * SIZEOF_INT) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def get_chunk_size(self, object_size: int) -> int:
        # ref: ErasureCodeJerasure.cc:80-102
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = (object_size + self.k - 1) // self.k
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    def prepare(self) -> None:
        raise NotImplementedError


class ReedSolomonVandermonde(ErasureCodeJerasure):
    technique = "reed_sol_van"

    def prepare(self) -> None:
        self._prepare_coding(
            lambda: gf.jerasure_vandermonde_coding_matrix(self.k, self.m),
            lambda f: f.vandermonde_coding_matrix(self.k, self.m))


class ReedSolomonRAID6(ErasureCodeJerasure):
    technique = "reed_sol_r6_op"

    def parse(self, profile: ErasureCodeProfile) -> None:
        profile.pop("m", None)
        super().parse(profile)
        self.m = 2

    def prepare(self) -> None:
        self._prepare_coding(
            lambda: gf.jerasure_r6_coding_matrix(self.k),
            lambda f: f.r6_coding_matrix(self.k))


class Cauchy(ErasureCodeJerasure):
    DEFAULT_K = "7"
    DEFAULT_M = "3"
    DEFAULT_PACKETSIZE = "2048"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.packetsize = 2048

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.packetsize = to_int("packetsize", profile, self.DEFAULT_PACKETSIZE)

    def get_alignment(self) -> int:
        # ref: ErasureCodeJerasure.cc:280-293
        if self.per_chunk_alignment:
            alignment = self.w * self.packetsize
            modulo = alignment % LARGEST_VECTOR_WORDSIZE
            if modulo:
                alignment += LARGEST_VECTOR_WORDSIZE - modulo
            return alignment
        alignment = self.k * self.w * self.packetsize * SIZEOF_INT
        if (self.w * self.packetsize * SIZEOF_INT) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
        return alignment


class CauchyOrig(Cauchy):
    technique = "cauchy_orig"

    def prepare(self) -> None:
        self._prepare_coding(
            lambda: gf.cauchy_original_coding_matrix(self.k, self.m),
            lambda f: f.cauchy_original_coding_matrix(self.k, self.m))


class CauchyGood(Cauchy):
    technique = "cauchy_good"

    def prepare(self) -> None:
        self._prepare_coding(
            lambda: gf.cauchy_good_coding_matrix(self.k, self.m),
            lambda f: f.cauchy_good_coding_matrix(self.k, self.m))


class Bitmatrix(ErasureCodeJerasure):
    """Base for the GF(2) bitmatrix RAID-6 techniques
    (ref: ErasureCodeJerasure.h:152-252 Liberation/BlaumRoth/
    Liber8tion; schedule encode ErasureCodeJerasure.cc:266).

    Chunks are w packets; coding applies a (2w x kw) 0/1 matrix by
    XOR (the schedule form) — see ec/bitmatrix.py for the
    constructions, the MDS verification, and the K1 device form.
    Matrices follow the published structure; jerasure bit-parity is
    NOT claimed (sources not vendored) — layouts are pinned by the
    committed fixtures instead (tests/test_ec_bitmatrix.py).
    """
    DEFAULT_K = "2"
    DEFAULT_W = "7"
    DEFAULT_PACKETSIZE = "2048"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.packetsize = 2048
        self.generator = None       # ((k+2)w x kw) over GF(2)

    def parse(self, profile: ErasureCodeProfile) -> None:
        profile.pop("m", None)
        # bypass the matrix-code w in (8,16,32) restriction
        MatrixErasureCode.parse(self, profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = 2
        self.w = to_int("w", profile, self.DEFAULT_W)
        sanity_check_k_m(self.k, self.m)
        self.packetsize = to_int("packetsize", profile,
                                 self.DEFAULT_PACKETSIZE)
        self.per_chunk_alignment = to_bool(
            "jerasure-per-chunk-alignment", profile, "false")
        self._check_w()

    def _check_w(self) -> None:
        raise NotImplementedError

    def _build_generator(self):
        raise NotImplementedError

    def prepare(self) -> None:
        self.generator = self._build_generator()
        # encode-time XOR schedule (ref: jerasure_schedule_encode)
        from ..bitmatrix import bitmatrix_schedule
        self.schedule = bitmatrix_schedule(
            self.generator[self.k * self.w:])

    def get_alignment(self) -> int:
        # packets of w rows (ref: Liberation::get_alignment shape)
        if self.per_chunk_alignment:
            alignment = self.w * self.packetsize
            modulo = alignment % LARGEST_VECTOR_WORDSIZE
            if modulo:
                alignment += LARGEST_VECTOR_WORDSIZE - modulo
            return alignment
        return self.k * self.w * self.packetsize

    # -- coding --------------------------------------------------------
    def _packets(self, chunks: dict, idxs, plen: int) -> np.ndarray:
        rows = np.empty((len(idxs) * self.w, plen), dtype=np.uint8)
        for n, i in enumerate(idxs):
            rows[n * self.w:(n + 1) * self.w] = np.asarray(
                chunks[i], dtype=np.uint8).reshape(self.w, plen)
        return rows

    def encode_chunks(self, want_to_encode, encoded: dict) -> None:
        from ..bitmatrix import bitmatrix_apply
        k, w = self.k, self.w
        plen = len(encoded[0]) // w
        data = self._packets(encoded, range(k), plen)
        coding = bitmatrix_apply(self.generator[k * w:], data)
        for j in range(2):
            encoded[k + j][:] = coding[j * w:(j + 1) * w].reshape(-1)

    def decode_chunks(self, want_to_read, chunks: dict,
                      decoded: dict) -> None:
        from ..bitmatrix import bitmatrix_apply, gf2_inv, gf2_matmul
        k, w = self.k, self.w
        avail = sorted(chunks)
        if len(avail) < k:
            raise ErasureCodeError(
                f"EIO: need {k} chunks to decode, have {len(avail)}")
        survivors = avail[:k]
        erased = sorted(set(want_to_read) - set(chunks))
        if not erased:
            return
        plen = len(next(iter(chunks.values()))) // w
        sub = np.vstack([
            self.generator[c * w:(c + 1) * w] for c in survivors])
        inv = gf2_inv(sub)
        if inv is None:
            raise ErasureCodeError("EIO: singular survivor bitmatrix")
        rows = np.vstack([
            self.generator[e * w:(e + 1) * w] for e in erased])
        dec = gf2_matmul(rows, inv)
        out = bitmatrix_apply(dec, self._packets(chunks, survivors,
                                                 plen))
        for n, e in enumerate(erased):
            decoded[e][:] = out[n * w:(n + 1) * w].reshape(-1)


class Liberation(Bitmatrix):
    technique = "liberation"

    def _check_w(self) -> None:
        if self.w < 2 or any(self.w % d == 0 for d in range(2, self.w)):
            raise ErasureCodeError(f"liberation requires prime w "
                                   f"(w={self.w})")
        if self.k > self.w:
            raise ErasureCodeError("liberation requires k <= w")

    def _build_generator(self):
        from ..bitmatrix import liberation_bitmatrix
        return liberation_bitmatrix(self.k, self.w)


class BlaumRoth(Bitmatrix):
    technique = "blaum_roth"

    def _check_w(self) -> None:
        p = self.w + 1
        if p < 3 or any(p % d == 0 for d in range(2, p)):
            raise ErasureCodeError(f"blaum_roth requires w+1 prime "
                                   f"(w={self.w})")
        if self.k > self.w:
            raise ErasureCodeError("blaum_roth requires k <= w")

    def _build_generator(self):
        from ..bitmatrix import blaum_roth_bitmatrix
        return blaum_roth_bitmatrix(self.k, self.w)


class Liber8tion(Bitmatrix):
    technique = "liber8tion"
    DEFAULT_W = "8"

    def parse(self, profile: ErasureCodeProfile) -> None:
        profile.pop("w", None)
        super().parse(profile)

    def _check_w(self) -> None:
        self.w = 8
        if self.k > 8:
            raise ErasureCodeError("liber8tion requires k <= 8")

    def _build_generator(self):
        from ..bitmatrix import liber8tion_bitmatrix
        return liber8tion_bitmatrix(self.k)


TECHNIQUES = {
    "reed_sol_van": ReedSolomonVandermonde,
    "reed_sol_r6_op": ReedSolomonRAID6,
    "cauchy_orig": CauchyOrig,
    "cauchy_good": CauchyGood,
    "liberation": Liberation,
    "blaum_roth": BlaumRoth,
    "liber8tion": Liber8tion,
}


class _JerasureFactory:
    """Dispatch on profile['technique'] like ErasureCodePluginJerasure::factory
    (ref: src/erasure-code/jerasure/ErasureCodePluginJerasure.cc)."""

    def __call__(self, device=None) -> ErasureCodeJerasure:
        return _TechniqueDispatch(device)


class _TechniqueDispatch(ErasureCodeJerasure):
    """Thin shim: picks the concrete technique class at init() time."""

    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.setdefault("technique", "reed_sol_van")
        impl_cls = TECHNIQUES.get(technique)
        if impl_cls is None:
            raise ErasureCodeError(
                f"ENOENT: technique={technique!r} is not supported")
        self.__class__ = impl_cls
        impl_cls.__init__(self, self.device)
        impl_cls.init(self, profile)


PLUGIN = ErasureCodePlugin("jerasure", _JerasureFactory())
