"""The `tpu` erasure-code plugin of the port.

A GF(2^8) Reed-Solomon/Cauchy code behind the exact ErasureCodeInterface
boundary (ref: src/erasure-code/ErasureCodeInterface.h), with the product
running in the port's CUDA kernels (ceph_tpu_torch.ec.kernels.bitmatmul).
Matrices, chunk sizes and padding follow the isa/jerasure plugins so
chunks are byte-identical to the CPU reference.  The name stays `tpu` so
that `plugin=tpu` profiles carry over unchanged.

Techniques (profile `technique=`):
  reed_sol_van  - ISA-L gf_gen_rs_matrix (default; parity with isa plugin)
  cauchy        - ISA-L gf_gen_cauchy1_matrix
  jerasure_reed_sol_van, reed_sol_r6_op, cauchy_orig, cauchy_good
                - jerasure-compatible matrices (parity with jerasure plugin)

Beyond the interface, the plugin exposes a batched device-resident path
(`encode_batch`/`decode_batch`/`decode_batch_full`) that takes numpy or
torch input and returns tensors on the plugin's device: many stripes per
launch, so the host<->device boundary stays off the hot path.  Each stages
its input first and launches inside a region of the device guard
(common/devguard.py).  `encode_batch` and `decode_batch_full` are each a
root span of the device-path span log (common/tracing.py) over child
spans for the decode-table lookup (`ec.decode_table`, argument 1 on a
miss), the staging (`ec.stage`) and the launch (`ec.launch`, in the
operator); the staged `decode_batch`'s launch is a root of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import device as _device
from ...common import devguard
from ...common.tracing import SPANS, span_name
from .. import gf
from ..interface import ErasureCodeProfile, ErasureCodeError, to_int, \
    sanity_check_k_m
from ..kernels.bitmatmul import GFDecodeFull, GFMatmul
from ..matrix_code import DecodeTableCache, MatrixErasureCode, \
    erasure_signature, make_decode_matrix, make_decode_matrix_full
from ..registry import ErasureCodePlugin

EC_TPU_DEFAULT_ALIGNMENT = 32  # match isa (EC_ISA_ADDRESS_ALIGNMENT)

_SPAN_ENCODE = span_name("ec.encode_batch")
_SPAN_DECODE_FULL = span_name("ec.decode_batch_full")
_SPAN_TABLE = span_name("ec.decode_table")
_SPAN_STAGE = span_name("ec.stage")


def _matrices(technique: str, k: int, m: int) -> np.ndarray:
    eye = np.eye(k, dtype=np.uint8)
    if technique == "reed_sol_van":
        return gf.isa_rs_matrix(k, m)
    if technique == "cauchy":
        return gf.isa_cauchy_matrix(k, m)
    if technique == "jerasure_reed_sol_van":
        return np.vstack([eye, gf.jerasure_vandermonde_coding_matrix(k, m)])
    if technique == "reed_sol_r6_op":
        if m != 2:
            raise ErasureCodeError("reed_sol_r6_op requires m=2")
        return np.vstack([eye, gf.jerasure_r6_coding_matrix(k)])
    if technique == "cauchy_orig":
        return np.vstack([eye, gf.cauchy_original_coding_matrix(k, m)])
    if technique == "cauchy_good":
        return np.vstack([eye, gf.cauchy_good_coding_matrix(k, m)])
    raise ErasureCodeError(f"ENOENT: tpu technique={technique!r} not supported")


class ErasureCodeTpu(MatrixErasureCode):
    DEFAULT_K = "8"
    DEFAULT_M = "4"

    #: decode-kernel LRU capacity in matrix-WIDTH units (byte columns):
    #: a dense (nerrs x k) entry costs k, a full-width (nerrs x n)
    #: entry costs n, so the bound tracks device footprint across mixed
    #: signatures (ref: ErasureCodeIsaTableCache.cc
    #: decoding_tables_lru_length, which bounds dense entries only)
    DECODE_LRU_WIDTH = 2516 * 8

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.technique = "reed_sol_van"
        self.alignment = EC_TPU_DEFAULT_ALIGNMENT
        self._encode_mm: GFMatmul | None = None
        #: signature -> GFMatmul/GFDecodeFull, cost-weighted LRU so
        #: device-resident decode operators can't grow unbounded across
        #: erasure patterns (full-width entries charge n, dense k)
        self._decode_mm = DecodeTableCache(self.DECODE_LRU_WIDTH)

    def init(self, profile: ErasureCodeProfile) -> None:
        profile.setdefault("plugin", "tpu")
        self.technique = profile.setdefault("technique", "reed_sol_van")
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, self.DEFAULT_M)
        self.alignment = to_int("tpu-alignment", profile,
                                str(EC_TPU_DEFAULT_ALIGNMENT))
        sanity_check_k_m(self.k, self.m)

    def get_chunk_size(self, object_size: int) -> int:
        # identical to the isa plugin (ErasureCodeIsa.cc:66-79) by default
        chunk_size = (object_size + self.k - 1) // self.k
        modulo = chunk_size % self.alignment
        if modulo:
            chunk_size += self.alignment - modulo
        return chunk_size

    def prepare(self) -> None:
        self._prepare(_matrices(self.technique, self.k, self.m))
        self._encode_mm = GFMatmul(self.encode_matrix[self.k:], self.device)

    # -- matmul backend on device (interface boundary: host numpy) --------
    def matmul(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        if mat.shape == (self.m, self.k) and \
                np.array_equal(mat, self.encode_matrix[self.k:]):
            mm = self._encode_mm
        else:
            mm = GFMatmul(mat, self.device)
        return mm(data).cpu().numpy()

    # -- batched device API (the perf path) -------------------------------
    def encode_batch(self, data) -> torch.Tensor:
        """(..., k, N) uint8 (host or device) -> (..., m, N) parity on the
        plugin's device, one launch for every stripe in the batch."""
        root = SPANS.begin(_SPAN_ENCODE)
        try:
            span = SPANS.begin(_SPAN_STAGE)
            data = _device.as_u8(data, self.device)
            SPANS.end(span)
            with devguard.guard_transfers(self.device):
                return self._encode_mm.launch(data)
        finally:
            SPANS.end(root)

    def decode_batch(self, decode_index: list[int], erasures: list[int],
                     data) -> torch.Tensor:
        """Reconstruct `erasures` from survivor chunks.

        data: (..., k, N) survivor chunks ordered by decode_index.
        Returns (..., len(erasures), N) on the device.  The decode
        operator is cached per erasure signature (ISA-L table cache
        analogue)."""
        sig = erasure_signature(decode_index, erasures)
        mm = self._decode_mm.get(sig)
        if mm is None:
            dmat = make_decode_matrix(self.encode_matrix, self.k,
                                      list(decode_index), list(erasures))
            mm = GFMatmul(dmat, self.device)
            self._decode_mm.put(sig, mm, cost=self.k)
        data = _device.as_u8(data, self.device)
        with devguard.guard_transfers(self.device):
            return mm.launch(data)

    def decode_batch_full(self, erasures: list[int], data,
                          valid=None) -> torch.Tensor:
        """Reconstruct `erasures` straight from the FULL chunk array, the
        staging-free decode path.

        data: (..., k+m, N) in ARRIVAL layout (every chunk slot present;
        erased slots carry garbage).  `valid` optionally narrows which
        slots hold real survivor data (length-n bool mask; default:
        everything outside `erasures`).  The decode matrix is the
        zero-column (nerrs x n) form and the kernel reads only the
        survivor rows, so nothing is gathered on the host.  Returns
        (..., len(erasures), N) on the device.  Operators are cached per
        signature, cost-weighted in the LRU (full-width entries are
        (k+m)/k x a dense entry)."""
        root = SPANS.begin(_SPAN_DECODE_FULL)
        try:
            span = SPANS.begin(_SPAN_TABLE)
            mm, miss = self._full_operator(erasures, valid)
            SPANS.end(span, miss)
            # staging-free contract: the kernel reads the survivor rows
            # on the device, nothing inside the launch touches the host
            span = SPANS.begin(_SPAN_STAGE)
            data = _device.as_u8(data, self.device)
            SPANS.end(span)
            with devguard.guard_transfers(self.device):
                return mm.launch(data)
        finally:
            SPANS.end(root)

    def _full_operator(self, erasures: list[int],
                       valid) -> tuple[GFDecodeFull, bool]:
        """The cached full-width operator for (erasures, valid), and
        whether this lookup missed and built it."""
        n = self.k + self.m
        erased = sorted(int(e) for e in erasures)
        if valid is None:
            valid = np.ones(n, dtype=bool)
            valid[erased] = False
        else:
            valid = np.asarray(valid, dtype=bool)
        sig = "full" + "".join(f"-{e}" for e in erased) + \
            "+v" + "".join("1" if v else "0" for v in valid)
        mm = self._decode_mm.get(sig)
        if mm is not None:
            return mm, False
        decode_index = [i for i in range(n)
                        if valid[i] and i not in set(erased)][:self.k]
        if len(decode_index) < self.k:
            raise ErasureCodeError("EIO: fewer than k valid chunks available")
        dmat = make_decode_matrix_full(self.encode_matrix, self.k, n,
                                       decode_index, erased)
        mm = GFDecodeFull(dmat, valid, self.device)
        self._decode_mm.put(sig, mm, cost=n)
        return mm, True

    def decode_batches_full(self, erasures: list[int], batches,
                            valid=None):
        """Pipelined staging-free decode over a stream of host-resident
        full-width batches: batch i+1 is copied from pinned host memory
        on a side stream while batch i's kernel runs.  Yields device
        tensors in order."""
        if self.device.type != "cuda":
            for batch in batches:
                yield self.decode_batch_full(erasures, batch, valid)
            return
        copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)

        def stage(batch):
            if isinstance(batch, torch.Tensor) and batch.is_cuda:
                return batch, None
            host = _device.as_u8(batch, torch.device("cpu")).pin_memory()
            with torch.cuda.stream(copy_stream):
                dev = host.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return dev, done

        it = iter(batches)
        try:
            nxt = stage(next(it))
        except StopIteration:
            return
        while True:
            cur, done = nxt
            if done is not None:
                compute.wait_event(done)
                cur.record_stream(compute)
            out = self.decode_batch_full(erasures, cur, valid)
            try:
                # next batch's copy starts while `out`'s kernel runs
                nxt = stage(next(it))
            except StopIteration:
                yield out
                return
            yield out


PLUGIN = ErasureCodePlugin("tpu", ErasureCodeTpu)


def from_reference(encode_matrix: np.ndarray, k: int, m: int,
                   technique: str = "reed_sol_van",
                   device=None) -> ErasureCodeTpu:
    """Build the port plugin from another implementation's full
    (k+m) x k encode matrix, asserting it equals the port's own."""
    ec = PLUGIN.factory({"k": str(k), "m": str(m), "technique": technique},
                        device)
    ref = np.asarray(encode_matrix, dtype=np.uint8)
    if not np.array_equal(ref, ec.encode_matrix):
        raise AssertionError(
            f"reference encode matrix differs from the port's for "
            f"k={k} m={m} technique={technique}")
    return ec
