"""Probe-based repair-program compilation + fused execution.

Every repair the port performs — clay's pairwise-coupled plane walk,
lrc's local-group decode, a plain MDS decode-matrix apply — is
GF(2^8)-linear in the helper bytes: each rebuilt byte is a fixed
GF-linear combination of the gathered helper bytes, with coefficients
determined only by the erasure signature.  So the compiler does not
reimplement any plugin's math: it *extracts* the linear map by running
the plugin's own interpreted repair over basis probes at sub-chunk
size 1 (helper plane j := the byte 0x01, all others zero, yielding
column j of the repair matrix, since 0x01 is the field's
multiplicative identity), then lowers the whole schedule to

    gather survivor planes -> one GF(2^8) matmul -> scatter

The matmul is K1 (`GFMatmul`) on the program's device, its plain
PyTorch version on the CPU, or the numpy oracle (`backend="numpy"`).
On a cuda device a kernel that fails to build or launch raises; nothing
falls back to the oracle or the plain version.  The helper planes are
staged first and K1 launches inside a region of the device guard
(common/devguard.py); the readback comes after it.  Probing costs
`total_planes + 1` interpreted 1-byte-sub-chunk repairs per signature,
on the host, paid once and then cached (see cache.py).

The port's copy of `ceph_tpu.ec.repairc.compiler`.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ... import device as _device
from ...common import devguard
from .. import gf
from ..interface import ErasureCodeError
from ..kernels.bitmatmul import GFMatmul
from .plan import RepairPlan


class RepairPlanError(ValueError):
    """The helper buffers or the chunk size do not fit the plan: the
    chunk size is not sub-chunk aligned, a helper's buffer is not a
    whole number of its repair blocks, or the helpers disagree on the
    stripe count.  A caller may take another repair path on it; a fault
    of the kernel, its build or its launch is never raised as one."""


def interpret_plan(ec, plan: RepairPlan,
                   helper_bufs: Mapping[int, np.ndarray],
                   chunk_size: int) -> dict[int, np.ndarray]:
    """One stripe of the plugin's own interpreted repair: helper
    buffers hold exactly the plan's gathered planes (full chunks when
    the extents cover the chunk, repair planes otherwise).  This is
    the reference semantics the compiled program must match
    byte-for-byte — probes and the parity tests both run through it."""
    chunks = {h: np.asarray(helper_bufs[h], dtype=np.uint8)
              for h, _ in plan.helpers}
    out = ec.decode(set(plan.lost), chunks, chunk_size)
    return {i: np.asarray(out[i], dtype=np.uint8) for i in plan.lost}


def compile_program(ec, plan: RepairPlan) -> "RepairProgram":
    """Derive the signature's repair matrix by basis probes through
    the interpreted path and wrap it as an executable program."""
    sub_no = plan.sub_chunk_no
    rows = plan.output_planes()
    cols = plan.total_planes()
    planes = {h: sum(c for _, c in ext) for h, ext in plan.helpers}

    def probe(shard=None, plane=0):
        bufs = {h: np.zeros(planes[h], dtype=np.uint8)
                for h, _ in plan.helpers}
        if shard is not None:
            bufs[shard][plane] = 1
        return interpret_plan(ec, plan, bufs, sub_no)

    # linearity guard: a plugin whose repair is affine (or stateful)
    # would silently mis-compile — all-zero input must rebuild zeros
    zero = probe()
    for i in plan.lost:
        if zero[i].any():
            raise ErasureCodeError(
                f"repairc: plan {plan.signature()} is not GF-linear "
                f"(zero probe rebuilt non-zero shard {i})")

    mat = np.zeros((rows, cols), dtype=np.uint8)
    col = 0
    for h, _ in plan.helpers:
        for p in range(planes[h]):
            out = probe(h, p)
            for i, lost in enumerate(plan.lost):
                mat[i * sub_no:(i + 1) * sub_no, col] = out[lost]
            col += 1
    return RepairProgram(plan, mat)


class RepairProgram:
    """A compiled erasure-signature repair: gather -> matmul -> scatter.

    The matrix is (output_planes x total_planes) over GF(2^8); `run`
    folds every stripe of the object into the columns of ONE matmul,
    so a whole-object rebuild is a single K1 launch regardless of
    stripe count.  The kernel object (GFMatmul: the matrix and its
    tables resident on one device) is built lazily, one per device,
    and rides in the program cache with its program.
    """

    def __init__(self, plan: RepairPlan, matrix: np.ndarray):
        self.plan = plan
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        self._kernels: dict[torch.device, GFMatmul] = {}

    @classmethod
    def from_reference(cls, ref_prog) -> "RepairProgram":
        """Carry another implementation's compiled program across by
        attribute (its plan's lost shards, helper extents and sub-chunk
        count, and its matrix)."""
        ref_plan = ref_prog.plan
        plan = RepairPlan.make(ref_plan.lost, dict(ref_plan.helpers),
                               ref_plan.sub_chunk_no)
        return cls(plan, np.asarray(ref_prog.matrix, dtype=np.uint8))

    def cost(self) -> int:
        """LRU weight: the matrix footprint in bytes (the kernel's
        tables on the device scale with it alike for every entry, so
        relative weights are preserved)."""
        return int(self.matrix.size)

    def kernel(self, device=None) -> GFMatmul:
        """The program's GFMatmul on `device` (None -> cuda)."""
        dev = _device.resolve(device)
        mm = self._kernels.get(dev)
        if mm is None:
            mm = self._kernels.setdefault(dev, GFMatmul(self.matrix, dev))
        return mm

    # ------------------------------------------------------------ layout
    def _gather(self, helper_bufs: Mapping[int, bytes], chunk_size: int
                ) -> tuple[np.ndarray, int, int]:
        """Helpers' concatenated per-stripe plane bytes -> one dense
        (total_planes x nstripes*ssz) array, plan order."""
        plan = self.plan
        if chunk_size % plan.sub_chunk_no:
            raise RepairPlanError("chunk size not sub-chunk aligned")
        ssz = chunk_size // plan.sub_chunk_no
        nstripes = None
        cols = []
        for h, ext in plan.helpers:
            planes_h = sum(c for _, c in ext)
            buf = np.frombuffer(helper_bufs[h], dtype=np.uint8) \
                if isinstance(helper_bufs[h], (bytes, bytearray,
                                               memoryview)) \
                else np.asarray(helper_bufs[h], dtype=np.uint8)
            block = planes_h * ssz
            if block == 0 or buf.size % block:
                raise RepairPlanError(
                    f"helper {h} buffer ({buf.size}B) not aligned to "
                    f"its {block}B repair block")
            ns = buf.size // block
            if nstripes is None:
                nstripes = ns
            elif ns != nstripes:
                raise RepairPlanError("helper buffers disagree on stripes")
            cols.append(buf.reshape(ns, planes_h, ssz)
                        .transpose(1, 0, 2).reshape(planes_h, ns * ssz))
        return np.concatenate(cols, axis=0), nstripes, ssz

    def _scatter(self, out: np.ndarray, nstripes: int, ssz: int
                 ) -> dict[int, bytes]:
        sub_no = self.plan.sub_chunk_no
        streams = {}
        for i, lost in enumerate(self.plan.lost):
            rowsl = out[i * sub_no:(i + 1) * sub_no]
            streams[lost] = np.ascontiguousarray(
                rowsl.reshape(sub_no, nstripes, ssz)
                .transpose(1, 0, 2)).tobytes()
        return streams

    # --------------------------------------------------------- execution
    def run(self, helper_bufs: Mapping[int, bytes], chunk_size: int,
            backend: str | None = None, device=None) -> dict[int, bytes]:
        """Rebuild every lost shard's chunk stream from the helpers'
        gathered plane bytes.  backend: None or "device" (K1 on
        `device`, None -> cuda; the plain version on the CPU) or
        "numpy" (the host oracle).  On the device: one copy in, one
        launch, one copy back."""
        x, nstripes, ssz = self._gather(helper_bufs, chunk_size)
        if backend == "numpy":
            out = gf.gf_matmul_bytes(self.matrix, x)
        elif backend in (None, "device"):
            mm = self.kernel(device)
            x_dev = _device.as_u8(x, mm.device)
            with devguard.guard_transfers(mm.device):
                out_dev = mm.launch(x_dev)
            out = out_dev.cpu().numpy()
        else:
            raise ValueError(f"unknown repair backend {backend!r}")
        return self._scatter(out, nstripes, ssz)
