"""GF(2^8) byte-matrix products over stripes: the erasure-code hot loop.

    out[s, i, :] = XOR_j mat[i, j] * data[s, j, :]      over GF(2^8)/0x11d

which is ISA-L's `ec_encode_data` per stripe (ref:
src/erasure-code/isa/ErasureCodeIsa.cc:129).  Two kernels carry it, both
CUDA C++ in `csrc/gf_matmul.cu`:

* K1 `gf_matmul_cuda`: (S, k, N) stripes -> (S, r, N); encode and staged
  decode.  Counterpart of `_gf_kernel_planar` in the reference package.
  Takes `packed_nibble_tables`: one entry per (input row, nibble) holds
  the products for every output row, so a byte costs two lookups.
* K2 `gf_decode_select_cuda`: the same product on the survivor rows `sel`
  of a full-width (S, n, N) arrival block; erased slots, whatever they
  hold, are never read.  Counterpart of `_gf_kernel_planar_select`.
  Takes `nibble_tables`, one 32-byte pair per (output row, input row).

Beside each kernel is its plain PyTorch version (`gf_matmul_plain`,
`gf_decode_select_plain`): a `mul_table` gather and an XOR over k,
independent of the kernels' split-nibble tables.  The dispatchers
(`gf_matmul`, `gf_decode_select`) run the kernel on a cuda tensor and
the plain version on a cpu tensor, and raise on anything else.

`GFMatmul` and `GFDecodeFull` keep the byte matrix, its tables and the
survivor index vector resident on their device across calls (the
analogue of ISA-L's table cache, ref: ErasureCodeIsaTableCache.cc),
staged without a host sync.  The CUDA wrappers refuse a tensor that is not
on the data's device; under the device guard (common/devguard.py) the
dispatchers refuse one on the CPU path too.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import gf
from ... import device as _device
from ...common import devguard
from . import _build

#: launches of each CUDA kernel, counted by its wrapper at the launch
LAUNCHES = {"gf_matmul": 0, "gf_decode_select": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=512)
def companion_bitmatrix(mat_bytes: bytes, r: int, k: int) -> np.ndarray:
    """(8r x 8k) GF(2) companion of an (r x k) byte matrix (int8): the
    bit-plane form of the same product (gf.expand_to_bitmatrix)."""
    mat = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(r, k)
    return gf.expand_to_bitmatrix(mat).astype(np.int8)


def nibble_tables(mat: np.ndarray) -> np.ndarray:
    """(r, k, 32) uint8 split-nibble tables of an (r x k) byte matrix:
    [..., x] = c * x and [..., 16 + x] = c * (x << 4) for x < 16, so
    c * b = t[b & 15] ^ t[16 + (b >> 4)] (the ISA-L pshufb scheme)."""
    mat = np.asarray(mat, dtype=np.uint8)
    MUL = gf.mul_table()
    x = np.arange(16)
    lo = MUL[mat[:, :, None], x[None, None, :]]
    hi = MUL[mat[:, :, None], (x << 4)[None, None, :]]
    return np.ascontiguousarray(np.concatenate([lo, hi], axis=2))


def packed_shape(r: int, k: int) -> tuple[int, ...]:
    """Shape of `packed_nibble_tables` for an (r x k) matrix."""
    return (-(-r // 8), k, 2, 16, 4 if r <= 4 else 8)


def packed_nibble_tables(mat: np.ndarray) -> np.ndarray:
    """(g, k, 2, 16, W) uint8 row-packed split-nibble tables for K1, one
    block per launch of up to 8 output rows (g = ceil(r / 8)).  Entry
    [G, j, h, x] holds in its byte i the product of mat[8G + i, j] with
    x (h = 0) or x << 4 (h = 1), 0 past the last row; W = 4 bytes when
    r <= 4, else 8.  So one lookup per nibble serves every output row:
    byte i of t[G, j, 0, b & 15] ^ t[G, j, 1, b >> 4] is
    mat[8G + i, j] * b."""
    mat = np.asarray(mat, dtype=np.uint8)
    r, k = mat.shape
    g, _, _, _, w = packed_shape(r, k)
    rows = np.zeros((g * w, k, 2, 16), dtype=np.uint8)
    rows[:r] = nibble_tables(mat).reshape(r, k, 2, 16)
    return np.ascontiguousarray(
        rows.reshape(g, w, k, 2, 16).transpose(0, 2, 3, 4, 1))


def _survivor_runs(idx: list[int]) -> list[tuple[int, int]]:
    """Sorted row indexes -> maximal contiguous [start, stop) runs, so
    the plain version gathers survivors with a few slices."""
    runs: list[tuple[int, int]] = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))
    return runs


def selection_from_matrix(mat_full: np.ndarray,
                          valid: np.ndarray | None = None) -> list[int]:
    """Survivor columns of a full-width decode matrix: the nonzero
    columns, checked against `valid` (length-n bool mask of slots
    whose content is real).  A nonzero column over an INVALID slot
    would fold garbage into the output — that is a caller bug, not a
    degraded mode, so it raises."""
    nz = [int(j) for j in np.flatnonzero(mat_full.any(axis=0))]
    if valid is not None:
        valid = np.asarray(valid, dtype=bool)
        bad = [j for j in nz if not valid[j]]
        if bad:
            raise ValueError(
                f"decode matrix has nonzero columns {bad} over slots "
                "the validity mask marks erased")
    return nz


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _mul_flat(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(gf.mul_table().reshape(-1)).to(device)


def gf_matmul_plain(mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """mat (r, k) uint8, data (S, k, N) uint8 -> (S, r, N): for each j,
    gather mul_table[mat[:, j], data[:, j]] and XOR it in."""
    s, k, n = data.shape
    r = mat.shape[0]
    mul = _mul_flat(data.device)
    rows = mat.to(device=data.device, dtype=torch.int64) * 256
    out = torch.zeros((s, r, n), dtype=torch.uint8, device=data.device)
    for j in range(k):
        idx = rows[:, j].view(1, r, 1) + data[:, j:j + 1, :].to(torch.int64)
        out ^= mul[idx]
    return out


def gf_decode_select_plain(mat: torch.Tensor, runs: list[tuple[int, int]],
                           data: torch.Tensor) -> torch.Tensor:
    """K1's product on the survivor rows (given as [start, stop) runs)
    of a full-width (S, n, N) block."""
    survivors = torch.cat([data[:, a:b] for a, b in runs], dim=1)
    return gf_matmul_plain(mat, survivors)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_matmul")
    lib.gf_matmul_k1.argtypes = [_VP, _I, _I, _VP, _VP, _LL, _LL, _VP]
    lib.gf_matmul_k1.restype = _I
    lib.gf_matmul_k2.argtypes = [_VP, _I, _I, _I, _VP, _VP, _VP, _LL, _LL,
                                 _VP]
    lib.gf_matmul_k2.restype = _I
    lib.gf_error_string.argtypes = [_I]
    lib.gf_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(tables: torch.Tensor, data: torch.Tensor,
                table_shape: tuple[int, ...], what: str) -> None:
    if data.device.type != "cuda" or tables.device != data.device:
        raise ValueError(f"kernel needs data and tables on one cuda device, "
                         f"got {data.device} and {tables.device}")
    if data.dtype != torch.uint8 or data.dim() != 3 or \
            not data.is_contiguous():
        raise ValueError("data must be a contiguous (S, rows, N) uint8 tensor")
    if tables.dtype != torch.uint8 or tuple(tables.shape) != table_shape or \
            not tables.is_contiguous() or tables.data_ptr() % 16:
        raise ValueError(f"tables must be a contiguous, 16-byte aligned "
                         f"{table_shape} uint8 tensor of {what}, got "
                         f"{tuple(tables.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _lib().gf_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def gf_matmul_cuda(tables: torch.Tensor, data: torch.Tensor,
                   r: int) -> torch.Tensor:
    """K1: tables of packed_nibble_tables for an (r x k) matrix, data
    (S, k, N) -> (S, r, N), launched on the current stream of the data's
    device, whichever device is current."""
    if data.dim() != 3:
        raise ValueError("data must be a contiguous (S, rows, N) uint8 tensor")
    s, k, n = data.shape
    _check_cuda(tables, data, packed_shape(r, k), "packed_nibble_tables")
    out = torch.empty((s, r, n), dtype=torch.uint8, device=data.device)
    if s and n:
        # the library launches on the calling thread's current device
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            _raise_on(_lib().gf_matmul_k1(tables.data_ptr(), r, k,
                                          data.data_ptr(), out.data_ptr(),
                                          s, n, stream), "gf_matmul_k1")
        LAUNCHES["gf_matmul"] += 1
    return out


def gf_decode_select_cuda(tables: torch.Tensor, sel: torch.Tensor,
                          data: torch.Tensor) -> torch.Tensor:
    """K2: tables (r, k, 32), sel (k,) int32 row indexes into the n rows
    of each stripe of data (S, n, N) -> (S, r, N)."""
    r, k = tables.shape[:2]
    _check_cuda(tables, data, (r, k, 32), "nibble_tables")
    s, n, nbytes = data.shape
    if sel.dtype != torch.int32 or sel.shape != (k,) or \
            sel.device != data.device:
        raise ValueError("sel must be a (k,) int32 tensor on the data's device")
    out = torch.empty((s, r, nbytes), dtype=torch.uint8, device=data.device)
    if s and nbytes:
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            _raise_on(_lib().gf_matmul_k2(tables.data_ptr(), r, k, n,
                                          sel.data_ptr(), data.data_ptr(),
                                          out.data_ptr(), s, nbytes, stream),
                      "gf_matmul_k2")
        LAUNCHES["gf_decode_select"] += 1
    return out


def gf_matmul(tables: torch.Tensor, mat: torch.Tensor,
              data: torch.Tensor) -> torch.Tensor:
    """K1 on a cuda tensor, its plain version on a cpu tensor."""
    if data.device.type == "cuda":
        return gf_matmul_cuda(tables, data, mat.shape[0])
    if data.device.type == "cpu":
        devguard.check_device("gf_matmul", data.device, tables, mat)
        return gf_matmul_plain(mat, data)
    raise ValueError(f"unsupported device {data.device}")


def gf_decode_select(tables: torch.Tensor, sel: torch.Tensor,
                     mat: torch.Tensor, runs: list[tuple[int, int]],
                     data: torch.Tensor) -> torch.Tensor:
    """K2 on a cuda tensor, its plain version on a cpu tensor."""
    if data.device.type == "cuda":
        return gf_decode_select_cuda(tables, sel, data)
    if data.device.type == "cpu":
        devguard.check_device("gf_decode_select", data.device, tables, sel,
                              mat)
        return gf_decode_select_plain(mat, runs, data)
    raise ValueError(f"unsupported device {data.device}")


# ---------------------------------------------------------------------------
# Device-resident operators
# ---------------------------------------------------------------------------

class GFMatmul:
    """GF matmul by a fixed (r x k) byte matrix, resident on `device`."""

    def __init__(self, mat: np.ndarray, device=None):
        self.device = _device.resolve(device)
        self.mat = np.ascontiguousarray(mat, dtype=np.uint8)
        self.r, self.k = self.mat.shape
        self.mat_t = _device.stage(self.mat.copy(), self.device)
        self.tables = _device.stage(packed_nibble_tables(self.mat),
                                    self.device)

    def __call__(self, data) -> torch.Tensor:
        """data: (..., k, N) uint8, numpy or tensor -> (..., r, N) on the
        device."""
        return self.launch(_device.as_u8(data, self.device))

    def launch(self, data: torch.Tensor) -> torch.Tensor:
        """__call__ on input its caller already staged on the device."""
        *lead, k, n = data.shape
        if k != self.k:
            raise ValueError(f"expected {self.k} input rows, got {k}")
        s = int(np.prod(lead)) if lead else 1
        out = gf_matmul(self.tables, self.mat_t, data.reshape(s, k, n))
        return out.reshape(*lead, self.r, n)


class GFDecodeFull:
    """Decode by one full-width (nerrs x n) matrix, resident on `device`.

    Holds the dense matrix restricted to its survivor columns, its tables
    and the survivor index vector; __call__ consumes (..., n, N) arrival-
    layout chunk arrays with no host-side staging."""

    def __init__(self, mat_full: np.ndarray,
                 valid: np.ndarray | None = None, device=None):
        self.device = _device.resolve(device)
        self.mat_full = np.ascontiguousarray(mat_full, dtype=np.uint8)
        self.r, self.n = self.mat_full.shape
        self.sel = tuple(selection_from_matrix(self.mat_full, valid))
        if not self.sel:
            raise ValueError("decode matrix has no nonzero columns")
        self.runs = _survivor_runs(list(self.sel))
        self.mat = np.ascontiguousarray(self.mat_full[:, list(self.sel)])
        self.mat_t = _device.stage(self.mat.copy(), self.device)
        self.tables = _device.stage(nibble_tables(self.mat), self.device)
        self.sel_t = _device.stage(np.asarray(self.sel, dtype=np.int32),
                                   self.device)

    def __call__(self, data) -> torch.Tensor:
        return self.launch(_device.as_u8(data, self.device))

    def launch(self, data: torch.Tensor) -> torch.Tensor:
        """__call__ on input its caller already staged on the device."""
        *lead, n, nbytes = data.shape
        if n != self.n:
            raise ValueError(f"expected {self.n} chunk slots, got {n}")
        s = int(np.prod(lead)) if lead else 1
        out = gf_decode_select(self.tables, self.sel_t, self.mat_t,
                               self.runs, data.reshape(s, n, nbytes))
        return out.reshape(*lead, self.r, nbytes)
