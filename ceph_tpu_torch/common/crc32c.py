"""crc32c (Castagnoli) with the reference's raw-seed chaining semantics.

`crc32c(seed, data)` behaves like the reference's `ceph_crc32c(seed,
buf, len)` (behavioral ref: src/common/crc32c.h, table impl
src/common/sctp_crc32.c): the seed is the running crc — no implicit
pre/post inversion — so cumulative shard hashes (ECUtil HashInfo) chain
calls directly.

Fast path: the repository's native slice-by-8 C library
(native/crc32c.c), compiled on demand with the system compiler into the
port's build directory (`ceph_tpu_torch/_build/`).  Without a compiler
or the source, a numpy table walk (correct, slower).

The port's copy of `ceph_tpu.common.crc32c`.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PORT = Path(__file__).resolve().parents[1]
_SRC = _PORT.parent / "native" / "crc32c.c"
_LIB = _PORT / "_build" / "libcrc32c.so"

_lock = threading.Lock()
_native = None
_native_tried = False


def _build_native() -> Path | None:
    if not _SRC.is_file():
        return None
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    # compile to a temp name + atomic rename so a concurrent process
    # never dlopens a half-written library
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", str(_SRC), "-o",
                     str(tmp)], check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, _LIB)
            return _LIB
    finally:
        tmp.unlink(missing_ok=True)
    return None


def _load_native():
    global _native, _native_tried
    with _lock:
        if not _native_tried:
            try:
                path = _build_native()
                if path is not None:
                    fn = ctypes.CDLL(str(path)).ceph_tpu_crc32c
                    fn.restype = ctypes.c_uint32
                    fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                   ctypes.c_size_t]
                    _native = fn
            except OSError:
                _native = None
            _native_tried = True
        return _native


def _make_table() -> np.ndarray:
    poly = 0x82F63B78
    tbl = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl[i] = c
    return tbl


_TABLE = _make_table()


def _crc32c_py(seed: int, data: bytes) -> int:
    crc = seed & 0xFFFFFFFF
    tbl = _TABLE
    for b in data:
        crc = int(tbl[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc


def crc32c(seed: int, data) -> int:
    """Running crc32c over data; chain by passing the previous result
    as the next seed.  data: bytes-like or uint8 ndarray."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    elif isinstance(data, (bytearray, memoryview)):
        data = bytes(data)
    fn = _load_native()
    if fn is not None:
        return fn(seed & 0xFFFFFFFF, data, len(data))
    return _crc32c_py(seed, data)
