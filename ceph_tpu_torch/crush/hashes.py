"""CRUSH rjenkins1 hash — scalar and numpy-vectorized, exact uint32 semantics.

Reimplementation of the Robert Jenkins 32-bit mix used by CRUSH
(ref: src/crush/hash.c:12-113): hash seed 1315423911, the 9-step hashmix,
and the 1..5-argument front-ends.  The numpy forms operate on uint32
arrays; `hash32_2_int` is hash32_2 on Python ints, for the scalar
engine's per-item reweight test, where numpy's per-call cost dominates.  The
batch engine's torch form lives in `batch.py`.
"""
from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = np.uint32(1315423911)
CRUSH_HASH_RJENKINS1 = 0

_U32 = 0xFFFFFFFF


def _mix(a, b, c):
    """One crush_hashmix round on uint32 numpy values/arrays."""
    with np.errstate(over="ignore"):
        a = a - b; a = a - c; a = a ^ (c >> np.uint32(13))
        b = b - c; b = b - a; b = b ^ (a << np.uint32(8))
        c = c - a; c = c - b; c = c ^ (b >> np.uint32(13))
        a = a - b; a = a - c; a = a ^ (c >> np.uint32(12))
        b = b - c; b = b - a; b = b ^ (a << np.uint32(16))
        c = c - a; c = c - b; c = c ^ (b >> np.uint32(5))
        a = a - b; a = a - c; a = a ^ (c >> np.uint32(3))
        b = b - c; b = b - a; b = b ^ (a << np.uint32(10))
        c = c - a; c = c - b; c = c ^ (b >> np.uint32(15))
    return a, b, c


def _u32(x):
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def hash32(a) -> np.ndarray:
    a = _u32(a)
    h = CRUSH_HASH_SEED ^ a
    b = a
    x = np.uint32(231232)
    y = np.uint32(1232)
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def hash32_2(a, b) -> np.ndarray:
    a, b = _u32(a), _u32(b)
    h = CRUSH_HASH_SEED ^ a ^ b
    x = np.uint32(231232)
    y = np.uint32(1232)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a, b, c) -> np.ndarray:
    a, b, c = _u32(a), _u32(b), _u32(c)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x = np.uint32(231232)
    y = np.uint32(1232)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_4(a, b, c, d) -> np.ndarray:
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x = np.uint32(231232)
    y = np.uint32(1232)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def hash32_5(a, b, c, d, e) -> np.ndarray:
    a, b, c, d, e = _u32(a), _u32(b), _u32(c), _u32(d), _u32(e)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e
    x = np.uint32(231232)
    y = np.uint32(1232)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


def _mix_int(a: int, b: int, c: int) -> tuple[int, int, int]:
    """crush_hashmix on Python ints in [0, 2^32)."""
    a = (a - b - c) & _U32; a ^= c >> 13
    b = (b - c - a) & _U32; b ^= (a << 8) & _U32
    c = (c - a - b) & _U32; c ^= b >> 13
    a = (a - b - c) & _U32; a ^= c >> 12
    b = (b - c - a) & _U32; b ^= (a << 16) & _U32
    c = (c - a - b) & _U32; c ^= b >> 5
    a = (a - b - c) & _U32; a ^= c >> 3
    b = (b - c - a) & _U32; b ^= (a << 10) & _U32
    c = (c - a - b) & _U32; c ^= b >> 15
    return a, b, c


def hash32_2_int(a: int, b: int) -> int:
    """hash32_2 on Python ints (low 32 bits of each argument)."""
    a, b = a & _U32, b & _U32
    h = 1315423911 ^ a ^ b
    a, b, h = _mix_int(a, b, h)
    x, a, h = _mix_int(231232, a, h)
    b, y, h = _mix_int(b, 1232, h)
    return h
