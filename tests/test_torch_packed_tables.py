"""K1's row-packed nibble tables and the kernel's lookup arithmetic, on the CPU.

`packed_nibble_tables` must hold exactly the products of `nibble_tables`.
A torch emulation of the CUDA kernel's arithmetic must equal the plain
version and the reference's fused kernel run in interpret mode, byte for
byte (tolerance 0).  The emulation works as the kernel does: the launch
block's tables as one flat byte array (shared memory), input bytes as
little-endian 32-bit words, nibble offsets by shift and mask, each byte's
offset taken with `__byte_perm` beside the 256-aligned row-group base,
word loads at those byte addresses, groups of 4 input rows, and at the
end either the 4x4 `__byte_perm` transposes (16-byte stores) or byte
stores.  The shifts, masks and selectors it uses are checked against the
kernel's source text, so a changed constant there fails here."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec.kernels import bitmatmul as ref_bm
from ceph_tpu_torch.ec.kernels import bitmatmul as bm

KERNEL_SRC = Path(bm.__file__).parent / "csrc" / "gf_matmul.cu"
GROUP, BYTES = 4, 16                 # kK1Group, kK1Bytes
LO = {4: (2, 0x3c3c3c3c), 8: (3, 0x78787878)}    # (w << s) & mask
HI = {4: (2, 0x3c3c3c3c), 8: (1, 0x78787878)}    # (w >> s) & mask
BYTE_SEL = 0x7650                    # + b: byte b of x, bytes 1..3 of y
TRANSPOSE = [("t0", "c[0]", "c[1]", 0x5140), ("t1", "c[0]", "c[1]", 0x7362),
             ("t2", "c[2]", "c[3]", 0x5140), ("t3", "c[2]", "c[3]", 0x7362),
             ("c[0]", "t0", "t2", 0x5410), ("c[1]", "t0", "t2", 0x7632),
             ("c[2]", "t1", "t3", 0x5410), ("c[3]", "t1", "t3", 0x7632)]

# (s, k, r, n): the K1 shapes of test_torch_bitmatmul.py, then r = 1 .. 8
# at k = 8, then two launch blocks (r > 8)
SHAPES = [
    (1, 8, 4, 2048 + 17),
    (2, 8, 2, 4096),
    (3, 5, 3, 2048 + 1),
    (4, 20, 4, 2048),
    (6, 3, 2, 1000),
] + [(2, 8, r, 2048 + 5) for r in range(1, 9)] + [(2, 6, 12, 2048 + 3)]


def unpack(packed: np.ndarray, r: int) -> np.ndarray:
    """(g, k, 2, 16, W) -> the (g*W, k, 32) tables of every packed row."""
    g, k, _, _, w = packed.shape
    return packed.transpose(0, 4, 1, 2, 3).reshape(g * w, k, 32)


def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm(x, y, sel) on int64 tensors or ints holding
    uint32 values: byte n of the result is byte (sel >> 4n) & 7 of the
    8 bytes y:x."""
    out = 0
    for n in range(4):
        src = (sel >> (4 * n)) & 7
        part = (x >> (8 * src)) if src < 4 else (y >> (8 * (src - 4)))
        out = out | ((part & 0xff) << (8 * n))
    return out


def load32(smem: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """The little-endian 32-bit word at each byte address; the address
    must be aligned, as an LDS needs."""
    assert not (addr % 4).any() and int(addr.max()) + 4 <= smem.numel()
    return sum(smem[addr + i] << (8 * i) for i in range(4))


def emulate_k1(packed: np.ndarray, r: int, data: np.ndarray,
               vec: bool) -> np.ndarray:
    g, k, _, _, w = packed.shape
    s, _, n = data.shape
    k_row = 32 * w                   # table bytes of one input row
    npad = -(-n // BYTES) * BYTES    # the last thread's bytes past n read 0
    padded = np.zeros((s, k, npad), dtype=np.uint8)
    padded[..., :n] = data
    words = torch.from_numpy(padded.view("<u4").astype(np.int64))
    out = np.zeros((s, r, n), dtype=np.uint8)
    for blk in range(g):
        smem = torch.from_numpy(packed[blk].reshape(-1).astype(np.int64))
        rows = min(8, r - 8 * blk)
        acc = torch.zeros((s, npad // 4, 4, w // 4), dtype=torch.int64)
        for j0 in range(0, k, GROUP):
            rel = j0 * k_row
            assert rel % 256 == 0
            for jj in range(min(GROUP, k - j0)):
                wq = words[:, j0 + jj]                  # (s, npad / 4)
                lo = (wq << LO[w][0]) & LO[w][1]
                hi = (wq >> HI[w][0]) & HI[w][1]
                row = jj * k_row
                for b in range(4):
                    a = row + byte_perm(lo, rel, BYTE_SEL + b)
                    c = row + 16 * w + byte_perm(hi, rel, BYTE_SEL + b)
                    assert not (a % w).any() and not (c % w).any()
                    for h in range(w // 4):
                        acc[:, :, b, h] ^= load32(smem, a + 4 * h) ^ \
                            load32(smem, c + 4 * h)
        if vec:
            o = torch.zeros((w, s, npad // 4), dtype=torch.int64)
            for h in range(w // 4):
                c = {f"c[{b}]": acc[:, :, b, h] for b in range(4)}
                for dst, x, y, sel in TRANSPOSE:
                    c[dst] = byte_perm(c[x], c[y], sel)
                for i in range(4):
                    o[4 * h + i] = c[f"c[{i}]"]
            rows_bytes = o.to(torch.int32).numpy().view(np.uint8)
            out[:, 8 * blk:8 * blk + rows] = \
                rows_bytes.reshape(w, s, npad)[:rows, :, :n].transpose(1, 0, 2)
        else:
            for i in range(rows):
                col = (acc[:, :, :, i >> 2] >> (8 * (i & 3))) & 0xff
                out[:, 8 * blk + i] = col.reshape(s, npad)[:, :n].numpy()
    return out


def test_emulated_constants_are_the_kernels():
    src = KERNEL_SRC.read_text()
    for w in (4, 8):
        assert f"(w << {LO[w][0]}) & {LO[w][1]:#x}u" in src
        assert f"(w >> {HI[w][0]}) & {HI[w][1]:#x}u" in src
    assert f"__byte_perm(lo, rel, {BYTE_SEL:#x} + b)" in src
    assert f"__byte_perm(hi, rel, {BYTE_SEL:#x} + b)" in src
    for dst, x, y, sel in TRANSPOSE:
        assert f"{dst} = __byte_perm({x}, {y}, {sel:#x});" in src
    assert f"constexpr int kK1Group = {GROUP};" in src
    assert f"constexpr int kK1Bytes = {BYTES};" in src
    assert "static_cast<uint32_t>(j0) * kRow" in src
    assert "tab + jj * kRow" in src and "row + 16 * W + c" in src


@pytest.mark.parametrize("s,k,r,n", SHAPES)
def test_packed_tables_unpack_to_nibble_tables(s, k, r, n):
    rng = np.random.default_rng(s * 1000 + k * 10 + r)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    packed = bm.packed_nibble_tables(mat)
    assert packed.dtype == np.uint8 and packed.flags.c_contiguous
    assert packed.shape == bm.packed_shape(r, k) == \
        (-(-r // 8), k, 2, 16, 4 if r <= 4 else 8)
    rows = unpack(packed, r)
    np.testing.assert_array_equal(rows[:r], bm.nibble_tables(mat))
    assert not rows[r:].any()          # rows past r hold zeros


@pytest.mark.parametrize("s,k,r,n", SHAPES)
def test_packed_lookup_matches_plain_and_reference(s, k, r, n):
    rng = np.random.default_rng(s * 1000 + k * 10 + r)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = rng.integers(0, 256, (s, k, n), dtype=np.uint8)
    packed = bm.packed_nibble_tables(mat)
    plain = bm.gf_matmul_plain(torch.from_numpy(mat),
                               torch.from_numpy(data)).numpy()
    want = np.asarray(ref_bm.gf_matmul_pallas(mat, jnp.asarray(data),
                                              interpret=True))
    np.testing.assert_array_equal(plain, want)
    # the kernel takes 16-byte stores only where N % 16 == 0 (and the
    # pointers are aligned), byte stores otherwise
    for vec in (True, False) if n % 16 == 0 else (False,):
        np.testing.assert_array_equal(emulate_k1(packed, r, data, vec), plain)
