"""EC coding over a 2-D (stripe, shard) grid of devices.

Layout: data (S, k, N) is cut into blocks: grid position (i, j) holds
stripes [i*s, (i+1)*s) and chunks [j*kl, (j+1)*kl) on its device, with
s = S / stripe_ways and kl = k / shard_ways (the sharding
P("stripe", "shard", None) of the reference).  Each position holds a
subset of the k data chunks of a slice of the stripe batch, the
device-resident analogue of chunk shards living on k different OSDs.
Coding runs per position:

  * K1 (`GFMatmul` over the position's column slice of the coding
    matrix) multiplies the position's block into a partial product, on
    the position's device;
  * the partials of one stripe row are XORed on the row's home device
    (its shard-0 position).  This is the byte form of the reference's
    `psum('shard')` followed by `& 1`: GF(2^8) addition is XOR.  A
    partial from another card comes over with a non-blocking peer copy;
    that combine is the reference's per-shard write fan-out
    (ref: src/osd/ECBackend.cc:2037-2070);
  * parity lands stripe-sharded, one (s, m, N) block per row on its
    home device (the reference's out_specs=P("stripe", None, None)).

Decode has the same structure, with the erasure's decode matrix over
the survivor chunks (ref: ECBackend.cc:1590 min-avail shard read +
reconstruct).

One process drives every device of the grid, as the reference's mesh
has a single controller.  A device may repeat: ["cuda:0"] * 8 is the
one-card mesh and ["cpu"] * 8 the CPU tests' (where K1's plain version
runs).  The port of `ceph_tpu.dist.mesh_ec`; no kernel of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _device
from ..common import devguard
from ..ec import gf
from ..ec.kernels.bitmatmul import GFMatmul
from ..ec.matrix_code import make_decode_matrix


def cuda_devices() -> list[torch.device]:
    """Every CUDA card present; raises when there is none (the mesh
    never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass devices=['cpu'] "
                           "* n to run the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceMesh:
    """A (stripe_ways, shard_ways) grid of torch.devices (`devices`, an
    object array, as jax's Mesh.devices)."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    def synchronize(self) -> None:
        """Wait until every card of the grid has finished its work."""
        for dev in dict.fromkeys(self.devices.flat):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_mesh(n_devices: int | None = None, shard_ways: int | None = None,
              k: int = 8, devices=None) -> DeviceMesh:
    """(stripe, shard) grid over the first n of `devices` (default: every
    CUDA card); shard_ways must divide both the device count and k
    (chunk subsets stay equal)."""
    devs = cuda_devices() if devices is None else \
        [_device.resolve(d) for d in devices]
    n = n_devices if n_devices is not None else len(devs)
    if n <= 0:
        raise ValueError(f"n_devices must be positive, got {n}")
    if n > len(devs):
        raise ValueError(f"{n} devices requested, {len(devs)} present")
    if shard_ways is None:
        shard_ways = next(c for c in (4, 2, 1)
                          if n % c == 0 and k % c == 0)
    if n % shard_ways or k % shard_ways:
        raise ValueError(
            f"shard_ways={shard_ways} must divide n={n} and k={k}")
    if len({d.type for d in devs[:n]}) != 1:
        raise ValueError("a mesh's devices must all be of one type")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return DeviceMesh(grid.reshape(n // shard_ways, shard_ways))


class ShardedStripes:
    """An (S, rows, N) uint8 array cut over a grid: blocks[i][j] is the
    block of stripe row i and chunk column j, on that position's
    device."""

    def __init__(self, blocks: list[list[torch.Tensor]], shape: tuple):
        self.blocks = blocks
        self.shape = shape

    def numpy(self) -> np.ndarray:
        """The whole array, read back to the host."""
        return np.concatenate([
            np.concatenate([b.cpu().numpy() for b in row], axis=1)
            for row in self.blocks])

    def row(self, r: int) -> np.ndarray:
        """Chunk row r of every stripe, (S, N), read back to the host."""
        per = self.shape[1] // len(self.blocks[0])
        j, local = divmod(r, per)
        return np.concatenate([row[j][:, local].cpu().numpy()
                               for row in self.blocks])


class MeshECCoder:
    """Sharded encode/decode for one (k, m) code on one mesh."""

    def __init__(self, k: int, m: int, mesh: DeviceMesh,
                 encode_matrix: np.ndarray | None = None):
        self.k = k
        self.m = m
        self.mesh = mesh
        self.shard_ways = mesh.devices.shape[1]
        if k % self.shard_ways:
            raise ValueError("k must divide over the shard axis")
        if encode_matrix is None:
            encode_matrix = gf.isa_rs_matrix(k, m)
        self.encode_matrix = np.ascontiguousarray(encode_matrix,
                                                  dtype=np.uint8)
        #: (matrix signature, chunk column, device) -> GFMatmul over that
        #: column slice, resident on that device
        self._ops: dict[tuple, GFMatmul] = {}
        #: decode signature -> (e x k) decode matrix
        self._dec: dict[str, np.ndarray] = {}

    # ------------------------------------------------------- placement
    def shard_data(self, data_np: np.ndarray) -> ShardedStripes:
        """Host (S, k, N) -> one contiguous block per grid position, on
        its device (a blocking copy on cuda: stage before a launch)."""
        a = np.asarray(data_np, dtype=np.uint8)
        S, rows, N = a.shape
        ways, cols = self.mesh.devices.shape
        if S % ways or rows % cols:
            raise ValueError(f"({S}, {rows}) does not divide over the "
                             f"({ways}, {cols}) mesh")
        s, kl = S // ways, rows // cols
        return ShardedStripes(
            [[_device.as_u8(a[i * s:(i + 1) * s, j * kl:(j + 1) * kl],
                            self.mesh.devices[i, j]) for j in range(cols)]
             for i in range(ways)], a.shape)

    # ---------------------------------------------------------- coding
    def _op(self, sig: str, mat: np.ndarray, j: int,
            dev: torch.device) -> GFMatmul:
        key = (sig, j, dev)
        op = self._ops.get(key)
        if op is None:
            kl = mat.shape[1] // self.shard_ways
            op = self._ops[key] = GFMatmul(mat[:, j * kl:(j + 1) * kl], dev)
        return op

    def _apply(self, sig: str, mat: np.ndarray,
               data: ShardedStripes) -> ShardedStripes:
        """K1 per position, then the partials XORed per stripe row on
        its home device."""
        if len(data.blocks) != self.mesh.devices.shape[0] or \
                len(data.blocks[0]) != self.shard_ways:
            raise ValueError("data is not sharded over this coder's mesh")
        out = []
        with devguard.guard_transfers(self.mesh.devices[0, 0]):
            for i, row in enumerate(data.blocks):
                home = self.mesh.devices[i, 0]
                acc = self._op(sig, mat, 0, home).launch(row[0])
                for j in range(1, len(row)):
                    part = self._op(sig, mat, j, row[j].device).launch(row[j])
                    acc.bitwise_xor_(part.to(home, non_blocking=True))
                out.append([acc])
        return ShardedStripes(out, (data.shape[0], mat.shape[0],
                                    data.shape[2]))

    def encode(self, data: ShardedStripes) -> ShardedStripes:
        """data (S, k, N) sharded (stripe, shard) -> parity (S, m, N)
        sharded (stripe)."""
        return self._apply("encode", self.encode_matrix[self.k:], data)

    def decode(self, decode_index: list[int], erasures: list[int],
               survivors: ShardedStripes) -> ShardedStripes:
        """survivors (S, k, N) — chunks `decode_index` in order,
        sharded (stripe, shard) -> reconstructed erasures (S, e, N)."""
        sig = f"{tuple(decode_index)}-{tuple(erasures)}"
        dmat = self._dec.get(sig)
        if dmat is None:
            dmat = self._dec[sig] = make_decode_matrix(
                self.encode_matrix, self.k, list(decode_index),
                list(erasures))
        return self._apply(sig, dmat, survivors)

    # ------------------------------------------------------ validation
    def check_parity(self, data_np: np.ndarray,
                     parity: ShardedStripes) -> bool:
        """Full-batch oracle comparison (per-stripe, so stripe-axis
        placement bugs can't hide behind a correct stripe 0)."""
        got = parity.numpy()
        for i in range(data_np.shape[0]):
            want = gf.gf_matmul_bytes(self.encode_matrix[self.k:],
                                      data_np[i])
            if not np.array_equal(got[i], want):
                return False
        return True
