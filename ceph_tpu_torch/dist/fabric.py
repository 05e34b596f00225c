"""ICIFabric: the device-mesh chunk fan-out inside the OSD data plane.

When an EC PG's acting OSDs are **co-resident** on one device mesh, the
primary does not host-encode and ship chunk bytes through the
messenger.  Instead:

* the primary stages the stripe-aligned logical segment onto the
  (stripe, shard) mesh and runs one mesh step (mesh_ec.MeshECCoder: K1
  per position, the partials XORed per stripe row).  That step is the
  reference's per-shard write fan-out (ref: src/osd/ECBackend.cc:
  2037-2070 — per-shard ECSubWrite construction + MOSDECSubOpWrite
  sends);
* the host messenger still carries the *control plane*: ECSubWrite
  messages shrink to metadata plus a `fabric_key` naming the staged
  device buffers;
* each acting shard resolves its `fabric_key` against the shared
  fabric and pulls ONLY its chunk slice from the device it co-resides
  with (`fetch_chunk`), writes it into its object store, and
  accumulates its own HashInfo crc locally.

Non-resident acting sets (or plugins without a plain matrix form —
clay sub-chunks, lrc layers, legacy mappings) fall back to the host
encode path transparently; the fabric is an accelerator, not a
correctness dependency.

The port of `ceph_tpu.dist.fabric`.  It reads an ec object only through
the plugin interface and `encode_matrix`, so it serves the port's
plugins and the reference's alike.  `ICIFabric()` spans every CUDA card
and raises without one; `devices=["cpu"] * n` runs it on the CPU.
"""
from __future__ import annotations

import numpy as np

from ..common.lockdep import make_lock
from .mesh_ec import MeshECCoder, cuda_devices, make_mesh


def _identity_mapping(ec) -> bool:
    n = ec.get_chunk_count()
    return all(ec.chunk_index(i) == i for i in range(n))


class ICIFabric:
    """Shared device-mesh coding fabric for co-resident OSD shards.

    One instance per process/host; daemons register residency at boot
    the way the reference's OSDs learn their NUMA/network locality.
    """

    def __init__(self, n_devices: int | None = None, devices=None):
        self.n_devices = n_devices
        self.devices = cuda_devices() if devices is None else list(devices)
        self.resident: set[int] = set()
        self._lock = make_lock("dist.fabric")
        #: serializes mesh launches and readbacks.  The fabric is driven
        #: by many daemon threads at once (the primary staging an
        #: encode, k+m shard OSDs each gathering their slice): one mesh
        #: step in flight at a time, completed on every device of the
        #: mesh before release — the device contract for a
        #: process-shared mesh (in the reference, two interleaved
        #: collectives deadlocked without it).
        self._dispatch = make_lock("dist.fabric.dispatch")
        self._coders: dict = {}       # (k, m, matrix bytes) -> coder
        self._meshes: dict = {}       # shard_ways-compat k -> mesh
        self._staged: dict = {}       # fabric_key -> staging record
        self.stats = {"staged": 0, "fetched": 0, "released": 0}

    # ------------------------------------------------------- residency
    def register_resident(self, osd_id: int) -> None:
        with self._lock:
            self.resident.add(osd_id)

    def covers(self, acting) -> bool:
        """All acting OSDs co-resident on this fabric's mesh."""
        return bool(acting) and all(
            a >= 0 and a in self.resident for a in acting)

    # -------------------------------------------------------- support
    def supports(self, ec) -> bool:
        """Plain matrix plugins with identity chunk mapping and no
        sub-chunks (the fabric step is one matrix product per
        position and an XOR)."""
        return (getattr(ec, "encode_matrix", None) is not None
                and ec.get_sub_chunk_count() == 1
                and _identity_mapping(ec))

    def _coder_for(self, ec) -> MeshECCoder:
        k = ec.get_data_chunk_count()
        m = ec.get_coding_chunk_count()
        mat = np.ascontiguousarray(ec.encode_matrix, dtype=np.uint8)
        key = (k, m, mat.tobytes())
        with self._lock:
            coder = self._coders.get(key)
            if coder is None:
                mesh = self._meshes.get(k)
                if mesh is None:
                    mesh = make_mesh(self.n_devices, k=k,
                                     devices=self.devices)
                    self._meshes[k] = mesh
                coder = MeshECCoder(k, m, mesh, encode_matrix=mat)
                self._coders[key] = coder
            return coder

    # --------------------------------------------------------- staging
    def stage_encode(self, key, ec, seg: bytes, chunk_size: int) -> int:
        """Run the mesh encode step for one write and stage the
        device-resident chunk arrays under `key`.

        Returns the per-shard chunk length.  `seg` must be
        stripe-aligned (primary guarantees it, as for the host path).
        """
        k = ec.get_data_chunk_count()
        m = ec.get_coding_chunk_count()
        width = k * chunk_size
        if not seg or len(seg) % width:
            raise ValueError("segment must be non-empty stripe-aligned")
        nstripes = len(seg) // width
        coder = self._coder_for(ec)
        arr = np.frombuffer(seg, dtype=np.uint8).reshape(
            nstripes, k, chunk_size)
        # pad the stripe batch to the mesh's stripe axis (zero stripes
        # encode to zero parity; fetch slices them back off)
        stripe_ways = coder.mesh.devices.shape[0]
        pad = -nstripes % stripe_ways
        if pad:
            arr = np.concatenate(
                [arr, np.zeros((pad, k, chunk_size), dtype=np.uint8)])
        with self._dispatch:
            # the blocking host->device copy stays outside the device
            # guard's region, which encode() opens around its launches
            data_dev = coder.shard_data(arr)
            parity_dev = coder.encode(data_dev)
            # complete before releasing the launch lock
            coder.mesh.synchronize()
        with self._lock:
            self._staged[key] = {
                "data": data_dev, "parity": parity_dev,
                "k": k, "m": m, "cs": chunk_size, "S": nstripes}
            self.stats["staged"] += 1
        return nstripes * chunk_size

    def fetch_chunk(self, key, shard: int) -> bytes:
        """One shard's chunk stream (concatenated over stripes) from
        the staged device arrays — the per-shard gather a co-resident
        OSD does instead of receiving bytes in the sub-write."""
        with self._lock:
            rec = self._staged.get(key)
            self.stats["fetched"] += 1
        if rec is None:
            raise KeyError(f"no staged write {key!r}")
        k = rec["k"]
        # a readback, serialized with every mesh launch (k+m shards fetch
        # at once) and outside every device-guard region: the guard's
        # sync mode is process-global, so inside one this legal readback
        # would raise
        with self._dispatch:
            if shard < k:
                sl = rec["data"].row(shard)
            else:
                sl = rec["parity"].row(shard - k)
        return np.ascontiguousarray(sl[:rec["S"]]).tobytes()

    def release(self, key) -> None:
        with self._lock:
            if self._staged.pop(key, None) is not None:
                self.stats["released"] += 1

    def staged_count(self) -> int:
        with self._lock:
            return len(self._staged)
