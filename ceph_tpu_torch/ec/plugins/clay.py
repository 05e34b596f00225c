"""clay plugin: coupled-layer MSR regenerating code.

Faithful re-implementation of the reference clay plugin
(ref: src/erasure-code/clay/ErasureCodeClay.{h,cc}).  A Clay code wraps
a scalar MDS code (the `mds` sub-plugin, (k+nu)+m) whose codewords are
"coupled" across q^t sub-chunk planes via a pairwise (2,2) transform
(the `pft` sub-plugin): chunks carry sub-chunks, and repairing a single
lost chunk reads only q^(t-1) sub-chunk ranges from d helpers instead
of whole chunks — the MSR repair-bandwidth optimality that motivates
the code.

Structure mirrors the reference exactly:
- parse (:190-302): q = d-k+1, nu padding so q | (k+m+nu), t=(k+m+nu)/q,
  sub_chunk_no = q^t; mds profile k=k+nu, pft profile (2,2);
- encode = decode_layered with the parity chunks as erasures (:131);
- decode_layered (:648): per-plane intersection-score ordering,
  uncoupled-domain MDS decode, then pairwise recouple;
- repair (:400): single-lost-chunk path reading only the repair planes
  (get_repair_subchunks :364).

Buffers are numpy arrays; sub-chunk views are numpy slices, so the
"bufferlist substr_of" aliasing of the C++ (transform writes land in
the parent chunk) holds naturally.

The port's copy of `ceph_tpu.ec.plugins.clay`: the scalar MDS and the
pairwise transform are built through the port's registry on this
plugin's device; compiled repair runs there through K1.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from ..interface import (ErasureCode, ErasureCodeError, ErasureCodeProfile,
                         sanity_check_k_m, to_int)
from ..registry import ErasureCodePlugin


def pow_int(a: int, x: int) -> int:
    return a ** x


class ErasureCodeClay(ErasureCode):
    DEFAULT_K = "4"
    DEFAULT_M = "2"
    DEFAULT_W = "8"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.k = 0
        self.m = 0
        self.d = 0
        self.w = 8
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds = None           # scalar MDS over (k+nu, m)
        self.pft = None           # pairwise transform code (2, 2)
        self.U_buf: dict[int, np.ndarray] = {}

    # -- interface ----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, object_size: int) -> int:
        # ref: ErasureCodeClay.cc:90-96
        alignment_scalar = self.pft.get_chunk_size(1)
        alignment = self.sub_chunk_no * self.k * alignment_scalar
        padded = (object_size + alignment - 1) // alignment * alignment
        return padded // self.k

    # -- init ---------------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        from ..registry import ErasureCodePluginRegistry
        self.parse(profile)
        super().init(profile)
        registry = ErasureCodePluginRegistry.instance()
        self.mds = registry.factory(self.mds_profile["plugin"],
                                    self.mds_profile, self.device)
        self.pft = registry.factory(self.pft_profile["plugin"],
                                    self.pft_profile, self.device)

    def parse(self, profile: ErasureCodeProfile) -> None:
        """ref: ErasureCodeClay.cc:190-302."""
        super().parse(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, self.DEFAULT_M)
        sanity_check_k_m(self.k, self.m)
        self.d = to_int("d", profile, str(self.k + self.m - 1))
        scalar_mds = profile.get("scalar_mds") or "jerasure"
        if scalar_mds not in ("jerasure", "isa", "shec"):
            raise ErasureCodeError(
                f"scalar_mds {scalar_mds} is not currently supported, "
                "use one of 'jerasure', 'isa', 'shec'")
        technique = profile.get("technique") or ""
        if not technique:
            technique = "reed_sol_van" if scalar_mds in ("jerasure", "isa") \
                else "single"
        allowed = {
            "jerasure": ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                         "cauchy_good", "liber8tion"),
            "isa": ("reed_sol_van", "cauchy"),
            "shec": ("single", "multiple"),
        }[scalar_mds]
        if technique not in allowed:
            raise ErasureCodeError(
                f"technique {technique} is not currently supported with "
                f"scalar_mds {scalar_mds}, use one of {allowed}")
        if self.d < self.k or self.d > self.k + self.m - 1:
            raise ErasureCodeError(
                f"value of d {self.d} must be within "
                f"[{self.k},{self.k + self.m - 1}]")
        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) \
            if (self.k + self.m) % self.q else 0
        if self.k + self.m + self.nu > 254:
            raise ErasureCodeError("k+m+nu must be <= 254")
        self.mds_profile = {"plugin": scalar_mds, "technique": technique,
                            "k": str(self.k + self.nu), "m": str(self.m),
                            "w": "8"}
        self.pft_profile = {"plugin": scalar_mds, "technique": technique,
                            "k": "2", "m": "2", "w": "8"}
        if scalar_mds == "shec":
            self.mds_profile["c"] = "2"
            self.pft_profile["c"] = "2"
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = pow_int(self.q, self.t)

    # -- plane helpers ------------------------------------------------------
    def get_plane_vector(self, z: int) -> list[int]:
        """Base-q digits of z (ref: ErasureCodeClay.cc:886-892)."""
        z_vec = [0] * self.t
        for i in range(self.t):
            z_vec[self.t - 1 - i] = z % self.q
            z = (z - z_vec[self.t - 1 - i]) // self.q
        return z_vec

    def get_max_iscore(self, erased_chunks: set) -> int:
        weight_vec = [0] * self.t
        iscore = 0
        for i in erased_chunks:
            if weight_vec[i // self.q] == 0:
                weight_vec[i // self.q] = 1
                iscore += 1
        return iscore

    def set_planes_sequential_decoding_order(self, erasures: set
                                             ) -> list[int]:
        order = [0] * self.sub_chunk_no
        for z in range(self.sub_chunk_no):
            z_vec = self.get_plane_vector(z)
            for i in erasures:
                if i % self.q == z_vec[i // self.q]:
                    order[z] += 1
        return order

    def _ensure_U(self, size: int) -> None:
        for i in range(self.q * self.t):
            if i not in self.U_buf or self.U_buf[i].size != size:
                self.U_buf[i] = np.zeros(size, dtype=np.uint8)

    # -- repair predicates ---------------------------------------------------
    def is_repair(self, want_to_read: set, available_chunks: set) -> bool:
        """ref: ErasureCodeClay.cc:304-324."""
        if set(want_to_read) <= set(available_chunks):
            return False
        if len(want_to_read) > 1:
            return False
        i = next(iter(want_to_read))
        lost_node_id = i if i < self.k else i + self.nu
        for x in range(self.q):
            node = (lost_node_id // self.q) * self.q + x
            node = node if node < self.k else node - self.nu
            if node != i and node not in available_chunks:
                return False
        if len(available_chunks) < self.d:
            return False
        return True

    def get_repair_subchunks(self, lost_node: int
                             ) -> list[tuple[int, int]]:
        """ref: ErasureCodeClay.cc:364-378."""
        y_lost = lost_node // self.q
        x_lost = lost_node % self.q
        seq_sc_count = pow_int(self.q, self.t - 1 - y_lost)
        num_seq = pow_int(self.q, y_lost)
        out = []
        index = x_lost * seq_sc_count
        for _ in range(num_seq):
            out.append((index, seq_sc_count))
            index += self.q * seq_sc_count
        return out

    def get_repair_sub_chunk_count(self, want_to_read: set) -> int:
        """ref: ErasureCodeClay.cc:380-396."""
        weight_vector = [0] * self.t
        for to_read in want_to_read:
            weight_vector[to_read // self.q] += 1
        cnt = 1
        for y in range(self.t):
            cnt *= self.q - weight_vector[y]
        return self.sub_chunk_no - cnt

    # -- minimum_to_decode ---------------------------------------------------
    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        """ref: ErasureCodeClay.cc:98-106.  Extended past the
        reference: when `want_to_read` spans multiple shards but only
        ONE of them is erased, the lost shard still repairs from
        sub-chunk planes — the wanted survivors are whole-chunk reads
        and the erased one keeps the d-helper repair plan, instead of
        silently falling through to a k-full-chunk decode."""
        want_to_read = set(want_to_read)
        available = set(available)
        if self.is_repair(want_to_read, available):
            return self.minimum_to_repair(want_to_read, available)
        erased = want_to_read - available
        if len(erased) == 1 and self.is_repair(erased, available):
            minimum = self.minimum_to_repair(erased, available)
            for c in want_to_read & available:
                minimum[c] = [(0, self.sub_chunk_no)]
            return minimum
        return super().minimum_to_decode(want_to_read, available)

    def repair_schedule(self, erasures: set, available: set):
        """Single-erasure regenerating plan: d helpers each shipping
        the q^(t-1)-of-q^t repair planes of minimum_to_repair."""
        erasures = set(erasures)
        available = set(available) - erasures
        if not self.is_repair(erasures, available):
            return None
        from ..repairc import RepairPlan
        minimum = self.minimum_to_repair(erasures, available)
        return RepairPlan.make(erasures, minimum,
                               sub_chunk_no=self.sub_chunk_no)

    def minimum_to_repair(self, want_to_read: set, available_chunks: set
                          ) -> dict[int, list[tuple[int, int]]]:
        """ref: ErasureCodeClay.cc:326-362."""
        i = next(iter(want_to_read))
        lost_node_index = i if i < self.k else i + self.nu
        minimum: dict[int, list[tuple[int, int]]] = {}
        sub_chunk_ind = self.get_repair_subchunks(lost_node_index)
        if len(available_chunks) < self.d:
            raise ErasureCodeError("minimum_to_repair: not enough chunks")
        for j in range(self.q):
            if j != lost_node_index % self.q:
                rep = (lost_node_index // self.q) * self.q + j
                if rep < self.k:
                    minimum[rep] = list(sub_chunk_ind)
                elif rep >= self.k + self.nu:
                    minimum[rep - self.nu] = list(sub_chunk_ind)
        for chunk in sorted(available_chunks):
            if len(minimum) >= self.d:
                break
            if chunk not in minimum:
                minimum[chunk] = list(sub_chunk_ind)
        assert len(minimum) == self.d
        return minimum

    # -- encode / decode -----------------------------------------------------
    def encode_chunks(self, want_to_encode: Iterable[int],
                      encoded: dict[int, np.ndarray]) -> None:
        """ref: ErasureCodeClay.cc:131-158."""
        k, m, nu = self.k, self.m, self.nu
        chunk_size = len(encoded[0])
        chunks: dict[int, np.ndarray] = {}
        parity_chunks = set()
        for i in range(k + m):
            if i < k:
                chunks[i] = encoded[i]
            else:
                chunks[i + nu] = encoded[i]
                parity_chunks.add(i + nu)
        for i in range(k, k + nu):
            chunks[i] = np.zeros(chunk_size, dtype=np.uint8)
        self.decode_layered(set(parity_chunks), chunks)

    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, np.ndarray], chunk_size: int = 0
               ) -> dict[int, np.ndarray]:
        """Repair path for single-chunk loss with partial (repair-plane)
        reads (ref: ErasureCodeClay.cc:108-126)."""
        want = set(want_to_read)
        chunks = {i: np.asarray(c, dtype=np.uint8)
                  for i, c in chunks.items()}
        avail = set(chunks)
        first_len = len(next(iter(chunks.values()))) if chunks else 0
        if self.is_repair(want, avail) and chunk_size > first_len:
            return self.repair(want, chunks, chunk_size)
        erased = want - avail
        if (chunk_size and len(erased) == 1 and len(want) > 1
                and self.is_repair(erased, avail)
                and all(len(chunks[i]) == chunk_size
                        for i in want & avail)):
            out = self._decode_one_erased(erased, chunks, chunk_size)
            if out is not None:
                out.update({i: chunks[i] for i in want & avail})
                return {i: out[i] for i in want}
        return self._decode(want, chunks)

    def _decode_one_erased(self, erased: set,
                           chunks: Mapping[int, np.ndarray],
                           chunk_size: int):
        """Companion to the extended minimum_to_decode: rebuild the one
        erased chunk from its d helpers' repair planes.  Helpers read
        whole (because they were also wanted) are sliced down to their
        repair planes; helpers that shipped only planes pass through.
        None when buffers fit neither shape (caller falls back)."""
        lost = next(iter(erased))
        lost_node = lost if lost < self.k else lost + self.nu
        ssz = chunk_size // self.sub_chunk_no
        ext = [(o * ssz, c * ssz)
               for o, c in self.get_repair_subchunks(lost_node)]
        rb = sum(length for _, length in ext)
        helpers = {}
        for h in self.minimum_to_repair(erased, set(chunks)):
            buf = chunks[h]
            if len(buf) == chunk_size:
                helpers[h] = np.concatenate(
                    [buf[o:o + length] for o, length in ext])
            elif len(buf) == rb:
                helpers[h] = buf
            else:
                return None
        return self.repair(erased, helpers, chunk_size)

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        """ref: ErasureCodeClay.cc:160-188."""
        k, m, nu = self.k, self.m, self.nu
        erasures = set()
        coded_chunks: dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i not in chunks:
                erasures.add(i if i < k else i + nu)
            coded_chunks[i if i < k else i + nu] = decoded[i]
        chunk_size = len(coded_chunks[0])
        for i in range(k, k + nu):
            coded_chunks[i] = np.zeros(chunk_size, dtype=np.uint8)
        self.decode_layered(erasures, coded_chunks)

    # -- layered decode core -------------------------------------------------
    def decode_layered(self, erased_chunks: set,
                       chunks: dict[int, np.ndarray]) -> None:
        """ref: ErasureCodeClay.cc:648-711."""
        q, t, m = self.q, self.t, self.m
        num_erasures = len(erased_chunks)
        size = len(chunks[0])
        assert size % self.sub_chunk_no == 0
        sc_size = size // self.sub_chunk_no
        assert num_erasures > 0
        i = self.k + self.nu
        while num_erasures < m and i < q * t:
            if i not in erased_chunks:
                erased_chunks.add(i)
                num_erasures += 1
            i += 1
        assert num_erasures == m
        max_iscore = self.get_max_iscore(erased_chunks)
        self._ensure_U(size)
        order = self.set_planes_sequential_decoding_order(erased_chunks)
        for iscore in range(max_iscore + 1):
            for z in range(self.sub_chunk_no):
                if order[z] == iscore:
                    self.decode_erasures(erased_chunks, z, chunks, sc_size)
            for z in range(self.sub_chunk_no):
                if order[z] != iscore:
                    continue
                z_vec = self.get_plane_vector(z)
                for node_xy in sorted(erased_chunks):
                    x = node_xy % q
                    y = node_xy // q
                    node_sw = y * q + z_vec[y]
                    if z_vec[y] != x:
                        if node_sw not in erased_chunks:
                            self.recover_type1_erasure(
                                chunks, x, y, z, z_vec, sc_size)
                        elif z_vec[y] < x:
                            self.get_coupled_from_uncoupled(
                                chunks, x, y, z, z_vec, sc_size)
                    else:
                        chunks[node_xy][z * sc_size:(z + 1) * sc_size] = \
                            self.U_buf[node_xy][z * sc_size:(z + 1) * sc_size]

    def decode_erasures(self, erased_chunks: set, z: int,
                        chunks: dict[int, np.ndarray], sc_size: int) -> None:
        """ref: ErasureCodeClay.cc:713-739."""
        q, t = self.q, self.t
        z_vec = self.get_plane_vector(z)
        for x in range(q):
            for y in range(t):
                node_xy = q * y + x
                node_sw = q * y + z_vec[y]
                if node_xy in erased_chunks:
                    continue
                if z_vec[y] < x:
                    self.get_uncoupled_from_coupled(
                        chunks, x, y, z, z_vec, sc_size)
                elif z_vec[y] == x:
                    self.U_buf[node_xy][z * sc_size:(z + 1) * sc_size] = \
                        chunks[node_xy][z * sc_size:(z + 1) * sc_size]
                else:
                    if node_sw in erased_chunks:
                        self.get_uncoupled_from_coupled(
                            chunks, x, y, z, z_vec, sc_size)
        self.decode_uncoupled(erased_chunks, z, sc_size)

    def decode_uncoupled(self, erased_chunks: set, z: int,
                         sc_size: int) -> None:
        """MDS decode in the uncoupled domain
        (ref: ErasureCodeClay.cc:741-758)."""
        known = {}
        all_sub = {}
        for i in range(self.q * self.t):
            view = self.U_buf[i][z * sc_size:(z + 1) * sc_size]
            all_sub[i] = view
            if i not in erased_chunks:
                known[i] = view
        self.mds.decode_chunks(erased_chunks, known, all_sub)

    def recover_type1_erasure(self, chunks, x, y, z, z_vec,
                              sc_size) -> None:
        """ref: ErasureCodeClay.cc:773-807."""
        q, t = self.q, self.t
        node_xy = y * q + x
        node_sw = y * q + z_vec[y]
        z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
        i0, i1, i2, i3 = (0, 1, 2, 3) if z_vec[y] < x else (1, 0, 3, 2)
        scratch = np.zeros(sc_size, dtype=np.uint8)
        pft_sub = {
            i0: chunks[node_xy][z * sc_size:(z + 1) * sc_size],
            i1: chunks[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size],
            i2: self.U_buf[node_xy][z * sc_size:(z + 1) * sc_size],
            i3: scratch,
        }
        known = {i1: pft_sub[i1], i2: pft_sub[i2]}
        self.pft.decode_chunks({i0}, known, pft_sub)

    def get_coupled_from_uncoupled(self, chunks, x, y, z, z_vec,
                                   sc_size) -> None:
        """ref: ErasureCodeClay.cc:809-833."""
        q, t = self.q, self.t
        node_xy = y * q + x
        node_sw = y * q + z_vec[y]
        z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
        assert z_vec[y] < x
        uncoupled = {
            2: self.U_buf[node_xy][z * sc_size:(z + 1) * sc_size],
            3: self.U_buf[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size],
        }
        pft_sub = {
            0: chunks[node_xy][z * sc_size:(z + 1) * sc_size],
            1: chunks[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size],
            2: uncoupled[2],
            3: uncoupled[3],
        }
        self.pft.decode_chunks({0, 1}, uncoupled, pft_sub)

    def get_uncoupled_from_coupled(self, chunks, x, y, z, z_vec,
                                   sc_size) -> None:
        """ref: ErasureCodeClay.cc:835-865."""
        q, t = self.q, self.t
        node_xy = y * q + x
        node_sw = y * q + z_vec[y]
        z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
        i0, i1, i2, i3 = (0, 1, 2, 3) if z_vec[y] < x else (1, 0, 3, 2)
        coupled = {
            i0: chunks[node_xy][z * sc_size:(z + 1) * sc_size],
            i1: chunks[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size],
        }
        pft_sub = {
            0: coupled[0],
            1: coupled[1],
            i2: self.U_buf[node_xy][z * sc_size:(z + 1) * sc_size],
            i3: self.U_buf[node_sw][z_sw * sc_size:(z_sw + 1) * sc_size],
        }
        self.pft.decode_chunks({2, 3}, coupled, pft_sub)

    # -- single-chunk repair -------------------------------------------------
    def repair(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
               chunk_size: int) -> dict[int, np.ndarray]:
        """ref: ErasureCodeClay.cc:400-460."""
        assert len(want_to_read) == 1 and len(chunks) == self.d
        k, m, nu = self.k, self.m, self.nu
        # note: the reference passes the ORIGINAL chunk ids here (no nu
        # shift), ErasureCodeClay.cc:405
        repair_sub_chunk_no = self.get_repair_sub_chunk_count(
            set(want_to_read))
        repair_blocksize = len(next(iter(chunks.values())))
        assert repair_blocksize % repair_sub_chunk_no == 0
        sub_chunksize = repair_blocksize // repair_sub_chunk_no
        chunksize = self.sub_chunk_no * sub_chunksize
        assert chunksize == chunk_size

        recovered_data: dict[int, np.ndarray] = {}
        helper_data: dict[int, np.ndarray] = {}
        aloof_nodes: set = set()
        repaired: dict[int, np.ndarray] = {}
        repair_sub_chunks_ind: list[tuple[int, int]] = []
        lost = next(iter(want_to_read))
        for i in range(k + m):
            if i in chunks:
                helper_data[i if i < k else i + nu] = chunks[i]
            elif i != lost:
                aloof_nodes.add(i if i < k else i + nu)
            else:
                lost_node_id = i if i < k else i + nu
                repaired[i] = np.zeros(chunksize, dtype=np.uint8)
                recovered_data[lost_node_id] = repaired[i]
                repair_sub_chunks_ind = self.get_repair_subchunks(
                    lost_node_id)
        for i in range(k, k + nu):
            helper_data[i] = np.zeros(repair_blocksize, dtype=np.uint8)
        assert len(helper_data) + len(aloof_nodes) + len(recovered_data) \
            == self.q * self.t
        self.repair_one_lost_chunk(recovered_data, aloof_nodes,
                                   helper_data, repair_blocksize,
                                   repair_sub_chunks_ind)
        return repaired

    def repair_one_lost_chunk(self, recovered_data, aloof_nodes,
                              helper_data, repair_blocksize,
                              repair_sub_chunks_ind) -> None:
        """ref: ErasureCodeClay.cc:462-645."""
        q, t = self.q, self.t
        repair_subchunks = self.sub_chunk_no // q
        sub_chunksize = repair_blocksize // repair_subchunks

        ordered_planes: dict[int, list[int]] = {}
        repair_plane_to_ind: dict[int, int] = {}
        plane_ind = 0
        for index, count in repair_sub_chunks_ind:
            for j in range(index, index + count):
                z_vec = self.get_plane_vector(j)
                order = 0
                for node in recovered_data:
                    if node % q == z_vec[node // q]:
                        order += 1
                for node in aloof_nodes:
                    if node % q == z_vec[node // q]:
                        order += 1
                assert order > 0
                ordered_planes.setdefault(order, []).append(j)
                repair_plane_to_ind[j] = plane_ind
                plane_ind += 1
        assert plane_ind == repair_subchunks

        self._ensure_U(self.sub_chunk_no * sub_chunksize)
        temp_buf = np.zeros(sub_chunksize, dtype=np.uint8)

        assert len(recovered_data) == 1
        lost_chunk = next(iter(recovered_data))
        erasures = {lost_chunk - lost_chunk % q + i for i in range(q)}
        erasures |= aloof_nodes

        order = 1
        while order in ordered_planes:
            for z in sorted(ordered_planes[order]):
                z_vec = self.get_plane_vector(z)
                # fill U for all non-erased nodes at plane z
                for y in range(t):
                    for x in range(q):
                        node_xy = y * q + x
                        if node_xy in erasures:
                            continue
                        z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
                        node_sw = y * q + z_vec[y]
                        i0, i1, i2, i3 = (0, 1, 2, 3) if z_vec[y] <= x \
                            else (1, 0, 3, 2)
                        U_xy = self.U_buf[node_xy]
                        if node_sw in aloof_nodes:
                            known = {
                                i0: helper_data[node_xy][
                                    repair_plane_to_ind[z] * sub_chunksize:
                                    (repair_plane_to_ind[z] + 1)
                                    * sub_chunksize],
                                i3: self.U_buf[node_sw][
                                    z_sw * sub_chunksize:
                                    (z_sw + 1) * sub_chunksize],
                            }
                            pft_sub = {
                                i0: known[i0], i1: temp_buf,
                                i2: U_xy[z * sub_chunksize:
                                         (z + 1) * sub_chunksize],
                                i3: known[i3],
                            }
                            self.pft.decode_chunks({i2}, known, pft_sub)
                        elif z_vec[y] != x:
                            known = {
                                i0: helper_data[node_xy][
                                    repair_plane_to_ind[z] * sub_chunksize:
                                    (repair_plane_to_ind[z] + 1)
                                    * sub_chunksize],
                                i1: helper_data[node_sw][
                                    repair_plane_to_ind[z_sw]
                                    * sub_chunksize:
                                    (repair_plane_to_ind[z_sw] + 1)
                                    * sub_chunksize],
                            }
                            pft_sub = {
                                i0: known[i0], i1: known[i1],
                                i2: U_xy[z * sub_chunksize:
                                         (z + 1) * sub_chunksize],
                                i3: temp_buf[:sub_chunksize],
                            }
                            self.pft.decode_chunks({i2}, known, pft_sub)
                        else:
                            U_xy[z * sub_chunksize:(z + 1) * sub_chunksize] \
                                = helper_data[node_xy][
                                    repair_plane_to_ind[z] * sub_chunksize:
                                    (repair_plane_to_ind[z] + 1)
                                    * sub_chunksize]
                assert len(erasures) <= self.m
                self.decode_uncoupled(erasures, z, sub_chunksize)
                for i in sorted(erasures):
                    x = i % q
                    y = i // q
                    node_sw = y * q + z_vec[y]
                    z_sw = z + (x - z_vec[y]) * pow_int(q, t - 1 - y)
                    i0, i1, i2, i3 = (0, 1, 2, 3) if z_vec[y] <= x \
                        else (1, 0, 3, 2)
                    if i in aloof_nodes:
                        continue
                    if x == z_vec[y]:  # hole-dot pair (type 0)
                        recovered_data[i][
                            z * sub_chunksize:(z + 1) * sub_chunksize] = \
                            self.U_buf[i][z * sub_chunksize:
                                          (z + 1) * sub_chunksize]
                    else:
                        assert y == lost_chunk // q
                        assert node_sw == lost_chunk
                        known = {
                            i0: helper_data[i][
                                repair_plane_to_ind[z] * sub_chunksize:
                                (repair_plane_to_ind[z] + 1)
                                * sub_chunksize],
                            i2: self.U_buf[i][z * sub_chunksize:
                                              (z + 1) * sub_chunksize],
                        }
                        pft_sub = {
                            i0: known[i0],
                            i1: recovered_data[node_sw][
                                z_sw * sub_chunksize:
                                (z_sw + 1) * sub_chunksize],
                            i2: known[i2],
                            i3: temp_buf,
                        }
                        self.pft.decode_chunks({i1}, known, pft_sub)
            order += 1


PLUGIN = ErasureCodePlugin("clay", ErasureCodeClay)
