"""RepairPlan: one erasure signature's read/rebuild schedule.

A plan is the *what* of a repair — which shards are lost, which
helpers serve bytes and which sub-chunk ranges of each — normalized
into a hashable value whose string signature keys the compiled-program
cache.  Extents are in SUB-CHUNK units (the plugin's native repair
granularity, ref: ErasureCodeClay.cc:364 get_repair_subchunks); the
OSD scales them to bytes against the pool's chunk size, so one plan
(and one compiled program) serves every object and chunk size of the
profile.

The port's copy of `ceph_tpu.ec.repairc.plan`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping


def _norm_extents(extents: Iterable[tuple[int, int]]
                  ) -> tuple[tuple[int, int], ...]:
    out = tuple((int(o), int(c)) for o, c in extents)
    if not out or any(c <= 0 or o < 0 for o, c in out):
        raise ValueError(f"bad repair extents {out!r}")
    return out


@dataclass(frozen=True)
class RepairPlan:
    """Read/rebuild schedule for one erasure signature.

    lost:     shards to rebuild, sorted.
    helpers:  ((shard, ((sub_off, count), ...)), ...) sorted by shard —
              each helper ships exactly those sub-chunk ranges of its
              chunk, per stripe.
    sub_chunk_no: the code's sub-chunk granularity (1 for MDS/LRC
              full-chunk helpers, q^t for clay).
    """
    lost: tuple[int, ...]
    helpers: tuple[tuple[int, tuple[tuple[int, int], ...]], ...]
    sub_chunk_no: int

    @classmethod
    def make(cls, lost: Iterable[int],
             helpers: Mapping[int, Iterable[tuple[int, int]]],
             sub_chunk_no: int) -> "RepairPlan":
        lost_t = tuple(sorted(set(int(i) for i in lost)))
        help_t = tuple(sorted(
            (int(h), _norm_extents(ext)) for h, ext in helpers.items()))
        if not lost_t or not help_t:
            raise ValueError("repair plan needs lost shards and helpers")
        if set(lost_t) & {h for h, _ in help_t}:
            raise ValueError("a lost shard cannot be its own helper")
        return cls(lost_t, help_t, int(sub_chunk_no))

    # ------------------------------------------------------------ shape
    def helper_ids(self) -> list[int]:
        return [h for h, _ in self.helpers]

    def planes_of(self, shard: int) -> int:
        """Sub-chunk planes this helper contributes per stripe."""
        for h, ext in self.helpers:
            if h == shard:
                return sum(c for _, c in ext)
        raise KeyError(shard)

    def total_planes(self) -> int:
        """Gathered input planes per stripe (the matmul contraction)."""
        return sum(sum(c for _, c in ext) for _, ext in self.helpers)

    def output_planes(self) -> int:
        """Rebuilt planes per stripe: every lost shard comes back
        whole (all sub-chunks)."""
        return len(self.lost) * self.sub_chunk_no

    def read_fraction(self, k: int) -> float:
        """Helper bytes read / the k-full-chunk baseline (the l/k or
        clay d/(k*q) saving the recovery_bytes gates assert)."""
        return self.total_planes() / (k * self.sub_chunk_no)

    # ------------------------------------------------------- byte space
    def byte_extents(self, chunk_size: int) -> dict[int,
                                                    list[tuple[int, int]]]:
        """Per-helper byte extents WITHIN ONE CHUNK of `chunk_size`."""
        if chunk_size % self.sub_chunk_no:
            raise ValueError("chunk size not sub-chunk aligned")
        ssz = chunk_size // self.sub_chunk_no
        return {h: [(o * ssz, c * ssz) for o, c in ext]
                for h, ext in self.helpers}

    # -------------------------------------------------------- signature
    def signature(self) -> str:
        """Cache key, same spirit as matrix_code.erasure_signature's
        "+r..-e.." strings, extended with each helper's extents."""
        lost = "".join(f"-{e}" for e in self.lost)
        helps = "".join(
            f"+{h}@" + ",".join(f"{o}:{c}" for o, c in ext)
            for h, ext in self.helpers)
        return f"{lost}{helps}/{self.sub_chunk_no}"
