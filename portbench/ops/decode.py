"""Degraded reads: each call rebuilds the erased chunks of its objects.

Timed entry: `ErasureCodeTpu.decode_batch_full(erasures, arrival)`,
arrival (objects, k + m, chunk) on the device with every chunk slot
present.  The stored coding chunks are made at set-up by the program's
own `encode_batch`.  Each call's erasure pattern is the next of a seeded
run of permutations of all C(k + m, e) patterns, so every pattern is
equally likely and every seed does the same set of work; the warm-up
is the first permutation, so it touches each pattern once.  A call
drawn for the check gets junk in its erased slots first (and its true
chunks back after), so a program that read an erased slot would show.
The reference rebuilds the sampled call's chunks from the object bytes
it makes again from the seed, through its own encode and its own
inverse of the survivors' submatrix.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench import reference
from portbench.work import gf_product
from portbench.workload import derive_seed, junk, object_batch


class Operation:
    def __init__(self, shape, seed, device, code, traffic):
        self.shape, self.seed, self.code = shape, seed, code
        n = shape.k + shape.m
        e = int(traffic["erasures"])
        self.patterns = [list(p) for p in itertools.combinations(range(n), e)]
        self._rng = np.random.default_rng(derive_seed(seed, 3))
        self._block, self._perm = -1, None
        self.batches = []
        for b in range(shape.batches):
            data = object_batch(seed, b, shape, device)
            arrival = torch.empty((shape.objects_per_call, n, shape.chunk),
                                  dtype=torch.uint8, device=device)
            arrival[:, :shape.k] = data
            arrival[:, shape.k:] = code.encode_batch(data)
            self.batches.append(arrival)
            del data
        self.junk = junk(seed, e, shape, device)
        self.saved = torch.empty_like(self.junk)
        self.warm_calls = len(self.patterns)
        self.work_per_call = gf_product(shape.objects_per_call, shape.k, e,
                                        shape.chunk)

    def pattern(self, i: int) -> list[int]:
        """Call i's pattern; calls come in order, so only the current
        permutation is kept."""
        block, pos = divmod(i, len(self.patterns))
        if block < self._block:
            raise ValueError("calls must come in order")
        while self._block < block:
            self._perm = self._rng.permutation(len(self.patterns))
            self._block += 1
        return self.patterns[self._perm[pos]]

    def submit(self, i: int, sampled: bool):
        b = i % len(self.batches)
        erasures = self.pattern(i)
        arrival = self.batches[b]
        if sampled:
            for j, e in enumerate(erasures):
                self.saved[:, j].copy_(arrival[:, e])
                arrival[:, e].copy_(self.junk[:, j])
        out = self.code.decode_batch_full(erasures, arrival)
        if sampled:
            for j, e in enumerate(erasures):
                arrival[:, e].copy_(self.saved[:, j])
        return out, (b, tuple(erasures))

    def expected(self, info, device):
        b, erasures = info
        s = self.shape
        data = object_batch(self.seed, b, s, device)
        return reference.rebuild(reference.generator(s.technique, s.k, s.m),
                                 data, list(erasures))

    def free(self) -> None:
        """Drop the program and the working set before the check."""
        self.batches.clear()
        self.junk = self.saved = self.code = None
