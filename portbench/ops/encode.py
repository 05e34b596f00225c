"""Full-object writes: each call encodes the data chunks of its objects.

Timed entry: `ErasureCodeTpu.encode_batch(data)`, data (objects, k,
chunk) on the device.  Calls cycle through the working set's batches in
order, so no call finds its input in the card's L2.  The reference works
out the coding chunks of a sampled call from the object bytes it makes
again from the seed.
"""
from __future__ import annotations

from portbench import reference
from portbench.work import gf_product
from portbench.workload import object_batch


class Operation:
    def __init__(self, shape, seed, device, code, traffic):
        self.shape, self.seed, self.code = shape, seed, code
        self.batches = [object_batch(seed, b, shape, device)
                        for b in range(shape.batches)]
        #: calls of the warm-up: one shape, a few rounds of the loop
        self.warm_calls = 2 * shape.calls_in_flight
        self.work_per_call = gf_product(shape.objects_per_call, shape.k,
                                        shape.m, shape.chunk)

    def submit(self, i: int, sampled: bool):
        b = i % len(self.batches)
        return self.code.encode_batch(self.batches[b]), (b,)

    def expected(self, info, device):
        (b,) = info
        s = self.shape
        data = object_batch(self.seed, b, s, device)
        return reference.encode(reference.generator(s.technique, s.k, s.m),
                                data)

    def free(self) -> None:
        """Drop the program and the working set before the check."""
        self.batches.clear()
        self.code = None
