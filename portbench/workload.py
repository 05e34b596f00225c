"""The general generator: a cell's shapes and its object bytes from the seed.

A configuration gives the code (`profile`), the object size and, under
`assumed`, the objects per call, the calls in flight and the working
set; a traffic mix gives the operation and its parameters.  The object
bytes of batch b are made on the device by one `torch.Generator` call
seeded from (seed, b), so the reference can make them again after the
run instead of reading what the program may have touched.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

ALIGNMENT = 32  # the tpu plugin's chunk alignment (EC_TPU_DEFAULT_ALIGNMENT)


def derive_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([int(seed), *salt])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass(frozen=True)
class Shape:
    technique: str
    k: int
    m: int
    object_bytes: int
    objects_per_call: int
    calls_in_flight: int
    batches: int
    check_sample_calls: int

    @property
    def chunk(self) -> int:
        return self.object_bytes // self.k

    @property
    def call_bytes(self) -> int:
        """Object bytes one call serves."""
        return self.objects_per_call * self.object_bytes

    @classmethod
    def of(cls, config: dict, traffic: dict, **overrides) -> "Shape":
        """The shape a cell runs at; `overrides` (objects_per_call,
        object_bytes, working_set_object_bytes, check_sample_calls) scale
        it down for tests on the CPU."""
        assumed = config["assumed"]
        profile = config["profile"]
        objects = overrides.get("objects_per_call",
                                assumed["objects_per_call"])
        obj = overrides.get("object_bytes", config["object_bytes"])
        ws = overrides.get("working_set_object_bytes",
                           assumed["working_set_object_bytes"])
        k = int(profile["k"])
        if obj % (k * ALIGNMENT):
            raise ValueError(f"object size {obj} is not k x {ALIGNMENT} "
                             "aligned: chunks would be padded")
        batches = ws // (objects * obj)
        if batches < 1:
            raise ValueError("working set smaller than one call")
        return cls(technique=profile["technique"], k=k, m=int(profile["m"]),
                   object_bytes=obj, objects_per_call=objects,
                   calls_in_flight=int(assumed["calls_in_flight"]),
                   batches=int(batches),
                   check_sample_calls=int(overrides.get(
                       "check_sample_calls", traffic["check_sample_calls"])))


def object_batch(seed: int, b: int, shape: Shape,
                 device: torch.device) -> torch.Tensor:
    """Batch b's objects as (objects, k, chunk) uint8 data chunks: each
    object's bytes in order, cut into its k chunks."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, 1, b))
    return torch.randint(0, 256, (shape.objects_per_call, shape.k,
                                  shape.chunk),
                         dtype=torch.uint8, generator=g, device=device)


def junk(seed: int, rows: int, shape: Shape,
         device: torch.device) -> torch.Tensor:
    """Bytes that stand in erased slots: (objects, rows, chunk)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, 2))
    return torch.randint(0, 256, (shape.objects_per_call, rows, shape.chunk),
                         dtype=torch.uint8, generator=g, device=device)
