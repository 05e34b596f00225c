"""Shared sizes for the benchmark's own tests: every cell scaled down to
a few small objects, run on the CPU with the port's plain versions."""
import pytest
import torch

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
CPU = torch.device("cpu")


def small(cell: spec.Cell, objects: int = 4, chunk: int = 256,
          calls: int = 4, sample: int = 8) -> dict:
    """Shape overrides: `objects` objects of k chunks of `chunk` bytes
    per call, `calls` calls' worth of working set, `sample` kept calls."""
    k = int(cell.config["profile"]["k"])
    return {"objects_per_call": objects, "object_bytes": k * chunk,
            "working_set_object_bytes": calls * objects * k * chunk,
            "check_sample_calls": sample}


@pytest.fixture(params=CELLS)
def cell(request) -> spec.Cell:
    return spec.resolve(request.param)
