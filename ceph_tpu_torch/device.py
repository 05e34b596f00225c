"""Device selection and host-to-device staging for the port.

Every entry point of the port runs on the CUDA card unless its caller
asks for the CPU (`device="cpu"`, as the CPU tests do).  A missing card
is an error, never a quiet fall back to the CPU.

`as_u8` stages a batch with a plain (blocking) copy; `stage` copies the
small tables of an operator through pinned memory without a host sync,
so an operator can be built inside a region of the device guard.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """None -> cuda.  Raises when cuda is asked for and no card is
    present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_u8(x, device: torch.device) -> torch.Tensor:
    """numpy array, bytes-backed buffer or tensor -> contiguous uint8
    tensor on `device`.  A read-only numpy view (np.frombuffer over
    bytes) is shared without a copy on the CPU: the kernels and their
    plain versions never write their inputs."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {x.dtype}")
        return x.to(device).contiguous()
    a = np.ascontiguousarray(x, dtype=np.uint8)
    with warnings.catch_warnings():
        # torch warns on non-writable buffers; nothing here writes them
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    return t.to(device)


def stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device` with no host sync: on cuda a
    non-blocking copy from pinned memory on the current stream, the one
    the port's launches use (the pinned block is kept until the copy is
    done); on the CPU the array itself, shared."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
