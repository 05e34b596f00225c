"""devguard: the port's runtime device-contract sanitizer.

Two halves, both armed by ``CEPH_TPU_TORCH_DEVGUARD=1`` (read when the
module is imported) or by ``enable()``; when the guard is off every entry
point here is a no-op:

* **Transfer guarding.**  ``guard_transfers(device)`` wraps a kernel
  launch.  On a cuda region it sets ``torch.cuda.set_sync_debug_mode
  ("error")``, so a host<->device synchronisation inside (``.item()``,
  ``.cpu()``, a blocking copy of a host array, ``nonzero``) raises
  instead of silently stalling the launch path, and restores the
  previous mode when the outermost region ends (the mode is
  process-global, so open regions are counted under a lock).
  ``check_device`` makes every kernel wrapper refuse a tensor that is
  not already on its device.  Explicit staging before the region and
  the readback after it stay legal: the regions wrap launches only.
* **Compile accounting.**  Eager PyTorch compiles nothing behind the
  caller's back; what the port compiles is counted where it happens:
  each nvcc build and each library load in ``ec/kernels/_build.py``
  (one per source per process) and each ``RepairProgram`` compile in
  ``ec/repairc/cache.py`` (one per erasure signature and cache).
  Compiling a signature a site has already compiled, beyond the bound
  declared with ``set_recompile_bound`` (default 0), raises
  ``RecompileError``; ``stats()`` reports each site.

The counterpart of the reference package's ``common/jaxguard.py``.
"""
from __future__ import annotations

import contextlib
import os

import torch

from .lockdep import make_lock

__all__ = ["ENV", "enable", "disable", "enabled", "guard_transfers",
           "check_device", "count_compile", "set_recompile_bound", "stats",
           "reset", "DevGuardError", "RecompileError"]

ENV = "CEPH_TPU_TORCH_DEVGUARD"


class DevGuardError(RuntimeError):
    """A device-contract violation observed at run time."""


class RecompileError(DevGuardError):
    """A site compiled a signature it had already compiled, beyond its
    declared bound: the cache in front of the compiler is defeated."""


def _armed_by_env() -> bool:
    return os.environ.get(ENV, "").strip().lower() in ("1", "true", "yes",
                                                         "on")


_enabled = _armed_by_env()
_lock = make_lock("devguard.sites")
#: open cuda regions and the sync-debug mode to restore after the last
_open = 0
_saved_mode = 0
#: site -> {"compiles", "recompiles", "signatures": {sig: count}}
_sites: dict[str, dict] = {}
#: substring pattern -> allowed recompiles per signature
_bounds: dict[str, int] = {}


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop the compile counts and declared bounds."""
    with _lock:
        _sites.clear()
        _bounds.clear()


# ------------------------------------------------------ transfer guard

_OFF = contextlib.nullcontext()


def guard_transfers(device):
    """Around a launch on `device`: on cuda, a host<->device sync inside
    raises (torch's sync debug mode "error").  Off, or on the CPU, a
    shared null context."""
    if not _enabled or torch.device(device).type != "cuda":
        return _OFF
    return _cuda_region()


@contextlib.contextmanager
def _cuda_region():
    global _open, _saved_mode
    with _lock:
        if _open == 0:
            _saved_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1
            if _open == 0:
                torch.cuda.set_sync_debug_mode(_saved_mode)


def check_device(what: str, device, *tensors: torch.Tensor) -> None:
    """Raise DevGuardError when a tensor handed to kernel wrapper `what`
    is not on the wrapper's `device` (an index-less device matches any
    index of its type)."""
    if not _enabled:
        return
    dev = torch.device(device)
    for t in tensors:
        td = t.device
        if td.type != dev.type or (dev.index is not None and
                                   td.index != dev.index):
            raise DevGuardError(f"devguard: {what} was handed a tensor on "
                                f"{td}, its device is {dev}")


# -------------------------------------------------- compile accounting

def set_recompile_bound(pattern: str, bound: int) -> None:
    """Sites whose name contains `pattern` may compile an already
    compiled signature again up to `bound` times (default 0)."""
    with _lock:
        _bounds[pattern] = int(bound)


def _bound_for(site: str) -> int:
    return max((b for pat, b in _bounds.items() if pat in site), default=0)


def count_compile(site: str, signature: str) -> None:
    """Record one compile of `signature` at `site`; raise RecompileError
    when the site compiled it before more often than its bound."""
    if not _enabled:
        return
    with _lock:
        s = _sites.setdefault(site, {"compiles": 0, "recompiles": 0,
                                     "signatures": {}})
        s["compiles"] += 1
        seen = s["signatures"].get(signature, 0)
        s["signatures"][signature] = seen + 1
        if seen:
            s["recompiles"] += 1
        bound = _bound_for(site)
    if seen > bound:
        raise RecompileError(
            f"devguard: {site} compiled {signature!r} again (recompile "
            f"#{seen}, bound {bound}): the cache in front of it is "
            "defeated")


def stats() -> dict[str, dict]:
    """{site: {"compiles", "recompiles", "signatures"}} with the count of
    distinct signatures."""
    with _lock:
        return {site: {"compiles": s["compiles"],
                       "recompiles": s["recompiles"],
                       "signatures": len(s["signatures"])}
                for site, s in _sites.items()}
