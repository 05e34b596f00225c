"""Build and bind the port's CUDA kernels.

Each source under a `kernels/csrc/` directory of the port (`ec/` and
`crush/`; a name resolves to the one source of that name) is compiled with
`nvcc` into a shared library with a plain C interface and loaded with
ctypes: no PyTorch headers, so a
build takes seconds.  Libraries go to `ceph_tpu_torch/_build/`, named by
a digest of the source and flags, and are built at first use.  The
compiler's output (ptxas's register and stack-frame report) is kept
beside each library, so it can be read back for a cached build too.  A
failed build raises; nothing falls back to the plain versions.  Under the
device guard (common/devguard.py) each nvcc run and each library load
counts as one compile of its library: a second one in a process raises.
Processes that build at once (daemons started together) take a file
lock per source, so one runs nvcc and the others load its library.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ...common import devguard

PORT = Path(__file__).resolve().parents[2]
CSRC = PORT / "ec" / "kernels" / "csrc"
CSRC_DIRS = (CSRC, PORT / "crush" / "kernels" / "csrc")
BUILD_DIR = PORT / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def source(name: str) -> Path:
    """The one `{name}.cu` under the port's source directories."""
    found = [d / f"{name}.cu" for d in CSRC_DIRS if (d / f"{name}.cu").is_file()]
    if len(found) != 1:
        raise FileNotFoundError(
            f"{name}.cu: expected one source under {CSRC_DIRS}, found {found}")
    return found[0]


def lib_path(name: str) -> Path:
    src = source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """Where the compiler output of `name`'s current library is kept."""
    return lib_path(name).with_suffix(".log")


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for `name` unless its library and log are already
    built."""
    out = lib_path(name)
    if out.exists() and log_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


@contextlib.contextmanager
def _file_locks(names):
    """Hold an exclusive file lock per source (taken in sorted order)
    across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        for name in sorted(set(names)):
            f = stack.enter_context(open(BUILD_DIR / f".{name}.lock", "a"))
            fcntl.flock(f, fcntl.LOCK_EX)
            stack.callback(fcntl.flock, f, fcntl.LOCK_UN)
        yield


def build(*names: str) -> dict[str, str]:
    """Compile every named source that is not built yet, all nvcc
    processes at once.  Returns {name: compiler output} for every name,
    read back from the kept log where the library was already built."""
    with _file_locks(names):
        started = {n: _start(n) for n in names}
        for name, job in started.items():
            if job is None:
                continue
            out, tmp, proc = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            log_tmp = log_path(name).with_suffix(f".{os.getpid()}.logtmp")
            log_tmp.write_text(log)
            os.replace(log_tmp, log_path(name))
            os.replace(tmp, out)
            devguard.count_compile(f"nvcc:{name}", out.name)
        return {n: log_path(n).read_text() for n in names}


def load(name: str) -> ctypes.CDLL:
    """The bound library for `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            path = lib_path(name)
            lib = _libs[name] = ctypes.CDLL(str(path))
            devguard.count_compile(f"load:{name}", path.name)
        return lib
