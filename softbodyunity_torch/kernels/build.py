"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds into ``build/kernels/lib<name>_<hash>.so`` at the
repository root.  The hash covers the sources and the flags, so a stale
library never loads.  A missing ``nvcc`` or a failed compile raises; nothing
falls back to another path.  The wrapper of each kernel declares the
``argtypes`` of its functions.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills, into the log
)


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of the sources
    (the .cu and every shared .cuh) and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_libraries(names) -> None:
    """Build every named library that does not exist yet, one nvcc per
    source, all started together, then load them."""
    with concurrent.futures.ThreadPoolExecutor(max(len(names), 1)) as pool:
        list(pool.map(load_library, names))


_build_locks: dict = {}
_build_locks_guard = threading.Lock()


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless its library exists, then load it.
    nvcc's messages (ptxas register and spill counts) go to a ``.log`` file
    beside the library.  Safe from several threads (the halo paths' ranks
    of ``parallel/ring.py::LocalRing``): one build of a library at a time,
    and each library loaded once."""
    with _build_locks_guard:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        return _load_library(name)


def check_launch(err: int, what: str, error_string) -> None:
    """Raise on a nonzero ``cudaError_t`` from a launch, with its string."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({error_string(err).decode()})")


@functools.cache
def _load_library(name: str) -> ctypes.CDLL:
    out = library_path(name)
    if not out.exists():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    return ctypes.CDLL(str(out))
