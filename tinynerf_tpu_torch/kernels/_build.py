"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on first use into a shared library with a
plain C interface, under build/tinynerf_tpu_torch/ at the repository
root. The library's name carries a hash of the source, the shared
headers (csrc/*.cuh) and the flags, so an edited source or header
builds anew and a stale library is never loaded. The
compiler's output (ptxas register and shared-memory counts) is kept
beside the library as a .log file.

Nothing here runs at import time: the CPU-only test environment has no
nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tinynerf_tpu_torch"
# sm_90a (not sm_90) keeps wgmma/setmaxnreg available to later kernels.
# Never add --use_fast_math: __sinf is wrong for the 2^9 * x encoding
# arguments.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")
    return nvcc


def library_path(name: str) -> Path:
    """The library's path: its name hashes the source, every shared
    header (csrc/*.cuh) and the flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built. A lock
    file per library serialises the processes that ask at once (the
    ranks of a parallel run): one compiles, the others load its output."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(lib.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(name, lib)
    return lib


def _compile(name: str, lib: Path) -> None:
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True,
            text=True,
        )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    return ctypes.CDLL(str(build(name)))
