"""Build the CUDA C++ kernels of ``csrc/`` at first use and load them.

``nvcc`` compiles each source into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``kandinsky2_tpu_torch/build/`` (listed in ``.gitignore``).  The library
name carries a hash of the source, so an edited kernel is rebuilt and a
stale library is never loaded.  Several sources build in parallel, one
``nvcc`` each; ptxas's register and shared-memory report of every build is
kept in ``PTXAS_REPORTS``.  ``ctypes`` binds the entry points; every
pointer and the stream are passed as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills per kernel) of each
# source compiled by this process, by file name
PTXAS_REPORTS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(*sources: Path) -> list[Path]:
    """Compile each source that is not built yet (once per content), one
    ``nvcc`` process per source, all started together; returns the
    libraries' paths in the order of ``sources``."""
    paths, jobs = [], []
    for src in sources:
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
        paths.append(lib_path)
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((src, lib_path, tmp, proc))
    for src, lib_path, tmp, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        PTXAS_REPORTS[src.name] = out
        os.replace(tmp, lib_path)
    return paths


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content) and return the library."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build(CSRC_DIR / source)[0]))
    return _loaded[source]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
