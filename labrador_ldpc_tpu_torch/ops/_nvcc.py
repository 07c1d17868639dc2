"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/*.cu` file is compiled on its own into a shared library with a
plain C interface, at first use, into `labrador_ldpc_tpu_torch/_build/`
(listed in .gitignore). The library's name carries a hash of the source, of
every header in `csrc/` (`*.cuh`, which the sources share) and of the flags,
so an edited source or header is rebuilt and never mixed with a stale one.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

__all__ = ["Built", "build", "load_library", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a: Hopper with its arch-specific features; --fmad=false keeps every
# multiply and add separately rounded, as the plain PyTorch versions are
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    path: Path  # the shared library
    seconds: float  # nvcc wall time; 0.0 when an existing build was reused
    log: str  # nvcc's output (ptxas registers, shared memory, spills)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(source: str) -> tuple[Path, Path]:
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    so = BUILD_DIR / f"{src.stem}-{digest}.so"
    return so, so.with_suffix(".log")


def build(source: str) -> Built:
    """Compile csrc/<source> with nvcc unless that build exists already."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so, log = _target(source)
    if so.exists():
        return Built(so, 0.0, log.read_text() if log.exists() else "")
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return Built(so, seconds, proc.stdout)


@lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source> as a ctypes library."""
    return ctypes.CDLL(str(build(source).path))
