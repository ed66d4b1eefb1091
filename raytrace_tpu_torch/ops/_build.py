"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``build/lib<name>-<hash>.so``, where the hash covers the source and the
flags, so an edited source rebuilds and a stale library is never loaded.
A file lock serialises concurrent builds; a failed build raises with
nvcc's output.  Delete ``raytrace_tpu_torch/build/`` to force a rebuild.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (on PATH or in /usr/local/cuda)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists.
    Returns the library's path; nvcc's report (registers, spills) is kept
    beside it as ``.log``."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name}.cu (exit {proc.returncode}):"
                    f"\n{proc.stdout}{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
