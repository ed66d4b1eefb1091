"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone into
``build/lib<name>-<hash>.so``, where the hash covers the source, every
header ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and a stale library is never loaded.  A library named in
``SOURCES`` is another build of a source under its own flags (the fused
bounce kernel's measuring build).
A file lock serialises concurrent builds; a failed build raises with
nvcc's output.  Each nvcc run is a ``kernels.build`` span
(utils/profiling.py) naming the library.  Delete ``raytrace_tpu_torch/build/`` to force a rebuild.
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

from ..utils.profiling import span

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Flags a kernel adds to NVCC_FLAGS.  The fused bounce kernel, the sphere
# sweeps (world and object space), the triangle sweeps and the BVH walk,
# and the three dev probes are built without multiply-add contraction, so
# each of their operations rounds as the plain PyTorch version's
# elementwise kernels do.
KERNEL_FLAGS = {name: ("-fmad=false",) for name in (
    "megakernel", "sphere_sweep", "tri_sweep", "paged_tri", "bvh_walk",
    "sphere_obj", "probe_ops", "probe_trig", "micro_raygen")}
# Libraries built from another library's source, with their own flags:
# the fused bounce kernel's measuring build (csrc/megakernel.cu under
# K4_MEASURE: its warp lanes-busy counts and phase clocks; loaded by
# ops/megakernel.measure_library, never by the Renderer).
SOURCES = {"megakernel_measure": "megakernel"}
KERNEL_FLAGS["megakernel_measure"] = ("-fmad=false", "-DK4_MEASURE")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (on PATH or in /usr/local/cuda)")


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def source(name: str) -> Path:
    """The source that library ``name`` is built from."""
    return CSRC / f"{SOURCES.get(name, name)}.cu"


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, every header (any source
    may include any of them) and the flags."""
    digest = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name``'s source unless the library for this
    source and these flags exists.
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
            with span("kernels.build", library=name):
                proc = subprocess.run(
                    [_nvcc(), *nvcc_flags(name), "-o", tmp,
                     str(source(name))],
                    capture_output=True, text=True,
                )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name} (exit {proc.returncode}):"
                    f"\n{proc.stdout}{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
