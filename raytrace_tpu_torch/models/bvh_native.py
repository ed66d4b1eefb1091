"""The native binned-SAH BVH builder (csrc/bvh_builder.cc), loaded with
ctypes (counterpart of native/__init__.py).

The library is built with g++ at first use into ``build/``, beside the
CUDA kernels (ops/_build.py), under a name keyed by a hash of the source
and the flags, so an edited source rebuilds and a stale library is never
loaded; a file lock serialises concurrent builds.  Where it cannot be
built or loaded, ``build_sah_bvh`` returns None (``error()`` says why),
models/bvh_build.build_bvh_sah logs a warning naming the error at each
such call, and the Renderer takes the implicit tree (build_bvh), as the
JAX package does.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "bvh_builder.cc"
# The host compiler and its flags (native/__init__.py:32).
CXX = "g++"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_ERROR = None


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libbvh_builder-{digest.hexdigest()[:16]}.so"


def _build():
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "bvh_builder.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{CXX} exited {proc.returncode}: "
                                   f"{proc.stderr.strip()}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def get_library():
    """The loaded library, or None where it cannot be built or loaded (the
    error is kept in ``error()``)."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is not None or _ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            lib.rtpu_build_bvh.restype = ctypes.c_int32
            lib.rtpu_build_bvh.argtypes = [fp, fp, ctypes.c_int32,
                                           ctypes.c_int32, fp, ip, ip]
            _LIB = lib
        except Exception as e:  # no compiler, a failed build, ...
            _ERROR = f"{type(e).__name__}: {e}"
        return _LIB


def error():
    """Why the library is unavailable, or None."""
    return _ERROR


def reset() -> None:
    """Forget the loaded library and any failure, so the next call builds
    or loads again."""
    global _LIB, _ERROR
    with _LOCK:
        _LIB = _ERROR = None


def build_sah_bvh(tri_mn: np.ndarray, tri_mx: np.ndarray, leaf_max: int = 8):
    """Binned-SAH BVH over per-triangle boxes (native/__init__.py:62-86).
    Returns (rows [N, 16] f32 with the child links bitcast in cols 12/13,
    order [T] int32, root link, depth), or None where the library is
    unavailable."""
    lib = get_library()
    if lib is None:
        return None
    t = np.ascontiguousarray(tri_mn, np.float32)
    x = np.ascontiguousarray(tri_mx, np.float32)
    n = t.shape[0]
    rows = np.zeros((max(1, n), 16), np.float32)
    order = np.zeros(n, np.int32)
    root_depth = np.zeros(2, np.int32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa
    n_nodes = lib.rtpu_build_bvh(fp(t), fp(x), np.int32(n),
                                 np.int32(leaf_max), fp(rows), ip(order),
                                 ip(root_depth))
    if n_nodes < 0:
        raise ValueError("rtpu_build_bvh failed")
    return rows[:n_nodes], order, int(root_depth[0]), int(root_depth[1])
