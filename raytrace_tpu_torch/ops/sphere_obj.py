"""The wavefront's sphere closest hit in object space: the CUDA kernel
``csrc/sphere_obj.cu`` (H2) and its plain PyTorch version
(ops/spheres.intersect_spheres, the port of raytrace_tpu/ops/spheres.py:40,
which the JAX package traces with XLA: there is no Pallas kernel to port,
and H2 replaces none).

A scene whose spheres are not all mapped to spheres by their instances (a
non-uniform scale: ellipsoids) has no world-space sphere table, so the
wavefront sweeps them here, each ray moved into each sphere's object
space (``SceneStatic.sphere_world_mode`` False).  ``intersect_spheres_object``
is the entry point: for tensors on the CPU it runs the plain version; for
CUDA tensors it launches the kernel on the current stream, or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .intersect import T_MAX
from .paged_tri import _check_rays
from .spheres import SphereHit, intersect_spheres
from .vec3 import V3

LAUNCHES = 0


def _check_table(table16: torch.Tensor, device) -> None:
    if (table16.dtype != torch.float32 or table16.dim() != 2
            or table16.shape[1] != 16 or table16.shape[0] % 8
            or table16.device != device or not table16.is_contiguous()):
        raise ValueError("table16 must be a contiguous float32 [S8, 16] "
                         "tensor (S8 a multiple of 8) on the rays' device "
                         "(ops/spheres.object_sphere_table)")


def intersect_spheres_object(o: V3, d: V3, table16: torch.Tensor,
                             active: torch.Tensor) -> SphereHit:
    """Closest hit of rays o + t d against the spheres of the [S8, 16]
    object-space table; the lowest id on ties; inactive rays and misses
    give (T_MAX, -1)."""
    global LAUNCHES
    _check_rays(o, d, active)
    device = o.x.device
    _check_table(table16, device)
    if device.type == "cpu":
        hit = intersect_spheres(o, d, table16)
        return SphereHit(t=torch.where(active, hit.t, T_MAX),
                         sph=torch.where(active, hit.sph, -1))
    if device.type != "cuda":
        raise ValueError(f"no object-space sphere sweep for device {device}")
    if table16.data_ptr() % 16:
        raise ValueError("table16 must be 16-byte aligned (float4 loads)")
    R = o.x.shape[0]
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays: the kernel indexes rays in 32 bits")
    lib = library()
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    err = lib.sphere_obj_launch(
        table16.data_ptr(), table16.shape[0],
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sphere_obj launch failed: CUDA error {err} "
            f"({lib.sphere_obj_error_string(err).decode()})")
    LAUNCHES += 1
    return SphereHit(t=t, sph=ids)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("sphere_obj")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sphere_obj_launch.argtypes = [p, i, p, p, p, p, p, p, p, i, p, p, p]
    lib.sphere_obj_launch.restype = i
    lib.sphere_obj_error_string.argtypes = [i]
    lib.sphere_obj_error_string.restype = ctypes.c_char_p
    return lib
