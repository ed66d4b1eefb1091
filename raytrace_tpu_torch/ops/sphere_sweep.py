"""Dense sphere closest hit: the CUDA kernel ``csrc/sphere_sweep.cu`` and its
plain PyTorch version (counterpart of raytrace_tpu/ops/pallas_sweep.py).

``intersect_spheres_sweep`` is the one entry point.  For tensors on the CPU
it runs the plain version; for CUDA tensors it launches the kernel on the
current stream, or raises.  ``LAUNCHES`` counts kernel launches, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .intersect import T_MAX
from .spheres import SphereHit, intersect_spheres_world
from .vec3 import V3

LAUNCHES = 0

_PAD_K = 3.0e37  # padding rows: k so large that disc < 0, never a hit


def pad_table8(table5: torch.Tensor) -> torch.Tensor:
    """[S, 5] world sphere table → [S8, 8] kernel table (S8 = S rounded up
    to a multiple of 8, at least 8; padding rows have r = 0, k = 3e37)."""
    S = table5.shape[0]
    S8 = max(8, -(-S // 8) * 8)
    out = torch.zeros((S8, 8), dtype=torch.float32, device=table5.device)
    out[:S, :5] = table5
    out[S:, 4] = _PAD_K
    return out


def sphere_sweep_reference(o: V3, d: V3, table8: torch.Tensor):
    """The plain version of the kernel: (t [R] f32, id [R] int32) of the
    closest sphere for every ray, (T_MAX, -1) on a miss."""
    hit = intersect_spheres_world(o, d, table8)
    return hit.t, hit.sph


def _check_inputs(o: V3, d: V3, table8, active) -> None:
    R = o.x.shape[0]
    device = o.x.device
    for v in (*o, *d):
        if v.dtype != torch.float32 or v.shape != (R,) or v.device != device:
            raise ValueError("ray components must be float32 [R] tensors "
                             "on one device")
        if not v.is_contiguous():
            raise ValueError("ray components must be contiguous")
    if (table8.dtype != torch.float32 or table8.dim() != 2
            or table8.shape[1] != 8 or table8.shape[0] % 8
            or table8.device != device or not table8.is_contiguous()):
        raise ValueError("table8 must be a contiguous float32 [S8, 8] tensor "
                         "(S8 a multiple of 8) on the rays' device")
    if (active.dtype != torch.bool or active.shape != (R,)
            or active.device != device or not active.is_contiguous()):
        raise ValueError("active must be a contiguous bool [R] tensor on the "
                         "rays' device")


def intersect_spheres_sweep(o: V3, d: V3, table8: torch.Tensor,
                            active: torch.Tensor) -> SphereHit:
    """Closest hit of rays o + t d against the [S8, 8] table (c.xyz, r, k);
    lowest id on ties; inactive rays and misses give (T_MAX, -1)."""
    global LAUNCHES
    _check_inputs(o, d, table8, active)
    device = o.x.device
    if device.type == "cpu":
        t, ids = sphere_sweep_reference(o, d, table8)
        return SphereHit(t=torch.where(active, t, T_MAX),
                         sph=torch.where(active, ids, -1))
    if device.type != "cuda":
        raise ValueError(f"no sphere sweep for device {device}")
    if table8.data_ptr() % 16:
        raise ValueError("table8 must be 16-byte aligned (float4 loads)")

    lib = library()
    R = o.x.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.sphere_sweep_launch(
        table8.data_ptr(), table8.shape[0],
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"sphere_sweep launch failed: CUDA error {err} "
            f"({lib.sphere_sweep_error_string(err).decode()})")
    LAUNCHES += 1
    return SphereHit(t=t, sph=ids)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("sphere_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sphere_sweep_launch.argtypes = [p, i, p, p, p, p, p, p, p, i, p, p, p]
    lib.sphere_sweep_launch.restype = i
    lib.sphere_sweep_error_string.argtypes = [i]
    lib.sphere_sweep_error_string.restype = ctypes.c_char_p
    return lib
