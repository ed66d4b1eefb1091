"""The wavefront's sphere closest hit: the CUDA kernel ``csrc/sphere_sweep.cu``
(K1) and its plain PyTorch version (counterpart of
raytrace_tpu/ops/pallas_sweep.py).

``intersect_spheres_sweep`` is the entry point.  For tensors on the CPU it
runs the plain version, a dense sweep of every ray against every table
row; for CUDA tensors it launches the kernel on the current stream, or
raises.  Given the scene's sphere tree (ops/sphere_tree.build_sphere_tree
over the spheres past the prefix ``tree_prefix``), the kernel sweeps the
prefix densely and walks the tree over the rest; without one (a scene
with at most ``SPHERE_FLAT_MAX`` spheres past its prefix) it sweeps every
row.  Either way it gives the dense sweep's bits.  ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through the
kernel.

``intersect_spheres_dense`` is the dense sweep of the kernel's first
version, kept as a check-only entry point: ``chip_smoke.py``, the chip
probes and the card tests hold other kernels against it.  No Renderer path
calls it, and ``LAUNCHES`` does not count it.
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

# The walk's stack (csrc/sphere_sweep.cu kStack): one entry a level, so a
# tree over any sphere count the port holds fits (2^24 leaves), not only
# the fused gate's (ops/sphere_tree.MAX_SPHERE_DEPTH).
WALK_DEPTH = 24
# The most spheres past the prefix that K1 sweeps densely, with no tree.
# Chosen on the card (PERF.md §6: 2^21 rays, n small spheres past a
# ground sphere): at 8 and 16 the two are within 4% (the dense loop 2%
# faster at 16), from 24 the walk is faster (8% at 24, 15% at 32, 30% at
# 64, 61% at 256).
SPHERE_FLAT_MAX = 16

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


def tree_prefix(static) -> "int | None":
    """The spheres K1 sweeps densely before it walks the sphere tree over
    the rest: the scene's dense prefix (``SceneStatic.sph_prefix``, the
    large spheres of a scene in Morton clusters; 0 for other scenes), or
    None where at most SPHERE_FLAT_MAX spheres lie past it and K1 sweeps
    every sphere densely, with no tree."""
    n_prefix = max(0, min(static.sph_prefix, static.num_spheres))
    return (n_prefix if static.num_spheres - n_prefix > SPHERE_FLAT_MAX
            else None)


def _check_tree(tree, table8: torch.Tensor) -> None:
    """The tree against the table and the walk's stack (ops/sphere_tree.
    check_tree at WALK_DEPTH): shapes, devices, a static tree, the 16-byte
    alignment of the float4 loads.  The ids only label a hit, so their
    permutation is not checked here, which would wait for the device."""
    from . import sphere_tree

    sphere_tree.check_tree(tree, table8, tree.n_prefix,
                           tree.n_prefix + tree.num_spheres, anim=False,
                           max_depth=WALK_DEPTH, permutation=False)


def _masked(hit, active) -> SphereHit:
    t, ids = hit
    return SphereHit(t=torch.where(active, t, T_MAX),
                     sph=torch.where(active, ids, -1))


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.sphere_sweep_error_string(err).decode()})")


def intersect_spheres_sweep(o: V3, d: V3, table8: torch.Tensor,
                            active: torch.Tensor, tree=None) -> SphereHit:
    """Closest hit of rays o + t d against the [S8, 8] table (c.xyz, r, k);
    lowest id on ties; inactive rays and misses give (T_MAX, -1).  On the
    CPU the plain version sweeps the table; on the card the kernel sweeps
    the table's first ``tree.n_prefix`` rows and walks ``tree`` (a static
    ops/sphere_tree.SphereTree over the rest of the same table), or sweeps
    every row when ``tree`` is None, and gives the same bits."""
    global LAUNCHES
    _check_inputs(o, d, table8, active)
    if tree is not None:
        _check_tree(tree, table8)
    device = o.x.device
    if device.type == "cpu":
        return _masked(sphere_sweep_reference(o, d, table8), active)
    if device.type != "cuda":
        raise ValueError(f"no sphere sweep for device {device}")
    if table8.data_ptr() % 16:
        raise ValueError("table8 must be 16-byte aligned (float4 loads)")
    R = o.x.shape[0]
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays: the kernel indexes rays in 32 bits")

    lib = library()
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if tree is None:
        walk = (table8.shape[0], None, None, None, 0, 0, 1, 0)
    else:
        from .sphere_tree import stage_nodes

        # The top node rows that fit the kernel's 16 KiB of shared memory.
        walk = (tree.n_prefix, tree.rows.data_ptr(), tree.nodes.data_ptr(),
                tree.ids.data_ptr(), tree.num_spheres, tree.depth, tree.leaf,
                stage_nodes((1 << tree.depth) - 1))
    err = lib.sphere_sweep_launch(
        table8.data_ptr(), *walk,
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(), stream,
    )
    _raise_on(lib, err, "sphere_sweep")
    LAUNCHES += 1
    return SphereHit(t=t, sph=ids)


def intersect_spheres_dense(o: V3, d: V3, table8: torch.Tensor,
                            active: torch.Tensor) -> SphereHit:
    """The dense sweep, a check-only oracle: the same contract as
    ``intersect_spheres_sweep``, every ray against every table row.  On
    the CPU the plain version; on the card the kernel's dense entry point
    (csrc/sphere_sweep.cu sphere_sweep_dense_launch), not counted in
    ``LAUNCHES``."""
    _check_inputs(o, d, table8, active)
    device = o.x.device
    if device.type == "cpu":
        return _masked(sphere_sweep_reference(o, d, table8), active)
    if device.type != "cuda":
        raise ValueError(f"no sphere sweep for device {device}")
    if table8.data_ptr() % 16:
        raise ValueError("table8 must be 16-byte aligned (float4 loads)")
    lib = library()
    R = o.x.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    err = lib.sphere_sweep_dense_launch(
        table8.data_ptr(), table8.shape[0],
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "sphere_sweep_dense")
    return SphereHit(t=t, sph=ids)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("sphere_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sphere_sweep_launch.argtypes = [p, i, p, p, p, i, i, i, i, p, p, p,
                                        p, p, p, p, i, p, p, p]
    lib.sphere_sweep_launch.restype = i
    lib.sphere_sweep_dense_launch.argtypes = [p, i, p, p, p, p, p, p, p, i,
                                              p, p, p]
    lib.sphere_sweep_dense_launch.restype = i
    lib.sphere_sweep_error_string.argtypes = [i]
    lib.sphere_sweep_error_string.restype = ctypes.c_char_p
    return lib
