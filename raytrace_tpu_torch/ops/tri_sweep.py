"""The wavefront's triangle closest hit: the CUDA kernel ``csrc/tri_sweep.cu``
(K2) and its plain PyTorch version (counterpart of
raytrace_tpu/ops/pallas_tri_sweep.py).

``intersect_tris_sweep`` is the entry point.  For tensors on the CPU it
runs the plain version, a dense sweep of every ray against every table
row; for CUDA tensors it launches the kernel on the current stream, or
raises.  The kernel walks the soup's tree (ops/paged_tri.build_soup_tree,
which the wavefront builds for every soup outside the paged sweep) and
returns the dense sweep's bits.  ``LAUNCHES`` counts kernel launches, so a
run can show that its main path went through the kernel.

``intersect_tris_dense`` is the dense sweep of the kernel's first version,
kept as a check-only entry point: ``chip_smoke.py``, the chip probes and
the card tests hold other kernels against it as an independent oracle.
No Renderer path calls it, and ``LAUNCHES`` does not count it.

Table layout [T8, 16] (``pack_tri_table``): v0.xyz, e1.xyz, e2.xyz, valid,
then six zeros; T8 is the soup's length rounded up to a multiple of 8.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .intersect import T_MAX, T_MIN, Hit
from .vec3 import V3

LAUNCHES = 0

# Elements of one [chunk, R] temporary in the plain sweep (64 MiB of f32).
_CHUNK_ELEMS = 1 << 24


def pack_tri_table(world_p: torch.Tensor, num_real: int) -> torch.Tensor:
    """[T, 3, 3] world triangles → [T8, 16] kernel table; rows at or past
    ``num_real`` (the soup's padding) are marked invalid
    (raytrace_tpu/ops/pallas_tri_sweep.py:125)."""
    T = world_p.shape[0]
    T8 = max(8, -(-T // 8) * 8)
    v0 = world_p[:, 0, :]
    tbl = torch.zeros((T8, 16), dtype=torch.float32, device=world_p.device)
    tbl[:T, 0:3] = v0
    tbl[:T, 3:6] = world_p[:, 1, :] - v0
    tbl[:T, 6:9] = world_p[:, 2, :] - v0
    tbl[:T, 9] = (torch.arange(T, device=world_p.device)
                  < num_real).to(torch.float32)
    return tbl


def tri_sweep_reference(o: V3, d: V3, table16: torch.Tensor):
    """The plain version of the kernel, in the operation order of
    ``_tri_kernel`` (raytrace_tpu/ops/pallas_tri_sweep.py:41-70):
    (t, id, u, v) of the closest triangle for every ray; (T_MAX, -1, 0, 0)
    on a miss; the lowest id on ties."""
    R = o.x.shape[0]
    T8 = table16.shape[0]
    dev = o.x.device
    chunk = max(8, min(512, _CHUNK_ELEMS // max(R, 1)) // 8 * 8)
    ox, oy, oz = o
    dx, dy, dz = d
    bt = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    bid = torch.full((R,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(R, dtype=torch.float32, device=dev)
    bv = torch.zeros(R, dtype=torch.float32, device=dev)
    for s in range(0, T8, chunk):
        tb = table16[s:s + chunk]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, valid = (
            tb[:, i:i + 1] for i in range(10))                 # [C, 1]
        px = dy * e2z - dz * e2y                                  # [C, R]
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = torch.where(det != 0.0,
                              1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = ((valid > 0.0) & (det != 0.0) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t > T_MIN) & (t < T_MAX))
        t = torch.where(ok, t, T_MAX)
        tc, arg = torch.min(t, dim=0)   # the first minimum: the lowest id
        better = tc < bt
        bt = torch.where(better, tc, bt)
        bid = torch.where(better, (arg + s).to(torch.int32), bid)
        bu = torch.where(better, u.gather(0, arg[None])[0], bu)
        bv = torch.where(better, v.gather(0, arg[None])[0], bv)
    return bt, bid, bu, bv


def _check_inputs(o: V3, d: V3, table16, active) -> None:
    R = o.x.shape[0]
    device = o.x.device
    for c in (*o, *d):
        if c.dtype != torch.float32 or c.shape != (R,) or c.device != device:
            raise ValueError("ray components must be float32 [R] tensors "
                             "on one device")
        if not c.is_contiguous():
            raise ValueError("ray components must be contiguous")
    if (table16.dtype != torch.float32 or table16.dim() != 2
            or table16.shape[1] != 16 or table16.shape[0] % 8
            or table16.device != device or not table16.is_contiguous()):
        raise ValueError("table16 must be a contiguous float32 [T8, 16] "
                         "tensor (T8 a multiple of 8) on the rays' device")
    if (active.dtype != torch.bool or active.shape != (R,)
            or active.device != device or not active.is_contiguous()):
        raise ValueError("active must be a contiguous bool [R] tensor on the "
                         "rays' device")


def _check_tree(tree, table16: torch.Tensor, device) -> None:
    """The soup's tree against its table and the kernel's stack
    (ops/paged_tri._check_tree), with one id a real triangle."""
    from .paged_tri import MAX_DEPTH, _check_tree as check_tree

    check_tree(tree, device, MAX_DEPTH)
    if tree.ids is None:
        raise ValueError("K2 walks a soup in its own order: its tree needs "
                         "the slot -> id table (ops/paged_tri."
                         "build_soup_tree)")
    if tree.num_tris > table16.shape[0]:
        raise ValueError(f"a tree of {tree.num_tris} triangles over a table "
                         f"of {table16.shape[0]} rows")


def _masked(hit, active) -> Hit:
    t, ids, u, v = hit
    return Hit(t=torch.where(active, t, T_MAX),
               tri=torch.where(active, ids, -1),
               u=torch.where(active, u, 0.0),
               v=torch.where(active, v, 0.0))


def _outputs(R: int, device):
    return (torch.empty(R, dtype=torch.float32, device=device),
            torch.empty(R, dtype=torch.int32, device=device),
            torch.empty(R, dtype=torch.float32, device=device),
            torch.empty(R, dtype=torch.float32, device=device))


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.tri_sweep_error_string(err).decode()})")


def intersect_tris_sweep(o: V3, d: V3, table16: torch.Tensor,
                         active: torch.Tensor, tree=None) -> Hit:
    """Closest hit of rays o + t d against the soup of the [T8, 16] table;
    the lowest id on ties; inactive rays and misses give (T_MAX, -1, 0, 0).
    On the CPU the plain version sweeps the table; on the card the kernel
    walks ``tree``, the soup's TriTree with its slot -> id table
    (ops/paged_tri.build_soup_tree over the same soup), and gives the
    same bits.  A launch without a tree raises: the dense sweep is
    ``intersect_tris_dense``."""
    global LAUNCHES
    _check_inputs(o, d, table16, active)
    device = o.x.device
    if tree is not None:
        _check_tree(tree, table16, device)
    if device.type == "cpu":
        return _masked(tri_sweep_reference(o, d, table16), active)
    if device.type != "cuda":
        raise ValueError(f"no triangle sweep for device {device}")
    if tree is None:
        raise ValueError("K2 walks the soup's tree: pass tree "
                         "(ops/paged_tri.build_soup_tree)")
    if (tree.tris.data_ptr() % 16 or tree.nodes.data_ptr() % 16
            or tree.ids.data_ptr() % 4):
        raise ValueError("the tree's tables must be 16-byte aligned (float4 "
                         "loads)")
    R = o.x.shape[0]
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays: the kernel indexes rays in 32 bits")
    lib = library()
    t, ids, u, v = _outputs(R, device)
    err = lib.tri_sweep_launch(
        tree.tris.data_ptr(), tree.num_tris, tree.nodes.data_ptr(),
        tree.ids.data_ptr(), tree.depth, tree.leaf,
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(), u.data_ptr(),
        v.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "tri_sweep")
    LAUNCHES += 1
    return Hit(t=t, tri=ids, u=u, v=v)


def intersect_tris_dense(o: V3, d: V3, table16: torch.Tensor,
                         active: torch.Tensor) -> Hit:
    """The dense sweep, a check-only oracle: the same contract as
    ``intersect_tris_sweep``, every ray against every table row.  On the
    CPU the plain version; on the card the kernel's dense entry point
    (csrc/tri_sweep.cu tri_sweep_dense_launch), not counted in
    ``LAUNCHES``."""
    _check_inputs(o, d, table16, active)
    device = o.x.device
    if device.type == "cpu":
        return _masked(tri_sweep_reference(o, d, table16), active)
    if device.type != "cuda":
        raise ValueError(f"no triangle sweep for device {device}")
    if table16.data_ptr() % 16:
        raise ValueError("table16 must be 16-byte aligned (float4 loads)")
    lib = library()
    R = o.x.shape[0]
    t, ids, u, v = _outputs(R, device)
    err = lib.tri_sweep_dense_launch(
        table16.data_ptr(), table16.shape[0],
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(), u.data_ptr(),
        v.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "tri_sweep_dense")
    return Hit(t=t, tri=ids, u=u, v=v)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("tri_sweep")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tri_sweep_launch.argtypes = [p, i, p, p, i, i, p, p, p, p, p, p,
                                     p, i, p, p, p, p, p]
    lib.tri_sweep_launch.restype = i
    lib.tri_sweep_dense_launch.argtypes = [p, i, p, p, p, p, p, p, p, i, p,
                                           p, p, p, p]
    lib.tri_sweep_dense_launch.restype = i
    lib.tri_sweep_error_string.argtypes = [i]
    lib.tri_sweep_error_string.restype = ctypes.c_char_p
    return lib
