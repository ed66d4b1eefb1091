"""The wavefront's sphere closest hit in object space: the CUDA kernel
``csrc/sphere_obj.cu`` (H2) and its plain PyTorch versions
(ops/spheres.intersect_spheres, the port of raytrace_tpu/ops/spheres.py:40,
which the JAX package traces with XLA: there is no Pallas kernel to port,
and H2 replaces none).

A scene whose spheres are not all mapped to spheres by their instances (a
non-uniform scale: ellipsoids) has no world-space sphere table, so the
wavefront tests each ray in each sphere's object space
(``SceneStatic.sphere_world_mode`` False).  The kernel sweeps the scene's
dense prefix of large spheres (``tree_prefix``), then walks a tree over
the world boxes of the rest (``build_object_tree``: each ellipsoid's exact
box, the tree built by ops/sphere_tree.build_box_nodes, the builder of K1's
and K4's sphere trees, over a Morton order of the boxes' centres,
``object_order``), each box widened per ray by the rounding margin that
csrc/sphere_obj.cu derives.  A hit is kept as the lexicographic minimum
of (t, id), so the walk gives the dense sweep's bits.

``intersect_spheres_object`` is the entry point: for tensors on the CPU
it runs the plain walk (``object_tree_sweep_reference``; its work is
ops/sphere_tree.sphere_tree_visit_counts) given a tree,
else the dense plain sweep; for CUDA tensors it launches the kernel on the
current stream, or raises.  ``LAUNCHES`` counts kernel launches.
``intersect_spheres_object_dense`` is the kernel's first version, the
dense loop, kept as a check-only entry point (not counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _build, paged_tri, sphere_tree
from .intersect import T_MAX
from .paged_tri import _check_rays
from .sphere_sweep import SPHERE_FLAT_MAX, WALK_DEPTH
from .spheres import SphereHit, intersect_spheres, object_hit_t
from .vec3 import V3

LAUNCHES = 0

# The unit roundoff of the margin's coefficient, nu sigma^2 (36 + 8
# kappa) u / r (csrc/sphere_obj.cu derives it).
_U = 2.0 ** -24
# A once-built tree's boxes are widened by STATIC_DRIFT u kappa nu (|t| +
# |c| + r) on each axis, which holds the ellipsoid of a static instance's
# map at any other batch time (csrc/sphere_obj.cu derives 36).
STATIC_DRIFT = 40.0
# A sphere whose box or margin is not finite (a singular instance map)
# gets this box, which every ray passes, and no margin.
_UNBOUNDED = 1e30
# The compiler's rule for a large sphere (models/sphere_order.
# sphere_cluster_order's big_factor), applied to the boxes where the
# compiler gives no prefix.
BIG_FACTOR = 3.0


def _check_table(table16: torch.Tensor, device) -> None:
    if (table16.dtype != torch.float32 or table16.dim() != 2
            or table16.shape[1] != 16 or table16.shape[0] % 8
            or table16.device != device or not table16.is_contiguous()):
        raise ValueError("table16 must be a contiguous float32 [S8, 16] "
                         "tensor (S8 a multiple of 8) on the rays' device "
                         "(ops/spheres.object_sphere_table)")


# ------------------------------------------------------------ the tree

def object_sphere_bounds(rows16: torch.Tensor, static: bool = False):
    """Each [16] object-space row's world box and margin terms (see
    csrc/sphere_obj.cu), from its map and sphere in float64: (lo [n, 3],
    hi [n, 3] f32, valid [n] bool (r > 0: a row that can hit), reach [n],
    coef [n] f32).  The box is centred at A (c - t) with half-extent
    r |A[i, :]|_2, A the inverse of M's 3 x 3 part L; reach is (|t| + |c|
    + r) / sigma and coef nu sigma^2 (36 + 8 kappa) u / r, sigma = |L|_2,
    nu the largest |A[i, :]|_2, kappa = |L|_F |A|_2.  With ``static`` the
    half-extent gains STATIC_DRIFT u kappa nu (|t| + |c| + r), so the box
    also holds the row's ellipsoid at any other batch time of a static
    instance.  A row whose box or margin is not finite gets the box
    +/-1e30 with no margin."""
    x = rows16.double()
    m = x[:, 0:12].reshape(-1, 3, 4)
    lin, tv = m[:, :, 0:3], m[:, :, 3]
    c, r = x[:, 12:15], x[:, 15]
    a, b, e = lin[:, 0], lin[:, 1], lin[:, 2]
    det = (a * torch.linalg.cross(b, e)).sum(dim=1)
    inv = torch.stack([torch.linalg.cross(b, e), torch.linalg.cross(e, a),
                       torch.linalg.cross(a, b)], dim=2) / det[:, None, None]
    centre = (inv @ (c - tv)[:, :, None])[:, :, 0]
    rows_norm = torch.linalg.vector_norm(inv, dim=2)            # [n, 3]
    half = r.abs()[:, None] * rows_norm
    sv = torch.linalg.svdvals(torch.nan_to_num(lin))           # [n, 3]
    sigma = sv[:, 0]
    kappa = torch.linalg.matrix_norm(lin) / sv[:, 2]
    reach = (torch.linalg.vector_norm(tv, dim=1)
             + torch.linalg.vector_norm(c, dim=1) + r.abs()) / sigma
    nu = rows_norm.amax(dim=1)
    coef = (nu * sigma * sigma * (36.0 + 8.0 * kappa)
            * _U / torch.where(r > 0.0, r, 1.0))
    if static:
        half = half + (STATIC_DRIFT * _U * kappa * nu * (
            torch.linalg.vector_norm(tv, dim=1)
            + torch.linalg.vector_norm(c, dim=1) + r.abs()))[:, None]
    lo, hi = centre - half, centre + half
    bounded = (torch.isfinite(lo).all(dim=1) & torch.isfinite(hi).all(dim=1)
               & torch.isfinite(reach) & torch.isfinite(coef))
    big = torch.full_like(lo, _UNBOUNDED)
    keep = bounded[:, None]
    return (torch.where(keep, lo, -big).float(),
            torch.where(keep, hi, big).float(), r > 0.0,
            torch.where(bounded, reach, 0.0).float(),
            torch.where(bounded, coef, 0.0).float())


def tree_prefix(static, table16: torch.Tensor) -> Optional[int]:
    """The spheres H2 sweeps densely before it walks the tree over the
    rest, or None where at most SPHERE_FLAT_MAX spheres lie past them and
    it sweeps every sphere densely (ops/sphere_sweep.tree_prefix's rule).
    The prefix is the compiler's (``SceneStatic.sph_prefix``, its large
    spheres first); where it gives none, the leading run of spheres whose
    box's largest half-extent is above BIG_FACTOR times the median's over
    the scene's spheres (the compiler's own rule for a large sphere, on
    the boxes of ``table16`` at the time it holds)."""
    n = min(static.num_spheres, table16.shape[0])
    n_prefix = max(0, min(static.sph_prefix, n))
    if n_prefix == 0 and n > 0:
        lo, hi, valid, _, _ = object_sphere_bounds(table16[:n])
        ext = torch.where(valid, (hi - lo).amax(dim=1), 0.0).cpu().numpy()
        big = ext > BIG_FACTOR * max(float(np.median(ext)), 1e-30)
        n_prefix = int(np.argmin(big)) if not big.all() else n
    return n_prefix if n - n_prefix > SPHERE_FLAT_MAX else None


def object_order(table16: torch.Tensor, n_prefix: int,
                 num_spheres: int) -> torch.Tensor:
    """[num_spheres - n_prefix] int32 sphere ids past the prefix, on the
    table's device, in the isotropic Morton order of their boxes' centres
    (ops/sphere_tree.sphere_order; on the host)."""
    lo, hi, _, _, _ = object_sphere_bounds(table16[:num_spheres])
    mid = (0.5 * (lo.double() + hi.double())).cpu().numpy()
    return torch.tensor(sphere_tree.sphere_order(mid, n_prefix, num_spheres),
                        dtype=torch.int32, device=table16.device)


def build_object_tree(table16: torch.Tensor, num_spheres: int,
                      n_prefix: int, ids: torch.Tensor,
                      leaf: Optional[int] = None,
                      stage_bytes: int = sphere_tree.STAGE_BYTES,
                      static: bool = False) -> sphere_tree.SphereTree:
    """The tree over the spheres ``n_prefix`` .. ``num_spheres`` - 1 of the
    [S8, 16] table at one batch time, in the order ``ids`` (``object_order``:
    [num_spheres - n_prefix] int32 on the table's device): a permuted copy
    of their rows (``rows`` [n, 16]), each one's world box and margin
    terms (``object_sphere_bounds``) and the node rows of
    ops/sphere_tree.build_box_nodes, on the table's device.  ``leaf``
    spheres a leaf, ops/sphere_tree.sphere_leaf's when not given.  With
    ``static`` (the spheres' instances do not move) the boxes are widened
    for the drift of the maps between batch times, so the tree serves the
    rows of every batch time (``object_sphere_bounds``)."""
    n = num_spheres - n_prefix
    if leaf is None:
        leaf = sphere_tree.sphere_leaf(n)
    if n < 1 or leaf < 1:
        raise ValueError("a sphere tree needs at least one sphere past the "
                         "prefix and one sphere a leaf")
    if ids.dtype != torch.int32 or ids.shape != (n,):
        raise ValueError(f"ids must be an int32 [{n}] permutation of the "
                         f"spheres past the prefix")
    rows = table16[ids.long()].contiguous()
    lo, hi, valid, reach, coef = object_sphere_bounds(rows, static)
    nodes, depth = sphere_tree.build_box_nodes([(lo, hi)], valid, reach,
                                               coef, leaf)
    return sphere_tree.SphereTree(
        rows=rows, drows=None, nodes=nodes, ids=ids, n_prefix=int(n_prefix),
        num_spheres=int(n), leaf=int(leaf), depth=depth,
        staged=sphere_tree.stage_nodes(nodes.shape[0], stage_bytes))


# ------------------------------------------------------------ plain version

def object_tree_sweep_reference(o: V3, d: V3, table16: torch.Tensor,
                                tree: sphere_tree.SphereTree):
    """The kernel's walk in plain PyTorch: (t [R] f32, id [R] int32),
    (T_MAX, -1) on a miss.  The table's first ``tree.n_prefix`` rows are
    swept densely (ops/spheres.intersect_spheres), then the tree is walked
    (ops/paged_tri.walk_reference with the margins of ops/sphere_tree),
    seeded with the prefix's best hit, whose ids are below the tree's, and
    at each leaf its spheres are tested with ``object_hit_t`` and merged
    as the lexicographic minimum of (t, id)."""
    R = o.x.shape[0]
    dev = o.x.device
    best = [torch.full((R,), T_MAX, dtype=torch.float32, device=dev),
            torch.full((R,), -1, dtype=torch.int32, device=dev)]
    if tree.n_prefix > 0:
        hit = intersect_spheres(o, d, table16[:tree.n_prefix])
        best = [hit.t.clone(), hit.sph.clone()]
    n, L = tree.num_spheres, tree.leaf
    lane = torch.arange(L, device=dev)

    def on_leaves(ray, leaf):
        step = max(1, paged_tri._CHUNK_ELEMS // (16 * L))
        for k0 in range(0, ray.numel(), step):
            kr, kl = ray[k0:k0 + step], leaf[k0:k0 + step]
            slots = kl[:, None] * L + lane                    # [K, L]
            inside = slots < n
            idx = slots.clamp(max=n - 1)
            rows = tree.rows[idx]                             # [K, L, 16]
            th = object_hit_t(tuple(x[kr][:, None] for x in o),
                              tuple(x[kr][:, None] for x in d),
                              [rows[..., i] for i in range(16)])
            paged_tri.merge_hits(best, kr, torch.where(inside, th, T_MAX),
                                 tree.ids[idx].long())

    paged_tri.walk_reference(tuple(o), tuple(paged_tri._inv(x) for x in d),
                             tree, torch.arange(R, device=dev), best[0],
                             sphere_tree._margins(o), on_leaves)
    return best[0], best[1]


# ------------------------------------------------------------------- kernel

def _check_tree(tree, table16: torch.Tensor) -> None:
    """The tree against the table and the walk's stack (ops/sphere_tree.
    check_tree at WALK_DEPTH, with 64-byte rows); the ids only label a
    hit, so their permutation is not checked here, which would wait for
    the device."""
    sphere_tree.check_tree(tree, table16, tree.n_prefix,
                           tree.n_prefix + tree.num_spheres, anim=False,
                           max_depth=WALK_DEPTH, permutation=False)


def _masked(t, ids, active) -> SphereHit:
    return SphereHit(t=torch.where(active, t, T_MAX),
                     sph=torch.where(active, ids, -1))


def _launch_inputs(o: V3, d: V3, table16, active):
    _check_rays(o, d, active)
    device = o.x.device
    _check_table(table16, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no object-space sphere sweep for device {device}")
    if device.type == "cuda":
        if table16.data_ptr() % 16:
            raise ValueError("table16 must be 16-byte aligned (float4 loads)")
        if o.x.shape[0] >= 2 ** 31:
            raise ValueError(f"{o.x.shape[0]} rays: the kernel indexes rays "
                             f"in 32 bits")
    return device


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.sphere_obj_error_string(err).decode()})")


def intersect_spheres_object(o: V3, d: V3, table16: torch.Tensor,
                             active: torch.Tensor,
                             tree: Optional[sphere_tree.SphereTree] = None
                             ) -> SphereHit:
    """Closest hit of rays o + t d against the spheres of the [S8, 16]
    object-space table; the lowest id on ties; inactive rays and misses
    give (T_MAX, -1).  With ``tree`` (``build_object_tree`` over this
    table) the table's first ``tree.n_prefix`` rows are swept and the tree
    walked, by each ray whose margin at the root is below a fraction of
    the root's size (csrc/sphere_obj.cu kFlatRatio: its warp sweeps the
    rest of the table for each of the others); without one every row is
    swept.  All give the same
    bits."""
    global LAUNCHES
    device = _launch_inputs(o, d, table16, active)
    if tree is not None:
        _check_tree(tree, table16)
    if device.type == "cpu":
        if tree is None:
            hit = intersect_spheres(o, d, table16)
            return _masked(hit.t, hit.sph, active)
        live = torch.nonzero(active).squeeze(1)
        t, ids = object_tree_sweep_reference(
            *(V3(*(x[live] for x in v)) for v in (o, d)), table16, tree)
        out = SphereHit(
            t=torch.full_like(o.x, T_MAX),
            sph=torch.full(o.x.shape, -1, dtype=torch.int32))
        out.t[live], out.sph[live] = t, ids
        return out
    lib = library()
    R = o.x.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    if tree is None:
        walk = (table16.shape[0], None, None, None, 0, 0, 1, 0)
    else:
        walk = (tree.n_prefix, tree.rows.data_ptr(), tree.nodes.data_ptr(),
                tree.ids.data_ptr(), tree.num_spheres, tree.depth, tree.leaf,
                tree.staged)
    err = lib.sphere_obj_launch(
        table16.data_ptr(), table16.shape[0], *walk,
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "sphere_obj")
    LAUNCHES += 1
    return SphereHit(t=t, sph=ids)


def intersect_spheres_object_dense(o: V3, d: V3, table16: torch.Tensor,
                                   active: torch.Tensor) -> SphereHit:
    """The dense sweep, a check-only oracle: every ray against every table
    row.  On the CPU the plain version; on the card the kernel's dense
    entry point (csrc/sphere_obj.cu sphere_obj_dense_launch), not counted
    in ``LAUNCHES``."""
    device = _launch_inputs(o, d, table16, active)
    if device.type == "cpu":
        hit = intersect_spheres(o, d, table16)
        return _masked(hit.t, hit.sph, active)
    lib = library()
    R = o.x.shape[0]
    t = torch.empty(R, dtype=torch.float32, device=device)
    ids = torch.empty(R, dtype=torch.int32, device=device)
    err = lib.sphere_obj_dense_launch(
        table16.data_ptr(), table16.shape[0],
        o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
        d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
        active.data_ptr(), R, t.data_ptr(), ids.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "sphere_obj_dense")
    return SphereHit(t=t, sph=ids)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("sphere_obj")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sphere_obj_launch.argtypes = [p, i, i, p, p, p, i, i, i, i, p, p, p,
                                      p, p, p, p, i, p, p, p]
    lib.sphere_obj_launch.restype = i
    lib.sphere_obj_dense_launch.argtypes = [p, i, p, p, p, p, p, p, p, i, p,
                                            p, p]
    lib.sphere_obj_dense_launch.restype = i
    lib.sphere_obj_error_string.argtypes = [i]
    lib.sphere_obj_error_string.restype = ctypes.c_char_p
    return lib
