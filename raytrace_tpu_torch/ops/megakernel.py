"""The fused bounce kernel: the CUDA kernel ``csrc/megakernel.cu`` and its
plain PyTorch version (counterpart of raytrace_tpu/ops/megakernel.py,
``render_tile_mega`` and ``megakernel_supported``).

One launch renders every pixel of the frame for ``n_batches`` consecutive
sample batches: each pixel's K = n_batches * spp samples are traced in
sample order and summed, so the result is the per-pixel radiance sums and
the per-pixel bounce counts.  ``render_tile_mega`` is the one entry point:
for tensors on the CPU it runs the plain version, for CUDA tensors it
launches the kernel on the current stream, or raises.  ``LAUNCHES`` counts
kernel launches, ``ANIM_LAUNCHES``, ``TRI_LAUNCHES``, ``LIGHT_LAUNCHES``,
``NOISE_LAUNCHES``, ``IMAGE_LAUNCHES`` and ``SPHERE_CLUSTER_LAUNCHES``
those of the animated, the triangle, the lit, the noise, the image and the
clustered-sphere forms, so a run can show that its main path went through
the kernel.

Spheres in clusters: a scene whose sphere block the compiler put in
Morton clusters (``SceneStatic.sph_prefix`` > 0, models/sphere_order.py)
takes the clustered twin of its form (``MegaConfig.n_sph_clusters`` > 0)
when the clusters number at most ``MAX_SPHERE_CLUSTERS``: the kernel
sweeps the prefix densely, then visits the clusters in ascending order,
slab-tests each cluster's box (``sphere_cluster_boxes``, built with the
batch's geometry as ``BatchGeometry.sph_boxes``, widened by the ray's
rounding margin, ``sphere_cluster_pretest``) against the ray's best t
so far, and tests the spheres of the clusters that pass with the dense
sweep's operations.  The result is the dense sweep's (t, id), bit for
bit: the JAX kernel's gather sweep (``_sweep`` :1389, ``_sweep_sieve``
:1005, ``_cluster_rounds_gather`` :550) as its contract, without its
TPU mechanisms (the MXU sieve, lane gathers, rounds and bands).  Such a
scene may hold MAX_SPHERES_CLUSTERED spheres, whose rows the clustered
forms read from global memory.  ``sphere_cluster_sweep_reference`` is
the clustered loop in plain PyTorch; ``megakernel_reference`` keeps the
dense sweep, the yardstick the kernel is held to.

The kernel covers spheres in world space, triangle soups in world space,
fat-row shading with constant, checker, noise and image textures, and
lights; ``megakernel_supported`` is that gate, decided from facts about
the scene.  Image textures take the kernel's image form
(``MegaConfig.has_image``) of its static, triangle and lit forms: the
spheres' normals come from their world-to-object rows (engine/wavefront.py
prepare_batch), and where a slot a hit reads is in image mode the kernel
samples the image at the hit's UV from the packed atlas
(``BatchGeometry.atlas_words``, engine/arrays.pack_atlas), at any bounce,
as the wavefront does.  The JAX kernel's item mode (image albedo shaded
as 1, each sample multiplied by its primary hit's texel afterwards, for
one convex sphere seen from outside: ``deferred_image_supported``,
``camera_outside_spheres``, ``_texel_factor``) is a TPU workaround and
has no counterpart here.  Noise textures take the
kernel's noise form (``MegaConfig.has_noise``) of any of its other forms:
the hit's turbulence (ops/perlin.py) is computed in the kernel where a
slot the hit reads is in noise mode.  Lights take the kernel's lit form
(``MegaConfig.lights``): the scene's light rows
(``SceneArrays.light_tri_packed``, the triangle and the alias table in
one 64-byte row) and the batch's instance transforms
(``BatchGeometry.inst_o2w_rows``) go to the kernel, which samples a light
point after every scattering hit as the wavefront does (ops/nee.py).
Triangles take the kernel's third form (``MegaConfig.tris``): the soup's
table (``tri_table12``) and its cluster boxes (``cluster_boxes``) come
with the batch's geometry, and the kernel tests the triangles of each
cluster whose box its ray may hit first, which gives the dense triangle
sweep's closest hit (ops/tri_sweep.py).
Animated spheres take one of two forms.  When every sphere moves on a
straight line at a constant radius (ops/spheres.world_sphere_anim_tables),
the geometry holds the spheres at shutter time 0 and their motion
(``BatchGeometry.sph_dtab8``), and the kernel's animated variant
(``MegaConfig.anim``, the JAX kernel's ``anim_lerp``) moves each sphere to
the time of the sample's batch, read from ``times``: one launch serves any
number of batches.  Otherwise the static kernel renders one batch per
launch from that batch's world table.

The TPU kernel's lane machinery (q-pixel lanes, snake permutations, pair
stealing), its row-fetch matmul, its MXU, sieve and selective sphere
sweeps are TPU mechanisms and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.sphere_order import effective_cluster_g
from . import _build, sphere_sweep, tri_sweep, vec3
from .intersect import T_MAX, T_MIN, Hit
from .spheres import SphereHit, intersect_spheres_world
from .vec3 import V3

# Launches of the kernel, of any form, and of its animated, triangle, lit,
# noise, image and clustered-sphere forms alone.
LAUNCHES = 0
ANIM_LAUNCHES = 0
TRI_LAUNCHES = 0
LIGHT_LAUNCHES = 0
NOISE_LAUNCHES = 0
IMAGE_LAUNCHES = 0
SPHERE_CLUSTER_LAUNCHES = 0

_N_PARAMS = 40  # csrc/megakernel.cu kNumParams
_USE_DOF, _HAS_CHECKER, _HAS_EMISSIVE, _HAS_NOISE, _HAS_IMAGE = 1, 2, 4, 8, 16

# The dense forms stage the sphere table in shared memory, of which a block
# may use 227 KiB on the H100.  A static sphere takes two float4 (32 B):
# 4096 spheres take 128 KiB.  An animated sphere takes three (48 B: its
# time-0 row, k with its motion terms k1 and k2, its centre's delta), so
# 4096 take 192 KiB, and the cap that fits is above the static one.
# Scenes with more spheres render on the wavefront, unless they are in
# clusters.
_SMEM_BYTES = 232_448
MAX_SPHERES = 4096
MAX_SPHERES_ANIM = min(MAX_SPHERES, (_SMEM_BYTES - 4 * _N_PARAMS) // 48)

# Spheres in clusters (models/sphere_order.py): at most MAX_SPHERE_CLUSTERS
# boxes of 32 B in shared memory (the JAX gather table's 128 lanes,
# raytrace_tpu/ops/megakernel.py:2607-2611), and so at most 128 x 128
# spheres (the JAX gate's ceiling, :2756-2781).  A clustered form reads
# the sphere rows from global memory through the read-only cache, where a
# ray reads only the rows of the clusters it enters; it stages only the
# boxes.  SPHERE_ROUNDING (32 u, u = 2^-24) scales the pretest's rounding
# margin (sphere_cluster_pretest).
MAX_SPHERE_CLUSTERS = 128
MAX_SPHERES_CLUSTERED = 16384
SPHERE_ROUNDING = 2.0 ** -19

# Triangles the kernel takes: a clustered soup (models/sphere_order.
# apply_triangle_order) of at most MAX_TRI_CLUSTERS clusters, each box 32 B
# of shared memory beside the sphere table, or a soup in file order of at
# most MAX_TRIANGLES_DENSE, swept as one cluster (the JAX gate's ceilings,
# raytrace_tpu/ops/megakernel.py:2756).
MAX_TRI_CLUSTERS = 128
MAX_TRIANGLES = 16384
MAX_TRIANGLES_DENSE = 2048
_BIGF = 3.0e37  # an empty cluster's box: a point the pretest never passes
_SLAB_EPS = 1e-30  # the pretest keeps |d| at least this in 1 / d


class MegaConfig(NamedTuple):
    """What one launch is specialised on (the fields of the JAX
    ``MegaConfig`` this kernel reads)."""

    width: int
    height: int
    sqrt_spp: int
    spp: int
    spp_local: int
    n_batches: int
    max_depth: int
    use_dof: bool
    has_checker: bool
    has_emissive: bool
    has_noise: bool
    has_image: bool
    anim: bool
    tris: bool
    lights: bool
    S8: int        # sphere table rows; also the primitive id of triangle 0
    P: int
    T8: int         # triangle table rows (0 without triangles)
    n_tris: int     # the real triangles, the rows the kernel sweeps
    tri_g: int      # triangles per cluster
    n_clusters: int
    n_sph: int      # the real spheres, the rows the kernel sweeps
    # The clustered sphere sweep: the dense prefix, spheres per cluster and
    # clusters (all 0 for a scene without the cluster layout).
    n_prefix: int
    sph_g: int
    n_sph_clusters: int


def sphere_cluster_layout(static):
    """(n_prefix, G, C) of the kernel's clustered sphere sweep, or None
    for a scene it sweeps densely: the scene's Morton cluster layout
    (``sph_prefix`` > 0) when its n_local = num_spheres - n_prefix spheres
    make at most MAX_SPHERE_CLUSTERS clusters of G =
    effective_cluster_g(n_local) (raytrace_tpu/ops/megakernel.py
    make_config :2602-2611, its default ``sweep="auto"``)."""
    n_prefix = static.sph_prefix
    if n_prefix <= 0:
        return None
    n_local = static.num_spheres - n_prefix
    G = effective_cluster_g(n_local)
    C = -(-n_local // G)
    return (n_prefix, G, C) if C <= MAX_SPHERE_CLUSTERS else None


def megakernel_supported(static) -> bool:
    """Scenes the fused kernel covers: spheres in world space (uniform
    scale, so the world table holds), fat-row shading, at most
    MAX_SPHERES_CLUSTERED spheres in clusters (``sphere_cluster_layout``),
    else at most MAX_SPHERES (MAX_SPHERES_ANIM when they move), and at
    most MAX_TRIANGLES triangles in clusters or MAX_TRIANGLES_DENSE in
    file order; with or
    without lights, with or without noise and image textures
    (raytrace_tpu/ops/megakernel.py:2743-2785, as one predicate; the JAX
    gate has no noise exclusion, whatever its comment at :107 says, and
    refuses images, which its deferred item mode takes for one convex
    sphere, :2788-2833: here the kernel samples any image at any hit).  The
    JAX gate's cap of 64 instances on lit scenes (:2783) is not carried over:
    it is the TPU's SMEM budget for the instance transforms, which this
    kernel reads from global memory.  Animated scenes are admitted under
    the JAX package's conditions for its fused animated kernel
    (raytrace_tpu/engine/renderer.py:468-472); a lit animated scene renders
    one launch per batch (the Renderer's ``fused_per_batch``).  A soup the
    Renderer put on the paged sweep (``bvh_mode`` "paged") is refused, as
    the JAX gate refuses any ``bvh_mode`` but "none" (:2752).  Every other
    scene renders on the wavefront.  The Renderer's triangle ceiling reads
    this gate too."""
    if sphere_cluster_layout(static) is not None:
        cap = MAX_SPHERES_CLUSTERED
    else:
        cap = MAX_SPHERES_ANIM if static.any_animated else MAX_SPHERES
    tri_max = (MAX_TRIANGLES if static.tri_cluster_g > 0
               else MAX_TRIANGLES_DENSE)
    return (static.bvh_mode == "none"
            and static.use_fat_shading
            and (static.sphere_world_mode or not static.has_spheres)
            and static.num_spheres <= cap
            and static.num_triangles <= tri_max)


def tri_group(static, T8: int) -> int:
    """Triangles per cluster of the kernel's traversal: the soup's own
    cluster size, or the whole soup as one cluster when it keeps its file
    order."""
    return static.tri_cluster_g if static.tri_cluster_g > 0 else T8


def tri_table12(table16: torch.Tensor) -> torch.Tensor:
    """[T8, 16] triangle table (ops/tri_sweep.pack_tri_table) → the
    kernel's [T8, 12]: three float4 a triangle, (v0, valid), (e1, 0),
    (e2, 0)."""
    out = torch.zeros((table16.shape[0], 12), dtype=torch.float32,
                      device=table16.device)
    out[:, 0:3] = table16[:, 0:3]
    out[:, 3] = table16[:, 9]
    out[:, 4:7] = table16[:, 3:6]
    out[:, 8:11] = table16[:, 6:9]
    return out


def cluster_boxes(table16: torch.Tensor, num_real: int,
                  G: int) -> torch.Tensor:
    """[C, 8] boxes (min xyz, 0, max xyz, 0) of the contiguous G-triangle
    clusters of the soup's first ``num_real`` rows, C = ceil(num_real / G),
    in f32: the min and max over each cluster's valid vertices v0, v0 + e1,
    v0 + e2, widened by 1e-5 + 1e-5 max(|min|, |max|)
    (raytrace_tpu/ops/megakernel.py:2442-2464).  A cluster without a valid
    triangle gets the point box at (_BIGF, _BIGF, _BIGF), far beyond T_MAX,
    which the pretest never passes (the JAX kernel's min > max box passes
    the slab test, whose min/max swap makes it the whole space, and its
    triangles then never hit)."""
    T8 = table16.shape[0]
    C = max(1, -(-num_real // G))
    grid = torch.zeros((C * G, 10), dtype=torch.float32,
                       device=table16.device)
    take = min(C * G, T8)
    grid[:take] = table16[:take, 0:10]
    g = grid.reshape(C, G, 10)
    v0 = g[..., 0:3]
    p1 = v0 + g[..., 3:6]
    p2 = v0 + g[..., 6:9]
    valid = g[..., 9:10] > 0.0
    mn = torch.where(valid, torch.minimum(torch.minimum(v0, p1), p2),
                     _BIGF).amin(dim=1)
    mx = torch.where(valid, torch.maximum(torch.maximum(v0, p1), p2),
                     -_BIGF).amax(dim=1)
    ipad = 1e-5 + 1e-5 * torch.maximum(mn.abs(), mx.abs())
    anyv = valid[:, :, 0].any(dim=1, keepdim=True)
    out = torch.zeros((C, 8), dtype=torch.float32, device=table16.device)
    out[:, 0:3] = torch.where(anyv, mn - ipad, _BIGF)
    out[:, 4:7] = torch.where(anyv, mx + ipad, _BIGF)
    return out


def _slab_pretest(o: V3, d: V3, lo, hi, best_t: torch.Tensor):
    """The kernel's slab test of the rays against boxes whose per-axis
    bounds lo[axis] and hi[axis] broadcast against them, pruned by each
    ray's best t so far: te <= tx, tx > T_MIN and te < best_t * 1.0001 +
    1e-4, with |d| kept at least _SLAB_EPS in 1 / d
    (raytrace_tpu/ops/megakernel.py:1262-1280)."""
    te = tx = None
    for oa, da, lo_a, hi_a in zip(o, d, lo, hi):
        iv = 1.0 / torch.where(da.abs() < _SLAB_EPS,
                               torch.where(da < 0.0, -_SLAB_EPS, _SLAB_EPS),
                               da)
        a0 = (lo_a - oa) * iv
        a1 = (hi_a - oa) * iv
        tn, tf = torch.minimum(a0, a1), torch.maximum(a0, a1)
        te = tn if te is None else torch.maximum(te, tn)
        tx = tf if tx is None else torch.minimum(tx, tf)
    return (te <= tx) & (tx > T_MIN) & (te < best_t * 1.0001 + 1e-4)


def cluster_pretest(o: V3, d: V3, boxes: torch.Tensor,
                    best_t: torch.Tensor) -> torch.Tensor:
    """[C, R] bool: the kernel's slab pretest of every ray against every
    cluster box, given each ray's best t so far; a cluster that fails
    cannot hold a hit closer than best_t (csrc/megakernel.cu sweep_tris)."""
    return _slab_pretest(o, d, [boxes[:, ax:ax + 1] for ax in range(3)],
                         [boxes[:, 4 + ax:5 + ax] for ax in range(3)],
                         best_t)


def sphere_cluster_boxes(table8: torch.Tensor, n_prefix: int, G: int,
                         C: int, dtab8=None) -> torch.Tensor:
    """[C, 8] boxes of the G-sphere clusters of the [S8, 8] table's rows
    past ``n_prefix``, in f32: columns 0:3 and 4:7 the min and max of
    c -/+ |r| over each cluster's valid rows (k < 1e37; rows past S8 are
    padding), widened by 1e-5 + 1e-5 max(|min|, |max|)
    (raytrace_tpu/ops/megakernel.py cluster_aabbs :2185-2207); column 3
    SPHERE_ROUNDING / the least positive radius and column 7 the most
    |c| + |r|, the terms of the pretest's rounding margin
    (``sphere_cluster_pretest``).  With ``dtab8`` (the spheres' linear
    motion, table8 at shutter time 0) a box is the union of the boxes at
    c0 and at c0 + dc, which holds the spheres at every time in [0, 1]:
    the radii are fixed (:2364-2378).  A cluster without a valid sphere
    gets the point box at (_BIGF, _BIGF, _BIGF) and no margin, which the
    pretest never passes (as ``cluster_boxes``)."""
    take = min(C * G, table8.shape[0] - n_prefix)
    grid = torch.zeros((C * G, 8), dtype=torch.float32, device=table8.device)
    grid[:, 4] = _BIGF
    grid[:take] = table8[n_prefix:n_prefix + take]

    def bounds(rows):
        g = rows.reshape(C, G, 8)
        c, r = g[..., 0:3], g[..., 3:4].abs()
        valid = g[..., 4:5] < 1e37
        mn = torch.where(valid, c - r, _BIGF).amin(dim=1)
        mx = torch.where(valid, c + r, -_BIGF).amax(dim=1)
        pad = 1e-5 + 1e-5 * torch.maximum(mn.abs(), mx.abs())
        reach = torch.where(valid[..., 0], torch.linalg.vector_norm(c, dim=-1)
                            + r[..., 0], 0.0).amax(dim=1)
        return mn - pad, mx + pad, reach

    mn, mx, reach = bounds(grid)
    if dtab8 is not None:
        moved = grid.clone()
        moved[:take, 0:3] = grid[:take, 0:3] + dtab8[n_prefix:n_prefix + take,
                                                     0:3]
        mn1, mx1, reach1 = bounds(moved)
        mn, mx = torch.minimum(mn, mn1), torch.maximum(mx, mx1)
        reach = torch.maximum(reach, reach1)
    g = grid.reshape(C, G, 8)
    radius = torch.where((g[..., 4] < 1e37) & (g[..., 3] > 0.0), g[..., 3],
                         _BIGF).amin(dim=1)
    anyv = (g[..., 4] < 1e37).any(dim=1, keepdim=True)
    out = torch.zeros((C, 8), dtype=torch.float32, device=table8.device)
    out[:, 0:3] = torch.where(anyv, mn, _BIGF)
    out[:, 4:7] = torch.where(anyv, mx, _BIGF)
    out[:, 3] = torch.where(radius < _BIGF, SPHERE_ROUNDING / radius, 0.0)
    out[:, 7] = reach
    return out


def sphere_cluster_pretest(o: V3, d: V3, box: torch.Tensor,
                           best_t: torch.Tensor) -> torch.Tensor:
    """[R] bool: the kernel's pretest of one sphere cluster's box
    (``sphere_cluster_boxes`` row) against every ray: the slab test and
    prune of ``cluster_pretest`` on the box widened by the ray's rounding
    margin m = (|o| + reach)^2 * box[3], reach = box[7] (csrc/megakernel.cu
    sweep_sphere_clusters).  m bounds how far outside a sphere the dense
    sweep's f32 quadratic can report a hit: its discriminant's error is
    below ~18 u a S^2 (S = |o| + |c| + |r|, u = 2^-24), so a reported hit
    lies within (S^2 * SPHERE_ROUNDING / (2 r)) of the sphere, and with
    SPHERE_ROUNDING = 32 u the margin also covers the error of the
    reported t.  Without it the JAX pad alone lets a ray from far away
    (|o| ~ 1,800 inside final-one-weekend's ground sphere) keep a hit the
    dense sweep does not report."""
    s = torch.sqrt(o.x * o.x + o.y * o.y + o.z * o.z) + box[7]
    m = s * s * box[3]
    return _slab_pretest(o, d, [box[ax] - m for ax in range(3)],
                         [box[4 + ax] + m for ax in range(3)], best_t)


def moved_table(table8: torch.Tensor, dtab8: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """The animated kernel's sphere table at shutter time t (a 0-dim f32
    tensor): c + t * dc and k + t * (k1 + t * k2), in f32
    (raytrace_tpu/ops/megakernel.py:1420-1436)."""
    out = table8.clone()
    out[:, 0:3] = table8[:, 0:3] + t * dtab8[:, 0:3]
    out[:, 4] = table8[:, 4] + t * (dtab8[:, 4] + t * dtab8[:, 5])
    return out


def sphere_cluster_sweep_reference(o: V3, d: V3, table8: torch.Tensor,
                                   boxes: torch.Tensor, n_prefix: int,
                                   G: int, dtab8=None, t=None, work=None):
    """The kernel's clustered sphere sweep in plain PyTorch: (t [R] f32,
    id [R] int32), (T_MAX, -1) on a miss.  The prefix is swept densely,
    then the clusters in ascending order, each pretested
    (``sphere_cluster_pretest``, the kernel's) against every ray's best t
    so far and its spheres tested, for the rays whose pretest passes,
    with the dense sweep's arithmetic (ops/spheres.intersect_spheres_world)
    under strict <.  With ``dtab8`` the spheres first move to time ``t``
    (``moved_table``).  A ``work`` dict gets the rays, the prefix tests,
    the box tests and the tests of the real spheres of the clusters that
    pass, summed."""
    if dtab8 is not None:
        table8 = moved_table(table8, dtab8, t)
    R = o.x.shape[0]
    dev = o.x.device
    best_t = torch.full((R,), T_MAX, dtype=torch.float32, device=dev)
    best_id = torch.full((R,), -1, dtype=torch.int32, device=dev)
    if n_prefix > 0:
        hit = intersect_spheres_world(o, d, table8[:n_prefix])
        best_t, best_id = hit.t, hit.sph
    real = (table8[:, 4] < 1e37).nonzero()
    n_real = int(real[-1]) + 1 if real.numel() else 0
    for c in range(boxes.shape[0]):
        j0, j1 = n_prefix + c * G, min(n_prefix + (c + 1) * G, n_real)
        rays = sphere_cluster_pretest(o, d, boxes[c], best_t).nonzero()[:, 0]
        if work is not None:
            work["box_tests"] = work.get("box_tests", 0) + R
            work["sphere_tests"] = (work.get("sphere_tests", 0)
                                    + rays.numel() * max(j1 - j0, 0))
        if rays.numel() == 0 or j1 <= j0:
            continue
        hit = intersect_spheres_world(V3(*(x[rays] for x in o)),
                                      V3(*(x[rays] for x in d)),
                                      table8[j0:j1])
        better = hit.t < best_t[rays]
        best_t[rays] = torch.where(better, hit.t, best_t[rays])
        best_id[rays] = torch.where(better, hit.sph + j0, best_id[rays])
    if work is not None:
        work["rays"] = work.get("rays", 0) + R
        work["prefix_tests"] = work.get("prefix_tests", 0) + R * n_prefix
    return best_t, best_id


def make_config(static, geom, use_dof: bool, n_batches: int) -> MegaConfig:
    spp = static.sqrt_spp ** 2
    tris = geom.tri_table12 is not None
    T8 = geom.tri_table12.shape[0] if tris else 0
    S8 = geom.sph_table8.shape[0]
    n_sph = min(S8, static.num_spheres)
    layout = sphere_cluster_layout(static)
    n_prefix, sph_g, n_sph_clusters = layout or (0, 0, 0)
    anim = geom.sph_dtab8 is not None
    return MegaConfig(
        width=static.width, height=static.height, sqrt_spp=static.sqrt_spp,
        spp=spp, spp_local=spp, n_batches=int(n_batches),
        max_depth=static.max_ray_depth, use_dof=bool(use_dof),
        has_checker=static.flags.has_checker,
        has_emissive=static.flags.has_emissive,
        has_noise=static.flags.has_noise,
        has_image=static.flags.has_image,
        anim=anim, tris=tris,
        lights=bool(static.has_lights),
        S8=S8, P=geom.prim_rows.shape[0], T8=T8,
        n_tris=min(T8, static.num_triangles),
        tri_g=tri_group(static, T8) if tris else 0,
        n_clusters=geom.tri_boxes.shape[0] if tris else 0,
        n_sph=n_sph, n_prefix=n_prefix, sph_g=sph_g,
        n_sph_clusters=n_sph_clusters)


def _float_params(cfg: MegaConfig, static, scene, cam) -> torch.Tensor:
    """The kernel's [40] f32 parameter block, built on the device: view
    and projection inverses (row-major), focal length, aperture, the sky
    colour (direction-independent, render_tile_mega :2894-2900),
    f32(1 / sqrt_spp), then in slots 38 and 39 the light count as f32 and
    the lights' total area (:2909-2910)."""
    from ..engine.wavefront import _background_v3

    dev = cam.view_inverse.device
    # Filled on the device: a copy from the host's pageable memory would
    # wait for the stream, and so for the work queued before this launch.
    recip = torch.full((1,), float(np.float32(1.0 / cfg.sqrt_spp)),
                       dtype=torch.float32, device=dev)
    out = torch.cat([
        cam.view_inverse.reshape(16), cam.proj_inverse.reshape(16),
        cam.focal_length.reshape(1), cam.aperture_size.reshape(1),
        torch.stack(list(_background_v3(static, scene))), recip,
        scene.light_count.to(torch.float32).reshape(1),
        scene.light_total_area.reshape(1)])
    return out


def geometry_at(geom, t: torch.Tensor):
    """An animated geometry at shutter time t (a 0-dim f32 tensor): the
    static geometry whose table and rows hold the moved spheres.  The
    arithmetic is the kernel's (``moved_table``, and the centre in the
    rows as raytrace_tpu/ops/megakernel.py:1876-1882 moves it)."""
    table8 = moved_table(geom.sph_table8, geom.sph_dtab8, t)
    rows = geom.prim_rows.clone()
    rows[:, 44:47] = rows[:, 44:47] + t * rows[:, 49:52]
    return geom._replace(sph_table8=table8, prim_rows=rows, sph_dtab8=None)


def megakernel_reference(static, scene, geom, cam, batch0: int,
                         n_batches: int = 1, sample_base: int = 0, *,
                         use_dof: bool, times=None):
    """The plain version of the kernel: (sums [H, W, 3] f32, traced
    [H, W] int32).  Each batch's pixel x sample rays go through the
    wavefront bounce loop with the plain sphere sweep (not the K1 kernel)
    and, for a soup, the plain dense triangle sweep over the soup in its
    stored order (not K2), the sphere keeping the hit at equal t as in the
    kernel; a pixel's samples are then summed in sample order, batch after
    batch, as the kernel sums them.  An animated geometry is moved to each
    batch's time, ``times[batch0 + b]``, first."""
    from ..engine.wavefront import (RawHit, bounce_wavefront, combine_hits,
                                    primary_rays)

    H, W = static.height, static.width
    spp = static.sqrt_spp ** 2
    dev = geom.sph_table8.device
    s_pad = scene.sph_center.shape[0]

    def trace(o: V3, d: V3, alive, g) -> RawHit:
        t, ids = sphere_sweep.sphere_sweep_reference(o, d, g.sph_table8)
        sph = SphereHit(t=torch.where(alive, t, T_MAX),
                        sph=torch.where(alive, ids, -1))
        tri = None
        if g.tri_table16 is not None:
            t, ids, u, v = tri_sweep.tri_sweep_reference(o, d, g.tri_table16)
            tri = Hit(t=torch.where(alive, t, T_MAX),
                      tri=torch.where(alive, ids, -1), u=u, v=v)
        return combine_hits(sph, tri, s_pad, ties_to_spheres=True)

    sums = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    traced = torch.zeros(H * W, dtype=torch.int32, device=dev)
    for b in range(n_batches):
        g = (geom if geom.sph_dtab8 is None
             else geometry_at(geom, times[batch0 + b]))
        state, o, d = primary_rays(static, cam, batch0 + b, 0, H, use_dof,
                                   dev, sample_base)
        counts = torch.zeros(H * W * spp, dtype=torch.int32, device=dev)
        radiance, _ = bounce_wavefront(
            static, scene, lambda o, d, alive, g=g: trace(o, d, alive, g),
            g, state, o, d, counts)
        rad = vec3.to_rows(radiance).reshape(H * W, spp, 3)
        for j in range(spp):
            sums = sums + rad[:, j]
        traced = traced + counts.reshape(H * W, spp).sum(1, dtype=torch.int32)
    return sums.reshape(H, W, 3), traced.reshape(H, W)


def _check_inputs(cfg: MegaConfig, scene, geom, params, times,
                  batch0: int) -> None:
    table8, rows = geom.sph_table8, geom.prim_rows
    device = table8.device
    if (table8.dtype != torch.float32 or table8.dim() != 2
            or table8.shape[1] != 8 or table8.shape[0] % 8
            or not table8.is_contiguous()):
        raise ValueError("sph_table8 must be a contiguous float32 [S8, 8] "
                         "tensor (S8 a multiple of 8)")
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[1] != 64 or rows.device != device
            or not rows.is_contiguous()):
        raise ValueError("prim_rows must be a contiguous float32 [P, 64] "
                         "tensor on the table's device")
    if params.device != device:
        raise ValueError("camera and scene must be on the table's device")
    if cfg.n_sph_clusters:
        _check_sphere_clusters(cfg, geom, device)
    else:
        cap = MAX_SPHERES_ANIM if cfg.anim else MAX_SPHERES
        if cfg.n_sph > cap:
            raise ValueError(f"{cfg.n_sph} spheres: the kernel holds at most "
                             f"{cap} outside clusters (megakernel_supported)")
    if table8.data_ptr() % 16:
        raise ValueError("sph_table8 must be 16-byte aligned (float4 loads)")
    if cfg.tris:
        _check_tris(cfg, geom, device)
    if cfg.lights:
        _check_lights(cfg, scene, geom, device)
    if cfg.has_image:
        _check_image(cfg, scene, geom, device)
    if not cfg.anim:
        return
    dtab = geom.sph_dtab8
    if (dtab.dtype != torch.float32 or dtab.shape != table8.shape
            or dtab.device != device or not dtab.is_contiguous()
            or dtab.data_ptr() % 16):
        raise ValueError("sph_dtab8 must be a contiguous, 16-byte aligned "
                         "float32 tensor shaped as sph_table8, on its device")
    if (times.dtype != torch.float32 or times.dim() != 1
            or times.device != device or not times.is_contiguous()
            or times.shape[0] < batch0 + cfg.n_batches):
        raise ValueError("times must be a contiguous float32 [B] tensor on "
                         "the table's device with a time for every batch")


def _check_sphere_clusters(cfg: MegaConfig, geom, device) -> None:
    boxes = geom.sph_boxes
    if boxes is None:
        raise ValueError("a scene with its spheres in clusters needs "
                         "sph_boxes (engine/wavefront.prepare_batch)")
    if (boxes.dtype != torch.float32
            or boxes.shape != (cfg.n_sph_clusters, 8)
            or boxes.device != device or not boxes.is_contiguous()
            or boxes.data_ptr() % 16):
        raise ValueError(f"sph_boxes must be a contiguous, 16-byte aligned "
                         f"float32 [{cfg.n_sph_clusters}, 8] tensor on the "
                         f"table's device")
    if (cfg.n_sph > MAX_SPHERES_CLUSTERED
            or cfg.n_sph_clusters > MAX_SPHERE_CLUSTERS
            or cfg.n_prefix + cfg.n_sph_clusters * cfg.sph_g < cfg.n_sph):
        raise ValueError(f"{cfg.n_sph} spheres in {cfg.n_sph_clusters} "
                         f"clusters of {cfg.sph_g}: the kernel holds at most "
                         f"{MAX_SPHERES_CLUSTERED} in {MAX_SPHERE_CLUSTERS} "
                         f"(megakernel_supported)")


def _check_tris(cfg: MegaConfig, geom, device) -> None:
    t12, boxes = geom.tri_table12, geom.tri_boxes
    if cfg.anim:
        raise ValueError("the animated form takes no triangles")
    if (t12.dtype != torch.float32 or t12.dim() != 2 or t12.shape[1] != 12
            or t12.device != device or not t12.is_contiguous()
            or t12.data_ptr() % 16):
        raise ValueError("tri_table12 must be a contiguous, 16-byte aligned "
                         "float32 [T8, 12] tensor on the table's device")
    if (boxes.dtype != torch.float32 or boxes.dim() != 2
            or boxes.shape[1] != 8 or boxes.device != device
            or not boxes.is_contiguous() or boxes.data_ptr() % 16):
        raise ValueError("tri_boxes must be a contiguous, 16-byte aligned "
                         "float32 [C, 8] tensor on the table's device")
    if cfg.n_clusters > MAX_TRI_CLUSTERS:
        raise ValueError(f"{cfg.n_clusters} triangle clusters: the kernel "
                         f"holds at most {MAX_TRI_CLUSTERS} "
                         f"(megakernel_supported)")


def _check_lights(cfg: MegaConfig, scene, geom, device) -> None:
    """Shapes and devices only, so no check waits on the card: the light
    count the kernel reads (``scene.light_count``) is the table's row
    count for any lit scene (models/compile.py _build_light_table)."""
    lights, o2w = scene.light_tri_packed, geom.inst_o2w_rows
    if cfg.anim:
        raise ValueError("the animated form takes no lights")
    if (lights.dtype != torch.float32 or lights.dim() != 2
            or lights.shape[0] < 1 or lights.shape[1] != 16
            or lights.device != device or not lights.is_contiguous()):
        raise ValueError("light_tri_packed must be a contiguous float32 "
                         "[L, 16] tensor (L >= 1) on the table's device")
    if o2w is None or (o2w.dtype != torch.float32 or o2w.dim() != 2
                       or o2w.shape != (scene.inst_t0.shape[0], 12)
                       or o2w.device != device or not o2w.is_contiguous()):
        raise ValueError("a lit geometry needs inst_o2w_rows, a contiguous "
                         "float32 [I, 12] tensor on the table's device")


def _check_image(cfg: MegaConfig, scene, geom, device) -> None:
    atlas, words = scene.atlas, geom.atlas_words
    if cfg.anim:
        raise ValueError("the animated form takes no image textures")
    if words is None:
        raise ValueError("an image scene's geometry needs atlas_words, the "
                         "packed atlas (engine/arrays.pack_atlas)")
    if (atlas.dtype != torch.uint8 or atlas.dim() != 4
            or atlas.shape[3] != 3):
        raise ValueError("the scene's atlas must be a uint8 [NI, AH, AW, 3] "
                         "tensor")
    if (words.dtype != torch.int32 or words.shape != atlas.shape[:3]
            or words.device != device or not words.is_contiguous()):
        raise ValueError("atlas_words must be a contiguous int32 [NI, AH, "
                         "AW] tensor, the atlas packed, on the table's "
                         "device")
    wh, lut = scene.atlas_wh, scene.srgb_lut
    if (wh.dtype != torch.int32 or wh.shape != (atlas.shape[0], 2)
            or wh.device != device or not wh.is_contiguous()):
        raise ValueError("atlas_wh must be a contiguous int32 [NI, 2] "
                         "tensor on the table's device")
    if (lut.dtype != torch.float32 or lut.shape != (256,)
            or lut.device != device or not lut.is_contiguous()):
        raise ValueError("srgb_lut must be a contiguous float32 [256] tensor "
                         "on the table's device")


def render_tile_mega(static, scene, geom, cam, batch0: int,
                     n_batches: int = 1, sample_base: int = 0, *,
                     use_dof: bool, reduce_mean: bool = False, times=None):
    """Render the whole frame for sample batches batch0 .. batch0 +
    n_batches - 1 in one launch.  Returns (image [H, W, 3] f32, traced
    [H, W] int32): the image is the per-pixel radiance sums over the
    K = n_batches * spp samples, or their mean with ``reduce_mean``;
    traced is each pixel's number of bounces.  An animated geometry
    (``geom.sph_dtab8``) needs ``times``, every batch's shutter time
    ([B] f32 on the geometry's device); a static one ignores it."""
    global LAUNCHES, ANIM_LAUNCHES, TRI_LAUNCHES, LIGHT_LAUNCHES
    global NOISE_LAUNCHES, IMAGE_LAUNCHES, SPHERE_CLUSTER_LAUNCHES
    device = geom.sph_table8.device
    cfg = make_config(static, geom, use_dof, n_batches)
    if cfg.anim and times is None:
        raise ValueError("an animated geometry needs the batch times")
    if device.type == "cpu":
        sums, traced = megakernel_reference(static, scene, geom, cam, batch0,
                                            n_batches, sample_base,
                                            use_dof=use_dof, times=times)
    elif device.type != "cuda":
        raise ValueError(f"no fused bounce kernel for device {device}")
    else:
        params = _float_params(cfg, static, scene, cam)
        _check_inputs(cfg, scene, geom, params, times, batch0)
        if cfg.tris and cfg.S8 != scene.sph_center.shape[0]:
            raise ValueError("the sphere table must have a row for every "
                             "sphere slot: triangle ids start after it")
        lib = library()
        H, W = cfg.height, cfg.width
        sums = torch.empty((H, W, 3), dtype=torch.float32, device=device)
        traced = torch.empty((H, W), dtype=torch.int32, device=device)
        flags = ((_USE_DOF if cfg.use_dof else 0)
                 | (_HAS_CHECKER if cfg.has_checker else 0)
                 | (_HAS_EMISSIVE if cfg.has_emissive else 0)
                 | (_HAS_NOISE if cfg.has_noise else 0)
                 | (_HAS_IMAGE if cfg.has_image else 0))
        image = cfg.has_image
        clustered = cfg.n_sph_clusters > 0
        err = lib.megakernel_launch(
            geom.sph_table8.data_ptr(),
            geom.sph_dtab8.data_ptr() if cfg.anim else None,
            times.data_ptr() if cfg.anim else None, cfg.n_sph,
            geom.tri_table12.data_ptr() if cfg.tris else None, cfg.n_tris,
            geom.tri_boxes.data_ptr() if cfg.tris else None, cfg.n_clusters,
            cfg.tri_g, cfg.S8,
            geom.sph_boxes.data_ptr() if clustered else None, cfg.n_prefix,
            cfg.sph_g, cfg.n_sph_clusters,
            scene.light_tri_packed.data_ptr() if cfg.lights else None,
            geom.inst_o2w_rows.data_ptr() if cfg.lights else None,
            geom.atlas_words.data_ptr() if image else None,
            scene.atlas_wh.data_ptr() if image else None,
            scene.atlas.shape[0], scene.atlas.shape[1], scene.atlas.shape[2],
            scene.srgb_lut.data_ptr() if image else None,
            geom.prim_rows.data_ptr(),
            cfg.P, params.data_ptr(), W, H, cfg.sqrt_spp, cfg.spp_local,
            cfg.n_batches, int(batch0), int(sample_base), cfg.max_depth,
            flags, sums.data_ptr(), traced.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"megakernel launch failed: CUDA error {err} "
                f"({lib.megakernel_error_string(err).decode()})")
        LAUNCHES += 1
        ANIM_LAUNCHES += cfg.anim
        TRI_LAUNCHES += cfg.tris
        LIGHT_LAUNCHES += cfg.lights
        NOISE_LAUNCHES += cfg.has_noise
        IMAGE_LAUNCHES += cfg.has_image
        SPHERE_CLUSTER_LAUNCHES += clustered
    if reduce_mean:
        sums = sums / float(np.float32(cfg.spp_local * cfg.n_batches))
    return sums, traced


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("megakernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.megakernel_launch.argtypes = [p, p, p, i, p, i, p, i, i, i, p, i, i,
                                      i, p, p, p, p, i, i, i, p, p, i, p,
                                      i, i, i, i, i, i, i, i, i, p, p, p]
    lib.megakernel_launch.restype = i
    lib.megakernel_error_string.argtypes = [i]
    lib.megakernel_error_string.restype = ctypes.c_char_p
    return lib
