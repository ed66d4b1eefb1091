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
``NOISE_LAUNCHES`` and ``IMAGE_LAUNCHES`` those of the animated, the
triangle, the lit, the noise and the image forms, so a run can show that
its main path went through the kernel.

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
stealing), its row-fetch matmul and its sub-linear sweeps are TPU
mechanisms and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build, sphere_sweep, tri_sweep, vec3
from .intersect import T_MAX, T_MIN, Hit
from .spheres import SphereHit
from .vec3 import V3

# Launches of the kernel, of any form, and of its animated, triangle, lit
# and noise forms alone.
LAUNCHES = 0
ANIM_LAUNCHES = 0
TRI_LAUNCHES = 0
LIGHT_LAUNCHES = 0
NOISE_LAUNCHES = 0
IMAGE_LAUNCHES = 0

_N_PARAMS = 40  # csrc/megakernel.cu kNumParams
_USE_DOF, _HAS_CHECKER, _HAS_EMISSIVE, _HAS_NOISE, _HAS_IMAGE = 1, 2, 4, 8, 16

# The kernel stages the sphere table in shared memory, of which a block
# may use 227 KiB on the H100.  A static sphere takes two float4 (32 B):
# 4096 spheres take 128 KiB.  An animated sphere takes three (48 B: its
# time-0 row, k with its motion terms k1 and k2, its centre's delta), so
# 4096 take 192 KiB, and the cap that fits is above the static one.
# Scenes with more spheres render on the wavefront.
_SMEM_BYTES = 232_448
MAX_SPHERES = 4096
MAX_SPHERES_ANIM = min(MAX_SPHERES, (_SMEM_BYTES - 4 * _N_PARAMS) // 48)

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


def megakernel_supported(static) -> bool:
    """Scenes the fused kernel covers: spheres in world space (uniform
    scale, so the world table holds), fat-row shading, at most MAX_SPHERES
    spheres (MAX_SPHERES_ANIM when they move), and at most MAX_TRIANGLES
    triangles in clusters or MAX_TRIANGLES_DENSE in file order; with or
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


def cluster_pretest(o: V3, d: V3, boxes: torch.Tensor,
                    best_t: torch.Tensor) -> torch.Tensor:
    """[C, R] bool: the kernel's slab pretest of every ray against every
    cluster box, given each ray's best t so far; a cluster that fails
    cannot hold a hit closer than best_t (csrc/megakernel.cu sweep_tris,
    raytrace_tpu/ops/megakernel.py:1262-1280)."""
    def inv(x):
        return 1.0 / torch.where(x.abs() < _SLAB_EPS,
                                 torch.where(x < 0.0, -_SLAB_EPS, _SLAB_EPS),
                                 x)

    te = tx = None
    for ax, (oa, da) in enumerate(zip(o, d)):
        iv = inv(da)
        a0 = (boxes[:, ax:ax + 1] - oa) * iv
        a1 = (boxes[:, 4 + ax:5 + ax] - oa) * iv
        tn, tf = torch.minimum(a0, a1), torch.maximum(a0, a1)
        te = tn if te is None else torch.maximum(te, tn)
        tx = tf if tx is None else torch.minimum(tx, tf)
    return (te <= tx) & (tx > T_MIN) & (te < best_t * 1.0001 + 1e-4)


def make_config(static, geom, use_dof: bool, n_batches: int) -> MegaConfig:
    spp = static.sqrt_spp ** 2
    tris = geom.tri_table12 is not None
    T8 = geom.tri_table12.shape[0] if tris else 0
    return MegaConfig(
        width=static.width, height=static.height, sqrt_spp=static.sqrt_spp,
        spp=spp, spp_local=spp, n_batches=int(n_batches),
        max_depth=static.max_ray_depth, use_dof=bool(use_dof),
        has_checker=static.flags.has_checker,
        has_emissive=static.flags.has_emissive,
        has_noise=static.flags.has_noise,
        has_image=static.flags.has_image,
        anim=geom.sph_dtab8 is not None, tris=tris,
        lights=bool(static.has_lights),
        S8=geom.sph_table8.shape[0], P=geom.prim_rows.shape[0], T8=T8,
        n_tris=min(T8, static.num_triangles),
        tri_g=tri_group(static, T8) if tris else 0,
        n_clusters=geom.tri_boxes.shape[0] if tris else 0)


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
    arithmetic is the kernel's: c + t * dc for each centre coordinate,
    k + t * (k1 + t * k2), in f32 (raytrace_tpu/ops/megakernel.py:1420-1436
    and :1876-1882)."""
    tab, dt = geom.sph_table8, geom.sph_dtab8
    table8 = tab.clone()
    table8[:, 0:3] = tab[:, 0:3] + t * dt[:, 0:3]
    table8[:, 4] = tab[:, 4] + t * (dt[:, 4] + t * dt[:, 5])
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
    cap = MAX_SPHERES_ANIM if cfg.anim else MAX_SPHERES
    if cfg.S8 > cap:
        raise ValueError(f"{cfg.S8} table rows: the kernel holds at most "
                         f"{cap} spheres (megakernel_supported)")
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
    global NOISE_LAUNCHES, IMAGE_LAUNCHES
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
        err = lib.megakernel_launch(
            geom.sph_table8.data_ptr(),
            geom.sph_dtab8.data_ptr() if cfg.anim else None,
            times.data_ptr() if cfg.anim else None, cfg.S8,
            geom.tri_table12.data_ptr() if cfg.tris else None, cfg.n_tris,
            geom.tri_boxes.data_ptr() if cfg.tris else None, cfg.n_clusters,
            cfg.tri_g, cfg.S8,
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
    if reduce_mean:
        sums = sums / float(np.float32(cfg.spp_local * cfg.n_batches))
    return sums, traced


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel's shared library, built from csrc/ at first use."""
    lib = _build.load_library("megakernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.megakernel_launch.argtypes = [p, p, p, i, p, i, p, i, i, i, p, p, p,
                                      p, i, i, i, p, p, i, p, i, i, i, i, i,
                                      i, i, i, i, p, p, p]
    lib.megakernel_launch.restype = i
    lib.megakernel_error_string.argtypes = [i]
    lib.megakernel_error_string.restype = ctypes.c_char_p
    return lib
