"""The wavefront path-tracing loop for analytic spheres in world space and
triangle soups (raytrace_tpu/engine/wavefront.py:87-871, the XLA wavefront
configuration with the packed triangle tables).

One sample batch is one geometry prepare plus one ``render_tile`` per row
tile.  A tile generates its pixel x sample wavefront and bounces it until
every ray has terminated or the depth limit is reached (the rayColour loop
of ray_gen.glsl:457-541 across the whole wavefront).  The loop runs on the
host, one bounce per iteration; each iteration reads the alive count once,
which both ends the loop and drives the tail compaction.

Covered here: spheres in world mode (the kernel K1: the scene's dense
prefix, then a walk of a tree over the rest), with direct normals, or in
a scene with an image texture with the normal and UV of the sphere's
world-to-object branch; spheres in object space, where an instance's
non-uniform scale makes an ellipsoid (the kernel H2, with that branch's
normal); triangles in a soup that keeps its compiled
order (the kernel K2, a walk of the soup's own tree) or, on a soup the
Renderer put in paged order, by a walk of a tree over it (the kernel K3),
or, on a soup the Renderer put in the order of its SAH or implicit BVH
(use_bvh=True), by a walk of that BVH (the kernel H1),
with their hit point, normal and UV
rebuilt from the packed position and attribute tables, fat-row shading
(constant, checker, noise and image textures) or, for a material graph the
fat row cannot encode, registry shading (ops/materials.py: each property
looked up in the scene's tables), next-event
estimation with lights (the alias-table light sample moved by the hit
instance's objectToWorld, and the 50/50 mixture of the light and material
pdfs); animated spheres and instances through per-batch geometry.

A tile may hold a range of the frame's rows and of each pixel's samples
(``render_tile``'s ``spp_local`` and ``sample_base``, for the sharded
renderer of parallel/multichip.py), and a batch's geometry may hold one
slice of the scene's primitives (``BatchGeometry.shard``): every bounce
then combines the slices' closest hits and fetches the winner's rows from
the slice that owns it, with collectives over the slices' process group
(``_sc_combine_hit``, ``_sc_decode``, ``_sc_fetch``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models.compile import SKY_SOLID, SKY_VERTICAL_GRADIENT

from ..ops import camera as cam_ops
from ..ops import (bvh, materials, megakernel, nee, paged_tri, perlin, rng,
                   shading, sphere_obj, sphere_sweep, sphere_tree, spheres, transforms,
                   tri_sweep, vec3)
from ..ops.intersect import T_MAX, Hit
from ..ops.materials import LIGHT_PDF
from ..ops.spheres import SphereHit
from ..ops.vec3 import V3
from .arrays import SceneArrays, SceneStatic

# The bvh_modes of use_bvh=True's trees, which the BVH walk H1 traces.
BVH_MODES = ("sah", "implicit")


class RawHit(NamedTuple):
    """Closest-hit output of the trace sweep."""

    missed: torch.Tensor     # [R] bool
    t: torch.Tensor          # [R] f32
    prim: torch.Tensor       # [R] int32: sphere i | s_pad + triangle j
    is_sphere: torch.Tensor  # [R] bool
    bu: torch.Tensor         # [R] f32 triangle barycentric u (0 for spheres)
    bv: torch.Tensor         # [R] f32


class HitRecord(NamedTuple):
    p: V3  # hit point
    n: V3  # unit geometric normal (not yet flipped to face the ray)
    # texture coordinates, in a scene with an image texture (else None)
    u: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None


class BatchGeometry(NamedTuple):
    """Per-batch world-space geometry.  For the fused kernel's animated
    variant the table and rows hold the spheres at shutter time 0 and
    ``sph_dtab8`` their linear motion (ops/spheres.world_sphere_anim_tables),
    so one geometry serves every batch.  The triangle fields are None for
    a scene without triangles (see ``prepare_tris``)."""

    # [S8, 8] the sweep kernel's table; None for spheres in object space
    sph_table8: Optional[torch.Tensor]
    prim_rows: torch.Tensor   # [P, 64] combined per-primitive rows
    # [S8, 8] motion rows (dc xyz, -, k1, k2), or None for a static table
    sph_dtab8: Optional[torch.Tensor] = None
    world_p: Optional[torch.Tensor] = None      # [T, 3, 3] world soup
    world_n: Optional[torch.Tensor] = None      # [T, 3, 3] unnormalised
    tri_table16: Optional[torch.Tensor] = None  # [T8, 16] ops/tri_sweep
    # [T8, 16] n0, n1 - n0, n2 - n0, uv0, uv1 - uv0, uv2 - uv0, pad
    tri_attr16: Optional[torch.Tensor] = None
    # [T8, 12] v0, e1, e2 each padded to four floats (ops/megakernel.
    # tri_table12): the rows the trees are built from.
    tri_table12: Optional[torch.Tensor] = None
    # The soup's tree: on a "paged" soup the one K3 walks
    # (ops/paged_tri.build_tri_tree), else the one K2 and the fused kernel
    # walk (ops/paged_tri.build_soup_tree, with its slot -> id table).
    tri_tree: Optional[paged_tri.TriTree] = None
    # [I, 12] every instance's objectToWorld at the batch's time, row-major
    # 3x4: the light sample's transform (raytrace_tpu/engine/wavefront.py:
    # 755, :875-876); None when the geometry was built without a time.
    inst_o2w_rows: Optional[torch.Tensor] = None
    # The fused kernel's copy of the image atlas (engine/arrays.pack_atlas),
    # in a scene with an image texture; the wavefront reads scene.atlas.
    atlas_words: Optional[torch.Tensor] = None
    # The tree over the spheres past the dense prefix
    # (ops/sphere_tree.build_sphere_tree; with sph_dtab8, its boxes hold the
    # spheres over the shutter): the fused kernel's, in a scene with its
    # spheres in clusters, or K1's on the wavefront
    # (ops/sphere_sweep.tree_prefix); None where neither walks one.
    sph_tree: Optional[sphere_tree.SphereTree] = None
    # [S8, 16] the spheres in object space at the batch's time
    # (ops/spheres.object_sphere_table), the table H2 sweeps where the
    # scene has no world-space sphere table; else None.
    sph_obj16: Optional[torch.Tensor] = None
    # The tree H2 walks over the world boxes of the spheres past the dense
    # prefix (ops/sphere_obj.build_object_tree), its rows this batch's;
    # None where H2 sweeps every sphere (ops/sphere_obj.tree_prefix).
    sph_obj_tree: Optional[sphere_tree.SphereTree] = None
    # The scene shard this geometry is a slice of (parallel/multichip.
    # SceneShard: its rank among the shards, their count, and its
    # all_reduce over them), or None for the whole scene.
    shard: Optional[object] = None


def _compact_size(R: int) -> int:
    """Next compaction size after R (0 = stop compacting)."""
    if R < 16384:
        return 0
    return max(2048, (R // 8 + 1023) // 1024 * 1024)


def _compact_schedule(R: int):
    """Descending wavefront sizes at which the bounce loop compacts."""
    sizes = []
    cur = R
    while True:
        nxt = _compact_size(cur)
        if nxt == 0 or nxt >= cur:
            break
        sizes.append(nxt)
        cur = nxt
    return sizes


def _background_v3(static: SceneStatic, scene: SceneArrays) -> V3:
    """Sky colour (quirk: direction-independent, ray_gen.glsl:442-455)."""
    if static.sky_type == SKY_SOLID:
        col = scene.sky_solid
    elif static.sky_type == SKY_VERTICAL_GRADIENT:
        f = scene.sky_factor
        col = scene.sky_top * (1.0 - f) + scene.sky_bottom * f
    else:
        col = torch.zeros(3, dtype=torch.float32, device=scene.sky_top.device)
    return V3(col[0], col[1], col[2])


def tri_attr_table(world_n: torch.Tensor, tri_uv: torch.Tensor,
                   T8: int) -> torch.Tensor:
    """[T8, 16] attribute rows: n0, n1 - n0, n2 - n0, uv0, uv1 - uv0,
    uv2 - uv0, pad (raytrace_tpu/engine/wavefront.py:821-838)."""
    T = world_n.shape[0]
    n0 = world_n[:, 0, :]
    uv0 = tri_uv[:, 0, :]
    att = torch.zeros((T8, 16), dtype=torch.float32, device=world_n.device)
    att[:T, 0:3] = n0
    att[:T, 3:6] = world_n[:, 1, :] - n0
    att[:T, 6:9] = world_n[:, 2, :] - n0
    att[:T, 9:11] = uv0
    att[:T, 11:13] = tri_uv[:, 1, :] - uv0
    att[:T, 13:15] = tri_uv[:, 2, :] - uv0
    return att


def world_soup(scene: SceneArrays, batch_time: torch.Tensor):
    """(instance matrices, world_p, world_n) of the soup at a batch time (a
    0-dim f32 tensor)."""
    mats = transforms.interpolate_instances(scene.inst_t0, scene.inst_t1,
                                            batch_time)
    return (mats, *transforms.transform_soup(scene.tri_p, scene.tri_n,
                                             scene.tri_inst, mats))


def prepare_tris(static: SceneStatic, scene: SceneArrays,
                 batch_time: torch.Tensor,
                 order: Optional[torch.Tensor] = None) -> dict:
    """The triangle fields of a BatchGeometry for one batch time (a 0-dim
    f32 tensor): the instances go to that time, the soup to world space,
    then the packed position and attribute tables and the soup's tree: on
    a "paged" soup the paged sweep's, on a soup in the order of its SAH or
    implicit BVH none (the BVH is the scene's, ``scene.bvh_child_boxes``,
    and H1 reads the batch's [T8, 12] rows), else the one K2 and the fused
    kernel walk, over the Morton order ``order`` (ops/paged_tri.soup_order;
    taken from this batch's soup when not given)
    (raytrace_tpu/engine/wavefront.py:779-839,
    :881-890).  A static scene builds them once; a moving one every batch
    (the tree re-fitted over the same order: the Renderer passes the order
    of its first batch time; a BVH keeps its shutter-wide boxes)."""
    mats, world_p, world_n = world_soup(scene, batch_time)
    table16 = tri_sweep.pack_tri_table(world_p, static.num_triangles)
    T8 = table16.shape[0]
    table12 = megakernel.tri_table12(table16)
    out = dict(inst_o2w_rows=_o2w_rows(mats), world_p=world_p,
               world_n=world_n, tri_table16=table16,
               tri_attr16=tri_attr_table(world_n, scene.tri_uv, T8),
               tri_table12=table12)
    n = static.num_triangles
    if static.bvh_mode == "paged":
        out["tri_tree"] = paged_tri.build_tri_tree(world_p, n, table12)
    elif static.bvh_mode not in BVH_MODES and n > 0:
        if order is None:
            order = paged_tri.soup_order(world_p, n)
        out["tri_tree"] = paged_tri.build_soup_tree(world_p, n, table12,
                                                    order)
    return out


def object_table(scene: SceneArrays, batch_time: torch.Tensor) -> torch.Tensor:
    """The [S8, 16] object-space sphere table at a batch time (a 0-dim f32
    tensor), as ``prepare_batch`` builds H2's: each sphere's instance's
    world-to-object map at that time, its centre and radius."""
    w2o = transforms.interpolate_instances(
        scene.inst_t0, scene.inst_t1, batch_time).world_to_object
    return spheres.object_sphere_table(w2o[scene.sph_inst.long()],
                                       scene.sph_center, scene.sph_radius)


def _o2w_rows(mats: transforms.InstanceMatrices) -> torch.Tensor:
    return mats.object_to_world.reshape(-1, 12).contiguous()


def sphere_prefix(static: SceneStatic, fused: bool) -> Optional[int]:
    """The dense prefix before the sphere tree that the path walks, or
    None where it walks none: the fused kernel's clustered layout
    (ops/megakernel.sphere_cluster_layout), or K1's on the wavefront
    (ops/sphere_sweep.tree_prefix)."""
    if fused:
        layout = megakernel.sphere_cluster_layout(static)
        return None if layout is None else layout[0]
    return sphere_sweep.tree_prefix(static)


def prepare_batch(static: SceneStatic, scene: SceneArrays,
                  sph_table: Optional[torch.Tensor],
                  sph_dtab: Optional[torch.Tensor] = None,
                  tris: Optional[dict] = None,
                  batch_time: Optional[torch.Tensor] = None,
                  atlas_words: Optional[torch.Tensor] = None,
                  fused: bool = False,
                  sph_order: Optional[torch.Tensor] = None,
                  sph_tree: Optional[sphere_tree.SphereTree] = None,
                  shard=None,
                  obj_order: Optional[torch.Tensor] = None,
                  obj_tree: Optional[sphere_tree.SphereTree] = None
                  ) -> BatchGeometry:
    """Kernel tables and per-primitive rows for one batch.

    sph_table: [S, 5] world sphere rows at the batch time
    (ops/spheres.world_sphere_tables), or at shutter time 0 when
    ``sph_dtab`` ([S8, 8], ops/spheres.world_sphere_anim_tables) gives the
    spheres' linear motion; None for spheres in object space (a scene with
    no world table: the Renderer's ``sphere_world_mode`` False), which
    take the world-to-object branch's rows below and H2's table
    ``sph_obj16`` at ``batch_time`` with the tree H2 walks past the dense
    prefix (ops/sphere_obj.tree_prefix): ``obj_tree`` where it is given
    (built once where no sphere instance moves; its sphere rows are taken
    again from this batch's table), else built over this batch's table in
    the order ``obj_order`` (ops/sphere_obj.object_order, fixed once per
    Renderer; taken from this table when not given).
    A scene with triangles takes ``tris``, the
    fields ``prepare_tris`` built for the batch's time, with the instances'
    objectToWorld rows at that time; a scene with lights and without
    triangles takes ``batch_time`` (a 0-dim f32 tensor) for those rows
    (a scene without lights needs none).  Rows of
    ``prim_rows`` (a sphere slot's, then a triangle slot's): [0:32] the
    fat shading row (zero for registry shading) |
    [44:47] world center | [47] world radius | [48] instance id | [49:52]
    the center's motion delta when ``sph_dtab`` is given; a triangle's row
    holds its normal rows n0, dn1, dn2 in [49:58] (the JAX megakernel's
    _SLOT_TRIN); the rest stay zero
    (raytrace_tpu/engine/wavefront.py:845-871, direct-normal branch).
    A scene with an image texture takes JAX's other branch, which needs
    ``batch_time``: a sphere's row holds its world-to-object matrix at
    that time in [32:44] and its object-space center and radius in
    [44:48]; a triangle's row also holds uv0, uv1 - uv0 and uv2 - uv0 in
    [58:64], for the fused kernel, which reads ``atlas_words`` (the
    packed atlas, engine/arrays.pack_atlas) where the wavefront reads the
    scene's atlas.  The spheres past a dense prefix get the tree over
    them where a kernel walks one (``sphere_prefix``): with ``fused`` (the
    geometry feeds the fused kernel), a scene with its spheres in clusters;
    without it, K1 on the wavefront.  The tree is ``sph_tree`` where it is
    given (a static scene's, built once), else built on the table's
    device in the Morton order ``sph_order`` (ops/sphere_tree.sphere_order,
    [n] int32, fixed once per Renderer; taken from this table's centres,
    at shutter time 0.5 with ``sph_dtab``, when not given) over this
    table: a moving scene's wavefront table is at the batch's time, so
    its tree is built again each batch over the same order.  ``shard``
    (parallel/multichip.SceneShard) marks a geometry built from one slice
    of the scene's primitives.
    """
    s_pad = scene.sph_center.shape[0]
    P = s_pad + scene.tri_inst.shape[0]
    rows = torch.zeros((P, 64), dtype=torch.float32,
                       device=scene.sph_center.device)
    if static.use_fat_shading:
        rows[:, 0:32] = scene.shade_rows
    image = static.flags.has_image
    object_space = sph_table is None
    if object_space and fused:
        raise ValueError("spheres in object space (no world table) render "
                         "on the wavefront only")
    if image or object_space:
        if batch_time is None:
            raise ValueError("a scene with an image texture or spheres in "
                             "object space needs the batch time (its "
                             "spheres' world-to-object rows)")
        w2o = transforms.interpolate_instances(
            scene.inst_t0, scene.inst_t1, batch_time).world_to_object
        rows[:s_pad, 32:44] = w2o[scene.sph_inst.long()].reshape(s_pad, 12)
        rows[:s_pad, 44:47] = scene.sph_center
        rows[:s_pad, 47] = scene.sph_radius
    else:
        rows[:s_pad, 44:47] = sph_table[:s_pad, 0:3]
        rows[:s_pad, 47] = sph_table[:s_pad, 3]
    rows[:s_pad, 48] = scene.sph_inst.to(torch.float32)
    rows[s_pad:, 48] = scene.tri_inst.to(torch.float32)
    if sph_dtab is not None:
        rows[:s_pad, 49:52] = sph_dtab[:s_pad, 0:3]
    if static.has_tris:
        if tris is None:
            raise ValueError("a scene with triangles needs prepare_tris's "
                             "tables")
        att = tris["tri_attr16"]
        T = min(att.shape[0], P - s_pad)
        rows[s_pad:s_pad + T, 49:58] = att[:T, 0:9]
        if image:
            rows[s_pad:s_pad + T, 58:64] = att[:T, 9:15]
    extra = dict(tris or {})
    if tris is None and batch_time is not None and static.has_lights:
        extra["inst_o2w_rows"] = _o2w_rows(transforms.interpolate_instances(
            scene.inst_t0, scene.inst_t1, batch_time))
    if static.has_lights and extra.get("inst_o2w_rows") is None:
        raise ValueError("a scene with lights needs the batch time (or "
                         "prepare_tris's tables)")
    if object_space:
        table16 = spheres.object_sphere_table(
            rows[:s_pad, 32:44].reshape(s_pad, 3, 4), scene.sph_center,
            scene.sph_radius)
        n_sph = min(static.num_spheres, s_pad)
        if obj_tree is not None:
            obj_tree = obj_tree._replace(
                rows=table16[obj_tree.ids.long()].contiguous())
        else:
            if obj_order is None:
                n_prefix = sphere_obj.tree_prefix(static, table16)
                if n_prefix is not None:
                    obj_order = sphere_obj.object_order(table16, n_prefix,
                                                        n_sph)
            if obj_order is not None:
                obj_tree = sphere_obj.build_object_tree(
                    table16, n_sph, n_sph - obj_order.shape[0], obj_order)
        return BatchGeometry(
            sph_table8=None, prim_rows=rows, atlas_words=atlas_words,
            shard=shard, sph_obj16=table16, sph_obj_tree=obj_tree, **extra)
    table8 = sphere_sweep.pad_table8(sph_table)
    n_prefix = sphere_prefix(static, fused)
    if n_prefix is not None and sph_tree is None:
        n_sph = min(table8.shape[0], static.num_spheres)
        if sph_order is None:
            mid = table8[:, 0:3] if sph_dtab is None else (
                table8[:, 0:3] + 0.5 * sph_dtab[:, 0:3])
            sph_order = torch.tensor(
                sphere_tree.sphere_order(mid.cpu().numpy(), n_prefix, n_sph),
                dtype=torch.int32, device=table8.device)
        sph_tree = sphere_tree.build_sphere_tree(
            table8, n_prefix, n_sph, sph_order, dtab8=sph_dtab)
    if n_prefix is not None:
        extra["sph_tree"] = sph_tree
    return BatchGeometry(sph_table8=table8, prim_rows=rows,
                         sph_dtab8=sph_dtab, atlas_words=atlas_words,
                         shard=shard, **extra)


def combine_hits(sph: Optional[SphereHit], tri: Optional[Hit], s_pad: int,
                 ties_to_spheres: bool = False) -> RawHit:
    """The nearer of the sphere and triangle closest hits (either may be
    None when the scene has no such primitive).  At equal t the triangle
    wins, as in the JAX wavefront, or the sphere with ``ties_to_spheres``,
    as in the fused kernel, which sweeps the spheres first."""
    if tri is None:
        zeros = torch.zeros_like(sph.t)
        return RawHit(missed=sph.t >= T_MAX, t=sph.t,
                      prim=torch.clamp_min(sph.sph, 0),
                      is_sphere=torch.ones_like(sph.t, dtype=torch.bool),
                      bu=zeros, bv=zeros)
    tri_prim = s_pad + torch.clamp_min(tri.tri, 0)
    if sph is None:
        return RawHit(missed=tri.t >= T_MAX, t=tri.t, prim=tri_prim,
                      is_sphere=torch.zeros_like(tri.t, dtype=torch.bool),
                      bu=tri.u, bv=tri.v)
    sphere_wins = ~(tri.t < sph.t) if ties_to_spheres else sph.t < tri.t
    t = torch.minimum(tri.t, sph.t)
    return RawHit(missed=t >= T_MAX, t=t,
                  prim=torch.where(sphere_wins, torch.clamp_min(sph.sph, 0),
                                   tri_prim),
                  is_sphere=sphere_wins,
                  bu=torch.where(sphere_wins, 0.0, tri.u),
                  bv=torch.where(sphere_wins, 0.0, tri.v))


def bvh_tree(static: SceneStatic,
             scene: SceneArrays) -> Optional[bvh.BVHTree]:
    """The scene's BVH as H1 walks it (its four-wide rows, their root and
    the wide walk's stack from the binary depth), on a soup in the order
    of its SAH or implicit BVH; else None."""
    if static.bvh_mode not in BVH_MODES:
        return None
    return bvh.BVHTree(nodes=scene.bvh_child_boxes, root=static.bvh_root,
                       stack_depth=bvh.wide_stack(static.bvh_stack_depth - 2),
                       leaf=static.bvh_leaf_size,
                       num_tris=static.num_triangles)




def make_trace_fn(static: SceneStatic, scene: SceneArrays,
                  geom: BatchGeometry) -> Callable:
    """trace(o, d, alive) -> RawHit for this batch: the triangle sweep
    (K2 over the soup's tree, the paged sweep K3 on a "paged" soup, or the
    BVH walk H1 on a soup in the order of its SAH or implicit BVH), then
    the sphere sweep (K1, over the batch's sphere tree where it has one,
    or H2 where the batch's spheres are in object space, ``sph_obj16``,
    over the batch's ``sph_obj_tree`` where it has one),
    each only where the scene has such primitives
    (raytrace_tpu/engine/wavefront.py:138-232).  Raises where the batch's
    sphere tree is not the one K1 walks
    (``sphere_sweep.tree_prefix``): K1 sweeps every sphere only where no
    tree pays, never for want of one.  On a geometry of one scene slice
    (``geom.shard``) the slices' hits are combined (``_sc_combine_hit``),
    and the hit's primitive id is a global one; a slice that holds no real
    triangle sweeps none."""
    s_pad = scene.sph_center.shape[0]
    n_prefix = sphere_sweep.tree_prefix(static)
    tree = geom.sph_tree
    sweep_spheres = static.has_spheres or not static.has_tris
    tri_bvh = bvh_tree(static, scene)
    if (geom.sph_obj16 is None and sweep_spheres
            and (None if tree is None else tree.n_prefix) != n_prefix):
        want = ("no tree" if n_prefix is None
                else f"a tree past the first {n_prefix} spheres")
        got = ("none" if tree is None
               else f"one past the first {tree.n_prefix}")
        raise ValueError(f"K1 walks {want} here (ops/sphere_sweep."
                         f"tree_prefix); the batch's geometry has {got}: "
                         f"build it with prepare_batch(fused=False)")

    def trace(o: V3, d: V3, alive) -> RawHit:
        tri = sph = None
        if static.bvh_mode == "paged":
            tri = paged_tri.intersect_tris_paged(o, d, geom.tri_tree, alive)
        elif tri_bvh is not None:
            tri = bvh.intersect_tris_bvh(o, d, geom.tri_table12, tri_bvh,
                                         alive)
        elif static.has_tris and static.num_triangles > 0:
            tri = tri_sweep.intersect_tris_sweep(o, d, geom.tri_table16,
                                                 alive, geom.tri_tree)
        if geom.sph_obj16 is not None:
            sph = sphere_obj.intersect_spheres_object(
                o, d, geom.sph_obj16, alive, geom.sph_obj_tree)
        elif sweep_spheres or tri is None:
            sph = sphere_sweep.intersect_spheres_sweep(
                o, d, geom.sph_table8, alive, geom.sph_tree)
        raw = combine_hits(sph, tri, s_pad)
        if geom.shard is None:
            return raw
        return _sc_combine_hit(geom.shard, raw, s_pad,
                               geom.prim_rows.shape[0])

    return trace


def _sc_combine_hit(shard, rh: RawHit, s_pad: int, P_loc: int) -> RawHit:
    """The closest hit over the scene slices (raytrace_tpu/engine/
    wavefront.py:240-273): each slice swept its own primitives, and ``rh``
    holds its local ids (a sphere below ``s_pad``, a triangle ``s_pad`` +
    j in a slice of ``P_loc`` rows).  The tie key is family-major and
    rank-major over local ids, as the whole scene's sweep orders its hits:
    at equal t a triangle beats a sphere (``combine_hits``), and within a
    family the lowest original index wins (each kernel keeps its lowest id
    on ties, and the slices are contiguous, so rank-major local order is
    original order; a duplicate of ``_pad_dup`` sits at a higher id and
    never wins).  One all_reduce MIN over the int64 (t bits, key) picks the
    winner (t is finite and not negative, so its bits order as it does),
    and one all_reduce SUM of the winner's fields as int32 bits, a single
    nonzero term a lane, carries them to every slice bit for bit.  The
    returned prim is global: rank * P_loc + the local id."""
    rank, n_sc = shard.rank, shard.count
    t_span = P_loc - s_pad
    fam_key = torch.where(rh.is_sphere,
                          n_sc * t_span + rank * s_pad + rh.prim,
                          rank * t_span + (rh.prim - s_pad)).to(torch.int64)
    t_bits = rh.t.view(torch.int32).to(torch.int64)
    key = (t_bits << 32) | fam_key
    best = shard.all_reduce(key, "min")
    win = key == best
    t = (best >> 32).to(torch.int32).view(torch.float32)
    fields = torch.stack([rank * P_loc + rh.prim,
                          rh.is_sphere.to(torch.int32),
                          rh.bu.view(torch.int32), rh.bv.view(torch.int32)])
    fields = shard.all_reduce(torch.where(win, fields, 0), "sum")
    return RawHit(missed=t >= T_MAX, t=t, prim=fields[0],
                  is_sphere=fields[1] > 0,
                  bu=fields[2].view(torch.float32),
                  bv=fields[3].view(torch.float32))


def _sc_decode(shard, P_loc: int, prim):
    """A global primitive id → (its local id, whether this slice owns it)
    under scene sharding (raytrace_tpu/engine/wavefront.py:276-283)."""
    return prim % P_loc, (prim // P_loc) == shard.rank


def _sc_fetch(shard, mine, rows):
    """Rows gathered from a slice's table, each kept by the slice that owns
    it and zeroed elsewhere, summed over the slices as int32 bits: one
    nonzero term a lane, so every slice gets the owner's rows bit for bit
    (raytrace_tpu/engine/wavefront.py:286-292)."""
    mask = mine.reshape(mine.shape + (1,) * (rows.dim() - 1))
    bits = torch.where(mask, rows.view(torch.int32), 0)
    return shard.all_reduce(bits, "sum").view(torch.float32)


def reconstruct_hit(raw: RawHit, ray_o: V3, ray_d: V3, rows,
                    geom: BatchGeometry, s_pad: int,
                    has_image: bool = False,
                    object_space: bool = False,
                    prim=None, fetch=None) -> HitRecord:
    """RawHit → HitRecord.  A sphere's normal is the direct one from the
    fat rows, (hit - c_world) / r_world; a triangle's hit point is
    v0 + u e1 + v e2 from the position table and its normal the
    barycentric lerp of the attribute rows; the pair is chosen per ray,
    then normalised (raytrace_tpu/engine/wavefront.py:321-341, :355-365,
    :388-399).

    With ``has_image``, or ``object_space`` (spheres without a world
    table), the sphere takes JAX's world-to-object branch (:366-386) from
    the rows of ``prepare_batch``: the hit point moved to object space,
    the object normal (p_obj - c) / r taken back to world space by the
    transposed matrix; with ``has_image`` also the UV of the tessellator's
    parameterisation, v = arccos(-n.y) / pi and u = arctan2(n.z, -n.x) /
    2 pi floor-mod 1, of the unit object normal; a triangle's UV is the
    barycentric lerp of its attribute rows' uv0, duv1, duv2.  On a scene
    slice, ``prim`` is the hit's local id and ``fetch`` combines the rows
    read from the slice's tables over the slices (``_sc_fetch``)."""
    p = ray_o + raw.t * ray_d
    r = rows[:, 47]
    inv_r = 1.0 / torch.where(r == 0.0, 1.0, r)
    su = sv = None
    if has_image or object_space:
        m_cols = tuple(rows[:, 32 + i] for i in range(12))
        p_obj = vec3.mat34_apply_point(m_cols, p)
        n_obj = V3((p_obj.x - rows[:, 44]) * inv_r,
                   (p_obj.y - rows[:, 45]) * inv_r,
                   (p_obj.z - rows[:, 46]) * inv_r)
        n = vec3.mat34_apply_transposed_vec(m_cols, n_obj)
    if has_image:
        nn = vec3.normalize(n_obj)
        sv = torch.arccos(torch.clamp(-nn.y, -1.0, 1.0)) / spheres.PI
        su = torch.remainder(torch.arctan2(nn.z, -nn.x) / spheres.TWO_PI,
                             1.0)
    if not (has_image or object_space):
        c = V3(rows[:, 44], rows[:, 45], rows[:, 46])
        n = V3((p.x - c.x) * inv_r, (p.y - c.y) * inv_r, (p.z - c.z) * inv_r)
    if geom.tri_table16 is not None:
        tri = torch.clamp_min((raw.prim if prim is None else prim) - s_pad, 0)
        pos = geom.tri_table16[torch.clamp(tri, 0,
                                           geom.tri_table16.shape[0] - 1)]
        att = geom.tri_attr16[torch.clamp(tri, 0,
                                          geom.tri_attr16.shape[0] - 1)]
        if fetch is not None:
            pos, att = fetch(pos), fetch(att)
        bu, bv = raw.bu, raw.bv
        tp = V3(pos[:, 0] + bu * pos[:, 3] + bv * pos[:, 6],
                pos[:, 1] + bu * pos[:, 4] + bv * pos[:, 7],
                pos[:, 2] + bu * pos[:, 5] + bv * pos[:, 8])
        tn = V3(att[:, 0] + bu * att[:, 3] + bv * att[:, 6],
                att[:, 1] + bu * att[:, 4] + bv * att[:, 7],
                att[:, 2] + bu * att[:, 5] + bv * att[:, 8])
        p = vec3.where(raw.is_sphere, p, tp)
        n = vec3.where(raw.is_sphere, n, tn)
        if has_image:
            tu = att[:, 9] + bu * att[:, 11] + bv * att[:, 13]
            tv = att[:, 10] + bu * att[:, 12] + bv * att[:, 14]
            su = torch.where(raw.is_sphere, su, tu)
            sv = torch.where(raw.is_sphere, sv, tv)
    return HitRecord(p=p, n=vec3.normalize(n), u=su, v=sv)


def registry_material(static: SceneStatic, scene: SceneArrays, raw: RawHit):
    """(material type, material index, instance) of each hit, looked up by
    primitive in the scene's tables: the registry path's counterpart of
    the fat row's slots 0 and 48 (raytrace_tpu/engine/wavefront.py:
    405-420)."""
    s_pad = scene.sph_center.shape[0]
    sid = torch.clamp_max(raw.prim, s_pad - 1).long()
    tri = torch.clamp_min(raw.prim - s_pad, 0).long()
    sph = (scene.sph_mat_type[sid], scene.sph_mat_index[sid],
           scene.sph_inst[sid])
    if not static.has_tris:
        return sph
    tris = (scene.tri_mat_type[tri], scene.tri_mat_index[tri],
            scene.tri_inst[tri])
    if not static.has_spheres:
        return tris
    return tuple(torch.where(raw.is_sphere, a, b) for a, b in zip(sph, tris))


def _registry_scatter(state, scene: SceneArrays, static: SceneStatic,
                      mat_type, mat_index, rec: HitRecord, normal: V3,
                      front, ray_d: V3, alive):
    """Registry scatter and emission (raytrace_tpu/engine/wavefront.py:
    428-453): a dead ray's material type is 0, the [R, 3] rows of
    ops/materials.py at the boundary and V3 back.  One turbulence at the
    hit point serves every property."""
    mat_type = torch.where(alive, mat_type, 0)
    p_rows = vec3.to_rows(rec.p)
    turb = (perlin.turbulence(p_rows, 7) if static.flags.has_noise
            else None)
    emit = materials.calculate_emission(scene, static.flags, mat_type,
                                        mat_index, p_rows, front, rec.u,
                                        rec.v, turb=turb)
    state, srec = materials.calculate_scatter(
        state, scene, static.flags, mat_type, mat_index, p_rows,
        vec3.to_rows(normal), front, rec.u, rec.v, vec3.to_rows(ray_d),
        turb=turb)
    rows3 = lambda a: V3(a[:, 0], a[:, 1], a[:, 2])  # noqa: E731
    return state, shading.ScatterV3(
        is_scattered=srec.is_scattered, attenuation=rows3(srec.attenuation),
        mat_pdf_type=srec.mat_pdf_type, skip_pdf=srec.skip_pdf,
        skip_dir=rows3(srec.skip_dir)), rows3(emit)


class _Wave(NamedTuple):
    """The live part of a wavefront between bounces."""

    idx: torch.Tensor       # [n] int64 ray index in the tile
    state: torch.Tensor     # [n] int64 RNG state
    ray_o: V3
    ray_d: V3
    throughput: V3
    accumulated: V3         # radiance gathered since the last compaction
    alive: torch.Tensor     # [n] bool


def _bounce(static: SceneStatic, scene: SceneArrays, bg: V3, trace_fn,
            geom: BatchGeometry, s_pad: int, w: _Wave) -> _Wave:
    """One bounce of every ray in the wave (ray_gen.glsl:467-541)."""
    raw = trace_fn(w.ray_o, w.ray_d, w.alive)

    missed = w.alive & raw.missed
    accumulated = vec3.where(missed, w.accumulated + w.throughput * bg,
                             w.accumulated)
    alive = w.alive & ~raw.missed

    # One combined row fetch per bounce; on a scene slice the rows come
    # from the slice that owns the hit.
    prim = torch.where(alive, raw.prim, 0)
    P = geom.prim_rows.shape[0]
    lprim = fetch = None
    if geom.shard is not None:
        prim, mine = _sc_decode(geom.shard, P, prim)
        lprim = prim
        fetch = lambda x: _sc_fetch(geom.shard, mine, x)  # noqa: E731
    rows = geom.prim_rows[torch.clamp(prim, 0, P - 1)]
    if fetch is not None:
        rows = fetch(rows)

    rec = reconstruct_hit(raw, w.ray_o, w.ray_d, rows, geom, s_pad,
                          static.flags.has_image,
                          geom.sph_obj16 is not None, lprim, fetch)
    front = vec3.dot(w.ray_d, rec.n) < 0.0   # common.glsl:239-241
    normal = vec3.where(front, rec.n, -rec.n)

    if static.use_fat_shading:
        state, srec, emit = shading.scatter_and_emit_v3(
            w.state, static.flags, rows, rec.p, normal, front, w.ray_d,
            scene=scene, hit_u=rec.u, hit_v=rec.v)
        inst = rows[:, 48].to(torch.int64)
    else:
        mat_type, mat_index, inst = registry_material(static, scene, raw)
        state, srec, emit = _registry_scatter(
            w.state, scene, static, mat_type, mat_index, rec, normal, front,
            w.ray_d, alive)
    accumulated = vec3.where(alive, accumulated + w.throughput * emit,
                             accumulated)
    alive = alive & srec.is_scattered

    if static.has_lights:
        # NEE / MIS (ray_gen.glsl:516-537): a light sample moved by the hit
        # instance's objectToWorld at the batch's time, the 50/50 mixture,
        # and the material pdf over the mixture's pdf.
        o2w = geom.inst_o2w_rows[inst.long()]            # [R, 12]
        state, light = nee.sample_light_sources_v3(
            state, scene, tuple(o2w[:, i] for i in range(12)))
        state, chosen = nee.choose_mixture_pdf(state, srec.mat_pdf_type,
                                               True)
        state, sdir = nee.gen_scatter_direction_v3(state, chosen, rec.p,
                                                   normal, light)
        scatter_pdf = nee.pdf_value_v3(srec.mat_pdf_type, sdir, normal, light,
                                       scene.light_total_area)
        light_pdf = nee.pdf_value_v3(torch.full_like(chosen, LIGHT_PDF),
                                     sdir, normal, light,
                                     scene.light_total_area)
        pdf_value = 0.5 * light_pdf + 0.5 * scatter_pdf
        ratio = torch.where(
            pdf_value > 0.0,
            scatter_pdf / torch.where(pdf_value == 0.0, 1.0, pdf_value),
            0.0)
    else:
        # No lights: pdfValue == scatteringPdf and the ratio cancels to 1,
        # except where the cosine pdf is exactly 0 (the reference's 0/0,
        # guarded to 0 here).
        state, chosen = nee.choose_mixture_pdf(state, srec.mat_pdf_type,
                                               False)
        zero = vec3.zeros_like(rec.p)
        no_light = nee.LightSampleV3(position=zero, normal=zero)
        state, sdir = nee.gen_scatter_direction_v3(state, chosen, rec.p,
                                                   normal, no_light)
        scatter_pdf = nee.pdf_value_v3(srec.mat_pdf_type, sdir, normal,
                                       no_light, 1.0)
        ratio = torch.where(scatter_pdf > 0.0, 1.0, 0.0)
    mis_throughput = w.throughput * srec.attenuation * ratio
    mis_dir = vec3.normalize(sdir)

    use_skip = srec.skip_pdf
    new_throughput = vec3.where(use_skip, w.throughput * srec.attenuation,
                                mis_throughput)
    new_dir = vec3.where(use_skip, srec.skip_dir, mis_dir)

    return _Wave(
        idx=w.idx, state=state,
        ray_o=vec3.where(alive, rec.p, w.ray_o),
        ray_d=vec3.where(alive, new_dir, w.ray_d),
        throughput=vec3.where(alive, new_throughput, w.throughput),
        accumulated=accumulated, alive=alive,
    )


def bounce_wavefront(static: SceneStatic, scene: SceneArrays,
                     trace_fn: Callable, geom: BatchGeometry, state,
                     ray_o: V3, ray_d: V3,
                     counts: Optional[torch.Tensor] = None,
                     max_depth: Optional[int] = None):
    """Bounce a wavefront to termination, at most ``max_depth`` bounces
    (the scene's ``max_ray_depth`` by default); returns (radiance V3 of
    [R], rays traced).  Rays traced is the sum over bounces of the rays
    alive at that bounce, as in the JAX package.  ``counts`` ([R] int32),
    when given, gets each ray's own number of bounces added to it.

    Tail compaction: scenes run to max depth 50 while most paths end after
    a few bounces.  Whenever the alive count falls to the next size of
    ``_compact_schedule`` the radiance gathered so far is added into the
    output and the wave shrinks to its alive rays, so the tail runs at a
    fraction of the cost.  The JAX package compacts at the same alive
    counts (into fixed-size waves with dead padding, which this eager
    loop does not need), so each ray's radiance sums the same terms in
    the same grouping.  On a scene slice every slice holds the same rays,
    so all of them bounce the same number of times and meet at each
    bounce's collectives.
    """
    R = ray_o.x.shape[0]
    dev = ray_o.x.device
    zeros = torch.zeros(R, dtype=torch.float32, device=dev)
    ones = torch.ones(R, dtype=torch.float32, device=dev)
    w = _Wave(idx=torch.arange(R, device=dev), state=state, ray_o=ray_o,
              ray_d=ray_d, throughput=V3(ones, ones, ones),
              accumulated=V3(zeros, zeros, zeros),
              alive=torch.ones(R, dtype=torch.bool, device=dev))
    out = [zeros.clone(), zeros.clone(), zeros.clone()]
    bg = _background_v3(static, scene)
    s_pad = scene.sph_center.shape[0]
    sizes = _compact_schedule(R)

    def flush(w: _Wave) -> None:
        for o, a in zip(out, w.accumulated):
            o[w.idx] = o[w.idx] + a

    rays_traced = 0
    for _ in range(static.max_ray_depth if max_depth is None
                   else max_depth):
        n_alive = int(w.alive.sum())
        if n_alive == 0:
            break
        if sizes and n_alive <= sizes[0]:
            while sizes and n_alive <= sizes[0]:
                sizes.pop(0)
            flush(w)
            sel = torch.nonzero(w.alive).squeeze(1)
            take = lambda v: V3(v.x[sel], v.y[sel], v.z[sel])  # noqa: E731
            nz = torch.zeros(n_alive, dtype=torch.float32, device=dev)
            w = _Wave(idx=w.idx[sel], state=w.state[sel],
                      ray_o=take(w.ray_o), ray_d=take(w.ray_d),
                      throughput=take(w.throughput),
                      accumulated=V3(nz, nz, nz),
                      alive=torch.ones(n_alive, dtype=torch.bool, device=dev))
        rays_traced += n_alive
        if counts is not None:
            counts.index_add_(0, w.idx, w.alive.to(torch.int32))
        w = _bounce(static, scene, bg, trace_fn, geom, s_pad, w)
    flush(w)
    return V3(*out), rays_traced


def primary_rays(static: SceneStatic, cam: cam_ops.CameraArrays,
                 sample_batch: int, row0: int, rows_per_tile: int,
                 use_dof: bool, device, sample_base: int = 0,
                 spp_local: int = 0):
    """Raygen for ``rows_per_tile`` pixel rows x width x ``spp_local``
    samples (all of the pixel's spp when 0), ray order (row, column,
    sample); the samples are numbered from ``sample_base``, in the same
    per-sample streams as a render of all of them.  Returns (rng state,
    origin, direction)."""
    W = static.width
    sqrt_spp = static.sqrt_spp
    spp = sqrt_spp * sqrt_spp
    spp_local = spp_local or spp
    ray_ids = torch.arange(rows_per_tile * W * spp_local, dtype=torch.int64,
                           device=device)
    s = ray_ids % spp_local + sample_base
    pix = ray_ids // spp_local
    px = pix % W
    py = row0 + pix // W
    state = rng.init_rng(sample_batch, s, py, px, W, static.height, spp)
    return cam_ops.get_rays_v3(state, cam, px, py, s % sqrt_spp,
                               s // sqrt_spp, W, static.height, sqrt_spp,
                               use_dof=use_dof)


def render_tile(static: SceneStatic, scene: SceneArrays,
                cam: cam_ops.CameraArrays, trace_fn: Callable,
                geom: BatchGeometry, sample_batch: int, row0: int,
                rows_per_tile: int, use_dof: bool, spp_local: int = 0,
                sample_base: int = 0, reduce_mean: bool = True,
                max_depth: Optional[int] = None):
    """Render ``rows_per_tile`` pixel rows x width x ``spp_local`` samples
    (every sample of the pixel when 0) numbered from ``sample_base``
    (raytrace_tpu/engine/wavefront.py:673-739), at most ``max_depth``
    bounces (the scene's by default).  Returns (tile [rows, W, 3], rays
    traced): the samples' mean with ``reduce_mean``, else their sum, for a
    sum over the sample shards."""
    device = scene.sph_center.device
    spp_local = spp_local or static.sqrt_spp * static.sqrt_spp
    state, ray_o, ray_d = primary_rays(static, cam, sample_batch, row0,
                                       rows_per_tile, use_dof, device,
                                       sample_base, spp_local)
    radiance, rays_traced = bounce_wavefront(static, scene, trace_fn, geom,
                                             state, ray_o, ray_d,
                                             max_depth=max_depth)
    tile = vec3.to_rows(radiance).reshape(rows_per_tile, static.width,
                                          spp_local, 3)
    return (tile.mean(dim=2) if reduce_mean else tile.sum(dim=2)), rays_traced
