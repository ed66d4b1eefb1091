"""The wavefront path-tracing loop for analytic spheres in world space and
triangle soups (raytrace_tpu/engine/wavefront.py:87-871, the XLA wavefront
configuration with the packed triangle tables).

One sample batch is one geometry prepare plus one ``render_tile`` per row
tile.  A tile generates its pixel x sample wavefront and bounces it until
every ray has terminated or the depth limit is reached (the rayColour loop
of ray_gen.glsl:457-541 across the whole wavefront).  The loop runs on the
host, one bounce per iteration; each iteration reads the alive count once,
which both ends the loop and drives the tail compaction.

Covered here: spheres swept in world mode, with direct normals, or in a
scene with an image texture with the normal and UV of the sphere's
world-to-object branch; triangles swept
densely (the kernel K2) or, on a soup the Renderer put in paged order, by
pages and clusters (the kernel K3), with their hit point, normal and UV
rebuilt from the packed position and attribute tables, fat-row shading
(constant, checker, noise and image textures), next-event
estimation with lights (the alias-table light sample moved by the hit
instance's objectToWorld, and the 50/50 mixture of the light and material
pdfs); animated spheres and instances through per-batch geometry.  The
Renderer rejects every other scene.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..models.compile import SKY_SOLID, SKY_VERTICAL_GRADIENT

from ..ops import camera as cam_ops
from ..ops import (megakernel, nee, paged_tri, rng, shading, sphere_sweep,
                   spheres, transforms, tri_sweep, vec3)
from ..ops.intersect import T_MAX, Hit
from ..ops.materials import LIGHT_PDF
from ..ops.spheres import SphereHit
from ..ops.vec3 import V3
from .arrays import SceneArrays, SceneStatic


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

    sph_table8: torch.Tensor  # [S8, 8] the sweep kernel's table
    prim_rows: torch.Tensor   # [P, 64] combined per-primitive rows
    # [S8, 8] motion rows (dc xyz, -, k1, k2), or None for a static table
    sph_dtab8: Optional[torch.Tensor] = None
    world_p: Optional[torch.Tensor] = None      # [T, 3, 3] world soup
    world_n: Optional[torch.Tensor] = None      # [T, 3, 3] unnormalised
    tri_table16: Optional[torch.Tensor] = None  # [T8, 16] ops/tri_sweep
    # [T8, 16] n0, n1 - n0, n2 - n0, uv0, uv1 - uv0, uv2 - uv0, pad
    tri_attr16: Optional[torch.Tensor] = None
    # The fused kernel's triangle tables (ops/megakernel.py): [T8, 12]
    # v0, e1, e2 each padded to four floats, and [C, 8] cluster boxes
    # (None on the paged sweep, which nothing else reads them on).
    tri_table12: Optional[torch.Tensor] = None
    tri_boxes: Optional[torch.Tensor] = None
    # The paged sweep's tables (ops/paged_tri.py), on a "paged" soup.
    tri_pages: Optional[paged_tri.PageTables] = None
    # [I, 12] every instance's objectToWorld at the batch's time, row-major
    # 3x4: the light sample's transform (raytrace_tpu/engine/wavefront.py:
    # 755, :875-876); None when the geometry was built without a time.
    inst_o2w_rows: Optional[torch.Tensor] = None
    # The fused kernel's copy of the image atlas (engine/arrays.pack_atlas),
    # in a scene with an image texture; the wavefront reads scene.atlas.
    atlas_words: Optional[torch.Tensor] = None
    # The fused kernel's [C, 8] sphere cluster boxes
    # (ops/megakernel.sphere_cluster_boxes; with sph_dtab8, the union over
    # the shutter), in a scene with its spheres in clusters, on the fused
    # path only.
    sph_boxes: Optional[torch.Tensor] = None


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


def prepare_tris(static: SceneStatic, scene: SceneArrays,
                 batch_time: torch.Tensor) -> dict:
    """The triangle fields of a BatchGeometry for one batch time (a 0-dim
    f32 tensor): the instances go to that time, the soup to world space,
    then the packed position and attribute tables, and the fused kernel's
    tables, or on a "paged" soup the paged sweep's
    (raytrace_tpu/engine/wavefront.py:779-839, :881-890).  A static scene
    builds them once."""
    mats = transforms.interpolate_instances(scene.inst_t0, scene.inst_t1,
                                            batch_time)
    world_p, world_n = transforms.transform_soup(scene.tri_p, scene.tri_n,
                                                 scene.tri_inst, mats)
    table16 = tri_sweep.pack_tri_table(world_p, static.num_triangles)
    T8 = table16.shape[0]
    table12 = megakernel.tri_table12(table16)
    out = dict(inst_o2w_rows=_o2w_rows(mats), world_p=world_p,
               world_n=world_n, tri_table16=table16,
               tri_attr16=tri_attr_table(world_n, scene.tri_uv, T8),
               tri_table12=table12)
    if static.bvh_mode == "paged":
        out["tri_pages"] = paged_tri.build_page_tables(
            world_p, static.num_triangles, table12)
    else:
        out["tri_boxes"] = megakernel.cluster_boxes(
            table16, static.num_triangles, megakernel.tri_group(static, T8))
    return out


def _o2w_rows(mats: transforms.InstanceMatrices) -> torch.Tensor:
    return mats.object_to_world.reshape(-1, 12).contiguous()


def prepare_batch(static: SceneStatic, scene: SceneArrays,
                  sph_table: torch.Tensor,
                  sph_dtab: Optional[torch.Tensor] = None,
                  tris: Optional[dict] = None,
                  batch_time: Optional[torch.Tensor] = None,
                  atlas_words: Optional[torch.Tensor] = None,
                  fused: bool = False) -> BatchGeometry:
    """Kernel tables and fat rows for one batch.

    sph_table: [S, 5] world sphere rows at the batch time
    (ops/spheres.world_sphere_tables), or at shutter time 0 when
    ``sph_dtab`` ([S8, 8], ops/spheres.world_sphere_anim_tables) gives the
    spheres' linear motion.  A scene with triangles takes ``tris``, the
    fields ``prepare_tris`` built for the batch's time, with the instances'
    objectToWorld rows at that time; a scene with lights and without
    triangles takes ``batch_time`` (a 0-dim f32 tensor) for those rows
    (a scene without lights needs none).  Rows of
    ``prim_rows``: [0:32] shading row |
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
    scene's atlas.  With ``fused`` (the geometry feeds the fused kernel), a
    scene with its spheres in clusters (ops/megakernel.
    sphere_cluster_layout) gets the clusters' boxes, built on the table's
    device; the wavefront reads none.
    """
    s_pad = scene.sph_center.shape[0]
    P = scene.shade_rows.shape[0]
    rows = torch.zeros((P, 64), dtype=torch.float32,
                       device=scene.shade_rows.device)
    rows[:, 0:32] = scene.shade_rows
    image = static.flags.has_image
    if image:
        if batch_time is None:
            raise ValueError("a scene with an image texture needs the batch "
                             "time (its spheres' world-to-object rows)")
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
    table8 = sphere_sweep.pad_table8(sph_table)
    layout = megakernel.sphere_cluster_layout(static) if fused else None
    if layout is not None:
        extra["sph_boxes"] = megakernel.sphere_cluster_boxes(
            table8, *layout, dtab8=sph_dtab)
    return BatchGeometry(sph_table8=table8, prim_rows=rows,
                         sph_dtab8=sph_dtab, atlas_words=atlas_words, **extra)


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


def make_trace_fn(static: SceneStatic, scene: SceneArrays,
                  geom: BatchGeometry) -> Callable:
    """trace(o, d, alive) -> RawHit for this batch: the triangle sweep
    (K2, or the paged sweep K3 on a "paged" soup), then the sphere sweep
    (K1), each only where the scene has such primitives
    (raytrace_tpu/engine/wavefront.py:138-232)."""
    s_pad = scene.sph_center.shape[0]

    def trace(o: V3, d: V3, alive) -> RawHit:
        tri = None
        if static.bvh_mode == "paged":
            tri = paged_tri.intersect_tris_paged(o, d, geom.tri_pages, alive)
        elif static.has_tris:
            tri = tri_sweep.intersect_tris_sweep(o, d, geom.tri_table16,
                                                 alive)
        sph = (sphere_sweep.intersect_spheres_sweep(o, d, geom.sph_table8,
                                                    alive)
               if static.has_spheres or not static.has_tris else None)
        return combine_hits(sph, tri, s_pad)

    return trace


def reconstruct_hit(raw: RawHit, ray_o: V3, ray_d: V3, rows,
                    geom: BatchGeometry, s_pad: int,
                    has_image: bool = False) -> HitRecord:
    """RawHit → HitRecord.  A sphere's normal is the direct one from the
    fat rows, (hit - c_world) / r_world; a triangle's hit point is
    v0 + u e1 + v e2 from the position table and its normal the
    barycentric lerp of the attribute rows; the pair is chosen per ray,
    then normalised (raytrace_tpu/engine/wavefront.py:321-341, :355-365,
    :388-399).

    With ``has_image`` the sphere takes JAX's world-to-object branch
    (:366-386) from the rows of ``prepare_batch``: the hit point moved to
    object space, the object normal (p_obj - c) / r taken back to world
    space by the transposed matrix, and the UV of the tessellator's
    parameterisation, v = arccos(-n.y) / pi and u = arctan2(n.z, -n.x) /
    2 pi floor-mod 1, of the unit object normal; a triangle's UV is the
    barycentric lerp of its attribute rows' uv0, duv1, duv2."""
    p = ray_o + raw.t * ray_d
    r = rows[:, 47]
    inv_r = 1.0 / torch.where(r == 0.0, 1.0, r)
    su = sv = None
    if has_image:
        m_cols = tuple(rows[:, 32 + i] for i in range(12))
        p_obj = vec3.mat34_apply_point(m_cols, p)
        n_obj = V3((p_obj.x - rows[:, 44]) * inv_r,
                   (p_obj.y - rows[:, 45]) * inv_r,
                   (p_obj.z - rows[:, 46]) * inv_r)
        n = vec3.mat34_apply_transposed_vec(m_cols, n_obj)
        nn = vec3.normalize(n_obj)
        sv = torch.arccos(torch.clamp(-nn.y, -1.0, 1.0)) / spheres.PI
        su = torch.remainder(torch.arctan2(nn.z, -nn.x) / spheres.TWO_PI,
                             1.0)
    else:
        c = V3(rows[:, 44], rows[:, 45], rows[:, 46])
        n = V3((p.x - c.x) * inv_r, (p.y - c.y) * inv_r, (p.z - c.z) * inv_r)
    if geom.tri_table16 is not None:
        tri = torch.clamp_min(raw.prim - s_pad, 0)
        pos = geom.tri_table16[torch.clamp(tri, 0,
                                           geom.tri_table16.shape[0] - 1)]
        att = geom.tri_attr16[torch.clamp(tri, 0,
                                          geom.tri_attr16.shape[0] - 1)]
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

    # One combined row fetch per bounce.
    prim = torch.where(alive, raw.prim, 0)
    P = geom.prim_rows.shape[0]
    rows = geom.prim_rows[torch.clamp(prim, 0, P - 1)]

    rec = reconstruct_hit(raw, w.ray_o, w.ray_d, rows, geom, s_pad,
                          static.flags.has_image)
    front = vec3.dot(w.ray_d, rec.n) < 0.0   # common.glsl:239-241
    normal = vec3.where(front, rec.n, -rec.n)

    state, srec, emit = shading.scatter_and_emit_v3(
        w.state, static.flags, rows, rec.p, normal, front, w.ray_d,
        scene=scene, hit_u=rec.u, hit_v=rec.v)
    accumulated = vec3.where(alive, accumulated + w.throughput * emit,
                             accumulated)
    alive = alive & srec.is_scattered

    if static.has_lights:
        # NEE / MIS (ray_gen.glsl:516-537): a light sample moved by the hit
        # instance's objectToWorld (fat-row slot 48), the 50/50 mixture,
        # and the material pdf over the mixture's pdf.
        inst = rows[:, 48].to(torch.int64)
        o2w = geom.inst_o2w_rows[inst]                   # [R, 12]
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
                     counts: Optional[torch.Tensor] = None):
    """Bounce a wavefront to termination; returns (radiance V3 of [R],
    rays traced).  Rays traced is the sum over bounces of the rays alive
    at that bounce, as in the JAX package.  ``counts`` ([R] int32), when
    given, gets each ray's own number of bounces added to it.

    Tail compaction: scenes run to max depth 50 while most paths end after
    a few bounces.  Whenever the alive count falls to the next size of
    ``_compact_schedule`` the radiance gathered so far is added into the
    output and the wave shrinks to its alive rays, so the tail runs at a
    fraction of the cost.  The JAX package compacts at the same alive
    counts (into fixed-size waves with dead padding, which this eager
    loop does not need), so each ray's radiance sums the same terms in
    the same grouping.
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
    for _ in range(static.max_ray_depth):
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
                 use_dof: bool, device, sample_base: int = 0):
    """Raygen for ``rows_per_tile`` pixel rows x width x spp samples, ray
    order (row, column, sample); the samples are numbered from
    ``sample_base``.  Returns (rng state, origin, direction)."""
    W = static.width
    sqrt_spp = static.sqrt_spp
    spp = sqrt_spp * sqrt_spp
    ray_ids = torch.arange(rows_per_tile * W * spp, dtype=torch.int64,
                           device=device)
    s = ray_ids % spp + sample_base
    pix = ray_ids // spp
    px = pix % W
    py = row0 + pix // W
    state = rng.init_rng(sample_batch, s, py, px, W, static.height, spp)
    return cam_ops.get_rays_v3(state, cam, px, py, s % sqrt_spp,
                               s // sqrt_spp, W, static.height, sqrt_spp,
                               use_dof=use_dof)


def render_tile(static: SceneStatic, scene: SceneArrays,
                cam: cam_ops.CameraArrays, trace_fn: Callable,
                geom: BatchGeometry, sample_batch: int, row0: int,
                rows_per_tile: int, use_dof: bool):
    """Render ``rows_per_tile`` pixel rows x width x spp samples and average
    the samples.  Returns (tile [rows, W, 3], rays traced)."""
    device = scene.shade_rows.device
    state, ray_o, ray_d = primary_rays(static, cam, sample_batch, row0,
                                       rows_per_tile, use_dof, device)
    radiance, rays_traced = bounce_wavefront(static, scene, trace_fn, geom,
                                             state, ray_o, ray_d)
    spp = static.sqrt_spp * static.sqrt_spp
    tile = vec3.to_rows(radiance).reshape(rows_per_tile, static.width, spp, 3)
    return tile.mean(dim=2), rays_traced
