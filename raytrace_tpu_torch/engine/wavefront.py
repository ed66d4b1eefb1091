"""The wavefront path-tracing loop for analytic spheres in world space
(raytrace_tpu/engine/wavefront.py:87-871, the XLA wavefront configuration).

One sample batch is one geometry prepare plus one ``render_tile`` per row
tile.  A tile generates its pixel x sample wavefront and bounces it until
every ray has terminated or the depth limit is reached (the rayColour loop
of ray_gen.glsl:457-541 across the whole wavefront).  The loop runs on the
host, one bounce per iteration; each iteration reads the alive count once,
which both ends the loop and drives the tail compaction.

Covered here: spheres in world mode with direct normals, fat-row shading,
no triangles and no lights.  The Renderer rejects every other scene.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from raytrace_tpu.models.compile import SKY_SOLID, SKY_VERTICAL_GRADIENT

from ..ops import camera as cam_ops
from ..ops import nee, rng, shading, sphere_sweep, vec3
from ..ops.intersect import T_MAX
from ..ops.vec3 import V3
from .arrays import SceneArrays, SceneStatic


class RawHit(NamedTuple):
    """Closest-hit output of the trace sweep."""

    missed: torch.Tensor  # [R] bool
    t: torch.Tensor       # [R] f32
    prim: torch.Tensor    # [R] int32 primitive id (0 on a miss)


class HitRecord(NamedTuple):
    p: V3  # hit point
    n: V3  # unit geometric normal (not yet flipped to face the ray)


class BatchGeometry(NamedTuple):
    """Per-batch world-space geometry."""

    sph_table8: torch.Tensor  # [S8, 8] the sweep kernel's table
    prim_rows: torch.Tensor   # [P, 64] combined per-primitive rows


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


def prepare_batch(static: SceneStatic, scene: SceneArrays,
                  sph_table: torch.Tensor) -> BatchGeometry:
    """Kernel table and fat rows for one batch.

    sph_table: [S, 5] world sphere rows at the batch time
    (ops/spheres.world_sphere_tables).  Rows of ``prim_rows``:
    [0:32] shading row | [44:47] world center | [47] world radius |
    [48] instance id; the rest stay zero (raytrace_tpu/engine/
    wavefront.py:845-871, direct-normal branch).
    """
    s_pad = scene.sph_center.shape[0]
    P = scene.shade_rows.shape[0]
    rows = torch.zeros((P, 64), dtype=torch.float32,
                       device=scene.shade_rows.device)
    rows[:, 0:32] = scene.shade_rows
    rows[:s_pad, 44:47] = sph_table[:s_pad, 0:3]
    rows[:s_pad, 47] = sph_table[:s_pad, 3]
    rows[:s_pad, 48] = scene.sph_inst.to(torch.float32)
    rows[s_pad:, 48] = scene.tri_inst.to(torch.float32)
    return BatchGeometry(sph_table8=sphere_sweep.pad_table8(sph_table),
                         prim_rows=rows)


def make_trace_fn(geom: BatchGeometry) -> Callable:
    """trace(o, d, alive) -> RawHit: the sphere sweep for this batch."""

    def trace(o: V3, d: V3, alive) -> RawHit:
        hit = sphere_sweep.intersect_spheres_sweep(o, d, geom.sph_table8,
                                                   alive)
        return RawHit(missed=hit.t >= T_MAX, t=hit.t,
                      prim=torch.clamp_min(hit.sph, 0))

    return trace


def reconstruct_hit(raw: RawHit, ray_o: V3, ray_d: V3, rows) -> HitRecord:
    """RawHit → HitRecord from the fat rows: the direct sphere normal
    (hit - c_world) / r_world (raytrace_tpu/engine/wavefront.py:355-365)."""
    c = V3(rows[:, 44], rows[:, 45], rows[:, 46])
    r = rows[:, 47]
    p = ray_o + raw.t * ray_d
    inv_r = 1.0 / torch.where(r == 0.0, 1.0, r)
    n = V3((p.x - c.x) * inv_r, (p.y - c.y) * inv_r, (p.z - c.z) * inv_r)
    return HitRecord(p=p, n=vec3.normalize(n))


class _Wave(NamedTuple):
    """The live part of a wavefront between bounces."""

    idx: torch.Tensor       # [n] int64 ray index in the tile
    state: torch.Tensor     # [n] int64 RNG state
    ray_o: V3
    ray_d: V3
    throughput: V3
    accumulated: V3         # radiance gathered since the last compaction
    alive: torch.Tensor     # [n] bool


def _bounce(static: SceneStatic, bg: V3, trace_fn, geom: BatchGeometry,
            w: _Wave) -> _Wave:
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

    rec = reconstruct_hit(raw, w.ray_o, w.ray_d, rows)
    front = vec3.dot(w.ray_d, rec.n) < 0.0   # common.glsl:239-241
    normal = vec3.where(front, rec.n, -rec.n)

    state, srec, emit = shading.scatter_and_emit_v3(
        w.state, static.flags, rows, rec.p, normal, front, w.ray_d)
    accumulated = vec3.where(alive, accumulated + w.throughput * emit,
                             accumulated)
    alive = alive & srec.is_scattered

    # No lights: pdfValue == scatteringPdf and the ratio cancels to 1,
    # except where the cosine pdf is exactly 0 (the reference's 0/0,
    # guarded to 0 here).
    state, chosen = nee.choose_mixture_pdf(state, srec.mat_pdf_type, False)
    zero = vec3.zeros_like(rec.p)
    no_light = nee.LightSampleV3(position=zero, normal=zero)
    state, sdir = nee.gen_scatter_direction_v3(state, chosen, rec.p, normal,
                                               no_light)
    scatter_pdf = nee.pdf_value_v3(srec.mat_pdf_type, sdir, normal, no_light,
                                   1.0)
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
                     ray_o: V3, ray_d: V3):
    """Bounce a wavefront to termination; returns (radiance V3 of [R],
    rays traced).  Rays traced is the sum over bounces of the rays alive
    at that bounce, as in the JAX package.

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
        w = _bounce(static, bg, trace_fn, geom, w)
    flush(w)
    return V3(*out), rays_traced


def primary_rays(static: SceneStatic, cam: cam_ops.CameraArrays,
                 sample_batch: int, row0: int, rows_per_tile: int,
                 use_dof: bool, device):
    """Raygen for ``rows_per_tile`` pixel rows x width x spp samples, ray
    order (row, column, sample).  Returns (rng state, origin, direction)."""
    W = static.width
    sqrt_spp = static.sqrt_spp
    spp = sqrt_spp * sqrt_spp
    ray_ids = torch.arange(rows_per_tile * W * spp, dtype=torch.int64,
                           device=device)
    s = ray_ids % spp
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
