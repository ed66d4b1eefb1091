"""Analytic spheres in world space (raytrace_tpu/ops/spheres.py:104, :137,
:203) and in object space (:40).

Any rigid + uniform-scale instance maps a sphere to a sphere, so each batch
gets a world table (c.xyz, r, k = |c|^2 - r^2) precomputed on the host in
float64, which keeps k exact for the 1000-radius ground sphere.  The
closest hit is then the stable "h-form" quadratic against every sphere.

A scene with a non-uniform instance scale (an ellipsoid) has no world
table: ``intersect_spheres`` takes each ray into each sphere's object
space through its world-to-object matrix at the batch time
(``object_sphere_table``) and solves the quadratic there; it is the plain
version of the kernel H2 (ops/sphere_obj.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.bvh_build import _instance_matrix_at

from .intersect import T_MAX, T_MIN
from .vec3 import V3

# Elements of one [chunk, R] temporary in the plain sweep (64 MiB of f32).
_CHUNK_ELEMS = 1 << 24
# The float32 constants of the sphere UV (raytrace_tpu/ops/spheres.py:265-266).
TWO_PI = float(np.float32(2.0 * np.pi))
PI = float(np.float32(np.pi))


class SphereHit(NamedTuple):
    t: torch.Tensor    # [R] f32, T_MAX on a miss
    sph: torch.Tensor  # [R] int32 sphere id, -1 on a miss


def world_sphere_tables(cs, batch_times) -> "np.ndarray | None":
    """[B, S, 5] float32 world tables (c.xyz, r, k) for each batch time, or
    None when a sphere instance has non-uniform scale (an ellipsoid, which
    needs the object-space path).  Padding rows get r = 0, k = 3e37 and
    never hit."""
    S = cs.sph_center.shape[0]
    out = np.zeros((len(batch_times), S, 5), np.float64)
    n = cs.num_spheres
    if n == 0:
        # No real sphere: padding rows alone, whatever the instances do.
        out[:, :, 4] = 3.0e37
        return out.astype(np.float32)
    for bi, t in enumerate(batch_times):
        mats = _instance_matrix_at(cs.inst_t0, cs.inst_t1, float(t))
        m = mats[cs.sph_inst[:n]]
        rot = m[:, :, :3]
        scale = np.linalg.norm(rot, axis=1)  # column norms [n, 3]
        if not np.allclose(scale, scale[:, :1], rtol=1e-5, atol=1e-7):
            return None
        c_world = np.einsum("sij,sj->si", rot, cs.sph_center[:n]) + m[:, :, 3]
        r_world = scale[:, 0] * cs.sph_radius[:n]
        out[bi, :n, 0:3] = c_world
        out[bi, :n, 3] = r_world
        out[bi, :n, 4] = (c_world ** 2).sum(-1) - r_world ** 2
        out[bi, n:, 4] = 3.0e37
    return out.astype(np.float32)


def world_sphere_anim_tables(cs):
    """Host (f64) endpoint + delta tables for the FUSED animated
    megakernel (ops/megakernel.py MegaConfig.anim): instead of one table
    per batch time, the kernel lerps world centers in-flight —
    c(t) = c0 + t*dc — so one pair of tables serves every batch of a
    fused chunk.  The TPU replacement for the reference's per-batch TLAS
    refit + fence (acceleration.rs:91-115) on animated scenes.

    Returns (tab0 [S,5] f32 endpoint-0 table in world_sphere_tables
    layout, dtab8 [S8,8] f32 with cols 0:3 = dc = c1-c0, col 4 =
    k1 = 2*c0.dc, col 5 = k2 = |dc|^2, so k(t) = k0 + t*(k1 + t*k2)
    keeps the f64-precomputed |c0|^2 - r^2 cancellation), or None when
    the fused form is invalid: non-uniform scale (no world mode), a
    radius-animated sphere (dr != 0 — the kernel lerps centers only),
    or a center path that is not linear in t (rotation-about-offset
    animation: c(t) = T(t) + R(t) S(t) c_obj bends when R animates and
    c_obj != 0; verified against the true transform at t = 0.25/0.5/0.75).
    """
    S = cs.sph_center.shape[0]
    n = cs.num_spheres
    if n == 0:
        return None

    def _world(t):
        mats = _instance_matrix_at(cs.inst_t0, cs.inst_t1, float(t))
        m = mats[cs.sph_inst[:n]]
        rot = m[:, :, :3]
        scale = np.linalg.norm(rot, axis=1)
        if not np.allclose(scale, scale[:, :1], rtol=1e-5, atol=1e-7):
            return None, None
        c = np.einsum("sij,sj->si", rot, cs.sph_center[:n]) + m[:, :, 3]
        r = scale[:, 0] * cs.sph_radius[:n]
        return c, r

    c0, r0 = _world(0.0)
    c1, r1 = _world(1.0)
    if c0 is None or c1 is None:
        return None
    rs = np.maximum(np.abs(r0), np.abs(r1))
    if not np.all(np.abs(r1 - r0) <= 1e-6 * rs + 1e-9):
        return None                       # radius-animated sphere
    dc = c1 - c0
    span = np.linalg.norm(dc, axis=-1) + rs
    for t in (0.25, 0.5, 0.75):
        ct, _ = _world(t)
        if ct is None:
            return None
        dev = np.linalg.norm(ct - (c0 + t * dc), axis=-1)
        if not np.all(dev <= 1e-6 * span + 1e-9):
            return None                   # nonlinear center path

    tab0 = np.zeros((S, 5), np.float64)
    tab0[:n, 0:3] = c0
    tab0[:n, 3] = r0
    tab0[:n, 4] = (c0 ** 2).sum(-1) - r0 ** 2
    tab0[n:, 4] = 3.0e37                  # padding: never hits
    S8 = max(8, -(-S // 8) * 8)
    dtab8 = np.zeros((S8, 8), np.float64)
    dtab8[:n, 0:3] = dc
    dtab8[:n, 4] = 2.0 * (c0 * dc).sum(-1)
    dtab8[:n, 5] = (dc ** 2).sum(-1)
    return tab0.astype(np.float32), dtab8.astype(np.float32)


def intersect_spheres_world(o: V3, d: V3, table) -> SphereHit:
    """Closest hit of rays (V3 of [R]) against world spheres.

    table: [S, >=5] f32 rows (cx, cy, cz, r, k).  Spheres are swept in
    chunks whose [chunk, R] temporaries stay near 64 MiB; within a chunk
    the first minimum wins and a chunk replaces the running best only when
    strictly closer, so ties go to the lowest sphere id.  Both roots must
    lie in (T_MIN, T_MAX) and r > 0.
    """
    R = o.x.shape[0]
    S = table.shape[0]
    chunk = max(8, min(128, _CHUNK_ELEMS // max(R, 1)) // 8 * 8)

    d_dot_o = d.x * o.x + d.y * o.y + d.z * o.z
    a = d.x * d.x + d.y * d.y + d.z * d.z
    o_sq = o.x * o.x + o.y * o.y + o.z * o.z
    inv_a = 1.0 / torch.where(a == 0.0, 1.0, a)

    best_t = torch.full((R,), T_MAX, dtype=torch.float32, device=o.x.device)
    best_id = torch.full((R,), -1, dtype=torch.int32, device=o.x.device)
    for s0 in range(0, S, chunk):
        tb = table[s0:s0 + chunk]
        cx, cy, cz, r, k = (tb[:, i:i + 1] for i in range(5))   # [C, 1]
        dc = cx * d.x + cy * d.y + cz * d.z                      # [C, R]
        oc = cx * o.x + cy * o.y + cz * o.z
        h = d_dot_o - dc
        c2 = o_sq - 2.0 * oc + k
        disc = h * h - a * c2
        ok = (disc >= 0.0) & (r > 0.0)
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-h - sq) * inv_a
        t2 = (-h + sq) * inv_a
        t1_ok = ok & (t1 > T_MIN) & (t1 < T_MAX)
        t2_ok = ok & (t2 > T_MIN) & (t2 < T_MAX)
        t = torch.where(t1_ok, t1, torch.where(t2_ok, t2, T_MAX))
        tc, arg = torch.min(t, dim=0)
        better = tc < best_t
        best_t = torch.where(better, tc, best_t)
        best_id = torch.where(better, (arg + s0).to(torch.int32), best_id)
    return SphereHit(t=best_t, sph=best_id)


def object_sphere_table(w2o: torch.Tensor, centers: torch.Tensor,
                        radii: torch.Tensor) -> torch.Tensor:
    """[S, 3, 4] world-to-object matrices (each sphere's instance's, at the
    batch time), [S, 3] object-space centres and [S] radii → the [S8, 16]
    table of ``intersect_spheres`` and the kernel H2: M's 12 floats
    row-major, then c.xyz and r (S8 = S rounded up to a multiple of 8, at
    least 8; padding rows all zero: r = 0 never hits)."""
    S = centers.shape[0]
    S8 = max(8, -(-S // 8) * 8)
    out = torch.zeros((S8, 16), dtype=torch.float32, device=centers.device)
    out[:S, 0:12] = w2o.reshape(S, 12)
    out[:S, 12:15] = centers
    out[:S, 15] = radii
    return out


def object_hit_t(o3, d3, cols) -> torch.Tensor:
    """t of the object-space test (raytrace_tpu/ops/spheres.py:40-101) of
    rays (o3, d3: three tensors each) against spheres (``cols``: the 16
    columns of ``object_sphere_table``'s rows, each broadcastable against
    the rays): the ray moved by the sphere's world-to-object M, o' = M o +
    t and d' = M d (each row summed left to right, as the JAX einsum), then
    the quadratic against the object-space centre and radius, t1 before
    t2, both in (T_MIN, T_MAX), r > 0 and a > 0; T_MAX on a miss.  The
    operations of the kernel H2 (csrc/sphere_obj.cu obj_t), in its order."""
    m = cols[:12]
    cx, cy, cz, r = cols[12:16]
    po = [m[4 * i] * o3[0] + m[4 * i + 1] * o3[1] + m[4 * i + 2] * o3[2]
          + m[4 * i + 3] for i in range(3)]
    pd = [m[4 * i] * d3[0] + m[4 * i + 1] * d3[1] + m[4 * i + 2] * d3[2]
          for i in range(3)]
    ocx, ocy, ocz = po[0] - cx, po[1] - cy, po[2] - cz
    a = pd[0] * pd[0] + pd[1] * pd[1] + pd[2] * pd[2]
    h = pd[0] * ocx + pd[1] * ocy + pd[2] * ocz
    c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = h * h - a * c2
    ok = (disc >= 0.0) & (r > 0.0) & (a > 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / torch.where(a == 0.0, 1.0, a)
    t1 = (-h - sq) * inv_a
    t2 = (-h + sq) * inv_a
    t1_ok = ok & (t1 > T_MIN) & (t1 < T_MAX)
    t2_ok = ok & (t2 > T_MIN) & (t2 < T_MAX)
    return torch.where(t1_ok, t1, torch.where(t2_ok, t2, T_MAX))


def intersect_spheres(o: V3, d: V3, table16: torch.Tensor) -> SphereHit:
    """Closest hit of rays (V3 of [R]) against spheres in object space
    (raytrace_tpu/ops/spheres.py:40-101): each ray against each row of the
    [S8, 16] table (``object_sphere_table``) with ``object_hit_t``.  Swept
    in chunks whose [chunk, R] temporaries stay near 64 MiB; the first
    minimum wins within a chunk and a strictly closer chunk replaces the
    best, so ties go to the lowest sphere id.  Returns (T_MAX, -1) on a
    miss."""
    R = o.x.shape[0]
    S = table16.shape[0]
    chunk = max(8, min(128, _CHUNK_ELEMS // max(R, 1)) // 8 * 8)
    best_t = torch.full((R,), T_MAX, dtype=torch.float32, device=o.x.device)
    best_id = torch.full((R,), -1, dtype=torch.int32, device=o.x.device)
    for s0 in range(0, S, chunk):
        tb = table16[s0:s0 + chunk]
        t = object_hit_t(tuple(o), tuple(d),
                         [tb[:, i:i + 1] for i in range(16)])  # [C, R]
        tc, arg = torch.min(t, dim=0)
        better = tc < best_t
        best_t = torch.where(better, tc, best_t)
        best_id = torch.where(better, (arg + s0).to(torch.int32), best_id)
    return SphereHit(t=best_t, sph=best_id)
