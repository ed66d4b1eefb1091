"""Analytic spheres in world space (raytrace_tpu/ops/spheres.py:104, :203).

Any rigid + uniform-scale instance maps a sphere to a sphere, so each batch
gets a world table (c.xyz, r, k = |c|^2 - r^2) precomputed on the host in
float64, which keeps k exact for the 1000-radius ground sphere.  The
closest hit is then the stable "h-form" quadratic against every sphere.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu.models.bvh_build import _instance_matrix_at

from .intersect import T_MAX, T_MIN
from .vec3 import V3

# Elements of one [chunk, R] temporary in the plain sweep (64 MiB of f32).
_CHUNK_ELEMS = 1 << 24


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
    for bi, t in enumerate(batch_times):
        mats = _instance_matrix_at(cs.inst_t0, cs.inst_t1, float(t))
        m = mats[cs.sph_inst[:n]]
        rot = m[:, :, :3]
        scale = np.linalg.norm(rot, axis=1)  # column norms [n, 3]
        if n and not np.allclose(scale, scale[:, :1], rtol=1e-5, atol=1e-7):
            return None
        c_world = np.einsum("sij,sj->si", rot, cs.sph_center[:n]) + m[:, :, 3]
        r_world = scale[:, 0] * cs.sph_radius[:n] if n else np.zeros(0)
        out[bi, :n, 0:3] = c_world
        out[bi, :n, 3] = r_world
        out[bi, :n, 4] = (c_world ** 2).sum(-1) - r_world ** 2
        out[bi, n:, 4] = 3.0e37
    return out.astype(np.float32)


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
