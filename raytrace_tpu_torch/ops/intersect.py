"""Ray-triangle closest hit, Möller–Trumbore over flat wavefronts
(raytrace_tpu/ops/intersect.py:19-115), and the ray parameter bounds every
closest-hit routine shares.

``intersect_brute_force`` tests every ray against every triangle in chunks
with a running closest-hit reduction; it is the plain triangle closest hit
the kernel K2 (ops/tri_sweep.py) is held to.  Barycentric convention as
VK_KHR: hit attribs (u, v) with position = v0 (1 - u - v) + v1 u + v2 v.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

T_MIN = 0.001    # ray_gen.glsl:579
T_MAX = 10000.0  # ray_gen.glsl:580


class Hit(NamedTuple):
    t: torch.Tensor    # [R] hit distance (T_MAX where missed)
    tri: torch.Tensor  # [R] int32 triangle id (-1 where missed)
    u: torch.Tensor    # [R]
    v: torch.Tensor    # [R]

    @property
    def missed(self):
        return self.tri < 0


def moller_trumbore(o, d, v0, e1, e2, t_min=T_MIN, t_max=T_MAX):
    """Batched intersection test.  o, d: [..., 3]; v0, e1, e2: [..., 3]
    broadcast-compatible with the rays.  Returns (t, u, v, valid)."""
    pvec = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    inv_det = torch.where(det != 0.0,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    valid = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > t_min) & (t < t_max))
    return t, u, v, valid


def intersect_brute_force(o, d, tri_p, active=None, chunk=2048,
                          t_min=T_MIN, t_max=T_MAX) -> Hit:
    """Closest hit of rays o, d [R, 3] against all triangles tri_p [T, 3, 3].

    T must be a multiple of ``chunk`` (else one chunk).  Within a chunk the
    first minimum wins, and a chunk replaces the running best only when
    strictly closer, so ties go to the lowest triangle id.  Padding
    triangles are all-zero: det == 0, never hit.
    """
    R = o.shape[0]
    T = tri_p.shape[0]
    if T % chunk != 0:
        chunk = T
    v0 = tri_p[:, 0, :]
    e1 = tri_p[:, 1, :] - tri_p[:, 0, :]
    e2 = tri_p[:, 2, :] - tri_p[:, 0, :]
    dev = o.device
    best = Hit(t=torch.full((R,), t_max, dtype=torch.float32, device=dev),
               tri=torch.full((R,), -1, dtype=torch.int32, device=dev),
               u=torch.zeros(R, dtype=torch.float32, device=dev),
               v=torch.zeros(R, dtype=torch.float32, device=dev))
    rows = torch.arange(R, device=dev)
    for s in range(0, T, chunk):
        t, u, v, valid = moller_trumbore(
            o[:, None, :], d[:, None, :], v0[None, s:s + chunk],
            e1[None, s:s + chunk], e2[None, s:s + chunk], t_min, t_max)
        t = torch.where(valid, t, t_max)
        arg = torch.argmin(t, dim=1)   # the first minimum
        tc, uc, vc = t[rows, arg], u[rows, arg], v[rows, arg]
        better = tc < best.t
        best = Hit(t=torch.where(better, tc, best.t),
                   tri=torch.where(better, (s + arg).to(torch.int32),
                                   best.tri),
                   u=torch.where(better, uc, best.u),
                   v=torch.where(better, vc, best.v))
    if active is not None:
        best = best._replace(t=torch.where(active, best.t, t_max),
                             tri=torch.where(active, best.tri, -1))
    return best
