"""Device-side instance transforms: per-batch TRS interpolation and the
object-space triangle soup moved to world space
(raytrace_tpu/ops/transforms.py:18-88).

This replaces the reference's per-batch TLAS refit (acceleration.rs:91-115):
the soup is re-transformed to world space on the device for a batch time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class InstanceMatrices(NamedTuple):
    object_to_world: torch.Tensor  # [I, 3, 4]
    world_to_object: torch.Tensor  # [I, 3, 4]


def quat_slerp(a, b, t):
    """Batched quaternion slerp with the shortest-path flip and an nlerp
    fallback for nearly parallel quaternions.  a, b: [..., 4] (x, y, z, w)."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0.0, -b, b)
    dot = torch.abs(dot)
    dot_c = torch.clamp(dot, -1.0, 1.0)

    lin = a + t * (b - a)
    lin = lin / torch.linalg.norm(lin, dim=-1, keepdim=True)

    theta = torch.arccos(dot_c)
    s = torch.sin(theta)
    safe_s = torch.where(s < 1e-6, 1.0, s)
    sph = ((torch.sin((1.0 - t) * theta) / safe_s) * a
           + (torch.sin(t * theta) / safe_s) * b)
    return torch.where(dot > 0.9995, lin, sph)


def quat_to_mat3(q):
    """[..., 4] → [..., 3, 3] rotation matrices."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                        2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                        2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def interpolate_instances(inst_t0, inst_t1, time) -> InstanceMatrices:
    """TRS-lerp every instance to ``time`` in [0, 1] and build its 3x4
    matrices.  inst_t0/inst_t1: [I, 10] = translation(3) | quat(4) |
    scale(3); static instances have t1 == t0."""
    tr = (1.0 - time) * inst_t0[:, 0:3] + time * inst_t1[:, 0:3]
    q = quat_slerp(inst_t0[:, 3:7], inst_t1[:, 3:7], time)
    sc = (1.0 - time) * inst_t0[:, 7:10] + time * inst_t1[:, 7:10]

    rot = quat_to_mat3(q)                        # [I, 3, 3]
    m = rot * sc[:, None, :]                     # R diag(s): scale columns
    o2w = torch.cat([m, tr[:, :, None]], dim=-1)  # [I, 3, 4]

    # Inverse of T R S: S^-1 R^T T^-1 (analytic, no linear solve).
    inv_s = 1.0 / sc
    m_inv = rot.transpose(-1, -2) * inv_s[:, :, None]  # diag(1/s) R^T
    t_inv = -torch.einsum("ijk,ik->ij", m_inv, tr)
    w2o = torch.cat([m_inv, t_inv[:, :, None]], dim=-1)
    return InstanceMatrices(object_to_world=o2w, world_to_object=w2o)


def transform_soup(tri_p, tri_n, tri_inst, mats: InstanceMatrices):
    """Object-space soup → world space for one batch time.

    tri_p/tri_n: [T, 3, 3]; tri_inst: [T].  Normals go through the inverse
    transpose (n · worldToObject, ray_gen.glsl:171) and stay unnormalised:
    shading normalises after the barycentric lerp, which commutes with the
    linear map."""
    idx = tri_inst.long()
    o2w = mats.object_to_world[idx]  # [T, 3, 4]
    w2o = mats.world_to_object[idx]
    world_p = (torch.einsum("tij,tvj->tvi", o2w[:, :, :3], tri_p)
               + o2w[:, None, :, 3])
    world_n = torch.einsum("tvj,tji->tvi", tri_n, w2o[:, :, :3])
    return world_p, world_n
