"""Component-wise vec3: every per-ray vector is three 1-D [R] tensors
(raytrace_tpu/ops/vec3.py:20-120).

The JAX package chose this layout against the TPU's (8, 128) tiling; the
port keeps it so each function reads like its counterpart and runs the
same operations in the same order, which is what the parity tests rely on.
On the GPU it also keeps every elementwise pass coalesced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def to_rows(v: V3) -> torch.Tensor:
    """V3 → [R, 3]."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def norm(v: V3):
    return torch.sqrt(dot(v, v))


def normalize(v: V3, eps: float = 1e-20) -> V3:
    inv = 1.0 / torch.clamp_min(norm(v), eps)
    return V3(v.x * inv, v.y * inv, v.z * inv)


def where(mask, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def zeros_like(v: V3) -> V3:
    return V3(torch.zeros_like(v.x), torch.zeros_like(v.y),
              torch.zeros_like(v.z))


def reflect(i: V3, n: V3) -> V3:
    """GLSL reflect."""
    d = 2.0 * dot(i, n)
    return V3(i.x - d * n.x, i.y - d * n.y, i.z - d * n.z)


def mat34_apply_point(m_cols, p: V3) -> V3:
    """M p + t for a row-major 3x4 matrix given as its 12 [R] entries
    (raytrace_tpu/ops/vec3.py:121)."""
    (m00, m01, m02, m03, m10, m11, m12, m13, m20, m21, m22, m23) = m_cols
    return V3(
        m00 * p.x + m01 * p.y + m02 * p.z + m03,
        m10 * p.x + m11 * p.y + m12 * p.z + m13,
        m20 * p.x + m21 * p.y + m22 * p.z + m23,
    )


def mat34_apply_transposed_vec(m_cols, v: V3) -> V3:
    """v M, the normal transform when M is world-to-object
    (raytrace_tpu/ops/vec3.py:140)."""
    (m00, m01, m02, _m03, m10, m11, m12, _m13, m20, m21, m22, _m23) = m_cols
    return V3(
        m00 * v.x + m10 * v.y + m20 * v.z,
        m01 * v.x + m11 * v.y + m21 * v.z,
        m02 * v.x + m12 * v.y + m22 * v.z,
    )


def refract(i: V3, n: V3, eta) -> V3:
    """GLSL refract (i, n unit); returns 0 on total internal reflection."""
    cos_i = -dot(i, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    coef = eta * cos_i - torch.sqrt(torch.clamp_min(k, 0.0))
    out = V3(eta * i.x + coef * n.x, eta * i.y + coef * n.y,
             eta * i.z + coef * n.z)
    tir = k < 0.0
    return V3(
        torch.where(tir, 0.0, out.x),
        torch.where(tir, 0.0, out.y),
        torch.where(tir, 0.0, out.z),
    )
