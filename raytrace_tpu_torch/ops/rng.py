"""Per-ray PCG hash RNG (raytrace_tpu/ops/rng.py:32-208).

Each ray carries one 32-bit state.  torch has no usable ``uint32`` on the
CPU (no ``+`` or ``>>``), so states live in int64 tensors holding values in
[0, 2^32) and every wrapping step is masked with ``& 0xFFFFFFFF``.
Products stay below 2^62 because both multipliers are below 2^30, so the
int64 arithmetic never overflows and the words equal the JAX uint32 words
bit for bit.  The word → float32 cast is one round-to-nearest conversion,
the same single rounding the JAX package gets from ``_u32_to_f32`` (a TPU
workaround that is not needed here).
"""

from __future__ import annotations

import numpy as np
import torch

from .vec3 import V3

_MASK = 0xFFFFFFFF
_MUL = 747796405
_INC = 1
_OUT_MUL = 277803737
_U32_MAX_F = float(np.float32(4294967295.0))

TWO_PI = float(np.float32(2.0 * np.pi))
PI_OVER_2 = float(np.float32(np.pi / 2.0))
PI_OVER_4 = float(np.float32(np.pi / 4.0))


def init_rng(sample_batch, sample_index, py, px, resolution_x, resolution_y,
             spp):
    """Per-(pixel, sample) seed, wrapped to 32 bits:
    ``((batch * spp + sample) * res_y + py) * res_x + px``.
    Integer tensors in, int64 state out."""
    s = (sample_batch * spp + sample_index) & _MASK
    s = (s * resolution_y + py) & _MASK
    return (s * resolution_x + px) & _MASK


def step_rng(state):
    return (state * _MUL + _INC) & _MASK


def random_float(state):
    """Returns (new_state, float32 in [0, 1])."""
    state = step_rng(state)
    word = (((state >> ((state >> 28) + 4)) ^ state) * _OUT_MUL) & _MASK
    word = (word >> 22) ^ word
    return state, word.to(torch.float32) / _U32_MAX_F


def sample_square_stratified(state, si, sj, recip_sqrt_spp):
    """Jittered offset inside sub-pixel cell (si, sj) (common.glsl:377-381)."""
    state, rx = random_float(state)
    state, ry = random_float(state)
    px = (si + rx) * recip_sqrt_spp - 0.5
    py = (sj + ry) * recip_sqrt_spp - 0.5
    return state, px, py


def random_unit_v3(state):
    """Uniform direction on the unit sphere."""
    state, u1 = random_float(state)
    state, u2 = random_float(state)
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return state, V3(r * torch.cos(phi), r * torch.sin(phi), z)


def random_cosine_v3(state):
    """Cosine-weighted hemisphere about +z (common.glsl:336-346)."""
    state, r1 = random_float(state)
    state, r2 = random_float(state)
    phi = TWO_PI * r1
    sq = torch.sqrt(r2)
    return state, V3(
        torch.cos(phi) * sq, torch.sin(phi) * sq,
        torch.sqrt(torch.clamp_min(1.0 - r2, 0.0)),
    )


def sample_triangle_uniform_v3(state, p0: V3, p1: V3, p2: V3):
    """Uniform point on a triangle (common.glsl:383-394): two draws, then
    the fold of (rx, ry) into the lower triangle when rx + ry > 1."""
    state, rx = random_float(state)
    state, ry = random_float(state)
    flip = rx + ry > 1.0
    rx = torch.where(flip, 1.0 - rx, rx)
    ry = torch.where(flip, 1.0 - ry, ry)
    return state, V3(
        p0.x + rx * (p1.x - p0.x) + ry * (p2.x - p0.x),
        p0.y + rx * (p1.y - p0.y) + ry * (p2.y - p0.y),
        p0.z + rx * (p1.z - p0.z) + ry * (p2.z - p0.z),
    )


def sample_disk_concentric_xy(state):
    """Concentric disk sample as two [R] components (common.glsl:353-373)."""
    state, u1 = random_float(state)
    state, u2 = random_float(state)
    ux = 2.0 * u1 - 1.0
    uy = 2.0 * u2 - 1.0
    degenerate = (ux == 0.0) & (uy == 0.0)
    x_major = torch.abs(ux) > torch.abs(uy)
    r = torch.where(x_major, ux, uy)

    def safe(num, den):
        return num / torch.where(den == 0.0, 1.0, den)

    theta = torch.where(
        x_major,
        PI_OVER_4 * safe(uy, ux),
        PI_OVER_2 - PI_OVER_4 * safe(ux, uy),
    )
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    return (state, torch.where(degenerate, 0.0, x),
            torch.where(degenerate, 0.0, y))
