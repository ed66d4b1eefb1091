"""Texture families (raytrace_tpu/ops/textures.py:32-61 and :118-124).

The fat shading rows (``models/shading_table.py``) resolve
constant colours on the host, so on the device the constant family is the
row's rgb slots, the checker family is one parity test and the noise
family is the marble of ops/perlin.py's turbulence (ops/shading.py) and
the image family ``sample_image_nearest`` at the hit's UV.

``TexFlags.for_scene`` is the JAX rule as it stands, quirk included: a
``noise`` texture whose scale is 0 leaves ``has_noise`` False, so its slot
shades as the row's zero base colour, not as the marble.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.compile import MAT_TYPE_DIFFUSE_LIGHT


class TexFlags(NamedTuple):
    """Which texture/material families a scene uses."""

    has_image: bool
    has_checker: bool
    has_noise: bool
    has_emissive: bool = True

    @staticmethod
    def for_scene(cs) -> "TexFlags":
        """cs: models.compile.CompiledScene."""
        return TexFlags(
            has_image=bool(np.prod(cs.atlas.shape[1:3]) > 1),
            has_checker=bool(len(cs.checker_scale) > 0
                             and cs.checker_scale.any()),
            has_noise=bool(len(cs.noise_scale) > 0 and cs.noise_scale.any()),
            has_emissive=bool(
                (cs.tri_mat_type == MAT_TYPE_DIFFUSE_LIGHT).any()
                or (cs.sph_mat_type == MAT_TYPE_DIFFUSE_LIGHT).any()
            ),
        )


def srgb_u8_to_linear_lut() -> np.ndarray:
    """256-entry sRGB-decode table (hardware R8G8B8A8_SRGB semantics)."""
    c = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


def checker_is_even(scale, p):
    """Checker parity at hit point p (V3) for cell size ``scale`` [R]
    (ray_gen.glsl:214-243).  ``%`` is floor-mod, as in jnp."""
    inv_scale = 1.0 / torch.where(scale == 0.0, 1.0, scale)
    cells = (torch.floor(inv_scale * p.x).to(torch.int32)
             + torch.floor(inv_scale * p.y).to(torch.int32)
             + torch.floor(inv_scale * p.z).to(torch.int32))
    return cells % 2 == 0


def sample_image_nearest(atlas, atlas_wh, srgb_lut, index, u, v):
    """Nearest/repeat sample of image ``index`` [R] at (u, v) [R]
    (raytrace_tpu/ops/textures.py:63-76).  atlas: [NI, AH, AW, 3] uint8
    sRGB, padded to the largest image; atlas_wh: [NI, 2] int32 (width,
    height); srgb_lut: [256] f32.  Returns [R, 3] linear f32.  ``%`` is
    floor-mod (torch.remainder: fmod plus the divisor where the signs
    differ, as jnp.remainder), in JAX's order of operations."""
    wh = atlas_wh[index]
    w = wh[:, 0].to(torch.float32)
    h = wh[:, 1].to(torch.float32)
    x = torch.floor(torch.remainder(u, 1.0) * w).to(torch.int32)
    y = torch.floor(torch.remainder(v, 1.0) * h).to(torch.int32)
    x = torch.minimum(torch.clamp_min(x, 0), wh[:, 0] - 1)
    y = torch.minimum(torch.clamp_min(y, 0), wh[:, 1] - 1)
    texel = atlas[index.long(), y.long(), x.long()]
    return srgb_lut[texel.long()]
