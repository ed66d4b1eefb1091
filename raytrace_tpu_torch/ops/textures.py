"""Texture families (raytrace_tpu/ops/textures.py:32-61 and :118-124).

The fat shading rows (``raytrace_tpu.models.shading_table``) resolve
constant colours on the host, so on the device the constant family is the
row's rgb slots and the checker family is one parity test.  Image and
noise textures are not ported yet (ops/shading.py raises for them).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu.models.compile import MAT_TYPE_DIFFUSE_LIGHT


class TexFlags(NamedTuple):
    """Which texture/material families a scene uses."""

    has_image: bool
    has_checker: bool
    has_noise: bool
    has_emissive: bool = True

    @staticmethod
    def for_scene(cs) -> "TexFlags":
        """cs: raytrace_tpu.models.compile.CompiledScene."""
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
