"""Texture families (raytrace_tpu/ops/textures.py).

The fat shading rows (``models/shading_table.py``) resolve
constant colours on the host, so on the device the constant family is the
row's rgb slots, the checker family is one parity test and the noise
family is the marble of ops/perlin.py's turbulence (ops/shading.py) and
the image family ``sample_image_nearest`` at the hit's UV.  Scenes whose
material graph the fat row cannot encode look each property up in the
scene's texture tables instead: ``eval_basic`` (constant, image, noise)
and ``eval_property`` (those and one checker indirection), as
ops/materials.py's registry shading calls them.

``TexFlags.for_scene`` is the JAX rule as it stands, quirk included: a
``noise`` texture whose scale is 0 leaves ``has_noise`` False, so its slot
shades as the row's zero base colour, not as the marble.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.compile import (MAT_PROP_CHECKER, MAT_PROP_IMAGE,
                              MAT_PROP_NOISE, MAT_PROP_RGB,
                              MAT_TYPE_DIFFUSE_LIGHT)
from . import perlin
from .vec3 import V3


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


def eval_basic(scene, flags: TexFlags, ptype, pindex, hit_p, hit_u, hit_v,
               turb=None):
    """Constant / image / noise evaluation (ray_gen.glsl:184-212;
    raytrace_tpu/ops/textures.py:78-110).  ptype, pindex: [R] int32;
    hit_p: [R, 3]; hit_u, hit_v: [R] (read only with an image texture);
    ``turb``: the hit points' turbulence where the caller has it (computed
    here otherwise).  Returns [R, 3]; a reference outside its table, or of
    another family, gives 0."""
    R = ptype.shape[0]
    out = torch.zeros((R, 3), dtype=torch.float32, device=hit_p.device)
    rgb = scene.const_colours[torch.clamp(
        pindex, 0, scene.const_colours.shape[0] - 1).long()]
    out = torch.where(((ptype == MAT_PROP_RGB)
                       & (pindex < scene.n_const))[:, None], rgb, out)
    if flags.has_image:
        idx = torch.clamp(pindex, 0, scene.atlas.shape[0] - 1)
        img = sample_image_nearest(scene.atlas, scene.atlas_wh,
                                   scene.srgb_lut, idx, hit_u, hit_v)
        out = torch.where(((ptype == MAT_PROP_IMAGE)
                           & (pindex < scene.n_image))[:, None], img, out)
    if flags.has_noise:
        if turb is None:
            turb = perlin.turbulence(hit_p, 7)
        scale = scene.noise_scale[torch.clamp(
            pindex, 0, scene.noise_scale.shape[0] - 1).long()]
        marble = 0.5 * (1.0 + torch.sin(scale * hit_p[:, 2] + 10.0 * turb))
        out = torch.where(((ptype == MAT_PROP_NOISE)
                           & (pindex < scene.n_noise))[:, None],
                          marble[:, None].expand(R, 3), out)
    return out


def eval_property(scene, flags: TexFlags, ptype, pindex, hit_p, hit_u,
                  hit_v, turb=None):
    """A material property with one checker indirection (ray_gen.glsl:
    214-243; raytrace_tpu/ops/textures.py:113-139): ``eval_basic``, or
    where the property is a checker, its even or odd side by
    ``checker_is_even`` at the hit point.  Returns [R, 3]."""
    out = eval_basic(scene, flags, ptype, pindex, hit_p, hit_u, hit_v, turb)
    if flags.has_checker:
        ck = torch.clamp(pindex, 0, scene.checker_scale.shape[0] - 1).long()
        p = V3(hit_p[:, 0], hit_p[:, 1], hit_p[:, 2])
        even = checker_is_even(scene.checker_scale[ck], p)
        e, o = scene.checker_even[ck], scene.checker_odd[ck]
        even_val = eval_basic(scene, flags, e[:, 0], e[:, 1], hit_p, hit_u,
                              hit_v, turb)
        odd_val = eval_basic(scene, flags, o[:, 0], o[:, 1], hit_p, hit_u,
                             hit_v, turb)
        out = torch.where(((ptype == MAT_PROP_CHECKER)
                           & (pindex < scene.n_checker))[:, None],
                          torch.where(even[:, None], even_val, odd_val), out)
    return out
