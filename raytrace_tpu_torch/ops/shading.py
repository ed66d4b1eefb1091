"""Fat-row scatter and emission on V3 state
(raytrace_tpu/ops/shading.py:216-311).

Each hit primitive's material arrives pre-resolved as one 32-float row of
``CompiledScene.shade_rows`` (layout in raytrace_tpu/models/shading_table.py);
every material family is evaluated for every ray and mask-selected, and the
RNG draws are unconditional, so every ray consumes the same stream values
per bounce whatever its material.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.compile import (
    MAT_TYPE_DIELECTRIC,
    MAT_TYPE_DIFFUSE_LIGHT,
    MAT_TYPE_LAMBERTIAN,
    MAT_TYPE_METAL,
)
from ..models.shading_table import MODE_CHECKER, MODE_IMAGE, MODE_NOISE

from . import perlin, rng, textures, vec3
from .materials import COSINE_PDF, NO_PDF, schlick_reflectance
from .textures import TexFlags, checker_is_even
from .vec3 import V3


class ScatterV3(NamedTuple):
    is_scattered: torch.Tensor  # [R] bool
    attenuation: V3
    mat_pdf_type: torch.Tensor  # [R] int32
    skip_pdf: torch.Tensor      # [R] bool
    skip_dir: V3                # next direction where skip_pdf


def _rowv3(rows, c0):
    return V3(rows[:, c0], rows[:, c0 + 1], rows[:, c0 + 2])


def _eval_slot(flags: TexFlags, image, base: V3, mode, aux, p: V3,
               turb) -> V3:
    """One basic property slot (raytrace_tpu/ops/shading.py:194-209): the
    constant rgb; where the slot's mode is image, image ``aux`` (clipped
    to the atlas) sampled at the hit's UV; where it is noise, the marble
    (ray_gen.glsl:203-208) on all three channels, aux being the baked
    noise scale.  ``image`` is (scene, u, v) in a scene with an image
    texture; ``turb`` is the hit points' turbulence, computed once for
    every slot (None without noise)."""
    out = base
    if flags.has_image:
        scene, u, v = image
        idx = torch.clamp(aux.to(torch.int32), 0, scene.atlas.shape[0] - 1)
        img = textures.sample_image_nearest(scene.atlas, scene.atlas_wh,
                                            scene.srgb_lut, idx, u, v)
        out = vec3.where(mode == MODE_IMAGE,
                         V3(img[:, 0], img[:, 1], img[:, 2]), out)
    if flags.has_noise:
        m = 0.5 * (1.0 + torch.sin(aux * p.z + 10.0 * turb))
        out = vec3.where(mode == MODE_NOISE, V3(m, m, m), out)
    return out


def _eval_property(flags: TexFlags, image, rows, base_col: int,
                   mode_col: int, p, turb) -> V3:
    """A property slot (cols base_col:+3, its mode at mode_col and aux
    after it), or the row's checker of two slots where the mode says so
    (raytrace_tpu/ops/shading.py:216-251)."""
    out = _eval_slot(flags, image, _rowv3(rows, base_col), rows[:, mode_col],
                     rows[:, mode_col + 1], p, turb)
    if flags.has_checker:
        even = _eval_slot(flags, image, _rowv3(rows, 18), rows[:, 24],
                          rows[:, 25], p, turb)
        odd = _eval_slot(flags, image, _rowv3(rows, 21), rows[:, 26],
                         rows[:, 27], p, turb)
        ck = vec3.where(checker_is_even(rows[:, 17], p), even, odd)
        out = vec3.where(rows[:, mode_col] == MODE_CHECKER, ck, out)
    return out


def scatter_and_emit_v3(state, flags: TexFlags, rows, p: V3, normal: V3,
                        front_face, wrd: V3, scene=None, hit_u=None,
                        hit_v=None):
    """Fat-row calculateScatter + calculateEmission (ray_gen.glsl:328-440).
    ``normal`` is the front-face-flipped shading normal, ``wrd`` the
    incoming direction as traced; a scene with an image texture needs
    ``scene`` (its atlas, sizes and sRGB table) and the hits' UV ``hit_u``,
    ``hit_v``.  Returns (state, ScatterV3, emission V3).
    """
    mat_type = rows[:, 0].to(torch.int32)

    state, fuzz_unit = rng.random_unit_v3(state)
    state, diel_u = rng.random_float(state)

    # One turbulence at the hit point serves every slot.
    turb = (perlin.turbulence_v3(p.x, p.y, p.z, 7) if flags.has_noise
            else None)
    image = (scene, hit_u, hit_v)
    albedo = _eval_property(flags, image, rows, 2, 11, p, turb)
    fuzz = _rowv3(rows, 5)

    is_lamb = mat_type == MAT_TYPE_LAMBERTIAN
    is_metal = mat_type == MAT_TYPE_METAL
    is_diel = mat_type == MAT_TYPE_DIELECTRIC
    is_light = mat_type == MAT_TYPE_DIFFUSE_LIGHT

    # metal (ray_gen.glsl:344-364)
    reflected = vec3.reflect(wrd, normal)
    metal_scatters = vec3.dot(reflected, normal) > 0.0
    refl_unit = vec3.normalize(reflected)
    metal_dir = refl_unit + fuzz * fuzz_unit

    # dielectric (ray_gen.glsl:366-399)
    ref_idx = rows[:, 1]
    ri = torch.where(front_face,
                     1.0 / torch.where(ref_idx == 0.0, 1.0, ref_idx), ref_idx)
    unit_dir = vec3.normalize(wrd)
    cos_theta = torch.clamp_max(-vec3.dot(unit_dir, normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ((ri * sin_theta > 1.0)
                      | (schlick_reflectance(cos_theta, ri) > diel_u))
    diel_dir = vec3.where(
        cannot_refract,
        vec3.reflect(unit_dir, normal),
        vec3.refract(unit_dir, normal, ri),
    )

    ones = torch.ones_like(ref_idx)
    zero = V3(torch.zeros_like(ones), torch.zeros_like(ones),
              torch.zeros_like(ones))
    is_scattered = is_lamb | is_diel | (is_metal & metal_scatters)
    attenuation = vec3.where(
        is_lamb | is_metal, albedo,
        vec3.where(is_diel, V3(ones, ones, ones), zero),
    )
    skip_pdf = is_metal | is_diel
    skip_dir = vec3.where(is_metal, metal_dir,
                          vec3.where(is_diel, diel_dir, zero))
    mat_pdf_type = torch.where(is_lamb, COSINE_PDF, NO_PDF).to(torch.int32)

    srec = ScatterV3(
        is_scattered=is_scattered, attenuation=attenuation,
        mat_pdf_type=mat_pdf_type, skip_pdf=skip_pdf, skip_dir=skip_dir,
    )

    if flags.has_emissive:
        emit = _eval_property(flags, image, rows, 8, 15, p, turb)
        emission = vec3.where(is_light & front_face, emit, zero)
    else:
        emission = zero
    return state, srec, emission
