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

from raytrace_tpu.models.compile import (
    MAT_TYPE_DIELECTRIC,
    MAT_TYPE_DIFFUSE_LIGHT,
    MAT_TYPE_LAMBERTIAN,
    MAT_TYPE_METAL,
)
from raytrace_tpu.models.shading_table import MODE_CHECKER

from . import rng, vec3
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


def _check_families(flags: TexFlags) -> None:
    if flags.has_image:
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP queue 1: "
            "'Image textures')")
    if flags.has_noise:
        raise NotImplementedError(
            "noise textures are not ported yet (ROADMAP queue 1: "
            "'Noise textures')")


def _eval_property(flags: TexFlags, rows, base_col: int, mode_col: int, p):
    """A constant property slot, or the row's checker when the slot's mode
    says so (ray_gen.glsl:184-243)."""
    _check_families(flags)
    out = _rowv3(rows, base_col)
    if flags.has_checker:
        even = checker_is_even(rows[:, 17], p)
        ck = vec3.where(even, _rowv3(rows, 18), _rowv3(rows, 21))
        out = vec3.where(rows[:, mode_col] == MODE_CHECKER, ck, out)
    return out


def eval_albedo_v3(flags: TexFlags, rows, p: V3) -> V3:
    return _eval_property(flags, rows, 2, 11, p)


def eval_emit_v3(flags: TexFlags, rows, p: V3) -> V3:
    return _eval_property(flags, rows, 8, 15, p)


def scatter_and_emit_v3(state, flags: TexFlags, rows, p: V3, normal: V3,
                        front_face, wrd: V3):
    """Fat-row calculateScatter + calculateEmission (ray_gen.glsl:328-440).
    ``normal`` is the front-face-flipped shading normal, ``wrd`` the
    incoming direction as traced.  Returns (state, ScatterV3, emission V3).
    """
    mat_type = rows[:, 0].to(torch.int32)

    state, fuzz_unit = rng.random_unit_v3(state)
    state, diel_u = rng.random_float(state)

    albedo = eval_albedo_v3(flags, rows, p)
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
        emit = eval_emit_v3(flags, rows, p)
        emission = vec3.where(is_light & front_face, emit, zero)
    else:
        emission = zero
    return state, srec, emission
