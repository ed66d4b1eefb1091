"""Registry scatter and emission on [R, 3] rows (raytrace_tpu/ops/
materials.py): the shading of scenes whose material graph the 32-float
fat row cannot encode (models/shading_table.py ComplexMaterial), where each
property is looked up in the scene's material and texture tables.

All four material families are evaluated for every ray and combined with
masked selects; the RNG draws are unconditional (a unit vector, then a
float), so every ray consumes the same stream values per bounce whatever
its material, as the fat-row path (ops/shading.py) does.  Every dot
product is written out in index order, the sum the V3 functions of
ops/vec3.py take, so a scene that fits both encodings gets the same bits
from either.
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
from . import perlin, rng, textures, vec3

# PDF type tags (common.glsl:117-121).
NO_PDF = 0
SPHERE_PDF = 1
COSINE_PDF = 2
LIGHT_PDF = 3


class ScatterRecord(NamedTuple):
    is_scattered: torch.Tensor  # [R] bool
    attenuation: torch.Tensor   # [R, 3]
    mat_pdf_type: torch.Tensor  # [R] int32
    skip_pdf: torch.Tensor      # [R] bool
    skip_dir: torch.Tensor      # [R, 3] next ray direction where skip_pdf


def schlick_reflectance(cosine, refraction_index):
    """ray_gen.glsl:246-250.  ``x ** 5`` is spelled as the squarings JAX's
    integer_pow lowers to, so both packages round the same products."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def _dot(a, b):
    """Row-wise dot product of [R, 3] rows, summed in index order."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _normalize(v, eps: float = 1e-20):
    inv = 1.0 / torch.clamp_min(torch.sqrt(_dot(v, v)), eps)
    return v * inv[:, None]


def reflect(i, n):
    """GLSL reflect on [R, 3] rows (raytrace_tpu/ops/materials.py:41)."""
    return i - (2.0 * _dot(i, n))[:, None] * n


def refract(i, n, eta):
    """GLSL refract: i, n unit [R, 3]; eta = n1 / n2, [R, 1].  Returns 0
    on total internal reflection (raytrace_tpu/ops/materials.py:45-53)."""
    cos_i = -_dot(i, n)[:, None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = eta * i + (eta * cos_i - torch.sqrt(torch.clamp_min(k, 0.0))) * n
    return torch.where(k < 0.0, 0.0, out)


def _turbulence(flags: textures.TexFlags, hit_p):
    """The hit points' turbulence, computed once for every property, or
    None without noise."""
    return perlin.turbulence(hit_p, 7) if flags.has_noise else None


def calculate_scatter(state, scene, flags: textures.TexFlags, mat_type,
                      mat_index, hit_p, normal, front_face, hit_u, hit_v,
                      world_ray_dir, turb=None):
    """calculateScatter (ray_gen.glsl:414-429; raytrace_tpu/ops/
    materials.py:60-137).  ``normal`` is the front-face-flipped shading
    normal and ``world_ray_dir`` the incoming direction as traced, both
    [R, 3]; ``turb`` the hit points' turbulence where the caller has it.
    Returns (state, ScatterRecord)."""
    R = mat_type.shape[0]
    if turb is None:
        turb = _turbulence(flags, hit_p)

    # Unconditional RNG draws (see the module docstring).
    state, fuzz_unit = rng.random_unit_v3(state)
    fuzz_unit = vec3.to_rows(fuzz_unit)
    state, diel_u = rng.random_float(state)

    zero3 = torch.zeros((R, 3), dtype=torch.float32, device=hit_p.device)

    def prop(table, idx):
        return textures.eval_property(scene, flags, table[idx, 0],
                                      table[idx, 1], hit_p, hit_u, hit_v,
                                      turb=turb)

    # lambertian (ray_gen.glsl:328-342)
    is_lamb = (mat_type == MAT_TYPE_LAMBERTIAN) & (mat_index < scene.n_lamb)
    li = torch.clamp(mat_index, 0, scene.lamb_albedo.shape[0] - 1).long()
    lamb_albedo = prop(scene.lamb_albedo, li)

    # metal (ray_gen.glsl:344-364)
    is_metal = (mat_type == MAT_TYPE_METAL) & (mat_index < scene.n_metal)
    mi = torch.clamp(mat_index, 0, scene.metal_albedo.shape[0] - 1).long()
    metal_albedo = prop(scene.metal_albedo, mi)
    metal_fuzz = prop(scene.metal_fuzz, mi)
    reflected = reflect(world_ray_dir, normal)
    metal_scatters = _dot(reflected, normal) > 0.0
    metal_dir = _normalize(reflected) + metal_fuzz * fuzz_unit

    # dielectric (ray_gen.glsl:366-399)
    is_diel = (mat_type == MAT_TYPE_DIELECTRIC) & (mat_index < scene.n_diel)
    di = torch.clamp(mat_index, 0, scene.diel_ri.shape[0] - 1).long()
    ref_idx = scene.diel_ri[di]
    ri = torch.where(front_face, 1.0 / ref_idx, ref_idx)
    unit_dir = _normalize(world_ray_dir)
    cos_theta = torch.clamp_max(_dot(-unit_dir, normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ((ri * sin_theta > 1.0)
                      | (schlick_reflectance(cos_theta, ri) > diel_u))
    diel_dir = torch.where(cannot_refract[:, None],
                           reflect(unit_dir, normal),
                           refract(unit_dir, normal, ri[:, None]))

    # combine
    is_scattered = is_lamb | is_diel | (is_metal & metal_scatters)
    attenuation = torch.where(
        is_lamb[:, None], lamb_albedo,
        torch.where(is_metal[:, None], metal_albedo,
                    torch.where(is_diel[:, None], torch.ones_like(zero3),
                                zero3)))
    skip_pdf = is_metal | is_diel
    skip_dir = torch.where(is_metal[:, None], metal_dir,
                           torch.where(is_diel[:, None], diel_dir, zero3))
    mat_pdf_type = torch.where(is_lamb, COSINE_PDF, NO_PDF).to(torch.int32)
    return state, ScatterRecord(
        is_scattered=is_scattered, attenuation=attenuation,
        mat_pdf_type=mat_pdf_type, skip_pdf=skip_pdf, skip_dir=skip_dir)


def calculate_emission(scene, flags: textures.TexFlags, mat_type, mat_index,
                       hit_p, front_face, hit_u, hit_v, turb=None):
    """Diffuse-light emission, front faces only (ray_gen.glsl:401-412;
    raytrace_tpu/ops/materials.py:140-153): [R, 3]."""
    if turb is None:
        turb = _turbulence(flags, hit_p)
    is_light = ((mat_type == MAT_TYPE_DIFFUSE_LIGHT)
                & (mat_index < scene.n_light_mat) & front_face)
    ei = torch.clamp(mat_index, 0, scene.light_emit.shape[0] - 1).long()
    emit = textures.eval_property(scene, flags, scene.light_emit[ei, 0],
                                  scene.light_emit[ei, 1], hit_p, hit_u,
                                  hit_v, turb=turb)
    return torch.where(is_light[:, None], emit, 0.0)
