"""Next-event estimation: alias-table light sampling, the 50/50 mixture
choice and pdf evaluation (raytrace_tpu/ops/nee.py:27-124,
ray_gen.glsl:252-326).

Scenes without lights sample only the material pdf; the light sample is a
zero placeholder that no pdf branch reads.

QUIRK kept (SURVEY.md §8 #2): the sampled light triangle, stored in object
space, is moved to the world by the objectToWorld of the instance that was
HIT, not by the light's own.  That is right only where the two coincide;
the reference does it, so the port does it too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rng, vec3
from .materials import COSINE_PDF, LIGHT_PDF, SPHERE_PDF
from .vec3 import V3

PI = float(np.float32(np.pi))
# 1 / (4 pi) rounded in float32 arithmetic, as the JAX package computes it.
_SPHERE_PDF_VALUE = float(np.float32(1.0) / (np.float32(4.0) * np.float32(PI)))


class LightSampleV3(NamedTuple):
    position: V3
    normal: V3


def choose_mixture_pdf(state, mat_pdf_type, has_lights: bool):
    """50/50 light/material choice (ray_gen.glsl:317-326): one draw, and
    r < 0.5 picks the light pdf.  Without lights the material pdf is used
    and no RNG is consumed (the reference's early return)."""
    if not has_lights:
        return state, mat_pdf_type
    state, r = rng.random_float(state)
    return state, torch.where(r < 0.5, LIGHT_PDF,
                              mat_pdf_type).to(torch.int32)


def sample_light_sources_v3(state, scene, o2w_cols):
    """One point on a light triangle picked by the alias table, in world
    space (raytrace_tpu/ops/nee.py:46-68).  ``o2w_cols`` are the 12 [R]
    entries of the HIT instance's objectToWorld (the quirk above)."""
    state, u1 = rng.random_float(state)
    state, u2 = rng.random_float(state)

    n = scene.light_count.to(torch.float32)
    n_idx = torch.clamp_min(scene.light_count - 1, 0)
    i = torch.minimum((u1 * n).to(torch.int32), n_idx).long()
    use_alias = u2 >= scene.light_prob[i]
    tri_index = torch.where(use_alias, scene.light_alias[i].long(), i)

    row = scene.light_tri_packed[tri_index]        # [R, 16]: p0 p1 p2 ...
    w0, w1, w2 = (vec3.mat34_apply_point(
        o2w_cols, V3(row[:, c], row[:, c + 1], row[:, c + 2]))
        for c in (0, 3, 6))
    state, position = rng.sample_triangle_uniform_v3(state, w0, w1, w2)
    nrm = vec3.normalize(vec3.cross(w1 - w0, w2 - w0))
    return state, LightSampleV3(position=position, normal=nrm)


def pdf_value_v3(pdf_type, direction: V3, normal: V3, light: LightSampleV3,
                 total_area):
    """getPdfValue (ray_gen.glsl:283-301)."""
    dn = vec3.norm(direction)
    inv = 1.0 / torch.where(dn == 0.0, 1.0, dn)
    unit = V3(direction.x * inv, direction.y * inv, direction.z * inv)

    sphere = _SPHERE_PDF_VALUE
    cosine = torch.clamp_min(vec3.dot(unit, normal) / PI, 0.0)

    dist_sq = vec3.dot(direction, direction)
    cos_l = torch.abs(-vec3.dot(light.normal, unit))
    light_pdf = torch.where(
        cos_l <= 0.0, 0.0,
        (dist_sq / torch.where(cos_l <= 0.0, 1.0, cos_l)) * (1.0 / total_area),
    )

    out = torch.zeros_like(cosine)
    out = torch.where(pdf_type == SPHERE_PDF, sphere, out)
    out = torch.where(pdf_type == COSINE_PDF, cosine, out)
    out = torch.where(pdf_type == LIGHT_PDF, light_pdf, out)
    return out


def make_onb_v3(n: V3):
    """Orthonormal basis about n (common.glsl:187-197)."""
    axis2 = vec3.normalize(n)
    pick_y = torch.abs(axis2.x) > 0.9
    zero = torch.zeros_like(axis2.x)
    one = torch.ones_like(axis2.x)
    a = V3(torch.where(pick_y, zero, one), torch.where(pick_y, one, zero),
           zero)
    axis1 = vec3.normalize(vec3.cross(axis2, a))
    axis0 = vec3.cross(axis2, axis1)
    return axis0, axis1, axis2


def gen_scatter_direction_v3(state, pdf_type, hit_p: V3, normal: V3,
                             light: LightSampleV3):
    """genScatterDirection (ray_gen.glsl:303-315)."""
    state, sphere_dir = rng.random_unit_v3(state)
    state, cl = rng.random_cosine_v3(state)
    a0, a1, a2 = make_onb_v3(normal)
    cosine_dir = V3(
        cl.x * a0.x + cl.y * a1.x + cl.z * a2.x,
        cl.x * a0.y + cl.y * a1.y + cl.z * a2.y,
        cl.x * a0.z + cl.y * a1.z + cl.z * a2.z,
    )
    light_dir = light.position - hit_p

    zero = vec3.zeros_like(sphere_dir)
    out = vec3.where(pdf_type == SPHERE_PDF, sphere_dir, zero)
    out = vec3.where(pdf_type == COSINE_PDF, cosine_dir, out)
    out = vec3.where(pdf_type == LIGHT_PDF, light_dir, out)
    return state, out
