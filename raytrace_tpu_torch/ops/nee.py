"""Next-event estimation, the no-light branch (raytrace_tpu/ops/nee.py:27,
:71, :95, :107).

Scenes without lights sample only the material pdf; the light sample is a
zero placeholder that no pdf branch reads.  Light sampling (the alias table
and the hit-instance o2w quirk) is still to port: ROADMAP queue 1, 'NEE
with lights'.
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
    """50/50 light/material choice (ray_gen.glsl:317-326); without lights
    the material pdf is used and no RNG is consumed."""
    if has_lights:
        raise NotImplementedError(
            "NEE with lights is not ported yet (ROADMAP queue 1: "
            "'NEE with lights')")
    return state, mat_pdf_type


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
