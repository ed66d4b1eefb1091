"""Camera matrices and primary-ray generation
(raytrace_tpu/ops/camera.py:29-76 and :134).

The host side builds the reference's matrices in float64 numpy (glam
``perspective_rh`` + ``look_at_rh``, camera.rs:58-60); the device side is
the raygen of ray_gen.glsl:543-571, including the thin-lens quirk (the
lens sample is scaled by the NDC coordinate, SURVEY.md §8 quirk 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .vec3 import V3, normalize


class CameraArrays(NamedTuple):
    """Device camera state for one (camera, resolution) pair."""

    view_inverse: torch.Tensor   # [4,4] f32 (v_world = M @ v_cam)
    proj_inverse: torch.Tensor   # [4,4] f32
    focal_length: torch.Tensor   # f32 scalar
    aperture_size: torch.Tensor  # f32 scalar


def perspective_rh(fov_y_rad: float, aspect: float, z_near: float,
                   z_far: float) -> np.ndarray:
    """glam Mat4::perspective_rh (Vulkan 0..1 depth), row-major (y = M @ x)."""
    sin_fov = math.sin(0.5 * fov_y_rad)
    cos_fov = math.cos(0.5 * fov_y_rad)
    h = cos_fov / sin_fov
    w = h / aspect
    r = z_far / (z_near - z_far)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """glam Mat4::look_at_rh, row-major."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def build_camera_arrays(params, width: int, height: int,
                        device) -> CameraArrays:
    """params: models.compile.CameraParams."""
    aspect = width / height
    proj = perspective_rh(math.radians(params.fov_y_deg), aspect,
                          params.z_near, params.z_far)
    view = look_at_rh(params.eye, np.asarray(params.look_at, np.float64),
                      np.asarray(params.up, np.float64))

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return CameraArrays(
        view_inverse=f32(np.linalg.inv(view)),
        proj_inverse=f32(np.linalg.inv(proj)),
        focal_length=f32(params.focal_length),
        aperture_size=f32(params.aperture_size),
    )


def get_rays_v3(state, cam: CameraArrays, px, py, si, sj, width, height,
                sqrt_spp, use_dof: bool = False):
    """Primary rays for a wavefront.  px, py, si, sj: integer [R] tensors.
    Returns (state, origin V3, direction V3)."""
    recip_sqrt_spp = float(np.float32(1.0 / sqrt_spp))
    state, ox_pix, oy_pix = rng.sample_square_stratified(
        state, si.to(torch.float32), sj.to(torch.float32), recip_sqrt_spp)

    dx = ((px.to(torch.float32) + 0.5 + ox_pix) / width) * 2.0 - 1.0
    dy = ((py.to(torch.float32) + 0.5 + oy_pix) / height) * 2.0 - 1.0

    vi = cam.view_inverse
    pi = cam.proj_inverse

    target = V3(
        pi[0, 0] * dx + pi[0, 1] * dy + pi[0, 2] + pi[0, 3],
        pi[1, 0] * dx + pi[1, 1] * dy + pi[1, 2] + pi[1, 3],
        pi[2, 0] * dx + pi[2, 1] * dy + pi[2, 2] + pi[2, 3],
    )
    tn = normalize(target)
    direction = V3(
        vi[0, 0] * tn.x + vi[0, 1] * tn.y + vi[0, 2] * tn.z,
        vi[1, 0] * tn.x + vi[1, 1] * tn.y + vi[1, 2] * tn.z,
        vi[2, 0] * tn.x + vi[2, 1] * tn.y + vi[2, 2] * tn.z,
    )
    ones = torch.ones_like(dx)
    origin = V3(vi[0, 3] * ones, vi[1, 3] * ones, vi[2, 3] * ones)

    if use_dof:
        state, lx, ly = rng.sample_disk_concentric_xy(state)
        half_ap = cam.aperture_size / 2.0
        # QUIRK (ray_gen.glsl:554-558): world x/y offset scaled by NDC d.
        origin = V3(
            origin.x + lx * half_ap * dx,
            origin.y + ly * half_ap * dy,
            origin.z,
        )
        fp = V3(cam.focal_length * tn.x, cam.focal_length * tn.y,
                cam.focal_length * tn.z)
        fpw = V3(
            vi[0, 0] * fp.x + vi[0, 1] * fp.y + vi[0, 2] * fp.z + vi[0, 3],
            vi[1, 0] * fp.x + vi[1, 1] * fp.y + vi[1, 2] * fp.z + vi[1, 3],
            vi[2, 0] * fp.x + vi[2, 1] * fp.y + vi[2, 2] * fp.z + vi[2, 3],
        )
        direction = normalize(fpw - origin)

    return state, origin, direction
