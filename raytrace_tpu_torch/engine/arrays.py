"""Device-resident scene state (raytrace_tpu/engine/arrays.py:24-228).

``SceneArrays`` holds the scene's tensors, field for field the JAX
package's ``SceneArrays``, so ``from_jax_scene`` can carry the JAX arrays
across unchanged and the tests can feed both packages the same state.
``SceneStatic`` holds the host-side facts that select code paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu.models.compile import CompiledScene

from ..ops.textures import TexFlags, srgb_u8_to_linear_lut


class SceneArrays(NamedTuple):
    # triangle soup (object space)
    tri_p: torch.Tensor
    tri_n: torch.Tensor
    tri_uv: torch.Tensor
    tri_inst: torch.Tensor
    tri_mat_type: torch.Tensor
    tri_mat_index: torch.Tensor
    # analytic spheres
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_inst: torch.Tensor
    sph_mat_type: torch.Tensor
    sph_mat_index: torch.Tensor
    # instances
    inst_t0: torch.Tensor
    inst_t1: torch.Tensor
    # lights
    light_prob: torch.Tensor
    light_alias: torch.Tensor
    light_tri_p: torch.Tensor
    light_tri_packed: torch.Tensor  # [L,16] p0 p1 p2 pad
    light_count: torch.Tensor       # i32 scalar
    light_total_area: torch.Tensor  # f32 scalar
    # textures
    const_colours: torch.Tensor
    checker_scale: torch.Tensor
    checker_even: torch.Tensor
    checker_odd: torch.Tensor
    noise_scale: torch.Tensor
    atlas: torch.Tensor
    atlas_wh: torch.Tensor
    srgb_lut: torch.Tensor
    atlas_flat: torch.Tensor        # image 0 as linear f32 [AH*AW, 3]
    # materials
    lamb_albedo: torch.Tensor
    metal_albedo: torch.Tensor
    metal_fuzz: torch.Tensor
    diel_ri: torch.Tensor
    light_emit: torch.Tensor
    # table counts
    n_const: torch.Tensor
    n_image: torch.Tensor
    n_checker: torch.Tensor
    n_noise: torch.Tensor
    n_lamb: torch.Tensor
    n_metal: torch.Tensor
    n_diel: torch.Tensor
    n_light_mat: torch.Tensor
    # sky
    sky_solid: torch.Tensor
    sky_top: torch.Tensor
    sky_bottom: torch.Tensor
    sky_factor: torch.Tensor
    # BVH node rows ([0,16] when tracing brute force)
    bvh_child_boxes: torch.Tensor
    # pre-resolved shading rows ([1,32] dummy when unavailable)
    shade_rows: torch.Tensor


@dataclass(frozen=True)
class SceneStatic:
    """Host-side scene facts that select code paths (the JAX package's
    fields of the same names)."""

    sky_type: int
    flags: TexFlags
    has_lights: bool
    any_animated: bool
    has_tris: bool
    max_ray_depth: int
    sqrt_spp: int
    width: int
    height: int
    use_fat_shading: bool


def _scene_numpy(cs: CompiledScene) -> dict:
    """CompiledScene → the SceneArrays fields as numpy arrays, with the
    dtypes and derived tables of the JAX package's upload_scene."""
    i32 = lambda x: np.asarray(x, np.int32)      # noqa: E731
    f32 = lambda x: np.asarray(x, np.float32)    # noqa: E731
    n_image = (0 if int(np.prod(cs.atlas.shape[1:3])) <= 1
               else cs.atlas.shape[0])
    lut = srgb_u8_to_linear_lut()
    return dict(
        tri_p=f32(cs.tri_p), tri_n=f32(cs.tri_n), tri_uv=f32(cs.tri_uv),
        tri_inst=i32(cs.tri_inst),
        tri_mat_type=i32(cs.tri_mat_type),
        tri_mat_index=i32(cs.tri_mat_index),
        sph_center=f32(cs.sph_center), sph_radius=f32(cs.sph_radius),
        sph_inst=i32(cs.sph_inst),
        sph_mat_type=i32(cs.sph_mat_type),
        sph_mat_index=i32(cs.sph_mat_index),
        inst_t0=f32(cs.inst_t0), inst_t1=f32(cs.inst_t1),
        light_prob=f32(cs.light_prob), light_alias=i32(cs.light_alias),
        light_tri_p=f32(cs.light_tri_p),
        light_tri_packed=f32(np.pad(
            cs.light_tri_p.reshape(len(cs.light_tri_p), 9), ((0, 0), (0, 7)))),
        light_count=i32(cs.light_count),
        light_total_area=f32(cs.light_total_area),
        const_colours=f32(cs.const_colours),
        checker_scale=f32(cs.checker_scale),
        checker_even=i32(cs.checker_even), checker_odd=i32(cs.checker_odd),
        noise_scale=f32(cs.noise_scale),
        atlas=np.asarray(cs.atlas, np.uint8), atlas_wh=i32(cs.atlas_wh),
        srgb_lut=lut,
        atlas_flat=(lut[cs.atlas[0].reshape(-1, 3).astype(np.int32)]
                    if n_image else np.zeros((1, 3), np.float32)),
        lamb_albedo=i32(cs.lamb_albedo),
        metal_albedo=i32(cs.metal_albedo), metal_fuzz=i32(cs.metal_fuzz),
        diel_ri=f32(cs.diel_ri), light_emit=i32(cs.light_emit),
        n_const=i32(len(cs.const_colours)),
        n_image=i32(n_image),
        n_checker=i32(len(cs.checker_scale)),
        n_noise=i32(len(cs.noise_scale)),
        n_lamb=i32(len(cs.lamb_albedo)),
        n_metal=i32(len(cs.metal_albedo)),
        n_diel=i32(len(cs.diel_ri)),
        n_light_mat=i32(len(cs.light_emit)),
        sky_solid=f32(cs.sky_solid), sky_top=f32(cs.sky_top),
        sky_bottom=f32(cs.sky_bottom), sky_factor=f32(cs.sky_factor),
        bvh_child_boxes=np.zeros((0, 16), np.float32),
        shade_rows=f32(cs.shade_rows if cs.shade_rows is not None
                       else np.zeros((1, 32), np.float32)),
    )


def _to_device(arrays: dict, device) -> SceneArrays:
    return SceneArrays(**{k: torch.tensor(v, device=device)
                          for k, v in arrays.items()})


def upload_scene(cs: CompiledScene, device):
    """CompiledScene (numpy) → (SceneArrays on ``device``, SceneStatic)."""
    arrays = _to_device(_scene_numpy(cs), device)
    static = SceneStatic(
        sky_type=int(cs.sky_type),
        flags=TexFlags.for_scene(cs),
        has_lights=bool(cs.light_count > 0 and cs.light_total_area > 0.0),
        any_animated=bool(cs.any_animated),
        has_tris=bool(cs.num_triangles > 0),
        max_ray_depth=int(cs.render.max_ray_depth),
        sqrt_spp=int(cs.render.sqrt_spp),
        width=int(cs.render.width),
        height=int(cs.render.height),
        use_fat_shading=cs.shade_rows is not None,
    )
    return arrays, static


def from_jax_scene(scene_arrays, device="cpu") -> SceneArrays:
    """The JAX package's SceneArrays (or any object with the same fields
    that numpy can read) → the port's SceneArrays on ``device``."""
    return _to_device(
        {k: np.asarray(getattr(scene_arrays, k)) for k in SceneArrays._fields},
        device)
