"""Device-resident scene state (raytrace_tpu/engine/arrays.py:24-228).

``SceneArrays`` holds the scene's tensors, field for field the JAX
package's ``SceneArrays``, so ``from_jax_scene`` can carry the JAX arrays
across and the tests can feed both packages the same state; only
``light_tri_packed`` also holds the alias table (``light_table16``).
``SceneStatic`` holds the host-side facts that select code paths.
``from_jax_compiled`` carries the JAX package's ``CompiledScene`` over to
the port's, so one compiled scene can feed both packages.  The image
atlas travels as the JAX package keeps it (uint8 sRGB, padded to the
largest image) and is what the plain sampler reads; ``pack_atlas`` builds
the fused kernel's copy of it, one 32-bit word a texel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..models import compile as _compile
from ..models.compile import CompiledScene
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
    # [L,16] p0 p1 p2 | prob | alias (as f32) | pad: one 64-byte row a
    # light, the alias table and the triangle together (light_table16)
    light_tri_packed: torch.Tensor
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
    num_spheres: int = 0
    # Spheres swept densely before the rest, which lie in Morton clusters
    # (models/sphere_order.apply_sphere_order); 0 = no cluster layout.
    sph_prefix: int = 0
    # Set by the Renderer once every sphere has a world-space table
    # (uniform scale), as in the JAX package.
    sphere_world_mode: bool = False
    has_spheres: bool = False
    num_triangles: int = 0   # real triangles (the soup is padded beyond)
    # Triangles per contiguous cluster of the soup
    # (models/sphere_order.apply_triangle_order); 0 = file order.
    tri_cluster_g: int = 0
    num_instances: int = 0
    # How triangles are traced: "none" (the dense sweep, or the fused
    # kernel's clusters) or "paged" (ops/paged_tri.py), set by the Renderer.
    bvh_mode: str = "none"


def light_table16(tri_p, prob, alias) -> np.ndarray:
    """[L, 16] f32 light rows: the object-space triangle p0 p1 p2 in
    columns 0:9, the alias table's probability in 9 and its alias (an
    integer below 2^24, exact in f32) in 10, zeros after.  One 64-byte row
    a light, which the fused kernel reads by index (the JAX package's
    build_mega_tables layout, raytrace_tpu/ops/megakernel.py:2284-2289,
    transposed to rows); the wavefront reads columns 0:9."""
    tri_p = np.asarray(tri_p, np.float32)
    out = np.zeros((len(tri_p), 16), np.float32)
    out[:, 0:9] = tri_p.reshape(len(tri_p), 9)
    out[:, 9] = np.asarray(prob, np.float32)
    out[:, 10] = np.asarray(alias, np.int32).astype(np.float32)
    return out


def pack_atlas(atlas: torch.Tensor) -> torch.Tensor:
    """[NI, AH, AW, 3] uint8 sRGB atlas → [NI, AH, AW] int32 words
    r | g << 8 | b << 16 (the top byte zero), on the atlas's device: one
    aligned 4-byte load a texel for the fused kernel, whose row stride is
    the padded width AW.  Each byte indexes the same sRGB table as the
    uint8 atlas, so both decode to the same linear values."""
    a = atlas.to(torch.int32)
    return (a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16)).contiguous()


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
        light_tri_packed=light_table16(cs.light_tri_p, cs.light_prob,
                                       cs.light_alias),
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
    static = scene_static(cs)
    return _to_device(_scene_numpy(cs), device), static


def scene_static(cs: CompiledScene) -> SceneStatic:
    """The host-side facts of a CompiledScene, without uploading it."""
    if not isinstance(cs, CompiledScene):
        raise TypeError(
            f"upload_scene takes the port's models.compile.CompiledScene, "
            f"not {type(cs).__module__}.{type(cs).__name__} (convert a JAX "
            f"package scene with engine.arrays.from_jax_compiled)")
    return SceneStatic(
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
        num_spheres=int(cs.num_spheres),
        sph_prefix=int(cs.sph_prefix),
        has_spheres=bool(cs.num_spheres > 0),
        num_triangles=int(cs.num_triangles),
        tri_cluster_g=int(cs.tri_cluster_g),
        num_instances=int(cs.num_instances),
    )


def from_jax_scene(scene_arrays, device="cpu") -> SceneArrays:
    """The JAX package's SceneArrays (or any object with the same fields
    that numpy can read) → the port's SceneArrays on ``device``.  Every
    field is carried across unchanged but ``light_tri_packed``, whose
    columns 9 and 10 the JAX package leaves zero: it is packed again with
    the alias table (``light_table16``)."""
    arrays = {k: np.asarray(getattr(scene_arrays, k))
              for k in SceneArrays._fields}
    arrays["light_tri_packed"] = light_table16(
        arrays["light_tri_p"], arrays["light_prob"], arrays["light_alias"])
    return _to_device(arrays, device)


def _port_record(value):
    """A value of a JAX package CompiledScene field → the port's: its
    dataclass records (camera, render) become the port's classes of the
    same name, arrays become numpy copies, containers are walked."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = getattr(_compile, type(value).__name__)
        return cls(**{f.name: _port_record(getattr(value, f.name))
                      for f in dataclasses.fields(value)})
    if isinstance(value, dict):
        return {k: _port_record(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_port_record(v) for v in value)
    if isinstance(value, np.ndarray):
        return value.copy()
    return value


def from_jax_compiled(cs) -> CompiledScene:
    """The JAX package's CompiledScene (or any dataclass with the same
    fields and records) → the port's CompiledScene, through numpy."""
    out = _port_record(cs)
    if not isinstance(out, CompiledScene):
        raise TypeError(f"not a CompiledScene: {type(cs).__name__}")
    return out
